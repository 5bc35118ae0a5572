"""Segmentation quality metric of the eval step: mean IoU, NCHW.

Port of ``patchgan_tpu/utils/metrics.py:14-44`` (``iou``): probabilities
are arg-maxed over the channels (C > 1) or thresholded (C == 1), then
per-(sample, class) IoU, averaged over the pairs whose union is not
empty.
"""

import torch


def _harden(y_pred, threshold):
    c = y_pred.shape[1]
    if c > 1:
        labels = y_pred.argmax(dim=1, keepdim=True)
        classes = torch.arange(c, device=y_pred.device).view(1, c, 1, 1)
        return (labels == classes).float()
    return (y_pred >= threshold).float()


def iou(y_true, y_pred, threshold=0.5, eps=1e-7):
    """y_true: (N, C, H, W) one-hot, y_pred: (N, C, H, W) probabilities;
    a 0-d fp32 tensor."""
    y_true = y_true.float()
    hard = _harden(y_pred, threshold)
    inter = (hard * y_true).sum(dim=(2, 3))
    union = hard.sum(dim=(2, 3)) + y_true.sum(dim=(2, 3)) - inter
    present = (union > 0).float()
    return ((inter / (union + eps)) * present).sum() / \
        present.sum().clamp(min=1.0)
