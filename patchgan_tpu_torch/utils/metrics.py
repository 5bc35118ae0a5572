"""Segmentation quality metrics: IoU, Dice, boundary F1 and the confusion
matrix, NCHW.

Port of ``patchgan_tpu/utils/metrics.py:14-123``: probabilities are
arg-maxed over the channels (C > 1) or thresholded (C == 1); IoU, Dice
and boundary F1 are per (sample, class), averaged over the pairs that
are present (a non-empty union, a non-empty size sum, a non-empty
boundary in either mask), each a 0-d fp32 tensor on the inputs' device.
``iou(..., mesh=)`` takes the mean over the global batch's present pairs
under data parallelism: the ranks' sums and counts are summed first; over
a ``parallel.spatial.SpatialMesh`` each (sample, class) sum is summed over
the band's spatial axis before that.
"""

import torch
import torch.nn.functional as F


def _harden(y_pred, threshold):
    c = y_pred.shape[1]
    if c > 1:
        labels = y_pred.argmax(dim=1, keepdim=True)
        classes = torch.arange(c, device=y_pred.device).view(1, c, 1, 1)
        return (labels == classes).float()
    return (y_pred >= threshold).float()


def _present_mean(per_class, present, mesh=None):
    present = present.float()
    total, count = (per_class * present).sum(), present.sum()
    if mesh is not None:
        total, count = mesh.stat(torch.stack([total, count]))
    return total / count.clamp(min=1.0)


def iou(y_true, y_pred, threshold=0.5, eps=1e-7, mesh=None):
    """y_true: (N, C, H, W) one-hot, y_pred: (N, C, H, W) probabilities;
    a 0-d fp32 tensor. With a ``mesh`` (``parallel.mesh.DataMesh``), the
    global batch's IoU on every rank."""
    y_true = y_true.float()
    hard = _harden(y_pred, threshold)
    inter = (hard * y_true).sum(dim=(2, 3))
    union = hard.sum(dim=(2, 3)) + y_true.sum(dim=(2, 3)) - inter
    if getattr(mesh, 'spatial', None) is not None:
        inter, union = mesh.spatial.stat(torch.stack([inter, union]))
        mesh = mesh.data
    return _present_mean(inter / (union + eps), union > 0, mesh)


def dice(y_true, y_pred, threshold=0.5, eps=1e-7):
    """Per-class 2|A n B| / (|A| + |B|), averaged as ``iou`` is."""
    y_true = y_true.float()
    hard = _harden(y_pred, threshold)
    inter = (hard * y_true).sum(dim=(2, 3))
    size_sum = hard.sum(dim=(2, 3)) + y_true.sum(dim=(2, 3))
    return _present_mean(2.0 * inter / (size_sum + eps), size_sum > 0)


def _erode(m):
    """3x3 binary erosion of (N, C, H, W) {0, 1} masks, edge-padded so a
    pixel on the image border is not boundary for that alone."""
    return -F.max_pool2d(-F.pad(m, (1, 1, 1, 1), mode='replicate'), 3, 1)


def _dilate(m, radius):
    """(2r + 1)-square binary dilation; outside the image counts as 0."""
    if radius <= 0:
        return m
    return F.max_pool2d(m, 2 * radius + 1, 1, padding=radius)


def boundary_f1(y_true, y_pred, threshold=0.5, tolerance=2, eps=1e-7):
    """Boundary F1: a boundary is a mask minus its 3x3 erosion; precision
    counts predicted-boundary pixels within ``tolerance`` pixels of a
    true boundary, recall the converse; their harmonic mean averaged over
    the (sample, class) pairs where either boundary is non-empty."""
    y_true = y_true.float()
    hard = _harden(y_pred, threshold)
    tb = y_true - _erode(y_true)
    pb = hard - _erode(hard)
    n_pb = pb.sum(dim=(2, 3))
    n_tb = tb.sum(dim=(2, 3))
    prec = (pb * _dilate(tb, tolerance)).sum(dim=(2, 3)) / (n_pb + eps)
    rec = (tb * _dilate(pb, tolerance)).sum(dim=(2, 3)) / (n_tb + eps)
    f1 = 2.0 * prec * rec / (prec + rec + eps)
    return _present_mean(f1, (n_pb + n_tb) > 0)


def confusion_matrix(true_labels, pred_labels, n_classes):
    """Integer label maps of one shape -> (n_classes, n_classes) counts,
    rows the truth, columns the prediction."""
    idx = true_labels.reshape(-1).long() * n_classes + \
        pred_labels.reshape(-1).long()
    return torch.bincount(idx, minlength=n_classes * n_classes).reshape(
        n_classes, n_classes)


def iou_from_confusion(cm, eps=1e-7):
    """Per-class IoU vector from a confusion matrix."""
    cm = cm.float()
    tp = cm.diagonal()
    fp = cm.sum(dim=0) - tp
    fn = cm.sum(dim=1) - tp
    return tp / (tp + fp + fn + eps)
