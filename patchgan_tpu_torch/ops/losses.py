"""Segmentation and adversarial losses, NCHW, fp32 reductions.

Port of ``patchgan_tpu/ops/losses.py``:

- ``tversky``: per-sample Tversky index over all non-batch axes,
  loss = 1 - tp / (tp + beta*fn + (1-beta)*fp), batch-meaned.
- ``fc_tversky``: focal Tversky with smooth=1 in numerator and
  denominator; gamma is applied AFTER the batch mean (``:45-61``).
- ``bce_loss``: binary cross-entropy on probabilities with the log
  clamped at -100 (``torch.nn.BCELoss``), written so the gradient at
  p = 0 is zero and NaN-free (``:71-82``).
- ``weighted_bce_loss``: elementwise-weighted BCE.

Every reduction runs in float32 whatever the input dtype.

Under data parallelism each rank holds a slice of the global batch, and
``mesh`` (a ``parallel.mesh.DataMesh``) makes each batch mean the global
batch's: ``mesh.mean`` of the rank's mean, whose backward hands the rank
its own samples' share of the gradient. The gamma of ``fc_tversky`` then
applies to the global mean, as it does in the JAX package's step on a
sharded batch. Without a mesh each loss is the local batch's.

A ``parallel.spatial.SpatialMesh`` as ``mesh`` means the inputs are this
rank's band of the rows: the per-sample Tversky sums go through
``mesh.spatial.band_sum`` before the ratio, and a mean is a sum and an
element count, both summed over the spatial axis, then divided (the
discriminator's bands are uneven, so a mean of the bands' means would be
another number), then meaned over the data axis.
"""

import torch


def _spatial(mesh):
    """The spatial axis of a mesh, or None."""
    return getattr(mesh, 'spatial', None)


def _sum_nonbatch(x):
    """Sum over every axis but the leading batch axis (fp32)."""
    return x.float().sum(dim=tuple(range(1, x.dim())))


def _tversky_terms(y_true, y_pred, mesh=None):
    y_true, y_pred = y_true.float(), y_pred.float()
    tp = _sum_nonbatch(y_true * y_pred)
    fn = _sum_nonbatch((1.0 - y_pred) * y_true)
    fp = _sum_nonbatch(y_pred * (1.0 - y_true))
    if _spatial(mesh) is not None:
        # one sum over the band for the three per-sample terms
        tp, fn, fp = mesh.spatial.band_sum(torch.stack([tp, fn, fp]))
    return tp, fn, fp


def global_mean(x, mesh=None, banded=True):
    """The mean of ``x`` over the global batch: ``x.mean()``, then the
    mean over the ranks when there is a ``mesh``; where x is a band's
    elements over a spatial mesh (``banded``), the sum and the count
    summed over the band first (a per-sample value, whole on every rank,
    is not)."""
    spatial = _spatial(mesh) if banded else None
    if spatial is not None:
        # the count filled on the device: a captured step copies nothing
        # from the host
        total = spatial.band_sum(torch.stack([
            x.float().sum(), x.new_full((), float(x.numel()),
                                        dtype=torch.float32)]))
        m = total[0] / total[1]
    else:
        m = x.mean()
    return m if mesh is None else mesh.mean(m)


def tversky(y_true, y_pred, beta, batch_mean=True, mesh=None):
    tp, fn, fp = _tversky_terms(y_true, y_pred, mesh)
    loss = 1.0 - tp / (tp + beta * fn + (1.0 - beta) * fp)
    return global_mean(loss, mesh, banded=False) if batch_mean else loss


def fc_tversky(y_true, y_pred, beta, gamma=0.75, batch_mean=True,
               mesh=None):
    smooth = 1.0
    tp, fn, fp = _tversky_terms(y_true, y_pred, mesh)
    index = (tp + smooth) / (tp + beta * fn + (1.0 - beta) * fp + smooth)
    focal = 1.0 - index
    if batch_mean:
        return torch.pow(global_mean(focal, mesh, banded=False), gamma)
    return torch.pow(focal, gamma)


def mae_loss(y_true, y_pred, mesh=None):
    return global_mean((y_true.float() - y_pred.float()).abs(), mesh)


def _clamped_log(p):
    """log(p) clamped at -100; the where() takes the constant branch at
    p == 0, so the gradient there is 0, not 0 * (1/0) = NaN."""
    safe = torch.log(torch.clamp(p, min=1e-35))
    return torch.where(p > 0, torch.clamp(safe, min=-100.0),
                       torch.full_like(p, -100.0))


def bce_loss(y_pred, y_true, mesh=None):
    """(input = predicted probabilities, target), torch's order."""
    p, t = y_pred.float(), y_true.float()
    return global_mean(-(t * _clamped_log(p)
                        + (1.0 - t) * _clamped_log(1.0 - p)), mesh)


def weighted_bce_loss(y_pred, y_true, weight, mesh=None):
    p, t = y_pred.float(), y_true.float()
    w = weight.float().expand_as(p)
    return global_mean(-w * (t * _clamped_log(p)
                            + (1.0 - t) * _clamped_log(1.0 - p)), mesh)
