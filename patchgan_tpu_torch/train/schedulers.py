"""Host-side learning-rate schedules, stepped once per epoch.

The port's own copy of ``patchgan_tpu/train/schedulers.py`` (the port
imports nothing of the JAX package): ExponentialDecay every
``decay_freq`` epochs, torch's ReduceLROnPlateau defaults, a constant
LR, and the LR fast-forward on resume.
"""


class ExponentialDecay:
    """lr <- lr * gamma at the end of every ``decay_freq``-th epoch."""

    def __init__(self, initial_lr, gamma, decay_freq=5):
        self.lr = initial_lr
        self.gamma = gamma
        self.decay_freq = decay_freq

    def epoch_end(self, epoch, metric=None):
        if epoch % self.decay_freq == 0:
            self.lr = self.lr * self.gamma
        return self.lr


class ReduceLROnPlateau:
    """torch.optim.lr_scheduler.ReduceLROnPlateau defaults (mode 'min',
    factor 0.1, patience 10, relative threshold 1e-4, cooldown 0,
    min_lr 0), stepped on the epoch's mean validation loss."""

    def __init__(self, initial_lr, factor=0.1, patience=10, threshold=1e-4,
                 min_lr=0.0, cooldown=0):
        self.lr = initial_lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.min_lr = min_lr
        self.cooldown = cooldown
        self.cooldown_counter = 0
        self.best = float('inf')
        self.num_bad_epochs = 0

    def epoch_end(self, epoch, metric=None):
        if metric is None:
            return self.lr
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr


class ConstantLR:
    def __init__(self, initial_lr):
        self.lr = initial_lr

    def epoch_end(self, epoch, metric=None):
        return self.lr


def resume_fast_forward(lr, lr_decay, start_epoch, decay_freq):
    """lr * decay ** ((start - 1) / decay_freq), float division."""
    if lr_decay is None:
        return lr
    return lr * lr_decay ** ((start_epoch - 1) / decay_freq)
