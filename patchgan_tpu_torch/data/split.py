"""Dataset train/val splitting.

The port's own copy of ``patchgan_tpu/data/split.py``: ``random_split``
by fractions or lengths from ``np.random.default_rng(seed)``, and an
index-remapping ``Subset`` that forwards the dataset's attributes.
"""

import numpy as np


class Subset:
    """Index-remapped view of a dataset; attribute access falls through
    to it, with the index-taking methods remapped."""

    _INDEX_METHODS = frozenset(
        ('load_raw', 'load_raw_u8', 'get_image', 'get_filename'))

    def __init__(self, dataset, indices):
        self.dataset = dataset
        self.indices = np.asarray(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]

    def __getattr__(self, name):
        if name in ('dataset', 'indices'):  # guard pre-__init__ lookups
            raise AttributeError(name)
        attr = getattr(self.dataset, name)
        if name in self._INDEX_METHODS and callable(attr):
            indices = self.indices

            def remapped(i, *args, _attr=attr, **kwargs):
                return _attr(indices[i], *args, **kwargs)
            return remapped
        return attr


def random_split(dataset, lengths, seed=0):
    """Split by fractions (summing to ~1) or absolute lengths, as
    torch.utils.data.random_split does."""
    n = len(dataset)
    lengths = list(lengths)
    if all(isinstance(x, float) for x in lengths) and \
            abs(sum(lengths) - 1.0) < 1e-6:
        counts = [int(np.floor(n * f)) for f in lengths]
        for i in range(n - sum(counts)):
            counts[i % len(counts)] += 1
    else:
        counts = [int(x) for x in lengths]
        if sum(counts) != n:
            raise ValueError(
                f"Sum of input lengths {sum(counts)} does not equal the "
                f"length of the input dataset {n}")
    perm = np.random.default_rng(seed).permutation(n)
    subsets, offset = [], 0
    for c in counts:
        subsets.append(Subset(dataset, perm[offset:offset + c]))
        offset += c
    return subsets
