"""Per-rank input slices: the parts of ``patchgan_tpu/parallel/multihost.py``
and of the JAX loader's per-host sharding (``data/loader.py:177-195``)
that data-parallel training uses.

Each rank decodes only its contiguous slice of every global batch
(``process_local_range``); the slices follow from the global batch size
and the rank alone, so the ranks agree on them without communicating.
The JAX mesh over DCN and ICI (``dcn_mesh``) is not ported: the port runs
one process per card and NCCL picks its own topology (``mesh.py``).
"""

import torch.distributed as dist


def process_local_range(global_batch_size, process_index=None,
                        process_count=None):
    """Contiguous [start, stop) slice of a global batch owned by this
    rank (JAX ``multihost.py:95-109``). The index and count default to
    the default process group's rank and size, or (0, 1) without one;
    a batch that does not divide across the ranks raises ValueError.
    Under a model axis the defaults are wrong: a rank's rows follow its
    data rank (``HybridMesh.local_rows``), so pass them."""
    if process_index is None or process_count is None:
        grouped = dist.is_available() and dist.is_initialized()
        if process_index is None:
            process_index = dist.get_rank() if grouped else 0
        if process_count is None:
            process_count = dist.get_world_size() if grouped else 1
    if global_batch_size % process_count:
        raise ValueError(
            f"global batch {global_batch_size} must divide across "
            f"{process_count} hosts")
    per = global_batch_size // process_count
    return process_index * per, (process_index + 1) * per

