"""The async exact-resume store (``Trainer.checkpoint_format = 'orbax'``).

Port of ``patchgan_tpu/utils/orbax_ckpt.py``, under its name so a reader
finds the counterpart; it stores through ``torch.distributed.checkpoint``
(DCP), not orbax. The four functions are the JAX module's:
``orbax_path``, ``save_async``, ``wait`` and ``restore``.

A state is a nested dict (lists inside it too) of tensors and JSON-able
scalars, such as ``Trainer.training_state()``. Its tensors go through DCP
under flat keys (the path of names and list positions joined by '/');
its scalars (step counts, learning rates, the schedules' state) go into
``scalars.json`` beside DCP's files, with the list of tensor keys.

- ``save_async`` copies every tensor and returns: a CUDA tensor on its
  device, the copy queued on the device's current stream, so work queued
  after the call (the captured train step, which updates the tensors in
  place) cannot change the source before it is read; a CPU tensor at
  once. A thread of its own then takes the device copies to host memory
  on a stream of its own (behind an event at the end of the copies; the
  training's stream goes on meanwhile), frees them, writes everything
  into ``<path>.tmp`` and renames it to ``path`` once DCP's metadata is
  written, so a directory under the final name is whole. While a save is
  in flight the card holds a second copy of the state. A save first waits
  for the one before it, as orbax's ``AsyncCheckpointer`` does.
- ``wait`` blocks until the started save has committed, and raises its
  error if it failed.
- ``restore`` loads in place into the tensors of a template of the same
  structure (the live ones: a captured step that reads them needs no new
  capture) and returns the template with the saved scalars.

The store writes with ``no_dist=True``: under a process group only the
caller's process writes (the Trainer's rank 0), and no collective waits
for the others; every rank may restore the same directory, whatever the
world size was at the save (the state is replicated). DCP's own
``async_save`` is not used: with a process group it asks the default
group for a CPU backend, which an NCCL group lacks.
"""

import json
import os
import shutil
import threading
import warnings

import torch

SCALARS = 'scalars.json'
TENSOR = '__tensor__'   # a tensor's place in the scalars' tree

_lock = threading.RLock()
_pending = None   # (thread, [error]) of the save in flight


def orbax_path(savefolder, epoch):
    """The epoch state's directory: ``training_state_ep_###.dcp``."""
    return os.path.abspath(
        os.path.join(savefolder, f'training_state_ep_{epoch:03d}.dcp'))


def _split(tree, prefix=''):
    """({flat key: tensor}, the tree with each tensor replaced by
    ``TENSOR``, lists and tuples as lists)."""
    if torch.is_tensor(tree):
        return {prefix: tree}, TENSOR
    if isinstance(tree, dict):
        items = [(str(k), v) for k, v in tree.items()]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return {}, tree
    tensors, out = {}, {} if isinstance(tree, dict) else []
    for key, value in items:
        t, s = _split(value, f'{prefix}/{key}' if prefix else key)
        tensors.update(t)
        if isinstance(out, dict):
            out[key] = s
        else:
            out.append(s)
    return tensors, out


def _merge(scalars, template):
    """The saved scalars' tree with the template's tensors in their
    places."""
    if isinstance(scalars, str) and scalars == TENSOR:
        return template
    if isinstance(scalars, dict):
        return {k: _merge(v, template.get(k) if isinstance(template, dict)
                          else None) for k, v in scalars.items()}
    if isinstance(scalars, list):
        return [_merge(v, template[i] if isinstance(template, (list, tuple))
                       and i < len(template) else None)
                for i, v in enumerate(scalars)]
    return scalars


def _stage(tensors):
    """(copies of ``tensors``, [(device, an event after its copies)]):
    a CUDA tensor's copy queued on its device's current stream."""
    copies = {k: t.detach().clone() for k, t in tensors.items()}
    events = []
    for device in {t.device for t in copies.values() if t.is_cuda}:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(device))
        events.append((device, event))
    return copies, events


def _to_host(copies, events):
    """The copies on the host: each device's taken over on a stream of
    its own behind its event (the writer thread's part)."""
    for device, event in events:
        stream = torch.cuda.Stream(device)
        stream.wait_event(event)
        with torch.cuda.stream(stream):
            for k, t in copies.items():
                if t.device == device:
                    copies[k] = t.to('cpu')
        stream.synchronize()
    return copies


def _quiet():
    # DCP warns on every save and load without a process group; the store
    # works without one by design
    warnings.filterwarnings(
        'ignore', message='torch.distributed is disabled, unavailable or '
                          'uninitialized')


def save_async(path, state):
    """Start saving ``state`` into the directory ``path`` and return once
    its tensors are copied (see the module's docstring)."""
    global _pending
    import torch.distributed.checkpoint as dcp
    _quiet()
    with _lock:
        wait()
        tensors, scalars = _split(state)
        copies, events = _stage(tensors)
        tmp = f'{path}.tmp'
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, SCALARS), 'w') as f:
            json.dump({'tensors': sorted(copies), 'scalars': scalars}, f)
        errors = []

        def commit():
            try:
                dcp.save(_to_host(copies, events),
                         storage_writer=dcp.FileSystemWriter(tmp),
                         no_dist=True)
                shutil.rmtree(path, ignore_errors=True)
                os.rename(tmp, path)
            except Exception as e:   # raised again by wait()
                errors.append(e)

        thread = threading.Thread(target=commit, name='orbax_ckpt.save')
        thread.start()
        _pending = (thread, errors)


def wait():
    """Block until the started save has committed; raise its error."""
    global _pending
    with _lock:
        if _pending is None:
            return
        thread, errors = _pending
        thread.join()
        _pending = None
    if errors:
        raise errors[0]


def restore(path, template):
    """Load the state saved in ``path`` into ``template``'s tensors, in
    place, and return the template with the saved scalars. The tensors'
    keys must match the saved ones."""
    import torch.distributed.checkpoint as dcp
    _quiet()
    wait()
    with open(os.path.join(path, SCALARS)) as f:
        meta = json.load(f)
    tensors, _ = _split(template)
    saved, have = set(meta['tensors']), set(tensors)
    if saved != have:
        raise ValueError(
            f"{os.path.basename(path)} holds other tensors than the "
            f"template: only saved {sorted(saved - have)[:4]}, only in "
            f"the template {sorted(have - saved)[:4]} (set "
            f"accumulate_steps and freeze_generator as they were)")
    dcp.load(tensors, storage_reader=dcp.FileSystemReader(path),
             no_dist=True)
    return _merge(meta['scalars'], template)
