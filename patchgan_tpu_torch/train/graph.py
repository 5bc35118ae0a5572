"""The G+D train step as one captured CUDA graph: the counterpart of the
JAX Trainer's ``jax.jit(step, donate_argnums=(0,))``
(``patchgan_tpu/train/trainer.py:192``).

``CapturedStep`` wraps the two parts of a train step that
``make_train_step`` splits it into: ``run(x, y)``, the device work (G
forward, the losses, G backward, G's Adam or ``MultiSteps`` update, the
paired D forward and backward, D's update), and ``advance()``, the
host's bookkeeping (the optimizers' step counts and accumulation
windows). For each key (x's and y's shapes and dtypes and the
optimizers' mini-step positions, so an accumulating step has one
program per position) it runs ``warmup`` eager steps, which are real
training steps on real batches, on the side stream PyTorch's
whole-network capture recipe asks for; the next call captures ``run``
into a CUDA graph and replays it, and every later call replays it:

- the batch is copied into the graph's static input buffers, and the
  losses come back as fresh 0-d tensors (one copy after the replay);
  nothing waits for the device;
- a capture runs no arithmetic, so it advances no host counter and no
  generator state; each replay, like each eager step, advances them
  once. The dropout generator is registered with every graph
  (``register_generator_state``), so each replay draws its masks from
  where the generator stands, and ``get_state`` / ``set_state`` keep
  their meaning. The optimizers read their learning rate and step count
  from device tensors (``steps.Adam``), and a restore copies into the
  tensors the graphs read, so neither needs a recapture;
- the graphs of one step share one memory pool and run one at a time,
  in the order the step calls them;
- the kernel wrappers count their launches where they launch: an eager
  step's, and a capture's, which it records into the graph. A replay
  runs the recorded kernels without calling a wrapper; ``replays``
  counts those.

A data-parallel step's collectives (``parallel/mesh.py``) are captured
with the rest under NCCL, on a communicator that no eager collective
uses; the mesh holds the step, and ``parallel.shutdown`` frees its
graphs (``release``) before the process group goes. A data x model
parallel step (a ``HybridMesh``) captures the gradient sums on its data
group's graph communicator and the activation gathers, and their
backward sums, on its model group's: a sharded layer picks the
communicator in its forward, so the backward that the capture records
takes the same one. A gloo group cannot be captured (the Trainer then steps
eagerly). A capture or a replay that fails raises; the step never falls
back to eager. CPU tensors take the eager step, as graphs exist only on the card.
``PATCHGAN_CUDA_GRAPH`` (``cuda_graph_enabled``), read when a Trainer is
built, selects this step in the Trainer.
"""

import contextlib
import os

import torch

# the Trainer's step on the card when PATCHGAN_CUDA_GRAPH is unset
DEFAULT = 'on'


def cuda_graph_enabled():
    """``PATCHGAN_CUDA_GRAPH``, read as ``PATCHGAN_S2D`` is: off, 0 or
    false select the eager step, any other value the captured one."""
    flag = os.environ.get('PATCHGAN_CUDA_GRAPH', DEFAULT).lower()
    return flag not in ('off', '0', 'false')


def graph_flag_given():
    """Whether ``PATCHGAN_CUDA_GRAPH`` asks for the captured step
    explicitly (set, and not off)."""
    return 'PATCHGAN_CUDA_GRAPH' in os.environ and cuda_graph_enabled()


def capturable(x):
    """Whether a batch can take the captured step: graphs exist only on
    the card."""
    return x.device.type == 'cuda'


class CapturedStep:
    """``step(x, y) -> losses`` from ``run`` and ``advance`` (see the
    module's docstring); ``position()`` gives the optimizers' mini-step
    positions, ``generators()`` the generators ``run`` draws from.
    ``eager_steps``, ``captures`` and ``replays`` count the calls of
    each kind on the card."""

    warmup = 1   # eager steps of a key before its capture

    def __init__(self, run, advance, position, generators):
        self._run, self._advance = run, advance
        self._position, self._generators = position, generators
        self._graphs = {}    # key -> replay(x, y) -> (keys, losses)
        self._cuda_graphs = []
        self._eager = {}     # key -> eager steps run
        self._pool = None
        self._stream = None
        self.eager_steps = self.captures = self.replays = 0

    def __call__(self, x, y):
        if not capturable(x):
            return self._step(x, y)
        key = (tuple(x.shape), x.dtype, tuple(y.shape), y.dtype,
               self._position())
        replay = self._graphs.get(key)
        if replay is None:
            if self._eager.get(key, 0) < self.warmup:
                self._eager[key] = self._eager.get(key, 0) + 1
                self.eager_steps += 1
                with self._side_stream(x.device):
                    return self._step(x, y)
            replay = self._graphs[key] = self._capture(x, y, key)
            self.captures += 1
        keys, losses = replay(x, y)
        self._advance()
        self.replays += 1
        return dict(zip(keys, losses.unbind()))

    def release(self):
        """Free the captured graphs; a later call warms up and captures
        anew. NCCL's teardown waits for every graph that holds a
        communicator's work, so a data-parallel step releases its graphs
        before its process group goes (``parallel.shutdown``)."""
        for graph in self._cuda_graphs:
            graph.reset()
        self._cuda_graphs.clear()
        self._graphs.clear()
        self._eager.clear()
        self._pool = None

    def _step(self, x, y):
        losses = self._run(x, y)
        self._advance()
        return losses

    @contextlib.contextmanager
    def _side_stream(self, device):
        """The block on the step's side stream, ordered after the work
        queued before it and before the work queued after it."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        current = torch.cuda.current_stream(device)
        self._stream.wait_stream(current)
        with torch.cuda.stream(self._stream):
            yield
        current.wait_stream(self._stream)

    def _capture(self, x, y, key):
        """Capture ``run`` on static copies of x and y; returns the
        replay. The loader's threads may use the card meanwhile, so the
        capture checks for unsafe calls in this thread only."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(x.device)
        static_x, static_y = x.clone(), y.clone()
        graph = torch.cuda.CUDAGraph()
        for gen in self._generators():
            if gen is not None and gen.device.type == 'cuda':
                graph.register_generator_state(gen)
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream,
                                  capture_error_mode='thread_local'):
                losses = self._run(static_x, static_y)
                keys = list(losses)
                out = torch.stack([losses[k].float() for k in keys])
        except Exception as e:
            raise RuntimeError(
                f'capturing the train step failed at {key}; '
                f'PATCHGAN_CUDA_GRAPH=off runs it eagerly') from e
        if self._pool is None:
            self._pool = graph.pool()
        self._cuda_graphs.append(graph)

        def replay(x, y):
            static_x.copy_(x)
            static_y.copy_(y)
            graph.replay()
            return keys, out.clone()

        return replay
