"""The train step replayed as CUDA graphs (what ``train/step.py::
make_train_step`` returns where the step can be captured).

A train step at the CLI's batch issues about 2,200 small launches, and the
host takes several times longer to issue them than the card takes to run
them.  A CUDA graph of the whole step (forward, losses, backward, the finite
check and the gated optimizer update) issues them in one launch.

:class:`GraphedStep` keeps up to ``MAX_GRAPHS`` graphs, one per signature of
its calls: the batch's tensors (their places, shapes and dtypes), its
``num_target_nodes``, the addresses of the parameters, ``mt_params`` and the
optimizer's moments, and the dropout generator.  The first call of a
signature runs the eager step, exactly as a step that is never captured; the
second captures the step and replays it; later calls replay.  A call on CPU
tensors and every call of a signature past the first ``MAX_GRAPHS`` run the
eager step; so does a call inside another capture or under a
``TorchDispatchMode`` (which a replay would bypass), and it counts as its
signature's first call: the benchmark's check records the draws of its
first steps under such a mode, and those stay the eager steps.  The step reads no count of valid nodes
or edges: the padding is in the tensors, so batches of one signature differ
only in their tensors' contents.

A replay, in this order:

* copies the batch into the graph's own buffers (one ``_foreach_copy_`` per
  dtype), so the graph holds no batch of its caller;
* reads ``state.opt_state.count``, which adds the previous replay's finite
  flag once its pinned copy has arrived, and writes the scheduled rate and
  the bias corrections for that count into the graph's device buffer with
  one copy;
* replays the graph, clones its packed aux scalars once (the returned
  values are views of the clone, so they outlive later steps) and starts
  the copy of its finite flag to the host.

The dropout generator is registered with every graph, so a replay draws
from the generator's offset at that moment, fresh masks each time, and
leaves the generator where the eager step would.  The graphs of one step
share one memory pool: they replay one at a time on one stream, and a
graph's outputs are read right after its own replay.

Spans (``torch.profiler.record_function``): a capturing call opens
``step.capture``, with the step's five stages inside it as the capture walks
them, and every call that replays (the capturing call too) opens
``step.replay`` around the copy-in, the rates, the replay and the clone.
``GraphedStep.replays`` counts the calls that replayed without capturing:
they launch no kernel from the host, so the kernel wrappers' host counters
(``kernels/launch.py``) do not see them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import torch
from torch.profiler import record_function
from torch.utils._python_dispatch import _get_current_dispatch_mode

from analysisgnn_tpu_torch.core.graph import HeteroGraph

MAX_GRAPHS = 4  # graphs a step keeps; calls of further signatures run eagerly
MAX_SEEN = 64  # signatures called once, remembered until the second call


def batch_tensors(batch: HeteroGraph) -> List[Tuple[tuple, torch.Tensor]]:
    """Every tensor of ``batch`` with its place in the graph, in a fixed
    order."""
    out = [(("x", t), v) for t, v in sorted(batch.node_features.items())]
    out += [(("e", et), v) for et, v in sorted(batch.edge_index.items())]
    out += [(("a", t, k), v) for t, d in sorted(batch.node_attrs.items()) for k, v in sorted(d.items())]
    out += [(("b", t), v) for t, v in sorted(batch.batch.items())]
    return out


def _with_tensors(batch: HeteroGraph, tensors: Dict[tuple, torch.Tensor]) -> HeteroGraph:
    """``batch`` with each tensor replaced by the one at its place."""
    return dataclasses.replace(
        batch,
        node_features={t: tensors["x", t] for t in batch.node_features},
        edge_index={et: tensors["e", et] for et in batch.edge_index},
        node_attrs={t: {k: tensors["a", t, k] for k in d} for t, d in batch.node_attrs.items()},
        batch={t: tensors["b", t] for t in batch.batch},
    )


class _Graph:
    """One captured step with its buffers."""

    def __init__(self, graph, inputs: List[torch.Tensor], rates, finite, flat, keys):
        self.graph = graph
        self.rates, self.finite, self.flat, self.keys = rates, finite, flat, keys
        groups: Dict[torch.dtype, List[int]] = {}
        for i, t in enumerate(inputs):
            groups.setdefault(t.dtype, []).append(i)
        self.groups = [([inputs[i] for i in idx], idx) for idx in groups.values()]
        self.rates_host = torch.empty(3, dtype=torch.float32, pin_memory=True)
        self.flag_host = torch.empty((), dtype=torch.bool, pin_memory=True)
        self.done = torch.cuda.Event()  # recorded after the flag's copy

    def replay(self, state, tensors: List[torch.Tensor], rates: Callable[[int], Tuple[float, float, float]]):
        for dst, idx in self.groups:
            torch._foreach_copy_(dst, [tensors[i] for i in idx])
        count = state.opt_state.count  # waits for the previous replay's flag
        self.done.synchronize()  # this graph's last copies from its pinned buffers have run
        self.rates_host.numpy()[:] = rates(count)
        self.rates.copy_(self.rates_host, non_blocking=True)
        self.graph.replay()
        flat = self.flat.clone()
        self.flag_host.copy_(self.finite, non_blocking=True)
        self.done.record()
        state.opt_state.defer_count(self.flag_host, self.done)
        return dict(zip(self.keys, flat.unbind()))


class GraphedStep:
    """``step(state, batch) -> (state, aux)``: ``eager`` on the first call of
    each signature, a CUDA graph of ``body`` from the second on.

    ``body(state, batch, rates) -> (finite, aux)`` is the step as the graph
    captures it: no host read, the update gated on the card by the 0-d bool
    ``finite`` and scaled by the device tensor ``rates``
    (``ClippedAdamW.update``); it leaves ``state.step`` and
    ``state.opt_state.count`` to this class.  ``params`` are the model's
    parameters; ``rates(count)`` gives the host's values for ``rates``."""

    replays = 0  # calls, over every GraphedStep, that replayed a graph without capturing it

    def __init__(self, eager, body, params: List[torch.Tensor], rates: Callable[[int], Tuple[float, float, float]]):
        self.eager, self.body = eager, body
        self.params, self.rates = params, rates
        self.graphs: Dict[tuple, _Graph] = {}
        self.seen: set = set()
        self.pool = None  # the memory pool this step's graphs share

    def signature(self, state, batch: HeteroGraph, tensors: List[Tuple[tuple, torch.Tensor]]) -> tuple:
        """What a graph of this call depends on (``tensors`` is
        :func:`batch_tensors` of ``batch``)."""
        opt = state.opt_state
        leaves = [*self.params, state.mt_params, *opt.mu, *opt.nu]
        return (batch.num_target_nodes, tuple((k, t.shape, t.dtype) for k, t in tensors),
                tuple(p.data_ptr() for p in leaves), state.generator)

    def on_card(self, tensors: List[Tuple[tuple, torch.Tensor]]) -> bool:
        """Whether the batch's tensors are on the parameters' card."""
        device = self.params[0].device
        return device.type == "cuda" and all(t.device == device for _, t in tensors)

    def __call__(self, state, batch: HeteroGraph):
        tensors = batch_tensors(batch)
        if not self.on_card(tensors):
            return self.eager(state, batch)
        sig = self.signature(state, batch, tensors)
        # a TorchDispatchMode would miss a replay's operations, and a capture
        # cannot hold another: such a call runs eagerly and counts as seen
        watched = torch.cuda.is_current_stream_capturing() or _get_current_dispatch_mode() is not None
        graph = None if watched else self.graphs.get(sig)
        if graph is not None:
            GraphedStep.replays += 1
        elif not watched and sig in self.seen and len(self.graphs) < MAX_GRAPHS:
            self.seen.discard(sig)
            graph = self.graphs[sig] = self._capture(state, batch, tensors)
        else:
            if len(self.seen) >= MAX_SEEN:
                self.seen.clear()
            self.seen.add(sig)
            return self.eager(state, batch)
        with record_function("step.replay"):
            aux = graph.replay(state, [t for _, t in tensors], self.rates)
        state.step += 1
        return state, aux

    def _capture(self, state, batch: HeteroGraph, tensors: List[Tuple[tuple, torch.Tensor]]) -> _Graph:
        inputs = {k: torch.empty_like(t) for k, t in tensors}
        rates = torch.zeros(3, dtype=torch.float32, device=self.params[0].device)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(state.generator)
        with record_function("step.capture"):
            # thread-local: a thread that stages the next batches meanwhile
            # (the Trainer's prefetch) may make calls that a capture forbids
            with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
                finite, aux = self.body(state, _with_tensors(batch, inputs), rates)
                flat = torch.stack(list(aux.values()))  # the step's aux values are float32 scalars
        self.pool = graph.pool()
        return _Graph(graph, list(inputs.values()), rates, finite, flat, list(aux))
