"""Train steps replayed from CUDA graphs — the card's counterpart of the JAX
package's fused ``window_step`` (``train.step_window`` K > 1, ROADMAP A.5b).

The JAX trainer jits K steps as one ``lax.scan``, so a window pays dispatch
and input staging once. Here one whole train step (forward, backward, the
global norm, the optimizer update, the EMA) is captured once as a
``torch.cuda.CUDAGraph`` and replayed step after step: a step costs the host
one graph launch instead of thousands of kernel launches. The replay is the
same kernels on the same addresses as the eager step, so the trajectory is
the eager one (bit for bit where the step has no atomics).

What makes a step replayable, and where it is kept:

- **Host values.** A graph freezes every value the host passed at capture.
  The learning rate and the update count are f32 device scalars that the
  host fills before each replay (``Optimizer.prepare``); the bias
  corrections are computed from them on the device (``train/optim.py``).
- **Dropout.** One :class:`StepGenerator` per trainer, registered with every
  graph and reseeded to ``step_seed(seed, step)`` before each step, eager or
  replayed, so step s draws the masks the eager step s draws.
- **Remat.** A recompute draws again the masks of its forward. Eagerly the
  generator is rewound (``get_state``/``set_state``, which a capture
  refuses); under capture the recompute draws from a twin generator, also
  registered, that each replay seeds to the step's seed at the offset the
  generator had at that remat entry in the last eager step
  (:meth:`StepGenerator.rewind_point`).
- **Inputs.** A graph reads fixed buffers: each staged batch (the
  ``DevicePrefetcher``'s stream has been waited on) is copied into the
  graph's static inputs on the replay stream. One graph per batch signature
  (keys, shapes and dtypes); a new signature warms up and captures anew.
- **State.** Parameters, buffers, optimizer slots and the EMA are updated in
  place and never rebound after the first update, so the captured addresses
  stay the live ones. Capture happens inside ``fit``, after any restore.
  A graph destroyed while another is being captured invalidates that
  capture, so the garbage collector runs before a capture and not during
  it, and a trainer's graphs sit in no reference cycle.
- **Warm-up.** The first step of each signature runs eagerly (an ordinary,
  counted step, on the capture stream): it builds and binds the CUDA kernels,
  sets their shared-memory attributes and creates the optimizer's slots.
  Then one step is captured on that side stream, and every later step
  replays it on the current stream.
- **Outputs.** Each replay's metrics are packed into one f32 vector in the
  graph and copied out before the next replay overwrites it.
- **Launch counts.** The kernel wrappers count a launch when Python calls
  them, which under capture launches nothing. A capture gives its counts
  back, and every replay adds them again (``ops.attention.add_launch_counts``),
  so the counts stay the kernels' executions.

There is no fallback: a capture or replay that fails raises.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops import attention as attn

Batch = Dict[str, torch.Tensor]
Signature = Tuple[Tuple[str, Tuple[int, ...], torch.dtype], ...]

# Eager steps of each batch signature before its capture.
WARMUP_STEPS = 1


def step_seed(seed: int, step: int, rank: Optional[int] = None) -> int:
    """A well-mixed 63-bit seed for ``(seed, step)``, or for ``(seed, step,
    rank)``: each block of rows of a data-parallel job (the trainer passes
    ``Mesh.data_index``) draws its own masks."""
    key = [int(seed), int(step)] + ([] if rank is None else [int(rank)])
    return int(np.random.SeedSequence(key)
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


class StepGenerator(torch.Generator):
    """The dropout generator of a trainer: :meth:`reseed` sets it to
    ``step_seed(seed, step)`` (``step_seed(seed, step, rank)`` for the
    processes of a block of rows of a data-parallel job) before every
    step, so a step's masks
    do not depend on earlier steps, and a remat recompute rewinds it with
    :meth:`rewind_point` and :meth:`rewound`, which a CUDA graph can
    capture."""

    def __new__(cls, device: torch.device, seed: int,
                rank: Optional[int] = None):
        return super().__new__(cls, device=device)

    def __init__(self, device: torch.device, seed: int,
                 rank: Optional[int] = None):
        super().__init__()
        self.seed = int(seed)
        self.rank = rank
        # The offset at each remat entry of the last eager step (CUDA).
        self.offsets: List[int] = []
        # Set while a step is captured: one twin per entry in ``offsets``.
        self.capture_twins: Optional[List[torch.Generator]] = None
        self._entries = 0

    def reseed(self, step: int) -> None:
        self.manual_seed(step_seed(self.seed, step, self.rank))
        self._entries = 0

    def rewind_point(self):
        """Mark a remat entry: the state to draw from again in the
        recompute. Eagerly it is the state itself (and, on the card, the
        offset is kept for a later capture); under capture it is the index
        of the twin that will draw in its place."""
        i = self._entries
        self._entries += 1
        if self.capture_twins is not None:
            if i >= len(self.capture_twins):
                raise RuntimeError(
                    f"remat entry {i} under capture, but the eager step "
                    f"before it had {len(self.capture_twins)}")
            return i
        if self.device.type == "cuda":
            del self.offsets[i:]
            self.offsets.append(self.get_offset())
        return self.get_state()

    @contextlib.contextmanager
    def rewound(self, point):
        """Draw from the state at ``point`` inside the block; afterwards
        the generator is where it was before the block."""
        if isinstance(point, int):
            own = self.graphsafe_get_state()
            self.graphsafe_set_state(self.capture_twins[point])
            try:
                yield
            finally:
                self.graphsafe_set_state(own)
            return
        with rewound_to_state(self, point):
            yield


@contextlib.contextmanager
def rewound_to_state(generator: torch.Generator, state: torch.Tensor):
    """Draw from ``generator`` at ``state`` (a ``get_state()``) inside the
    block; afterwards it is where it was before the block."""
    later = generator.get_state()
    generator.set_state(state)
    try:
        yield
    finally:
        generator.set_state(later)


def _signature(batch: Batch) -> Signature:
    return tuple((k, tuple(v.shape), v.dtype) for k, v in batch.items())


def _pack(metrics: Dict[str, torch.Tensor], names: List[str]) -> torch.Tensor:
    return torch.stack([metrics[n].detach().float().reshape(())
                        for n in names])


def _launch_delta(after, before):
    return {name: {v: n - before[name][v] for v, n in by.items()}
            for name, by in after.items()}


class _Graph:
    """One captured step: its graph, static inputs, packed metrics, the
    kernel launches it replays, and its remat twins with their offsets."""

    def __init__(self, graph, static: Batch, out: torch.Tensor, launches,
                 twins: List[torch.Generator], offsets: List[int]):
        self.graph, self.static, self.out = graph, static, out
        self.launches, self.twins, self.offsets = launches, twins, offsets

    def replay(self, trainer, state, batch: Batch) -> torch.Tensor:
        trainer.prepare_step(state)
        seed = trainer.generator.initial_seed()
        for twin, offset in zip(self.twins, self.offsets):
            twin.manual_seed(seed)
            twin.set_offset(offset)
        for k, t in batch.items():
            self.static[k].copy_(t)
        self.graph.replay()
        attn.add_launch_counts(self.launches)
        row = self.out.clone()
        state.advance()
        return row


class GraphedStep:
    """The train steps of a trainer on the card with ``train.step_window``
    K > 1: the first of each batch signature eager, then replays of its
    captured graph (see the module docstring). The trainer is passed to
    each call, not kept: no reference cycle holds a graph past its
    trainer."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(self.device)
        self.graphs: Dict[Signature, _Graph] = {}
        self.eager_steps: Dict[Signature, int] = {}
        self.names: Optional[List[str]] = None

    @property
    def warming_up(self) -> bool:
        """True until the first capture."""
        return not self.graphs

    def window(self, trainer, state, batches) -> Dict[str, torch.Tensor]:
        """``len(batches)`` steps; each metric stacked ``[k]``."""
        rows = torch.stack([self.step(trainer, state, b) for b in batches])
        return {n: rows[:, i] for i, n in enumerate(self.names)}

    def step(self, trainer, state, batch: Batch) -> torch.Tensor:
        """One step; its metrics packed as ``names``."""
        sig = _signature(batch)
        graph = self.graphs.get(sig)
        if graph is None:
            done = self.eager_steps.get(sig, 0)
            if done < WARMUP_STEPS:
                self.eager_steps[sig] = done + 1
                return self._eager(trainer, state, batch)
            graph = self.graphs[sig] = self._capture(trainer, state, batch)
        return graph.replay(trainer, state, batch)

    def _eager(self, trainer, state, batch: Batch) -> torch.Tensor:
        main = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(main)
        with torch.cuda.stream(self.stream):
            for t in batch.values():
                t.record_stream(self.stream)
            metrics = trainer.train_step(state, batch)
            if self.names is None:
                self.names = list(metrics)
            row = _pack(metrics, self.names)
        main.wait_stream(self.stream)
        row.record_stream(main)
        return row

    def _capture(self, trainer, state, batch: Batch) -> _Graph:
        gen = trainer.generator
        static = {k: v.clone() for k, v in batch.items()}
        graph = torch.cuda.CUDAGraph()
        twins = [torch.Generator(device=self.device) for _ in gen.offsets]
        # The binding takes a plain torch.Generator: one that shares the
        # step generator's state registers that state.
        for g in (gen.graphsafe_get_state(), *twins):
            graph.register_generator_state(g)
        trainer.prepare_step(state)
        # Free the warm-up step's gradients before capture: the captured
        # backward makes its own in the graph's memory pool.
        state.optimizer.zero_grad()
        before = attn.launch_counts()
        # A graph destroyed during a capture (a dead trainer's, collected
        # from a reference cycle) invalidates it: collect now, and not
        # again until the capture ends.
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        gen.capture_twins = twins
        try:
            # thread_local: the prefetch thread keeps staging batches (pinned
            # copies on its own stream) while this thread captures.
            with torch.cuda.graph(graph, stream=self.stream,
                                  capture_error_mode="thread_local"):
                out = _pack(trainer.step_body(state, static), self.names)
        finally:
            gen.capture_twins = None
            if collecting:
                gc.enable()
        launches = _launch_delta(attn.launch_counts(), before)
        attn.add_launch_counts(launches, -1)  # a capture launches nothing
        return _Graph(graph, static, out, launches, twins,
                      list(gen.offsets))
