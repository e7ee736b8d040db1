"""The program's random draws, read as it makes them, so that the reference
applies the same dropout masks whatever order, generator or seed the
program draws them with.

Inside :func:`recording`, every random tensor that a PyTorch operator makes
is copied to the host and kept in order: the values of ``rand`` and
``uniform_`` (an element is kept where its value is at least the rate, the
rule of inverted dropout over a uniform draw), the result of ``bernoulli``
(kept where non-zero) and the mask of ``native_dropout``.  :class:`Masks` hands them to the
reference's dropout: each call takes the first draw not yet taken that has
its shape.  A mask that the program makes inside a kernel of its own, and
never as a tensor, cannot be read here; the reference then finds no draw
and the check reads no number.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

UNIFORM = {"rand", "rand_like", "uniform", "uniform_"}
BERNOULLI = {"bernoulli", "bernoulli_"}

Draw = Tuple[str, torch.Tensor]  # ("uniform", values) or ("keep", bool mask)


class _Recorder(TorchDispatchMode):
    def __init__(self, out: List[Draw]):
        super().__init__()
        self.out = out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        result = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        if name in UNIFORM:
            self.out.append(("uniform", result.detach().to("cpu", copy=True)))
        elif name in BERNOULLI:
            self.out.append(("keep", (result.detach() != 0).cpu()))
        elif name == "native_dropout":
            self.out.append(("keep", result[1].detach().bool().cpu()))
        return result


@contextlib.contextmanager
def recording(out: List[Draw]) -> Iterator[None]:
    """Append every random draw made inside the block to ``out``."""
    with _Recorder(out):
        yield


class Masks:
    """The recorded draws, taken by shape in the order they were made."""

    def __init__(self, draws: List[Draw]):
        self.draws = list(draws)
        self.taken = [False] * len(self.draws)

    def keep(self, shape: torch.Size, rate: float, device) -> torch.Tensor:
        for i, (kind, value) in enumerate(self.draws):
            if not self.taken[i] and value.shape == shape:
                self.taken[i] = True
                mask = value >= rate if kind == "uniform" else value
                return mask.to(device)
        raise LookupError(f"the program made no random draw of shape {tuple(shape)} for this dropout")
