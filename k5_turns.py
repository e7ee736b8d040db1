"""Time K5 (segment_softmax_sorted) of this checkout against K5 of another
checkout of the repo, in turns in one process on one NVIDIA GPU.

    python3 k5_turns.py OTHER_TREE

OTHER_TREE is the root of another version of the repo, for example the
parent commit unpacked with ``git archive HEAD~1 | tar -x -C OTHER_TREE``.
Its ``analysisgnn_tpu_torch`` package is imported beside this one's and
builds its own kernels from its own ``csrc/`` into its own ``_build/``.

At chip_smoke.py's two timed shapes of K5 (``k5_timed_shapes``: the HGT
layer's valid union edges of a train batch and of a 20,000-note score,
H = 4), with int32 and with int64 ids, both wrappers' results are held
against this checkout's plain version within chip_smoke.K5_ATOL.  Then, on
the same inputs and in turns, so that a drift of the host's speed reaches
both alike:

* a call: ``chip_smoke.cuda_ms_turns`` over the two wrappers;
* the device: torch.profiler windows of 20 calls, in the order this, other,
  other, this; every kernel a call launches is counted, with no filter by
  name (each must show 20 launches), and listed with its time.

Prints one JSON line per shape and id type, and the card's
``nvidia-smi --query-gpu=name,power.limit`` line.  Exits nonzero without a
GPU or if either version disagrees with the plain version.
"""

from __future__ import annotations

import importlib
import json
import sys
from pathlib import Path

import torch

import chip_smoke as cs

PACKAGE = "analysisgnn_tpu_torch"
ITERS = 20


def import_from_tree(root: Path, module: str):
    """``module`` of the package under ``root``, imported beside this
    checkout's package of the same name, which is left in place."""
    ours = {k: v for k, v in sys.modules.items() if k == PACKAGE or k.startswith(PACKAGE + ".")}
    for k in ours:
        del sys.modules[k]
    sys.path.insert(0, str(root))
    try:
        return importlib.import_module(module)
    finally:
        sys.path.remove(str(root))
        for k in [k for k in sys.modules if k == PACKAGE or k.startswith(PACKAGE + ".")]:
            del sys.modules[k]
        sys.modules.update(ours)


def call_kernels_ms(fn) -> tuple:
    """Device time of one call of ``fn``, all of its kernels, from a profiler
    window of ITERS calls, and ``{kernel: ms a call}``; a window in which a
    kernel shows another count than ITERS is taken again (see
    ``chip_smoke.device_ms``)."""
    pad = torch.zeros(8, device="cuda")

    def padding():
        for _ in range(8):
            pad.add_(1.0)
        torch.cuda.synchronize()

    def calls():
        padding()
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    pad_keys = set()
    for _ in range(cs.PROFILER_ATTEMPTS):
        pad_keys = {e.key for e in cs._cuda_window(padding)}
        if pad_keys:
            break
    for _ in range(cs.PROFILER_ATTEMPTS):
        kernels = [e for e in cs._cuda_window(calls) if e.key not in pad_keys]
        if kernels and all(e.count == ITERS for e in kernels):
            per_kernel = {e.key[:70]: e.self_device_time_total / ITERS / 1e3 for e in kernels}
            return sum(per_kernel.values()), per_kernel
        cs.phase(f"k5 turns: a profiler window held {[(e.key[:40], e.count) for e in kernels]}; taking it again")
    raise AssertionError(f"no profiler window of {ITERS} calls held every kernel {ITERS} times")


def main() -> None:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    other_root = Path(sys.argv[1]).resolve()
    smi = cs.environment()
    other = import_from_tree(other_root, f"{PACKAGE}.kernels.segment_softmax")
    from analysisgnn_tpu_torch.kernels import segment_softmax as this

    if Path(other.__file__).resolve() == Path(this.__file__).resolve():
        raise SystemExit(f"{other_root} is this checkout")
    cs.phase(f"k5 turns: this {this.__file__}, other {other.__file__}")
    batch = cs.train_corpus().sample_batch(device="cuda")
    gen = torch.Generator(device="cpu").manual_seed(5)
    for name, dst, n in cs.k5_timed_shapes(batch):
        e = dst.shape[0]
        logits = (torch.randn(e, 4, generator=gen) * 2).cuda()
        for ids in (dst.to(torch.int32), dst):
            versions = {"this": this.segment_softmax_sorted, "other": other.segment_softmax_sorted}
            fns = {k: (lambda f=f: f(logits, ids, n)) for k, f in versions.items()}
            ref = this.segment_softmax_sorted_plain(logits, ids, n)
            err = {k: float((fn() - ref).abs().max()) for k, fn in fns.items()}
            if max(err.values()) > cs.K5_ATOL:
                raise AssertionError(f"K5 turns {name}: max |kernel - plain| {err} > {cs.K5_ATOL}")
            ms = cs.cuda_ms_turns(fns)
            device = {k: [] for k in fns}
            kernels = {}
            for k in ("this", "other", "other", "this"):
                total, kernels[k] = call_kernels_ms(fns[k])
                device[k].append(total)
            bound_ms, bound_by = cs.k5_bound_ms(e, 4)
            row = {"case": name, "E": e, "H": 4, "ids": str(ids.dtype).removeprefix("torch."), "max_abs_err": err,
                   "ms": ms, "device_ms": device, "kernels": kernels, "bound_ms": bound_ms, "bound_by": bound_by}
            cs.phase(f"k5 turns: {name} E={e} {row['ids']} ids: a call this {ms['this']:.4f} / other "
                     f"{ms['other']:.4f} ms; the device, all kernels of a call, this "
                     f"{'/'.join(f'{t:.4f}' for t in device['this'])} / other "
                     f"{'/'.join(f'{t:.4f}' for t in device['other'])} ms; bound {bound_ms:.5f} ms ({bound_by})")
            print(json.dumps(row), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
