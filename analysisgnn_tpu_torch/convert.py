"""Convert a JAX analysis-model parameter tree into the port's state dict,
and back.

The caller hands over the flax tree as nested dicts of numpy arrays (reading
an Orbax checkpoint needs JAX, so it stays outside this package).  Layout
differences handled here:

* a flax ``Dense`` kernel is ``[in, out]``, a torch ``Linear`` weight
  ``[out, in]``: transposed;
* stacked parameters (``FusedHeteroSage`` ``w_neigh [T, F, F]``, ``w_self``,
  ``w_agg``, ``b_*``; ``FusedTaskHeads`` ``w1``, ``w2``, ``b*``, ``ln_*``) keep
  their layout;
* flax ``OptimizedLSTMCell`` keeps separate ``ii/if/ig/io`` input kernels
  (no bias) and ``hi/hf/hg/ho`` hidden kernels (with bias); the port's
  ``LSTMCell`` packs them in ``i, f, g, o`` order;
* an HGT layer's Dense ``qkv_{t}``, ``out_{t}`` and ``res_{t}`` become
  ``qkv.{t}``, ``out.{t}`` and ``res.{t}`` Linears; its ``watt_{g}``,
  ``wmsg_{g}``, ``prior_{g}`` (``g`` a relation stack: ``g0`` .. or
  ``src__dst``) and scalar ``skip_{t}`` keep their layout, as
  ``watt.{g}`` and so on.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

GATES = ("i", "f", "g", "o")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out: Dict[Tuple[str, ...], np.ndarray] = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v, np.float32)
    return out


def _dense(prefix: str, leaf: str, v: np.ndarray) -> Tuple[str, np.ndarray]:
    if leaf == "kernel":
        return f"{prefix}.weight", v.T
    if leaf == "bias":
        return f"{prefix}.bias", v
    raise KeyError(f"unexpected Dense parameter {leaf!r} under {prefix}")


# HGT layer parameters: flax name prefix -> port ParameterDict / ModuleDict
HGT_LEAVES = ("watt", "wmsg", "prior", "skip")
HGT_DENSES = ("qkv", "out", "res")


def _conv_layer(prefix: str, rest: Tuple[str, ...], v: np.ndarray) -> Tuple[str, np.ndarray]:
    head = rest[0]
    kind, _, name = head.partition("_")
    if kind == "fused" and len(rest) == 2:
        return f"{prefix}.fused.{name}.{rest[1]}", v
    if kind == "conv" and len(rest) == 3:
        return _dense(f"{prefix}.convs.{name}.{rest[1]}", rest[2], v)
    if kind == "self" and len(rest) == 2:
        return _dense(f"{prefix}.selfs.{name}", rest[1], v)
    if kind in HGT_DENSES and len(rest) == 2:
        return _dense(f"{prefix}.{kind}.{name}", rest[1], v)
    if kind in HGT_LEAVES and len(rest) == 1:
        return f"{prefix}.{kind}.{name}", v
    raise KeyError(f"unexpected encoder-layer parameter {'/'.join(rest)} under {prefix}")


def _lstm(flat: Dict[Tuple[str, ...], np.ndarray], cell: str) -> Dict[str, np.ndarray]:
    base = ("encoder", "jk", cell)
    ih = np.concatenate([flat.pop(base + (f"i{g}", "kernel")) for g in GATES], axis=1)
    hh = np.concatenate([flat.pop(base + (f"h{g}", "kernel")) for g in GATES], axis=1)
    hb = np.concatenate([flat.pop(base + (f"h{g}", "bias")) for g in GATES])
    name = {"OptimizedLSTMCell_0": "fwd", "OptimizedLSTMCell_1": "bwd"}[cell]
    return {f"encoder.jk.{name}.ih.weight": ih.T, f"encoder.jk.{name}.hh.weight": hh.T, f"encoder.jk.{name}.hh.bias": hb}


def state_dict_from_flax(params: Mapping, cfg: Mapping) -> Dict[str, torch.Tensor]:
    """The port's ``AnalysisGNN`` state dict for a flax ``AnalysisGNN`` tree
    (``{"params": ...}`` or the inner dict) of the configuration ``cfg``."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    flat = _flatten(params)
    out: Dict[str, np.ndarray] = {}
    for cell in ("OptimizedLSTMCell_0", "OptimizedLSTMCell_1"):
        if ("encoder", "jk", cell, "ii", "kernel") in flat:
            out.update(_lstm(flat, cell))
    layers = set()
    for path, v in flat.items():
        top = path[0]
        if top in ("pitch_embedding", "key_embedding") and path[1:] == ("embedding",):
            key, val = f"{top}.weight", v
        elif top == "project_enc":
            key, val = _dense("project_enc.dense", path[-1], v)
        elif top.startswith("project_"):
            key, val = _dense(f"project.{top[len('project_'):]}.dense", path[-1], v)
        elif top == "heads" and path[1] == "clf" and len(path) == 3:
            key, val = f"heads.clf.{path[2]}", v
        elif top == "encoder" and path[1] == "jk" and path[2] == "Dense_0":
            key, val = _dense("encoder.jk.attn", path[3], v)
        elif top == "encoder" and re.fullmatch(r"layer_\d+", path[1]):
            i = int(path[1].split("_")[1])
            layers.add(i)
            key, val = _conv_layer(f"encoder.layers.{i}", path[2:], v)
        elif top == "encoder" and path[1] == "final":
            key, val = _conv_layer("encoder.final", path[2:], v)
        else:
            raise KeyError(f"no port parameter for flax path {'/'.join(path)}")
        out[key] = val
    if layers != set(range(cfg["num_layers"])):
        raise ValueError(f"parameter tree has encoder layers {sorted(layers)}, config says {cfg['num_layers']}")
    return {k: torch.tensor(v) for k, v in out.items()}


def trainables_from_flax(params: Mapping, mt_params, cfg: Mapping) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """``(state dict, mt_params)`` of the port for the trainables of a JAX
    ``TrainState`` (``state.params``, ``state.mt_params``)."""
    return state_dict_from_flax(params, cfg), torch.tensor(np.asarray(mt_params, np.float32))


def _conv_path(rest: str) -> Tuple[str, ...]:
    kind, name, *leaf = rest.split(".")
    dense_leaf = {"weight": "kernel", "bias": "bias"}
    if kind == "fused":
        return (f"fused_{name}", *leaf)
    if kind == "convs":
        return (f"conv_{name}", leaf[0], dense_leaf[leaf[1]])
    if kind == "selfs":
        return (f"self_{name}", dense_leaf[leaf[0]])
    if kind in HGT_DENSES:
        return (f"{kind}_{name}", dense_leaf[leaf[0]])
    if kind in HGT_LEAVES and not leaf:
        return (f"{kind}_{name}",)
    raise KeyError(f"unexpected encoder-layer parameter {rest}")


def flax_tree_from_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, object]:
    """The flax ``AnalysisGNN`` parameter tree (the inner dict, numpy leaves)
    of a port state dict: the inverse of :func:`state_dict_from_flax`."""
    tree: Dict[str, object] = {}

    def put(path: Tuple[str, ...], v: np.ndarray) -> None:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(v).reshape(v.shape)  # keeps a 0-d leaf 0-d

    dense_leaf = {"weight": "kernel", "bias": "bias"}
    for key, t in state_dict.items():
        v = t.detach().cpu().numpy()
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "weight" and v.ndim == 2 and "embedding" not in key:
            v = v.T  # torch Linear [out, in] -> flax Dense kernel [in, out]
        m = re.fullmatch(r"encoder\.jk\.(fwd|bwd)\.(ih|hh)\.(weight|bias)", key)
        if key.endswith("_embedding.weight"):
            put((key.split(".")[0], "embedding"), v)
        elif m:
            cell = {"fwd": "OptimizedLSTMCell_0", "bwd": "OptimizedLSTMCell_1"}[m.group(1)]
            for gate, part in zip(GATES, np.split(v, 4, axis=-1)):
                put(("encoder", "jk", cell, f"{m.group(2)[0]}{gate}", dense_leaf[m.group(3)]), part)
        elif key.startswith("encoder.jk.attn."):
            put(("encoder", "jk", "Dense_0", dense_leaf[leaf]), v)
        elif key.startswith("project_enc.dense."):
            put(("project_enc", "Dense_0", dense_leaf[leaf]), v)
        elif key.startswith("project."):
            put((f"project_{key.split('.')[1]}", "Dense_0", dense_leaf[leaf]), v)
        elif key.startswith("heads.clf."):
            put(("heads", "clf", leaf), v)
        elif m := re.fullmatch(r"encoder\.layers\.(\d+)\.(.+)", key):
            put(("encoder", f"layer_{m.group(1)}", *_conv_path(m.group(2))), v)
        elif key.startswith("encoder.final."):
            put(("encoder", "final", *_conv_path(key[len("encoder.final."):])), v)
        else:
            raise KeyError(f"no flax path for port parameter {key}")
    return tree
