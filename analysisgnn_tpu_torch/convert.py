"""Convert a JAX parameter tree into the port's state dict, and back: the
analysis model (``state_dict_from_flax`` / ``flax_tree_from_state_dict``),
with any of the three encoders and ``use_rnn``, and the other model families
(``chord_state_dict_from_flax`` / ``flax_tree_from_chord_state_dict``:
``ChordPredictionModel``, ``PostProcessingMLT``, the pitch-spelling and
cadence models and each of their modules).

The caller hands over the flax tree as nested dicts of numpy arrays (reading
an Orbax checkpoint needs JAX, so it stays outside this package).  Layout
differences handled here:

* a flax ``Dense`` kernel is ``[in, out]``, a torch ``Linear`` weight
  ``[out, in]``: transposed;
* stacked parameters (``FusedHeteroSage`` ``w_neigh [T, F, F]``, ``w_self``,
  ``w_agg``, ``b_*``; ``FusedTaskHeads`` ``w1``, ``w2``, ``b*``, ``ln_*``) keep
  their layout; a hetero layer's ``fused_{t}`` is ``fused.{t}``, its
  ``conv_{src}__{rel}__{dst}`` SageConv is ``convs.{src}__{rel}__{dst}`` and
  its ``self_{t}`` Dense ``selfs.{t}``;
* flax ``LayerNorm_i`` / ``Dense_i`` of a deep projection are ``norm_i`` /
  ``dense_i``; a LayerNorm's ``scale`` is the torch ``weight``;
* the logit-fusion heads' ``proj_{task}``, ``projnorm_{task}`` and
  ``fusion_{task}`` are ``proj.{task}`` and so on; the cross-task attention's
  ``query``/``key``/``value`` kernels ``[in, heads, head_dim]`` (bias
  ``[heads, head_dim]``) and ``out`` kernel ``[heads, head_dim, out]`` are
  Linears over the flattened ``heads * head_dim`` axis;
* a flax ``GRUCell`` (``ir, iz, in`` input Denses with bias, ``hr, hz``
  hidden Denses without, ``hn`` with) is one direction of ``nn.GRU``: the
  kernels concatenated in ``r, z, n`` order and transposed, ``b_hh =
  [0, 0, b_hn]``; a ``BiResetGRU``'s ``ResetGRU_0`` / ``ResetGRU_1`` are the
  forward and ``_reverse`` directions;
* flax ``OptimizedLSTMCell`` keeps separate ``ii/if/ig/io`` input kernels
  (no bias) and ``hi/hf/hg/ho`` hidden kernels (with bias); the port's
  ``LSTMCell`` packs them in ``i, f, g, o`` order;
* an HGT layer's Dense ``qkv_{t}``, ``out_{t}`` and ``res_{t}`` become
  ``qkv.{t}``, ``out.{t}`` and ``res.{t}`` Linears; its ``watt_{g}``,
  ``wmsg_{g}``, ``prior_{g}`` (``g`` a relation stack: ``g0`` .. or
  ``src__dst``) and scalar ``skip_{t}`` keep their layout, as
  ``watt.{g}`` and so on;
* an encoder's ``layer_i`` is ``layers.i`` (``HierarchicalHeteroSage``'s
  ``conv_i``: ``convs.i``); MetricalGNN's ``emb_{t}s``,
  ``project_metrical_i`` and ``{t}_conv_i`` keep their names, and in a
  ``MetricalConv`` the ``LayerNorm_0`` is ``norm_0`` and an ``AssocBiGRU``'s
  ``AssocResetGRU_0`` / ``AssocResetGRU_1`` are ``fwd`` / ``bwd``;
  ``StackedBiGRU``'s ``layer_i`` and ``proj_i`` keep their names;
* the edge decoder's ``embed_{rel}_dense`` / ``embed_{rel}_norm`` are
  ``embed_dense.{rel}`` / ``embed_norm.{rel}``; its ``fc_dense1``,
  ``fc_norm`` and ``fc_dense2`` keep their names.

The layer zoo and the pre-training encoder (``zoo_state_dict_from_flax``:
``PreEncoder``, ``HGPS``, ``HResGatedConv``, ``OnsetEmbedding``,
``ResGatedConv``, ``GATConv``, ``UNet`` and their parts; no JAX code reads
the port's weights back, so there is no inverse) add:

* a ``PreEncoder``'s ``encoder`` is an HGT encoder as above, its heads'
  ``Dense_i`` / ``LayerNorm_i`` are ``dense_i`` / ``norm_i``;
* ``layer_i`` is ``layers.i``; a hetero layer's ``conv_{src}__{rel}__{dst}``
  and ``self_{t}`` are ``convs.{...}`` and ``selfs.{t}``; an HGPS layer's
  ``local_{rel}`` is ``local.{rel}`` and its Dense ``embedding`` ``embed``;
* an attention's ``query``/``key``/``value`` kernels ``[F, H, D]`` (bias
  ``[H, D]``) and ``out`` kernel ``[H, D, F]`` are Linears over the flattened
  ``H * D`` axis, as in the cross-task attention;
* a flax ``Conv`` kernel ``[kh, kw, in, out]`` is an ``nn.Conv2d`` weight
  ``[out, in, kh, kw]``; ``ConvBlock_i``, ``Conv_i`` and ``GroupNorm_i`` are
  ``blocks.i``, ``convs.i`` and ``norms.i``;
* any other leaf (``GATConv``'s ``attnl`` / ``attnr``) keeps its name and
  layout.
"""

from __future__ import annotations

import re
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

GATES = ("i", "f", "g", "o")
GRU_GATES = ("r", "z", "n")
# heads of the cross-task attention (models/heads.py)
XTASK_HEADS = 4


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


_ASSOC_DIRECTIONS = {"AssocResetGRU_0": "fwd", "AssocResetGRU_1": "bwd"}
_FLAX_ASSOC = {v: k for k, v in _ASSOC_DIRECTIONS.items()}
_METRICAL_CONV = re.compile(r"(?:beat|measure)_conv_\d+")
# encoder children that are one Dense under the same name in both packages
_ENCODER_DENSE = re.compile(r"emb_\w+|project_metrical_\d+|lin")
# the port's names of an encoder's children (HybridGNN, HybridHGT, MetricalGNN, HierarchicalHeteroSage)
_ENCODER_CHILD = re.compile(r"layers|final|convs|jk|emb_\w+|project_metrical_\d+|lin|(?:beat|measure)_conv_\d+")
_FLAX_ENCODER_CHILD = re.compile(r"layer_\d+|final|conv_\d+|jk|emb_\w+|project_metrical_\d+|lin|"
                                 r"(?:beat|measure)_conv_\d+")


def _encoder_param(prefix: str, rest: Tuple[str, ...], v: np.ndarray) -> Tuple[str, np.ndarray]:
    """A parameter of an encoder's subtree (``rest`` below the encoder) as
    the port's key under ``prefix``; GRU cells and the JK's LSTM cells are
    converted apart (:func:`_pop_gru_cells`, :func:`_lstm`)."""
    head = rest[0]
    if m := re.fullmatch(r"(layer|conv)_(\d+)", head):
        return _conv_layer(f"{prefix}.{m.group(1)}s.{m.group(2)}", rest[1:], v)
    if head == "final":
        return _conv_layer(f"{prefix}.final", rest[1:], v)
    if head == "jk" and rest[1:2] == ("Dense_0",):
        return _dense(f"{prefix}.jk.attn", rest[2], v)
    if _ENCODER_DENSE.fullmatch(head) and len(rest) == 2:
        return _dense(f"{prefix}.{head}", rest[1], v)
    if _METRICAL_CONV.fullmatch(head):
        sub = rest[1]
        if sub in ("neigh", "out") and len(rest) == 3:
            return _dense(f"{prefix}.{head}.{sub}", rest[2], v)
        if sub == "LayerNorm_0" and len(rest) == 3:
            return _leaf(f"{prefix}.{head}.norm_0", rest[2], v)
        if sub == "seq" and rest[2] in _ASSOC_DIRECTIONS and rest[3] == "gates" and len(rest) == 5:
            return _dense(f"{prefix}.{head}.seq.{_ASSOC_DIRECTIONS[rest[2]]}.gates", rest[4], v)
    raise KeyError(f"unexpected encoder parameter {'/'.join(rest)} under {prefix}")


def _encoder_flax_path(rest: Sequence[str]) -> Tuple[str, ...]:
    """The flax path below an encoder of the port's key parts ``rest`` below
    it (the inverse of :func:`_encoder_param`)."""
    dense_leaf = {"weight": "kernel", "bias": "bias"}
    head = rest[0]
    if head in ("layers", "convs"):
        return (f"{head[:-1]}_{rest[1]}", *_conv_path(".".join(rest[2:])))
    if head == "final":
        return ("final", *_conv_path(".".join(rest[1:])))
    if head == "jk" and rest[1] == "attn":
        return ("jk", "Dense_0", dense_leaf[rest[2]])
    if _ENCODER_DENSE.fullmatch(head) and len(rest) == 2:
        return (head, dense_leaf[rest[1]])
    if _METRICAL_CONV.fullmatch(head):
        if rest[1] in ("neigh", "out") and len(rest) == 3:
            return (head, rest[1], dense_leaf[rest[2]])
        if rest[1] == "norm_0" and len(rest) == 3:
            return (head, "LayerNorm_0", "scale" if rest[2] == "weight" else "bias")
        if rest[1] == "seq" and rest[2] in _FLAX_ASSOC and len(rest) == 5:
            return (head, "seq", _FLAX_ASSOC[rest[2]], "gates", dense_leaf[rest[4]])
    raise KeyError(f"unexpected encoder parameter {'.'.join(rest)}")


def _pop_gru_cells(flat: Dict[Tuple[str, ...], np.ndarray], module_name) -> Dict[str, np.ndarray]:
    """Take every flax ``GRUCell`` out of ``flat`` and return the port's
    ``nn.GRU`` entries: a cell below ``owner/cell/GRUCell_0`` is the ``rnn``
    of the port module at ``owner`` (each name mapped by ``module_name``),
    and a ``BiResetGRU``'s ``ResetGRU_0`` / ``ResetGRU_1`` are its forward
    and ``_reverse`` directions."""
    cells: Dict[Tuple[str, str], Dict[Tuple[str, str], np.ndarray]] = {}
    for path in [p for p in flat if "GRUCell_0" in p]:
        i = path.index("GRUCell_0")
        owner, suffix = path[: i - 1], ""
        if owner and owner[-1] in _GRU_DIRECTIONS:  # a BiResetGRU's direction
            owner, suffix = owner[:-1], _GRU_DIRECTIONS[owner[-1]]
        prefix = ".".join(module_name(c) for c in owner)
        cells.setdefault((prefix, suffix), {})[path[i + 1:]] = flat.pop(path)
    out: Dict[str, np.ndarray] = {}
    for (prefix, suffix), gates in cells.items():
        rnn = f"{prefix}.rnn" if prefix else "rnn"
        out[f"{rnn}.weight_ih_l0{suffix}"] = np.concatenate([gates[(f"i{g}", "kernel")] for g in GRU_GATES], 1).T
        out[f"{rnn}.bias_ih_l0{suffix}"] = np.concatenate([gates[(f"i{g}", "bias")] for g in GRU_GATES])
        out[f"{rnn}.weight_hh_l0{suffix}"] = np.concatenate([gates[(f"h{g}", "kernel")] for g in GRU_GATES], 1).T
        b_hn = gates[("hn", "bias")]
        out[f"{rnn}.bias_hh_l0{suffix}"] = np.concatenate([np.zeros_like(b_hn), np.zeros_like(b_hn), b_hn])
    return out


_GRU_KEY = re.compile(r"(?:(.+)\.)?rnn\.(weight|bias)_(ih|hh)_l0(_reverse)?")


def _put_gru(put, owner: List[str], key: str, m: "re.Match", v: np.ndarray) -> None:
    """One ``nn.GRU`` tensor as the flax ``GRUCell`` of the module at
    ``owner`` (its ``ResetGRU_0`` / ``ResetGRU_1`` already appended for a
    bidirectional one).  Hidden biases of the ``r`` and ``z`` gates that are
    not zero have no flax counterpart and raise."""
    kind = "i" if m.group(3) == "ih" else "h"
    for g, part in zip(GRU_GATES, np.split(v, 3, axis=0)):
        cell = owner + ["cell", "GRUCell_0", f"{kind}{g}"]
        if m.group(2) == "weight":
            put(cell + ["kernel"], part.T)
        elif kind == "i" or g == "n":
            put(cell + ["bias"], part)
        elif np.any(part != 0):
            raise ValueError(f"{key}: the {g} gate's hidden bias is not zero; a flax GRUCell has none")


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


_FUSION = ("proj", "projnorm", "fusion")


def _leaf(prefix: str, leaf: str, v: np.ndarray) -> Tuple[str, np.ndarray]:
    """A Dense (``kernel`` transposed), LayerNorm (``scale``) or Embed leaf."""
    if leaf == "kernel":
        return f"{prefix}.weight", v.T
    if leaf in ("scale", "embedding"):
        return f"{prefix}.weight", v
    if leaf == "bias":
        return f"{prefix}.bias", v
    raise KeyError(f"unexpected parameter {leaf!r} under {prefix}")


def _auto_name(name: str) -> str:
    """flax ``Dense_i`` / ``LayerNorm_i`` -> the port's ``dense_i`` / ``norm_i``."""
    m = re.fullmatch(r"(Dense|LayerNorm)_(\d+)", name)
    if not m:
        raise KeyError(f"unexpected flax module {name!r}")
    return f"{'dense' if m.group(1) == 'Dense' else 'norm'}_{m.group(2)}"


def _flax_auto_name(name: str) -> str:
    m = re.fullmatch(r"(dense|norm)_(\d+)", name)
    return f"{'Dense' if m.group(1) == 'dense' else 'LayerNorm'}_{m.group(2)}" if m else name


def _xtask(rest: Tuple[str, ...], v: np.ndarray) -> Tuple[str, np.ndarray]:
    """The cross-task attention: ``MultiHeadDotProductAttention_0/{query,key,
    value,out}/{kernel,bias}`` and ``LayerNorm_0``."""
    if rest[0] == "LayerNorm_0":
        return _leaf("heads.xtask.norm", rest[1], v)
    if rest[0] != "MultiHeadDotProductAttention_0" or len(rest) != 3:
        raise KeyError(f"unexpected cross-task attention parameter {'/'.join(rest)}")
    proj, leaf = rest[1], rest[2]
    if proj == "out":
        return (f"heads.xtask.out.weight", v.reshape(-1, v.shape[-1]).T) if leaf == "kernel" else (
            "heads.xtask.out.bias", v)
    if leaf == "kernel":
        return f"heads.xtask.{proj}.weight", v.reshape(v.shape[0], -1).T
    return f"heads.xtask.{proj}.bias", v.reshape(-1)


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
    out: Dict[str, np.ndarray] = _pop_gru_cells(flat, lambda name: name)
    for cell in ("OptimizedLSTMCell_0", "OptimizedLSTMCell_1"):
        if ("encoder", "jk", cell, "ii", "kernel") in flat:
            out.update(_lstm(flat, cell))
    layers = set()
    # a projection with more than its one Dense_0 is a deep one (plain_proj=False)
    deep = {p[0] for p in flat if p[0].startswith("project") and p[1] != "Dense_0"}
    for path, v in flat.items():
        top = path[0]
        if top in ("pitch_embedding", "key_embedding") and path[1:] == ("embedding",):
            key, val = f"{top}.weight", v
        elif top.startswith("project"):
            name = "project_enc" if top == "project_enc" else f"project.{top[len('project_'):]}"
            key, val = (_leaf(f"{name}.{_auto_name(path[1])}", path[2], v) if top in deep
                        else _dense(f"{name}.dense", path[-1], v))
        elif top == "heads" and path[1] == "clf" and len(path) == 3:
            key, val = f"heads.clf.{path[2]}", v
        elif top == "heads" and path[1] == "xtask":
            key, val = _xtask(path[2:], v)
        elif top == "heads" and len(path) == 3 and path[1].split("_", 1)[0] in _FUSION:
            kind, task = path[1].split("_", 1)
            key, val = _leaf(f"heads.{kind}.{task}", path[2], v)
        elif top == "encoder":
            if re.fullmatch(r"layer_\d+", path[1]):
                layers.add(int(path[1].split("_")[1]))
            key, val = _encoder_param("encoder", path[1:], v)
        elif top == "rnn" and re.fullmatch(r"proj_\d+", path[1]) and len(path) == 3:
            key, val = _dense(f"rnn.{path[1]}", path[2], v)
        elif top in ("rnn_norm", "rnn_proj") and len(path) == 2:
            key, val = _leaf(top, path[1], v)
        elif top == "edge_decoder" and (m := re.fullmatch(r"embed_(\w+)_(dense|norm)", path[1])):
            key, val = _leaf(f"edge_decoder.embed_{m.group(2)}.{m.group(1)}", path[2], v)
        elif top == "edge_decoder" and path[1] in ("fc_dense1", "fc_norm", "fc_dense2"):
            key, val = _leaf(f"edge_decoder.{path[1]}", path[2], v)
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
        if m := _GRU_KEY.fullmatch(key):  # a BiResetGRU's nn.GRU: MetricalConv's seq or use_rnn's layers
            _put_gru(put, m.group(1).split(".") + ["ResetGRU_1" if m.group(4) else "ResetGRU_0"], key, m, v)
            continue
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
        elif m := re.fullmatch(r"rnn\.(proj_\d+)\.(weight|bias)", key):
            put(("rnn", m.group(1), dense_leaf[leaf]), v)
        elif m := re.fullmatch(r"(rnn_norm|rnn_proj)\.(weight|bias)", key):
            put((m.group(1), _flax_leaf(m.group(1), leaf, v)), v)
        elif m := re.fullmatch(r"project(?:_enc|\.(\w+))\.(\w+)\.(weight|bias)", key):
            top = f"project_{m.group(1)}" if m.group(1) else "project_enc"
            module = "Dense_0" if m.group(2) == "dense" else _flax_auto_name(m.group(2))
            put((top, module, _flax_leaf(module, leaf, v)), v)
        elif key.startswith("heads.clf."):
            put(("heads", "clf", leaf), v)
        elif m := re.fullmatch(r"heads\.(proj|projnorm|fusion)\.(\w+)\.(weight|bias)", key):
            put(("heads", f"{m.group(1)}_{m.group(2)}", _flax_leaf(m.group(1), leaf, v)), v)
        elif m := re.fullmatch(r"heads\.xtask\.(query|key|value|out|norm)\.(weight|bias)", key):
            if m.group(1) == "norm":
                put(("heads", "xtask", "LayerNorm_0", "scale" if leaf == "weight" else "bias"), v)
                continue
            attn = ("heads", "xtask", "MultiHeadDotProductAttention_0", m.group(1))
            if m.group(1) == "out":  # v is the kernel [H * D, out] (transposed above) or the bias
                put(attn + (dense_leaf[leaf],), v.reshape(XTASK_HEADS, -1, v.shape[-1]) if leaf == "weight" else v)
            else:
                put(attn + (dense_leaf[leaf],), v.reshape(v.shape[0], XTASK_HEADS, -1) if leaf == "weight"
                    else v.reshape(XTASK_HEADS, -1))
        elif key.startswith("encoder."):
            put(("encoder", *_encoder_flax_path(key.split(".")[1:])), v)
        elif m := re.fullmatch(r"edge_decoder\.embed_(dense|norm)\.(\w+)\.(weight|bias)", key):
            put(("edge_decoder", f"embed_{m.group(2)}_{m.group(1)}", _flax_leaf(m.group(1), leaf, v)), v)
        elif m := re.fullmatch(r"edge_decoder\.(fc_dense1|fc_norm|fc_dense2)\.(weight|bias)", key):
            put(("edge_decoder", m.group(1), _flax_leaf(m.group(1), leaf, v)), v)
        else:
            raise KeyError(f"no flax path for port parameter {key}")
    return tree


def _flax_leaf(module: str, leaf: str, v: np.ndarray) -> str:
    """The flax leaf of a torch ``weight`` / ``bias`` of a Linear (``kernel``),
    a LayerNorm (1-D ``weight``: ``scale``) or an Embedding."""
    if leaf == "bias":
        return "bias"
    if v.ndim == 1:
        return "scale"
    return "embedding" if module.endswith("embedding") and module != "embedding" else "kernel"


# ------------------------------------------------------------------ chord family

# flax per-task / per-node-type name prefixes -> the port's ModuleDicts
_CHORD_DICTS = {"head": "heads", "logits": "logits", "cond": "cond", "norm": "norm", "out": "out", "x_map": "x_map"}
_CHORD_DICT_NAMES = {v: k for k, v in _CHORD_DICTS.items()}
_GRU_DIRECTIONS = {"ResetGRU_0": "", "ResetGRU_1": "_reverse"}


def _chord_module(name: str) -> str:
    """One flax module name of the chord family as the port's path."""
    if name in _ASSOC_DIRECTIONS:
        return _ASSOC_DIRECTIONS[name]
    for prefix, port in _CHORD_DICTS.items():
        if name.startswith(prefix + "_") and not re.fullmatch(r"\d+", name[len(prefix) + 1:]):
            return f"{port}.{name[len(prefix) + 1:]}"
    return _auto_name(name) if re.fullmatch(r"(Dense|LayerNorm)_\d+", name) else name


def _encoder_index(path: Sequence[str], child: "re.Pattern") -> int:
    """The index of the first ``gnn`` or ``encoder`` in ``path`` whose next
    name is an encoder's child (``ChordPredictionModel``'s ``encoder`` holds
    a ``gnn``; the pitch-spelling and cadence models' ``encoder`` and
    ``CadenceGNNNeighbor``'s ``gnn`` are encoders), or -1."""
    for i, name in enumerate(path[:-1]):
        if name in ("gnn", "encoder") and child.fullmatch(path[i + 1]):
            return i
    return -1


def chord_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state dict of a chord-family, pitch-spelling or cadence
    module (``ChordPredictionModel``, ``PostProcessingMLT``, ``PKSpell``,
    ``PitchSpellingGNN``, ``CadenceGNN``, ... or any of their modules) for its
    flax tree (``{"params": ...}`` or the inner dict)."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    flat = _flatten(params)
    out: Dict[str, np.ndarray] = _pop_gru_cells(flat, _chord_module)
    for path, v in flat.items():
        i = _encoder_index(path, _FLAX_ENCODER_CHILD)
        if i >= 0:
            prefix = ".".join([_chord_module(c) for c in path[:i]] + [path[i]])
            key, val = _encoder_param(prefix, path[i + 1:], v)
        else:
            key, val = _leaf(".".join(_chord_module(c) for c in path[:-1]), path[-1], v)
        out[key] = val
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in out.items()}


def flax_tree_from_chord_state_dict(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, object]:
    """The flax tree (inner dict, numpy leaves) of a state dict of
    :func:`chord_state_dict_from_flax`'s modules: its inverse.  A GRU whose
    hidden biases of the ``r`` and ``z`` gates are not zero has no flax
    counterpart and raises."""
    tree: Dict[str, object] = {}

    def put(path: Sequence[str], v: np.ndarray) -> None:
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.ascontiguousarray(v)

    def modules(parts: Sequence[str]) -> List[str]:
        out, i = [], 0
        while i < len(parts):
            if parts[i] in _CHORD_DICT_NAMES and i + 1 < len(parts):
                out.append(f"{_CHORD_DICT_NAMES[parts[i]]}_{parts[i + 1]}")
                i += 2
            elif parts[i] in _FLAX_ASSOC:
                out.append(_FLAX_ASSOC[parts[i]])
                i += 1
            else:
                out.append(_flax_auto_name(parts[i]))
                i += 1
        return out

    reverse_owners = {m.group(1) or "" for m in map(_GRU_KEY.fullmatch, state_dict) if m and m.group(4)}
    for key, t in state_dict.items():
        v = t.detach().cpu().numpy()
        parts = key.split(".")
        if m := _GRU_KEY.fullmatch(key):
            owner_parts = m.group(1).split(".") if m.group(1) else []
            i = _encoder_index(owner_parts, _ENCODER_CHILD)
            if i >= 0:  # a MetricalConv's BiResetGRU (seq_impl="scan")
                owner = modules(owner_parts[:i]) + [owner_parts[i], *owner_parts[i + 1:]]
            else:
                owner = modules(owner_parts)
            if (m.group(1) or "") in reverse_owners:
                owner.append("ResetGRU_1" if m.group(4) else "ResetGRU_0")
            _put_gru(put, owner, key, m, v)
            continue
        i = _encoder_index(parts, _ENCODER_CHILD)
        if i >= 0:  # an encoder holds no embedding: every 2-D weight is a Linear's
            put(modules(parts[:i]) + [parts[i], *_encoder_flax_path(parts[i + 1:])],
                v.T if parts[-1] == "weight" and v.ndim == 2 else v)
            continue
        path = modules(parts[:-1])
        leaf = _flax_leaf(path[-1], parts[-1], v)
        put(path + [leaf], v.T if leaf == "kernel" else v)
    return tree


_ZOO_LISTS = {"layer": "layers", "ConvBlock": "blocks", "Conv": "convs", "GroupNorm": "norms"}
_ZOO_DICTS = {"local": "local", "conv": "convs", "self": "selfs"}


def _zoo_module(name: str) -> str:
    """One flax module name of the layer zoo as the port's path."""
    if m := re.fullmatch(r"(layer|ConvBlock|Conv|GroupNorm)_(\d+)", name):
        return f"{_ZOO_LISTS[m.group(1)]}.{m.group(2)}"
    if m := re.fullmatch(r"(Dense|LayerNorm)_\d+", name):
        return _auto_name(name)
    if m := re.fullmatch(r"(local|conv|self)_(.+)", name):
        return f"{_ZOO_DICTS[m.group(1)]}.{m.group(2)}"
    return "embed" if name == "embedding" else name


def _zoo_leaf(module: str, leaf: str, v: np.ndarray) -> Tuple[str, np.ndarray]:
    """A leaf of the layer zoo: the port's leaf name and layout."""
    if leaf == "kernel" and v.ndim == 4:  # Conv [kh, kw, in, out]
        return "weight", v.transpose(3, 2, 0, 1)
    if leaf == "kernel" and v.ndim == 3:  # attention: out [H, D, F], query / key / value [F, H, D]
        return "weight", (v.reshape(-1, v.shape[-1]) if module == "out" else v.reshape(v.shape[0], -1)).T
    if leaf == "kernel":
        return "weight", v.T
    if leaf == "bias":
        return "bias", v.reshape(-1)
    if leaf == "scale":
        return "weight", v
    return leaf, v


def zoo_state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state dict of a flax layer-zoo module's tree
    (``{"params": ...}`` or the inner dict): ``PreEncoder``, ``HGPS``,
    ``HGPSLayer``, ``HResGatedConv``, ``OnsetEmbedding``, ``ResGatedConv``,
    ``GATConv``, ``UNet`` or ``ConvBlock``."""
    if "params" in params and isinstance(params["params"], Mapping):
        params = params["params"]
    flat = _flatten(params)
    out: Dict[str, np.ndarray] = {}
    for cell in ("OptimizedLSTMCell_0", "OptimizedLSTMCell_1"):
        if ("encoder", "jk", cell, "ii", "kernel") in flat:
            out.update(_lstm(flat, cell))
    for path, v in flat.items():
        if path[0] == "encoder":  # the PreEncoder's HybridHGT
            key, val = _encoder_param("encoder", path[1:], v)
        else:
            leaf, val = _zoo_leaf(path[-2] if len(path) > 1 else "", path[-1], v)
            key = ".".join([_zoo_module(c) for c in path[:-1]] + [leaf])
        out[key] = val
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in out.items()}
