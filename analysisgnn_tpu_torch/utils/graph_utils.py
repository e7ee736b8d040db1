"""Graph utility ops on the host (counterpart of
``analysisgnn_tpu/utils/graph_utils.py``, the same numpy/scipy code, so the
two give equal arrays): degrees, Laplacian positional encodings, voice
assignment from edges, induced subgraphs and disjoint-union batching.

Reference: analysisgnn/models/core/graph_utils.py:7-53 (``degree`` and the
Laplacian-eigenvector ``positional_encoding``) plus the hgraph helpers
``voice_from_edges`` / ``adj_matrix_from_edges`` (analysisgnn/utils/
hgraph.py:333-352), ``node_subgraph`` (:404-452) and ``batch_graphs``
(:468-489).  These are pre- and post-processing ops; on-device batching is
the sampler's job (data/sampler.py).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def degree(edge_index: np.ndarray, num_nodes: int, direction: str = "out") -> np.ndarray:
    idx = edge_index[0] if direction == "out" else edge_index[1]
    idx = idx[idx < num_nodes]
    return np.bincount(idx, minlength=num_nodes).astype(np.float32)


def laplacian_positional_encoding(
    edge_index: np.ndarray, num_nodes: int, k: int = 8
) -> np.ndarray:
    """First-k nontrivial eigenvectors of the symmetric-normalized Laplacian
    (sign-randomization left to the caller)."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.linalg import eigsh

    src, dst = edge_index[0], edge_index[1]
    keep = (src < num_nodes) & (dst < num_nodes)
    src, dst = src[keep], dst[keep]
    data = np.ones(len(src))
    a = coo_matrix((data, (src, dst)), shape=(num_nodes, num_nodes))
    a = ((a + a.T) > 0).astype(np.float64)
    deg = np.asarray(a.sum(1)).ravel()
    d_inv_sqrt = 1.0 / np.sqrt(np.maximum(deg, 1.0))
    lap = coo_matrix(np.eye(num_nodes) - (a.multiply(d_inv_sqrt[:, None])).multiply(d_inv_sqrt[None, :]))
    k_eff = min(k + 1, num_nodes - 1)
    if k_eff < 1:
        return np.zeros((num_nodes, k), np.float32)
    vals, vecs = eigsh(lap.tocsc(), k=k_eff, which="SM")
    order = np.argsort(vals)
    vecs = vecs[:, order][:, 1 : k + 1]  # drop the trivial eigenvector
    out = np.zeros((num_nodes, k), np.float32)
    out[:, : vecs.shape[1]] = vecs
    return out


def adj_matrix_from_edges(edge_index: np.ndarray, num_nodes: int):
    """Sparse CSR adjacency from a ``[2, E]`` edge list (reference
    ``adj_matrix_from_edges``, hgraph.py:345-352)."""
    from scipy.sparse import csr_matrix

    src, dst = np.asarray(edge_index[0]), np.asarray(edge_index[1])
    keep = (src < num_nodes) & (dst < num_nodes)
    src, dst = src[keep], dst[keep]
    return csr_matrix(
        (np.ones(len(src)), (src, dst)), shape=(num_nodes, num_nodes)
    )


def voice_from_edges(
    edge_index: np.ndarray, num_nodes: int
) -> Tuple[np.ndarray, int]:
    """Assign each connected component a unique 1-based voice number.

    Used to turn predicted same-voice note edges (the pre-encoder's voice
    task, models/pre_encoder.py) into discrete voice ids.  Reference:
    ``voice_from_edges`` (analysisgnn/utils/hgraph.py:333-341).

    Returns ``(voices, number_of_voices)`` with ``voices[i] >= 1``.
    """
    from scipy.sparse.csgraph import connected_components

    n_comp, labels = connected_components(
        csgraph=adj_matrix_from_edges(edge_index, num_nodes),
        directed=False,
        return_labels=True,
    )
    return labels.astype(np.int64) + 1, int(n_comp)


def node_subgraph(
    edges: Dict, num_nodes: Dict[str, int], notes: np.ndarray
) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """Induced typed subgraph on a set of note ids.

    ``edges`` maps edge types — ``(src_type, relation, dst_type)`` tuples —
    to ``[2, E]`` int arrays; ``num_nodes`` gives the per-type node counts.
    Keeps a non-note node (beat/measure) iff it remains connected to a kept
    note; beat→beat / measure→measure chain edges survive only when BOTH
    endpoints are kept (an intermediate dropped beat breaks the chain — no
    new shortcut edges are synthesized, unlike the reference's contiguous
    window slicing which cannot create gaps).  Node ids are relabeled
    compactly per type.

    Unlike the reference ``node_subgraph`` (hgraph.py:404-452), which
    assumes a *contiguous* note window (it subtracts ``nodes.min()``), this
    accepts any id set — the relabeling is a searchsorted over the sorted
    kept ids.  Returns ``(sub_edges, keep_ids_per_type)``.
    """
    notes = np.unique(np.asarray(notes, dtype=np.int64))
    keep: Dict[str, np.ndarray] = {"note": notes}
    # non-note nodes survive iff referenced by a kept note's cross edge
    for t in num_nodes:
        if t == "note":
            continue
        referenced = []
        for (src_t, _rel, dst_t), ei in edges.items():
            if src_t == "note" and dst_t == t:
                referenced.append(ei[1][np.isin(ei[0], notes)])
            elif src_t == t and dst_t == "note":
                referenced.append(ei[0][np.isin(ei[1], notes)])
        keep[t] = (
            np.unique(np.concatenate(referenced))
            if referenced
            else np.zeros(0, np.int64)
        )

    def _relabel(ids: np.ndarray, kept: np.ndarray) -> np.ndarray:
        return np.searchsorted(kept, ids)

    sub: Dict = {}
    for et, ei in edges.items():
        src_t, _rel, dst_t = et
        mask = np.isin(ei[0], keep.get(src_t, ())) & np.isin(
            ei[1], keep.get(dst_t, ())
        )
        sub[et] = np.stack(
            [
                _relabel(ei[0][mask], keep[src_t]),
                _relabel(ei[1][mask], keep[dst_t]),
            ]
        )
    return sub, keep


def batch_graphs(
    edge_dicts: Sequence[Dict],
    num_nodes: Sequence[Dict[str, int]],
) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """Disjoint-union batch of typed graphs (reference ``batch_graphs``,
    hgraph.py:468-489, generalized to hetero node types).

    Returns ``(edges, offsets)`` where ``offsets[t][i]`` is graph ``i``'s
    node-id offset for type ``t`` (its cumulative-length vector — the
    reference's ``lengths``); per-node features/labels batch with a plain
    ``np.concatenate`` using the same offsets.  The training path's batching
    lives in the static-shape sampler (data/sampler.py); this is the
    host-side analysis/export helper.
    """
    types = sorted({t for nn in num_nodes for t in nn})
    offsets = {
        t: np.cumsum([0] + [nn.get(t, 0) for nn in num_nodes])[:-1]
        for t in types
    }
    all_ets = sorted({et for ed in edge_dicts for et in ed})
    out: Dict = {}
    for et in all_ets:
        src_t, _rel, dst_t = et
        parts = []
        for i, ed in enumerate(edge_dicts):
            if et not in ed or ed[et].size == 0:
                continue
            parts.append(
                np.stack(
                    [
                        ed[et][0] + offsets[src_t][i],
                        ed[et][1] + offsets[dst_t][i],
                    ]
                )
            )
        out[et] = (
            np.concatenate(parts, axis=1)
            if parts
            else np.zeros((2, 0), np.int64)
        )
    return out, offsets
