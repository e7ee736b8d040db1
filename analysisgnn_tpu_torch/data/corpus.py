"""Score samples from a note array (counterpart of the first part of
``analysisgnn_tpu/data/corpus.py``: ``samples_from_note_array`` and
``_metrical_features``).

Only the untransposed interval ``P1`` is ported: the transposition of note
arrays, pitch spellings and key signatures, and the file corpora built on
them (MusicXML, DLC TSV, ``.krn``, the AN joint TSV, with their ``.npz``
cache), come with a later slice (ROADMAP queue 1 item 7).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from analysisgnn_tpu_torch.core.graph import NOTE
from analysisgnn_tpu_torch.data.features import select_features
from analysisgnn_tpu_torch.data.graph_build import build_score_graph
from analysisgnn_tpu_torch.data.sampler import ScoreSample
from analysisgnn_tpu_torch.theory.encoders import KeySignatureEncoder, PitchEncoder

_PITCH_ENC = PitchEncoder()
_KS_ENC = KeySignatureEncoder()


def _metrical_features(g, feat_dim: int) -> Dict[str, np.ndarray]:
    """Zero feature rows for the beat and measure nodes of graph ``g``."""
    return {
        "beat": np.zeros((max(g.num_beats, 1), feat_dim), np.float32),
        "measure": np.zeros((max(g.num_measures, 1), feat_dim), np.float32),
    }


def samples_from_note_array(
    note_array: np.ndarray,
    labels: Optional[Dict[str, np.ndarray]] = None,
    label_fn: Optional[Callable[[str], Dict[str, np.ndarray]]] = None,
    measures: Optional[np.ndarray] = None,
    name: str = "",
    feature_type: str = "voice",
    transpositions: Sequence[str] = ("P1",),
    add_beats: bool = True,
    add_measures: bool = True,
    test: bool = False,
) -> List[ScoreSample]:
    """One :class:`ScoreSample` per transposition (only ``"P1"`` so far).

    ``labels`` are transposition-invariant extra labels; ``label_fn`` maps an
    interval name to the transposition-covariant label dict (vocab-encoded).
    """
    others = [t for t in transpositions if t != "P1"]
    if others:
        raise NotImplementedError(
            f"transpositions {others} are not ported yet: only 'P1'; transposed samples come with the file "
            "corpora (ROADMAP queue 1 item 7)"
        )
    g = build_score_graph(note_array, measures=measures, add_beats=add_beats, add_measures=add_measures)
    out: List[ScoreSample] = []
    for interval in transpositions:
        feats = select_features(note_array, feature_type)
        attrs: Dict[str, np.ndarray] = {
            "pitch_spelling": _PITCH_ENC.encode(note_array).astype(np.int64),
            "key_signature": _KS_ENC.encode(note_array).astype(np.int64),
            "onset_div": note_array["onset_div"].astype(np.int64),
            "voice": note_array["voice"].astype(np.int64),
            "staff": note_array["staff"].astype(np.int64),
        }
        n_notes = len(note_array)
        if labels:
            for k, v in labels.items():
                attrs[k] = np.asarray(v)
        if label_fn is not None:
            for k, v in label_fn(interval).items():
                attrs[k] = np.asarray(v)
        for k, v in attrs.items():
            # labels must be aligned with the notes: a mismatch means the label
            # source saw another row set, and every later label would shift
            if v.shape[:1] != (n_notes,):
                raise ValueError(
                    f"label {k!r} has {v.shape[0]} rows for {n_notes} notes ({name}); build labels from the "
                    "same note array"
                )
        features = {NOTE: feats}
        if add_beats or add_measures:
            features.update(
                {
                    t: f
                    for t, f in _metrical_features(g, feats.shape[1]).items()
                    if (t == "beat" and add_beats) or (t == "measure" and add_measures)
                }
            )
        out.append(
            ScoreSample(
                features=features,
                edges=g.edges,
                note_attrs=attrs,
                name=f"{name}_{interval}",
                transposition=interval,
                test=test,
            )
        )
    return out
