"""Corpus datasets: cached score -> ScoreSample pipelines with transposition
augmentation (counterpart of ``analysisgnn_tpu/data/corpus.py``: the same
samples, the same ``.npz`` keys and the same cache key, so each package reads
the other's cache).

The dataset-framework analog of the reference's StrutturaDataset/
InMemoryDataset lifecycle (analysisgnn/data/dataset.py:185-421 —
has_cache -> process -> save -> load) and its corpus datasets
(data/datasets/{cadence,dlc,chord}.py): each source piece yields one
:class:`ScoreSample` per admissible chromatic transposition (12-interval
augmentation, reference data/datasets/dlc.py:68,373), cached as one ``.npz``
per (piece, interval).

Graph edges are onset-time-only, hence transposition-invariant — they are
built once per piece and shared across the augmented samples.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from analysisgnn_tpu_torch.core.graph import NOTE, edge_type_key, parse_edge_type_key
from analysisgnn_tpu_torch.data.features import select_features
from analysisgnn_tpu_torch.data.graph_build import build_score_graph
from analysisgnn_tpu_torch.data.note_array import transpose_note_array
from analysisgnn_tpu_torch.data.sampler import ScoreSample
from analysisgnn_tpu_torch.theory.encoders import KeySignatureEncoder, PitchEncoder
from analysisgnn_tpu_torch.theory.tonal import CHROMATIC_INTERVALS

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
    """One ScoreSample per admissible transposition.

    ``labels`` are transposition-invariant extra labels; ``label_fn`` maps an
    interval name to the transposition-covariant label dict (vocab-encoded).
    """
    g = build_score_graph(
        note_array, measures=measures, add_beats=add_beats, add_measures=add_measures
    )
    ps_base = _PITCH_ENC.encode(note_array)
    ks_base = _KS_ENC.encode(note_array)
    out: List[ScoreSample] = []
    for interval in transpositions:
        try:
            if interval == "P1":
                na_t = note_array
                ps, ks = ps_base, ks_base
            else:
                na_t = transpose_note_array(note_array, interval)
                ps = _PITCH_ENC.transpose(ps_base, interval)
                ks = _KS_ENC.transpose(ks_base, interval)
        except ValueError:
            continue  # piece not representable under this interval
        feats = select_features(na_t, feature_type)
        attrs: Dict[str, np.ndarray] = {
            "pitch_spelling": ps.astype(np.int64),
            "key_signature": ks.astype(np.int64),
            "onset_div": na_t["onset_div"].astype(np.int64),
            "voice": na_t["voice"].astype(np.int64),
            "staff": na_t["staff"].astype(np.int64),
        }
        n_notes = len(na_t)
        if labels:
            for k, v in labels.items():
                attrs[k] = np.asarray(v)
        if label_fn is not None:
            for k, v in label_fn(interval).items():
                attrs[k] = np.asarray(v)
        for k, v in attrs.items():
            # labels must be per-note aligned: a mismatch means the label
            # source saw a different row set than the note array (e.g. an
            # uncleaned table) and every label after the first divergent
            # row would silently shift
            if v.shape[:1] != (n_notes,):
                raise ValueError(
                    f"label {k!r} has {v.shape[0]} rows for {n_notes} notes "
                    f"({name}); build labels from the SAME cleaned table as "
                    "the note array (data/tsv.py::clean_pitch_frame)"
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


# --------------------------------------------------------------------------- #
# npz caching
# --------------------------------------------------------------------------- #


def save_sample(sample: ScoreSample, path: str) -> None:
    payload = {
        "name": np.array(sample.name),
        "transposition": np.array(sample.transposition),
        "test": np.array(sample.test),
        "split": np.array(sample.split),
    }
    for t, f in sample.features.items():
        payload[f"feat__{t}"] = f
    for et, ei in sample.edges.items():
        payload[f"edge__{edge_type_key(et)}"] = ei
    for k, v in sample.note_attrs.items():
        payload[f"attr__{k}"] = v
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, **payload)


def load_sample(path: str) -> ScoreSample:
    z = np.load(path, allow_pickle=False)
    features, edges, attrs = {}, {}, {}
    for k in z.files:
        if k.startswith("feat__"):
            features[k[6:]] = z[k]
        elif k.startswith("edge__"):
            edges[parse_edge_type_key(k[6:])] = z[k]
        elif k.startswith("attr__"):
            attrs[k[6:]] = z[k]
    return ScoreSample(
        features=features,
        edges=edges,
        note_attrs=attrs,
        name=str(z["name"]),
        transposition=str(z["transposition"]),
        test=bool(z["test"]),
        split=str(z["split"]) if "split" in z.files else "",
    )


@dataclasses.dataclass
class CorpusConfig:
    cache_dir: str
    feature_type: str = "voice"
    transpose: bool = True
    add_beats: bool = True
    add_measures: bool = True
    force_reload: bool = False


class GraphCorpus:
    """A cached corpus of ScoreSamples built from source files.

    Subclasses implement :meth:`source_files` and :meth:`process_file`;
    lifecycle mirrors the reference dataset framework: cached .npz per
    (piece, interval), skip-on-error per piece (reference ``prob_pieces``
    pattern, data/datasets/dlc.py:71-88).
    """

    def __init__(self, cfg: CorpusConfig):
        self.cfg = cfg
        self.samples: List[ScoreSample] = []
        self.errors: List[Tuple[str, str]] = []

    # -- to be provided by subclasses --------------------------------------

    def source_files(self) -> List[str]:
        raise NotImplementedError

    def process_file(self, path: str) -> List[ScoreSample]:
        raise NotImplementedError

    # -- lifecycle ----------------------------------------------------------

    def _cache_key(self, path: str) -> str:
        h = hashlib.sha1(
            f"{path}:{self.cfg.feature_type}:{self.cfg.transpose}".encode()
        ).hexdigest()[:16]
        base = os.path.splitext(os.path.basename(path))[0]
        return os.path.join(self.cfg.cache_dir, f"{base}-{h}")

    def load(self) -> "GraphCorpus":
        for path in self.source_files():
            prefix = self._cache_key(path)
            marker = prefix + ".done"
            if os.path.exists(marker) and not self.cfg.force_reload:
                with open(marker) as f:
                    files = [line.strip() for line in f if line.strip()]
                self.samples.extend(load_sample(p) for p in files)
                continue
            try:
                samples = self.process_file(path)
            except Exception as e:  # skip problem pieces, keep building
                self.errors.append((path, repr(e)))
                continue
            written = []
            for s in samples:
                out = f"{prefix}-{s.transposition}.npz"
                save_sample(s, out)
                written.append(out)
            os.makedirs(os.path.dirname(marker), exist_ok=True)
            with open(marker, "w") as f:
                f.write("\n".join(written))
            self.samples.extend(samples)
        return self

    @property
    def transpositions(self) -> Sequence[str]:
        return CHROMATIC_INTERVALS if self.cfg.transpose else ("P1",)

    def transpositions_for(self, path: str, is_test: bool) -> Sequence[str]:
        """Per-file augmentation policy: test pieces are never transposed
        (reference data/datasets/dlc.py:373); subclasses with explicit
        collections restrict further."""
        return ("P1",) if is_test else self.transpositions


class MusicXMLCorpus(GraphCorpus):
    """Corpus built from a directory of (possibly .mxl) MusicXML scores —
    the cadence-dataset analog (reference data/datasets/cadence.py)."""

    def __init__(self, cfg: CorpusConfig, source_dir: str, test_names: Sequence[str] = ()):
        super().__init__(cfg)
        self.source_dir = source_dir
        self.test_names = set(test_names)

    def source_files(self) -> List[str]:
        exts = (".xml", ".musicxml", ".mxl")
        out = []
        for root, _, files in os.walk(self.source_dir):
            out += [os.path.join(root, f) for f in files if f.endswith(exts)]
        return sorted(out)

    def process_file(self, path: str) -> List[ScoreSample]:
        from analysisgnn_tpu_torch.data.musicxml import load_score

        parsed = load_score(path)
        name = os.path.splitext(os.path.basename(path))[0]
        is_test = name in self.test_names
        transpositions = ("P1",) if is_test else self.transpositions
        return samples_from_note_array(
            parsed.note_array,
            measures=parsed.measures,
            name=name,
            feature_type=self.cfg.feature_type,
            transpositions=transpositions,
            add_beats=self.cfg.add_beats,
            add_measures=self.cfg.add_measures,
            test=is_test,
        )


class DLCTsvCorpus(GraphCorpus):
    """Corpus built from DLC/AugmentedNet pitch-array TSVs — the
    DLCGraphDataset / RNAGraphDataset analog (reference data/datasets/
    {dlc,chord}.py)."""

    def __init__(
        self,
        cfg: CorpusConfig,
        source_dir: str,
        test_names: Optional[Sequence[str]] = None,
        dlc: bool = True,
    ):
        super().__init__(cfg)
        self.source_dir = source_dir
        if test_names is None and dlc:
            # canonical DLC held-out split (reference dlc.py:89-340)
            from analysisgnn_tpu_torch.data.dlc_meta import dlc_test_pieces

            test_names = dlc_test_pieces()
        self.test_names = set(test_names or ())
        self.dlc = dlc

    def source_files(self) -> List[str]:
        skip = set()
        if self.dlc:
            from analysisgnn_tpu_torch.data.dlc_meta import dlc_problem_pieces

            skip = set(dlc_problem_pieces())
        out = []
        for root, _, files in os.walk(self.source_dir):
            for f in files:
                if f.endswith(".tsv") and os.path.splitext(f)[0] not in skip:
                    out.append(os.path.join(root, f))
        return sorted(out)

    def process_file(self, path: str) -> List[ScoreSample]:
        from analysisgnn_tpu_torch.data.tsv import (
            clean_pitch_frame,
            create_labels_augmentednet,
            create_labels_dlc,
            load_pitch_array,
            note_array_from_df,
        )

        # clean ONCE and derive both the note array and the labels from the
        # same cleaned table — cleaning may drop unplaceable rows, and
        # labeling the raw table would shift every label after a dropped row
        df = clean_pitch_frame(load_pitch_array(path, dropna_tpc=self.dlc))
        na, measures = note_array_from_df(df)
        name = os.path.splitext(os.path.basename(path))[0]
        is_test = name in self.test_names
        transpositions = self.transpositions_for(path, is_test)
        label_fn = (
            (lambda iv: create_labels_dlc(df, interval=iv))
            if self.dlc
            else (lambda iv: create_labels_augmentednet(df, interval=iv))
        )
        return samples_from_note_array(
            na,
            label_fn=label_fn,
            measures=measures,
            name=name,
            feature_type=self.cfg.feature_type,
            transpositions=transpositions,
            add_beats=self.cfg.add_beats,
            add_measures=self.cfg.add_measures,
            test=is_test,
        )
