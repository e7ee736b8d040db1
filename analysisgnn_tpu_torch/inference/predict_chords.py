"""The chord / Roman-numeral-analysis chain of the port (counterpart of
``analysisgnn_tpu/inference/predict_chords.py``): score -> chord model (the
14 "latest" tasks, SATB voices included) -> the BiGRU smoother -> per-onset
decode -> harmonic-rhythm segmentation -> ``resolve_roman_numeral_cosine``
-> first-chord heuristic -> consecutive dedup -> RNA MusicXML and RomanText.

    python -m analysisgnn_tpu_torch.inference.predict_chords --input_score piece.musicxml --output_dir out --romantext

Runs on the GPU unless ``--device cpu`` is given.  ``--use_ckpt DIR`` loads
``DIR/model.pt``, a state dict of the chord model; without it the model has
seeded random weights.  As in the JAX chain, the smoother is never loaded: it
is initialised afresh from ``seed + 1`` on every call (here a
``torch.Generator``), so the two chains agree only when the caller hands
both the same smoother (``post_model``).
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from analysisgnn_tpu_torch.core.graph import NOTE, metadata, resolve_device
from analysisgnn_tpu_torch.theory.roman import format_roman_numeral, generate_romantext, resolve_roman_numeral_cosine
from analysisgnn_tpu_torch.theory.vocab import TASK_DICT_LATEST, available_representations_latest

_STEPS = {"C": 0, "D": 1, "E": 2, "F": 3, "G": 4, "A": 5, "B": 6}
TASKS = tuple(TASK_DICT_LATEST.items())


def build_chord_model(in_features: int, hidden: int = 256, num_layers: int = 1, seed: int = 0,
                      device: "str | torch.device" = "cuda"):
    """The chord CLI's ``ChordPredictionModel`` (the 14 latest tasks) on
    ``device``, with the seeded weights of ``init_parameters``."""
    from analysisgnn_tpu_torch.models.analysis import init_parameters
    from analysisgnn_tpu_torch.models.chord import ChordPredictionModel

    with torch.device(resolve_device(device)):
        model = ChordPredictionModel(in_features, hidden, TASKS, metadata(False, False)[1], num_layers=num_layers)
    init_parameters(model, torch.Generator(device="cpu").manual_seed(seed))
    return model.eval()


def build_post_model(hidden: int = 256, seed: int = 1, device: "str | torch.device" = "cuda"):
    """The ``PostProcessingMLT`` smoother on ``device``, seeded."""
    from analysisgnn_tpu_torch.models.analysis import init_parameters
    from analysisgnn_tpu_torch.models.chord import PostProcessingMLT

    with torch.device(resolve_device(device)):
        post = PostProcessingMLT(hidden, TASKS)
    init_parameters(post, torch.Generator(device="cpu").manual_seed(seed))
    return post.eval()


def _softmax64(x) -> np.ndarray:
    """Host float64 softmax (the JAX chain's, kept as it is)."""
    x = np.asarray(x, np.float64)
    x = x - x.max(-1, keepdims=True)
    e = np.exp(x)
    return e / e.sum(-1, keepdims=True)


@torch.no_grad()
def predict_chord_tasks(
    note_array: np.ndarray,
    model=None,
    post_model=None,
    hidden: int = 256,
    num_layers: int = 1,
    seed: int = 0,
    use_post: bool = True,
    device: "str | torch.device" = "cuda",
) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Per-onset probabilities of the 14 tasks and the onsets, rows aligned
    to the score's unique onsets in order.  Runs on ``device`` (the GPU unless
    the caller passes ``device="cpu"``).  ``model`` / ``post_model`` default to
    fresh seeded ones (``seed``, ``seed + 1``); given ones must be on
    ``device``."""
    from analysisgnn_tpu_torch.inference.predict import _model_device, graph_from_note_array
    from analysisgnn_tpu_torch.models.rnn import segment_starts

    dev = resolve_device(device)
    with record_function("chords.graph"):
        graph = graph_from_note_array(note_array, add_beats=False, add_measures=False, device=dev)
    if model is None:
        model = build_chord_model(graph.node_features[NOTE].shape[1], hidden, num_layers, seed, dev)
    _model_device(model, dev, "predict_chord_tasks")
    n = len(note_array)
    with record_function("chords.forward"):
        weight = torch.ones(n, dtype=torch.bool, device=dev)
        logits, group_valid = model(graph.node_features, graph.edge_index, graph.batch[NOTE],
                                    graph.node_attrs[NOTE]["onset_div"], weight)
        probs = {k: _softmax64(v.cpu().numpy()) for k, v in logits.items()}
    if use_post:
        with record_function("chords.smoother"):
            if post_model is None:
                post_model = build_post_model(hidden, seed + 1, dev)
            _model_device(post_model, dev, "predict_chord_tasks")
            starts = segment_starts(torch.where(group_valid, 0, -1))
            probs_dev = {k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in probs.items()}
            probs = {k: _softmax64(v.cpu().numpy()) for k, v in post_model(probs_dev, starts).items()}
    valid = group_valid.cpu().numpy()
    out = {k: v[valid] for k, v in probs.items()}
    onsets = np.unique(note_array["onset_div"])
    g = min(len(onsets), out[next(iter(out))].shape[0])
    return {k: v[:g] for k, v in out.items()}, onsets[:g]


def decode_chord_predictions(probs: Dict[str, np.ndarray]) -> Dict[str, list]:
    """argmax-decode each task through the latest vocabularies."""
    reps = available_representations_latest()
    return {task: reps[task].decode(np.argmax(p, axis=-1)) for task, p in probs.items() if task in reps}


def resolve_annotations(
    decoded: Dict[str, list],
    onsets: np.ndarray,
    first_chord_step: Optional[str] = None,
) -> List[Tuple[str, int]]:
    """Per-onset SATB -> resolved Roman numerals with key prefixes, the
    first-chord heuristic, and consecutive dedup."""
    n = len(onsets)
    hr = list(decoded.get("hrhythm", [0] * n))
    if not any(h == 0 for h in hr[:n]):
        # degenerate prediction (no harmonic onsets at all): keep every onset
        hr = [0] * n
    annotations: List[Tuple[str, int]] = []
    prev_key = ""
    for i in range(n):
        if hr[i] != 0:  # keep only harmonic-rhythm onsets
            continue
        key = str(decoded["localkey"][i])
        rn, _label = resolve_roman_numeral_cosine(
            str(decoded["bass"][i]),
            str(decoded["tenor"][i]),
            str(decoded["alto"][i]),
            str(decoded["soprano"][i]),
            decoded["pcset"][i],
            key,
            str(decoded["romanNumeral"][i]),
            str(decoded["tonkey"][i]),
        )
        fig = f"{key}:{rn}" if key != prev_key else rn
        prev_key = key
        annotations.append((format_roman_numeral(fig, key), int(onsets[i])))
    if not annotations:
        return annotations
    # first-chord heuristic: an opening I64/i64 is re-read as V; likewise an
    # opening chord whose single step sits a 4th below the key implies V
    rn0, onset0 = annotations[0]
    if rn0.lower().endswith("i64") and ":" in rn0:
        annotations[0] = (rn0[: rn0.index(":") + 1] + "V", onset0)
    elif first_chord_step is not None and ":" in rn0:
        key_step = rn0[0].upper()
        if (
            key_step in _STEPS
            and first_chord_step.upper() in _STEPS
            and (_STEPS[first_chord_step.upper()] - _STEPS[key_step]) % 7 == 3
        ):
            annotations[0] = (rn0[: rn0.index(":") + 1] + "V", onset0)
    # dedupe consecutive identical numerals (key-prefix-insensitive)
    deduped = [annotations[0]]
    for i in range(1, len(annotations)):
        prev_rn = deduped[-1][0]
        bare_prev = prev_rn[prev_rn.index(":") + 1:] if ":" in prev_rn else prev_rn
        if annotations[i][0] != bare_prev:
            deduped.append(annotations[i])
    return deduped


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("Chord Prediction")
    p.add_argument("--use_ckpt", type=str, default=None,
                   help="checkpoint directory holding model.pt, a state dict of the chord model")
    p.add_argument("--input_score", type=str, required=True)
    p.add_argument("--output_dir", type=str, default="./artifacts")
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--num_layers", type=int, default=1)
    p.add_argument("--romantext", action="store_true", help="also write a RomanText analysis file")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)

    from analysisgnn_tpu_torch.data.features import select_features
    from analysisgnn_tpu_torch.data.musicxml import load_score
    from analysisgnn_tpu_torch.inference.predict import export_roman_numerals_to_musicxml

    device = resolve_device(args.device)
    parsed = load_score(args.input_score)
    note_array = parsed.note_array
    model = None
    if args.use_ckpt and os.path.isdir(args.use_ckpt):
        model = build_chord_model(select_features(note_array, "voice").shape[1], args.hidden, args.num_layers,
                                  device=device)
        state = torch.load(os.path.join(args.use_ckpt, "model.pt"), map_location=device, weights_only=True)
        model.load_state_dict(state)
    probs, onsets = predict_chord_tasks(note_array, model=model, hidden=args.hidden, num_layers=args.num_layers,
                                        device=device)
    decoded = decode_chord_predictions(probs)
    first_rows = note_array[note_array["onset_div"] == note_array["onset_div"].min()]
    steps = np.unique(first_rows["step"]) if "step" in note_array.dtype.names else []
    first_step = str(steps[0]) if len(steps) == 1 else None
    annotations = resolve_annotations(decoded, onsets, first_step)

    os.makedirs(args.output_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(args.input_score))[0]
    out_path = os.path.join(args.output_dir, f"{base}_rna.musicxml")
    # map annotations back onto per-note rows for the exporter
    onset_to_rn = {o: rn for rn, o in annotations}
    per_note = []
    current = ""
    for o in note_array["onset_div"]:
        current = onset_to_rn.get(int(o), current)
        per_note.append(current)
    export_roman_numerals_to_musicxml(out_path, note_array, {"romanNumeral": per_note})
    if args.romantext:
        ts_beats = int(note_array["ts_beats"][0]) if "ts_beats" in note_array.dtype.names else 4
        divisions = 4
        measure_len = ts_beats * divisions
        rt = generate_romantext(
            [(rn, int(o) // measure_len + 1, (int(o) % measure_len) / divisions + 1) for rn, o in annotations],
            title=base,
        )
        with open(os.path.join(args.output_dir, f"{base}.rntxt"), "w") as f:
            f.write(rt)
    print("Done! Score saved at:", out_path)


if __name__ == "__main__":
    main()
