"""Score-analysis inference CLI of the port.

Counterpart of ``analysisgnn_tpu/cli/predict.py::main`` for ``--score`` and
``--score_dir`` (MusicXML, ``.mxl`` or Humdrum ``.krn``) with CSV output and
the Roman-numeral MusicXML (``--output_musicxml``; ``--export_musicxml`` in
``--score_dir`` mode).  A port checkpoint is a directory holding
``model_config.json`` (the training configuration) and ``<tag>.pt``, a
``torch.save``d state dict of the analysis model.

    python -m analysisgnn_tpu_torch.cli.predict --checkpoint_dir CKPT --score piece.musicxml --output_musicxml rna.musicxml

``--conv_impl`` overrides the fused-SAGE layout of the checkpoint's HybridGNN
or MetricalGNN (``edge-zxp`` runs K3; the parameters are the same in every
layout), and
``--hgt_stage_dtype`` the HGT staging dtype (``float32`` or ``bfloat16``; for
an HGT checkpoint the saved one by default).

``--partition_devices N`` serves a long score through N graph partitions on
a line (the overlap-region regime of ``distributed/partition_encoder.py``;
note-node HybridGNN and HybridHGT configs without ``use_rnn`` only), spread
over the visible cards as the JAX CLI spreads them over its devices: C of
them, the largest count up to ``min(N, cards)`` that divides N, the model's
card first (C = 1 on one card or on the CPU).  The CLI prints C and the
devices; the CSV is the one written without the flag.

``--checkpoint_dir`` is resolved as the JAX CLI resolves it
(:func:`resolve_checkpoint`): the local directory, then a cached copy under
``--artifacts_dir``, then a W&B artifact id (``entity/project/name:version``),
which needs the ``wandb`` package and the network.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

SCORE_EXTENSIONS = (".musicxml", ".xml", ".mxl", ".krn", ".kern")


def resolve_checkpoint(checkpoint_dir: str, tag: str, artifacts_dir: str = "./artifacts/models") -> str:
    """Resolve a checkpoint directory the way the reference resolves its
    ``.ckpt`` (inference/predict_analysis.py:79-125): prefer the local
    path, then any previously-downloaded copy under ``artifacts_dir``,
    then — if ``checkpoint_dir`` looks like a W&B artifact reference
    (``entity/project/name:version``) — download it via the wandb API.

    A port checkpoint root is a directory holding ``model_config.json`` and
    ``<tag>.pt``, so the local hit is the file ``<checkpoint_dir>/<tag>.pt``
    and the cache scan looks for such roots.
    """
    local = os.path.join(checkpoint_dir, f"{tag}.pt")
    if os.path.isfile(local):
        return checkpoint_dir

    def _is_ckpt_root(d: str) -> bool:
        return os.path.isfile(os.path.join(d, "model_config.json")) and (
            os.path.isfile(os.path.join(d, f"{tag}.pt"))
        )

    # cached artifact scan (reference :86-105)
    if os.path.isdir(artifacts_dir):
        if _is_ckpt_root(artifacts_dir):
            print(f"Using cached checkpoint: {artifacts_dir}")
            return artifacts_dir
        for fname in sorted(os.listdir(artifacts_dir)):
            cand = os.path.join(artifacts_dir, fname)
            if os.path.isdir(cand) and _is_ckpt_root(cand):
                print(f"Using cached checkpoint: {cand}")
                return cand

    # W&B artifact reference, e.g. "melkisedeath/AnalysisGNN/model-xyz:v3"
    # (reference :107-125); requires network + wandb login.  Filesystem
    # paths never qualify: artifact ids are relative and carry a :version.
    looks_like_artifact = (
        not os.path.isabs(checkpoint_dir)
        and ":" in os.path.basename(checkpoint_dir)
        and checkpoint_dir.count("/") >= 2
    )
    if looks_like_artifact:
        try:
            import wandb  # noqa: F401  (not baked in: optional)
        except ImportError as e:
            raise ImportError(
                "wandb package is required to download artifacts; "
                f"no local checkpoint at {local} and no cached copy in "
                f"{artifacts_dir}"
            ) from e
        os.makedirs(artifacts_dir, exist_ok=True)
        print(f"Downloading checkpoint from W&B: {checkpoint_dir}")
        run = wandb.init()
        artifact = run.use_artifact(checkpoint_dir, type="model")
        art_dir = artifact.download(root=artifacts_dir)
        wandb.finish()
        if _is_ckpt_root(art_dir):
            return art_dir
        for fname in sorted(os.listdir(art_dir)):
            cand = os.path.join(art_dir, fname)
            if os.path.isdir(cand) and _is_ckpt_root(cand):
                return cand
        raise FileNotFoundError(
            f"W&B artifact {checkpoint_dir} contains no checkpoint "
            f"with tag {tag!r}"
        )
    raise FileNotFoundError(
        f"no checkpoint {tag!r} under {checkpoint_dir} and no cached copy "
        f"in {artifacts_dir}"
    )


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Predict analysis for a score (PyTorch port)")
    p.add_argument("--score", type=str, default=None, help="MusicXML/.mxl/.krn path")
    p.add_argument("--score_dir", type=str, default=None,
                   help="batch mode: predict every score file in this directory (recursive)")
    p.add_argument("--output_dir", type=str, default=None,
                   help="batch mode: write per-score CSVs here (default: alongside each score)")
    p.add_argument("--bucket_factor", type=float, default=1.25,
                   help="batch mode: pad graphs to a geometric capacity ladder with this "
                        "growth factor (0 disables bucketing)")
    p.add_argument("--partition_devices", type=int, default=0,
                   help="encode the full graph as this many partitions on a line (overlap-region graph "
                        "partition), spread over the visible cards; for long scores; note-node model "
                        "configs only")
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints",
                   help="directory with model_config.json and <checkpoint>.pt, OR W&B artifact id "
                        "(entity/project/name:version)")
    p.add_argument("--checkpoint", type=str, default="best", help="state-dict tag inside checkpoint_dir")
    p.add_argument("--artifacts_dir", type=str, default="./artifacts/models",
                   help="cache dir for downloaded checkpoints")
    p.add_argument("--conv_impl", type=str, default=None, choices=["node", "edge", "edge-zxp"],
                   help="override the fused-SAGE layout for this run (parameter-compatible)")
    p.add_argument("--hgt_stage_dtype", type=str, default=None, choices=["float32", "bfloat16"],
                   help="override the HGT q/k/v staging dtype; default: the checkpoint's (HGT only), else float32")
    p.add_argument("--tasks", type=str, default=None, help="comma list; default all")
    p.add_argument("--output_csv", type=str, default=None)
    p.add_argument("--output_musicxml", type=str, default=None,
                   help="write the Roman-numeral annotation MusicXML here")
    p.add_argument("--export_musicxml", action="store_true",
                   help="batch mode: also write <score>_rna.musicxml per score next to the CSVs")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def load_model(checkpoint_dir: str, tag: str, device: "str | torch.device", conv_impl: "str | None" = None,
               hgt_stage_dtype: "str | None" = None):
    """The checkpoint's model on ``device`` and its configuration, with the
    overrides applied: ``conv_impl`` replaces the saved layout; the staging
    dtype is ``hgt_stage_dtype`` when given, else the saved one for an HGT
    checkpoint and float32 for any other (the JAX CLI's rule).  The edge
    decoder of a checkpoint trained with the edge-consistency loss serves no
    prediction and is not loaded."""
    from analysisgnn_tpu_torch.models.analysis import model_from_config

    with open(os.path.join(checkpoint_dir, "model_config.json")) as f:
        cfg = json.load(f)
    if conv_impl:
        cfg["conv_impl"] = conv_impl
    is_hgt = cfg.get("model", "HybridGNN").lower() == "hgt"
    saved = cfg.get("hgt_stage_dtype", "float32") if is_hgt else "float32"
    cfg["hgt_stage_dtype"] = hgt_stage_dtype if hgt_stage_dtype is not None else saved
    model = model_from_config(cfg, device=device)
    state = torch.load(os.path.join(checkpoint_dir, f"{tag}.pt"), map_location=device, weights_only=True)
    model.load_state_dict({k: v for k, v in state.items() if not k.startswith("edge_decoder.")})
    return model.eval(), cfg


def main(argv=None) -> None:
    args = get_parser().parse_args(argv)
    if bool(args.score) == bool(args.score_dir):
        raise SystemExit("exactly one of --score / --score_dir is required")
    from analysisgnn_tpu_torch.core.graph import resolve_device
    from analysisgnn_tpu_torch.data.musicxml import load_score
    from analysisgnn_tpu_torch.inference.predict import (
        decode_predictions,
        export_predictions_csv,
        export_roman_numerals_to_musicxml,
        predict_score_ids,
        predict_score_partitioned,
    )

    device = resolve_device(args.device)
    ckpt_dir = resolve_checkpoint(args.checkpoint_dir, args.checkpoint, args.artifacts_dir)
    model, cfg = load_model(ckpt_dir, args.checkpoint, device, args.conv_impl, args.hgt_stage_dtype)
    tasks = args.tasks.split(",") if args.tasks else None

    if args.score_dir:
        paths = sorted(
            os.path.join(r, f)
            for r, _d, fs in os.walk(args.score_dir)
            for f in fs
            if f.lower().endswith(SCORE_EXTENSIONS)
        )
        if not paths:
            raise SystemExit(f"no score files under {args.score_dir}")
        # factor <= 1 (incl. the documented 0) disables bucketing
        bucket = args.bucket_factor if args.bucket_factor > 1.0 else None
    else:
        paths = [args.score]
        bucket = None  # single score: exact shapes, no padding waste

    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
    feature_type = cfg.get("feature_type", "simple").replace("simple", "voice")
    if args.partition_devices and (cfg.get("add_beats") or cfg.get("add_measures")):
        raise SystemExit(
            "--partition_devices covers note-node model configs only "
            "(this checkpoint was trained with beat/measure nodes)"
        )
    if args.partition_devices:
        from analysisgnn_tpu_torch.distributed.partition_encoder import spread_devices, visible_devices

        spread = spread_devices(args.partition_devices, visible_devices(device))
        print(f"--partition_devices {args.partition_devices}: {args.partition_devices} partitions over "
              f"{len(spread)} device(s): {', '.join(str(d) for d in spread)}")
    for path in paths:
        parsed = load_score(path)
        if args.partition_devices:
            ids = predict_score_partitioned(
                model, parsed.note_array, tasks=tasks, feature_type=feature_type,
                num_devices=args.partition_devices, ids_only=True, device=device, devices=spread,
            )
        else:
            ids = predict_score_ids(
                model,
                parsed.note_array,
                measures=parsed.measures,
                tasks=tasks,
                feature_type=feature_type,
                add_beats=cfg.get("add_beats", False),
                add_measures=cfg.get("add_measures", False),
                bucket_factor=bucket,
                device=device,
            )
        decoded = decode_predictions(ids)
        if args.score_dir and args.output_dir:
            # flatten into output_dir without basename collisions across subdirectories
            rel = os.path.relpath(path, args.score_dir)
            base = os.path.splitext(rel)[0].replace(os.sep, "__")
            out_csv = os.path.join(args.output_dir, f"{base}_analysis.csv")
        elif args.score_dir:
            base = os.path.splitext(os.path.basename(path))[0]
            out_csv = os.path.join(os.path.dirname(path), f"{base}_analysis.csv")
        else:
            base = os.path.splitext(os.path.basename(path))[0]
            out_csv = args.output_csv or f"{base}_analysis.csv"
        export_predictions_csv(out_csv, parsed.note_array, decoded)
        print(f"wrote {out_csv}")
        out_xml = None
        if args.score_dir and args.export_musicxml:
            out_xml = os.path.join(os.path.dirname(out_csv), f"{base}_rna.musicxml")
        elif not args.score_dir and args.output_musicxml:
            out_xml = args.output_musicxml
        if out_xml:
            export_roman_numerals_to_musicxml(out_xml, parsed.note_array, decoded)
            print(f"wrote {out_xml}")


if __name__ == "__main__":
    main()
