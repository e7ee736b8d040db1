"""The training entry point of the PyTorch port (counterpart of
``analysisgnn_tpu/cli/train.py``): the same flags, the same JSON config
overlay (the config file wins; the command line fills missing keys) and the
same comma-list ``--num_epochs`` per-task schedule, plus ``--device``.

    python -m analysisgnn_tpu_torch.cli.train --demo --do_train --do_eval            # on the GPU
    python -m analysisgnn_tpu_torch.cli.train --demo --do_train --device cpu ...     # on the CPU

It writes ``<checkpoint_dir>/model_config.json`` as the JAX CLI does, trains
with :class:`~analysisgnn_tpu_torch.train.loop.Trainer` (``log.jsonl``,
``best.pt``, ``last.pt``, ...) and evaluates the test split.  The corpora
come from ``--raw_dir`` (DLC or AugmentedNet TSVs, time-divided TSVs,
MusicXML; cached as ``.npz`` under ``<raw_dir>/.cache``) or, with
``--demo``, from the synthetic demo corpus.  On a copy of the repo's
``data_synth/`` (so that the cache lands in the copy):

    cp -r data_synth /tmp/ds
    python -m analysisgnn_tpu_torch.cli.train --raw_dir /tmp/ds --test_split_file /tmp/ds/test_split.json \\
        --main_tasks all --use_transpositions --do_train --do_eval

``configs/example_config.json`` trains the three main tasks one after
another (``cl_training``) with the distillation from the frozen teacher; its
raw dir holds ``all/``, ``cadence/`` and ``rna/`` (``rna/`` is read with the
AugmentedNet labels):

    python -m analysisgnn_tpu_torch.cli.train --config_path configs/example_config.json --raw_dir /tmp/ds \\
        --num_epochs 3 --do_train --do_eval
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict

import numpy as np

from analysisgnn_tpu_torch.theory.vocab import TASK_DICT


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the AnalysisGNN (PyTorch port)")
    p.add_argument("--gpus", type=str, default="-1",
                   help="accepted for reference parity; the device comes from --device")
    p.add_argument("--num_layers", type=int, default=3)
    p.add_argument("--hidden_channels", type=int, default=256)
    p.add_argument("--out_channels", type=int, default=128)
    p.add_argument("--num_epochs", type=str, default="50",
                   help="total epochs, or comma list = epochs per task")
    p.add_argument("--dropout", type=float, default=0.3)
    p.add_argument("--lr", type=float, default=0.005)
    p.add_argument("--weight_decay", type=float, default=5e-3)
    p.add_argument("--num_workers", type=int, default=5)
    p.add_argument("--lambda_dctn", type=float, default=0.5)
    p.add_argument("--lambda_featl", type=float, default=0.1)
    p.add_argument("--lambda_ewc", type=float, default=2.0)
    p.add_argument("--lambda_edge", type=float, default=0.1)
    p.add_argument("--use_edge_loss", action="store_true")
    p.add_argument("--load_from_checkpoint", action="store_true",
                   help="resume from checkpoint_dir/full before training")
    p.add_argument("--model", type=str, default="HybridGNN",
                   choices=["HybridGNN", "HGT", "MetricalGNN"])
    # JumpingKnowledge defaults ON — the reference MODEL-class default
    # (models/analysis.py:422 ``use_jk=True``; only its argparse flag is
    # store_true).  Measured: at the verbatim reference recipe (lr=5e-3,
    # dropout=0.3) the JK layer-attention skip paths are what keep the
    # RNA heads converging (bench_queue/dropout_bisect.json: root_acc
    # 0.75 with JK vs 0.38 without at 650 steps).
    p.add_argument("--use_jk", action="store_true", default=True)
    p.add_argument("--no_use_jk", dest="use_jk", action="store_false",
                   help="disable JumpingKnowledge (the reference CLI-flag "
                        "default)")
    p.add_argument("--scan_steps", type=int, default=1,
                   help="optimizer updates per call of the continual-learning loop")
    p.add_argument("--use_pallas", action="store_true",
                   help="the kernel route of the JAX package's Pallas flag: src-sorted "
                        "sampler edges, and K2 with the emax stacks for HGT")
    p.add_argument("--subgraph_sample_ratio", type=float, default=0.5,
                   help="train-epoch subgraphs per corpus graph (reference "
                        "MuseNeighborLoader subgraph_sample_ratio=0.5)")
    p.add_argument("--no_sort_edges", action="store_true",
                   help="disable src-sorted sampler edges (sorting is the "
                        "benched default and harmless on the XLA path)")
    p.add_argument("--final_norm", action="store_true", default=True,
                   help="ReLU+L2-normalize the final conv output (HybridGNN);"
                        " stabilizes the multi-task recipe at lr=5e-3"
                        " (default ON since round 3)")
    p.add_argument("--no_final_norm", dest="final_norm", action="store_false",
                   help="leave the final conv raw, as the reference HGCN"
                        " does (core/hgnn.py:178-179)")
    p.add_argument("--deep_proj", dest="plain_proj", action="store_false",
                   default=True,
                   help="use the reference's deep projection stacks"
                        " (analysis.py:429-443/:474-485) instead of the"
                        " measured-stable single-Dense default")
    p.add_argument("--tags", type=str, default="", help="wandb run tags")
    p.add_argument("--homogeneous", action="store_true",
                   help="accepted for parity (hetero path is always used)")
    p.add_argument("--reg_loss_type", type=str, default="la")
    p.add_argument("--auto_batch_size", type=bool, default=True,
                   help="accepted for parity; the sampler's shapes are static")
    p.add_argument("--use_reledge", action="store_true")
    p.add_argument("--use_wandb", action="store_true")
    p.add_argument("--use_metrical", action="store_true",
                   help="alias for --add_beats --add_measures")
    p.add_argument("--feat_norm_scale", type=float, default=0.0)
    p.add_argument("--compile", action="store_true",
                   help="accepted for parity; the port runs eagerly")
    p.add_argument("--has_memories", type=bool, default=False,
                   help="EWC memory replay (same as --use_ewc)")
    p.add_argument("--raw_dir", type=str, default=None,
                   help="root dir with per-main-task corpora (see docs)")
    p.add_argument("--batch_size", type=int, default=100)
    p.add_argument("--subgraph_size", type=int, default=500)
    p.add_argument("--add_beats", action="store_true")
    p.add_argument("--add_measures", action="store_true")
    p.add_argument("--mt_strategy", type=str, default="wloss")
    p.add_argument("--main_tasks", type=str, default="all,cadence,rna")
    p.add_argument("--max_samples", type=int, default=None)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--random_split", action="store_true")
    p.add_argument("--logit_fusion", action="store_true")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize conv layers in backward (memory lever "
                        "for full-graph training on very long scores)")
    p.add_argument("--no_torch_init", dest="torch_init", action="store_false",
                   default=True,
                   help="keep the seeded normal init instead of the torch-"
                        "nn.Linear-style uniform draw (the reference's "
                        "effective init; see train/state.py)")
    p.add_argument("--final_dropout", action="store_true",
                   help="apply dropout after the final conv as well (the "
                        "torch-anchor RefModel drops every layer incl. the "
                        "last; the reference HGCN leaves it raw) — probe "
                        "lever for the key-head family study")
    p.add_argument("--no_fused_torch_init", dest="fused_torch_init",
                   action="store_false", default=True,
                   help="restrict the torch-style draw to plain Dense "
                        "modules (the round-4 scope), leaving the fused "
                        "relation-batched SAGE weights and per-task head "
                        "stacks at flax defaults — bisect knob for the "
                        "key-head family study (RESULTS.md)")
    p.add_argument("--hgt_group_mode", type=str, default="pair",
                   choices=["pair", "emax"],
                   help="HGT relation-stack grouping (emax = union-space "
                        "capacity bins, fewer dispatches per layer)")
    p.add_argument("--hgt_softmax_stab", type=str, default="global",
                   choices=["global", "segment"],
                   help="HGT softmax stabilizer: 'global' (default) "
                        "subtracts one per-head max over all edges — the "
                        "same softmax, two fewer E-row kernels per layer "
                        "(+18%% edges/s); 'segment' restores the exact "
                        "per-aggregator max subtraction")
    p.add_argument("--hgt_stage_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"],
                   help="HGT q/k/v + edge-transform staging dtype; bf16 "
                        "halves the gather traffic (softmax/accumulation "
                        "stay f32, models/encoders.py HGTLayer)")
    p.add_argument("--conv_impl", type=str, default="node",
                   choices=["node", "edge", "edge-zxp"],
                   help="fused-SAGE implementation (models/fused.py): node "
                        "wins at sampled-subgraph training shapes, edge at "
                        "bandwidth-bound full-graph scale (docs/STATUS.md)")
    p.add_argument("--use_rnn", action="store_true",
                   help="onset-sequence BiGRU after the encoder "
                        "(reference models/analysis.py:512-537)")
    p.add_argument("--feature_type", type=str, default="simple",
                   choices=["cadence", "simple"])
    p.add_argument("--config_path", type=str, default=None)
    p.add_argument("--do_train", action="store_true")
    p.add_argument("--do_eval", action="store_true")
    p.add_argument("--checkpoint_path", type=str, default=None)
    p.add_argument("--checkpoint_dir", type=str, default="checkpoints")
    p.add_argument("--use_transpositions", action="store_true")
    p.add_argument("--use_ewc", action="store_true")
    p.add_argument("--cl_training", action="store_true")
    p.add_argument("--use_smote", action="store_true")
    p.add_argument("--use_swa", action="store_true",
                   help="stochastic weight averaging over the training tail")
    p.add_argument("--force_reload", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--demo", action="store_true",
                   help="run on a small synthetic corpus (no data needed)")
    p.add_argument("--test_split_file", type=str, default=None,
                   help="JSON file with a list of held-out piece names "
                        "(overrides the canonical DLC test split)")
    p.add_argument("--max_steps_per_epoch", type=int, default=None)
    p.add_argument("--test_eval_every", type=int, default=0,
                   help="run a full test-split eval every N epochs and "
                        "append to <checkpoint_dir>/test_curve.jsonl "
                        "(win-count-vs-steps crossover evidence)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def resolve_config(argv=None) -> Dict:
    args = get_parser().parse_args(argv)
    config = vars(args)
    config["main_tasks"] = args.main_tasks.split(",")
    epochs = args.num_epochs.split(",")
    if len(epochs) == 1:
        config["num_epochs"] = int(epochs[0])
        config["epochs_per_task"] = [
            config["num_epochs"] // len(config["main_tasks"])
        ] * len(config["main_tasks"])
    else:
        config["epochs_per_task"] = [int(n) for n in epochs]
        config["num_epochs"] = sum(config["epochs_per_task"])
    config["task_dict"] = dict(TASK_DICT)
    if config.get("use_metrical"):
        config["add_beats"] = True
        config["add_measures"] = True
    if config.get("has_memories"):
        config["use_ewc"] = True
    file_cfg = {}
    if args.config_path:
        with open(args.config_path) as f:
            file_cfg = json.load(f)
        merged = dict(file_cfg)
        for k, v in config.items():
            if k not in merged:
                merged[k] = v
        config = merged
    argv_tokens = sys.argv[1:] if argv is None else list(argv)
    if (
        "use_jk" not in file_cfg
        and "--use_jk" not in argv_tokens
        and "--no_use_jk" not in argv_tokens
    ):
        # default changed to ON in round 3 (MIGRATION.md); old recipes that
        # omitted the flag now train a larger model — say so once (ADVICE r3)
        print(
            "[config] use_jk defaulting to True (changed from the reference "
            "CLI-flag default in round 3; pass --no_use_jk for the old "
            "architecture — see MIGRATION.md)"
        )
    return config


def build_datamodule(config: Dict):
    """The corpora of ``--raw_dir`` (one sub-directory per main task, its
    layout detected from its files) or, with ``--demo`` or no ``--raw_dir``,
    the demo corpus (six synthetic 200-note scores per main task, the last one
    held out for test, labels derived from the pitches), in a data module
    whose batches lie on ``config["device"]``."""
    from analysisgnn_tpu_torch.data.corpus import CorpusConfig, DLCTsvCorpus, MusicXMLCorpus
    from analysisgnn_tpu_torch.data.datamodule import AnalysisDataModule, DataModuleConfig

    feature_type = "voice" if config.get("feature_type") == "simple" else "cadence"
    task_samples = {}
    if config.get("demo") or not config.get("raw_dir"):
        from analysisgnn_tpu_torch.data.corpus import samples_from_note_array
        from analysisgnn_tpu_torch.data.note_array import synthetic_score

        for mt in config["main_tasks"]:
            ss = []
            for i in range(6):
                na = synthetic_score(200, seed=i)
                labels = {
                    t: (na["pitch"].astype(np.int64) * (j + 2)) % n_cls
                    for j, (t, n_cls) in enumerate(TASK_DICT.items())
                }
                labels["valid_label"] = np.ones(len(na), np.int64)
                ss += samples_from_note_array(
                    na, name=f"{mt}{i}", labels=labels,
                    transpositions=("P1",),
                    add_beats=config.get("add_beats", False),
                    add_measures=config.get("add_measures", False),
                    feature_type=feature_type,
                    test=(i >= 5),
                )
            task_samples[mt] = ss
    else:
        raw = config["raw_dir"]
        ccfg = CorpusConfig(
            cache_dir=os.path.join(raw, ".cache"),
            feature_type=feature_type,
            transpose=config.get("use_transpositions", False),
            add_beats=config.get("add_beats", False),
            add_measures=config.get("add_measures", False),
            force_reload=config.get("force_reload", False),
        )
        test_names = None
        if config.get("test_split_file"):
            with open(config["test_split_file"]) as f:
                test_names = json.load(f)
        for mt in config["main_tasks"]:
            sub = os.path.join(raw, mt)
            if not os.path.isdir(sub):
                continue
            tsvs = [os.path.join(r, f) for r, _, fs in os.walk(sub) for f in fs if f.endswith(".tsv")]
            if not tsvs:
                corpus = MusicXMLCorpus(ccfg, sub)
            elif any(os.path.isdir(os.path.join(sub, d)) for d in ("training", "validation")) and any(
                f.endswith("joint.tsv") for f in tsvs
            ):
                # AN v1.0.0 layout: {training,test,validation}/*joint.tsv
                from analysisgnn_tpu_torch.data.time_divided import ANJointTsvCorpus

                corpus = ANJointTsvCorpus(ccfg, sub)
            elif "s_notes" in _first_line(tsvs[0]):
                # legacy time-divided slices (one row per 1/8th-note frame)
                from analysisgnn_tpu_torch.data.time_divided import TimeDividedTsvCorpus

                corpus = TimeDividedTsvCorpus(ccfg, sub)
            else:
                corpus = DLCTsvCorpus(ccfg, sub, test_names=test_names, dlc=(mt != "rna"))
            task_samples[mt] = corpus.load().samples
    dm_cfg = DataModuleConfig(
        subgraph_size=config.get("subgraph_size", 500),
        batch_size=max(config.get("batch_size", 8) // 10, 2),
        random_split=config.get("random_split", False),
        augment=config.get("use_transpositions", False),
        seed=config.get("seed", 0),
        max_samples=config.get("max_samples"),
        subgraph_sample_ratio=config.get("subgraph_sample_ratio", 0.5),
        # src-sorted edges are the benched default; the kernel route needs them
        sort_edges_by_src=(not config.get("no_sort_edges", False) or config.get("use_pallas", False)),
    )
    return AnalysisDataModule(task_samples, dm_cfg, device=config.get("device", "cuda")).setup()


def _first_line(path: str) -> str:
    with open(path) as f:
        return f.readline()


def train_config(config: Dict):
    """The :class:`~analysisgnn_tpu_torch.train.loop.TrainConfig` of a resolved
    CLI config."""
    from analysisgnn_tpu_torch.train.loop import TrainConfig

    return TrainConfig(
        num_layers=config["num_layers"],
        hidden_channels=config["hidden_channels"],
        out_channels=config["out_channels"],
        dropout=config["dropout"],
        lr=config["lr"],
        weight_decay=config["weight_decay"],
        model=config["model"],
        use_jk=config.get("use_jk", True),
        final_norm=config.get("final_norm", True),
        plain_proj=config.get("plain_proj", True),
        use_pallas=config.get("use_pallas", False),
        hgt_group_mode=config.get("hgt_group_mode", "pair"),
        hgt_stage_dtype=config.get("hgt_stage_dtype", "float32"),
        hgt_softmax_stab=config.get("hgt_softmax_stab", "global"),
        conv_impl=config.get("conv_impl", "node"),
        remat=config.get("remat", False),
        torch_init=config.get("torch_init", True),
        fused_torch_init=config.get("fused_torch_init", True),
        final_dropout=config.get("final_dropout", False),
        logit_fusion=config.get("logit_fusion", False),
        use_rnn=config.get("use_rnn", False),
        mt_strategy=config.get("mt_strategy", "wloss"),
        lambda_dctn=config.get("lambda_dctn", 0.5),
        lambda_featl=config.get("lambda_featl", 0.1),
        lambda_ewc=config.get("lambda_ewc", 2.0),
        use_ewc=config.get("use_ewc", False),
        use_smote=config.get("use_smote", False),
        use_swa=config.get("use_swa", False),
        use_edge_loss=config.get("use_edge_loss", False),
        lambda_edge=config.get("lambda_edge", 0.1),
        cl_training=config.get("cl_training", False),
        main_tasks=tuple(config["main_tasks"]),
        epochs_per_task=tuple(config.get("epochs_per_task", ())),
        num_epochs=config["num_epochs"],
        add_beats=config.get("add_beats", False),
        add_measures=config.get("add_measures", False),
        seed=config.get("seed", 0),
        checkpoint_dir=config.get("checkpoint_dir", "checkpoints"),
        log_path=os.path.join(config.get("checkpoint_dir", "checkpoints"), "log.jsonl"),
        use_wandb=config.get("use_wandb", False),
        resume=config.get("load_from_checkpoint", False),
        scan_steps=config.get("scan_steps", 1),
        num_workers=config.get("num_workers", 0),
        test_eval_every=config.get("test_eval_every", 0),
        device=config.get("device", "cuda"),
    )


def main(argv=None):
    """Train and/or evaluate as the flags say; returns the Trainer."""
    config = resolve_config(argv)
    from analysisgnn_tpu_torch.core.graph import resolve_device
    from analysisgnn_tpu_torch.train.loop import Trainer

    resolve_device(config.get("device", "cuda"))  # no GPU and no --device cpu: raise before any work
    dm = build_datamodule(config)
    tc = train_config(config)
    trainer = Trainer(tc, dm)
    # the model-construction config beside the checkpoints, for predict
    os.makedirs(tc.checkpoint_dir, exist_ok=True)
    with open(os.path.join(tc.checkpoint_dir, "model_config.json"), "w") as f:
        json.dump(
            {
                "num_layers": tc.num_layers,
                "hidden_channels": tc.hidden_channels,
                "out_channels": tc.out_channels,
                "dropout": tc.dropout,
                "model": tc.model,
                "use_jk": tc.use_jk,
                "final_norm": tc.final_norm,
                "plain_proj": tc.plain_proj,
                "logit_fusion": tc.logit_fusion,
                "use_rnn": tc.use_rnn,
                # the grouping in effect: the kernel route forces the emax
                # stacks for HGT, and predict must rebuild the same parameters
                "hgt_group_mode": (
                    "emax"
                    if tc.model.lower() == "hgt" and tc.use_pallas
                    else tc.hgt_group_mode
                ),
                "add_beats": tc.add_beats,
                "add_measures": tc.add_measures,
                "conv_impl": tc.conv_impl,
                "hgt_stage_dtype": tc.hgt_stage_dtype,
                "in_channels": dm.feature_dim,
                "feature_type": config.get("feature_type", "simple"),
            },
            f,
        )
    state = None
    if config.get("do_train"):
        state = trainer.fit(max_steps_per_epoch=config.get("max_steps_per_epoch"))
    if config.get("do_eval"):
        if state is None:
            # evaluate a stored checkpoint
            state = trainer._init_state()
            trainer.restore_checkpoint(config.get("checkpoint_path") or "best")
        metrics = trainer.evaluate(state, split="test")
        print(json.dumps(metrics, indent=1))
    return trainer


if __name__ == "__main__":
    main()
