"""Check the PyTorch port's kernels, serving and training paths on one NVIDIA
GPU; with ``--cards N``, only its paths across N cards of one host.

    python3 chip_smoke.py
    python3 chip_smoke.py --cards 4

Every phase asserts; none times anything (``gpubench/run.py`` measures the
port).  Each kernel is held against its plain PyTorch version on the card,
and each path against the same path on the CPU where the phase says so.  A
path's route is read from ``kernels/launch.py``'s ``launches_by_device``:
the set of launchers whose count grew while the path ran must be the set
that path takes (K1's and K3's f32 forward for a served edge-zxp model, K2
and K1 for an HGT train step, none on the CPU).

Phases, each on its own lines with elapsed seconds:
  1. environment: torch / CUDA versions, the card's name and power limit,
     TF32 off for matmuls and cuDNN;
  2. build: the CUDA sources of K1 and K4 (analysisgnn_tpu_torch/csrc/
     segment_mean_base.cu), K3 (csrc/relation_weighted_matmul.cu), K2
     (csrc/segment_softmax_agg.cu), K5 (csrc/segment_softmax.cu) and K6
     (csrc/halo_pull.cu), one nvcc each, and the host edge builder
     (csrc/graphbuild.cpp) with g++, started together, into the
     git-ignored analysisgnn_tpu_torch/_build/, with ptxas's registers;
  3. K1 check: segment_mean_base against its plain PyTorch version on the
     card, at the fused 7-relation note layer and onset pooling of the
     largest request (F=256, with the plan's row pointers), the fused layer
     on bf16 rows too, and at edge cases (padding ids, empty segments, F=25,
     F=6, no edges);
  4. serve: the full-width HybridGNN score-analysis model (3 x 256 hidden,
     128 out, JK, 21 task heads; seeded random weights) answers 2,000-,
     8,000- and 20,000-note requests through predict_score_ids, twice each:
     routed through K1 alone, the same ids both times, the C++ edge builder
     once a request; the largest request's logits against the port on the
     CPU (plain versions, same weights);
  5. graph build: build_score_graph of the 20,000-note score through the C++
     edge builder (csrc/graphbuild.cpp, data/native.py) against its numpy
     twin, every array equal;
  6. train corpus: the 8 synthetic 2,000-note scores of bench.py with beats,
     measures and random labels for the 21 tasks, sampled by the port's
     SubgraphSampler (500-note subgraphs x 8, neighbours (5, 5), src-sorted);
  7. K3, K1 backward and K2 checks: relation_weighted_matmul's forward, dx,
     dw (tensor cores, three TF32 passes) and d alpha kernels against the
     plain version's value and autograd gradients, at the train step's shape
     (N = the batch's note capacity, F = G = 256, T = 7) and at edge cases
     (N = 1, 63, 300, 1000; T = 1; F, G of 25/20, 40/24, 64/96; a strided
     x), two dw and two d alpha calls bit for bit; K1's gradient through the
     kernel against the plain version's at the fused-layer shape, padding
     edges exactly 0; segment_softmax_agg (K2) against its plain version
     (value and the gradients of logits and msgs, padding gradients exactly
     0) at the HGT train step's shape (13 relation blocks, H = 4, D = 64)
     and at edge cases (an empty node, H = 3, a degree-77 node over 9
     ranges, 40 blocks);
  8. bf16: K3's bf16 forward (relmm.forward_kernel: the wgmma kernel where
     TMA can describe the two bf16 operands, else the f32 kernels on f32
     copies) against its plain version at the train shape and edge cases,
     each case routed through the kernel it names (F=25 G=20, F=256 G=20,
     F=20 G=256, x or w 2 bytes off a 16-byte boundary: the f32 forward),
     the backward's cotangent dtypes and values at the train shape; K1 on
     f32 and bf16 rows at a bench batch's fused note layer;
  9. train: the full-width HybridGNN train step of bench.py (dropout 0.3,
     wloss, AdamW + clip 1.0, warmup-cosine 5e-3, torch-style init seed 0)
     with conv_impl "edge-zxp" (K3 base term) and "node" (K1), the
     "HGT-emax-pallas" model of scripts/bench_encoders.py (HybridHGT 3 x 256
     -> 128, 4 heads, K2), the MetricalGNN 3 x 256 -> 128 with use_rnn and
     edge-zxp, both HybridGNN layouts at bf16 compute (StepConfig
     compute_dtype="bfloat16": master parameters stay f32) and the
     "variants" arm (edge-zxp with the deep projections, logit fusion,
     remat and final dropout): a warm-up step, then steps on fresh batches
     (the second call of a signature captures a CUDA graph, train/
     graphed.py) through the arm's route with finite losses, and a loss
     that falls over FALL_STEPS steps on one batch (edge-zxp, HGT,
     edge-zxp-bf16); then one step on the GPU against the same step on the
     CPU (plain versions, same weights, a batch of 2 subgraphs, dropout 0;
     edge-zxp, HGT, MetricalGNN, and the bf16 arms at a bf16 tolerance);
 10. metrical: cli.train.main --demo --model MetricalGNN --use_metrical at
     the CLI's full width (3 x 256 -> 128, JK, beats and measures), two
     epochs of 4 steps, in the node layout (K1) and with --use_rnn
     --conv_impl edge-zxp (K3's forward, dx and dw, K1), each served by
     cli.predict.main on a generated 2,000-note MusicXML score (its route)
     and through predict_score on the card against the CPU (probabilities
     within METRICAL_PROB_ATOL); AssocBiGRU at a train batch's beat rows on
     the card against the CPU;
 11. K4 and K5 checks: segment_sum_sorted (K4, the sum mode of K1's kernel)
     and segment_softmax_sorted (K5) against their plain versions at
     tests/test_pallas.py's cases, at a train batch's shape (K4 over the
     fused note layer's sorted valid edges, F = 256; K5 over the HGT layer's
     valid union edges of a train batch and of a 20,000-note score, H = 4,
     where a call launches K5's kernel once and no other kernel, as
     torch.profiler sees it) and at edge cases (empty nodes, F = 25, H = 1,
     ids past num_nodes, no edges; for K5 runs at the ends of its 32-edge
     slices and of its registers, one run of every edge, H = 6 and 40, int64
     ids, -inf logits); then the generic segment ops of kernels/
     segment_ops.py (plain PyTorch: segment_mean, segment_mean_or,
     segment_softmax, gather_scatter_sum / _mean, sddmm_dot, coalesce) on
     CUDA tensors against CPU copies at a bench batch's fused-layer shape
     with padding and negative ids;
 12. pre-training and the layer zoo, at full width with weights from seed 0:
     the PreEncoder (HybridHGT pair 3 x 256, 4 heads, JK) pre-trained by
     make_pretrain_step on the bench's batches with seeded voice and staff
     attributes: no hand-written kernel launched, a loss that falls, one
     step on the GPU against the CPU; K4 through a SegmentPlan
     (segment_sum_plan) against its plain version and its gradient, and
     equal to the call that builds its row pointers; HResGatedConv (3
     layers, K4), HGPS (2 layers, 4 heads, K4), OnsetEmbedding (K1) and
     GATConv (3 heads, K4) on a bench batch, forward and backward on the GPU
     against the CPU, each through its route; UNet((32, 64, 128)) on [8, 88,
     256, 1] pianoroll-shaped images, GPU against CPU; hetero_fidelity of
     the serve model on a 2,000-note request with half of each note -> note
     relation's edges masked (three forwards through K1), GPU against CPU;
     the pretrained PreEncoder's voice links through voice_from_edges,
     pianoroll_svg and graph_to_json, and GraphSampler and the Laplacian
     positional encoding on the host;
 13. trainers: the training entry point, analysisgnn_tpu_torch.cli.train.main,
     at full width (HybridGNN 3 x 256 -> 128, JK, final norm) on the demo
     corpus with --use_metrical --use_pallas --conv_impl edge-zxp
     --use_edge_loss, validation and the test split: its route, the edge
     decoder's term at every step, the log.jsonl keys, finite losses and
     test metrics; its last.pt served through cli/predict.py's load_model;
     --model HGT --use_pallas --hgt_stage_dtype bfloat16 (K2) and its last.pt
     served by cli/predict.py; single-task cadence with --use_smote (every
     step oversamples); --deep_proj --logit_fusion --remat --final_dropout
     --no_fused_torch_init (a loss that falls on a bench batch, last.pt
     served, one dropout-0 step of its weights on the GPU against the CPU);
     one fit epoch of 2 steps on the GPU against the same on the CPU (dropout
     0, the same initial state dict); scripts/parity_experiment.py's recipe
     on file corpora (data_synth/ written by the port's synth_dlc byte for
     byte as committed, 227 samples per interval as the JAX corpus lists
     them, --use_wandb with the wandb package's import blocked, a second
     build_datamodule from the .npz cache equal array for array) and its fit
     on the GPU against the CPU; configs/example_config.json as the file
     stands (continual learning over all, cadence and rna, with its corpora
     on the raw-dir copy): memory_loss per epoch 0, then above 0, the
     checkpoints, finite test metrics, and the teacher on one step and off
     on another; the CL path with EWC and FAMO (edge-zxp) on the GPU against
     the CPU: every epoch's losses, FAMO's logits and the fisher's sum;
 14. remat: one train step of the variants model on a whole 20,000-note
     score with beats and measures, its gradients with remat against those
     without within REMAT_RTOL in PyTorch's deterministic mode, each step
     through its route with a finite loss;
 15. K6 check: halo_pull (csrc/halo_pull.cu), in the allocating form and in
     the planned form with out= that regime 2 uses, bit-equal to its plain
     version at the regime-2 shape (D = 4 partitions of 5,000 rows, H = 24,
     F = 256), at D = 1, 2, 8, H = 1, H = N_local, F = 25 (the scalar loop)
     and on non-contiguous inputs;
 16. partitioned serve: the serve model on a 20,000-note score through 4
     partitions on a line.  Regime 1, the CLI's path:
     predict_score_partitioned(ids_only=True) through K1, the same ids
     twice, its embeddings within 2e-4 * max|full| + 2e-5 of the
     single-window encode; then cli.predict.main --partition_devices 4 on a
     generated MusicXML score of about 20,000 notes.  Regime 2:
     make_partitioned_fused_sage at D = 1, 2, 4, 8 through K6 alone, within
     the same tolerance of model.encoder's output after ReLU and L2 norm;
     then the dryrun_multichip twin (__graft_entry__.py:287-356): 1,200
     notes (seed 7) of the serve model's configuration through 8 partitions;
 17. mesh: the dry run's twin at world size 1 over NCCL (a FileStore, rank
     0): dryrun_multichip at the reference configuration (21 tasks,
     HybridGNN 3 x 256 -> 128 node, subgraphs of 500 notes from 2,000-note
     scores) with 4 data slots of 2 graphs on the card, through K1 and K6;
     one sharded step with a finite loss; the cycle on 1 of the slots on the
     GPU against the CPU (dropout 0, Adam eps 1): losses, parameters, the
     AdamW moments after the cycle and each parameter's move;
 18. RNA serve and chord chain: cli.predict.main on the serve model with
     --output_musicxml on a generated 2,000-note MusicXML score (K1; the
     same ids on a second call), with --conv_impl edge-zxp (K1 and K3's
     forward; its logits against the node model's), on a .krn score, and
     with --checkpoint_dir entity/project/model-rna:v0 --artifacts_dir
     pointing at a cached copy under utils/profiling.py's trace (it prints
     "Using cached checkpoint", its ids equal the local run's, the Chrome
     trace names segment_mean_base_kernel); predict_chords.main at the CLI's
     defaults (hidden 256, one HybridGNN layer, the BiGRU smoother) with
     --romantext on a generated 2,000-note score through K1, and
     predict_chord_tasks on the card against the CPU with the same weights.
The last lines are the card's nvidia-smi line, one JSON object describing
each kernel (its source, the TPU kernel it replaces, its largest error
against its plain version over the run, and its launches on the main
paths as their routes read them from launches_by_device: one request of the
20,000-note score, and each train arm's steps after its warm-up; 0 where no
main path takes it, as for K5 and d alpha) and the result line.  Any failure raises and exits
nonzero.

With ``--cards N`` (N cards must be visible, else it fails; nothing of the
default run runs), the build, then:
  (a) every card's name and power limit, the peer-access matrix
      (torch.cuda.can_device_access_peer) and nvidia-smi topo -m;
  (b) every kernel (K1, K4, K5, K6 in both forms, K2, K3's f32 forward, dx,
      dw and d alpha and its bf16 forward) launched on every card from this
      process, whose current card stays 0, against its plain version on that
      card, each launch counted on its card and none on another;
  (c) the serve model on a 20,000-note and a 100,000-note score through 4
      partitions spread over the cards by predict_score_partitioned (one a
      card on 4) against the same partitions on card 0: ids equal,
      probabilities within the partitioned-serve tolerance, K1 alone and as
      often on every card; the spread's embeddings against the
      single-window encode; K1 at a window's fused note layer against its
      plain version; then cli.predict.main --partition_devices 4 against
      the one-card line's CSV;
  (d) dryrun_multichip(N) over NCCL, one rank a card, 2 data slots a rank
      (on 4: data 2 x 2 slots x model 2): both certifications, K1 and K6
      alone on every rank's card; one sharded step with a finite loss, and
      the end-halo exchange equal to its plain version; K6 at a rank's
      partitions against its plain version.
Then the same closing lines, with K1's and K6's entries of this run: K1's
launches on each card for each score of (c), and both kernels' on each
rank's card in (d).
"""

from __future__ import annotations

import collections
import contextlib
import csv
import dataclasses
import importlib.metadata
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

T0 = time.perf_counter()
# the launchers of csrc/, as kernels/launch.py counts them in launches_by_device
K1, K1_BF16 = "segment_mean_base_launch", "segment_mean_base_bf16_launch"
K2 = "segment_softmax_agg_launch"
K3, K3_DX, K3_DW, K3_DALPHA = "rwm_forward_launch", "rwm_dx_launch", "rwm_dw_launch", "rwm_dalpha_launch"
K3_BF16 = "rwm_bf16_wgmma_launch"
K4, K5, K6 = "segment_sum_launch", "segment_softmax_launch", "halo_pull_launch"
# routes: the launchers a path takes.  Every model pools onsets through K1; a hetero conv runs K1 for each
# single relation and, per fused group, K1 ("node") or K3's forward ("edge-zxp"), whose dx and dw a backward adds
# (alpha carries no gradient: no d alpha); HybridHGT with use_pallas runs K2 in every layer
NODE, HGT = frozenset({K1}), frozenset({K1, K2})
EDGE_SERVE, EDGE_TRAIN = frozenset({K1, K3}), frozenset({K1, K3, K3_DX, K3_DW})
# the kernels of the closing line: name, launcher, source under analysisgnn_tpu_torch/csrc/, the TPU kernel replaced
KERNELS = (
    ("segment_mean_base", K1, "segment_mean_base.cu", "analysisgnn_tpu/kernels/pallas_segment.py:263"),
    ("segment_mean_base.bf16", K1_BF16, "segment_mean_base.cu", "analysisgnn_tpu/kernels/pallas_segment.py:263"),
    ("relation_weighted_matmul", K3, "relation_weighted_matmul.cu", "analysisgnn_tpu/kernels/pallas_relmm.py:93"),
    ("relation_weighted_matmul.dx", K3_DX, "relation_weighted_matmul.cu",
     "analysisgnn_tpu/kernels/pallas_relmm.py:116"),
    ("relation_weighted_matmul.dw", K3_DW, "relation_weighted_matmul.cu",
     "analysisgnn_tpu/kernels/pallas_relmm.py:122"),
    ("relation_weighted_matmul.dalpha", K3_DALPHA, "relation_weighted_matmul.cu",
     "analysisgnn_tpu/kernels/pallas_relmm.py:122"),
    ("relation_weighted_matmul.bf16", K3_BF16, "relation_weighted_matmul.cu",
     "analysisgnn_tpu/kernels/pallas_relmm.py:93"),
    ("segment_softmax_agg", K2, "segment_softmax_agg.cu", "analysisgnn_tpu/kernels/pallas_segment.py:754"),
    ("segment_sum_sorted", K4, "segment_mean_base.cu", "analysisgnn_tpu/kernels/pallas_segment.py:302"),
    ("segment_softmax_sorted", K5, "segment_softmax.cu", "analysisgnn_tpu/kernels/pallas_segment.py:486"),
    ("halo_pull", K6, "halo_pull.cu", "analysisgnn_tpu/kernels/halo.py:97"),
)
K1_RTOL = 1e-5  # kernel vs plain: f32 sums of the same terms in another order
LOGIT_ATOL = 1e-3  # GPU vs CPU logits of the whole model at full width
REQUEST_NOTES = (2000, 8000, 20000)
BUCKET_FACTOR = 1.25
PROFILER_ATTEMPTS = 5  # profiler windows taken before a short one fails (check_alone)
# K3 kernel vs plain, elementwise, relative to the same contraction of the
# absolute values (the sum of |terms|, which bounds f32 rounding): sums of
# up to T*F = 1,792 (forward, dx), N = 5,376 (dw) or F*G = 65,536 (d alpha)
# terms in another order; a random walk of K roundings is about
# sqrt(K) * 6e-8 = 4.4e-6 of it at K = 5,376, a wrong index is O(1)
K3_RTOL = 1e-4
# the train workload of bench.py: HybridGNN 3 x 256 -> 128 over 500-note x 8 subgraphs
TRAIN_CFG = {"model": "HybridGNN", "num_layers": 3, "hidden_channels": 256, "out_channels": 128, "in_channels": 25,
             "use_jk": True, "final_norm": True, "plain_proj": True, "dropout": 0.3,
             "add_beats": True, "add_measures": True}
# K2 kernel vs plain, elementwise, relative to the sum of |terms| of each
# result (the weighted sum of |msgs| for the output, w * |g| for d msgs,
# w * (<|msgs|, |g|> + <|out|, |g|>) for d logits): the same terms summed in
# another order, over a node's few dozen edges, with expf within 2 ulp; a
# random walk of K roundings is about sqrt(K) * 6e-8 = 6e-7 of it at K = 100,
# a wrong index is O(1)
K2_RTOL = 1e-5
# the "HGT-emax-pallas" model of scripts/bench_encoders.py:98-114 on the same batches
HGT_CFG = {**TRAIN_CFG, "model": "HGT", "use_pallas": True}
# train arms: conv_impl of the HybridGNN, the HGT model, or the MetricalGNN with the stacked BiGRU of use_rnn
# and K3's layout
ARMS = {"edge-zxp": {**TRAIN_CFG, "conv_impl": "edge-zxp"}, "node": {**TRAIN_CFG, "conv_impl": "node"},
        "hgt": HGT_CFG, "metrical": {**TRAIN_CFG, "model": "MetricalGNN", "use_rnn": True, "conv_impl": "edge-zxp"}}
# bf16 compute: the bench step of both HybridGNN layouts with StepConfig compute_dtype="bfloat16"
BF16_ARMS = ("node-bf16", "edge-zxp-bf16")
ARMS.update({"node-bf16": ARMS["node"], "edge-zxp-bf16": ARMS["edge-zxp"]})
# the train CLI's last five knobs: edge-zxp with the deep projections, logit fusion, remat of the hidden convs and
# dropout after the final conv; its torch-style draw leaves the fused stacks out (--no_fused_torch_init)
ARMS["variants"] = {**ARMS["edge-zxp"], "plain_proj": False, "logit_fusion": True, "remat": True,
                    "final_dropout": True}
UNFUSED_INIT_ARMS = ("variants",)
# each arm's route a train step.  Under bf16 compute the first conv reads the bf16 projections: its K1 launches
# (the HybridGNN's beat and measure relations, and the fused group under "node") read bf16 rows, and its K3
# forward takes two bf16 operands that TMA can describe (the wgmma kernel); every later conv and onset pooling
# read f32 states, and the backward runs the f32 kernels
TRAIN_ROUTES = {"edge-zxp": EDGE_TRAIN, "node": NODE, "hgt": HGT, "metrical": EDGE_TRAIN, "variants": EDGE_TRAIN,
                "node-bf16": NODE | {K1_BF16}, "edge-zxp-bf16": EDGE_TRAIN | {K1_BF16, K3_BF16}}
TRAIN_STEPS = 2  # steps after the warm-up: the first captures a batch signature's CUDA graph, the second replays it
FALL_ARMS = ("edge-zxp", "hgt", "edge-zxp-bf16")  # the metrical Trainer runs show its loss falling
# one step on the GPU against the CPU; the CPU steps take a batch of PARITY_BATCH of the bench's 500-note subgraphs
# (8 in the train steps), the same models at full width
PARITY_ARMS = ("edge-zxp", "hgt", "metrical", "node-bf16", "edge-zxp-bf16")
PARITY_BATCH = 2
FALL_STEPS = 6
# K3's bf16 forward vs its plain version (the f32 einsum of the upcast
# operands), elementwise, relative to the sum of |terms|: products of bf16
# values are exact in f32 (and a bf16 value exact in TF32, so the f32
# kernels' lo terms are 0 on upcast copies), so the two differ only in the
# order of f32 sums
K3_BF16_RTOL = 1e-5
# one bf16 step on the GPU against the same bf16 step on the CPU (same
# weights and batch, dropout 0, PARITY_LR and PARITY_EPS): bf16 rounds
# products and sums at other places on each device (cuBLAS and the CPU's
# kernels, the kernels' f32 accumulation against index_add_), so the loss
# within 1e-2 relative and every parameter's update (lr g / (|g| + 1)) within
# 1e-1 relative L2 over all parameters: the port's CPU tests find bf16
# gradients 3.4e-2 from the JAX step's in that norm
BF16_PARITY_LOSS_RTOL, BF16_PARITY_UPDATE_RTOL = 1e-2, 1e-1
# GPU vs CPU after one train step at the constant rate PARITY_LR, with the
# optimizer's eps raised to PARITY_EPS: Adam's first step moves every
# coordinate by +-lr whatever its gradient's size, so a coordinate whose true
# gradient is zero (the JK attention bias: the softmax over layers ignores
# it) moves by +-lr on rounding noise, differently on each device; with
# eps = 1 the update is lr * g / (|g| + 1), linear in the gradient, and the
# parameters check the gradients.  The loss relative (the same f32 model in
# another summation order); every parameter absolute: the largest parameters
# (embeddings drawn from N(0, 1), up to about 5) have an f32 spacing of
# 4.8e-7, so the tolerance allows two roundings of the updated value.
PARITY_LR, PARITY_EPS = 5e-3, 1.0
PARITY_LOSS_RTOL, PARITY_PARAM_ATOL = 1e-5, 1e-6
# K4 kernel vs plain, elementwise, relative to the sum of |terms| of each
# output row (the segment's messages summed in another order)
K4_RTOL = 1e-5
# K5 kernel vs plain: weights in [0, 1], absolute; the weights of each run of
# equal ids sum to 1 within K5_SUM_ATOL
K5_ATOL, K5_SUM_ATOL = 1e-6, 1e-5
# the training entry point at full width: three main tasks (the CLI's
# default), --num_epochs 3 = 1 epoch of combined mode, 4 steps per task, with
# the edge-consistency loss
TRAINER_FLAGS = ["--demo", "--use_metrical", "--use_pallas", "--conv_impl", "edge-zxp", "--do_train", "--do_eval",
                 "--num_epochs", "3", "--max_steps_per_epoch", "4", "--main_tasks", "all,cadence,rna",
                 "--use_edge_loss"]
HGT_TRAINER_FLAGS = ["--demo", "--use_metrical", "--model", "HGT", "--use_pallas", "--do_train",
                     "--num_epochs", "3", "--max_steps_per_epoch", "4", "--main_tasks", "all,cadence,rna",
                     "--hgt_stage_dtype", "bfloat16"]
# single-task cadence training with SMOTE: continual-learning mode with one
# task makes "cadence" the only active head, where the step oversamples
SMOTE_TRAINER_FLAGS = ["--demo", "--use_metrical", "--use_pallas", "--conv_impl", "edge-zxp", "--do_train",
                       "--cl_training", "--main_tasks", "cadence", "--use_smote", "--num_epochs", "2",
                       "--max_steps_per_epoch", "4"]
# one fit epoch on the GPU against the CPU: losses of the same f32 model in another summation order
TRAINER_PARITY_FLAGS = ["--demo", "--use_metrical", "--use_pallas", "--conv_impl", "edge-zxp", "--dropout", "0",
                        "--num_epochs", "1", "--main_tasks", "all"]
TRAINER_PARITY_RTOL = 1e-5
# scripts/parity_experiment.py:84-99's recipe (the repo's training run with task
# metrics, RESULTS.md) at full width on a temporary copy of data_synth/ and its
# split file; the default conv_impl "node" runs every SAGE layer and onset
# pooling through K1
RAW_DIR_FLAGS = ["--model", "HybridGNN", "--num_layers", "3", "--hidden_channels", "256", "--out_channels", "128",
                 "--subgraph_size", "500", "--batch_size", "80", "--main_tasks", "all", "--use_transpositions",
                 "--seed", "0"]
RAW_DIR_EPOCHS = 2
# data_synth/'s samples per interval under transposition: 227 in all, the
# JAX corpus's list (tests/test_torch_port_corpora.py)
RAW_DIR_COUNTS = {"P1": 24, "M2": 20, "m3": 20, "P4": 20, "P5": 20, "m6": 20, "M6": 20, "m7": 20, "M3": 18,
                  "M7": 18, "m2": 15, "A4": 12}
# configs/example_config.json as the file stands (HybridGNN 3 x 256 -> 128,
# continual learning over all, cadence and rna, batch 100, 500-note
# subgraphs, transpositions), one epoch per task of 4 steps, on the raw-dir
# phase's copy of data_synth/ with cadence/ and rna/ of its first 8 TSVs;
# the CLI's default 5 sampler threads
CL_CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs", "example_config.json")
CL_TASKS = ("all", "cadence", "rna")
CL_TSVS = 8
CL_TRAINER_FLAGS = ["--num_epochs", "3", "--max_steps_per_epoch", "4", "--do_train", "--do_eval"]
# the CL path with EWC and FAMO at full width on the edge-zxp arm (K3), GPU
# against CPU over two tasks of one epoch each, with the optimizer's eps at
# PARITY_EPS: from the second step on the rate is nonzero, and Adam would
# move a coordinate whose gradient is rounding noise (the gather's backward
# adds in no fixed order on the card) by the rate on either side, which
# reached 2e-5 of an epoch's loss in one of two runs; FAMO's logits after 4
# updates (Adam at 0.025 a step) absolute, the fisher's sum (squared
# gradients of one replay batch) relative: at least ten times the largest
# of three runs on an H100 (w 8.9e-08, the fisher's sum 6.1e-08)
CL_PARITY_FLAGS = ["--demo", "--cl_training", "--main_tasks", "all,cadence", "--use_ewc", "--mt_strategy", "famo",
                   "--conv_impl", "edge-zxp", "--dropout", "0", "--num_epochs", "2", "--num_workers", "0"]
CL_FAMO_W_ATOL, CL_FISHER_RTOL = 1e-5, 1e-6
# partitioned against full-graph embeddings: 2e-4 of the largest |full| plus
# 2e-5 (__graft_entry__.py:341-344; the JAX partition tests' tolerance)
PART_RTOL, PART_ATOL = 2e-4, 2e-5
PART_NOTES = 20000
PART_SEED = 0  # its largest edge span, 24 rows, is regime 2's halo and the shape of K6's first check
PARTITIONS = 4  # regime 1's, the CLI's and K6's first check's
REGIME2_PARTITIONS = (1, 2, 4, 8)
# RNA serve and the chord chain: generated MusicXML scores of about 2,000 notes
RNA_NOTES = 2000
CHORD_NOTES = 2000
CHORD_HIDDEN, CHORD_LAYERS = 256, 1  # predict_chords' CLI defaults
# GPU vs CPU probabilities of the chord chain (float64 softmaxes of f32 logits
# of the same weights, summed in another order on the card; a softmax moves
# by at most half its largest logit change, and the serve phase holds whole-
# model logits at full width to 1e-3): absolute.  An onset may decode to
# another label on the card only where that task's top two CPU probabilities
# lie within 2 * CHORD_PROB_ATOL of each other; where every label is equal,
# the resolved annotations must be equal too
CHORD_PROB_ATOL = 1e-4
# the MetricalGNN family through the training entry point at the CLI's full width (MetricalGNN 3 x 256 -> 128,
# JK, beats and measures) on the demo corpus, two epochs of 4 steps: the node layout (K1), then use_rnn with
# edge-zxp (K3); each checkpoint served by the predict CLI on a generated MusicXML score
METRICAL_FLAGS = ["--demo", "--model", "MetricalGNN", "--use_metrical", "--do_train", "--main_tasks", "all",
                  "--num_epochs", "2", "--max_steps_per_epoch", "4"]
METRICAL_RNN_FLAGS = [*METRICAL_FLAGS, "--use_rnn", "--conv_impl", "edge-zxp"]
METRICAL_NOTES = 2000
# GPU vs CPU probabilities of a served metrical checkpoint: as CHORD_PROB_ATOL
METRICAL_PROB_ATOL = 1e-4
# AssocBiGRU on the card against the CPU at a train batch's beat rows, F = 256: the states are convex
# combinations (|h| <= 1) of gate values from 512-term dot products summed in another order, and the
# recurrence contracts errors; absolute, the JAX tests' bound for the scan against the sequential cell
SCAN_ATOL = 2e-5
# the serve path's host graph build of the serve phase's largest score: the C++ edge builder against its numpy twin
GRAPH_NOTES = 20000
# the training entry point with the train CLI's last five knobs at full width, one combined epoch of 2 steps; its
# losses fall over FALL_STEPS steps on one bench batch, its last.pt is served, and one dropout-0 step of its
# weights on a batch of its data runs on the GPU against the CPU (PARITY_LOSS_RTOL, PARITY_PARAM_ATOL)
VARIANT_TRAINER_FLAGS = ["--demo", "--use_metrical", "--use_pallas", "--conv_impl", "edge-zxp", "--deep_proj",
                         "--logit_fusion", "--remat", "--final_dropout", "--no_fused_torch_init", "--do_train",
                         "--num_epochs", "3", "--max_steps_per_epoch", "2", "--main_tasks", "all,cadence,rna"]
# one train step of the variants arm (dropout 0) on a whole 20,000-note score with beats and measures, with and
# without remat; the loss relative and the concatenated gradients in relative L2 (the same function, the gather's
# backward adding in no fixed order)
REMAT_NOTES = 20000
REMAT_RTOL = 1e-5
# pre-training and the rest of the layer zoo at full width, weights drawn from seed 0.  The PreEncoder (HybridHGT
# pair 3 x 256, 4 heads, JK, no K2: the JAX module's build) pre-trains on the bench's batches with seeded voice /
# staff attributes in {1, 2} (tests/test_model_families.py:226-229), AdamW at PRETRAIN_LR with optax's weight decay
# and no clipping (the JAX step's optax.adamw): the loss falling over FALL_STEPS steps on one batch after a
# warm-up, one dropout-0 step on the GPU against the CPU at PARITY_EPS on a batch of PARITY_BATCH (the loss within
# PARITY_LOSS_RTOL, every parameter within PARITY_PARAM_ATOL)
PRETRAIN = {"hidden": 256, "num_layers": 3, "heads": 4}
PRETRAIN_LR, PRETRAIN_WEIGHT_DECAY = 1e-3, 1e-4
# the layer zoo on one bench batch at width 256, forward and backward, GPU against CPU on the same weights: each
# output's note rows within ZOO_RTOL of its largest |value| (the same f32 sums in another order; K4 sums a node's
# few dozen messages, HGPS's softmax runs over 5,376 keys), the gradients of the parameters and the input within
# ZOO_GRAD_RTOL in relative L2.  The gradient is not continuous at a ReLU's kink: a pre-activation within f32
# rounding of 0 lands on the other side of it on the card, and each such unit moves the gradient by its term, 1e-4
# to 1e-3 of the gradient's norm here (HGPS: 2 of the last layer's 2.2 million ff1 units, at |pre| < 6e-7, moved
# it by 1.1e-3 in one chip run and by 2.7e-4 in another, where the CPU's f32 gradient lay within 4.5e-7 of float64:
# chip runs, NVIDIA H100 80GB HBM3, 700.00 W, PERF.md section 6); a wrong index or a dropped term moves it by
# O(1).  Padding rows (graph id -1) are never read: a finite output is all they owe, and the cotangent is 0
# there.  HGPS's padding rows have no valid key and attend uniformly to every key, as flax's do; their output is a
# mean over the 5,376 rows, which the card sums in another order: 1.4e-5 of the largest |output| from float64
# after two layers, where the note rows lie within 8.6e-7 on the card and 7.0e-7 on the CPU (chip run, NVIDIA
# H100 80GB HBM3, 700.00 W, PERF.md section 6)
ZOO_HIDDEN = 256
ZOO_RTOL, ZOO_GRAD_RTOL = 1e-5, 1e-2
HGPS_LAYERS, HGPS_HEADS, HRES_LAYERS, GAT_HEADS = 2, 4, 3, 3
# UNet((32, 64, 128), out 1) on pianoroll-shaped images [B, 88 pitches, 256 steps, 1], GPU against CPU: the same
# convolutions (cuDNN, TF32 off) and GroupNorms in another order, within UNET_RTOL of the largest |output|
UNET_SHAPE, UNET_FEATURES, UNET_RTOL = (8, 88, 256, 1), (32, 64, 128), 1e-5
# hetero_fidelity of the serve model on a FID_NOTES-note request, a seeded mask keeping half of each note -> note
# relation's edges: three forwards through the serve path's K1; the pretrained PreEncoder's voice links on the
# same score, then voice_from_edges, pianoroll_svg, graph_to_json, GraphSampler and the Laplacian positional
# encoding on the host
FID_NOTES = 2000
LAP_PE_K = 8


def phase(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f}s] {msg}", flush=True)


def _grown(before: dict) -> dict:
    """``(launcher, card) -> launches`` since ``before``, a copy of
    ``launches_by_device``."""
    from analysisgnn_tpu_torch.kernels.launch import launches_by_device

    return {key: c - before.get(key, 0) for key, c in launches_by_device.items() if c != before.get(key, 0)}


@contextlib.contextmanager
def route(label: str, want):
    """The block's path through the kernels: the launchers whose count grew
    in ``launches_by_device`` while it ran, on any card, must be ``want``
    (a set of launcher symbols; empty for a path on the CPU).  Yields a dict
    that holds each of them with its launches once the block has run."""
    from analysisgnn_tpu_torch.kernels.launch import launches_by_device

    before = dict(launches_by_device)
    launched = {}
    yield launched
    for (symbol, _card), c in _grown(before).items():
        launched[symbol] = launched.get(symbol, 0) + c
    if set(launched) != set(want):
        raise AssertionError(f"{label}: launched {launched}, its route is {sorted(want)}")


def check_alone(fn, kernel: str, iters: int = 20) -> None:
    """Each of ``iters`` calls of ``fn`` launches ``kernel`` (a substring of
    the kernel's name) once and no other kernel, as torch.profiler's CUDA
    records show them.  A window now and then comes back short of records in
    a process profiled before (seen on the H100 with none of the window's
    kernels, or 13 of 20 launches): such a window is taken again, up to
    PROFILER_ATTEMPTS times, and one that holds at least half of the
    launches is taken at last.  More launches than calls, or another kernel,
    fail at once."""
    from torch.profiler import ProfilerActivity, profile

    def window(body) -> list:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            body()
        return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]

    fn()
    torch.cuda.synchronize()
    pad = torch.zeros(8, device="cuda")

    def padding():
        # a window may lose its first kernel records (two of them, in a process
        # profiled before): eight small launches of another kernel take them
        for _ in range(8):
            pad.add_(1.0)
        torch.cuda.synchronize()

    def calls():
        padding()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()

    pad_keys = set()  # the names of the padding launches' kernels, to tell them from the calls'
    for _ in range(PROFILER_ATTEMPTS):
        pad_keys = {e.key for e in window(padding)}
        if pad_keys:
            break
    if not pad_keys:
        raise AssertionError(f"the profiler recorded no kernel in {PROFILER_ATTEMPTS} windows of padding launches")
    fullest = 0
    for _ in range(PROFILER_ATTEMPTS):
        cuda = window(calls)
        count = sum(e.count for e in cuda if kernel in e.key)
        others = [f"{e.key} x{e.count}" for e in cuda if kernel not in e.key and e.key not in pad_keys]
        if count > iters or others:
            raise AssertionError(f"{iters} calls of {kernel}: the profiler saw {count} launches of it and other "
                                 f"kernels {others}")
        if count == iters:
            return
        fullest = max(fullest, count)
        phase(f"check_alone: the profiler's window held {count} of the {iters} launches of {kernel}; taking it again")
    if 2 * fullest < iters:
        raise AssertionError(f"the profiler saw fewer than {iters} launches of {kernel} in {PROFILER_ATTEMPTS} "
                             f"windows of {iters} calls")


def environment() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this check needs an NVIDIA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase(f"environment: python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    phase(f"environment: nvidia-smi name,power.limit = {smi}")
    phase(f"environment: matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    return smi


def build_kernels() -> None:
    from analysisgnn_tpu_torch.kernels import build

    # the CUDA sources with nvcc and the host edge builder (graphbuild.cpp) with g++, all started together
    built = build.build_all(["segment_mean_base", "relation_weighted_matmul", "segment_softmax_agg", "segment_softmax",
                             "halo_pull", "graphbuild"])
    for name, (_seconds, log) in built.items():
        phase(f"build: {name} -> {build.library_path(name).name}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line or "C75" in line:
                phase(f"build:   {line.strip()}")


def kernel_entries(worst: dict, launches: dict) -> list:
    """The closing line's kernels that ``worst`` (name -> the largest
    |kernel - plain| over the run) holds, each with ``launches[launcher]``:
    its launches on the main paths, as their routes read them from
    ``launches_by_device`` (``{"launches": 0}`` where no main path takes it;
    the kernel checks' own launches are not counted)."""
    return [{"name": name, "route": "cuda", "source": f"analysisgnn_tpu_torch/csrc/{source}", "replaces": replaces,
             "max_abs_err": worst[name], **launches.get(symbol, {"launches": 0})}
            for name, symbol, source, replaces in KERNELS if name in worst]


def close(smi: str, worst: dict, launches: dict) -> None:
    phase(f"all phases passed in {time.perf_counter() - T0:.1f}s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernel_entries(worst, launches)}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


def check_k1(name: str, msgs, seg, x_base, num_segments, row_ptr=None) -> dict:
    """K1's kernel against its plain version; ``row_ptr``, a plan's, is passed
    as ``aggregate`` passes it."""
    from analysisgnn_tpu_torch.kernels.segment_mean import segment_mean_base, segment_mean_base_plain

    out, cnt = segment_mean_base(msgs, seg, x_base, num_segments, row_ptr)
    ref, ref_cnt = segment_mean_base_plain(msgs, seg, x_base, num_segments)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise AssertionError(f"K1 {name}: non-finite output")
    err = (out - ref).abs()
    max_abs = float(err.max()) if err.numel() else 0.0
    if not bool((err <= K1_RTOL * (1.0 + ref.abs())).all()):
        raise AssertionError(f"K1 {name}: max |kernel - plain| = {max_abs:.3e} exceeds {K1_RTOL} rel")
    if not torch.equal(cnt, ref_cnt):
        raise AssertionError(f"K1 {name}: counts differ from the plain version")
    e, f = msgs.shape
    m = x_base.shape[0]
    e_valid = int((seg.long() < num_segments).sum())
    rows = str(msgs.dtype).replace("torch.", "")
    phase(f"kernel check: K1 {name}: E={e} (valid {e_valid}) F={f} m={m} S={num_segments} {rows} rows "
          f"max|d|={max_abs:.3e} (tol {K1_RTOL} rel)")
    return {"case": name, "max_abs_err": max_abs, "rows": rows}


def kernel_checks(model, largest_notes: int) -> list:
    from analysisgnn_tpu_torch.core.graph import NOTE
    from analysisgnn_tpu_torch.data.note_array import synthetic_score
    from analysisgnn_tpu_torch.inference.predict import graph_from_note_array
    from analysisgnn_tpu_torch.models.analysis import restrict_edges_to_targets
    from analysisgnn_tpu_torch.models.conv import sage_plan
    from analysisgnn_tpu_torch.models.hetero import plan_hetero

    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(1)
    f = model.encoder.final.fused[NOTE].w_neigh.shape[1]  # the hidden width
    graph = graph_from_note_array(
        synthetic_score(largest_notes, seed=largest_notes), add_beats=False, add_measures=False,
        bucket_factor=BUCKET_FACTOR, device=dev,
    )
    n = graph.capacity(NOTE)
    fused = plan_hetero(graph.edge_index, model.edge_types, {NOTE: n})[NOTE]
    onset = sage_plan(
        restrict_edges_to_targets(graph.edges((NOTE, "onset", NOTE)), graph.num_target_nodes, n), n, n
    )
    rows = []
    for name, plan in (("fused note layer T=7", fused), ("onset pooling T=1", onset)):
        e = plan.seg.shape[0]
        msgs = torch.randn(e, f, generator=g).to(dev)
        x_base = torch.randn(plan.base_rows, f, generator=g).to(dev)
        rows.append(check_k1(name, msgs, plan.seg, x_base, plan.num_segments, row_ptr=plan.row_ptr))
        if plan is fused:  # the same layer on bf16 rows, as layer 0 reads them under bf16 compute
            rows.append(check_k1(f"{name} of a {largest_notes}-note request", msgs.bfloat16(), plan.seg,
                                 x_base.bfloat16(), plan.num_segments, row_ptr=plan.row_ptr))
    # edge cases: padding ids past the end, empty segments, the scalar path, no edges
    for name, e, f_, m, t in (("padding+empty F=256", 5000, 256, 1000, 3), ("F=25", 3000, 25, 500, 7),
                              ("F=6 scalar path", 700, 6, 64, 2), ("no edges", 0, 256, 128, 2)):
        s = m * t
        seg = torch.randint(0, s + s // 10 + 1, (e,), generator=g).sort().values.to(torch.int32)
        msgs = torch.randn(e, f_, generator=g)
        x_base = torch.randn(m, f_, generator=g)
        rows.append(check_k1(name, msgs.to(dev), seg.to(dev), x_base.to(dev), s))
    return rows


def serve(model) -> dict:
    """Each request twice through predict_score_ids on the card: K1 alone and
    as often both times, the same ids, the C++ edge builder once a request.
    Returns the launches of one request of the largest score, by launcher."""
    from analysisgnn_tpu_torch.data.graph_build import build_score_graph
    from analysisgnn_tpu_torch.data.native import build_note_edges_native
    from analysisgnn_tpu_torch.data.note_array import synthetic_score
    from analysisgnn_tpu_torch.inference.predict import predict_score_ids

    for notes in REQUEST_NOTES:
        na = synthetic_score(notes, seed=notes)
        native_before = build_note_edges_native.calls
        requests = []
        for _ in range(2):
            with route(f"serve: a {notes}-note request", NODE) as launched:
                requests.append((predict_score_ids(model, na, add_beats=False, add_measures=False,
                                                   bucket_factor=BUCKET_FACTOR, device="cuda"), launched))
        (ids, launched), (again, launched_again) = requests
        if launched != launched_again:
            raise AssertionError(f"{notes}-note requests: launched {launched}, then {launched_again}")
        native_builds = build_note_edges_native.calls - native_before
        if native_builds != 2:
            raise AssertionError(f"{notes}-note requests: {native_builds} native edge builds in 2 requests")
        for k, v in ids.items():
            if v.shape != (notes,) or (v < 0).any() or not np.array_equal(v, again[k]):
                raise AssertionError(f"{notes}-note request: bad or unstable ids for {k}")
        edges = sum(ei.shape[1] for ei in build_score_graph(na, add_beats=False, add_measures=False).edges.values())
        phase(f"serve: {notes} notes, {edges} note-note edges: two requests through K1 alone ({launched}), the "
              f"same ids; the C++ edge builder ran once a request")
    return launched


@torch.no_grad()
def check_logits(model, notes: int) -> float:
    """The largest request's logits on the GPU against the port on the CPU."""
    from analysisgnn_tpu_torch.core.graph import NOTE
    from analysisgnn_tpu_torch.data.note_array import synthetic_score
    from analysisgnn_tpu_torch.inference.predict import graph_from_note_array
    from analysisgnn_tpu_torch.models.analysis import SERVE_CONFIG, model_from_config

    na = synthetic_score(notes, seed=notes)
    cpu_model = model_from_config(SERVE_CONFIG, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    logits = {}
    for label, dev, m in (("gpu", "cuda", model), ("cpu", "cpu", cpu_model)):
        g = graph_from_note_array(na, add_beats=False, add_measures=False, bucket_factor=BUCKET_FACTOR, device=dev)
        a = g.node_attrs[NOTE]
        with route(f"serve: the {notes}-note forward on the {label}", NODE if label == "gpu" else set()):
            out = m(g.node_features, g.edge_index, a["pitch_spelling"], a["key_signature"], g.num_target_nodes)
        logits[label] = {k: v[:notes].float().cpu() for k, v in out.items()}
    worst = 0.0
    for task, n_cls in model.task_dict:
        a, b = logits["gpu"][task], logits["cpu"][task]
        if a.shape != (notes, n_cls) or not torch.isfinite(a).all():
            raise AssertionError(f"logits of {task}: shape {tuple(a.shape)} or non-finite values")
        worst = max(worst, float((a - b).abs().max()))
    if worst > LOGIT_ATOL:
        raise AssertionError(f"GPU vs CPU logits differ by {worst:.3e} > {LOGIT_ATOL}")
    phase(f"serve: {notes}-note logits, GPU vs CPU port (plain versions, same weights): "
          f"max|d| = {worst:.3e} (tol {LOGIT_ATOL} abs), all 21 heads finite")
    return worst


def graph_build_phase() -> None:
    """The serve path's host graph build of the serve phase's largest score:
    the C++ edge builder (data/native.py, built with g++ in the build phase)
    against its numpy twin, every array equal."""
    from analysisgnn_tpu_torch.data.graph_build import build_score_graph
    from analysisgnn_tpu_torch.data.native import build_note_edges_native
    from analysisgnn_tpu_torch.data.note_array import synthetic_score

    na = synthetic_score(GRAPH_NOTES, seed=GRAPH_NOTES)
    calls = build_note_edges_native.calls
    got = build_score_graph(na, add_beats=False, add_measures=False)
    want = build_score_graph(na, add_beats=False, add_measures=False, use_native=False)
    if build_note_edges_native.calls != calls + 1:
        raise AssertionError("build_score_graph did not take the C++ edge builder")
    if list(got.edges) != list(want.edges) or not all(
        got.edges[k].dtype == want.edges[k].dtype and np.array_equal(got.edges[k], want.edges[k]) for k in want.edges
    ):
        raise AssertionError(f"{GRAPH_NOTES} notes: the C++ edge builder's arrays differ from the numpy builder's")
    edges = sum(v.shape[1] for v in got.edges.values())
    phase(f"graph build: {GRAPH_NOTES} notes, {edges} note-note edges, every array of the C++ edge builder equal to "
          f"the numpy builder's")


# ----------------------------------------------------------------- training


def check_k3(name: str, n: int, f: int, g: int, t: int, strided: bool = False) -> dict:
    """K3's four kernels against the plain version (value and autograd
    gradients) on the same inputs, and two dw and two d alpha calls bit for
    bit; with ``strided``, x is a non-contiguous view."""
    from analysisgnn_tpu_torch.kernels import relmm

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(n * 7 + t)
    x = (torch.randn(f, n, generator=gen).t() if strided else torch.randn(n, f, generator=gen)).to(dev)
    w = (torch.randn(t, f, g, generator=gen) / f**0.5).to(dev)
    alpha = torch.rand(t, n, generator=gen).to(dev)
    gout = torch.randn(n, g, generator=gen).to(dev)
    if x.is_contiguous() == strided:
        raise AssertionError(f"K3 {name}: x is {'' if strided else 'not '}contiguous")
    leaves = [v.clone().requires_grad_(True) for v in (x, w, alpha)]
    out = relmm.relation_weighted_matmul(*leaves)
    got = (out.detach(), *torch.autograd.grad(out, leaves, gout))
    plain_leaves = [v.clone().requires_grad_(True) for v in (x, w, alpha)]
    ref_out = relmm.relation_weighted_matmul_plain(*plain_leaves)
    want = (ref_out.detach(), *torch.autograd.grad(ref_out, plain_leaves, gout))
    # the sums of |terms| of each result, the scale of its rounding
    abs_leaves = [v.abs().requires_grad_(True) for v in (x, w, alpha)]
    abs_out = relmm.relation_weighted_matmul_plain(*abs_leaves)
    scales = (abs_out.detach(), *torch.autograd.grad(abs_out, abs_leaves, gout.abs()))
    torch.cuda.synchronize()
    errs = {}
    for part, a, b, sc in zip(("forward", "dx", "dw", "dalpha"), got, want, scales):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"K3 {name} {part}: shape {tuple(a.shape)} vs {tuple(b.shape)} or non-finite values")
        err = (a - b).abs()
        if not bool((err <= K3_RTOL * sc).all()):
            worst = float((err / sc.clamp_min(1e-30)).max())
            raise AssertionError(f"K3 {name} {part}: |kernel - plain| reaches {worst:.3e} of the sum of |terms| "
                                 f"(tol {K3_RTOL})")
        errs[part] = float(err.max())
    # dw and d alpha sum their partials in a fixed order: the same bits every call
    if not torch.equal(relmm.rwm_dw(x, gout, alpha), relmm.rwm_dw(x, gout, alpha)):
        raise AssertionError(f"K3 {name}: two dw calls on the same inputs differ")
    if not torch.equal(relmm.rwm_dalpha(x, w, gout), relmm.rwm_dalpha(x, w, gout)):
        raise AssertionError(f"K3 {name}: two d alpha calls on the same inputs differ")
    phase(f"kernel check: K3 {name}: N={n} F={f} G={g} T={t}{' strided x' if strided else ''} max|d| "
          + " ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (tol {K3_RTOL} of the sum of |terms|); "
          "dw and d alpha bit-equal over two calls")
    return {"case": name, "max_abs_err": errs}


def k3_checks(n_train: int) -> list:
    rows = [check_k3("train shape", n_train, 256, 256, 7)]
    # N not a multiple of the 128-row tile, below one tile, one row; T=1; F != G,
    # G not a tile multiple; F not a multiple of the 32-deep chunk, and F, G not
    # multiples of 4 (4-byte copies); x a non-contiguous view
    for name, n, f, g, t in (("N=300", 300, 256, 256, 7), ("T=1", 1000, 256, 256, 1),
                             ("F=64 G=96", 300, 64, 96, 3), ("F=40 G=24", 77, 40, 24, 2),
                             ("N=1", 1, 256, 256, 7), ("N=63", 63, 256, 256, 7), ("F=25 G=20", 65, 25, 20, 3)):
        rows.append(check_k3(name, n, f, g, t))
    rows.append(check_k3("strided x", 300, 256, 256, 7, strided=True))
    return rows


def check_k1_backward(batch) -> dict:
    """K1's gradient through the CUDA kernel against the plain version's
    autograd, at the fused note layer's shape of a train batch (F = 256),
    padding edges included."""
    from analysisgnn_tpu_torch.core.graph import NOTE, NOTE_EDGE_TYPES
    from analysisgnn_tpu_torch.kernels.segment_mean import segment_mean_base, segment_mean_base_plain
    from analysisgnn_tpu_torch.models.fused import fused_plan

    n = batch.capacity(NOTE)
    plan = fused_plan([batch.edges(et) for et in NOTE_EDGE_TYPES], n)
    gen = torch.Generator(device="cpu").manual_seed(2)
    e, f = plan.seg.shape[0], TRAIN_CFG["hidden_channels"]
    msgs = torch.randn(e, f, generator=gen).cuda()
    x_base = torch.randn(n, f, generator=gen).cuda()
    g = torch.randn(plan.num_segments, f, generator=gen).cuda()
    grads = {}
    for name, fn in (("kernel", segment_mean_base), ("plain", segment_mean_base_plain)):
        leaves = [msgs.clone().requires_grad_(True), x_base.clone().requires_grad_(True)]
        out, _ = fn(leaves[0], plan.seg, leaves[1], plan.num_segments)
        grads[name] = torch.autograd.grad(out, leaves, g)
    torch.cuda.synchronize()
    padding = plan.seg.long() >= plan.num_segments
    worst = 0.0
    for part, a, b in zip(("d msgs", "d x_base"), grads["kernel"], grads["plain"]):
        err = (a - b).abs()
        if not bool((err <= K1_RTOL * (1.0 + b.abs())).all()):
            raise AssertionError(
                f"K1 backward {part}: max |kernel - plain| = {float(err.max()):.3e} exceeds {K1_RTOL} rel")
        worst = max(worst, float(err.max()))
    if int(padding.sum()) == 0 or bool(grads["kernel"][0][padding].any()):
        raise AssertionError("K1 backward: the batch has no padding edges, or they got a nonzero gradient")
    phase(f"kernel check: K1 backward at the fused note layer: E={e} ({int(padding.sum())} padding) F={f} "
          f"S={plan.num_segments}: max|d| {worst:.3e} (tol {K1_RTOL} rel), padding gradients exactly 0")
    return {"max_abs_err": worst}


def check_k2(name: str, logits, msgs, plan) -> dict:
    """K2's kernel against its plain version on the same inputs: the value and
    the autograd gradients of logits and msgs (padding gradients exactly 0),
    each within K2_RTOL of its sum of |terms|."""
    from analysisgnn_tpu_torch.kernels.softmax_agg import segment_softmax_agg, segment_softmax_agg_plain

    n, (e, h), f = plan.num_nodes, logits.shape, msgs.shape[1]
    d = f // h
    gen = torch.Generator(device="cpu").manual_seed(e + n)
    g = torch.randn(n, f, generator=gen).to(logits.device)
    results = {}
    for kind, fn in (("kernel", segment_softmax_agg), ("plain", segment_softmax_agg_plain)):
        lo, ms = logits.clone().requires_grad_(True), msgs.clone().requires_grad_(True)
        out = fn(lo, ms, plan)
        results[kind] = (out.detach(), *torch.autograd.grad(out, (lo, ms), g))
    # the sums of |terms| of each result, the scale of its rounding; the plain
    # version is linear in msgs, so its gradient for a cotangent of ones is
    # the attention weight w [E, H] repeated over D
    ms = msgs.clone().requires_grad_(True)
    w = torch.autograd.grad(segment_softmax_agg_plain(logits, ms, plan), ms, torch.ones_like(g))[0]
    w = w.view(e, h, d)[..., 0]
    node_g = torch.cat([g.abs(), g.new_zeros((1, f))]).index_select(0, plan.node).view(e, h, d)
    out_abs = segment_softmax_agg_plain(logits, msgs.abs(), plan)
    scales = (
        out_abs,
        w * ((msgs.abs().view(e, h, d) * node_g).sum(-1)
             + torch.cat([(results["plain"][0].abs() * g.abs()).view(n, h, d).sum(-1), g.new_zeros((1, h))])
             .index_select(0, plan.node)),
        (node_g * w[..., None]).view(e, f),
    )
    torch.cuda.synchronize()
    padding = plan.node >= n
    errs = {}
    for part, a, b, sc in zip(("forward", "d logits", "d msgs"), results["kernel"], results["plain"], scales):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise AssertionError(f"K2 {name} {part}: shape {tuple(a.shape)} vs {tuple(b.shape)} or non-finite values")
        err = (a - b).abs()
        if not bool((err <= K2_RTOL * sc + 1e-30).all()):
            worst = float((err / sc.clamp_min(1e-30)).max())
            raise AssertionError(f"K2 {name} {part}: |kernel - plain| reaches {worst:.3e} of the sum of |terms| "
                                 f"(tol {K2_RTOL})")
        errs[part] = float(err.max()) if err.numel() else 0.0
    d_logits, d_msgs = results["kernel"][1:]
    if bool(d_logits[padding].any()) or bool(d_msgs[padding].any()):
        raise AssertionError(f"K2 {name}: padding edges got a nonzero gradient")
    e_valid = int((~padding).sum())
    phase(f"kernel check: K2 {name}: E={e} (valid {e_valid}) H={h} F={f} n={n} blocks={plan.num_blocks} max|d| "
          + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" (tol {K2_RTOL} of the sum of |terms|), padding gradients exactly 0")
    return {"case": name, "max_abs_err": max(errs.values())}


def k2_checks(batch) -> list:
    """K2 at the HGT train step's shape (the union softmax of one layer over
    ``batch``), at tests/test_pallas.py's case, and at edge cases: an empty
    node, a node with edges in every block, a block that is all padding;
    H = 3 (the scalar path); a node of degree 77 over 10 ranges (three
    chunks of the kernel's walk, more ranges and edges than its prefetch
    depth); 40 blocks (the walk past 32 blocks) at H = 5."""
    from analysisgnn_tpu_torch.core.graph import metadata
    from analysisgnn_tpu_torch.kernels.softmax_agg import plan_softmax_agg
    from analysisgnn_tpu_torch.models.encoders import plan_hgt

    dev = torch.device("cuda")
    _, model_edges = metadata(HGT_CFG["add_beats"], HGT_CFG["add_measures"])
    caps = {t: v.shape[0] for t, v in batch.node_features.items()}
    hgt = plan_hgt(batch.edge_index, model_edges, caps, "emax")
    gen = torch.Generator(device="cpu").manual_seed(3)
    h, f = 4, TRAIN_CFG["hidden_channels"]
    e = hgt.k2.node.shape[0]
    rows = [check_k2("HGT train shape", (torch.randn(e, h, generator=gen) * 2).to(dev),
                     torch.randn(e, f, generator=gen).to(dev), hgt.k2)]
    heavy = [1, 9, 3, 17, 0, 12, 5, 20, 2, 8]  # node 7's edges in each of 10 blocks: 77 over 9 ranges
    cases = (("test_pallas.py case", 300, 4, 8, [257, 1100, 64], [0, 0, 0]),
             ("edge cases", 40, 2, 4, [30, 0, 12, 25], [3, 9, 0, 5]),
             ("D=6 scalar path", 50, 3, 6, [70, 20], [4, 1]),
             ("degree-77 node over 9 ranges", 50, 4, 64, [30 + k for k in heavy], [2] * 10),
             ("40 blocks", 30, 5, 4, [6 + r % 7 for r in range(40)], [r % 3 for r in range(40)]))
    for name, n, h, d, per_block, pads in cases:
        nodes, blocks = [], []
        for r, (ne, p) in enumerate(zip(per_block, pads)):
            ids = torch.randint(0, n, (ne,), generator=gen)
            if ne and name == "edge cases":  # node 5 empty, node 0 in every block with edges
                ids = torch.cat([torch.where(ids == 5, 6, ids)[1:], torch.zeros(1, dtype=ids.dtype)])
            if name.startswith("degree-77"):  # 30 edges of other nodes, then node 7's share
                ids = torch.cat([torch.where(ids[:30] == 7, 8, ids[:30]), torch.full((heavy[r],), 7)])
            if name == "40 blocks":  # node 3 empty; node 4 only in blocks 32 and up, in each of them
                ids = torch.where((ids == 3) | ((ids == 4) & (r < 32)), 2, ids)
                ids = torch.cat([ids[1:], torch.full((1,), 4)]) if r >= 32 else ids
            nodes.append(torch.cat([ids.sort().values, torch.full((p,), n)]))
            blocks.append(torch.full((ne + p,), r))
        plan = plan_softmax_agg(torch.cat(nodes).to(dev), torch.cat(blocks).to(dev), n, len(per_block))
        ne = plan.node.shape[0]
        rows.append(check_k2(name, (torch.randn(ne, h, generator=gen) * 2).to(dev),
                             torch.randn(ne, h * d, generator=gen).to(dev), plan))
    return rows


def train_corpus():
    """bench.py's corpus and sampler, built by the port."""
    from analysisgnn_tpu_torch.core.graph import NOTE
    from analysisgnn_tpu_torch.data.features import select_features
    from analysisgnn_tpu_torch.data.graph_build import build_score_graph
    from analysisgnn_tpu_torch.data.note_array import synthetic_score
    from analysisgnn_tpu_torch.data.sampler import SamplerConfig, ScoreSample, SubgraphSampler
    from analysisgnn_tpu_torch.theory.encoders import KeySignatureEncoder, PitchEncoder
    from analysisgnn_tpu_torch.theory.vocab import TASK_DICT

    samples = []
    for s in range(8):
        na = synthetic_score(num_notes=2000, seed=s)
        feats = select_features(na, "voice")
        g = build_score_graph(na, add_beats=True, add_measures=True)
        features = {
            NOTE: feats,
            "beat": np.zeros((max(g.num_beats, 1), feats.shape[1]), np.float32),
            "measure": np.zeros((max(g.num_measures, 1), feats.shape[1]), np.float32),
        }
        rng = np.random.default_rng(s)
        attrs = {
            "pitch_spelling": PitchEncoder().encode(na),
            "key_signature": KeySignatureEncoder().encode(na),
            "onset_div": na["onset_div"].astype(np.int64),
            "valid_label": np.ones(len(na), np.int64),
        }
        for task, n_cls in TASK_DICT.items():
            attrs[task] = rng.integers(0, n_cls, size=len(na)).astype(np.int64)
        samples.append(ScoreSample(features=features, edges=g.edges, note_attrs=attrs))
    cfg = SamplerConfig(subgraph_size=500, batch_size=8, num_neighbors=(5, 5), seed=0, sort_edges_by_src=True)
    return SubgraphSampler(samples, cfg)


def _train_model(arm: str, dropout: float, device: str):
    from analysisgnn_tpu_torch.models.analysis import init_parameters, model_from_config
    from analysisgnn_tpu_torch.train.state import torch_style_reinit

    model = model_from_config({**ARMS[arm], "dropout": dropout}, device=device)
    init_parameters(model, torch.Generator(device="cpu").manual_seed(0))
    torch_style_reinit(model, seed=0, fused=arm not in UNFUSED_INIT_ARMS)
    return model


def _trainer(model, opt, compute_dtype: str = "float32"):
    from analysisgnn_tpu_torch.theory.vocab import TASK_DICT
    from analysisgnn_tpu_torch.train.state import create_train_state
    from analysisgnn_tpu_torch.train.step import StepConfig, make_train_step

    tasks = tuple(TASK_DICT.items())
    state = create_train_state(model, len(tasks), opt, seed=1)
    cfg = StepConfig(task_dict=tasks, active_tasks=tuple(t for t, _ in tasks), compute_dtype=compute_dtype)
    return state, make_train_step(model, opt, cfg)


def train(arm: str, batches: list) -> dict:
    """One warm-up step, then TRAIN_STEPS steps on fresh batches through the
    arm's route with finite losses (the first call of a batch signature
    runs eagerly, the second captures a CUDA graph and a later one replays
    it, train/graphed.py: a replay launches nothing from the host, so the
    route is read over the steps that launched); for FALL_ARMS also
    FALL_STEPS steps on one fixed batch, whose loss must fall.  Returns the
    route's launches, by launcher."""
    from analysisgnn_tpu_torch.train.schedules import warmup_cosine_schedule
    from analysisgnn_tpu_torch.train.state import make_optimizer

    model = _train_model(arm, TRAIN_CFG["dropout"], "cuda")
    compute = "bfloat16" if arm in BF16_ARMS else "float32"
    state, step = _trainer(model, make_optimizer(warmup_cosine_schedule(5e-3, total_steps=1000)), compute)
    state, aux = step(state, batches[0])
    losses, skipped = [], 0.0
    with route(f"train {arm}", TRAIN_ROUTES[arm]) as launched:
        for b in batches[1:1 + TRAIN_STEPS]:
            state, aux = step(state, b)
            losses.append(float(aux["total_loss"]))
            skipped += float(aux["skipped_nonfinite"])
    if not all(np.isfinite(losses)) or skipped:
        raise AssertionError(f"{arm}: non-finite loss {losses}")
    if compute != "float32" and not all(p.dtype == torch.float32 for p in model.parameters()):
        raise AssertionError(f"{arm}: a master parameter left float32")
    phase(f"train {arm}: {TRAIN_STEPS} steps after one warm-up, launched {launched}; losses "
          + ", ".join(f"{v:.4f}" for v in losses))
    if arm in FALL_ARMS:
        fall = []
        for _ in range(FALL_STEPS):
            state, aux = step(state, batches[0])
            fall.append(float(aux["total_loss"]))
        first, last = statistics.mean(fall[:3]), statistics.mean(fall[-3:])
        if not (all(np.isfinite(fall)) and last < first):
            raise AssertionError(f"{arm}: loss on one fixed batch did not fall over {FALL_STEPS} steps: {fall}")
        phase(f"train {arm}: {FALL_STEPS} steps on one batch: loss {fall[0]:.4f} -> {fall[-1]:.4f} "
              f"(mean of the first 3 {first:.4f}, of the last 3 {last:.4f})")
    return launched


def step_parity(arm: str, batch, state_dict=None) -> None:
    """One step of the arm on the GPU (kernels) against the same step on the
    CPU (plain versions, no launch): same weights (the arm's init, or
    ``state_dict``), same batch, dropout 0, constant rate."""
    from analysisgnn_tpu_torch.train.state import ClippedAdamW

    model = _train_model(arm, 0.0, "cpu")
    if state_dict is not None:
        model.load_state_dict({k: v.cpu() for k, v in state_dict.items()})
    gpu_model = _train_model(arm, 0.0, "cuda")
    gpu_model.load_state_dict(model.state_dict())
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    compute = "bfloat16" if arm in BF16_ARMS else "float32"
    out = {}
    for label, m, b in (("gpu", gpu_model, batch), ("cpu", model, batch.to("cpu"))):
        state, step = _trainer(m, ClippedAdamW(lambda _step: PARITY_LR, eps=PARITY_EPS), compute)
        with route(f"one {arm} step on the {label}", TRAIN_ROUTES[arm] if label == "gpu" else set()):
            state, aux = step(state, b)
        out[label] = (float(aux["total_loss"]), {k: v.detach().cpu() for k, v in m.state_dict().items()},
                      state.mt_params.detach().cpu())
    loss_g, params_g, mt_g = out["gpu"]
    loss_c, params_c, mt_c = out["cpu"]
    rel = abs(loss_g - loss_c) / abs(loss_c)
    if compute != "float32":
        # the updates of all parameters, GPU against CPU, in relative L2
        d_g = torch.cat([(params_g[k] - start[k]).flatten() for k in start])
        d_c = torch.cat([(params_c[k] - start[k]).flatten() for k in start])
        upd = float((d_g - d_c).norm() / d_c.norm())
        if not (np.isfinite(loss_g) and rel <= BF16_PARITY_LOSS_RTOL and upd <= BF16_PARITY_UPDATE_RTOL):
            raise AssertionError(f"GPU vs CPU {arm} step: loss {loss_g} vs {loss_c} (rel {rel:.2e}, tol "
                                 f"{BF16_PARITY_LOSS_RTOL}), updates {upd:.3e} relative L2 (tol "
                                 f"{BF16_PARITY_UPDATE_RTOL})")
        phase(f"train: one {arm} step, GPU vs CPU ({compute} compute, same weights and batch, dropout 0, lr "
              f"{PARITY_LR}, eps {PARITY_EPS}): loss {loss_g:.6f} vs {loss_c:.6f} (rel {rel:.2e}, tol "
              f"{BF16_PARITY_LOSS_RTOL}); parameter updates {upd:.3e} relative L2 (tol {BF16_PARITY_UPDATE_RTOL})")
        return
    worst = max(float((params_g[k] - params_c[k]).abs().max()) for k in params_c)
    worst = max(worst, float((mt_g - mt_c).abs().max()))
    if not (np.isfinite(loss_g) and rel <= PARITY_LOSS_RTOL and worst <= PARITY_PARAM_ATOL):
        raise AssertionError(f"GPU vs CPU train step: loss {loss_g} vs {loss_c} (rel {rel:.2e}, "
                             f"tol {PARITY_LOSS_RTOL}), "
                             f"parameters max|d| {worst:.3e} (tol {PARITY_PARAM_ATOL})")
    phase(f"train: one {arm} step, GPU vs CPU (plain versions, same weights and batch, dropout 0, lr {PARITY_LR}, "
          f"eps {PARITY_EPS}): "
          f"loss {loss_g:.6f} vs {loss_c:.6f} (rel {rel:.2e}, tol {PARITY_LOSS_RTOL}); every parameter and mt_params "
          f"max|d| {worst:.3e} (tol {PARITY_PARAM_ATOL} abs)")


# ------------------------------------------------------------- K4 and K5


def check_k4(name: str, msgs, dst, n: int) -> dict:
    """K4's kernel against its plain version on the same inputs, within
    K4_RTOL of each output element's sum of |terms|."""
    from analysisgnn_tpu_torch.kernels.segment_sum import segment_sum_sorted, segment_sum_sorted_plain

    out = segment_sum_sorted(msgs, dst, n)
    ref = segment_sum_sorted_plain(msgs, dst, n)
    scale = segment_sum_sorted_plain(msgs.abs(), dst, n)
    torch.cuda.synchronize()
    e, f = msgs.shape
    if out.shape != (n, f) or not torch.isfinite(out).all():
        raise AssertionError(f"K4 {name}: shape {tuple(out.shape)} or non-finite values")
    err = (out - ref).abs()
    if not bool((err <= K4_RTOL * scale).all()):
        worst = float((err / scale.clamp_min(1e-30)).max())
        raise AssertionError(f"K4 {name}: |kernel - plain| reaches {worst:.3e} of the sum of |terms| (tol {K4_RTOL})")
    e_valid = int(((dst >= 0) & (dst < n)).sum())
    max_abs = float(err.max()) if err.numel() else 0.0
    phase(f"kernel check: K4 {name}: E={e} (in range {e_valid}) F={f} n={n} max|d|={max_abs:.3e} "
          f"(tol {K4_RTOL} of the sum of |terms|)")
    return {"case": name, "max_abs_err": max_abs}


def k4_checks(batch) -> list:
    """K4 over the fused note layer's sorted valid edges of a train batch
    (F = 256), at tests/test_pallas.py's two cases, and at edge cases."""
    from analysisgnn_tpu_torch.core.graph import NOTE, NOTE_EDGE_TYPES
    from analysisgnn_tpu_torch.models.fused import fused_plan

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(4)
    plan = fused_plan([batch.edges(et) for et in NOTE_EDGE_TYPES], batch.capacity(NOTE))
    dst = plan.seg[plan.seg.long() < plan.num_segments]
    rows = [check_k4("fused note layer", torch.randn(dst.shape[0], TRAIN_CFG["hidden_channels"], generator=gen).to(dev),
                     dst, plan.num_segments)]
    cases = [
        ("test_pallas.py case", torch.randint(0, 300, (2000,), generator=gen).sort().values, 300, 64),
        ("empty nodes", torch.tensor([0] * 5 + [100] * 5), 128, 32),
        ("F=25", torch.randint(0, 500, (3000,), generator=gen).sort().values, 500, 25),
        ("ids past num_nodes and negative", torch.tensor([-3, -1, 0, 0, 5, 299, 300, 300, 400]), 300, 16),
        ("no edges", torch.zeros(0, dtype=torch.long), 40, 16),
    ]
    for name, ids, n, f in cases:
        msgs = torch.ones(len(ids), f) if name == "empty nodes" else torch.randn(len(ids), f, generator=gen)
        rows.append(check_k4(name, msgs.to(dev), ids.to(torch.int32).to(dev), n))
    return rows


def check_k5(name: str, logits, dst, n: int, alone: bool = False) -> dict:
    """K5's kernel against its plain version within K5_ATOL, and the weights
    of every run of equal ids summing to 1 in every head whose logits are
    not all -inf (those weigh 0); with ``alone``, a call must launch K5's
    kernel once and no other kernel (:func:`check_alone`)."""
    from analysisgnn_tpu_torch.kernels.segment_softmax import (
        run_ids, segment_softmax_sorted, segment_softmax_sorted_plain,
    )
    from analysisgnn_tpu_torch.kernels.segment_ops import segment_max

    out = segment_softmax_sorted(logits, dst, n)
    ref = segment_softmax_sorted_plain(logits, dst, n)
    torch.cuda.synchronize()
    e, h = logits.shape
    if out.shape != (e, h) or not torch.isfinite(out).all():
        raise AssertionError(f"K5 {name}: shape {tuple(out.shape)} or non-finite values")
    err = float((out - ref).abs().max()) if e else 0.0
    if err > K5_ATOL:
        raise AssertionError(f"K5 {name}: max |kernel - plain| = {err:.3e} > {K5_ATOL}")
    sum_err = 0.0
    if e:
        runs = run_ids(dst)
        count = int(runs[-1]) + 1
        sums = torch.zeros_like(out).index_add_(0, runs, out)[:count]
        weighed = segment_max(logits, runs, count) > -math.inf
        sum_err = float((sums - 1)[weighed].abs().max())
        if bool(sums[~weighed].any()):
            raise AssertionError(f"K5 {name}: a head whose logits are all -inf got a nonzero weight")
    if sum_err > K5_SUM_ATOL:
        raise AssertionError(f"K5 {name}: the weights of a destination sum to 1 within {sum_err:.3e} > {K5_SUM_ATOL}")
    if alone:
        check_alone(lambda: segment_softmax_sorted(logits, dst, n), "segment_softmax_kernel")
    phase(f"kernel check: K5 {name}: E={e} H={h} n={n} max|d|={err:.3e} (tol {K5_ATOL} abs), weights of each "
          f"destination sum to 1 within {sum_err:.1e} (tol {K5_SUM_ATOL})"
          + ("; one launch a call and no other kernel" if alone else ""))
    return {"case": name, "max_abs_err": err}


def k5_union(edge_index, capacities) -> tuple:
    """The sorted valid union edges of the HGT model's ``emax`` plan of a
    graph: K5's destination ids, and the node count."""
    from analysisgnn_tpu_torch.core.graph import metadata
    from analysisgnn_tpu_torch.models.encoders import plan_hgt

    _, model_edges = metadata(HGT_CFG["add_beats"], HGT_CFG["add_measures"])
    k2 = plan_hgt(edge_index, model_edges, capacities, "emax").k2
    return k2.node[k2.node < k2.num_nodes].sort().values, k2.num_nodes


def k5_union_shapes(batch) -> list:
    """``(name, sorted int64 ids on the card, node count)``: the HGT layer's
    valid union edges of a train batch (H = 4) and those of the serve
    phase's 20,000-note score."""
    from analysisgnn_tpu_torch.data.note_array import synthetic_score
    from analysisgnn_tpu_torch.inference.predict import graph_from_note_array

    dst, n = k5_union(batch.edge_index, {t: v.shape[0] for t, v in batch.node_features.items()})
    shapes = [("HGT union edges", dst, n)]
    notes = max(REQUEST_NOTES)
    graph = graph_from_note_array(synthetic_score(notes, seed=notes), add_beats=HGT_CFG["add_beats"],
                                  add_measures=HGT_CFG["add_measures"], bucket_factor=BUCKET_FACTOR, device="cuda")
    dst, n = k5_union(graph.edge_index, {t: v.shape[0] for t, v in graph.node_features.items()})
    return shapes + [(f"HGT union edges of a {notes}-note score", dst, n)]


def k5_checks(batch) -> list:
    """K5 at the HGT layer's union edges (``k5_union_shapes``), at tests/
    test_pallas.py's two cases, and at edge cases: the kernel's slices of 32
    edges and its registers (the tails of up to 32 edges past a slice) at
    their ends, heads that are not a power of two or span two grid rows,
    -inf logits."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(5)
    rows = []
    for name, dst, n in k5_union_shapes(batch):
        logits = (torch.randn(dst.shape[0], 4, generator=gen) * 2).to(dev)
        rows.append(check_k5(name, logits, dst.to(torch.int32), n, alone=True))
    stability = torch.tensor([[1e4], [1e4 + 1], [-1e4], [0.0]])
    cases = [
        ("test_pallas.py case", torch.randint(0, 300, (2000,), generator=gen).sort().values, 300, 4, 3.0),
        ("stability at 1e4", torch.tensor([0, 0, 1, 1]), 128, 1, None),
        ("H=1", torch.randint(0, 300, (2000,), generator=gen).sort().values, 300, 1, 3.0),
        ("H=6 head-per-lane path", torch.randint(0, 100, (700,), generator=gen).sort().values, 100, 6, 3.0),
        ("ids past num_nodes", torch.tensor([0, 0, 5, 299, 300, 300, 400]), 300, 1, 2.0),
        ("ids below 0 and past the tiles", torch.tensor([-2, -2, -1, 3, 3, 300, 300, 300, 1000]), 10, 2, 2.0),
        ("no edges", torch.zeros(0, dtype=torch.long), 50, 4, 1.0),
        # runs that start on a slice's last edge (31, 95): one with a tail of exactly
        # 32 edges in the next slice, one that outgrows its tail (40 edges), then
        # 100 edges (online)
        ("slice ends", torch.tensor([0] * 31 + [1] * 33 + [2] * 31 + [3] * 40 + [4] * 100 + [5] + [6] * 3), 7, 4,
         3.0),
        ("one run of every edge", torch.full((5000,), 7), 8, 4, 3.0),
        ("H=1 long runs", torch.randint(0, 3, (1000,), generator=gen).sort().values, 3, 1, 3.0),
        ("H=6 long runs", torch.randint(0, 5, (400,), generator=gen).sort().values, 5, 6, 3.0),
        ("H=40 over 32 lanes", torch.randint(0, 60, (600,), generator=gen).sort().values, 60, 40, 3.0),
        ("int64 ids", torch.randint(0, 300, (2000,), generator=gen).sort().values, 300, 8, 3.0),
    ]
    for name, ids, n, h, scale in cases:
        logits = stability if scale is None else torch.randn(len(ids), h, generator=gen) * scale
        ids = ids if name == "int64 ids" else ids.to(torch.int32)
        rows.append(check_k5(name, logits.to(dev), ids.to(dev), n))
    # -inf logits: whole runs (in registers and online) and parts of runs
    ids = torch.tensor([0] * 3 + [1] * 200 + [2] * 5 + [3] * 150)
    logits = torch.randn(len(ids), 4, generator=gen) * 3
    logits[:3] = -math.inf
    logits[3:203, :2] = -math.inf
    logits[203:205] = -math.inf
    logits[208::3] = -math.inf
    rows.append(check_k5("-inf logits", logits.to(dev), ids.to(torch.int32).to(dev), 4))
    return rows


# the generic segment ops of kernels/segment_ops.py (plain PyTorch, XLA code in the JAX package) on the card against
# the same calls on CPU copies, at the bench batch's fused-note-layer shape of PERF.md section 6
SEG_OPS_SHAPE = {"E": 82_176, "F": 256, "S": 37_632, "H": 4, "D": 64}
# sums and means: f32 sums of the same terms in another order (the card's atomics add in no fixed order), so
# elementwise within SEG_OPS_RTOL of the same op on |data| (the sum of |terms|, which bounds f32 rounding); a wrong
# index is O(1) of it
SEG_OPS_RTOL = 1e-5
# softmax weights, elementwise relative: expf within 2 ulp and a positive denominator summed in another order (a
# few ulp); relative, since an edge of a negative id reads another segment's max and sum, as in the JAX package,
# and its weight may exceed 1
SEG_OPS_SOFTMAX_RTOL = 1e-5


def segment_ops_checks() -> dict:
    """segment_mean, segment_mean_or, segment_softmax, gather_scatter_sum /
    _mean, sddmm_dot (4 heads) and coalesce on CUDA tensors against the same
    calls on CPU copies, with padding ids (== S and past it) and negative
    ids; coalesce exactly."""
    from analysisgnn_tpu_torch.kernels import segment_ops as ops

    shp = SEG_OPS_SHAPE
    e, f, s, h, d = shp["E"], shp["F"], shp["S"], shp["H"], shp["D"]
    gen = torch.Generator(device="cpu").manual_seed(21)
    ids = torch.randint(0, s, (e,), generator=gen)
    pick = torch.rand(e, generator=gen)
    ids[pick < 0.12] = s  # padding
    ids[(pick >= 0.12) & (pick < 0.14)] = s + 7
    ids[(pick >= 0.14) & (pick < 0.17)] = -1  # negative ids: dropped from sums, gathered as numpy counts them
    src = torch.randint(0, s, (e,), generator=gen)
    src[pick < 0.12] = s
    edges = torch.stack([src, ids])
    data = torch.randn(e, f, generator=gen)
    x = torch.randn(s, f, generator=gen)
    default = torch.randn(s, f, generator=gen)
    weight = torch.rand(e, generator=gen)
    logits = torch.randn(e, h, generator=gen) * 3
    q, k = torch.randn(s, h, d, generator=gen), torch.randn(s, h, d, generator=gen)
    cases = {
        "segment_mean": (lambda t: ops.segment_mean(t["data"], t["ids"], s),
                         lambda t: ops.segment_mean(t["data"].abs(), t["ids"], s)),
        "segment_mean_or": (lambda t: ops.segment_mean_or(t["data"], t["ids"], t["default"]),
                            lambda t: ops.segment_mean_or(t["data"].abs(), t["ids"], t["default"].abs())),
        "gather_scatter_sum": (lambda t: ops.gather_scatter_sum(t["x"], t["edges"], s, t["weight"]),
                               lambda t: ops.gather_scatter_sum(t["x"].abs(), t["edges"], s, t["weight"])),
        "gather_scatter_mean": (lambda t: ops.gather_scatter_mean(t["x"], t["edges"], s),
                                lambda t: ops.gather_scatter_mean(t["x"].abs(), t["edges"], s)),
        "sddmm_dot": (lambda t: ops.sddmm_dot(t["q"], t["k"], t["edges"]),
                      lambda t: ops.sddmm_dot(t["q"].abs(), t["k"].abs(), t["edges"])),
    }
    cpu = {"data": data, "ids": ids, "default": default, "x": x, "edges": edges, "weight": weight, "logits": logits,
           "q": q, "k": k}
    gpu = {key: v.cuda() for key, v in cpu.items()}
    out = {}
    for name, (fn, scale_fn) in cases.items():
        got, want, scale = fn(gpu).cpu(), fn(cpu), scale_fn(cpu)
        err = float((got - want).abs().max())
        ratio = float(((got - want).abs() / (scale + 1e-30)).max())
        if got.shape != want.shape or not bool(torch.isfinite(got).all()) or ratio > SEG_OPS_RTOL:
            raise AssertionError(f"segment ops {name}: max|d| {err:.3e}, {ratio:.3e} of the sum of |terms| "
                                 f"(tol {SEG_OPS_RTOL})")
        out[name] = {"max_abs_err": err, "rel_of_abs_terms": ratio}
    got, want = ops.segment_softmax(gpu["logits"], gpu["ids"], s).cpu(), ops.segment_softmax(logits, ids, s)
    err = float((got - want).abs().max())
    ratio = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
    if got.shape != want.shape or not bool(torch.isfinite(got).all()) or ratio > SEG_OPS_SOFTMAX_RTOL:
        raise AssertionError(f"segment ops segment_softmax: max|d| {err:.3e}, relative {ratio:.3e} "
                             f"(tol {SEG_OPS_SOFTMAX_RTOL})")
    out["segment_softmax"] = {"max_abs_err": err, "max_rel_err": ratio}
    dup = torch.cat([edges, edges[:, : e // 10]], dim=1)  # duplicates for sure
    (got, count), (want, want_count) = ops.coalesce(dup.cuda(), s), ops.coalesce(dup, s)
    if not torch.equal(got.cpu(), want) or int(count) != int(want_count):
        raise AssertionError(f"segment ops coalesce: {int(count)} unique edges on the card, {int(want_count)} on "
                             f"the CPU, or another order")
    out["coalesce"] = {"max_abs_err": 0.0, "unique": int(count)}
    phase(f"segment ops: E={e} F={f} S={s} (H={h} D={d} for sddmm_dot and softmax), padding and negative ids, on "
          f"the card against the CPU: " + ", ".join(
              f"{name} max|d| {r['max_abs_err']:.3e}" + (f" ({r['rel_of_abs_terms']:.2e} of the sum of |terms|)"
                                                        if "rel_of_abs_terms" in r else "")
              for name, r in out.items())
          + f" (tol {SEG_OPS_RTOL} of the sum of |terms|, softmax {out['segment_softmax']['max_rel_err']:.2e} "
          f"relative, tol {SEG_OPS_SOFTMAX_RTOL}; coalesce exact, "
          f"{out['coalesce']['unique']} unique edges)")
    return out


# ------------------------------------------------------------- the Trainer


def trainer_phase(ckpt_dir: str) -> None:
    """The training entry point at full width on the card through its route,
    then its last.pt served once."""
    from analysisgnn_tpu_torch.cli.predict import load_model
    from analysisgnn_tpu_torch.cli.train import main as train_main
    from analysisgnn_tpu_torch.data.note_array import synthetic_score
    from analysisgnn_tpu_torch.inference.predict import predict_score_ids

    import analysisgnn_tpu_torch.train.step as step_mod

    edge_terms = []  # every edge-consistency term the run computes (train steps and validation batches)
    edge_loss = step_mod._edge_loss

    def counted(*args):
        term = edge_loss(*args)
        edge_terms.append(float("nan") if term is None else float(term.detach()))
        return term

    printed = io.StringIO()
    step_mod._edge_loss = counted
    try:
        # --do_eval prints the test metrics as JSON
        with route("trainer", EDGE_TRAIN) as launched, contextlib.redirect_stdout(printed):
            trainer = train_main([*TRAINER_FLAGS, "--checkpoint_dir", ckpt_dir])
        torch.cuda.synchronize()
    finally:
        step_mod._edge_loss = edge_loss
    n_steps = len(trainer.step_seconds)
    if not trainer.model.use_edge_decoder or len(edge_terms) < n_steps or not all(np.isfinite(edge_terms)):
        raise AssertionError(f"trainer: {len(edge_terms)} edge-consistency terms in {n_steps} train steps: "
                             f"{edge_terms[:8]}")
    phase(f"trainer: --use_edge_loss: the edge decoder's term ran {len(edge_terms)} times ({n_steps} train steps "
          f"and the validation batches), lambda_edge x its mean CE {edge_terms[0]:.4f} at the first step, "
          f"{edge_terms[n_steps - 1]:.4f} at the last")
    text = printed.getvalue()
    test_metrics = json.loads(text[text.index("{"):])
    if not test_metrics or not all(np.isfinite(v) for v in test_metrics.values()):
        raise AssertionError("trainer: --do_eval printed no or non-finite test metrics")
    hist = trainer.history
    with open(f"{ckpt_dir}/log.jsonl") as f:
        logged = [json.loads(line) for line in f]
    keys = sorted(logged[0])
    losses = [r["train_loss"] for r in hist] + [r["val/total_loss"] for r in hist]
    if logged != hist or not all(np.isfinite(losses)) or any(set(r) != set(keys) for r in logged):
        raise AssertionError(f"trainer: log.jsonl differs from the history or holds a non-finite loss: {losses}")
    phase(f"trainer: cli.train.main {' '.join(TRAINER_FLAGS)}: {len(hist)} epochs of {n_steps // len(hist)} train "
          f"steps, launched {launched}; train_loss " + ", ".join(f"{r['train_loss']:.4f}" for r in hist)
          + "; val/total_loss " + ", ".join(f"{r['val/total_loss']:.4f}" for r in hist))
    phase(f"trainer: log.jsonl keys ({len(keys)}): {', '.join(keys[:6])}, ... {', '.join(keys[-3:])}")
    phase(f"trainer: --do_eval test metrics ({len(test_metrics)} keys): "
          + ", ".join(f"{k} {test_metrics[k]:.4f}" for k in ("all/cadence_acc", "all/localkey_f1", "all/rna_onset_acc",
                                                           "all/rna_nct_acc") if k in test_metrics))

    model, cfg = load_model(ckpt_dir, "last", "cuda")
    with route("trainer: serving last.pt", EDGE_SERVE) as served:
        ids = predict_score_ids(model, synthetic_score(2000, seed=7), add_beats=cfg["add_beats"],
                                add_measures=cfg["add_measures"], device="cuda")
    if any(v.shape != (2000,) or (v < 0).any() for v in ids.values()):
        raise AssertionError("serving last.pt: bad ids")
    phase(f"trainer: last.pt through cli/predict.py's load_model served a 2000-note request, {len(ids)} id columns, "
          f"launched {served}")


def hgt_trainer_phase(ckpt_dir: str) -> None:
    """One epoch of the training entry point with the HybridHGT and K2."""
    from analysisgnn_tpu_torch.cli.train import main as train_main

    with route("trainer HGT", HGT) as launched:
        trainer = train_main([*HGT_TRAINER_FLAGS, "--checkpoint_dir", ckpt_dir])
    torch.cuda.synchronize()
    rec = trainer.history[-1]
    if not (np.isfinite(rec["train_loss"]) and np.isfinite(rec["val/total_loss"])):
        raise AssertionError(f"trainer HGT: non-finite loss {rec['train_loss']}, {rec['val/total_loss']}")
    if any(layer.stage != torch.bfloat16 for layer in trainer.model.encoder.layers):
        raise AssertionError("trainer HGT: the layers do not stage in bf16")
    phase(f"trainer HGT: cli.train.main {' '.join(HGT_TRAINER_FLAGS)} (q, k, v and the typed transforms staged in "
          f"bf16): {len(trainer.history)} epoch of {len(trainer.step_seconds)} train steps, launched {launched}; "
          f"train_loss {rec['train_loss']:.4f}, val/total_loss {rec['val/total_loss']:.4f}")


def hgt_staged_serve(ckpt_dir: str, tmp: str) -> None:
    """The bf16-staged HGT checkpoint of the HGT Trainer run served by
    cli/predict.py on a generated MusicXML score: the staging read back from
    model_config.json, the CSV written, its route (K1 alone)."""
    from analysisgnn_tpu_torch.cli.predict import load_model
    from analysisgnn_tpu_torch.cli.predict import main as predict_main

    model, cfg = load_model(ckpt_dir, "last", "cuda")
    if cfg.get("hgt_stage_dtype") != "bfloat16" or any(layer.stage != torch.bfloat16 for layer in model.encoder.layers):
        raise AssertionError(f"the HGT checkpoint's staging was not served: {cfg.get('hgt_stage_dtype')}")
    score = f"{tmp}/hgt_score.musicxml"
    with open(score, "w") as fh:
        fh.write(synthetic_score_xml(RNA_NOTES, seed=5))
    out = f"{tmp}/hgt.csv"
    # model_config.json records no use_pallas: the served HybridHGT runs its softmax without K2, K1 alone
    with route("serving the staged HGT checkpoint", NODE) as launched:
        predict_main(["--checkpoint_dir", ckpt_dir, "--checkpoint", "last", "--score", score, "--output_csv", out])
    with open(out) as fh:
        rows = list(csv.reader(fh))
    if len(rows) < RNA_NOTES // 2:
        raise AssertionError(f"the staged HGT CSV has {len(rows)} rows")
    phase(f"trainer HGT serve: cli.predict.main on the bf16-staged last.pt ({cfg['hgt_group_mode']} stacks) and a "
          f"MusicXML score: {len(rows) - 1} rows, launched {launched}")


def smote_trainer_phase(ckpt_dir: str) -> None:
    """Single-task cadence training with SMOTE through the training entry
    point at full width: every train step oversamples (counted around
    smote_oversample), finite losses, its route."""
    import analysisgnn_tpu_torch.train.step as step_mod
    from analysisgnn_tpu_torch.cli.train import main as train_main

    calls = []
    oversample = step_mod.smote_oversample

    def counted(*args, **kwargs):
        out = oversample(*args, **kwargs)
        calls.append(int(out[2].sum()))  # the valid synthetic rows
        return out

    step_mod.smote_oversample = counted
    try:
        with route("trainer SMOTE", EDGE_TRAIN) as launched:
            trainer = train_main([*SMOTE_TRAINER_FLAGS, "--checkpoint_dir", ckpt_dir])
        torch.cuda.synchronize()
    finally:
        step_mod.smote_oversample = oversample
    steps = len(trainer.step_seconds)
    losses = [r["train_loss"] for r in trainer.history] + [r["val/total_loss"] for r in trainer.history]
    if len(calls) != steps or not all(calls) or not all(np.isfinite(losses)):
        raise AssertionError(f"trainer SMOTE: {len(calls)} oversamplings ({calls} valid rows) in {steps} steps, "
                             f"losses {losses}")
    phase(f"trainer SMOTE: cli.train.main {' '.join(SMOTE_TRAINER_FLAGS)}: {len(trainer.history)} epochs of "
          f"{steps // len(trainer.history)} train steps, launched {launched}; every step oversampled "
          f"({', '.join(map(str, calls))} valid synthetic rows of 256); train_loss "
          + ", ".join(f"{r['train_loss']:.4f}" for r in trainer.history))


def variant_trainer_phase(ckpt_dir: str, fall_batch) -> None:
    """The training entry point with --deep_proj --logit_fusion --remat
    --final_dropout --no_fused_torch_init at full width through its route
    (remat recomputes forwards, on the same kernels), finite losses that fall
    over FALL_STEPS steps on one bench batch, last.pt served through
    cli/predict.py's load_model, and one dropout-0 step of the trained
    weights on the GPU against the CPU."""
    from analysisgnn_tpu_torch.cli.predict import load_model
    from analysisgnn_tpu_torch.cli.train import main as train_main
    from analysisgnn_tpu_torch.data.note_array import synthetic_score
    from analysisgnn_tpu_torch.inference.predict import predict_score_ids
    from analysisgnn_tpu_torch.train.schedules import warmup_cosine_schedule
    from analysisgnn_tpu_torch.train.state import make_optimizer

    with route("trainer variants", EDGE_TRAIN) as launched:
        trainer = train_main([*VARIANT_TRAINER_FLAGS, "--checkpoint_dir", ckpt_dir])
    torch.cuda.synchronize()
    model = trainer.model
    if not (model.encoder.remat and model.encoder.final_dropout and model.heads.logit_fusion
            and not trainer.model_config["plain_proj"] and not trainer.cfg.fused_torch_init):
        raise AssertionError("trainer variants: the Trainer's model lacks one of the five knobs")
    hist = trainer.history
    losses = [r["train_loss"] for r in hist] + [r["val/total_loss"] for r in hist]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"trainer variants: non-finite losses {losses}")
    # the trained model's loss falls on one fixed bench batch (dropout 0.3 on)
    state, step = _trainer(model, make_optimizer(warmup_cosine_schedule(5e-3, total_steps=1000)))
    fall = []
    for _ in range(FALL_STEPS):
        state, aux = step(state, fall_batch)
        fall.append(float(aux["total_loss"]))
    if not (all(np.isfinite(fall)) and statistics.mean(fall[-3:]) < statistics.mean(fall[:3])):
        raise AssertionError(f"trainer variants: loss on one fixed batch did not fall over {FALL_STEPS} steps: {fall}")
    phase(f"trainer variants: cli.train.main {' '.join(VARIANT_TRAINER_FLAGS)}: {len(hist)} epoch of "
          f"{len(trainer.step_seconds)} train steps, launched {launched}; train_loss {hist[-1]['train_loss']:.4f}, "
          f"val/total_loss {hist[-1]['val/total_loss']:.4f}; {FALL_STEPS} more steps on one bench batch: loss "
          f"{fall[0]:.4f} -> {fall[-1]:.4f}")
    served_model, cfg = load_model(ckpt_dir, "last", "cuda")
    with route("serving the variants' last.pt", EDGE_SERVE) as served:
        ids = predict_score_ids(served_model, synthetic_score(2000, seed=7), add_beats=cfg["add_beats"],
                                add_measures=cfg["add_measures"], device="cuda")
    if any(v.shape != (2000,) or (v < 0).any() for v in ids.values()):
        raise AssertionError("serving the variants' last.pt gave bad ids")
    phase(f"trainer variants: last.pt (deep projections, logit fusion) through cli/predict.py's load_model served "
          f"a 2000-note request, launched {served}")
    step_parity("variants", next(iter(trainer.dm.val_batches("all"))), model.state_dict())


def trainer_parity(ckpt_dir: str, gpu_route, flags: list = TRAINER_PARITY_FLAGS, label: str = "trainer",
                   eps: "float | None" = None) -> dict:
    """A fit of 2 steps an epoch on the GPU (kernels, through ``gpu_route``)
    against the same on the CPU (plain versions, no launch): dropout 0, the
    same initial state dict, and with ``eps`` the optimizer's eps raised to
    it (see PARITY_EPS); every epoch's train and validation loss within
    TRAINER_PARITY_RTOL."""
    from analysisgnn_tpu_torch.cli.train import build_datamodule, resolve_config, train_config
    from analysisgnn_tpu_torch.models.analysis import init_parameters, model_from_config
    from analysisgnn_tpu_torch.train.loop import Trainer
    from analysisgnn_tpu_torch.train.state import torch_style_reinit

    init = None
    out = {}
    for side, dev in (("gpu", "cuda"), ("cpu", "cpu")):
        config = resolve_config([*flags, "--device", dev, "--checkpoint_dir", f"{ckpt_dir}/{side}"])
        trainer = Trainer(train_config(config), build_datamodule(config))
        if eps is not None:
            trainer._init_state = _with_eps(trainer, eps)
        if init is None:
            model = model_from_config(trainer.model_config, device="cpu")
            init_parameters(model, torch.Generator(device="cpu").manual_seed(0))
            torch_style_reinit(model, seed=0)
            init = model.state_dict()
        with route(f"{label}: the fit on the {side}", gpu_route if side == "gpu" else set()):
            state = trainer.fit(max_steps_per_epoch=2, initial_state_dict=init)
        out[side] = {"trainer": trainer, "state": state}
    gpu, cpu = out["gpu"]["trainer"].history, out["cpu"]["trainer"].history
    if len(gpu) != len(cpu):
        raise AssertionError(f"{label} GPU vs CPU: {len(gpu)} epochs against {len(cpu)}")
    rels = []
    for epoch, (g, c) in enumerate(zip(gpu, cpu)):
        rels.append({})
        for key in ("train_loss", "val/total_loss"):
            rels[-1][key] = abs(g[key] - c[key]) / abs(c[key])
            if not (np.isfinite(g[key]) and rels[-1][key] <= TRAINER_PARITY_RTOL):
                raise AssertionError(f"{label} GPU vs CPU, epoch {epoch}: {key} {g[key]} vs {c[key]} "
                                     f"(rel {rels[-1][key]:.2e}, tol {TRAINER_PARITY_RTOL})")
    phase(f"{label}: {len(gpu)} fit epoch(s) of 2 steps, GPU vs CPU (plain versions, dropout 0, the same initial "
          f"state dict, {f'Adam eps {eps}, ' if eps is not None else ''}{' '.join(flags)}): "
          + "; ".join(f"{g['task']} epoch {g['epoch']}: train_loss {g['train_loss']:.6f} vs {c['train_loss']:.6f} "
                      f"(rel {r['train_loss']:.2e}), val/total_loss {g['val/total_loss']:.6f} vs "
                      f"{c['val/total_loss']:.6f} (rel {r['val/total_loss']:.2e})" for g, c, r in zip(gpu, cpu, rels))
          + f" (tol {TRAINER_PARITY_RTOL})")
    return out


def _with_eps(trainer, eps: float):
    """The Trainer's ``_init_state``, then its optimizer's eps set to ``eps``."""
    init_state = trainer._init_state

    def init(*args, **kwargs):
        state = init_state(*args, **kwargs)
        trainer.optimizer.eps = eps
        return state

    return init


def _same_samples(a: list, b: list) -> None:
    if [(s.name, s.test) for s in a] != [(s.name, s.test) for s in b]:
        raise AssertionError("raw-dir trainer: the cached corpus lists other samples than the built one")
    for x, y in zip(a, b):
        for part in ("features", "edges", "note_attrs"):
            px, py = getattr(x, part), getattr(y, part)
            if list(px) != list(py) or not all(np.array_equal(px[k], py[k]) and px[k].dtype == py[k].dtype
                                               for k in px):
                raise AssertionError(f"raw-dir trainer: {x.name} {part} differ between the build and the cache")


def raw_dir_trainer_phase(tmp: str) -> dict:
    """The training entry point on file corpora: parity_experiment.py's recipe
    at full width on a copy of data_synth/, then a second corpus build from
    its .npz cache."""
    import analysisgnn_tpu_torch.cli.train as cli

    raw = f"{tmp}/data_synth"  # the CLI caches under <raw_dir>/.cache, so never in the checkout
    write_synth_corpus(raw)
    data = ["--raw_dir", raw, "--test_split_file", f"{raw}/test_split.json"]
    # W&B logging as on a host without the wandb package: the Trainer imports it at each record and goes on
    # without it.  Where the package is installed its import is blocked for the run (sys.modules entry None), since
    # a real wandb.init could try to reach the network
    try:
        wandb_installed = importlib.metadata.version("wandb")
    except importlib.metadata.PackageNotFoundError:
        wandb_installed = None
    argv = [*data, *RAW_DIR_FLAGS, "--num_epochs", str(RAW_DIR_EPOCHS), "--do_train", "--do_eval",
            "--checkpoint_dir", f"{tmp}/ckpt", "--use_wandb"]
    printed = io.StringIO()
    blocked = sys.modules.get("wandb", False)
    sys.modules["wandb"] = None  # any import of wandb raises ImportError
    try:
        # --do_eval prints the test metrics as JSON
        with route("raw-dir trainer", NODE) as launched, contextlib.redirect_stdout(printed):
            trainer = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        if blocked is False:
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = blocked
    samples = trainer.dm.task_samples["all"]
    per_interval = collections.Counter(s.transposition for s in samples)
    if len(samples) != 227 or per_interval != RAW_DIR_COUNTS:
        raise AssertionError(f"raw-dir trainer: {len(samples)} samples {dict(per_interval)}, want 227 "
                             f"{RAW_DIR_COUNTS}")
    phase(f"raw-dir trainer: --use_wandb with wandb's import blocked trained to the end (wandb installed on this "
          f"host: {wandb_installed}); corpus of {len(samples)} samples from {len(os.listdir(f'{raw}/all'))} DLC "
          f"TSVs (" + ", ".join(f"{k} {v}" for k, v in per_interval.items())
          + f"); test pieces {sorted(s.name for s in samples if s.test)}")
    text = printed.getvalue()
    test_metrics = json.loads(text[text.index("{"):])
    if not test_metrics or not all(np.isfinite(v) for v in test_metrics.values()):
        raise AssertionError("raw-dir trainer: --do_eval printed no or non-finite test metrics")
    hist = trainer.history
    losses = [r["train_loss"] for r in hist] + [r["val/total_loss"] for r in hist]
    if len(hist) != RAW_DIR_EPOCHS or not all(np.isfinite(losses)):
        raise AssertionError(f"raw-dir trainer: {len(hist)} epochs, losses {losses}")
    phase(f"raw-dir trainer: cli.train.main {' '.join(RAW_DIR_FLAGS)} --num_epochs {RAW_DIR_EPOCHS}: {len(hist)} "
          f"epochs of {len(trainer.step_seconds) // len(hist)} train steps, launched {launched}; train_loss "
          + ", ".join(f"{r['train_loss']:.4f}" for r in hist)
          + "; val/total_loss " + ", ".join(f"{r['val/total_loss']:.4f}" for r in hist))
    phase(f"raw-dir trainer: --do_eval test metrics ({len(test_metrics)} keys): "
          + ", ".join(f"{k} {test_metrics[k]:.4f}" for k in ("all/localkey_acc", "all/degree1_acc", "all/cadence_acc",
                                                           "all/rna_onset_acc") if k in test_metrics))
    cached = cli.build_datamodule(cli.resolve_config(argv))
    markers = [f for f in os.listdir(f"{raw}/.cache") if f.endswith(".done")]
    if len(markers) != 24:
        raise AssertionError(f"raw-dir trainer: {len(markers)} .done markers in the cache, want 24")
    _same_samples(samples, cached.task_samples["all"])
    phase(f"raw-dir trainer: a second build_datamodule read the cache ({len(markers)} .done markers), its "
          f"{len(cached.task_samples['all'])} samples array for array the built ones")
    return {"flags": [*data, *RAW_DIR_FLAGS], "raw": raw}


def write_synth_corpus(raw: str) -> None:
    """data_synth/ written by the port's generator as scripts/parity_experiment.py
    writes it (24 pieces of 10 phrases, seed 7, test fraction 0.2), held byte
    for byte against the committed files."""
    from analysisgnn_tpu_torch.data import synth_dlc

    split = synth_dlc.write_corpus(f"{raw}/all", 24, 10, seed=7, test_fraction=0.2)
    with open(f"{raw}/test_split.json", "w") as f:
        json.dump(split["test"], f)
    committed = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data_synth")
    names = sorted(os.listdir(f"{committed}/all"))
    if sorted(os.listdir(f"{raw}/all")) != names or len(names) != 24:
        raise AssertionError(f"synth corpus: wrote {sorted(os.listdir(f'{raw}/all'))}, committed {names}")
    for rel in [f"all/{n}" for n in names] + ["test_split.json"]:
        with open(f"{raw}/{rel}", "rb") as a, open(f"{committed}/{rel}", "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"synth corpus: {rel} differs from the committed data_synth/{rel}")
    phase(f"raw-dir trainer: data_synth/ written by the port's synth_dlc.write_corpus, all {len(names)} TSVs and "
          f"test_split.json byte-equal to the committed files")


# ------------------------------------------------- continual-learning training


def cl_trainer_phase(raw: str, ckpt_dir: str) -> None:
    """The training entry point on configs/example_config.json as the file
    stands (continual learning over all, cadence and rna), on the raw-dir
    phase's copy of data_synth/ (all/ read from its .npz cache) with cadence/
    and rna/ made of the first CL_TSVS pieces of all/."""
    import analysisgnn_tpu_torch.cli.train as cli

    pieces = sorted(f for f in os.listdir(f"{raw}/all") if f.endswith(".tsv"))[:CL_TSVS]
    for sub in ("cadence", "rna"):
        os.makedirs(f"{raw}/{sub}")
        for name in pieces:
            shutil.copy(f"{raw}/all/{name}", f"{raw}/{sub}/{name}")
    argv = ["--config_path", CL_CONFIG, "--raw_dir", raw, "--test_split_file", f"{raw}/test_split.json",
            *CL_TRAINER_FLAGS, "--checkpoint_dir", ckpt_dir]
    printed = io.StringIO()
    # --do_eval prints the test metrics as JSON
    with route("CL trainer", NODE) as launched, contextlib.redirect_stdout(printed):
        trainer = cli.main(argv)
    torch.cuda.synchronize()
    cfg, hist = trainer.cfg, trainer.history
    tasks = [r["task"] for r in hist]
    if not cfg.cl_training or tasks != list(CL_TASKS) or cfg.conv_impl != "node":
        raise AssertionError(f"CL trainer: epochs of {tasks} with cl_training={cfg.cl_training}, want {CL_TASKS}")
    phase("CL trainer: corpora " + ", ".join(f"{mt} {len(trainer.dm.task_samples[mt])} samples" for mt in CL_TASKS)
          + f" (all/ from the raw-dir phase's .npz cache; cadence/ and rna/ of {len(pieces)} TSVs each, rna/ with the "
          f"AugmentedNet labels); {cfg.num_workers} sampler threads; batches of {trainer.dm.cfg.batch_size} graphs "
          f"split over {len(CL_TASKS)} main tasks")
    text = printed.getvalue()
    test_metrics = json.loads(text[text.index("{"):])
    if not test_metrics or not all(np.isfinite(v) for v in test_metrics.values()):
        raise AssertionError("CL trainer: --do_eval printed no or non-finite test metrics")
    losses = [r["train_loss"] for r in hist] + [r["val/total_loss"] for r in hist]
    memory = trainer.epoch_memory_loss
    if not all(np.isfinite(losses)) or memory[0] != 0 or not all(m > 0 for m in memory[1:]):
        raise AssertionError(f"CL trainer: losses {losses}, memory_loss per epoch {memory} (want 0, then > 0)")
    missing = [f"{tag}.pt" for tag in (*(f"{mt}_model" for mt in CL_TASKS), "best", "last", "full")
               if not os.path.isfile(f"{ckpt_dir}/{tag}.pt")]
    if missing:
        raise AssertionError(f"CL trainer: checkpoints missing: {missing}")
    phase(f"CL trainer: cli.train.main {' '.join(argv[:2])} {' '.join(CL_TRAINER_FLAGS)}: {len(hist)} epochs "
          f"({', '.join(tasks)}) of {len(trainer.step_seconds) // len(hist)} train steps, launched {launched}; "
          "train_loss " + ", ".join(f"{r['train_loss']:.4f}" for r in hist)
          + "; memory_loss " + ", ".join(f"{m:.4f}" for m in memory)
          + "; val/total_loss " + ", ".join(f"{r['val/total_loss']:.4f}" for r in hist))
    _teacher_check(trainer)
    phase(f"CL trainer: checkpoints {', '.join(f'{mt}_model.pt' for mt in CL_TASKS)}, best.pt, last.pt, full.pt "
          f"present; --do_eval test metrics ({len(test_metrics)} keys): "
          + ", ".join(f"{k} {test_metrics[k]:.4f}" for k in ("all/cadence_acc", "cadence/cadence_acc",
                                                           "rna/localkey_acc", "rna/rna_onset_acc")
                      if k in test_metrics))


def _teacher_check(trainer) -> None:
    """The rna heads' train step on one rna batch without the teacher and
    with it (every head distilled), each once more after a step of each
    (the schedule's first rate is 0, which leaves the student on the
    teacher): memory_loss is above 0 only with it.  The Trainer's model
    trains on."""
    from analysisgnn_tpu_torch.train.state import create_train_state
    from analysisgnn_tpu_torch.train.step import StepConfig, make_train_step

    tasks = tuple(trainer.task_dict.items())
    state = create_train_state(trainer.model, len(tasks), trainer.optimizer, seed=0)
    (batch,) = trainer.dm.train_batches("rna", 1)
    steps = {label: make_train_step(trainer.model, trainer.optimizer, StepConfig(
        task_dict=tasks, active_tasks=trainer._cl_active("rna"), previous_tasks=previous,
        lambda_dctn=trainer.cfg.lambda_dctn)) for label, previous in (("without", ()), ("with", tuple(trainer.task_dict)))}
    memory = {}
    for label in ("without", "with", "without", "with"):
        state, aux = steps[label](state, batch)
        memory[label] = float(aux["memory_loss"])
    if memory["without"] > 0 or not memory["with"] > 0:
        raise AssertionError(f"CL trainer: memory_loss {memory['without']} without the teacher, {memory['with']} "
                             f"with it")
    phase(f"CL trainer: the rna heads' step on one rna batch: memory_loss {memory['without']:.4f} without the "
          f"teacher, {memory['with']:.4f} with it (previous tasks: all heads)")


def cl_parity(ckpt_dir: str) -> None:
    """The CL path with EWC and FAMO on the edge-zxp arm: a fit on the GPU
    against the CPU (trainer_parity; the fisher batch's backward on the
    GPU's route), FAMO's logits and the fisher's sum against the CPU's."""
    out = trainer_parity(ckpt_dir, EDGE_TRAIN, CL_PARITY_FLAGS, "CL parity", eps=PARITY_EPS)
    gpu, cpu = out["gpu"], out["cpu"]
    w_err = float((gpu["state"].famo.w.cpu() - cpu["state"].famo.w).abs().max())
    sums = [float(sum(f.double().sum() for f in side["state"].fisher).cpu()) for side in (gpu, cpu)]
    fisher_rel = abs(sums[0] - sums[1]) / abs(sums[1])
    if not (w_err <= CL_FAMO_W_ATOL and sums[1] > 0 and fisher_rel <= CL_FISHER_RTOL):
        raise AssertionError(f"CL parity: FAMO w max|d| {w_err:.3e} (tol {CL_FAMO_W_ATOL}), fisher sum {sums[0]} vs "
                             f"{sums[1]} (rel {fisher_rel:.2e}, tol {CL_FISHER_RTOL})")
    phase(f"CL parity: FAMO w max|GPU - CPU| {w_err:.3e} (tol {CL_FAMO_W_ATOL}, |w| up to "
          f"{float(cpu['state'].famo.w.abs().max()):.4f}); fisher sum {sums[0]:.6e} vs {sums[1]:.6e} (rel "
          f"{fisher_rel:.2e}, tol {CL_FISHER_RTOL})")


# ------------------------------------------------------- partitioned serving


def check_k6(name: str, x, halo: int) -> dict:
    """K6's kernel bit-equal to its plain version (it copies), in the
    allocating form and in the planned form with ``out`` that regime 2 uses
    (every element of a NaN-filled buffer written)."""
    from analysisgnn_tpu_torch.kernels.halo import HaloPlan, halo_pull, halo_pull_plain

    out = halo_pull(x, halo)
    ref = halo_pull_plain(x, halo)
    plan = HaloPlan(x, halo)
    buf = torch.full(plan.out_shape, float("nan"), device=x.device)
    planned = halo_pull(x, halo, out=buf, plan=plan)
    torch.cuda.synchronize()
    d, n_local, f = x.shape
    if out.shape != (d, 2 * halo, f) or not torch.equal(out, ref):
        raise AssertionError(f"K6 {name}: the kernel's halos differ from the plain version's")
    if planned is not buf or not torch.equal(buf, ref):
        raise AssertionError(f"K6 {name}: the planned call with out differs from the plain version")
    phase(f"kernel check: K6 {name}: D={d} N_local={n_local} H={halo} F={f}"
          + ("" if x.is_contiguous() else f" strides {x.stride()}")
          + f" (plan: float4 {plan.vec}): both forms bit-equal to the plain version")
    return {"case": name, "D": d, "H": halo, "max_abs_err": 0.0}


def k6_checks() -> list:
    """K6 at the regime-2 shape of a 20,000-note score on 4 partitions (H = its
    largest edge span), and at edge cases: one partition (all zeros), 2 and 8
    partitions, H = 1, H = N_local, F = 25 (the scalar loop), and strided
    inputs with and without 16-byte rows."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(6)
    rnd = lambda *shape: torch.randn(*shape, generator=gen).to(dev)
    rows = [check_k6("regime-2 shape", rnd(4, 5000, 256), 24)]
    wide = rnd(4, 4000, 300)
    for name, x, h in (("D=1 (all zeros)", rnd(1, 5000, 256), 24), ("D=2", rnd(2, 5000, 256), 24),
                       ("D=8", rnd(8, 2500, 256), 24), ("H=1", rnd(4, 5000, 256), 1),
                       ("H=N_local", rnd(4, 300, 256), 300), ("F=25 scalar loop", rnd(4, 5000, 25), 24),
                       ("non-contiguous, 16-byte rows", wide[:, ::2, 4:260], 24),
                       ("non-contiguous, unaligned rows", wide[:, ::2, 7:263], 24)):
        rows.append(check_k6(name, x, h))
    return rows


def _full_encode(model, na):
    """The single-window encode of a score on the card, with the host arrays
    that partition it and the encoder's input (the projected note rows)."""
    from analysisgnn_tpu_torch.core.graph import NOTE
    from analysisgnn_tpu_torch.inference.predict import graph_from_note_array
    from analysisgnn_tpu_torch.models.analysis import KEY_SIGNATURE_CLASSES, PITCH_SPELLING_CLASSES

    g = graph_from_note_array(na, add_beats=False, add_measures=False, device="cuda")
    a = g.node_attrs[NOTE]
    x = g.node_features[NOTE]
    full = model.encode(g.node_features, g.edge_index, a["pitch_spelling"], a["key_signature"], g.num_target_nodes)
    ps = a["pitch_spelling"].clamp(0, PITCH_SPELLING_CLASSES - 1)
    ks = a["key_signature"].clamp(0, KEY_SIGNATURE_CLASSES - 1)
    h0 = model.project[NOTE](torch.cat([x, model.pitch_embedding(ps), model.key_embedding(ks)], -1))
    host = {"x": x.cpu().numpy(), "ps": a["pitch_spelling"].cpu().numpy(), "ks": a["key_signature"].cpu().numpy(),
            "edges": {et: ei.cpu().numpy() for et, ei in g.edge_index.items()}}
    return g, full, h0, host


def _within(got, want) -> tuple:
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    return err, scale, err <= PART_RTOL * scale + PART_ATOL


def _regime1_check(model, full, host: dict, partitions: int, label: str, devices=None) -> dict:
    """The overlap-region encode over ``partitions`` windows (spread over
    ``devices``; the model's card alone by default) against the
    single-window encode ``full`` (``_full_encode``)."""
    from analysisgnn_tpu_torch.distributed.partition_encoder import (
        make_partitioned_encode, partition_full_graph, unpartition,
    )

    part = partition_full_graph(host["x"], host["ps"], host["ks"], host["edges"], partitions,
                                len(model.encoder.layers) + 2)
    emb = unpartition(make_partitioned_encode(model, devices=devices)(part), part)
    err, scale, ok = _within(emb, full)
    if emb.shape != full.shape or not torch.isfinite(emb).all() or not ok:
        raise AssertionError(f"{label}: partitioned vs single-window embeddings max|d| {err:.3e} > "
                             f"{PART_RTOL} * {scale:.4f} + {PART_ATOL}")
    phase(f"{label}: {part.num_nodes} notes, {partitions} partitions of {part.num_local} owned rows with halos of "
          f"{part.halo} (N_ext {part.n_ext}): embeddings max|d| {err:.3e} against the single-window encode "
          f"(tol {PART_RTOL} * max|full| {scale:.4f} + {PART_ATOL})")
    return {"notes": part.num_nodes, "partitions": partitions, "halo": part.halo, "max_abs_err": err, "scale": scale}


def synthetic_score_xml(min_notes: int, seed: int) -> str:
    """A 4/4 MusicXML part of at least ``min_notes`` notes: quarter and half
    notes, some in chords of up to three, and rests."""
    rng = np.random.default_rng(seed)
    measures, count = [], 0
    while count < min_notes:
        notes, left = [], 4
        while left:
            dur = int(min(rng.choice([1, 2]), left))
            left -= dur
            if rng.random() < 0.1:
                notes.append(f"<note><rest/><duration>{dur}</duration></note>")
                continue
            for c in range(int(rng.integers(1, 4))):
                notes.append(f"<note>{'<chord/>' if c else ''}<pitch><step>{'CDEFGAB'[rng.integers(7)]}</step>"
                             f"<octave>{rng.integers(3, 6)}</octave></pitch><duration>{dur}</duration></note>")
                count += 1
        attrs = ("<attributes><divisions>1</divisions><time><beats>4</beats><beat-type>4</beat-type></time>"
                 "</attributes>") if not measures else ""
        measures.append(f'<measure number="{len(measures) + 1}">{attrs}{"".join(notes)}</measure>')
    return ('<?xml version="1.0"?><score-partwise version="3.1"><part-list><score-part id="P1"/></part-list>'
            f'<part id="P1">{"".join(measures)}</part></score-partwise>')



@torch.no_grad()
def partitioned_serve(model, cfg: dict, tmp: str) -> int:
    """Long-score serving through partitions on a line: regime 1 (the CLI's
    path, then the CLI itself on a checkpoint of ``model``, whose
    configuration is ``cfg``) and regime 2 (K6 before every layer).  The
    halo of regime 2 on PARTITIONS partitions."""
    from analysisgnn_tpu_torch.cli.predict import main as predict_main
    from analysisgnn_tpu_torch.core.graph import NOTE
    from analysisgnn_tpu_torch.data.note_array import synthetic_score
    from analysisgnn_tpu_torch.distributed.partition import partition_graph
    from analysisgnn_tpu_torch.distributed.partition_encoder import (
        make_partitioned_fused_sage, spread_devices, visible_devices,
    )
    from analysisgnn_tpu_torch.inference.predict import predict_score_ids, predict_score_partitioned
    from analysisgnn_tpu_torch.models.encoders import l2_normalize

    na = synthetic_score(PART_NOTES, seed=PART_SEED)
    spread = spread_devices(PARTITIONS, visible_devices("cuda"))  # C = 1 on one card
    n, layers = len(na), len(model.encoder.layers)
    serve = lambda: predict_score_partitioned(model, na, num_devices=PARTITIONS, ids_only=True, device="cuda")
    with route("regime 1", NODE) as launched:
        ids, again = serve(), serve()
    ref_ids = predict_score_ids(model, na, add_beats=False, add_measures=False, device="cuda")
    if set(ids) != set(ref_ids) or any(v.shape != (n,) or (v < 0).any() or not np.array_equal(v, again[k])
                                       for k, v in ids.items()):
        raise AssertionError("regime 1: bad or unstable ids")
    differ = sum(int((ids[k] != ref_ids[k]).sum()) for k in ref_ids)
    phase(f"partitioned serve: regime 1, predict_score_partitioned(ids_only=True) of {n} notes on {PARTITIONS} "
          f"partitions over C = {len(spread)} card(s) ({', '.join(str(d) for d in spread)}), twice: launched "
          f"{launched}, the same ids; {differ} of {n * len(ids)} ids differ from predict_score_ids")
    g, full, h0, host = _full_encode(model, na)
    _regime1_check(model, full, host, PARTITIONS, "partitioned serve: regime 1")

    # the CLI: a checkpoint of the serve model and a MusicXML score
    ckpt = f"{tmp}/serve_ckpt"
    os.makedirs(ckpt)
    with open(f"{ckpt}/model_config.json", "w") as f:
        json.dump(cfg, f)
    torch.save(model.state_dict(), f"{ckpt}/best.pt")
    with open(f"{tmp}/score.musicxml", "w") as f:
        f.write(synthetic_score_xml(PART_NOTES, seed=8))
    with route("CLI --partition_devices", NODE) as launched, contextlib.redirect_stdout(io.StringIO()):
        predict_main(["--checkpoint_dir", ckpt, "--score", f"{tmp}/score.musicxml", "--output_csv", f"{tmp}/out.csv",
                      "--partition_devices", str(PARTITIONS), "--device", "cuda"])
    with open(f"{tmp}/out.csv") as f:
        lines = f.read().splitlines()
    if len(lines) < PART_NOTES + 1 or lines[0].count(",") != 2 + len(model.task_dict):
        raise AssertionError(f"CLI --partition_devices: {len(lines)} CSV lines")
    phase(f"partitioned serve: cli.predict.main --partition_devices {PARTITIONS} on a MusicXML score of "
          f"{len(lines) - 1} notes: launched {launched}, {len(lines) - 1} CSV rows of {len(model.task_dict)} tasks")

    # regime 2: the halo exchange before every layer, on the projected note rows
    ref = model.encoder({NOTE: h0}, model.encoder.plan(g.edge_index, {NOTE: n}))
    rels = tuple(model.encoder.layers[0].groups[NOTE])
    fn = make_partitioned_fused_sage(rels, layers, use_jk=model.encoder.jk is not None, hidden=h0.shape[1])
    h0_host = h0.cpu().numpy()
    for d in REGIME2_PARTITIONS:
        pg = partition_graph(h0_host, {et: host["edges"][et] for et in rels}, d)
        on_card = lambda arrays: {et: torch.from_numpy(v).cuda() for et, v in arrays.items()}
        with route(f"regime 2 on {d} partitions", {K6}) as launched:
            out = fn(model.encoder, torch.from_numpy(pg.x).cuda(), on_card(pg.edge_src), on_card(pg.edge_dst), pg.halo)
        got = l2_normalize(torch.relu(out)).reshape(-1, out.shape[-1])[:n]
        err, scale, ok = _within(got, ref)
        if not torch.isfinite(got).all() or not ok:
            raise AssertionError(f"regime 2 on {d} partitions: max|d| {err:.3e} against model.encoder "
                                 f"(tol {PART_RTOL} * {scale:.4f} + {PART_ATOL})")
        phase(f"partitioned serve: regime 2 on {d} partitions of {pg.num_local} rows, H={pg.halo}: launched "
              f"{launched} a forward, max|d| {err:.3e} against model.encoder after ReLU and L2 norm (tol "
              f"{PART_RTOL} * {scale:.4f} + {PART_ATOL})")
        if d == PARTITIONS:
            regime2_halo = pg.halo
    return regime2_halo


@torch.no_grad()
def partition_twin(model) -> dict:
    """The partitioned-encode certification of dryrun_multichip
    (__graft_entry__.py:287-356) on one card: 1,200 notes (seed 7) through 8
    partitions."""
    from analysisgnn_tpu_torch.data.note_array import synthetic_score

    _, full, _, host = _full_encode(model, synthetic_score(num_notes=1200, seed=7))
    return _regime1_check(model, full, host, 8, "dryrun_multichip twin")


# ---------------------------------------------------------------- the mesh

MESH_SLOTS = 4  # data slots of the world-1 mesh on the card: the data axis of JAX's 8-device reference run
MESH_PARITY_SLOTS = 1  # the GPU-vs-CPU cycle runs on the first of them
MESH_TIMEOUT_S = 300.0  # the NCCL process group's timeout
# GPU vs CPU after the cycle (dropout 0, PARITY_EPS): the dry run's warmup
# leaves the rate 0 at step 0 and 1e-3 at step 1, so most parameters move by
# about 1e-7, under PARITY_PARAM_ATOL.  The gradients are held, parameter by
# parameter, through the AdamW moments after the cycle (mu = 0.09 g_all +
# 0.1 g_cadence) and through the moves (final - init): the norm of the
# difference within MESH_LEAF_RTOL of the CPU's norm, plus MESH_FLOOR_OF_MAX
# of the CPU's largest element an element (a leaf whose gradient is 0 but
# for rounding, the JK attention's bias, differs by noise) and, for the
# moves, one f32 ulp of each final value.  The card's gather backward adds
# with atomics in no fixed order and the L2 norms' backward cancels, so the
# encoder's gradients differ from the CPU's by about 5e-4 of a leaf's norm
# on an H100 (the remat phase found 1.8e-4 over all gradients between two
# runs on the card); a wrong gradient is off by its own size.
MESH_LEAF_RTOL, MESH_FLOOR_OF_MAX = 1e-2, 2e-5




def mesh_phase() -> None:
    """``dryrun_multichip`` at world size 1 over an NCCL process group (a
    FileStore, rank 0) with MESH_SLOTS data slots on the card, through K1
    and K6; one sharded step with a finite loss; then the cycle on
    MESH_PARITY_SLOTS slots on the GPU against the CPU (dropout 0, Adam eps
    1): losses, parameters, the AdamW moments and each parameter's move.
    The phase fails if NCCL does not initialize: there is no other backend
    for the card."""
    import torch.distributed as dist

    from analysisgnn_tpu_torch.distributed import dryrun
    from analysisgnn_tpu_torch.distributed import mesh as tmesh
    from analysisgnn_tpu_torch.distributed.launch import init_process_group
    from analysisgnn_tpu_torch.train.state import ClippedAdamW, create_train_state
    from analysisgnn_tpu_torch.train.step import StepConfig

    cfg = dryrun.DryrunConfig()
    with tempfile.TemporaryDirectory() as tmp:
        init_process_group("nccl", f"{tmp}/store", 0, 1, MESH_TIMEOUT_S)
        try:
            phase(f"mesh: NCCL process group of 1 rank (NCCL_SOCKET_IFNAME={os.environ.get('NCCL_SOCKET_IFNAME')}), "
                  f"backend {dist.get_backend()}")
            model = dryrun.build_model(cfg, "cuda")
            # the sharded cycle and its replay; certification 2: the full encode and the windows of regime 1
            # (K1), regime 2 (K6)
            with route("the mesh path", {K1, K6}) as launched, contextlib.redirect_stdout(io.StringIO()) as summary:
                result = dryrun.dryrun_multichip(1, device="cuda", slots_per_rank=MESH_SLOTS, cfg=cfg)
            phase(f"mesh: {summary.getvalue().strip()}")
            p = result["partitioned"]
            phase(f"mesh: dryrun_multichip(1, slots_per_rank={MESH_SLOTS}) launched {launched}; regime 1 halo "
                  f"{p['halo']}, regime 2 halo {p['regime2_halo']} over {p['partitions']} partitions")

            # the sharded step alone, on batches the parity cycle below takes too
            mesh = tmesh.make_mesh(1, slots=MESH_SLOTS, device="cuda")
            sampler = dryrun.build_sampler(cfg.num_notes, cfg.subgraph, cfg.graphs // MESH_SLOTS, tasks=cfg.tasks)
            stacked = tmesh.stack_batches([sampler.sample_batch(device="cpu") for _ in range(MESH_SLOTS)])
            slots = tmesh.shard_stacked_batch(stacked, mesh)
            opt = ClippedAdamW(lambda _step: PARITY_LR)
            state = tmesh.shard_train_state(create_train_state(model, len(cfg.tasks), opt, 1), model, mesh)
            step = tmesh.make_sharded_train_step(
                model, opt, StepConfig(task_dict=cfg.tasks, active_tasks=tuple(t for t, _ in cfg.tasks)), mesh)
            _, loss = step(state, slots)
            if not torch.isfinite(loss):
                raise AssertionError(f"the sharded step's loss is {float(loss)}")
            phase(f"mesh: one sharded step of {MESH_SLOTS} slots ({result['notes_per_step']} note rows): loss "
                  f"{float(loss):.4f}")
        finally:
            dist.destroy_process_group()
    del model, state, step

    # the cycle on the first slots, GPU (kernels) against CPU (plain versions), dropout 0, Adam eps 1
    pcfg = dataclasses.replace(cfg, dropout=0.0, adam_eps=PARITY_EPS)
    flat = lambda tensors: torch.cat([x.detach().reshape(-1).cpu() for x in tensors])  # noqa: E731
    out = {}
    for label, dev in (("gpu", "cuda"), ("cpu", "cpu")):
        one = tmesh.local_mesh(MESH_PARITY_SLOTS, dev)
        m = dryrun.build_model(pcfg, dev)
        init = flat(m.parameters())
        loss_all, loss_cad, st = dryrun.cl_cycle(m, tmesh.shard_stacked_batch(stacked[:MESH_PARITY_SLOTS], one), one,
                                                 pcfg)
        out[label] = {"losses": (loss_all, loss_cad), "init": init, "final": flat(m.parameters()),
                      **{k: _moments_in_order(getattr(st.opt_state, k), st.params.layout) for k in ("mu", "nu")}}
    g, c = out["gpu"], out["cpu"]
    (ga, gc), (ca, cc) = g["losses"], c["losses"]
    rel = max(abs(ga - ca) / abs(ca), abs(gc - cc) / abs(cc))
    worst = float((g["final"] - c["final"]).abs().max())
    if not (torch.equal(g["init"], c["init"]) and rel <= PARITY_LOSS_RTOL and worst <= PARITY_PARAM_ATOL):
        raise AssertionError(f"mesh: GPU vs CPU cycle: losses {ga}, {gc} vs {ca}, {cc} (rel {rel:.2e}, tol "
                             f"{PARITY_LOSS_RTOL}), parameters max|d| {worst:.3e} (tol {PARITY_PARAM_ATOL})")
    names = [n for n, _ in m.named_parameters()]
    numels = [p.numel() for p in m.parameters()]
    used = {k: _leafwise_within(g[k], c[k], numels + [len(cfg.tasks)], names + ["mt_params"],
                                f"AdamW {k} after the cycle") for k in ("mu", "nu")}
    move = c["final"] - c["init"]
    ulp = torch.nextafter(c["final"].abs(), torch.tensor(math.inf)) - c["final"].abs()
    used["move"] = _leafwise_within(g["final"] - g["init"], move, numels, names, "the cycle's move", ulp)
    phase(f"mesh: the cycle on {MESH_PARITY_SLOTS} slot, GPU vs CPU (dropout 0, eps {PARITY_EPS}): losses "
          f"{ga:.6f}, {gc:.6f} vs {ca:.6f}, {cc:.6f} (rel {rel:.2e}, tol {PARITY_LOSS_RTOL}); parameters max|d| "
          f"{worst:.3e} (tol {PARITY_PARAM_ATOL}); moves largest {float(move.abs().max()):.3e}, median "
          f"{float(move.abs().median()):.3e}; each parameter's AdamW moments and move within {MESH_LEAF_RTOL} of the "
          f"CPU's norm + {MESH_FLOOR_OF_MAX} of its largest an element (+ an ulp a final value), the largest share "
          f"of that used: " + ", ".join(f"{k} {u[0]:.3f} ({u[1]})" for k, u in used.items()))


def _moments_in_order(moments, layout) -> torch.Tensor:
    """A sharded state's AdamW moments ``[replicated, own slice, task
    weights]`` at one model rank, in the parameters' order, then the task
    weights' (on the host)."""
    flat = torch.empty(layout.total, device=moments[0].device)
    flat[layout.rep_idx], flat[layout.own_idx[0]] = moments[0], moments[1]
    return torch.cat([flat, moments[2].reshape(-1)]).cpu()


def _leafwise_within(got: torch.Tensor, want: torch.Tensor, numels, names, what: str, rounding=None) -> tuple:
    """``got`` against ``want`` (flat, split into ``numels`` parts named
    ``names``): each part's difference within MESH_LEAF_RTOL of its norm in
    ``want``, plus MESH_FLOOR_OF_MAX of ``want``'s largest element an element
    and the norm of ``rounding``'s part.  The largest share of its tolerance
    a part used, and its name."""
    norms = lambda x: torch.stack(torch._foreach_norm(list(x.split(numels)))).tolist()  # noqa: E731
    floor = MESH_FLOOR_OF_MAX * float(want.abs().max())
    err, scale = norms(got - want), norms(want)
    rounded = [0.0] * len(numels) if rounding is None else norms(rounding)
    worst = (0.0, "")
    for name, e, w, r, n in zip(names, err, scale, rounded, numels):
        tol = MESH_LEAF_RTOL * w + floor * math.sqrt(n) + r
        if not e <= tol:
            raise AssertionError(f"mesh: GPU vs CPU, {what}: {name} differs by {e:.3e} in norm from the CPU's "
                                 f"{w:.3e} (tol {tol:.3e})")
        worst = max(worst, (e / tol, name))
    return worst


# ---------------------------------------------------------------- RNA serve, chord chain


def humdrum_text(measures: int, seed: int) -> str:
    """A two-spine 4/4 Humdrum **kern score: a bass of quarter and half notes
    and an upper spine of chords of up to three notes, with rests and ties."""
    rng = np.random.default_rng(seed)
    lines = ["**kern\t**kern", "*clefF4\t*clefG2", "*k[b-]\t*k[b-]", "*M4/4\t*M4/4"]
    for m in range(measures):
        lines.append(f"={m + 1}\t={m + 1}")
        for _ in range(4):
            bass = f"4{'CDEFGAB'[rng.integers(7)]}" if rng.random() > 0.1 else "4r"
            upper = " ".join(f"4{'cdefgab'[rng.integers(7)]}" for _ in range(int(rng.integers(1, 4))))
            lines.append(f"{bass}\t{upper}")
    lines += ["==\t==", "*-\t*-"]
    return "\n".join(lines) + "\n"



def _csv_ids(path: str) -> list:
    """The label columns of each row of a predict CSV."""
    with open(path, newline="") as f:
        return [row[3:] for row in list(csv.reader(f))[1:]]


@torch.no_grad()
def _zxp_logits_against_node(ckpt: str, score: str) -> float:
    """The checkpoint loaded as the predict CLI loads it, once as saved
    ("node", K1) and once with --conv_impl edge-zxp (K3 forward), run on the
    card on the score's graph as the CLI builds it: the largest difference of
    their logits, which must stay within LOGIT_ATOL."""
    from analysisgnn_tpu_torch.cli.predict import load_model
    from analysisgnn_tpu_torch.core.graph import NOTE
    from analysisgnn_tpu_torch.data.musicxml import load_score
    from analysisgnn_tpu_torch.inference.predict import graph_from_note_array

    parsed = load_score(score)
    n = len(parsed.note_array)
    logits = {}
    for arm in ("node", "edge-zxp"):
        model, cfg = load_model(ckpt, "best", "cuda", conv_impl=arm)
        g = graph_from_note_array(parsed.note_array, parsed.measures,
                                  cfg.get("feature_type", "simple").replace("simple", "voice"),
                                  cfg.get("add_beats", False), cfg.get("add_measures", False), device="cuda")
        a = g.node_attrs[NOTE]
        out = model(g.node_features, g.edge_index, a["pitch_spelling"], a["key_signature"], g.num_target_nodes)
        logits[arm] = {k: v[:n].float() for k, v in out.items()}
    worst = 0.0
    for task, t in logits["node"].items():
        z = logits["edge-zxp"][task]
        if z.shape != t.shape or not bool(torch.isfinite(z).all()):
            raise AssertionError(f"RNA serve edge-zxp: {task} logits of shape {tuple(z.shape)} or not finite")
        worst = max(worst, float((z - t).abs().max()))
    if worst > LOGIT_ATOL:
        raise AssertionError(f"RNA serve: edge-zxp (K3) vs node (K1) logits differ by {worst:.3e} > {LOGIT_ATOL}")
    return worst


@torch.no_grad()
def rna_serve(model, cfg: dict, tmp: str) -> None:
    """The predict CLI's Roman-numeral MusicXML on the serve model (phase 4's
    weights): a generated 2,000-note MusicXML score with --output_musicxml
    (twice: the same ids each time), then with --conv_impl edge-zxp (K3),
    then a Humdrum .krn score, then a cached W&B artifact."""
    from analysisgnn_tpu_torch.cli.predict import main as predict_main
    from analysisgnn_tpu_torch.data.kern import parse_kern

    ckpt = f"{tmp}/rna_ckpt"
    os.makedirs(ckpt)
    with open(f"{ckpt}/model_config.json", "w") as f:
        json.dump(cfg, f)
    torch.save(model.state_dict(), f"{ckpt}/best.pt")
    with open(f"{tmp}/rna.musicxml", "w") as f:
        f.write(synthetic_score_xml(RNA_NOTES, seed=20))
    with open(f"{tmp}/rna.krn", "w") as f:
        f.write(humdrum_text(40, seed=20))

    def run(name: str, score: str, extra: list, want) -> dict:
        with route(f"RNA serve {name}", want) as launched, contextlib.redirect_stdout(io.StringIO()):
            predict_main(["--checkpoint_dir", ckpt, "--score", score, "--output_csv", f"{tmp}/{name}.csv",
                          "--output_musicxml", f"{tmp}/{name}.musicxml", "--device", "cuda", *extra])
        with open(f"{tmp}/{name}.musicxml") as f:
            xml = f.read()
        if not xml.startswith("<?xml") or "<lyric><text>" not in xml or not xml.endswith("</score-partwise>"):
            raise AssertionError(f"RNA serve {name}: the RNA MusicXML is malformed")
        return {"launched": launched, "bytes": len(xml.encode()), "labels": xml.count("<lyric>"),
                "ids": _csv_ids(f"{tmp}/{name}.csv")}

    first = run("node_first", f"{tmp}/rna.musicxml", [], NODE)
    node = run("node", f"{tmp}/rna.musicxml", [], NODE)
    zxp = run("zxp", f"{tmp}/rna.musicxml", ["--conv_impl", "edge-zxp"], EDGE_SERVE)
    krn = run("krn", f"{tmp}/rna.krn", [], NODE)
    notes = len(node["ids"])
    if notes < RNA_NOTES or len(zxp["ids"]) != notes or node["ids"] != first["ids"]:
        raise AssertionError(f"RNA serve: {notes} CSV rows (at least {RNA_NOTES}), or unstable ids across calls")
    krn_notes = len(parse_kern(f"{tmp}/rna.krn").note_array)
    if len(krn["ids"]) != krn_notes:
        raise AssertionError(f"RNA serve .krn: {len(krn['ids'])} CSV rows for {krn_notes} notes")
    cached_artifact_request(ckpt, f"{tmp}/rna.musicxml", tmp, node["ids"])
    differ = sum(a != b for row_a, row_b in zip(node["ids"], zxp["ids"]) for a, b in zip(row_a, row_b))
    zxp_err = _zxp_logits_against_node(ckpt, f"{tmp}/rna.musicxml")
    phase(f"RNA serve: cli.predict.main --output_musicxml on a MusicXML score of {notes} notes, twice: launched "
          f"{node['launched']}, the same ids; RNA MusicXML {node['bytes']} bytes, {node['labels']} harmony labels")
    phase(f"RNA serve: --conv_impl edge-zxp: launched {zxp['launched']}; {differ} of "
          f"{notes * len(model.task_dict)} ids differ from the node run; on the score's graph, the edge-zxp "
          f"model's logits (K3) against the node model's (K1) max|d| {zxp_err:.3e} (tol {LOGIT_ATOL} abs)")
    phase(f"RNA serve: a .krn score of {krn_notes} notes: launched {krn['launched']}, RNA MusicXML {krn['bytes']} "
          f"bytes, {krn['labels']} labels")


@torch.no_grad()
def cached_artifact_request(ckpt: str, score: str, tmp: str, want_ids: list) -> None:
    """The predict CLI given a W&B artifact id whose copy lies in the
    artifact cache (--artifacts_dir): it serves the cached checkpoint without
    wandb or the network, under utils/profiling.py's trace, whose Chrome
    trace must name K1's kernel."""
    from analysisgnn_tpu_torch.cli.predict import main as predict_main
    from analysisgnn_tpu_torch.utils.profiling import trace as profiling_trace

    name = "model-rna:v0"
    shutil.copytree(ckpt, f"{tmp}/artifacts/{name}")
    printed = io.StringIO()
    with route("RNA serve cached", NODE) as launched, profiling_trace(f"{tmp}/cached_trace"), \
            contextlib.redirect_stdout(printed):
        predict_main(["--checkpoint_dir", f"entity/project/{name}", "--artifacts_dir", f"{tmp}/artifacts",
                      "--score", score, "--output_csv", f"{tmp}/cached.csv", "--device", "cuda"])
        torch.cuda.synchronize()
    if f"Using cached checkpoint: {tmp}/artifacts/{name}" not in printed.getvalue():
        raise AssertionError(f"RNA serve cached: the CLI printed {printed.getvalue()!r}")
    if _csv_ids(f"{tmp}/cached.csv") != want_ids:
        raise AssertionError("RNA serve cached: the ids differ from the local checkpoint's run")
    (trace_file,) = os.listdir(f"{tmp}/cached_trace")
    with open(f"{tmp}/cached_trace/{trace_file}") as f:
        text = f.read()
    k1_events = text.count("segment_mean_base_kernel")
    if not k1_events:
        raise AssertionError("RNA serve cached: the profiling trace names no segment_mean_base_kernel")
    phase(f"RNA serve: cli.predict.main --checkpoint_dir entity/project/{name} --artifacts_dir served the cached "
          f"copy under utils.profiling.trace (its ids equal the local run's; launched {launched}); the trace "
          f"({len(text)} bytes) names segment_mean_base_kernel {k1_events} times")


def chord_chain(tmp: str) -> None:
    """The chord chain: predict_chords.main at its CLI defaults (hidden 256,
    one HybridGNN layer, the 14 latest tasks, the smoother) with --romantext
    on a generated score of about 2,000 notes through K1 (its HybridGNN's
    hetero convs; nothing else of the chain launches a hand-written kernel),
    and predict_chord_tasks on the card against the same on the CPU with the
    same weights."""
    from analysisgnn_tpu_torch.data.features import select_features
    from analysisgnn_tpu_torch.data.musicxml import load_score
    from analysisgnn_tpu_torch.inference import predict_chords as pc

    score = f"{tmp}/chords.musicxml"
    with open(score, "w") as f:
        f.write(synthetic_score_xml(CHORD_NOTES, seed=21))
    argv = ["--input_score", score, "--output_dir", f"{tmp}/chords", "--hidden", str(CHORD_HIDDEN),
            "--num_layers", str(CHORD_LAYERS), "--romantext", "--device", "cuda"]
    na = load_score(score).note_array
    in_features = select_features(na, "voice").shape[1]
    model = pc.build_chord_model(in_features, CHORD_HIDDEN, CHORD_LAYERS, device="cuda")
    post = pc.build_post_model(CHORD_HIDDEN, device="cuda")
    with route("chord chain", NODE) as launched, contextlib.redirect_stdout(io.StringIO()):
        pc.main(argv)
    base = os.path.splitext(os.path.basename(score))[0]
    with open(f"{tmp}/chords/{base}.rntxt") as f:
        rntxt = f.read()
    with open(f"{tmp}/chords/{base}_rna.musicxml") as f:
        xml = f.read()
    if not rntxt.startswith("Composer:") or "m1" not in rntxt or "<lyric><text>" not in xml:
        raise AssertionError("chord chain: the RomanText or the RNA MusicXML is malformed")
    phase(f"chord chain: predict_chords.main --hidden {CHORD_HIDDEN} --num_layers {CHORD_LAYERS} --romantext on a "
          f"score of {len(na)} notes: launched {launched}; {rntxt.count(chr(10))} RomanText lines, "
          f"{xml.count('<lyric>')} RNA labels")

    # the same weights on the CPU (plain versions): probabilities, decoded labels, annotations
    cpu_model = pc.build_chord_model(in_features, CHORD_HIDDEN, CHORD_LAYERS, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_post = pc.build_post_model(CHORD_HIDDEN, device="cpu")
    cpu_post.load_state_dict({k: v.cpu() for k, v in post.state_dict().items()})
    gpu, onsets = pc.predict_chord_tasks(na, model=model, post_model=post, device="cuda")
    cpu, cpu_onsets = pc.predict_chord_tasks(na, model=cpu_model, post_model=cpu_post, device="cpu")
    if set(gpu) != set(cpu) or not np.array_equal(onsets, cpu_onsets):
        raise AssertionError("chord chain: the GPU and CPU runs cover other tasks or onsets")
    worst = {}
    for task, p in gpu.items():
        if p.shape != cpu[task].shape or not np.isfinite(p).all():
            raise AssertionError(f"chord chain: {task} probabilities of shape {p.shape} or not finite")
        worst[task] = float(np.abs(p - cpu[task]).max())
    if max(worst.values()) > CHORD_PROB_ATOL:
        raise AssertionError(f"chord chain: GPU vs CPU probabilities differ by {max(worst.values()):.3e} > "
                             f"{CHORD_PROB_ATOL}: {worst}")
    dec, cpu_dec = pc.decode_chord_predictions(gpu), pc.decode_chord_predictions(cpu)
    differ = [i for i in range(len(onsets)) if any(dec[t][i] != cpu_dec[t][i] for t in dec)]
    # an onset may decode to another label only where that task's top two CPU probabilities lie within
    # 2 * CHORD_PROB_ATOL (a near tie that the allowed difference can flip); anything else raises
    for i in differ:
        for t in dec:
            if dec[t][i] != cpu_dec[t][i]:
                top2 = np.sort(cpu[t][i])[-2:]
                if top2[1] - top2[0] > 2 * CHORD_PROB_ATOL:
                    raise AssertionError(f"chord chain: onset {i} decodes {t} to {dec[t][i]!r} on the GPU and "
                                         f"{cpu_dec[t][i]!r} on the CPU with a top-two gap of "
                                         f"{top2[1] - top2[0]:.3e} > {2 * CHORD_PROB_ATOL}")
    differ = len(differ)
    ann, cpu_ann = pc.resolve_annotations(dec, onsets), pc.resolve_annotations(cpu_dec, onsets)
    if differ == 0 and ann != cpu_ann:
        raise AssertionError("chord chain: equal labels resolved to other annotations on the GPU and the CPU")
    phase(f"chord chain: GPU vs CPU (plain versions, same weights), {len(onsets)} onsets: probabilities max|d| "
          f"{max(worst.values()):.3e} (tol {CHORD_PROB_ATOL} abs; worst task "
          f"{max(worst, key=worst.get)}), {differ} onsets with other decoded labels, {len(ann)} annotations, "
          f"{'equal' if ann == cpu_ann else 'not equal'}")


# --------------------------------------------------------- the MetricalGNN family


def metrical_trainer(flags: list, label: str, ckpt_dir: str, want) -> None:
    """The training entry point on a MetricalGNN configuration through its
    route ``want``, finite losses."""
    from analysisgnn_tpu_torch.cli.train import main as train_main

    with route(label, want) as launched:
        trainer = train_main([*flags, "--checkpoint_dir", ckpt_dir])
    torch.cuda.synchronize()
    hist = trainer.history
    losses = [r["train_loss"] for r in hist] + [r["val/total_loss"] for r in hist]
    if not all(np.isfinite(losses)) or trainer.model.encoder_type != "metricalgnn":
        raise AssertionError(f"{label}: not a MetricalGNN run, or a non-finite loss: {losses}")
    phase(f"{label}: cli.train.main {' '.join(flags)}: {len(hist)} epochs of {len(trainer.step_seconds) // len(hist)} "
          f"train steps, launched {launched}; train_loss " + ", ".join(f"{r['train_loss']:.4f}" for r in hist)
          + "; val/total_loss " + ", ".join(f"{r['val/total_loss']:.4f}" for r in hist))


def metrical_serve(ckpt: str, label: str, score: str, want) -> None:
    """The predict CLI on a trained MetricalGNN checkpoint through its serve
    route ``want``; then predict_score's probabilities on the card against
    the CPU with the same weights.  The romanNumeral head's class 184, which
    has no label (ROADMAP queue 3), gets a low bias first, as the CPU tests
    do: a head trained for 8 steps may still pick it, and the decode raises."""
    from analysisgnn_tpu_torch.cli.predict import load_model
    from analysisgnn_tpu_torch.cli.predict import main as predict_main
    from analysisgnn_tpu_torch.data.musicxml import load_score
    from analysisgnn_tpu_torch.inference.predict import predict_score
    from analysisgnn_tpu_torch.theory.vocab import TASK_DICT

    state = torch.load(f"{ckpt}/last.pt", map_location="cpu", weights_only=True)
    state["heads.clf.b2"][list(TASK_DICT).index("romanNumeral"), 0, TASK_DICT["romanNumeral"] - 1] = -1e3
    torch.save(state, f"{ckpt}/served.pt")
    model, _ = load_model(ckpt, "served", "cuda")
    with route(f"{label} serve", want) as launched, contextlib.redirect_stdout(io.StringIO()):
        predict_main(["--checkpoint_dir", ckpt, "--checkpoint", "served", "--score", score, "--output_csv",
                      f"{ckpt}/served.csv", "--device", "cuda"])
    ids = _csv_ids(f"{ckpt}/served.csv")
    parsed = load_score(score)
    if len(ids) != len(parsed.note_array) or len(ids) < METRICAL_NOTES:
        raise AssertionError(f"{label} serve: {len(ids)} CSV rows for {len(parsed.note_array)} notes")
    cpu_model, _ = load_model(ckpt, "served", "cpu")
    probs = {label: predict_score(m, parsed.note_array, parsed.measures, add_beats=True, add_measures=True,
                                  device=dev) for label, dev, m in (("gpu", "cuda", model), ("cpu", "cpu", cpu_model))}
    worst = {}
    for task, p in probs["gpu"].items():
        if p.shape != probs["cpu"][task].shape or not np.isfinite(p).all():
            raise AssertionError(f"{label} serve: {task} probabilities of shape {p.shape} or not finite")
        worst[task] = float(np.abs(p - probs["cpu"][task]).max())
    err = max(worst.values())
    if err > METRICAL_PROB_ATOL:
        raise AssertionError(f"{label} serve: GPU vs CPU probabilities differ by {err:.3e} > {METRICAL_PROB_ATOL}")
    phase(f"{label} serve: cli.predict.main on a MusicXML score of {len(ids)} notes, launched {launched}; "
          f"predict_score GPU vs CPU (plain versions, same weights) probabilities max|d| {err:.3e} (tol "
          f"{METRICAL_PROB_ATOL} abs; worst task {max(worst, key=worst.get)})")


@torch.no_grad()
def scan_check(batch) -> None:
    """AssocBiGRU (MetricalConv's default sequence model, a log-depth scan in
    plain PyTorch) at a train batch's beat rows, F = 256, on the card against
    the CPU."""
    from analysisgnn_tpu_torch.models.rnn import AssocBiGRU, segment_starts

    f = TRAIN_CFG["hidden_channels"]
    rows = batch.capacity("beat")
    starts = segment_starts(batch.batch["beat"])
    torch.manual_seed(0)
    gpu = AssocBiGRU(f, f).cuda()
    x = torch.randn(rows, f, device="cuda")
    cpu = AssocBiGRU(f, f)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    err = float((gpu(x, starts).cpu() - cpu(x.cpu(), starts.cpu())).abs().max())
    if err > SCAN_ATOL:
        raise AssertionError(f"metrical scan: AssocBiGRU on the card vs the CPU differs by {err:.3e} > {SCAN_ATOL}")
    phase(f"metrical scan: {rows} beat rows ({int(starts.sum())} segments) x {f}: AssocBiGRU GPU vs CPU max|d| "
          f"{err:.3e} (tol {SCAN_ATOL} abs)")


def metrical_phase(tmp: str, batch) -> None:
    """The MetricalGNN family through both CLIs at full width, and the scan
    on the card."""
    score = f"{tmp}/metrical.musicxml"
    with open(score, "w") as f:
        f.write(synthetic_score_xml(METRICAL_NOTES, seed=22))
    for key, flags, label, train_route, serve_route in (
            ("node", METRICAL_FLAGS, "metrical trainer", NODE, NODE),
            ("rnn", METRICAL_RNN_FLAGS, "metrical trainer use_rnn edge-zxp", EDGE_TRAIN, EDGE_SERVE)):
        metrical_trainer(flags, label, f"{tmp}/metrical_{key}", train_route)
        metrical_serve(f"{tmp}/metrical_{key}", label, score, serve_route)
    scan_check(batch)


# ------------------------------------------------------------- bf16 compute


def check_k3_bf16(name: str, n: int, f: int, g: int, t: int, expect: str = "wgmma", misalign: str = "",
                  backward: bool = False) -> dict:
    """K3's bf16 forward against its plain version (the f32 einsum of the
    upcast operands), through the wrapper, which must take the ``expect``
    kernel (``relmm.forward_kernel``: ``"wgmma"``, or ``"f32"`` for the
    kernels on f32 copies) and launch it alone; ``misalign`` ("x" or "w")
    puts that operand 2 bytes off a 16-byte boundary.  With ``backward``:
    through the wrapper with autograd, the cotangents in the primals'
    dtypes against the plain version's."""
    from analysisgnn_tpu_torch.kernels import relmm

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(n * 11 + t)
    x = torch.randn(n, f, generator=gen).to(dev).bfloat16()
    w = (torch.randn(t, f, g, generator=gen) / f**0.5).to(dev).bfloat16()
    if misalign == "x":
        x = torch.empty(x.numel() + 1, dtype=torch.bfloat16, device=dev)[1:].view(x.shape).copy_(x)
    if misalign == "w":
        w = torch.empty(w.numel() + 1, dtype=torch.bfloat16, device=dev)[1:].view(w.shape).copy_(w)
    alpha = torch.rand(t, n, generator=gen).to(dev)
    kernel = relmm.forward_kernel(x, w)
    if kernel != expect:
        raise AssertionError(f"K3 bf16 {name}: the wrapper picks the {kernel} kernel, not {expect}")
    with route(f"K3 bf16 {name}", {K3_BF16} if expect == "wgmma" else {K3}):
        out = relmm.relation_weighted_matmul(x, w, alpha)
    ref = relmm.relation_weighted_matmul_plain(x, w, alpha)
    scale = relmm.relation_weighted_matmul_plain(x.abs(), w.abs(), alpha)  # the sum of |terms|
    torch.cuda.synchronize()
    if out.dtype != torch.float32 or out.shape != ref.shape or not torch.isfinite(out).all():
        raise AssertionError(f"K3 bf16 {name}: {out.dtype} {tuple(out.shape)} or non-finite values")
    err = (out - ref).abs()
    if not bool((err <= K3_BF16_RTOL * scale).all()):
        worst = float((err / scale.clamp_min(1e-30)).max())
        raise AssertionError(f"K3 bf16 {name}: |kernel - plain| reaches {worst:.3e} of the sum of |terms| "
                             f"(tol {K3_BF16_RTOL})")
    max_abs = float(err.max()) if err.numel() else 0.0
    rel = float((err / scale.clamp_min(1e-30)).max()) if err.numel() else 0.0
    line = (f"kernel check: K3 bf16 forward {name}: N={n} F={f} G={g} T={t}{f' {misalign} misaligned' * bool(misalign)}"
            f" -> {kernel} kernel, max|d| {max_abs:.2e}, {rel:.2e} of the sum of |terms| (tol {K3_BF16_RTOL})")
    if backward:
        gout = torch.randn(n, g, generator=gen).to(dev)
        leaves = [v.clone().requires_grad_(True) for v in (x, w, alpha)]
        grads = torch.autograd.grad(relmm.relation_weighted_matmul(*leaves), leaves, gout)
        plain_leaves = [v.clone().requires_grad_(True) for v in (x, w, alpha)]
        want = torch.autograd.grad(relmm.relation_weighted_matmul_plain(*plain_leaves), plain_leaves, gout)
        if tuple(gr.dtype for gr in grads) != (torch.bfloat16, torch.bfloat16, torch.float32):
            raise AssertionError(f"K3 bf16 {name}: cotangent dtypes {[gr.dtype for gr in grads]}")
        for part, a, b in zip(("dx", "dw", "dalpha"), grads, want):
            # the f32 backward kernels against the plain f32 gradients, both rounded to the primal's dtype
            tol = (2.0 ** -7 if a.dtype == torch.bfloat16 else 1e-4) * float(b.float().abs().max())
            if float((a.float() - b.float()).abs().max()) > tol:
                raise AssertionError(f"K3 bf16 {name} backward {part}: max|d| above {tol:.3e}")
        line += "; backward: cotangents bf16, bf16, f32 through the f32 kernels"
    phase(line)
    return {"case": name, "kernel": kernel, "max_abs_err": max_abs}


def k3_bf16_checks(n_train: int) -> list:
    rows = [check_k3_bf16("train shape", n_train, 256, 256, 7, backward=True)]
    # the wgmma kernel's tails: N not a multiple of the 128-row tile, one row, T=1, F short of or past the
    # 64-deep chunk, G not a multiple of WIDTH or of a 32-column box; then the operands TMA cannot describe,
    # which take the f32 kernels on upcast copies: F or G not a multiple of 8, an x or a w whose base is not
    # 16-byte aligned
    for name, n, f, g, t, expect, misalign in (
            ("N=300", 300, 256, 256, 7, "wgmma", ""), ("T=1", 1000, 256, 256, 1, "wgmma", ""),
            ("N=1", 1, 256, 256, 7, "wgmma", ""), ("F=64 G=96", 300, 64, 96, 3, "wgmma", ""),
            ("F=40 G=24", 77, 40, 24, 2, "wgmma", ""), ("F=72 G=200", 300, 72, 200, 7, "wgmma", ""),
            ("F=25 G=20", 65, 25, 20, 3, "f32", ""), ("F=256 G=20", 300, 256, 20, 7, "f32", ""),
            ("F=20 G=256", 300, 20, 256, 7, "f32", ""), ("x misaligned", 300, 256, 256, 7, "f32", "x"),
            ("w misaligned", 300, 256, 256, 7, "f32", "w")):
        rows.append(check_k3_bf16(name, n, f, g, t, expect=expect, misalign=misalign))
    return rows


def k1_batch_checks(batch) -> list:
    """K1 on f32 and on bf16 rows at the fused note layer of a bench train
    batch (the shape of check_k1_backward)."""
    from analysisgnn_tpu_torch.core.graph import NOTE, NOTE_EDGE_TYPES
    from analysisgnn_tpu_torch.models.fused import fused_plan

    n = batch.capacity(NOTE)
    plan = fused_plan([batch.edges(et) for et in NOTE_EDGE_TYPES], n)
    gen = torch.Generator(device="cpu").manual_seed(3)
    f = TRAIN_CFG["hidden_channels"]
    msgs = torch.randn(plan.seg.shape[0], f, generator=gen).cuda()
    x_base = torch.randn(n, f, generator=gen).cuda()
    return [check_k1("fused note layer T=7 of a bench batch", m, plan.seg, b, plan.num_segments, row_ptr=plan.row_ptr)
            for m, b in ((msgs, x_base), (msgs.bfloat16(), x_base.bfloat16()))]


def remat_phase() -> None:
    """One train step of the variants arm's model (full width, edge-zxp,
    dropout 0) on a whole 20,000-note score with beats, measures and random
    labels: its gradients with remat against those without, within
    REMAT_RTOL in PyTorch's deterministic mode (beside the card's spread
    between two runs without remat, and remat in the default mode); then one
    step of each through its route with a finite loss."""
    from analysisgnn_tpu_torch.core.graph import NOTE
    from analysisgnn_tpu_torch.data.note_array import synthetic_score
    from analysisgnn_tpu_torch.inference.predict import graph_from_note_array
    from analysisgnn_tpu_torch.models.analysis import model_from_config
    from analysisgnn_tpu_torch.theory.vocab import TASK_DICT
    from analysisgnn_tpu_torch.train.state import ClippedAdamW
    from analysisgnn_tpu_torch.train.step import StepConfig, compute_losses

    na = synthetic_score(REMAT_NOTES, seed=REMAT_NOTES)
    graph = graph_from_note_array(na, add_beats=True, add_measures=True, device="cuda")
    n = graph.capacity(NOTE)
    rng = np.random.default_rng(0)
    attrs = graph.node_attrs[NOTE]
    for task, n_cls in TASK_DICT.items():
        attrs[task] = torch.from_numpy(rng.integers(0, n_cls, n)).to("cuda")
    attrs["valid_label"] = torch.ones(n, dtype=torch.int64, device="cuda")
    base = _train_model("variants", 0.0, "cuda")
    cfg = StepConfig(task_dict=tuple(TASK_DICT.items()), active_tasks=tuple(TASK_DICT))
    arms = {}
    for remat in (False, True):
        model = model_from_config({**ARMS["variants"], "dropout": 0.0, "remat": remat}, device="cuda")
        model.load_state_dict(base.state_dict())
        arms[remat] = (model, *_trainer(model, ClippedAdamW(lambda _step: PARITY_LR)))
    del base

    def gradients(remat: bool) -> tuple:
        model, state, _ = arms[remat]
        total, feature, memory, _, _ = compute_losses(model, state.mt_params, graph, cfg, False, state.generator)
        loss = total + memory + cfg.lambda_featl * feature
        names = [name for name, _ in model.named_parameters()] + ["mt_params"]
        trainables = [*model.parameters(), state.mt_params]
        grads = torch.autograd.grad(loss, trainables, allow_unused=True)
        return float(loss.detach()), {k: torch.zeros_like(p) if g is None else g
                                      for k, p, g in zip(names, trainables, grads)}

    def compare(a: tuple, b: tuple) -> tuple:
        """(loss relative, gradients relative L2, the three parameters that
        differ most, relative L2 each)."""
        flat = lambda grads: torch.cat([g.reshape(-1) for g in grads.values()])
        rel = float((flat(a[1]) - flat(b[1])).norm() / flat(b[1]).norm())
        worst = sorted(((float((a[1][k] - v).norm() / v.norm().clamp_min(1e-30)), k) for k, v in b[1].items()),
                       reverse=True)[:3]
        return abs(a[0] - b[0]) / abs(b[0]), rel, worst

    # the card's run-to-run spread without remat (the gathers' backward adds with atomics, in no fixed order),
    # remat against it in that mode, then in PyTorch's deterministic mode, which holds remat to REMAT_RTOL
    plain = gradients(False)
    floor = compare(gradients(False), plain)
    loose = compare(gradients(True), plain)
    cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            exact = compare(gradients(True), gradients(False))
    finally:
        torch.use_deterministic_algorithms(False)
        if cublas is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas
    del plain
    loose_ops = sorted({str(w.message).split(".")[0][:120] for w in caught})
    show = lambda c: (f"loss rel {c[0]:.2e}, gradients {c[1]:.2e} relative L2 (most: "
                      + ", ".join(f"{k} {r:.1e}" for r, k in c[2]) + ")")
    phase(f"remat: gradients of one step on the whole {REMAT_NOTES}-note score: without remat twice {show(floor)}; "
          f"with remat against without {show(loose)}; in deterministic mode {show(exact)} (tol {REMAT_RTOL}); "
          f"ops without a deterministic version: {loose_ops or 'none'}")
    if not (exact[0] <= REMAT_RTOL and exact[1] <= REMAT_RTOL):
        raise AssertionError(f"remat in deterministic mode: loss rel {exact[0]:.2e}, gradients {exact[1]:.2e} "
                             f"relative L2 (tol {REMAT_RTOL})")
    for remat, (model, state, step) in arms.items():
        with route(f"remat={remat}: a step", EDGE_TRAIN) as launched:
            state, aux = step(state, graph)
        if not np.isfinite(float(aux["total_loss"])):
            raise AssertionError(f"remat={remat}: loss {float(aux['total_loss'])}")
        phase(f"remat: one train step on the whole {REMAT_NOTES}-note score ({n} note rows) with remat={remat}: "
              f"launched {launched}, loss {float(aux['total_loss']):.4f}")


# ------------------------------------------------- pre-training and the layer zoo


def _with_voice_staff(batch, seed: int):
    """The batch with seeded voice and staff attributes in {1, 2} (the
    sampler does not carry them)."""
    from analysisgnn_tpu_torch.core.graph import NOTE

    rng = np.random.default_rng(seed)
    n = batch.capacity(NOTE)
    dev = batch.node_features[NOTE].device
    attrs = dict(batch.node_attrs[NOTE])
    for name in ("voice", "staff"):
        attrs[name] = torch.from_numpy(rng.integers(1, 3, n)).to(dev)
    return dataclasses.replace(batch, node_attrs={**batch.node_attrs, NOTE: attrs})


def _pre_encoder(device: str):
    from analysisgnn_tpu_torch.core.graph import metadata
    from analysisgnn_tpu_torch.models.analysis import init_parameters
    from analysisgnn_tpu_torch.models.pre_encoder import PreEncoder

    nodes, edges = metadata(True, True)
    model = PreEncoder(TRAIN_CFG["in_channels"], PRETRAIN["hidden"], nodes, edges, PRETRAIN["num_layers"],
                       PRETRAIN["heads"])
    init_parameters(model, torch.Generator(device="cpu").manual_seed(0))
    return model.to(device)


def _pretrain_optimizer(lr: float, eps: float = 1e-8):
    from analysisgnn_tpu_torch.train.state import ClippedAdamW

    return ClippedAdamW(lambda _count: lr, eps=eps, weight_decay=PRETRAIN_WEIGHT_DECAY, clip_norm=None)



def pretrain_phase(batches: list, parity_batch):
    """The PreEncoder's pretrain step at full width on the bench's batches:
    no hand-written kernel launched (the HGT of ``pair`` without K2 and the
    heads are PyTorch ops), finite losses that fall over FALL_STEPS steps on
    one batch after a warm-up on another; then one dropout-0 step on the
    GPU against the CPU.  The pre-trained model."""
    from analysisgnn_tpu_torch.train.pretrain import make_pretrain_step

    batches = [_with_voice_staff(b, i) for i, b in enumerate(batches[:2])]
    model = _pre_encoder("cuda")
    opt = _pretrain_optimizer(PRETRAIN_LR)
    state = opt.init(list(model.parameters()))
    step = make_pretrain_step(model, opt)
    gen = torch.Generator(device="cuda").manual_seed(1)
    fall = []
    with route("the pretrain step", set()):
        state, losses = step(state, batches[1], gen)  # warm-up
        for _ in range(FALL_STEPS):
            state, losses = step(state, batches[0], gen)
            fall.append(float(losses["total"]))
    if not all(np.isfinite(float(v)) for v in losses.values()) or not fall[-1] < fall[0]:
        raise AssertionError(f"pretrain: losses {losses}; the loss did not fall over {FALL_STEPS} steps on one "
                             f"batch: {fall}")
    phase(f"pretrain: PreEncoder HybridHGT pair {PRETRAIN['num_layers']}x{PRETRAIN['hidden']}, {PRETRAIN['heads']} "
          f"heads, JK, {sum(p.numel() for p in model.parameters())} parameters: no hand-written kernel launched; "
          f"losses " + ", ".join(f"{k} {float(v):.4f}" for k, v in losses.items())
          + f"; {FALL_STEPS} steps on one batch: total {fall[0]:.4f} -> {fall[-1]:.4f}")

    # one dropout-0 step on the GPU against the CPU, the same weights and batch
    pb = _with_voice_staff(parity_batch, 0)
    out = {}
    for label, dev, b in (("gpu", "cuda", pb), ("cpu", "cpu", pb.to("cpu"))):
        m = _pre_encoder(dev)
        m.load_state_dict({k: v.to(dev) for k, v in model.state_dict().items()})
        o = _pretrain_optimizer(PARITY_LR, PARITY_EPS)
        st, l = make_pretrain_step(m, o)(o.init(list(m.parameters())), b)
        out[label] = ({k: float(v) for k, v in l.items()}, {k: v.detach().cpu() for k, v in m.state_dict().items()})
    (lg, pg), (lc, pc) = out["gpu"], out["cpu"]
    rels = {k: abs(lg[k] - lc[k]) / abs(lc[k]) for k in lc}
    worst = max(float((pg[k] - pc[k]).abs().max()) for k in pc)
    if max(rels.values()) > PARITY_LOSS_RTOL or worst > PARITY_PARAM_ATOL:
        raise AssertionError(f"pretrain step GPU vs CPU: losses rel {rels} (tol {PARITY_LOSS_RTOL}), parameters "
                             f"max|d| {worst:.3e} (tol {PARITY_PARAM_ATOL})")
    phase(f"pretrain: one step GPU vs CPU (dropout 0, lr {PARITY_LR}, eps {PARITY_EPS}, a batch of {PARITY_BATCH}): "
          f"total {lg['total']:.6f} vs {lc['total']:.6f}, losses rel max {max(rels.values()):.2e} (tol "
          f"{PARITY_LOSS_RTOL}); every parameter max|d| {worst:.3e} (tol {PARITY_PARAM_ATOL} abs)")
    return model


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _zoo_case(name: str, make, run, batch, want) -> None:
    """One zoo module on the card and on the CPU with the same weights and
    inputs: forward and backward of a seeded cotangent (0 on padding rows);
    the card's forward through the route ``want``, the note rows' output
    within ZOO_RTOL of its largest |value|, every row finite, the parameters'
    and the input's gradients within ZOO_GRAD_RTOL in relative L2."""
    from analysisgnn_tpu_torch.core.graph import NOTE
    from analysisgnn_tpu_torch.models.analysis import init_parameters

    cpu = make()
    init_parameters(cpu, torch.Generator(device="cpu").manual_seed(0))
    gpu = make().cuda()
    gpu.load_state_dict(cpu.state_dict())
    res = {}
    notes = (batch.batch[NOTE] >= 0).cpu()
    cot = torch.randn(batch.capacity(NOTE), ZOO_HIDDEN, generator=torch.Generator(device="cpu").manual_seed(1))
    cot = cot * notes[:, None]
    for label, m, b in (("gpu", gpu, batch), ("cpu", cpu, batch.to("cpu"))):
        with route(f"zoo {name}: the forward on the {label}", want if m is gpu else set()) as launched:
            x, out = run(m, b)  # x: the note features, with requires_grad
        if not torch.isfinite(out).all():
            raise AssertionError(f"zoo {name}: non-finite output on the {label}")
        if m is gpu:
            forward_launched = launched
        (out * cot.to(out.device)).sum().backward()
        # the last HResGatedConv layer's beat and measure relations do not reach the note states: no gradient
        grads = torch.cat([x.grad.flatten()] + [p.grad.flatten() if p.grad is not None else p.new_zeros(p.numel())
                                                for p in m.parameters()]).cpu()
        res[label] = (out.detach().cpu()[notes], grads)
    (og, gg), (oc, gc) = res["gpu"], res["cpu"]
    err = float((og - oc).abs().max())
    scale = float(oc.abs().max())
    grad_rel = _rel_l2(gg, gc)
    if err > ZOO_RTOL * scale or grad_rel > ZOO_GRAD_RTOL:
        raise AssertionError(f"zoo {name}: GPU vs CPU note rows max|d| {err:.3e} of max|out| {scale:.3e} (tol "
                             f"{ZOO_RTOL} relative), gradients {grad_rel:.3e} relative L2 (tol {ZOO_GRAD_RTOL})")
    phase(f"zoo {name}: out {tuple(out.shape)}, the forward launched {forward_launched}, GPU vs CPU note rows max|d| "
          f"{err:.3e} of max|out| {scale:.3e} (tol {ZOO_RTOL} relative), gradients {grad_rel:.3e} relative L2 (tol "
          f"{ZOO_GRAD_RTOL})")


def zoo_phase(batch) -> None:
    """HResGatedConv (3 layers, 13 relations), HGPS (2 layers, 4 heads, the
    dense [4, N, N] masked attention over the batch's note rows),
    OnsetEmbedding and GATConv (3 heads) on the onset relation, at width 256
    on one bench batch: each through its route, GPU against CPU."""
    from analysisgnn_tpu_torch.core.graph import NOTE, metadata
    from analysisgnn_tpu_torch.models.conv import GATConv, sage_plan
    from analysisgnn_tpu_torch.models.extra_layers import HGPS, HResGatedConv, OnsetEmbedding

    nodes, edges = metadata(True, True)
    f_in = TRAIN_CFG["in_channels"]
    n = batch.capacity(NOTE)
    onset = (NOTE, "onset", NOTE)

    def leaf(b):
        return {t: v.clone().requires_grad_(t == NOTE) for t, v in b.node_features.items()}

    def run_hres(m, b):
        x = leaf(b)
        return x[NOTE], m(x, m.plan(b.edge_index, {t: v.shape[0] for t, v in x.items()}))

    def run_hgps(m, b):
        x = leaf(b)
        return x[NOTE], m(x, m.plan(b.edge_index, n), b.batch, valid=b.batch[NOTE] >= 0)

    def run_single(m, b):
        x = leaf(b)[NOTE]
        return x, m(x, sage_plan(b.edges(onset), n, n))

    # ResGatedConv (HResGatedConv's layers, HGPS's local branch) and GATConv sum through K4; OnsetEmbedding
    # pools through K1
    _zoo_case(f"HResGatedConv {HRES_LAYERS}x{ZOO_HIDDEN}", lambda: HResGatedConv(f_in, ZOO_HIDDEN, nodes, edges,
                                                                                  HRES_LAYERS), run_hres, batch, {K4})
    _zoo_case(f"HGPS {HGPS_LAYERS}x{ZOO_HIDDEN}, {HGPS_HEADS} heads, attention over {n} note rows",
              lambda: HGPS(f_in, ZOO_HIDDEN, edges, HGPS_LAYERS, HGPS_HEADS), run_hgps, batch, {K4})
    _zoo_case(f"OnsetEmbedding {ZOO_HIDDEN}", lambda: OnsetEmbedding(f_in, ZOO_HIDDEN), run_single, batch, NODE)
    _zoo_case(f"GATConv {ZOO_HIDDEN}, {GAT_HEADS} heads, onset relation", lambda: GATConv(f_in, ZOO_HIDDEN, GAT_HEADS),
              run_single, batch, {K4})


def check_k4_plan(batch) -> dict:
    """K4 through a SegmentPlan (segment_sum_plan, the models' form) against
    its plain version within K4_RTOL and its gradient against the plain
    gradient (each sorted edge takes its segment's row, padding 0), on a
    ResGatedConv relation with its padding edges; then, at the fused note
    layer's sorted valid edges, the plan call equal to the call that builds
    its row pointers."""
    from analysisgnn_tpu_torch.core.graph import NOTE, NOTE_EDGE_TYPES
    from analysisgnn_tpu_torch.kernels.segment_mean import SegmentPlan, row_pointers
    from analysisgnn_tpu_torch.kernels.segment_ops import dummy_row_ids
    from analysisgnn_tpu_torch.kernels.segment_sum import segment_sum_plan, segment_sum_sorted, \
        segment_sum_sorted_plain
    from analysisgnn_tpu_torch.models.conv import sage_plan
    from analysisgnn_tpu_torch.models.fused import fused_plan

    gen = torch.Generator(device="cpu").manual_seed(27)
    n = batch.capacity(NOTE)
    f = ZOO_HIDDEN
    plan = sage_plan(batch.edges((NOTE, "consecutive", NOTE)), n, n)
    msgs = torch.randn(plan.seg.shape[0], f, generator=gen).cuda().requires_grad_()
    g = torch.randn(n, f, generator=gen).cuda()
    out = segment_sum_plan(msgs, plan)
    ref = segment_sum_sorted_plain(msgs.detach(), plan.seg, n)
    scale = segment_sum_sorted_plain(msgs.detach().abs(), plan.seg, n)
    (out * g).sum().backward()
    want_grad = torch.cat([g, g.new_zeros((1, f))])[dummy_row_ids(plan.seg, n)]
    torch.cuda.synchronize()
    err = (out.detach() - ref).abs()
    padding = int((plan.seg >= n).sum())
    if not bool((err <= K4_RTOL * scale).all()) or not torch.equal(msgs.grad, want_grad):
        raise AssertionError(f"K4 plan call: max|kernel - plain| {float(err.max()):.3e} (tol {K4_RTOL} of the sum of "
                             f"|terms|) or a gradient unequal to the plain one")
    fplan = fused_plan([batch.edges(et) for et in NOTE_EDGE_TYPES], n)
    dst = fplan.seg[fplan.seg.long() < fplan.num_segments].contiguous()
    s = fplan.num_segments
    tplan = SegmentPlan(gather=torch.arange(dst.shape[0], device=dst.device), seg=dst, num_segments=s, base_rows=s,
                        row_ptr=row_pointers(dst, s))
    tm = torch.randn(dst.shape[0], f, generator=gen).cuda()
    if not torch.equal(segment_sum_plan(tm, tplan), segment_sum_sorted(tm, dst, s)):
        raise AssertionError("K4: the plan call and the searchsorted call differ on the same inputs")
    phase(f"kernel check: K4 plan call on the consecutive relation (E={plan.seg.shape[0]}, {padding} padding, F={f}, "
          f"n={n}): max|d| {float(err.max()):.3e} (tol {K4_RTOL} of the sum of |terms|), gradient equal to the "
          f"plain one; at E={dst.shape[0]} F={f} n={s} the plan call equal to the searchsorted call")
    return {"max_abs_err": float(err.max())}


@torch.no_grad()
def unet_phase() -> None:
    """UNet((32, 64, 128), out 1) on [8, 88, 256, 1] images on the card
    against the CPU."""
    from analysisgnn_tpu_torch.models.analysis import init_parameters
    from analysisgnn_tpu_torch.models.unet import UNet

    cpu = UNet(UNET_SHAPE[-1], UNET_FEATURES, out_channels=1)
    init_parameters(cpu, torch.Generator(device="cpu").manual_seed(0))
    gpu = UNet(UNET_SHAPE[-1], UNET_FEATURES, out_channels=1).cuda()
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(UNET_SHAPE, generator=torch.Generator(device="cpu").manual_seed(2))
    want = cpu(x)
    got = gpu(x.cuda()).cpu()
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    if got.shape != UNET_SHAPE or not torch.isfinite(got).all() or err > UNET_RTOL * scale:
        raise AssertionError(f"UNet: shape {tuple(got.shape)}, GPU vs CPU max|d| {err:.3e} of max|out| {scale:.3e} "
                             f"(tol {UNET_RTOL} relative)")
    phase(f"UNet{UNET_FEATURES} on {list(UNET_SHAPE)}: GPU vs CPU max|d| {err:.3e} of max|out| {scale:.3e} (tol "
          f"{UNET_RTOL} relative)")


def fidelity_voices_phase(pre_encoder) -> None:
    """hetero_fidelity of the serve model (phase 4's weights) on a
    FID_NOTES-note request with a seeded mask keeping half of each
    note -> note relation's edges, GPU against CPU (fid values equal except
    where an argmax has two logits within LOGIT_ATOL), the card's three
    forwards through K1; then the pretrained PreEncoder's voice links with a
    logit above 0 through voice_from_edges, pianoroll_svg and graph_to_json,
    and GraphSampler and the Laplacian positional encoding on the host."""
    from analysisgnn_tpu_torch.core.graph import NOTE
    from analysisgnn_tpu_torch.data.graph_sampling import GraphSampler
    from analysisgnn_tpu_torch.data.note_array import synthetic_score
    from analysisgnn_tpu_torch.inference.predict import graph_from_note_array
    from analysisgnn_tpu_torch.models.analysis import SERVE_CONFIG, init_parameters, model_from_config
    from analysisgnn_tpu_torch.train.pretrain import pretrain_candidates
    from analysisgnn_tpu_torch.utils.explain import hetero_fidelity
    from analysisgnn_tpu_torch.utils.graph_utils import laplacian_positional_encoding, voice_from_edges
    from analysisgnn_tpu_torch.utils.visualization import graph_to_json, pianoroll_svg

    na = synthetic_score(FID_NOTES, seed=FID_NOTES)
    models = {}
    for label, dev in (("gpu", "cuda"), ("cpu", "cpu")):
        m = model_from_config(SERVE_CONFIG, device=dev).eval()
        init_parameters(m, torch.Generator(device="cpu").manual_seed(0))  # the serve phase's weights
        models[label] = m
    rng = np.random.default_rng(FID_NOTES)
    tasks = [t for t, _ in models["gpu"].task_dict]
    fids, logits_seen = {}, {}
    for label, m in models.items():
        dev = next(m.parameters()).device
        g = graph_from_note_array(na, add_beats=False, add_measures=False, bucket_factor=BUCKET_FACTOR, device=dev)
        if label == "gpu":
            n_cap = g.capacity(NOTE)
            masks_np = {et: rng.random(ei.shape[1]) < 0.5 for et, ei in g.edge_index.items()}
            labels_np = {t: rng.integers(0, c, n_cap) for t, c in m.task_dict}
        a = g.node_attrs[NOTE]
        seen = []

        @torch.no_grad()
        def logits_fn(ei, m=m, g=g, a=a, seen=seen):
            out = m(g.node_features, ei, a["pitch_spelling"], a["key_signature"], g.num_target_nodes)
            seen.append({k: v.float().cpu() for k, v in out.items()})
            return out

        to = lambda d: {k: torch.from_numpy(v).to(dev) for k, v in d.items()}
        with route(f"hetero_fidelity on the {label}", NODE if label == "gpu" else set()) as launched:
            fids[label] = hetero_fidelity(logits_fn, g.edge_index, to(masks_np), to(labels_np), g.target_mask(),
                                          {NOTE: g.capacity(NOTE)})
        if label == "gpu":
            gpu_launched = launched
        logits_seen[label] = seen
    if len(logits_seen["gpu"]) != 3:
        raise AssertionError(f"hetero_fidelity ran {len(logits_seen['gpu'])} forwards, not 3")
    weight = (torch.arange(n_cap) < FID_NOTES).float()
    denom = float(weight.sum())
    worst = 0.0
    for task in tasks:
        ties = 0  # weighted rows where a forward's CPU top two logits lie within LOGIT_ATOL
        for fwd_g, fwd_c in zip(logits_seen["gpu"], logits_seen["cpu"]):
            worst = max(worst, float((fwd_g[task] - fwd_c[task]).abs().max()))
            top2 = fwd_c[task].topk(2, dim=-1).values
            ties += int(((top2[:, 0] - top2[:, 1] <= LOGIT_ATOL) & (weight > 0)).sum())
        for k in (0, 1):
            d = abs(float(fids["gpu"][k][task]) - float(fids["cpu"][k][task])) * denom
            if d > ties + 1e-3:
                raise AssertionError(f"hetero_fidelity {task}: fid {'+-'[k]} GPU {float(fids['gpu'][k][task])} vs "
                                     f"CPU {float(fids['cpu'][k][task])} on {d:.1f} rows, {ties} near ties")
    if worst > LOGIT_ATOL:
        raise AssertionError(f"hetero_fidelity: GPU vs CPU logits differ by {worst:.3e} > {LOGIT_ATOL}")
    fid_plus = [float(v) for v in fids["gpu"][0].values()]
    fid_minus = [float(v) for v in fids["gpu"][1].values()]
    phase(f"fidelity: hetero_fidelity of the serve model on a {FID_NOTES}-note request, half of each note -> note "
          f"relation's edges kept: three forwards, launched {gpu_launched}; GPU vs CPU logits max|d| {worst:.3e}, "
          f"every fid equal but for near ties; fid+ mean {statistics.mean(fid_plus):.4f}, fid- mean "
          f"{statistics.mean(fid_minus):.4f} over {len(tasks)} tasks")
    del models

    # the pretrained PreEncoder's voice links on the same score, with beats and measures
    g = graph_from_note_array(na, bucket_factor=BUCKET_FACTOR, device="cuda")
    g = dataclasses.replace(g, node_attrs={NOTE: {**g.node_attrs[NOTE], "voice": torch.ones_like(
        g.node_attrs[NOTE]["pitch_spelling"]), "staff": torch.ones_like(g.node_attrs[NOTE]["pitch_spelling"])}})
    cand = pretrain_candidates(g)
    capacities = {tt: v.shape[0] for tt, v in g.node_features.items()}
    with torch.no_grad():
        _, voice_logits, _, _ = pre_encoder(g.node_features, pre_encoder.plan(g.edge_index, capacities),
                                            cand["staff"], cand["voice"])
    links = cand["voice"][:, (voice_logits > 0) & cand["voice_valid"]].cpu().numpy()
    voices, n_voices = voice_from_edges(links, FID_NOTES)
    predicted = na.copy()
    predicted["voice"] = voices
    svg = pianoroll_svg(predicted)
    host_edges = {et: g.edge_index[et][:, :g.num_edges[et]].cpu().numpy() for et in g.edge_index
                  if et[0] == et[2] == NOTE}
    js = graph_to_json(na, host_edges, {"voice_pred": voices.tolist()})
    if not (svg.startswith("<svg") and svg.count("<rect") == FID_NOTES + 1 and len(json.loads(js)["nodes"]) == FID_NOTES
            and 1 <= n_voices <= FID_NOTES and voices.min() == 1):
        raise AssertionError(f"voices: {n_voices} voices, an SVG of {svg.count('<rect')} rects, a JSON graph")
    cons = host_edges[(NOTE, "consecutive", NOTE)]
    sel, sub = GraphSampler(cons, FID_NOTES, seed=0).sample_node_induced(num_seeds=32, walk_length=16)
    pe = laplacian_positional_encoding(np.concatenate(list(host_edges.values()), axis=1), FID_NOTES, LAP_PE_K)
    if pe.shape != (FID_NOTES, LAP_PE_K) or not np.isfinite(pe).all() or len(sel) == 0:
        raise AssertionError(f"Laplacian encoding {pe.shape} or an empty sampled subgraph")
    phase(f"voices: the pretrained PreEncoder's {links.shape[1]} voice links with a logit above 0 of "
          f"{int(cand['voice_valid'].sum())} candidates -> {n_voices} voices by voice_from_edges; pianoroll_svg "
          f"{len(svg)} bytes, graph_to_json {len(js)} bytes; GraphSampler.sample_node_induced {len(sel)} notes, "
          f"{sub.shape[1]} edges; laplacian_positional_encoding k={LAP_PE_K} of shape {pe.shape}")


def zoo_and_pretrain(batches: list, parity_batch) -> dict:
    """Pre-training, the layer zoo, UNet, fidelity and voices."""
    pre = pretrain_phase(batches, parity_batch)
    k4 = check_k4_plan(batches[0])
    zoo_phase(batches[0])
    unet_phase()
    fidelity_voices_phase(pre)
    return {"k4_plan": k4}


# ------------------------------------------- across cards (python3 chip_smoke.py --cards 4), phases (a)-(d)

CARDS_NOTES = (20000, 100000)  # phase (c)'s requests: the partitioned-serve score, then one five times as long
CARDS_PARTITIONS = 4  # partitions of phase (c)'s line: one a card on 4 cards
CARDS_SLOTS = 2  # data slots a rank of the dry run: data 2 x 2 slots x model 2 on 4 ranks, the logical
# configuration of JAX's 8-device run (MULTICHIP_r05.json: data 4, model 2)
CARDS_TIMEOUT_S = 600.0  # the NCCL ranks' deadline and their groups' timeout: it covers rank 0's replay


def _sync_cards(cards: int) -> None:
    for k in range(cards):
        torch.cuda.synchronize(k)


def _k1_on_each_card(label: str, before: dict, cards: int) -> list:
    """K1's launches on each card since ``before`` (a copy of
    ``launches_by_device``): every card launched K1, as often as the others,
    and nothing else."""
    grown = _grown(before)
    per_card = [grown.get((K1, k), 0) for k in range(cards)]
    if set(grown) != {(K1, k) for k in range(cards)} or len(set(per_card)) != 1:
        raise AssertionError(f"{label}: launched {grown}, not K1 alone and as often on each of {cards} cards")
    return per_card


def cards_environment(cards: int) -> str:
    """Phase (a): every card's name and power limit, the peer-access matrix
    and ``nvidia-smi topo -m``; fails unless ``cards`` cards are visible."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this check needs NVIDIA GPUs")
    count = torch.cuda.device_count()
    if count < cards:
        raise SystemExit(f"chip_smoke --cards {cards}: {count} CUDA device(s) visible, this mode needs {cards}")
    smi = environment()
    lines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    for k, line in enumerate(lines):
        phase(f"cards: card {k}: nvidia-smi name,power.limit = {line}")
    rows = ["".join("-" if i == j else "y" if torch.cuda.can_device_access_peer(i, j) else "n" for j in range(count))
            for i in range(count)]
    phase(f"cards: peer access, card i (row) to card j's memory (column): {' '.join(rows)}")
    topo = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True, timeout=60)
    for line in (topo.stdout or topo.stderr).splitlines():
        if line.strip():
            phase(f"cards: nvidia-smi topo -m: {line.rstrip()}")
    if torch.cuda.current_device() != 0:
        raise AssertionError(f"the process's current card is {torch.cuda.current_device()}, not 0")
    return smi


def _held(name: str, card: int, got, want, scale, rtol: float) -> float:
    """``got`` (a kernel's, on ``card``) within ``rtol`` of ``scale`` (the sum
    of |terms|) of ``want`` (its plain version's, on the same card)."""
    if got.device != torch.device("cuda", card) or got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name} on card {card}: {got.device} {tuple(got.shape)} against {tuple(want.shape)}, "
                             f"or non-finite values")
    err = (got - want).abs()
    if not bool((err <= rtol * scale).all()):
        raise AssertionError(f"{name} on card {card}: |kernel - plain| up to {float(err.max()):.3e}, beyond {rtol} "
                             f"of the sum of |terms|")
    return float(err.max())



def card_kernel_checks(cards: int) -> dict:
    """Phase (b): every kernel launched on every card from this process, whose
    current card stays 0 (``kernels/launch.py`` enters the others), held
    against its plain version on the same card, every launch counted on its
    card (``launch.launches_by_device``): K1, K4, K5, K6 (allocating and
    planned), K2, K3's f32 forward, dx, dw and d alpha, and its bf16 forward
    (wgmma)."""
    from analysisgnn_tpu_torch.kernels import launch, relmm
    from analysisgnn_tpu_torch.kernels.halo import HaloPlan, halo_pull, halo_pull_plain
    from analysisgnn_tpu_torch.kernels.segment_mean import segment_mean_base, segment_mean_base_plain
    from analysisgnn_tpu_torch.kernels.segment_softmax import segment_softmax_sorted, segment_softmax_sorted_plain
    from analysisgnn_tpu_torch.kernels.segment_sum import segment_sum_sorted, segment_sum_sorted_plain
    from analysisgnn_tpu_torch.kernels.softmax_agg import (
        plan_softmax_agg, segment_softmax_agg, segment_softmax_agg_plain,
    )

    gen = torch.Generator(device="cpu").manual_seed(22)
    e, f, s, m, h, n, t = 20000, 256, 4000, 1000, 4, 3000, 7
    host = {"seg": torch.randint(0, s + s // 10, (e,), generator=gen).sort().values.int(),  # ids past s: padding
            "msgs": torch.randn(e, f, generator=gen), "base": torch.randn(m, f, generator=gen),
            "logits": torch.randn(e, h, generator=gen),
            "block": torch.randint(0, 3, (e,), generator=gen).sort().values,
            "x_parts": torch.randn(4, 2500, f, generator=gen),
            "x": torch.randn(n, f, generator=gen), "w": torch.randn(t, f, f, generator=gen) / f**0.5,
            "alpha": torch.rand(t, n, generator=gen), "gout": torch.randn(n, f, generator=gen)}
    rows = {}
    for k in range(cards):
        dev = torch.device("cuda", k)
        a = {key: v.to(dev) for key, v in host.items()}
        before = dict(launch.launches_by_device)
        errs = {}
        out, _ = segment_mean_base(a["msgs"], a["seg"], a["base"], s)
        errs["K1"] = _held("K1", k, out, segment_mean_base_plain(a["msgs"], a["seg"], a["base"], s)[0],
                           segment_mean_base_plain(a["msgs"].abs(), a["seg"], a["base"].abs(), s)[0], K1_RTOL)
        errs["K4"] = _held("K4", k, segment_sum_sorted(a["msgs"], a["seg"], s),
                           segment_sum_sorted_plain(a["msgs"], a["seg"], s),
                           segment_sum_sorted_plain(a["msgs"].abs(), a["seg"], s), K4_RTOL)
        errs["K5"] = _held("K5", k, segment_softmax_sorted(a["logits"], a["seg"], s),
                           segment_softmax_sorted_plain(a["logits"], a["seg"], s), 1.0, K5_ATOL)
        plan = plan_softmax_agg(a["seg"], a["block"], s, 3)  # H = 4 heads of 64 over the 256 columns
        errs["K2"] = _held("K2", k, segment_softmax_agg(a["logits"], a["msgs"], plan),
                           segment_softmax_agg_plain(a["logits"], a["msgs"], plan),
                           segment_softmax_agg_plain(a["logits"], a["msgs"].abs(), plan), K2_RTOL)
        halos = halo_pull(a["x_parts"], 24)
        hplan = HaloPlan(a["x_parts"], 24)
        planned = halo_pull(a["x_parts"], 24, out=torch.full(hplan.out_shape, float("nan"), device=dev), plan=hplan)
        want = halo_pull_plain(a["x_parts"], 24)
        if not (torch.equal(halos, want) and torch.equal(planned, want)):
            raise AssertionError(f"K6 on card {k}: the halos differ from the plain version's")
        leaves = [a[key].clone().requires_grad_(True) for key in ("x", "w", "alpha")]
        out = relmm.relation_weighted_matmul(*leaves)
        got = (out.detach(), *torch.autograd.grad(out, leaves, a["gout"]))
        plain = [a[key].clone().requires_grad_(True) for key in ("x", "w", "alpha")]
        ref = relmm.relation_weighted_matmul_plain(*plain)
        ref = (ref.detach(), *torch.autograd.grad(ref, plain, a["gout"]))
        absl = [a[key].abs().requires_grad_(True) for key in ("x", "w", "alpha")]
        sc = relmm.relation_weighted_matmul_plain(*absl)
        sc = (sc.detach(), *torch.autograd.grad(sc, absl, a["gout"].abs()))
        for part, g_, r_, c_ in zip(("forward", "dx", "dw", "dalpha"), got, ref, sc):
            errs[f"K3 {part}"] = _held(f"K3 {part}", k, g_, r_, c_, K3_RTOL)
        xb, wb = a["x"].bfloat16(), a["w"].bfloat16()
        if relmm.forward_kernel(xb, wb) != "wgmma":
            raise AssertionError(f"K3 bf16 on card {k}: the wrapper would not take the wgmma kernel")
        errs["K3 bf16"] = _held("K3 bf16", k, relmm.relation_weighted_matmul(xb, wb, a["alpha"]),
                                relmm.relation_weighted_matmul_plain(xb, wb, a["alpha"]),
                                relmm.relation_weighted_matmul_plain(xb.abs(), wb.abs(), a["alpha"]), K3_BF16_RTOL)
        torch.cuda.synchronize(k)
        grown = _grown(before)
        launched = {sym: c for (sym, i), c in grown.items() if i == k}
        elsewhere = {key: c for key, c in grown.items() if key[1] != k}
        # K1 and K4 build their row pointers without a plan (searchsorted, no kernel of ours); K6 twice
        want_launched = {K1: 1, K4: 1, K5: 1, K2: 1, K6: 2, K3: 1, K3_DX: 1, K3_DW: 1, K3_DALPHA: 1, K3_BF16: 1}
        if launched != want_launched or elsewhere:
            raise AssertionError(f"card {k}: launched {launched} there (expected {want_launched}) and {elsewhere} "
                                 f"on other cards")
        rows[k] = {"max_abs_err": errs, "launched": launched}
        phase(f"cards: kernel check on card {k} from current card {torch.cuda.current_device()}: "
              + ", ".join(f"{name} max|d| {v:.2e}" for name, v in errs.items())
              + f"; K6 bit-equal in both forms; launched on card {k} as expected ("
              + ", ".join(f"{sym} {c}" for sym, c in launched.items()) + "), none on another card")
    return rows


def _window_k1(model, host: dict) -> dict:
    """K1 on card 0 at the fused note layer of the first window of phase
    (c)'s 20,000-note line (the shape each card's first layer gives it),
    against its plain version."""
    from analysisgnn_tpu_torch.core.graph import NOTE
    from analysisgnn_tpu_torch.distributed.partition_encoder import partition_full_graph
    from analysisgnn_tpu_torch.models.hetero import plan_hetero

    part = partition_full_graph(host["x"], host["ps"], host["ks"], host["edges"], CARDS_PARTITIONS,
                                len(model.encoder.layers) + 2)
    edges = {et: torch.from_numpy(v[0]).long().cuda() for et, v in part.edge_index.items()}
    fused = plan_hetero(edges, model.edge_types, {NOTE: part.n_ext})[NOTE]
    gen = torch.Generator(device="cpu").manual_seed(5)
    f = model.encoder.final.fused[NOTE].w_neigh.shape[1]
    msgs = torch.randn(fused.seg.shape[0], f, generator=gen).cuda()
    x_base = torch.randn(fused.base_rows, f, generator=gen).cuda()
    return check_k1(f"fused note layer of a {part.n_ext}-row window", msgs, fused.seg, x_base, fused.num_segments,
                    row_ptr=fused.row_ptr)


@torch.no_grad()
def cards_serve(cards: int, tmp: str) -> dict:
    """Phase (c): the serve model (phase 4's weights) on the partitioned-serve
    phase's 20,000-note score and on a 100,000-note one through
    CARDS_PARTITIONS partitions spread over the cards
    (``predict_score_partitioned``'s default: the visible cards) against the
    one-card line (the same partitions on card 0): ids equal, probabilities
    within the partitioned-serve tolerance, K1 alone and as often on every
    card; the embeddings of the spread against the single-window encode;
    then ``cli.predict.main --partition_devices`` against the one-card
    line's CSV.  K1's worst error at a window's fused layer."""
    from analysisgnn_tpu_torch.cli.predict import main as predict_main
    from analysisgnn_tpu_torch.data.musicxml import load_score
    from analysisgnn_tpu_torch.data.note_array import synthetic_score
    from analysisgnn_tpu_torch.distributed.partition_encoder import spread_devices, visible_devices
    from analysisgnn_tpu_torch.inference.predict import (
        decode_predictions, export_predictions_csv, predict_score_ids, predict_score_partitioned,
    )
    from analysisgnn_tpu_torch.kernels.launch import launches_by_device
    from analysisgnn_tpu_torch.models.analysis import SERVE_CONFIG as CFG
    from analysisgnn_tpu_torch.models.analysis import init_parameters, model_from_config

    model = model_from_config(CFG, device="cuda").eval()
    init_parameters(model, torch.Generator(device="cpu").manual_seed(0))  # phase 4's weights
    spread = spread_devices(CARDS_PARTITIONS, visible_devices("cuda"))
    one = spread[:1]
    if len(spread) != cards:
        raise AssertionError(f"{CARDS_PARTITIONS} partitions spread over {spread}, not over {cards} cards")
    launches_by_card = {}
    for notes in CARDS_NOTES:
        na = synthetic_score(notes, seed=PART_SEED)

        def serve(devs, ids_only=True):
            return predict_score_partitioned(model, na, num_devices=CARDS_PARTITIONS, ids_only=ids_only,
                                             device="cuda", devices=devs)

        before = dict(launches_by_device)
        ids = serve(spread)  # the first request over the cards: the replicas are made in the first of them
        _sync_cards(cards)
        per_card = _k1_on_each_card(f"{notes} notes over {cards} cards", before, cards)
        launches_by_card[notes] = per_card
        line = serve(one)
        _sync_cards(cards)
        if set(ids) != set(line) or not all(np.array_equal(ids[k], line[k]) for k in line):
            raise AssertionError(f"{notes} notes: the ids over {cards} cards differ from the one-card line's")
        ref = predict_score_ids(model, na, add_beats=False, add_measures=False, device="cuda")
        differing = sum(int((ids[k] != ref[k]).sum()) for k in ref)
        probs, probs_line = serve(spread, ids_only=False), serve(one, ids_only=False)
        err = max(float(np.abs(probs[k] - probs_line[k]).max()) for k in probs_line)
        scale = max(float(np.abs(v).max()) for v in probs_line.values())
        if not err <= PART_RTOL * scale + PART_ATOL:
            raise AssertionError(f"{notes} notes: probabilities over {cards} cards max|d| {err:.3e} from the one-card "
                                 f"line (tol {PART_RTOL} * {scale:.4f} + {PART_ATOL})")
        phase(f"cards: {notes} notes, {CARDS_PARTITIONS} partitions over {cards} card(s) "
              f"({', '.join(str(d) for d in spread)}): K1 launches a card {per_card}, nothing else; ids equal to the "
              f"one-card line's, {differing} of {sum(v.size for v in ref.values())} differ from predict_score_ids on "
              f"one card; probabilities max|d| {err:.3e} from the one-card line (tol {PART_RTOL} * {scale:.4f} + "
              f"{PART_ATOL})")
        if notes == CARDS_NOTES[0]:
            _, full, _, host = _full_encode(model, na)
            _regime1_check(model, full, host, CARDS_PARTITIONS, f"cards: regime 1 over {cards} card(s)",
                           devices=spread)
            del full
            k1_row = _window_k1(model, host)

    # the CLI: a checkpoint of the serve model, a MusicXML score
    ckpt, score = f"{tmp}/serve_ckpt", f"{tmp}/score.musicxml"
    os.makedirs(ckpt)
    with open(f"{ckpt}/model_config.json", "w") as f:
        json.dump(CFG, f)
    torch.save(model.state_dict(), f"{ckpt}/best.pt")
    with open(score, "w") as f:
        f.write(synthetic_score_xml(CARDS_NOTES[0], seed=8))
    before = dict(launches_by_device)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        predict_main(["--checkpoint_dir", ckpt, "--score", score, "--output_csv", f"{tmp}/spread.csv",
                      "--device", "cuda", "--partition_devices", str(CARDS_PARTITIONS)])
    _sync_cards(cards)
    per_card = _k1_on_each_card(f"CLI --partition_devices {CARDS_PARTITIONS}", before, cards)
    with open(f"{tmp}/spread.csv") as f:
        cli_csv = f.read().splitlines()
    parsed = load_score(score)
    line_ids = predict_score_partitioned(model, parsed.note_array, num_devices=CARDS_PARTITIONS, ids_only=True,
                                         device="cuda", devices=one,
                                         feature_type=CFG["feature_type"].replace("simple", "voice"))
    export_predictions_csv(f"{tmp}/line.csv", parsed.note_array, decode_predictions(line_ids))
    with open(f"{tmp}/line.csv") as f:
        line_csv = f.read().splitlines()
    said = f"{CARDS_PARTITIONS} partitions over {cards} device(s)"
    if said not in out.getvalue() or cli_csv != line_csv:
        raise AssertionError(f"CLI --partition_devices {CARDS_PARTITIONS}: printed {out.getvalue()!r}, CSV equal to "
                             f"the one-card line's {cli_csv == line_csv}")
    phase(f"cards: cli.predict.main --partition_devices {CARDS_PARTITIONS} on a MusicXML score of "
          f"{len(cli_csv) - 1} notes printed {out.getvalue().strip().splitlines()[0]!r}, K1 launches a card "
          f"{per_card}; its CSV equal to the one-card line's")
    return {"k1": k1_row, "launches_by_card": launches_by_card}


def _cards_rank(cards: int) -> dict:
    """Phase (d) on one NCCL rank (its card: ``launch.rank_device``):
    ``dryrun_multichip(cards)`` with CARDS_SLOTS data slots a rank through
    K1 and K6 on this rank's card alone; one sharded step with a finite
    loss, and the end-halo exchange against its plain version at regime 2's
    shape of the dry run."""
    import torch.distributed as dist

    from analysisgnn_tpu_torch.distributed import dryrun
    from analysisgnn_tpu_torch.distributed import mesh as tmesh
    from analysisgnn_tpu_torch.kernels.halo import HaloPlan, halo_pull_across_ranks, halo_pull_across_ranks_plain
    from analysisgnn_tpu_torch.kernels.launch import launches_by_device
    from analysisgnn_tpu_torch.train.state import ClippedAdamW, create_train_state
    from analysisgnn_tpu_torch.train.step import StepConfig

    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg = dryrun.DryrunConfig()
    model = dryrun.build_model(cfg, dev)
    parts_here = max(1, 8 // world)  # certification 2's partitions on a rank
    before = dict(launches_by_device)
    with contextlib.redirect_stdout(io.StringIO()) as summary:
        result = dryrun.dryrun_multichip(world, device="cuda", slots_per_rank=CARDS_SLOTS, cfg=cfg)
    torch.cuda.synchronize()
    # the sharded cycle (and rank 0's replay of it) and certification 2's encodes through K1; regime 2 through K6
    by_card = _grown(before)
    if set(by_card) != {(K1, dev.index), (K6, dev.index)}:
        raise AssertionError(f"rank {rank}: the dry run launched {by_card}, its route is K1 and K6 on card "
                             f"{dev.index}")
    out = {"rank": rank, "card": dev.index, "summary": summary.getvalue().strip(), "mesh": result["mesh"],
           "launched": {f"{sym}@{i}": c for (sym, i), c in by_card.items()}}

    # the sharded step alone
    mesh = tmesh.make_mesh(world, slots=CARDS_SLOTS, device="cuda")
    sampler = dryrun.build_sampler(cfg.num_notes, cfg.subgraph, cfg.graphs // mesh.num_slots, tasks=cfg.tasks)
    stacked = tmesh.stack_batches([sampler.sample_batch(device="cpu") for _ in range(mesh.num_slots)])
    slots = tmesh.shard_stacked_batch(stacked, mesh)
    opt = ClippedAdamW(lambda _step: PARITY_LR)
    state = tmesh.shard_train_state(create_train_state(model, len(cfg.tasks), opt, 1), model, mesh)
    step = tmesh.make_sharded_train_step(
        model, opt, StepConfig(task_dict=cfg.tasks, active_tasks=tuple(t for t, _ in cfg.tasks)), mesh)
    _, loss = step(state, slots)
    if not torch.isfinite(loss):
        raise AssertionError(f"rank {rank}: the sharded step's loss is {float(loss)}")
    out["loss"] = float(loss)

    # the end halos of regime 2 across the ranks, at the dry run's shape: D_local partitions of N_local rows
    p = result["partitioned"]
    halo, n_local = p["regime2_halo"], -(-p["notes"] // p["partitions"])
    x = torch.randn(parts_here, n_local, cfg.hidden, generator=torch.Generator().manual_seed(rank)).to(dev)
    plan, group = HaloPlan(x, halo), dist.group.WORLD
    buf = torch.empty(plan.out_shape, device=dev)
    got = halo_pull_across_ranks(x, halo, group, out=buf, plan=plan).clone()
    if not torch.equal(got, halo_pull_across_ranks_plain(x, halo, group)):
        raise AssertionError(f"rank {rank}: the end-halo exchange differs from its plain version")
    out.update({"halo": halo, "d_local": parts_here, "n_local": n_local})
    return out


def cards_dryrun(cards: int) -> list:
    """Phase (d): ``_cards_rank`` on ``cards`` NCCL ranks, one a card, started
    by ``distributed/launch.py::spawn`` after K1, K6 and csrc/graphbuild.cpp
    are built here."""
    from analysisgnn_tpu_torch.distributed.dryrun import RANK_SOURCES
    from analysisgnn_tpu_torch.distributed.launch import spawn

    ranks = spawn(_cards_rank, cards, "nccl", CARDS_TIMEOUT_S, cards, sources=RANK_SOURCES["nccl"])
    phase(f"cards: {ranks[0]['summary']}")
    phase(f"cards: dryrun_multichip({cards}, slots_per_rank={CARDS_SLOTS}) over NCCL, mesh {ranks[0]['mesh']}")
    for r in ranks:
        phase(f"cards: rank {r['rank']} on card {r['card']}: the dry run launched {r['launched']}, nothing on "
              f"another card; a sharded step's loss {r['loss']:.4f}; the end-halo exchange (D_local {r['d_local']}, "
              f"N_local {r['n_local']}, H {r['halo']}) equal to its plain version")
    return ranks


def cards_main(cards: int) -> None:
    """``python3 chip_smoke.py --cards N``: only what needs several cards,
    phases (a)-(d), then the closing lines."""
    smi = cards_environment(cards)
    build_kernels()
    phase("build: done")
    checks = card_kernel_checks(cards)
    with tempfile.TemporaryDirectory() as tmp:
        served = cards_serve(cards, tmp)
    ranks = cards_dryrun(cards)
    r = ranks[0]
    gen = torch.Generator(device="cpu").manual_seed(6)
    check_k6(f"regime 2's shape across {cards} ranks", torch.randn(r["d_local"], r["n_local"], 256,
                                                                   generator=gen).cuda(), r["halo"])
    worst = {"segment_mean_base": max(served["k1"]["max_abs_err"],
                                      max(c["max_abs_err"]["K1"] for c in checks.values())),
             "halo_pull": 0.0}
    # the main paths across cards: a request of each score spread over the cards, and the dry run on each rank
    first = served["launches_by_card"][CARDS_NOTES[0]]
    by_rank = {sym: [x["launched"].get(f"{sym}@{x['card']}", 0) for x in ranks] for sym in (K1, K6)}
    close(smi, worst, {
        K1: {"launches": sum(first), "launches_by_card": {str(n): c for n, c in served["launches_by_card"].items()},
             "dryrun_launches_by_rank": by_rank[K1]},
        K6: {"launches": sum(by_rank[K6]), "dryrun_launches_by_rank": by_rank[K6]},
    })


def main() -> None:
    smi = environment()
    from analysisgnn_tpu_torch.core.graph import NOTE
    from analysisgnn_tpu_torch.data.sampler import SubgraphSampler
    from analysisgnn_tpu_torch.models.analysis import SERVE_CONFIG as CFG
    from analysisgnn_tpu_torch.models.analysis import init_parameters, model_from_config

    def serve_model():
        model = model_from_config(CFG, device="cuda").eval()
        init_parameters(model, torch.Generator(device="cpu").manual_seed(0))
        return model

    build_kernels()
    phase("build: done")
    model = serve_model()
    phase(f"model: HybridGNN {CFG['num_layers']}x{CFG['hidden_channels']} -> {CFG['out_channels']}, "
          f"{sum(p.numel() for p in model.parameters())} parameters, seed 0")
    k1_rows = kernel_checks(model, max(REQUEST_NOTES))
    served = serve(model)
    check_logits(model, max(REQUEST_NOTES))
    graph_build_phase()
    del model

    sampler = train_corpus()
    batches = [sampler.sample_batch(device="cuda") for _ in range(1 + TRAIN_STEPS)]
    parity_batch = SubgraphSampler(sampler.samples, dataclasses.replace(sampler.cfg, batch_size=PARITY_BATCH)
                                   ).sample_batch(device="cuda")
    n_train = batches[0].capacity(NOTE)
    phase(f"train corpus: 8 scores x 2000 notes, {len(batches)} batches of {n_train} note rows "
          f"({batches[0].num_target_nodes} targets)")
    k3_rows = k3_checks(n_train)
    k1_rows.append(check_k1_backward(batches[0]) | {"rows": "float32"})
    k2_rows = k2_checks(batches[0])
    k3_bf16_rows = k3_bf16_checks(n_train)
    k1_rows += k1_batch_checks(batches[0])  # f32 rows, bf16 rows
    trained = {arm: train(arm, batches) for arm in ARMS}
    for arm in PARITY_ARMS:
        step_parity(arm, parity_batch)
    with tempfile.TemporaryDirectory() as tmp:
        metrical_phase(tmp, batches[0])
    k4_rows = k4_checks(batches[0])
    k5_rows = k5_checks(batches[0])
    segment_ops_checks()
    k4_rows.append(zoo_and_pretrain(batches, parity_batch)["k4_plan"])
    with tempfile.TemporaryDirectory() as tmp:
        trainer_phase(f"{tmp}/trainer")
        hgt_trainer_phase(f"{tmp}/trainer_hgt")
        hgt_staged_serve(f"{tmp}/trainer_hgt", tmp)
        smote_trainer_phase(f"{tmp}/trainer_smote")
        variant_trainer_phase(f"{tmp}/trainer_variants", batches[0])
        trainer_parity(f"{tmp}/parity", EDGE_TRAIN)
        raw_dir = raw_dir_trainer_phase(f"{tmp}/raw_dir")
        trainer_parity(f"{tmp}/raw_dir_parity", NODE, [*raw_dir["flags"], "--dropout", "0", "--num_epochs", "1"],
                       "raw-dir trainer")
        cl_trainer_phase(raw_dir["raw"], f"{tmp}/cl")
        cl_parity(f"{tmp}/cl_parity")
    remat_phase()

    k6_rows = k6_checks()
    model = serve_model()
    with tempfile.TemporaryDirectory() as tmp:
        regime2_halo = partitioned_serve(model, CFG, tmp)
    # K6's first check is at the shape of regime 2's run on PARTITIONS partitions
    if (k6_rows[0]["D"], k6_rows[0]["H"]) != (PARTITIONS, regime2_halo):
        raise AssertionError(f"K6 was checked at D={k6_rows[0]['D']} H={k6_rows[0]['H']}, not at the shape of regime "
                             f"2's run (D={PARTITIONS} H={regime2_halo})")
    partition_twin(model)
    del model
    mesh_phase()
    with tempfile.TemporaryDirectory() as tmp:
        rna_serve(serve_model(), CFG, tmp)
        chord_chain(tmp)

    worst = {
        "segment_mean_base": max(r["max_abs_err"] for r in k1_rows if r["rows"] == "float32"),
        "segment_mean_base.bf16": max(r["max_abs_err"] for r in k1_rows if r["rows"] == "bfloat16"),
        **{name: max(r["max_abs_err"][part] for r in k3_rows) for name, part in (
            ("relation_weighted_matmul", "forward"), ("relation_weighted_matmul.dx", "dx"),
            ("relation_weighted_matmul.dw", "dw"), ("relation_weighted_matmul.dalpha", "dalpha"))},
        "relation_weighted_matmul.bf16": max(r["max_abs_err"] for r in k3_bf16_rows if r["kernel"] == "wgmma"),
        "segment_softmax_agg": max(r["max_abs_err"] for r in k2_rows),
        "segment_sum_sorted": max(r["max_abs_err"] for r in k4_rows),
        "segment_softmax_sorted": max(r["max_abs_err"] for r in k5_rows),
        "halo_pull": max(r["max_abs_err"] for r in k6_rows),
    }
    # the main paths: one request of the largest score through predict_score_ids, and each arm's train steps after
    # its warm-up (a replayed step launches nothing from the host)
    close(smi, worst, {symbol: {"launches": served.get(symbol, 0),
                                "train_launches": {arm: c[symbol] for arm, c in trained.items() if symbol in c}}
                       for _, symbol, _, _ in KERNELS})


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=None,
                    help="run only the phases across N cards (a)-(d) (python3 chip_smoke.py --cards 4); fails "
                         "unless N cards are visible")
    args = ap.parse_args()
    if args.cards is None:
        main()
    else:
        cards_main(args.cards)
