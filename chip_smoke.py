"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU and
check them; with ``--cards N``, only its paths across N cards of one host.

    python3 chip_smoke.py
    python3 chip_smoke.py --cards 4

Phases, each on its own line with elapsed seconds:
  1. environment: torch / CUDA versions, the card's name and power limit,
     TF32 off for matmuls and cuDNN;
  2. build: the CUDA sources of K1 and K4 (analysisgnn_tpu_torch/csrc/
     segment_mean_base.cu), K3 (csrc/relation_weighted_matmul.cu), K2
     (csrc/segment_softmax_agg.cu), K5 (csrc/segment_softmax.cu) and K6
     (csrc/halo_pull.cu), one nvcc each, and the host edge builder
     (csrc/graphbuild.cpp) with g++, started together, into the
     git-ignored analysisgnn_tpu_torch/_build/, with ptxas's registers;
  3. kernel check: K1 (segment_mean_base) against its plain PyTorch version on
     the card, at the shapes of the largest request (the fused 7-relation note
     layer and onset pooling, F=256) and at edge cases (padding ids, empty
     segments, F=25, no edges), with median times of the kernel's call with
     its plan's row pointers (as the model calls it) and without them, the
     plain version and an index_add_ yardstick;
  4. serve: the full-width HybridGNN score-analysis model (3 x 256 hidden,
     128 out, JK, 21 task heads; seeded random weights) answers 2,000-,
     8,000- and 20,000-note requests through predict_score_ids on the GPU,
     with K1's launches counted per request; the largest request's logits
     are held against the port on the CPU (plain versions, same weights);
  5. trace: one more 20,000-note request under torch.profiler, with the host
     time of the request's stages (the predict.* spans), the device's busy
     share of the request and its kernels by device time;
  6. train corpus: the 8 synthetic 2,000-note scores of bench.py with beats,
     measures and random labels for the 21 tasks, sampled by the port's
     SubgraphSampler (500-note subgraphs x 8, neighbours (5, 5), src-sorted);
  7. K3 check: relation_weighted_matmul's forward, dx, dw (tensor cores, three
     TF32 passes) and d alpha kernels against the plain version's value and
     autograd gradients, at the train step's shape (N = the batch's note
     capacity, F = G = 256, T = 7) and at edge cases (N = 1, 63, 77, 300;
     T = 1; F, G of 25/20, 40/24, 64/96; a strided x), two dw and two d alpha
     calls bit for bit, with median times of each kernel's call, its device
     time, the plain version and a torch.einsum yardstick, beside the
     three-pass TF32 operations bound and the f32 SIMT one; K1's gradient
     through the CUDA kernel against the plain version's at the fused-layer
     shape, padding edges included;
  8. train: the full-width HybridGNN train step of bench.py (dropout 0.3,
     wloss, AdamW + clip 1.0, warmup-cosine 5e-3, torch-style init seed 0)
     with conv_impl "edge-zxp" (K3 base term) and "node" (K1), and the same
     step of the MetricalGNN 3 x 256 -> 128 with use_rnn and edge-zxp: ms
     per step, valid message edges per second, K3 and K1 launches per step
     against the code's prediction (over the steps that launched from the
     host: from a batch signature's second call on, the step of a model
     without GRUs replays a CUDA graph, train/graphed.py, and a replay
     launches nothing from the host), a finite loss that falls over 8 steps
     on one batch (edge-zxp, HGT); the same step of the "variants" arm
     (edge-zxp with the deep projections, logit fusion, remat and final
     dropout; its launches include remat's recomputed forwards); then one
     step on the GPU against the same step on the CPU (plain versions, same
     weights, a batch of 2 of the bench's subgraphs, dropout 0; edge-zxp,
     HGT, MetricalGNN);
  9. train trace: one edge-zxp step and one MetricalGNN step under
     torch.profiler, with the device's busy share of the step, its kernels
     by device time, K3's sum and the GRUs' (the kernels under the cuDNN
     GRU's forward and backward ops);
 10. K2 check: segment_softmax_agg's kernel against its plain version (value
     and the autograd gradients of logits and msgs, padding gradients exactly
     0) at the HGT train step's shape (the union softmax of one layer over a
     train batch: 13 relation blocks, H = 4, D = 64; its degree statistics
     printed) and at edge cases (an empty node, H = 3, a degree-77 node over
     9 ranges, 40 blocks), with median times of the kernel's call, its
     profiler device time and the plain version beside the bytes bound;
 11. HGT train: the same train step with the "HGT-emax-pallas" model of
     scripts/bench_encoders.py (HybridHGT 3 x 256 -> 128, 4 heads, K2):
     ms per step, K2 and K1 launches per step against the code's
     prediction, a loss that falls over 8 steps on one batch, one GPU step
     against the CPU step, and one traced step;
 12. K4 and K5 check: segment_sum_sorted (K4, the sum mode of K1's kernel)
     and segment_softmax_sorted (K5, csrc/segment_softmax.cu) against their
     plain versions at tests/test_pallas.py's cases, at a train batch's
     shape (K4 over the fused note layer's sorted valid edges, F = 256; K5
     over the HGT layer's valid union edges, H = 4, and over those of a
     20,000-note score, whose bytes bound lies above one launch's floor) and
     at edge cases (empty nodes, F = 25, H = 1, ids past num_nodes, no edges;
     for K5 runs at the ends of its 32-edge slices and of its registers, one
     run of every edge, H = 6 and 40, int64 ids, -inf logits), with median
     times of each kernel, its plain version and, for K4, an index_add_
     yardstick, and the profiler's device time (K5: one launch a call and no
     other kernel), beside the bytes bound; no path launches K5 (only tests
     call it), and K4's path is phase 27's; then the generic segment ops of
     kernels/segment_ops.py (plain PyTorch, as they are XLA code in the JAX
     package: segment_mean, segment_mean_or, segment_softmax,
     gather_scatter_sum / _mean, sddmm_dot with 4 heads, coalesce) on CUDA
     tensors against CPU copies at the bench batch's fused-layer shape
     (E = 82,176, F = 256, S = 37,632) with padding and negative ids;
 13. trainer: the training entry point, analysisgnn_tpu_torch.cli.train.main,
     at full width (HybridGNN 3 x 256 -> 128, JK, final norm) on the demo
     corpus with --use_metrical --use_pallas --conv_impl edge-zxp, one
     epoch of 12 steps, validation after it and the test split at the
     end: seconds per epoch, median ms per train step, K1 and K3 launches
     against the code's prediction, the log.jsonl keys, finite losses; then
     last.pt served once through cli/predict.py's load_model (a 2,000-note
     request), one epoch of --model HGT --use_pallas (K2), and one fit epoch
     of 2 steps on the GPU against the same on the CPU (dropout 0, the same
     initial state dict);
 14. raw-dir trainer: cli.train.main on file corpora with
     scripts/parity_experiment.py's recipe at full width (HybridGNN 3 x 256
     -> 128, subgraph 500, batch 80, --main_tasks all --use_transpositions,
     conv_impl node, --use_wandb with the wandb package's import blocked, as
     on a host without it, since a real wandb.init could try the network)
     on data_synth/ and
     its split file as the port's synth_dlc.write_corpus writes them into a
     temporary directory (the generator's seconds; all 24 TSVs and the split
     byte-equal to the committed data_synth/), two epochs: the corpus build's
     seconds and its 227 samples per
     interval (the JAX corpus's list), steps per epoch, median ms per train
     step, K1 launches against the code's prediction, finite losses and
     --do_eval metrics, whether pandas is importable on the host (the port
     does not use it); a second build_datamodule from the .npz cache (24
     .done markers, its samples array for array the built ones); then one
     fit epoch of 2 steps on the GPU against the same on the CPU (dropout 0,
     the same initial state dict, each epoch's losses: trainer_parity);
 15. CL trainer: cli.train.main on configs/example_config.json as the file
     stands (continual learning over all, cadence and rna, HybridGNN 3 x
     256 -> 128, conv_impl node, batch 100, transpositions) with --num_epochs
     3 --max_steps_per_epoch 4 --do_train --do_eval, on the raw-dir phase's
     copy of data_synth/ (all/ read from its .npz cache) with cadence/ and
     rna/ made of its first 8 TSVs (rna/ with the AugmentedNet labels), the
     CLI's 5 sampler threads: each corpus's build seconds, seconds per epoch,
     each task's median ms per train step and the medians without the teacher
     (the first task) and with it, memory_loss per epoch (0, then above 0),
     the {all,cadence,rna}_model.pt checkpoints, finite test metrics, K1
     launches against the code's prediction (5 a student pass, a teacher
     forward after the first switch, a validation or test pass); then the
     teacher's cost alone: the rna heads' step with and without the teacher
     on the same batches, timed in turns;
 16. CL parity: --demo --cl_training --main_tasks all,cadence --use_ewc
     --mt_strategy famo --conv_impl edge-zxp at full width, two epochs of 2
     steps on the GPU against the CPU (every epoch's losses; the optimizer's
     eps at 1, as in phase 8's step parity), FAMO's logits
     and the fisher's sum against the CPU's, and K1 and K3 launches in the
     GPU arm against the code's prediction (the fisher batch's backward
     included);
 17. K6 check: halo_pull (csrc/halo_pull.cu), in the allocating form and in
     the planned form with out= that regime 2 uses, bit-equal to its plain
     version at the regime-2 shape (D = 4 partitions of 5,000 rows, H = 24,
     F = 256), at D = 1, 2, 8, H = 1, H = N_local, F = 25 (the scalar loop)
     and on non-contiguous inputs, with the median times of both forms, the
     plain version and an index_select yardstick (timed in turns), and the
     profiler's device time of the kernel, beside the bytes bound;
 18. partitioned serve: the serve model (phase 4's weights) on a 20,000-note
     score through 4 partitions on a line.  Regime 1, the CLI's path:
     predict_score_partitioned(ids_only=True), K1 launches per window, ms
     per request, its embeddings within 2e-4 * max|full| + 2e-5 of the
     single-window encode, the count of ids that differ from
     predict_score_ids; then cli.predict.main --partition_devices 4 on a
     generated MusicXML score of about 20,000 notes.  Regime 2:
     make_partitioned_fused_sage at D = 1, 2, 4, 8 on the model's projected
     note embeddings, within the same tolerance of model.encoder's output
     after ReLU and L2 norm, K6 launched num_layers + 1 times per forward, ms
     per forward;
 19. the dryrun_multichip twin (__graft_entry__.py:287-356): 1,200 notes
     (seed 7) of the serve model's configuration (3 x 256 -> 128, JK, 21
     tasks) through 8 partitions, within the same tolerance;
 20. RNA serve: cli.predict.main on the serve model (phase 4's weights,
     saved with its model_config.json) with --output_musicxml on a generated
     MusicXML score of 2,000 notes (seconds, K1 launches against the code's
     prediction, the RNA MusicXML's bytes and harmony labels), with
     --conv_impl edge-zxp (K3 forward launches against the prediction, the
     ids that differ from the node run) and on a .krn score it writes; then
     one request with --checkpoint_dir entity/project/model-rna:v0
     --artifacts_dir pointing at a cached copy of the checkpoint, under
     utils/profiling.py's trace: it prints "Using cached checkpoint", its ids
     equal the local run's, K1 launches as predicted, and the Chrome trace it
     writes names K1's kernel (segment_mean_base_kernel);
 21. chord chain: predict_chords.main at the CLI's defaults (hidden 256, one
     HybridGNN layer, the 14 latest tasks, the BiGRU smoother) with
     --romantext on a generated 2,000-note score: seconds per request after
     one warm-up, K1 launches against the code's prediction, one traced
     request (device busy share, kernels by device time, the GRUs' share),
     and predict_chord_tasks on the card against the CPU with the same
     weights (probabilities within CHORD_PROB_ATOL, onsets with other decoded
     labels, the resolved annotations);
 22. metrical (run after phase 11): cli.train.main --demo --model
     MetricalGNN --use_metrical at the CLI's full width (3 x 256 -> 128, JK,
     beats and measures), two epochs of 4 steps, in the node layout (K1 5 a
     pass) and with --use_rnn --conv_impl edge-zxp (K3's forward, dx and dw
     4 a step, K1 1 a pass): seconds per epoch, median ms per train step,
     launches against the code's prediction; each checkpoint served by
     cli.predict.main on a generated 2,000-note MusicXML score (seconds a
     request, launches) and through predict_score on the card against the
     CPU (probabilities within METRICAL_PROB_ATOL); then AssocBiGRU (the
     log-depth scan) against BiResetGRU (cuDNN) at a train batch's beat rows
     and F = 256, forward and backward, in turns, with each one's device time
     and launches, and AssocBiGRU on the card against the CPU.
 23. bf16 compute (StepConfig compute_dtype="bfloat16", the JAX step's cast
     of the parameters and node features at apply time): K3's bf16 forward
     (wgmma fed by TMA where TMA can describe the operands, mma.sync for
     the rest; f32 accumulation) against its plain version at the bench
     shape and edge cases, each case naming the kernel it launched, the
     wgmma kernel, the mma.sync kernel and a torch.einsum yardstick on the
     same bf16 operands timed in turns beside the bound, each kernel's
     device time, and the backward's cotangent dtypes; K1 on f32 and bf16
     rows at the fused note layer of the 20,000-note request and of a bench
     batch (phase 3's and 7's shapes), call and device time beside its
     bytes bound; the bench train step in the node
     and edge-zxp layouts at bf16 (phase 8's arms node-bf16 and
     edge-zxp-bf16: launches against the prediction, bf16 forward and K1
     launches counted apart, ms per step in turns with the f32 arm of the
     same layout, one traced step, one step against the CPU at a bf16
     tolerance, a falling loss); and the Trainer with the edge-consistency
     loss (phase 12's run with --use_edge_loss: its edge decoder trains),
     the HGT epoch with --hgt_stage_dtype bfloat16 (its last.pt served by
     cli/predict.py) and a single-task cadence run with --use_smote
     (--cl_training --main_tasks cadence: SMOTE oversamples every step).
 24. graph build (run after phase 5): the serve path's host graph build of
     the 20,000-note score, build_score_graph through the C++ edge builder
     (csrc/graphbuild.cpp, built with g++ beside the CUDA sources in the
     build phase, called through data/native.py) against its
     numpy twin in turns, every array equal, and graph_from_note_array to
     the card, beside the serve phase's requests (each of which took the
     native build once, counted) and the loop-based numpy build's request
     before it;
 25. trainer variants (run after phase 13's SMOTE run): cli.train.main with
     --deep_proj --logit_fusion --remat --final_dropout --no_fused_torch_init
     at full width (one combined epoch of 2 steps a task), launches against
     the prediction with remat's recomputed K1 and K3 forwards, a loss that
     falls over FALL_STEPS steps on one bench batch, last.pt served through
     cli/predict.py's load_model, and one dropout-0 step of its weights on
     the GPU against the CPU;
 26. remat (run after phase 16): one train step of the variants model on a
     whole 20,000-note score with beats and measures, with and without
     remat, in turns: ms a step and peak device memory of each, launches
     against the prediction, the losses and gradients within 1e-5 relative.
 27. pre-training and the layer zoo (run after phase 12), at full width with
     weights from seed 0: (a) the PreEncoder (HybridHGT pair 3 x 256, 4
     heads, JK) pre-trained by make_pretrain_step on the bench's batches
     with seeded voice and staff attributes: ms a step over 4 steps, peak
     memory, no hand-written kernel launched, a loss that falls, one step on
     the GPU against the CPU; K4 through a SegmentPlan (segment_sum_plan)
     against its plain version, its gradient, and its call timed in turns
     with phase 12's call that builds its row pointers; (b) HResGatedConv (3
     layers, 13 relations: K4 39 a forward), HGPS (2 layers, 4 heads, the
     dense masked attention over a batch's note rows: K4 14), OnsetEmbedding
     (K1 1) and GATConv (3 heads, K4 1) on a bench batch, forward and
     backward on the GPU against the CPU, launches against the code's
     formula, peak memory; (c) UNet((32, 64, 128)) on [8, 88, 256, 1]
     pianoroll-shaped images, GPU against CPU; (d) hetero_fidelity of the
     serve model on a 2,000-note request with half of each note -> note
     relation's edges masked (three forwards, K1 15), GPU against CPU; the
     pretrained PreEncoder's voice links through voice_from_edges,
     pianoroll_svg and graph_to_json, and GraphSampler and the Laplacian
     positional encoding on the host.
 28. mesh (run after phase 18): the dry run's twin at world size 1 over NCCL
     (a FileStore, rank 0): dryrun_multichip at the reference configuration
     (21 tasks, HybridGNN 3 x 256 -> 128 node, subgraphs of 500 notes from
     2,000-note scores) with 4 data slots of 2 graphs on the card: the
     sharded CL cycle ("all", the teacher, "cadence" with distillation)
     against its unsharded replay, regime 1 and regime 2 of a 1,200-note
     score against the full encode, K1 and K6 launches against the code's
     prediction; ms per sharded step over the 4 slots, the device time of
     NCCL's kernels in one traced step and of its all-reduce of the step's
     gradients alone; the cycle on 1 of the slots on the GPU against the CPU
     (dropout 0, Adam eps 1): losses, parameters, the AdamW moments after the
     cycle and each parameter's move.
The last lines are the card's nvidia-smi line, one JSON object describing
each kernel, and the result line.  Any failure raises and exits nonzero.

With ``--cards N`` (N cards must be visible, else it fails; nothing of the
default run runs), the build, then:
  (a) every card's name and power limit, the peer-access matrix
      (torch.cuda.can_device_access_peer) and nvidia-smi topo -m;
  (b) every kernel (K1, K4, K5, K6 in both forms, K2, K3's f32 forward, dx,
      dw and d alpha and its bf16 forward) launched on every card from this
      process, whose current card stays 0, against its plain version on that
      card, each launch counted on its card (kernels/launch.py's
      launches_by_device);
  (c) the serve model on a 20,000-note and a 100,000-note score through 4
      partitions spread over the cards by predict_score_partitioned (one a
      card on 4) against the same partitions on card 0: ids equal, the ids
      that differ from predict_score_ids counted, probabilities within phase
      18's tolerance, K1 launches on every card as predicted, each card's
      peak memory, the first request (the replicas made in it) and 3 warm
      requests of each line in turns; the spread's embeddings against the
      single-window encode; K1 timed at a window's fused note layer; then
      cli.predict.main --partition_devices 4 against the CLI without the
      flag and the one-card line's CSV;
  (d) dryrun_multichip(N) over NCCL, one rank a card, 2 data slots a rank
      (on 4: data 2 x 2 slots x model 2): both certifications, K1 and K6
      launches on every rank as predicted; on every rank the sharded step
      (median ms of 3 after a warm-up, one traced step with NCCL's kernels),
      the gradients' all-reduce over the data group alone beside its NVLink
      bound, and the end-halo exchange against its plain version in turns;
      NCCL's channels from its INFO logs; K6 timed at a rank's partitions.
Then the same closing lines, with K1's and K6's entries of this run.
"""

from __future__ import annotations

import collections
import contextlib
import csv
import dataclasses
import importlib.metadata
import importlib.util
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

from analysisgnn_tpu_torch.utils.profiling import GPU_PEAKS

T0 = time.perf_counter()
# the card's published peaks (H100 SXM at 700 W, dense): device memory, float32 outside the tensor cores, TF32 and
# bf16 on the tensor cores
H100 = GPU_PEAKS["NVIDIA H100 80GB HBM3"]
HBM_BYTES_PER_S, FP32_OPS_PER_S = H100["hbm_bw"], H100["fp32_flops"]
TF32_OPS_PER_S, BF16_OPS_PER_S = H100["tf32_flops"], H100["bf16_flops"]
K1_RTOL = 1e-5  # kernel vs plain: f32 sums of the same terms in another order
LOGIT_ATOL = 1e-3  # GPU vs CPU logits of the whole model at full width
REQUEST_NOTES = (2000, 8000, 20000)
BUCKET_FACTOR = 1.25
REPEATS = 2
PROFILER_ATTEMPTS = 5  # profiler windows taken before a short one fails (device_ms, trace_forward)
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
# bf16 compute (phase 23): the bench step of both HybridGNN layouts with StepConfig compute_dtype="bfloat16"
ARMS.update({"node-bf16": ARMS["node"], "edge-zxp-bf16": ARMS["edge-zxp"]})
# the train CLI's last five knobs (phase 25): edge-zxp with the deep projections, logit fusion, remat of the
# hidden convs and dropout after the final conv; its torch-style draw leaves the fused stacks out
# (--no_fused_torch_init)
ARMS["variants"] = {**ARMS["edge-zxp"], "plain_proj": False, "logit_fusion": True, "remat": True,
                    "final_dropout": True}
UNFUSED_INIT_ARMS = ("variants",)
# each bf16 arm (compute_dtype="bfloat16"; every other arm float32) and the f32 arm of its layout, timed in turns
BF16_PAIRS = {"node-bf16": "node", "edge-zxp-bf16": "edge-zxp"}
BF16_TURNS = 2
TIMED_STEPS = {"edge-zxp": 3, "node": 2, "hgt": 2, "metrical": 2, "node-bf16": 2, "edge-zxp-bf16": 2, "variants": 2}
FALL_ARMS = ("edge-zxp", "hgt", "edge-zxp-bf16")  # the metrical Trainer runs of phase 22 show its loss falling
# one step on the GPU against the CPU, and one traced step; the CPU steps take a batch of PARITY_BATCH of the
# bench's 500-note subgraphs (8 in the timed steps), the same models at full width
PARITY_ARMS = ("edge-zxp", "hgt", "metrical", "node-bf16", "edge-zxp-bf16")
PARITY_BATCH = 2
FALL_STEPS = 6
# K3's bf16 forward vs its plain version (the f32 einsum of the upcast
# operands), elementwise, relative to the sum of |terms|: products of bf16
# values are exact in f32, so the two differ only in the order of f32 sums
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
# the teacher's cost alone: rounds of (without, with, with, without) over the same batches
CL_TURNS, CL_TURN_BATCHES = 2, 2
# partitioned against full-graph embeddings: 2e-4 of the largest |full| plus
# 2e-5 (__graft_entry__.py:341-344; the JAX partition tests' tolerance)
PART_RTOL, PART_ATOL = 2e-4, 2e-5
PART_NOTES = 20000
PART_SEED = 0  # its largest edge span, 24 rows, is regime 2's halo and K6's timed shape
PARTITIONS = 4  # regime 1's, the CLI's, regime 2's traced run's and K6's timed shape's
REGIME2_PARTITIONS = (1, 2, 4, 8)
# RNA serve (phase 20) and the chord chain (phase 21): generated MusicXML scores of about 2,000 notes
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
# phase 22: the MetricalGNN family through the training entry point at the CLI's full width (MetricalGNN 3 x
# 256 -> 128, JK, beats and measures) on the demo corpus, two epochs of 4 steps: the node layout (K1), then
# use_rnn with edge-zxp (K3); each checkpoint served by the predict CLI on a generated MusicXML score
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
# phase 24: the serve path's host graph build of the serve phase's largest score, the C++ edge builder against
# its numpy twin in rounds of (native, numpy, numpy, native); beside the earlier numpy build (a Python loop over
# the silent ends) and its request, PERF.md section 5 (chip run, NVIDIA H100 80GB HBM3, 700.00 W)
GRAPH_NOTES = 20000
GRAPH_TURNS = 5
LOOP_BUILD_MS, LOOP_REQUEST_MS = 133.5, 182.8
# phase 25: the training entry point with the train CLI's last five knobs at full width, one combined epoch of
# 2 steps; its losses fall over FALL_STEPS steps on one bench batch, its last.pt is served, and one dropout-0
# step of its weights on a batch of its data runs on the GPU against the CPU (PARITY_LOSS_RTOL, the
# TRAINER_PARITY_RTOL)
VARIANT_TRAINER_FLAGS = ["--demo", "--use_metrical", "--use_pallas", "--conv_impl", "edge-zxp", "--deep_proj",
                         "--logit_fusion", "--remat", "--final_dropout", "--no_fused_torch_init", "--do_train",
                         "--num_epochs", "3", "--max_steps_per_epoch", "2", "--main_tasks", "all,cadence,rna"]
# phase 26: one train step of the variants arm (dropout 0) on a whole 20,000-note score with beats and
# measures, with and without remat, in rounds of (without, with, with, without); the loss relative and the
# concatenated gradients in relative L2 (the same function, the gather's backward adding in no fixed order)
REMAT_NOTES = 20000
REMAT_TURNS = 2
REMAT_RTOL = 1e-5
# phase 27: pre-training and the rest of the layer zoo at full width, weights drawn from seed 0.  The PreEncoder
# (HybridHGT pair 3 x 256, 4 heads, JK, no K2: the JAX module's build) pre-trains on the bench's batches with seeded
# voice / staff attributes in {1, 2} (tests/test_model_families.py:226-229), AdamW at PRETRAIN_LR with optax's
# weight decay and no clipping (the JAX step's optax.adamw): PRETRAIN_STEPS timed steps after one warm-up, the loss
# falling over FALL_STEPS steps on one batch, one dropout-0 step on the GPU against the CPU at PARITY_EPS on a
# batch of PARITY_BATCH (the loss within PARITY_LOSS_RTOL, every parameter within PARITY_PARAM_ATOL)
PRETRAIN = {"hidden": 256, "num_layers": 3, "heads": 4}
PRETRAIN_LR, PRETRAIN_WEIGHT_DECAY = 1e-3, 1e-4
PRETRAIN_STEPS = 4
# the layer zoo on one bench batch at width 256, forward and backward, GPU against CPU on the same weights: each
# output's note rows within ZOO_RTOL of its largest |value| (the same f32 sums in another order; K4 sums a node's
# few dozen messages, HGPS's softmax runs over 5,376 keys), the gradients of the parameters and the input within
# ZOO_GRAD_RTOL in relative L2.  The gradient is not continuous at a ReLU's kink: a pre-activation within f32
# rounding of 0 lands on the other side of it on the card, and each such unit moves the gradient by its term, 1e-4
# to 1e-3 of the gradient's norm here (HGPS: 2 of the last layer's 2.2 million ff1 units, at |pre| < 6e-7, moved
# it by 1.1e-3 in one chip run and by 2.7e-4 in another, where the CPU's f32 gradient lay within 4.5e-7 of float64:
# chip runs, NVIDIA H100 80GB HBM3, 700.00 W, PERF.md section 6); a wrong index or a dropped term moves it by
# O(1).  Padding rows (graph id -1) are never read: a finite output is all they owe, and the cotangent is 0
# there.  HGPS's
# padding rows have no valid key and attend uniformly to every key, as flax's do; their output is a mean over the
# 5,376 rows, which the card sums in another order: 1.4e-5 of the largest |output| from float64 after two layers,
# where the note rows lie within 8.6e-7 on the card and 7.0e-7 on the CPU (chip run, NVIDIA H100 80GB HBM3,
# 700.00 W, PERF.md section 6)
ZOO_HIDDEN = 256
ZOO_RTOL, ZOO_GRAD_RTOL = 1e-5, 1e-2
HGPS_LAYERS, HGPS_HEADS, HRES_LAYERS, GAT_HEADS = 2, 4, 3, 3
# UNet((32, 64, 128), out 1) on pianoroll-shaped images [B, 88 pitches, 256 steps, 1], GPU against CPU: the same
# convolutions (cuDNN, TF32 off) and GroupNorms in another order, within UNET_RTOL of the largest |output|
UNET_SHAPE, UNET_FEATURES, UNET_RTOL = (8, 88, 256, 1), (32, 64, 128), 1e-5
# hetero_fidelity of the serve model on a FID_NOTES-note request, a seeded mask keeping half of each note -> note
# relation's edges: three forwards, each with the serve path's K1 launches; the pretrained PreEncoder's voice
# links on the same score, then voice_from_edges, pianoroll_svg, graph_to_json, GraphSampler and the Laplacian
# positional encoding on the host
FID_NOTES = 2000
LAP_PE_K = 8


def phase(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f}s] {msg}", flush=True)


def cuda_ms(fn, iters: int = 20, trials: int = 5) -> float:
    """Median over trials of the mean time of ``iters`` back-to-back calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _cuda_window(body) -> list:
    """The CUDA kernel records (``key_averages``) of one torch.profiler window
    around ``body``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        body()
    return [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, kernel: str, iters: int = 20, per_call: int = 1, alone: bool = False) -> float:
    """Device time of one call of ``fn``'s kernels whose names contain
    ``kernel`` (``per_call`` launches a call), from torch.profiler over
    ``iters`` calls: the kernels alone, without the host time of the wrapper.
    With ``alone``, a call that launches any other kernel fails.

    A window now and then comes back short of records, in a process profiled
    before (seen on the H100 with none of the window's kernels, or 13 of 20
    launches): a window with fewer launches of ``kernel`` than the calls
    made is taken again, up to PROFILER_ATTEMPTS times, and every retake is
    printed (seen too: every window one of 20 launches short); if all come
    back short, the fullest window gives the time, a launch's mean over the
    launches it holds, if it holds at least half of them.  More launches
    than expected, or another kernel with ``alone``, fail at once."""
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

    # the names of the padding launches' kernels, to tell them from the call's
    pad_keys = set()
    for _ in range(PROFILER_ATTEMPTS if alone else 0):
        pad_keys = {e.key for e in _cuda_window(padding)}
        if pad_keys:
            break
    if alone and not pad_keys:
        raise AssertionError(f"the profiler recorded no kernel in {PROFILER_ATTEMPTS} windows of padding launches")
    fullest = (0, [])
    for _ in range(PROFILER_ATTEMPTS):
        cuda = _cuda_window(calls)
        hits = [e for e in cuda if kernel in e.key]
        count = sum(e.count for e in hits)
        fullest = max(fullest, (count, hits), key=lambda c: c[0])
        others = [f"{e.key} x{e.count}" for e in cuda if kernel not in e.key and e.key not in pad_keys]
        if count > iters * per_call or (alone and others):
            raise AssertionError(f"{iters} calls of {kernel}: the profiler saw {count} launches of it "
                                 f"(expected {iters * per_call})" + (f" and other kernels {others}" if alone else ""))
        if count == iters * per_call:
            return sum(e.self_device_time_total for e in hits) / iters / 1e3
        phase(f"device_ms: the profiler's window held {count} of the {iters * per_call} launches of {kernel}; "
              f"taking it again")
    count, hits = fullest
    if 2 * count >= iters * per_call:
        phase(f"device_ms: every window short; {kernel}'s time from the fullest, a launch's mean over its {count} "
              f"launches")
        return sum(e.self_device_time_total for e in hits) / count * per_call / 1e3
    raise AssertionError(f"the profiler saw fewer than {iters * per_call} launches of {kernel} in "
                         f"{PROFILER_ATTEMPTS} windows of {iters} calls")


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

    t = time.perf_counter()
    # the CUDA sources with nvcc and the host edge builder (graphbuild.cpp) with g++, all started together
    built = build.build_all(["segment_mean_base", "relation_weighted_matmul", "segment_softmax_agg", "segment_softmax",
                             "halo_pull", "graphbuild"])
    for name, (seconds, log) in built.items():
        phase(f"build: {name} {seconds:.2f}s -> {build.library_path(name).name}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line or "C75" in line:
                phase(f"build:   {line.strip()}")
    phase(f"build: {len(built)} sources in {time.perf_counter() - t:.2f}s wall")


def k1_bound_ms(e_valid: int, f: int, m: int, s: int, row_bytes: int = 4) -> tuple:
    """Least time for K1's work on this data: the valid edges' messages and ids
    read once (padding edges are neither read nor needed), the base rows read
    once (``row_bytes`` an element: 4 for f32 rows, 2 for bf16), the f32 rows
    and counts written once."""
    bytes_moved = e_valid * f * row_bytes + e_valid * 4 + m * f * row_bytes + s * f * 4 + s * 4
    ops = e_valid * f + 2 * s * f  # one add per message element; base add + divide per output
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_k1(name: str, msgs, seg, x_base, num_segments, timed: bool, row_ptr=None) -> dict:
    """K1's kernel against its plain version; ``row_ptr``, a plan's, is passed
    as ``aggregate`` passes it.  With ``timed``, medians of the call (with the
    plan's row pointers, and without them: the call builds its own), the
    plain version and an index_add_ yardstick, and the profiler's device
    time of the kernel with the plan's row pointers."""
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
    row = {"case": name, "E": e, "E_valid": e_valid, "F": f, "m": m, "S": num_segments, "max_abs_err": max_abs,
           "rows": str(msgs.dtype).replace("torch.", "")}
    line = (f"kernel check: K1 {name}: E={e} (valid {e_valid}) F={f} m={m} S={num_segments} {row['rows']} rows "
            f"max|d|={max_abs:.3e} (tol {K1_RTOL} rel)")
    if timed:
        valid = seg.long() < num_segments
        seg_l, msgs_v = seg.long()[valid], msgs[valid]
        base_tiled = x_base.repeat(num_segments // m, 1)

        def library():  # yardstick only: index_add_ plus counts, never called by the port
            total = base_tiled.index_add(0, seg_l, msgs_v)
            counts = torch.bincount(seg_l, minlength=num_segments)
            return total / counts.clamp_min(1)[:, None]

        row["ms"] = cuda_ms(lambda: segment_mean_base(msgs, seg, x_base, num_segments, row_ptr))
        row["unplanned_ms"] = cuda_ms(lambda: segment_mean_base(msgs, seg, x_base, num_segments))
        row["plain_ms"] = cuda_ms(lambda: segment_mean_base_plain(msgs, seg, x_base, num_segments))
        row["library_ms"] = cuda_ms(library)
        row["device_ms"] = device_ms(lambda: segment_mean_base(msgs, seg, x_base, num_segments, row_ptr),
                                     "segment_mean_base_kernel")
        row["bound_ms"], row["bound_by"] = k1_bound_ms(e_valid, f, m, num_segments, msgs.element_size())
        line += (f" | kernel {row['ms']:.4f} ms a call with the plan's row pointers ({row['unplanned_ms']:.4f} ms "
                 f"without them), {row['device_ms']:.4f} ms on the device, plain {row['plain_ms']:.4f} ms, "
                 f"index_add_ yardstick {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
                 f"({row['bound_by']}, {100 * row['bound_ms'] / row['ms']:.1f}% of the call, "
                 f"{100 * row['bound_ms'] / row['device_ms']:.1f}% of the device time)")
    phase(line)
    return row


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
        rows.append(check_k1(name, msgs, plan.seg, x_base, plan.num_segments, timed=True, row_ptr=plan.row_ptr))
        if plan is fused:  # phase 23: the same layer on bf16 rows, as layer 0 reads them under bf16 compute
            bf16_row = check_k1(f"{name} of a {largest_notes}-note request", msgs.bfloat16(), plan.seg,
                                x_base.bfloat16(), plan.num_segments, timed=True, row_ptr=plan.row_ptr)
    # edge cases: padding ids past the end, empty segments, the scalar path, no edges
    for name, e, f_, m, t in (("padding+empty F=256", 5000, 256, 1000, 3), ("F=25", 3000, 25, 500, 7),
                              ("F=6 scalar path", 700, 6, 64, 2), ("no edges", 0, 256, 128, 2)):
        s = m * t
        seg = torch.randint(0, s + s // 10 + 1, (e,), generator=g).sort().values.to(torch.int32)
        msgs = torch.randn(e, f_, generator=g)
        x_base = torch.randn(m, f_, generator=g)
        rows.append(check_k1(name, msgs.to(dev), seg.to(dev), x_base.to(dev), s, timed=False))
    return rows + [bf16_row]


def serve(model) -> dict:
    from analysisgnn_tpu_torch.data.graph_build import build_score_graph
    from analysisgnn_tpu_torch.data.native import build_note_edges_native
    from analysisgnn_tpu_torch.data.note_array import synthetic_score
    from analysisgnn_tpu_torch.inference.predict import predict_score_ids
    from analysisgnn_tpu_torch.kernels.segment_mean import segment_mean_base
    from analysisgnn_tpu_torch.models.hetero import fusion_groups

    groups, singles = fusion_groups(model.edge_types)
    # every hetero conv (num_layers + final) launches once per fused group and
    # once per single relation; onset pooling launches once
    expected = (len(model.encoder.layers) + 1) * (len(groups) + len(singles)) + 1
    results = {}
    segment_mean_base.launches = 0  # the main path's run starts here
    for notes in REQUEST_NOTES:
        na = synthetic_score(notes, seed=notes)
        before = segment_mean_base.launches
        native_before = build_note_edges_native.calls
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        ids = predict_score_ids(model, na, add_beats=False, add_measures=False,
                                bucket_factor=BUCKET_FACTOR, device="cuda")
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t
        launches = segment_mean_base.launches - before
        if launches != expected:
            raise AssertionError(f"{notes}-note request launched K1 {launches} times, expected {expected}")
        lat = []
        for _ in range(REPEATS):
            t = time.perf_counter()
            again = predict_score_ids(model, na, add_beats=False, add_measures=False,
                                      bucket_factor=BUCKET_FACTOR, device="cuda")
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t)
        peak = torch.cuda.max_memory_allocated()
        native_builds = build_note_edges_native.calls - native_before
        if native_builds != 1 + REPEATS:
            raise AssertionError(f"{notes}-note requests: {native_builds} native edge builds in {1 + REPEATS} requests")
        for k, v in ids.items():
            if v.shape != (notes,) or (v < 0).any() or not np.array_equal(v, again[k]):
                raise AssertionError(f"{notes}-note request: bad or unstable ids for {k}")
        edges = sum(ei.shape[1] for ei in build_score_graph(na, add_beats=False, add_measures=False).edges.values())
        results[notes] = {"edges": edges, "launches": launches, "median_s": statistics.median(lat),
                          "first_s": first_s, "peak_bytes": peak, "native_builds": native_builds}
        phase(f"serve: {notes} notes, {edges} note-note edges: K1 launches {launches} (expected {expected}), "
              f"first call {first_s * 1e3:.1f} ms, median of {REPEATS} {statistics.median(lat) * 1e3:.1f} ms, "
              f"max memory allocated {peak / 2**20:.1f} MiB; the C++ edge builder ran once a request")
    results["main_path_launches"] = segment_mean_base.launches
    if results["main_path_launches"] == 0:
        raise AssertionError("the serve phase never launched K1")
    return results


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
    for dev, m in (("cuda", model), ("cpu", cpu_model)):
        g = graph_from_note_array(na, add_beats=False, add_measures=False, bucket_factor=BUCKET_FACTOR, device=dev)
        a = g.node_attrs[NOTE]
        out = m(g.node_features, g.edge_index, a["pitch_spelling"], a["key_signature"], g.num_target_nodes)
        logits[dev] = {k: v[:notes].float().cpu() for k, v in out.items()}
    worst = 0.0
    for task, n_cls in model.task_dict:
        a, b = logits["cuda"][task], logits["cpu"][task]
        if a.shape != (notes, n_cls) or not torch.isfinite(a).all():
            raise AssertionError(f"logits of {task}: shape {tuple(a.shape)} or non-finite values")
        worst = max(worst, float((a - b).abs().max()))
    if worst > LOGIT_ATOL:
        raise AssertionError(f"GPU vs CPU logits differ by {worst:.3e} > {LOGIT_ATOL}")
    phase(f"serve: {notes}-note logits, GPU vs CPU port (plain versions, same weights): "
          f"max|d| = {worst:.3e} (tol {LOGIT_ATOL} abs), all 21 heads finite")
    return worst


def trace(model, notes: int, top: int = 10) -> None:
    """One request under torch.profiler (after the warm requests of the serve
    phase): host time of its stages, device busy time, kernels by device time."""
    from torch.profiler import ProfilerActivity, profile

    from analysisgnn_tpu_torch.data.note_array import synthetic_score
    from analysisgnn_tpu_torch.inference.predict import predict_score_ids

    na = synthetic_score(notes, seed=notes)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        predict_score_ids(model, na, add_beats=False, add_measures=False,
                          bucket_factor=BUCKET_FACTOR, device="cuda")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    # host side of each stage span (each span also has a device-side range, without host time)
    spans = {e.key: e.cpu_time_total / 1e3 for e in events
             if e.key.startswith("predict.") and e.device_type == torch.autograd.DeviceType.CPU}
    stages = ["predict.decode", "predict.decode.fetch", "predict.forward", "predict.graph", "predict.graph.edges",
              "predict.graph.features", "predict.graph.stage"]
    if sorted(spans) != stages or min(spans.values()) <= 0:
        raise AssertionError(f"the profiled request lacks its stage spans: {spans}")
    # kernel entries only: CPU ops and the spans' device-side ranges (user annotations) would count the same
    # time again
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        raise AssertionError("the profiled request shows no device time")
    phase(f"trace: {notes}-note request, wall {wall_ms:.2f} ms under the profiler; host spans: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in sorted(spans.items()))
          + f"; device busy {busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}% of the wall)")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    for e in kernels[:top]:
        phase(f"trace:   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} {e.key[:90]}")


# ----------------------------------------------------------------- training


def k3_bound_ms(n: int, f: int, g: int, t: int) -> tuple:
    """Least time for one K3 kernel's work at f32 accuracy: 2*T*N*F*G
    operations (each of the forward, dx, dw and d alpha does as many) in three
    TF32 passes on the tensor cores, or its inputs read and its output written
    once; and beside it the bound of the same work in f32 on the SIMT cores
    (what a plain f32 kernel could reach, beside the three-pass scheme)."""
    ops = 2 * t * n * f * g
    bytes_moved = 4 * (n * f + t * f * g + t * n + n * g)
    t_ops, t_bytes = 3 * ops / TF32_OPS_PER_S * 1e3, bytes_moved / HBM_BYTES_PER_S * 1e3
    f32_simt = max(ops / FP32_OPS_PER_S * 1e3, t_bytes)
    return ((t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")) + (f32_simt,)


def check_k3(name: str, n: int, f: int, g: int, t: int, timed: bool, strided: bool = False) -> dict:
    """K3's four kernels against the plain version (value and autograd
    gradients) on the same inputs, and two dw calls bit for bit; with
    ``strided``, x is a non-contiguous view.  With ``timed``, medians of each
    kernel's wrapper call, its device time, the plain version and a
    torch.einsum yardstick."""
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
    want = (ref_out.detach(), *torch.autograd.grad(ref_out, plain_leaves, gout, retain_graph=True))
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
    row = {"case": name, "N": n, "F": f, "G": g, "T": t, "max_abs_err": errs}
    line = (f"kernel check: K3 {name}: N={n} F={f} G={g} T={t}{' strided x' if strided else ''} max|d| "
            + " ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (tol {K3_RTOL} of the sum of |terms|); "
            "dw and d alpha bit-equal over two calls")
    if timed:
        bound, bound_by, f32_simt = k3_bound_ms(n, f, g, t)
        xp, wp, ap = plain_leaves
        # the plain version's gradients, each one backward of its einsum graph
        plain_grad = lambda leaf: (lambda: torch.autograd.grad(ref_out, leaf, gout, retain_graph=True))
        parts = {
            "forward": (lambda: relmm.rwm_forward(x, w, alpha),
                        lambda: relmm.relation_weighted_matmul_plain(x, w, alpha),
                        lambda: torch.einsum("tn,nf,tfg->ng", alpha, x, w)),
            "dx": (lambda: relmm.rwm_dx(gout, w, alpha), plain_grad(xp),
                   lambda: torch.einsum("tn,ng,tfg->nf", alpha, gout, w)),
            "dw": (lambda: relmm.rwm_dw(x, gout, alpha), plain_grad(wp),
                   lambda: torch.einsum("tn,nf,ng->tfg", alpha, x, gout)),
            "dalpha": (lambda: relmm.rwm_dalpha(x, w, gout), plain_grad(ap),
                       lambda: torch.einsum("nf,tfg,ng->tn", x, w, gout)),
        }
        # launches a call: dw and d alpha add the sum of their partials when they have several
        per_call = {"forward": 1, "dx": 1, "dw": 1 + (relmm.dw_splits(n, f, g, t) > 1),
                    "dalpha": 1 + (relmm.dalpha_splits(n, f, g) > 1)}
        row["timed"] = {}
        line += (f"\nkernel check:   K3 bound {bound:.4f} ms ({bound_by}, three TF32 passes at "
                 f"{TF32_OPS_PER_S / 1e12:.0f} TFLOP/s); f32 on the SIMT cores {f32_simt:.4f} ms")
        for part, (kernel, plain, library) in parts.items():
            r = {"ms": cuda_ms(kernel), "device_ms": device_ms(kernel, "rwm_", per_call=per_call[part]),
                 "plain_ms": cuda_ms(plain), "library_ms": cuda_ms(library),
                 "bound_ms": bound, "bound_by": bound_by, "bound_f32_simt_ms": f32_simt, "max_abs_err": errs[part]}
            row["timed"][part] = r
            line += (f"\nkernel check:   K3 {part}: kernel {r['ms']:.4f} ms a call, {r['device_ms']:.4f} ms on the "
                     f"device, plain {r['plain_ms']:.4f} ms, einsum yardstick {r['library_ms']:.4f} ms; "
                     f"{100 * bound / r['device_ms']:.1f}% of the bound on the device")
    for part in line.split("\n"):
        phase(part)
    return row


def k3_checks(n_train: int) -> list:
    rows = [check_k3("train shape", n_train, 256, 256, 7, timed=True)]
    # N not a multiple of the 128-row tile, below one tile, one row; T=1; F != G,
    # G not a tile multiple; F not a multiple of the 32-deep chunk, and F, G not
    # multiples of 4 (4-byte copies); x a non-contiguous view
    for name, n, f, g, t in (("N=300", 300, 256, 256, 7), ("T=1", 1000, 256, 256, 1),
                             ("F=64 G=96", 300, 64, 96, 3), ("F=40 G=24", 77, 40, 24, 2),
                             ("N=1", 1, 256, 256, 7), ("N=63", 63, 256, 256, 7), ("F=25 G=20", 65, 25, 20, 3)):
        rows.append(check_k3(name, n, f, g, t, timed=False))
    rows.append(check_k3("strided x", 300, 256, 256, 7, timed=False, strided=True))
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
    return {"E": e, "E_padding": int(padding.sum()), "F": f, "S": plan.num_segments, "max_abs_err": worst}


def k2_bound_ms(e_valid: int, h: int, f: int, n: int) -> tuple:
    """Least time for K2's work on this data: each valid edge's logits,
    message row and node id read once (padding edges are neither read nor
    needed), each node's output row, max and den written once."""
    bytes_moved = e_valid * (h + f + 1) * 4 + n * (f + 2 * h) * 4
    ops = e_valid * (3 * f + 4 * h) + n * (f + h)  # exp, weight and add per element; max per logit; divide per output
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_k2(name: str, logits, msgs, plan, timed: bool) -> dict:
    """K2's kernel against its plain version on the same inputs: the value and
    the autograd gradients of logits and msgs (padding gradients exactly 0),
    each within K2_RTOL of its sum of |terms|; with ``timed``, medians of the
    kernel and the plain version (forward)."""
    from analysisgnn_tpu_torch.kernels.softmax_agg import (
        segment_softmax_agg, segment_softmax_agg_plain, softmax_agg_forward,
    )

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
    row = {"case": name, "E": e, "E_valid": e_valid, "H": h, "F": f, "n": n, "blocks": plan.num_blocks,
           "max_abs_err": max(errs.values())}
    line = (f"kernel check: K2 {name}: E={e} (valid {e_valid}) H={h} F={f} n={n} blocks={plan.num_blocks} max|d| "
            + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + f" (tol {K2_RTOL} of the sum of |terms|), padding gradients exactly 0")
    if timed:
        row["ms"] = cuda_ms(lambda: softmax_agg_forward(logits, msgs, plan))
        row["device_ms"] = device_ms(lambda: softmax_agg_forward(logits, msgs, plan), "segment_softmax_agg_kernel")
        row["plain_ms"] = cuda_ms(lambda: segment_softmax_agg_plain(logits, msgs, plan))
        row["library_ms"] = None  # no single PyTorch call computes this function
        row["bound_ms"], row["bound_by"] = k2_bound_ms(e_valid, h, f, n)
        line += (f" | kernel {row['ms']:.4f} ms a call ({row['device_ms']:.4f} ms of it on the device), plain "
                 f"{row['plain_ms']:.4f} ms (no single PyTorch call computes it), bound {row['bound_ms']:.4f} ms "
                 f"({row['bound_by']}, {100 * row['bound_ms'] / row['device_ms']:.1f}% of the kernel's device time)")
    phase(line)
    return row


def k2_degrees(plan) -> dict:
    """What K2's work looks like on ``plan``'s data: each node's degree and its
    non-empty (block, node) ranges, the counts that bound its warp's chain of
    memory rounds."""
    n, b = plan.num_nodes, plan.num_blocks
    lengths = plan.row_ptr.long().view(b, n + 1).diff(dim=1)  # [B, n]: edges of node v in block b
    deg, ranges = lengths.sum(0).double(), (lengths > 0).sum(0).double()
    return {"mean_degree": float(deg.mean()), "max_degree": int(deg.max()), "p99_degree": float(deg.quantile(0.99)),
            "nodes_without_edges": int((deg == 0).sum()), "mean_nonempty_ranges": float(ranges.mean()),
            "max_nonempty_ranges": int(ranges.max())}


def k2_checks(batch) -> list:
    """K2 at the HGT train step's shape (the union softmax of one layer over
    ``batch``, with its degree statistics), at tests/test_pallas.py's case,
    and at edge cases: an empty node, a node with edges in every block, a
    block that is all padding; H = 3 (the scalar path); a node of degree 77
    over 10 ranges (three chunks of the kernel's walk, more ranges and edges
    than its prefetch depth); 40 blocks (the walk past 32 blocks) at H = 5."""
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
    degrees = k2_degrees(hgt.k2)
    phase("kernel check: K2 HGT train shape data: mean degree {mean_degree:.2f}, p99 {p99_degree:.0f}, max "
          "{max_degree}; {nodes_without_edges} nodes without edges; non-empty (block, node) ranges per node "
          "{mean_nonempty_ranges:.2f} on average, {max_nonempty_ranges} at most".format(**degrees))
    rows = [check_k2("HGT train shape", (torch.randn(e, h, generator=gen) * 2).to(dev),
                     torch.randn(e, f, generator=gen).to(dev), hgt.k2, timed=True)]
    rows[0]["degrees"] = degrees
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
                             torch.randn(ne, h * d, generator=gen).to(dev), plan, timed=False))
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


def _launch_counters():
    from analysisgnn_tpu_torch.kernels.halo import halo_pull as k6
    from analysisgnn_tpu_torch.kernels.relmm import relation_weighted_matmul as k3
    from analysisgnn_tpu_torch.kernels.segment_mean import segment_mean_base as k1
    from analysisgnn_tpu_torch.kernels.segment_softmax import segment_softmax_sorted as k5
    from analysisgnn_tpu_torch.kernels.segment_sum import segment_sum_sorted as k4
    from analysisgnn_tpu_torch.kernels.softmax_agg import segment_softmax_agg as k2

    return k1, k2, k3, k4, k5, k6


def _reset_counts() -> None:
    from analysisgnn_tpu_torch.train.graphed import GraphedStep

    k1, k2, k3, k4, k5, k6 = _launch_counters()
    k1.launches = k1.bf16_launches = k2.launches = k4.launches = k5.launches = k6.launches = 0
    k3.launches = k3.bf16_launches = k3.bf16_mma_launches = k3.dx_launches = k3.dw_launches = 0
    k3.dalpha_launches = 0
    GraphedStep.replays = 0


def _replayed() -> int:
    """Train steps since :func:`_reset_counts` that replayed a CUDA graph
    (``train/graphed.py``) without capturing it: the kernel counters count
    host launches, and such a step makes none."""
    from analysisgnn_tpu_torch.train.graphed import GraphedStep

    return GraphedStep.replays


def _counts() -> dict:
    k1, k2, k3, k4, k5, k6 = _launch_counters()
    return {"segment_mean_base": k1.launches, "segment_mean_base.bf16": k1.bf16_launches,
            "segment_softmax_agg": k2.launches, "relation_weighted_matmul": k3.launches,
            "relation_weighted_matmul.bf16": k3.bf16_launches,
            "relation_weighted_matmul.bf16_mma": k3.bf16_mma_launches, "relation_weighted_matmul.dx": k3.dx_launches,
            "relation_weighted_matmul.dw": k3.dw_launches, "relation_weighted_matmul.dalpha": k3.dalpha_launches,
            "segment_sum_sorted": k4.launches, "segment_softmax_sorted": k5.launches, "halo_pull": k6.launches}


def _conv_edge_types(model) -> tuple:
    """The relations of the encoder's hetero convs: every relation of the
    HybridGNN's, the note-to-note ones of the MetricalGNN's (its metrical
    convs are index_add_ scatters and scans in plain PyTorch)."""
    return model.encoder.note_edge_types if model.encoder_type == "metricalgnn" else model.edge_types


def predicted_launches(model, compute_dtype: str = "float32") -> dict:
    """Launches per train step the code predicts.  HybridGNN and MetricalGNN:
    every hetero conv (the layers and the final one) runs one K1 per single
    relation, plus one per fused group under "node" or one K3 forward, dx and
    dw per fused group under "edge-zxp"; no d alpha (the edge layout's alpha
    = 1 / max(count, 1) carries no gradient).  HybridHGT with K2: one K2 per
    layer (its backward is plain PyTorch).  All: onset pooling runs one K1;
    the GRUs of use_rnn launch none of the hand-written kernels.  Under bf16
    compute the first conv reads the bf16 projections: its K1 launches read
    bf16 rows and its K3 forwards take bf16 operands (the ``.bf16``
    counters: the wgmma kernel, since the model's widths are multiples of 8
    and its tensors aligned; the mma.sync kernel's ``.bf16_mma`` stays 0);
    every later conv reads f32 states (a mean over f32 counts), and so does
    onset pooling."""
    k1, k2, k3, k1_bf16, k3_bf16 = 1, 0, 0, 0, 0
    if model.encoder_type == "hgt":
        k2 = len(model.encoder.layers) if model.encoder.layers[0].use_pallas else 0
    else:
        per_conv_k1, per_conv_k3 = _per_conv(model)
        convs = len(model.encoder.layers) + 1
        k1 += convs * per_conv_k1
        k3 = convs * per_conv_k3
        if compute_dtype == "bfloat16":
            k1, k1_bf16, k3_bf16 = k1 - per_conv_k1, per_conv_k1, per_conv_k3
    return {"segment_mean_base": k1, "segment_mean_base.bf16": k1_bf16, "segment_softmax_agg": k2,
            "relation_weighted_matmul": k3 - k3_bf16, "relation_weighted_matmul.bf16": k3_bf16,
            "relation_weighted_matmul.bf16_mma": 0,
            "relation_weighted_matmul.dx": k3, "relation_weighted_matmul.dw": k3,
            "relation_weighted_matmul.dalpha": 0, "segment_sum_sorted": 0, "segment_softmax_sorted": 0,
            "halo_pull": 0}


def _per_conv(model) -> tuple:
    """K1 and K3-forward launches of one hetero conv: one K1 per single
    relation, plus one per fused group under "node" or one K3 forward per
    fused group under "edge-zxp"."""
    from analysisgnn_tpu_torch.models.hetero import fusion_groups

    groups, singles = fusion_groups(_conv_edge_types(model))
    return (len(singles) + (len(groups) if model.conv_impl == "node" else 0),
            len(groups) if model.conv_impl == "edge-zxp" else 0)


def remat_launches(model, compute_dtype: str = "float32") -> dict:
    """Launches a backward adds under a HybridGNN's remat (a train step or a
    fisher batch; a pass without gradients recomputes nothing): each hidden
    conv (not the final one) runs its forward kernels once more, on bf16
    rows in layer 0 under bf16 compute."""
    names = ("segment_mean_base", "segment_mean_base.bf16", "relation_weighted_matmul",
             "relation_weighted_matmul.bf16")
    out = dict.fromkeys(names, 0)
    if model.encoder_type != "hybridgnn" or not model.encoder.remat:
        return out
    per_conv_k1, per_conv_k3 = _per_conv(model)
    hidden = len(model.encoder.layers)
    first = 1 if compute_dtype == "bfloat16" else 0  # layer 0 reads the bf16 projections
    out.update({"segment_mean_base": (hidden - first) * per_conv_k1, "segment_mean_base.bf16": first * per_conv_k1,
                "relation_weighted_matmul": (hidden - first) * per_conv_k3,
                "relation_weighted_matmul.bf16": first * per_conv_k3})
    return out


def step_launches(model, compute_dtype: str = "float32") -> dict:
    """Launches of one train step: :func:`predicted_launches` and the
    recomputed forwards of remat."""
    rec = remat_launches(model, compute_dtype)
    return {k: v + rec.get(k, 0) for k, v in predicted_launches(model, compute_dtype).items()}


def train(arm: str, batches: list) -> dict:
    """One warm-up step, then the timed steps on fresh batches (the main
    path's run, with the launch counts read around it); for edge-zxp and hgt
    also FALL_STEPS steps on one fixed batch, whose loss must fall."""
    from analysisgnn_tpu_torch.core.graph import NOTE
    from analysisgnn_tpu_torch.train.schedules import warmup_cosine_schedule
    from analysisgnn_tpu_torch.train.state import make_optimizer

    model = _train_model(arm, TRAIN_CFG["dropout"], "cuda")
    compute = "bfloat16" if arm in BF16_PAIRS else "float32"
    state, step = _trainer(model, make_optimizer(warmup_cosine_schedule(5e-3, total_steps=1000)), compute)
    state, aux = step(state, batches[0])
    torch.cuda.synchronize()
    k = TIMED_STEPS[arm]
    timed = batches[1:1 + k]
    _reset_counts()  # the main path's run starts here
    times, losses, skipped = [], [], 0.0
    for b in timed:
        t = time.perf_counter()
        state, aux = step(state, b)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        losses.append(float(aux["total_loss"]))
        skipped += float(aux["skipped_nonfinite"])
    counts = _counts()
    expected = step_launches(model, compute)
    # the first timed step captures its CUDA graph (launching from the host once); replays launch nothing there
    host = k - _replayed()
    if counts != {name: host * v for name, v in expected.items()}:
        raise AssertionError(f"{arm}: launches {counts} over {host} of {k} steps launched from the host, the code "
                             f"predicts {expected} a step")
    per_step = {name: c / max(host, 1) for name, c in counts.items()}
    if not all(np.isfinite(losses)) or skipped:
        raise AssertionError(f"{arm}: non-finite loss {losses}")
    # bench.py:191-194: valid message edges per step, every edge type once
    edges = statistics.mean(sum(b.num_edges.values()) for b in timed)
    ms = statistics.median(times) * 1e3
    if compute != "float32" and not all(p.dtype == torch.float32 for p in model.parameters()):
        raise AssertionError(f"{arm}: a master parameter left float32")
    row = {"arm": arm, "compute_dtype": compute, "steps": k, "median_ms": ms, "step_ms": [t * 1e3 for t in times],
           "edges_per_step": edges, "edges_per_s": edges / (ms / 1e3), "launches": counts,
           "launches_per_step": per_step, "losses": losses, "notes": batches[0].capacity(NOTE)}
    phase(f"train {arm}: {k} steps after one warm-up: median {ms:.2f} ms/step "
          f"(each {', '.join(f'{t * 1e3:.1f}' for t in times)}), {edges:.0f} valid message edges per step, "
          f"{row['edges_per_s']:.4g} edges/s; losses {', '.join(f'{v:.4f}' for v in losses)}")
    phase(f"train {arm}: launches per step launched from the host ({host} of {k}; the others replayed a CUDA graph) "
          f"{per_step} (the code predicts the same); "
          f"max memory allocated {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    row["model"], row["state"], row["step"] = model, state, step
    if arm in FALL_ARMS:
        fixed = batches[0]
        fall = []
        for _ in range(FALL_STEPS):
            state, aux = step(state, fixed)
            fall.append(float(aux["total_loss"]))
        first, last = statistics.mean(fall[:3]), statistics.mean(fall[-3:])
        if not (all(np.isfinite(fall)) and last < first):
            raise AssertionError(f"{arm}: loss on one fixed batch did not fall over {FALL_STEPS} steps: {fall}")
        row["fall"] = fall
        phase(f"train {arm}: {FALL_STEPS} steps on one batch: loss {fall[0]:.4f} -> {fall[-1]:.4f} "
              f"(mean of the first 3 {first:.4f}, of the last 3 {last:.4f})")
    return row


def step_parity(arm: str, batch, state_dict=None) -> dict:
    """One step of the arm on the GPU (kernels) against the same step on the
    CPU (plain versions): same weights (the arm's init, or ``state_dict``),
    same batch, dropout 0, constant rate."""
    from analysisgnn_tpu_torch.train.state import ClippedAdamW

    model = _train_model(arm, 0.0, "cpu")
    if state_dict is not None:
        model.load_state_dict({k: v.cpu() for k, v in state_dict.items()})
    gpu_model = _train_model(arm, 0.0, "cuda")
    gpu_model.load_state_dict(model.state_dict())
    start = {k: v.detach().clone() for k, v in model.state_dict().items()}
    compute = "bfloat16" if arm in BF16_PAIRS else "float32"
    out = {}
    for dev, m, b in (("cuda", gpu_model, batch), ("cpu", model, batch.to("cpu"))):
        state, step = _trainer(m, ClippedAdamW(lambda _step: PARITY_LR, eps=PARITY_EPS), compute)
        t = time.perf_counter()
        state, aux = step(state, b)
        out[dev] = (float(aux["total_loss"]), {k: v.detach().cpu() for k, v in m.state_dict().items()},
                    state.mt_params.detach().cpu(), time.perf_counter() - t)
    loss_g, params_g, mt_g, _ = out["cuda"]
    loss_c, params_c, mt_c, cpu_s = out["cpu"]
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
              f"{BF16_PARITY_LOSS_RTOL}); parameter updates {upd:.3e} relative L2 (tol {BF16_PARITY_UPDATE_RTOL}); "
              f"CPU step {cpu_s:.1f} s")
        return {"loss_rel": rel, "update_rel_l2": upd}
    worst = max(float((params_g[k] - params_c[k]).abs().max()) for k in params_c)
    worst = max(worst, float((mt_g - mt_c).abs().max()))
    if not (np.isfinite(loss_g) and rel <= PARITY_LOSS_RTOL and worst <= PARITY_PARAM_ATOL):
        raise AssertionError(f"GPU vs CPU train step: loss {loss_g} vs {loss_c} (rel {rel:.2e}, "
                             f"tol {PARITY_LOSS_RTOL}), "
                             f"parameters max|d| {worst:.3e} (tol {PARITY_PARAM_ATOL})")
    phase(f"train: one {arm} step, GPU vs CPU (plain versions, same weights and batch, dropout 0, lr {PARITY_LR}, "
          f"eps {PARITY_EPS}): "
          f"loss {loss_g:.6f} vs {loss_c:.6f} (rel {rel:.2e}, tol {PARITY_LOSS_RTOL}); every parameter and mt_params "
          f"max|d| {worst:.3e} (tol {PARITY_PARAM_ATOL} abs); CPU step {cpu_s:.1f} s")
    return {"loss_rel": rel, "param_max_abs": worst}


def trace_forward(fn, label: str, prefix: str, top: int, group: str = "", op=()) -> dict:
    """One call of ``fn`` under torch.profiler: the device's busy share of its
    wall time and its kernels by device time, printed after ``prefix``; with
    ``group``, the summed device time of the kernels whose names contain it;
    with ``op`` (a host op's name, such as ``aten::gru``, or a tuple of
    them), the device time of every kernel launched under those ops."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILER_ATTEMPTS):  # a window that holds no kernel record (see device_ms) is taken again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
        events = prof.key_averages()
        # a record_function span shows as a device-side range too; the profiler flags it as a user annotation
        kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        if busy_ms > 0:
            break
        phase(f"{prefix}: the profiler's window around {label} held no kernel record; taking it again")
    if busy_ms <= 0:
        raise AssertionError(f"the profiled {label} shows no device time")
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    launches = sum(e.count for e in kernels)
    phase(f"{prefix}: {label}, wall {wall_ms:.2f} ms under the profiler, device busy {busy_ms:.2f} ms "
          f"({100 * busy_ms / wall_ms:.1f}% of the wall), {launches} kernel launches")
    for e in kernels[:top]:
        phase(f"{prefix}:   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")
    row = {"wall_ms": wall_ms, "busy_ms": busy_ms, "launches": launches}
    if group:
        members = [e for e in kernels if group in e.key]
        row["group_ms"] = sum(e.self_device_time_total for e in members) / 1e3
        phase(f"{prefix}: {group}* kernels {row['group_ms']:.3f} ms of the {busy_ms:.2f} ms busy, "
              f"{sum(e.count for e in members)} launches")
    if op:
        ops = (op,) if isinstance(op, str) else op
        under = [e for e in events if e.key in ops and e.device_type == torch.autograd.DeviceType.CPU]
        if not under:
            raise AssertionError(f"the profiled {label} ran none of {ops}")
        row["op_ms"] = sum(e.device_time_total for e in under) / 1e3
        row["op_calls"] = sum(e.count for e in under)
        phase(f"{prefix}: kernels under {' and '.join(sorted({e.key for e in under}))} ({row['op_calls']} calls) "
              f"{row['op_ms']:.3f} ms of the "
              f"{busy_ms:.2f} ms busy ({100 * row['op_ms'] / busy_ms:.1f}%)")
    return row


def trace_train(row: dict, batch, top: int = 12) -> dict:
    """One step of the arm under torch.profiler: the device's busy share of
    the step and its kernels by device time (and K3's summed, edge-zxp).
    The step replays its CUDA graph where the arm's timed steps captured
    one for this batch's signature; the use_rnn arm traces its eager step,
    whose GRU kernels run under host ops to count them by (a replay runs
    the same kernels and no host op).  The phase line says which ran."""
    state, step = row["state"], row["step"]
    group = "rwm_" if ARMS[row["arm"]].get("conv_impl") == "edge-zxp" else ""
    # use_rnn's GRUs: cuDNN's cell kernels and cuBLAS products, under the forward's and the backward's cuDNN ops
    gru = ("aten::gru", "aten::_cudnn_rnn_backward") if ARMS[row["arm"]].get("use_rnn") else ()
    run = getattr(step, "eager", step) if gru else step
    replays = _replayed()
    traced = trace_forward(lambda: run(state, batch), f"one {row['arm']} step", "train trace", top, group, gru)
    traced["replayed"] = _replayed() > replays
    phase(f"train trace: the traced {row['arm']} step "
          f"{'replayed its CUDA graph' if traced['replayed'] else 'ran eagerly'}")
    return traced


# ------------------------------------------------------------- K4 and K5


def k4_bound_ms(e_valid: int, f: int, n: int) -> tuple:
    """Least time for K4's work on this data: the in-range edges' messages and
    ids read once (out-of-range ids are neither read nor needed), each
    node's row written once."""
    bytes_moved = e_valid * (f + 1) * 4 + n * f * 4
    ops = e_valid * f  # one add per message element
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_k4(name: str, msgs, dst, n: int, timed: bool) -> dict:
    """K4's kernel against its plain version on the same inputs, within
    K4_RTOL of each output element's sum of |terms|; with ``timed``, medians
    of the kernel, the plain version and an index_add_ yardstick."""
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
    valid = (dst >= 0) & (dst < n)
    e_valid = int(valid.sum())
    row = {"case": name, "E": e, "E_valid": e_valid, "F": f, "n": n, "max_abs_err": float(err.max()) if err.numel() else 0.0}
    line = (f"kernel check: K4 {name}: E={e} (in range {e_valid}) F={f} n={n} max|d|={row['max_abs_err']:.3e} "
            f"(tol {K4_RTOL} of the sum of |terms|)")
    if timed:
        ids, mv = dst[valid].long(), msgs[valid]
        row["ms"] = cuda_ms(lambda: segment_sum_sorted(msgs, dst, n))
        row["plain_ms"] = cuda_ms(lambda: segment_sum_sorted_plain(msgs, dst, n))
        # yardstick only, never called by the port: index_add_ into a zeroed output
        row["library_ms"] = cuda_ms(lambda: torch.zeros((n, f), device=msgs.device).index_add_(0, ids, mv))
        row["device_ms"] = device_ms(lambda: segment_sum_sorted(msgs, dst, n), "segment_mean_base_kernel")
        row["bound_ms"], row["bound_by"] = k4_bound_ms(e_valid, f, n)
        line += (f" | kernel {row['ms']:.4f} ms ({row['device_ms']:.4f} ms of it on the device), plain "
                 f"{row['plain_ms']:.4f} ms, index_add_ yardstick {row['library_ms']:.4f} ms, bound "
                 f"{row['bound_ms']:.4f} ms ({row['bound_by']}, {100 * row['bound_ms'] / row['ms']:.1f}% of the "
                 f"kernel's time, {100 * row['bound_ms'] / row['device_ms']:.1f}% of its device time)")
    phase(line)
    return row


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
                     dst, plan.num_segments, timed=True)]
    cases = [
        ("test_pallas.py case", torch.randint(0, 300, (2000,), generator=gen).sort().values, 300, 64),
        ("empty nodes", torch.tensor([0] * 5 + [100] * 5), 128, 32),
        ("F=25", torch.randint(0, 500, (3000,), generator=gen).sort().values, 500, 25),
        ("ids past num_nodes and negative", torch.tensor([-3, -1, 0, 0, 5, 299, 300, 300, 400]), 300, 16),
        ("no edges", torch.zeros(0, dtype=torch.long), 40, 16),
    ]
    for name, ids, n, f in cases:
        msgs = torch.ones(len(ids), f) if name == "empty nodes" else torch.randn(len(ids), f, generator=gen)
        rows.append(check_k4(name, msgs.to(dev), ids.to(torch.int32).to(dev), n, timed=False))
    return rows


def k5_bound_ms(e: int, h: int) -> tuple:
    """Least time for K5's work: each logit and id read once, each weight
    written once; about seven operations per logit (max, two subtracts, two
    exps, an add, a divide)."""
    bytes_moved = e * (2 * h + 1) * 4
    ops = 7 * e * h
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_k5(name: str, logits, dst, n: int, timed: bool) -> dict:
    """K5's kernel against its plain version within K5_ATOL, and the weights
    of every run of equal ids summing to 1 in every head whose logits are
    not all -inf (those weigh 0); with ``timed``, medians of the kernel's
    call and the plain version, and the profiler's device time of a call,
    which must launch K5's kernel once and no other kernel."""
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
    row = {"case": name, "E": e, "H": h, "n": n, "max_abs_err": err, "sum_err": sum_err}
    line = (f"kernel check: K5 {name}: E={e} H={h} n={n} max|d|={err:.3e} (tol {K5_ATOL} abs), weights of each "
            f"destination sum to 1 within {sum_err:.1e} (tol {K5_SUM_ATOL})")
    if timed:
        ids64 = dst.long()  # the call converts int64 ids to int32 first: one more kernel a call
        row["ms"] = cuda_ms(lambda: segment_softmax_sorted(logits, dst, n))
        row["int64_ids_ms"] = cuda_ms(lambda: segment_softmax_sorted(logits, ids64, n))
        row["plain_ms"] = cuda_ms(lambda: segment_softmax_sorted_plain(logits, dst, n))
        row["library_ms"] = None  # no single PyTorch call computes a segment softmax
        row["device_ms"] = device_ms(lambda: segment_softmax_sorted(logits, dst, n), "segment_softmax_kernel",
                                     alone=True)
        row["bound_ms"], row["bound_by"] = k5_bound_ms(e, h)
        line += (f" | kernel {row['ms']:.4f} ms ({row['device_ms']:.4f} ms of it on the device, one launch a "
                 f"call and no other kernel; {row['int64_ids_ms']:.4f} ms a call with int64 ids), plain "
                 f"{row['plain_ms']:.4f} ms (no single PyTorch call computes it), bound {row['bound_ms']:.5f} ms "
                 f"({row['bound_by']}, {100 * row['bound_ms'] / row['ms']:.1f}% of the kernel's time, "
                 f"{100 * row['bound_ms'] / row['device_ms']:.1f}% of its device time)")
    phase(line)
    return row


def k5_union(edge_index, capacities) -> tuple:
    """The sorted valid union edges of the HGT model's ``emax`` plan of a
    graph: K5's destination ids, and the node count."""
    from analysisgnn_tpu_torch.core.graph import metadata
    from analysisgnn_tpu_torch.models.encoders import plan_hgt

    _, model_edges = metadata(HGT_CFG["add_beats"], HGT_CFG["add_measures"])
    k2 = plan_hgt(edge_index, model_edges, capacities, "emax").k2
    return k2.node[k2.node < k2.num_nodes].sort().values, k2.num_nodes


def k5_timed_shapes(batch) -> list:
    """K5's two timed shapes, as ``(name, sorted int64 ids on the card, node
    count)``: the HGT layer's valid union edges of a train batch (H = 4) and
    those of the serve phase's 20,000-note score, whose bytes bound lies above
    the single-launch floor."""
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
    """K5 at its two timed shapes (``k5_timed_shapes``), at tests/
    test_pallas.py's two cases, and at edge cases: the kernel's slices of 32
    edges and its registers (the tails of up to 32 edges past a slice) at
    their ends, heads that are not a power of two or span two grid rows,
    -inf logits."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(5)
    rows = []
    for name, dst, n in k5_timed_shapes(batch):
        logits = (torch.randn(dst.shape[0], 4, generator=gen) * 2).to(dev)
        rows.append(check_k5(name, logits, dst.to(torch.int32), n, timed=True))
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
        rows.append(check_k5(name, logits.to(dev), ids.to(dev), n, timed=False))
    # -inf logits: whole runs (in registers and online) and parts of runs
    ids = torch.tensor([0] * 3 + [1] * 200 + [2] * 5 + [3] * 150)
    logits = torch.randn(len(ids), 4, generator=gen) * 3
    logits[:3] = -math.inf
    logits[3:203, :2] = -math.inf
    logits[203:205] = -math.inf
    logits[208::3] = -math.inf
    rows.append(check_k5("-inf logits", logits.to(dev), ids.to(torch.int32).to(dev), 4, timed=False))
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


def _forward_passes(dm, epochs: int, evaluated: bool) -> int:
    """Forward-only passes of a Trainer run: the validation batches after each
    epoch and, if it evaluated the test split once, its batches (batch size
    1)."""
    per_task_bs = max(dm.cfg.batch_size // max(len(dm.main_tasks), 1), 1)
    val = sum(math.ceil(len(va) / per_task_bs) for _, va, _ in dm.splits.values())
    test = sum(len(te) for _, _, te in dm.splits.values())
    return epochs * val + (test if evaluated else 0)


def _check_trainer_launches(label: str, trainer, counts: dict, epochs: int, evaluated: bool, teacher_passes: int = 0,
                            fisher_passes: int = 0) -> dict:
    """The run's launches against the code's prediction: every train step,
    every forward-only pass, every teacher forward (continual learning, after
    the first task) and every fisher batch (EWC's replay) launch the forward
    kernels; only train steps and fisher batches launch K3's dx and dw, and
    under remat the hidden convs' forward kernels once more."""
    per = predicted_launches(trainer.model)
    rec = remat_launches(trainer.model)
    replayed = _replayed()
    steps = len(trainer.step_seconds) - replayed  # a replayed CUDA graph launches nothing from the host
    fwd = _forward_passes(trainer.dm, epochs, evaluated)
    expected = {name: (steps + teacher_passes + fwd + fisher_passes) * v + (steps + fisher_passes) * rec.get(name, 0)
                for name, v in per.items()}
    for name in ("relation_weighted_matmul.dx", "relation_weighted_matmul.dw"):
        expected[name] = (steps + fisher_passes) * per[name]
    passes = (f"{steps} train steps ({replayed} more replayed a CUDA graph), {teacher_passes} teacher forwards, "
              f"{fwd} forward-only passes and {fisher_passes} fisher batches")
    if counts != expected:
        raise AssertionError(f"{label}: launches {counts}, the code predicts {expected} ({passes})")
    phase(f"{label}: {passes} launched "
          + ", ".join(f"{k} {v}" for k, v in counts.items() if v)
          + f" (per pass {', '.join(f'{k} {v}' for k, v in per.items() if v)}; the code predicts the same)")
    return {"steps": steps, "replayed": replayed, "teacher_passes": teacher_passes, "forward_passes": fwd,
            "fisher_passes": fisher_passes,
            "launches": counts, "per_step": per, "remat_per_backward": rec}


def _cl_passes(trainer, steps_per_epoch: int) -> tuple:
    """Teacher forwards and fisher batches of a continual-learning run: the
    teacher runs on every train step after the first task (when the
    distillation has a weight); each switch replays the first validation
    batch of every task seen so far (with EWC)."""
    cfg, dm = trainer.cfg, trainer.dm
    tasks = [t for t in cfg.main_tasks if t in dm.main_tasks]
    teacher = sum(steps_per_epoch for r in trainer.history if r["task"] != tasks[0]) if cfg.lambda_dctn > 0 else 0
    fisher = sum(1 for ti in range(len(tasks) - 1) for mt in tasks[:ti + 1] if dm.splits[mt][1]) if cfg.use_ewc else 0
    return teacher, fisher


def trainer_phase(ckpt_dir: str) -> dict:
    """The training entry point at full width on the card, then its last.pt
    served once."""
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
    t = time.perf_counter()
    try:
        _reset_counts()  # the Trainer path's run starts here
        with contextlib.redirect_stdout(printed):  # --do_eval prints the test metrics as JSON
            trainer = train_main([*TRAINER_FLAGS, "--checkpoint_dir", ckpt_dir])
        torch.cuda.synchronize()
        counts = _counts()
    finally:
        step_mod._edge_loss = edge_loss
    wall = time.perf_counter() - t
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
    epochs = len(hist)
    launches = _check_trainer_launches("trainer", trainer, counts, epochs, evaluated=True)
    with open(f"{ckpt_dir}/log.jsonl") as f:
        logged = [json.loads(line) for line in f]
    keys = sorted(logged[0])
    losses = [r["train_loss"] for r in hist] + [r["val/total_loss"] for r in hist]
    if logged != hist or not all(np.isfinite(losses)) or any(set(r) != set(keys) for r in logged):
        raise AssertionError(f"trainer: log.jsonl differs from the history or holds a non-finite loss: {losses}")
    steps_ms = [x * 1e3 for x in trainer.step_seconds]
    per_epoch = len(steps_ms) // epochs
    median_ms = statistics.median(steps_ms[per_epoch:] or steps_ms)  # after the first epoch's warm-up
    phase(f"trainer: cli.train.main {' '.join(TRAINER_FLAGS)}: {epochs} epochs of {per_epoch} train steps in "
          f"{wall:.2f} s (build of the demo corpus included); seconds per epoch "
          + ", ".join(f"{r['secs']}" for r in hist)
          + f"; median {median_ms:.2f} ms per train step after the first epoch "
          f"(first step {steps_ms[0]:.1f} ms); train_loss " + ", ".join(f"{r['train_loss']:.4f}" for r in hist)
          + "; val/total_loss " + ", ".join(f"{r['val/total_loss']:.4f}" for r in hist))
    phase(f"trainer: log.jsonl keys ({len(keys)}): {', '.join(keys[:6])}, ... {', '.join(keys[-3:])}")
    phase(f"trainer: --do_eval test metrics ({len(test_metrics)} keys): "
          + ", ".join(f"{k} {test_metrics[k]:.4f}" for k in ("all/cadence_acc", "all/localkey_f1", "all/rna_onset_acc",
                                                           "all/rna_nct_acc") if k in test_metrics))

    _reset_counts()  # the serve path's run starts here
    model, cfg = load_model(ckpt_dir, "last", "cuda")
    na = synthetic_score(2000, seed=7)
    t = time.perf_counter()
    ids = predict_score_ids(model, na, add_beats=cfg["add_beats"], add_measures=cfg["add_measures"], device="cuda")
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t) * 1e3
    served = _counts()
    per = predicted_launches(model)
    expected = {k: v if k in ("segment_mean_base", "relation_weighted_matmul") else 0 for k, v in per.items()}
    if served != expected:
        raise AssertionError(f"serving last.pt launched {served}, the code predicts {expected}")
    if any(v.shape != (2000,) or (v < 0).any() for v in ids.values()):
        raise AssertionError("serving last.pt: bad ids")
    phase(f"trainer: last.pt through cli/predict.py's load_model served a 2000-note request in {serve_ms:.1f} ms "
          f"(first call), {len(ids)} id columns, launches {', '.join(f'{k} {v}' for k, v in served.items() if v)}")
    return {"epochs": epochs, "secs": [r["secs"] for r in hist], "median_step_ms": median_ms,
            "train_loss": [r["train_loss"] for r in hist], "val_total_loss": [r["val/total_loss"] for r in hist],
            "launches": launches, "serve_ms": serve_ms, "wall_s": wall, "edge_terms": len(edge_terms)}


def hgt_trainer_phase(ckpt_dir: str) -> dict:
    """One epoch of the training entry point with the HybridHGT and K2."""
    from analysisgnn_tpu_torch.cli.train import main as train_main

    t = time.perf_counter()
    _reset_counts()  # the HGT Trainer path's run starts here
    trainer = train_main([*HGT_TRAINER_FLAGS, "--checkpoint_dir", ckpt_dir])
    torch.cuda.synchronize()
    counts = _counts()
    wall = time.perf_counter() - t
    launches = _check_trainer_launches("trainer HGT", trainer, counts, len(trainer.history), evaluated=False)
    rec = trainer.history[-1]
    if not (np.isfinite(rec["train_loss"]) and np.isfinite(rec["val/total_loss"])):
        raise AssertionError(f"trainer HGT: non-finite loss {rec['train_loss']}, {rec['val/total_loss']}")
    steps_ms = [x * 1e3 for x in trainer.step_seconds]
    median_ms = statistics.median(steps_ms[1:] or steps_ms)
    phase(f"trainer HGT: cli.train.main {' '.join(HGT_TRAINER_FLAGS)} (q, k, v and the typed transforms staged in "
          f"bf16): {len(trainer.history)} epoch of "
          f"{len(steps_ms)} train steps in {wall:.2f} s, {rec['secs']} s for the epoch; median {median_ms:.2f} ms "
          f"per train step after the first; train_loss {rec['train_loss']:.4f}, val/total_loss "
          f"{rec['val/total_loss']:.4f}")
    if any(layer.stage != torch.bfloat16 for layer in trainer.model.encoder.layers):
        raise AssertionError("trainer HGT: the layers do not stage in bf16")
    return {"secs": rec["secs"], "median_step_ms": median_ms, "launches": launches, "wall_s": wall}


def trainer_parity(ckpt_dir: str, flags: list = TRAINER_PARITY_FLAGS, label: str = "trainer",
                   eps: "float | None" = None) -> dict:
    """A fit of 2 steps an epoch on the GPU (kernels) against the same on the
    CPU (plain versions): dropout 0, the same initial state dict, and with
    ``eps`` the optimizer's eps raised to it (see PARITY_EPS); every epoch's
    train and validation loss within TRAINER_PARITY_RTOL.  The GPU arm's
    launches are counted."""
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
        _reset_counts()  # the GPU arm's run starts here
        t = time.perf_counter()
        state = trainer.fit(max_steps_per_epoch=2, initial_state_dict=init)
        if dev == "cuda":
            torch.cuda.synchronize()
        out[side] = {"trainer": trainer, "state": state, "secs": time.perf_counter() - t, "counts": _counts()}
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
          + f" (tol {TRAINER_PARITY_RTOL}); the CPU fit took {out['cpu']['secs']:.1f} s")
    return {"rels": rels, **out}


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
    gen_s = write_synth_corpus(raw)
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
    build, build_s = cli.build_datamodule, []

    def timed_build(config):
        t0 = time.perf_counter()
        dm = build(config)
        build_s.append(time.perf_counter() - t0)
        return dm

    printed = io.StringIO()
    t = time.perf_counter()
    cli.build_datamodule = timed_build
    blocked = sys.modules.get("wandb", False)
    sys.modules["wandb"] = None  # any import of wandb raises ImportError
    _reset_counts()  # the raw-dir Trainer path's run starts here
    try:
        with contextlib.redirect_stdout(printed):  # --do_eval prints the test metrics as JSON
            trainer = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        cli.build_datamodule = build
        if blocked is False:
            del sys.modules["wandb"]
        else:
            sys.modules["wandb"] = blocked
    counts = _counts()
    wall = time.perf_counter() - t
    samples = trainer.dm.task_samples["all"]
    per_interval = collections.Counter(s.transposition for s in samples)
    if len(samples) != 227 or per_interval != RAW_DIR_COUNTS:
        raise AssertionError(f"raw-dir trainer: {len(samples)} samples {dict(per_interval)}, want 227 "
                             f"{RAW_DIR_COUNTS}")
    pandas = importlib.util.find_spec("pandas")
    phase(f"raw-dir trainer: --use_wandb with wandb's import blocked trained to the end (wandb installed on this "
          f"host: {wandb_installed}); corpus of {len(samples)} samples "
          f"from {len(os.listdir(f'{raw}/all'))} DLC TSVs "
          f"built in {build_s[0]:.2f} s (" + ", ".join(f"{k} {v}" for k, v in per_interval.items())
          + f"); test pieces {sorted(s.name for s in samples if s.test)}; pandas importable on this host: "
          f"{pandas is not None}{f' ({pandas.origin})' if pandas else ''} (the port does not use it)")
    text = printed.getvalue()
    test_metrics = json.loads(text[text.index("{"):])
    if not test_metrics or not all(np.isfinite(v) for v in test_metrics.values()):
        raise AssertionError("raw-dir trainer: --do_eval printed no or non-finite test metrics")
    hist = trainer.history
    epochs = len(hist)
    launches = _check_trainer_launches("raw-dir trainer", trainer, counts, epochs, evaluated=True)
    losses = [r["train_loss"] for r in hist] + [r["val/total_loss"] for r in hist]
    if epochs != RAW_DIR_EPOCHS or not all(np.isfinite(losses)):
        raise AssertionError(f"raw-dir trainer: {epochs} epochs, losses {losses}")
    steps_ms = [x * 1e3 for x in trainer.step_seconds]
    per_epoch = len(steps_ms) // epochs
    median_ms = statistics.median(steps_ms[per_epoch:])  # after the first epoch's warm-up
    phase(f"raw-dir trainer: cli.train.main {' '.join(RAW_DIR_FLAGS)} --num_epochs {RAW_DIR_EPOCHS}: {epochs} epochs "
          f"of {per_epoch} train steps in {wall:.2f} s (corpus build included); seconds per epoch "
          + ", ".join(f"{r['secs']}" for r in hist)
          + f"; median {median_ms:.2f} ms per train step after the first epoch (first step {steps_ms[0]:.1f} ms); "
          "train_loss " + ", ".join(f"{r['train_loss']:.4f}" for r in hist)
          + "; val/total_loss " + ", ".join(f"{r['val/total_loss']:.4f}" for r in hist))
    phase(f"raw-dir trainer: --do_eval test metrics ({len(test_metrics)} keys): "
          + ", ".join(f"{k} {test_metrics[k]:.4f}" for k in ("all/localkey_acc", "all/degree1_acc", "all/cadence_acc",
                                                           "all/rna_onset_acc") if k in test_metrics))
    t = time.perf_counter()
    cached = cli.build_datamodule(cli.resolve_config(argv))
    cache_s = time.perf_counter() - t
    markers = [f for f in os.listdir(f"{raw}/.cache") if f.endswith(".done")]
    if len(markers) != 24:
        raise AssertionError(f"raw-dir trainer: {len(markers)} .done markers in the cache, want 24")
    _same_samples(samples, cached.task_samples["all"])
    phase(f"raw-dir trainer: a second build_datamodule read the cache ({len(markers)} .done markers) in "
          f"{cache_s:.2f} s, its {len(cached.task_samples['all'])} samples array for array the built ones")
    return {"samples": len(samples), "build_s": build_s[0], "cache_s": cache_s, "epochs": epochs,
            "steps_per_epoch": per_epoch, "median_step_ms": median_ms, "secs": [r["secs"] for r in hist],
            "launches": launches, "wall_s": wall, "flags": [*data, *RAW_DIR_FLAGS], "raw": raw, "gen_s": gen_s}


def write_synth_corpus(raw: str) -> float:
    """data_synth/ written by the port's generator as scripts/parity_experiment.py
    writes it (24 pieces of 10 phrases, seed 7, test fraction 0.2), held byte
    for byte against the committed files; returns the generator's seconds."""
    from analysisgnn_tpu_torch.data import synth_dlc

    t = time.perf_counter()
    split = synth_dlc.write_corpus(f"{raw}/all", 24, 10, seed=7, test_fraction=0.2)
    with open(f"{raw}/test_split.json", "w") as f:
        json.dump(split["test"], f)
    gen_s = time.perf_counter() - t
    committed = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data_synth")
    names = sorted(os.listdir(f"{committed}/all"))
    if sorted(os.listdir(f"{raw}/all")) != names or len(names) != 24:
        raise AssertionError(f"synth corpus: wrote {sorted(os.listdir(f'{raw}/all'))}, committed {names}")
    for rel in [f"all/{n}" for n in names] + ["test_split.json"]:
        with open(f"{raw}/{rel}", "rb") as a, open(f"{committed}/{rel}", "rb") as b:
            if a.read() != b.read():
                raise AssertionError(f"synth corpus: {rel} differs from the committed data_synth/{rel}")
    phase(f"raw-dir trainer: data_synth/ written by the port's synth_dlc.write_corpus in {gen_s:.3f} s, all "
          f"{len(names)} TSVs and test_split.json byte-equal to the committed files")
    return gen_s


# ------------------------------------------------- continual-learning training


def cl_trainer_phase(raw: str, ckpt_dir: str) -> dict:
    """The training entry point on configs/example_config.json as the file
    stands (continual learning over all, cadence and rna), on the raw-dir
    phase's copy of data_synth/ (all/ read from its .npz cache) with cadence/
    and rna/ made of the first CL_TSVS pieces of all/."""
    import analysisgnn_tpu_torch.cli.train as cli
    from analysisgnn_tpu_torch.data import corpus

    pieces = sorted(f for f in os.listdir(f"{raw}/all") if f.endswith(".tsv"))[:CL_TSVS]
    for sub in ("cadence", "rna"):
        os.makedirs(f"{raw}/{sub}")
        for name in pieces:
            shutil.copy(f"{raw}/all/{name}", f"{raw}/{sub}/{name}")
    argv = ["--config_path", CL_CONFIG, "--raw_dir", raw, "--test_split_file", f"{raw}/test_split.json",
            *CL_TRAINER_FLAGS, "--checkpoint_dir", ckpt_dir]
    load, build_s = corpus.DLCTsvCorpus.load, {}

    def timed_load(self):
        t0 = time.perf_counter()
        out = load(self)
        build_s[os.path.basename(self.source_dir.rstrip("/"))] = time.perf_counter() - t0
        return out

    printed = io.StringIO()
    t = time.perf_counter()
    corpus.DLCTsvCorpus.load = timed_load
    _reset_counts()  # the CL Trainer path's run starts here
    try:
        with contextlib.redirect_stdout(printed):  # --do_eval prints the test metrics as JSON
            trainer = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        corpus.DLCTsvCorpus.load = load
    counts = _counts()
    wall = time.perf_counter() - t
    cfg, hist = trainer.cfg, trainer.history
    tasks = [r["task"] for r in hist]
    if not cfg.cl_training or tasks != list(CL_TASKS) or cfg.conv_impl != "node":
        raise AssertionError(f"CL trainer: epochs of {tasks} with cl_training={cfg.cl_training}, want {CL_TASKS}")
    phase("CL trainer: corpora " + ", ".join(
        f"{mt} {len(trainer.dm.task_samples[mt])} samples in {build_s[mt]:.2f} s" for mt in CL_TASKS)
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
    per_epoch = len(trainer.step_seconds) // len(hist)
    teacher, fisher = _cl_passes(trainer, per_epoch)
    launches = _check_trainer_launches("CL trainer", trainer, counts, len(hist), evaluated=True,
                                       teacher_passes=teacher, fisher_passes=fisher)
    steps_ms = [x * 1e3 for x in trainer.step_seconds]
    by_task = {r["task"]: steps_ms[i * per_epoch:(i + 1) * per_epoch] for i, r in enumerate(hist)}
    by_task[CL_TASKS[0]] = by_task[CL_TASKS[0]][1:]  # the run's first step warms up
    median = {mt: statistics.median(v) for mt, v in by_task.items()}
    without = statistics.median(by_task[CL_TASKS[0]])
    with_teacher = statistics.median([x for mt in CL_TASKS[1:] for x in by_task[mt]])
    phase(f"CL trainer: cli.train.main {' '.join(argv[:2])} {' '.join(CL_TRAINER_FLAGS)}: {len(hist)} epochs "
          f"({', '.join(tasks)}) of {per_epoch} train steps in {wall:.2f} s (corpus builds included); seconds per "
          f"epoch " + ", ".join(f"{r['task']} {r['secs']}" for r in hist)
          + "; median ms per train step " + ", ".join(f"{mt} {v:.2f}" for mt, v in median.items())
          + f" (first step {steps_ms[0]:.1f} ms); without the teacher {without:.2f}, with it {with_teacher:.2f}; "
          "train_loss " + ", ".join(f"{r['train_loss']:.4f}" for r in hist)
          + "; memory_loss " + ", ".join(f"{m:.4f}" for m in memory)
          + "; val/total_loss " + ", ".join(f"{r['val/total_loss']:.4f}" for r in hist))
    turns = _teacher_turns(trainer)
    phase(f"CL trainer: the teacher's cost alone, the rna heads' step on the same {CL_TURN_BATCHES} rna batches "
          f"in turns (without, with, with, without) x {CL_TURNS}: median {turns['without']:.2f} ms without the "
          f"teacher, {turns['with']:.2f} ms with it (previous tasks: all heads), {turns['with'] - turns['without']:.2f} "
          f"ms a step for the teacher's forward and the distillation")
    phase(f"CL trainer: checkpoints {', '.join(f'{mt}_model.pt' for mt in CL_TASKS)}, best.pt, last.pt, full.pt "
          f"present; --do_eval test metrics ({len(test_metrics)} keys): "
          + ", ".join(f"{k} {test_metrics[k]:.4f}" for k in ("all/cadence_acc", "cadence/cadence_acc",
                                                           "rna/localkey_acc", "rna/rna_onset_acc")
                      if k in test_metrics))
    return {"build_s": build_s, "secs": {r["task"]: r["secs"] for r in hist}, "median_step_ms": median,
            "without_teacher_ms": without, "with_teacher_ms": with_teacher, "memory_loss": memory,
            "launches": launches, "wall_s": wall, "teacher_turns": turns}


def _teacher_turns(trainer) -> dict:
    """Median ms of the rna heads' train step without the teacher and with it
    (every head distilled), on the same batches, timed in turns after one
    warm-up step of each; the Trainer's model trains on."""
    from analysisgnn_tpu_torch.train.state import create_train_state
    from analysisgnn_tpu_torch.train.step import StepConfig, make_train_step

    tasks = tuple(trainer.task_dict.items())
    state = create_train_state(trainer.model, len(tasks), trainer.optimizer, seed=0)
    steps = {label: make_train_step(trainer.model, trainer.optimizer, StepConfig(
        task_dict=tasks, active_tasks=trainer._cl_active("rna"), previous_tasks=previous,
        lambda_dctn=trainer.cfg.lambda_dctn)) for label, previous in (("without", ()), ("with", tuple(trainer.task_dict)))}
    batches = list(trainer.dm.train_batches("rna", CL_TURN_BATCHES))
    times = {"without": [], "with": []}
    for label in steps:  # warm-up
        state, _ = steps[label](state, batches[0])
    for _ in range(CL_TURNS):
        for label in ("without", "with", "with", "without"):
            for batch in batches:
                torch.cuda.synchronize()
                t = time.perf_counter()
                state, aux = steps[label](state, batch)
                torch.cuda.synchronize()
                times[label].append((time.perf_counter() - t) * 1e3)
                if (label == "with") != (float(aux["memory_loss"]) > 0):
                    raise AssertionError(f"CL trainer: memory_loss {float(aux['memory_loss'])} in the {label} arm")
    return {label: statistics.median(v) for label, v in times.items()}


def cl_parity(ckpt_dir: str) -> dict:
    """The CL path with EWC and FAMO on the edge-zxp arm: a fit on the GPU
    against the CPU (trainer_parity), FAMO's logits and the fisher's sum
    against the CPU's, and K3's launches in the GPU arm against the code's
    prediction."""
    out = trainer_parity(ckpt_dir, CL_PARITY_FLAGS, "CL parity", eps=PARITY_EPS)
    gpu, cpu = out["gpu"], out["cpu"]
    w_err = float((gpu["state"].famo.w.cpu() - cpu["state"].famo.w).abs().max())
    sums = [float(sum(f.double().sum() for f in side["state"].fisher).cpu()) for side in (gpu, cpu)]
    fisher_rel = abs(sums[0] - sums[1]) / abs(sums[1])
    if not (w_err <= CL_FAMO_W_ATOL and sums[1] > 0 and fisher_rel <= CL_FISHER_RTOL):
        raise AssertionError(f"CL parity: FAMO w max|d| {w_err:.3e} (tol {CL_FAMO_W_ATOL}), fisher sum {sums[0]} vs "
                             f"{sums[1]} (rel {fisher_rel:.2e}, tol {CL_FISHER_RTOL})")
    trainer = gpu["trainer"]
    teacher, fisher = _cl_passes(trainer, 2)
    launches = _check_trainer_launches("CL parity, GPU arm", trainer, gpu["counts"], len(trainer.history),
                                       evaluated=False, teacher_passes=teacher, fisher_passes=fisher)
    if not launches["launches"]["relation_weighted_matmul.dw"]:
        raise AssertionError("CL parity: the GPU arm launched no K3")
    phase(f"CL parity: FAMO w max|GPU - CPU| {w_err:.3e} (tol {CL_FAMO_W_ATOL}, |w| up to "
          f"{float(cpu['state'].famo.w.abs().max()):.4f}); fisher sum {sums[0]:.6e} vs {sums[1]:.6e} (rel "
          f"{fisher_rel:.2e}, tol {CL_FISHER_RTOL})")
    return {"rels": out["rels"], "famo_w_max_abs_err": w_err, "fisher_rel": fisher_rel, "launches": launches}


# ------------------------------------------------------- partitioned serving


def k6_bound_ms(d: int, h: int, f: int) -> tuple:
    """Least time for K6's work: the neighbours' rows read once ((D - 1) * 2H
    rows: the end partitions have one neighbour each), every halo row written
    once; no arithmetic."""
    bytes_moved = ((d - 1) * 2 * h * f + d * 2 * h * f) * 4
    return bytes_moved / HBM_BYTES_PER_S * 1e3, "bytes"


def cuda_ms_turns(fns: dict, iters: int = 20, trials: int = 7) -> dict:
    """``cuda_ms`` of several functions measured in turns (each trial times
    every function once, in order), so that a drift of the host's speed
    reaches them all alike; the median over trials of each."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for _ in range(trials):
        for k, fn in fns.items():
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize()
            times[k].append(start.elapsed_time(end) / iters)
    return {k: statistics.median(v) for k, v in times.items()}


def device_ms_turns(fns: dict, rounds: int = 2) -> dict:
    """``device_ms`` of several ``(fn, kernel)`` pairs measured in turns (each
    round takes every pair in order, then in reverse), so that a drift of the
    card's clocks reaches them all alike; the median of each.  Where a call's
    host work outlasts its kernel, back-to-back calls (``cuda_ms_turns``)
    time the host, and this times the kernels."""
    times = {k: [] for k in fns}
    for _ in range(rounds):
        for order in (list(fns), list(fns)[::-1]):
            for k in order:
                times[k].append(device_ms(*fns[k]))
    return {k: statistics.median(v) for k, v in times.items()}


def check_k6(name: str, x, halo: int, timed: bool) -> dict:
    """K6's kernel bit-equal to its plain version (it copies), in the
    allocating form and in the planned form with ``out`` that regime 2 uses
    (every element of a NaN-filled buffer written); with ``timed``, medians
    of both forms, the plain version and an index_select yardstick, timed in
    turns, and the profiler's device time of the kernel."""
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
    row = {"case": name, "D": d, "N_local": n_local, "H": halo, "F": f, "max_abs_err": 0.0, "vec": plan.vec}
    line = (f"kernel check: K6 {name}: D={d} N_local={n_local} H={halo} F={f}"
            + ("" if x.is_contiguous() else f" strides {x.stride()}")
            + f" (plan: float4 {plan.vec}): both forms bit-equal to the plain version")
    if timed:
        # yardstick only, never called by the port: one index_select over the
        # flattened input with a zero row appended beforehand, by a precomputed index
        flat = torch.cat([x.reshape(d * n_local, f), x.new_zeros((1, f))])
        rows, part = torch.arange(halo, device=x.device), torch.arange(d, device=x.device)[:, None]
        left = torch.where(part > 0, part * n_local - halo + rows, d * n_local)
        right = torch.where(part < d - 1, (part + 1) * n_local + rows, d * n_local)
        index = torch.cat([left, right], dim=1).reshape(-1)
        if not torch.equal(flat.index_select(0, index).view(d, 2 * halo, f), ref):
            raise AssertionError(f"K6 {name}: the index_select yardstick computes another function")
        times = cuda_ms_turns({"ms": lambda: halo_pull(x, halo, out=buf, plan=plan),
                               "library_ms": lambda: flat.index_select(0, index),
                               "alloc_ms": lambda: halo_pull(x, halo),
                               "plain_ms": lambda: halo_pull_plain(x, halo)})
        row.update(times)
        row["device_ms"] = device_ms(lambda: halo_pull(x, halo, out=buf, plan=plan), "halo_pull_kernel")
        row["bound_ms"], row["bound_by"] = k6_bound_ms(d, halo, f)
        line += (f" | planned call with out {row['ms']:.4f} ms ({row['device_ms']:.4f} ms of it on the device), "
                 f"index_select yardstick {row['library_ms']:.4f} ms (planned/yardstick "
                 f"{row['ms'] / row['library_ms']:.3f}), allocating call {row['alloc_ms']:.4f} ms, plain "
                 f"{row['plain_ms']:.4f} ms, timed in turns; bound {row['bound_ms']:.5f} ms ({row['bound_by']}, "
                 f"{100 * row['bound_ms'] / row['device_ms']:.1f}% of the kernel's device time)")
    phase(line)
    return row


def k6_checks() -> list:
    """K6 at the regime-2 shape of a 20,000-note score on 4 partitions (H = its
    largest edge span), and at edge cases: one partition (all zeros), 2 and 8
    partitions, H = 1, H = N_local, F = 25 (the scalar loop), and strided
    inputs with and without 16-byte rows."""
    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(6)
    rnd = lambda *shape: torch.randn(*shape, generator=gen).to(dev)
    rows = [check_k6("regime-2 shape", rnd(4, 5000, 256), 24, timed=True)]
    wide = rnd(4, 4000, 300)
    for name, x, h in (("D=1 (all zeros)", rnd(1, 5000, 256), 24), ("D=2", rnd(2, 5000, 256), 24),
                       ("D=8", rnd(8, 2500, 256), 24), ("H=1", rnd(4, 5000, 256), 1),
                       ("H=N_local", rnd(4, 300, 256), 300), ("F=25 scalar loop", rnd(4, 5000, 25), 24),
                       ("non-contiguous, 16-byte rows", wide[:, ::2, 4:260], 24),
                       ("non-contiguous, unaligned rows", wide[:, ::2, 7:263], 24)):
        rows.append(check_k6(name, x, h, timed=False))
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
def partitioned_serve(model, cfg: dict, tmp: str) -> dict:
    """Long-score serving through partitions on a line: regime 1 (the CLI's
    path, then the CLI itself on a checkpoint of ``model``, whose
    configuration is ``cfg``) and regime 2 (K6 before every layer)."""
    from analysisgnn_tpu_torch.cli.predict import main as predict_main
    from analysisgnn_tpu_torch.data.note_array import synthetic_score
    from analysisgnn_tpu_torch.distributed.partition import partition_graph
    from analysisgnn_tpu_torch.distributed.partition_encoder import make_partitioned_fused_sage
    from analysisgnn_tpu_torch.core.graph import NOTE
    from analysisgnn_tpu_torch.distributed.partition_encoder import spread_devices, visible_devices
    from analysisgnn_tpu_torch.inference.predict import predict_score_ids, predict_score_partitioned
    from analysisgnn_tpu_torch.kernels.halo import halo_pull
    from analysisgnn_tpu_torch.models.encoders import l2_normalize

    na = synthetic_score(PART_NOTES, seed=PART_SEED)
    spread = spread_devices(PARTITIONS, visible_devices("cuda"))  # C = 1 on one card
    n, layers = len(na), len(model.encoder.layers)
    per_window = predicted_launches(model)["segment_mean_base"]
    serve = lambda: predict_score_partitioned(model, na, num_devices=PARTITIONS, ids_only=True, device="cuda")
    _reset_counts()  # the partitioned serve path's run starts here
    t = time.perf_counter()
    ids = serve()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    counts = _counts()
    expected = {k: (PARTITIONS * per_window if k == "segment_mean_base" else 0) for k in counts}
    if counts != expected:
        raise AssertionError(f"regime 1 launched {counts}, the code predicts {expected}")
    lat = []
    for _ in range(REPEATS):
        t = time.perf_counter()
        again = serve()
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t)
    ref_ids = predict_score_ids(model, na, add_beats=False, add_measures=False, device="cuda")
    if set(ids) != set(ref_ids) or any(v.shape != (n,) or (v < 0).any() or not np.array_equal(v, again[k])
                                       for k, v in ids.items()):
        raise AssertionError("regime 1: bad or unstable ids")
    differ = sum(int((ids[k] != ref_ids[k]).sum()) for k in ref_ids)
    regime1 = {"launches": counts["segment_mean_base"], "first_s": first_s, "median_s": statistics.median(lat),
               "ids_differing": differ, "ids": n * len(ids)}
    phase(f"partitioned serve: regime 1, predict_score_partitioned(ids_only=True) of {n} notes on "
          f"{PARTITIONS} partitions over C = {len(spread)} card(s) ({', '.join(str(d) for d in spread)}): K1 launches {counts['segment_mean_base']} ({per_window} a window, as "
          f"predicted), first call {first_s * 1e3:.1f} ms, median of {REPEATS} {statistics.median(lat) * 1e3:.1f} ms; "
          f"{differ} of {n * len(ids)} ids differ from predict_score_ids")
    g, full, h0, host = _full_encode(model, na)
    regime1.update(_regime1_check(model, full, host, PARTITIONS, "partitioned serve: regime 1"))

    # the CLI: a checkpoint of the serve model and a MusicXML score
    ckpt = f"{tmp}/serve_ckpt"
    os.makedirs(ckpt)
    with open(f"{ckpt}/model_config.json", "w") as f:
        json.dump(cfg, f)
    torch.save(model.state_dict(), f"{ckpt}/best.pt")
    with open(f"{tmp}/score.musicxml", "w") as f:
        f.write(synthetic_score_xml(PART_NOTES, seed=8))
    _reset_counts()  # the CLI's run starts here
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        predict_main(["--checkpoint_dir", ckpt, "--score", f"{tmp}/score.musicxml", "--output_csv", f"{tmp}/out.csv",
                      "--partition_devices", str(PARTITIONS), "--device", "cuda"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t
    cli_counts = _counts()
    with open(f"{tmp}/out.csv") as f:
        lines = f.read().splitlines()
    if cli_counts != expected or len(lines) < PART_NOTES + 1 or lines[0].count(",") != 2 + len(model.task_dict):
        raise AssertionError(f"CLI --partition_devices: launches {cli_counts} (expected {expected}), "
                             f"{len(lines)} CSV lines")
    regime1.update({"cli_s": cli_s, "cli_notes": len(lines) - 1})
    phase(f"partitioned serve: cli.predict.main --partition_devices {PARTITIONS} on a MusicXML score of "
          f"{len(lines) - 1} notes: {cli_s:.2f} s (parse, model load and first call included), K1 launches "
          f"{cli_counts['segment_mean_base']}, {len(lines) - 1} CSV rows of {len(model.task_dict)} tasks")

    # regime 2: the halo exchange before every layer, on the projected note rows
    ref = model.encoder({NOTE: h0}, model.encoder.plan(g.edge_index, {NOTE: n}))
    rels = tuple(model.encoder.layers[0].groups[NOTE])
    fn = make_partitioned_fused_sage(rels, layers, use_jk=model.encoder.jk is not None, hidden=h0.shape[1])
    h0_host = h0.cpu().numpy()
    plans = {}
    for d in REGIME2_PARTITIONS:
        pg = partition_graph(h0_host, {et: host["edges"][et] for et in rels}, d)
        on_card = lambda arrays: {et: torch.from_numpy(v).cuda() for et, v in arrays.items()}
        plans[d] = (pg, torch.from_numpy(pg.x).cuda(), on_card(pg.edge_src), on_card(pg.edge_dst))
    _reset_counts()  # the regime-2 path's run starts here
    regime2 = {}
    for d, (pg, xs, es, ed) in plans.items():
        before = halo_pull.launches
        out = fn(model.encoder, xs, es, ed, pg.halo)
        torch.cuda.synchronize()
        launched = halo_pull.launches - before
        got = l2_normalize(torch.relu(out)).reshape(-1, out.shape[-1])[:n]
        err, scale, ok = _within(got, ref)
        if launched != layers + 1 or not torch.isfinite(got).all() or not ok:
            raise AssertionError(f"regime 2 on {d} partitions: K6 launched {launched} times (expected {layers + 1}), "
                                 f"max|d| {err:.3e} against model.encoder "
                                 f"(tol {PART_RTOL} * {scale:.4f} + {PART_ATOL})")
        regime2[d] = {"halo": pg.halo, "num_local": pg.num_local, "k6_launches": launched, "max_abs_err": err}
    k6_launches = halo_pull.launches
    pg, xs, es, ed = plans[PARTITIONS]
    regime2_trace = trace_forward(lambda: fn(model.encoder, xs, es, ed, pg.halo),
                                  f"one regime-2 forward on {PARTITIONS} partitions", "partitioned serve", 8)
    for d, (pg, xs, es, ed) in plans.items():
        times = []
        for _ in range(REPEATS):
            t = time.perf_counter()
            fn(model.encoder, xs, es, ed, pg.halo)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        regime2[d]["median_ms"] = statistics.median(times) * 1e3
        r = regime2[d]
        phase(f"partitioned serve: regime 2 on {d} partitions of {r['num_local']} rows, H={r['halo']}: K6 launches "
              f"{r['k6_launches']} a forward (expected {layers + 1}), max|d| {r['max_abs_err']:.3e} against "
              f"model.encoder after ReLU and L2 norm (tol {PART_RTOL} * {scale:.4f} + {PART_ATOL}), median of "
              f"{REPEATS} {r['median_ms']:.2f} ms a forward")
    return {"regime1": regime1, "regime2": regime2, "k6_launches": k6_launches, "regime2_trace": regime2_trace}


@torch.no_grad()
def partition_twin(model) -> dict:
    """The partitioned-encode certification of dryrun_multichip
    (__graft_entry__.py:287-356) on one card: 1,200 notes (seed 7) through 8
    partitions."""
    from analysisgnn_tpu_torch.data.note_array import synthetic_score

    _, full, _, host = _full_encode(model, synthetic_score(num_notes=1200, seed=7))
    return _regime1_check(model, full, host, 8, "dryrun_multichip twin")


# ---------------------------------------------------------------- the mesh (phase 28)

MESH_SLOTS = 4  # data slots of the world-1 mesh on the card: the data axis of JAX's 8-device reference run
MESH_PARITY_SLOTS = 1  # the GPU-vs-CPU cycle runs on the first of them
MESH_TIMED_STEPS = 3
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
# on an H100 (phase 26 finds 1.8e-4 over all gradients between two runs on
# the card); a wrong gradient is off by its own size.
MESH_LEAF_RTOL, MESH_FLOOR_OF_MAX = 1e-2, 2e-5


def mesh_phase() -> dict:
    """Phase 28: ``dryrun_multichip`` at world size 1 over an NCCL process
    group (a FileStore, rank 0) with MESH_SLOTS data slots on the card, K1's
    and K6's launches counted against the code's prediction; then the
    sharded step timed and traced (NCCL's kernels), its gradients'
    all-reduce timed alone, and the cycle on MESH_PARITY_SLOTS slots on the
    GPU against the CPU (dropout 0, Adam eps 1): losses, parameters, the
    AdamW moments and each parameter's move.  The phase fails if NCCL
    does not initialize: there is no other backend for the card."""
    import torch.distributed as dist

    from analysisgnn_tpu_torch.distributed import dryrun
    from analysisgnn_tpu_torch.distributed import mesh as tmesh
    from analysisgnn_tpu_torch.distributed.launch import init_process_group
    from analysisgnn_tpu_torch.train.state import ClippedAdamW, create_train_state
    from analysisgnn_tpu_torch.train.step import StepConfig

    t0 = time.perf_counter()
    cfg = dryrun.DryrunConfig()
    with tempfile.TemporaryDirectory() as tmp:
        init_process_group("nccl", f"{tmp}/store", 0, 1, MESH_TIMEOUT_S)
        try:
            phase(f"mesh: NCCL process group of 1 rank (NCCL_SOCKET_IFNAME={os.environ.get('NCCL_SOCKET_IFNAME')}), "
                  f"backend {dist.get_backend()}")
            model = dryrun.build_model(cfg, "cuda")
            note_model = dryrun.build_model(cfg, "cuda", seed=3, with_metrical=False)
            per_pass = predicted_launches(model)["segment_mean_base"]
            # the sharded cycle and its replay: 3 passes a slot each ("all"; "cadence" and its teacher);
            # certification 2: the full encode and 8 windows of regime 1, the encoder (its convs) for regime 2
            k1 = 2 * 3 * MESH_SLOTS * per_pass + 9 * predicted_launches(note_model)["segment_mean_base"] + (
                cfg.layers + 1) * _per_conv(note_model)[0]
            expected = {k: 0 for k in _counts()}
            expected.update({"segment_mean_base": k1, "halo_pull": cfg.layers + 1})
            del note_model
            _reset_counts()  # the mesh path's run starts here
            t = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as summary:
                result = dryrun.dryrun_multichip(1, device="cuda", slots_per_rank=MESH_SLOTS, cfg=cfg)
            torch.cuda.synchronize()
            dryrun_s = time.perf_counter() - t
            counts = _counts()
            if counts != expected:
                raise AssertionError(f"the mesh path launched {counts}, the code predicts {expected}")
            phase(f"mesh: {summary.getvalue().strip()}")
            p = result["partitioned"]
            phase(f"mesh: dryrun_multichip(1, slots_per_rank={MESH_SLOTS}) in {dryrun_s:.2f} s: K1 launches "
                  f"{counts['segment_mean_base']}, K6 {counts['halo_pull']}, as predicted; regime 1 halo "
                  f"{p['halo']}, regime 2 halo {p['regime2_halo']} over {p['partitions']} partitions")

            # the sharded step alone: timed, traced, its all-reduce timed alone
            mesh = tmesh.make_mesh(1, slots=MESH_SLOTS, device="cuda")
            sampler = dryrun.build_sampler(cfg.num_notes, cfg.subgraph, cfg.graphs // MESH_SLOTS, tasks=cfg.tasks)
            stacked = tmesh.stack_batches([sampler.sample_batch(device="cpu") for _ in range(MESH_SLOTS)])
            slots = tmesh.shard_stacked_batch(stacked, mesh)
            phase(f"mesh: {MESH_SLOTS} slots sampled for the timed steps")
            opt = ClippedAdamW(lambda _step: PARITY_LR)
            state = tmesh.shard_train_state(create_train_state(model, len(cfg.tasks), opt, 1), model, mesh)
            step = tmesh.make_sharded_train_step(
                model, opt, StepConfig(task_dict=cfg.tasks, active_tasks=tuple(t for t, _ in cfg.tasks)), mesh)
            step(state, slots)
            step_ms = []
            for _ in range(MESH_TIMED_STEPS):
                torch.cuda.synchronize()
                t = time.perf_counter()
                _, loss = step(state, slots)
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t) * 1e3)
            if not torch.isfinite(loss):
                raise AssertionError(f"the sharded step's loss is {float(loss)}")
            # one step traced for its kernels alone (a window of CUDA records: the host ops of its 13,000
            # launches would take the profiler seconds to sort); NCCL's are named nccl..._AllReduce_...
            wall = {}

            def traced_step():
                t = time.perf_counter()
                step(state, slots)
                torch.cuda.synchronize()
                wall["ms"] = (time.perf_counter() - t) * 1e3

            kernels = [e for e in _cuda_window(traced_step) if not e.is_user_annotation]
            traced = {"wall_ms": wall["ms"], "busy_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
                      "launches": sum(e.count for e in kernels)}
            reduce = [e for e in kernels if "AllReduce" in e.key]
            if not traced["busy_ms"] > 0:
                raise AssertionError("the traced sharded step shows no device time")
            packed = torch.zeros(state.params.layout.total + len(cfg.tasks) + 1, device="cuda")
            allreduce_ms = cuda_ms(lambda: dist.all_reduce(packed, group=mesh.data_group))
            row = {"dryrun_s": dryrun_s, "k1_launches": counts["segment_mean_base"],
                   "k6_launches": counts["halo_pull"], "step_ms": statistics.median(step_ms),
                   "allreduce_device_ms": sum(e.self_device_time_total for e in reduce) / 1e3,
                   "allreduce_launches": sum(e.count for e in reduce), "allreduce_call_ms": allreduce_ms,
                   "allreduce_bytes": packed.numel() * 4, **traced, **{k: result[k] for k in (
                       "loss_all", "loss_cad", "params_max_abs", "delta_norm", "delta_norm_unsharded",
                       "notes_per_step")}, "partition_max_abs_err": p["max_abs_err"],
                   "regime2_max_abs_err": p["regime2_max_abs_err"]}
            phase(f"mesh: {row['step_ms']:.2f} ms a sharded step of {MESH_SLOTS} slots (median of "
                  f"{MESH_TIMED_STEPS}; {result['notes_per_step']} note rows); one traced step: the device busy "
                  f"{row['busy_ms']:.2f} ms of {row['wall_ms']:.2f} ms under the profiler, {row['launches']} kernel "
                  f"launches, NCCL's all-reduce {row['allreduce_launches']} kernels, "
                  f"{row['allreduce_device_ms']:.4f} ms on the device; "
                  f"the all-reduce of the step's {row['allreduce_bytes']} bytes of gradients alone "
                  f"{allreduce_ms:.4f} ms a call (CUDA events)")
        finally:
            dist.destroy_process_group()
    del model, state, step

    # the cycle on the first slots, GPU (kernels) against CPU (plain versions), dropout 0, Adam eps 1
    pcfg = dataclasses.replace(cfg, dropout=0.0, adam_eps=PARITY_EPS)
    flat = lambda tensors: torch.cat([x.detach().reshape(-1).cpu() for x in tensors])  # noqa: E731
    out = {}
    for dev in ("cuda", "cpu"):
        one = tmesh.local_mesh(MESH_PARITY_SLOTS, dev)
        m = dryrun.build_model(pcfg, dev)
        init = flat(m.parameters())
        t = time.perf_counter()
        loss_all, loss_cad, st = dryrun.cl_cycle(m, tmesh.shard_stacked_batch(stacked[:MESH_PARITY_SLOTS], one), one,
                                                 pcfg)
        out[dev] = {"losses": (loss_all, loss_cad), "init": init, "final": flat(m.parameters()),
                    "s": time.perf_counter() - t,
                    **{k: _moments_in_order(getattr(st.opt_state, k), st.params.layout) for k in ("mu", "nu")}}
    g, c = out["cuda"], out["cpu"]
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
    row.update({"parity_loss_rel": rel, "parity_param_max_abs": worst, "max_move": float(move.abs().max()),
                "median_move": float(move.abs().median()), **{f"parity_{k}_tol_used": u[0] for k, u in used.items()},
                "seconds": time.perf_counter() - t0})
    phase(f"mesh: the cycle on {MESH_PARITY_SLOTS} slot, GPU vs CPU (dropout 0, eps {PARITY_EPS}): losses "
          f"{ga:.6f}, {gc:.6f} vs {ca:.6f}, {cc:.6f} (rel {rel:.2e}, tol {PARITY_LOSS_RTOL}); parameters max|d| "
          f"{worst:.3e} (tol {PARITY_PARAM_ATOL}); moves largest {row['max_move']:.3e}, median "
          f"{row['median_move']:.3e}; each parameter's AdamW moments and move within {MESH_LEAF_RTOL} of the CPU's "
          f"norm + {MESH_FLOOR_OF_MAX} of its largest an element (+ an ulp a final value), the largest share of "
          f"that used: " + ", ".join(f"{k} {u[0]:.3f} ({u[1]})" for k, u in used.items())
          + f"; CPU cycle {c['s']:.1f} s; phase {row['seconds']:.1f} s")
    return row


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


def _serve_expected(model, conv_impl: str) -> dict:
    """Launches of one serve request the code predicts (no backward): every
    hetero conv runs one K1 per single relation and, per fused group, one K1
    ("node") or one K3 forward ("edge-zxp"); onset pooling one K1."""
    from analysisgnn_tpu_torch.models.hetero import fusion_groups

    groups, singles = fusion_groups(_conv_edge_types(model))
    convs = len(model.encoder.layers) + 1
    counts = {k: 0 for k in _counts()}
    counts["segment_mean_base"] = 1 + convs * (len(singles) + (len(groups) if conv_impl == "node" else 0))
    counts["relation_weighted_matmul"] = convs * len(groups) if conv_impl == "edge-zxp" else 0
    return counts


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
def rna_serve(model, cfg: dict, tmp: str) -> dict:
    """The predict CLI's Roman-numeral MusicXML on the serve model (phase 4's
    weights): a generated 2,000-note MusicXML score with --output_musicxml
    (twice: the first call carries the parse and the model load's first
    touches), then with --conv_impl edge-zxp (K3), then a Humdrum .krn score."""
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

    def run(name: str, score: str, extra: list) -> dict:
        _reset_counts()  # this CLI run starts here
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            predict_main(["--checkpoint_dir", ckpt, "--score", score, "--output_csv", f"{tmp}/{name}.csv",
                          "--output_musicxml", f"{tmp}/{name}.musicxml", "--device", "cuda", *extra])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t
        counts = _counts()
        with open(f"{tmp}/{name}.musicxml") as f:
            xml = f.read()
        ids = _csv_ids(f"{tmp}/{name}.csv")
        if not xml.startswith("<?xml") or "<lyric><text>" not in xml or not xml.endswith("</score-partwise>"):
            raise AssertionError(f"RNA serve {name}: the RNA MusicXML is malformed")
        return {"s": seconds, "counts": counts, "bytes": len(xml.encode()), "labels": xml.count("<lyric>"),
                "ids": ids}

    node_expected, zxp_expected = _serve_expected(model, "node"), _serve_expected(model, "edge-zxp")
    first = run("node_first", f"{tmp}/rna.musicxml", [])
    node = run("node", f"{tmp}/rna.musicxml", [])
    zxp = run("zxp", f"{tmp}/rna.musicxml", ["--conv_impl", "edge-zxp"])
    krn = run("krn", f"{tmp}/rna.krn", [])
    for name, r, expected in (("first", first, node_expected), ("node", node, node_expected),
                              ("edge-zxp", zxp, zxp_expected), ("krn", krn, node_expected)):
        if r["counts"] != expected:
            raise AssertionError(f"RNA serve {name}: launches {r['counts']}, the code predicts {expected}")
    notes = len(node["ids"])
    if notes < RNA_NOTES or len(zxp["ids"]) != notes or node["ids"] != first["ids"]:
        raise AssertionError(f"RNA serve: {notes} CSV rows (at least {RNA_NOTES}), or unstable ids across calls")
    krn_notes = len(parse_kern(f"{tmp}/rna.krn").note_array)
    if len(krn["ids"]) != krn_notes:
        raise AssertionError(f"RNA serve .krn: {len(krn['ids'])} CSV rows for {krn_notes} notes")
    cached = cached_artifact_request(ckpt, f"{tmp}/rna.musicxml", tmp, node["ids"], node_expected)
    differ = sum(a != b for row_a, row_b in zip(node["ids"], zxp["ids"]) for a, b in zip(row_a, row_b))
    zxp_err = _zxp_logits_against_node(ckpt, f"{tmp}/rna.musicxml")
    phase(f"RNA serve: cli.predict.main --output_musicxml on a MusicXML score of {notes} notes: {node['s']:.3f} s "
          f"(first call {first['s']:.3f} s), K1 launches {node['counts']['segment_mean_base']} (the code predicts "
          f"{node_expected['segment_mean_base']}); RNA MusicXML {node['bytes']} bytes, {node['labels']} harmony "
          f"labels")
    phase(f"RNA serve: --conv_impl edge-zxp: {zxp['s']:.3f} s, K3 forward launches "
          f"{zxp['counts']['relation_weighted_matmul']} (the code predicts "
          f"{zxp_expected['relation_weighted_matmul']}), K1 {zxp['counts']['segment_mean_base']}; {differ} of "
          f"{notes * len(model.task_dict)} ids differ from the node run; on the score's graph, the edge-zxp "
          f"model's logits (K3) against the node model's (K1) max|d| {zxp_err:.3e} (tol {LOGIT_ATOL} abs)")
    phase(f"RNA serve: a .krn score of {krn_notes} notes: {krn['s']:.3f} s, K1 launches "
          f"{krn['counts']['segment_mean_base']}, RNA MusicXML {krn['bytes']} bytes, {krn['labels']} labels")
    return {"notes": notes, "seconds": node["s"], "first_s": first["s"], "k1_launches": node["counts"][
        "segment_mean_base"], "k3_launches": zxp["counts"]["relation_weighted_matmul"], "zxp_s": zxp["s"],
            "ids_differing": differ, "zxp_logit_max_abs": zxp_err, "xml_bytes": node["bytes"], "labels": node["labels"], "krn_notes": krn_notes,
            "krn_s": krn["s"], "cached": cached}


@torch.no_grad()
def cached_artifact_request(ckpt: str, score: str, tmp: str, want_ids: list, expected: dict) -> dict:
    """The predict CLI given a W&B artifact id whose copy lies in the
    artifact cache (--artifacts_dir): it serves the cached checkpoint without
    wandb or the network, under utils/profiling.py's trace, whose Chrome
    trace must name K1's kernel."""
    from analysisgnn_tpu_torch.cli.predict import main as predict_main
    from analysisgnn_tpu_torch.utils.profiling import trace as profiling_trace

    name = "model-rna:v0"
    shutil.copytree(ckpt, f"{tmp}/artifacts/{name}")
    printed = io.StringIO()
    _reset_counts()  # this CLI run starts here
    t = time.perf_counter()
    with profiling_trace(f"{tmp}/cached_trace"), contextlib.redirect_stdout(printed):
        predict_main(["--checkpoint_dir", f"entity/project/{name}", "--artifacts_dir", f"{tmp}/artifacts",
                      "--score", score, "--output_csv", f"{tmp}/cached.csv", "--device", "cuda"])
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    counts = _counts()
    if f"Using cached checkpoint: {tmp}/artifacts/{name}" not in printed.getvalue():
        raise AssertionError(f"RNA serve cached: the CLI printed {printed.getvalue()!r}")
    if _csv_ids(f"{tmp}/cached.csv") != want_ids:
        raise AssertionError("RNA serve cached: the ids differ from the local checkpoint's run")
    if counts != expected:
        raise AssertionError(f"RNA serve cached: launches {counts}, the code predicts {expected}")
    (trace_file,) = os.listdir(f"{tmp}/cached_trace")
    with open(f"{tmp}/cached_trace/{trace_file}") as f:
        text = f.read()
    k1_events = text.count("segment_mean_base_kernel")
    if not k1_events:
        raise AssertionError("RNA serve cached: the profiling trace names no segment_mean_base_kernel")
    phase(f"RNA serve: cli.predict.main --checkpoint_dir entity/project/{name} --artifacts_dir served the cached "
          f"copy in {seconds * 1e3:.1f} ms under utils.profiling.trace (its ids equal the local run's; K1 launches "
          f"{counts['segment_mean_base']}, as predicted); the trace ({len(text)} bytes) names "
          f"segment_mean_base_kernel {k1_events} times")
    return {"ms": seconds * 1e3, "k1_launches": counts["segment_mean_base"], "trace_bytes": len(text),
            "k1_trace_events": k1_events}


def chord_chain(tmp: str) -> dict:
    """The chord chain: predict_chords.main at its CLI defaults (hidden 256,
    one HybridGNN layer, the 14 latest tasks, the smoother) with --romantext
    on a generated score of about 2,000 notes; seconds per request after one
    warm-up, K1 launches against the code's prediction, one traced request
    (the GRUs' share named), and predict_chord_tasks on the card against the
    same on the CPU with the same weights."""
    from analysisgnn_tpu_torch.data.features import select_features
    from analysisgnn_tpu_torch.data.musicxml import load_score
    from analysisgnn_tpu_torch.inference import predict_chords as pc
    from analysisgnn_tpu_torch.models.hetero import fusion_groups

    score = f"{tmp}/chords.musicxml"
    with open(score, "w") as f:
        f.write(synthetic_score_xml(CHORD_NOTES, seed=21))
    argv = ["--input_score", score, "--output_dir", f"{tmp}/chords", "--hidden", str(CHORD_HIDDEN),
            "--num_layers", str(CHORD_LAYERS), "--romantext", "--device", "cuda"]
    na = load_score(score).note_array
    in_features = select_features(na, "voice").shape[1]
    model = pc.build_chord_model(in_features, CHORD_HIDDEN, CHORD_LAYERS, device="cuda")
    post = pc.build_post_model(CHORD_HIDDEN, device="cuda")
    groups, singles = fusion_groups(model.encoder.gnn.edge_types)
    # every hetero conv of the chord encoder's HybridGNN (its layers and the final one) runs one K1 per fused
    # group and per single relation; nothing else of the chain launches a hand-written kernel
    expected = {k: 0 for k in _counts()}
    expected["segment_mean_base"] = (len(model.encoder.gnn.layers) + 1) * (len(groups) + len(singles))
    with contextlib.redirect_stdout(io.StringIO()):
        pc.main(argv)  # warm-up
    torch.cuda.synchronize()
    seconds, counts = [], None
    for _ in range(REPEATS):
        _reset_counts()  # the chord chain's run starts here
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            pc.main(argv)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        counts = counts or _counts()
    if counts != expected:
        raise AssertionError(f"chord chain: launches {counts}, the code predicts {expected}")
    base = os.path.splitext(os.path.basename(score))[0]
    with open(f"{tmp}/chords/{base}.rntxt") as f:
        rntxt = f.read()
    with open(f"{tmp}/chords/{base}_rna.musicxml") as f:
        xml = f.read()
    if not rntxt.startswith("Composer:") or "m1" not in rntxt or "<lyric><text>" not in xml:
        raise AssertionError("chord chain: the RomanText or the RNA MusicXML is malformed")
    phase(f"chord chain: predict_chords.main --hidden {CHORD_HIDDEN} --num_layers {CHORD_LAYERS} --romantext on a "
          f"score of {len(na)} notes: median of {REPEATS} {statistics.median(seconds):.3f} s a request after one "
          f"warm-up ({', '.join(f'{x:.3f}' for x in seconds)}); K1 launches {counts['segment_mean_base']} (the code "
          f"predicts {expected['segment_mean_base']}); {rntxt.count(chr(10))} RomanText lines, "
          f"{xml.count('<lyric>')} RNA labels")

    tasks = lambda: pc.predict_chord_tasks(na, model=model, post_model=post, device="cuda")
    tasks()
    torch.cuda.synchronize()
    task_s = []
    for _ in range(REPEATS):
        t = time.perf_counter()
        tasks()
        torch.cuda.synchronize()
        task_s.append(time.perf_counter() - t)
    # the GRUs: cuDNN's cell kernels and the recurrent matrix-vector products it has cuBLAS run, all under aten::gru
    traced = trace_forward(tasks, "one predict_chord_tasks request", "chord chain", 12, op="aten::gru")
    phase(f"chord chain: predict_chord_tasks alone (graph, model, smoother, host softmaxes): median of {REPEATS} "
          f"{statistics.median(task_s) * 1e3:.1f} ms; the two BiGRUs {traced['op_ms']:.3f} ms = "
          f"{100 * traced['op_ms'] / traced['busy_ms']:.1f}% of the device's busy time")

    # the same weights on the CPU (plain versions): probabilities, decoded labels, annotations
    cpu_model = pc.build_chord_model(in_features, CHORD_HIDDEN, CHORD_LAYERS, device="cpu")
    cpu_model.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    cpu_post = pc.build_post_model(CHORD_HIDDEN, device="cpu")
    cpu_post.load_state_dict({k: v.cpu() for k, v in post.state_dict().items()})
    gpu, onsets = tasks()
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
    return {"median_s": statistics.median(seconds), "seconds": seconds, "launches": counts["segment_mean_base"],
            "task_ms": statistics.median(task_s) * 1e3, "trace": traced, "prob_max_abs_err": max(worst.values()),
            "labels_differing": differ, "annotations": len(ann), "notes": len(na), "onsets": len(onsets)}


# --------------------------------------------------------- the MetricalGNN family


def metrical_trainer(flags: list, label: str, ckpt_dir: str) -> dict:
    """The training entry point on a MetricalGNN configuration: seconds per
    epoch, median ms per train step after the first epoch, K1 and K3
    launches against the code's prediction, finite losses."""
    from analysisgnn_tpu_torch.cli.train import main as train_main

    t = time.perf_counter()
    _reset_counts()  # this Trainer path's run starts here
    trainer = train_main([*flags, "--checkpoint_dir", ckpt_dir])
    torch.cuda.synchronize()
    counts = _counts()
    wall = time.perf_counter() - t
    hist = trainer.history
    launches = _check_trainer_launches(label, trainer, counts, len(hist), evaluated=False)
    losses = [r["train_loss"] for r in hist] + [r["val/total_loss"] for r in hist]
    if not all(np.isfinite(losses)) or trainer.model.encoder_type != "metricalgnn":
        raise AssertionError(f"{label}: not a MetricalGNN run, or a non-finite loss: {losses}")
    steps_ms = [x * 1e3 for x in trainer.step_seconds]
    per_epoch = len(steps_ms) // len(hist)
    median_ms = statistics.median(steps_ms[per_epoch:] or steps_ms)
    phase(f"{label}: cli.train.main {' '.join(flags)}: {len(hist)} epochs of {per_epoch} train steps in {wall:.2f} s "
          f"(the demo corpus's build included); seconds per epoch {', '.join(str(r['secs']) for r in hist)}; median "
          f"{median_ms:.2f} ms per train step after the first epoch (first step {steps_ms[0]:.1f} ms); train_loss "
          + ", ".join(f"{r['train_loss']:.4f}" for r in hist)
          + "; val/total_loss " + ", ".join(f"{r['val/total_loss']:.4f}" for r in hist))
    return {"secs": [r["secs"] for r in hist], "median_step_ms": median_ms, "first_step_ms": steps_ms[0],
            "launches": launches, "wall_s": wall, "train_loss": [r["train_loss"] for r in hist]}


def metrical_serve(ckpt: str, label: str, score: str) -> dict:
    """The predict CLI on a trained MetricalGNN checkpoint: seconds a request
    (median of REPEATS after one warm-up), K1 and K3 launches against the
    code's prediction; then predict_score's probabilities on the card against
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
    model, cfg = load_model(ckpt, "served", "cuda")
    expected = _serve_expected(model, cfg["conv_impl"])
    argv = ["--checkpoint_dir", ckpt, "--checkpoint", "served", "--score", score, "--output_csv",
            f"{ckpt}/served.csv", "--device", "cuda"]
    seconds, counts = [], []
    for _ in range(1 + REPEATS):  # one warm-up, then the timed requests
        _reset_counts()  # this CLI request starts here
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            predict_main(argv)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t)
        counts.append(_counts())
    if any(c != expected for c in counts):
        raise AssertionError(f"{label} serve: launches {counts}, the code predicts {expected} a request")
    ids = _csv_ids(f"{ckpt}/served.csv")
    parsed = load_score(score)
    if len(ids) != len(parsed.note_array) or len(ids) < METRICAL_NOTES:
        raise AssertionError(f"{label} serve: {len(ids)} CSV rows for {len(parsed.note_array)} notes")
    cpu_model, _ = load_model(ckpt, "served", "cpu")
    probs = {dev: predict_score(m, parsed.note_array, parsed.measures, add_beats=True, add_measures=True, device=dev)
             for dev, m in (("cuda", model), ("cpu", cpu_model))}
    worst = {}
    for task, p in probs["cuda"].items():
        if p.shape != probs["cpu"][task].shape or not np.isfinite(p).all():
            raise AssertionError(f"{label} serve: {task} probabilities of shape {p.shape} or not finite")
        worst[task] = float(np.abs(p - probs["cpu"][task]).max())
    err = max(worst.values())
    if err > METRICAL_PROB_ATOL:
        raise AssertionError(f"{label} serve: GPU vs CPU probabilities differ by {err:.3e} > {METRICAL_PROB_ATOL}")
    median = statistics.median(seconds[1:])
    phase(f"{label} serve: cli.predict.main on a MusicXML score of {len(ids)} notes: median of {REPEATS} "
          f"{median:.3f} s a request after one warm-up (first {seconds[0]:.3f} s); launches a request "
          + ", ".join(f"{k} {v}" for k, v in counts[-1].items() if v)
          + f" (the code predicts the same); predict_score GPU vs CPU (plain versions, same weights) probabilities "
          f"max|d| {err:.3e} (tol {METRICAL_PROB_ATOL} abs; worst task {max(worst, key=worst.get)})")
    return {"median_s": median, "first_s": seconds[0], "launches": counts[-1], "prob_max_abs_err": err,
            "notes": len(ids)}


def scan_turns(batch) -> dict:
    """AssocBiGRU (MetricalConv's default sequence model, a log-depth scan in
    plain PyTorch) against BiResetGRU (seq_impl="scan", one packed cuDNN GRU)
    at a train batch's beat rows, F = 256, forward and backward: ms a call in
    turns, and each one's device time and launches from one traced call;
    then AssocBiGRU's forward on the card against the CPU."""
    from analysisgnn_tpu_torch.models.rnn import AssocBiGRU, BiResetGRU, segment_starts

    f = TRAIN_CFG["hidden_channels"]
    rows = batch.capacity("beat")
    starts = segment_starts(batch.batch["beat"])
    torch.manual_seed(0)
    mods = {"assoc": AssocBiGRU(f, f).cuda(), "scan": BiResetGRU(f, f).cuda()}
    x = torch.randn(rows, f, device="cuda", requires_grad=True)

    def call(mod):
        return lambda: mod(x, starts).sum().backward()

    fns = {k: call(m) for k, m in mods.items()}
    ms = cuda_ms_turns(fns, iters=5, trials=5)
    traced = {k: trace_forward(fn, f"one {k} forward and backward", "metrical scan", 4) for k, fn in fns.items()}
    cpu = AssocBiGRU(f, f)
    cpu.load_state_dict({k: v.cpu() for k, v in mods["assoc"].state_dict().items()})
    with torch.no_grad():
        err = float((mods["assoc"](x, starts).cpu() - cpu(x.detach().cpu(), starts.cpu())).abs().max())
    if err > SCAN_ATOL:
        raise AssertionError(f"metrical scan: AssocBiGRU on the card vs the CPU differs by {err:.3e} > {SCAN_ATOL}")
    segments = int(starts.sum())
    phase(f"metrical scan: {rows} beat rows ({segments} segments) x {f}, forward and backward, in turns: AssocBiGRU "
          f"{ms['assoc']:.3f} ms a call ({traced['assoc']['busy_ms']:.3f} ms device, {traced['assoc']['launches']} "
          f"launches), BiResetGRU {ms['scan']:.3f} ms ({traced['scan']['busy_ms']:.3f} ms device, "
          f"{traced['scan']['launches']} launches); AssocBiGRU GPU vs CPU max|d| {err:.3e} (tol {SCAN_ATOL} abs)")
    return {"rows": rows, "segments": segments, "ms": ms,
            "device_ms": {k: r["busy_ms"] for k, r in traced.items()},
            "launches": {k: r["launches"] for k, r in traced.items()}, "max_abs_err": err}


def metrical_phase(tmp: str, batch) -> dict:
    """Phase 22: the MetricalGNN family through both CLIs at full width, and
    the scan on the card."""
    score = f"{tmp}/metrical.musicxml"
    with open(score, "w") as f:
        f.write(synthetic_score_xml(METRICAL_NOTES, seed=22))
    out = {}
    for key, flags, label in (("node", METRICAL_FLAGS, "metrical trainer"),
                              ("rnn", METRICAL_RNN_FLAGS, "metrical trainer use_rnn edge-zxp")):
        out[key] = metrical_trainer(flags, label, f"{tmp}/metrical_{key}")
        out[key]["serve"] = metrical_serve(f"{tmp}/metrical_{key}", label, score)
    out["scan"] = scan_turns(batch)
    return out


# ------------------------------------------------------------- bf16 compute (phase 23)


def k3_bf16_bound_ms(n: int, f: int, g: int, t: int) -> tuple:
    """Least time for the bf16 forward's work: 2*T*N*F*G operations on the
    bf16 tensor cores, or x and w (bf16) and alpha (f32) read once and the
    f32 output written once."""
    ops = 2 * t * n * f * g
    bytes_moved = 2 * (n * f + t * f * g) + 4 * (t * n + n * g)
    t_ops, t_bytes = ops / BF16_OPS_PER_S * 1e3, bytes_moved / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def check_k3_bf16(name: str, n: int, f: int, g: int, t: int, timed: bool, expect: str = "wgmma",
                  misalign: bool = False) -> dict:
    """K3's bf16 forward against its plain version (the f32 einsum of the
    upcast operands), through the wrapper, which must launch the ``expect``
    kernel (``relmm.forward_kernel``; ``misalign`` puts x 2 bytes off a
    16-byte boundary).  With ``timed``: through the wrapper with autograd,
    the cotangents in the primals' dtypes against the plain version's; the
    mma.sync kernel on the same operands against the plain version; the
    wgmma kernel, the mma.sync kernel and a torch.einsum yardstick on the
    same bf16 operands timed in turns (calls back to back), the two kernels'
    device times in turns, the plain version."""
    from analysisgnn_tpu_torch.kernels import relmm

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(n * 11 + t)
    x = torch.randn(n, f, generator=gen).to(dev).bfloat16()
    if misalign:
        x = torch.empty(n * f + 1, dtype=torch.bfloat16, device=dev)[1:].view(n, f).copy_(x)
    w = (torch.randn(t, f, g, generator=gen) / f**0.5).to(dev).bfloat16()
    alpha = torch.rand(t, n, generator=gen).to(dev)
    k3 = relmm.relation_weighted_matmul
    kernel = relmm.forward_kernel(x, w)
    if kernel != expect:
        raise AssertionError(f"K3 bf16 {name}: the wrapper picks the {kernel} kernel, not {expect}")
    before = (k3.bf16_launches, k3.bf16_mma_launches)
    out = k3(x, w, alpha)  # the wrapper takes a bf16 kernel for bf16 x and w
    launched = (k3.bf16_launches - before[0], k3.bf16_mma_launches - before[1])
    if launched != ((1, 0) if expect == "wgmma" else (0, 1)):
        raise AssertionError(f"K3 bf16 {name}: the wrapper launched {launched} (wgmma, mma.sync), not one {expect}")
    ref = relmm.relation_weighted_matmul_plain(x, w, alpha)
    scale = relmm.relation_weighted_matmul_plain(x.abs(), w.abs(), alpha)  # the sum of |terms|

    def held(got, which: str) -> float:
        torch.cuda.synchronize()
        if got.dtype != torch.float32 or got.shape != ref.shape or not torch.isfinite(got).all():
            raise AssertionError(f"K3 bf16 {name} ({which}): {got.dtype} {tuple(got.shape)} or non-finite values")
        err = (got - ref).abs()
        if not bool((err <= K3_BF16_RTOL * scale).all()):
            worst = float((err / scale.clamp_min(1e-30)).max())
            raise AssertionError(f"K3 bf16 {name} ({which}): |kernel - plain| reaches {worst:.3e} of the sum of "
                                 f"|terms| (tol {K3_BF16_RTOL})")
        return float(err.max()) if err.numel() else 0.0

    row = {"case": name, "N": n, "F": f, "G": g, "T": t, "kernel": kernel, "max_abs_err": held(out, kernel)}
    line = (f"kernel check: K3 bf16 forward {name}: N={n} F={f} G={g} T={t}{' x misaligned' if misalign else ''} "
            f"-> {kernel} kernel, max|d| {row['max_abs_err']:.2e} (tol {K3_BF16_RTOL} of the sum of |terms|)")
    if timed:
        gout = torch.randn(n, g, generator=gen).to(dev)
        leaves = [v.clone().requires_grad_(True) for v in (x, w, alpha)]
        grads = torch.autograd.grad(k3(*leaves), leaves, gout)
        plain_leaves = [v.clone().requires_grad_(True) for v in (x, w, alpha)]
        want = torch.autograd.grad(relmm.relation_weighted_matmul_plain(*plain_leaves), plain_leaves, gout)
        if tuple(gr.dtype for gr in grads) != (torch.bfloat16, torch.bfloat16, torch.float32):
            raise AssertionError(f"K3 bf16 {name}: cotangent dtypes {[gr.dtype for gr in grads]}")
        for part, a, b in zip(("dx", "dw", "dalpha"), grads, want):
            # the f32 backward kernels against the plain f32 gradients, both rounded to the primal's dtype
            tol = (2.0 ** -7 if a.dtype == torch.bfloat16 else 1e-4) * float(b.float().abs().max())
            if float((a.float() - b.float()).abs().max()) > tol:
                raise AssertionError(f"K3 bf16 {name} backward {part}: max|d| above {tol:.3e}")
        row["mma_sync_max_abs_err"] = held(relmm.rwm_forward_bf16_mma(x, w, alpha), "mma.sync")
        a16 = alpha.bfloat16()
        turns = cuda_ms_turns({"wgmma": lambda: relmm.rwm_forward_bf16_wgmma(x, w, alpha),
                               "mma.sync": lambda: relmm.rwm_forward_bf16_mma(x, w, alpha),
                               "einsum": lambda: torch.einsum("tn,nf,tfg->ng", a16, x, w)})
        on_device = device_ms_turns({
            "wgmma": (lambda: relmm.rwm_forward_bf16_wgmma(x, w, alpha), "rwm_bf16_wgmma"),
            "mma.sync": (lambda: relmm.rwm_forward_bf16_mma(x, w, alpha), "rwm_bf16_forward_kernel")})
        row.update({"ms": turns["wgmma"], "mma_sync_ms": turns["mma.sync"], "library_ms": turns["einsum"],
                    "device_ms": on_device["wgmma"], "mma_sync_device_ms": on_device["mma.sync"],
                    "plain_ms": cuda_ms(lambda: relmm.relation_weighted_matmul_plain(x, w, alpha))})
        row["bound_ms"], row["bound_by"] = k3_bf16_bound_ms(n, f, g, t)
        line += (f" | calls in turns: wgmma {row['ms']:.4f} ms a call, mma.sync {row['mma_sync_ms']:.4f} ms "
                 f"({row['mma_sync_ms'] / row['ms']:.2f}x), torch.einsum on the bf16 operands "
                 f"{row['library_ms']:.4f} ms; on the device in turns wgmma {row['device_ms']:.4f} ms, mma.sync "
                 f"{row['mma_sync_device_ms']:.4f} ms ({row['mma_sync_device_ms'] / row['device_ms']:.2f}x); plain "
                 f"{row['plain_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms ({row['bound_by']}, bf16 at "
                 f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s), {100 * row['bound_ms'] / row['device_ms']:.1f}% of it on "
                 f"the device (mma.sync {100 * row['bound_ms'] / row['mma_sync_device_ms']:.1f}%); mma.sync max|d| "
                 f"{row['mma_sync_max_abs_err']:.2e}; backward: cotangents bf16, bf16, f32 through the f32 kernels")
    phase(line)
    return row


def k3_bf16_checks(n_train: int) -> list:
    rows = [check_k3_bf16("train shape", n_train, 256, 256, 7, timed=True)]
    # the wgmma kernel's tails: N not a multiple of the 128-row tile, one row, T=1, F short of or past the
    # 64-deep chunk, G not a multiple of WIDTH or of a 32-column box; then the mma.sync kernel: F and G not
    # multiples of 8, and an x whose base is not 16-byte aligned
    for name, n, f, g, t, expect, misalign in (
            ("N=300", 300, 256, 256, 7, "wgmma", False), ("T=1", 1000, 256, 256, 1, "wgmma", False),
            ("N=1", 1, 256, 256, 7, "wgmma", False), ("F=64 G=96", 300, 64, 96, 3, "wgmma", False),
            ("F=40 G=24", 77, 40, 24, 2, "wgmma", False), ("F=72 G=200", 300, 72, 200, 7, "wgmma", False),
            ("F=25 G=20", 65, 25, 20, 3, "mma.sync", False), ("x misaligned", 300, 256, 256, 7, "mma.sync", True)):
        rows.append(check_k3_bf16(name, n, f, g, t, timed=False, expect=expect, misalign=misalign))
    return rows


def k1_batch_checks(batch) -> list:
    """K1 on f32 and on bf16 rows at the fused note layer of a bench train
    batch (the shape of check_k1_backward), timed."""
    from analysisgnn_tpu_torch.core.graph import NOTE, NOTE_EDGE_TYPES
    from analysisgnn_tpu_torch.models.fused import fused_plan

    n = batch.capacity(NOTE)
    plan = fused_plan([batch.edges(et) for et in NOTE_EDGE_TYPES], n)
    gen = torch.Generator(device="cpu").manual_seed(3)
    f = TRAIN_CFG["hidden_channels"]
    msgs = torch.randn(plan.seg.shape[0], f, generator=gen).cuda()
    x_base = torch.randn(n, f, generator=gen).cuda()
    return [check_k1("fused note layer T=7 of a bench batch", m, plan.seg, b, plan.num_segments, timed=True,
                     row_ptr=plan.row_ptr) for m, b in ((msgs, x_base), (msgs.bfloat16(), x_base.bfloat16()))]


def bf16_turns(trained: dict, batches: list) -> dict:
    """Each bf16 arm's train step against the f32 arm of its layout, in turns
    (f32, bf16, bf16, f32; BF16_TURNS times) on the same batches: host ms per
    step, each ending in a synchronize."""
    out = {}
    for arm, f32_arm in BF16_PAIRS.items():
        times = {arm: [], f32_arm: []}
        i = 0
        for _ in range(BF16_TURNS):
            for a in (f32_arm, arm, arm, f32_arm):
                row = trained[a]
                t = time.perf_counter()
                row["state"], _aux = row["step"](row["state"], batches[1 + i % (len(batches) - 1)])
                torch.cuda.synchronize()
                times[a].append((time.perf_counter() - t) * 1e3)
                i += 1
        out[arm] = {"bf16_ms": statistics.median(times[arm]), "f32_ms": statistics.median(times[f32_arm])}
        phase(f"train {arm}: in turns with {f32_arm} ({BF16_TURNS} x f32, bf16, bf16, f32): median "
              f"{out[arm]['bf16_ms']:.2f} ms per bf16 step, {out[arm]['f32_ms']:.2f} ms per f32 step "
              f"(bf16 / f32 = {out[arm]['bf16_ms'] / out[arm]['f32_ms']:.3f})")
    return out


def smote_trainer_phase(ckpt_dir: str) -> dict:
    """Single-task cadence training with SMOTE through the training entry
    point at full width: every train step oversamples (counted around
    smote_oversample), finite losses, launches against the prediction."""
    import analysisgnn_tpu_torch.train.step as step_mod
    from analysisgnn_tpu_torch.cli.train import main as train_main

    calls = []
    oversample = step_mod.smote_oversample

    def counted(*args, **kwargs):
        out = oversample(*args, **kwargs)
        calls.append(int(out[2].sum()))  # the valid synthetic rows
        return out

    step_mod.smote_oversample = counted
    t = time.perf_counter()
    try:
        _reset_counts()  # the SMOTE Trainer path's run starts here
        trainer = train_main([*SMOTE_TRAINER_FLAGS, "--checkpoint_dir", ckpt_dir])
        torch.cuda.synchronize()
        counts = _counts()
    finally:
        step_mod.smote_oversample = oversample
    wall = time.perf_counter() - t
    launches = _check_trainer_launches("trainer SMOTE", trainer, counts, len(trainer.history), evaluated=False)
    steps = len(trainer.step_seconds)
    losses = [r["train_loss"] for r in trainer.history] + [r["val/total_loss"] for r in trainer.history]
    if len(calls) != steps or not all(calls) or not all(np.isfinite(losses)):
        raise AssertionError(f"trainer SMOTE: {len(calls)} oversamplings ({calls} valid rows) in {steps} steps, "
                             f"losses {losses}")
    steps_ms = [x * 1e3 for x in trainer.step_seconds]
    median_ms = statistics.median(steps_ms[1:] or steps_ms)
    phase(f"trainer SMOTE: cli.train.main {' '.join(SMOTE_TRAINER_FLAGS)}: {len(trainer.history)} epochs of "
          f"{steps // len(trainer.history)} train steps in {wall:.2f} s, seconds per epoch "
          + ", ".join(f"{r['secs']}" for r in trainer.history)
          + f"; every step oversampled ({', '.join(map(str, calls))} valid synthetic rows of 256); median {median_ms:.2f} ms per train step after the "
          f"first; train_loss " + ", ".join(f"{r['train_loss']:.4f}" for r in trainer.history))
    return {"secs": [r["secs"] for r in trainer.history], "median_step_ms": median_ms, "launches": launches,
            "synthetic_rows": calls, "wall_s": wall}


def hgt_staged_serve(ckpt_dir: str, tmp: str) -> dict:
    """The bf16-staged HGT checkpoint of the HGT Trainer run served by
    cli/predict.py on a generated MusicXML score: the staging read back from
    model_config.json, the CSV written, launches against the prediction."""
    from analysisgnn_tpu_torch.cli.predict import load_model
    from analysisgnn_tpu_torch.cli.predict import main as predict_main

    model, cfg = load_model(ckpt_dir, "last", "cuda")
    if cfg.get("hgt_stage_dtype") != "bfloat16" or any(layer.stage != torch.bfloat16 for layer in model.encoder.layers):
        raise AssertionError(f"the HGT checkpoint's staging was not served: {cfg.get('hgt_stage_dtype')}")
    score = f"{tmp}/hgt_score.musicxml"
    with open(score, "w") as fh:
        fh.write(synthetic_score_xml(RNA_NOTES, seed=5))
    out = f"{tmp}/hgt.csv"
    _reset_counts()  # this CLI request starts here
    t = time.perf_counter()
    predict_main(["--checkpoint_dir", ckpt_dir, "--checkpoint", "last", "--score", score, "--output_csv", out])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t
    counts = _counts()
    per = predicted_launches(model)
    expected = {k: v if k in ("segment_mean_base", "segment_softmax_agg") else 0 for k, v in per.items()}
    if counts != expected:
        raise AssertionError(f"serving the staged HGT checkpoint launched {counts}, the code predicts {expected}")
    with open(out) as fh:
        rows = list(csv.reader(fh))
    if len(rows) < RNA_NOTES // 2:
        raise AssertionError(f"the staged HGT CSV has {len(rows)} rows")
    phase(f"trainer HGT serve: cli.predict.main on the bf16-staged last.pt ({cfg['hgt_group_mode']} stacks) and a "
          f"MusicXML score: {len(rows) - 1} rows in {seconds:.3f} s (first call), launches "
          + ", ".join(f"{k} {v}" for k, v in counts.items() if v) + " (the code predicts the same)")
    return {"seconds": seconds, "rows": len(rows) - 1, "launches": counts}



# ---------------------------------------------------------- phases 24-26


def graph_build_phase(served: dict) -> dict:
    """Phase 24: the serve path's host graph build of the serve phase's
    largest score: the C++ edge builder (data/native.py, built with g++ in
    the build phase) against its numpy twin in turns, every array equal, then
    graph_from_note_array to the card; beside the serve phase's request and
    the loop-based build's numbers."""
    from analysisgnn_tpu_torch.data.graph_build import build_score_graph
    from analysisgnn_tpu_torch.data.native import build_note_edges_native
    from analysisgnn_tpu_torch.data.note_array import synthetic_score
    from analysisgnn_tpu_torch.inference.predict import graph_from_note_array

    na = synthetic_score(GRAPH_NOTES, seed=GRAPH_NOTES)
    builds = {"native": lambda: build_score_graph(na, add_beats=False, add_measures=False),
              "numpy": lambda: build_score_graph(na, add_beats=False, add_measures=False, use_native=False)}
    calls = build_note_edges_native.calls
    got, want = builds["native"](), builds["numpy"]()
    if build_note_edges_native.calls != calls + 1:
        raise AssertionError("build_score_graph did not take the C++ edge builder")
    if list(got.edges) != list(want.edges) or not all(
        got.edges[k].dtype == want.edges[k].dtype and np.array_equal(got.edges[k], want.edges[k]) for k in want.edges
    ):
        raise AssertionError(f"{GRAPH_NOTES} notes: the C++ edge builder's arrays differ from the numpy builder's")
    times = {name: [] for name in builds}
    for _ in range(GRAPH_TURNS):
        for name in ("native", "numpy", "numpy", "native"):
            t = time.perf_counter()
            builds[name]()
            times[name].append((time.perf_counter() - t) * 1e3)
    ms = {name: statistics.median(v) for name, v in times.items()}
    graph_ms = []
    for _ in range(GRAPH_TURNS):
        t = time.perf_counter()
        graph_from_note_array(na, add_beats=False, add_measures=False, bucket_factor=BUCKET_FACTOR, device="cuda")
        torch.cuda.synchronize()
        graph_ms.append((time.perf_counter() - t) * 1e3)
    edges = sum(v.shape[1] for v in got.edges.values())
    request_ms = served[GRAPH_NOTES]["median_s"] * 1e3
    phase(f"graph build: {GRAPH_NOTES} notes, {edges} note-note edges, every array of the C++ edge builder equal to "
          f"the numpy builder's; in turns x {GRAPH_TURNS}: build_score_graph native median {ms['native']:.2f} ms "
          f"({', '.join(f'{v:.2f}' for v in times['native'])}), numpy {ms['numpy']:.2f} ms "
          f"({', '.join(f'{v:.2f}' for v in times['numpy'])}); graph_from_note_array to the card median "
          f"{statistics.median(graph_ms):.2f} ms; the serve phase's {GRAPH_NOTES}-note request {request_ms:.1f} ms "
          f"(with the loop over silent ends: the numpy build {LOOP_BUILD_MS} ms of a {LOOP_REQUEST_MS} ms request)")
    return {"native_ms": ms["native"], "numpy_ms": ms["numpy"], "native_runs_ms": times["native"],
            "numpy_runs_ms": times["numpy"], "graph_from_note_array_ms": statistics.median(graph_ms),
            "request_ms": {n: served[n]["median_s"] * 1e3 for n in REQUEST_NOTES}, "edges": edges}


def variant_trainer_phase(ckpt_dir: str, fall_batch) -> dict:
    """Phase 25: the training entry point with --deep_proj --logit_fusion
    --remat --final_dropout --no_fused_torch_init at full width: launches
    against the prediction (remat's recomputed forwards included), finite
    losses that fall over FALL_STEPS steps on one bench batch, last.pt served
    through cli/predict.py's load_model, and one dropout-0 step of the
    trained weights on the GPU against the CPU."""
    from analysisgnn_tpu_torch.cli.predict import load_model
    from analysisgnn_tpu_torch.cli.train import main as train_main
    from analysisgnn_tpu_torch.data.note_array import synthetic_score
    from analysisgnn_tpu_torch.inference.predict import predict_score_ids
    from analysisgnn_tpu_torch.train.schedules import warmup_cosine_schedule
    from analysisgnn_tpu_torch.train.state import make_optimizer

    t = time.perf_counter()
    _reset_counts()  # the variant Trainer path's run starts here
    trainer = train_main([*VARIANT_TRAINER_FLAGS, "--checkpoint_dir", ckpt_dir])
    torch.cuda.synchronize()
    counts = _counts()
    wall = time.perf_counter() - t
    model = trainer.model
    if not (model.encoder.remat and model.encoder.final_dropout and model.heads.logit_fusion
            and not trainer.model_config["plain_proj"] and not trainer.cfg.fused_torch_init):
        raise AssertionError("trainer variants: the Trainer's model lacks one of the five knobs")
    hist = trainer.history
    launches = _check_trainer_launches("trainer variants", trainer, counts, len(hist), evaluated=False)
    losses = [r["train_loss"] for r in hist] + [r["val/total_loss"] for r in hist]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"trainer variants: non-finite losses {losses}")
    steps_ms = [x * 1e3 for x in trainer.step_seconds]
    # the trained model's loss falls on one fixed bench batch (dropout 0.3 on)
    state, step = _trainer(model, make_optimizer(warmup_cosine_schedule(5e-3, total_steps=1000)))
    fall = []
    for _ in range(FALL_STEPS):
        state, aux = step(state, fall_batch)
        fall.append(float(aux["total_loss"]))
    if not (all(np.isfinite(fall)) and statistics.mean(fall[-3:]) < statistics.mean(fall[:3])):
        raise AssertionError(f"trainer variants: loss on one fixed batch did not fall over {FALL_STEPS} steps: {fall}")
    phase(f"trainer variants: cli.train.main {' '.join(VARIANT_TRAINER_FLAGS)}: {len(hist)} epoch of "
          f"{len(steps_ms)} train steps in {wall:.2f} s (demo corpus included), steps "
          f"{', '.join(f'{v:.1f}' for v in steps_ms)} ms; train_loss {hist[-1]['train_loss']:.4f}, val/total_loss "
          f"{hist[-1]['val/total_loss']:.4f}; {FALL_STEPS} more steps on one bench batch: loss {fall[0]:.4f} -> "
          f"{fall[-1]:.4f}")
    _reset_counts()  # the serve path's run starts here
    served_model, cfg = load_model(ckpt_dir, "last", "cuda")
    t = time.perf_counter()
    ids = predict_score_ids(served_model, synthetic_score(2000, seed=7), add_beats=cfg["add_beats"],
                            add_measures=cfg["add_measures"], device="cuda")
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t) * 1e3
    served = _counts()
    per = predicted_launches(served_model)
    expected = {k: v if k in ("segment_mean_base", "relation_weighted_matmul") else 0 for k, v in per.items()}
    if served != expected or any(v.shape != (2000,) or (v < 0).any() for v in ids.values()):
        raise AssertionError(f"serving the variants' last.pt launched {served} (the code predicts {expected}) or "
                             f"gave bad ids")
    phase(f"trainer variants: last.pt (deep projections, logit fusion) through cli/predict.py's load_model served "
          f"a 2000-note request in {serve_ms:.1f} ms (first call), launches "
          + ", ".join(f"{k} {v}" for k, v in served.items() if v))
    parity = step_parity("variants", next(iter(trainer.dm.val_batches("all"))), model.state_dict())
    return {"launches": launches, "wall_s": wall, "step_ms": steps_ms, "fall": fall, "serve_ms": serve_ms,
            "serve_launches": served, "parity": parity}


def remat_turns() -> dict:
    """Phase 26: remat's reason to exist, measured: one train step of the
    variants arm's model (full width, edge-zxp, dropout 0) on a whole
    20,000-note score with beats, measures and random labels, with and
    without remat, in turns: peak device memory and ms a step, launches
    against the prediction; the loss and the gradients of both."""
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
        state, step = _trainer(model, ClippedAdamW(lambda _step: PARITY_LR))
        # the eager step every time: a replayed CUDA graph's activations are not the allocator's to count
        arms[remat] = (model, state, getattr(step, "eager", step))
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
    loss_rel, grad_rel = exact[0], exact[1]
    if not (loss_rel <= REMAT_RTOL and grad_rel <= REMAT_RTOL):
        raise AssertionError(f"remat in deterministic mode: loss rel {loss_rel:.2e}, gradients {grad_rel:.2e} "
                             f"relative L2 (tol {REMAT_RTOL})")
    ms, peak, base_bytes = {False: [], True: []}, {}, {}
    for _ in range(REMAT_TURNS):
        for remat in (False, True, True, False):
            model, state, step = arms[remat]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base_bytes[remat] = torch.cuda.memory_allocated()
            _reset_counts()
            t = time.perf_counter()
            state, aux = step(state, graph)
            torch.cuda.synchronize()
            ms[remat].append((time.perf_counter() - t) * 1e3)
            peak[remat] = max(peak.get(remat, 0), torch.cuda.max_memory_allocated())
            counts, expected = _counts(), step_launches(model)
            if counts != expected or not np.isfinite(float(aux["total_loss"])):
                raise AssertionError(f"remat={remat}: a step launched {counts}, the code predicts {expected}, "
                                     f"loss {float(aux['total_loss'])}")
            arms[remat] = (model, state, step)
    med = {k: statistics.median(v) for k, v in ms.items()}
    recomputed = remat_launches(arms[True][0])
    phase(f"remat: one train step on a whole {REMAT_NOTES}-note score ({n} note rows, beats and measures; the "
          f"variants arm at dropout 0): in turns x {REMAT_TURNS}: without remat "
          f"median {med[False]:.2f} ms ({', '.join(f'{v:.1f}' for v in ms[False])}), peak "
          f"{peak[False] / 2**20:.1f} MiB; with remat {med[True]:.2f} ms ({', '.join(f'{v:.1f}' for v in ms[True])}),"
          f" peak {peak[True] / 2**20:.1f} MiB ({base_bytes[True] / 2**20:.1f} MiB allocated before a step); "
          f"remat's recomputed forwards a step: " + ", ".join(f"{k} {v}" for k, v in recomputed.items() if v))
    return {"loss_rel": loss_rel, "grad_rel_l2": grad_rel, "floor_grad_rel_l2": floor[1],
            "default_mode_grad_rel_l2": loose[1], "ms": ms, "median_ms": med,
            "peak_bytes": peak, "allocated_before_bytes": base_bytes, "recomputed_per_step": recomputed}


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


def pretrain_phase(batches: list, parity_batch) -> dict:
    """Phase 27 (a): the PreEncoder's pretrain step at full width on the
    bench's batches: ms a step, peak memory, no hand-written kernel launched
    (the HGT of ``pair`` without K2 and the heads are PyTorch ops), a loss
    that falls over FALL_STEPS steps on one batch; then one dropout-0 step on
    the GPU against the CPU."""
    from analysisgnn_tpu_torch.train.pretrain import make_pretrain_step

    batches = [_with_voice_staff(b, i) for i, b in enumerate(batches)]
    model = _pre_encoder("cuda")
    opt = _pretrain_optimizer(PRETRAIN_LR)
    state = opt.init(list(model.parameters()))
    step = make_pretrain_step(model, opt)
    gen = torch.Generator(device="cuda").manual_seed(1)
    state, losses = step(state, batches[0], gen)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(PRETRAIN_STEPS):
        b = batches[1 + i % (len(batches) - 1)]
        t = time.perf_counter()
        state, losses = step(state, b, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    counts = _counts()
    if any(counts.values()):
        raise AssertionError(f"the pretrain step launched hand-written kernels {counts}; the code predicts none")
    if not all(np.isfinite(float(v)) for v in losses.values()):
        raise AssertionError(f"pretrain step: non-finite losses {losses}")
    fall = []
    for _ in range(FALL_STEPS):
        state, losses = step(state, batches[0], gen)
        fall.append(float(losses["total"]))
    if not fall[-1] < fall[0]:
        raise AssertionError(f"pretrain: the loss did not fall over {FALL_STEPS} steps on one batch: {fall}")
    ms = statistics.median(times)
    phase(f"pretrain: PreEncoder HybridHGT pair {PRETRAIN['num_layers']}x{PRETRAIN['hidden']}, {PRETRAIN['heads']} "
          f"heads, JK, {sum(p.numel() for p in model.parameters())} parameters: {PRETRAIN_STEPS} steps after one "
          f"warm-up, median {ms:.2f} ms/step ({', '.join(f'{v:.1f}' for v in times)}), peak memory "
          f"{peak / 2**20:.1f} MiB ({base / 2**20:.1f} MiB allocated before the steps); hand-written kernels "
          f"launched: none (as predicted); losses "
          + ", ".join(f"{k} {float(v):.4f}" for k, v in losses.items())
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
    return {"model": model, "median_ms": ms, "step_ms": times, "peak_bytes": peak, "base_bytes": base, "fall": fall,
            "parity": {"loss_rel": max(rels.values()), "param_max_abs": worst}}


def _rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _zoo_case(name: str, make, run, batch, expected: dict) -> dict:
    """One zoo module on the card and on the CPU with the same weights and
    inputs: forward and backward of a seeded cotangent (0 on padding rows);
    the card's launches against ``expected``, the note rows' output within
    ZOO_RTOL of its largest |value|, every row finite, the parameters' and
    the input's gradients within ZOO_GRAD_RTOL in relative L2; the card's
    forward and forward + backward timed."""
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
    _reset_counts()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for label, m, b in (("gpu", gpu, batch), ("cpu", cpu, batch.to("cpu"))):
        x, out = run(m, b)  # x: the note features, with requires_grad
        if not torch.isfinite(out).all():
            raise AssertionError(f"zoo {name}: non-finite output on the {label}")
        if m is gpu:
            torch.cuda.synchronize()
            launches = _counts()
        (out * cot.to(out.device)).sum().backward()
        # the last HResGatedConv layer's beat and measure relations do not reach the note states: no gradient
        grads = torch.cat([x.grad.flatten()] + [p.grad.flatten() if p.grad is not None else p.new_zeros(p.numel())
                                                for p in m.parameters()]).cpu()
        res[label] = (out.detach().cpu()[notes], grads)
        if m is gpu:
            peak = torch.cuda.max_memory_allocated()
    (og, gg), (oc, gc) = res["gpu"], res["cpu"]
    err = float((og - oc).abs().max())
    scale = float(oc.abs().max())
    grad_rel = _rel_l2(gg, gc)
    if err > ZOO_RTOL * scale or grad_rel > ZOO_GRAD_RTOL:
        raise AssertionError(f"zoo {name}: GPU vs CPU note rows max|d| {err:.3e} of max|out| {scale:.3e} (tol "
                             f"{ZOO_RTOL} relative), gradients {grad_rel:.3e} relative L2 (tol {ZOO_GRAD_RTOL})")
    got = {k: v for k, v in launches.items() if v}
    if got != expected:
        raise AssertionError(f"zoo {name}: forward launches {got}, the code predicts {expected}")

    def fwd():
        with torch.no_grad():
            run(gpu, batch)

    def fwd_bwd():
        x, out = run(gpu, batch)
        out.sum().backward()

    gpu.zero_grad(set_to_none=True)
    row = {"launches": got, "max_abs_err": err, "max_abs_out": scale, "grad_rel_l2": grad_rel,
           "forward_ms": cuda_ms(fwd, iters=5, trials=3), "step_ms": cuda_ms(fwd_bwd, iters=3, trials=3),
           "peak_bytes": peak, "base_bytes": base, "shape": tuple(out.shape)}
    phase(f"zoo {name}: out {tuple(out.shape)}, forward launches {got} (as the code predicts), GPU vs CPU note rows max|d| "
          f"{err:.3e} of max|out| {scale:.3e} (tol {ZOO_RTOL} relative), gradients {grad_rel:.3e} relative L2 (tol "
          f"{ZOO_GRAD_RTOL}); forward {row['forward_ms']:.3f} ms, forward + backward {row['step_ms']:.3f} ms, peak "
          f"memory {peak / 2**20:.1f} MiB ({base / 2**20:.1f} MiB allocated before)")
    return row


def zoo_phase(batch) -> dict:
    """Phase 27 (b): HResGatedConv (3 layers, 13 relations), HGPS (2 layers,
    4 heads, the dense [4, N, N] masked attention over the batch's note rows),
    OnsetEmbedding and GATConv (3 heads) on the onset relation, at width 256
    on one bench batch: launches against the code's formula, GPU against
    CPU."""
    from analysisgnn_tpu_torch.core.graph import NOTE, metadata
    from analysisgnn_tpu_torch.models.conv import GATConv, sage_plan
    from analysisgnn_tpu_torch.models.extra_layers import HGPS, HResGatedConv, OnsetEmbedding, note_relations

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

    rels = [et for et in edges if et in batch.edge_index]
    rows = {}
    rows["HResGatedConv"] = _zoo_case(
        f"HResGatedConv {HRES_LAYERS}x{ZOO_HIDDEN}", lambda: HResGatedConv(f_in, ZOO_HIDDEN, nodes, edges, HRES_LAYERS),
        run_hres, batch, {"segment_sum_sorted": HRES_LAYERS * len(rels)})
    rows["HGPS"] = _zoo_case(
        f"HGPS {HGPS_LAYERS}x{ZOO_HIDDEN}, {HGPS_HEADS} heads, attention over {n} note rows",
        lambda: HGPS(f_in, ZOO_HIDDEN, edges, HGPS_LAYERS, HGPS_HEADS), run_hgps, batch,
        {"segment_sum_sorted": HGPS_LAYERS * len(note_relations(rels))})
    rows["OnsetEmbedding"] = _zoo_case(f"OnsetEmbedding {ZOO_HIDDEN}", lambda: OnsetEmbedding(f_in, ZOO_HIDDEN),
                                       run_single, batch, {"segment_mean_base": 1})
    rows["GATConv"] = _zoo_case(f"GATConv {ZOO_HIDDEN}, {GAT_HEADS} heads, onset relation",
                                lambda: GATConv(f_in, ZOO_HIDDEN, GAT_HEADS), run_single, batch,
                                {"segment_sum_sorted": 1})
    return rows


def check_k4_plan(batch) -> dict:
    """K4 through a SegmentPlan (segment_sum_plan, the models' form) against
    its plain version within K4_RTOL and its gradient against the plain
    gradient (each sorted edge takes its segment's row, padding 0), on a
    ResGatedConv relation with its padding edges; then, at phase 12's shape
    (the fused note layer's sorted valid edges), the plan call's time and
    device time beside the call that builds its row pointers."""
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
    # phase 12's timed shape, through a plan of its sorted ids
    fplan = fused_plan([batch.edges(et) for et in NOTE_EDGE_TYPES], n)
    dst = fplan.seg[fplan.seg.long() < fplan.num_segments].contiguous()
    s = fplan.num_segments
    tplan = SegmentPlan(gather=torch.arange(dst.shape[0], device=dst.device), seg=dst, num_segments=s, base_rows=s,
                        row_ptr=row_pointers(dst, s))
    tm = torch.randn(dst.shape[0], f, generator=gen).cuda()
    ids = dst.long()
    plan_call = lambda: segment_sum_plan(tm, tplan)
    sorted_call = lambda: segment_sum_sorted(tm, dst, s)
    if not torch.equal(plan_call(), sorted_call()):
        raise AssertionError("K4: the plan call and the searchsorted call differ on the same inputs")
    with torch.no_grad():
        turns = cuda_ms_turns({"plan": plan_call, "searchsorted": sorted_call})
        row = {"case": "fused note layer (plan)", "E": dst.shape[0], "F": f, "n": s,
               "max_abs_err": float(err.max()), "grad_equal": True, "padding_edges": padding,
               "ms": turns["plan"], "searchsorted_ms": turns["searchsorted"],
               "device_ms": device_ms(plan_call, "segment_mean_base_kernel"),
               "plain_ms": cuda_ms(lambda: segment_sum_sorted_plain(tm, dst, s)),
               "library_ms": cuda_ms(lambda: torch.zeros((s, f), device="cuda").index_add_(0, ids, tm))}
    row["bound_ms"], row["bound_by"] = k4_bound_ms(dst.shape[0], f, s)
    phase(f"kernel check: K4 plan call on the consecutive relation (E={plan.seg.shape[0]}, {padding} padding, F={f}, "
          f"n={n}): max|d| {row['max_abs_err']:.3e} (tol {K4_RTOL} of the sum of |terms|), gradient equal to the "
          f"plain one; at E={row['E']} F={f} n={s}, in turns: plan call {row['ms']:.4f} ms, searchsorted call "
          f"{row['searchsorted_ms']:.4f} ms; plan call on the device {row['device_ms']:.4f} ms; plain "
          f"{row['plain_ms']:.4f} ms, index_add_ yardstick {row['library_ms']:.4f} ms; bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}, {100 * row['bound_ms'] / row['device_ms']:.1f}% of the device time)")
    return row


def unet_phase() -> dict:
    """Phase 27 (c): UNet((32, 64, 128), out 1) on [8, 88, 256, 1] images on
    the card against the CPU, and its forward timed."""
    from analysisgnn_tpu_torch.models.analysis import init_parameters
    from analysisgnn_tpu_torch.models.unet import UNet

    cpu = UNet(UNET_SHAPE[-1], UNET_FEATURES, out_channels=1)
    init_parameters(cpu, torch.Generator(device="cpu").manual_seed(0))
    gpu = UNet(UNET_SHAPE[-1], UNET_FEATURES, out_channels=1).cuda()
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(UNET_SHAPE, generator=torch.Generator(device="cpu").manual_seed(2))
    with torch.no_grad():
        t = time.perf_counter()
        want = cpu(x)
        cpu_s = time.perf_counter() - t
        xg = x.cuda()
        got = gpu(xg).cpu()
        ms = cuda_ms(lambda: gpu(xg), iters=5, trials=3)
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    if got.shape != UNET_SHAPE or not torch.isfinite(got).all() or err > UNET_RTOL * scale:
        raise AssertionError(f"UNet: shape {tuple(got.shape)}, GPU vs CPU max|d| {err:.3e} of max|out| {scale:.3e} "
                             f"(tol {UNET_RTOL} relative)")
    phase(f"UNet{UNET_FEATURES} on {list(UNET_SHAPE)}: GPU vs CPU max|d| {err:.3e} of max|out| {scale:.3e} (tol "
          f"{UNET_RTOL} relative); forward {ms:.3f} ms on the card, {cpu_s:.2f} s on the CPU")
    return {"forward_ms": ms, "max_abs_err": err, "max_abs_out": scale}


def fidelity_voices_phase(pre_encoder) -> dict:
    """Phase 27 (d): hetero_fidelity of the serve model (phase 4's weights) on
    a FID_NOTES-note request with a seeded mask keeping half of each
    note -> note relation's edges, GPU against CPU (fid values equal except
    where an argmax has two logits within LOGIT_ATOL), K1's launches against
    the serve path's; then the pretrained PreEncoder's voice links with a
    logit above 0 through voice_from_edges, pianoroll_svg and graph_to_json,
    and GraphSampler and the Laplacian positional encoding on the host."""
    from analysisgnn_tpu_torch.core.graph import NOTE
    from analysisgnn_tpu_torch.data.graph_sampling import GraphSampler
    from analysisgnn_tpu_torch.data.note_array import synthetic_score
    from analysisgnn_tpu_torch.inference.predict import graph_from_note_array
    from analysisgnn_tpu_torch.models.analysis import SERVE_CONFIG, init_parameters, model_from_config
    from analysisgnn_tpu_torch.models.hetero import fusion_groups
    from analysisgnn_tpu_torch.train.pretrain import pretrain_candidates
    from analysisgnn_tpu_torch.utils.explain import hetero_fidelity
    from analysisgnn_tpu_torch.utils.graph_utils import laplacian_positional_encoding, voice_from_edges
    from analysisgnn_tpu_torch.utils.visualization import graph_to_json, pianoroll_svg
    import scipy.sparse.csgraph  # noqa: F401  (imported here, outside the timed host calls)
    import scipy.sparse.linalg  # noqa: F401

    na = synthetic_score(FID_NOTES, seed=FID_NOTES)
    models = {}
    for label, dev in (("gpu", "cuda"), ("cpu", "cpu")):
        m = model_from_config(SERVE_CONFIG, device=dev).eval()
        init_parameters(m, torch.Generator(device="cpu").manual_seed(0))  # the serve phase's weights
        models[label] = m
    groups, singles = fusion_groups(models["gpu"].edge_types)
    per_forward = (len(models["gpu"].encoder.layers) + 1) * (len(groups) + len(singles)) + 1
    rng = np.random.default_rng(FID_NOTES)
    tasks = [t for t, _ in models["gpu"].task_dict]
    fids, logits_seen, launches = {}, {}, 0
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
        _reset_counts()
        t = time.perf_counter()
        fids[label] = hetero_fidelity(logits_fn, g.edge_index, to(masks_np), to(labels_np), g.target_mask(),
                                      {NOTE: g.capacity(NOTE)})
        if label == "gpu":
            torch.cuda.synchronize()
            fid_ms = (time.perf_counter() - t) * 1e3
            launches = _counts()["segment_mean_base"]
        logits_seen[label] = seen
    if launches != 3 * per_forward:
        raise AssertionError(f"hetero_fidelity launched K1 {launches} times, the code predicts 3 x {per_forward}")
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
    fid_plus = {t: float(v) for t, v in fids["gpu"][0].items()}
    fid_minus = {t: float(v) for t, v in fids["gpu"][1].items()}
    phase(f"fidelity: hetero_fidelity of the serve model on a {FID_NOTES}-note request, half of each note -> note "
          f"relation's edges kept: {fid_ms:.1f} ms for its three forwards, K1 launches {launches} (3 x {per_forward}, "
          f"as predicted); GPU vs CPU logits max|d| {worst:.3e}, every fid equal but for near ties; fid+ "
          f"mean {statistics.mean(fid_plus.values()):.4f}, fid- mean {statistics.mean(fid_minus.values()):.4f} over "
          f"{len(tasks)} tasks")
    del models

    # the pretrained PreEncoder's voice links on the same score, with beats and measures
    t = time.perf_counter()
    g = graph_from_note_array(na, bucket_factor=BUCKET_FACTOR, device="cuda")
    g = dataclasses.replace(g, node_attrs={NOTE: {**g.node_attrs[NOTE], "voice": torch.ones_like(
        g.node_attrs[NOTE]["pitch_spelling"]), "staff": torch.ones_like(g.node_attrs[NOTE]["pitch_spelling"])}})
    cand = pretrain_candidates(g)
    capacities = {tt: v.shape[0] for tt, v in g.node_features.items()}
    with torch.no_grad():
        _, voice_logits, _, _ = pre_encoder(g.node_features, pre_encoder.plan(g.edge_index, capacities),
                                            cand["staff"], cand["voice"])
    links = cand["voice"][:, (voice_logits > 0) & cand["voice_valid"]].cpu().numpy()
    torch.cuda.synchronize()
    forward_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    voices, n_voices = voice_from_edges(links, FID_NOTES)
    voices_ms = (time.perf_counter() - t) * 1e3
    predicted = na.copy()
    predicted["voice"] = voices
    t = time.perf_counter()
    svg = pianoroll_svg(predicted)
    svg_ms = (time.perf_counter() - t) * 1e3
    host_edges = {et: g.edge_index[et][:, :g.num_edges[et]].cpu().numpy() for et in g.edge_index
                  if et[0] == et[2] == NOTE}
    t = time.perf_counter()
    js = graph_to_json(na, host_edges, {"voice_pred": voices.tolist()})
    json_ms = (time.perf_counter() - t) * 1e3
    if not (svg.startswith("<svg") and svg.count("<rect") == FID_NOTES + 1 and len(json.loads(js)["nodes"]) == FID_NOTES
            and 1 <= n_voices <= FID_NOTES and voices.min() == 1):
        raise AssertionError(f"voices: {n_voices} voices, an SVG of {svg.count('<rect')} rects, a JSON graph")
    cons = host_edges[(NOTE, "consecutive", NOTE)]
    t = time.perf_counter()
    sel, sub = GraphSampler(cons, FID_NOTES, seed=0).sample_node_induced(num_seeds=32, walk_length=16)
    sampler_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    pe = laplacian_positional_encoding(np.concatenate(list(host_edges.values()), axis=1), FID_NOTES, LAP_PE_K)
    pe_ms = (time.perf_counter() - t) * 1e3
    if pe.shape != (FID_NOTES, LAP_PE_K) or not np.isfinite(pe).all() or len(sel) == 0:
        raise AssertionError(f"Laplacian encoding {pe.shape} or an empty sampled subgraph")
    phase(f"voices: the pretrained PreEncoder's {links.shape[1]} voice links with a logit above 0 of "
          f"{int(cand['voice_valid'].sum())} candidates ({forward_ms:.1f} ms with the graph build) -> "
          f"{n_voices} voices by voice_from_edges ({voices_ms:.2f} ms); pianoroll_svg {len(svg)} bytes "
          f"({svg_ms:.2f} ms), graph_to_json {len(js)} bytes ({json_ms:.2f} ms); GraphSampler.sample_node_induced "
          f"{len(sel)} notes, {sub.shape[1]} edges ({sampler_ms:.2f} ms); laplacian_positional_encoding k="
          f"{LAP_PE_K} {pe_ms:.1f} ms")
    return {"fid_ms": fid_ms, "launches": launches, "per_forward": per_forward, "logit_max_abs": worst,
            "fid_plus": fid_plus, "fid_minus": fid_minus, "voices": n_voices, "links": int(links.shape[1]),
            "forward_ms": forward_ms, "voices_ms": voices_ms, "svg_ms": svg_ms, "json_ms": json_ms,
            "sampler_ms": sampler_ms, "lap_pe_ms": pe_ms}


def zoo_and_pretrain(batches: list, parity_batch) -> dict:
    """Phase 27: pre-training, the layer zoo, UNet, fidelity and voices."""
    t = time.perf_counter()
    pre = pretrain_phase(batches, parity_batch)
    k4 = check_k4_plan(batches[0])
    zoo = zoo_phase(batches[0])
    unet = unet_phase()
    fid = fidelity_voices_phase(pre.pop("model"))
    phase(f"pretrain and zoo: done in {time.perf_counter() - t:.1f} s")
    return {"pretrain": pre, "k4_plan": k4, "zoo": zoo, "unet": unet, "fidelity": fid}


# ------------------------------------------- across cards (python3 chip_smoke.py --cards 4), phases (a)-(d)

CARDS_NOTES = (20000, 100000)  # phase (c)'s requests: phase 18's score, then one five times as long
CARDS_PARTITIONS = 4  # partitions of phase (c)'s line: one a card on 4 cards
CARDS_TURNS = 5  # warm requests of the spread and of the one-card line, timed in turns
CARDS_SLOTS = 2  # data slots a rank of the dry run: data 2 x 2 slots x model 2 on 4 ranks, the logical
# configuration of JAX's 8-device run (MULTICHIP_r05.json: data 4, model 2)
CARDS_TIMED_STEPS = 3
CARDS_TIMEOUT_S = 600.0  # the NCCL ranks' deadline and their groups' timeout: it covers rank 0's replay
NVLINK_BYTES_PER_S = 450e9  # NVLink between two H100s of one host, one direction (NVIDIA's data sheet)
K1_SYMBOL, K6_SYMBOL = "segment_mean_base_launch", "halo_pull_launch"  # kernels/launch.py's per-card counts


def _sync_cards(cards: int) -> None:
    for k in range(cards):
        torch.cuda.synchronize(k)


def _card_counts(symbol: str, cards: int) -> list:
    from analysisgnn_tpu_torch.kernels.launch import launches_by_device

    return [launches_by_device[symbol, k] for k in range(cards)]


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
        launched = {sym: c - before.get((sym, i), 0) for (sym, i), c in launch.launches_by_device.items()
                    if i == k and c != before.get((sym, i), 0)}
        elsewhere = {key: c - before.get(key, 0) for key, c in launch.launches_by_device.items()
                     if key[1] != k and c != before.get(key, 0)}
        # K1 and K4 build their row pointers without a plan (searchsorted, no kernel of ours); K6 twice
        want_launched = {K1_SYMBOL: 1, "segment_sum_launch": 1, "segment_softmax_launch": 1,
                         "segment_softmax_agg_launch": 1, K6_SYMBOL: 2, "rwm_forward_launch": 1, "rwm_dx_launch": 1,
                         "rwm_dw_launch": 1, "rwm_dalpha_launch": 1, "rwm_bf16_wgmma_launch": 1}
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
    """K1 timed on card 0 at the fused note layer of the first window of
    phase (c)'s 20,000-note line (the shape each card's first layer gives
    it), against its plain version and the index_add_ yardstick."""
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
                    timed=True, row_ptr=fused.row_ptr)


@torch.no_grad()
def cards_serve(cards: int, tmp: str) -> dict:
    """Phase (c): the serve model (phase 4's weights) on phase 18's
    20,000-note score and on a 100,000-note one through CARDS_PARTITIONS
    partitions spread over the cards (``predict_score_partitioned``'s
    default: the visible cards) against the one-card line (the same
    partitions on card 0): ids equal, probabilities within phase 18's
    tolerance, K1's launches on every card as the code predicts, each card's
    peak memory, the first request (the replicas made in it) and warm
    requests of both lines in turns; the embeddings of the spread against the
    single-window encode; then ``cli.predict.main --partition_devices``
    against the CLI without the flag and the one-card line's CSV."""
    from analysisgnn_tpu_torch.cli.predict import main as predict_main
    from analysisgnn_tpu_torch.data.musicxml import load_score
    from analysisgnn_tpu_torch.data.note_array import synthetic_score
    from analysisgnn_tpu_torch.distributed.partition_encoder import spread_devices, visible_devices
    from analysisgnn_tpu_torch.inference.predict import (
        decode_predictions, export_predictions_csv, predict_score_ids, predict_score_partitioned,
    )
    from analysisgnn_tpu_torch.models.analysis import SERVE_CONFIG as CFG
    from analysisgnn_tpu_torch.models.analysis import init_parameters, model_from_config

    model = model_from_config(CFG, device="cuda").eval()
    init_parameters(model, torch.Generator(device="cpu").manual_seed(0))  # phase 4's weights
    spread = spread_devices(CARDS_PARTITIONS, visible_devices("cuda"))
    one = spread[:1]
    if len(spread) != cards:
        raise AssertionError(f"{CARDS_PARTITIONS} partitions spread over {spread}, not over {cards} cards")
    per_card = predicted_launches(model)["segment_mean_base"] * CARDS_PARTITIONS // cards
    rows = {}
    for notes in CARDS_NOTES:
        na = synthetic_score(notes, seed=PART_SEED)

        def serve(devs, ids_only=True):
            return predict_score_partitioned(model, na, num_devices=CARDS_PARTITIONS, ids_only=ids_only,
                                             device="cuda", devices=devs)

        _sync_cards(cards)
        base = [torch.cuda.memory_allocated(k) for k in range(cards)]
        for k in range(cards):
            torch.cuda.reset_peak_memory_stats(k)
        before = _card_counts(K1_SYMBOL, cards)
        t = time.perf_counter()
        ids = serve(spread)  # the first request over the cards: the replicas are made in the first of them
        _sync_cards(cards)
        row = {"notes": notes, "first_ms": (time.perf_counter() - t) * 1e3, "base_bytes": base,
               "peak_bytes": [torch.cuda.max_memory_allocated(k) for k in range(cards)],
               "k1_launches": [a - b for a, b in zip(_card_counts(K1_SYMBOL, cards), before)]}
        if row["k1_launches"] != [per_card] * cards:
            raise AssertionError(f"{notes} notes over {cards} cards: K1 launched {row['k1_launches']} a card, the "
                                 f"code predicts {per_card} on each")
        row["one_card_base_bytes"] = torch.cuda.memory_allocated(0)
        torch.cuda.reset_peak_memory_stats(0)
        line = serve(one)
        _sync_cards(cards)
        row["one_card_peak_bytes"] = torch.cuda.max_memory_allocated(0)
        if set(ids) != set(line) or not all(np.array_equal(ids[k], line[k]) for k in line):
            raise AssertionError(f"{notes} notes: the ids over {cards} cards differ from the one-card line's")
        ref = predict_score_ids(model, na, add_beats=False, add_measures=False, device="cuda")
        row["ids"] = sum(v.size for v in ref.values())
        row["ids_differing_from_predict_score_ids"] = sum(int((ids[k] != ref[k]).sum()) for k in ref)
        probs, probs_line = serve(spread, ids_only=False), serve(one, ids_only=False)
        # where an id differs from predict_score_ids: the gap between the two likeliest classes there
        top2 = {k: np.sort(v, axis=-1)[:, -2:] for k, v in probs_line.items()}
        gaps = [float(top2[k][i, 1] - top2[k][i, 0]) for k in ref for i in np.flatnonzero(ids[k] != ref[k])]
        row["differing_top2_gap_max"] = max(gaps, default=0.0)
        row["prob_max_abs_err"] = max(float(np.abs(probs[k] - probs_line[k]).max()) for k in probs_line)
        row["prob_bit_equal"] = all(np.array_equal(probs[k], probs_line[k]) for k in probs_line)
        scale = max(float(np.abs(v).max()) for v in probs_line.values())
        if not row["prob_max_abs_err"] <= PART_RTOL * scale + PART_ATOL:
            raise AssertionError(f"{notes} notes: probabilities over {cards} cards max|d| {row['prob_max_abs_err']:.3e}"
                                 f" from the one-card line (tol {PART_RTOL} * {scale:.4f} + {PART_ATOL})")
        if notes == CARDS_NOTES[0]:
            times = {"one_card": [], "spread": []}
            for i in range(CARDS_TURNS):  # one card, spread, spread, one card, ...
                for which in ("one_card", "spread")[:: 1 if i % 2 == 0 else -1]:
                    t = time.perf_counter()
                    serve(spread if which == "spread" else one)
                    _sync_cards(cards)
                    times[which].append((time.perf_counter() - t) * 1e3)
            row.update({f"{k}_ms": statistics.median(v) for k, v in times.items()})
            row["times_ms"] = times
            _, full, _, host = _full_encode(model, na)
            row["regime1"] = _regime1_check(model, full, host, CARDS_PARTITIONS,
                                            f"cards: regime 1 over {cards} card(s)", devices=spread)
            del full
            k1_row = _window_k1(model, host)
        gib = lambda b: b / 2**30  # noqa: E731
        phase(f"cards: {notes} notes, {CARDS_PARTITIONS} partitions over {cards} card(s) "
              f"({', '.join(str(d) for d in spread)}): first request {row['first_ms']:.1f} ms (replicas made"
              f"{' in it' if notes == CARDS_NOTES[0] else ' before'}); K1 launches a card {row['k1_launches']} (the "
              f"code predicts {per_card}); ids equal to the one-card line's, "
              f"{row['ids_differing_from_predict_score_ids']} of {row['ids']} differ from predict_score_ids on one "
              f"card (the two likeliest classes there at most {row['differing_top2_gap_max']:.2e} apart); "
              f"probabilities max|d| {row['prob_max_abs_err']:.3e} from the one-card line (bit-equal "
              f"{row['prob_bit_equal']}; tol {PART_RTOL} * {scale:.4f} + {PART_ATOL}); peak memory a card (GiB) "
              + ", ".join(f"{gib(p):.3f} (base {gib(b):.3f})" for p, b in zip(row["peak_bytes"], row["base_bytes"]))
              + f", one-card line {gib(row['one_card_peak_bytes']):.3f} (base {gib(row['one_card_base_bytes']):.3f})"
              + (f"; warm requests in turns, median of {CARDS_TURNS}: spread {row['spread_ms']:.1f} ms, one card "
                 f"{row['one_card_ms']:.1f} ms" if "spread_ms" in row else ""))
        rows[notes] = row

    # the CLI: a checkpoint of the serve model, a MusicXML score, with and without the flag
    ckpt, score = f"{tmp}/serve_ckpt", f"{tmp}/score.musicxml"
    os.makedirs(ckpt)
    with open(f"{ckpt}/model_config.json", "w") as f:
        json.dump(CFG, f)
    torch.save(model.state_dict(), f"{ckpt}/best.pt")
    with open(score, "w") as f:
        f.write(synthetic_score_xml(CARDS_NOTES[0], seed=8))
    cli = {}
    for label, flags in (("spread", ["--partition_devices", str(CARDS_PARTITIONS)]), ("no flag", [])):
        before = _card_counts(K1_SYMBOL, cards)
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()) as out:
            predict_main(["--checkpoint_dir", ckpt, "--score", score, "--output_csv", f"{tmp}/{label}.csv",
                          "--device", "cuda", *flags])
        _sync_cards(cards)
        with open(f"{tmp}/{label}.csv") as f:
            cli[label] = {"s": time.perf_counter() - t, "stdout": out.getvalue().strip(), "csv": f.read().splitlines(),
                          "k1_launches": [a - b for a, b in zip(_card_counts(K1_SYMBOL, cards), before)]}
    parsed = load_score(score)
    line_ids = predict_score_partitioned(model, parsed.note_array, num_devices=CARDS_PARTITIONS, ids_only=True,
                                         device="cuda", devices=one,
                                         feature_type=CFG["feature_type"].replace("simple", "voice"))
    export_predictions_csv(f"{tmp}/line.csv", parsed.note_array, decode_predictions(line_ids))
    with open(f"{tmp}/line.csv") as f:
        line_csv = f.read().splitlines()
    got = cli["spread"]
    said = f"{CARDS_PARTITIONS} partitions over {cards} device(s)"
    if said not in got["stdout"] or got["k1_launches"] != [per_card] * cards or got["csv"] != line_csv:
        raise AssertionError(f"CLI --partition_devices {CARDS_PARTITIONS}: printed {got['stdout']!r}, K1 launches a "
                             f"card {got['k1_launches']} (expected {per_card}), CSV equal to the one-card line's "
                             f"{got['csv'] == line_csv}")
    differ = sum(a != b for a, b in zip(got["csv"], cli["no flag"]["csv"])) + abs(
        len(got["csv"]) - len(cli["no flag"]["csv"]))
    phase(f"cards: cli.predict.main --partition_devices {CARDS_PARTITIONS} on a MusicXML score of "
          f"{len(got['csv']) - 1} notes printed {got['stdout'].splitlines()[0]!r}, {got['s']:.2f} s (model load, "
          f"parse and the replicas included), K1 launches a card {got['k1_launches']}; its CSV equal to the one-card "
          f"line's; {differ} of {len(got['csv']) - 1} rows differ from the CLI's without the flag "
          f"({cli['no flag']['s']:.2f} s)")
    return {"rows": rows, "per_card": per_card, "k1": k1_row, "cli_rows_differing": differ,
            "cli_s": {k: v["s"] for k, v in cli.items()}}


def _cards_rank(cards: int) -> dict:
    """Phase (d) on one NCCL rank (its card: ``launch.rank_device``):
    ``dryrun_multichip(cards)`` with CARDS_SLOTS data slots a rank, K1's and
    K6's launches against the code's prediction (and on which card); then the
    sharded step timed and traced (NCCL's kernels), the gradients' all-reduce
    over the data group alone, and the end-halo exchange against its plain
    version in turns, at regime 2's shape of the dry run."""
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
    data, _ = tmesh.mesh_shape(world)
    model = dryrun.build_model(cfg, dev)
    note_model = dryrun.build_model(cfg, dev, seed=3, with_metrical=False)
    per_pass = predicted_launches(model)["segment_mean_base"]
    parts_here = max(1, 8 // world)  # certification 2's partitions on a rank
    # the sharded cycle: 3 passes a slot ("all"; "cadence" and its teacher); rank 0's replay: every slot of the
    # mesh; certification 2: the full encode, this rank's windows of regime 1, the encoder's convs for regime 2
    k1 = (3 * CARDS_SLOTS * per_pass + (rank == 0) * 3 * data * CARDS_SLOTS * per_pass
          + (1 + parts_here) * predicted_launches(note_model)["segment_mean_base"]
          + (cfg.layers + 1) * _per_conv(note_model)[0])
    expected = {k: 0 for k in _counts()}
    expected.update({"segment_mean_base": k1, "halo_pull": cfg.layers + 1})
    del note_model
    _reset_counts()  # the dry run's path starts here
    before = dict(launches_by_device)
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as summary:
        result = dryrun.dryrun_multichip(world, device="cuda", slots_per_rank=CARDS_SLOTS, cfg=cfg)
    torch.cuda.synchronize()
    out = {"rank": rank, "card": dev.index, "dryrun_s": time.perf_counter() - t, "summary": summary.getvalue().strip(),
           "counts": _counts(), "expected": expected, "mesh": result["mesh"]}
    out["by_card"] = {f"{sym}@{i}": c - before.get((sym, i), 0) for (sym, i), c in launches_by_device.items()
                      if c != before.get((sym, i), 0)}
    if out["counts"] != expected or set(out["by_card"]) - {f"{K1_SYMBOL}@{dev.index}", f"{K6_SYMBOL}@{dev.index}"}:
        raise AssertionError(f"rank {rank}: the dry run launched {out['counts']} ({out['by_card']}), the code "
                             f"predicts {expected} on card {dev.index}")
    out.update({k: result[k] for k in ("loss_all", "loss_cad", "notes_per_step") if k in result})
    out["partitioned"] = result["partitioned"]
    if rank == 0:
        out.update({k: result[k] for k in ("params_max_abs", "delta_norm", "delta_norm_unsharded",
                                           "loss_all_unsharded", "loss_cad_unsharded")})

    # the sharded step alone: timed, traced, its gradients' all-reduce timed alone
    mesh = tmesh.make_mesh(world, slots=CARDS_SLOTS, device="cuda")
    hosts = dist.new_group(backend="gloo")  # a barrier of the hosts alone: it launches no kernel on the cards

    def aligned():
        """Every rank here, its card idle, before a profiler window's work: the
        profiler starts in each rank at its own pace, and an NCCL kernel
        would count the wait for the last one as device time."""
        torch.cuda.synchronize()
        dist.barrier(group=hosts)

    sampler = dryrun.build_sampler(cfg.num_notes, cfg.subgraph, cfg.graphs // mesh.num_slots, tasks=cfg.tasks)
    stacked = tmesh.stack_batches([sampler.sample_batch(device="cpu") for _ in range(mesh.num_slots)])
    slots = tmesh.shard_stacked_batch(stacked, mesh)
    opt = ClippedAdamW(lambda _step: PARITY_LR)
    state = tmesh.shard_train_state(create_train_state(model, len(cfg.tasks), opt, 1), model, mesh)
    step = tmesh.make_sharded_train_step(
        model, opt, StepConfig(task_dict=cfg.tasks, active_tasks=tuple(t for t, _ in cfg.tasks)), mesh)
    step(state, slots)
    step_ms = []
    for _ in range(CARDS_TIMED_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, loss = step(state, slots)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
    if not torch.isfinite(loss):
        raise AssertionError(f"rank {rank}: the sharded step's loss is {float(loss)}")
    wall = {}

    def traced_step():
        aligned()
        t = time.perf_counter()
        step(state, slots)
        torch.cuda.synchronize()
        wall["ms"] = (time.perf_counter() - t) * 1e3

    kernels = [e for e in _cuda_window(traced_step) if not e.is_user_annotation]
    nccl = [e for e in kernels if "nccl" in e.key.lower()]
    out.update({"step_ms": statistics.median(step_ms), "step_ms_all": step_ms, "wall_ms": wall["ms"],
                "busy_ms": sum(e.self_device_time_total for e in kernels) / 1e3,
                "launches": sum(e.count for e in kernels),
                "nccl": {e.key[:60]: (e.count, e.self_device_time_total / 1e3) for e in nccl}})
    out["compute_busy_ms"] = out["busy_ms"] - sum(e.self_device_time_total for e in nccl) / 1e3
    packed = torch.zeros(state.params.layout.total + len(cfg.tasks) + 1, device=dev)
    out["allreduce_bytes"] = packed.numel() * 4
    out["allreduce_ms"] = cuda_ms(lambda: dist.all_reduce(packed, group=mesh.data_group))
    reduce = [e for e in _cuda_window(lambda: [aligned()] + [dist.all_reduce(packed, group=mesh.data_group)
                                                             for _ in range(20)])
              if "nccl" in e.key.lower()]
    out["allreduce_device_ms"] = sum(e.self_device_time_total for e in reduce) / 1e3 / 20
    out["allreduce_bound_ms"] = 2 * (data - 1) / data * out["allreduce_bytes"] / NVLINK_BYTES_PER_S * 1e3

    # the end halos of regime 2 across the ranks, at the dry run's shape: D_local partitions of N_local rows
    p = result["partitioned"]
    halo, n_local = p["regime2_halo"], -(-p["notes"] // p["partitions"])
    x = torch.randn(parts_here, n_local, cfg.hidden, generator=torch.Generator().manual_seed(rank)).to(dev)
    plan, group = HaloPlan(x, halo), dist.group.WORLD
    buf = torch.empty(plan.out_shape, device=dev)
    got = halo_pull_across_ranks(x, halo, group, out=buf, plan=plan).clone()
    if not torch.equal(got, halo_pull_across_ranks_plain(x, halo, group)):
        raise AssertionError(f"rank {rank}: the end-halo exchange differs from its plain version")
    out.update({"halo": halo, "d_local": parts_here, "n_local": n_local,
                **{f"exchange_{k}": v for k, v in cuda_ms_turns({
                    "ms": lambda: halo_pull_across_ranks(x, halo, group, out=buf, plan=plan),
                    "plain_ms": lambda: halo_pull_across_ranks_plain(x, halo, group)}).items()}})
    # the bytes each rank sends to a neighbour (H rows of F floats) over NVLink, one direction
    out["exchange_bound_ms"] = halo * cfg.hidden * 4 / NVLINK_BYTES_PER_S * 1e3
    return out


def _nccl_transports(log_dir: str) -> dict:
    """How NCCL's channels connected the ranks: the counts of each transport
    named by the ``... via <transport>`` lines of NCCL_DEBUG=INFO logs."""
    seen = collections.Counter()
    for name in os.listdir(log_dir):
        if name.startswith("nccl."):
            with open(os.path.join(log_dir, name), errors="replace") as f:
                for line in f:
                    if " via " in line:
                        seen[line.split(" via ", 1)[1].split()[0]] += 1
    return dict(seen)


def cards_dryrun(cards: int) -> dict:
    """Phase (d): ``_cards_rank`` on ``cards`` NCCL ranks, one a card, started
    by ``distributed/launch.py::spawn`` after K1, K6 and csrc/graphbuild.cpp
    are built here; NCCL's channels read from its INFO logs."""
    from analysisgnn_tpu_torch.distributed.dryrun import RANK_SOURCES
    from analysisgnn_tpu_torch.distributed.launch import spawn

    with tempfile.TemporaryDirectory() as logs:
        env = {"NCCL_DEBUG": "INFO", "NCCL_DEBUG_FILE": f"{logs}/nccl.%h.%p.log"}
        set_here = {k: v for k, v in env.items() if k not in os.environ}
        os.environ.update(set_here)
        t = time.perf_counter()
        try:
            ranks = spawn(_cards_rank, cards, "nccl", CARDS_TIMEOUT_S, cards, sources=RANK_SOURCES["nccl"])
        finally:
            for k in set_here:
                os.environ.pop(k)
        seconds = time.perf_counter() - t
        transports = _nccl_transports(logs)
    r0 = ranks[0]
    phase(f"cards: {r0['summary']}")
    phase(f"cards: dryrun_multichip({cards}, slots_per_rank={CARDS_SLOTS}) over NCCL, mesh {r0['mesh']}, in "
          f"{seconds:.1f} s with the ranks' start (the dry run {max(r['dryrun_s'] for r in ranks):.1f} s on the "
          f"slowest rank); NCCL's channels: "
          + (", ".join(f"{k} x{v}" for k, v in sorted(transports.items())) or "no 'via' line in its logs"))
    for r in ranks:
        phase(f"cards: rank {r['rank']} on card {r['card']}: K1 {r['counts']['segment_mean_base']} and K6 "
              f"{r['counts']['halo_pull']} launches, as the code predicts ({r['by_card']}); a sharded step "
              f"{r['step_ms']:.2f} ms (median of {CARDS_TIMED_STEPS}: {', '.join(f'{v:.1f}' for v in r['step_ms_all'])}); "
              f"one traced step busy {r['busy_ms']:.2f} of {r['wall_ms']:.2f} ms ({100 * r['busy_ms'] / r['wall_ms']:.1f}%), "
              f"{r['launches']} kernel launches, the kernels other than NCCL's {r['compute_busy_ms']:.2f} ms "
              f"({100 * r['compute_busy_ms'] / r['step_ms']:.1f}% of the median step), NCCL's "
              + ("; ".join(f"{k} x{c} {ms:.4f} ms" for k, (c, ms) in r["nccl"].items()) or "none")
              + f"; the gradients' all-reduce alone ({r['allreduce_bytes']} bytes over the data group) "
              f"{r['allreduce_ms']:.4f} ms a call, {r['allreduce_device_ms']:.4f} ms on the device, NVLink bound "
              f"{r['allreduce_bound_ms']:.4f} ms; the end-halo exchange (D_local {r['d_local']}, N_local "
              f"{r['n_local']}, H {r['halo']}) {r['exchange_ms']:.4f} ms a call against the plain all-gather's "
              f"{r['exchange_plain_ms']:.4f} ms, in turns (bound {r['exchange_bound_ms']:.6f} ms)")
    return {"ranks": ranks, "seconds": seconds, "transports": transports}


def cards_main(cards: int) -> None:
    """``python3 chip_smoke.py --cards N``: only what needs several cards,
    phases (a)-(d), then the closing lines."""
    smi = cards_environment(cards)
    build_kernels()
    phase("build: done")
    checks = card_kernel_checks(cards)
    with tempfile.TemporaryDirectory() as tmp:
        served = cards_serve(cards, tmp)
    dry = cards_dryrun(cards)
    r = dry["ranks"][0]
    gen = torch.Generator(device="cpu").manual_seed(6)
    k6 = check_k6(f"regime 2's shape across {cards} ranks", torch.randn(r["d_local"], r["n_local"], 256,
                                                                        generator=gen).cuda(), r["halo"], timed=True)
    k1 = served["k1"]
    k1_keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms")
    first = served["rows"][CARDS_NOTES[0]]
    kernels = [{
        "name": "segment_mean_base", "route": "cuda", "source": "analysisgnn_tpu_torch/csrc/segment_mean_base.cu",
        "replaces": "analysisgnn_tpu/kernels/pallas_segment.py:263", "launches": sum(first["k1_launches"]),
        "max_abs_err": max(k1["max_abs_err"], max(c["max_abs_err"]["K1"] for c in checks.values())),
        **{k: k1[k] for k in k1_keys}, "shape": f"{k1['case']}: E={k1['E']} (valid {k1['E_valid']}) F={k1['F']} "
                                                f"S={k1['S']}, timed on card 0",
        "launches_by_card": {str(n): row["k1_launches"] for n, row in served["rows"].items()},
        "dryrun_launches_by_rank": [x["counts"]["segment_mean_base"] for x in dry["ranks"]],
    }, {
        "name": "halo_pull", "route": "cuda", "source": "analysisgnn_tpu_torch/csrc/halo_pull.cu",
        "replaces": "analysisgnn_tpu/kernels/halo.py:97",
        "launches": sum(x["counts"]["halo_pull"] for x in dry["ranks"]),
        "max_abs_err": 0.0, **{k: k6[k] for k in k1_keys}, "alloc_ms": k6["alloc_ms"],
        "shape": f"D={k6['D']} N_local={k6['N_local']} H={k6['H']} F={k6['F']}, a rank's partitions, timed on card 0",
        "dryrun_launches_by_rank": [x["counts"]["halo_pull"] for x in dry["ranks"]],
        "exchange_ms_by_rank": [x["exchange_ms"] for x in dry["ranks"]],
        "exchange_plain_ms_by_rank": [x["exchange_plain_ms"] for x in dry["ranks"]],
    }]
    phase(f"cards: done; {CARDS_PARTITIONS} partitions of {CARDS_NOTES[0]} notes over {cards} cards "
          f"{first['spread_ms']:.1f} ms a warm request against {first['one_card_ms']:.1f} ms on one card; a sharded "
          f"step {statistics.median(x['step_ms'] for x in dry['ranks']):.2f} ms (median over the ranks)")
    phase(f"all phases passed in {time.perf_counter() - T0:.1f}s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


def main() -> None:
    smi = environment()
    from analysisgnn_tpu_torch.core.graph import NOTE
    from analysisgnn_tpu_torch.data.sampler import SubgraphSampler
    from analysisgnn_tpu_torch.models.analysis import SERVE_CONFIG as CFG
    from analysisgnn_tpu_torch.models.analysis import init_parameters, model_from_config

    build_kernels()
    phase("build: done")
    model = model_from_config(CFG, device="cuda").eval()
    init_parameters(model, torch.Generator(device="cpu").manual_seed(0))
    phase(f"model: HybridGNN {CFG['num_layers']}x{CFG['hidden_channels']} -> {CFG['out_channels']}, "
          f"{sum(p.numel() for p in model.parameters())} parameters, seed 0")
    rows = kernel_checks(model, max(REQUEST_NOTES))
    phase("kernel check: done")
    served = serve(model)
    check_logits(model, max(REQUEST_NOTES))
    phase(f"serve: done; K1 launches on the main path: {served['main_path_launches']}")
    trace(model, max(REQUEST_NOTES))
    graph_build = graph_build_phase(served)
    del model

    t = time.perf_counter()
    sampler = train_corpus()
    batches = [sampler.sample_batch(device="cuda") for _ in range(1 + max(TIMED_STEPS.values()))]
    parity_batch = SubgraphSampler(sampler.samples, dataclasses.replace(sampler.cfg, batch_size=PARITY_BATCH)
                                   ).sample_batch(device="cuda")
    n_train = batches[0].capacity(NOTE)
    phase(f"train corpus: 8 scores x 2000 notes, {len(batches)} batches of {n_train} note rows "
          f"({batches[0].num_target_nodes} targets) in {time.perf_counter() - t:.2f}s")
    k3_rows = k3_checks(n_train)
    k1_backward = check_k1_backward(batches[0])
    k2_rows = k2_checks(batches[0])
    phase("kernel check: K3, K1 backward and K2 done")
    k3_bf16_rows = k3_bf16_checks(n_train)
    k1_batch = k1_batch_checks(batches[0])  # f32 rows, bf16 rows
    k1_bf16_rows = [r for r in rows if r["rows"] == "bfloat16"] + [k1_batch[1]]
    phase("kernel check: K3's bf16 forward and K1 on bf16 rows done")
    trained = {arm: train(arm, batches) for arm in ARMS}
    turns = bf16_turns(trained, batches)
    parity = {arm: step_parity(arm, parity_batch) for arm in PARITY_ARMS}
    traced = {arm: trace_train(trained[arm], batches[1]) for arm in PARITY_ARMS}
    with tempfile.TemporaryDirectory() as tmp:
        metrical = metrical_phase(tmp, batches[0])
    phase(f"metrical: done; {trained['metrical']['median_ms']:.2f} ms per MetricalGNN use_rnn edge-zxp train step "
          f"(device busy {traced['metrical']['busy_ms']:.2f} of {traced['metrical']['wall_ms']:.2f} ms traced); "
          f"Trainer {metrical['node']['median_step_ms']:.2f} ms (node), {metrical['rnn']['median_step_ms']:.2f} ms "
          f"(use_rnn edge-zxp) a step; serve {metrical['node']['serve']['median_s']:.3f} s, "
          f"{metrical['rnn']['serve']['median_s']:.3f} s a request")
    del trained["metrical"]["model"], trained["metrical"]["state"], trained["metrical"]["step"]
    k4_rows = k4_checks(batches[0])
    k5_rows = k5_checks(batches[0])
    phase("kernel check: K4 and K5 done")
    segment_ops_checks()
    zoo = zoo_and_pretrain(batches, parity_batch)
    with tempfile.TemporaryDirectory() as tmp:
        trainer = trainer_phase(f"{tmp}/trainer")
        hgt_trainer = hgt_trainer_phase(f"{tmp}/trainer_hgt")
        hgt_served = hgt_staged_serve(f"{tmp}/trainer_hgt", tmp)
        smote = smote_trainer_phase(f"{tmp}/trainer_smote")
        variants = variant_trainer_phase(f"{tmp}/trainer_variants", batches[0])
        trainer_rels = trainer_parity(f"{tmp}/parity")["rels"]
        phase(f"trainer: done; {trainer['median_step_ms']:.2f} ms per HybridGNN train step (with the edge loss), "
              f"{hgt_trainer['median_step_ms']:.2f} ms per HGT train step (bf16 staging), "
              f"{smote['median_step_ms']:.2f} ms per SMOTE cadence step, "
              f"{statistics.median(variants['step_ms']):.2f} ms per step with the five knobs; GPU vs CPU "
              f"{trainer_rels}, with the five knobs {variants['parity']}")
        raw_dir = raw_dir_trainer_phase(f"{tmp}/raw_dir")
        raw_dir_rels = trainer_parity(f"{tmp}/raw_dir_parity", [*raw_dir["flags"], "--dropout", "0", "--num_epochs",
                                                                "1"], "raw-dir trainer")["rels"]
        cl = cl_trainer_phase(raw_dir["raw"], f"{tmp}/cl")
        cl_par = cl_parity(f"{tmp}/cl_parity")
    phase(f"raw-dir trainer: done; {raw_dir['samples']} samples built in {raw_dir['build_s']:.2f} s, read back in "
          f"{raw_dir['cache_s']:.2f} s; {raw_dir['median_step_ms']:.2f} ms per train step; GPU vs CPU {raw_dir_rels}")
    phase(f"CL trainer: done; {cl['without_teacher_ms']:.2f} ms per train step without the teacher, "
          f"{cl['with_teacher_ms']:.2f} with it; GPU vs CPU {cl_par['rels']}")
    remat = remat_turns()

    k6_rows = k6_checks()
    phase("kernel check: K6 done")
    model = model_from_config(CFG, device="cuda").eval()
    init_parameters(model, torch.Generator(device="cpu").manual_seed(0))  # the serve phase's weights
    with tempfile.TemporaryDirectory() as tmp:
        partitioned = partitioned_serve(model, CFG, tmp)
    twin = partition_twin(model)
    del model
    mesh = mesh_phase()
    phase(f"partitioned serve: done; regime 1 {partitioned['regime1']['median_s'] * 1e3:.1f} ms a "
          f"{PART_NOTES}-note request, regime 2 "
          + ", ".join(f"{d} partitions {r['median_ms']:.2f} ms" for d, r in partitioned["regime2"].items())
          + f" a forward; the 1,200-note twin max|d| {twin['max_abs_err']:.3e}")

    model = model_from_config(CFG, device="cuda").eval()
    init_parameters(model, torch.Generator(device="cpu").manual_seed(0))  # the serve phase's weights
    with tempfile.TemporaryDirectory() as tmp:
        rna = rna_serve(model, CFG, tmp)
        del model
        chords = chord_chain(tmp)
    phase(f"RNA serve and chord chain: done; {rna['seconds']:.3f} s an RNA-serve request of {rna['notes']} notes, "
          f"{chords['median_s']:.3f} s a chord-chain request of {chords['notes']} notes (GRUs "
          f"{chords['trace']['op_ms']:.3f} of {chords['trace']['busy_ms']:.2f} ms device busy)")

    main_row = rows[0]
    zxp = trained["edge-zxp"]
    shape = k3_rows[0]
    k3_shape = f"train step: N={shape['N']} F={shape['F']} G={shape['G']} T={shape['T']}"
    k3_replaces = {"forward": "analysisgnn_tpu/kernels/pallas_relmm.py:93",
                   "dx": "analysisgnn_tpu/kernels/pallas_relmm.py:116",
                   "dw": "analysisgnn_tpu/kernels/pallas_relmm.py:122",
                   "dalpha": "analysisgnn_tpu/kernels/pallas_relmm.py:122"}

    def k3_entry(part: str, name: str) -> dict:
        r = k3_rows[0]["timed"][part]
        return {"name": name, "route": "cuda", "source": "analysisgnn_tpu_torch/csrc/relation_weighted_matmul.cu",
                "replaces": k3_replaces[part], "launches": zxp["launches"][name],
                "max_abs_err": max(row["max_abs_err"][part] for row in k3_rows),
                "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": r["library_ms"], "device_ms": r["device_ms"],
                "bound_f32_simt_ms": r["bound_f32_simt_ms"], "shape": k3_shape}

    dw_entry = k3_entry("dw", "relation_weighted_matmul.dw")
    # d alpha is held against the plain version here but is not on the main
    # path (alpha carries no gradient in the edge-zxp model): a sub-row of dw,
    # whose TPU kernel computed both
    dw_entry["dalpha"] = k3_entry("dalpha", "relation_weighted_matmul.dalpha")
    kernels = [{
        "name": "segment_mean_base",
        "route": "cuda",
        "source": "analysisgnn_tpu_torch/csrc/segment_mean_base.cu",
        "replaces": "analysisgnn_tpu/kernels/pallas_segment.py:263",
        "launches": served["main_path_launches"],
        "max_abs_err": max(max(r["max_abs_err"] for r in rows), k1_backward["max_abs_err"],
                           k1_batch[0]["max_abs_err"]),
        "ms": main_row["ms"],
        "device_ms": main_row["device_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": f"{main_row['case']}: E={main_row['E']} (valid {main_row['E_valid']}) "
                 f"F={main_row['F']} S={main_row['S']}",
        "onset_pooling": {k: rows[1][k] for k in ("E", "E_valid", "S", "ms", "device_ms", "plain_ms", "library_ms",
                                                  "bound_ms")},
        "bench_batch": {k: k1_batch[0][k] for k in ("case", "E", "E_valid", "S", "ms", "device_ms", "plain_ms",
                                                    "library_ms", "bound_ms", "bound_by")},
        "train_launches": {impl: r["launches"]["segment_mean_base"] for impl, r in trained.items()},
        "backward": k1_backward,
    },
        k3_entry("forward", "relation_weighted_matmul"),
        k3_entry("dx", "relation_weighted_matmul.dx"),
        dw_entry,
    ]
    k2_row = k2_rows[0]
    kernels.append({
        "name": "segment_softmax_agg",
        "route": "cuda",
        "source": "analysisgnn_tpu_torch/csrc/segment_softmax_agg.cu",
        "replaces": "analysisgnn_tpu/kernels/pallas_segment.py:754",
        "launches": trained["hgt"]["launches"]["segment_softmax_agg"],
        "max_abs_err": max(r["max_abs_err"] for r in k2_rows),
        "ms": k2_row["ms"],
        "plain_ms": k2_row["plain_ms"],
        "bound_ms": k2_row["bound_ms"],
        "bound_by": k2_row["bound_by"],
        "library_ms": k2_row["library_ms"],
        "device_ms": k2_row["device_ms"],
        "shape": f"{k2_row['case']}: E={k2_row['E']} (valid {k2_row['E_valid']}) H={k2_row['H']} F={k2_row['F']} "
                 f"n={k2_row['n']} blocks={k2_row['blocks']}",
        "degrees": k2_row["degrees"],
        "trainer_launches": hgt_trainer["launches"]["launches"]["segment_softmax_agg"],
    })
    kernels[0]["trainer_launches"] = trainer["launches"]["launches"]["segment_mean_base"]
    # phases 25 and 26: the Trainer with the five knobs (remat recomputes the hidden convs' forward
    # kernels in every backward) and a remat step on a whole 20,000-note score
    for entry in kernels[:4]:
        entry["variant_trainer_launches"] = variants["launches"]["launches"][entry["name"]]
    kernels[0]["remat_recomputed_per_step"] = remat["recomputed_per_step"]["segment_mean_base"]
    kernels[1]["remat_recomputed_per_step"] = remat["recomputed_per_step"]["relation_weighted_matmul"]
    kernels[0]["raw_dir_trainer_launches"] = raw_dir["launches"]["launches"]["segment_mean_base"]
    kernels[0]["cl_trainer_launches"] = cl["launches"]["launches"]["segment_mean_base"]
    for entry in kernels[1:4]:
        entry["cl_parity_launches"] = cl_par["launches"]["launches"][entry["name"]]
    kernels[1]["trainer_launches"] = trainer["launches"]["launches"]["relation_weighted_matmul"]
    # K4: its first path is phase 27's layer zoo (ResGatedConv in HResGatedConv and HGPS's local branch, GATConv),
    # through a SegmentPlan's row pointers; timed there as the plan call, beside phase 12's call that builds its
    # row pointers with searchsorted, at the same shape
    zoo_rows = zoo["zoo"]
    k4p = zoo["k4_plan"]
    k4_launches = {name: r["launches"].get("segment_sum_sorted", 0) for name, r in zoo_rows.items()}
    kernels.append({
        "name": "segment_sum_sorted", "route": "cuda", "source": "analysisgnn_tpu_torch/csrc/segment_mean_base.cu",
        "replaces": "analysisgnn_tpu/kernels/pallas_segment.py:302", "launches": sum(k4_launches.values()),
        "max_abs_err": max([k4p["max_abs_err"]] + [x["max_abs_err"] for x in k4_rows]), "ms": k4p["ms"],
        "plain_ms": k4p["plain_ms"], "bound_ms": k4p["bound_ms"], "bound_by": k4p["bound_by"],
        "library_ms": k4p["library_ms"], "device_ms": k4p["device_ms"], "searchsorted_ms": k4p["searchsorted_ms"],
        "searchsorted_check": {k: k4_rows[0][k] for k in ("ms", "device_ms", "plain_ms", "library_ms")},
        "shape": f"{k4p['case']}: E={k4p['E']} F={k4p['F']} n={k4p['n']}; ms is the plan call (segment_sum_plan), "
                 f"timed in turns with the call that builds its row pointers (searchsorted_ms)",
        "zoo_launches": k4_launches,
    })
    # K5: held against its plain version above; no path of the JAX package
    # runs it (its only callers are tests), so none here does
    r = k5_rows[0]
    kernels.append({
        "name": "segment_softmax_sorted", "route": "cuda", "source": "analysisgnn_tpu_torch/csrc/segment_softmax.cu",
        "replaces": "analysisgnn_tpu/kernels/pallas_segment.py:486", "launches": 0,
        "max_abs_err": max(x["max_abs_err"] for x in k5_rows), "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "device_ms": r["device_ms"], "shape": f"{r['case']}: E={r['E']} H={r['H']} n={r['n']}",
        "note": "only tests call it (tests/test_pallas.py in the JAX package), so no path launches it",
    })
    # phase 27: K1 in OnsetEmbedding and in hetero_fidelity's three forwards of the serve model
    kernels[0]["zoo_launches"] = zoo_rows["OnsetEmbedding"]["launches"]["segment_mean_base"]
    kernels[0]["fidelity_launches"] = zoo["fidelity"]["launches"]
    # K5's bound at the train batch's shape lies below a single launch's floor: the larger shape beside it
    large = k5_rows[1]
    kernels[-1]["large"] = {k: large[k] for k in ("case", "E", "H", "ms", "int64_ids_ms", "device_ms", "plain_ms",
                                                  "bound_ms", "bound_by", "max_abs_err")}
    kernels[-1]["int64_ids_ms"] = k5_rows[0]["int64_ids_ms"]
    kernels[0]["partitioned_serve_launches"] = partitioned["regime1"]["launches"]
    kernels[0]["rna_serve_launches"] = rna["k1_launches"]
    kernels[0]["chord_launches"] = chords["launches"]
    kernels[1]["serve_launches"] = rna["k3_launches"]
    # phase 22: the MetricalGNN paths' launches (a bench-shaped train step of the use_rnn edge-zxp arm, the two
    # Trainer runs, one served request of each checkpoint)
    kernels[0]["metrical"] = {"train_step": trained["metrical"]["launches_per_step"]["segment_mean_base"],
                              "trainer_node": metrical["node"]["launches"]["launches"]["segment_mean_base"],
                              "trainer_rnn_edge_zxp": metrical["rnn"]["launches"]["launches"]["segment_mean_base"],
                              "serve_node": metrical["node"]["serve"]["launches"]["segment_mean_base"],
                              "serve_rnn_edge_zxp": metrical["rnn"]["serve"]["launches"]["segment_mean_base"]}
    for entry in kernels[1:4]:
        entry["metrical"] = {"train_step": trained["metrical"]["launches_per_step"][entry["name"]],
                             "trainer_rnn_edge_zxp": metrical["rnn"]["launches"]["launches"][entry["name"]],
                             "serve_rnn_edge_zxp": metrical["rnn"]["serve"]["launches"][entry["name"]]}
    k6 = k6_rows[0]
    if (k6["D"], k6["H"]) != (PARTITIONS, partitioned["regime2"][PARTITIONS]["halo"]):
        raise AssertionError(f"K6 was timed at D={k6['D']} H={k6['H']}, not at the shape of regime 2's run")
    kernels.append({
        "name": "halo_pull", "route": "cuda", "source": "analysisgnn_tpu_torch/csrc/halo_pull.cu",
        "replaces": "analysisgnn_tpu/kernels/halo.py:97", "launches": partitioned["k6_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in k6_rows), "ms": k6["ms"], "plain_ms": k6["plain_ms"],
        "bound_ms": k6["bound_ms"], "bound_by": k6["bound_by"], "library_ms": k6["library_ms"],
        "device_ms": k6["device_ms"], "alloc_ms": k6["alloc_ms"],
        "shape": f"{k6['case']}: D={k6['D']} N_local={k6['N_local']} H={k6['H']} F={k6['F']}; ms is the planned "
                 f"call with out, the form regime 2 uses",
        "per_forward": {d: r["k6_launches"] for d, r in partitioned["regime2"].items()},
        "mesh_launches": mesh["k6_launches"],
    })
    # phase 28: the dry run's twin over NCCL at world size 1
    kernels[0]["mesh_launches"] = mesh["k1_launches"]
    # phase 23: K3's bf16 forward and K1 on bf16 rows, launched by the bf16 arms' timed steps
    k3b = k3_bf16_rows[0]
    bf16_arms = tuple(BF16_PAIRS)
    kernels[1]["bf16_launches"] = sum(trained[a]["launches"]["relation_weighted_matmul.bf16"] for a in bf16_arms)
    kernels.append({
        "name": "relation_weighted_matmul.bf16", "route": "cuda",
        "source": "analysisgnn_tpu_torch/csrc/relation_weighted_matmul.cu",
        "replaces": "analysisgnn_tpu/kernels/pallas_relmm.py:93",
        "launches": kernels[1]["bf16_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in k3_bf16_rows if r["kernel"] == "wgmma"), "ms": k3b["ms"],
        "plain_ms": k3b["plain_ms"], "bound_ms": k3b["bound_ms"], "bound_by": k3b["bound_by"],
        "library_ms": k3b["library_ms"], "device_ms": k3b["device_ms"],
        "mma_sync_ms": k3b["mma_sync_ms"], "mma_sync_device_ms": k3b["mma_sync_device_ms"],
        "shape": f"train step: N={k3b['N']} F={k3b['F']} G={k3b['G']} T={k3b['T']}, x and w bf16, alpha and out f32",
        "per_step": {a: trained[a]["launches_per_step"]["relation_weighted_matmul.bf16"] for a in bf16_arms},
        "note": "rwm_bf16_wgmma_kernel: TMA ring, wgmma reading w MN-major, x resident across relations",
    })
    # the mma.sync kernel takes the bf16 operands that TMA cannot describe: off the main path; timed in turns
    # with the wgmma kernel at the train shape, checked there and at its own edge cases
    kernels.append({
        "name": "relation_weighted_matmul.bf16_mma", "route": "cuda",
        "source": "analysisgnn_tpu_torch/csrc/relation_weighted_matmul.cu",
        "replaces": "analysisgnn_tpu/kernels/pallas_relmm.py:93",
        "launches": sum(trained[a]["launches"]["relation_weighted_matmul.bf16_mma"] for a in bf16_arms),
        "max_abs_err": max([k3b["mma_sync_max_abs_err"]]
                           + [r["max_abs_err"] for r in k3_bf16_rows if r["kernel"] == "mma.sync"]),
        "ms": k3b["mma_sync_ms"], "plain_ms": k3b["plain_ms"], "bound_ms": k3b["bound_ms"],
        "bound_by": k3b["bound_by"], "library_ms": k3b["library_ms"], "device_ms": k3b["mma_sync_device_ms"],
        "shape": f"train step: N={k3b['N']} F={k3b['F']} G={k3b['G']} T={k3b['T']} (timed there in turns with the "
                 f"wgmma kernel; the path sends it only F or G not a multiple of 8, or a misaligned base)",
        "note": "rwm_bf16_forward_kernel: mma.sync m16n8k16, one chunk in flight; no model shape takes it",
    })
    k1b = k1_bf16_rows[0]
    kernels.append({
        "name": "segment_mean_base.bf16", "route": "cuda", "source": "analysisgnn_tpu_torch/csrc/segment_mean_base.cu",
        "replaces": "analysisgnn_tpu/kernels/pallas_segment.py:263",
        "launches": sum(trained[a]["launches"]["segment_mean_base.bf16"] for a in bf16_arms),
        "max_abs_err": max(r["max_abs_err"] for r in k1_bf16_rows), "ms": k1b["ms"], "plain_ms": k1b["plain_ms"],
        "bound_ms": k1b["bound_ms"], "bound_by": k1b["bound_by"], "library_ms": k1b["library_ms"],
        "device_ms": k1b["device_ms"],
        "shape": f"{k1b['case']}: E={k1b['E']} (valid {k1b['E_valid']}) F={k1b['F']} S={k1b['S']}, bf16 rows",
        "bench_batch": {k: k1_bf16_rows[1][k] for k in ("case", "E", "E_valid", "S", "ms", "device_ms", "plain_ms",
                                                          "library_ms", "bound_ms", "bound_by")},
        "f32_rows_ms": main_row["ms"], "f32_rows_device_ms": main_row["device_ms"],
        "f32_rows_bound_ms": main_row["bound_ms"],
        "per_step": {a: trained[a]["launches_per_step"]["segment_mean_base.bf16"] for a in bf16_arms},
    })
    per_step = ", ".join(f"{arm} {r['median_ms']:.2f}" for arm, r in trained.items())
    phase("train: bf16 against f32 in turns: " + ", ".join(
        f"{arm} {r['bf16_ms']:.2f} ms vs {BF16_PAIRS[arm]} {r['f32_ms']:.2f} ms" for arm, r in turns.items()))
    busy = ", ".join(f"{arm} {r['busy_ms']:.2f} of {r['wall_ms']:.2f} ms" for arm, r in traced.items())
    phase(f"train: done; ms per step {per_step}; traced steps busy {busy}; K3 in the traced edge-zxp step "
          f"{traced['edge-zxp']['group_ms']:.3f} ms of device time; parity {parity}")
    phase(f"graph build and remat: done; at {GRAPH_NOTES} notes the C++ edge builder "
          f"{graph_build['native_ms']:.2f} ms, its numpy twin {graph_build['numpy_ms']:.2f} ms, requests "
          + ", ".join(f"{n} notes {v:.1f} ms" for n, v in graph_build["request_ms"].items())
          + f"; a {REMAT_NOTES}-note train step {remat['median_ms'][False]:.2f} ms and "
          f"{remat['peak_bytes'][False] / 2**20:.1f} MiB peak without remat, {remat['median_ms'][True]:.2f} ms and "
          f"{remat['peak_bytes'][True] / 2**20:.1f} MiB with it")
    pre, hgps = zoo["pretrain"], zoo["zoo"]["HGPS"]
    phase(f"pretrain and zoo: {pre['median_ms']:.2f} ms a PreEncoder pretrain step (peak "
          f"{(pre['peak_bytes'] - pre['base_bytes']) / 2**20:.1f} MiB above what was allocated before); forward + "
          f"backward " + ", ".join(f"{k} {r['step_ms']:.2f} ms" for k, r in zoo["zoo"].items())
          + f"; HGPS peak {(hgps['peak_bytes'] - hgps['base_bytes']) / 2**20:.1f} MiB above what was allocated before; "
          f"UNet forward {zoo['unet']['forward_ms']:.2f} ms; K4 plan "
          f"call {zoo['k4_plan']['ms']:.4f} ms against {zoo['k4_plan']['searchsorted_ms']:.4f} ms with searchsorted")
    phase(f"all phases passed in {time.perf_counter() - T0:.1f}s")
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


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
