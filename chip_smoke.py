#!/usr/bin/env python3
"""Smoke run of ray_tpu_torch, the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path once and checks it, phase by phase. Every
phase runs even when an earlier one failed (its traceback is printed);
if any failed, the script exits non-zero and prints no result. Phases:

  1. build  — compile the port's CUDA kernels from ray_tpu_torch/ops/csrc
              and print the card's name and power limit;
  2. kernel — hold the flash-attention forward kernel (K1) and the
              backward kernels (K2 dq, K3 dk/dv) against their plain
              torch versions (``_blockwise_fwd``, ``_blockwise_bwd``) on
              the card at the main paths' shapes and at ragged, Sq != Sk
              and head_dim-64 shapes that reach the edges of the TMA
              tiles of K1, K2 and K3 (all three take the wgmma route in
              bf16 at head_dim 64 and 128), and time each kernel, its
              plain version, its bound and one PyTorch library call (a
              yardstick only);
              each row names the route (``attention.kernel_route``) it
              took; rows at head dims 80 (Sq < Sk), 120 (Sq > Sk), 160
              (B2, and the xl16 train step's B8), 192 (non-causal), 224
              and 256 hold K1, K2 and K3 on the padded wgmma kernels fed
              by TMA, as do rows at 16 and 32 (the entry_train step's
              B16 S512 H8), and on them fed by cp.async rows at 20 (Sq !=
              Sk), 33 (through registers) and 100 at B2 S2048 H16; in
              fp32 K1 and K3 on their ring kernels (route fma_f32_ring)
              and K2 on its FMA kernel at ModelConfig.debug's d 16, at d
              64 (ragged) and at d 16 and 128 at B2 S2048 H16, where the
              arithmetic bounds them;
              past 256, K1, K2 and K3 on wgmma in bf16 fed by TMA at D %
              8 == 0 (d 264, 320, 512 at B1 S1000 H4, 512 at B2 S2048
              H8, 384 non-causal with Sq != Sk; K2 and K3 also at the
              b1_h4 train step's B8 S2048 H4 and 320 causal with Sq <
              Sk) and by cp.async or through registers otherwise (d 300
              at both sizes, 301), on the ring-fed FMA kernels in fp32
              (d 320, at both sizes); no route runs mma.sync;
  2b. debug — the JAX package's test configs on the card through the
              kernels (head_dim 16, float32: K1 and K3 on fma_f32_ring,
              K2 on fma_f32):
              ModelConfig.debug() and tiny_moe() (routed alike) served
              and one train step of each, ViTConfig.debug() served, each
              against the plain attention within DEBUG_REL_L2_TOL, a
              float32 limit;
  3. sched  — drain 256 nodes x 100k tasks x 32 classes through the live
              raylet tick with the placement solve on CUDA: the
              single-buffered tick must place every task where the numpy
              path does, the pipelined tick must drain with the device
              mirror's drift check on;
  4. serve  — ray_tpu_torch.init(device="cuda") with a few nodes; an
              actor holds ModelConfig.b1 at full width and depth (random
              weights from a seed) and answers forward.remote(tokens)
              requests; the kernel's launch count over those requests
              must be 24 per request, all on the wgmma route, and one
              request's logits must agree with the same model on the
              plain attention; then phase b1_h4_serve does the same
              for b1's widths at 4 heads over 4 kv heads (head dim 512):
              24 K1 launches a request, all on the wgmma kernel past 256
              (route dchunk_wgmma_tma_ws), logits within
              SERVE_REL_L2_TOL of plain attention, its request seconds
              printed beside b1's;
  4a. serve_lib — the serving library: ray_tpu_torch.serve deploys b1
              (full width and depth, weights from seed 0 on the card) as
              2 replicas sharing card 0 (num_gpus 0.5 each), each
              batching up to 4 [2048]-token rows with @serve.batch (0.05
              s) into one forward through K1 inside a ``b1_batch``
              profile span; 8 client threads send 32 requests through
              the handle's P2C router, 2 more go through the HTTP proxy,
              then 8 are in flight while a calm redeploy scales to 1
              replica (the victim drains first). Every answer, the last
              position's 32,000 fp32 logits, must agree with its row
              served alone at batch 1 within SERVE_LIB_REL_TOL, HTTP
              answers with the handle's; at least one batch > 1, none >
              4; both replicas served; nothing dropped; K1 24 launches a
              batch on wgmma; one timeline span a batch. Start-up,
              latency p50/p95/max, batch sizes and requests/s print
              beside the card line;
  4b. proc_serve — the process tier: init(worker_mode="process") on
              CUDA; an actor built in its own OS process (given card 0
              by RAY_TPU_WORKER_CUDA_VISIBLE_DEVICES) serves b1 at full
              width and depth through K1 (wgmma), 24 launches a request
              counted in that process; each reply, the last position's
              [2, 32000] fp32 logits, rides the pool's shm segment and is
              held against the serve phase's; a plain task in a pool
              worker without the override sees no card, and
              build_forward raises there;
  4c. cluster — the multi-process cluster (ray_tpu_torch.cluster):
              the GCS's actor-burst placer (GcsService.
              _batch_assign_actors, state-only) places 16,384 actors in
              32 classes over 256 seeded nodes on CUDA, map equal to its
              numpy route's; a ProcessCluster at its default settings
              (its GCS on CUDA, which takes its context at start and
              alone of the servers maps libcuda.so; the raylets'
              workers given card 0; device threshold 0) takes bursts of
              32 and 16 {"CPU": 0.25} actors through
              actor_create_batch: all ALIVE, no node past its CPUs, the
              GCS's solves on CUDA, every node alive with its longest
              heartbeat gap under the 0.5 s timeout; an actor in a
              worker of the GPU raylet serves b1 (24 K1 launches a
              request on wgmma, counted in its process; last-position
              logits bit-equal to the serve phase's); a 64 MiB array put
              on one node is summed by a task on the other; every
              process the phase started is stopped and its shm segments
              swept;
  5. train  — a Cluster with one GPU node; ray_tpu_torch.train.Trainer
              with one GPU worker runs a train function that builds
              ModelConfig.b1 at full width and depth (random weights from
              a seed, remat "full") and takes 4 optimizer steps on one
              seeded [8, 2049] token batch. Losses must be finite and
              falling, K1 must launch 2 x 24 x 4 times (forward and remat
              recompute) and K2 and K3 24 x 4 times each, all three on
              the wgmma route, and one step's gradients must agree with
              the same step on the plain attention, leaf by leaf;
  5b. xl16  — the same for bench.py's 1.25 B xl at 16 heads (hidden 2560,
              16 layers, 16 heads over 8 kv heads: head_dim 160, inter
              6912, vocab 32000, remat full, logits_chunk 256, bf16) at
              full width and depth: K1 2 x 16 x 4 launches, K2 and K3
              16 x 4 each, all on the padded wgmma kernels;
  5c. b1_h4_train — the same for b1's widths at 4 heads (head_dim 512):
              K1 2 x 24 x 4 launches, K2 and K3 24 x 4 each, all on the
              bf16 wgmma kernels past 256 (route dchunk_wgmma_tma_ws);
  5d. entry_train — the same for the entry point's model
              (tools/multichip.py's ENTRY_MODEL: vocab 2048, hidden 256, 4
              layers, 8 heads over 4 kv heads, head_dim 32, inter 704,
              bf16, remat off) at [16, 513] tokens (its max_seq 512): K1,
              K2 and K3 4 x 4 launches each, all on the padded wgmma
              kernels fed by TMA (route wgmma_tma_ws_padded);
  6. moe    — the bench's sparse model (bench.py's MoE row: hidden 1024,
              8 layers, 16 heads over 8 kv heads, head_dim 64, inter
              2816, vocab 32000, top-2 of 8 experts on every second
              layer, 4096-token groups, remat, logits_chunk 256, bf16) at
              full width and depth: an actor serves it at [2, 2048]
              tokens (K1 8 launches a request, logits held against the
              plain attention); Trainer(num_workers=1, use_gpu=True)
              takes steps on one seeded [16, 2049] batch (K1 2 x 8, K2
              and K3 8 a step, all on the wgmma route at head_dim 64),
              saves (params, opt_state) with models.checkpoint after step
              2, restores it onto a fresh init (every leaf equal), and
              goes on from the restored state; losses finite and falling,
              the aux loss finite and > 0; one step's gradients held
              against the plain attention;
  7. vit    — ViTConfig.base() (ViT-B/16, bf16): an actor serves seeded
              [64, 224, 224, 3] image batches (K1 12 launches a request at
              S 197, non-causal, logits held against the plain
              attention); then 3 ClippedAdamW steps at batch 128 through
              loss_fn and autograd (K1, K2 and K3 12 a step), and one
              step's gradients held against the plain attention;
  8. data   — ray_tpu_torch.data feeding the card: 16 b1 token rows
              (int64 [2049], seed 0) through from_items(parallelism=4),
              random_shuffle(seed=0) and repeat(2) are the dataset of
              Trainer(num_workers=1, use_gpu=True) on the train phase's
              cluster; the train function takes one b1 step (full width
              and depth, remat full, seed-0 weights) on each batch of 8
              that its shard's to_device feeds: 4 steps. Every fed batch
              must be int32 on cuda [8, 2049] and equal to the batch the
              script computes on the host from the same pipeline
              (iter_batches, JAX's x64-off dtypes); K1, K2 and K3 must
              launch 192, 96 and 96 times on wgmma; losses finite and
              falling. Then ViT-B/16's input alone: 256 seeded image rows
              [224, 224, 3] float32, repeated twice, fed in batches of 128,
              each equal to its host batch. It prints the feed's ms a
              batch, the steady step and tokens/s beside the train
              phase's, and the ViT feed's images/s beside the vit
              phase's;
  9. tune   — ray_tpu_torch.tune on the card: five b1 trials (full width
              and depth, seed-0 weights, the train phase's batch, 6
              steps; ClippedAdamW at lr 1e-4, 3e-4, 3e-2, 1e-1, 1e-3, in
              that order) through Trainer(num_workers=1, use_gpu=True,
              GPU 0.5).to_tune_trainable under ASHA (grace 2, factor 2,
              max_t 6), two at a time on a one-GPU cluster. Every trial
              ends TERMINATED with finite losses, the first the train
              phase's; ASHA stops the two bad rates at rung 2, and the
              last trial then gets the card; the best config is a good
              rate; two trials' steps overlap on the card; K1, K2 and K3
              launch 48, 24 and 24 times for each b1 step the train
              functions finished, on wgmma; after tune.run the GPU
              resource is whole again, no placement group and no trial or
              train thread is left, and the card memory is back within
              TUNE_MEM_SLACK of its value before the phase. It prints each
              trial's losses, the steady step alone and shared, the peak
              and each stopped trial's time from its stop to its weights
              being freed;
  10. rllib — ray_tpu_torch.rllib on the card (no K1-K3 launch; its
              launch counts are reported, all 0): each translated policy
              class (PPO, DQN, PG, MARWIL, A2C, SAC, IMPALA, APPO, DDPG,
              TD3, continuous SAC, CQL), the QMIX and VDN networks and
              the three catalog nets built on cuda and on the CPU from
              the same numpy weights, three updates on one seeded batch,
              the worst weight leaf's rel L2 within RLLIB_REL_L2 (fp32;
              RLLIB_SQUASHED_REL_L2 for the squashed Gaussians,
              RLLIB_VISION_REL_L2 for vision_net's TF32 convs) and every
              tensor of each on cuda; PPO, DQN and continuous SAC learn
              their test environments to the tests' thresholds with two
              rollout workers on the thread tier, every other trainer
              takes two iterations with finite stats; every torch
              policy the trainers built, the learner's and each rollout
              worker's (built in this process on the thread tier), holds
              its tensors on cuda; PPOTrainer on CartPole at upstream RLlib's PPO
              defaults (256x256, batch 4000, minibatch 128, 30 SGD
              passes, 2 workers) for 3 iterations, each train() split
              into sampling and learning; vision_net at 84x84x4 (batch
              128) forward+backward timed and held against the CPU; the
              card's memory after trainer.stop() within RLLIB_MEM_SLACK
              of its value before the phase;
  11. workflow — ray_tpu_torch.workflow on the card: workflow.init
              (storage in WORKFLOW_DIR, removed after) starts the runtime
              on CUDA; a four-step DAG: init_b1 writes b1's seeded
              weights and AdamW state with models/checkpoint.py, train_b1
              takes WORKFLOW_STEPS steps at TRAIN_TOKENS from the latest
              checkpoint and writes the next, a second train_b1
              (max_retries=0) dies on its first attempt (a marker file),
              serve_b1 serves two seeded [2048] prompts and returns the
              last-position logits on the card. The first run ends
              FAILED; workflow.resume finishes it, launching K1, K2 and K3
              for the unfinished steps alone (the second train and the
              serve); its losses and logits are bit-equal to an
              uninterrupted run of the same DAG under another id, and
              get_output gives the stored result on the card. Each
              step's checkpoint read and write times print;
  12. persist — a detached, named b1 actor (seed-0 weights) serves
              through K1; gcs.persistence.save_snapshot, shutdown() (the
              card's memory back within PERSIST_MEM_SLACK of its value
              before the actor), init(), restore_snapshot; the restored
              actor, found by name, answers the serve phase's prompts
              with last-position logits bit-equal to the serve phase's;
              the snapshot's size and save/restore times print;
  13. client — ray:// client mode: a ``python -m
              ray_tpu_torch.util.client.server`` process whose runtime is
              on CUDA; this process, with no runtime of its own, connects
              with init(address="ray://..."), creates a b1 actor over the
              wire and gets its last-position logits back in client
              frames as CUDA tensors, bit-equal to the serve phase's; K1's
              launches are counted in the server's process;
              CLIENT_REQUESTS requests' round trips print beside as many
              direct calls to a b1 actor of a local runtime, made first
              and shut down before client mode; the server is killed and its card memory freed (free memory
              back within CLIENT_MEM_SLACK);
  14. util  — ray_tpu_torch.util on the card: UTIL_ROWS seeded [2048]
              rows through util.iter.from_items(num_shards=2).gather_sync()
              into a util.queue.Queue, drained by a b1 actor in batches of
              up to UTIL_MAX_BATCH through K1; every answer bit-equal to
              the row served alone at batch 1; QUEUE_OPS host puts, then
              as many gets, each timed as one window, print the queue's
              puts and gets per second;
  15. ops   — the cluster operator's surface: the runtime of the earlier
              phases shut down, create_or_update_cluster on the process
              provider (its GCS on CUDA; node types head {CPU: 2} and
              gpu {CPU: 2, GPU: 1}, 0 to 1 of them, idle timeout
              OPS_IDLE_S); a pending {GPU: 1, CPU: 1} placement group
              makes the autoscaler's monitor launch exactly one gpu node
              and the group CREATED, then removed; a task with
              resources {GPU: 1} and runtime_env {py_modules: [a package
              the phase writes], env_vars: {B1_TAG}} builds b1 from seed
              0 on that node (its workers given card 0) and serves the
              serve phase's 4 requests: the package reaches the node as
              a pymod:// URI through the GCS KV (the servers' module
              cache is not this process's), K1 24 launches a request on
              wgmma in the task's process, the last-position logits
              bit-equal to the serve phase's; the idle gpu node is
              terminated; a job (JobSubmissionClient.submit_job, its
              entrypoint a script the phase writes) goes PENDING ->
              RUNNING -> SUCCEEDED serving b1 from an actor of its own
              runtime on the card (launches in its log, logits saved and
              bit-equal); a second job loads b1 and waits until
              stop_job gives STOPPED and the card's free memory is back
              within OPS_MEM_SLACK; `python -m ray_tpu_torch status`,
              `job list`, `job status` and `job logs` on the cluster
              exit 0 and name both jobs; teardown_cluster leaves no GCS
              or raylet process, no state file and the card's memory
              back within OPS_MEM_SLACK; `python -m ray_tpu_torch
              microbenchmark --json` in a process of its own prints the
              JAX package's seven rows with their spread;
  16. dash  — both dashboards over b1 served through K1. The process
              tier: a ProcessCluster at its default settings (its GCS on
              CUDA) and one raylet {CPU: 2, GPU: 1} whose workers get
              card 0; the head as `python -m
              ray_tpu_torch.observability.dashboard_head --gcs <addr>`
              (its start to DASHBOARD_URL prints; it maps no libtorch);
              a b1 actor on that node serves the serve phase's 4
              requests (24 K1 launches a request on wgmma in the
              actor's process, logits bit-equal to the serve phase's),
              each printing a marker line; then over HTTP: /healthz ok,
              / is text/html naming /api/nodes, /api/cluster shows the
              node alive with GPU 1, /api/nodes its agent's pid and rss
              and thread roots that are all labels the port's raycheck
              derives statically (lambda roots counted apart),
              /api/actors the actor ALIVE, /api/logs?n=500 its 4
              markers, /api/jobs a shell job submitted through
              JobSubmissionClient SUCCEEDED; each route's median of
              DASH_GETS gets (ms) while 4 more requests are in flight;
              after shutdown the card's free memory is back within
              OPS_MEM_SLACK, no process of the cluster or the head is
              left and no shm segment of its raylet. The thread tier:
              init() on CUDA, a named b1 actor serving the 4 requests
              from one task each (bit-equal, 96 launches), then
              start_dashboard(): every JSON route answers, /api/actors
              names the actor, /metrics carries ray_tpu_tasks_finished
              moved by at least the requests.
  17. parallel — parallel/ and collective/ on one card: four ranks as
              spawned processes (parallel.multihost.RankPool), each on
              card 0, joined by gloo (NCCL takes one rank per card), so
              every collective stages its CUDA tensor through pinned
              host memory (collective.api.staged_bytes). Three sub-steps,
              each with fresh ranks and first computed on one rank in
              this process on the same card, weights and inputs: b1 (seed
              0) served at sp=4 by build_forward(mesh=) for the serve
              phase's first 2 prompts, Ulysses (K1 on [2, 2048, 4, 128]
              a rank, 24 launches a request) and ring (fp32 block math,
              no launch); the logits gathered over sp within
              SERVE_LIB_REL_TOL of one rank's, last argmax equal; one
              ulysses_attention forward and backward at b1's train shape
              [8, 2048, 16, 128] split 4 ways (K1, K2, K3 once a rank),
              out within KERNEL_TOL and gradients within GRAD_REL_L2_TOL
              of one rank's flash_attention; b1 trained by
              build_pipeline_train_step over pp=4 (6 layers a stage, 4
              microbatches, 7 ticks) for 3 steps at [8, 2049]: step 1's
              gradients of each stage's first layer and of embed within
              GRAD_REL_L2_TOL of one rank's, each step's loss within
              PARALLEL_LOSS_TOL and grad norm within GRAD_REL_L2_TOL of
              build_train_step's, and per rank exactly 2 x 7 x 6 K1 and
              7 x 6 K2 and K3 launches a step (remat). Then the mesh
              parts in one pool: b1 served at tp 4, trained at dp2 x
              tp2 (saved with DCP, restored at tp 4 for the next step)
              and at FSDP dp 4, the bench MoE model with its experts
              over dp 4 (part ep) and at dp2 x sp2 with ring attention
              (part ep_sp: each 4096-token group two 2048-token rows cut
              over both sp ranks), each held against one rank's steps.
              Last, two NCCL ranks on card 0 must refuse to start (one
              rank per card; no switch to gloo). Latency, step time,
              staged bytes, peak memory and rank start-up print beside
              the card line;
  18. dryrun — ray_tpu_torch.tools.multichip.dryrun_multichip(4) with
              four gloo ranks on card 0: the dp x sp x tp MoE step, the
              FSDP step, the pp 2 x tp 2 pipeline step and the train
              runtime (Trainer(num_workers=2), a store collective group,
              rank 0 driving the first step through the ranks), each
              loss finite.

    python3 chip_smoke.py --cards 4

runs phases build, parallel and dryrun alone with four NCCL ranks, one
a card (parallel.multihost.RankPool's cuda_device="per_rank"), and
prints each rank's card (four distinct UUIDs), staged bytes (0: nothing
stages), step seconds, the share of them inside the collectives (each
op timed between two card synchronizations) and peak memory, and
``nvidia-smi topo -m``; it ends with the same contract line.

The line before the last is the card's name and power limit as
nvidia-smi prints them; above it, one JSON line with the kernel table
(``launches`` summed over the model paths, per path in
``launches_by_path``, per route in ``launches_by_route``; ``kernel_route``
is the route at the b1 train shape; ``head_dims_by_route`` the head dims
the kernel phase ran on each route).
The last line is {"ok": true, "device": {...}}. Details go to
chiprun_out/chip_smoke.json. Without CUDA the script exits 2 and
prints no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import traceback
import weakref

# published peaks of one H100 SXM (NVIDIA data sheet; dense): the bound
H100_PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
H100_HBM_BYTES_PER_S = 3.35e12

# kernel vs plain version on the card. bf16 out: both round an fp32
# accumulation to bf16 (8 bits), the kernel also rounds P to bf16 before
# P.V as the TPU kernel does, so they differ by up to a few bf16 ulps of
# values of magnitude ~1; lse is fp32 in both from the same bf16 inputs,
# apart only by summation order and exp/log rounding. fp32: summation
# order only.
KERNEL_TOL = {
    "bfloat16": {"out": (2e-2, 2e-2), "lse": (1e-3, 1e-4)},
    "float32": {"out": (1e-4, 1e-4), "lse": (1e-4, 1e-4)},
}
# K2/K3 vs _blockwise_bwd on the card, (atol, rtol) on dq, dk and dv.
# bf16: the kernels round ds (and p, for dv) to bf16 before the products
# that consume them, as the TPU kernels do, and round the results to
# bf16; the plain version keeps fp32 throughout. They differ by a few
# bf16 steps (2^-8 relative) of gradients up to ~6 in magnitude (first
# chip check: max abs 0.031). fp32: summation order only (<= 1e-6).
BWD_TOL = {"bfloat16": (5e-2, 2e-2), "float32": (1e-5, 1e-5)}
# served logits, kernel vs plain attention, relative L2: the two
# attentions round differently at bf16's 2^-9 relative step, and 24
# residual layers compound that; a wrong kernel (mask, scale, row)
# moves the logits by O(1)
SERVE_REL_L2_TOL = 3e-2

KERNEL_SHAPES = [
    # name, B, S, H, D, causal, dtype — b1's served shape, b1's train
    # shape, entry()'s shape after the GQA repeat, a ragged fp32 one, and
    # for the wgmma route: a ragged length (a last q tile and K/V tile
    # that TMA fills past S with zeros), causal and not, and head_dim 64
    ("b1", 2, 2048, 16, 128, True, "bfloat16"),
    ("train", 8, 2048, 16, 128, True, "bfloat16"),
    ("entry", 2, 128, 8, 32, True, "bfloat16"),
    ("ragged", 1, 1000, 4, 64, False, "float32"),
    ("ragged_causal_bf16", 1, 1000, 4, 128, True, "bfloat16"),
    ("ragged_bf16", 1, 1000, 4, 128, False, "bfloat16"),
    ("d64", 2, 2048, 16, 64, True, "bfloat16"),
    # the MoE train step's shape (16 heads after the GQA repeat) and the
    # ViT-B/16 train step's (196 patches + CLS, non-causal)
    ("moe", 16, 2048, 16, 64, True, "bfloat16"),
    ("vit", 128, 197, 12, 64, False, "bfloat16"),
    # head dims off the wgmma route's 64 and 128 (K1, K2 and K3 on their
    # padded wgmma kernels in bf16, fed by TMA at D % 8 == 0 and by
    # cp.async off it; FMA in fp32): ModelConfig.debug's attention; d 16
    # in bf16 at a ragged length; d 20 (a 40-byte row) with Sq != Sk,
    # given as an 8th field; bench.py's xl width at 16 heads; the widest;
    # the xl16 train step's shape; the backward rows' d 80 (Sq < Sk), d
    # 192 (non-causal), d 120 (padded to 128, Sq > Sk) and d 224 below;
    # fed through registers at an odd D (33), and by 8-byte cp.async at a
    # size where the arithmetic bounds it (d 100, B2 S2048 H16); fp32 (K1
    # and K3 on their ring kernels, K2 on FMA) at the debug configs' d 16
    # and, where the arithmetic bounds the work, at d 16 and 128 at B2
    # S2048 H16
    ("debug_f32", 2, 128, 4, 16, True, "float32"),
    ("d16_f32_wide", 2, 2048, 16, 16, True, "float32"),
    ("d128_f32_wide", 2, 2048, 16, 128, True, "float32"),
    ("d16_bf16", 2, 1000, 4, 16, True, "bfloat16"),
    ("d20_ragged", 1, 1000, 4, 20, False, "bfloat16", 700),
    ("d160", 2, 2048, 16, 160, True, "bfloat16"),
    ("d256_ragged", 1, 1000, 4, 256, True, "bfloat16"),
    ("xl16_train", 8, 2048, 16, 160, True, "bfloat16"),
    ("d80_sq_lt_sk", 1, 700, 4, 80, True, "bfloat16", 1000),
    ("d192_noncausal", 2, 1000, 8, 192, False, "bfloat16"),
    ("d120_sq_gt_sk", 1, 1000, 4, 120, True, "bfloat16", 700),
    ("d224", 2, 2048, 8, 224, True, "bfloat16"),
    ("d33_odd", 1, 1000, 4, 33, True, "bfloat16"),
    ("d100_wide", 2, 2048, 16, 100, True, "bfloat16"),
    # past 256: K1 on wgmma in bf16 at 264 (two slices of 136 columns),
    # 320 and 512, on the ring-fed FMA kernel in fp32 at 320, each also at
    # a size where the work is bound by the arithmetic (B2 S2048 H8; the
    # B1 S1000 H4 rows take 64-row tiles to fill the card); d 384
    # non-causal with Sq != Sk (the masks of keys past Sk and rows past
    # Sq); d 300 in bf16 (D % 8 != 0: TMA cannot take the row stride) on
    # the wgmma kernel fed by 8-byte cp.async, at both sizes, and d 301
    # fed through registers
    ("d264", 1, 1000, 4, 264, True, "bfloat16"),
    ("d320", 1, 1000, 4, 320, True, "bfloat16"),
    ("d512", 1, 1000, 4, 512, True, "bfloat16"),
    ("d320_f32", 1, 1000, 4, 320, True, "float32"),
    ("d512_wide", 2, 2048, 8, 512, True, "bfloat16"),
    ("d320_f32_wide", 2, 2048, 8, 320, True, "float32"),
    ("d384_noncausal", 2, 1000, 8, 384, False, "bfloat16", 700),
    ("d300", 1, 1000, 4, 300, True, "bfloat16"),
    ("d300_wide", 2, 2048, 8, 300, True, "bfloat16"),
    ("d301", 1, 1000, 4, 301, True, "bfloat16"),
    # b1's widths at 4 heads trained (phase b1_h4_train): its attention
    ("b1_h4_train", 8, 2048, 4, 512, True, "bfloat16"),
    # the entry point's model trained (phase entry_train): its attention
    ("entry_train", 16, 512, 8, 32, True, "bfloat16"),
]

BWD_SHAPES = [
    # name, B, Sq, Sk, H, D, causal, dtype — the b1 train step's shape
    # (8 x 2048 tokens), entry()'s shape, a ragged fp32 one with Sq != Sk,
    # and for the wgmma route of K2 and K3: Sq > Sk at head_dim 64 and
    # Sq < Sk at 128 (causal, top-left aligned: the last key tiles see no
    # query and write zeros), both ragged, and a ragged non-causal one
    # (K2's mask of the keys past Sk without the causal bound)
    ("train", 8, 2048, 2048, 16, 128, True, "bfloat16"),
    ("entry", 2, 128, 128, 8, 32, True, "bfloat16"),
    ("ragged", 1, 1000, 700, 4, 64, False, "float32"),
    ("ragged_bf16", 1, 1000, 700, 4, 64, True, "bfloat16"),
    ("sq_lt_sk_bf16", 1, 700, 1000, 4, 128, True, "bfloat16"),
    ("ragged_noncausal_bf16", 1, 1000, 1000, 4, 128, False, "bfloat16"),
    ("moe", 16, 2048, 2048, 16, 64, True, "bfloat16"),
    ("vit", 128, 197, 197, 12, 64, False, "bfloat16"),
    # the kernel phase's rows at head dims off 64 and 128 (K2 and K3 on
    # the padded wgmma kernels at d 16, 160 and 256 fed by TMA, at 20, 33
    # (through registers) and 100 at B2 S2048 H16 fed by cp.async); for
    # the padded kernels: the xl16 train step's shape, d 80 (padded to
    # 96: a 64-column box, then a 32-column piece whose last 16 columns TMA
    # fills with zeros) at Sq < Sk (causal, top-left aligned: the last key
    # tiles see no query and write zeros), d 192 (one whole box past
    # 128) without the causal bound, d 120 (padded to 128 in one 128-key
    # tile of K1) at Sq > Sk (the rows past Sk see every key), and d 224
    # (a 32-column piece past three boxes) at a long causal length; fp32
    # at the debug configs' d 16 and at d 16 and 128 at B2 S2048 H16
    ("debug_f32", 2, 128, 128, 4, 16, True, "float32"),
    ("d16_f32_wide", 2, 2048, 2048, 16, 16, True, "float32"),
    ("d128_f32_wide", 2, 2048, 2048, 16, 128, True, "float32"),
    ("d16_bf16", 2, 1000, 1000, 4, 16, True, "bfloat16"),
    ("d20_ragged", 1, 1000, 700, 4, 20, False, "bfloat16"),
    ("d160", 2, 2048, 2048, 16, 160, True, "bfloat16"),
    ("d256_ragged", 1, 1000, 1000, 4, 256, True, "bfloat16"),
    ("xl16_train", 8, 2048, 2048, 16, 160, True, "bfloat16"),
    ("d80_sq_lt_sk", 1, 700, 1000, 4, 80, True, "bfloat16"),
    ("d192_noncausal", 2, 1000, 1000, 8, 192, False, "bfloat16"),
    ("d120_sq_gt_sk", 1, 1000, 700, 4, 120, True, "bfloat16"),
    ("d224", 2, 2048, 2048, 8, 224, True, "bfloat16"),
    ("d33_odd", 1, 1000, 1000, 4, 33, True, "bfloat16"),
    ("d100_wide", 2, 2048, 2048, 16, 100, True, "bfloat16"),
    # the entry_train step's attention (one 64-column box: K3's two
    # warpgroups split its two products)
    ("entry_train", 16, 512, 512, 8, 32, True, "bfloat16"),
    # past 256 the forward's rows, backward too: K2 and K3 on wgmma in
    # bf16 (slices of dq padded to 160 at 264 and 320, 256 at 512; of dk
    # and dv to 96 and 128) and on the ring-fed FMA kernels in fp32, each
    # also at a size where the arithmetic bounds it (B2 S2048 H8), and at
    # the b1_h4 train step's attention (B8 S2048 H4 D512); d 384 without
    # the causal bound at Sq 1000 > Sk 700 (the keys past Sk masked, rows
    # past Sk of dk/dv never written); d 320 causal at Sq 700 < Sk 1000
    # (top-left aligned: the last key tiles see no query and write
    # zeros); d 300 (D % 8 != 0: TMA cannot take the row stride) on the
    # wgmma kernels fed by cp.async, at both sizes, and d 301 fed through
    # registers
    ("d264", 1, 1000, 1000, 4, 264, True, "bfloat16"),
    ("d320", 1, 1000, 1000, 4, 320, True, "bfloat16"),
    ("d512", 1, 1000, 1000, 4, 512, True, "bfloat16"),
    ("d320_f32", 1, 1000, 1000, 4, 320, True, "float32"),
    ("d512_wide", 2, 2048, 2048, 8, 512, True, "bfloat16"),
    ("d320_f32_wide", 2, 2048, 2048, 8, 320, True, "float32"),
    ("b1_h4_train", 8, 2048, 2048, 4, 512, True, "bfloat16"),
    ("d384_noncausal", 2, 1000, 700, 8, 384, False, "bfloat16"),
    ("d320_sq_lt_sk", 1, 700, 1000, 4, 320, True, "bfloat16"),
    ("d300", 1, 1000, 1000, 4, 300, True, "bfloat16"),
    ("d300_wide", 2, 2048, 2048, 8, 300, True, "bfloat16"),
    ("d301", 1, 1000, 1000, 4, 301, True, "bfloat16"),
]
# the rows of KERNEL_SHAPES and BWD_SHAPES off the wgmma route, reported
# beside the model shapes in the kernels line (each kernel at the rows it
# has)
HEAD_DIM_SHAPES = ("debug_f32", "d16_f32_wide", "d128_f32_wide", "d16_bf16",
                   "d20_ragged", "d160", "d256_ragged", "xl16_train",
                   "d80_sq_lt_sk", "d192_noncausal", "d120_sq_gt_sk", "d224",
                   "d264", "d320", "d512", "d320_f32", "d512_wide",
                   "d320_f32_wide", "d384_noncausal", "d300", "d33_odd",
                   "d100_wide", "d300_wide", "d301", "b1_h4_train",
                   "d320_sq_lt_sk", "entry_train")

SCHED = dict(nodes=256, tasks=100_000, classes=32)
SCHED_PIPELINED_TICKS = 3
# the cluster phase: the GCS burst placer at the scheduler's verdict
# scale (256 nodes x 32 classes = 8,192 cells, the device threshold's
# default), 3 timed bursts a route; the live cluster's burst of
# {"CPU": 0.25} actors; its cross-node object; each raylet's store
CLUSTER_PLACER = dict(nodes=256, actors=16_384, classes=32, bursts=3)
CLUSTER_BURST = 32
CROSS_NODE_BYTES = 64 << 20
CLUSTER_STORE_BYTES = 512 << 20
SERVE_REQUESTS = 4
SERVE_TOKENS = (2, 2048)
# the serve_lib phase: b1 through ray_tpu_torch.serve, two replicas on
# one card batching up to 4 [2048]-token rows; 8 client threads of 4
# requests, 2 over HTTP, then 8 in flight across a scale-down to 1
SERVE_LIB = dict(replicas=2, max_batch=4, wait_s=0.05, max_queries=8,
                 clients=8, per_client=4, http=2, inflight=8, seq=2048)
# each answer against the same row served alone (batch 1) on the same
# weights, relative L2; the HTTP answer's sum against the handle's, over
# the row's L1 norm. Only cuBLAS's choice of kernel for another batch M
# can move them (bf16 rounding compounded through 24 layers); a row
# answered from another row or another batch position moves them by O(1)
SERVE_LIB_REL_TOL = 2e-2
TRAIN_STEPS = 4
TRAIN_TOKENS = (8, 2049)  # [B, S + 1]: next-token targets for S = 2048
# the entry_train phase's batch: [B, S + 1] at the model's max_seq 512
ENTRY_TRAIN_TOKENS = (16, 513)
# the bench's MoE batch (RAY_TPU_BENCH_MODEL_MOE_BATCH's default, 16)
MOE_TRAIN_TOKENS = (16, 2049)
MOE_TRAIN_STEPS = 4
MOE_CKPT_STEP = 2  # saved after 2 steps, restored, and trained on from
# the checkpoint of the moe phase: in the checkout (listed in .gitignore)
# and removed when the phase ends
CKPT_DIR = ".chip_smoke_ckpt"
VIT_SERVE_IMAGES = 64
VIT_TRAIN_IMAGES = 128
VIT_TRAIN_STEPS = 3
# the data phase: DATA_ROWS b1 token rows (seed 0) shuffled (seed 0) and
# repeated twice, fed in batches of TRAIN_TOKENS[0]: TRAIN_STEPS steps;
# ViT's feed alone over VIT_FEED_IMAGES image rows (seed 1), repeated
# twice, in batches of VIT_TRAIN_IMAGES
DATA_ROWS = 16
DATA_PARALLELISM = 4
VIT_FEED_IMAGES = 256
# the tune phase: b1 trials of TUNE_STEPS steps under ASHA (grace 2,
# factor 2, max_t TUNE_STEPS), two at a time, in this order: two good
# learning rates set the rungs; the two bad ones (a step-2 loss above the
# good trials') start when those end and are stopped at rung 2; the last
# needs the card share (GPU 0.5 a trial) that the stopped ones held
TUNE_STEPS = 6
TUNE_LRS = (1e-4, 3e-4, 3e-2, 1e-1, 1e-3)
TUNE_BAD_LRS = (3e-2, 1e-1)
# a tune trial's first loss is the train phase's first (the same seed-0
# weights and batch, before any update): relative difference, as train's
# replay check
TUNE_FIRST_LOSS_RTOL = 1e-3
# after tune.run, the card memory allocated may exceed its value before
# the phase by at most this: PyTorch may keep a cuBLAS workspace for each
# trial's thread; a trial's weights and AdamW state are ≈ 8 GiB
TUNE_MEM_SLACK = 1 << 30
# one step's gradients, kernels vs the plain attention, relative L2 per
# leaf: both run the same bf16 model; the kernels round p and ds to bf16
# inside attention (the plain version keeps fp32) and that difference
# flows back through 24 layers; a wrong kernel (mask, scale, transpose)
# moves the gradients by O(1)
GRAD_REL_L2_TOL = 5e-2
# the debug phase's float32 configs, kernels vs plain attention, relative
# L2 on the logits and on the worst gradient leaf: fp32 in and fp32
# accumulate on both sides, apart only by summation order (~1e-6). A
# bf16 (2^-9) or TF32 (2^-11) product inside a kernel would move them by
# ~1e-3, so the b1 limits above, set for bf16, would not see it
DEBUG_REL_L2_TOL = 1e-4


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# --------------------------------------------------------------- phase 1


def ptxas_report(log: str) -> list:
    """One row per compiled kernel of ``nvcc -Xptxas=-v``'s report: its
    name, registers, spill bytes and any performance note."""
    rows, notes = [], {}
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            rows.append({"kernel": ln.split("'")[1], "notes": []})
        elif "Potential Performance Loss" in ln:
            # names its function, and may come before that function's rows
            notes.setdefault(ln.split("'")[1], []).append(
                ln.split("Loss:")[1].split(" for ")[0].strip())
        elif rows and "spill stores" in ln:
            rows[-1]["spill"] = ln.split(":")[-1].strip()
        elif rows and "Used" in ln and "registers" in ln:
            rows[-1]["registers"] = int(ln.split("Used")[1].split()[0])
    for row in rows:
        row["notes"] = notes.get(row["kernel"], [])
    return rows


def _spill_bytes(spill: str) -> int:
    """The spill-store bytes of a ptxas "... bytes spill stores ..." line."""
    found = re.search(r"(\d+) bytes spill stores", spill)
    return int(found.group(1)) if found else 0


def phase_build(report: dict) -> None:
    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.tools.check_head_dims import kernel_name

    t0 = time.monotonic()
    log = attention.build_kernels()
    report["build_s"] = time.monotonic() - t0
    report["ptxas"] = ptxas_report(log)
    report["card"] = card_line()
    print(f"build: kernels built in {report['build_s']:.1f} s on "
          f"{report['card']}", flush=True)
    for row in report["ptxas"]:
        if any(tag in row["kernel"] for tag in ("_ws_kernel", "padded_kernel",
                                                 "dchunk_wgmma_kernel",
                                                 "ring_f32_kernel")):
            print(f"build: ptxas {kernel_name(row['kernel'])[-60:]}: "
                  f"{row.get('registers')} registers at entry, "
                  f"{row.get('spill')} {row['notes']}", flush=True)
    # K2's fp32 FMA kernel up to 256: one instantiation per padded head dim
    small = [r for r in report["ptxas"]
             if "f32_kernel" in r["kernel"]
             and "ring_f32_kernel" not in r["kernel"]]
    spilling = [r for r in small if _spill_bytes(r.get("spill", ""))]
    report["ptxas_fma"] = {
        "kernels": len(small),
        "max_registers": max((r.get("registers", 0) for r in small),
                             default=0),
        "spilling": [f"{r['kernel']}: {r.get('spill')}" for r in spilling]}
    print(f"build: {len(small)} FMA (K2 fp32) instantiations, at most "
          f"{report['ptxas_fma']['max_registers']} registers, "
          f"{len(spilling)} of them spill", flush=True)


# --------------------------------------------------------------- phase 2


def _pairs(sq, sk, causal):
    """(query, key) pairs the mask keeps (top-left causal alignment)."""
    if not causal:
        return sq * sk
    if sq <= sk:
        return sq * (sq + 1) // 2
    return sk * (sk + 1) // 2 + (sq - sk) * sk


def _attention_work(kernel, b, sq, sk, h, d, causal, dtype):
    """(bound ms, what bounds it): the larger of FLOPs over the card's
    peak and bytes over its HBM rate. FLOPs: 2*d per kept pair and
    product (fwd: S, P.V; dq: S, dP, ds.K; dk/dv: S, dP, p.dO, ds.Q).
    Bytes: each input read once, each output written once."""
    elt = 2 if dtype == "bfloat16" else 4
    q_bytes = b * sq * h * d * elt
    kv_bytes = b * sk * h * d * elt
    row_bytes = b * h * sq * 4  # lse or delta
    products, nbytes = {
        "fwd": (2, 2 * q_bytes + 2 * kv_bytes + row_bytes),
        "dq": (3, 3 * q_bytes + 2 * kv_bytes + 2 * row_bytes),
        "dkdv": (4, 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes),
    }[kernel]
    flops = 2 * d * products * b * h * _pairs(sq, sk, causal)
    t_ops = flops / H100_PEAK_FLOPS[dtype]
    t_bytes = nbytes / H100_HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _sdpa_backend(q, k, v, causal: bool) -> str:
    """The SDPA backend PyTorch's dispatch picks for [B, H, S, D] q/k/v
    (the flash backend stops at head dim 256)."""
    import torch
    from torch.nn.attention import SDPBackend

    try:
        choice = torch._fused_sdp_choice(q, k, v, is_causal=causal)
    except Exception as exc:  # noqa: BLE001 — reported, not fatal
        return f"unknown ({type(exc).__name__})"
    for backend in SDPBackend.__members__.values():
        if int(backend) == int(choice):
            return backend.name
    return f"unknown ({choice})"


def phase_kernel(report: dict) -> None:
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention

    rows = []
    for name, b, s, h, d, causal, dtype, *rest in KERNEL_SHAPES:
        sk = rest[0] if rest else s
        dt = getattr(torch, dtype)
        g = torch.Generator(device="cuda").manual_seed(len(rows))
        q = torch.randn((b, s, h, d), generator=g, device="cuda").to(dt)
        k, v = (torch.randn((b, sk, h, d), generator=g, device="cuda")
                .to(dt) for _ in range(2))
        scale = d ** -0.5
        out, lse = attention._fwd_dispatch(q, k, v, causal)
        torch.cuda.synchronize()
        p_out, p_lse = attention._blockwise_fwd(q, k, v, causal, scale)
        err_out = (out.float() - p_out.float()).abs().max().item()
        err_lse = (lse - p_lse).abs().max().item()
        tol = KERNEL_TOL[dtype]
        for what, got, want in (("out", out, p_out), ("lse", lse, p_lse)):
            atol, rtol = tol[what]
            if not torch.allclose(got.float(), want.float(), atol=atol,
                                  rtol=rtol):
                raise AssertionError(
                    f"kernel {what} disagrees with the plain version at "
                    f"{name}: max abs err {err_out if what == 'out' else err_lse}"
                    f" (atol {atol}, rtol {rtol})")
        if not (torch.isfinite(out).all() and torch.isfinite(lse).all()):
            raise AssertionError(f"kernel output not finite at {name}")
        ms = cuda_ms(lambda: attention._fwd_dispatch(q, k, v, causal), 20)
        plain_ms = cuda_ms(
            lambda: attention._blockwise_fwd(q, k, v, causal, scale), 5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal), 20)
        library = _sdpa_backend(qt, kt, vt, causal)
        bound_ms, bound_by = _attention_work("fwd", b, s, sk, h, d, causal,
                                             dtype)
        route = attention.kernel_route("fwd", dt, d)
        row = {"shape": name, "B": b, "S": s, "Sk": sk, "H": h, "D": d,
               "causal": causal, "dtype": dtype, "route": route,
               "max_abs_err": err_out,
               "max_abs_err_lse": err_lse, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms, "library_backend": library}
        rows.append(row)
        print(f"kernel: {name} B{b} S{s} Sk{sk} H{h} D{d} causal={causal} "
              f"{dtype} [{route}]: err out {err_out:.3g} lse {err_lse:.3g}; "
              f"ms {ms:.4f} plain {plain_ms:.4f} bound {bound_ms:.4f} "
              f"({bound_by}) sdpa {library_ms:.4f} ({library})", flush=True)
        del q, k, v, out, lse, p_out, p_lse
    report["kernel_shapes"] = rows
    report["bwd_shapes"] = [_bwd_row(*shape) for shape in BWD_SHAPES]


def _bwd_row(name, b, sq, sk, h, d, causal, dtype):
    """K2 and K3 at one shape: held against _blockwise_bwd, then timed
    each alone (on the same inputs), beside the plain backward (dq, dk
    and dv in one call) and the SDPA backward (the same)."""
    import torch
    import torch.nn.functional as F

    from ray_tpu_torch.ops import attention

    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(sq + sk + d)
    q, do = (torch.randn((b, sq, h, d), generator=g, device="cuda").to(dt)
             for _ in range(2))
    k, v = (torch.randn((b, sk, h, d), generator=g, device="cuda").to(dt)
            for _ in range(2))
    scale = d ** -0.5
    out, lse = attention._fwd_dispatch(q, k, v, causal)
    got = attention._kernel_bwd(q, k, v, out, lse, do, causal, scale)
    torch.cuda.synchronize()
    want = attention._blockwise_bwd(q, k, v, out, lse, do, causal, scale)
    atol, rtol = BWD_TOL[dtype]
    errs = {}
    for what, x, y in zip(("dq", "dk", "dv"), got, want):
        errs[what] = (x.float() - y.float()).abs().max().item()
        if not torch.isfinite(x).all() or not torch.allclose(
                x.float(), y.float(), atol=atol, rtol=rtol):
            raise AssertionError(
                f"backward kernel {what} disagrees with the plain version "
                f"at {name}: max abs err {errs[what]} (atol {atol}, rtol "
                f"{rtol})")
    delta = torch.einsum("bqhd,bqhd->bhq", out.float(),
                         do.float()).contiguous()
    dq_ms = cuda_ms(lambda: attention._kernel_bwd_dq(
        q, k, v, do, lse, delta, causal, scale), 20)
    dkdv_ms = cuda_ms(lambda: attention._kernel_bwd_dkdv(
        q, k, v, do, lse, delta, causal, scale), 20)
    plain_ms = cuda_ms(lambda: attention._blockwise_bwd(
        q, k, v, out, lse, do, causal, scale), 3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
    dot = do.transpose(1, 2)
    library_ms = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True), 20)
    routes = {kernel: attention.kernel_route(kernel, dt, d)
              for kernel in ("dq", "dkdv")}
    row = {"shape": name, "B": b, "Sq": sq, "Sk": sk, "H": h, "D": d,
           "causal": causal, "dtype": dtype, "routes": routes,
           "max_abs_err": errs, "dq_ms": dq_ms, "dkdv_ms": dkdv_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_backend": _sdpa_backend(qt, kt, vt, causal)}
    for kernel in ("dq", "dkdv"):
        bound_ms, bound_by = _attention_work(kernel, b, sq, sk, h, d,
                                             causal, dtype)
        row[f"{kernel}_bound_ms"] = bound_ms
        row[f"{kernel}_bound_by"] = bound_by
    print(f"kernel: bwd {name} B{b} Sq{sq} Sk{sk} H{h} D{d} "
          f"causal={causal} {dtype} {routes}: err dq {errs['dq']:.3g} dk "
          f"{errs['dk']:.3g} dv {errs['dv']:.3g}; ms dq {dq_ms:.4f} "
          f"(bound {row['dq_bound_ms']:.4f}) dk/dv {dkdv_ms:.4f} (bound "
          f"{row['dkdv_bound_ms']:.4f}) plain {plain_ms:.4f} sdpa-bwd "
          f"{library_ms:.4f} ({row['library_backend']})", flush=True)
    return row


def _reset_counts() -> None:
    from ray_tpu_torch.ops import attention

    for count in (attention.launches, attention.dq_launches,
                  attention.dkdv_launches):
        count.reset()


def _read_counts() -> dict:
    from ray_tpu_torch.ops import attention

    return {"fwd": attention.launches.count,
            "dq": attention.dq_launches.count,
            "dkdv": attention.dkdv_launches.count}


def _read_routes() -> dict:
    from ray_tpu_torch.ops import attention

    return {"fwd": attention.launches.by_route,
            "dq": attention.dq_launches.by_route,
            "dkdv": attention.dkdv_launches.by_route}


def _main_path_routes(dtype: str, head_dim: int) -> dict:
    """The route each kernel must take on a main path of b1."""
    import torch

    from ray_tpu_torch.ops import attention

    return {k: attention.kernel_route(k, getattr(torch, dtype), head_dim)
            for k in ("fwd", "dq", "dkdv")}


# --------------------------------------------------------------- phase 3


class _FrozenDeps:
    """Tasks never become ready: placements are the observable state."""

    def wait_ready(self, spec, callback):
        pass


def _sched_drive(device: str, device_solve: bool, pipeline: bool):
    import numpy as np

    from ray_tpu_torch._private.config import Config
    from ray_tpu_torch._private.ids import JobID, NodeID, TaskID
    from ray_tpu_torch.core.raylet import ClusterState, Raylet, _PendingTask
    from ray_tpu_torch.core.task_spec import (
        TaskKind,
        TaskSpec,
        scheduling_class_of,
    )

    cfg = Config.instance()
    saved = {k: getattr(cfg, k) for k in (
        "scheduler_device_solve_min_cells", "scheduler_pipeline_enabled",
        "scheduler_pipeline_debug_check")}
    cfg._set("scheduler_device_solve_min_cells", 0 if device_solve else -1)
    cfg._set("scheduler_pipeline_enabled", pipeline)
    cfg._set("scheduler_pipeline_debug_check", pipeline)
    try:
        rng = np.random.default_rng(0)
        cluster = ClusterState(device)
        deps = _FrozenDeps()
        raylets = []
        for _ in range(SCHED["nodes"]):
            resources = {"CPU": float(rng.integers(4, 32)),
                         "MEM": float(rng.integers(8, 64)),
                         "TPU": float(rng.integers(0, 4))}
            raylets.append(Raylet(NodeID.from_random(), resources,
                                  cluster, deps))
            cluster.register(raylets[-1])
        rng = np.random.default_rng(1)
        demands = []
        for c in range(SCHED["classes"]):
            d = {"CPU": float(rng.integers(1, 4))}
            if c % 3 == 0:
                d["MEM"] = float(rng.integers(1, 8))
            if c % 7 == 0:
                d["TPU"] = 1.0
            demands.append(d)
        head = raylets[0]
        job, parent = JobID.from_int(7), TaskID.for_task(None)
        names = {}
        with head._lock:
            for i in range(SCHED["tasks"]):
                spec = TaskSpec(
                    kind=TaskKind.NORMAL, task_id=TaskID.for_task(None),
                    job_id=job, parent_task_id=parent, name=f"t{i}",
                    resources=dict(demands[i % SCHED["classes"]]))
                spec.scheduling_class = scheduling_class_of(
                    spec.resource_request(cluster.ids))
                names[spec.task_id] = spec.name
                task = _PendingTask(spec, lambda r, w: None, 0)
                head._pending.append(task)
                head._by_task_id[spec.task_id] = task
        t0 = time.monotonic()
        for _ in range(256):
            head.schedule_tick()
            with head._lock:
                if not head._pending:
                    break
        wall = time.monotonic() - t0
        if head._pending:
            raise AssertionError("pending queue failed to drain")
        placements = {}
        for slot, raylet in enumerate(raylets):
            with raylet._lock:
                for tid in raylet._running:
                    placements[names[tid]] = ("run", slot)
                for q in raylet._dispatch_queues.values():
                    for task in q:
                        placements[names[task.spec.task_id]] = (
                            "queued", slot)
                for task in raylet._infeasible:
                    placements[names[task.spec.task_id]] = (
                        "infeasible", -1)
        with cluster.lock:
            cluster.refresh_locked()
            if not np.all(cluster.matrix.available >= 0):
                raise AssertionError("availability went negative")
        return placements, wall, cluster.device_mirror
    finally:
        for k, v in saved.items():
            cfg._set(k, v)


def _sched_pipelined_step(policy) -> list:
    """bench.py's device-resident drain for SCHED_PIPELINED_TICKS ticks
    (SCHED's nodes and classes, its tasks spread over the classes): each
    tick's ``pipelined_step`` on CUDA, repaired on the host, against
    ``schedule_tick_fused`` + ``repair_oversubscription`` on the
    availability the step folded; the device availability against the
    host's int64 shadow. -> per tick {ms to the pulled counts, placed}."""
    import numpy as np
    import torch

    from ray_tpu_torch.scheduler.policy import SchedulingOptions
    from ray_tpu_torch.scheduler.resources import to_fixed

    rng = np.random.default_rng(2)
    n, c = SCHED["nodes"], SCHED["classes"]
    total = rng.integers(4, 32, size=(n, 3)) * to_fixed(1)
    reqs = rng.integers(0, 4, size=(c, 3)) * to_fixed(1)
    reqs[:, 0] = np.maximum(reqs[:, 0], to_fixed(1))
    ks = np.full(c, SCHED["tasks"] // c, dtype=np.int64)
    alive = np.ones(n, dtype=bool)
    opts = SchedulingOptions()
    dev = torch.device("cuda")
    total_d = torch.as_tensor(total, dtype=torch.float32, device=dev)
    alive_d = torch.as_tensor(alive, device=dev)
    avail_d = total_d.clone()
    zeros = torch.zeros_like(total_d)
    freed_d = zeros
    avail_host, prev_usage = total.copy(), np.zeros_like(total)
    ticks = []
    for _ in range(SCHED_PIPELINED_TICKS):
        t0 = time.monotonic()
        avail_d, usage_d, pending = policy.pipelined_step(
            avail_d, freed_d, zeros, reqs.astype(np.float32),
            ks.astype(np.float32), total_d, alive_d, 0, opts)
        raw = pending.pull()
        ms = (time.monotonic() - t0) * 1e3
        avail_host += prev_usage  # last tick's tasks complete now
        counts = policy.repair_oversubscription(reqs, raw, avail_host)
        want = policy.repair_oversubscription(
            reqs, policy.schedule_tick_fused(
                reqs, ks, total, avail_host, alive, 0, opts).pull(),
            avail_host)
        if not np.array_equal(counts, want):
            raise AssertionError("pipelined_step's counts are not "
                                 "schedule_tick_fused's")
        usage = counts.T @ reqs
        avail_host -= usage
        prev_usage = usage
        freed_d = usage_d
        ks = ks - counts.sum(axis=1)
        ticks.append({"ms": ms, "placed": int(counts.sum())})
    torch.cuda.synchronize()
    # no repair clamped (magnitudes far below 2^24): the device's
    # availability is the host shadow's
    if not np.array_equal(avail_d.cpu().numpy(),
                          avail_host.astype(np.float32)):
        raise AssertionError("pipelined_step's device availability left "
                             "the host shadow")
    print(f"sched pipelined_step: {SCHED_PIPELINED_TICKS} chained ticks "
          f"at {n} nodes x {c} classes on CUDA equal to schedule_tick_fused"
          f" + repair; ms to counts {[round(t['ms'], 3) for t in ticks]}, "
          f"placed {[t['placed'] for t in ticks]}", flush=True)
    return ticks


def phase_sched(report: dict) -> None:
    import torch

    from ray_tpu_torch.scheduler.policy import shared_batched_policy

    policy = shared_batched_policy(torch.device("cuda"))
    before = policy.device_solves
    dev, dev_s, _ = _sched_drive("cuda", True, False)
    single_solves = policy.device_solves - before
    ref, ref_s, _ = _sched_drive("cuda", False, False)
    if len(dev) != SCHED["tasks"] or dev != ref:
        bad = sum(1 for t in ref if dev.get(t) != ref[t])
        raise AssertionError(
            f"CUDA solve placed {bad} tasks differently from numpy")
    if single_solves == 0:
        raise AssertionError("the single-buffered drain ran no CUDA solve")
    before = policy.device_solves
    pipe, pipe_s, mirror = _sched_drive("cuda", True, True)
    pipe_solves = policy.device_solves - before
    if len(pipe) != SCHED["tasks"] or pipe_solves == 0 or mirror is None:
        raise AssertionError("pipelined drain lost tasks or ran no solve")
    # a head tick drains recursively through the spillback re-ticks, so
    # the unit of work is a batch of scheduler_max_tasks_per_tick tasks:
    # one device solve + its commit, spillback and dispatch
    from ray_tpu_torch._private.config import Config

    per_tick = Config.instance().scheduler_max_tasks_per_tick
    batches = -(-SCHED["tasks"] // per_tick)
    pipelined_ticks = _sched_pipelined_step(policy)
    report["sched"] = {
        **SCHED, "batches": batches, "tasks_per_batch": per_tick,
        "single_device_s": dev_s, "single_device_solves": single_solves,
        "single_device_ms_per_batch": dev_s / batches * 1e3,
        "single_numpy_s": ref_s,
        "single_numpy_ms_per_batch": ref_s / batches * 1e3,
        "pipelined_s": pipe_s, "pipelined_solves": pipe_solves,
        "pipelined_ms_per_batch": pipe_s / batches * 1e3,
        "mirror_full_syncs": mirror.full_syncs,
        "mirror_delta_syncs": mirror.delta_syncs,
        "placements_equal": True,
        "pipelined_step_ticks": pipelined_ticks,
    }
    print(f"sched: {SCHED['nodes']}x{SCHED['tasks']}x{SCHED['classes']} "
          f"single-buffered CUDA == numpy placements; {batches} batches "
          f"of <= {per_tick} tasks: CUDA {single_solves} solves, "
          f"{dev_s / batches * 1e3:.1f} ms/batch (numpy "
          f"{ref_s / batches * 1e3:.1f}); pipelined "
          f"{pipe_s / batches * 1e3:.1f} ms/batch, {pipe_solves} CUDA "
          f"solves, mirror {mirror.full_syncs} full + "
          f"{mirror.delta_syncs} delta syncs, drift check on", flush=True)


# --------------------------------------------------------------- phase 4


# bench.py's 1.25 B "xl" (its dims["xl"]: hidden 2560, 16 layers, inter
# 6912, vocab 32000, S 2048, remat full, logits_chunk 256) at 16 heads,
# the head_dim-160 variant its comments measured; kv_heads 8 keeps
# bench.py's heads/kv ratio of 2
XL16 = dict(vocab_size=32000, hidden=2560, layers=16, heads=16, kv_heads=8,
            intermediate=6912, max_seq=2048, remat=True,
            remat_policy="full", logits_chunk=256)


def _text_config(model: str):
    """b1, b1's widths at 4 heads (head dim 512), bench.py's xl at 16
    heads, the entry point's model, or the bench's MoE model (bench.py's
    sparse row)."""
    import dataclasses

    import torch

    from ray_tpu_torch.models.transformer import ModelConfig
    from ray_tpu_torch.tools.multichip import ENTRY_MODEL

    if model == "entry":
        return ModelConfig(**ENTRY_MODEL, dtype=torch.bfloat16)
    if model == "b1":
        return ModelConfig.b1()
    if model == "b1_h4":
        return dataclasses.replace(ModelConfig.b1(), heads=4, kv_heads=4)
    if model == "xl16":
        return ModelConfig(**XL16)
    return ModelConfig.moe_bench()


MODEL_DESC = {
    "b1": "ModelConfig.b1 (hidden 2048, 24 layers, 16 heads, d 128, inter "
          "5632, vocab 32000, bf16)",
    "b1_h4": "ModelConfig.b1's widths at 4 heads (hidden 2048, 24 layers, 4 "
             "heads, d 512, inter 5632, vocab 32000, bf16)",
    "xl16": "bench.py's xl at 16 heads (hidden 2560, 16 layers, 16 heads "
            "over 8 kv heads, d 160, inter 6912, vocab 32000, bf16)",
    "entry": "the entry point's model (hidden 256, 4 layers, 8 heads over "
             "4 kv heads, d 32, inter 704, vocab 2048, max_seq 512, bf16)",
    "moe": "bench MoE (hidden 1024, 8 layers, 16 heads over 8 kv heads, d "
           "64, inter 2816, top-2 of 8 experts every 2nd layer, groups "
           "4096, vocab 32000, bf16)",
    "vit": "ViTConfig.base() (ViT-B/16: hidden 768, 12 layers, 12 heads, d "
           "64, MLP 3072, 224-px images, 16-px patches, S 197, bf16)",
}


class PinnedRouting:
    """Routes a MoE model's plain-attention run as its kernel run routed.

    The kernels and the plain attention round differently, and where a
    token's top-2 router scores nearly tie the two runs send it to other
    experts, or drop it past an expert's capacity; its MoE output then
    differs by O(1) (on the card: 5.7 % of the served tokens, 2.2 % of a
    train step's (token, layer) routings; the tokens routed alike agree
    within 1.6e-2). So the two runs are compared routed alike: the MoE
    layers choose experts with ``torch.topk``, and inside ``record()``
    each call's indices are kept; inside ``replay()`` each call takes the
    indices of the recorded call at its place (values gathered from its
    own scores, so gradients flow as through top-k), and ``flips`` counts
    the routings it would have chosen otherwise."""

    def __init__(self):
        self.indices, self.flips, self.routings = [], 0, 0

    def _topk(self, scores, k, dim=-1, *args, **kwargs):
        if self._replay is None:
            out = self._torch_topk(scores, k, dim, *args, **kwargs)
            self.indices.append(out.indices)
            return out
        idx = self.indices[self._replay]
        self._replay += 1
        own = self._torch_topk(scores, k, dim).indices
        self.flips += int((own.sort(dim).values != idx.sort(dim).values)
                          .any(dim).sum())
        self.routings += own.numel() // k
        return scores.gather(dim, idx), idx

    @contextlib.contextmanager
    def _patched(self, replay):
        import torch

        self._torch_topk, self._replay = torch.topk, replay
        torch.topk = self._topk
        try:
            yield self
        finally:
            torch.topk = self._torch_topk

    def record(self):
        self.indices = []
        return self._patched(None)

    def replay(self):
        self.flips = self.routings = 0
        return self._patched(0)


class ModelServer:
    """Serves a text model (``b1`` or ``moe``) at full width and depth on
    the card."""

    def __init__(self, seed: int, model: str = "b1"):
        import torch

        from ray_tpu_torch.models import transformer as tfm
        from ray_tpu_torch.models.training import build_forward
        from ray_tpu_torch.ops.attention import blockwise_attention

        self.cfg = _text_config(model)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        self.params = tfm.init_params(self.cfg, gen, device="cuda")
        self.fwd = build_forward(self.cfg, device="cuda")
        self.fwd_plain = build_forward(self.cfg, device="cuda",
                                       attention_fn=blockwise_attention)

    def forward(self, tokens):
        import torch

        logits = self.fwd(self.params, tokens)
        torch.cuda.current_stream().synchronize()
        return logits

    def forward_plain(self, tokens, pinned: bool = True):
        """The plain-attention model's logits; a MoE model routed as the
        kernel model routes these tokens (PinnedRouting) unless
        ``pinned`` is false."""
        import torch

        if not (self.cfg.num_experts and pinned):
            logits = self.fwd_plain(self.params, tokens)
        else:
            pin = PinnedRouting()
            with pin.record():
                self.fwd(self.params, tokens)
            with pin.replay():
                logits = self.fwd_plain(self.params, tokens)
            self.flip_share = pin.flips / pin.routings
        torch.cuda.current_stream().synchronize()
        return logits

    def routing_flip_share(self):
        return getattr(self, "flip_share", None)


class VitServer:
    """Serves ViTConfig.base() on the card: images in, logits out."""

    def __init__(self, seed: int, model: str = "vit"):
        import torch

        from ray_tpu_torch.models import vision

        self.cfg = vision.ViTConfig.base()
        gen = torch.Generator(device="cuda").manual_seed(seed)
        self.params = vision.init_params(self.cfg, gen, device="cuda")

    def _run(self, images, attention_fn):
        import torch

        from ray_tpu_torch.models import vision

        with torch.no_grad():
            logits = vision.forward(self.params, images, self.cfg,
                                    attention_fn)
        torch.cuda.current_stream().synchronize()
        return logits

    def forward(self, images):
        return self._run(images, None)

    def forward_plain(self, images):
        import functools

        from ray_tpu_torch.ops.attention import blockwise_attention

        return self._run(images, functools.partial(blockwise_attention,
                                                   causal=False))


def _vit_batch(n: int, seed: int):
    """Seeded images [n, 224, 224, 3] float32 and labels [n] in numpy."""
    import numpy as np

    from ray_tpu_torch.models.vision import ViTConfig

    cfg = ViTConfig.base()
    rng = np.random.default_rng(seed)
    images = rng.standard_normal(
        (n, cfg.image_size, cfg.image_size, cfg.channels), dtype=np.float32)
    return images, rng.integers(0, cfg.num_classes, size=n)


def phase_serve(report: dict, model: str = "b1") -> dict:
    """An actor serves ``model`` (b1, moe or vit) for SERVE_REQUESTS
    requests; returns the kernels' launches by route over them."""
    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.cluster_utils import Cluster

    if model == "vit":
        from ray_tpu_torch.models.vision import ViTConfig

        layers, head_dim = ViTConfig.base().layers, ViTConfig.base().head_dim
        batches = [_vit_batch(VIT_SERVE_IMAGES, i)[0]
                   for i in range(SERVE_REQUESTS)]
        probe, server_cls, out_shape = batches[0][:1], VitServer, (
            VIT_SERVE_IMAGES, ViTConfig.base().num_classes)
    else:
        cfg = _text_config(model)
        layers, head_dim = cfg.layers, cfg.head_dim
        rng = np.random.default_rng(0)
        batches = [rng.integers(0, cfg.vocab_size, size=SERVE_TOKENS)
                   for _ in range(SERVE_REQUESTS)]
        probe, server_cls, out_shape = batches[0][:, :16], ModelServer, (
            *SERVE_TOKENS, cfg.vocab_size)
    cluster = Cluster(head_node_args={
        "num_cpus": 4, "device": "cuda",
        # logits stay on the card; keep them out of the spill path
        "_system_config": {"object_store_memory": 64 << 30}})
    try:
        for _ in range(2):
            cluster.add_node(num_cpus=4)
        cluster.add_node(num_cpus=4, num_gpus=1)
        t0 = time.monotonic()
        server = ray_tpu_torch.remote(num_gpus=1)(server_cls).remote(
            0, model)
        # the first call includes construction (weights drawn on the card)
        ray_tpu_torch.get(server.forward.remote(probe))
        setup_s = time.monotonic() - t0
        _reset_counts()
        latencies, first, last = [], None, []
        for inputs in batches:
            t = time.monotonic()
            logits = ray_tpu_torch.get(server.forward.remote(inputs))
            latencies.append(time.monotonic() - t)
            if first is None:
                first = logits
            # the last position's logits: what proc_serve's replies hold
            last.append(logits[:, -1].float().cpu().numpy())
            del logits
        counts = _read_counts()
        routes = _read_routes()
        launches = counts["fwd"]
        if launches != layers * SERVE_REQUESTS or counts["dq"] or \
                counts["dkdv"]:
            raise AssertionError(
                f"{model}: attention kernels launched {counts} for "
                f"{SERVE_REQUESTS} requests; expected {layers} forward "
                f"launches each and no backward")
        want_route = _main_path_routes("bfloat16", head_dim)["fwd"]
        if routes["fwd"] != {want_route: launches}:
            raise AssertionError(f"{model}: served forward launches by "
                                 f"route {routes['fwd']}; expected all on "
                                 f"{want_route}")
        plain = ray_tpu_torch.get(server.forward_plain.remote(batches[0]))
        if tuple(first.shape) != out_shape or \
                not torch.isfinite(first).all():
            raise AssertionError(f"{model}: served logits malformed or not "
                                 f"finite")
        flips = free_rel = None
        if model == "moe":
            flips = ray_tpu_torch.get(server.routing_flip_share.remote())
            free = ray_tpu_torch.get(server.forward_plain.remote(
                batches[0], False))
            free_rel = ((first - free).norm() / free.norm()).item()
            del free
        rel = ((first - plain).norm() / plain.norm()).item()
        max_abs = (first - plain).abs().max().item()
        agree = (first.argmax(-1) == plain.argmax(-1)).float().mean().item()
        if not rel <= SERVE_REL_L2_TOL:
            raise AssertionError(
                f"{model}: served logits off the plain-attention model: "
                f"rel L2 {rel:.3g} > {SERVE_REL_L2_TOL}")
        shape = list(batches[0].shape)
        pinned = ("" if flips is None else
                  f" (routed alike, {flips:.4f} of the routings pinned; "
                  f"unpinned rel L2 {free_rel:.3g})")
        report["serve" if model == "b1" else f"{model}_serve"] = {
            "model": MODEL_DESC[model], "requests": SERVE_REQUESTS,
            "inputs": shape, "setup_s": setup_s, "latency_s": latencies,
            "kernel_launches": launches,
            "kernel_launches_by_route": routes["fwd"],
            "logits_rel_l2_vs_plain": rel,
            "routing_flip_share_pinned": flips,
            # not checked: each side routed by its own scores
            "logits_rel_l2_vs_plain_unpinned": free_rel,
            "logits_max_abs_vs_plain": max_abs,
            "argmax_agreement_vs_plain": agree,
            "logits_abs_max": first.abs().max().item(),
        }
        if model == "b1":
            report["_serve_last_logits"] = last
        print(f"{'serve' if model == 'b1' else model}: {model} actor "
              f"answered {SERVE_REQUESTS} requests of {shape}, latency s "
              f"{[round(x, 4) for x in latencies]}; kernel launches "
              f"{routes['fwd']}; logits vs plain attention{pinned} rel L2 "
              f"{rel:.3g}, argmax agreement {agree:.4f}", flush=True)
        if model == "b1_h4" and "serve" in report:
            print(f"b1_h4: request s {[round(x, 4) for x in latencies]} "
                  f"beside b1's (16 heads, d 128) "
                  f"{[round(x, 4) for x in report['serve']['latency_s']]}",
                  flush=True)
        del first, plain
    finally:
        cluster.shutdown()
    return routes


def _b1_deployment():
    """The class the serve_lib phase deploys: b1 on the card behind
    ``@serve.batch``. A request is a [2048] token row (through a handle)
    or ``{"tokens": [...]}`` (HTTP); the reply is the row's last-position
    logits as 32,000 fp32 values, or their argmax and sum for HTTP."""
    from ray_tpu_torch import serve

    class B1Deployment:
        def __init__(self):
            import torch

            from ray_tpu_torch.models import transformer as tfm
            from ray_tpu_torch.models.training import build_forward

            self.cfg = tfm.ModelConfig.b1()
            self.params = tfm.init_params(
                self.cfg, torch.Generator("cuda").manual_seed(0),
                device="cuda")
            self.fwd = build_forward(self.cfg, device="cuda")
            self.batch_sizes = []
            # start-up counts the weights drawn on the card, not their
            # launches
            torch.cuda.current_stream().synchronize()

        @serve.batch(max_batch_size=SERVE_LIB["max_batch"],
                     batch_wait_timeout_s=SERVE_LIB["wait_s"])
        def __call__(self, requests):
            import numpy as np

            from ray_tpu_torch.observability import profile

            n = len(requests)
            tokens = np.stack([np.asarray(r["tokens"] if isinstance(r, dict)
                                          else r) for r in requests])
            with profile("b1_batch", {"n": n}):
                last = self.fwd(self.params, tokens)[:, -1].float().cpu()
            self.batch_sizes.append(n)
            rows = last.numpy()
            return [{"argmax": int(row.argmax()), "sum": float(row.sum())}
                    if isinstance(r, dict) else row
                    for r, row in zip(requests, rows)]

        def seen(self):
            return list(self.batch_sizes)

    return B1Deployment


def _b1_spans():
    from ray_tpu_torch.observability import timeline

    return [e for e in timeline() if e["name"] == "b1_batch"]


def phase_serve_lib(report: dict) -> dict:
    """b1 deployed through ray_tpu_torch.serve: two batched replicas on
    one card, the P2C router, the HTTP proxy and a draining scale-down;
    every forward through K1. Returns K1's launches by route over the
    served traffic."""
    import threading
    import urllib.request

    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch import serve
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.observability import global_profiler
    from ray_tpu_torch.observability.metrics import get_metric

    cfg = _text_config("b1")
    k = SERVE_LIB
    n_traffic = k["clients"] * k["per_client"]
    rows = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(n_traffic + k["inflight"], k["seq"]))
    answers, latency, errors = [None] * n_traffic, [None] * n_traffic, []
    want_route = _main_path_routes("bfloat16", cfg.head_dim)["fwd"]

    def drains():
        return sum(get_metric("ray_tpu_serve_drains_completed")
                   .series().values())

    os.makedirs("chiprun_out", exist_ok=True)
    cluster = Cluster(head_node_args={
        "num_cpus": 4, "device": "cuda",
        "_system_config": {"object_store_memory": 64 << 30}})
    serving = False
    try:
        for _ in range(2):
            cluster.add_node(num_cpus=4)
        cluster.add_node(num_cpus=4, num_gpus=1)
        serve.start()
        serving = True
        deployment = serve.deployment(
            name="B1Deployment", version="v1",
            num_replicas=k["replicas"], ray_actor_options={"num_gpus": 0.5},
            max_concurrent_queries=k["max_queries"],
            graceful_shutdown_timeout_s=60.0)(_b1_deployment())
        global_profiler.clear()
        _reset_counts()
        t0 = time.monotonic()
        deployment.deploy()
        startup_s = time.monotonic() - t0
        handle = deployment.get_handle()

        def client(c):
            try:
                for i in range(c * k["per_client"], (c + 1) * k["per_client"]):
                    t = time.monotonic()
                    answers[i] = ray_tpu_torch.get(handle.remote(rows[i]))
                    latency[i] = time.monotonic() - t
            except Exception as exc:  # re-raised by the phase below
                errors.append(exc)

        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(k["clients"])]
        t0 = time.monotonic()
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=300)
        traffic_s = time.monotonic() - t0
        if errors or any(t.is_alive() for t in clients):
            raise AssertionError(f"serve_lib: client threads failed: "
                                 f"{errors!r}")

        controller = ray_tpu_torch.get_actor("SERVE_CONTROLLER")
        proxy = serve.start_http_proxy(controller)
        address = ray_tpu_torch.get(proxy.address.remote())
        http = []
        for i in range(k["http"]):
            request = urllib.request.Request(
                address + deployment.route_prefix,
                data=json.dumps({"tokens": rows[i].tolist()}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(request, timeout=120) as resp:
                http.append(json.loads(resp.read()))
        ray_tpu_torch.get(proxy.stop.remote())
        ray_tpu_torch.kill(proxy)

        _, replicas = ray_tpu_torch.get(
            controller.get_replicas.remote("B1Deployment"))
        per_replica = [ray_tpu_torch.get(r.handle_request.remote(
            "seen", (), {})) for r in replicas]
        spans_before = _b1_spans()

        # 8 requests in flight, then a calm redeploy to one replica: the
        # victim leaves routing, drains to zero in flight, then dies
        drains_before = drains()
        inflight_refs = [handle.remote(rows[n_traffic + j])
                         for j in range(k["inflight"])]
        t0 = time.monotonic()
        deployment.options(num_replicas=1).deploy()
        scale_s = time.monotonic() - t0
        inflight = ray_tpu_torch.get(inflight_refs, timeout=300)
        _, left = ray_tpu_torch.get(
            controller.get_replicas.remote("B1Deployment"))
        drained = drains() - drains_before
        counts, routes = _read_counts(), _read_routes()
        spans = _b1_spans()
        trace_path = ray_tpu_torch.timeline(
            os.path.join("chiprun_out", "serve_lib_timeline.json"))
    finally:
        if serving:
            serve.shutdown()
        cluster.shutdown()

    # batches: the replicas' own reports, the timeline, K1's launches
    sizes = [n for seen in per_replica for n in seen]
    span_sizes = [e["args"]["n"] for e in spans]
    batches = len(spans)
    if sorted(e["args"]["n"] for e in spans_before) != sorted(sizes):
        raise AssertionError(f"serve_lib: timeline spans "
                             f"{[e['args']['n'] for e in spans_before]} != "
                             f"the replicas' batches {per_replica}")
    with open(trace_path) as f:
        on_disk = [e for e in json.load(f) if e["name"] == "b1_batch"]
    if len(on_disk) != batches:
        raise AssertionError(f"serve_lib: {trace_path} holds {len(on_disk)} "
                             f"b1_batch spans for {batches} batches")
    total = n_traffic + k["http"] + k["inflight"]
    if sum(span_sizes) != total or max(span_sizes) > k["max_batch"] or \
            max(span_sizes) < 2 or sum(sizes) != n_traffic + k["http"]:
        raise AssertionError(f"serve_lib: batch sizes {span_sizes} (the "
                             f"replicas' {per_replica}) for {total} "
                             f"requests, at most {k['max_batch']}, one > 1")
    served = [sum(seen) for seen in per_replica]
    if len(replicas) != k["replicas"] or not all(served):
        raise AssertionError(f"serve_lib: replicas served {served} "
                             f"requests in batches {per_replica}")
    if len(left) != 1 or drained != 1 or len(inflight) != k["inflight"]:
        raise AssertionError(f"serve_lib: scale-down left {len(left)} "
                             f"replicas, {drained} drains, "
                             f"{len(inflight)} of {k['inflight']} answers")
    if counts["fwd"] != cfg.layers * batches or counts["dq"] or \
            counts["dkdv"] or routes["fwd"] != {want_route: counts["fwd"]}:
        raise AssertionError(f"serve_lib: attention launches {counts} by "
                             f"route {routes['fwd']} for {batches} batches;"
                             f" expected {cfg.layers} each on {want_route}")

    # each answer against its row served alone through ModelServer
    served_rows = answers + inflight
    server = ModelServer(0)
    _reset_counts()
    reference = [server.forward(rows[i][None])[0, -1].float().cpu().numpy()
                 for i in range(len(served_rows))]
    ref_counts, ref_routes = _read_counts(), _read_routes()
    del server
    if ref_counts["fwd"] != cfg.layers * len(reference) or \
            ref_routes["fwd"] != {want_route: ref_counts["fwd"]}:
        raise AssertionError(f"serve_lib: batch-1 references launched "
                             f"{ref_routes['fwd']}")
    rel = [float(np.linalg.norm(a - r) / np.linalg.norm(r))
           for a, r in zip(served_rows, reference)]
    bit_equal = sum(bool(np.array_equal(a, r))
                    for a, r in zip(served_rows, reference))
    for a in served_rows:
        if a.shape != (cfg.vocab_size,) or a.dtype != np.float32 or \
                not np.isfinite(a).all():
            raise AssertionError("serve_lib: an answer is malformed or not "
                                 "finite")
    if not max(rel) <= SERVE_LIB_REL_TOL:
        raise AssertionError(f"serve_lib: answers off batch-1 serving: "
                             f"worst rel L2 {max(rel):.3g} > "
                             f"{SERVE_LIB_REL_TOL}")
    http_rel = []
    for i, h in enumerate(http):
        row = answers[i]
        http_rel.append(abs(h["sum"] - float(row.sum()))
                        / float(np.abs(row).sum()))
        if h["argmax"] != int(row.argmax()) or \
                not http_rel[-1] <= SERVE_LIB_REL_TOL:
            raise AssertionError(f"serve_lib: HTTP answer {h} for row {i} "
                                 f"off the handle's (argmax "
                                 f"{int(row.argmax())}, sum "
                                 f"{float(row.sum())})")

    lat = np.asarray(latency)
    report["serve_lib"] = {
        "model": MODEL_DESC["b1"], "replicas": k["replicas"],
        "ray_actor_options": {"num_gpus": 0.5},
        "max_batch_size": k["max_batch"],
        "batch_wait_timeout_s": k["wait_s"],
        "startup_s": startup_s, "traffic_s": traffic_s,
        "requests_per_s": n_traffic / traffic_s,
        "latency_s": latency,
        "latency_p50_s": float(np.percentile(lat, 50)),
        "latency_p95_s": float(np.percentile(lat, 95)),
        "latency_max_s": float(lat.max()),
        "batch_sizes": span_sizes, "batch_sizes_by_replica": per_replica,
        "requests_by_replica": served, "scale_down_s": scale_s,
        "drains_completed": drained, "kernel_launches": counts["fwd"],
        "kernel_launches_by_route": routes["fwd"],
        "reference_launches": ref_counts["fwd"],
        "rel_l2_vs_batch1": rel, "bit_equal_vs_batch1": bit_equal,
        "http_answers": http, "http_sum_rel_vs_handle": http_rel,
        "timeline": trace_path,
    }
    print(f"serve_lib: b1 from {k['replicas']} replicas on one card, start-"
          f"up {startup_s:.2f} s; {n_traffic} requests from {k['clients']} "
          f"threads in {traffic_s:.3f} s ({n_traffic / traffic_s:.2f} "
          f"requests/s), latency s p50 {np.percentile(lat, 50):.4f} p95 "
          f"{np.percentile(lat, 95):.4f} max {lat.max():.4f}; batch sizes "
          f"{span_sizes} (by replica {per_replica}, requests {served}); "
          f"scale-down to 1 in {scale_s:.2f} s, {k['inflight']} in flight, "
          f"0 dropped; K1 {routes['fwd']} for {batches} batches; vs batch 1 "
          f"rel L2 worst {max(rel):.3g} (readings "
          f"{sorted({float(f'{x:.3g}') for x in rel})}), {bit_equal} of "
          f"{len(rel)} bit-equal; HTTP sums rel {[f'{x:.3g}' for x in http_rel]}; "
          f"{card_line()}", flush=True)
    return routes


# --------------------------------------------------------------- phase 5


def _train_tokens(model: str) -> tuple:
    """[B, S + 1] of ``model``'s train batch."""
    return {"moe": MOE_TRAIN_TOKENS,
            "entry": ENTRY_TRAIN_TOKENS}.get(model, TRAIN_TOKENS)


def _train_batch(model: str = "b1"):
    import numpy as np

    rng = np.random.default_rng(0)
    return rng.integers(0, _text_config(model).vocab_size,
                        size=_train_tokens(model))


def train_text(config):
    """The train function: ``config["model"]`` (b1, b1_h4, xl16 or entry)
    at full width and depth on this worker's card, TRAIN_STEPS optimizer
    steps on one seeded batch, each step's loss, grad norm and wall time
    reported."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models.training import build_train_step

    cfg = _text_config(config["model"])
    torch.cuda.reset_peak_memory_stats()
    step, init_fn = build_train_step(cfg, device="cuda")
    params, opt_state = init_fn(
        torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.as_tensor(_train_batch(config["model"]), device="cuda")
    torch.cuda.synchronize()
    for i in range(TRAIN_STEPS):
        t0 = time.monotonic()
        params, opt_state, metrics = step(params, opt_state, tokens)
        loss = metrics["loss"].item()  # waits for the step's kernels
        train.report(step=i, loss=loss,
                     grad_norm=metrics["grad_norm"].item(),
                     step_s=time.monotonic() - t0,
                     peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    return train.world_rank()


def _leaf_names(tree, prefix: str = "") -> list:
    """Dotted names of tree_leaves(tree), in its order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items()
                for n in _leaf_names(v, f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def _loss_and_grads(params, loss_of):
    """(loss, {leaf name: grad}) of ``loss_of(params)``."""
    import torch

    from ray_tpu_torch.models.training import tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = loss_of(params)
    grads = torch.autograd.grad(loss, leaves)
    return loss.item(), dict(zip(_leaf_names(params), grads))


def _one_step_grads(model: str, attention_fn):
    """Gradients of a text model's loss at its seeded initial weights on
    its train batch, with ``attention_fn`` (None: the kernels)."""
    import torch

    from ray_tpu_torch.models import transformer as tfm

    cfg = _text_config(model)
    params = tfm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    tokens = torch.as_tensor(_train_batch(model), device="cuda").long()
    return _loss_and_grads(
        params, lambda p: tfm.loss_fn(p, tokens, cfg, attention_fn))


def _grad_rel(grads_k: dict, grads_p: dict):
    """Relative L2 per leaf, kernels vs plain attention -> (rel by leaf,
    worst leaf)."""
    rel = {name: ((grads_k[name].float() - grads_p[name].float()).norm()
                  / grads_p[name].float().norm()).item()
           for name in grads_k}
    return rel, max(rel, key=rel.get)


def _check_grads(model: str, rel: dict, worst: str,
                 tol: float = GRAD_REL_L2_TOL) -> None:
    """Raises past ``tol`` on any leaf."""
    if not all(math.isfinite(r) for r in rel.values()) or rel[worst] > tol:
        raise AssertionError(
            f"{model}: one step's gradients on the kernels off the plain "
            f"attention: {worst} rel L2 {rel[worst]:.3g} > {tol}")


def _run_trainer(train_fn, config=None, dataset_fn=None, results=None):
    """``train_fn`` through Trainer(num_workers=1, use_gpu=True) on a
    one-GPU cluster -> (reported rows, run s, launches, by route).
    ``dataset_fn()``, called once the cluster is up, gives the run's
    dataset; the list ``results`` receives the train function's return
    values."""
    from ray_tpu_torch import train
    from ray_tpu_torch.cluster_utils import Cluster

    rows = []

    class Collect(train.TrainingCallback):
        def handle_result(self, results, **info):
            rows.append(results[0])

    cluster = Cluster(head_node_args={"num_cpus": 4, "num_gpus": 1,
                                      "device": "cuda"})
    try:
        dataset = dataset_fn() if dataset_fn is not None else None
        trainer = train.Trainer(num_workers=1, use_gpu=True)
        trainer.start()
        _reset_counts()
        t0 = time.monotonic()
        out = trainer.run(train_fn, config=config, dataset=dataset,
                          callbacks=[Collect()])
        run_s = time.monotonic() - t0
        if results is not None:
            results.extend(out)
        counts = _read_counts()
        routes = _read_routes()
        trainer.shutdown()
    finally:
        cluster.shutdown()
    return rows, run_s, counts, routes


def _check_launches(model: str, counts: dict, routes: dict, want: dict,
                    head_dim: int) -> None:
    if counts != want:
        raise AssertionError(f"{model}: attention kernels launched "
                             f"{counts}; expected {want}")
    for kernel, route in _main_path_routes("bfloat16", head_dim).items():
        if routes[kernel] != ({route: want[kernel]} if want[kernel] else {}):
            raise AssertionError(
                f"{model}: {kernel} launches by route {routes[kernel]}; "
                f"expected all {want[kernel]} on {route}")


def _text_train_phase(report: dict, model: str, shape: str) -> tuple:
    """``model`` (b1, b1_h4, xl16 or entry) trained TRAIN_STEPS steps
    through Trainer(num_workers=1, use_gpu=True): every K1, K2 and K3
    launch on its route at the model's head dim (K1 twice a layer under
    remat, for the recompute), losses finite and falling, one
    step's gradients against the plain attention, the replayed first
    loss the run's; the kernels' share of a step from the kernel phase's
    rows at ``shape``."""
    from ray_tpu_torch.ops.attention import blockwise_attention

    cfg = _text_config(model)
    rows, run_s, counts, routes = _run_trainer(train_text,
                                               config={"model": model})
    want = {"fwd": (2 if cfg.remat else 1) * cfg.layers * TRAIN_STEPS,
            "dq": cfg.layers * TRAIN_STEPS,
            "dkdv": cfg.layers * TRAIN_STEPS}
    _check_launches(f"{model} train", counts, routes, want, cfg.head_dim)
    losses = [r["loss"] for r in rows]
    if len(rows) != TRAIN_STEPS or not all(
            math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"{model} train losses not finite and "
                             f"falling: {losses}")

    loss_k, grads_k = _one_step_grads(model, None)
    loss_p, grads_p = _one_step_grads(model, blockwise_attention)
    rel, worst = _grad_rel(grads_k, grads_p)
    _check_grads(model, rel, worst)
    if abs(loss_k - losses[0]) > 1e-3 * abs(losses[0]):
        raise AssertionError(f"the replayed first step's loss {loss_k} is "
                             f"not the train run's {losses[0]}")

    steady = [r["step_s"] for r in rows[1:]]
    step_s = sum(steady) / len(steady)
    batch = _train_tokens(model)
    tokens = batch[0] * (batch[1] - 1)
    kernel_ms = {"fwd": next(r["ms"] for r in report["kernel_shapes"]
                             if r["shape"] == shape)}
    bwd = next(r for r in report["bwd_shapes"] if r["shape"] == shape)
    kernel_ms.update(dq=bwd["dq_ms"], dkdv=bwd["dkdv_ms"])
    share = {k: counts[k] / TRAIN_STEPS * kernel_ms[k] / (step_s * 1e3)
             for k in counts}
    out = {
        "model": MODEL_DESC[model] + (", remat full" if cfg.remat
                                      else ", remat off"),
        "tokens": list(batch), "steps": rows, "run_s": run_s,
        "kernel_launches": counts, "kernel_launches_by_route": routes,
        "step_s_steady": step_s,
        "tokens_per_s": tokens / step_s,
        "peak_gib": max(r["peak_gib"] for r in rows),
        "kernel_share_of_step_est": share,
        "grad_rel_l2_vs_plain": rel, "loss_kernels": loss_k,
        "loss_plain": loss_p,
    }
    print(f"{model} train: through Trainer(num_workers=1, use_gpu=True), "
          f"{TRAIN_STEPS} steps on {batch[0]}x{batch[1]} "
          f"tokens: losses {[round(x, 4) for x in losses]}, grad norms "
          f"{[round(r['grad_norm'], 4) for r in rows]}, step s "
          f"{[round(r['step_s'], 4) for r in rows]}; steady {step_s:.4f} "
          f"s/step, {tokens / step_s:.0f} tokens/s, peak "
          f"{out['peak_gib']:.2f} GiB; launches {routes}; kernel "
          f"share of a step (launches x kernel-phase ms) "
          f"{ {k: round(v, 4) for k, v in share.items()} }; grads vs "
          f"plain attention: worst rel L2 {rel[worst]:.3g} ({worst}), "
          f"loss {loss_k:.5f} vs {loss_p:.5f}", flush=True)
    return out, routes


def phase_train(report: dict) -> dict:
    report["train"], routes = _text_train_phase(report, "b1", "train")
    return routes


def phase_xl16(report: dict) -> dict:
    """bench.py's xl at 16 heads (head_dim 160): K1, K2 and K3 on the
    padded wgmma kernels."""
    report["xl16"], routes = _text_train_phase(report, "xl16",
                                               "xl16_train")
    return routes


def phase_b1_h4_train(report: dict) -> dict:
    """b1's widths at 4 heads (head_dim 512): K1, K2 and K3 on the bf16
    wgmma kernels past 256."""
    report["b1_h4_train"], routes = _text_train_phase(report, "b1_h4",
                                                      "b1_h4_train")
    return routes


def phase_entry_train(report: dict) -> dict:
    """The entry point's model (head_dim 32): K1, K2 and K3 on the padded
    wgmma kernels fed by TMA, K3's two warpgroups splitting its two
    products (one 64-column box)."""
    report["entry_train"], routes = _text_train_phase(report, "entry",
                                                      "entry_train")
    return routes


# --------------------------------------------------------------- phase 6


def train_moe(config):
    """The train function of the moe phase: the bench MoE model on this
    worker's card, MOE_TRAIN_STEPS steps on one seeded batch. Before step
    MOE_CKPT_STEP it saves (params, opt_state), restores them onto a
    fresh init through ``like`` and checks every leaf equal, takes that
    step once on the state that never stopped (its loss is reported as
    ``uninterrupted_loss``) and goes on from the restored state."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.models.checkpoint import CheckpointManager
    from ray_tpu_torch.models.training import build_train_step, tree_leaves
    from ray_tpu_torch.ops.attention import blockwise_attention

    cfg = _text_config("moe")
    step, init_fn = build_train_step(cfg, device="cuda")
    params, opt_state = init_fn(
        torch.Generator(device="cuda").manual_seed(0))
    tokens = torch.as_tensor(_train_batch("moe"), device="cuda")
    ckpt = CheckpointManager(config["ckpt_dir"], max_to_keep=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(MOE_TRAIN_STEPS):
        extra = {}
        if i == MOE_CKPT_STEP:
            t0 = time.monotonic()
            ckpt.save(i, {"params": params, "opt_state": opt_state})
            extra["save_s"] = time.monotonic() - t0
            fresh_p, fresh_o = init_fn(
                torch.Generator(device="cuda").manual_seed(1))
            t0 = time.monotonic()
            restored = ckpt.restore(i, like={"params": fresh_p,
                                             "opt_state": fresh_o})
            torch.cuda.synchronize()
            extra["restore_s"] = time.monotonic() - t0
            del fresh_p, fresh_o
            saved = tree_leaves(params) + opt_state["mu"] + opt_state["nu"]
            got = (tree_leaves(restored["params"])
                   + restored["opt_state"]["mu"]
                   + restored["opt_state"]["nu"])
            unequal = [n for n, (a, b) in enumerate(zip(got, saved))
                       if not torch.equal(a, b.detach())]
            if len(got) != len(saved) or unequal or \
                    restored["opt_state"]["count"] != opt_state["count"]:
                raise AssertionError(
                    f"moe: the restored train state differs from the saved "
                    f"one ({len(got)} vs {len(saved)} leaves, unequal at "
                    f"{unequal[:5]}, count {restored['opt_state']['count']}"
                    f" vs {opt_state['count']})")
            extra["restored_leaves_equal"] = len(got)
            _, _, metrics = step(params, opt_state, tokens)
            extra["uninterrupted_loss"] = metrics["loss"].item()
            params, opt_state = restored["params"], restored["opt_state"]
            del restored, saved, got, metrics
        t0 = time.monotonic()
        params, opt_state, metrics = step(params, opt_state, tokens)
        loss = metrics["loss"].item()  # waits for the step's kernels
        step_s = time.monotonic() - t0
        if i == MOE_TRAIN_STEPS - 1:
            # the aux loss of the trained weights, on the plain attention
            # (no kernel launch outside the counted steps)
            with torch.no_grad():
                _, aux = tfm.hidden_states(params, tokens[:2, :-1], cfg,
                                           blockwise_attention)
            extra["aux"] = aux.item()
        train.report(step=i, loss=loss,
                     grad_norm=metrics["grad_norm"].item(), step_s=step_s,
                     peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                     **extra)
    ckpt.close()
    return train.world_rank()


def phase_moe(report: dict) -> dict:
    """The MoE model's train path (its serve path is phase_serve's)."""
    import shutil

    import torch

    from ray_tpu_torch.ops.attention import blockwise_attention

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the MoE dispatch and combine "
                             "must run in fp32")
    cfg = _text_config("moe")
    ckpt_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            CKPT_DIR)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        rows, run_s, counts, routes = _run_trainer(
            train_moe, {"ckpt_dir": ckpt_dir})
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    steps_run = MOE_TRAIN_STEPS + 1  # the uninterrupted step besides
    want = {"fwd": 2 * cfg.layers * steps_run,
            "dq": cfg.layers * steps_run, "dkdv": cfg.layers * steps_run}
    _check_launches("moe train", counts, routes, want, cfg.head_dim)
    losses = [r["loss"] for r in rows]
    if len(rows) != MOE_TRAIN_STEPS or not all(
            math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"moe train losses not finite and falling: "
                             f"{losses}")
    aux = rows[-1]["aux"]
    resumed = rows[MOE_CKPT_STEP]
    pin = PinnedRouting()
    with pin.record():
        loss_k, grads_k = _one_step_grads("moe", None)
    with pin.replay():
        loss_p, grads_p = _one_step_grads("moe", blockwise_attention)
    rel, worst = _grad_rel(grads_k, grads_p)
    flip_share = pin.flips / pin.routings
    del grads_p
    # not checked: the plain run routed by its own scores
    _, grads_f = _one_step_grads("moe", blockwise_attention)
    rel_free, worst_free = _grad_rel(grads_k, grads_f)
    del grads_k, grads_f
    steady = [r["step_s"] for r in rows[1:]]
    step_s = sum(steady) / len(steady)
    tokens = MOE_TRAIN_TOKENS[0] * (MOE_TRAIN_TOKENS[1] - 1)
    report["moe_train"] = {
        "model": MODEL_DESC["moe"] + ", remat full, logits_chunk 256",
        "tokens": list(MOE_TRAIN_TOKENS), "steps": rows, "run_s": run_s,
        "steps_run": steps_run, "kernel_launches": counts,
        "kernel_launches_by_route": routes, "step_s_steady": step_s,
        "tokens_per_s": tokens / step_s, "aux": aux,
        "checkpoint": {k: resumed[k] for k in (
            "save_s", "restore_s", "restored_leaves_equal",
            "uninterrupted_loss")},
        "grad_rel_l2_vs_plain": rel, "loss_kernels": loss_k,
        "loss_plain": loss_p, "routing_flip_share_pinned": flip_share,
        "grad_rel_l2_vs_plain_unpinned": rel_free,
    }
    print(f"moe: Trainer(num_workers=1, use_gpu=True), {MOE_TRAIN_STEPS} "
          f"steps on {MOE_TRAIN_TOKENS[0]}x{MOE_TRAIN_TOKENS[1]} tokens "
          f"(+1 uninterrupted): losses {[round(x, 4) for x in losses]}, "
          f"aux {aux:.4f}, step s {[round(r['step_s'], 4) for r in rows]}; "
          f"steady {step_s:.4f} s/step, {tokens / step_s:.0f} tokens/s, "
          f"peak {rows[-1]['peak_gib']:.1f} GiB; checkpoint after step "
          f"{MOE_CKPT_STEP}: {resumed['restored_leaves_equal']} leaves "
          f"restored equal (save {resumed['save_s']:.2f} s, restore "
          f"{resumed['restore_s']:.2f} s), next loss {resumed['loss']:.6f} "
          f"vs uninterrupted {resumed['uninterrupted_loss']:.6f}; launches "
          f"{routes}; grads vs plain attention routed alike: worst rel L2 "
          f"{rel[worst]:.3g} ({worst}), loss {loss_k:.5f} vs {loss_p:.5f}, "
          f"{flip_share:.4f} of the routings pinned (unpinned worst rel L2 "
          f"{rel_free[worst_free]:.3g}, {worst_free})", flush=True)
    torch.cuda.empty_cache()
    if not (math.isfinite(aux) and aux > 0):
        raise AssertionError(f"moe aux loss {aux} is not finite and > 0")
    if abs(resumed["loss"] - resumed["uninterrupted_loss"]) > \
            1e-3 * abs(resumed["loss"]):
        raise AssertionError(
            f"moe: the step after the restore took loss {resumed['loss']}, "
            f"the uninterrupted run {resumed['uninterrupted_loss']}")
    _check_grads("moe", rel, worst)
    if abs(loss_k - losses[0]) > 1e-3 * abs(losses[0]):
        raise AssertionError(f"moe: the replayed first step's loss {loss_k} "
                             f"is not the train run's {losses[0]}")
    return routes


def _merge_routes(*parts: dict) -> dict:
    """Launches by kernel and route, summed over the parts of a path."""
    merged = {k: {} for k in ("fwd", "dq", "dkdv")}
    for part in parts:
        for kernel, by_route in part.items():
            for route, n in by_route.items():
                merged[kernel][route] = merged[kernel].get(route, 0) + n
    return merged


# --------------------------------------------------------------- phase 7


def phase_vit(report: dict) -> dict:
    """ViT-B/16's train path (its serve path is phase_serve's)."""
    import functools

    import torch

    from ray_tpu_torch.models import vision
    from ray_tpu_torch.models.training import make_optimizer, tree_leaves
    from ray_tpu_torch.ops.attention import blockwise_attention

    cfg = vision.ViTConfig.base()
    images, labels = (torch.as_tensor(a, device="cuda")
                      for a in _vit_batch(VIT_TRAIN_IMAGES, 100))
    params = vision.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    opt = make_optimizer()
    state = opt.init(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    rows = []
    for _ in range(VIT_TRAIN_STEPS):
        t0 = time.monotonic()
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss = vision.loss_fn(params, images, labels, cfg)
        norm = opt.update(params, torch.autograd.grad(loss, leaves), state)
        rows.append({"loss": loss.item(), "grad_norm": norm.item(),
                     "step_s": time.monotonic() - t0})
    counts = _read_counts()
    routes = _read_routes()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    want = {k: cfg.layers * VIT_TRAIN_STEPS for k in ("fwd", "dq", "dkdv")}
    _check_launches("vit train", counts, routes, want, cfg.head_dim)
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"vit train losses not finite and falling: "
                             f"{losses}")
    del params, state

    def vit_grads(attention_fn):
        params = vision.init_params(
            cfg, torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
        return _loss_and_grads(params, lambda p: vision.loss_fn(
            p, images, labels, cfg, attention_fn))

    loss_k, grads_k = vit_grads(None)
    loss_p, grads_p = vit_grads(functools.partial(blockwise_attention,
                                                  causal=False))
    rel, worst = _grad_rel(grads_k, grads_p)
    steady = [r["step_s"] for r in rows[1:]]
    step_s = sum(steady) / len(steady)
    report["vit_train"] = {
        "model": MODEL_DESC["vit"], "images": VIT_TRAIN_IMAGES,
        "steps": rows, "kernel_launches": counts,
        "kernel_launches_by_route": routes, "step_s_steady": step_s,
        "images_per_s": VIT_TRAIN_IMAGES / step_s, "peak_gib": peak_gib,
        "grad_rel_l2_vs_plain": rel, "loss_kernels": loss_k,
        "loss_plain": loss_p,
    }
    print(f"vit: {VIT_TRAIN_STEPS} ClippedAdamW steps on {VIT_TRAIN_IMAGES} "
          f"images: losses {[round(x, 4) for x in losses]}, step s "
          f"{[round(r['step_s'], 4) for r in rows]}; steady {step_s:.4f} "
          f"s/step, {VIT_TRAIN_IMAGES / step_s:.0f} images/s, peak "
          f"{peak_gib:.1f} GiB; launches {routes}; grads vs plain "
          f"attention: worst rel L2 {rel[worst]:.3g} ({worst}), loss "
          f"{loss_k:.5f} vs {loss_p:.5f}", flush=True)
    del grads_k, grads_p
    torch.cuda.empty_cache()
    _check_grads("vit", rel, worst)
    if abs(loss_k - losses[0]) > 1e-3 * abs(losses[0]):
        raise AssertionError(f"vit: the replayed first step's loss {loss_k} "
                             f"is not the train run's {losses[0]}")
    return routes


# ------------------------------------------------------------ phase data


def _b1_pipeline():
    """DATA_ROWS b1 token rows, each an int64 array [2049] drawn with seed
    0, through ray_tpu_torch.data: shuffled (seed 0) and repeated twice."""
    import numpy as np

    from ray_tpu_torch import data

    rows = np.random.default_rng(0).integers(
        0, _text_config("b1").vocab_size, size=(DATA_ROWS, TRAIN_TOKENS[1]))
    return data.from_items(list(rows), parallelism=DATA_PARALLELISM
                           ).random_shuffle(seed=0).repeat(2)


def _host_batches(source, batch_size: int) -> list:
    """The batches ``to_device`` must give, computed on the host from the
    same source: its numpy batches with JAX's x64-off dtypes."""
    import numpy as np
    import torch

    x32 = {np.dtype(np.int64): np.int32, np.dtype(np.float64): np.float32}
    return [torch.from_numpy(b.astype(x32.get(b.dtype, b.dtype)))
            for b in source.iter_batches(batch_size=batch_size,
                                         batch_format="numpy",
                                         drop_last=True)]


def train_b1_data():
    """The data phase's train function: b1 at full width and depth on this
    worker's card, one optimizer step on each batch that its dataset
    shard's ``to_device`` feeds; the time inside the feed's ``next()``,
    each step's loss and wall time (feed included) and the fed batch's
    dtype, device and shape reported. Returns the fed batches (host
    copies, taken after each step)."""
    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models.transformer import ModelConfig
    from ray_tpu_torch.models.training import build_train_step

    cfg = ModelConfig.b1()
    step, init_fn = build_train_step(cfg, device="cuda")
    params, opt_state = init_fn(
        torch.Generator(device="cuda").manual_seed(0))
    feed = train.get_dataset_shard().to_device(batch_size=TRAIN_TOKENS[0])
    fed = []
    torch.cuda.synchronize()
    while True:
        t0 = time.monotonic()
        tokens = next(feed, None)
        feed_s = time.monotonic() - t0
        if tokens is None:
            break
        params, opt_state, metrics = step(params, opt_state, tokens)
        loss = metrics["loss"].item()  # waits for the step's kernels
        step_s = time.monotonic() - t0
        train.report(step=len(fed), loss=loss, step_s=step_s,
                     feed_ms=feed_s * 1e3, dtype=str(tokens.dtype),
                     device=tokens.device.type, shape=list(tokens.shape))
        fed.append(tokens.cpu())
    return fed


def _vit_feed() -> dict:
    """ViT-B/16's input alone through ray_tpu_torch.data: VIT_FEED_IMAGES
    seeded image rows, repeated twice, fed by ``to_device`` in batches of
    VIT_TRAIN_IMAGES. Times each ``next()`` and each batch until its copy
    has landed; every batch must equal its host batch."""
    import torch

    import ray_tpu_torch
    from ray_tpu_torch import data

    ray_tpu_torch.init(num_cpus=4, device="cuda")
    try:
        images, _ = _vit_batch(VIT_FEED_IMAGES, 1)
        pipe = data.from_items(list(images)).repeat(2)
        want = _host_batches(pipe, VIT_TRAIN_IMAGES)
        feed = pipe.to_device(batch_size=VIT_TRAIN_IMAGES)
        got, next_ms, landed_ms = [], [], []
        torch.cuda.synchronize()
        while True:
            t0 = time.monotonic()
            batch = next(feed, None)
            t1 = time.monotonic()
            if batch is None:
                break
            torch.cuda.synchronize()
            next_ms.append((t1 - t0) * 1e3)
            landed_ms.append((time.monotonic() - t0) * 1e3)
            got.append(batch)
    finally:
        ray_tpu_torch.shutdown()
    if len(got) != len(want) or not all(
            g.device.type == "cuda" and g.dtype == torch.float32
            and torch.equal(g.cpu(), w) for g, w in zip(got, want)):
        raise AssertionError(
            f"vit feed: {len(got)} batches "
            f"{[(g.dtype, g.device.type) for g in got]} not equal to the "
            f"{len(want)} host batches")
    steady = landed_ms[1:]
    return {"images": VIT_FEED_IMAGES, "batch": VIT_TRAIN_IMAGES,
            "batches": len(got), "next_ms": next_ms, "landed_ms": landed_ms,
            "images_per_s": VIT_TRAIN_IMAGES * len(steady) / sum(steady)
            * 1e3,
            "batch_mb": got[0].numel() * got[0].element_size() / 1e6}


def phase_data(report: dict) -> dict:
    """b1 trained through Trainer from a shuffled, repeated
    ray_tpu_torch.data pipeline that ``to_device`` feeds to the card;
    then ViT-B/16's feed alone."""
    import torch

    cfg = _text_config("b1")
    made, fed = {}, []

    def dataset_fn():
        made["pipe"] = _b1_pipeline()
        made["host"] = _host_batches(made["pipe"], TRAIN_TOKENS[0])
        return made["pipe"]

    rows, run_s, counts, routes = _run_trainer(
        train_b1_data, dataset_fn=dataset_fn, results=fed)
    [fed] = fed
    want = {"fwd": 2 * cfg.layers * TRAIN_STEPS,
            "dq": cfg.layers * TRAIN_STEPS,
            "dkdv": cfg.layers * TRAIN_STEPS}
    _check_launches("b1 data", counts, routes, want, cfg.head_dim)
    if len(rows) != TRAIN_STEPS or len(made["host"]) != TRAIN_STEPS:
        raise AssertionError(f"b1 data: {len(rows)} steps on "
                             f"{len(made['host'])} host batches; expected "
                             f"{TRAIN_STEPS}")
    for r, got, host in zip(rows, fed, made["host"]):
        if (r["dtype"], r["device"], r["shape"]) != (
                "torch.int32", "cuda", [TRAIN_TOKENS[0], TRAIN_TOKENS[1]]) \
                or not torch.equal(got, host):
            raise AssertionError(
                f"b1 data: step {r['step']} was fed {r['dtype']} on "
                f"{r['device']} {r['shape']}, equal to the host batch: "
                f"{torch.equal(got, host)}")
    losses = [r["loss"] for r in rows]
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"b1 data losses not finite and falling: "
                             f"{losses}")
    steady = [r["step_s"] for r in rows[1:]]
    step_s = sum(steady) / len(steady)
    tokens = TRAIN_TOKENS[0] * (TRAIN_TOKENS[1] - 1)
    feed_ms = [r["feed_ms"] for r in rows]
    vit = _vit_feed()
    train_tps = report.get("train", {}).get("tokens_per_s")
    vit_ips = report.get("vit_train", {}).get("images_per_s")
    report["data"] = {
        "model": MODEL_DESC["b1"] + ", remat full",
        "rows": DATA_ROWS, "pipeline": "from_items(parallelism="
        f"{DATA_PARALLELISM}).random_shuffle(seed=0).repeat(2)",
        "steps": rows, "run_s": run_s, "kernel_launches": counts,
        "kernel_launches_by_route": routes, "feed_ms": feed_ms,
        "feed_ms_steady": sum(feed_ms[1:]) / len(feed_ms[1:]),
        "step_s_steady": step_s, "tokens_per_s": tokens / step_s,
        "train_phase_tokens_per_s": train_tps, "vit_feed": vit,
        "vit_phase_images_per_s": vit_ips,
    }
    print(f"data: b1 through Trainer(num_workers=1, use_gpu=True) from "
          f"{report['data']['pipeline']} of {DATA_ROWS} rows, to_device "
          f"batches of {TRAIN_TOKENS[0]}: losses "
          f"{[round(x, 4) for x in losses]}, feed ms (inside next()) "
          f"{[round(x, 3) for x in feed_ms]}, step s (feed included) "
          f"{[round(r['step_s'], 4) for r in rows]}; steady {step_s:.4f} "
          f"s/step, {tokens / step_s:.0f} tokens/s (train phase, one "
          f"resident batch: {train_tps and round(train_tps)}); launches "
          f"{routes}; every batch int32 on cuda, equal to the host batch. "
          f"ViT feed alone: {vit['batches']} batches of {vit['batch']} "
          f"({vit['batch_mb']:.1f} MB), next() ms "
          f"{[round(x, 2) for x in vit['next_ms']]}, landed ms "
          f"{[round(x, 2) for x in vit['landed_ms']]}: "
          f"{vit['images_per_s']:.0f} images/s (vit phase's step: "
          f"{vit_ips and round(vit_ips)} images/s)", flush=True)
    return routes


# ------------------------------------------------------------ phase tune


class _TuneLog:
    """What the tune phase's train functions record in this process (the
    thread tier runs them here): each b1 step they finished, as its start
    and end on this process's monotonic clock by learning rate (a
    stopped trial's last steps reach no result), and when each trial's
    weights were freed."""

    def __init__(self):
        self._lock = threading.Lock()
        self.spans = {}
        self.freed_at = {}

    def reset(self) -> None:
        with self._lock:
            self.spans = {}
            self.freed_at = {}

    def step_done(self, lr: float, t0: float, t1: float) -> None:
        with self._lock:
            self.spans.setdefault(lr, []).append((t0, t1))

    @property
    def steps(self) -> int:
        return sum(len(v) for v in self.spans.values())

    def freed(self, lr: float) -> None:
        self.freed_at[lr] = time.monotonic()


TUNE_LOG = _TuneLog()


def train_b1_tune(config):
    """The tune phase's train function: train_text's b1 at the trial's
    learning rate (ClippedAdamW's other settings as build_train_step's
    default), TUNE_STEPS steps, each reporting its loss, its wall time and
    the peak memory. TUNE_LOG notes each finished step and when the
    weights are freed."""
    import weakref

    import torch

    from ray_tpu_torch import train
    from ray_tpu_torch.models.transformer import ModelConfig
    from ray_tpu_torch.models.training import (
        build_train_step,
        make_optimizer,
    )

    cfg = ModelConfig.b1()
    step, init_fn = build_train_step(
        cfg, device="cuda",
        optimizer=make_optimizer(learning_rate=config["lr"]))
    params, opt_state = init_fn(
        torch.Generator(device="cuda").manual_seed(0))
    weakref.finalize(params["embed"], TUNE_LOG.freed, config["lr"])
    tokens = torch.as_tensor(_train_batch("b1"), device="cuda")
    torch.cuda.synchronize()
    for i in range(TUNE_STEPS):
        t0 = time.monotonic()
        params, opt_state, metrics = step(params, opt_state, tokens)
        loss = metrics["loss"].item()  # waits for the step's kernels
        t1 = time.monotonic()
        TUNE_LOG.step_done(config["lr"], t0, t1)
        train.report(step=i, loss=loss, step_s=t1 - t0,
                     peak_gib=torch.cuda.max_memory_allocated() / 2**30)


def _timed_asha():
    """ASHA (grace 2, factor 2, max_t TUNE_STEPS) that notes when it is
    told each trial completed: for a stopped trial, its stop."""
    from ray_tpu_torch import tune

    class TimedASHA(tune.AsyncHyperBandScheduler):
        def __init__(self):
            super().__init__(max_t=TUNE_STEPS, grace_period=2,
                             reduction_factor=2)
            self.completed_at = {}

        def on_trial_complete(self, runner, trial, result):
            self.completed_at[trial.config["lr"]] = time.monotonic()

    return TimedASHA()


def _steady_steps(spans: dict):
    """{lr: [(start, end) of each step]} -> (mean step s alone on the
    card, mean step s beside another trial's step, whether any two
    trials' steps overlapped), each trial's first step left out of the
    means."""
    alone, shared = [], []
    for lr, mine in spans.items():
        others = [iv for o, ivs in spans.items() if o != lr for iv in ivs]
        for a, b in mine[1:]:
            overlap = any(a < d and c < b for c, d in others)
            (shared if overlap else alone).append(b - a)

    def mean(xs):
        return sum(xs) / len(xs) if xs else None

    return mean(alone), mean(shared), bool(shared)


def phase_tune(report: dict) -> dict:
    """b1 trials searched by ray_tpu_torch.tune under ASHA through
    Trainer.to_tune_trainable, two sharing the card at a time."""
    import tempfile

    import torch

    import ray_tpu_torch
    from ray_tpu_torch import train, tune
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.util.placement_group import placement_group_table

    cfg = _text_config("b1")
    if "train" not in report:
        raise AssertionError("tune needs the train phase's first loss")
    train_first = report["train"]["steps"][0]["loss"]
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sched = _timed_asha()
    cluster = Cluster(head_node_args={"num_cpus": 6, "num_gpus": 1,
                                      "device": "cuda"})
    try:
        trainable = train.Trainer(
            num_workers=1, use_gpu=True, resources_per_worker={"GPU": 0.5}
        ).to_tune_trainable(train_b1_tune)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_tune_") as d:
            TUNE_LOG.reset()
            _reset_counts()
            t0 = time.monotonic()
            analysis = tune.run(
                trainable, config={"lr": tune.grid_search(list(TUNE_LRS))},
                metric="loss", mode="min", scheduler=sched,
                max_concurrent_trials=2, resources_per_trial={"cpu": 1},
                local_dir=d)
            run_s = time.monotonic() - t0
            counts, routes = _read_counts(), _read_routes()
            spans, steps = dict(TUNE_LOG.spans), TUNE_LOG.steps
        gpu_free = ray_tpu_torch.available_resources().get("GPU")
        pgs_left = [pg["state"] for pg in placement_group_table().values()
                    if pg["state"] != "REMOVED"]
        threads_left = [th.name for th in threading.enumerate()
                        if th.name.startswith(("tune-fn-", "train-rank-"))]
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
    finally:
        cluster.shutdown()

    trials = {t.config["lr"]: t for t in analysis.trials}
    rows = {lr: t.results for lr, t in trials.items()}
    losses = {lr: [r["loss"] for r in rs] for lr, rs in rows.items()}
    best = analysis.get_best_config()
    alone_s, shared_s, overlapped = _steady_steps(spans)
    # the trials ASHA stopped before max_t: from the stop to the moment
    # their weights were freed (None: never freed)
    stop_to_free_ms = {
        lr: (TUNE_LOG.freed_at[lr] - sched.completed_at[lr]) * 1e3
        if lr in TUNE_LOG.freed_at else None
        for lr in trials if len(rows[lr]) < TUNE_STEPS}
    free_ms = {f"{lr:g}": v and round(v, 1)
               for lr, v in stop_to_free_ms.items()}
    peak_gib = max(r["peak_gib"] for rs in rows.values() for r in rs)
    report["tune"] = {
        "model": MODEL_DESC["b1"] + ", remat full",
        "tokens": list(TRAIN_TOKENS), "steps_per_trial": TUNE_STEPS,
        "scheduler": "AsyncHyperBandScheduler(max_t=6, grace_period=2, "
                     "reduction_factor=2)", "max_concurrent_trials": 2,
        "trials": {str(lr): {"status": trials[lr].status,
                             "error": trials[lr].error,
                             "losses": losses[lr],
                             "step_s": [r["step_s"] for r in rows[lr]]}
                   for lr in TUNE_LRS},
        "best_config": best, "run_s": run_s, "steps_finished": steps,
        "step_spans_s": {str(lr): [(a - t0, b - t0) for a, b in v]
                         for lr, v in spans.items()},
        "kernel_launches": counts, "kernel_launches_by_route": routes,
        "step_s_alone": alone_s, "step_s_shared": shared_s,
        "peak_gib": peak_gib, "stop_to_free_ms": stop_to_free_ms,
        "gpu_free_after": gpu_free, "placement_groups_left": pgs_left,
        "threads_left": threads_left, "memory_before_gib":
        mem_before / 2**30, "memory_after_gib": mem_after / 2**30,
    }
    print(f"tune: b1 trials through Trainer(num_workers=1, use_gpu=True, "
          f"GPU 0.5).to_tune_trainable under ASHA (max_t {TUNE_STEPS}, "
          f"grace 2, factor 2), 2 at a time, {TRAIN_TOKENS[0]}x"
          f"{TRAIN_TOKENS[1]} tokens: "
          + "; ".join(f"lr {lr:g} {trials[lr].status} {len(rows[lr])} steps "
                      f"losses {[round(x, 4) for x in losses[lr]]}"
                      for lr in TUNE_LRS)
          + f"; best {best}; phase {run_s:.1f} s; steady step alone "
          f"{alone_s and round(alone_s, 4)} s, two sharing the card "
          f"{shared_s and round(shared_s, 4)} s; peak {peak_gib:.2f} GiB; "
          f"stop to weights freed ms {free_ms}; {steps} steps, launches "
          f"{routes}; after: GPU free {gpu_free}, "
          f"memory {mem_before / 2**30:.3f} -> {mem_after / 2**30:.3f} GiB "
          f"[{card_line()}]", flush=True)

    problems = []
    if any(t.status != "TERMINATED" for t in trials.values()):
        errors = {lr: t.error for lr, t in trials.items() if t.error}
        problems.append("statuses "
                        f"{ {lr: t.status for lr, t in trials.items()} }, "
                        f"errors {errors}")
    for lr in TUNE_BAD_LRS:
        if len(rows[lr]) != 2:
            problems.append(f"lr {lr:g}: {len(rows[lr])} results, not "
                            "stopped at rung 2")
    if len(rows[TUNE_LRS[-1]]) < 2:
        problems.append(f"lr {TUNE_LRS[-1]:g} got {len(rows[TUNE_LRS[-1]])}"
                        " results: it never had the card")
    flat = [x for ls in losses.values() for x in ls]
    if not all(math.isfinite(x) for x in flat):
        problems.append(f"losses not finite: {losses}")
    for lr, ls in losses.items():
        # a trial with no result is reported by the statuses above
        if ls and abs(ls[0] - train_first) > (TUNE_FIRST_LOSS_RTOL
                                              * abs(train_first)):
            problems.append(f"lr {lr:g}: first loss {ls[0]} is not the "
                            f"train phase's {train_first}")
    if best is None or best["lr"] in TUNE_BAD_LRS:
        problems.append(f"best config {best}")
    if not overlapped:
        problems.append("no two trials' steps overlapped on the card")
    if gpu_free != 1.0 or pgs_left or threads_left:
        problems.append(f"after tune.run: GPU free {gpu_free}, placement "
                        f"groups {pgs_left}, threads {threads_left}")
    if mem_after - mem_before > TUNE_MEM_SLACK:
        problems.append(f"card memory {mem_before} -> {mem_after} bytes")
    if problems:
        raise AssertionError("b1 tune: " + "; ".join(problems))
    _check_launches("b1 tune", counts, routes,
                    {"fwd": 2 * cfg.layers * steps,
                     "dq": cfg.layers * steps, "dkdv": cfg.layers * steps},
                    cfg.head_dim)
    return routes


# --------------------------------------------------------------- phase 8


DEBUG_TOKENS = (2, 129)  # [B, S + 1]: next-token targets at max_seq 128
DEBUG_IMAGES = 8


def _routed_alike(cfg):
    """(record, replay) contexts: a MoE model's plain run routed as its
    kernel run (PinnedRouting), nothing for a dense one."""
    if not cfg.num_experts:
        return contextlib.nullcontext(), contextlib.nullcontext()
    pin = PinnedRouting()
    return pin.record(), pin.replay()


def _rel_l2(got, want) -> float:
    return ((got.float() - want.float()).norm()
            / want.float().norm()).item()


def _debug_text(name: str) -> dict:
    """ModelConfig.debug() or tiny_moe() (the JAX package's test
    configs, float32, head_dim 16) on the card: served logits and one
    step's gradients through the kernels, each held against the plain
    attention (a MoE model routed alike), then one optimizer step."""
    import numpy as np
    import torch

    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.models.training import build_forward, build_train_step
    from ray_tpu_torch.ops.attention import blockwise_attention

    cfg = getattr(tfm.ModelConfig, name)()
    params = tfm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=DEBUG_TOKENS), device="cuda")
    record, replay = _routed_alike(cfg)
    with torch.no_grad():
        with record:
            logits = build_forward(cfg, device="cuda")(params, tokens[:, :-1])
        with replay:
            plain = build_forward(cfg, device="cuda",
                                  attention_fn=blockwise_attention)(
                params, tokens[:, :-1])
    serve_rel = _rel_l2(logits, plain)
    if tuple(logits.shape) != (DEBUG_TOKENS[0], DEBUG_TOKENS[1] - 1,
                               cfg.vocab_size) or \
            not torch.isfinite(logits).all() or \
            not serve_rel <= DEBUG_REL_L2_TOL:
        raise AssertionError(f"debug {name}: served logits malformed or off "
                             f"the plain attention (rel L2 {serve_rel:.3g})")
    record, replay = _routed_alike(cfg)
    with record:
        loss_k, grads_k = _loss_and_grads(
            params, lambda p: tfm.loss_fn(p, tokens, cfg, None))
    with replay:
        loss_p, grads_p = _loss_and_grads(
            params, lambda p: tfm.loss_fn(p, tokens, cfg,
                                          blockwise_attention))
    rel, worst = _grad_rel(grads_k, grads_p)
    _check_grads(f"debug {name}", rel, worst, DEBUG_REL_L2_TOL)
    step, init_fn = build_train_step(cfg, device="cuda")
    p, o = init_fn(torch.Generator(device="cuda").manual_seed(0))
    _, _, metrics = step(p, o, tokens)
    step_loss = metrics["loss"].item()
    if not math.isfinite(step_loss):
        raise AssertionError(f"debug {name}: train step loss {step_loss}")
    return {"serve_rel_l2_vs_plain": serve_rel, "loss_kernels": loss_k,
            "loss_plain": loss_p, "grad_worst_rel_l2": rel[worst],
            "grad_worst_leaf": worst, "train_step_loss": step_loss}


def phase_debug(report: dict) -> dict:
    """The JAX package's test configs on the card through the kernels
    (head_dim 16, float32: K1 and K3 on fma_f32_ring, K2 on fma_f32):
    ModelConfig.debug() and tiny_moe() served and one train step of each,
    ViTConfig.debug() served, each against the plain attention."""
    import functools

    import numpy as np
    import torch

    from ray_tpu_torch.models import vision
    from ray_tpu_torch.ops.attention import blockwise_attention

    _reset_counts()
    rows = {name: _debug_text(name) for name in ("debug", "tiny_moe")}
    cfg = vision.ViTConfig.debug()
    params = vision.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    images = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (DEBUG_IMAGES, cfg.image_size, cfg.image_size, cfg.channels),
        dtype=np.float32), device="cuda")
    with torch.no_grad():
        logits = vision.forward(params, images, cfg, None)
        plain = vision.forward(params, images, cfg, functools.partial(
            blockwise_attention, causal=False))
    rows["vit_debug"] = {"serve_rel_l2_vs_plain": _rel_l2(logits, plain)}
    counts, routes = _read_counts(), _read_routes()
    if not torch.isfinite(logits).all() or \
            not rows["vit_debug"]["serve_rel_l2_vs_plain"] <= \
            DEBUG_REL_L2_TOL:
        raise AssertionError(f"debug vit: logits off the plain attention: "
                             f"{rows['vit_debug']}")
    want = _main_path_routes("float32", cfg.head_dim)
    for kernel, route in want.items():
        if not counts[kernel] or routes[kernel] != {route: counts[kernel]}:
            raise AssertionError(f"debug: {kernel} launches by route "
                                 f"{routes[kernel]}; expected some, all on "
                                 f"{route}")
    report["debug"] = {"configs": rows, "kernel_launches": counts,
                       "kernel_launches_by_route": routes}
    print(f"debug: ModelConfig.debug, tiny_moe (routed alike) and "
          f"ViTConfig.debug on the card, head_dim 16 float32: "
          f"{ {k: {m: (round(v, 8) if isinstance(v, float) else v) for m, v in r.items()} for k, r in rows.items()} }; "
          f"launches {routes}", flush=True)
    return routes


# --------------------------------------------------------------- phase 9


class ProcServer(ModelServer):
    """ModelServer in an actor's own OS process (the process tier). Its
    replies are the last position's logits as host arrays, [2, 32000]
    float32 (256 KB, past the pipe protocol's SHM_THRESHOLD), so each
    rides the pool's shm segment; the launch counts it reads are those of
    its own process, where its kernels run."""

    def pid(self):
        return os.getpid()

    def visible_devices(self):
        return os.environ.get("CUDA_VISIBLE_DEVICES")

    def forward_last(self, tokens):
        return self.forward(tokens)[:, -1].float().cpu().numpy()

    def forward_last_card(self, tokens):
        """The last position's logits left on the card (the client phase's
        replies: they cross the ray:// frames as CUDA tensors). A copy:
        a view pickles its whole storage, here the [2, 2048, 32000] fp32
        logits (524 MB)."""
        return self.forward(tokens)[:, -1].clone()

    def rel_l2_vs_plain(self, tokens):
        return _rel_l2(self.forward(tokens), self.forward_plain(tokens))

    def reset_counts(self):
        _reset_counts()

    def counts(self):
        return _read_counts(), _read_routes()


def _no_card_build():
    """In a device-less pool worker: the port's CUDA entry point raises."""
    import torch

    from ray_tpu_torch.models.training import build_forward
    from ray_tpu_torch.models.transformer import ModelConfig

    seen = (os.environ.get("CUDA_VISIBLE_DEVICES"),
            torch.cuda.device_count())
    try:
        build_forward(ModelConfig.b1())
    except RuntimeError as exc:
        return seen, str(exc)
    return seen, None


def phase_proc_serve(report: dict) -> dict:
    """b1 served from an actor's own OS process on the card, through K1,
    its replies through the port's shm segment, held against the thread
    tier's serve phase; and a device-less pool worker's CUDA entry point
    raising (the device rule, shown with a card present)."""
    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch._native.shm_store import ShmStore

    want_last = report.get("_serve_last_logits")
    if want_last is None:
        raise AssertionError("proc_serve needs the serve phase's logits")
    cfg = _text_config("b1")
    rng = np.random.default_rng(0)  # the serve phase's tokens
    batches = [rng.integers(0, cfg.vocab_size, size=SERVE_TOKENS)
               for _ in range(SERVE_REQUESTS)]
    moved = []  # bytes of each shm buffer this process read off a pipe
    get_bytes = ShmStore.get_bytes

    def counting_get_bytes(store, object_id):
        data = get_bytes(store, object_id)
        if data is not None:
            moved.append(len(data))
        return data

    ShmStore.get_bytes = counting_get_bytes
    override = "RAY_TPU_WORKER_CUDA_VISIBLE_DEVICES"
    os.environ.pop(override, None)  # the pool's task workers: no card
    rt = ray_tpu_torch.init(worker_mode="process", num_process_workers=2,
                            num_gpus=1)
    try:
        shm_path = rt.process_pool.shm_path
        if not shm_path:
            raise AssertionError("the process pool has no shm segment")
        os.environ[override] = "0"  # the actor's process is given card 0
        t0 = time.monotonic()
        server = ray_tpu_torch.remote(num_gpus=1)(ProcServer).remote(0, "b1")
        pid = ray_tpu_torch.get(server.pid.remote())
        # the first forward, as the serve phase's probe: part of start-up
        ray_tpu_torch.get(server.forward_last.remote(batches[0][:, :16]))
        startup_s = time.monotonic() - t0
        visible = ray_tpu_torch.get(server.visible_devices.remote())
        if pid == os.getpid():
            raise AssertionError("the actor runs in the driver's process")
        ray_tpu_torch.get(server.reset_counts.remote())
        moved.clear()
        latencies, last = [], []
        for tokens in batches:
            t = time.monotonic()
            last.append(ray_tpu_torch.get(server.forward_last.remote(tokens)))
            latencies.append(time.monotonic() - t)
        counts, routes = ray_tpu_torch.get(server.counts.remote())
        shm_reads, shm_bytes = len(moved), sum(moved)
        want_route = _main_path_routes("bfloat16", cfg.head_dim)["fwd"]
        if counts != {"fwd": cfg.layers * SERVE_REQUESTS, "dq": 0,
                      "dkdv": 0} or routes["fwd"] != {
                          want_route: cfg.layers * SERVE_REQUESTS}:
            raise AssertionError(f"proc_serve: the actor's kernels launched "
                                 f"{counts} by route {routes}; expected "
                                 f"{cfg.layers} forward launches a request "
                                 f"on {want_route}")
        if shm_reads < SERVE_REQUESTS or any(
                x.nbytes < 256 * 1000 for x in last):
            raise AssertionError(f"proc_serve: {shm_reads} shm reads for "
                                 f"{SERVE_REQUESTS} replies")
        rel = max(float(np.linalg.norm(g - w) / np.linalg.norm(w))
                  for g, w in zip(last, want_last))
        bitwise = all(np.array_equal(g, w) for g, w in zip(last, want_last))
        if not all(g.shape == (SERVE_TOKENS[0], cfg.vocab_size)
                   and np.isfinite(g).all() for g in last) or \
                not rel <= SERVE_REL_L2_TOL:
            raise AssertionError(f"proc_serve: logits off the thread tier's "
                                 f"(rel L2 {rel:.3g})")
        child_rel = ray_tpu_torch.get(server.rel_l2_vs_plain.remote(
            batches[0]))
        if not child_rel <= SERVE_REL_L2_TOL:
            raise AssertionError(f"proc_serve: the actor's logits off its "
                                 f"plain attention: rel L2 {child_rel:.3g}")
        ray_tpu_torch.kill(server)
        os.environ.pop(override, None)
        (seen, error) = ray_tpu_torch.get(
            ray_tpu_torch.remote(_no_card_build).remote())
        if seen != ("", 0) or not error or "no CUDA device" not in error:
            raise AssertionError(f"proc_serve: a device-less pool worker saw "
                                 f"{seen} and build_forward gave {error!r}")
    finally:
        os.environ.pop(override, None)
        ShmStore.get_bytes = get_bytes
        ray_tpu_torch.shutdown()
    report["proc_serve"] = {
        "model": MODEL_DESC["b1"], "requests": SERVE_REQUESTS,
        "inputs": list(SERVE_TOKENS), "actor_pid_differs": True,
        "actor_visible_devices": visible, "startup_s": startup_s,
        "latency_s": latencies,
        "thread_tier_latency_s": report["serve"]["latency_s"],
        "shm_path": shm_path, "shm_reads": shm_reads,
        "shm_bytes": shm_bytes, "kernel_launches": counts,
        "kernel_launches_by_route": routes,
        "last_logits_rel_l2_vs_thread_tier": rel,
        "last_logits_bitwise_equal_thread_tier": bitwise,
        "logits_rel_l2_vs_plain_in_actor": child_rel,
        "device_less_worker": {"visible_devices": seen[0],
                               "device_count": seen[1], "error": error},
    }
    print(f"proc_serve: on {report.get('card')}: b1 actor in its own process "
          f"(pid {pid}, "
          f"CUDA_VISIBLE_DEVICES={visible!r}) up (first forward included) "
          f"in {startup_s:.2f} s; "
          f"{SERVE_REQUESTS} requests of {list(SERVE_TOKENS)}, latency s "
          f"{[round(x, 4) for x in latencies]} (thread tier "
          f"{[round(x, 4) for x in report['serve']['latency_s']]}); "
          f"{shm_reads} replies, {shm_bytes} bytes through the shm segment; "
          f"launches in the actor {routes}; last-position logits vs the "
          f"thread tier rel L2 {rel:.3g}, bitwise equal {bitwise}; full "
          f"logits vs plain attention in the actor rel L2 {child_rel:.3g}; "
          f"device-less pool worker saw {seen} and raised {error[:60]!r}",
          flush=True)
    return routes


# -------------------------------------------------------------- phase 4c


class BurstActor:
    """One of the live cluster's {"CPU": 0.25} burst actors."""

    def __init__(self, i):
        self.i = i

    def ping(self):
        return self.i


def _array_sum(array):
    return int(array.sum())


def _pool_ready(pool: dict) -> bool:
    return pool["alive"] == pool["size"] and \
        pool["warm_idle"] >= pool["warm_size"]


def _burst(client, n: int, tag: str) -> list:
    """``n`` {"CPU": 0.25} actors in one actor_create_batch frame; the
    GCS's views of them once every one is ALIVE."""
    from ray_tpu_torch.cluster import protocol

    rows = [{"actor_id": f"{tag}{i:03d}",
             "cls_bytes": protocol.dumps(BurstActor),
             "args_bytes": protocol.dumps(([("v", protocol.dumps(i))], {})),
             "resources": {"CPU": 0.25}, "max_restarts": 0, "name": "",
             "token": f"{tag}-row{i}"} for i in range(n)]
    client.gcs.call("actor_create_batch", creates=rows, token=tag,
                    timeout=120.0)
    deadline = time.monotonic() + 120
    while True:
        views = [client.gcs.call("actor_get", actor_id=r["actor_id"])
                 for r in rows]
        if all(v["state"] == "ALIVE" for v in views):
            return views
        if time.monotonic() > deadline:
            raise AssertionError(f"cluster: burst actors not ALIVE: "
                                 f"{sorted({v['state'] for v in views})}")
        time.sleep(0.1)


def _maps(pid: int, library: str) -> bool:
    """Whether the process has ``library`` mapped."""
    with open(f"/proc/{pid}/maps") as f:
        return library in f.read()


def _descendants(roots) -> set:
    """Every live process under ``roots`` (the cluster's server pids)."""
    parent = {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        parent[int(entry)] = int(fields[1])
    out, frontier = set(), set(roots)
    while frontier:
        frontier = {p for p, pp in parent.items()
                    if pp in frontier and p not in out}
        out |= frontier
    return out


def _reap(pids, timeout: float = 15.0) -> list:
    """Wait for ``pids`` to exit; SIGKILL the ones still alive after
    ``timeout``. Returns the pids that had to be killed."""
    import signal

    def alive(pid):
        try:
            os.kill(pid, 0)
            return True
        except ProcessLookupError:
            return False

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and any(alive(p) for p in pids):
        time.sleep(0.1)
    killed = [p for p in pids if alive(p)]
    for p in killed:
        with contextlib.suppress(ProcessLookupError):
            os.kill(p, signal.SIGKILL)
    return killed


def _placer_state(gcs_server):
    """A state-only GcsService (as tests/test_device_scheduler_live.py
    builds it) over CLUSTER_PLACER["nodes"] seeded nodes, and the burst's
    CLUSTER_PLACER["classes"] demand classes."""
    import threading

    import numpy as np

    rng = np.random.default_rng(0)
    svc = gcs_server.GcsService.__new__(gcs_server.GcsService)
    svc._lock = threading.RLock()
    svc._nodes = {}
    for i in range(CLUSTER_PLACER["nodes"]):
        res = {"CPU": float(rng.choice([32, 64, 96, 128])),
               "memory": float(rng.choice([128, 256, 512])) * 2 ** 30}
        if i % 4 == 0:
            res["GPU"] = float(rng.choice([1, 2, 4, 8]))
        rec = gcs_server._NodeRecord(f"node{i:04d}",
                                     f"10.0.{i // 200}.{i % 200}:7000", res)
        rec.available = {k: (float(np.floor(v * rng.uniform(0.5, 1.0)))
                             if k != "memory" else v * rng.uniform(0.5, 1.0))
                         for k, v in res.items()}
        svc._nodes[rec.node_id] = rec
    demands = []
    for c in range(CLUSTER_PLACER["classes"]):
        d = {"CPU": float(rng.choice([0.25, 0.5, 1, 2])) + c * 1e-3}
        if c % 4 == 1:
            d["GPU"] = float(rng.choice([0.25, 0.5]))
        if c % 3 == 2:
            d["memory"] = float(rng.choice([1, 2, 4])) * 2 ** 30
        demands.append(d)
    return svc, demands


def _placer_bursts() -> dict:
    """The GCS's actor-burst placer (A3) on the card at the scheduler's
    verdict scale, against its numpy route on the same state."""
    from ray_tpu_torch._private.config import Config
    from ray_tpu_torch.cluster import gcs_server
    from ray_tpu_torch.scheduler.policy import shared_batched_policy

    knob = "RAY_TPU_scheduler_device_solve_min_cells"
    svc, demands = _placer_state(gcs_server)

    def burst():
        return [gcs_server._ActorRecord(f"a{i:05d}", b"", b"",
                                        demands[i % len(demands)], 0)
                for i in range(CLUSTER_PLACER["actors"])]

    def timed(n):
        maps, ms = [], []
        for _ in range(n):
            actors = burst()
            t = time.perf_counter()
            maps.append(svc._batch_assign_actors(actors))
            ms.append((time.perf_counter() - t) * 1e3)
        return maps, ms

    policy = shared_batched_policy("cuda")
    solves0 = policy.device_solves
    os.environ.pop(knob, None)  # the default routing: 8,192 cells
    Config.reset()
    dev_maps, dev_ms = timed(CLUSTER_PLACER["bursts"] + 1)  # first warms
    device_solves = policy.device_solves - solves0
    os.environ[knob] = "-1"  # the numpy route
    Config.reset()
    try:
        np_maps, np_ms = timed(CLUSTER_PLACER["bursts"])
    finally:
        os.environ.pop(knob, None)
        Config.reset()
    if policy.device_solves - solves0 != device_solves:
        raise AssertionError("the numpy route launched a device solve")
    if device_solves != CLUSTER_PLACER["bursts"] + 1:
        raise AssertionError(f"placer: {device_solves} device solves for "
                             f"{CLUSTER_PLACER['bursts'] + 1} bursts")
    want = np_maps[0]
    if any(m != want for m in dev_maps + np_maps) or not want:
        raise AssertionError("placer: the device map differs from numpy's")
    return {"nodes": CLUSTER_PLACER["nodes"],
            "actors": CLUSTER_PLACER["actors"],
            "classes": CLUSTER_PLACER["classes"],
            "placed": len(want), "device_solves": device_solves,
            "device_ms": dev_ms, "numpy_ms": np_ms,
            "maps_equal": True}


def phase_cluster(report: dict) -> dict:
    """The multi-process cluster on the card: the GCS burst placer (A3)
    on CUDA against numpy; a live ProcessCluster at its default settings
    (the GCS on CUDA, warmed at start; 50 ms heartbeats, 10 missed make
    a node dead) whose GCS takes bursts through its device solve; b1
    served from a raylet's worker through K1; one cross-node object."""
    import numpy as np

    from ray_tpu_torch.cluster import process_cluster as pc
    from ray_tpu_torch.cluster import protocol
    from ray_tpu_torch.cluster.byte_store import sweep_stale_segments

    want_last = report.get("_serve_last_logits")
    if want_last is None:
        raise AssertionError("cluster needs the serve phase's logits")
    placer = _placer_bursts()
    print(f"cluster: on {report.get('card')}: GCS placer "
          f"{placer['nodes']} nodes x {placer['actors']} actors x "
          f"{placer['classes']} classes, {placer['placed']} placed, maps "
          f"equal; ms a burst on CUDA {[round(x, 2) for x in placer['device_ms']]}"
          f" (the first warms), numpy "
          f"{[round(x, 2) for x in placer['numpy_ms']]}", flush=True)

    cfg = _text_config("b1")
    rng = np.random.default_rng(0)  # the serve phase's tokens
    batches = [rng.integers(0, cfg.vocab_size, size=SERVE_TOKENS)
               for _ in range(SERVE_REQUESTS)]
    override = "RAY_TPU_WORKER_CUDA_VISIBLE_DEVICES"
    os.environ[override] = "0"  # the raylets' workers get card 0
    cluster = client = None
    started, out = set(), {"placer": placer}
    try:
        t = time.monotonic()
        cluster = pc.ProcessCluster(
            gcs_env={"RAY_TPU_scheduler_device_solve_min_cells": "0"})
        gcs_start_s = time.monotonic() - t
        cpu_node = cluster.add_node(
            num_cpus=8, object_store_memory=CLUSTER_STORE_BYTES)
        gpu_node = cluster.add_node(
            num_cpus=8, resources={"GPU": 1},
            object_store_memory=CLUSTER_STORE_BYTES)
        cluster.wait_for_nodes(2)
        client = pc.ClusterClient(cluster.gcs_address)
        gcs_pid = cluster.gcs_proc.pid
        # the raylets' worker pools booted: the burst meets an idle host
        deadline = time.monotonic() + 60
        while not all(
                _pool_ready(cluster.node_stats(n)["pool"])
                for n in (cpu_node, gpu_node)):
            if time.monotonic() > deadline:
                raise AssertionError("cluster: worker pools not booted")
            time.sleep(0.1)

        # the GCS took its CUDA context at start (warm_device) and the
        # raylets, which run no solve, took none
        cuda_maps = {"gcs": _maps(gcs_pid, "libcuda.so"),
                     "raylets": [_maps(p.pid, "libcuda.so")
                                 for p in cluster.raylets.values()]}
        if not cuda_maps["gcs"] or any(cuda_maps["raylets"]):
            raise AssertionError(f"cluster: libcuda.so mapped in {cuda_maps}"
                                 f"; expected the GCS alone")
        gap0 = {n: v["heartbeat_max_gap_ms"]
                for n, v in client.cluster_view()["nodes"].items()}
        # bursts of actors through actor_create_batch
        t = time.monotonic()
        first = _burst(client, CLUSTER_BURST, "burst")
        burst_s = time.monotonic() - t
        t = time.monotonic()
        second = _burst(client, CLUSTER_BURST // 2, "again")
        again_s = time.monotonic() - t
        view = client.cluster_view()
        placement = view["actor_placement"]
        gaps = {n: v["heartbeat_max_gap_ms"] for n, v in view["nodes"].items()}
        timeout_ms = 50 * 10  # ProcessCluster's defaults
        alive = [v["alive"] for v in view["nodes"].values()]
        if not all(alive) or max(gaps.values()) >= timeout_ms:
            raise AssertionError(f"cluster: a node's heartbeats fell "
                                 f"behind in the bursts: gaps ms {gaps}, "
                                 f"alive {alive}")
        per_node = {}
        for v in first + second:
            per_node[v["node_id"]] = per_node.get(v["node_id"], 0) + 1
        if max(per_node.values()) * 0.25 > 8 or \
                not set(per_node) <= {cpu_node, gpu_node}:
            raise AssertionError(f"cluster: burst placed beyond capacity: "
                                 f"{per_node}")
        if not str(placement.get("device", "")).startswith("cuda") or \
                placement.get("device_solves", 0) < 2 or \
                placement.get("host_solves"):
            raise AssertionError(f"cluster: the GCS's burst solves did not "
                                 f"all run on CUDA: {placement}")
        for v in first + second:
            client.kill_actor(pc.ClusterActorHandle(client, v["actor_id"]))
        solves = placement["device_ms"]
        out["burst"] = {
            "actors": [CLUSTER_BURST, CLUSTER_BURST // 2],
            "alive_s": [burst_s, again_s],
            "per_node": {n[:8]: k for n, k in per_node.items()},
            "gcs_placement": placement, "gcs_pid": gcs_pid,
            "gcs_start_s": gcs_start_s, "libcuda_mapped": cuda_maps,
            "heartbeat_max_gap_ms": {"before": max(gap0.values()),
                                     "after": max(gaps.values()),
                                     "timeout": timeout_ms}}
        print(f"cluster: GCS (pid {gcs_pid}) up in {gcs_start_s:.2f} s, its "
              f"CUDA solve warmed at start in "
              f"{placement['warmup_ms']:.1f} ms (libcuda.so mapped in the "
              f"GCS, in no raylet); bursts of {CLUSTER_BURST} and "
              f"{CLUSTER_BURST // 2} actors ALIVE in {burst_s:.2f} s and "
              f"{again_s:.2f} s through actor_create_batch, per node "
              f"{sorted(per_node.values())}; solved on "
              f"{placement['device']}, ms (actors) "
              f"{[(round(m, 2), n) for m, n in solves]}; longest heartbeat "
              f"gap ms {max(gap0.values()):.1f} before the bursts, "
              f"{max(gaps.values()):.1f} after (timeout {timeout_ms}), "
              f"every node alive", flush=True)

        # b1 from a raylet's worker
        t0 = time.monotonic()
        server = client.create_actor(ProcServer, (0, "b1"),
                                     resources={"GPU": 1})
        pid = server.pid()
        server.forward_last(batches[0][:, :16])  # the probe
        startup_s = time.monotonic() - t0
        host = client.gcs.call("actor_get", actor_id=server.actor_id)
        if host["node_id"] != gpu_node or pid == os.getpid():
            raise AssertionError(f"cluster: the b1 actor is not in a "
                                 f"worker of the GPU node: {host}")
        server.reset_counts()
        reply_bytes = []
        loads = protocol.loads

        def counting_loads(data):
            if isinstance(data, (bytes, bytearray, memoryview)):
                reply_bytes.append(len(data))
            return loads(data)

        latencies, last = [], []
        protocol.loads = counting_loads
        try:
            for tokens in batches:
                reply_bytes.clear()
                t = time.monotonic()
                last.append(server.forward_last(tokens))
                latencies.append(time.monotonic() - t)
        finally:
            protocol.loads = loads
        counts, routes = server.counts()
        want_route = _main_path_routes("bfloat16", cfg.head_dim)["fwd"]
        if counts != {"fwd": cfg.layers * SERVE_REQUESTS, "dq": 0,
                      "dkdv": 0} or routes["fwd"] != {
                          want_route: cfg.layers * SERVE_REQUESTS}:
            raise AssertionError(f"cluster: the actor's kernels launched "
                                 f"{counts} by route {routes}; expected "
                                 f"{cfg.layers} forward launches a request "
                                 f"on {want_route}")
        bitwise = all(np.array_equal(g, w) for g, w in zip(last, want_last))
        if not bitwise or not all(
                g.shape == (SERVE_TOKENS[0], cfg.vocab_size) for g in last):
            rel = max(float(np.linalg.norm(g - w) / np.linalg.norm(w))
                      for g, w in zip(last, want_last))
            raise AssertionError(f"cluster: last-position logits not "
                                 f"bit-equal to the serve phase's (rel L2 "
                                 f"{rel:.3g})")
        server_pid = pid
        client.kill_actor(server)
        out["serve"] = {
            "model": MODEL_DESC["b1"], "requests": SERVE_REQUESTS,
            "inputs": list(SERVE_TOKENS), "actor_pid": server_pid,
            "node": "gpu", "startup_s": startup_s, "latency_s": latencies,
            "thread_tier_latency_s": report["serve"]["latency_s"],
            "reply": ("inline in the actor_call RPC reply; worker to "
                      "raylet over the pipe, its buffer in the raylet's "
                      "shm segment"),
            "reply_rpc_bytes": reply_bytes[-1] if reply_bytes else None,
            "kernel_launches": counts, "kernel_launches_by_route": routes,
            "last_logits_bitwise_equal_serve": bitwise}
        print(f"cluster: b1 actor in a worker of the GPU raylet (pid "
              f"{server_pid}) up (first forward included) in "
              f"{startup_s:.2f} s; {SERVE_REQUESTS} requests of "
              f"{list(SERVE_TOKENS)}, latency s "
              f"{[round(x, 4) for x in latencies]} (thread tier "
              f"{[round(x, 4) for x in report['serve']['latency_s']]}); "
              f"replies inline in the actor_call RPC, "
              f"{out['serve']['reply_rpc_bytes']} bytes; launches in the "
              f"actor {routes}; last-position logits bit-equal to the "
              f"serve phase's", flush=True)

        # one cross-node object
        array = np.random.default_rng(1).integers(
            0, 1 << 20, size=CROSS_NODE_BYTES // 8, dtype=np.int64)
        ref = client.put(array)
        reader = cpu_node if ref.node_id == gpu_node else gpu_node
        t = time.monotonic()
        total = client.get(client.submit(_array_sum, (ref,),
                                         node_id=reader), timeout=120.0)
        cross_s = time.monotonic() - t
        if total != int(array.sum()):
            raise AssertionError(f"cluster: cross-node sum {total} != "
                                 f"{int(array.sum())}")
        fetches = cluster.node_stats(reader).get("fetches")
        out["cross_node"] = {"bytes": array.nbytes, "seconds": cross_s,
                             "reader_fetches": fetches}
        print(f"cluster: {array.nbytes} B put on one node, summed by a task "
              f"on the other in {cross_s:.3f} s (reader's fetches "
              f"{fetches})", flush=True)
        started = _descendants([gcs_pid, *(p.pid for p in
                                           cluster.raylets.values())])
    finally:
        os.environ.pop(override, None)
        if client is not None:
            client.close()
        if cluster is not None:
            servers = [cluster.gcs_proc.pid,
                       *(p.pid for p in cluster.raylets.values())]
            started |= _descendants(servers)
            cluster.shutdown()
            out["killed_after_shutdown"] = _reap(started)
        out["segments_swept"] = sweep_stale_segments(min_age_s=0.0)
    report["cluster"] = out
    return routes


# ----------------------------------------------------------- phase rllib

# the rllib phase: every translated policy class on the card against its
# CPU copy (same numpy weights, RLLIB_UPDATES updates on one seeded
# batch of RLLIB_BATCH rows); the QMIX/VDN networks the same way; the
# three catalog nets (vision at 84x84x4, RLLIB_VISION_CHECK_BATCH rows)
RLLIB_OBS, RLLIB_ACTIONS, RLLIB_ACTION_DIM = 8, 4, 2
RLLIB_BATCH, RLLIB_UPDATES, RLLIB_LR = 256, 3, 1e-3
RLLIB_VISION_CHECK_BATCH = 32
# card vs CPU, relative L2 of the worst weight leaf after the updates.
# float32 MLPs: cuBLAS runs fp32 matmuls without TF32 by default, so the
# two sides differ by summation order and the last ulps of tanh/exp,
# which adam's sqrt(nu) normalisation carries into each step at the
# same relative size (~1e-6 in the CPU parity tests against JAX);
# continuous SAC and CQL take log(1 - tanh^2), whose cancellation turns
# 1-2 ulp tanh differences into 1e-4-level weight differences
# (tests/test_torch_rllib_extra.py: 3.7e-4 against JAX)
RLLIB_REL_L2 = 1e-4
RLLIB_SQUASHED_REL_L2 = 2e-3
# vision_net's convs run on cuDNN in TF32 (rllib/models.py): inputs
# rounded to 10 mantissa bits, products summed in fp32; through three
# convs and two dense layers, ~1e-3 relative on the output and up to
# ~1e-2 on the worst gradient leaf (a bias, summed over every position).
# Its updates are held with fp32 convs (_rllib_catalog_pairs)
RLLIB_VISION_REL_L2 = {"out": 5e-3, "grads": 2e-2, "weights": RLLIB_REL_L2}
# learning on the card: the tests' configs and thresholds, with two
# rollout workers on the thread tier (tests/test_torch_rllib*.py)
RLLIB_OTHER_ITERS = 2
# at published widths: upstream RLlib's PPO widths on CartPole
# (fcnet_hiddens, train_batch_size, sgd_minibatch_size,
# num_sgd_iter); lr, clip, lambda, the loss coefficients and the
# absent KL penalty are the port's PPOPolicy defaults
RLLIB_PPO_PUBLISHED = dict(hidden=(256, 256), train_batch_size=4000,
                           sgd_minibatch_size=128, num_sgd_iter=30,
                           num_workers=2, iterations=3)
RLLIB_VISION = dict(shape=(84, 84, 4), batch=128, hidden=256, iters=20)
# card memory after every trainer.stop() against before the phase,
# read after a warm-up trainer has given a cuBLAS handle and workspace
# (kept by PyTorch for the process) to each thread the phase multiplies
# on: the main thread, autograd's device thread and two rollout
# workers'. The slack is below the smallest policy the phase builds (a
# DQN policy on the guessing env: 74 KiB of weights, target and
# moments), so one policy left on the card fails the check
RLLIB_MEM_SLACK = 64 << 10
# the offline trainers' JSON input (in the checkout, listed in
# .gitignore, removed when the phase ends)
RLLIB_DATA_DIR = ".chip_smoke_rllib"
# phase workflow: the DAG's storage and checkpoints (b1's weights and
# AdamW state, ≈ 7.7 GB a checkpoint), removed after
WORKFLOW_DIR = ".chip_smoke_workflow"
WORKFLOW_STEPS = 2  # optimizer steps in each of the DAG's train steps
WORKFLOW_PROMPTS = (2, 2048)  # the serve step's two seeded prompts
# phase persist: the GCS snapshot, removed after; the card's memory after
# shutdown() within this of its value before the detached actor
PERSIST_DIR = ".chip_smoke_persist"
PERSIST_MEM_SLACK = 64 << 10
# phase client: the card's free memory after the server's kill within
# this of its value before the server started (this process's caching
# allocator keeps the blocks of the replies it received)
CLIENT_MEM_SLACK = 64 << 20
# b1 requests timed over ray:// and as direct actor calls, each side
CLIENT_REQUESTS = 32
# phase util: rows through the iterator and the queue, the drain's batch;
# host puts, then gets, of a [2048] row timed as one window each
UTIL_ROWS = 10
UTIL_MAX_BATCH = 4
QUEUE_OPS = 5000
# phase ops: the py_modules package, the job scripts and the module
# caches, in the checkout (listed in .gitignore) and removed after; the
# gpu node's idle timeout; the card's free memory after the stopped job
# and after `down` within OPS_MEM_SLACK of its value before (this
# process's caching allocator keeps the blocks of the replies it got)
OPS_DIR = ".chip_smoke_ops"
OPS_IDLE_S = 3.0
OPS_MEM_SLACK = 64 << 20
# the microbenchmark's rows, named and ordered as the JAX package's
# (ray_tpu/_private/ray_perf.py), and the seconds each run is timed
OPS_PERF_ROWS = ("single_client_tasks_async", "multi_client_tasks_async",
                 "1_1_actor_calls_sync", "1_1_actor_calls_async",
                 "n_n_actor_calls_async", "single_client_put_MiB_per_s",
                 "placement_group_create_removal")
OPS_PERF_DURATION = 0.5
# phase dash: the process-tier head's routes, gets a route timed under
# load, the marker each b1 request prints, the thread tier's actor name
DASH_ROUTES = ("/", "/healthz", "/api/cluster", "/api/nodes",
               "/api/actors", "/api/logs?n=500", "/api/jobs")
DASH_THREAD_ROUTES = ("/api/cluster_status", "/api/nodes", "/api/actors",
                      "/api/placement_groups", "/api/objects",
                      "/api/events")
DASH_GETS = 5
DASH_MARKER = "DASH_B1_REQUEST"
DASH_ACTOR = "dash_b1"


def _rllib_env_classes():
    """The continuous one-step oracle of tests/test_torch_rllib_extra.py
    (reward -(a - 0.5)^2) and the oracle experts for offline data."""
    import numpy as np

    from ray_tpu_torch.rllib.env import Env

    class TargetEnv(Env):
        observation_dim = 2
        num_actions = 1
        action_dim = 1
        action_low = -1.0
        action_high = 1.0

        def __init__(self, seed=None):
            self._rng = np.random.default_rng(seed)

        def reset(self):
            return self._rng.normal(size=2).astype(np.float32)

        def step(self, action):
            a = float(np.asarray(action).reshape(-1)[0])
            return self.reset(), -((a - 0.5) ** 2), True, {}

    class Oracle:
        def compute_actions(self, obs):
            return np.array([int(np.argmax(obs))]), {}

    class RandomCont:
        def __init__(self):
            self._rng = np.random.default_rng(0)

        def compute_actions(self, obs):
            return self._rng.uniform(-1, 1, size=(1, 1)), {}

    return TargetEnv, Oracle, RandomCont


def _policy_tensors(obj, out=None) -> list:
    """Every tensor a policy (or a QMIX trainer) holds: parameters,
    targets, optimizer moments, the noise generator's device."""
    import torch

    out = [] if out is None else out
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, dict):
        for v in obj.values():
            _policy_tensors(v, out)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _policy_tensors(v, out)
    elif isinstance(obj, torch.Generator):
        out.append(torch.empty(0, device=obj.device))
    return out


def _off_card(holder) -> list:
    """The attributes of ``holder`` that hold a tensor off the card."""
    return [k for k, v in vars(holder).items()
            if any(t.device.type != "cuda" for t in _policy_tensors(v))]


def _tree_rel_l2(got, want) -> tuple:
    """(worst leaf's relative L2, its path) over two numpy trees."""
    import numpy as np

    worst = (0.0, "")

    def walk(g, w, path):
        nonlocal worst
        if isinstance(w, dict):
            for k in w:
                walk(g[k], w[k], f"{path}/{k}")
        elif isinstance(w, (list, tuple)):
            for i, (a, b) in enumerate(zip(g, w)):
                walk(a, b, f"{path}/{i}")
        elif isinstance(w, np.ndarray):
            rel = float(np.linalg.norm(g - w)
                        / max(np.linalg.norm(w), 1e-12))
            worst = max(worst, (rel, path))

    walk(got, want, "")
    return worst


def _rllib_batch(continuous: bool, scale: float = 1.0, mid: float = 0.0):
    import numpy as np

    from ray_tpu_torch.rllib import SampleBatch
    from ray_tpu_torch.rllib import sample_batch as sb

    rng = np.random.default_rng(11)
    n = RLLIB_BATCH
    dones = rng.random(n) < 0.2
    dones[-1] = False
    actions = (rng.uniform(-1, 1, (n, RLLIB_ACTION_DIM)).astype(np.float32)
               * scale + mid if continuous
               else rng.integers(RLLIB_ACTIONS, size=n))
    return SampleBatch({
        sb.OBS: rng.normal(size=(n, RLLIB_OBS)).astype(np.float32),
        sb.ACTIONS: actions,
        sb.REWARDS: rng.normal(size=n).astype(np.float32),
        sb.NEXT_OBS: rng.normal(size=(n, RLLIB_OBS)).astype(np.float32),
        sb.DONES: dones,
        sb.LOGP: np.log(rng.uniform(0.1, 0.9, n)).astype(np.float32),
        sb.VALUES: rng.normal(size=n).astype(np.float32),
        sb.ADVANTAGES: rng.normal(size=n).astype(np.float32),
        sb.RETURNS: rng.normal(size=n).astype(np.float32),
    })


def _rllib_policy_pairs() -> dict:
    """Each translated policy class on the card and on the CPU from the
    same numpy weights: RLLIB_UPDATES updates on one batch (continuous
    SAC and CQL given the same noise), then the worst weight leaf's
    relative L2 and the device check."""
    import numpy as np
    import torch

    from ray_tpu_torch import rllib
    from ray_tpu_torch.rllib import policy_extra

    classes = [
        ("PPO", rllib.PPOPolicy, {"num_sgd_iter": 2,
                                  "sgd_minibatch_size": 64}),
        ("DQN", rllib.DQNPolicy, {"target_update_freq": 2}),
        ("PG", rllib.PGPolicy, {}), ("MARWIL", rllib.MARWILPolicy,
                                      {"beta": 1.0, "ma_lr": 0.1}),
        ("A2C", rllib.A2CPolicy, {}), ("SAC", rllib.SACPolicy, {}),
        ("IMPALA", rllib.IMPALAPolicy, {}),
        ("APPO", policy_extra.APPOPolicy, {}),
        ("DDPG", rllib.DDPGPolicy, {"action_low": -2.0,
                                    "action_high": 2.0}),
        ("TD3", rllib.TD3Policy, {}),
        ("ContinuousSAC", rllib.ContinuousSACPolicy, {}),
        ("CQL", rllib.CQLPolicy, {"num_cql_actions": 8}),
    ]
    out = {}
    for name, cls, extra in classes:
        continuous = name in ("DDPG", "TD3", "ContinuousSAC", "CQL")
        width = RLLIB_ACTION_DIM if continuous else RLLIB_ACTIONS
        lrs = ({"actor_lr": RLLIB_LR, "critic_lr": RLLIB_LR,
                "alpha_lr": RLLIB_LR} if continuous else {"lr": RLLIB_LR})
        cfg = {"seed": 7, "hidden": (64, 64), **lrs, **extra}
        host = cls(RLLIB_OBS, width, {**cfg, "device": "cpu"})
        card = cls(RLLIB_OBS, width, {**cfg, "device": "cuda"})
        card.set_weights(host.get_weights())
        batch = _rllib_batch(continuous, getattr(host, "_scale", 1.0),
                             getattr(host, "_mid", 0.0))
        noise_rng = np.random.default_rng(12)
        squashed = name in ("ContinuousSAC", "CQL")
        stats = []
        for _ in range(RLLIB_UPDATES):
            kw = {}
            if squashed:
                shape = (RLLIB_BATCH, RLLIB_ACTION_DIM)
                kw["noise"] = {
                    "next": torch.as_tensor(noise_rng.normal(
                        size=shape).astype(np.float32)),
                    "pi": torch.as_tensor(noise_rng.normal(
                        size=shape).astype(np.float32))}
                if name == "CQL":
                    kw["noise"]["rand"] = torch.as_tensor(noise_rng.uniform(
                        -1, 1, (RLLIB_BATCH, 8, RLLIB_ACTION_DIM)).astype(
                            np.float32))
            copy = {k: np.array(v) for k, v in batch.items()}
            s_host = host.learn_on_batch(type(batch)(copy), **kw)
            copy = {k: np.array(v) for k, v in batch.items()}
            s_card = card.learn_on_batch(type(batch)(copy), **kw)
            stats.append({k: (s_card[k], s_host[k]) for k in s_host})
        rel, leaf = _tree_rel_l2(card.get_weights(), host.get_weights())
        out[name] = {"weights_rel_l2": rel, "worst_leaf": leaf,
                     "tol": RLLIB_SQUASHED_REL_L2 if squashed
                     else RLLIB_REL_L2,
                     "device": str(card.device),
                     "off_device": _off_card(card),
                     "last_stats_card_cpu": stats[-1]}
    return out


def _rllib_qmix_pairs() -> dict:
    """QMIX's and VDN's networks (agent Q-net, mixer hypernets, one
    adam) on the card against the CPU: three training steps from the same
    weights (the numpy rollouts and replay draws agree while the greedy
    actions do)."""
    import torch

    from ray_tpu_torch import rllib

    out = {}
    for name, cls in (("QMIX", rllib.QMixTrainer),
                      ("VDN", rllib.VDNTrainer)):
        cfg = {"env": rllib.TwoStepCoopEnv, "seed": 3, "lr": 5e-3,
               "sgd_steps_per_iter": 8}
        host = cls({**cfg, "device": "cpu"})
        card = cls({**cfg, "device": "cuda"})
        card.restore(host.save_checkpoint())
        for _ in range(RLLIB_UPDATES):
            host.train()
            card.train()
        rel, leaf = _tree_rel_l2(card.save_checkpoint()["params"],
                                 host.save_checkpoint()["params"])
        out[name] = {"weights_rel_l2": rel, "worst_leaf": leaf,
                     "tol": RLLIB_REL_L2, "device": str(card.device),
                     "off_device": _off_card(card)}
    return out


def _adam_fit(model, params, x, target, steps: int):
    """``steps`` adam updates (rllib.policy.Adam) of an MSE fit; the
    first forward's output and gradients, as numpy."""
    import torch

    from ray_tpu_torch.rllib.policy import Adam, grads_of, tree_leaves

    opt = Adam(RLLIB_LR)
    state = opt.init(params)
    first = None
    for _ in range(steps):
        out = model(params, x)
        out = out[0] if isinstance(out, tuple) else out
        loss = torch.mean((out - target) ** 2)
        grads = grads_of(loss, tree_leaves(params))
        if first is None:
            first = (out.detach().cpu().numpy(),
                     [g.cpu().numpy() for g in grads])
        opt.update(params, grads, state)
    return first


def _rllib_catalog_pairs() -> dict:
    """fcnet, gru_net and vision_net (84x84x4, the catalog's default
    filters) on the card against the CPU from the same weights: the first
    forward and its gradients, then the weights after RLLIB_UPDATES adam
    steps of an MSE fit. vision_net's convs run in TF32 on the card by
    default (rllib/models.py), and adam's first steps are +-lr wherever
    |g| >> eps, so a gradient element that TF32 rounding flips in sign
    moves its weight by 2 lr: its updates are held in full fp32 convs
    (``torch.backends.cudnn.flags``, scoped to the check), its TF32
    weights reported beside them."""
    import numpy as np
    import torch

    from ray_tpu_torch.rllib import models
    from ray_tpu_torch.rllib.policy import tree_to_device, tree_to_numpy

    rng = np.random.default_rng(13)
    nets = {
        "fcnet": (models.ModelCatalog.get_model((RLLIB_OBS,), 4),
                  rng.normal(size=(RLLIB_BATCH, RLLIB_OBS)),
                  (RLLIB_BATCH, 4)),
        "gru_net": (models.ModelCatalog.get_model(
            (RLLIB_OBS,), 4, {"use_rnn": True, "rnn_hidden": 64}),
            rng.normal(size=(32, 16, RLLIB_OBS)), (32, 16, 4)),
        "vision_net": (models.ModelCatalog.get_model(
            RLLIB_VISION["shape"], 4),
            rng.uniform(size=(RLLIB_VISION_CHECK_BATCH,
                              *RLLIB_VISION["shape"])),
            (RLLIB_VISION_CHECK_BATCH, 4)),
    }
    out = {}
    for name, ((init, apply), x, tshape) in nets.items():
        weights = tree_to_numpy(init(torch.Generator().manual_seed(5),
                                     device="cpu"))
        target = rng.normal(size=tshape).astype(np.float32)

        def fit(side):
            params = tree_to_device(weights, side)
            (o, g) = _adam_fit(
                apply, params, torch.as_tensor(x.astype(np.float32),
                                               device=side),
                torch.as_tensor(target, device=side), RLLIB_UPDATES)
            return o, g, tree_to_numpy(params), params

        o_h, g_h, w_h, _ = fit("cpu")
        o_c, g_c, w_c, p_card = fit("cuda")
        row = {"out_rel_l2": float(np.linalg.norm(o_c - o_h)
                                   / np.linalg.norm(o_h)),
               "grads_rel_l2": max(float(np.linalg.norm(a - b)
                                         / max(np.linalg.norm(b), 1e-12))
                                   for a, b in zip(g_c, g_h)),
               "weights_rel_l2": _tree_rel_l2(w_c, w_h)[0],
               "off_device": [] if all(
                   t.device.type == "cuda"
                   for t in _policy_tensors(p_card)) else ["params"]}
        if name == "vision_net":
            row["tol"] = dict(RLLIB_VISION_REL_L2)
            row["tf32_weights_rel_l2"] = row.pop("weights_rel_l2")
            with torch.backends.cudnn.flags(enabled=True,
                                            allow_tf32=False):
                o_f, _g, w_f, _p = fit("cuda")
            row["fp32_out_rel_l2"] = float(np.linalg.norm(o_f - o_h)
                                           / np.linalg.norm(o_h))
            row["weights_rel_l2"] = _tree_rel_l2(w_f, w_h)[0]
        else:
            row["tol"] = {"out": 1e-5, "grads": 1e-4,
                          "weights": RLLIB_REL_L2}
        out[name] = row
    return out


def _finite_stats(stats) -> bool:
    if isinstance(stats, dict):
        return bool(stats) and all(_finite_stats(v) for v in stats.values())
    return isinstance(stats, (int, float)) and math.isfinite(stats)


def _rllib_learn(data_dir: str) -> dict:
    """PPO, DQN and continuous SAC learn their test environments to the
    tests' thresholds with two rollout workers; every other trainer
    takes RLLIB_OTHER_ITERS iterations. The policies get no ``device``
    key on the card: ``None`` is CUDA."""
    import numpy as np

    from ray_tpu_torch import rllib

    TargetEnv, Oracle, RandomCont = _rllib_env_classes()
    guess = {"env": rllib.StatelessGuessEnv, "num_workers": 2}
    expert = os.path.join(data_dir, "expert.json")
    cont = os.path.join(data_dir, "cont.json")
    w = rllib.JsonWriter(expert)
    for ep in range(4):
        rllib.collect_episodes(rllib.StatelessGuessEnv(num_actions=4,
                                                       seed=0),
                               Oracle(), 256, writer=w, seed=ep)
    w.close()
    w = rllib.JsonWriter(cont)
    for ep in range(4):
        rllib.collect_episodes(TargetEnv(seed=0), RandomCont(), 256,
                               writer=w, seed=ep)
    w.close()
    replay_cont = {"env": TargetEnv, "num_workers": 2,
                   "rollout_fragment_length": 128, "learning_starts": 128,
                   "sgd_batch_size": 64}
    sac_pc = {"seed": 0, "actor_lr": 1e-3, "critic_lr": 1e-3,
              "alpha_lr": 1e-3}
    runs = {
        # name: (trainer class, config, iterations, check(result, trainer))
        "PPO": (rllib.PPOTrainer, {
            **guess, "train_batch_size": 512,
            "policy_config": {"seed": 0, "lr": 5e-3, "entropy_coeff": 0.0},
            "env_config": {"num_actions": 4, "seed": 1}}, 12,
            lambda r, t: r["episode_reward_mean"] > 0.6),
        "DQN": (rllib.DQNTrainer, {
            **guess, "rollout_fragment_length": 256,
            "learning_starts": 256, "sgd_steps_per_iter": 64,
            "policy_config": {"seed": 0, "lr": 5e-3, "epsilon_decay": 0.9},
            "env_config": {"num_actions": 3, "seed": 2}}, 12,
            lambda r, t: r["episode_reward_mean"] > 0.6),
        "SACContinuous": (rllib.SACContinuousTrainer, {
            **replay_cont, "sgd_steps_per_iter": 64,
            "policy_config": sac_pc}, 25,
            lambda r, t: (r["episode_reward_mean"] > -0.12
                          and r["info"]["learner"]["alpha"] < 0.1
                          and abs(float(t.get_policy().greedy_actions(
                              np.zeros((4, 2), np.float32)).mean())
                              - 0.5) < 0.25)),
    }
    guess4 = {**guess, "train_batch_size": 512,
              "env_config": {"num_actions": 4, "seed": 3}}
    two = RLLIB_OTHER_ITERS
    for name, cls, cfg in (
            ("A2C", rllib.A2CTrainer, {**guess4, "policy_config": {
                "seed": 0, "lr": 5e-3}}),
            ("SAC", rllib.SACTrainer, {
                **guess, "rollout_fragment_length": 256,
                "learning_starts": 256, "sgd_steps_per_iter": 32,
                "policy_config": {"seed": 0, "lr": 5e-3},
                "env_config": {"num_actions": 3, "seed": 4}}),
            ("IMPALA", rllib.IMPALATrainer, {**guess4, "policy_config": {
                "seed": 0, "lr": 5e-3}}),
            ("APPO", rllib.APPOTrainer, {**guess4, "policy_config": {
                "seed": 0, "lr": 5e-3}}),
            ("PG", rllib.PGTrainer, {**guess4, "policy_config": {
                "seed": 0, "lr": 2e-2}}),
            ("MARWIL", rllib.MARWILTrainer, {
                **guess4, "input": expert, "sgd_steps_per_iter": 24,
                "policy_config": {"seed": 0, "lr": 1e-2}}),
            ("BC", rllib.BCTrainer, {
                **guess4, "input": expert, "sgd_steps_per_iter": 24,
                "policy_config": {"seed": 0, "lr": 1e-2}}),
            ("DDPG", rllib.DDPGTrainer, {
                **replay_cont, "sgd_steps_per_iter": 32,
                "policy_config": {"seed": 0}}),
            ("TD3", rllib.TD3Trainer, {
                **replay_cont, "sgd_steps_per_iter": 32,
                "policy_config": {"seed": 0}}),
            ("CQL", rllib.CQLTrainer, {
                "env": TargetEnv, "num_workers": 2, "input": cont,
                "sgd_steps_per_iter": 64,
                "policy_config": {**sac_pc, "min_q_weight": 0.5}}),
            ("LinUCB", rllib.LinUCBTrainer, {
                "env": rllib.LinearBanditEnv, "num_workers": 2,
                "policy_config": {"seed": 0},
                "env_config": {"context_dim": 6, "num_arms": 4,
                               "seed": 5, "noise": 0.02}}),
            ("LinTS", rllib.LinTSTrainer, {
                "env": rllib.LinearBanditEnv, "num_workers": 2,
                "policy_config": {"seed": 0},
                "env_config": {"context_dim": 6, "num_arms": 4,
                               "seed": 5, "noise": 0.02}}),
            ("ES", rllib.ESTrainer, {
                "env": rllib.StatelessGuessEnv,
                "env_config": {"num_actions": 4, "seed": 7},
                "num_perturbations": 12, "episodes_per_perturbation": 8,
                "hidden": ()}),
            ("ARS", rllib.ARSTrainer, {
                "env": rllib.StatelessGuessEnv,
                "env_config": {"num_actions": 4, "seed": 7},
                "num_perturbations": 12, "episodes_per_perturbation": 8,
                "hidden": ()}),
            ("A3C", rllib.A3CTrainer, {
                "env": rllib.StatelessGuessEnv, "num_workers": 2,
                "rollout_fragment_length": 64, "grads_per_iter": 16,
                "policy_config": {"seed": 0, "lr": 5e-3},
                "env_config": {"num_actions": 4, "seed": 1}}),
            ("MultiAgent", rllib.MultiAgentTrainer, {
                "env": rllib.TwoStepGuessEnv,
                "env_config": {"num_actions": 3, "seed": 2},
                "num_workers": 2, "train_batch_size": 256,
                "policies": {"p0": (rllib.PGPolicy, {"lr": 2e-2}),
                             "p1": (rllib.PGPolicy, {"lr": 2e-2})},
                "policy_mapping_fn": _agent_to_policy}),
            ("QMix", rllib.QMixTrainer, {
                "env": rllib.TwoStepCoopEnv, "seed": 0}),
            ("VDN", rllib.VDNTrainer, {
                "env": rllib.TwoStepCoopEnv, "seed": 0})):
        runs[name] = (cls, cfg, two, None)

    out = {}
    for name, (cls, cfg, iters, check) in runs.items():
        t0 = time.monotonic()
        cls, made = _probed(cls)
        trainer = cls(cfg)
        try:
            results = [trainer.train() for _ in range(iters)]
            built = [p for p in (ref() for ref in made) if p is not None]
            holders = _rllib_holders(name, trainer)
            # the learner's policy and, on the thread tier, each rollout
            # worker's, built in this process
            holders.update({f"policy#{i}": p for i, p in enumerate(built)})
            off = sorted({f"{h}.{k}" for h, obj in holders.items()
                          for k in _off_card(obj)})
            res = results[-1]
            row = {"iterations": iters,
                   "reward": res.get("episode_reward_mean"),
                   "rewards": [r.get("episode_reward_mean")
                               for r in results],
                   "stats": res["info"]["learner"],
                   "finite": _finite_stats(res["info"]["learner"]),
                   "tensors_on": "host numpy (as the reference)"
                   if not holders else "cuda",
                   "off_device": off, "policies_checked": len(built),
                   "policies_expected": 1 + cfg.get("num_workers", 0)
                   if built else 0,
                   "s": time.monotonic() - t0}
            if check is not None:
                row["learned"] = bool(check(res, trainer))
        finally:
            trainer.stop()
        out[name] = row
    return out


def _probed(trainer_cls):
    """(a subclass of ``trainer_cls`` whose policy class records a weak
    reference to every instance, the list it records into). The thread
    tier builds each rollout worker's policy in this process, so the
    phase reads where the workers' tensors live, not only the learner's.
    The references are weak: a dead actor's record keeps its creation
    arguments (this policy class) until shutdown, and strong ones would
    keep every policy on the card through it. Trainers without
    a torch policy class (A3C, multi-agent, QMIX, the numpy ones) come
    back as they are."""
    base = getattr(trainer_cls, "_policy_cls", None)
    made: list = []
    if base is None or base.__module__.endswith(".policy_bandit"):
        return trainer_cls, made

    class Probe(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(weakref.ref(self))

    return type(trainer_cls.__name__, (trainer_cls,),
                {"_policy_cls": Probe}), made


def _agent_to_policy(aid: str) -> str:
    return "p0" if aid == "a0" else "p1"


def _rllib_holders(name: str, trainer) -> dict:
    """The objects whose tensors must be on the card: the learner's
    policy or policies, or QMIX's trainer itself; none for the numpy
    algorithms (bandits, ES, ARS)."""
    if name in ("LinUCB", "LinTS", "ES", "ARS"):
        return {}
    if name == "MultiAgent":
        return {pid: trainer.get_policy(pid) for pid in ("p0", "p1")}
    if name in ("QMix", "VDN"):
        return {name: trainer}
    return {"policy": trainer.get_policy()}


class _PPOClock:
    """Splits a PPOTrainer.train() into sampling (host clock around
    ``sample_parallel``) and learning (CUDA events and host clock around
    ``learn_on_batch``); the rest is the weight sync and metrics. Keeps
    the last batch learned on for ``_ppo_profile``."""

    def __init__(self, trainer):
        import torch

        self.sample_s = 0.0
        self.learn_s = 0.0
        self.learn_events = []
        self.last_batch = None
        ws = trainer.workers
        sample, learn = ws.sample_parallel, ws.local_worker.learn_on_batch

        def timed_sample(*a, **k):
            t0 = time.perf_counter()
            try:
                return sample(*a, **k)
            finally:
                self.sample_s += time.perf_counter() - t0

        def timed_learn(batch):
            self.last_batch = batch
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            t0 = time.perf_counter()
            try:
                return learn(batch)
            finally:
                ev[1].record()
                self.learn_events.append(ev)
                self.learn_s += time.perf_counter() - t0

        ws.sample_parallel = timed_sample
        ws.local_worker.learn_on_batch = timed_learn

    def take(self) -> dict:
        import torch

        torch.cuda.synchronize()
        out = {"sample_s": self.sample_s, "learn_s": self.learn_s,
               "learn_cuda_ms": sum(a.elapsed_time(b)
                                    for a, b in self.learn_events)}
        self.sample_s = self.learn_s = 0.0
        self.learn_events = []
        return out


def _union_us(spans) -> float:
    """Microseconds covered by the union of (start, end) spans."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def _ppo_profile(policy, batch) -> dict:
    """One learn_on_batch of the published-width policy on the last
    sampled batch, one SGD pass (``num_sgd_iter`` 1), under
    torch.profiler: wall time, the device's busy time (union of its
    kernel and copy spans), kernels and top-level ATen ops per update.
    None where the profiler saw no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    updates = -(-batch.count // policy.cfg["sgd_minibatch_size"])
    passes = policy.cfg["num_sgd_iter"]
    policy.cfg["num_sgd_iter"] = 1
    try:
        policy.learn_on_batch(batch)  # the same work, outside the trace
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            policy.learn_on_batch(batch)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    finally:
        policy.cfg["num_sgd_iter"] = passes
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    if not device:
        return None
    kernels = [e for e in device
               if not e.name.startswith(("Memcpy", "Memset"))]
    ops = [e for e in events if e.device_type == DeviceType.CPU
           and e.name.startswith("aten::") and e.cpu_parent is None]
    busy_s = _union_us((e.time_range.start, e.time_range.end)
                       for e in device) / 1e6
    return {"updates": updates, "wall_s": wall_s, "device_busy_s": busy_s,
            "device_busy_share": busy_s / wall_s,
            "kernels_per_update": len(kernels) / updates,
            "copies_per_update": (len(device) - len(kernels)) / updates,
            "aten_ops_per_update": len(ops) / updates,
            "device_us_per_update": busy_s * 1e6 / updates,
            "wall_ms_per_update": wall_s * 1e3 / updates}


def _rllib_published() -> dict:
    """PPOTrainer on CartPoleEnv at upstream RLlib's PPO widths
    (fcnet_hiddens [256, 256], train_batch_size 4000, sgd_minibatch_size
    128, num_sgd_iter 30) with two rollout workers; each train() split
    into sampling and learning, then one update pass traced."""
    from ray_tpu_torch import rllib

    p = RLLIB_PPO_PUBLISHED
    trainer = rllib.PPOTrainer({
        "env": rllib.CartPoleEnv, "num_workers": p["num_workers"],
        "train_batch_size": p["train_batch_size"],
        "policy_config": {"hidden": p["hidden"],
                          "sgd_minibatch_size": p["sgd_minibatch_size"],
                          "num_sgd_iter": p["num_sgd_iter"]}})
    try:
        clock = _PPOClock(trainer)
        iters = []
        for _ in range(p["iterations"]):
            t0 = time.perf_counter()
            res = trainer.train()
            row = {"train_s": time.perf_counter() - t0, **clock.take(),
                   "reward": res["episode_reward_mean"],
                   "timesteps_total": res["timesteps_total"],
                   "stats": res["info"]["learner"]}
            iters.append(row)
        off = _off_card(trainer.get_policy())
        traced = _ppo_profile(trainer.get_policy(), clock.last_batch)
    finally:
        trainer.stop()
    return {"config": {k: list(v) if isinstance(v, tuple) else v
                       for k, v in p.items()},
            "iterations": iters, "off_device": off, "profile": traced}


def _rllib_vision() -> dict:
    """vision_net at 84x84x4 (the catalog's default filters, hidden 256)
    on a minibatch of 128: forward + backward ms on the card (CUDA
    events) and its output and gradients against the CPU."""
    import numpy as np
    import torch

    from ray_tpu_torch.rllib import models
    from ray_tpu_torch.rllib.policy import (
        tree_leaves,
        tree_to_device,
        tree_to_numpy,
    )

    v = RLLIB_VISION
    init, apply = models.ModelCatalog.get_model(
        v["shape"], 4, {"post_fcnet_hiddens": v["hidden"]})
    weights = tree_to_numpy(init(torch.Generator().manual_seed(6),
                                 device="cpu"))
    x = np.random.default_rng(14).uniform(
        size=(v["batch"], *v["shape"])).astype(np.float32)

    def fwd_bwd(side):
        params = tree_to_device(weights, side)
        xs = torch.as_tensor(x, device=side)
        leaves = tree_leaves(params)

        def step():
            out = apply(params, xs)
            return out, torch.autograd.grad(out.square().mean(), leaves)

        return step

    step = fwd_bwd("cuda")
    ms = cuda_ms(step, v["iters"])
    out_c, g_c = step()
    out_h, g_h = fwd_bwd("cpu")()
    rel_out = _rel_l2(out_c.cpu(), out_h)
    rel_grads = max(_rel_l2(a.cpu(), b) for a, b in zip(g_c, g_h))
    return {"batch": v["batch"], "shape": list(v["shape"]),
            "hidden": v["hidden"], "fwd_bwd_ms": ms,
            "out_rel_l2": rel_out, "grads_rel_l2": rel_grads,
            "tol": RLLIB_VISION_REL_L2}


def _rllib_warm() -> None:
    """One iteration of a PPOTrainer with two rollout workers, stopped:
    every thread the phase multiplies on (the main thread, autograd's
    device thread, two workers' at once) has its cuBLAS handle and
    workspace before the phase's memory is read."""
    from ray_tpu_torch import rllib

    trainer = rllib.PPOTrainer({
        "env": rllib.StatelessGuessEnv, "num_workers": 2,
        "train_batch_size": 128, "env_config": {"num_actions": 4}})
    try:
        trainer.train()
    finally:
        trainer.stop()


def phase_rllib(report: dict) -> dict:
    """ray_tpu_torch.rllib on the card: every translated policy class,
    the QMIX/VDN networks and the catalog nets against their CPU copies;
    PPO, DQN and continuous SAC learning their test environments, every
    other trainer two iterations; PPO at upstream RLlib's published
    widths and vision_net at 84x84x4 timed; the card's memory back after
    the trainers stop. Launches none of K1-K3."""
    import gc
    import shutil

    import torch

    import ray_tpu_torch

    os.makedirs(RLLIB_DATA_DIR, exist_ok=True)
    ray_tpu_torch.init(num_cpus=8)
    try:
        _rllib_warm()
        gc.collect()
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        _reset_counts()
        t0 = time.monotonic()
        pairs = _rllib_policy_pairs()
        pairs.update(_rllib_qmix_pairs())
        catalog = _rllib_catalog_pairs()
        pairs_s = time.monotonic() - t0
        t0 = time.monotonic()
        learn = _rllib_learn(RLLIB_DATA_DIR)
        learn_s = time.monotonic() - t0
        published = _rllib_published()
        vision = _rllib_vision()
        counts, routes = _read_counts(), _read_routes()
        gc.collect()
        torch.cuda.synchronize()
        mem_after_stop = torch.cuda.memory_allocated()
    finally:
        ray_tpu_torch.shutdown()
        shutil.rmtree(RLLIB_DATA_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.synchronize()
    mem = {"before": mem_before, "after_stop": mem_after_stop,
           "after_shutdown": torch.cuda.memory_allocated(),
           "slack": RLLIB_MEM_SLACK}
    report["rllib"] = {"card_vs_cpu": pairs, "catalog": catalog,
                       "learn": learn, "published_ppo": published,
                       "vision": vision, "memory_bytes": mem,
                       "kernel_launches": counts, "pairs_s": pairs_s,
                       "learn_s": learn_s}
    card = card_line()
    print("rllib: card vs CPU, worst weight leaf rel L2 after "
          f"{RLLIB_UPDATES} updates: "
          + ", ".join(f"{k} {v['weights_rel_l2']:.3g}"
                      for k, v in pairs.items())
          + "; catalog (out / grads / weights): "
          + ", ".join(f"{k} {v['out_rel_l2']:.3g} / {v['grads_rel_l2']:.3g}"
                      f" / {v['weights_rel_l2']:.3g}"
                      for k, v in catalog.items())
          + " (vision_net's weights with fp32 convs; with TF32 "
          f"{catalog['vision_net']['tf32_weights_rel_l2']:.3g})"
          + f" [{card}]", flush=True)
    print("rllib: learning with 2 rollout workers: "
          + "; ".join(f"{k} {v['iterations']} it reward "
                      f"{v['reward'] if v['reward'] is None else round(v['reward'], 4)}"
                      f"{' learned' if v.get('learned') else ''} "
                      f"{v['s']:.1f} s" for k, v in learn.items())
          + "; policies read on the device (learner + workers): "
          + str(sum(v["policies_checked"] for v in learn.values()))
          + f" [{card}]", flush=True)
    for i, row in enumerate(published["iterations"]):
        print(f"rllib: PPO CartPole at published widths (256x256, batch "
              f"4000, minibatch 128, 30 SGD passes, 2 workers) iteration "
              f"{i + 1}: train {row['train_s']:.3f} s = sample "
              f"{row['sample_s']:.3f} s + learn {row['learn_s']:.3f} s "
              f"(CUDA events {row['learn_cuda_ms']:.1f} ms) + rest; reward "
              f"{row['reward']:.2f} [{card}]", flush=True)
    prof = published["profile"]
    print("rllib: one traced SGD pass at published widths: "
          + ("not measured (torch.profiler saw no device event)"
             if prof is None else
             f"{prof['updates']} updates in {prof['wall_s']:.4f} s, device "
             f"busy {prof['device_busy_s']:.4f} s "
             f"({prof['device_busy_share']:.4f}); an update "
             f"{prof['wall_ms_per_update']:.3f} ms wall, "
             f"{prof['device_us_per_update']:.1f} us on the device, "
             f"{prof['kernels_per_update']:.1f} kernels, "
             f"{prof['copies_per_update']:.1f} copies, "
             f"{prof['aten_ops_per_update']:.1f} top-level ATen ops")
          + f" [{card}]", flush=True)
    print(f"rllib: vision_net 84x84x4 batch {vision['batch']}: fwd+bwd "
          f"{vision['fwd_bwd_ms']:.4f} ms, rel L2 vs CPU out "
          f"{vision['out_rel_l2']:.3g} grads {vision['grads_rel_l2']:.3g}; "
          f"memory bytes {mem}; launches {counts} [{card}]", flush=True)

    problems = []
    for name, row in pairs.items():
        if not row["weights_rel_l2"] <= row["tol"]:
            problems.append(f"{name}: weights rel L2 "
                            f"{row['weights_rel_l2']} ({row['worst_leaf']})")
        if row["off_device"]:
            problems.append(f"{name}: off the card: {row['off_device']}")
    for name, row in catalog.items():
        for k in ("out", "grads", "weights"):
            if not row[f"{k}_rel_l2"] <= row["tol"][k]:
                problems.append(f"{name}: {k} rel L2 {row[f'{k}_rel_l2']}")
        if row["off_device"]:
            problems.append(f"{name}: params off the card")
    for name, row in learn.items():
        if not row["finite"]:
            problems.append(f"{name}: stats {row['stats']}")
        if row["off_device"]:
            problems.append(f"{name}: off the card: {row['off_device']}")
        if row.get("learned") is False:
            problems.append(f"{name}: did not learn: {row['rewards']}")
        if row["policies_checked"] != row["policies_expected"]:
            problems.append(f"{name}: {row['policies_checked']} policies "
                            f"seen, {row['policies_expected']} built")
    if published["off_device"] or not all(
            _finite_stats(r["stats"]) for r in published["iterations"]):
        problems.append(f"published PPO: {published}")
    for k in ("out", "grads"):
        if not vision[f"{k}_rel_l2"] <= RLLIB_VISION_REL_L2[k]:
            problems.append(f"vision_net 84x84x4: {k} rel L2 "
                            f"{vision[f'{k}_rel_l2']}")
    if mem["after_stop"] - mem["before"] > RLLIB_MEM_SLACK:
        problems.append(f"card memory {mem}")
    if any(counts.values()):
        problems.append(f"K1-K3 launched: {counts}")
    if problems:
        raise AssertionError("rllib: " + "; ".join(problems))
    return routes


# ------------------------------------------------------------------ main


# ------------------------------------------------------------ phase 11


def _to_card(tree):
    """A restored (CPU) train state on the card, tree for tree."""
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.to("cuda")
    if isinstance(tree, dict):
        return {k: _to_card(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_card(v) for v in tree)
    return tree


def _wf_note(ckpt_dir: str, **row) -> None:
    """A step's timings, appended to a file beside its checkpoints (a
    resumed workflow runs unpickled copies of the steps, so nothing in
    this process's memory would see them)."""
    with open(os.path.join(ckpt_dir, "steps.jsonl"), "a") as f:
        f.write(json.dumps(row) + "\n")


def wf_init_b1(ckpt_dir: str, seed: int) -> str:
    """Workflow step 1: b1's seeded weights and AdamW state, written with
    models/checkpoint.py as step 0 -> the directory."""
    import torch

    from ray_tpu_torch.models.checkpoint import CheckpointManager
    from ray_tpu_torch.models.training import build_train_step

    _, init_fn = build_train_step(_text_config("b1"), device="cuda")
    params, opt_state = init_fn(
        torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    t0 = time.monotonic()
    CheckpointManager(ckpt_dir, max_to_keep=None).save(
        0, {"params": params, "opt_state": opt_state})
    _wf_note(ckpt_dir, step="init_b1", write_s=time.monotonic() - t0)
    return ckpt_dir


def wf_train_b1(prev, steps: int, fail_marker: str = ""):
    """Workflow steps 2 and 3: ``steps`` b1 train steps at TRAIN_TOKENS
    from the latest checkpoint, saved as the next -> (directory, every
    loss so far). With ``fail_marker`` it raises on its first attempt,
    before it touches the card."""
    import torch

    from ray_tpu_torch.models.checkpoint import CheckpointManager
    from ray_tpu_torch.models.training import build_train_step

    if fail_marker and not os.path.exists(fail_marker):
        open(fail_marker, "w").close()
        raise RuntimeError("train_b1 dies on its first attempt")
    ckpt_dir, losses = (prev, []) if isinstance(prev, str) else prev
    ckpt = CheckpointManager(ckpt_dir, max_to_keep=None, create=False)
    done = ckpt.latest_step()
    t0 = time.monotonic()
    state = _to_card(ckpt.restore(done))
    torch.cuda.synchronize()
    read_s = time.monotonic() - t0
    step, _ = build_train_step(_text_config("b1"), device="cuda")
    params, opt_state = state["params"], state["opt_state"]
    tokens = torch.as_tensor(_train_batch("b1"), device="cuda")
    step_s = []
    for _ in range(steps):
        t0 = time.monotonic()
        params, opt_state, metrics = step(params, opt_state, tokens)
        losses = losses + [metrics["loss"].item()]
        step_s.append(time.monotonic() - t0)
    t0 = time.monotonic()
    ckpt.save(done + steps, {"params": params, "opt_state": opt_state})
    _wf_note(ckpt_dir, step=f"train_b1 {done}->{done + steps}",
             read_s=read_s, step_s=step_s, write_s=time.monotonic() - t0)
    return ckpt_dir, losses


def wf_serve_b1(prev, prompts):
    """Workflow step 4: the trained b1 serves ``prompts`` [2, 2048]
    through K1 -> (the losses, the last-position logits [2, 32000] fp32
    on the card, so that the stored result carries a device)."""
    import torch

    from ray_tpu_torch.models.checkpoint import CheckpointManager
    from ray_tpu_torch.models.training import build_forward

    ckpt_dir, losses = prev
    ckpt = CheckpointManager(ckpt_dir, max_to_keep=None, create=False)
    t0 = time.monotonic()
    params = _to_card(ckpt.restore(ckpt.latest_step())["params"])
    torch.cuda.synchronize()
    read_s = time.monotonic() - t0
    fwd = build_forward(_text_config("b1"), device="cuda")
    t0 = time.monotonic()
    # a copy: a view would pickle the whole [2, 2048, 32000] logits
    logits = fwd(params, prompts)[:, -1].clone()
    torch.cuda.synchronize()
    _wf_note(ckpt_dir, step="serve_b1", read_s=read_s,
             forward_s=time.monotonic() - t0)
    return losses, logits


def _wf_dag(workflow, ckpt_dir: str, fail_marker: str):
    """init_b1 -> train_b1 (2) -> train_b1 (2, dies once) -> serve_b1."""
    import numpy as np

    prompts = np.random.default_rng(13).integers(
        0, _text_config("b1").vocab_size, size=WORKFLOW_PROMPTS)
    init, train, serve = (workflow.step(f) for f in (
        wf_init_b1, wf_train_b1, wf_serve_b1))
    first = train.step(init.step(ckpt_dir, 0), WORKFLOW_STEPS)
    second = train.options(max_retries=0).step(first, WORKFLOW_STEPS,
                                                fail_marker)
    return serve.step(second, prompts)


def _du(root: str) -> int:
    """Bytes of the files under ``root``."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(root) for f in fs)


def _wf_notes(ckpt_dir: str) -> list:
    with open(os.path.join(ckpt_dir, "steps.jsonl")) as f:
        return [json.loads(line) for line in f]


def phase_workflow(report: dict) -> dict:
    """A durable b1 workflow (ray_tpu_torch.workflow) on the card: the
    DAG's third step dies on its first attempt, resume finishes the run
    from the stored outputs of the first two, and its losses and logits
    are bit-equal to an uninterrupted run of the same DAG under another
    id; the resumed run launches K1-K3 for the unfinished steps alone."""
    import shutil

    import torch

    import ray_tpu_torch
    from ray_tpu_torch import workflow
    from ray_tpu_torch.core import runtime as rt_mod

    cfg = _text_config("b1")
    root = os.path.abspath(WORKFLOW_DIR)
    shutil.rmtree(root, ignore_errors=True)
    per_step = {"fwd": 2 * cfg.layers, "dq": cfg.layers, "dkdv": cfg.layers}

    def want(train_steps: int, serves: int) -> dict:
        return {k: n * train_steps + (cfg.layers * serves if k == "fwd"
                                      else 0)
                for k, n in per_step.items()}

    runs = {}
    try:
        # with no runtime up, workflow.init starts the port's, on CUDA
        workflow.init(storage=os.path.join(root, "storage"))
        if rt_mod.global_runtime.device.type != "cuda":
            raise AssertionError("workflow.init did not start the runtime "
                                 "on CUDA")
        node = _wf_dag(workflow, os.path.join(root, "resumed"),
                       os.path.join(root, "attempted"))
        _reset_counts()
        t0 = time.monotonic()
        try:
            node.run("b1-resumed")
        except Exception as exc:  # the third step's first attempt
            if "first attempt" not in str(exc):
                raise
        else:
            raise AssertionError("workflow: the failing step did not fail")
        runs["failed"] = (time.monotonic() - t0, _read_counts(),
                          _read_routes())
        status_failed = workflow.get_status("b1-resumed")
        _reset_counts()
        t0 = time.monotonic()
        resumed = workflow.resume("b1-resumed")
        runs["resumed"] = (time.monotonic() - t0, _read_counts(),
                           _read_routes())
        stored = workflow.get_output("b1-resumed")
        status_resumed = workflow.get_status("b1-resumed")
        # the result holds what the checks compare; the checkpoints go
        # before the next run writes its own
        notes = {"resumed": _wf_notes(os.path.join(root, "resumed"))}
        disk = {"after_resume": _du(root)}
        shutil.rmtree(os.path.join(root, "resumed"))

        node = _wf_dag(workflow, os.path.join(root, "uninterrupted"), "")
        _reset_counts()
        t0 = time.monotonic()
        whole = node.run("b1-uninterrupted")
        runs["uninterrupted"] = (time.monotonic() - t0, _read_counts(),
                                 _read_routes())
        listed = sorted(workflow.list_all())
        notes["uninterrupted"] = _wf_notes(os.path.join(root,
                                                        "uninterrupted"))
        disk["after_uninterrupted"] = _du(root)
        ckpt_bytes = _du(os.path.join(root, "uninterrupted", "0"))
    finally:
        workflow.set_global_storage(None)
        ray_tpu_torch.shutdown()
        shutil.rmtree(root, ignore_errors=True)

    for name, train_steps, serves in (("failed", WORKFLOW_STEPS, 0),
                                      ("resumed", WORKFLOW_STEPS, 1),
                                      ("uninterrupted", 2 * WORKFLOW_STEPS,
                                       1)):
        _check_launches(f"workflow {name} run", runs[name][1], runs[name][2],
                        want(train_steps, serves), cfg.head_dim)
    losses, logits = resumed
    if status_failed != "FAILED" or status_resumed != "SUCCESSFUL" or \
            listed != ["b1-resumed", "b1-uninterrupted"]:
        raise AssertionError(f"workflow: statuses {status_failed} -> "
                             f"{status_resumed}, listed {listed}")
    if len(losses) != 2 * WORKFLOW_STEPS or not all(
            math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"workflow: losses not finite and falling: "
                             f"{losses}")
    if logits.device.type != "cuda" or stored[1].device.type != "cuda" or \
            tuple(logits.shape) != (WORKFLOW_PROMPTS[0], cfg.vocab_size) or \
            not torch.isfinite(logits).all():
        raise AssertionError(f"workflow: result logits {logits.device} "
                             f"{tuple(logits.shape)}, stored on "
                             f"{stored[1].device}")
    bit_equal = (losses == whole[0] and torch.equal(logits, whole[1])
                 and stored[0] == losses and torch.equal(stored[1], logits))
    if not bit_equal:
        raise AssertionError(
            f"workflow: the resumed run is not the uninterrupted one: losses "
            f"{losses} vs {whole[0]}, logits max diff "
            f"{(logits - whole[1]).abs().max().item():.3g}")
    trains = [n for n in notes["uninterrupted"]
              if n["step"].startswith("train")]
    step_s = [s for n in trains for s in n["step_s"][1:]]
    out = {
        "model": MODEL_DESC["b1"] + ", remat full",
        "dag": f"init_b1 -> train_b1 ({WORKFLOW_STEPS} steps at "
               f"{list(TRAIN_TOKENS)}) -> train_b1 ({WORKFLOW_STEPS}, dies "
               f"on its first attempt) -> serve_b1 ({list(WORKFLOW_PROMPTS)})",
        "run_s": {k: v[0] for k, v in runs.items()},
        "kernel_launches": {k: v[1] for k, v in runs.items()},
        "losses": losses, "steps": notes, "checkpoint_bytes": ckpt_bytes,
        "disk_bytes": disk, "peak_disk_bytes": max(disk.values()),
        "bit_equal_to_uninterrupted": bit_equal,
        "result_device": str(stored[1].device),
    }
    report["workflow"] = out
    writes = [n["write_s"] for n in notes["uninterrupted"] if "write_s" in n]
    reads = [n["read_s"] for n in notes["uninterrupted"] if "read_s" in n]
    print(f"workflow: on {report.get('card')}: b1 DAG {out['dag']}: failed "
          f"run {runs['failed'][0]:.2f} s, resume {runs['resumed'][0]:.2f} "
          f"s, uninterrupted {runs['uninterrupted'][0]:.2f} s; launches "
          f"failed/resumed/uninterrupted {[runs[k][1] for k in runs]}; "
          f"losses {[round(x, 5) for x in losses]} bit-equal to the "
          f"uninterrupted run's, logits too, result on {stored[1].device}; "
          f"checkpoint {ckpt_bytes / 2**30:.2f} GiB (peak disk "
          f"{max(disk.values()) / 2**30:.2f} GiB): writes s "
          f"{[round(x, 3) for x in writes]}, reads s "
          f"{[round(x, 3) for x in reads]}; steady train step "
          f"{sum(step_s) / len(step_s):.4f} s", flush=True)
    return _merge_routes(*(v[2] for v in runs.values()))


# ------------------------------------------------------------ phase 12


def phase_persist(report: dict) -> dict:
    """A detached, named b1 actor comes back from a GCS snapshot
    (ray_tpu_torch.gcs.persistence): save_snapshot, shutdown (the card's
    memory back within PERSIST_MEM_SLACK), init, restore_snapshot; the
    restored actor, found by name, serves the serve phase's prompts with
    last-position logits bit-equal to the serve phase's."""
    import gc
    import shutil

    import numpy as np
    import torch

    import ray_tpu_torch
    from ray_tpu_torch.gcs import persistence

    want_last = report.get("_serve_last_logits")
    if want_last is None:
        raise AssertionError("persist needs the serve phase's logits")
    cfg = _text_config("b1")
    rng = np.random.default_rng(0)  # the serve phase's tokens
    batches = [rng.integers(0, cfg.vocab_size, size=SERVE_TOKENS)
               for _ in range(SERVE_REQUESTS)]
    os.makedirs(PERSIST_DIR, exist_ok=True)
    path = os.path.join(PERSIST_DIR, "gcs_snapshot.bin")
    gc.collect()
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    try:
        ray_tpu_torch.init(num_cpus=4, num_gpus=1)
        server = ray_tpu_torch.remote(num_gpus=1)(ProcServer).options(
            name="b1-server", lifetime="detached").remote(0, "b1")
        _reset_counts()
        before = [ray_tpu_torch.get(server.forward_last.remote(t))
                  for t in batches[:1]]
        first_counts, first_routes = _read_counts(), _read_routes()
        mem_serving = torch.cuda.memory_allocated()
        t0 = time.monotonic()
        persistence.save_snapshot(path)
        save_s = time.monotonic() - t0
        del server
        ray_tpu_torch.shutdown()
        gc.collect()
        torch.cuda.synchronize()
        mem_down = torch.cuda.memory_allocated()

        ray_tpu_torch.init(num_cpus=4, num_gpus=1)
        t0 = time.monotonic()
        counts = persistence.restore_snapshot(path)
        restored = ray_tpu_torch.get_actor("b1-server")
        # constructed (its weights' kernels enqueued, not yet run)
        ray_tpu_torch.get(restored.pid.remote())
        restore_s = time.monotonic() - t0
        _reset_counts()
        last, latencies = [], []
        for tokens in batches:
            t0 = time.monotonic()
            last.append(ray_tpu_torch.get(
                restored.forward_last.remote(tokens)))
            latencies.append(time.monotonic() - t0)
        main_counts, main_routes = _read_counts(), _read_routes()
        ray_tpu_torch.kill(restored)
        del restored
    finally:
        ray_tpu_torch.shutdown()
        size = os.path.getsize(path) if os.path.exists(path) else None
        shutil.rmtree(PERSIST_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.synchronize()
    mem_after = torch.cuda.memory_allocated()
    _check_launches("persist (before the snapshot)", first_counts,
                    first_routes, {"fwd": cfg.layers, "dq": 0, "dkdv": 0},
                    cfg.head_dim)
    _check_launches("persist (the restored actor)", main_counts,
                    main_routes, {"fwd": cfg.layers * SERVE_REQUESTS,
                                  "dq": 0, "dkdv": 0}, cfg.head_dim)
    if counts["actors"] != 1:
        raise AssertionError(f"persist: restore counts {counts}")
    if mem_serving - mem_before < 2 << 30 or \
            mem_down - mem_before > PERSIST_MEM_SLACK or \
            mem_after - mem_before > PERSIST_MEM_SLACK:
        raise AssertionError(
            f"persist: card memory allocated before {mem_before}, serving "
            f"{mem_serving}, after shutdown {mem_down}, at the end "
            f"{mem_after} (slack {PERSIST_MEM_SLACK})")
    equal = [bool(np.array_equal(g, w)) for g, w in zip(last, want_last)]
    if not all(equal) or not np.array_equal(before[0], want_last[0]):
        raise AssertionError(f"persist: the restored actor's logits are not "
                             f"the serve phase's bit for bit ({equal})")
    report["persist"] = {
        "model": MODEL_DESC["b1"], "snapshot_bytes": size,
        "save_s": save_s, "restore_s": restore_s, "restore_counts": counts,
        "latency_s": latencies,
        "memory_bytes": {"before": mem_before, "serving": mem_serving,
                         "after_shutdown": mem_down, "after": mem_after,
                         "slack": PERSIST_MEM_SLACK},
        "kernel_launches": main_counts, "bit_equal_to_serve": equal,
    }
    print(f"persist: on {report.get('card')}: detached b1 actor snapshot "
          f"{size} bytes, saved in {save_s * 1e3:.2f} ms; after shutdown "
          f"the card holds {mem_down - mem_before} bytes more than before "
          f"(serving: {(mem_serving - mem_before) / 2**30:.2f} GiB); "
          f"restored (re-created from its class and arguments, a first "
          f"call answered) in {restore_s * 1e3:.2f} ms; {SERVE_REQUESTS} "
          f"requests, latency s {[round(x, 4) for x in latencies]} (the "
          f"first includes the weights' draw), K1 "
          f"{main_routes['fwd']}; logits bit-equal to the serve phase's",
          flush=True)
    return _merge_routes(first_routes, main_routes)


# ------------------------------------------------------------ phase 13


def _median(xs: list) -> float:
    return sorted(xs)[len(xs) // 2]


def phase_client(report: dict) -> dict:
    """b1 served over ray://: a ``python -m ray_tpu_torch.util.client.
    server`` process on the card, this process a pure client
    (init(address=...)); the actor's last-position logits come back in
    client frames as CUDA tensors, bit-equal to the serve phase's; K1
    counted in the server's process; CLIENT_REQUESTS round trips against
    as many direct calls to the same actor class in a local runtime,
    shut down before client mode; the server killed and its card memory
    freed."""
    import numpy as np
    import torch

    import ray_tpu_torch
    import ray_tpu_torch.core.api as api

    want_last = report.get("_serve_last_logits")
    if want_last is None:
        raise AssertionError("client needs the serve phase's logits")
    if ray_tpu_torch.is_initialized():
        raise AssertionError("client: a local runtime is up")
    cfg = _text_config("b1")
    rng = np.random.default_rng(0)  # the serve phase's tokens
    batches = [rng.integers(0, cfg.vocab_size, size=SERVE_TOKENS)
               for _ in range(SERVE_REQUESTS)]

    def serve(server) -> tuple:
        """CLIENT_REQUESTS requests after a first forward -> (round trips
        s, replies, launches, routes)."""
        ray_tpu_torch.get(server.forward_last_card.remote(
            batches[0][:, :16]))  # the first forward, as serve's probe
        ray_tpu_torch.get(server.reset_counts.remote())
        latencies, last = [], []
        for i in range(CLIENT_REQUESTS):
            t = time.monotonic()
            last.append(ray_tpu_torch.get(server.forward_last_card.remote(
                batches[i % SERVE_REQUESTS])))
            latencies.append(time.monotonic() - t)
        return (latencies, last, *ray_tpu_torch.get(server.counts.remote()))

    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    try:
        local = ray_tpu_torch.remote(num_gpus=1)(ProcServer).remote(0, "b1")
        direct, direct_last, direct_counts, direct_routes = serve(local)
        direct_last = [t.cpu().numpy() for t in direct_last]
        ray_tpu_torch.kill(local)
        del local
    finally:
        ray_tpu_torch.shutdown()
    torch.cuda.synchronize()
    free_before = torch.cuda.mem_get_info()[0]
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.util.client.server",
         "--init-kwargs", json.dumps({"num_cpus": 4, "num_gpus": 1})],
        stdout=subprocess.PIPE, text=True, cwd=root,
        env=dict(os.environ, PYTHONPATH=root))
    try:
        t0 = time.monotonic()
        line = proc.stdout.readline().strip()
        if not line.startswith("CLIENT_SERVER_ADDRESS "):
            raise AssertionError(f"client: the server said {line!r}")
        address = line.split()[1]
        server_up_s = time.monotonic() - t0
        threading.Thread(target=proc.stdout.read, daemon=True).start()
        ray_tpu_torch.init(address=address)
        if api._client() is None:
            raise AssertionError("client: init(address=...) is not in "
                                 "client mode")
        t0 = time.monotonic()
        server = ray_tpu_torch.remote(num_gpus=1)(ProcServer).remote(0, "b1")
        server_pid = ray_tpu_torch.get(server.pid.remote())
        actor_up_s = time.monotonic() - t0
        latencies, last, counts, routes = serve(server)
        torch.cuda.synchronize()
        free_serving = torch.cuda.mem_get_info()[0]
        ray_tpu_torch.kill(server)
        ray_tpu_torch.shutdown()
        if api._client() is not None or ray_tpu_torch.is_initialized():
            raise AssertionError("client: shutdown left a connection or a "
                                 "local runtime")
    finally:
        if api._client() is not None:
            ray_tpu_torch.shutdown()
        proc.kill()
        proc.wait(timeout=30)
    devices = {str(t.device) for t in last}
    last_np = [t.cpu().numpy() for t in last]
    del last
    deadline = time.monotonic() + 30
    while True:  # the server's context goes with its process
        torch.cuda.synchronize()
        free_after = torch.cuda.mem_get_info()[0]
        if free_before - free_after <= CLIENT_MEM_SLACK or \
                time.monotonic() > deadline:
            break
        time.sleep(0.2)
    if server_pid != proc.pid:
        raise AssertionError(f"client: the actor ran in pid {server_pid}, "
                             f"not the server's {proc.pid}")
    want = {"fwd": cfg.layers * CLIENT_REQUESTS, "dq": 0, "dkdv": 0}
    _check_launches("client (direct)", direct_counts, direct_routes, want,
                    cfg.head_dim)
    _check_launches("client (in the server)", counts, routes, want,
                    cfg.head_dim)
    if devices != {"cuda:0"}:
        raise AssertionError(f"client: logits came back on {devices}")
    equal = [bool(np.array_equal(g, want_last[i % SERVE_REQUESTS]) and
                  np.array_equal(d, want_last[i % SERVE_REQUESTS]))
             for i, (g, d) in enumerate(zip(last_np, direct_last))]
    if not all(equal):
        raise AssertionError(f"client: logits over ray:// or direct are not "
                             f"the serve phase's bit for bit ({equal})")
    if free_before - free_serving < 2 << 30 or \
            free_before - free_after > CLIENT_MEM_SLACK:
        raise AssertionError(
            f"client: card memory free before the server {free_before}, "
            f"while it served {free_serving}, after its kill {free_after} "
            f"(slack {CLIENT_MEM_SLACK})")
    report["client"] = {
        "model": MODEL_DESC["b1"], "server_up_s": server_up_s,
        "actor_up_s": actor_up_s, "latency_s": latencies,
        "direct_latency_s": direct,
        "median_s": {"ray": _median(latencies), "direct": _median(direct)},
        "kernel_launches": counts, "kernel_launches_by_route": routes,
        "logits_device": sorted(devices), "bit_equal_to_serve": equal,
        "card_free_bytes": {"before": free_before, "serving": free_serving,
                            "after_kill": free_after,
                            "slack": CLIENT_MEM_SLACK},
    }
    print(f"client: on {report.get('card')}: server process up in "
          f"{server_up_s:.2f} s, b1 actor over ray:// in {actor_up_s:.2f} s; "
          f"{CLIENT_REQUESTS} requests of {list(SERVE_TOKENS)} each side, "
          f"round trip s over ray:// median {_median(latencies):.4f} (range "
          f"{min(latencies):.4f}-{max(latencies):.4f}), direct actor call "
          f"median {_median(direct):.4f} ({min(direct):.4f}-"
          f"{max(direct):.4f}); K1 in the server {routes['fwd']}; logits on "
          f"{sorted(devices)}, bit-equal to the serve phase's; card free GiB "
          f"before / serving / after the kill {free_before / 2**30:.2f} / "
          f"{free_serving / 2**30:.2f} / {free_after / 2**30:.2f}",
          flush=True)
    return routes


# ------------------------------------------------------------ phase 14


class QueueServer(ProcServer):
    """b1 on the card draining a util.queue.Queue of [2048] token rows
    in batches of up to UTIL_MAX_BATCH, one forward a batch."""

    def drain(self, queue):
        import numpy as np

        answers, sizes = [], []
        while n := queue.qsize():
            rows = queue.get_nowait_batch(min(UTIL_MAX_BATCH, n))
            last = self.forward(np.stack(rows))[:, -1].float().cpu()
            answers.extend(last.numpy())
            sizes.append(len(rows))
        return answers, sizes


def phase_util(report: dict) -> dict:
    """ray_tpu_torch.util on the card: seeded prompt rows through
    util.iter.from_items(..., num_shards=2).gather_sync() into a
    util.queue.Queue; a b1 actor drains it in batches of up to
    UTIL_MAX_BATCH through K1; every answer bit-equal to the row served
    alone at batch 1. Then the queue's rate: QUEUE_OPS host puts of a
    row into a fresh Queue, then as many gets, each timed as one window,
    the gets in the order of the puts."""
    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch.util import iter as rti
    from ray_tpu_torch.util.queue import Queue

    cfg = _text_config("b1")
    rows = np.random.default_rng(0).integers(
        0, cfg.vocab_size, size=(UTIL_ROWS, SERVE_LIB["seq"]))
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    try:
        server = ray_tpu_torch.remote(num_gpus=1)(QueueServer).remote(0)
        ray_tpu_torch.get(server.forward_last.remote(rows[:1, :16]))
        _reset_counts()
        t0 = time.monotonic()
        fed = list(rti.from_items(list(rows), num_shards=2).gather_sync())
        queue = Queue()
        for row in fed:
            queue.put(row)
        answers, sizes = ray_tpu_torch.get(server.drain.remote(queue))
        run_s = time.monotonic() - t0
        counts, routes = _read_counts(), _read_routes()
        queue.shutdown()
        reference = [ray_tpu_torch.get(server.forward_last.remote(r[None]))[0]
                     for r in fed]
        ray_tpu_torch.kill(server)

        queue = Queue()
        t0 = time.monotonic()
        for i in range(QUEUE_OPS):
            queue.put(rows[i % UTIL_ROWS])
        put_s = time.monotonic() - t0
        t0 = time.monotonic()
        got = [queue.get() for _ in range(QUEUE_OPS)]
        get_s = time.monotonic() - t0
        queue.shutdown()
    finally:
        ray_tpu_torch.shutdown()
    if sorted(map(tuple, fed)) != sorted(map(tuple, rows)) or \
            len(answers) != UTIL_ROWS or max(sizes) > UTIL_MAX_BATCH or \
            max(sizes) < 2:
        raise AssertionError(f"util: {len(fed)} rows fed, {len(answers)} "
                             f"answers in batches {sizes}")
    _check_launches("util", counts, routes,
                    {"fwd": cfg.layers * len(sizes), "dq": 0, "dkdv": 0},
                    cfg.head_dim)
    equal = [bool(np.array_equal(a, r)) for a, r in zip(answers, reference)]
    if not all(equal):
        rel = max(float(np.linalg.norm(a - r) / np.linalg.norm(r))
                  for a, r in zip(answers, reference))
        raise AssertionError(f"util: batched answers not bit-equal to batch "
                             f"1 ({sum(equal)} of {len(equal)}; worst rel L2 "
                             f"{rel:.3g})")
    if not all(np.array_equal(g, rows[i % UTIL_ROWS])
               for i, g in enumerate(got)):
        raise AssertionError("util: the queue's gets are not its puts in "
                             "order")
    report["util"] = {
        "model": MODEL_DESC["b1"], "rows": UTIL_ROWS,
        "batch_sizes": sizes, "run_s": run_s,
        "queue_ops": QUEUE_OPS, "queue_put_s": put_s, "queue_get_s": get_s,
        "queue_puts_per_s": QUEUE_OPS / put_s,
        "queue_gets_per_s": QUEUE_OPS / get_s,
        "kernel_launches": counts, "kernel_launches_by_route": routes,
        "bit_equal_to_batch1": equal,
    }
    print(f"util: on {report.get('card')}: {UTIL_ROWS} rows of "
          f"[{SERVE_LIB['seq']}] through from_items(num_shards=2)."
          f"gather_sync() into a Queue, drained by a b1 actor in batches "
          f"{sizes} in {run_s:.3f} s; K1 {routes['fwd']}; all answers "
          f"bit-equal to batch 1; {QUEUE_OPS} host puts of a row in "
          f"{put_s:.3f} s ({QUEUE_OPS / put_s:.1f} puts/s), as many gets in "
          f"{get_s:.3f} s ({QUEUE_OPS / get_s:.1f} gets/s), in order",
          flush=True)
    return routes


# ------------------------------------------------------------ phase 15

# the package a py_modules task imports on the gpu node and the jobs
# import from PYTHONPATH: b1 at full width and depth from a seed on the
# card, the serve phase's prompts, its probe, then the requests
OPS_PACKAGE = '''"""b1 served through K1 on the card (chip_smoke.py's ops phase)."""

import os

import numpy as np


def prompts(vocab_size, requests=4, shape=(2, 2048)):
    """The serve phase's seeded prompts."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab_size, size=shape) for _ in range(requests)]


class B1Server:
    def __init__(self, seed=0):
        import torch

        from ray_tpu_torch.models import transformer as tfm
        from ray_tpu_torch.models.training import build_forward

        self.cfg = tfm.ModelConfig.b1()
        gen = torch.Generator(device="cuda").manual_seed(seed)
        self.params = tfm.init_params(self.cfg, gen, device="cuda")
        self.fwd = build_forward(self.cfg, device="cuda")

    def forward_last(self, tokens):
        """The last position's logits, a copy: a view would carry the
        whole [2, 2048, 32000] logits when pickled."""
        import torch

        logits = self.fwd(self.params, tokens)
        torch.cuda.current_stream().synchronize()
        return logits[:, -1].clone()

    def serve(self, batches):
        """The serve phase's probe, then one forward a batch -> (last
        logits, K1-K3 launches, by route), counted in this process."""
        from ray_tpu_torch.ops import attention

        counters = {"fwd": attention.launches, "dq": attention.dq_launches,
                    "dkdv": attention.dkdv_launches}
        self.forward_last(batches[0][:, :16])
        for counter in counters.values():
            counter.reset()
        last = [self.forward_last(tokens) for tokens in batches]
        return (last, {k: c.count for k, c in counters.items()},
                {k: c.by_route for k, c in counters.items()})


def serve_b1(batches):
    """A task's whole b1 server: build, serve, report where it ran."""
    last, counts, routes = B1Server(0).serve(batches)
    return {"last": last, "counts": counts, "routes": routes,
            "tag": os.environ.get("B1_TAG"), "module": __file__,
            "pid": os.getpid(),
            "visible": os.environ.get("CUDA_VISIBLE_DEVICES")}
'''

# job 1: the port's runtime on the card, b1 served by an actor
OPS_SERVE_JOB = '''import json
import sys

import numpy as np

import b1_ops_serving
import ray_tpu_torch
from ray_tpu_torch.models.transformer import ModelConfig

ray_tpu_torch.init(num_cpus=2, num_gpus=1)
server = ray_tpu_torch.remote(num_gpus=1)(b1_ops_serving.B1Server).remote(0)
batches = b1_ops_serving.prompts(ModelConfig.b1().vocab_size)
last, counts, routes = ray_tpu_torch.get(server.serve.remote(batches),
                                         timeout=600)
np.save(sys.argv[1], np.stack([t.float().cpu().numpy() for t in last]))
print("OPS_JOB_LAUNCHES " + json.dumps({"counts": counts,
                                        "routes": routes}), flush=True)
ray_tpu_torch.shutdown()
'''

# job 2: b1 loaded on the card, then a wait until it is stopped. The job
# manager uploads a job's log every 20 lines: 20 lines say it is loaded
OPS_HOLD_JOB = '''import time

import b1_ops_serving
import ray_tpu_torch
from ray_tpu_torch.models.transformer import ModelConfig

ray_tpu_torch.init(num_cpus=2, num_gpus=1)
server = ray_tpu_torch.remote(num_gpus=1)(b1_ops_serving.B1Server).remote(0)
ray_tpu_torch.get(server.forward_last.remote(
    b1_ops_serving.prompts(ModelConfig.b1().vocab_size, 1)[0][:, :16]))
for i in range(20):
    print(f"OPS_B1_LOADED {i}", flush=True)
time.sleep(600)
'''


def _ops_task(batches):
    """A cluster task: its b1 serving code comes from py_modules."""
    import b1_ops_serving

    return b1_ops_serving.serve_b1(batches)


def _wait_for(predicate, timeout: float, what: str) -> float:
    """Poll until ``predicate()`` -> the seconds it took."""
    t0 = time.monotonic()
    while not predicate():
        if time.monotonic() - t0 > timeout:
            raise AssertionError(f"ops: timed out waiting for {what}")
        time.sleep(0.05)
    return time.monotonic() - t0


def _free_card_bytes() -> int:
    import torch

    torch.cuda.synchronize()
    return torch.cuda.mem_get_info()[0]


def _ops_cli(root: str, *argv) -> str:
    """``python -m ray_tpu_torch ...`` -> its output; it must exit 0."""
    proc = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch", *argv], cwd=root,
        env=dict(os.environ, PYTHONPATH=root), capture_output=True,
        text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"ops: `{' '.join(argv)}` exited "
                             f"{proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout


def phase_ops(report: dict) -> dict:
    """The cluster operator's surface on the card: ``ray up`` (the
    process provider, its GCS on CUDA); a pending {"GPU": 1} bundle makes
    the autoscaler launch one gpu node; a task there imports its b1
    serving code from py_modules (staged by the raylet from the GCS KV)
    and serves through K1; the idle node goes; two submitted jobs (b1
    served by an actor of the job's own runtime; b1 loaded, then
    stopped); the CLI on the cluster; ``down``; the microbenchmark."""
    import shutil

    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch._private import runtime_env_packaging as pkg
    from ray_tpu_torch._private.runtime_env import normalize
    from ray_tpu_torch.autoscaler.commands import (
        _state_path,
        create_or_update_cluster,
        teardown_cluster,
    )
    from ray_tpu_torch.cluster.byte_store import sweep_stale_segments
    from ray_tpu_torch.cluster.job_manager import JobSubmissionClient
    from ray_tpu_torch.cluster.process_cluster import ClusterClient

    want_last = report.get("_serve_last_logits")
    if want_last is None:
        raise AssertionError("ops needs the serve phase's logits")
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    cfg = _text_config("b1")
    rng = np.random.default_rng(0)  # the serve phase's tokens
    batches = [rng.integers(0, cfg.vocab_size, size=SERVE_TOKENS)
               for _ in range(SERVE_REQUESTS)]
    want = {"fwd": cfg.layers * SERVE_REQUESTS, "dq": 0, "dkdv": 0}
    root = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(root, OPS_DIR)
    shutil.rmtree(work, ignore_errors=True)
    pkg_dir = os.path.join(work, "b1_pkg")
    os.makedirs(pkg_dir)
    with open(os.path.join(pkg_dir, "b1_ops_serving.py"), "w") as f:
        f.write(OPS_PACKAGE)
    for name, src in (("serve_job.py", OPS_SERVE_JOB),
                      ("hold_job.py", OPS_HOLD_JOB)):
        with open(os.path.join(work, name), "w") as f:
            f.write(src)
    # the servers' module cache is not this process's: the package
    # reaches the gpu node only through the GCS KV
    node_cache = os.path.join(work, "node_cache")
    env_keys = {"RAY_TPU_WORKER_CUDA_VISIBLE_DEVICES": "0",
                "RAY_TPU_PY_MODULES_CACHE": node_cache,
                "RAY_TPU_object_store_memory": str(CLUSTER_STORE_BYTES)}
    saved_env = {k: os.environ.get(k) for k in env_keys}
    saved_manager = pkg._default
    os.environ.update(env_keys)
    pkg._default = pkg.PyModulesManager(
        cache_root=os.path.join(work, "client_cache"))
    free_before = _free_card_bytes()
    name = "ops"
    config = {
        "cluster_name": name, "provider": {"type": "process"},
        "head_node_type": "head", "idle_timeout_minutes": OPS_IDLE_S / 60,
        "available_node_types": {
            "head": {"resources": {"CPU": 2}, "min_workers": 0,
                     "max_workers": 0},
            "gpu": {"resources": {"CPU": 2, "GPU": 1}, "min_workers": 0,
                    "max_workers": 1}}}
    out: dict = {"card": report.get("card")}
    handle = client = jobs = None
    started: set = set()
    try:
        # 1. up
        t0 = time.monotonic()
        handle = create_or_update_cluster(config)
        out["up_s"] = time.monotonic() - t0
        if handle.worker_ids():
            raise AssertionError(f"ops: up launched {handle.worker_ids()}")
        gcs = handle.provider.gcs_address
        cluster = handle.provider._cluster
        gcs_pid = cluster.gcs_proc.pid
        client = ClusterClient(gcs)

        # 2. a pending GPU bundle: one gpu node, the group CREATED
        t0 = time.monotonic()
        pg = client.create_placement_group([{"GPU": 1, "CPU": 1}])
        handle.start_monitor(interval_s=0.3)
        _wait_for(lambda: handle.worker_ids(), 60, "a gpu node")
        launch_s = time.monotonic() - t0
        _wait_for(lambda: client.pg_info(pg)["state"] == "CREATED", 60,
                  "the bundle's group CREATED")
        created_s = time.monotonic() - t0
        gpu_workers = handle.worker_ids()
        tags = [handle.provider.node_tags(w)["ray-user-node-type"]
                for w in gpu_workers]
        if tags != ["gpu"] or handle.autoscaler.num_launches != 1:
            raise AssertionError(f"ops: the autoscaler launched {tags} "
                                 f"({handle.autoscaler.num_launches})")
        gpu_raylet = handle.provider.raylet_node_id(gpu_workers[0])
        client.remove_placement_group(pg)
        started |= _descendants([gcs_pid, *(
            p.pid for p in cluster.raylets.values())])
        print(f"ops: on {report.get('card')}: up (GCS on CUDA) in "
              f"{out['up_s']:.2f} s; a pending {{GPU: 1, CPU: 1}} bundle "
              f"launched one gpu node in {launch_s:.2f} s, group CREATED in "
              f"{created_s:.2f} s", flush=True)

        # 3. a py_modules task on the gpu node
        env = {"py_modules": [pkg_dir], "env_vars": {"B1_TAG": "ops-b1"}}
        t0 = time.monotonic()
        uri = normalize(dict(env))["py_modules"][0]
        package_ms = (time.monotonic() - t0) * 1e3
        t0 = time.monotonic()
        ref = client.submit(_ops_task, (batches,), resources={"GPU": 1},
                            runtime_env=env)
        result = client.get(ref, timeout=600.0)
        task_s = time.monotonic() - t0
        # what the raylet did before dispatch: a KV fetch and an extract
        t0 = time.monotonic()
        pkg.PyModulesManager(
            cache_root=os.path.join(work, "stage_probe")).ensure_local(
            uri, fetch=lambda key: client.kv_get(key, ns=pkg.KV_NAMESPACE))
        stage_ms = (time.monotonic() - t0) * 1e3
        node_extract = os.path.join(node_cache, uri.split("//", 1)[1])
        staged = os.path.exists(os.path.join(node_extract, ".ready"))
        task_last = [t.float().cpu().numpy() for t in result["last"]]
        task_devices = sorted({str(t.device) for t in result["last"]})
        del result["last"]
        _check_launches("ops (py_modules task)", result["counts"],
                        result["routes"], want, cfg.head_dim)
        equal = [bool(np.array_equal(g, w))
                 for g, w in zip(task_last, want_last)]
        if not all(equal) or len(equal) != SERVE_REQUESTS:
            raise AssertionError(f"ops: the py_modules task's logits are not "
                                 f"the serve phase's bit for bit ({equal})")
        if result["tag"] != "ops-b1" or not staged or \
                not result["module"].startswith(node_extract + os.sep) or \
                result["visible"] != "0":
            raise AssertionError(f"ops: the task ran with B1_TAG "
                                 f"{result['tag']!r}, its module at "
                                 f"{result['module']}, staged {staged}, "
                                 f"CUDA_VISIBLE_DEVICES {result['visible']!r}"
                                 f"; want the package of {uri} under "
                                 f"{node_cache}")
        out["py_modules_task"] = {
            "uri": uri, "package_ms": package_ms, "stage_ms": stage_ms,
            "task_s": task_s, "node": gpu_raylet,
            "kernel_launches": result["counts"],
            "kernel_launches_by_route": result["routes"],
            "logits_device": task_devices, "bit_equal_to_serve": equal,
            "env_var": result["tag"], "module": result["module"]}
        print(f"ops: a task with runtime_env py_modules ({uri}; packaged and "
              f"put in the GCS KV in {package_ms:.1f} ms, a KV fetch and "
              f"extract as the raylet stages it {stage_ms:.1f} ms) served "
              f"b1 on the gpu node in {task_s:.2f} s; K1 "
              f"{result['routes']['fwd']}; logits on {task_devices}, "
              f"bit-equal to the serve phase's; B1_TAG {result['tag']!r}",
              flush=True)

        # 6a. the idle gpu node goes
        t0 = time.monotonic()
        _wait_for(lambda: handle.autoscaler.num_terminations == 1, 60,
                  "the idle gpu node's termination")
        out["idle_to_terminated_s"] = time.monotonic() - t0
        if handle.worker_ids() or gpu_raylet in cluster.raylets:
            raise AssertionError(f"ops: the gpu node is still up: "
                                 f"{handle.worker_ids()}")
        print(f"ops: the idle gpu node terminated "
              f"{out['idle_to_terminated_s']:.2f} s after the task (idle "
              f"timeout {OPS_IDLE_S} s)", flush=True)

        # 4. two jobs
        jobs = JobSubmissionClient(gcs)
        logits_file = os.path.join(work, "job_logits.npy")
        job_env = {"env_vars": {"PYTHONPATH": f"{root}:{pkg_dir}"}}

        def run_job(script, *args):
            t0 = time.monotonic()
            job_id = jobs.submit_job(
                entrypoint=" ".join([sys.executable,
                                     os.path.join(work, script), *args]),
                runtime_env=job_env)
            seen = [jobs.get_job_status(job_id)]

            def moved(target):
                status = jobs.get_job_status(job_id)
                if status != seen[-1]:
                    seen.append(status)
                return status in target

            running_s = _wait_for(lambda: moved(("RUNNING", "SUCCEEDED",
                                                 "FAILED", "STOPPED")),
                                  120, f"{script} to start")
            return job_id, seen, moved, t0, running_s

        serve_id, seen, moved, t0, running_s = run_job(
            "serve_job.py", logits_file)
        _wait_for(lambda: moved(("SUCCEEDED", "FAILED", "STOPPED")), 600,
                  "the serve job to end")
        done_s = time.monotonic() - t0
        logs = jobs.get_job_logs(serve_id)
        if seen != ["PENDING", "RUNNING", "SUCCEEDED"]:
            raise AssertionError(f"ops: serve job went {seen}: {logs[-3000:]}")
        line = [x for x in logs.splitlines()
                if x.startswith("OPS_JOB_LAUNCHES ")]
        launched = json.loads(line[-1].split(" ", 1)[1])
        _check_launches("ops (job)", launched["counts"], launched["routes"],
                        want, cfg.head_dim)
        job_last = np.load(logits_file)
        job_equal = [bool(np.array_equal(g, w))
                     for g, w in zip(job_last, want_last)]
        if not all(job_equal) or len(job_equal) != SERVE_REQUESTS:
            raise AssertionError(f"ops: the job's logits are not the serve "
                                 f"phase's bit for bit ({job_equal})")

        free_job = _free_card_bytes()
        hold_id, hold_seen, hold_moved, t0, hold_running_s = run_job(
            "hold_job.py")
        _wait_for(lambda: "OPS_B1_LOADED" in jobs.get_job_logs(hold_id)
                  or hold_moved(("SUCCEEDED", "FAILED", "STOPPED")), 300,
                  "the holding job's log to say b1 is loaded")
        if hold_seen[-1] != "RUNNING":
            raise AssertionError(f"ops: the holding job went {hold_seen}: "
                                 f"{jobs.get_job_logs(hold_id)[-3000:]}")
        free_holding = _free_card_bytes()
        t0 = time.monotonic()
        if not jobs.stop_job(hold_id):
            raise AssertionError("ops: stop_job refused the running job")
        stop_s = _wait_for(lambda: hold_moved(("STOPPED", "FAILED",
                                               "SUCCEEDED")), 60,
                           "the stopped job to end")
        freed_s = _wait_for(
            lambda: free_job - _free_card_bytes() <= OPS_MEM_SLACK, 60,
            "the stopped job's card memory") + stop_s
        free_stopped = _free_card_bytes()
        if hold_seen != ["PENDING", "RUNNING", "STOPPED"] or \
                free_job - free_holding < 2 << 30:
            raise AssertionError(f"ops: holding job went {hold_seen}, card "
                                 f"free {free_job} before it, "
                                 f"{free_holding} while it held b1")
        out["jobs"] = {
            "serve": {"id": serve_id, "statuses": seen,
                      "submit_to_running_s": running_s,
                      "submit_to_succeeded_s": done_s,
                      "kernel_launches": launched["counts"],
                      "kernel_launches_by_route": launched["routes"],
                      "bit_equal_to_serve": job_equal},
            "hold": {"id": hold_id, "statuses": hold_seen,
                     "submit_to_running_s": hold_running_s,
                     "stop_to_stopped_s": stop_s,
                     "stop_to_memory_freed_s": freed_s,
                     "card_free_bytes": {"before": free_job,
                                         "holding": free_holding,
                                         "stopped": free_stopped,
                                         "slack": OPS_MEM_SLACK}}}
        print(f"ops: job {serve_id}: PENDING -> RUNNING in {running_s:.2f} "
              f"s, SUCCEEDED in {done_s:.2f} s; K1 "
              f"{launched['routes']['fwd']} in the job's process; logits "
              f"bit-equal to the serve phase's. Job {hold_id} (b1 loaded, "
              f"card free GiB {free_job / 2**30:.2f} -> "
              f"{free_holding / 2**30:.2f}): stop -> STOPPED in {stop_s:.2f} "
              f"s, card memory back ({free_stopped / 2**30:.2f} GiB) "
              f"{freed_s:.2f} s after the stop", flush=True)

        # 5. the CLI on this cluster
        status = _ops_cli(root, "status", "--address", gcs)
        listed = _ops_cli(root, "job", "--address", gcs, "list")
        rows = {line.split()[0]: line.split()[1]
                for line in listed.splitlines() if line.strip()}
        statuses = {j: _ops_cli(root, "job", "--address", gcs, "status",
                                j).strip() for j in (serve_id, hold_id)}
        cli_logs = _ops_cli(root, "job", "--address", gcs, "logs", serve_id)
        want_rows = {serve_id: "SUCCEEDED", hold_id: "STOPPED"}
        if rows != want_rows or statuses != want_rows or \
                f"[gcs {gcs}]" not in status or \
                "OPS_JOB_LAUNCHES" not in cli_logs:
            raise AssertionError(f"ops: the CLI listed {rows}, statuses "
                                 f"{statuses}, status {status[:200]!r}")
        out["cli"] = {"status": status, "list": listed, "statuses": statuses}
        print(f"ops: python -m ray_tpu_torch status / job list / status / "
              f"logs --address {gcs}: exit 0, jobs {statuses}", flush=True)
        started |= _descendants([gcs_pid, *(
            p.pid for p in cluster.raylets.values())])
        servers = [cluster.gcs_proc, *cluster.raylets.values()]
        jobs.close()
        jobs = None
        client.close()
        client = None

        # 6b. down
        t0 = time.monotonic()
        teardown_cluster(name)
        handle = None
        out["down_s"] = time.monotonic() - t0
        left = [p.pid for p in servers if p.poll() is None]
        if left or os.path.exists(_state_path(name)):
            raise AssertionError(f"ops: down left servers {left} or the "
                                 f"state file {_state_path(name)}")
        out["workers_left_after_down"] = _reap(started)
        freed_s = _wait_for(
            lambda: free_before - _free_card_bytes() <= OPS_MEM_SLACK, 60,
            "the card's memory after down")
        free_after = _free_card_bytes()
        out["card_free_bytes"] = {"before": free_before, "after": free_after,
                                  "slack": OPS_MEM_SLACK}
        print(f"ops: down in {out['down_s']:.2f} s, no GCS or raylet left, "
              f"no state file; card free GiB {free_before / 2**30:.2f} "
              f"before, {free_after / 2**30:.2f} {freed_s:.2f} s after",
              flush=True)
    finally:
        if jobs is not None:
            jobs.close()
        if client is not None:
            client.close()
        if handle is not None:
            with contextlib.suppress(Exception):
                teardown_cluster(name)
        _reap(started)
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        pkg._default = saved_manager
        shutil.rmtree(work, ignore_errors=True)
        sweep_stale_segments(min_age_s=0.0)

    # 7. the microbenchmark on the card's runtime, in a process of its own
    perf = _ops_cli(root, "microbenchmark", "--json", "--duration",
                    str(OPS_PERF_DURATION))
    rows = json.loads(perf.strip().splitlines()[-1])
    if tuple(r["name"] for r in rows) != OPS_PERF_ROWS:
        raise AssertionError(f"ops: microbenchmark rows "
                             f"{[r['name'] for r in rows]}")
    out["microbenchmark"] = rows
    for r in rows:
        print(f"ops: microbenchmark {r['name']}: {r['rate']:.1f} /s "
              f"(min {r['rate_min']:.1f}, max {r['rate_max']:.1f}, spread "
              f"{r['spread']}) on {report.get('card')}", flush=True)
    report["ops"] = out
    return _merge_routes(out["py_modules_task"]["kernel_launches_by_route"],
                         out["jobs"]["serve"]["kernel_launches_by_route"])


# ------------------------------------------------------------ phase 16


class DashServer(ProcServer):
    """ProcServer whose requests each print one marker line, which the
    raylet publishes on the LOG channel and the head keeps."""

    def forward_marked(self, tokens, i):
        print(f"{DASH_MARKER} {i}", file=sys.stderr, flush=True)
        return self.forward_last(tokens)


def _dash_request(tokens):
    """A thread-tier task: one request to the named b1 actor -> the last
    position's logits on the host."""
    import ray_tpu_torch

    server = ray_tpu_torch.get_actor(DASH_ACTOR)
    logits = ray_tpu_torch.get(server.forward.remote(tokens))
    return logits[:, -1].float().cpu().numpy()


def _http_get(url: str) -> tuple:
    """(status, content type, body, ms) of one GET."""
    import urllib.error
    import urllib.request

    t = time.monotonic()
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            out = (r.status, r.headers["Content-Type"], r.read())
    except urllib.error.HTTPError as e:
        out = (e.code, e.headers.get("Content-Type"), e.read())
    return (*out, (time.monotonic() - t) * 1e3)


def _http_json(url: str):
    status, ctype, body, _ = _http_get(url)
    if status != 200 or ctype != "application/json":
        raise AssertionError(f"dash: GET {url} answered {status} {ctype}")
    return json.loads(body)


def _static_thread_labels() -> set:
    """The thread-root labels the port's raycheck derives from
    ``ray_tpu_torch/`` (``facts._root_label`` of each root it finds)."""
    import ray_tpu_torch
    from ray_tpu_torch.tools import raycheck
    from ray_tpu_torch.tools.raycheck import facts

    pkg = os.path.dirname(os.path.abspath(ray_tpu_torch.__file__))
    program = facts.Program(raycheck.load_tree(pkg), root=pkg)
    return {r.label for r in program.thread_roots}


def _dash_process_tier(report: dict, batches, want_last, want) -> tuple:
    """b1 from a raylet's worker, read back through the process-tier
    head; everything the cluster and the head started is gone after."""
    import statistics

    import numpy as np

    from ray_tpu_torch.cluster import process_cluster as pc
    from ray_tpu_torch.cluster.job_manager import JobSubmissionClient

    cfg = _text_config("b1")
    root = os.path.dirname(os.path.abspath(__file__))
    override = "RAY_TPU_WORKER_CUDA_VISIBLE_DEVICES"
    saved = os.environ.get(override)
    os.environ[override] = "0"  # the raylet's workers get card 0
    free_before = _free_card_bytes()
    out: dict = {}
    cluster = client = jobs = head = None
    started: set = set()
    raylet_pids: list = []
    try:
        t0 = time.monotonic()
        cluster = pc.ProcessCluster()
        out["gcs_start_s"] = time.monotonic() - t0
        node = cluster.add_node(num_cpus=2, resources={"GPU": 1},
                                object_store_memory=CLUSTER_STORE_BYTES)
        cluster.wait_for_nodes(1)
        raylet_pids = [p.pid for p in cluster.raylets.values()]
        gcs = cluster.gcs_address

        # the head, as a user starts it
        t0 = time.monotonic()
        head = subprocess.Popen(
            [sys.executable, "-m",
             "ray_tpu_torch.observability.dashboard_head", "--gcs", gcs],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
            cwd=root, env=dict(os.environ, PYTHONPATH=root))
        line = head.stdout.readline()
        out["head_start_s"] = time.monotonic() - t0
        if not line.startswith("DASHBOARD_URL "):
            raise AssertionError(f"dash: the head printed {line!r}")
        url = line.split()[1]
        out["head_maps_libtorch"] = _maps(head.pid, "libtorch")
        if out["head_maps_libtorch"]:
            raise AssertionError("dash: the head process loaded torch")
        print(f"dash: on {report.get('card')}: GCS on CUDA up in "
              f"{out['gcs_start_s']:.2f} s; `python -m ray_tpu_torch."
              f"observability.dashboard_head` printed DASHBOARD_URL {url} "
              f"{out['head_start_s']:.3f} s after its spawn (no libtorch "
              f"mapped)", flush=True)

        # b1 from the raylet's worker, each request marked
        client = pc.ClusterClient(gcs)
        t0 = time.monotonic()
        server = client.create_actor(DashServer, (0, "b1"),
                                     resources={"GPU": 1})
        server.forward_last(batches[0][:, :16])  # the probe
        out["actor_startup_s"] = time.monotonic() - t0
        server.reset_counts()
        latencies, last = [], []
        for i, tokens in enumerate(batches):
            t = time.monotonic()
            last.append(server.forward_marked(tokens, i))
            latencies.append(time.monotonic() - t)
        counts, routes = server.counts()
        _check_launches("dash (process tier)", counts, routes, want,
                        cfg.head_dim)
        equal = [bool(np.array_equal(g, w)) for g, w in zip(last, want_last)]
        if not all(equal) or len(equal) != SERVE_REQUESTS:
            raise AssertionError(f"dash: the actor's logits are not the "
                                 f"serve phase's bit for bit ({equal})")
        out["serve"] = {"latency_s": latencies, "kernel_launches": counts,
                        "kernel_launches_by_route": routes,
                        "bit_equal_to_serve": equal}

        # a short job through the job client
        jobs = JobSubmissionClient(gcs)
        job_id = jobs.submit_job(entrypoint="echo dash-job-ok")
        t0 = time.monotonic()
        while jobs.get_job_status(job_id) not in ("SUCCEEDED", "FAILED",
                                                   "STOPPED"):
            if time.monotonic() - t0 > 60:
                raise AssertionError("dash: the shell job never ended")
            time.sleep(0.05)
        out["job"] = {"id": job_id, "status": jobs.get_job_status(job_id),
                      "submit_to_end_s": time.monotonic() - t0}

        # the routes
        healthz = _http_json(url + "/healthz")
        status, ctype, page, _ = _http_get(url + "/")
        view = _http_json(url + "/api/cluster")
        nodes = _http_json(url + "/api/nodes")
        actors = _http_json(url + "/api/actors")
        logs = _http_json(url + "/api/logs?n=500")
        job_rows = _http_json(url + "/api/jobs")
        row = next((n for n in nodes if n["node_id"] == node), {})
        info = view["nodes"].get(node, {})
        markers = sorted(e["line"] for e in logs
                         if e["line"].startswith(DASH_MARKER))
        listed = {a["actor_id"]: a["state"] for a in actors}
        job_listed = {j["job_id"]: j["status"] for j in job_rows}
        problems = [what for what, bad in (
            ("/healthz", healthz != {"ok": True}),
            ("/", status != 200 or not str(ctype).startswith("text/html")
             or b"/api/nodes" not in page),
            ("/api/cluster", not info.get("alive")
             or info.get("resources", {}).get("GPU") != 1),
            ("/api/nodes", not row.get("alive")
             or row.get("agent", {}).get("pid", 0) == 0
             or row.get("agent", {}).get("rss_kb", 0) <= 0),
            ("/api/actors", listed.get(server.actor_id) != "ALIVE"),
            ("/api/logs", markers != [f"{DASH_MARKER} {i}"
                                      for i in range(SERVE_REQUESTS)]),
            ("/api/jobs", job_listed.get(job_id) != "SUCCEEDED"
             or out["job"]["status"] != "SUCCEEDED")) if bad]
        if problems:
            raise AssertionError(
                f"dash: routes {problems} answered wrong: healthz "
                f"{healthz}, / {status} {ctype}, node {info}, agent "
                f"{row.get('agent')}, actors {listed}, markers {markers}, "
                f"jobs {job_listed}")
        roots = row.get("threads") or {}
        static = _static_thread_labels()
        lambdas = sorted(n for n, label in roots.items()
                         if "<lambda>" in label)
        named = {n: label for n, label in roots.items()
                 if "<lambda>" not in label}
        unknown = {n: label for n, label in named.items()
                   if label not in static}
        if not named or unknown:
            raise AssertionError(f"dash: thread roots not derived by "
                                 f"raycheck: {unknown} (of {roots})")
        out["routes"] = {
            "node_agent": row["agent"], "thread_roots": roots,
            "lambda_roots": lambdas, "static_labels": len(static),
            "actor_state": listed[server.actor_id], "markers": markers,
            "jobs": job_listed, "node_resources": info["resources"]}
        print(f"dash: b1 actor (started with its probe in "
              f"{out['actor_startup_s']:.2f} s) served {SERVE_REQUESTS} "
              f"requests, latency s {[round(x, 4) for x in latencies]}; "
              f"K1 {routes['fwd']} in the actor's process; logits "
              f"bit-equal to the serve phase's. Head: /healthz ok, / "
              f"text/html, node alive with {info['resources']}, agent pid "
              f"{row['agent']['pid']} rss {row['agent']['rss_kb']} kB, "
              f"{len(named)} named thread roots all among raycheck's "
              f"{len(static)} static labels ({len(lambdas)} lambda roots: "
              f"{lambdas}), actor ALIVE, {len(markers)} markers in "
              f"/api/logs, job {job_id} SUCCEEDED in "
              f"{out['job']['submit_to_end_s']:.2f} s", flush=True)

        # each route under load: 4 more requests in flight
        server.reset_counts()
        load = {"last": [], "done": None}

        def more_requests():
            for i, tokens in enumerate(batches):
                load["last"].append(
                    server.forward_marked(tokens, SERVE_REQUESTS + i))
            load["done"] = time.monotonic()

        loader = threading.Thread(target=more_requests, daemon=True)
        t_load = time.monotonic()
        loader.start()
        route_ms = {}
        for route in DASH_ROUTES:
            times = []
            for _ in range(DASH_GETS):
                got = _http_get(url + route)
                if got[0] != 200:
                    raise AssertionError(f"dash: {route} answered {got[0]} "
                                         f"under load")
                times.append(got[3])
            route_ms[route] = statistics.median(times)
        timed_s = time.monotonic() - t_load
        loader.join(timeout=600)
        load_counts, load_routes = server.counts()
        if loader.is_alive() or not all(
                np.array_equal(g, w) for g, w in zip(load["last"],
                                                     want_last)):
            raise AssertionError("dash: the requests in flight did not "
                                 "all answer bit-equal")
        out["under_load"] = {
            "route_ms_median": route_ms, "gets": DASH_GETS,
            "timing_s": timed_s, "requests_s": load["done"] - t_load,
            "kernel_launches": load_counts}
        print(f"dash: route ms (median of {DASH_GETS} gets) with "
              f"{SERVE_REQUESTS} b1 requests in flight "
              f"({load['done'] - t_load:.3f} s for them, {timed_s:.3f} s "
              f"for the gets): "
              f"{ {r: round(v, 3) for r, v in route_ms.items()} }",
              flush=True)

        started |= _descendants([cluster.gcs_proc.pid, head.pid,
                                 *raylet_pids])
        started |= {head.pid}
        client.kill_actor(server)
    finally:
        if jobs is not None:
            jobs.close()
        if client is not None:
            client.close()
        if head is not None:
            head.terminate()
            with contextlib.suppress(Exception):
                head.wait(timeout=10)
        if cluster is not None:
            cluster.shutdown()
        if saved is None:
            os.environ.pop(override, None)
        else:
            os.environ[override] = saved
    left = _reap(started)
    segments = [n for n in os.listdir("/dev/shm") for pid in raylet_pids
                if n.startswith(f"ray_tpu_torch_store_{pid}_")]
    freed_s = _wait_for(lambda: free_before - _free_card_bytes()
                        <= OPS_MEM_SLACK, 60,
                        "the card's memory after the dash cluster")
    free_after = _free_card_bytes()
    out["after_shutdown"] = {
        "processes_left": left, "raylet_segments_left": segments,
        "card_free_bytes": {"before": free_before, "after": free_after,
                            "slack": OPS_MEM_SLACK},
        "memory_back_s": freed_s}
    if left or segments:
        raise AssertionError(f"dash: after shutdown processes {left} and "
                             f"segments {segments} were left")
    print(f"dash: shut down: no process and no segment of the raylet "
          f"left; card free GiB {free_before / 2**30:.2f} before, "
          f"{free_after / 2**30:.2f} {freed_s:.2f} s after", flush=True)
    return out, out["serve"]["kernel_launches_by_route"]


def _dash_thread_tier(report: dict, batches, want_last, want) -> tuple:
    """A named b1 actor of the thread tier on CUDA, its requests made by
    tasks, read back through the in-process dashboard."""
    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch.observability.dashboard import start_dashboard
    from ray_tpu_torch.observability.metrics import prometheus_text

    def finished(text):
        for line in text.splitlines():
            if line.startswith("ray_tpu_tasks_finished "):
                return float(line.split()[1])
        raise AssertionError("dash: no ray_tpu_tasks_finished in /metrics")

    cfg = _text_config("b1")
    ray_tpu_torch.init(num_cpus=4, num_gpus=1)
    dash = None
    try:
        server = ray_tpu_torch.remote(num_gpus=1)(ModelServer).options(
            name=DASH_ACTOR).remote(0, "b1")
        ray_tpu_torch.get(server.forward.remote(batches[0][:, :16]))
        request = ray_tpu_torch.remote(_dash_request)
        before = finished(prometheus_text())
        _reset_counts()
        last = [ray_tpu_torch.get(request.remote(tokens))
                for tokens in batches]
        counts, routes = _read_counts(), _read_routes()
        _check_launches("dash (thread tier)", counts, routes, want,
                        cfg.head_dim)
        equal = [bool(np.array_equal(g, w)) for g, w in zip(last, want_last)]
        if not all(equal) or len(equal) != SERVE_REQUESTS:
            raise AssertionError(f"dash: the thread tier's logits are not "
                                 f"the serve phase's bit for bit ({equal})")
        dash = start_dashboard()
        answers = {route: _http_json(dash.url + route)
                   for route in DASH_THREAD_ROUTES}
        status, _, metrics, _ = _http_get(dash.url + "/metrics")
        names = [a["Name"] for a in answers["/api/actors"].values()
                 if a["State"] == "ALIVE"]
        moved = finished(metrics.decode()) - before
        if status != 200 or DASH_ACTOR not in names or \
                moved < SERVE_REQUESTS:
            raise AssertionError(f"dash: thread-tier dashboard: /metrics "
                                 f"{status}, alive actors {names}, "
                                 f"ray_tpu_tasks_finished moved {moved}")
        ray_tpu_torch.kill(server)
    finally:
        if dash is not None:
            dash.stop()
        ray_tpu_torch.shutdown()
    out = {"kernel_launches": counts, "kernel_launches_by_route": routes,
           "bit_equal_to_serve": equal, "alive_actors": names,
           "tasks_finished_moved": moved}
    print(f"dash: thread tier on CUDA: named actor {DASH_ACTOR!r} served "
          f"{SERVE_REQUESTS} requests from tasks, K1 {routes['fwd']}, "
          f"bit-equal; start_dashboard(): every JSON route answered, "
          f"/api/actors names it, ray_tpu_tasks_finished moved by "
          f"{moved:.0f}", flush=True)
    return out, routes


def phase_dash(report: dict) -> dict:
    """b1 served through K1 and read back through both dashboards: the
    process-tier head over a ProcessCluster, then the thread tier's
    in-process dashboard."""
    import numpy as np

    import ray_tpu_torch

    want_last = report.get("_serve_last_logits")
    if want_last is None:
        raise AssertionError("dash needs the serve phase's logits")
    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    cfg = _text_config("b1")
    rng = np.random.default_rng(0)  # the serve phase's tokens
    batches = [rng.integers(0, cfg.vocab_size, size=SERVE_TOKENS)
               for _ in range(SERVE_REQUESTS)]
    want = {"fwd": cfg.layers * SERVE_REQUESTS, "dq": 0, "dkdv": 0}
    process, process_routes = _dash_process_tier(report, batches,
                                                 want_last, want)
    thread, thread_routes = _dash_thread_tier(report, batches, want_last,
                                              want)
    report["dash"] = {"card": report.get("card"), "process_tier": process,
                      "thread_tier": thread}
    return _merge_routes(process_routes, thread_routes)


# ------------------------------------------------------------ phase 17

PARALLEL_RANKS = 4
# the cards the parallel and dryrun phases' ranks take: 1, all four gloo
# ranks on card 0 (the default run), or PARALLEL_RANKS with --cards, one
# NCCL rank a card
PARALLEL_CARDS = 1
PARALLEL_SERVE_REQUESTS = 2  # the serve phase's first two prompts
PARALLEL_ULYSSES = (8, 2048, 16, 128)  # b1's train attention [B, S, H, D]
PARALLEL_PIPE_STEPS = 3
PARALLEL_MICROBATCHES = 4
# pipeline loss against the single-rank step, absolute, each step: the
# same bf16 model on [2, 2048] microbatches against one [8, 2048] batch
# (cuBLAS may tile the two differently), and AdamW's first steps move
# every weight by about lr whatever the gradient's size, so small
# gradient differences show in the next losses
PARALLEL_LOSS_TOL = 2e-2
# a rank's collectives and the pool's wait for its answer: a hung rank
# fails the phase instead of the run's time limit
PARALLEL_TIMEOUT_S = 240
# the mesh parts (tensor, fully-sharded and expert parallelism): b1 steps
# at dp2 x tp2 (saved after the last), the step after them restored at
# tp 4, b1 steps at FSDP dp 4, and the bench MoE model's steps at dp 4
# (experts over dp: 2 a rank) and at dp2 x sp2 on MOE_TRAIN_TOKENS. The
# b1 parts take 2 and 1 steps: with the MoE part at dp2 x sp2 and the
# dryrun phase the whole run must stay well under its time limit
MESH_TP_STEPS = 2
MESH_FSDP_STEPS = 1
MESH_EP_STEPS = 2
MESH_CKPT = "mesh_ckpt"  # in the phase's work directory


def _nccl(device: str) -> bool:
    return device == "cuda" and PARALLEL_CARDS > 1


def _ranks_text(device: str) -> str:
    return (f"{PARALLEL_RANKS} NCCL ranks, one a card" if _nccl(device)
            else f"{PARALLEL_RANKS} gloo ranks on card 0")


def _parallel_pool(device: str):
    """PARALLEL_RANKS ranks joined by gloo, all on card 0 (NCCL takes one
    rank per card), or with --cards joined by NCCL, rank r on card r."""
    from ray_tpu_torch.parallel.multihost import RankPool

    nccl = _nccl(device)
    return RankPool(PARALLEL_RANKS, backend="nccl" if nccl else "gloo",
                    cuda_device=("per_rank" if nccl else 0)
                    if device == "cuda" else None,
                    env={"RAY_TPU_collective_op_timeout_s":
                         str(PARALLEL_TIMEOUT_S)},
                    timeout_s=PARALLEL_TIMEOUT_S)


def _sync(device: str) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def _peak_gib(device: str) -> float:
    import torch

    return (torch.cuda.max_memory_allocated() / 2**30 if device == "cuda"
            else 0.0)


class _CollectiveClock:
    """Seconds a rank spends inside the collectives (staging, gloo, and
    waiting for its peers), by wrapping ``collective.api._run`` for the
    phase's measurement windows. An NCCL op is enqueued on the card and
    returns at once: it is timed between a synchronization before it
    (the work queued ahead, outside the clock) and one after it."""

    def __init__(self):
        self.seconds = 0.0

    @contextlib.contextmanager
    def running(self):
        import torch
        import torch.distributed as dist

        from ray_tpu_torch.collective import api as coll

        run = coll._run

        def timed(x, group, *args, **kwargs):
            card = x.is_cuda and dist.get_backend(group) == "nccl"
            if card:
                torch.cuda.synchronize()
            t0 = time.monotonic()
            try:
                return run(x, group, *args, **kwargs)
            finally:
                if card:
                    torch.cuda.synchronize()
                self.seconds += time.monotonic() - t0

        coll._run = timed
        try:
            yield self
        finally:
            coll._run = run


def _parallel_prompts(cfg) -> list:
    import numpy as np

    rng = np.random.default_rng(0)  # the serve phase's tokens
    return [rng.integers(0, cfg.vocab_size, size=SERVE_TOKENS)
            for _ in range(SERVE_REQUESTS)][:PARALLEL_SERVE_REQUESTS]


def _logits_check(logits, ref_path: str) -> dict:
    """Served logits against the single-rank logits saved at
    ``ref_path``: rel L2, last position's argmax, finite, shape."""
    import numpy as np
    import torch

    ref = torch.from_numpy(np.load(ref_path)).to(logits.device)
    return {"rel_l2": ((logits - ref).norm() / ref.norm()).item(),
            "last_argmax_equal": bool((logits[:, -1].argmax(-1)
                                       == ref[:, -1].argmax(-1)).all()),
            "finite": bool(torch.isfinite(logits).all()),
            "shape": list(logits.shape)}


def _check_served(part: str, checks: list, cfg) -> None:
    """Raises unless every request's logits are finite, of the served
    shape, within SERVE_LIB_REL_TOL of one rank's and agree on the last
    argmax."""
    for i, c in enumerate(checks):
        if not (c["finite"] and c["rel_l2"] <= SERVE_LIB_REL_TOL
                and c["last_argmax_equal"]
                and c["shape"] == [*SERVE_TOKENS, cfg.vocab_size]):
            raise AssertionError(f"parallel {part} request {i}: gathered "
                                 f"logits off the single-rank logits: {c}")


def par_serve_rank(device: str, ref_paths: list) -> dict:
    """A rank of the sp mesh: b1 (seed 0) served by build_forward(mesh=)
    with each strategy, every rank starting each request together; then
    the logits gathered over sp and held on rank 0 against the
    single-rank logits in ``ref_paths``."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.collective import api as coll
    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.models.training import build_forward
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh, shard_map
    from ray_tpu_torch.parallel.multihost import sync_global_devices

    rank = dist.get_rank()
    cfg = _text_config("b1")
    mesh = build_mesh(MeshSpec(sp=PARALLEL_RANKS), device_type=device)
    params = tfm.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    prompts = _parallel_prompts(cfg)
    out = {}
    for strategy in ("ulysses", "ring"):
        fwd = build_forward(cfg, mesh=mesh, sp_strategy=strategy)
        # a first request outside the timings: it pays the gloo pairs'
        # connections and the pinned buffers' first allocations
        fwd(params, prompts[0])
        _sync(device)
        _reset_counts()
        latency, staged, logits = [], 0, []
        clock = _CollectiveClock()
        for batch in prompts:
            coll.staged_bytes.reset()
            sync_global_devices("request")
            t0 = time.monotonic()
            with clock.running():
                logits.append(fwd(params, batch))
                _sync(device)
            latency.append(time.monotonic() - t0)
            staged += coll.staged_bytes.count
        counts, routes = _read_counts(), _read_routes()
        checks = []
        for local, ref_path in zip(logits, ref_paths):
            with shard_map(mesh):
                full = coll.ici.allgather(local, "sp")  # [sp, B, S/sp, V]
            full = full.transpose(0, 1).reshape(
                local.shape[0], -1, local.shape[-1])
            if rank == 0:
                checks.append(_logits_check(full, ref_path))
            del full
        del logits
        out[strategy] = {"latency_s": latency, "staged_bytes": staged,
                         "collective_s": clock.seconds,
                         "counts": counts, "routes": routes,
                         "checks": checks}
    out["peak_gib"] = _peak_gib(device)
    return out


def _ulysses_inputs(device: str) -> list:
    """q, k, v and dout [B, S, H, D] bf16, seeded on ``device``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(1)
    return [torch.randn(PARALLEL_ULYSSES, generator=gen, device=device
                        ).to(torch.bfloat16) for _ in range(4)]


def par_ulysses_rank(device: str, ref_path: str) -> dict:
    """ulysses_attention forward and backward on this rank's sequence
    shard of the seeded inputs, held against the single-rank
    flash_attention's out and gradients in ``ref_path``: out within
    KERNEL_TOL, each gradient's squared error and norm returned for the
    global relative L2."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.collective import api as coll
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh, shard_map
    from ray_tpu_torch.parallel.multihost import sync_global_devices
    from ray_tpu_torch.parallel.ulysses import ulysses_attention

    rank = dist.get_rank()
    n = PARALLEL_RANKS
    rows = slice(rank * PARALLEL_ULYSSES[1] // n,
                 (rank + 1) * PARALLEL_ULYSSES[1] // n)
    q, k, v, dout = (t[:, rows].contiguous()
                     for t in _ulysses_inputs(device))
    mesh = build_mesh(MeshSpec(sp=n), device_type=device)
    # a first call outside the timings and counts (gloo connections,
    # pinned buffers)
    with shard_map(mesh):
        warm = [t.clone().requires_grad_() for t in (q, k, v)]
        ulysses_attention(*warm, "sp").backward(dout)
    del warm
    local = [t.requires_grad_() for t in (q, k, v)]
    _reset_counts()
    coll.staged_bytes.reset()
    _sync(device)
    sync_global_devices("ulysses")
    t0 = time.monotonic()
    with shard_map(mesh):
        out = ulysses_attention(*local, "sp")
        out.backward(dout)
    _sync(device)
    wall = time.monotonic() - t0
    ref = torch.load(ref_path)
    got = {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
    errors = {}
    for name, value in got.items():
        want = ref[name][:, rows].to(device).float()
        diff = value.float() - want
        errors[name] = {"max_abs": diff.abs().max().item(),
                        "sq_err": diff.square().sum().item(),
                        "sq_ref": want.square().sum().item()}
    atol, rtol = KERNEL_TOL["bfloat16"]["out"]
    out_ok = bool(torch.allclose(got["out"].float(),
                                 ref["out"][:, rows].to(device).float(),
                                 atol=atol, rtol=rtol))
    return {"wall_s": wall, "staged_bytes": coll.staged_bytes.count,
            "counts": _read_counts(), "routes": _read_routes(),
            "errors": errors, "out_within_tol": out_ok,
            "peak_gib": _peak_gib(device)}


def par_pipeline_rank(device: str, ref_path: str) -> dict:
    """A stage of build_pipeline_train_step(b1, MeshSpec(pp=4)): its
    first step's gradients (this stage's first layer and embed) against
    the single-rank gradients in ``ref_path``, then PARALLEL_PIPE_STEPS
    steps, launches counted over them."""
    import torch
    import torch.distributed as dist

    from ray_tpu_torch.collective import api as coll
    from ray_tpu_torch.models.training import build_pipeline_train_step
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.multihost import sync_global_devices

    cfg = _text_config("b1")
    mesh = build_mesh(MeshSpec(pp=PARALLEL_RANKS), device_type=device)
    t0 = time.monotonic()
    step, init_fn = build_pipeline_train_step(
        cfg, mesh, num_microbatches=PARALLEL_MICROBATCHES)
    params, opt_state = init_fn(
        torch.Generator(device=device).manual_seed(0))
    tokens = torch.as_tensor(_train_batch("b1"), device=device)
    first = mesh.get_local_rank("pp") * (cfg.layers // PARALLEL_RANKS)
    _sync(device)
    init_s = time.monotonic() - t0
    loss, grads, norm = step.loss_and_grads(params, tokens)
    ref = torch.load(ref_path)
    rel = {}
    for name, g in zip(_leaf_names(params), grads):
        if name.startswith("layers."):
            key, mine = f"{name}.{first}", g[0]
        elif name == "embed":
            key, mine = name, g
        else:
            continue
        want = ref[key].to(device).float()
        rel[key] = ((mine.float() - want).norm() / want.norm()).item()
    first_step = {"loss": loss.item(), "grad_norm": norm.item(),
                  "grad_rel_l2": rel}
    del grads, ref
    _reset_counts()
    coll.staged_bytes.reset()
    rows = []
    for _ in range(PARALLEL_PIPE_STEPS):
        _sync(device)
        sync_global_devices("step")
        t0 = time.monotonic()
        with _CollectiveClock().running() as clock:
            params, opt_state, metrics = step(params, opt_state, tokens)
            loss = metrics["loss"].item()  # waits for the step
        rows.append({"loss": loss, "grad_norm": metrics["grad_norm"].item(),
                     "step_s": time.monotonic() - t0,
                     "collective_s": clock.seconds})
    return {"rank": dist.get_rank(), "first_layer": first,
            "init_s": init_s, "first_step": first_step, "steps": rows,
            "staged_bytes": coll.staged_bytes.count,
            "counts": _read_counts(), "routes": _read_routes(),
            "peak_gib": _peak_gib(device)}


def _free_card(device: str) -> None:
    import gc

    import torch

    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()


def _pool_run(device: str, fn, *args) -> tuple:
    """fn on every rank of a fresh pool -> (results, start-up s, run s);
    the ranks are stopped after."""
    pool = _parallel_pool(device)
    t0 = time.monotonic()
    try:
        pool.start()
        start_s = time.monotonic() - t0
        t1 = time.monotonic()
        results = pool.run(fn, device, *args)
        return results, start_s, time.monotonic() - t1
    finally:
        pool.close()


def _parallel_serve(device: str, work: str, card: str) -> tuple:
    import numpy as np
    import torch

    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.models.training import build_forward

    cfg = _text_config("b1")
    params = tfm.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    fwd = build_forward(cfg, device=device)
    paths = []
    for i, batch in enumerate(_parallel_prompts(cfg)):
        paths.append(os.path.join(work, f"serve_ref_{i}.npy"))
        np.save(paths[-1], fwd(params, batch).float().cpu().numpy())
    del params
    _free_card(device)
    results, start_s, run_s = _pool_run(device, par_serve_rank, paths)
    out = {"rank_start_s": start_s, "run_s": run_s,
           "peak_gib_by_rank": [r["peak_gib"] for r in results]}
    routes = []
    for strategy in ("ulysses", "ring"):
        per_rank = [r[strategy] for r in results]
        checks = per_rank[0]["checks"]
        n_req = PARALLEL_SERVE_REQUESTS
        want = {"fwd": cfg.layers * n_req if strategy == "ulysses" else 0,
                "dq": 0, "dkdv": 0}
        for rank, r in enumerate(per_rank):
            _check_launches(f"parallel serve {strategy} rank {rank}",
                            r["counts"], r["routes"], want, cfg.head_dim)
        _check_served(f"serve {strategy}", checks, cfg)
        latency = [max(r["latency_s"][i] for r in per_rank)
                   for i in range(n_req)]
        out[strategy] = {
            "latency_s": latency, "checks": checks,
            "latency_s_by_rank": [r["latency_s"] for r in per_rank],
            "collective_s_by_rank": [r["collective_s"] for r in per_rank],
            "staged_bytes_by_rank": [r["staged_bytes"] for r in per_rank],
            "kernel_launches_by_rank": [r["counts"] for r in per_rank]}
        routes += [r["routes"] for r in per_rank]
        print(f"parallel serve {strategy}: b1 at sp={PARALLEL_RANKS} "
              f"({_ranks_text(device)}), {n_req} requests of "
              f"{list(SERVE_TOKENS)}: latency s "
              f"{[round(x, 4) for x in latency]} (in collectives, rank 0 "
              f"{per_rank[0]['collective_s']:.4f} s over both); gathered "
              f"logits vs one "
              f"rank rel L2 {[round(c['rel_l2'], 6) for c in checks]}, "
              f"last argmax equal; staged bytes by rank "
              f"{out[strategy]['staged_bytes_by_rank']}; K1 launches by "
              f"rank {[r['counts']['fwd'] for r in per_rank]} on {card}",
              flush=True)
    return out, _merge_routes(*routes)


def _parallel_ulysses(device: str, work: str, card: str) -> tuple:
    import torch

    from ray_tpu_torch.ops.attention import flash_attention

    q, k, v, dout = _ulysses_inputs(device)
    for t in (q, k, v):
        t.requires_grad_()
    out = flash_attention(q, k, v, causal=True)
    out.backward(dout)
    path = os.path.join(work, "ulysses_ref.pt")
    torch.save({"out": out.detach().cpu(), "dq": q.grad.cpu(),
                "dk": k.grad.cpu(), "dv": v.grad.cpu()}, path)
    del q, k, v, dout, out
    _free_card(device)
    results, start_s, run_s = _pool_run(device, par_ulysses_rank, path)
    rel = {}
    for name in ("dq", "dk", "dv"):
        err = sum(r["errors"][name]["sq_err"] for r in results)
        ref = sum(r["errors"][name]["sq_ref"] for r in results)
        rel[name] = math.sqrt(err / ref)
    max_abs_out = max(r["errors"]["out"]["max_abs"] for r in results)
    if not all(r["out_within_tol"] for r in results) or \
            not all(x <= GRAD_REL_L2_TOL for x in rel.values()):
        raise AssertionError(f"parallel ulysses: out max abs "
                             f"{max_abs_out}, gradient rel L2 {rel}")
    for rank, r in enumerate(results):
        _check_launches(f"parallel ulysses rank {rank}", r["counts"],
                        r["routes"], {"fwd": 1, "dq": 1, "dkdv": 1},
                        PARALLEL_ULYSSES[3])
    out = {"shape": list(PARALLEL_ULYSSES), "rank_start_s": start_s,
           "run_s": run_s, "wall_s_by_rank": [r["wall_s"] for r in results],
           "out_max_abs_vs_one_rank": max_abs_out,
           "grad_rel_l2_vs_one_rank": rel,
           "staged_bytes_by_rank": [r["staged_bytes"] for r in results],
           "peak_gib_by_rank": [r["peak_gib"] for r in results]}
    print(f"parallel ulysses: {list(PARALLEL_ULYSSES)} split {PARALLEL_RANKS}"
          f" ways, forward and backward: out max abs vs one rank "
          f"{max_abs_out:.3g}, gradient rel L2 "
          f"{ {k: round(x, 6) for k, x in rel.items()} }; wall s by rank "
          f"{[round(r['wall_s'], 4) for r in results]}; staged bytes by "
          f"rank {out['staged_bytes_by_rank']}; K1/K2/K3 1 each a rank on "
          f"{card}", flush=True)
    return out, _merge_routes(*(r["routes"] for r in results))


def _parallel_pipeline(device: str, work: str, card: str) -> tuple:
    import torch

    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.models.training import build_train_step

    cfg = _text_config("b1")
    stages = PARALLEL_RANKS
    n_local = cfg.layers // stages
    # the single-rank reference on the same card, weights and tokens
    params = tfm.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    tokens = torch.as_tensor(_train_batch("b1"), device=device).long()
    _, grads = _loss_and_grads(
        params, lambda p: tfm.loss_fn(p, tokens, cfg))
    del params
    keep = {"embed": grads["embed"].cpu()}
    for name, g in grads.items():
        if name.startswith("layers."):
            for layer in range(0, cfg.layers, n_local):
                keep[f"{name}.{layer}"] = g[layer].cpu()
    path = os.path.join(work, "pipeline_ref.pt")
    torch.save(keep, path)
    del grads, keep
    _free_card(device)
    step, init_fn = build_train_step(cfg, device=device)
    params, opt_state = init_fn(
        torch.Generator(device=device).manual_seed(0))
    single = []
    # the mesh parts compare with these too, up to the step after the
    # reshard
    for _ in range(max(PARALLEL_PIPE_STEPS, MESH_TP_STEPS + 1,
                       MESH_FSDP_STEPS)):
        params, opt_state, m = step(params, opt_state, tokens)
        single.append((m["loss"].item(), m["grad_norm"].item()))
    with open(os.path.join(work, "b1_single.json"), "w") as f:
        json.dump({"steps": single,
                   "state_bytes": _state_bytes(params, opt_state)}, f)
    single = single[:PARALLEL_PIPE_STEPS]
    del params, opt_state, step, m
    _free_card(device)
    free_before = (torch.cuda.mem_get_info()[0] if device == "cuda"
                   else 0)
    results, start_s, run_s = _pool_run(device, par_pipeline_rank, path)
    ticks = PARALLEL_MICROBATCHES + stages - 1
    want = {"fwd": 2 * ticks * n_local * PARALLEL_PIPE_STEPS,
            "dq": ticks * n_local * PARALLEL_PIPE_STEPS,
            "dkdv": ticks * n_local * PARALLEL_PIPE_STEPS}
    for rank, r in enumerate(results):
        _check_launches(f"parallel pipeline rank {rank}", r["counts"],
                        r["routes"], want, cfg.head_dim)
        bad = {k: x for k, x in r["first_step"]["grad_rel_l2"].items()
               if not x <= GRAD_REL_L2_TOL}
        if bad:
            raise AssertionError(f"parallel pipeline rank {rank}: step-1 "
                                 f"gradients off one rank's: {bad}")
    _check_mesh_steps("pipeline", results, single)
    step_s = [max(r["steps"][i]["step_s"] for r in results)
              for i in range(PARALLEL_PIPE_STEPS)]
    collective_s = [[row["collective_s"] for row in r["steps"]]
                    for r in results]
    grad_rel = {k: x for r in results
                for k, x in r["first_step"]["grad_rel_l2"].items()}
    out = {"mesh": f"pp={stages}", "microbatches": PARALLEL_MICROBATCHES,
           "tokens": list(TRAIN_TOKENS), "ticks": ticks,
           "rank_start_s": start_s, "run_s": run_s,
           "card_free_bytes_before": free_before,
           "single_rank": single, "steps": results[0]["steps"],
           "step_s": step_s, "collective_s_by_rank": collective_s,
           "grad_rel_l2_vs_one_rank": grad_rel,
           "staged_bytes_by_rank": [r["staged_bytes"] for r in results],
           "peak_gib_by_rank": [r["peak_gib"] for r in results],
           "kernel_launches_by_rank": [r["counts"] for r in results]}
    worst = max(grad_rel, key=grad_rel.get)
    print(f"parallel pipeline: b1 GPipe over pp={stages} ({n_local} layers "
          f"a stage, {PARALLEL_MICROBATCHES} microbatches, {ticks} ticks) "
          f"at {list(TRAIN_TOKENS)}: losses "
          f"{[round(s['loss'], 5) for s in results[0]['steps']]} vs one "
          f"rank {[round(x, 5) for x, _ in single]}; step s "
          f"{[round(x, 4) for x in step_s]} (in collectives, rank 0 "
          f"{[round(x, 4) for x in collective_s[0]]}); step-1 worst "
          f"gradient rel L2 "
          f"{grad_rel[worst]:.3g} ({worst}); staged bytes by rank "
          f"{out['staged_bytes_by_rank']}; peak GiB by rank "
          f"{[round(x, 2) for x in out['peak_gib_by_rank']]} (card free "
          f"{free_before / 2**30:.1f} GiB before); launches by rank "
          f"{results[0]['counts']} on {card}", flush=True)
    return out, _merge_routes(*(r["routes"] for r in results))


def _state_bytes(params, opt_state) -> int:
    """Bytes of a rank's parameters and AdamW moments."""
    from ray_tpu_torch.models.training import tree_leaves

    return sum(t.nbytes for t in (tree_leaves(params) + opt_state["mu"]
                                  + opt_state["nu"]))


def _mesh_steps(step, params, opt_state, tokens, steps: int,
                device: str) -> list:
    """``steps`` steps, every rank starting each together -> a row each:
    loss, grad norm, step s, s in collectives, staged bytes."""
    from ray_tpu_torch.collective import api as coll
    from ray_tpu_torch.parallel.multihost import sync_global_devices

    rows = []
    for _ in range(steps):
        coll.staged_bytes.reset()
        _sync(device)
        sync_global_devices("step")
        t0 = time.monotonic()
        with _CollectiveClock().running() as clock:
            params, opt_state, metrics = step(params, opt_state, tokens)
            loss = metrics["loss"].item()  # waits for the step
        rows.append({"loss": loss, "grad_norm": metrics["grad_norm"].item(),
                     "step_s": time.monotonic() - t0,
                     "collective_s": clock.seconds,
                     "staged_bytes": coll.staged_bytes.count})
    return rows


def _mesh_params(cfg, mesh, device: str, fsdp: bool = False):
    """b1-style seeded weights (seed 0) cut to this rank's shards."""
    import torch

    from ray_tpu_torch.models import transformer as tfm
    from ray_tpu_torch.models.convert import local_params
    from ray_tpu_torch.models.training import param_shardings

    full = tfm.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                           device=device)
    params = local_params(full, param_shardings(cfg, mesh, fsdp), mesh)
    del full
    _free_card(device)
    return params


def par_tp_serve_rank(device: str, ref_paths: list) -> dict:
    """A rank of tp 4: b1 served by build_forward(mesh=) on its heads,
    mlp columns and vocab rows; the full-vocab logits (gathered over tp)
    held on rank 0 against the single-rank logits in ``ref_paths``."""
    import torch.distributed as dist

    from ray_tpu_torch.collective import api as coll
    from ray_tpu_torch.models.training import build_forward
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh
    from ray_tpu_torch.parallel.multihost import sync_global_devices

    cfg = _text_config("b1")
    mesh = build_mesh(MeshSpec(tp=PARALLEL_RANKS), device_type=device)
    params = _mesh_params(cfg, mesh, device)
    prompts = _parallel_prompts(cfg)
    fwd = build_forward(cfg, mesh=mesh)
    fwd(params, prompts[0])  # outside the timings: gloo pairs, buffers
    _sync(device)
    _reset_counts()
    latency, staged, checks = [], [], []
    clock = _CollectiveClock()
    for batch, ref_path in zip(prompts, ref_paths):
        coll.staged_bytes.reset()
        sync_global_devices("request")
        t0 = time.monotonic()
        with clock.running():
            logits = fwd(params, batch)
            _sync(device)
        latency.append(time.monotonic() - t0)
        staged.append(coll.staged_bytes.count)
        if dist.get_rank() == 0:
            checks.append(_logits_check(logits, ref_path))
        del logits
    return {"latency_s": latency, "staged_bytes": staged,
            "collective_s": clock.seconds, "counts": _read_counts(),
            "routes": _read_routes(), "checks": checks,
            "peak_gib": _peak_gib(device)}


def par_tp_train_rank(device: str, work: str) -> dict:
    """A rank of dp 2 x tp 2: MESH_TP_STEPS b1 steps from the seeded
    weights, then the state saved with DCP (every rank together)."""
    import torch

    from ray_tpu_torch.models.checkpoint import CheckpointManager
    from ray_tpu_torch.models.convert import checkpoint_state
    from ray_tpu_torch.models.training import (
        build_train_step,
        make_optimizer,
        param_shardings,
    )
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    cfg = _text_config("b1")
    mesh = build_mesh(MeshSpec(dp=2, tp=2), device_type=device)
    opt = make_optimizer()
    step, _ = build_train_step(cfg, mesh=mesh, optimizer=opt)
    params = _mesh_params(cfg, mesh, device)
    opt_state = opt.init(params)
    tokens = torch.as_tensor(_train_batch("b1"), device=device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    rows = _mesh_steps(step, params, opt_state, tokens, MESH_TP_STEPS,
                       device)
    counts, routes = _read_counts(), _read_routes()
    state_bytes = _state_bytes(params, opt_state)
    t0 = time.monotonic()
    ckpt = CheckpointManager(os.path.join(work, MESH_CKPT))
    ckpt.save(MESH_TP_STEPS, checkpoint_state(
        {"params": params, "opt_state": opt_state},
        param_shardings(cfg, mesh), mesh))
    save_s = time.monotonic() - t0
    return {"steps": rows, "counts": counts, "routes": routes,
            "state_bytes": state_bytes, "save_s": save_s,
            "peak_gib": _peak_gib(device)}


def par_reshard_rank(device: str, work: str) -> dict:
    """A rank of tp 4: the dp2 x tp2 state restored in this layout (DCP
    reshards), then the step after the saved ones."""
    import torch

    from ray_tpu_torch.models.checkpoint import CheckpointManager
    from ray_tpu_torch.models.convert import checkpoint_state, train_state
    from ray_tpu_torch.models.training import (
        build_train_step,
        param_shardings,
    )
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    cfg = _text_config("b1")
    mesh = build_mesh(MeshSpec(tp=PARALLEL_RANKS), device_type=device)
    step, init_fn = build_train_step(cfg, mesh=mesh)
    fresh_p, fresh_o = init_fn(torch.Generator(device=device).manual_seed(1))
    like = checkpoint_state({"params": fresh_p, "opt_state": fresh_o},
                            param_shardings(cfg, mesh), mesh)
    _sync(device)
    t0 = time.monotonic()
    state = train_state(CheckpointManager(os.path.join(
        work, MESH_CKPT)).restore(MESH_TP_STEPS, like))
    _sync(device)
    restore_s = time.monotonic() - t0
    count = state["opt_state"]["count"]  # before the step moves it on
    del like, fresh_p, fresh_o
    _free_card(device)
    tokens = torch.as_tensor(_train_batch("b1"), device=device)
    _reset_counts()
    rows = _mesh_steps(step, state["params"], state["opt_state"], tokens, 1,
                       device)
    return {"restore_s": restore_s, "count": count,
            "steps": rows, "counts": _read_counts(),
            "routes": _read_routes(), "peak_gib": _peak_gib(device)}


def par_fsdp_rank(device: str) -> dict:
    """A rank of dp 4 with fsdp=True: its 1/4 of b1's parameters and
    moments, MESH_FSDP_STEPS steps."""
    import torch

    from ray_tpu_torch.models.training import build_train_step, make_optimizer
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    cfg = _text_config("b1")
    mesh = build_mesh(MeshSpec(dp=PARALLEL_RANKS), device_type=device)
    opt = make_optimizer()
    step, _ = build_train_step(cfg, mesh=mesh, fsdp=True, optimizer=opt)
    params = _mesh_params(cfg, mesh, device, fsdp=True)
    opt_state = opt.init(params)
    tokens = torch.as_tensor(_train_batch("b1"), device=device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    rows = _mesh_steps(step, params, opt_state, tokens, MESH_FSDP_STEPS,
                       device)
    return {"steps": rows, "counts": _read_counts(),
            "routes": _read_routes(),
            "state_bytes": _state_bytes(params, opt_state),
            "peak_gib": _peak_gib(device)}


def par_ep_rank(device: str) -> dict:
    """A rank of dp 4: the bench MoE model with its 8 experts over dp (2
    a rank), MESH_EP_STEPS steps on MOE_TRAIN_TOKENS (2 groups of 4096
    tokens a rank)."""
    import torch

    from ray_tpu_torch.models.training import build_train_step, make_optimizer
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    cfg = _text_config("moe")
    mesh = build_mesh(MeshSpec(dp=PARALLEL_RANKS), device_type=device)
    opt = make_optimizer()
    step, _ = build_train_step(cfg, mesh=mesh, optimizer=opt)
    params = _mesh_params(cfg, mesh, device)
    opt_state = opt.init(params)
    tokens = torch.as_tensor(_train_batch("moe"), device=device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    rows = _mesh_steps(step, params, opt_state, tokens, MESH_EP_STEPS,
                       device)
    return {"steps": rows, "counts": _read_counts(),
            "routes": _read_routes(),
            "state_bytes": _state_bytes(params, opt_state),
            "peak_gib": _peak_gib(device)}


def par_ep_sp_rank(device: str) -> dict:
    """A rank of dp 2 x sp 2 with ring attention: the bench MoE model,
    its 8 experts over dp (4 a rank), MESH_EP_STEPS steps on
    MOE_TRAIN_TOKENS; each 4096-token group is two 2048-token rows, cut
    over both sp ranks (``transformer._moe_spread``)."""
    import torch

    from ray_tpu_torch.models.training import build_train_step, make_optimizer
    from ray_tpu_torch.parallel.mesh import MeshSpec, build_mesh

    cfg = _text_config("moe")
    mesh = build_mesh(MeshSpec(dp=2, sp=2), device_type=device)
    opt = make_optimizer()
    step, _ = build_train_step(cfg, mesh=mesh, optimizer=opt,
                               sp_strategy="ring")
    params = _mesh_params(cfg, mesh, device)
    opt_state = opt.init(params)
    tokens = torch.as_tensor(_train_batch("moe"), device=device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    rows = _mesh_steps(step, params, opt_state, tokens, MESH_EP_STEPS,
                       device)
    return {"steps": rows, "counts": _read_counts(),
            "routes": _read_routes(),
            "state_bytes": _state_bytes(params, opt_state),
            "peak_gib": _peak_gib(device)}


def par_card_rank(device: str) -> dict:
    """This rank's place and card: its CUDA device index, name and
    UUID."""
    import torch
    import torch.distributed as dist

    out = {"rank": dist.get_rank(), "backend": dist.get_backend()}
    if device == "cuda":
        index = torch.cuda.current_device()
        props = torch.cuda.get_device_properties(index)
        out.update({"cuda_device": index, "name": props.name,
                    "uuid": str(getattr(props, "uuid", ""))})
    return out


def _one_rank_steps(model: str, steps: int, device: str) -> list:
    """(loss, grad norm) of ``steps`` steps of ``model`` on one rank of
    this process, from the seeded weights, on its train batch."""
    import torch

    from ray_tpu_torch.models.training import build_train_step

    step, init_fn = build_train_step(_text_config(model), device=device)
    params, opt_state = init_fn(torch.Generator(device=device).manual_seed(0))
    tokens = torch.as_tensor(_train_batch(model), device=device)
    out = []
    for _ in range(steps):
        params, opt_state, m = step(params, opt_state, tokens)
        out.append((m["loss"].item(), m["grad_norm"].item()))
    del params, opt_state, step
    _free_card(device)
    return out


def _check_mesh_steps(part: str, results: list, single: list) -> None:
    """Every rank's (loss, grad norm) per step against one rank's: loss
    within PARALLEL_LOSS_TOL, grad norm within GRAD_REL_L2_TOL
    relative."""
    for rank, r in enumerate(results):
        for (loss, norm), row in zip(single, r["steps"]):
            if not abs(row["loss"] - loss) <= PARALLEL_LOSS_TOL or \
                    not abs(row["grad_norm"] - norm) <= \
                    GRAD_REL_L2_TOL * norm:
                raise AssertionError(
                    f"parallel {part} rank {rank}: steps "
                    f"{[(x['loss'], x['grad_norm']) for x in r['steps']]} "
                    f"off one rank's {single}")


def _mesh_summary(results: list, steps: int) -> dict:
    return {
        "step_s": [max(r["steps"][i]["step_s"] for r in results)
                   for i in range(steps)],
        "steps": results[0]["steps"],
        "step_s_by_rank": [[x["step_s"] for x in r["steps"]]
                           for r in results],
        "collective_s_by_rank": [[x["collective_s"] for x in r["steps"]]
                                 for r in results],
        "staged_bytes_by_rank": [[x["staged_bytes"] for x in r["steps"]]
                                 for r in results],
        "peak_gib_by_rank": [r["peak_gib"] for r in results],
        "kernel_launches_by_rank": [r["counts"] for r in results]}


def _parallel_mesh(device: str, work: str, card: str) -> tuple:
    """tp_serve, tp_train, reshard, fsdp, ep and ep_sp in one pool of
    PARALLEL_RANKS ranks, each held against one rank's work first; the
    ranks' cards first."""
    cfg, moe = _text_config("b1"), _text_config("moe")
    with open(os.path.join(work, "b1_single.json")) as f:
        b1 = json.load(f)
    b1_single = [tuple(x) for x in b1["steps"]]
    full_bytes = b1["state_bytes"]
    moe_single = _one_rank_steps("moe", MESH_EP_STEPS, device)
    ref_paths = [os.path.join(work, f"serve_ref_{i}.npy")
                 for i in range(PARALLEL_SERVE_REQUESTS)]
    pool = _parallel_pool(device)
    out, routes = {}, []
    t0 = time.monotonic()
    try:
        pool.start()
        out["rank_start_s"] = time.monotonic() - t0
        out["cards"] = pool.run(par_card_rank, device)
        parts = (("tp_serve", par_tp_serve_rank, (ref_paths,)),
                 ("tp_train", par_tp_train_rank, (work,)),
                 ("reshard", par_reshard_rank, (work,)),
                 ("fsdp", par_fsdp_rank, ()),
                 ("ep", par_ep_rank, ()),
                 ("ep_sp", par_ep_sp_rank, ()))
        results = {}
        for name, fn, args in parts:
            t1 = time.monotonic()
            results[name] = pool.run(fn, device, *args)
            out[name] = {"wall_s": time.monotonic() - t1}
    finally:
        pool.close()
    n_req = PARALLEL_SERVE_REQUESTS

    serve = results["tp_serve"]
    for rank, r in enumerate(serve):
        _check_launches(f"parallel tp_serve rank {rank}", r["counts"],
                        r["routes"], {"fwd": cfg.layers * n_req, "dq": 0,
                                      "dkdv": 0}, cfg.head_dim)
    _check_served("tp_serve", serve[0]["checks"], cfg)
    out["tp_serve"].update({
        "mesh": f"tp={PARALLEL_RANKS}",
        "latency_s": [max(r["latency_s"][i] for r in serve)
                      for i in range(n_req)],
        "checks": serve[0]["checks"],
        "staged_bytes_by_rank": [r["staged_bytes"] for r in serve],
        "collective_s_by_rank": [r["collective_s"] for r in serve],
        "peak_gib_by_rank": [r["peak_gib"] for r in serve],
        "kernel_launches_by_rank": [r["counts"] for r in serve]})
    routes += [r["routes"] for r in serve]

    def train_want(c, steps, kernels=True):
        n = c.layers * steps if kernels else 0  # ring: fp32 block math
        return {"fwd": 2 * n, "dq": n, "dkdv": n}

    for name, c, steps, single, kernels in (
            ("tp_train", cfg, MESH_TP_STEPS, b1_single[:MESH_TP_STEPS],
             True),
            ("reshard", cfg, 1, b1_single[MESH_TP_STEPS:MESH_TP_STEPS + 1],
             True),
            ("fsdp", cfg, MESH_FSDP_STEPS, b1_single[:MESH_FSDP_STEPS],
             True),
            ("ep", moe, MESH_EP_STEPS, moe_single, True),
            ("ep_sp", moe, MESH_EP_STEPS, moe_single, False)):
        res = results[name]
        for rank, r in enumerate(res):
            _check_launches(f"parallel {name} rank {rank}", r["counts"],
                            r["routes"], train_want(c, steps, kernels),
                            c.head_dim)
        _check_mesh_steps(name, res, single)
        out[name].update({"single_rank": single, **_mesh_summary(res, steps)})
        routes += [r["routes"] for r in res]
    out["tp_train"].update({
        "mesh": "dp=2 x tp=2",
        "state_bytes_by_rank": [r["state_bytes"]
                                for r in results["tp_train"]],
        "save_s": max(r["save_s"] for r in results["tp_train"])})
    out["reshard"].update({
        "mesh": f"dp=2 x tp=2 -> tp={PARALLEL_RANKS}",
        "restore_s": max(r["restore_s"] for r in results["reshard"]),
        "count": results["reshard"][0]["count"]})
    if results["reshard"][0]["count"] != MESH_TP_STEPS:
        raise AssertionError("the restored optimizer count is not the "
                             "saved one")
    out["fsdp"].update({"mesh": f"dp={PARALLEL_RANKS}, fsdp",
                        "state_bytes_by_rank": [
                            r["state_bytes"] for r in results["fsdp"]]})
    out["ep"].update({"mesh": f"dp={PARALLEL_RANKS} (experts over dp)",
                      "tokens": list(MOE_TRAIN_TOKENS)})
    out["ep_sp"].update({"mesh": "dp=2 x sp=2, ring (experts over dp, "
                                 "groups across sp)",
                         "tokens": list(MOE_TRAIN_TOKENS)})
    out["one_rank_state_bytes"] = full_bytes
    print(f"parallel cards: {_ranks_text(device)}: "
          + "; ".join(f"rank {c['rank']} {c.get('cuda_device')} "
                      f"{c.get('uuid')}" for c in out["cards"]), flush=True)
    for name in ("tp_train", "reshard", "fsdp", "ep", "ep_sp"):
        o = out[name]
        extra = (f"; state bytes a rank {o['state_bytes_by_rank'][0]} vs "
                 f"{full_bytes} on one rank" if "state_bytes_by_rank" in o
                 else "")
        print(f"parallel {name}: {o['mesh']}: losses "
              f"{[round(x['loss'], 5) for x in o['steps']]} vs one rank "
              f"{[round(x, 5) for x, _ in o['single_rank']]}; step s "
              f"{[round(x, 3) for x in o['step_s']]} (in collectives, rank "
              f"0 {[round(x, 3) for x in o['collective_s_by_rank'][0]]}); "
              f"staged bytes rank 0 {o['staged_bytes_by_rank'][0]}; peak "
              f"GiB by rank {[round(x, 2) for x in o['peak_gib_by_rank']]}"
              f"{extra}; launches rank 0 {o['kernel_launches_by_rank'][0]}"
              f" on {card}", flush=True)
    o = out["tp_serve"]
    print(f"parallel tp_serve: b1 at tp={PARALLEL_RANKS}, {n_req} requests "
          f"of {list(SERVE_TOKENS)}: latency s "
          f"{[round(x, 4) for x in o['latency_s']]}; gathered logits vs one "
          f"rank rel L2 {[round(c['rel_l2'], 6) for c in o['checks']]}; "
          f"staged bytes rank 0 {o['staged_bytes_by_rank'][0]}; K1 launches"
          f" by rank {[c['fwd'] for c in o['kernel_launches_by_rank']]} on "
          f"{card}", flush=True)
    print(f"parallel reshard: restored at tp={PARALLEL_RANKS} in "
          f"{out['reshard']['restore_s']:.2f} s (saved at dp2 x tp2 in "
          f"{out['tp_train']['save_s']:.2f} s)", flush=True)
    return out, _merge_routes(*routes)


def _parallel_nccl_refused(device: str, work: str, card: str) -> tuple:
    """Two NCCL ranks on card 0 must refuse to start: NCCL takes one rank
    per card, and nothing switches to gloo on its own."""
    from ray_tpu_torch.parallel.multihost import RankPool

    pool = RankPool(2, backend="nccl", cuda_device=0,
                    timeout_s=PARALLEL_TIMEOUT_S)
    t0 = time.monotonic()
    try:
        pool.start()
    except RuntimeError as exc:
        message = str(exc)
    else:
        pool.close()
        raise AssertionError("two NCCL ranks started on one card")
    # the pool reports the first rank's failure (every rank runs the
    # same check on the same keys)
    if "NCCL needs one device per rank" not in message:
        raise AssertionError(f"NCCL ranks on one card: {message}")
    print(f"parallel nccl: two NCCL ranks on card 0 refused in "
          f"{time.monotonic() - t0:.1f} s on {card}", flush=True)
    return {"refused": True, "rank_start_s": time.monotonic() - t0,
            "message": message.splitlines()[-1]}, {}


def phase_parallel(report: dict, device: str = "cuda") -> dict:
    """parallel/ and collective/ on the card: four gloo ranks on card 0
    serve b1 sequence-parallel (Ulysses through K1, and ring), run one
    Ulysses forward and backward at b1's train shape, train b1 as a
    4-stage GPipe pipeline through K1-K3, then (one pool for the mesh
    parts) serve b1 at tp 4, train it at dp 2 x tp 2, restore that
    state at tp 4 and take the next step, train it at FSDP dp 4, and
    train the bench MoE model with its experts over dp 4; each held
    against the same work on one rank of this process first."""
    import shutil
    import tempfile

    import ray_tpu_torch

    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    _free_card(device)
    card = report.get("card") or card_line()
    work = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    out, routes = {"card": card, "ranks": PARALLEL_RANKS,
                   "transport": ("nccl, one rank a card" if _nccl(device)
                                 else "gloo, staged through pinned host "
                                      "memory")}, []
    try:
        for name, run in (("serve", _parallel_serve),
                          ("ulysses", _parallel_ulysses),
                          ("pipeline", _parallel_pipeline),
                          ("mesh", _parallel_mesh),
                          ("nccl", _parallel_nccl_refused)):
            t0 = time.monotonic()
            out[name], part = run(device, work, card)
            out[name]["wall_s"] = time.monotonic() - t0
            routes.append(part)
            print(f"parallel {name}: {out[name]['wall_s']:.1f} s (ranks "
                  f"started in {out[name]['rank_start_s']:.1f} s)",
                  flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        report["parallel"] = out
    if _nccl(device):
        _check_nccl_ranks(out)
    return _merge_routes(*routes)


def _staged(tree, path: str = "") -> dict:
    """{path: value} of every staged-bytes entry in a report tree."""
    found = {}
    if isinstance(tree, dict):
        for key, value in tree.items():
            where = f"{path}.{key}" if path else key
            if key.startswith("staged_bytes"):
                found[where] = value
            else:
                found.update(_staged(value, where))
    return found


def _check_nccl_ranks(out: dict) -> None:
    """With one NCCL rank a card: four distinct cards, nothing staged
    through host memory; each mesh part's per-rank step seconds, share
    inside the collectives and peak memory printed."""
    uuids = [c.get("uuid") for c in out["mesh"]["cards"]]
    if len(set(uuids)) != PARALLEL_RANKS or None in uuids:
        raise AssertionError(f"parallel: ranks' cards {uuids}: not "
                             f"{PARALLEL_RANKS} distinct")

    def nonzero(v):
        return any(nonzero(x) for x in v) if isinstance(v, list) else v != 0

    staged = {k: v for k, v in _staged(out).items() if nonzero(v)}
    if staged:
        raise AssertionError(f"parallel over NCCL staged bytes: {staged}")
    for name in ("tp_train", "reshard", "fsdp", "ep", "ep_sp"):
        o = out["mesh"][name]
        for rank in range(PARALLEL_RANKS):
            step_s = o["step_s_by_rank"][rank]
            coll_s = o["collective_s_by_rank"][rank]
            print(f"parallel {name} rank {rank} ({uuids[rank]}): step s "
                  f"{[round(x, 4) for x in step_s]}, in collectives "
                  f"{100 * sum(coll_s) / sum(step_s):.1f} %, staged bytes "
                  f"0, peak GiB {o['peak_gib_by_rank'][rank]:.2f}",
                  flush=True)


def phase_dryrun(report: dict) -> None:
    """The multichip dry run (tools/multichip.py) on PARALLEL_RANKS
    ranks: gloo on card 0, or NCCL one a card with --cards."""
    import ray_tpu_torch
    from ray_tpu_torch.tools.multichip import dryrun_multichip

    if ray_tpu_torch.is_initialized():
        ray_tpu_torch.shutdown()
    _free_card("cuda")
    backend = "nccl" if _nccl("cuda") else "gloo"
    t0 = time.monotonic()
    rows = dryrun_multichip(PARALLEL_RANKS, device="cuda", backend=backend)
    report["dryrun"] = {"backend": backend, "rows": rows,
                        "wall_s": time.monotonic() - t0}
    if backend == "nccl":
        cards = rows[0]["cards"]
        staged = [r["staged_bytes_by_rank"] for r in rows[:3]]
        if len(set(cards)) != PARALLEL_RANKS or any(map(any, staged)):
            raise AssertionError(f"dryrun over NCCL: cards {cards}, "
                                 f"staged bytes {staged}")


def _at_shapes(report: dict, kernel: str) -> dict:
    """The kernel's time, bound, plain and library times at the moe and
    vit train shapes and at the head dims off 64 and 128 (kernel phase
    rows)."""
    out = {}
    rows = {r["shape"]: r for r in report[
        "kernel_shapes" if kernel == "fwd" else "bwd_shapes"]}
    for name in ("moe", "vit", *HEAD_DIM_SHAPES):
        if name not in rows:  # a forward-only row
            continue
        r = rows[name]
        if kernel == "fwd":
            out[name] = {k: r[k] for k in ("route", "ms", "plain_ms",
                                           "bound_ms", "bound_by",
                                           "library_ms", "library_backend")}
        else:
            out[name] = {"route": r["routes"][kernel],
                         "ms": r[f"{kernel}_ms"], "plain_ms": r["plain_ms"],
                         "bound_ms": r[f"{kernel}_bound_ms"],
                         "bound_by": r[f"{kernel}_bound_by"],
                         "library_ms": r["library_ms"],
                         "library_backend": r["library_backend"]}
    return out


def _kernel_table(report: dict, paths: dict) -> list:
    """The kernels JSON line: each kernel at the b1 train shape, its
    launches per path and route, and its rows at the moe and vit
    shapes."""
    for path in ("moe", "vit"):  # serve and train launches of a model
        paths[path] = _merge_routes(paths.pop(f"{path}_serve"), paths[path])
    fwd = next(r for r in report["kernel_shapes"] if r["shape"] == "train")
    bwd = next(r for r in report["bwd_shapes"] if r["shape"] == "train")
    shape = "B8 S2048 H16 D128 causal bfloat16 (the b1 train step)"
    csrc = "ray_tpu_torch/ops/csrc/"

    def launches(kernel):
        by_path = {p: sum(r[kernel].values()) for p, r in paths.items()}
        return {"launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "launches_by_route": {p: r[kernel]
                                      for p, r in paths.items()}}

    def head_dims(kernel):
        """{route: the head dims the kernel phase ran on it}."""
        rows = (report["kernel_shapes"] if kernel == "fwd"
                else report["bwd_shapes"])
        out = {}
        for r in rows:
            route = r["route"] if kernel == "fwd" else r["routes"][kernel]
            out.setdefault(route, set()).add(r["D"])
        return {route: sorted(ds) for route, ds in out.items()}

    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "kernel_route": fwd["route"],
        "source": csrc + "flash_attn_fwd.cu",
        # the wgmma kernel and C entry, then the padded wgmma kernel and
        # its TMA and cp.async feeds, the fp32 ring kernel (its one-slice
        # launcher) and, past 256, the wgmma kernel and its two feeds and
        # the ring kernel's slices
        "sources": [csrc + f for f in ("flash_attn_fwd.cu",
                                       "flash_attn_fwd_padded.cuh",
                                       "flash_attn_fwd_padded.cu",
                                       "flash_attn_fwd_padded_cp_async.cu",
                                       "flash_attn_ring_f32.cuh",
                                       "flash_attn_fwd_fma_ring.cu",
                                       "flash_attn_dchunk_fwd_wgmma.cuh",
                                       "flash_attn_dchunk_fwd_wgmma.cu",
                                       "flash_attn_dchunk_fwd_cp_async.cu",
                                       "flash_attn_dchunk_fma.cu")],
        "replaces": "ray_tpu/ops/attention.py:202",
        **launches("fwd"), "head_dims_by_route": head_dims("fwd"),
        "max_abs_err": max(r["max_abs_err"]
                           for r in report["kernel_shapes"]),
        "ms": fwd["ms"], "plain_ms": fwd["plain_ms"],
        "bound_ms": fwd["bound_ms"], "bound_by": fwd["bound_by"],
        "library_ms": fwd["library_ms"], "shape": shape,
        "at_shapes": _at_shapes(report, "fwd"),
    }]
    for name, kernel, line, errs in (
            ("flash_attention_bwd_dq", "dq", 356, ("dq",)),
            ("flash_attention_bwd_dkdv", "dkdv", 404, ("dk", "dv"))):
        kernels.append({
            "name": name, "route": "cuda",
            "kernel_route": bwd["routes"][kernel],
            "source": csrc + "flash_attn_bwd.cu",
            # the wgmma kernels at d 64/128 and padded D (the padded one
            # and its TMA and cp.async feeds), fp32 up to 256 (K2 FMA, K3
            # the ring kernel's one-slice launcher), and past 256 the
            # wgmma kernel and its two feeds and the ring kernel's slices
            "sources": [csrc + f for f in (
                "flash_attn_bwd.cu",
                "flash_attn_bwd_dq_ws.cuh" if kernel == "dq"
                else "flash_attn_bwd_dkdv_padded.cuh",
                f"flash_attn_bwd_{kernel}_padded.cu",
                f"flash_attn_bwd_{kernel}_padded_cp_async.cu",
                "flash_attn_bwd_fma.cu" if kernel == "dq"
                else "flash_attn_bwd_dkdv_fma_ring.cu",
                "flash_attn_dchunk_bwd_wgmma.cuh",
                f"flash_attn_dchunk_bwd_{kernel}_wgmma.cu",
                f"flash_attn_dchunk_bwd_{kernel}_cp_async.cu",
                "flash_attn_ring_f32.cuh",
                f"flash_attn_dchunk_bwd_{kernel}_fma.cu")],
            "replaces": f"ray_tpu/ops/attention.py:{line}",
            **launches(kernel), "head_dims_by_route": head_dims(kernel),
            "max_abs_err": max(r["max_abs_err"][e]
                               for r in report["bwd_shapes"] for e in errs),
            "ms": bwd[f"{kernel}_ms"],
            # the plain backward and SDPA's backward compute dq, dk and
            # dv in one call: the same time stands in both rows
            "plain_ms": bwd["plain_ms"],
            "bound_ms": bwd[f"{kernel}_bound_ms"],
            "bound_by": bwd[f"{kernel}_bound_by"],
            "library_ms": bwd["library_ms"], "shape": shape,
            "at_shapes": _at_shapes(report, kernel),
        })
    return kernels


def main(argv=None) -> int:
    import argparse

    import torch

    global PARALLEL_CARDS
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cards", type=int, default=1,
                        choices=(1, PARALLEL_RANKS),
                        help="cards for the parallel and dryrun phases: "
                             "with 4, only those phases (and build) run, "
                             "one NCCL rank a card")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < args.cards:
        print(f"chip_smoke: --cards {args.cards} with "
              f"{torch.cuda.device_count()} visible CUDA cards",
              file=sys.stderr)
        return 2
    import ray_tpu_torch  # noqa: F401 — a bare directory fails here

    PARALLEL_CARDS = args.cards
    report: dict = {"phase_s": {}, "cards": args.cards}
    paths, failed = {}, []
    t_start = time.monotonic()
    phases = (
            ("build", phase_build), ("kernel", phase_kernel),
            ("debug", phase_debug),
            ("sched", phase_sched), ("serve", phase_serve),
            ("b1_h4_serve", lambda r: phase_serve(r, "b1_h4")),
            ("serve_lib", phase_serve_lib),
            ("proc_serve", phase_proc_serve),
            ("cluster", phase_cluster),
            ("train", phase_train),
            ("xl16", phase_xl16),
            ("b1_h4_train", phase_b1_h4_train),
            ("entry_train", phase_entry_train),
            ("moe_serve", lambda r: phase_serve(r, "moe")),
            ("moe", phase_moe),
            ("vit_serve", lambda r: phase_serve(r, "vit")),
            ("vit", phase_vit),
            ("data", phase_data),
            ("tune", phase_tune),
            ("rllib", phase_rllib),
            ("workflow", phase_workflow),
            ("persist", phase_persist),
            ("client", phase_client),
            ("util", phase_util),
            ("ops", phase_ops),
            ("dash", phase_dash),
            ("parallel", phase_parallel),
            ("dryrun", phase_dryrun))
    if args.cards > 1:
        phases = tuple(p for p in phases
                       if p[0] in ("build", "parallel", "dryrun"))
        print(subprocess.run(["nvidia-smi", "topo", "-m"],
                             capture_output=True, text=True).stdout,
              flush=True)
    for name, phase in phases:
        t0 = time.monotonic()
        try:
            routes = phase(report)
        except Exception as exc:  # the later phases still run and report;
            # the script fails below, with no result line
            traceback.print_exc()
            failed.append(f"{name}: {exc!r}"[:500])
            continue
        finally:
            report["phase_s"][name] = time.monotonic() - t0
        if routes is not None:
            paths[name] = routes
    report["total_s"] = time.monotonic() - t_start
    print(f"phases s {({k: round(v, 1) for k, v in report['phase_s'].items()})}"
          f", total {report['total_s']:.1f}", flush=True)
    if failed:
        report["failed"] = failed
    elif args.cards == 1:
        report["kernels"] = _kernel_table(report, paths)
    report.pop("_serve_last_logits", None)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1, default=str)
    if failed:
        print("chip_smoke: failed phases:\n  " + "\n  ".join(failed),
              file=sys.stderr)
        return 1
    if args.cards == 1:
        print(json.dumps({"kernels": report["kernels"]}))
    else:
        print(json.dumps({"parallel_nccl": {
            "cards": report["parallel"]["mesh"]["cards"],
            "dryrun": report["dryrun"]["rows"]}}, default=str))
    print(report["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
