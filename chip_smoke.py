#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``coldrec_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printed with its seconds:
  1. device   the card's name and power limit (nvidia-smi) and torch's name;
  2. build    nvcc builds the kernels from ``coldrec_tpu_torch/csrc``, and
              the host compiler the negative sampler and FSGNN's PPR push
              beside them; then phase sass counts the tensor-core
              instructions (HMMA/HGMMA) of every instance of the bf16 sweep
              in the library's SASS (``cuobjdump``, those functions only)
              and fails where one has none (without cuobjdump, the bf16
              sweep's time below the CUDA cores' FMA bound in phase 8
              stands in);
  3. kernel   the retrieval kernel against its plain PyTorch version at
              d=64 on 2048 users x 270,170 items (kernel-bx) and 2048 x
              3,706 items (kernel-ml): the candidate values and ghosts agree
              within ``VALUE_TOL``, every non-candidate scores <= the user's
              max ghost, and the final top-k ids equal the exact plain
              path's on every row whose top-(k+1) scores are separated by
              more than ``GAP_REL``; kernel-ml adds an integer table with
              NaN item rows (bit-equal, NaN at the same places; no NaN in a
              slot, and the ghost NaN exactly in the lane classes of NaN
              items that are not excluded); kernel-ml repeats both checks
              for the sweep's bf16 instance (plain version: the fp32 sweep
              of the bf16-rounded tables);
  4. kernel-int  integer tables at 2048 and at 512 users x 270,170 items:
              the sweep (split into parts and merged at 512) bit for bit
              equal to its plain version, and the merge kernel equal to its
              plain version on the plain per-part sweeps; the bf16 instance
              bit for bit on the same tables (|x| <= 64: exact in bf16);
  5. slice    the main path at book-crossing shape: MF tables written to the
              npz bus, served through ``RetrievalServer`` (8 requests of 512
              users, then raw ids) and three-way tested through
              ``EvalSweep.run_kernel``; the same lists through the plain path
              must agree by the rule of phase 3, and both kernels (sweep and
              merge) must have launched (launch counts are zeroed just before
              the main path); then the steps of ``retrieval_topk`` after the
              kernel timed on their own for the overall test setting;
  knn         content KNN (``ops/knn.py``) at book-crossing's content
              widths: (a) 54,034 x 216,136 at d=416, k=5 (KNN, item cold),
              (b) 18,422 x 73,685 at d=2,312, k=5 (KNN, user cold), (c)
              270,170 x 216,136 at d=416, k=11 (AGNN's item side), (d)
              270,170 x 270,170 at d=416, k=16 and (e) 92,107 x 92,107 at
              d=32, k=16, each table against itself (FSGNN's item and user
              graphs); the entry point (the kernel route on the card,
              launch counts zeroed just before and read just after)
              against the plain route: on integer tables in [-3, 3] ids and
              values bit for bit (a, b, e), and the first 2048 queries'
              sweep bit for bit (a, b, d, e)
              against its plain version; on N(0,1) tables ids equal but
              at near-ties by the rule of phase 3; each shape's entry
              point and plain route timed on those tables, then timed
              warm: the kernel's sweeps alone (CUDA events) and the
              library yardstick (TF32-off
              ``torch.mm`` + ``topk(k + 1)`` per chunk) beside the bound,
              with its fallback rows and peak card memory;
  6. train    MF trained through the port's CLI entry
              (``coldrec_tpu_torch.main.run``) at book-crossing shape from a
              split directory, d=64, bs 4096, lr 1e-3, reg 1e-4, 2 epochs,
              validated every epoch through the kernel (launch counts zeroed
              just before the run and read just after: ``fused_sweep`` must
              have launched for every validation and the test); the loss
              must fall (last 50 batches below the first 50), validation
              NDCG@20 of the trained (bus) tables must beat the untrained
              tables', the three-way-test lists of the trained tables must
              equal the plain path's by the rule of phase 3, the result and
              bus files must be written; each epoch's time split (host
              batches, upload, step enqueue, device step from CUDA events,
              validation) is printed; then 20 MF steps on the card are held
              against the same 20 on the CPU from the same tables and
              batches; the split (item content of 416 N(0,1) columns,
              book-crossing's) and the MF bus stay for phase cold;
  cold        the cold-start models through the CLI on that split and bus
              (d=64, bs 4096; here and in phases content, recon, usim,
              graph and graph-user each run is handed the split read once
              by its phase and trains the first eighth of every epoch,
              ``EPOCH_STEPS`` of 215 batches, USIM ``USIM_EPOCH_STEPS`` of
              53): DropoutNet (hidden 200/100, n_dropout 0.5),
              GAR, ALDI, DeepMusic, DUIF and Heater 1 epoch each, each
              with its launch counts zeroed before and read after
              (``fused_sweep`` must have launched; ALDI's tables are 128
              wide), its time split, loss and test time logged, and the
              three-way-test lists of its bus tables held to the plain path
              by the rule of phase 3; DropoutNet once more under
              ``--eval_backend pallas_bf16`` (only the bf16 instance may
              launch; lists held to the plain path on the bf16-rounded
              tables); then 20 DropoutNet and 20 ALDI steps on the card
              against the same steps on the CPU (same weights, batches and
              dropped rows);
  content     the content-feature cold models through the CLI on that
              split and MF bus (d=64, bs 4096, one epoch each): KNN, AGNN,
              VBPR, then AMR on VBPR's bus, MTPR, MetaEmbedding, LARA,
              CLCRec and GoRec, each checked as in phase graph (launches,
              time split, fallback, peak memory, lists held to the plain
              path, every split's route) with its content searches
              (``knn_route`` events) on the JAX package's route; then 20
              VBPR steps (Adagrad + Adam) and 20 MetaEmbedding steps
              (second order) on the card against the same steps on the
              CPU, held as phase cold holds DropoutNet's, VBPR's free run
              in float64 on both devices and its float32 steps each from
              the CPU's state (``SYNCED_STEPS``), element by element: an
              element that float32 cannot sign is named and bounded
              (``synced_step_gap``);
  recon       the reconstruction-family models through the CLI on that
              split and MF bus (d=64, bs 4096, one epoch each): CCFCRec
              and M2VAE (``ccfcrec_batches``: 983,040 and 1,642,496
              warm-pool negatives a step), CGRC (its evaluation rebuilds Ĝ
              on the host after the top-20 users of every cold item by the
              edge MLP) and FSGNN (PPR by the native push, its two cosine
              kNN graphs, 270,170 items at d=416 and 92,107 users at the 32
              fallback columns, through the kernel), each checked as in
              phase content, with FSGNN's graph build and CGRC's
              evaluations (top-k users, Ĝ rebuild, propagation) logged;
              then 20 CCFCRec and 20 M2VAE steps on the card against the
              CPU (M2VAE's normals drawn on the host), held as phase cold
              holds DropoutNet's, CCFCRec's as VBPR's; CGRC's peak card
              memory over its CLI run, and (on that run's trainer) its
              top-k users of the first 2,048 cold items held against the
              CPU's; FSGNN's step (on its run's trainer) beside its SpMM
              applies and GAT segment ops;
  usim        USIM through the CLI on that split and MF bus at its
              published widths (92,108 actions: the 92,107 users and the
              stop token; max_time 7, k 10; d=64, bs 4096: 53 batches),
              one epoch of 7 batches, checked as in phase content, each
              epoch's split logged (host batches, step enqueue, device
              step, the greedy inference of the 54,034 cold items,
              validation, the test);
              then one step at bs 256 on the card against the CPU from
              the same weights and draws (rollout actions equal, losses,
              nets) after the greedy inference of 2,048 cold items
              (actions equal, states); phase usim-split, after the checks
              are joined (below), runs ``tools/profile_usim.py``'s
              functions on that run's trainer: ``_eval_tables`` twice and
              the validation sweep (launch counts zeroed just before and
              read just after: ``fused_sweep`` must have launched), one
              batch step split by CUDA events into its phases (the
              hoisted top-ks, the 3 x 7 rollout steps, the PPO targets,
              each of the 5 PPO iterations, the termination step) and the
              inference of one 4096-item chunk, each beside its bound,
              ``_rollouts`` alone, the in-place ceilings (the chained
              4096 x 65 @ 65 x 92,107 product with a logsumexp, with a
              top-10) and each phase's floor fraction; held: the phases'
              sum equal to the step's own span within 1e-3, every time
              finite;
  graph       the graph backbones through the CLI on that split (d=64, bs
              4096, --layers 2), one epoch each: LightGCN, NGCF, SimGCL,
              XSimGCL and NCL (BASELINE config 2's model and config 5's
              backbone), each with its launch counts zeroed before and read
              after (``fused_sweep`` must have launched), its time split,
              the exact fallback's rows and seconds during the run (SimGCL
              and XSimGCL give the edgeless cold items all-zero rows, so
              every cold-setting row is an all-tie), its peak card memory,
              and its three-way-test lists held to the plain path by the
              rule of phase 3; first the check that fp32 products run with
              TF32 off; then NCL past its warm-up on the card (k-means of
              both tables timed, the e-step, 20 steps with the proto term:
              finite losses); then one SpMM apply alone (its ELL part
              summed by ``embedding_bag`` and by gather + ``bmm``, its
              tail by ``index_add_`` and by ``segment_reduce``,
              forward + backward, ``torch.sparse.mm`` on the same CSR
              matrix as the yardstick) beside its byte bound, and its share
              of a LightGCN step;
  graph-user  BASELINE config 5 at book-crossing shape: a user-cold split
              with 2,312 N(0,1) user-content columns, XSimGCL 1 epoch, then
              Heater on its bus (``--backbone XSimGCL``) 1 epoch, each
              checked as in phase graph, every split on the JAX package's
              route;
  cold-signal a latent-factor split at MovieLens-1M shape (6,040 x 3,706 x
              1,000,209, item content 206 columns: a noisy view of the item
              factors); MF, then DropoutNet on its bus, 1 epoch each
              through the CLI; the route of every split (kernel or plain
              sweep) must be the one the JAX package takes (a split with a
              user rated beyond the kernel's candidates goes plain); the
              cold-setting NDCG@20 of both and of random tables (chance)
              are logged side by side, not held to an order (a finding,
              PERF.md §6);
  graph-ml    BASELINE config 2 at that shape: LightGCN 1 epoch through
              the CLI on the latent split (every split on the JAX package's
              route: the plain sweep), then 20 LightGCN and 20 SimGCL steps
              on the card against the same steps on the CPU (same tables
              and batches; SimGCL's noise drawn on the host and injected
              into both; SimGCL held step by step from the CPU's state,
              on the steps in which no element's sign flips: its noise
              takes sign(e), so its free runs part);
  7. variants the kernel-variant experiments (``coldrec_tpu_torch/tools``):
              first their path, driven through the tools' entry points with
              every launch count zeroed just before and read just after
              (``exp_retrieval_kernels.main`` at the tools' width of 2048
              users x 270,336 items, ``exp_multiacc.check`` and one
              ``exp_blockskip.check_exact`` regime at a small size); then
              every variant kernel held bit for bit against its own plain
              version on integer tables at that width: dot in both layouts,
              stream at block_i 2048 and 8192, multiacc at P = 1, 2, 4, 8,
              skip at tile_u 64 and 256 with floors rv[0] and rv[7], and a
              table on which skips fire (count > 0 and equal); then on an
              integer table with NaN item rows (NaN equal to NaN at the
              same places): dot in both layouts, stream at both block_i,
              multiacc at every P at block_i 8192 and at 384 (3 slices, no
              multiple of P > 1), skip at both tile_u;
  bench       after the checks are joined: the port's bench entry
              (``python -m coldrec_tpu_torch.bench``) in a subprocess at
              full shape; its one JSON line logged, every figure finite and
              positive, its ``device_kind`` this card's; then the kernel's
              lists at both of its sweep shapes (4096 x 270,336 and 6,040 x
              3,706) held to the plain route's by the rule of phase 3;
  mfstep      ``tools/profile_train.py``'s modes at the JAX tools'
              problems, launch counts zeroed just before and read just
              after: ``--split`` (MF at 92,107 x 270,170, d=64, bs 4096:
              the full step, through the sorted lookup, grad only, Adam
              only, forward only, ms a step by the two-point difference;
              the gradient A/B), ``--chain`` (the stacked step over 64,
              32, 64, 32 batches, 5 reps each) and ``--scatter`` (12,288
              rows into 270,170 x 64: ``index_add_``, the gather's
              backward, sorted, duplicates combined, each held to
              ``np.add.at`` within 1e-3); then ``exp_fused_steps`` for
              LightGCN on phase scale's XING dataset, K 32: the sequential
              steps and the ``--fused_steps`` path held to the JAX tool's
              limits (losses rtol 2e-4, weights rtol 3e-4 atol 3e-6), then
              timed; every time finite;
  profile     on a split of ``synthetic_interactions`` at MovieLens-1M
              shape (every split through the kernel, unlike phase
              cold-signal's): MF one epoch through the CLI, plain, with
              ``--profile DIR`` (the Chrome trace must load and name
              ``fused_sweep_kernel`` among its device kernels; its top 10
              kernels by device time logged) and with ``--debug_nans``,
              each run's seconds per epoch logged;
  fused       MF and XSimGCL 1 epoch each through the CLI on that split,
              ``--fused_steps 8`` against ``--fused_steps 0``, with
              deterministic algorithms on (the SpMM tail's atomics would
              part the runs on their own): bus tables within rtol 1e-5,
              atol 1e-6, test lists id-equal but at near-ties, each run's
              epochs logged;
  search      the port's search driver (``param_search.main``) in a
              temporary working directory on that split, deterministic
              algorithms on: 3 MF trials of 1 epoch, then a resume to 4
              that runs exactly one more; the params the port's
              ``RandomTrial`` draws for the slug, every value finite, the
              pickle the best journal line's params and its sidecar its
              value, ``view_best`` printing them, one CLI run of those
              params giving the best value again (equal), the card's
              allocated memory after trial 3 within 5% of that after trial
              1, ``fused_sweep`` launched in every trial; each trial's
              seconds, launches and allocated memory logged;
  parse       phase train's seven split CSVs (1,655,116 rows, 876,642 of
              them in the training file) read by the port's loader (the
              C++ parser) and by ``np.loadtxt``,
              arrays equal, the seconds of each logged (warm reads);
  scale       the port's ``scale_run`` (``coldrec_tpu_torch/tools``)
              through its command line at the XING shape (106,881 x
              20,519, item content 2,738 wide; its dataset built by the
              tool's ``build_dataset`` on a thread from the start of the
              script): MF one whole epoch (every batch of 4096) with
              ``--save_emb 1``, then DropoutNet one whole epoch on its bus,
              each run a CLI process; held: exit 0, the JAX tool's JSON
              line per run, every topN x setting x metric finite in both
              result files, whole epochs, MF's validation NDCG@20 above
              its untrained tables', every ranked split on the kernel
              route, ``fused_sweep`` launched in each run (its ``run_end``
              event's counts go to the ``kernels`` line), and each bus's
              lists for the first 512 users of each test setting equal to
              the plain path's by the rule of phase 3; each epoch's split,
              the test and wall seconds logged;
  serving     ``ubench_serving`` in its three modes at its defaults (92,107
              x 270,336, d=64, k=20; the bf16 A/B on phase train's MF
              bus): p50/p95 of ``RetrievalServer.topk`` at bs 1 to 4096,
              device ms a batch, fp32 against bf16 and the lists' drift;
              held: every time finite, each batch size's lists and the
              bf16 lists equal to the plain path's by the rule of phase 3,
              the drift equal to a recount;
  ubench      ``ubench_sweep`` at 1024 x 270,336, d=256 (each kernel, fp32
              and bf16, bit for bit against its plain version on integer
              tables first), the matmul ceilings, the plain path, the raw
              and the padded sweep beside their bounds; ``ubench_spmm`` on
              its ML and book-crossing slabs, every form held to
              ``torch.sparse.mm``;
  mesh        the process group and the mesh (``coldrec_tpu_torch/parallel``):
              ranks are subprocesses of this script (``--rank``, started by
              ``launch_ranks`` with the ``COLDREC_*`` variables), all on
              ``cuda:0``, their collectives over gloo through host memory,
              every check against one rank in this process: (a) a 1x2 mesh
              ``RetrievalServer`` on phase train's split with MF tables
              seeded as phase slice's (92,107 x 270,170, d=64; each rank
              sweeps its 135,085 items): 4 requests of 512 users and one of
              2048, excluding rated items, lists equal to the one-rank
              server's by the rule of phase 3, every rank launching
              ``fused_sweep`` on every request, seconds per request logged
              beside the one-rank server's and the staging seconds; (b) MF
              ``--mesh 1x2`` on phase train's split, one epoch (215
              batches), kernel eval,
              deterministic algorithms on in the ranks and the one-rank
              run: losses and bus tables bit-equal to one rank's, equal test
              metrics, rank 0 alone writing the result file (both ranks
              append to one) and the bus; (c) MF on 2 ranks with no
              ``--mesh`` (data-parallel) one epoch on phase profile's split
              with the plain (partitioned) eval: losses within 1e-5
              relative, test metrics within 1e-9 or, where they differ, the
              lists of both buses id-equal but at near-ties; (d) LightGCN
              ``--mesh 2x2`` (4 ranks, 2 layers; one epoch, 123
              batches) held as (c), kernel eval.
              The rank groups of (a)-(d) start at once, beside the
              one-rank runs; as soon as (c)'s two ranks have written the
              MF bus, on it, (e) DropoutNet ``--mesh 1x2``
              one epoch, deterministic, held as (b), and (f) DropoutNet
              ``--mesh 2x2`` (4 ranks; BatchNorm statistics over the global
              batch), deterministic: its first 20 losses within 1e-5
              relative (the float32 runs part later, on the CPU too), its
              eval tables within 1e-5 and its test metrics within 2e-3,
              the losses' gaps logged by step, each
              rank's BatchNorm running statistics equal (sha256 in its
              line), kernel eval (the same run in float64, where the
              losses stay within 1e-12, is
              ``coldrec_tpu_torch/tools/mesh_drift.py --device cuda``).
              Then, on ``ml_synth``, each trained for
              ``MESH_STEPS`` batches of one epoch (its one-rank run too;
              ``--epoch_steps`` among the rank flags), kernel eval, each
              held as (c): (g) XSimGCL ``--mesh 2x2`` and (h) SimGCL
              ``--mesh 1x2``, deterministic (2 layers; the noise drawn as
              the whole plane on every rank, the InfoNCE over the global
              batch); (i) NGCF ``--mesh 2x2`` (its Linears' gradients
              summed over the model group); (j) NCL ``--mesh 2x2``,
              deterministic, its proto term and e-step on from epoch 0
              (``--ncl_proto``: the k-means of the gathered tables on
              every rank); (k) CGRC ``--mesh 2x2``, deterministic, on
              ``ml_synth`` with ``ML_CONTENT`` N(0,1) item columns (the
              user table row-sharded, every rank building the same Ĝ).
              The ranks of (g), (h) and (k) record every perturbed
              layer's values or every Ĝ top-k with its logits
              (``mesh_record``); their one-rank runs come after them and,
              where a perturbed element took the other sign or a cold
              item's top-k users differ, must find a float32 tie
              (``MESH_TIE_REL``; CGRC's logits at the ranks' top-k within
              ``MESH_LOGIT_DRIFT``) and take the ranks' side
              (``mesh_replay``): anything else fails the phase, and the
              two runs do not part at a tie (float64: ``mesh_drift
              --model``).
              Then the eleven cold models, each ``MESH_STEPS`` batches
              of one epoch on ``ml_synth`` with ``ML_CONTENT`` item
              columns, deterministic, kernel eval: ``--mesh 1x2`` held
              bit for bit as (b): (l) DUIF, (m) KNN (2-layer LightGCN
              encoder), (n) LARA, (o) DeepMusic, (p) Heater;
              ``--mesh 2x2`` held as (c): (q) GAR, (r) CLCRec, (s)
              CCFCRec, (t) AGNN, (u) MetaEmbedding, (v) GoRec (its
              BatchNorm statistics over the global batch, every rank's
              equal); (n)-(q) and (t)-(v) on (c)'s MF bus.
              (h), (l), (m) run in (b)'s ranks after it, (g), (i), (j),
              (k), (r), (s) in (d)'s, (n)-(p) in (e)'s and (q), (t)-(v)
              in (f)'s (``MESH_CHAINS``: one start-up and fewer processes
              sharing the card), each run with its own stats;
  8. timing   CUDA-event times of one sweep of every kernel (2048 users, and
              the 512-user serving request for the sweep, its bf16 instance
              and the merge): the kernel, its plain version and one library
              yardstick, beside the least time the card could take (for the
              bf16 instance the tensor cores' bf16 rate, with the CUDA
              cores' fp32 FMA rate beside it). The merge is timed alone
              as well (100 launches in one CUDA graph: its device time) at
              512 users x the kernel's parts and 2048 users x 2 parts;
              timing-variants first logs each kernel's registers and spill
              bytes (the build's ``-Xptxas -v``), the skip kernel's
              resident clusters per layout, and every P and tile_u time.

Every card-vs-CPU check runs its card side in its phase and hands its CPU
side (which depends only on the split, the initial weights and the draws)
to a worker thread (``CHECKS``), which takes three quarters of the
intra-op threads; its comparison runs at a later phase boundary or when
the checks are joined after the last phase, and a failure there fails
the run. Synced checks step the card from each of the CPU's recorded
states at that point.
Then it prints the ``{"kernels": [...]}`` line, the nvidia-smi line, and as
the last line ``{"ok": true, "device": {...}}``. Any failure raises, so the
exit code is non-zero and no result line is printed. With no card it exits
non-zero at once. The whole run is held to ``BUDGET_S`` seconds.

The phase functions take a ``device`` argument so that the tests can
rehearse them on the CPU at a tiny size, where the kernel wrapper computes
its plain version.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import hashlib
import io
import itertools
import json
import math
import os
import pickle
import random
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings

import numpy as np
import torch

from coldrec_tpu_torch import bench as tbench
from coldrec_tpu_torch import main as tmain
from coldrec_tpu_torch import native
from coldrec_tpu_torch.config import default_args, make_args
from coldrec_tpu_torch.data import loader as tloader
from coldrec_tpu_torch.data.builder import ColdStartDataset
from coldrec_tpu_torch.data.sampler import pairwise_batches
from coldrec_tpu_torch.data.split import cold_start_split, write_split_dir
from coldrec_tpu_torch.data.synthetic import (
    latent_content, latent_interactions, synthetic_dataset,
    synthetic_interactions,
)
from coldrec_tpu_torch.models import TRAINERS
from coldrec_tpu_torch.models import cgrc as cgrc_mod
from coldrec_tpu_torch.models import ncl as ncl_mod
from coldrec_tpu_torch.models import simgcl as simgcl_mod
from coldrec_tpu_torch.models import usim as usim_mod
from coldrec_tpu_torch.models.common import MaskedBatchNorm1d
from coldrec_tpu_torch.models.lightgcn import GraphTables
from coldrec_tpu_torch.models.mf import MF, MFTrainer
from coldrec_tpu_torch.ops import spmm as spmm_mod
from coldrec_tpu_torch.ops.cuda import build as kbuild
from coldrec_tpu_torch.ops.cuda import retrieval as ret
from coldrec_tpu_torch.ops import knn as knn_mod
from coldrec_tpu_torch.ops.kmeans import kmeans
from coldrec_tpu_torch.parallel.distributed import (
    host_staging, init_distributed, launch_ranks, rank_device,
    run_collective, shutdown_distributed,
)
from coldrec_tpu_torch.parallel.mesh import make_mesh
from coldrec_tpu_torch.ops.cuda.retrieval import (
    CANDIDATES, INIT_NEG, LANES, SLOTS, USER_CHUNK, fused_sweep,
    fused_sweep_reference, merge_parts, merge_parts_reference, pad_items,
    retrieval_topk, sweep_parts_reference,
)
from coldrec_tpu_torch.runtime.checkpoints import (
    load_embeddings, save_embeddings,
)
from coldrec_tpu_torch.runtime.eval import (
    EvalSweep, exact_scores, mask_bias_vector, masked_topk,
)
from coldrec_tpu_torch.runtime.serving import RetrievalServer
from coldrec_tpu_torch.runtime.trainer import (
    SETTING_SPLITS, Config, rec_lists, three_way_test,
)
from coldrec_tpu_torch.tools import exp_blockskip as ebs
from coldrec_tpu_torch.tools import exp_fused_steps as efs
from coldrec_tpu_torch.tools import exp_multiacc as ema
from coldrec_tpu_torch.tools import exp_retrieval_kernels as erk
from coldrec_tpu_torch.tools import profile_train, profile_usim
from coldrec_tpu_torch.tools import scale_run as sr
from coldrec_tpu_torch.tools import tile_shapes, ubench_serving
from coldrec_tpu_torch.tools import ubench_spmm, ubench_sweep
from coldrec_tpu_torch.utils.logging import event_log
from coldrec_tpu_torch.utils import timing
from coldrec_tpu_torch.utils.metrics import ranking_evaluation
from coldrec_tpu_torch.utils.timing import (
    peak_gib, peak_start, sweep_bound, sync as _sync, time_ms, time_sweep,
    time_sweep_bf16,
)

# the whole run, under the 1200 s it may take at most. With phase recon
# (before it, 457.7 s) and the earlier phases' depth cut to one epoch a
# model it took 588.1 s, 677.9 s and ~862 s on three H100 machines: the
# host's share of the run (batches, set-up, the CPU side of the card-vs-CPU
# checks) varies 1.45x from machine to machine; the checks' CPU sides now
# run beside the card phases (``Checks``)
BUDGET_S = 1000.0
D = 64  # MF emb_size (BASELINE default)
BF16_KERNEL = "mma_sweep_kernel"  # the bf16 sweep's tensor-core kernel
K = 20
RATED_WIDTH = 32
# Book-crossing (reference data/README.md:9, BASELINE.md): users, items,
# interactions; MovieLens-1M item count for the narrow kernel shape.
BX = (92_107, 270_170, 1_031_175)
ML_ITEMS = 3_706
# fp32 sums taken in another order (the kernel's FFMA chain vs cuBLAS or the
# CPU's blocked product): at d=64 with N(0,1) inputs the scores reach ~40
# and the reordering error stays below 64 * 2^-24 * 40 ~ 1.5e-4.
VALUE_TOL = 1e-3
GAP_REL = 1e-5  # rows separated by less than this may swap ids at a tie
# The kernel-variant experiments' width (the JAX tools' default): 33 x 8192,
# book-crossing's 270,170 items rounded up to the block.
VAR_ITEMS = 270_336
VAR_BLOCKS = (2048, 8192)  # exp_retrieval_kernels' block_i, the others'
VAR_TILES = (64, 256)  # exp_blockskip's tile_u grid
INT_MAX = 64  # integer tables in [-64, 64]: every d=64 sum is exact in fp32
# NaN item rows of the variants' NaN table, beside random ones: 259 is lane
# class 3 in slice 2 of the first block of 384 items or more (the finite
# candidates of slices 0 and 1 come ahead of it), 650 lies in slice 2 of
# the second 384-item block, which starts at an odd item group, and 1283 is
# a second NaN of class 3.
NAN_ROWS = (259, 650, 1029, 1283)
ODD_BLOCK = 384  # 3 slices a block: no multiple of P > 1
SERVE_USERS = 512  # users per serving request
CLOCKS = "clocks.sm,power.draw"  # logged around the variants' times
# Phase train holds STEP_CHECK MF steps (lr 1e-3) on the card against the
# same steps on the CPU: the losses within STEP_LOSS_RTOL (fp32 sums in
# another order), and the tables within STEP_ATOL except at most STEP_FLIPS
# of the elements: Adam's first steps move an element by ~lr * sign(g), so
# an element whose gradient cancels to ~0 may flip sign between the two
# summation orders and move by up to 2 * lr a step (STEP_MAX_ERR in all).
STEP_CHECK = 20
STEP_LOSS_RTOL = 1e-5
STEP_ATOL = 1e-5
STEP_FLIPS = 1e-5
STEP_MAX_ERR = 2 * 1e-3 * STEP_CHECK
# The models' CLI runs at book-crossing shape (phases cold, content, recon,
# usim, graph, graph-user) train the first eighth of each epoch: 27 of its
# 215 batches (``main.run(epoch_steps=)``), USIM 7 of its 53; phase profile
# 27 of its 123; the full widths stay (PERF.md §4)
EPOCH_STEPS = 27
USIM_EPOCH_STEPS = 7
# Phase cold: the cold-start models through the CLI on phase train's split
# and MF bus: (model, epochs, flags). Book-crossing's item content has 416
# columns (BASELINE.md:17).
COLD_RUNS = (
    ("DropoutNet", 1, ("--dropoutnet_hidden1", "200", "--dropoutnet_hidden2",
                       "100", "--n_dropout", "0.5")),
    ("GAR", 1, ()),
    ("ALDI", 1, ()),
    ("DeepMusic", 1, ()),
    ("DUIF", 1, ()),
    ("Heater", 1, ()),
)
BX_CONTENT = 416
# DropoutNet's and ALDI's weights after STEP_CHECK steps on the card and the
# CPU, in relative norm: Adam carries the two trajectories apart from
# rounding differences (the CPU tests against the JAX package see ~2e-4
# after 12 steps); their losses stay within STEP_LOSS_RTOL.
COLD_NORM_RTOL = 1e-3
# Phase cold-signal: MovieLens-1M (BASELINE config 3's dataset): users,
# items, interactions and the item content dimension.
ML = (6_040, 3_706, 1_000_209)
ML_CONTENT = 206
# Phase graph: the graph backbones through the CLI on phase train's split
# (item cold): (model, epochs, flags); phase graph-user: book-crossing's
# 2,312 user-content columns (BASELINE.md:17) under user cold start.
GRAPH_RUNS = (
    ("LightGCN", 1, ("--layers", "2")),
    ("NGCF", 1, ("--layers", "2")),
    ("SimGCL", 1, ("--layers", "2")),
    ("XSimGCL", 1, ("--layers", "2")),
    ("NCL", 1, ("--layers", "2")),
)
BX_USER_CONTENT = 2_312
# Phase knn: content KNN through the retrieval kernel at book-crossing's
# content widths: (tag, queries, values, d, k). (a) KNN under item cold
# start: the 54,034 cold items x the 216,136 warm ones of phase train's
# split, 416 columns; (b) under user cold start: the 18,422 cold users x
# the 73,685 warm ones of phase graph-user's split, 2,312 columns; (c)
# AGNN's item side: every item x the warm ones, k = agnn_knn_k + 1.
FSGNN_FALLBACK = 32  # fsgnn_fallback_dim
KNN_SHAPES = (("a", 54_034, 216_136, BX_CONTENT, 5),
              ("b", 18_422, 73_685, BX_USER_CONTENT, 5),
              ("c", 270_170, 216_136, BX_CONTENT, 11),
              ("d", 270_170, 270_170, BX_CONTENT, 16),
              ("e", 92_107, 92_107, FSGNN_FALLBACK, 16))
# (d, e) FSGNN's graphs: every item against every item, every user against
# every user at the 32 fallback columns of a side without content (the
# queries are the values), k = fsgnn_knn_k + 1. On integer tables a, b and
# e hold the whole search to the plain route; d holds its first chunk's
# sweep (its integer ties send 30% of the rows to the exact fallback: the
# whole search took 8 s of the run)
KNN_SELF = ("d", "e")
KNN_INTEGER = ("a", "b", "e")
KNN_INTEGER_SWEEP = ("d",)
KNN_INT_MAX = 3  # integer tables in [-3, 3]: every d=2312 sum is exact
# Phase content: the content-feature cold models through the CLI on phase
# train's split and MF bus, one epoch each (500 in the reference's
# configs; cut for the run's time limit); AMR reads VBPR's bus.
CONTENT_RUNS = (
    ("KNN", 1, ()),
    ("AGNN", 1, ()),
    ("VBPR", 1, ()),
    ("AMR", 1, ()),
    ("MTPR", 1, ()),
    ("MetaEmbedding", 1, ()),
    ("LARA", 1, ()),
    ("CLCRec", 1, ()),
    ("GoRec", 1, ()),
)
# the content searches each model makes: KNN the cold side against the
# warm one, AGNN both sides against their warm rows, FSGNN each side
# against itself
KNN_CALLS = {"KNN": 1, "AGNN": 2, "FSGNN": 2}
# Phase recon: the reconstruction-family models through the CLI on phase
# train's split and MF bus, one epoch each (M2VAE's default is 10, CGRC's
# and FSGNN's 500; cut for the run's time limit; widths the published
# ones), then CCFCRec's and M2VAE's card-vs-CPU steps, CGRC's top-k users
# of the first CGRC_CHECK cold items against the CPU's, and FSGNN's step
# split into its SpMM applies and GAT segment ops.
RECON_RUNS = (
    ("CCFCRec", 1, ()),
    ("M2VAE", 1, ()),
    ("CGRC", 1, ()),
    ("FSGNN", 1, ()),
)
CGRC_CHECK = 2048
# Phase usim: USIM through the CLI on phase train's split and MF bus at its
# published widths (max_time 7, k 10, content hidden 150; the action space
# is the 92,107 users and the stop token), bs 4096 (the 216,136 warm items
# with training pairs: 53 batches), one epoch (500 in the reference's
# config; cut for the run's time limit); then one batch step split on the
# card into its phases, and one step at USIM_CHECK_BS on the card against
# the CPU (its PPO takes the dense path there, as the JAX rule picks), with
# the greedy inference of the first USIM_INFER_CHECK cold items.
USIM_CHECK_BS = 256
USIM_INFER_CHECK = 2048
# Models whose float32 steps on the card are held each from the CPU's
# state (``load_state``), their float32 free runs logged. SimGCL: its noise
# takes the sign of each propagated element, so its loss jumps where an
# element's two sums fall on either side of 0. CCFCRec (Adam at lr 1e-3 on
# xavier-normal tables of scale ~5e-3) and VBPR (Adagrad at lr 0.05):
# both optimizers move an element touched for the first time by ~lr
# whatever its gradient's size, so an element whose gradient cancels to
# rounding noise takes either sign. Over 20 steps on an H100 two card runs
# of VBPR were bit-equal, and a float32 CPU run parted from a float64 one
# by 9.8e-4 (VBPR) and 2.1e-3 (CCFCRec) in relative norm: float32 itself
# does not repeat a free run to COLD_NORM_RTOL. Their free runs are held
# in float64 on both devices instead, where the rounding noise lies far
# below the optimizers' eps (1e-10, 1e-8) and cannot be amplified.
SYNCED_STEPS = ("CCFCRec", "VBPR", "SimGCL")
# CCFCRec's and VBPR's synced steps are held element by element
# (``synced_step_gap``). An element whose card and CPU updates differ by
# more than STEP_ATOL is excused only where float32 cannot sign its
# gradient: from the CPU step's own float32 state, the float64 gradient
# g64 lies within UNSIGNED_RATIO times the CPU's float32 rounding error
# |g32 - g64| of 0 (the CPU's float32 gradient keeps fewer than 6 of its
# 24 bits). The card sums in another order: at VBPR's PQ2[62451, 60] its
# error was up to 54 times the CPU's (PERF.md §6). Such an element moves
# by ~lr * sign(g) on either side, so it may part by up to 2 * lr. Per
# weight and step at most STEP_FLIPS of the elements are excused, rounded
# up (VBPR's W, 26,624 elements, has one at its first Adam step: W[97,
# 58], |g| 1.7e-7 against eps 1e-8); every other element is held in
# relative norm to COLD_NORM_RTOL.
UNSIGNED_RATIO = 64.0
NAMED_PER_STEP = 8  # elements over STEP_ATOL a synced step's line names
LIBRARY_CHUNK = 4096  # queries per mm + topk of phase knn's library yardstick
# fp32 products with TF32 off: a 4096 x 64 x 4096 product within this of
# float64 (TF32 leaves ~1e-3)
FP32_RTOL = 1e-5
# the variant kernels' wrappers, each counting its launches in ``launches``
# (the retrieval kernels' counters are ``ret.launch_counts``)
VARIANTS = {"dot_sweep": erk.dot_sweep, "stream_sweep": erk.stream_sweep,
            "multiacc_sweep": ema.multiacc_sweep,
            "skip_sweep": ebs.skip_sweep}
MESH_SERVE = (SERVE_USERS,) * 4 + (2048,)  # users per request, phase mesh (a)
MESH_LOSS_RTOL = 1e-5
MESH_METRIC_TOL = 1e-9  # tests/test_multiprocess.py
# DropoutNet over a data axis: its eval tables, and its test metrics
# (tests/test_multiprocess.py's bound)
MESH_TABLE_TOL = 1e-5
MESH_DN_METRIC_TOL = 2e-3
# Phase mesh (g), (h), (k): a float32 tie between the ranks and the one-rank
# run. A perturbed element whose two values lie on either side of 0 (the
# noise takes its sign) is a tie where both lie within MESH_TIE_REL of their
# row's largest |value| (sums taken in another order put them ~1e-7 of it
# apart; a mesh fault puts a differing element anywhere in its row). CGRC's
# edge-MLP logits at the ranks' top-k users must lie within MESH_LOGIT_DRIFT
# of the row's largest in the two runs (Adam carries the rounding of the
# edge MLP's gradients: 6.7e-5 after 10 steps on the card), and a cold item's
# top-k users swapped between the runs is a tie where the gap of the swapped
# logits is within twice that drift (floor MESH_TIE_REL). The one-rank run
# takes the ranks' side of each tie (``mesh_replay``); all else fails.
MESH_TIE_REL = 1e-4
MESH_LOGIT_DRIFT = 1e-3
MESH_RANK_S = 600  # a rank group's time limit
SEARCH_TRIALS = 3  # phase search's trials before its resume
SEARCH_MEM_RTOL = 0.05  # allocated after the last trial vs the first
SCALE_SHAPE = "xing"  # phase scale's published shape (scale_run.SHAPES)
SCALE_LIST_USERS = 512  # test users a setting whose lists phase scale holds
SCALE_LINE = {"scale_run", "epochs", "wall_seconds", "sec_per_epoch"}
SERVE_ITERS = 20  # requests a batch size in phase serving (the tool's)
MFSTEP_K = 32  # phase mfstep's fused steps (exp_fused_steps' default)
MFSTEP_ITERS = 1  # timed runs of each path in phase mfstep (the tool's 3)
UBENCH_D = 256  # phase ubench's sweep depth (exp_d256_bf16's point)
REPO_DIR = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()


def log(msg: str) -> None:
    """Print ``msg``; from a worker thread to the process's own stdout, so
    that a line logged while the main thread has redirected ``sys.stdout``
    (a one-rank run of phase mesh) is not swallowed."""
    main = threading.current_thread() is threading.main_thread()
    print(msg, file=sys.stdout if main else sys.__stdout__, flush=True)


class Checks:
    """The CPU sides of the card-vs-CPU checks, on one worker thread beside
    the card phases.

    A check runs its card side on the main thread, then hands its CPU side
    (which depends only on its inputs: the split, the initial weights, the
    draws) to ``submit``; its ``finish`` (the comparison, the log line, any
    card steps that start from the CPU's states) runs on the main thread
    once the CPU side is done: at a phase boundary (``poll``) or at
    ``join``, before the ``kernels`` line. A CPU side's exception is raised
    on the main thread there. Until ``start`` every check runs inline, as
    the CPU rehearsals call the phases. torch's CPU kernels release the
    GIL; the intra-op threads are split between the worker (three
    quarters) and the main thread (each thread sets its own)."""

    def __init__(self):
        self.pool = None
        self.pending = []  # (name, future, finish)
        self.cpu_s = {}

    def start(self, worker_threads=None, main_threads=None):
        n = os.cpu_count() or 1
        # the main thread's host work (batches, launches) is mostly one
        # thread's; at half the cores each, the worker lagged the card
        # phases by ~30 s at the join
        worker = worker_threads or max(1, n - max(2, n // 4))
        main = main_threads or max(1, n - worker)
        torch.set_num_threads(main)
        self.pool = concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="cpu-checks",
            initializer=torch.set_num_threads, initargs=(worker,))
        log(f"  os.cpu_count() {n} ({cpu_line()}): the checks' CPU sides "
            f"on a worker thread with {worker} intra-op threads, the main "
            f"thread {main}")

    def submit(self, name: str, cpu_fn, finish) -> None:
        """Run ``cpu_fn()`` on the worker (inline before ``start``), then
        ``finish(result, cpu_seconds)`` on the main thread."""
        def timed():
            t = time.perf_counter()
            out = cpu_fn()
            return out, time.perf_counter() - t

        if self.pool is None:
            out, secs = timed()
            self.cpu_s[name] = secs
            finish(out, secs)
            return
        self.pending.append((name, self.pool.submit(timed), finish))

    def poll(self, wait: bool = False) -> None:
        """Finish the checks whose CPU side is done, in the order they were
        submitted (with ``wait``, all of them)."""
        while self.pending:
            name, fut, finish = self.pending[0]
            if not (wait or fut.done()):
                return
            try:
                out, secs = fut.result()
            except BaseException:
                self.close()
                raise
            self.pending.pop(0)
            self.cpu_s[name] = secs
            finish(out, secs)

    def join(self) -> None:
        t = time.perf_counter()
        n = len(self.pending)
        self.poll(wait=True)
        log(f"  checks joined: {n} pending, {time.perf_counter() - t:.2f} s "
            f"waited; CPU sides (s) "
            + ", ".join(f"{k} {v:.2f}" for k, v in self.cpu_s.items()))
        self.close()

    def close(self) -> None:
        """Drop the pending checks and stop the worker (a CPU side already
        running ends before the process does)."""
        for _, fut, _ in self.pending:
            fut.cancel()
        self.pending = []
        if self.pool is not None:
            self.pool.shutdown(wait=False, cancel_futures=True)
            self.pool = None


CHECKS = Checks()


def cpu_line() -> str:
    """The host CPU's model name and the vector code torch's CPU kernels
    run (``torch.backends.cpu.get_cpu_capability``)."""
    info = {}
    try:
        with open("/proc/cpuinfo") as f:
            for ln in f:
                key, _, value = ln.partition(":")
                info.setdefault(key.strip(), value.strip())
    except OSError:
        pass
    name = info.get("model name") or (
        f"{info.get('vendor_id', 'unknown vendor')} family "
        f"{info.get('cpu family', '?')} model {info.get('model', '?')}")
    return (f"{name}, torch CPU capability "
            f"{torch.backends.cpu.get_cpu_capability()}")


def check_budget(name: str) -> None:
    spent = time.perf_counter() - T0
    if spent > BUDGET_S:
        raise TimeoutError(f"{name}: {spent:.1f} s spent, budget {BUDGET_S} s")


def run_phase(name: str, fn, *args, **kwargs):
    t = time.perf_counter()
    out = fn(*args, **kwargs)
    log(f"[phase {name}] {time.perf_counter() - t:.2f} s")
    CHECKS.poll()
    check_budget(name)
    return out


def smi_line(query: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def reset_launches() -> None:
    ret.reset_launches()
    for wrapper in VARIANTS.values():
        wrapper.launches = 0


def launch_counts() -> dict:
    return {**ret.launch_counts(),
            **{name: w.launches for name, w in VARIANTS.items()}}


# ------------------------------------------------------------------ checks
def compare_lists(ue, ie, users, ids_a, ids_b, gap_rel=GAP_REL):
    """Hold two ranked id lists for the same users to each other.

    Rows must be id-equal unless they differ only at near-ties: there the
    exact scores at both lists must agree position by position within
    ``gap_rel`` of the row's top score. Returns (rows, id-equal rows)."""
    ids_a = np.asarray(ids_a)
    ids_b = np.asarray(ids_b)
    if ids_a.shape != ids_b.shape:
        raise AssertionError(f"list shapes {ids_a.shape} != {ids_b.shape}")
    same = (ids_a == ids_b).all(axis=1)
    bad = np.flatnonzero(~same)
    if bad.size:
        dev = ue.device
        u = ue[torch.as_tensor(np.asarray(users)[bad], device=dev).long()]
        sa = (u[:, None, :] * ie[torch.as_tensor(ids_a[bad], device=dev)
                                 .long()]).sum(-1)
        sb = (u[:, None, :] * ie[torch.as_tensor(ids_b[bad], device=dev)
                                 .long()]).sum(-1)
        scale = torch.maximum(sa.abs().amax(1), sb.abs().amax(1))[:, None]
        off = ((sa - sb).abs() > gap_rel * scale + 1e-30).any(dim=1)
        if bool(off.any()):
            r = int(bad[int(off.nonzero()[0, 0])])
            raise AssertionError(
                f"row {r}: lists differ beyond near-ties: "
                f"{ids_a[r][:8]} vs {ids_b[r][:8]}"
            )
    return int(same.shape[0]), int(same.sum())


def kernel_vs_plain(device, n_users, n_items, d=D, k=K, r=RATED_WIDTH,
                    seed=0, chunk=512, bf16=False):
    """Phase 3 at one shape; returns the max abs error and row counts.
    ``bf16``: the kernel's bf16 instance, held against the plain version
    on the bf16-rounded tables (and ``retrieval_topk(bf16=True)`` against
    the plain path on them)."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    users = torch.as_tensor(
        rng.standard_normal((n_users, d), dtype=np.float32), device=device)
    items = torch.as_tensor(
        rng.standard_normal((n_items, d), dtype=np.float32), device=device)
    kind = torch.bfloat16 if bf16 else torch.float32
    # the tables whose exact fp32 scores the kernel's lists must hold
    if bf16:
        users, items = ret.bf16_round(users), ret.bf16_round(items)
    excluded = np.zeros(n_items, bool)
    excluded[rng.choice(n_items, n_items // 4, replace=False)] = True
    rated = np.full((n_users, r), n_items, np.int32)
    counts = rng.integers(0, r + 1, n_users)
    for u in range(n_users):
        rated[u, :counts[u]] = rng.choice(n_items, counts[u], replace=False)
    excl_t = torch.as_tensor(excluded, device=device)
    items_t, excl_row = pad_items(items, excl_t)

    cv, ci, gh = fused_sweep(users.to(kind), items_t.to(kind), excl_row)
    rv, ri, rg = fused_sweep_reference(users, items_t, excl_row)
    _sync(device)
    err = max(float((cv - rv).abs().max()), float((gh - rg).abs().max()))
    if not err <= VALUE_TOL:
        raise AssertionError(f"kernel vs plain: max abs err {err}")
    id_equal = float((ci == ri).float().mean())

    # the ghost contract against the plain full scores
    worst = -np.inf
    for s in range(0, n_users, chunk):
        e = min(n_users, s + chunk)
        z = exact_scores(users[s:e], items_t.T).masked_fill(
            excl_row.bool()[None, :], -10e8)
        # slots a class with < SLOTS items never filled hold INIT_NEG and
        # id 0; point them at slot 0 of class 0, which always holds a real
        # candidate
        filled = cv[s:e] > INIT_NEG
        cid = torch.where(filled, ci[s:e], ci[s:e, :1]).long()
        at = z.gather(1, cid)
        if not float((at - cv[s:e]).abs()[filled].max()) <= VALUE_TOL:
            raise AssertionError("candidate values are not their scores")
        z.scatter_(1, cid, -float("inf"))
        over = z.max(dim=1).values - gh[s:e].max(dim=1).values
        worst = max(worst, float(over.max()))
    if not worst <= VALUE_TOL:
        raise AssertionError(f"a non-candidate beats the ghost by {worst}")

    vals, ids = retrieval_topk(users, items, rated, excluded, k, device=device,
                               bf16=bf16)
    plain = []
    rated_t = torch.as_tensor(rated, device=device)
    for s in range(0, n_users, chunk):
        e = min(n_users, s + chunk)
        _, pi = masked_topk(exact_scores(users[s:e], items), rated_t[s:e],
                            excl_t, k)
        plain.append(pi.cpu().numpy())
    rows, equal = compare_lists(users, items, np.arange(n_users), ids,
                                np.concatenate(plain))
    log(f"  kernel{' bf16' if bf16 else ''} {n_users}x{n_items} d={d}: "
        f"max_abs_err={err:.3e} "
        f"candidate ids equal {id_equal:.6f}, ghost margin {worst:.3e}, "
        f"top-{k} rows id-equal {equal}/{rows} (others near-ties)")
    return {"max_abs_err": err, "rows": rows, "id_equal_rows": equal}


def same(got, ref) -> bool:
    """Bit for bit equal, NaN equal to NaN at the same places
    (``torch.equal`` is False on any NaN)."""
    if got.dtype != ref.dtype or got.shape != ref.shape:
        return False
    if not got.is_floating_point():
        return torch.equal(got, ref)
    nan = got.isnan()
    return torch.equal(nan, ref.isnan()) and torch.equal(got[~nan],
                                                         ref[~nan])


def hold_equal(name, got, ref):
    """Raise unless every output equals its plain version bit for bit
    (NaN at the same places); returns the max abs difference over the
    numbers (0.0)."""
    err = 0.0
    for g, r in zip(got, ref):
        diff = (g.double() - r.double()).abs()
        diff = diff[diff == diff]
        worst = float(diff.max()) if diff.numel() else 0.0
        if not same(g, r):
            raise AssertionError(
                f"{name}: kernel differs from its plain version (max abs "
                f"err {worst}, NaN places equal: "
                f"{torch.equal(g.isnan(), r.isnan())})")
        err = max(err, worst)
    return err


def sweep_parts_on(device, n_users, d, i_pad):
    """The item ranges the kernel splits this sweep into (on the CPU, where
    the wrapper computes its plain version, 4 to rehearse the merge)."""
    if device.type != "cuda":
        return 4
    return kbuild.sweep_parts("coldrec_fused_sweep_parts", device, n_users,
                              d, i_pad)


def exact_sweep_check(device, n_users, n_items, d=D, seed=3, nan_items=0,
                      bf16=False):
    """``fused_sweep`` bit for bit against its plain version on integer
    tables (every sum exact, many ties) with 20% of the items excluded and,
    with ``nan_items``, that many NaN item rows (three in one lane class),
    whose lane classes' ghosts must be NaN;
    then the merge kernel against its plain version on the plain per-part
    sweeps, at the kernel's part count for this batch (at least 2).
    ``bf16``: the kernel's bf16 instance on the same tables, which bf16
    holds exactly (|x| <= 64), against the same plain version; no merge
    check (the merge runs inside the sweep where it splits)."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    ue = rng.integers(-INT_MAX, INT_MAX + 1, (n_users, d)).astype(np.float32)
    ie = rng.integers(-INT_MAX, INT_MAX + 1, (n_items, d)).astype(np.float32)
    nan_rows = np.zeros(0, np.int64)
    if nan_items:
        nan_rows = np.unique(np.concatenate([
            rng.choice(n_items, nan_items, replace=False), [5, 133, 261]]))
        ie[nan_rows] = np.nan
    excluded = rng.random(n_items) < 0.2
    users = torch.as_tensor(ue, device=device)
    items_t, excl_row = pad_items(torch.as_tensor(ie, device=device),
                                  torch.as_tensor(excluded, device=device))
    kind = torch.bfloat16 if bf16 else torch.float32
    name = "fused_sweep_bf16" if bf16 else "fused_sweep"
    got = fused_sweep(users.to(kind), items_t.to(kind), excl_row)
    err = hold_equal(name, got,
                     fused_sweep_reference(users, items_t, excl_row))
    if bool(got[0].isnan().any()):
        raise AssertionError("a NaN score reached a slot")
    nan_class = torch.zeros(LANES, dtype=torch.bool, device=device)
    live_nan = nan_rows[~excluded[nan_rows]]
    nan_class[torch.as_tensor(live_nan % LANES, device=device)] = True
    if not torch.equal(got[2].isnan(), nan_class.expand_as(got[2])):
        raise AssertionError("the NaN ghosts are not the NaN items' classes")
    # an excluded item scores NEG, NaN or not; any other NaN item is dropped
    filled = got[1][got[0] > INIT_NEG].cpu().numpy()
    if np.isin(filled, nan_rows[~excluded[nan_rows]]).any():
        raise AssertionError("a NaN item is a candidate")
    if bf16:
        _sync(device)
        log(f"  integer table {n_users}x{n_items} d={d}, {len(nan_rows)} "
            f"NaN items: fused_sweep_bf16 bit-equal to its plain version")
        return {name: err}
    parts = max(2, sweep_parts_on(device, n_users, d, items_t.shape[1]))
    pv, pi, pg = sweep_parts_reference(users, items_t, excl_row, parts)
    merr = hold_equal("merge_parts", merge_parts(pv, pi, pg),
                      merge_parts_reference(pv, pi, pg))
    _sync(device)
    log(f"  integer table {n_users}x{n_items} d={d}, {len(nan_rows)} NaN "
        f"items ({int(nan_class.sum())} NaN ghost classes): fused_sweep "
        f"bit-equal to its plain version; merge_parts bit-equal at {parts} "
        f"parts")
    return {"fused_sweep": err, "merge_parts": merr}


def kernel_ml(device, n_users=2048, n_items=ML_ITEMS):
    """Phase kernel-ml: the N(0,1) check of phase 3 and the NaN table, for
    the fp32 sweep and its bf16 instance."""
    out = kernel_vs_plain(device, n_users, n_items)
    exact = exact_sweep_check(device, n_users, n_items, nan_items=200)
    out16 = kernel_vs_plain(device, n_users, n_items, bf16=True)
    exact16 = exact_sweep_check(device, n_users, n_items, nan_items=200,
                                bf16=True)
    return {"max_abs_err": max(out["max_abs_err"], exact["fused_sweep"]),
            "merge_err": exact["merge_parts"],
            "bf16_err": max(out16["max_abs_err"],
                            exact16["fused_sweep_bf16"])}


def kernel_int(device, n_items=BX[1], sizes=(2048, SERVE_USERS)):
    """Phase kernel-int: integer tables at the eval chunk and the serving
    shape (where the sweep is split and merged), fp32 and bf16."""
    errs = [{**exact_sweep_check(device, n, n_items, seed=4 + n),
             **exact_sweep_check(device, n, n_items, seed=4 + n, bf16=True)}
            for n in sizes]
    return {k: max(e[k] for e in errs) for k in errs[0]}


def host_split(device, data, ue, ie, k=K, setting="all"):
    """The steps of ``retrieval_topk`` on one test setting's users, each
    synchronised and timed on its own (host clock): the kernel, ``_resolve``,
    the downloads, the tie order and the exact fallback."""
    sweep = EvalSweep(data, "item", USER_CHUNK, k, device=device)
    split = SETTING_SPLITS[(setting, "test")]
    st = sweep._prepare(split, setting)
    users = st["user_chunks"].reshape(-1)[: st["n_users"]]
    width = max(st["rated_widths"])
    rated = torch.as_tensor(st["rated_chunks"][:, :, :width].reshape(
        -1, width)[: st["n_users"]], device=device).long()
    rows = ue[torch.as_tensor(users, device=device).long()]
    excl = st["bias"].bool()
    secs = dict.fromkeys(("pad", "kernel", "resolve", "download",
                          "tie_order", "fallback"), 0.0)

    def timed(step, fn):
        _sync(device)
        t = time.perf_counter()
        out = fn()
        _sync(device)
        secs[step] += time.perf_counter() - t
        return out

    items_t, excl_row = timed("pad", lambda: pad_items(ie, excl))
    vals_l, ids_l, sus_l = [], [], []
    for s in range(0, rows.shape[0], USER_CHUNK):
        e = min(rows.shape[0], s + USER_CHUNK)
        cv, ci, gh = timed("kernel", lambda: fused_sweep(
            rows[s:e].contiguous(), items_t, excl_row))
        v, i, sus = timed("resolve", lambda: ret._resolve(
            cv, ci, gh, rated[s:e], k))
        v, i, sus = timed("download", lambda: (
            v.cpu().numpy(), i.cpu().numpy(), sus.cpu().numpy()))
        vals_l.append(v)
        ids_l.append(i)
        sus_l.append(sus)
    vals, ids = timed("tie_order", lambda: ret._torch_tie_order(
        np.concatenate(vals_l), np.concatenate(ids_l)))
    sus = np.concatenate(sus_l)

    def exact_chunk(rows_pad):
        r = torch.as_tensor(rows_pad, device=device)
        return ret._exact_rows(rows[r], ie, rated[r], excl, k)

    timed("fallback", lambda: ret.apply_exact_fallback(vals, ids, sus,
                                                       exact_chunk))
    total = sum(secs.values())
    log(f"  host split ({setting} setting, {rows.shape[0]} users, "
        f"{int(sus.sum())} rows to the fallback): " + ", ".join(
            f"{n} {v:.4f} s" for n, v in secs.items())
        + f"; kernel {secs['kernel'] / total:.1%} of {total:.3f} s")
    return secs


def slice_run(device, n_users, n_items, n_inter, d=D, topN=(10, 20),
              n_requests=8, request_size=512, seed=0):
    """Phase 4: the main path (serving + three-way test) and its checks.
    Returns the launches of each kernel counted during the main path."""
    device = torch.device(device)
    t = time.perf_counter()
    data, _ = synthetic_dataset(n_users, n_items, n_inter,
                                cold_object="item", seed=seed)
    log(f"  data {data.user_num} users x {data.item_num} items, "
        f"{data.n_train} train pairs, max rated {data.max_rated} "
        f"({time.perf_counter() - t:.2f} s)")
    mf = MF(data.user_num, data.item_num, emb_size=d, seed=seed,
            device=device)
    ue, ie = (w.detach() for w in mf.forward_tables())
    rng = np.random.default_rng(seed + 1)
    requests = [rng.choice(data.user_num, request_size, replace=False)
                for _ in range(n_requests)]
    with tempfile.TemporaryDirectory() as emb_dir:
        save_embeddings(emb_dir, "bx_synth", "item", "MF",
                        {"user_emb": ue, "item_emb": ie})
        srv = RetrievalServer.from_checkpoint(
            emb_dir, "bx_synth", "item", "MF", dataset=data, device=device)

    reset_launches()
    t = time.perf_counter()
    served = [srv.topk(u, K, exclude_rated=True)[1] for u in requests]
    raw_users = data.id2user[requests[0]]
    _, raw_items = srv.topk(raw_users, K, exclude_rated=True, raw_ids=True)
    _sync(device)
    t_serve = time.perf_counter() - t
    t = time.perf_counter()
    res = three_way_test(data, ue, ie, topN=topN, backend="kernel",
                         device=device)
    _sync(device)
    t_test = time.perf_counter() - t
    launches = {name: launch_counts()[name]
                for name in ("fused_sweep", "merge_parts")}
    log(f"  serving {n_requests}x{request_size} users + 1 raw-id request "
        f"{t_serve:.2f} s ({t_serve / (n_requests + 1):.4f} s per request); "
        f"three-way test {t_test:.2f} s; kernel launches {launches}")
    if device.type == "cuda" and min(launches.values()) <= 0:
        raise AssertionError(f"the main path left a kernel unlaunched: "
                             f"{launches}")

    # checks: raw ids round-trip, lists vs the plain path, metrics finite
    if not np.array_equal(raw_items, data.id2item[served[0]]):
        raise AssertionError("raw-id request disagrees with the mapped one")
    for u, ids in zip(requests, served):
        if ids.shape != (request_size, K) or (ids >= data.item_num).any():
            raise AssertionError(f"bad served ids, shape {ids.shape}")
        rated = torch.as_tensor(data.rated_padded(u.astype(np.int32)),
                                device=device)
        if K + rated.shape[1] > CANDIDATES:
            raise AssertionError("a served user left the kernel path")
        _, pi = masked_topk(exact_scores(ue[torch.as_tensor(u, device=device)],
                                         ie), rated, srv.bias, K)
        compare_lists(ue, ie, u, ids, pi.cpu().numpy())
    plain = three_way_test(data, ue, ie, topN=topN, backend="plain",
                           device=device, verbose=False)
    for setting, out in res.items():
        es = data.eval_splits[
            {"all": "overall_test", "cold": "cold_test",
             "warm": "warm_test"}[setting]]
        rows, equal = compare_lists(ue, ie, es.users, out["rec"],
                                    plain[setting]["rec"])
        perf = np.asarray(out["performance"], dtype=np.float64)
        if perf.shape != (len(topN), 4) or not np.isfinite(perf).all():
            raise AssertionError(f"{setting}: bad metrics {perf}")
        log(f"  {setting}: {rows} users, lists id-equal to the plain path "
            f"on {equal} (others near-ties)")
    host_split(device, data, ue, ie)
    return launches


def read_events(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def val_ndcg(data, ue, ie, device, k=K):
    """Validation NDCG@k (overall setting) of one pair of tables through the
    kernel path, as ``fast_evaluation`` computes it."""
    sweep = EvalSweep(data, "item", USER_CHUNK, k, device=device)
    rec = rec_lists(sweep, "valid", "all", ue, ie, backend="kernel")
    es = data.eval_splits[SETTING_SPLITS[("all", "valid")]]
    _, perf = ranking_evaluation(es.indptr, es.items, rec, [k], data.item_num)
    return float(perf[0][3])


def step_parity(device, data, d, bs, steps=STEP_CHECK, seed=0):
    """``steps`` MF steps on ``device`` and on the CPU from the same tables
    and the same host batches, the CPU's on ``CHECKS``' worker; at its
    finish the check is logged and held: loss max rel err, table max abs
    err and the elements beyond STEP_ATOL."""
    device = torch.device(device)
    tables = MF(data.user_num, data.item_num, d, seed=seed, device="cpu")
    init = {k: v.detach().numpy() for k, v in
            zip(("user_emb", "item_emb"), tables.forward_tables())}
    card, cpu = [MFTrainer(Config(default_args(
        model="MF", emb_size=d, bs=bs, seed=seed, save_emb=False,
        device=str(dev)), data), init_params=init)
        for dev in (device, torch.device("cpu"))]
    batches = list(itertools.islice(pairwise_batches(
        data, bs, np.random.default_rng(seed)), steps))

    def run(t):
        losses = [float(t.train_step(t.upload(b))) for b in batches]
        return losses, [x.detach().cpu() for x in t.model.forward_tables()]

    t0 = time.perf_counter()
    card_losses, card_tables = run(card)
    card_s = time.perf_counter() - t0

    def finish(out, cpu_s):
        cpu_losses, cpu_tables = out
        a, b = np.asarray(card_losses), np.asarray(cpu_losses)
        loss_err = float(np.max(np.abs(a - b) / np.abs(b)))
        worst, over, numel = 0.0, 0, 0
        for x, y in zip(card_tables, cpu_tables):
            diff = (x - y).abs()
            worst = max(worst, float(diff.max()))
            over += int((diff > STEP_ATOL).sum())
            numel += diff.numel()
        log(f"  {steps} steps {device.type} vs cpu ({device.type} side "
            f"{card_s:.2f} s, cpu side {cpu_s:.2f} s): loss max rel err "
            f"{loss_err:.3e}, tables max abs err {worst:.3e}, {over} of "
            f"{numel} elements beyond {STEP_ATOL}")
        if not (loss_err <= STEP_LOSS_RTOL and worst <= STEP_MAX_ERR
                and over <= STEP_FLIPS * numel):
            raise AssertionError("the card's steps disagree with the CPU's")

    CHECKS.submit("MF steps", lambda: run(cpu), finish)


_SPLITS = {}


def read_split(root, ds, cold_object="item"):
    """The split directory ``root/ds`` as a ``ColdStartDataset``, read once
    and shared by the phases (and their CLI runs) that use it."""
    key = (os.path.abspath(root), ds, cold_object)
    if key not in _SPLITS:
        _SPLITS[key] = ColdStartDataset.from_split_dir(root, ds, cold_object)
    return _SPLITS[key]


def write_split(root, ds, pairs, seed, content_dim, content=None,
                cold_object="item"):
    """The split directory of ``pairs`` under ``root/ds`` (cold
    ``cold_object``), and the cold side's content: ``content`` (rows in raw
    id order) or N(0,1) of ``content_dim`` columns from ``seed``."""
    res = cold_start_split(pairs, cold_object=cold_object, seed=seed + 42)
    write_split_dir(res, root, ds, cold_object)
    if content is None:
        n = res.item_num if cold_object == "item" else res.user_num
        content = np.random.default_rng(seed + 2).standard_normal(
            (n, content_dim), dtype=np.float32)
    np.save(os.path.join(root, ds, f"{ds}_{cold_object}_content.npy"),
            content)
    return res


def train_run(device, n_users, n_items, n_inter, d=D, epochs=2, bs=4096,
              topN=(10, 20), seed=0, steps=STEP_CHECK, root=None,
              content_dim=1):
    """Phase train: MF trained through the port's CLI entry
    (``coldrec_tpu_torch.main.run``) on a split directory at the given
    shape, validated every epoch through the retrieval kernel, then checked.
    The split directory (item content of ``content_dim`` N(0,1) columns)
    and the MF bus stay under ``root`` when given, for phase cold. Returns
    the launches of each kernel counted during the run."""
    if root is None:
        with tempfile.TemporaryDirectory() as tmp:
            return train_run(device, n_users, n_items, n_inter, d, epochs,
                             bs, topN, seed, steps, tmp, content_dim)
    device = torch.device(device)
    top = max(topN)
    t = time.perf_counter()
    pairs = synthetic_interactions(n_users, n_items, n_inter, seed=seed)
    write_split(root, "bx_synth", pairs, seed, content_dim)
    events = os.path.join(root, "events.jsonl")
    os.environ["COLDREC_EVENT_LOG"] = events
    log(f"  split dir written, item content {content_dim} columns "
        f"({time.perf_counter() - t:.2f} s)")
    args = make_args([
        "--model", "MF", "--dataset", "bx_synth", "--cold_object", "item",
        "--data_dir", root, "--emb_dir", os.path.join(root, "emb"),
        "--result_file", os.path.join(root, "result.txt"),
        "--epochs", str(epochs), "--bs", str(bs), "--emb_size", str(d),
        "--lr", "0.001", "--reg", "0.0001", "--topN",
        ",".join(map(str, topN)), "--early_stop", "10", "--eval_every",
        "1", "--seed", str(seed), "--device", device.type])
    reset_launches()
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        payload = tmain.run(args)
    _sync(device)
    t_run = time.perf_counter() - t
    launches = {name: launch_counts()[name]
                for name in ("fused_sweep", "merge_parts")}
    text = out.getvalue()
    log("\n".join("  | " + ln for ln in text.splitlines()
                  if ln.startswith(("training:", "Epoch:", "Time:",
                                    "Results written"))))
    with open(args.result_file) as f:
        result = f.read()
    if "--- JSON (machine-readable) ---" not in result:
        raise AssertionError("the result file has no JSON block")
    bus = load_embeddings(args.emb_dir, "bx_synth", "item", "MF")
    event_log().close()
    evs = read_events(events)
    data = read_split(root, "bx_synth")

    epoch_evs = [e for e in evs if e["event"] == "epoch"]
    val_evs = [e for e in evs if e["event"] == "validation"]
    end = [e for e in evs if e["event"] == "run_end"][0]
    if len(epoch_evs) != epochs or len(val_evs) != epochs:
        raise AssertionError(f"{len(epoch_evs)} epochs, {len(val_evs)} "
                             f"validations logged, {epochs} asked for")
    losses = [x for e in epoch_evs for x in e["losses"]]
    w = min(50, len(losses) // 2)
    first, last = float(np.mean(losses[:w])), float(np.mean(losses[-w:]))
    if not (np.isfinite(losses).all() and last < first):
        raise AssertionError(f"the loss did not fall: first {w} batches "
                             f"{first}, last {w} {last}")
    for e in epoch_evs:
        log(f"  epoch {e['epoch']}: {e['batches']} steps in "
            f"{e['train_s']:.3f} s ({e['batches'] / e['train_s']:.1f} "
            f"steps/s): host batches {e['host_s']:.3f} s, upload "
            f"{e['upload_s']:.3f} s, step enqueue {e['step_host_s']:.3f} s, "
            f"device step {e['step_device_s']:.3f} s; validation "
            f"{e['validation_s']:.3f} s")

    mf = MF(data.user_num, data.item_num, d, seed=seed, device=device)
    untrained = val_ndcg(data, *(x.detach() for x in mf.forward_tables()),
                         device, top)
    ue = torch.as_tensor(bus["user_emb"], device=device)
    ie = torch.as_tensor(bus["item_emb"], device=device)
    trained = val_ndcg(data, ue, ie, device, top)
    best = max(e["ndcg"] for e in val_evs)
    if not trained > untrained or abs(trained - best) > 1e-6:
        raise AssertionError(
            f"validation NDCG@{top}: trained {trained} (best logged {best}), "
            f"untrained {untrained}")

    reset_launches()
    kernel = three_way_test(data, ue, ie, topN=topN, backend="kernel",
                            device=device, verbose=False)
    test_launches = launch_counts()["fused_sweep"]
    plain = three_way_test(data, ue, ie, topN=topN, backend="plain",
                           device=device, verbose=False)
    for setting, got in kernel.items():
        es = data.eval_splits[SETTING_SPLITS[(setting, "test")]]
        rows, equal = compare_lists(ue, ie, es.users, got["rec"],
                                    plain[setting]["rec"])
        log(f"  trained {setting}: {rows} users, lists id-equal to the "
            f"plain path on {equal} (others near-ties); metrics "
            f"{got['performance']}")
    val_launches = (launches["fused_sweep"] - test_launches) / epochs
    log(f"  run {t_run:.2f} s; kernel launches {launches} "
        f"(fused_sweep: {val_launches:g} per validation, {test_launches} in "
        f"the three-way test); three-way test of the trained tables "
        f"{end['test_seconds']:.3f} s; seconds per epoch "
        f"{payload['efficiency']['seconds_per_completed_epoch_mean']:.3f}; "
        f"validation NDCG@{top} {untrained:.5f} untrained -> "
        f"{trained:.5f}; loss {first:.5f} -> {last:.5f}")
    if device.type == "cuda" and not val_launches >= 1:
        raise AssertionError(f"validation left the kernel unlaunched: "
                             f"{launches}, test {test_launches}")

    step_parity(device, data, d, bs, steps)
    return launches


# ------------------------------------------------------ the cold-start path
def cli_run(device, root, ds, model, epochs, flags=(), d=D, bs=4096, seed=0,
            topN=(10, 20), tag=None, cold_object="item", data=None,
            epoch_steps=0, on_model=None):
    """One run of the port's CLI (``coldrec_tpu_torch.main.run``) on the
    split directory ``root/ds`` with the bus under ``root/emb``, the launch
    counts zeroed just before and read just after; ``data`` (that split,
    already read), ``epoch_steps`` and ``on_model`` go to ``main.run``.
    Returns (payload, launches, events, seconds)."""
    device = torch.device(device)
    tag = tag or f"{model}_{cold_object}"
    events = os.path.join(root, f"events_{tag}.jsonl")
    if os.path.exists(events):  # the log appends: keep this run's alone
        os.remove(events)
    os.environ["COLDREC_EVENT_LOG"] = events
    args = make_args([
        "--model", model, "--dataset", ds, "--cold_object", cold_object,
        "--data_dir", root, "--emb_dir", os.path.join(root, "emb"),
        "--result_file", os.path.join(root, f"result_{tag}.txt"),
        "--epochs", str(epochs), "--bs", str(bs), "--emb_size", str(d),
        "--topN", ",".join(map(str, topN)), "--seed", str(seed),
        "--device", device.type, *flags])
    reset_launches()
    t = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        payload = tmain.run(args, on_model, data, epoch_steps)
    _sync(device)
    secs = time.perf_counter() - t
    launches = launch_counts()
    event_log().close()
    return payload, launches, read_events(events), secs


def log_epochs(evs):
    """Log each epoch's time split from the event log; returns the batch
    losses' means over the first and last (up to) 50 batches."""
    for e in (e for e in evs if e["event"] == "epoch"):
        log(f"    epoch {e['epoch']}: {e['batches']} steps in "
            f"{e['train_s']:.3f} s ({e['batches'] / e['train_s']:.1f} "
            f"steps/s): host batches {e['host_s']:.3f} s, upload "
            f"{e['upload_s']:.3f} s, step enqueue {e['step_host_s']:.3f} s, "
            f"device step {e['step_device_s']:.3f} s; eval tables "
            f"{e['refresh_s']:.3f} s; validation {e['validation_s']:.3f} s")
    losses = [x for e in evs if e["event"] == "epoch" for x in e["losses"]]
    if not losses or not np.isfinite(losses).all():
        raise AssertionError(f"non-finite or no batch losses: {losses[:5]}")
    w = max(1, min(50, len(losses) // 2))
    return float(np.mean(losses[:w])), float(np.mean(losses[-w:]))


def routes(evs) -> dict:
    """{split: sorted routes} of the run's sweeps (``sweep_route``)."""
    out = {}
    for e in evs:
        if e["event"] == "sweep_route":
            out.setdefault(e["split"], set()).add(e["route"])
    return {k: sorted(v) for k, v in sorted(out.items())}


def expected_routes(data, cold_object, bs, top, device) -> dict:
    """{split: [route]} the JAX package takes (``kernel_supported``: plain
    where a user is rated beyond the kernel's candidates)."""
    sweep = EvalSweep(data, cold_object, bs, top, device=device)
    return {split: ["kernel" if sweep.kernel_supported(split, kind)
                    else "plain"]
            for (kind, _), split in SETTING_SPLITS.items()}


def check_routes(model, evs, expected) -> None:
    for split, route in routes(evs).items():
        if route != expected[split]:
            raise AssertionError(f"{model} {split}: route {route}, the JAX "
                                 f"package's {expected[split]}")


def lists_vs_plain(data, ue, ie, device, got, backend="kernel",
                   topN=(10, 20), cold_object="item"):
    """The three-way-test lists ``got`` of (ue, ie) through ``backend`` (a
    CLI run's ``test_results``) against the plain path's (on the
    bf16-rounded tables for ``kernel_bf16``), by the rule of
    ``compare_lists``; returns {setting: (rows, id-equal rows)}."""
    if backend == "kernel_bf16":
        ue, ie = ret.bf16_round(ue), ret.bf16_round(ie)
    plain = three_way_test(data, ue, ie, topN=topN, backend="plain",
                           cold_object=cold_object, device=device,
                           verbose=False)
    out = {}
    for setting, res in got.items():
        es = data.eval_splits[SETTING_SPLITS[(setting, "test")]]
        out[setting] = compare_lists(ue, ie, es.users, res["rec"],
                                     plain[setting]["rec"])
    return out


def noise_walked(name: str) -> bool:
    """A weight whose exact gradient is 0, which Adam moves by ~lr a step on
    rounding noise of either sign, differently on each device: a Linear
    bias right ahead of a BatchNorm (DropoutNet's tower blocks, ALDI's fc1,
    M2VAE's fc2, fc3 and decoder blocks) and CCFCRec's and M2VAE's
    attr_b1 (one constant added to every attention logit)."""
    return (name.endswith(("attr.attr_b1", ".lin.bias"))
            or name.endswith(".bias") and (".lins." in name
                                           or ".fc1." in name))


def bx_trainer(model, device, data, root, d, bs, seed, **flags):
    """``model``'s trainer on ``device`` over phase train's item-cold split
    (its bus under ``root/emb``), writing no bus; ``flags`` set the
    model's own."""
    return TRAINERS[model](Config(default_args(
        model=model, dataset="bx_synth", cold_object="item", emb_size=d,
        bs=bs, seed=seed, save_emb=False, emb_dir=os.path.join(root, "emb"),
        device=str(device), **flags), data))


def _params(model) -> dict:
    """A module's named parameters, detached copies on the host."""
    return {k: v.detach().cpu().clone() for k, v in model.named_parameters()}


def _weights_gap(got: dict, ref: dict) -> float:
    """The largest relative norm gap between the named weights ``got``
    and ``ref``, the noise-walked ones left out."""
    gap = 0.0
    for name, p in got.items():
        if noise_walked(name):
            continue
        want = ref[name]
        gap = max(gap, float((p.detach().cpu() - want).norm()
                             / want.norm().clamp_min(1e-30)))
    return gap


def snapshot(t) -> tuple:
    """Trainer ``t``'s weights and optimizer state, copied."""
    return (copy.deepcopy(t.model.state_dict()),
            copy.deepcopy(t.optimizer.state_dict()))


def load_state(t, state) -> None:
    """Start trainer ``t`` from a ``snapshot``: the held step of a
    card-vs-CPU check."""
    t.model.load_state_dict(state[0])
    t.optimizer.load_state_dict(copy.deepcopy(state[1]))


def as_float64(t) -> None:
    """Trainer ``t`` in float64: its module, its float32 tensors (the
    content tables) and its optimizer's state."""
    state = t.optimizer.state_dict()
    t.model.double()
    for name, v in list(vars(t).items()):
        if torch.is_tensor(v) and v.dtype == torch.float32:
            setattr(t, name, v.double())
    t.optimizer.load_state_dict(state)


def _grads(module) -> dict:
    """A module's gradients by name, copied to the host."""
    return {k: v.grad.detach().cpu().clone()
            for k, v in module.named_parameters() if v.grad is not None}


def step_grads(t, weights: dict, batch, kw) -> dict:
    """The gradient of trainer ``t``'s loss on ``batch`` at ``weights`` (a
    state dict, cast to ``t``'s dtype as it loads), by name, on the host."""
    t.model.load_state_dict(weights)
    t.model.zero_grad(set_to_none=True)
    t.loss(t.upload(batch), **_on(kw, t)).backward()
    return _grads(t.model)


def weight_lrs(t) -> dict:
    """Each named weight's learning rate under trainer ``t``'s optimizer
    (each of an ``OptimizerGroups``'s)."""
    opts = getattr(t.optimizer, "optimizers", (t.optimizer,))
    lr = {id(p): g["lr"] for o in opts for g in o.param_groups
          for p in g["params"]}
    return {k: lr[id(v)] for k, v in t.model.named_parameters()
            if id(v) in lr}


def unsigned(g32, g64) -> torch.Tensor:
    """Where float32 cannot sign a gradient: the float64 one lies within
    UNSIGNED_RATIO times the float32 one's rounding error of 0."""
    g64 = g64.double()
    return g64.abs() < UNSIGNED_RATIO * (g32.double() - g64).abs()


def digest(tensors: dict) -> str:
    """A short hash of named tensors' bytes: equal digests, equal bits."""
    h = hashlib.blake2b(digest_size=6)
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def synced_step_gap(got: dict, ref: dict, start: dict, lrs: dict, grads,
                    card_grads=None) -> dict:
    """One synced step held element by element: ``got`` the card's weights
    after it, ``ref`` the CPU's, ``start`` the CPU's weights it started
    from, ``lrs`` each weight's learning rate, ``grads()`` -> (g32, g64)
    the CPU step's float32 gradient and the float64 one from the same
    state, called only where an element parts by more than STEP_ATOL;
    ``card_grads`` (the card's gradients, optional) only name. The
    noise-walked weights are left out. Returns {"old": the largest
    relative norm gap of a weight, "gap": the same over the elements not
    excused, "over": the elements beyond STEP_ATOL, "named": up to
    NAMED_PER_STEP of them (weight, index, card and CPU updates, gradients,
    excused), "excused": how many, "faults": what breaks the rule (held gap
    over COLD_NORM_RTOL, more than STEP_FLIPS of a weight's elements
    excused (rounded up), an excused element parted by more than 2 * lr)};
    the step holds where "faults" is empty."""
    out = {"old": 0.0, "gap": 0.0, "over": 0, "named": [], "excused": 0,
           "faults": []}
    parted = {}
    for name, p in got.items():
        if noise_walked(name):
            continue
        want = ref[name]
        diff = (p.detach().cpu() - want).abs()
        rel = float(diff.norm() / want.norm().clamp_min(1e-30))
        out["old"] = max(out["old"], rel)
        over = diff > STEP_ATOL
        if over.any():
            parted[name] = (diff, over)
        else:
            out["gap"] = max(out["gap"], rel)
    g32, g64 = grads() if parted else ({}, {})
    for name, (diff, over) in parted.items():
        want = ref[name]
        excused = over & unsigned(g32[name], g64[name])
        kept = ~excused
        out["gap"] = max(out["gap"], float(
            diff[kept].norm() / want[kept].norm().clamp_min(1e-30)))
        n, lr = int(excused.sum()), lrs.get(name, 0.0)
        out["over"] += int(over.sum())
        out["excused"] += n
        if n > math.ceil(STEP_FLIPS * want.numel()):
            out["faults"].append(f"{name}: {n} of {want.numel()} elements "
                                 f"excused, over STEP_FLIPS {STEP_FLIPS}")
        if n and float(diff[excused].max()) > 2 * lr + STEP_ATOL:
            out["faults"].append(
                f"{name}: an excused element parted by "
                f"{float(diff[excused].max()):.3e}, over 2 * lr {2 * lr:g}")
        for idx in over.nonzero()[:NAMED_PER_STEP - len(out["named"])]:
            i = tuple(int(x) for x in idx)
            out["named"].append({
                "weight": name, "index": i,
                "card_update": float(got[name][i]) - float(start[name][i]),
                "cpu_update": float(want[i]) - float(start[name][i]),
                "card_g": (None if card_grads is None
                           else float(card_grads[name][i])),
                "g32": float(g32[name][i]), "g64": float(g64[name][i]),
                "excused": bool(excused[i])})
    if out["gap"] > COLD_NORM_RTOL:
        out["faults"].append(f"held gap {out['gap']:.3e} over "
                             f"COLD_NORM_RTOL {COLD_NORM_RTOL}")
    return out


def cold_step_parity(device, data, root, model, d=D, bs=4096,
                     steps=STEP_CHECK, seed=0, synced=False, float64=False,
                     on_done=None, repeat=False):
    """``steps`` steps of ``model`` on ``device`` and on the CPU from the
    same weights and the model's own batches (DropoutNet: the same rows
    dropped, M2VAE: the same normals, drawn once on the host), in float32
    or (``float64``) on both devices in float64. The card's steps run here;
    the CPU's go to ``CHECKS``' worker. At the finish ``on_done`` gets
    {"free": (loss max rel err, weights max relative norm gap without the
    noise-walked weights, eval tables of the card's final weights and state
    on both devices: max abs err over the table scale), "card_s", "cpu_s"}
    and, with ``synced``, "synced": one ``synced_step_gap`` a step (with
    its "loss_err") of a third trainer on ``device`` that starts every
    step from the CPU trainer's state and takes the CPU step's gradients
    (both recorded by the worker). With ``repeat`` every synced step runs
    twice from its state on each device, and each step's entry adds
    "card_twice" and "cpu_twice" (bit-equal) and the digests "card" and
    "cpu" of the weights after it."""
    device = torch.device(device)
    cpu_dev = torch.device("cpu")
    devs = (device, cpu_dev) + ((device,) if synced else ())
    trainers = [bx_trainer(model, dev, data, root, d, bs, seed)
                for dev in devs]
    for t in trainers[1:]:
        t.model.load_state_dict(trainers[0].model.state_dict())
    if float64:
        for t in trainers:
            as_float64(t)
    card, cpu = trainers[:2]
    held = trainers[2] if synced else None
    gen = torch.Generator().manual_seed(seed)
    cpu.host_rng = np.random.default_rng(seed)
    work = []
    for _, batch in zip(range(steps), cpu.batches()):
        kw = {}
        if model == "M2VAE":
            kw = {"draws": cpu.draw(len(batch["user"]))}
        if model == "DropoutNet":
            n = len(batch["user"])
            n_zero = int(n * card.n_dropout)
            masks = []
            for _ in range(2):
                m = torch.ones(n)
                m[torch.randperm(n, generator=gen)[:n_zero]] = 0.0
                masks.append(m)
            kw = {"masks": tuple(masks)}
        work.append((batch, kw))
    if model == "M2VAE":  # the cold rows' eval draw, one on both devices
        normal = cpu.eval_normal(cpu.cold_idx.shape[0])
        card.eval_normal = lambda n: normal.to(device)
        cpu.eval_normal = lambda n: normal

    def step(t, batch, kw):
        return float(t.train_step(t.upload(batch), **_on(kw, t)))

    def tables(t):
        t.refresh_tables()
        return [x.detach().cpu() for x in (t.user_emb, t.item_emb)]

    t0 = time.perf_counter()
    card_losses = [step(card, b, kw) for b, kw in work]
    card_state = copy.deepcopy(card.model.state_dict())
    card_params = _params(card.model)
    card_tables = tables(card)
    card_s = time.perf_counter() - t0
    del card, trainers  # the held trainer alone stays on the card

    def cpu_side():
        states, losses, grads, twice = [], [], [], []
        for b, kw in work:
            if synced:
                states.append(snapshot(cpu))
            losses.append(step(cpu, b, kw))
            if synced and repeat:
                first = (_params(cpu.model), _grads(cpu.model))
                load_state(cpu, states[-1])
                step(cpu, b, kw)
                again = (_params(cpu.model), _grads(cpu.model))
                twice.append(all(same(x[k], y[k]) for x, y in
                                 zip(first, again) for k in x))
            if synced:
                grads.append(_grads(cpu.model))
        final = _params(cpu.model)
        if synced:
            states.append(snapshot(cpu))
        cpu.model.load_state_dict(card_state)
        return losses, final, states, tables(cpu), grads, twice

    def held_steps(states, grads, cpu_losses, cpu_twice) -> list:
        """Each synced step on the card from the CPU's state, held by
        ``synced_step_gap``; the float64 gradients on the CPU trainer,
        turned to float64 at the first step that needs them."""
        lrs = weight_lrs(held)
        g64_s = {}

        def at(i):
            t = time.perf_counter()
            if next(cpu.model.parameters()).dtype != torch.float64:
                as_float64(cpu)
            g64 = step_grads(cpu, states[i][0], *work[i])
            g64_s[i] = time.perf_counter() - t
            return grads[i], g64

        out = []
        for i, (batch, kw) in enumerate(work):
            load_state(held, states[i])
            loss = step(held, batch, kw)
            got = _params(held.model)
            card_g = {k: v.grad for k, v in held.model.named_parameters()}
            r = synced_step_gap(got, states[i + 1][0], states[i][0], lrs,
                                lambda: at(i), card_g)
            r["loss_err"] = abs(loss - cpu_losses[i]) / abs(cpu_losses[i])
            r["g64_s"] = g64_s.get(i, 0.0)
            if repeat:
                load_state(held, states[i])
                step(held, batch, kw)
                again = _params(held.model)
                r["card_twice"] = all(
                    same(again[k], v) for k, v in got.items()) and all(
                    same(v.grad, card_g[k])
                    for k, v in held.model.named_parameters()
                    if card_g[k] is not None)
                r["cpu_twice"] = cpu_twice[i]
                r["card"], r["cpu"] = digest(got), digest(
                    {k: states[i + 1][0][k] for k in got})
            out.append(r)
        return out

    def finish(out, cpu_s):
        cpu_losses, final, states, cpu_tables, grads, twice = out
        a, b = np.asarray(card_losses), np.asarray(cpu_losses)
        table_err = max(float((x - y).abs().max() / y.abs().max())
                        for x, y in zip(card_tables, cpu_tables))
        res = {"free": (float(np.max(np.abs(a - b) / np.abs(b))),
                        _weights_gap(card_params, final), table_err),
               "card_s": card_s, "cpu_s": cpu_s}
        if synced:
            t1 = time.perf_counter()
            res["synced"] = held_steps(states, grads, cpu_losses, twice)
            res["card_s"] += time.perf_counter() - t1
        on_done(res)

    name = f"{model} steps" + (" float64" if float64 else "")
    CHECKS.submit(name, cpu_side, finish)


def _on(kw: dict, t) -> dict:
    """The step's injected draws on trainer ``t``'s device."""
    def move(v):
        if isinstance(v, dict):
            return {k: x.to(t.device) for k, x in v.items()}
        return tuple(x.to(t.device) for x in v)

    return {k: move(v) for k, v in kw.items()}


def cold_run(device, root, ds="bx_synth", runs=COLD_RUNS, d=D, bs=4096,
             topN=(10, 20), seed=0, steps=STEP_CHECK,
             epoch_steps=EPOCH_STEPS):
    """Phase cold: each cold-start model through the CLI on phase train's
    split and MF bus, then checked; DropoutNet once more under
    ``--eval_backend pallas_bf16``; then DropoutNet's and ALDI's steps on the
    card against the CPU. Returns the launches of each kernel counted
    during the bf16 run and, per model, during its CLI run."""
    device = torch.device(device)
    top = str(max(topN))
    t = time.perf_counter()
    data = read_split(root, ds)
    log(f"  split dir read ({time.perf_counter() - t:.2f} s): "
        f"{data.user_num} users x {data.item_num} items, item content "
        f"{data.item_content.shape[1]} columns, max rated {data.max_rated}")
    per_model = {}
    for model, epochs, flags in runs:
        made = []
        payload, launches, evs, secs = cli_run(
            device, root, ds, model, epochs, flags, d, bs, seed, topN,
            data=data, epoch_steps=epoch_steps, on_model=made.append)
        first, last = log_epochs(evs)
        end = [e for e in evs if e["event"] == "run_end"][0]
        bus = load_embeddings(os.path.join(root, "emb"), ds, "item", model)
        ue = torch.as_tensor(bus["user_emb"], device=device)
        ie = torch.as_tensor(bus["item_emb"], device=device)
        width = ue.shape[1]
        if width != (2 * d if model == "ALDI" else d):
            raise AssertionError(f"{model}: eval tables of width {width}")
        equal = lists_vs_plain(data, ue, ie, device, made[-1].test_results,
                               topN=topN)
        del made
        per_model[model] = launches
        log(f"  {model}: {epochs} epoch(s) in {secs:.2f} s (CLI, set-up "
            f"included); loss {first:.5f} -> {last:.5f}; kernel launches "
            f"{ {k: v for k, v in launches.items() if v} } at d={width}; "
            f"three-way test {end['test_seconds']:.3f} s; seconds per epoch "
            f"{payload['efficiency']['seconds_per_completed_epoch_mean']:.3f};"
            f" NDCG@{top} cold "
            f"{payload['metrics'][top]['cold']['NDCG']['mean']:.5f} warm "
            f"{payload['metrics'][top]['warm']['NDCG']['mean']:.5f}; routes "
            f"{routes(evs)}; test lists id-equal to the plain path "
            + ", ".join(f"{s} {e}/{r}" for s, (r, e) in equal.items()))
        if device.type == "cuda" and not launches["fused_sweep"] > 0:
            raise AssertionError(f"{model} left the kernel unlaunched")

    model, _, flags = runs[0]
    made = []
    payload, launches, evs, secs = cli_run(
        device, root, ds, model, 1, [*flags, "--eval_backend", "pallas_bf16"],
        d, bs, seed, topN, tag=f"{model}_bf16", data=data,
        epoch_steps=epoch_steps, on_model=made.append)
    log_epochs(evs)
    bus = load_embeddings(os.path.join(root, "emb"), ds, "item", model)
    ue = torch.as_tensor(bus["user_emb"], device=device)
    ie = torch.as_tensor(bus["item_emb"], device=device)
    equal = lists_vs_plain(data, ue, ie, device, made.pop().test_results,
                           "kernel_bf16", topN)
    log(f"  {model} --eval_backend pallas_bf16: 1 epoch in {secs:.2f} s; "
        f"kernel launches { {k: v for k, v in launches.items() if v} }; "
        f"routes {routes(evs)}; NDCG@{top} cold "
        f"{payload['metrics'][top]['cold']['NDCG']['mean']:.5f}; test lists "
        "id-equal to the plain bf16 path "
        + ", ".join(f"{s} {e}/{r}" for s, (r, e) in equal.items()))
    if device.type == "cuda" and not (launches["fused_sweep_bf16"] > 0
                                      and launches["fused_sweep"] == 0):
        raise AssertionError(f"the bf16 run's launches: {launches}")

    for model in ("DropoutNet", "ALDI"):
        hold_cold_steps(device, data, root, model, d, bs, steps, seed)
    return launches, per_model


# ------------------------------------------------------------- content KNN
def knn_tables(device, q, v, d, seed, integer):
    """(queries, values) on ``device``: integers in [-KNN_INT_MAX,
    KNN_INT_MAX] (exact products) or N(0,1), drawn on the host."""
    rng = np.random.default_rng(seed)
    if integer:
        m = KNN_INT_MAX
        qs = rng.integers(-m, m + 1, (q, d), dtype=np.int8)
        vs = rng.integers(-m, m + 1, (v, d), dtype=np.int8)
    else:
        qs = rng.standard_normal((q, d), dtype=np.float32)
        vs = rng.standard_normal((v, d), dtype=np.float32)
    return (torch.as_tensor(qs, device=device).float(),
            torch.as_tensor(vs, device=device).float())


def timed_s(fn, device):
    """(result, seconds) of one call, the card synchronised around it."""
    _sync(device)
    t = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t


def knn_library(queries, values, k, chunk=LIBRARY_CHUNK):
    """The library yardstick: per chunk of queries one TF32-off
    ``torch.mm`` and ``torch.topk(k + 1)``."""
    out = []
    for s in range(0, queries.shape[0], chunk):
        out.append(torch.topk(exact_scores(queries[s:s + chunk], values),
                              k + 1, dim=1)[1])
    return out


def knn_sweeps(queries, values, device):
    """The retrieval kernel alone over every query chunk of the kernel
    route (fused_sweep, and merge_parts where the sweep splits), against
    operands padded once: device seconds from CUDA events."""
    excl = torch.zeros(values.shape[0], dtype=torch.bool,
                       device=values.device)
    items_t, excl_row = pad_items(values, excl)

    def run():
        for s in range(0, queries.shape[0], USER_CHUNK):
            fused_sweep(queries[s:s + USER_CHUNK].contiguous(), items_t,
                        excl_row)

    return time_ms(run, 1, device, repeats=1) / 1e3


def knn_shape(device, tag, q, v, d, k, seed=0):
    """One shape of phase knn: the entry point (``knn_inner_product``, the
    kernel route on the card) against the plain route, on integer tables
    (ids and values bit-equal; shapes a and b) and on N(0,1) tables (ids
    equal but at near-ties), timed on the N(0,1) tables."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    want = knn_mod.knn_route(v, k, device)
    if cuda and want != "kernel":
        raise AssertionError(f"knn {tag}: route {want} on the card")
    # on the CPU (a rehearsal) the entry point takes the plain route: call
    # the kernel route, whose sweep is the kernel's plain version there
    entry = knn_mod.knn_inner_product if cuda else knn_mod.knn_via_kernel
    out = {"d": d, "queries": q, "values": v, "k": k}
    if tag in KNN_INTEGER_SWEEP:
        qs, vs = knn_tables(device, min(q, USER_CHUNK), v, d, seed, True)
        knn_first_sweep(tag, vs if tag in KNN_SELF else qs, vs, d)
        log(f"  knn {tag} {q} x {v} d={d} k={k}, integer tables: the first "
            f"{min(q, USER_CHUNK)} queries' sweep bit-equal to its plain "
            "version")
        del qs, vs
    for integer in ((True, False) if tag in KNN_INTEGER else (False,)):
        qs, vs = knn_tables(device, q, v, d, seed, integer)
        if tag in KNN_SELF:
            qs = vs
        reset_launches()
        rows0 = ret.apply_exact_fallback.rows
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        (ks, ki), secs = timed_s(lambda: entry(qs, vs, k, device=device),
                                 device)
        launches = launch_counts()
        fb = ret.apply_exact_fallback.rows - rows0
        peak = torch.cuda.max_memory_allocated(device) / 2**30 if cuda \
            else 0.0
        (ps, pi), plain_s = timed_s(lambda: knn_mod.knn_plain(
            qs, vs, k, device=device), device)
        if cuda and not launches["fused_sweep"] > 0:
            raise AssertionError(f"knn {tag}: the kernel route launched "
                                 f"nothing: {launches}")
        kind = "integer" if integer else "N(0,1)"
        if integer:
            knn_first_sweep(tag, qs, vs, d)
            if not (np.array_equal(ki, pi) and np.array_equal(ks, ps)):
                bad = int((ki != pi).any(axis=1).sum())
                raise AssertionError(f"knn {tag} integer tables: {bad} rows "
                                     "differ from the plain route")
            note = ("ids and values bit-equal to the plain route, the "
                    f"first {min(q, USER_CHUNK)} queries' sweep bit-equal "
                    "to its plain version")
        else:
            rows, equal = compare_lists(qs, vs, np.arange(q), ki, pi)
            note = (f"rows id-equal to the plain route {equal}/{rows} "
                    f"(others near-ties), max value gap "
                    f"{float(np.abs(ks - ps).max()):.3e}")
            out.update(kernel_s=secs, plain_s=plain_s, launches=launches,
                       fallback_rows=fb, peak_gib=peak,
                       max_abs_err=float(np.abs(ks - ps).max()))
        log(f"  knn {tag} {q} x {v} d={d} k={k}, {kind} tables: {note}; "
            f"route {'kernel' if cuda else 'kernel (plain sweep)'}, "
            f"{secs:.3f} s (plain route "
            f"{plain_s:.3f} s); launches "
            f"{ {n: c for n, c in launches.items() if c} }; exact fallback "
            f"{fb} rows; peak card memory {peak:.2f} GiB")
    # the entry point's time is its N(0,1) run above (the kernel loaded and
    # run before it); then the kernel alone and the library, warm
    out["sweep_s"] = knn_sweeps(qs, vs, device)
    knn_library(qs[:LIBRARY_CHUNK], vs, k)  # warm-up: its chunk's shapes
    _, out["library_s"] = timed_s(lambda: knn_library(qs, vs, k), device)
    # each table read once, the (Q, k) scores and ids written once
    bound_ms, out["bound_by"] = sweep_bound(2.0 * q * v * d,
                                            4.0 * (q + v) * d + 8.0 * q * k)
    out["bound_s"] = bound_ms / 1e3
    log(f"  knn {tag} timed warm: entry point {out['kernel_s']:.3f} s, the "
        f"kernel's sweeps alone {out['sweep_s']:.3f} s, plain route {out['plain_s']:.3f} s, "
        f"library (mm + topk({k + 1})) {out['library_s']:.3f} s, bound "
        f"{out['bound_s']:.3f} s ({out['bound_by']})")
    return out


def knn_first_sweep(tag, qs, vs, d):
    """The sweep of the first chunk of queries against its plain version,
    bit for bit (integer tables)."""
    excl = torch.zeros(vs.shape[0], dtype=torch.bool, device=vs.device)
    items_t, excl_row = pad_items(vs, excl)
    chunk = qs[:USER_CHUNK].contiguous()
    hold_equal(f"knn {tag} fused_sweep d={d}",
               fused_sweep(chunk, items_t, excl_row),
               fused_sweep_reference(chunk, items_t, excl_row))


def knn_run(device, shapes=KNN_SHAPES, seed=0):
    """Phase knn: each shape of ``shapes`` through ``knn_shape``. Returns
    {"shapes": {tag: numbers}, "launches": the kernel route's launches}."""
    out, launches = {}, {"fused_sweep": 0, "merge_parts": 0}
    for tag, q, v, d, k in shapes:
        out[tag] = knn_shape(device, tag, q, v, d, k, seed)
        for name in launches:
            launches[name] += out[tag]["launches"][name]
    return {"shapes": out, "launches": launches}


# ------------------------------------------------- the content-feature models
def knn_events(evs) -> list:
    """(route, queries, values, d, k) of the run's content searches."""
    return [(e["route"], e["queries"], e["values"], e["d"], e["k"])
            for e in evs if e["event"] == "knn_route"]


def content_run(device, root, ds="bx_synth", runs=CONTENT_RUNS, d=D,
                bs=4096, topN=(10, 20), seed=0, steps=STEP_CHECK,
                epoch_steps=EPOCH_STEPS):
    """Phase content: each content-feature cold model through the CLI on
    phase train's split and MF bus (AMR on VBPR's bus), checked by
    ``graph_cli`` (launches, fallback, peak memory, each epoch's split,
    lists held to the plain path, each split's route), its content
    searches on the JAX package's route; then VBPR's and MetaEmbedding's
    steps on the card against the CPU. Returns {model: launches}."""
    device = torch.device(device)
    data = read_split(root, ds)
    expected = expected_routes(data, "item", bs, max(topN), device)
    per_model = {}
    for model, epochs, flags in runs:
        r = graph_cli(device, root, ds, model, epochs, flags, data, d, bs,
                      seed, topN, expected=expected, epoch_steps=epoch_steps)
        check_knn_calls(model, r["knn"], device)
        per_model[model] = r["launches"]
    for model in ("VBPR", "MetaEmbedding"):
        hold_cold_steps(device, data, root, model, d, bs, steps, seed)
    return per_model


def check_knn_calls(model, calls, device) -> None:
    """The run's content searches: as many as the model makes, each on the
    JAX package's route (the kernel on the card where it fits)."""
    log(f"    knn routes {calls}")
    if len(calls) != KNN_CALLS.get(model, 0) or any(
            route != knn_mod.knn_route(v, k, device)
            for route, _, v, _, k in calls):
        raise AssertionError(f"{model}: content searches {calls}")


def hold_cold_steps(device, data, root, model, d, bs, steps, seed,
                    repeat=False) -> list:
    """``cold_step_parity`` of ``model``, logged and held at its finish:
    losses within STEP_LOSS_RTOL, weights within COLD_NORM_RTOL in relative
    norm, the eval tables of one set of weights within STEP_LOSS_RTOL. A
    model of SYNCED_STEPS is held on its float32 steps from the CPU's state
    (loss and weights, element by element: ``synced_step_gap``) and on its
    free run in float64 (the whole rule); its float32 free run is logged.
    Returns the list that its finish fills with the synced steps' entries
    (``repeat``: each step run twice on each device)."""
    synced = model in SYNCED_STEPS
    results, entries = {}, []

    def text(loss_err, gap, table_err):
        return (f"loss max rel err {loss_err:.3e}, weights max relative "
                f"norm gap {gap:.3e}, eval tables of one set of weights max "
                f"rel err {table_err:.3e}")

    def done(key, r):
        results[key] = r
        if len(results) < (2 if synced else 1):
            return
        r = results["f32"]
        held = [r["free"]]
        line = f"{text(*r['free'])}"
        faults = []
        if synced:
            r64 = results["f64"]
            entries.extend(r["synced"])
            s = synced_summary(r["synced"])
            held = [(s["loss_err"], s["gap"], r["free"][2]), r64["free"]]
            faults = s["faults"]
            line += (f"; each float32 step from the CPU's state: "
                     f"{s['text']}; free-running in float64: "
                     f"{text(*r64['free'])}")
        dev = torch.device(device).type
        sides = "; ".join(f"{k}: {dev} side {v['card_s']:.2f} s, cpu side "
                          f"{v['cpu_s']:.2f} s" for k, v in results.items())
        log(f"  {model}: {steps} steps {dev} vs cpu ({sides}): {line}")
        for loss_err, gap, table_err in held:
            if faults or not (loss_err <= STEP_LOSS_RTOL
                              and gap <= COLD_NORM_RTOL
                              and table_err <= STEP_LOSS_RTOL):
                raise AssertionError(f"{model}: the card's steps disagree "
                                     f"with the CPU's {faults}")

    cold_step_parity(device, data, root, model, d, bs, steps, seed, synced,
                     on_done=lambda r: done("f32", r), repeat=repeat)
    if synced:
        cold_step_parity(device, data, root, model, d, bs, steps, seed,
                         float64=True, on_done=lambda r: done("f64", r))
    return entries


def synced_summary(steps: list) -> dict:
    """The synced steps' entries (``synced_step_gap``) summed up: the
    largest loss error, single-norm gap and held gap, the faults, and a log
    text naming every element beyond STEP_ATOL that a step's entry holds
    (its card and CPU updates, gradients, and whether it was excused)."""
    s = {"loss_err": max(r["loss_err"] for r in steps),
         "old": max(r["old"] for r in steps),
         "gap": max(r["gap"] for r in steps),
         "faults": [f"step {i}: {f}" for i, r in enumerate(steps)
                    for f in r["faults"]]}
    named = "; ".join(
        f"step {i} {e['weight']}{list(e['index'])} "
        f"{'excused' if e['excused'] else 'held'}: update card "
        f"{e['card_update']:+.3e} cpu {e['cpu_update']:+.3e}, g card "
        f"{e['card_g']:+.3e} g32 {e['g32']:+.3e} g64 {e['g64']:+.3e}"
        for i, r in enumerate(steps) for e in r["named"])
    over = sum(r["over"] for r in steps)
    s["text"] = (
        f"loss max rel err {s['loss_err']:.3e}, weights gap "
        f"{s['old']:.3e} (one norm a weight), held gap {s['gap']:.3e} "
        f"(excused elements out); {over} elements beyond {STEP_ATOL} in "
        f"{sum(1 for r in steps if r['over'])} of {len(steps)} steps "
        f"(float64 gradients {sum(r['g64_s'] for r in steps):.2f} s), "
        f"{sum(r['excused'] for r in steps)} excused"
        + (f": {named}" if named else ""))
    return s


def synced_repeats(model="VBPR", repeats=5, device="cuda", shape=BX,
                   d=D, bs=4096, steps=STEP_CHECK, seed=0) -> int:
    """``model``'s synced check (``hold_cold_steps``) ``repeats`` times in
    this process on phase train's split and MF bus at ``shape``, every
    synced step run twice from its state on each device: per repeat, each
    step's bit-equality on both sides, the digests of both sides' weights
    after it, and the rule's line. Returns the number of repeats that
    failed. On the card:
    ``python3 -c "import sys, chip_smoke as cs; sys.exit(cs.synced_repeats())"``
    """
    device = torch.device(device)
    log(f"  {smi_line() if device.type == 'cuda' else 'cpu'}; host "
        f"{cpu_line()}")
    CHECKS.start()
    failed = 0
    try:
        with tempfile.TemporaryDirectory() as root:
            train_run(device, *shape, d=d, bs=bs, root=root,
                      content_dim=BX_CONTENT)
            CHECKS.poll(wait=True)
            data = read_split(root, "bx_synth")
            for rep in range(repeats):
                out = hold_cold_steps(device, data, root, model, d, bs,
                                      steps, seed, repeat=True)
                try:
                    CHECKS.poll(wait=True)
                except AssertionError as e:
                    failed += 1
                    log(f"  repeat {rep}: FAILED {e}")
                log(f"  repeat {rep}: both sides twice bit-equal at every "
                    f"step: card {all(r['card_twice'] for r in out)}, cpu "
                    f"{all(r['cpu_twice'] for r in out)}; digests card "
                    f"{[r['card'] for r in out]} cpu "
                    f"{[r['cpu'] for r in out]}")
    finally:
        CHECKS.close()
    log(f"{model}: {repeats - failed} of {repeats} repeats passed")
    return failed


# ----------------------------------------------- the reconstruction models
def recon_run(device, root, ds="bx_synth", runs=RECON_RUNS, d=D, bs=4096,
              topN=(10, 20), seed=0, steps=STEP_CHECK, n_check=CGRC_CHECK,
              epoch_steps=EPOCH_STEPS):
    """Phase recon: each reconstruction-family model through the CLI on
    phase train's split and MF bus, checked by ``graph_cli`` (launches,
    fallback, peak memory, each epoch's split, lists held to the plain
    path, each split's route), its content searches on the JAX package's
    route, FSGNN's graph build and CGRC's evaluations logged from the event
    log; then CCFCRec's and M2VAE's steps on the card against the CPU,
    CGRC's top-k users against the CPU's and FSGNN's step split, both on
    the trainer of the model's CLI run. Returns {model: launches}."""
    device = torch.device(device)
    data = read_split(root, ds)
    expected = expected_routes(data, "item", bs, max(topN), device)
    per_model, kept = {}, {}
    for model, epochs, flags in runs:
        keep = kept.setdefault(model, []).append \
            if model in ("CGRC", "FSGNN") else None
        r = graph_cli(device, root, ds, model, epochs, flags, data, d, bs,
                      seed, topN, expected=expected, epoch_steps=epoch_steps,
                      on_model=keep)
        check_knn_calls(model, r["knn"], device)
        for e in r["events"]:
            if e["event"] == "fsgnn_graph":
                log(f"    graph build {e['build_s']:.2f} s: PPR ({e['ppr_route']}) "
                    f"{e['ppr_s']:.2f} s, {e['ppr_edges']} edges added; "
                    f"cosine kNN {e['knn_s']:.2f} s, user-user "
                    f"{e['uu_edges']} and item-item {e['ii_edges']} "
                    f"entries; merged graph {e['merged_nnz']} entries")
            elif e["event"] == "cgrc_eval":
                log(f"    evaluation: top-{e['k']} users of {e['cold_items']}"
                    f" cold items {e['topk_users_s']:.3f} s, Ĝ rebuild "
                    f"{e['ghat_rebuild_s']:.3f} s ({e['ghat_edges']} "
                    f"entries), propagation {e['propagate_s']:.3f} s")
        per_model[model] = r["launches"]
        if keep is not None:
            kept[model].append(r["peak_gib"])
    for model in ("CCFCRec", "M2VAE"):
        hold_cold_steps(device, data, root, model, d, bs, steps, seed)
    cgrc_topk_check(device, data, *kept.pop("CGRC"), n_check)
    fsgnn_step_split(device, kept.pop("FSGNN")[0], d)
    return per_model


def cgrc_topk_check(device, data, tm, peak, n_check=CGRC_CHECK):
    """CGRC's top-k users on ``device`` against the same function on the CPU
    (on ``CHECKS``' worker) from the same weights and inputs, for the first
    ``n_check`` cold items of its CLI run's trainer ``tm``: rows id-equal,
    or differing only where the logits at both lists agree position by
    position within GAP_REL of the row's largest. ``peak`` is the card's
    peak memory over that run (its evaluations: the top-k users of every
    cold item, the Ĝ rebuild, the propagation; their seconds are the run's
    ``cgrc_eval`` events)."""
    device = torch.device(device)
    m = tm.model
    k = min(tm.topk, data.user_num)
    t0 = time.perf_counter()
    with torch.no_grad():
        x_all = tm.item_x()
        h_u = tm.propagate_frozen(tm.full_graph, m.user_emb, x_all, tm.Lg)
        x_cold = x_all[tm.cold_idx[:n_check]]
        got = m.topk_users(h_u, x_cold, k).cpu()
        cpu_model = copy.deepcopy(m).cpu()
        h_u, x_cold = h_u.cpu(), x_cold.cpu()
    card_s = time.perf_counter() - t0

    def cpu_side():
        with torch.no_grad():
            ref = cpu_model.topk_users(h_u, x_cold, k)
            bad = (got != ref).any(dim=1).nonzero().squeeze(1)
            hu, xi = cpu_model.edge_parts(h_u, x_cold)
            b1, w2, b2 = cpu_model.mlp_tail()
            for r in bad.tolist():
                sa, sb = (cgrc_mod.block_logits(xi[r:r + 1] + b1, hu[ids],
                                                w2, b2)[0]
                          for ids in (got[r], ref[r]))
                scale = max(float(sa.abs().max()), float(sb.abs().max()))
                if float((sa - sb).abs().max()) > GAP_REL * scale + 1e-30:
                    raise AssertionError(f"CGRC cold item {r}: top users "
                                         f"{got[r][:6]} vs {ref[r][:6]}")
        return int(bad.shape[0])

    def finish(n_bad, cpu_s):
        log(f"  CGRC: peak card memory {peak:.2f} GiB over its CLI run "
            f"(set-up, training, evaluations); top-{k} users of the first {got.shape[0]} cold"
            f" items x {data.user_num} users on the {device.type} against "
            f"the CPU's ({device.type} side {card_s:.2f} s, cpu side "
            f"{cpu_s:.2f} s): {got.shape[0] - n_bad} rows id-equal, the "
            "others near-ties")

    CHECKS.submit("CGRC top-k users", cpu_side, finish)


def fsgnn_step_split(device, tm, d=D, seed=0, reps=10):
    """The training step of FSGNN's trainer ``tm`` (its CLI run's) on
    ``device`` (mean of ``reps`` steps), beside one forward + backward of
    each of its SpMM operators (the merged graph, the training graph, the
    two kNN graphs) times the applies a step makes, and of the GAT's
    segment softmax and sums: the shares of the step. Returns the
    numbers."""
    tm.host_rng = np.random.default_rng(seed)
    batches = [tm.upload(b) for _, b in zip(range(reps), tm.batches())]
    it = iter(range(10 ** 9))
    step_ms = time_ms(lambda: tm.train_step(
        batches[next(it) % reps]), reps, device, repeats=1)
    m = tm.model
    applies = {"merged": (tm.g_complete, tm.n_layers),
               "train": (tm.g_train, len(m.fc_dec)),
               "user kNN": (tm.g_uu, len(m.sc_uu)),
               "item kNN": (tm.g_ii, len(m.sc_ii))}
    out = {"step_ms": step_ms, "spmm_ms": {}}
    spmm_total = 0.0
    for name, (op, count) in applies.items():
        n = op.graph.n_rows
        x = torch.randn((n, d), device=device, requires_grad=True)
        g = torch.randn((n, d), device=device)
        ms = time_ms(lambda: op(x).backward(g), reps, device,
                         repeats=1)
        out["spmm_ms"][name] = ms
        spmm_total += count * ms
    h0_u = m.proj_u(tm.raw_u).detach().requires_grad_()
    h0_i = m.proj_i(tm.raw_i).detach().requires_grad_()

    def gat():
        enc_u, enc_i = tm.gat_encode(h0_u, h0_i, h0_u, h0_i)
        (enc_u.sum() + enc_i.sum()).backward()

    out["gat_ms"] = time_ms(gat, reps, device, repeats=1)
    out["spmm_share"] = spmm_total / step_ms
    out["gat_share"] = out["gat_ms"] / step_ms
    log(f"  FSGNN step split (its CLI run's trainer): step "
        f"{step_ms:.3f} ms; SpMM forward + backward "
        + ", ".join(f"{k} {v:.3f} ms x {applies[k][1]}"
                    for k, v in out["spmm_ms"].items())
        + f" = {100 * out['spmm_share']:.1f}% of the step; GAT segment "
        f"softmax and sums {out['gat_ms']:.3f} ms "
        f"({100 * out['gat_share']:.1f}%)")
    return out


# -------------------------------------------------------------------- USIM
def usim_run(device, root, ds="bx_synth", d=D, bs=4096, topN=(10, 20),
             seed=0, epochs=1, check_bs=USIM_CHECK_BS,
             n_infer=USIM_INFER_CHECK, usim_flags=None,
             epoch_steps=USIM_EPOCH_STEPS):
    """Phase usim: USIM through the CLI on phase train's split and MF bus,
    checked by ``graph_cli`` (launches, fallback, peak memory, each split's
    route, lists held to the plain path), each epoch's split logged (host
    batches, step enqueue, device step, inference of the cold rows,
    validation; the test); then the card-vs-CPU step (``usim_check``).
    ``usim_flags`` ({flag: value}) narrow the model for the CPU rehearsal.
    Returns the launches and the CLI run's trainer for
    ``usim_split_phase``, which ``main`` runs after the checks are joined:
    the worker's CPU sides would slow the host's enqueue while it is
    timed."""
    device = torch.device(device)
    usim_flags = dict(usim_flags or {})
    flags = [x for k, v in usim_flags.items() for x in (f"--{k}", str(v))]
    data = read_split(root, ds)
    expected = expected_routes(data, "item", bs, max(topN), device)
    kept = []
    r = graph_cli(device, root, ds, "USIM", epochs, flags, data, d, bs,
                  seed, topN, expected=expected, epoch_steps=epoch_steps,
                  on_model=kept.append)
    end = [e for e in r["events"] if e["event"] == "run_end"][0]
    for e in r["epochs"]:
        log(f"    USIM epoch {e['epoch']}: {e['batches']} batches of {bs}: "
            f"host batches {e['host_s']:.3f} s, step enqueue "
            f"{e['step_host_s']:.3f} s, device step "
            f"{e['step_device_s']:.3f} s, inference of "
            f"{data.mapped_cold_item_idx.shape[0]} cold items "
            f"{e['refresh_s']:.3f} s, validation {e['validation_s']:.3f} s;"
            f" three-way test {end['test_seconds']:.3f} s")
    usim_check(device, data, root, d, check_bs, seed, n_infer, usim_flags)
    return r["launches"], kept[-1]


# the step split and its bounds live in the tool (``profile_usim``)
usim_step_split = profile_usim.usim_step_split


def usim_split_phase(tm, ceiling_iters=profile_usim.CEILING_ITERS):
    """Phase usim-split on phase usim's trainer ``tm``, through
    ``profile_usim``: ``_eval_tables`` twice (the second timed: the
    inference of the cold items an epoch) and the validation sweep, its
    launch counts zeroed just before and read just after; then one batch
    step split into its phases beside their bounds
    (``usim_step_split``), ``_rollouts`` alone, the in-place ceilings and
    each phase's floor fraction; held: the phases' sum against the step's
    own events, every time finite, ``fused_sweep`` launched (on the card).
    Returns (report, launches)."""
    ev = profile_usim.eval_report(tm, reps=2)
    report = profile_usim.step_report(tm, ev["eval_tables_s"][1] * 1e3,
                                      iters=ceiling_iters)
    times = [*report["phases_ms_per_batch"].values(),
             *report["ceilings_ms"].values(), report["rollout_only_ms"],
             report["inference_ms_per_epoch"]]
    if not all(np.isfinite(t) for t in times):
        raise AssertionError(f"USIM split: times not finite {times}")
    if tm.device.type == "cuda" and not ev["launches"]["fused_sweep"]:
        raise AssertionError("USIM split: the validation sweep launched no "
                             "fused_sweep")
    log(f"  USIM roofline: {json.dumps(report)}")
    return report, ev["launches"]


def usim_check(device, data, root, d=D, bs=USIM_CHECK_BS, seed=0,
               n_infer=USIM_INFER_CHECK, usim_flags=None):
    """One USIM batch step on ``device`` and on the CPU (on ``CHECKS``'
    worker) from the same weights and the same draws (drawn on the host),
    at full width, after the greedy inference of the first ``n_infer``
    cold items from the same weights. Held at the finish: the rollout
    actions equal (a difference is logged with the CPU's top-2 gap of the
    noisy logits at that row), the losses within STEP_LOSS_RTOL, the nets
    within COLD_NORM_RTOL in relative norm, the inference's actions equal
    and its states within STEP_LOSS_RTOL of their scale."""
    device = torch.device(device)
    card = bx_trainer("USIM", device, data, root, d, bs, seed,
                      **(usim_flags or {}))
    m = card.model
    cpu_model = copy.deepcopy(m).cpu()
    cpu_opts = usim_mod.make_optimizers(cpu_model, card.args)
    card.host_rng = np.random.default_rng(seed)
    batch = next(iter(card.batches()))
    draws = usim_mod.draw_usim(cpu_model, bs,
                               torch.Generator().manual_seed(seed), "cpu")
    cold = card.cold_idx[:n_infer].cpu()

    def run(model, opts, dev):
        model.trace = []
        state, acts = model._infer(model.actor,
                                   model.content[cold.to(dev)],
                                   with_actions=True)
        out = model._batch_step(
            torch.as_tensor(batch["items"], device=dev),
            torch.as_tensor(batch["weight"], device=dev),
            {k: v.to(dev) for k, v in draws.items()}, *opts)
        trace, model.trace = model.trace, None
        return {"state": state.cpu(), "infer_actions": acts.cpu(),
                "actions": out["actions"].cpu(),
                "losses": out["losses"].cpu(),
                "trace": [x.cpu() for x in trace],
                "params": _params(model)}

    t0 = time.perf_counter()
    got = run(m, (card.actor_opt, card.critic_opt), device)
    card_s = time.perf_counter() - t0
    max_time, n_user = m.max_time, m.n_user
    del card, m

    def finish(ref, cpu_s):
        diff = (got["actions"] != ref["actions"]).nonzero()
        if diff.numel():
            r, t, b = diff[0].tolist()
            top2 = ref["trace"][r * max_time + t][b].topk(2).values
            log(f"  USIM: rollout {r} step {t} row {b}: action "
                f"{int(got['actions'][r, t, b])} on the {device.type}, "
                f"{int(ref['actions'][r, t, b])} on the CPU; the CPU's "
                f"top-2 noisy logits {top2.tolist()} (gap "
                f"{float(top2[0] - top2[1]):.3e}); {diff.shape[0]} "
                "differing actions in all")
        a, b_ = got["losses"], ref["losses"]
        loss_err = float(((a - b_).abs() / b_.abs()).max())
        gap = max(float((got["params"][k] - v).norm()
                        / v.norm().clamp_min(1e-30))
                  for k, v in ref["params"].items())
        acts_equal = torch.equal(got["infer_actions"], ref["infer_actions"])
        state_err = float((got["state"] - ref["state"]).abs().max()
                          / ref["state"].abs().max())
        log(f"  USIM: one batch step of {bs} items x {n_user} actions "
            f"{device.type} vs cpu ({device.type} side {card_s:.2f} s, cpu "
            f"side {cpu_s:.2f} s): rollout actions "
            f"{'equal' if not diff.numel() else 'DIFFER'} "
            f"({got['actions'].numel()}, "
            f"{int((got['actions'] == n_user - 1).sum())} stops); losses "
            f"max rel err {loss_err:.3e}; nets max relative norm gap "
            f"{gap:.3e}; greedy inference of {cold.shape[0]} cold items: "
            f"actions {'equal' if acts_equal else 'DIFFER'}, states max "
            f"rel err {state_err:.3e}")
        if not (not diff.numel() and loss_err <= STEP_LOSS_RTOL
                and gap <= COLD_NORM_RTOL and acts_equal
                and state_err <= STEP_LOSS_RTOL):
            raise AssertionError("USIM: the card's step disagrees with the "
                                 "CPU's")

    CHECKS.submit("USIM step", lambda: run(cpu_model, cpu_opts,
                                           torch.device("cpu")), finish)


def signal_run(device, root, n_users=ML[0], n_items=ML[1], nnz=ML[2],
               content_dim=ML_CONTENT, d=D, epochs=1, bs=4096, seed=0,
               topN=(10, 20)):
    """Phase cold-signal: a latent-factor split (content a noisy view of
    the item factors) at the given shape; MF, then DropoutNet on its bus,
    each ``epochs`` epochs through the CLI. Every split must take the
    route the JAX package takes (``EvalSweep.kernel_supported``: plain
    where a user is rated beyond the kernel's candidates). Logs the
    cold-setting NDCG of both beside chance (seeded N(0,1) tables through
    the same test): whether DropoutNet's content lifts its cold ranking
    above MF's (whose cold rows never see a positive) is a finding of the
    run, not a check. Returns the cold NDCGs."""
    device = torch.device(device)
    top = str(max(topN))
    t = time.perf_counter()
    pairs, _, vf = latent_interactions(n_users, n_items, nnz, seed=seed)
    res = write_split(root, "ml_latent", pairs, seed, content_dim,
                      latent_content(vf, content_dim, seed=seed))
    degree = np.bincount(res.warm_train[:, 0])
    log(f"  latent split written ({time.perf_counter() - t:.2f} s): "
        f"{len(pairs)} pairs, max train degree {degree.max()}, "
        f"{int((degree > CANDIDATES - max(topN)).sum())} users above "
        f"{CANDIDATES - max(topN)}")
    data = read_split(root, "ml_latent")
    expected = expected_routes(data, "item", bs, max(topN), device)
    cold = {}
    for model, flags in (("MF", []), ("DropoutNet", list(COLD_RUNS[0][2]))):
        payload, launches, evs, secs = cli_run(device, root, "ml_latent",
                                               model, epochs, flags, d, bs,
                                               seed, topN, data=data)
        first, last = log_epochs(evs)
        cold[model] = payload["metrics"][top]["cold"]["NDCG"]["mean"]
        log(f"  {model}: {epochs} epochs in {secs:.2f} s; loss {first:.5f} "
            f"-> {last:.5f}; NDCG@{top} cold {cold[model]:.5f} all "
            f"{payload['metrics'][top]['all']['NDCG']['mean']:.5f}; kernel "
            f"launches { {k: v for k, v in launches.items() if v} }; routes "
            f"{routes(evs)}")
        check_routes(model, evs, expected)
        if not np.isfinite(cold[model]):
            raise AssertionError(f"{model}: cold NDCG {cold[model]}")
    rng = np.random.default_rng(seed + 3)
    chance = three_way_test(
        data, *(torch.as_tensor(rng.standard_normal((n, d), dtype=np.float32),
                                device=device)
                for n in (data.user_num, data.item_num)),
        topN=topN, device=device, verbose=False)
    cold["chance"] = float(chance["cold"]["performance"][-1][3])
    log(f"  chance (N(0,1) tables): NDCG@{top} cold {cold['chance']:.5f} all "
        f"{chance['all']['performance'][-1][3]:.5f}")
    order = sorted(cold, key=cold.get, reverse=True)
    log(f"  cold NDCG@{top}, highest first: "
        + ", ".join(f"{k} {cold[k]:.5f}" for k in order))
    return cold


# ------------------------------------------------------- the graph backbones
def graph_stats(data) -> dict:
    """Nodes, edges, ELL width K, tail edges, the largest degree and the
    nodes of degree 0 of the data's normalized adjacency."""
    host = data.norm_adj
    cols, _, tail_rows, _, _ = spmm_mod.ell_arrays_host(host)
    deg = np.bincount(host.rows, minlength=host.shape[0])
    return {"nodes": int(host.shape[0]), "nnz": host.nnz,
            "K": int(cols.shape[1]), "tail": int(tail_rows.shape[0]),
            "tail_rows": int(np.unique(tail_rows).shape[0]),
            "max_degree": int(deg.max()), "zero_degree": int((deg == 0).sum())}


def check_fp32_matmul(device, n=4096, d=D, seed=0) -> float:
    """The contrastive products (InfoNCE's 4096 x 4096, NCL's 4096 x all
    items) must be fp32 with TF32 off, as the JAX package's CPU path: the
    switches, then one 4096 x d x 4096 product against float64. TF32's
    10-bit mantissa would leave ~1e-3 of the largest score. Returns the
    relative error."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise AssertionError("fp32 matmuls may run in TF32")
    rng = np.random.default_rng(seed)
    a, b = (rng.standard_normal((n, d)) for _ in range(2))
    got = (torch.as_tensor(a, dtype=torch.float32, device=device)
           @ torch.as_tensor(b, dtype=torch.float32, device=device).T)
    ref = a @ b.T
    err = float(np.abs(got.cpu().double().numpy() - ref).max()
                / np.abs(ref).max())
    if err > FP32_RTOL:
        raise AssertionError(f"{n} x {d} x {n} product: rel err {err}")
    return err


def graph_cli(device, root, ds, model, epochs, flags, data, d=D, bs=4096,
              seed=0, topN=(10, 20), cold_object="item", expected=None,
              epoch_steps=0, on_model=None):
    """One graph (or cold) model through the CLI on ``data`` (its split,
    already read), then checked: launches, the exact fallback's rows and
    seconds during the run, the card's peak memory, each epoch's split, the
    three-way-test lists of the bus tables against the plain path, and
    (``expected``) each split's route. Returns the run's launches, epoch
    events and peak memory."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    top = str(max(topN))
    ret.apply_exact_fallback.rows = 0
    ret.apply_exact_fallback.seconds = 0.0
    base = peak_start(device)
    made = []
    payload, launches, evs, secs = cli_run(
        device, root, ds, model, epochs, flags, d, bs, seed, topN,
        cold_object=cold_object, data=data, epoch_steps=epoch_steps,
        on_model=made.append)
    fb_rows = ret.apply_exact_fallback.rows
    fb_s = ret.apply_exact_fallback.seconds
    peak = peak_gib(device, base)
    first, last = log_epochs(evs)
    end = [e for e in evs if e["event"] == "run_end"][0]
    bus = load_embeddings(os.path.join(root, "emb"), ds, cold_object, model)
    ue = torch.as_tensor(bus["user_emb"], device=device)
    ie = torch.as_tensor(bus["item_emb"], device=device)
    equal = lists_vs_plain(data, ue, ie, device, made[-1].test_results,
                           topN=topN, cold_object=cold_object)
    if on_model is not None:
        on_model(made[-1])
    del made
    log(f"  {model} ({cold_object} cold): {epochs} epoch(s) in {secs:.2f} s "
        f"(CLI, set-up included); loss {first:.5f} -> {last:.5f}; kernel "
        f"launches { {k: v for k, v in launches.items() if v} }; three-way "
        f"test "
        f"{end['test_seconds']:.3f} s; exact fallback {fb_rows} rows in "
        f"{fb_s:.3f} s; peak card memory {peak:.2f} GiB; seconds per epoch "
        f"{payload['efficiency']['seconds_per_completed_epoch_mean']:.3f}; "
        f"NDCG@{top} all {payload['metrics'][top]['all']['NDCG']['mean']:.5f}"
        f" cold {payload['metrics'][top]['cold']['NDCG']['mean']:.5f}; "
        f"routes {routes(evs)}; test lists id-equal to the plain path "
        + ", ".join(f"{s} {e}/{r}" for s, (r, e) in equal.items()))
    # where the JAX package sends every split to the plain sweep (a user
    # rated beyond the kernel's candidates), the kernel has nothing to run
    kernel_route = True
    if expected is not None:
        check_routes(model, evs, expected)
        kernel_route = ["kernel"] in expected.values()
    if cuda and kernel_route and not launches["fused_sweep"] > 0:
        raise AssertionError(f"{model} left the kernel unlaunched")
    return {"launches": launches, "knn": knn_events(evs),
            "epochs": [e for e in evs if e["event"] == "epoch"],
            "events": evs, "peak_gib": peak}


def ncl_proto(device, data, d=D, bs=4096, seed=0, steps=STEP_CHECK):
    """NCL on the card past its warm-up: ``steps`` steps, the e-step
    (k-means of the user and of the item tables, each timed), then
    ``steps`` steps with the proto term on; every loss must be finite."""
    device = torch.device(device)
    tm = TRAINERS["NCL"](Config(default_args(
        model="NCL", emb_size=d, bs=bs, seed=seed, save_emb=False,
        device=str(device)), data))
    batches = pairwise_batches(data, bs, np.random.default_rng(seed))
    warm = [float(tm.train_step(tm.upload(b)))
            for _, b in zip(range(steps), batches)]
    secs = {}
    for side in ("user_emb", "item_emb"):
        _sync(device)
        t = time.perf_counter()
        kmeans(getattr(tm.model, side).detach(), tm.k,
               generator=tm.generator)
        _sync(device)
        secs[side] = time.perf_counter() - t
    t = time.perf_counter()
    tm.epoch_hook(ncl_mod.WARMUP_EPOCHS)
    _sync(device)
    e_step_s = time.perf_counter() - t
    if not (tm._proto_on and tm.clusters[0].shape == (tm.k, d)):
        raise AssertionError("the e-step left the proto term off")
    proto = [float(tm.train_step(tm.upload(b)))
             for _, b in zip(range(steps), batches)]
    log(f"  NCL e-step on the card: k-means ({tm.k} clusters, 20 "
        f"iterations) users {secs['user_emb']:.4f} s, items "
        f"{secs['item_emb']:.4f} s; e-step {e_step_s:.4f} s; {steps} "
        f"warm-up steps loss {warm[0]:.5f} -> {warm[-1]:.5f}, {steps} proto "
        f"steps {proto[0]:.5f} -> {proto[-1]:.5f}")
    if not np.isfinite(warm + proto).all():
        raise AssertionError(f"NCL: non-finite losses {warm + proto}")


def time_spmm(device, data, d=D, reps=10, seed=0) -> dict:
    """One apply of the symmetric SpMM at the data's shape beside the forms
    it replaced, its yardstick and its byte bound (``timing.time_spmm``),
    logged."""
    out = timing.time_spmm(device, data.norm_adj, d, reps, seed)
    n, k, t, err, scale = (out[key] for key in ("n", "k", "tail",
                                                "max_abs_err", "scale"))
    log(f"  SpMM {n} nodes x d={d}, K={k}, tail {t} edges: apply "
        f"{out['apply_ms']:.3f} ms, forward + backward "
        f"{out['fwd_bwd_ms']:.3f} ms; ELL part (embedding_bag) "
        f"{out['ell_ms']:.3f} ms, gather + bmm {out['ell_gather_ms']:.3f} ms"
        f" (bound {out['ell_bound_ms']:.3f}); tail (index_add_) "
        f"{out['tail_ms']:.3f} ms, segment_reduce "
        f"{out['tail_segment_ms']:.3f} ms (bound {out['tail_bound_ms']:.4f})"
        f"; bound of the apply {out['bound_ms']:.3f} ms (bytes, 3.35 TB/s; "
        f"each byte once: {out['once_bound_ms']:.4f} ms); "
        f"torch.sparse.mm (CSR) {out['library_ms']:.3f} ms; max abs err vs "
        f"it {err:.3e} (scale {scale:.3e}); the apply repeatable bit for "
        f"bit: {out['repeatable']}")
    return out


def graph_run(device, root, ds="bx_synth", runs=GRAPH_RUNS, d=D, bs=4096,
              topN=(10, 20), seed=0, steps=STEP_CHECK,
              epoch_steps=EPOCH_STEPS):
    """Phase graph: the graph backbones through the CLI on phase train's
    split (item cold), each checked by ``graph_cli``; the fp32 product
    check; NCL's e-step and proto steps; the SpMM timed alone and its
    share of a LightGCN step. Returns {model: launches} and the SpMM
    times."""
    device = torch.device(device)
    t = time.perf_counter()
    data = read_split(root, ds)
    stats = graph_stats(data)
    log(f"  split dir read, graph built ({time.perf_counter() - t:.2f} s): "
        f"{stats}")
    log(f"  fp32 products, TF32 off: rel err "
        f"{check_fp32_matmul(device, d=d):.3e}")
    per_model = {}
    for model, epochs, flags in runs:
        per_model[model] = graph_cli(device, root, ds, model, epochs, flags,
                                     data, d, bs, seed, topN,
                                     epoch_steps=epoch_steps)
    ncl_proto(device, data, d, bs, seed, steps)
    sp = time_spmm(device, data, d)
    epochs = per_model["LightGCN"]["epochs"] if "LightGCN" in per_model \
        else []
    if epochs:
        step_ms = min(e["step_device_s"] / e["batches"] for e in epochs) * 1e3
        # a LightGCN step applies A twice forward and twice backward
        share = 2 * sp["fwd_bwd_ms"] / step_ms
        sp["lightgcn_step_ms"] = step_ms
        sp["share_of_lightgcn_step"] = share
        log(f"  LightGCN device step {step_ms:.3f} ms (fastest epoch); its "
            f"SpMM (2 x forward + backward) {2 * sp['fwd_bwd_ms']:.3f} ms = "
            f"{100 * share:.1f}%")
    return {m: r["launches"] for m, r in per_model.items()}, sp


def graph_user_run(device, root, n_users, n_items, n_inter,
                   content_dim=BX_USER_CONTENT, d=D, bs=4096, seed=0,
                   topN=(10, 20), epoch_steps=EPOCH_STEPS):
    """Phase graph-user (BASELINE config 5): a user-cold split of phase
    train's interactions with ``content_dim`` N(0,1) user-content columns;
    XSimGCL through the CLI, then Heater on its bus (``--backbone
    XSimGCL``), each split on the JAX package's route. Returns {model:
    launches}."""
    device = torch.device(device)
    t = time.perf_counter()
    pairs = synthetic_interactions(n_users, n_items, n_inter, seed=seed)
    write_split(root, "bx_user", pairs, seed, content_dim,
                cold_object="user")
    data = ColdStartDataset.from_split_dir(root, "bx_user", "user")
    log(f"  user-cold split written and read ({time.perf_counter() - t:.2f} "
        f"s): {data.user_num} users x {data.item_num} items, user content "
        f"{data.user_content.shape[1]} columns, graph {graph_stats(data)}")
    expected = expected_routes(data, "user", bs, max(topN), device)
    out = {}
    for model, flags in (("XSimGCL", ("--layers", "2")),
                         ("Heater", ("--backbone", "XSimGCL"))):
        out[model] = graph_cli(device, root, "bx_user", model, 1, flags,
                               data, d, bs, seed, topN, cold_object="user",
                               expected=expected,
                               epoch_steps=epoch_steps)["launches"]
    return out


def _tables_gap(got: dict, ref: dict):
    """(max abs err, elements beyond STEP_ATOL, elements) between the named
    tensors ``got`` and ``ref``."""
    worst, over, numel = 0.0, 0, 0
    for name, p in got.items():
        diff = (p.detach().cpu() - ref[name].detach().cpu()).abs()
        worst = max(worst, float(diff.max()))
        over += int((diff > STEP_ATOL).sum())
        numel += diff.numel()
    return worst, over, numel


@contextlib.contextmanager
def perturb_signs(active=True):
    """Yields a list that gets sign(e) (int8, on the host) of every
    perturbed layer of the SimGCL and XSimGCL forwards run inside the block
    on this thread (on a mesh graph the rank's node block): their noise is
    sign(e) * U * eps, so where two runs' sums of an element fall on either
    side of 0 their forwards part by up to 2 * eps * U there."""
    signs = []
    perturb = simgcl_mod.perturb
    owner = threading.get_ident()

    def recording(ego, eps, noise):
        if threading.get_ident() == owner:
            signs.append(torch.sign(ego.detach()).to(torch.int8).cpu())
        return perturb(ego, eps, noise)

    if active:
        simgcl_mod.perturb = recording
    try:
        yield signs
    finally:
        simgcl_mod.perturb = perturb


def graph_step_parity(device, data, model, d=D, bs=4096, steps=STEP_CHECK,
                      seed=0, synced=False, on_done=None):
    """``steps`` steps of a graph model on ``device`` and on the CPU (on
    ``CHECKS``' worker) from the same tables and batches (SimGCL: the same
    noise, drawn on the host and injected into both). At the finish
    ``on_done`` gets {"free": (loss max rel err, tables max abs err,
    elements beyond STEP_ATOL, elements)} after the free-running steps,
    "card_s", "cpu_s" and, with ``synced``, "synced": the same of a third
    trainer on ``device`` that starts every step from the CPU trainer's
    weights and Adam state (recorded by the worker; the loss over the steps
    without a sign flip, the tables after each step), and "flips": [(step,
    flipped elements, loss rel err)] of the steps in which the two
    forwards took another sign somewhere (``perturb_signs``).

    SimGCL's noise takes the sign of each propagated element, so its loss
    jumps where an element's two sums fall on either side of 0: from one
    state that happens in some steps, and once two free runs are ~1e-7
    apart in every step, which parts them whatever the summation orders."""
    init = GraphTables(data.user_num, data.item_num, d, seed=seed,
                       device="cpu")
    params = {k: v.detach().numpy() for k, v in init.named_parameters()}
    devs = [device, torch.device("cpu")] + ([device] if synced else [])
    card, cpu, *held = [TRAINERS[model](Config(default_args(
        model=model, emb_size=d, bs=bs, seed=seed, save_emb=False,
        device=str(dev)), data), init_params=params) for dev in devs]
    batches = list(itertools.islice(pairwise_batches(
        data, bs, np.random.default_rng(seed)), steps))
    rng = np.random.default_rng(seed + 7)
    shape = (2, card.n_layers, data.user_num + data.item_num, d)
    noises = [{"noise_pair": rng.random(shape, dtype=np.float32)}
              if model == "SimGCL" else {} for _ in batches]

    def step(t, i):
        k = {n: tuple(torch.as_tensor(x, device=t.device) for x in v)
             for n, v in noises[i].items()}
        return float(t.train_step(t.upload(batches[i]), **k))

    t0 = time.perf_counter()
    card_losses = [step(card, i) for i in range(len(batches))]
    card_params = _params(card.model)
    card_s = time.perf_counter() - t0
    del card

    def cpu_side():
        losses, states, signs = [], [], []
        for i in range(len(batches)):
            if synced:
                states.append(snapshot(cpu))
            with perturb_signs(synced) as rec:
                losses.append(step(cpu, i))
            signs.append(rec)
        if synced:
            states.append(snapshot(cpu))
        return losses, _params(cpu.model), states, signs

    def finish(out, cpu_s):
        cpu_losses, final, states, cpu_signs = out
        a, b = np.asarray(card_losses), np.asarray(cpu_losses)
        res = {"free": (float(np.max(np.abs(a - b) / np.abs(b))),
                        *_tables_gap(card_params, final)),
               "card_s": card_s, "cpu_s": cpu_s}
        if synced:
            t1 = time.perf_counter()
            synced_err, synced_gap, flip_steps = 0.0, (0.0, 0, 0), []
            for i in range(len(batches)):
                for t in held:
                    load_state(t, states[i])
                    with perturb_signs() as rec:
                        loss = step(t, i)
                    flips = sum(int((x != y).sum())
                                for x, y in zip(cpu_signs[i], rec))
                    err = abs(loss - cpu_losses[i]) / abs(cpu_losses[i])
                    if flips:
                        flip_steps.append((i, flips, err))
                    else:
                        synced_err = max(synced_err, err)
                    gap = _tables_gap(dict(t.model.named_parameters()),
                                      states[i + 1][0])
                    synced_gap = (max(synced_gap[0], gap[0]),
                                  max(synced_gap[1], gap[1]), gap[2])
            res["synced"] = (synced_err, *synced_gap)
            res["flips"] = flip_steps
            res["card_s"] += time.perf_counter() - t1
        on_done(res)

    CHECKS.submit(f"{model} graph steps", cpu_side, finish)


def graph_ml_run(device, root, ds="ml_latent", epochs=1, d=D, bs=4096,
                 seed=0, topN=(10, 20), steps=STEP_CHECK):
    """Phase graph-ml (BASELINE config 2): LightGCN on phase cold-signal's
    latent split at MovieLens-1M shape for ``epochs`` epochs through the
    CLI, each split on the JAX package's route; then ``steps`` LightGCN and
    SimGCL steps on the card against the CPU: LightGCN's free runs held;
    SimGCL held step by step from the CPU's state, the loss on the steps
    in which no element's sign flips (at least half of them), its free
    runs and the steps with flips logged (``graph_step_parity``). Returns
    {model: launches}."""
    device = torch.device(device)
    data = read_split(root, ds)
    log(f"  graph {graph_stats(data)}")
    expected = expected_routes(data, "item", bs, max(topN), device)
    out = {"LightGCN": graph_cli(device, root, ds, "LightGCN", epochs,
                                 ("--layers", "2"), data, d, bs, seed, topN,
                                 expected=expected)["launches"]}
    for model in ("LightGCN", "SimGCL"):
        synced = model in SYNCED_STEPS

        def done(res, model=model, synced=synced):
            flips = res.pop("flips", [])
            card_s, cpu_s = res.pop("card_s"), res.pop("cpu_s")
            text = {how: f"loss max rel err {e:.3e}, tables max abs err "
                         f"{worst:.3e}, {over} of {numel} elements beyond "
                         f"{STEP_ATOL}"
                    for how, (e, worst, over, numel) in res.items()}
            log(f"  {model}: {steps} steps {device.type} vs cpu "
                f"({device.type} side {card_s:.2f} s, cpu side "
                f"{cpu_s:.2f} s): free-running {text['free']}"
                + (f"; each step from the CPU's state: {steps - len(flips)}"
                   f" steps without a sign flip, {text['synced']} (tables "
                   f"after one step); steps with flips (step, elements, "
                   f"loss rel err) "
                   f"{[(i, n, float(f'{e:.3e}')) for i, n, e in flips]}"
                   if synced else ""))
            loss_err, worst, over, numel = res["synced" if synced
                                               else "free"]
            limit = STEP_MAX_ERR / steps if synced else STEP_MAX_ERR
            if not (loss_err <= STEP_LOSS_RTOL and worst <= limit
                    and over <= STEP_FLIPS * numel
                    and 2 * len(flips) <= steps):
                raise AssertionError(f"{model}: the card's steps disagree "
                                     "with the CPU's")

        graph_step_parity(device, data, model, d, bs, steps, seed,
                          synced=synced, on_done=done)
    return out


def time_merge(device, n_users=SERVE_USERS, n_items=BX[1], d=D, seed=0,
               reps=20, parts=None, graph_reps=100):
    """The merge at one shape, on the plain per-part sweeps of N(0,1)
    tables at the kernel's part count for this batch (at least 2) or at
    ``parts``: its device time ("ms": ``graph_reps`` launches in one CUDA
    graph), its time per call as the main path pays it ("call_ms": CUDA
    events around ``reps`` calls in a row, the host's checks, allocations
    and ctypes call included), its plain version's, the library
    yardstick's (``torch.topk`` of 8 over each class's parts x 8 values
    plus ``amax`` of the ghosts, in one graph as the kernel: no ids and no
    tie order, so less work) and the bound (bytes: every part read once,
    the result written once)."""
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    users = torch.as_tensor(
        rng.standard_normal((n_users, d), dtype=np.float32), device=device)
    items = torch.as_tensor(
        rng.standard_normal((n_items, d), dtype=np.float32), device=device)
    items_t, excl_row = pad_items(items, torch.zeros(n_items, dtype=torch.bool,
                                                     device=device))
    if parts is None:
        parts = max(2, sweep_parts_on(device, n_users, d, items_t.shape[1]))
    pv, pi, pg = sweep_parts_reference(users, items_t, excl_row, parts)
    ms = erk.graph_ms(lambda: merge_parts(pv, pi, pg), graph_reps, device)
    call_ms = time_ms(lambda: merge_parts(pv, pi, pg), reps, device,
                          repeats=1)
    plain_ms = time_ms(lambda: merge_parts_reference(pv, pi, pg), 3,
                           device, repeats=1)
    per_class = pv.view(parts, n_users, SLOTS, LANES).permute(
        1, 3, 0, 2).reshape(n_users, LANES, parts * SLOTS)
    lib_ms = erk.graph_ms(
        lambda: (torch.topk(per_class, SLOTS, dim=2), pg.amax(0)),
        graph_reps, device)
    row_bytes = CANDIDATES * 8 + LANES * 4
    bound, by = sweep_bound(0.0, (parts + 1) * n_users * row_bytes)
    log(f"  merge_parts {n_users} users x {parts} parts: kernel {ms:.4f} ms "
        f"device ({graph_reps} in a graph), {call_ms:.4f} ms per call "
        f"({reps} calls in a row); plain {plain_ms:.3f} ms; library "
        f"(topk(8) + amax) {lib_ms:.4f} ms; bound {bound:.4f} ms ({by})")
    return {"ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound, "bound_by": by,
            "parts": parts}


# ----------------------------------------------------- the variant kernels
def int_tables(device, n_users, n_items, d, seed, block_i=None,
               nan_items=0):
    """Integer tables in [-INT_MAX, INT_MAX] on ``device`` with 20% of the
    items excluded: (users, items (I, d), items_t (d, I), excl). With
    ``block_i``: users in [1, INT_MAX] and the items of block j scaled by
    n_blocks - j, so that later blocks are dominated and skips fire (scores
    stay below 2^24, so every sum is still exact). With ``nan_items``: the
    ``NAN_ROWS`` (not excluded) and that many random item rows are NaN (an
    excluded one scores NEG)."""
    rng = np.random.default_rng(seed)
    users = rng.integers(1 if block_i else -INT_MAX, INT_MAX + 1,
                         (n_users, d)).astype(np.float32)
    items = rng.integers(-INT_MAX, INT_MAX + 1,
                         (n_items, d)).astype(np.float32)
    if block_i:
        items *= np.repeat(np.arange(n_items // block_i, 0, -1),
                           block_i).astype(np.float32)[:, None]
    excl = (rng.random(n_items) < 0.2).astype(np.int8)
    if nan_items:
        items[rng.choice(n_items, nan_items, replace=False)] = np.nan
        items[list(NAN_ROWS)] = np.nan
        excl[list(NAN_ROWS)] = 0
    users, items, excl = (torch.as_tensor(a, device=device)
                          for a in (users, items, excl))
    return users, items, items.T.contiguous(), excl


def skip_plain(users, items_t, excl, tile_u, block_i, floor_slot):
    """The skip kernel's plain version on users zero-padded to the tile, as
    ``skip_sweep`` pads them, with the pad rows' outputs dropped."""
    b = users.shape[0]
    pad = users.new_zeros((-(-b // tile_u) * tile_u, users.shape[1]))
    pad[:b] = users
    ref = ebs.skip_sweep_reference(pad, items_t, excl, tile_u, block_i,
                                   floor_slot)
    return tuple(r[:b] for r in ref[:3]) + (ref[3],)


def skip_pair(users, items_t, excl, tile_u, block_i, floor_slot):
    """The skip kernel's outputs and its plain version's."""
    args = (users, items_t, excl, tile_u, block_i, floor_slot)
    return ebs.skip_sweep(*args), skip_plain(*args)


def variants_run(device, n_users=2048, n_items=VAR_ITEMS, d=D,
                 blocks=VAR_BLOCKS, tiles=VAR_TILES, check_users=1024,
                 check_items=24_576, iters=2, seed=0):
    """Phase 5: the experiment path (launches counted), then every variant
    kernel against its plain version. Returns {kernel: {"launches": n,
    "max_abs_err": x}} for the four variant kernels."""
    device = torch.device(device)
    small, big = blocks

    # the experiment path, through the tools' entry points
    rng = np.random.default_rng(seed)
    ue, ie = ebs.make_tables("skew_sorted", check_users, check_items, rng)
    rat = np.full((check_users, ebs.MAX_RATED), check_items, np.int32)
    for u in range(check_users):
        n = rng.integers(ebs.MAX_RATED // 4, ebs.MAX_RATED)
        rat[u, :n] = rng.choice(check_items, n, replace=False)
    reset_launches()
    t = time.perf_counter()
    erk.main(["--users", str(n_users), "--items", str(n_items), "--dim",
              str(d), "--iters", str(iters), "--block_i", str(small),
              "--device", str(device)])
    ema.check(check_users, check_items, tiles[-1], small, device=device)
    stats = ebs.check_exact(ue, ie, rat, tiles[0], big, 0, device)
    _sync(device)
    launches = launch_counts()
    log(f"  experiment path {time.perf_counter() - t:.2f} s, launches "
        f"{launches}; blockskip check (skew_sorted, tile_u {tiles[0]}, "
        f"rv[0]) {stats}")
    if device.type == "cuda":
        missing = [k for k in VARIANTS if launches[k] <= 0]
        if missing:
            raise AssertionError(f"the experiment path launched no {missing}")

    # every kernel bit-equal to its plain version on integer tables
    errs = dict.fromkeys(VARIANTS, 0.0)

    def hold(name, label, got, ref):
        errs[name] = max(errs[name], hold_equal(f"{name} {label}", got, ref))
        log(f"  {name} {label}: bit-equal to its plain version")

    t = time.perf_counter()
    users, items, items_t, excl = int_tables(device, n_users, n_items, d,
                                             seed)
    for transposed, tab in ((False, items), (True, items_t)):
        hold("dot_sweep", f"transposed={transposed}",
             [erk.dot_sweep(users, tab, transposed)],
             [erk.dot_sweep_reference(users, tab, transposed)])
    refs = {}
    for bi in blocks:
        refs[bi] = erk.stream_sweep_reference(users, items_t, excl, bi)
        hold("stream_sweep", f"block_i={bi}",
             erk.stream_sweep(users, items_t, excl, bi), refs[bi])
    for p in ema.P_ACC:
        hold("multiacc_sweep", f"P={p} block_i={big}",
             ema.multiacc_sweep(users, items_t, excl, big, p),
             ema.multiacc_sweep_reference(users, items_t, excl, big, p))
    for tile_u in tiles:
        for floor_slot in (0, SLOTS - 1):
            got, ref = skip_pair(users, items_t, excl, tile_u, big,
                                 floor_slot)
            hold("skip_sweep", f"tile_u={tile_u} floor=rv[{floor_slot}] "
                 f"skips {int(got[3].sum())}", got, ref)
    users, _, items_t, excl = int_tables(device, n_users, n_items, d,
                                         seed + 1, block_i=big)
    for tile_u in tiles:
        got, ref = skip_pair(users, items_t, excl, tile_u, big, 0)
        fired = int(got[3].sum())
        hold("skip_sweep", f"falling table tile_u={tile_u} floor=rv[0] "
             f"skips {fired}", got, ref)
        if fired <= 0:
            raise AssertionError(f"tile_u={tile_u}: no block was skipped on "
                                 "the falling table")

    # the NaN table: each variant keeps NaN as its own JAX tool does
    users, items, items_t, excl = int_tables(device, n_users, n_items, d,
                                             seed + 2, nan_items=40)
    for transposed, tab in ((False, items), (True, items_t)):
        hold("dot_sweep", f"NaN table transposed={transposed}",
             [erk.dot_sweep(users, tab, transposed)],
             [erk.dot_sweep_reference(users, tab, transposed)])
    nan_refs = {}
    for bi in blocks:
        ref = erk.stream_sweep_reference(users, items_t, excl, bi)
        if not bool(ref[2].isnan().any()):
            raise AssertionError("the NaN table gives no NaN ghost")
        nan_refs[bi] = ref
        hold("stream_sweep", f"NaN table block_i={bi} "
             f"({int(ref[2].isnan().sum())} NaN ghosts)",
             erk.stream_sweep(users, items_t, excl, bi), ref)
    for bi in (big, ODD_BLOCK):
        for p in ema.P_ACC:
            if bi == ODD_BLOCK and p == 1:
                continue  # one chain: no block-relative index to get wrong
            ref = ema.multiacc_sweep_reference(users, items_t, excl, bi, p)
            as_stream = bi in nan_refs and all(map(same, ref, nan_refs[bi]))
            hold("multiacc_sweep", f"NaN table P={p} block_i={bi} (equals "
                 f"stream's: {as_stream})",
                 ema.multiacc_sweep(users, items_t, excl, bi, p), ref)
    for tile_u in tiles:
        got, ref = skip_pair(users, items_t, excl, tile_u, big, 0)
        hold("skip_sweep", f"NaN table tile_u={tile_u} floor=rv[0] "
             f"skips {int(got[3].sum())}", got, ref)
    _sync(device)
    log(f"  kernel vs plain {time.perf_counter() - t:.2f} s")
    return {k: {"launches": launches[k], "max_abs_err": errs[k]}
            for k in VARIANTS}


def kernel_registers(ptxas: str) -> None:
    """Log registers / spill-store bytes of every instance of each kernel
    from the build's ``nvcc -Xptxas -v`` report (empty when the library
    was already built)."""
    if not ptxas:
        log("  registers: not reported (library already built)")
        return
    # stream and multiacc are instances of one template, told apart by
    # their chain
    for name, kernel in (
            ("fused_sweep", "fused_sweep_kernelILi"),
            ("fused_sweep_bf16", BF16_KERNEL),
            ("merge_parts", "merge_parts_kernel"),
            ("dot_sweep", "dot_sweep_kernel"),
            ("stream_sweep", r"chain_sweep_kernel\w*StreamChain"),
            ("multiacc_sweep", r"chain_sweep_kernel\w*MaxChain"),
            ("skip_sweep", "skip_sweep_kernel")):
        log(f"  registers/spill bytes {name}: "
            f"{tile_shapes.registers(ptxas, kernel)}")


def tensor_cores(path):
    """Phase sass: HMMA/HGMMA instructions per instance of the bf16 sweep
    in the library's SASS (only its functions are disassembled); raises
    where an instance has none. Returns their sum, or None without
    cuobjdump."""
    counts = kbuild.sass_mma_counts(path, BF16_KERNEL)
    if counts is None:
        log("  cuobjdump not found: the bf16 sweep's time against the FMA "
            "bound stands in (phase timing)")
        return None
    for name, n in counts.items():
        log(f"  {n} HMMA/HGMMA in {name}")
    if not counts or min(counts.values()) == 0:
        raise AssertionError(f"the bf16 sweep has no tensor-core "
                             f"instruction: {counts}")
    return sum(counts.values())


def time_variants(device, n_users=2048, n_items=VAR_ITEMS, d=D, k=K,
                  r=RATED_WIDTH, blocks=VAR_BLOCKS, tiles=VAR_TILES,
                  p_row=4, reps=10, seed=0, ptxas=""):
    """Phase 6 for the variants: per kernel, ms per sweep (CUDA events;
    the host clock on the CPU), its plain version's, a library yardstick's
    and the bound, on N(0,1) tables with 20% of the items excluded. Before
    the rows: every P and tile_u time, the skip kernel's resident clusters
    per layout, and each kernel's registers and spills."""
    device = torch.device(device)
    kernel_registers(ptxas)
    if device.type == "cuda":
        log(f"  SM clock, power draw before: {smi_line(CLOCKS)}")
        for tile_u in tiles:
            lay = ebs.skip_layout(tile_u, n_users)
            n = ebs.max_active_clusters(device, d, tile_u, n_users)
            log(f"  skip_sweep layout tile_u={tile_u} {lay}: {n} clusters "
                "resident at once")
    small, big = blocks
    rng = np.random.default_rng(seed)
    users = torch.as_tensor(
        rng.standard_normal((n_users, d), dtype=np.float32), device=device)
    items = torch.as_tensor(
        rng.standard_normal((n_items, d), dtype=np.float32), device=device)
    items_t = items.T.contiguous()
    excl = torch.as_tensor((rng.random(n_items) < 0.2).astype(np.int8),
                           device=device)

    def ms(fn, n=reps, repeats=3):
        return time_ms(fn, n, device, repeats=repeats)

    flops = 2.0 * n_users * n_items * d
    tables = n_users * d * 4 + n_items * d * 4
    cands = n_items + n_users * (CANDIDATES * 8 + LANES * 4)
    topk_ms = ms(lambda: torch.topk(exact_scores(users, items), k + r,
                                    dim=1), 3)
    rows = {}

    def row(name, kernel_ms, plain_ms, library_ms, bytes_moved, note):
        bound, by = sweep_bound(flops, bytes_moved)
        rows[name] = {"ms": kernel_ms, "plain_ms": plain_ms,
                      "library_ms": library_ms, "bound_ms": bound,
                      "bound_by": by}
        log(f"  {name} {n_users} x {n_items} d={d} {note}: kernel "
            f"{kernel_ms:.3f} ms, plain {plain_ms:.3f} ms, library "
            f"{library_ms:.3f} ms, bound {bound:.3f} ms ({by})")

    dot_ms = {tr: ms(lambda: erk.dot_sweep(users, tab, tr))
              for tr, tab in ((False, items), (True, items_t))}
    log(f"  dot_sweep items (I, d): {dot_ms[False]:.3f} ms")
    row("dot_sweep", dot_ms[True],
        ms(lambda: erk.dot_sweep_reference(users, items_t, True), 3),
        ms(lambda: exact_scores(users, items).view(
            n_users, -1, LANES).amax(1), 3),
        tables + n_users * LANES * 4,
        "items (d, I); library = matmul + amax (the same function)")
    stream = {}
    for bi in blocks:
        stream[bi] = ms(lambda: erk.stream_sweep(users, items_t, excl, bi))
        log(f"  stream_sweep block_i={bi}: {stream[bi]:.3f} ms")
    row("stream_sweep", stream[small],
        ms(lambda: erk.stream_sweep_reference(users, items_t, excl, small),
           1, 1),
        topk_ms, tables + cands,
        f"block_i={small}; library = matmul + topk({k + r}), less work")
    multi = {}
    for p in ema.P_ACC:
        multi[p] = ms(lambda: ema.multiacc_sweep(users, items_t, excl, big, p))
        log(f"  multiacc_sweep P={p} block_i={big}: {multi[p]:.3f} ms")
    row("multiacc_sweep", multi[p_row],
        ms(lambda: ema.multiacc_sweep_reference(users, items_t, excl, big,
                                                p_row), 1, 1),
        topk_ms, tables + cands,
        f"P={p_row} block_i={big}; library = matmul + topk({k + r}), less "
        "work")
    skip = {}
    for tile_u in tiles:
        skip[tile_u] = ms(lambda: ebs.skip_sweep(users, items_t, excl, tile_u,
                                                 big, 0), 2)
        log(f"  skip_sweep tile_u={tile_u} floor=rv[0] block_i={big}: "
            f"{skip[tile_u]:.3f} ms")
    tile_u = tiles[-1]
    row("skip_sweep", skip[tile_u],
        ms(lambda: skip_plain(users, items_t, excl, tile_u, big, 0), 1, 1),
        topk_ms, tables + cands + n_users // tile_u * 4,
        f"tile_u={tile_u} floor=rv[0] block_i={big}; library = matmul + "
        f"topk({k + r}), less work")
    if device.type == "cuda":
        log(f"  SM clock, power draw after: {smi_line(CLOCKS)}")
    return rows


# ------------------------------------- the bench entry and the CLI flags
def bench_run(device, shape=None, timeout=900):
    """Phase bench: the bench entry (``python -m coldrec_tpu_torch.bench``)
    in a subprocess, at full shape unless ``shape`` (users, items); its
    one JSON line parsed and logged, every figure finite and positive, its
    ``device_kind`` this card's. Then in this process, at each of the
    bench's sweep shapes, the kernel's lists (``retrieval_topk``) held to
    the plain route's by the rule of ``compare_lists``. Returns the line
    and the launches of both processes (the bench's from its line)."""
    device = torch.device(device)
    cmd = [sys.executable, "-m", "coldrec_tpu_torch.bench", "--device",
           device.type]
    if shape:
        cmd += ["--users", str(shape[0]), "--items", str(shape[1])]
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, check=False,
                          cwd=REPO_DIR)
    if proc.returncode != 0:
        raise AssertionError(f"the bench entry exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    lines = proc.stdout.strip().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"the bench printed {len(lines)} lines")
    line = json.loads(lines[0])
    log(f"  bench ({time.perf_counter() - t:.2f} s): {lines[0]}")
    cuda = device.type == "cuda"
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    count = torch.cuda.device_count() if cuda else 0
    if (line["device_kind"], line["device_count"]) != (kind, count):
        raise AssertionError(f"bench device {line['device_kind']!r} x "
                             f"{line['device_count']}, here {kind!r} x "
                             f"{count}")
    figures = {k: v for k, v in line.items() if k != "device_count"
               and isinstance(v, (int, float)) and not isinstance(v, bool)}
    bad = {k: v for k, v in figures.items()
           if not (np.isfinite(v) and v > 0)}
    missing = [k for k, v in line.items() if v is None] if cuda else []
    if bad or missing:
        raise AssertionError(f"bench figures not finite and positive: "
                             f"{bad}, not measured: {missing}")
    reset_launches()
    for problem in (tbench._make_problem(*(shape or (tbench.BC_USERS,
                                                     tbench.BC_ITEMS))),
                    tbench._make_problem(*(shape or (tbench.ML_USERS,
                                                     tbench.ML_ITEMS)),
                                         seed=1)):
        ue, ie, rated, excl = (torch.as_tensor(a, device=device)
                               for a in problem)
        _, ids = retrieval_topk(ue, ie, rated, excl, tbench.TOP_K,
                                device=device)
        ref = np.concatenate([ret._exact_rows(
            ue[s:s + 1024], ie, rated[s:s + 1024].long(), excl,
            tbench.TOP_K)[1] for s in range(0, ue.shape[0], 1024)])
        rows, equal = compare_lists(ue, ie, np.arange(ue.shape[0]), ids, ref)
        log(f"  {ue.shape[0]} x {ie.shape[0]}: kernel lists id-equal to the "
            f"plain route on {equal}/{rows} rows (others near-ties)")
    here = launch_counts()
    launches = {k: here[k] + line["kernel_launches"][k]
                for k in ("fused_sweep", "fused_sweep_bf16", "merge_parts")}
    log(f"  launches: bench process {line['kernel_launches']}, lists "
        f"{ {k: here[k] for k in launches} }")
    if cuda and not (launches["fused_sweep"] and launches["fused_sweep_bf16"]):
        raise AssertionError(f"the bench left a sweep unlaunched: {launches}")
    return line, launches


def mfstep_phase(device, root, shape=SCALE_SHAPE, built=None, read=None,
                 mf=None, scatter=None, k=MFSTEP_K, iters=MFSTEP_ITERS,
                 flags=()):
    """Phase mfstep: the MF step tools at the JAX tools' problems (``mf``
    and ``scatter``: keyword sizes for a smaller one), launch counts
    zeroed just before and read just after: ``profile_train``'s split
    (full step, sorted lookup, grad, Adam, forward; the gradient A/B),
    its chain (64, 32, 64, 32 stacked steps, 5 reps each) and its scatter
    variants (each held to ``np.add.at``, max error below 1e-3, inside the
    tool); then ``exp_fused_steps`` for LightGCN at ``shape`` on phase
    scale's workdir under ``root`` (``built``, ``read``: phase scale's
    futures of the dataset and its split; ``flags``: CLI flags of the
    trainer), K ``k``: the sequential steps and the ``--fused_steps K``
    path held to the JAX tool's limits, then timed (best of ``iters``).
    Every time must be finite. Returns the launches."""
    device = torch.device(device)
    mf = dict(mf or {})
    reset_launches()
    split = profile_train.split(device, **mf)
    chain = profile_train.chain(device, **mf)
    scat = profile_train.scatter(device, **(scatter or {}))
    stats = built.result() if built is not None else scale_build(root, shape)
    data = read.result() if read is not None else scale_split(root, shape)
    tm = efs.build_trainer("LightGCN", shape,
                           os.path.join(root, f"{shape}_workdir"), device,
                           data=data, flags=flags)
    fused = efs.run(tm, k, iters)
    here = launch_counts()
    launches = {name: here[name] for name in ("fused_sweep",
                                              "fused_sweep_bf16",
                                              "merge_parts")}
    times = [*split.values(), *(t for ts in chain.values() for t in ts),
             *(v["ms"] for v in scat.values()), fused["sequential_ms"],
             fused["fused_ms"]]
    if not all(np.isfinite(t) for t in times):
        raise AssertionError(f"mfstep: times not finite {times}")
    log(f"  mfstep [{timing.device_name(device)}]: split (ms a step) "
        + ", ".join(f"{name} {v:.4f}" for name, v in split.items())
        + "; chain (ms a run, sorted) "
        + "; ".join(f"{n}: {[round(t, 2) for t in ts]}"
                    for n, ts in chain.items())
        + "; scatter (ms, max|err|) "
        + ", ".join(f"{name} {v['ms']:.4f} {v['max_abs_err']:.2e}"
                    for name, v in scat.items())
        + f"; fused steps LightGCN {shape} (dataset "
        f"{'already built' if stats is None else 'built'}) {fused}; "
        f"launches {launches}")
    return launches


def ml_split(root, ds="ml_synth", n_users=ML[0], n_items=ML[1],
             n_inter=ML[2], seed=0):
    """A split of ``synthetic_interactions`` at MovieLens-1M shape under
    ``root/ds``: no user is rated beyond the kernel's candidates (unlike
    the latent split of phase cold-signal), so every split sweeps through
    the kernel."""
    t = time.perf_counter()
    res = write_split(root, ds, synthetic_interactions(
        n_users, n_items, n_inter, seed=seed), seed, 1)
    log(f"  split {ds} written ({time.perf_counter() - t:.2f} s): max train "
        f"degree {np.bincount(res.warm_train[:, 0]).max()}")
    return ColdStartDataset.from_split_dir(root, ds, "item")


def trace_kernels(path):
    """({kernel name: device microseconds}, the trace) of a Chrome
    trace."""
    with open(path) as f:
        trace = json.load(f)
    out = {}
    for ev in trace.get("traceEvents", []):
        if ev.get("cat") == "kernel":
            out[ev["name"]] = out.get(ev["name"], 0.0) + float(ev["dur"])
    return out, trace


def profile_run(device, root, ds="ml_synth", d=D, bs=4096, seed=0, top=10,
                epoch_steps=EPOCH_STEPS):
    """Phase profile: MF for one epoch (its first ``epoch_steps`` batches)
    through the CLI on phase ``ml_split``'s split, plain, then with
    ``--profile DIR`` and with ``--debug_nans``.
    The trace must exist, load as JSON, hold CPU ops and (on the card)
    name ``fused_sweep_kernel`` among its device kernels: the ctypes-loaded
    library's launches seen by the profiler. Logs the top ``top`` kernels
    by device time and each run's seconds per epoch. Returns the launches
    of the three runs."""
    device = torch.device(device)
    pdir = os.path.join(root, "profile")
    launches = dict.fromkeys(("fused_sweep", "fused_sweep_bf16",
                              "merge_parts"), 0)
    per_epoch = {}
    for tag, flags in (("plain", ()), ("profile", ("--profile", pdir)),
                       ("debug_nans", ("--debug_nans", "true"))):
        payload, got, evs, secs = cli_run(
            device, root, ds, "MF", 1, flags, d, bs, seed,
            tag=f"MF_{tag}", epoch_steps=epoch_steps)
        for k in launches:
            launches[k] += got[k]
        log_epochs(evs)
        per_epoch[tag] = payload["efficiency"][
            "seconds_per_completed_epoch_mean"]
        log(f"  MF {tag}: {secs:.2f} s (CLI), {per_epoch[tag]:.3f} s per "
            f"epoch, launches { {k: v for k, v in got.items() if v} }")
    traces = sorted(f for f in os.listdir(pdir) if f.endswith(".json"))
    if len(traces) != 1:
        raise AssertionError(f"{pdir} holds {traces}, one trace expected")
    path = os.path.join(pdir, traces[0])
    kernels, trace = trace_kernels(path)
    cpu_ops = sum(ev.get("cat") == "cpu_op"
                  for ev in trace.get("traceEvents", []))
    total = sum(kernels.values())
    log(f"  trace {traces[0]}: {os.path.getsize(path) / 2**20:.1f} MiB, "
        f"{cpu_ops} CPU ops, {len(kernels)} kernels, {total / 1e3:.3f} ms "
        f"of device time; top {top} by device time:")
    for name, us in sorted(kernels.items(), key=lambda kv: -kv[1])[:top]:
        log(f"    {us / 1e3:9.3f} ms {100 * us / max(total, 1e-9):5.1f}%  "
            f"{name[:110]}")
    sweeps = [n for n in kernels if "fused_sweep_kernel" in n]
    if not cpu_ops or device.type == "cuda" and not sweeps:
        raise AssertionError(f"the trace shows {cpu_ops} CPU ops and no "
                             f"fused_sweep_kernel among {sorted(kernels)[:20]}")
    log(f"  seconds per epoch: plain {per_epoch['plain']:.3f}, --profile "
        f"{per_epoch['profile']:.3f}, --debug_nans "
        f"{per_epoch['debug_nans']:.3f}; fused_sweep_kernel in the trace: "
        f"{[kernels[n] / 1e3 for n in sweeps]} ms")
    return launches


def fused_run(device, root, data, ds="ml_synth", k=8, epochs=1, d=D,
              bs=4096, seed=0, topN=(10, 20),
              runs=(("MF", ()), ("XSimGCL", ("--layers", "2")))):
    """Phase fused: each model for ``epochs`` epochs through the CLI with
    ``--fused_steps k`` and with ``--fused_steps 0`` on phase
    ``ml_split``'s split, under ``torch.use_deterministic_algorithms`` so
    that the SpMM tail's ``index_add_`` sums in a fixed order (its atomics
    would part the runs on their own). The bus tables must agree within
    ``tests/test_fused_steps.py``'s tolerance (rtol 1e-5, atol 1e-6), the
    three-way-test lists id-equal but at near-ties; each run's epochs are
    logged (host enqueue and device step). Returns the launches."""
    device = torch.device(device)
    launches = dict.fromkeys(("fused_sweep", "fused_sweep_bf16",
                              "merge_parts"), 0)
    was = torch.are_deterministic_algorithms_enabled()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for model, flags in runs:
                tables = {}
                for fs in (0, k):
                    emb = os.path.join(root, f"emb_fused{fs}")
                    _, got, evs, secs = cli_run(
                        device, root, ds, model, epochs,
                        (*flags, "--fused_steps", str(fs), "--emb_dir", emb),
                        d, bs, seed, topN, tag=f"{model}_fused{fs}")
                    for name in launches:
                        launches[name] += got[name]
                    log(f"  {model} --fused_steps {fs}: {secs:.2f} s (CLI)")
                    log_epochs(evs)
                    bus = load_embeddings(emb, ds, "item", model)
                    tables[fs] = [torch.as_tensor(bus[key], device=device)
                                  for key in ("user_emb", "item_emb")]
                hold_fused(model, data, tables[0], tables[k], device, topN)
        finally:
            torch.use_deterministic_algorithms(was)
    return launches


def hold_fused(model, data, base, fused, device, topN):
    """The fused run's bus tables and three-way-test lists against the
    per-batch run's."""
    gaps = [float((a - b).abs().max()) for a, b in zip(base, fused)]
    for a, b in zip(base, fused):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6)
    lists = {}
    for tabs in (base, fused):
        res = three_way_test(data, *tabs, topN=topN, device=device,
                             verbose=False)
        for setting, r in res.items():
            lists.setdefault(setting, []).append(r["rec"])
    equal = {}
    for setting, (a, b) in lists.items():
        es = data.eval_splits[SETTING_SPLITS[(setting, "test")]]
        equal[setting] = "/".join(map(str, compare_lists(
            *base, es.users, a, b)[::-1]))
    log(f"  {model}: fused vs per-batch tables max abs diff {gaps}; test "
        f"lists id-equal {equal}")


# ------------------------------------------------------------ phase search
def search_run(device, root, ds="ml_synth", bs=4096, seed=0, topN=(10, 20),
               trials=SEARCH_TRIALS):
    """Phase search: the port's search driver (``param_search.main``, the
    entry ``python -m coldrec_tpu_torch.param_search`` runs) in a temporary
    working directory, ``trials`` MF trials of 1 epoch on ``root/ds``, then
    a resume to ``trials + 1`` that runs exactly one more; deterministic
    algorithms on. Held: the params are the port's ``RandomTrial`` draws
    for the slug, every value finite, the pickle the best journal line's
    params and its sidecar its value, ``view_best`` prints them, one CLI
    run of those params gives the best value again (equal), and the card's
    allocated memory after trial ``trials`` within ``SEARCH_MEM_RTOL`` of
    that after trial 1. Returns the launch counts of the search."""
    from coldrec_tpu_torch import param_search as ps
    from coldrec_tpu_torch.param import view_best

    device = torch.device(device)
    flags = ["--model", "MF", "--dataset", ds, "--data_dir", root,
             "--cold_object", "item", "--epochs", "1", "--bs", str(bs),
             "--topN", ",".join(map(str, topN)), "--seed", str(seed),
             "--save_emb", "false", "--device", device.type]
    slug = f"MF_{ds}_item_bb_MF_cs"
    here = os.getcwd()
    ps.TRIAL_STATS.clear()
    reset_launches()
    with tempfile.TemporaryDirectory() as work, deterministic():
        os.chdir(work)
        try:
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                ps.main(["--n_trials", str(trials), *flags])
                first = open(f"param/search_{slug}.jsonl").read()
                ps.main(["--n_trials", str(trials + 1), *flags])
            launches = launch_counts()
            journal = open(f"param/search_{slug}.jsonl").read()
            with open(f"param/{slug}.pkl", "rb") as f:
                best_params = pickle.load(f)
            with open(f"param/{slug}.value.json") as f:
                best_value = json.load(f)["best_value"]
            shown = io.StringIO()
            with contextlib.redirect_stdout(shown):
                view_best.main(["--model", "MF", "--dataset", ds])
            with contextlib.redirect_stdout(io.StringIO()):
                payload = tmain.run(make_args([
                    *flags, "--lr", repr(best_params["lr"]), "--reg",
                    repr(best_params["reg"]), "--emb_size", "64",
                    "--result_file", os.path.join(work, "best.txt")]))
        finally:
            os.chdir(here)
    recs = [json.loads(x) for x in journal.splitlines()]
    stats = ps.TRIAL_STATS
    for st in stats:
        mib = {k: None if st[k] is None else st[k] / 2**20
               for k in ("allocated", "peak")}
        log(f"  trial {st['trial']}: {st['seconds']:.2f} s, fused_sweep "
            f"{st['fused_sweep']} launches, allocated after it "
            f"{mib['allocated']} MiB (peak in it {mib['peak']} MiB)")
    if [r["trial"] for r in recs] != list(range(trials + 1)) \
            or not journal.startswith(first) \
            or [st["trial"] for st in stats] != list(range(trials + 1)):
        raise AssertionError(f"search: the resume ran trials "
                             f"{[st['trial'] for st in stats]}, journal "
                             f"{[r['trial'] for r in recs]}")
    for r in recs:
        digest = hashlib.sha256(f"{slug}:{r['trial']}".encode()).digest()
        trial = ps.RandomTrial(random.Random(int.from_bytes(digest[:8],
                                                            "little")))
        ps.apply_suggestions(trial, make_args(flags))
        if trial.params != r["params"]:
            raise AssertionError(f"search: trial {r['trial']} ran "
                                 f"{r['params']}, RandomTrial draws "
                                 f"{trial.params}")
    if not all(math.isfinite(r["value"]) for r in recs):
        raise AssertionError(f"search: a value is not finite: {recs}")
    top = max(recs, key=lambda r: r["value"])
    if best_params != top["params"] or best_value != top["value"]:
        raise AssertionError(f"search: the pickle holds {best_params} / "
                             f"{best_value}, the best line is {top}")
    text = shown.getvalue()
    if not all(f"  {k}: {v}" in text for k, v in best_params.items()) \
            or f"(objective value: {best_value})" not in text:
        raise AssertionError(f"search: view_best printed {text!r}")
    again = payload["metrics"][str(topN[0])]["all"]["NDCG"]["mean"]
    if again != best_value:
        raise AssertionError(f"search: the CLI gives {again} for the best "
                             f"params, the search {best_value}")
    if device.type == "cuda":
        a, b = stats[0]["allocated"], stats[trials - 1]["allocated"]
        if abs(b - a) > SEARCH_MEM_RTOL * a:
            raise AssertionError(f"search: allocated {a} bytes after trial "
                                 f"1, {b} after trial {trials}")
    if device.type == "cuda" and not all(st["fused_sweep"] > 0
                                         for st in stats):
        raise AssertionError(f"search: a trial left fused_sweep "
                             f"unlaunched: {stats}")
    log(f"  {trials} trials, resumed to {trials + 1} (one more ran); best "
        f"trial {top['trial']} {top['params']}: NDCG@{topN[0]} "
        f"{best_value} (the CLI: {again}); view_best:\n{text.rstrip()}")
    return launches


# ------------------------------------------------------------ phase parse
def parse_run(root, ds="bx_synth", cold_object="item"):
    """Phase parse: the split's seven CSVs read by the port's loader (the
    C++ parser) and by ``np.loadtxt`` (the read the port's loader made
    before), arrays equal; seconds of each (the files were just written:
    warm reads)."""
    base = os.path.join(root, ds, f"cold_{cold_object}")
    names = sorted(n for n in os.listdir(base) if n.endswith(".csv"))
    secs = {"native": 0.0, "loadtxt": 0.0}
    rows = 0
    for name in names:
        path = os.path.join(base, name)
        t = time.perf_counter()
        got = tloader.load_interaction_csv(path)
        secs["native"] += time.perf_counter() - t
        t = time.perf_counter()
        ref = np.loadtxt(path, delimiter=",", skiprows=1, usecols=(0, 1),
                         dtype=np.int64, ndmin=2)
        secs["loadtxt"] += time.perf_counter() - t
        if ref.size == 0:
            ref = np.zeros((0, 2), np.int64)
        if got.dtype != ref.dtype or not np.array_equal(got, ref):
            raise AssertionError(f"parse: {name}: the parser's "
                                 f"{got.shape} != np.loadtxt's {ref.shape}")
        rows += got.shape[0]
    log(f"  {len(names)} CSVs, {rows} rows (warm reads): native parser "
        f"{secs['native']:.3f} s, np.loadtxt {secs['loadtxt']:.3f} s "
        f"({secs['loadtxt'] / max(secs['native'], 1e-9):.1f}x); arrays equal")
    return secs


# ---------------------------------------- phases scale, serving and ubench
def scale_build(root, shape=SCALE_SHAPE):
    """The scale tool's dataset at ``shape`` under ``root``'s workdir,
    built in this process by the tool's own ``build_dataset``: its stage
    seconds (the host's work, beside the card phases when run on a
    thread)."""
    return sr.build_dataset(os.path.join(root, f"{shape}_workdir"), shape)


def scale_split(root, shape=SCALE_SHAPE):
    """The scale tool's split under ``root``'s workdir, read (the C++
    parser: after phase build)."""
    return ColdStartDataset.from_split_dir(
        os.path.join(root, f"{shape}_workdir", "data"), shape, "item")


def scale_lists(data, ue, ie, device, n=SCALE_LIST_USERS, k=K):
    """The kernel's lists of the first ``n`` users of each test setting
    (``retrieval_topk``, rated items and the setting's items excluded)
    against the plain path's, by the rule of ``compare_lists``; returns
    {setting: (rows, id-equal rows)}."""
    out = {}
    for setting in ("all", "cold", "warm"):
        es = data.eval_splits[SETTING_SPLITS[(setting, "test")]]
        users = es.users[:n].astype(np.int64)
        rated = torch.as_tensor(data.rated_padded(users),
                                device=device).long()
        bias = torch.as_tensor(mask_bias_vector(
            data.item_num, data.candidate_mask("item", setting)),
            device=device)
        uu = ue[torch.as_tensor(users, device=device)]
        _, ids = retrieval_topk(uu, ie, rated, bias, k, device=device)
        ref = ret._exact_rows(uu, ie, rated, bias, k)[1]
        out[setting] = compare_lists(ue, ie, users, ids, ref)
    return out


def scale_phase(device, root, shape=SCALE_SHAPE, model="DropoutNet",
                backbone="MF", epochs=1, built=None, read=None,
                topN=(10, 20), timeout=900):  # topN: the CLI's default
    """Phase scale: the port's ``scale_run`` through its command line at
    ``shape`` in ``root``'s workdir: ``backbone`` one whole epoch with
    ``--save_emb 1`` (the tool's backbone-first rule), then ``model`` one
    whole epoch on its bus; the dataset is built first by the tool's
    ``build_dataset`` (``built``: a future of ``scale_build`` started
    earlier; ``read``: one of ``scale_split``, for the checks below), so
    the tool finds it. Held: exit 0, the JSON line of each
    run, every topN x setting x metric finite in both result files, whole
    epochs (every batch of the warm-train split), the backbone's
    validation NDCG@max(topN) above its untrained tables', every ranked
    split on the kernel route, ``fused_sweep`` launched in each run, and
    the lists of both buses' tables for the first ``SCALE_LIST_USERS``
    users of each test setting equal to the plain path's (near-ties
    aside). Logs the build, each epoch's split, test and wall seconds.
    Returns the runs' launches (their ``run_end`` events)."""
    device = torch.device(device)
    workdir = os.path.join(root, f"{shape}_workdir")
    t = time.perf_counter()
    stats = built.result() if built is not None else scale_build(root, shape)
    log(f"  dataset {shape} ({time.perf_counter() - t:.2f} s waited): "
        + (", ".join(f"{k} {v:.2f}" for k, v in stats.items())
           if stats else "already built"))
    events = os.path.join(root, "events_scale.jsonl")
    if os.path.exists(events):
        os.remove(events)
    cmd = [sys.executable, "-m", "coldrec_tpu_torch.tools.scale_run",
           "--shape", shape, "--workdir", workdir, "--model", model,
           "--epochs", str(epochs), "--backbone", backbone,
           "--backbone_epochs", str(epochs), "--device", device.type]
    t = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, check=False, cwd=REPO_DIR,
                          env=dict(os.environ, COLDREC_EVENT_LOG=events))
    wall = time.perf_counter() - t
    if proc.returncode != 0:
        raise AssertionError(f"scale_run exited {proc.returncode}: "
                             f"{proc.stderr[-3000:]}")
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith('{"scale_run"')]
    if [ln["scale_run"] for ln in lines] != [backbone, model] or any(
            set(ln) != SCALE_LINE for ln in lines):
        raise AssertionError(f"scale_run lines {lines}")
    data = read.result() if read is not None else scale_split(root, shape)
    batches = -(-data.train_pairs.shape[0] // 4096)
    runs, current = {}, []
    for ev in read_events(events):  # each run's events, from its run_start
        if ev["event"] == "run_start":
            current = runs.setdefault(ev["model"], [])
        current.append(ev)
    launches = {k: 0 for k in ("fused_sweep", "fused_sweep_bf16",
                               "merge_parts")}
    top = max(topN)
    for line in lines:
        name = line["scale_run"]
        evs = runs[name]
        payload = sr.result_payload(os.path.join(workdir, "results",
                                                 f"{name}.json"))
        bad = [(tn, s, m) for tn in map(str, topN)
               for s in ("all", "cold", "warm")
               for m in ("Hit", "Precision", "Recall", "NDCG")
               if not np.isfinite(payload["metrics"][tn][s][m]["mean"])]
        if bad:
            raise AssertionError(f"scale {name}: metrics not finite {bad}")
        epoch_evs = [e for e in evs if e["event"] == "epoch"]
        if [e["batches"] for e in epoch_evs] != [batches] * epochs:
            raise AssertionError(f"scale {name}: epochs of "
                                 f"{[e['batches'] for e in epoch_evs]} "
                                 f"batches, {epochs} of {batches} asked for")
        log_epochs(evs)
        routed = routes(evs)
        if any(r != ["kernel"] for r in routed.values()):
            raise AssertionError(f"scale {name}: routes {routed}")
        end = [e for e in evs if e["event"] == "run_end"][0]
        for k in launches:
            launches[k] += end["kernel_launches"][k]
        if device.type == "cuda" and not end["kernel_launches"][
                "fused_sweep"]:
            raise AssertionError(f"scale {name}: fused_sweep unlaunched")
        bus = load_embeddings(os.path.join(workdir, "emb"), shape, "item",
                              name)
        ue, ie = (torch.as_tensor(bus[k], device=device)
                  for k in ("user_emb", "item_emb"))
        same = scale_lists(data, ue, ie, device)
        best = max(e["ndcg"] for e in evs if e["event"] == "validation")
        log(f"  {name}: {line}; test {end['test_seconds']:.3f} s; "
            f"validation NDCG@{top} best {best:.5f}; kernel launches "
            f"{end['kernel_launches']}; routes {routed}; lists of "
            f"{SCALE_LIST_USERS} test users id-equal to the plain path "
            + ", ".join(f"{s} {e}/{r}" for s, (r, e) in same.items()))
        if name == backbone:
            seed = payload["hyperparameters"]["seed"]
            mf = MF(data.user_num, data.item_num, ue.shape[1], seed=seed,
                    device=device)
            untrained = val_ndcg(data, *(x.detach() for x in
                                         mf.forward_tables()), device, top)
            if not best > untrained:
                raise AssertionError(f"scale {name}: validation NDCG@{top} "
                                     f"{best} <= untrained {untrained}")
            log(f"    untrained tables' validation NDCG@{top} "
                f"{untrained:.5f}")
    log(f"  scale_run {wall:.2f} s for both runs ({data.user_num} x "
        f"{data.item_num}, {data.train_pairs.shape[0]} warm-train pairs, "
        f"{batches} batches an epoch); launches {launches}")
    return launches


def serving_phase(device, bus, flags=(), iters=SERVE_ITERS):
    """Phase serving: ``ubench_serving`` in its three modes (its default
    shape unless ``flags``), the bf16 A/B on the bus file ``bus``, the
    launch counts zeroed before and read after. Held: every time finite
    and positive, p95 >= p50; each batch size's lists (the last request's)
    equal to the plain path's by the rule of ``compare_lists``; the bf16
    A/B's lists equal to the plain path's on the bf16-rounded tables, and
    its drift equal to a recount. Returns the launches."""
    device = torch.device(device)
    base = ["--device", device.type, "--iters", str(iters), *flags]
    reset_launches()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        e2e = ubench_serving.main(base)
        dev = ubench_serving.main(base + ["--device_only"])
        ab = ubench_serving.main(base + ["--bf16_ab", "--emb", bus])
    launches = launch_counts()
    log("\n".join("  | " + ln for ln in out.getvalue().splitlines()))
    times = ([v for r in e2e["e2e"].values() for v in (r["p50_ms"],
                                                        r["p95_ms"])]
             + [r["ms"] for r in dev["device_only"].values()]
             + [ab["bf16_ab"]["fp32_ms"], ab["bf16_ab"]["bf16_ms"]])
    if not all(np.isfinite(t) and t > 0 for t in times) or any(
            r["p95_ms"] < r["p50_ms"] for r in e2e["e2e"].values()):
        raise AssertionError(f"serving times {times}")
    ue, ie = e2e["user_emb"], e2e["item_emb"]
    none = torch.zeros(ie.shape[0], dtype=torch.bool, device=device)
    for bs, r in e2e["e2e"].items():
        users = torch.as_tensor(r["users"], device=device).long()
        rated = torch.full((bs, 1), ie.shape[0], dtype=torch.int64,
                           device=device)
        ref = ret._exact_rows(ue[users], ie, rated, none, K)[1]
        rows, equal = compare_lists(ue, ie, r["users"], r["ids"], ref)
        log(f"  e2e bs {bs}: lists id-equal to the plain path on "
            f"{equal}/{rows} (others near-ties)")
    r = ab["bf16_ab"]
    bu, bi = (ret.bf16_round(ab[k]) for k in ("user_emb", "item_emb"))
    users = torch.as_tensor(r["users"], device=device).long()
    rated = torch.full((users.shape[0], 1), bi.shape[0], dtype=torch.int64,
                       device=device)
    ref = ret._exact_rows(bu[users], bi, rated, torch.zeros(
        bi.shape[0], dtype=torch.bool, device=device), K)[1]
    rows, equal = compare_lists(bu, bi, r["users"], r["ids16"], ref)
    changed = int(sum(not np.array_equal(a, b)
                      for a, b in zip(r["ids32"], r["ids16"])))
    overlap = float(np.mean([len(set(a) & set(b)) / K
                             for a, b in zip(r["ids32"], r["ids16"])]))
    if (changed, overlap) != (r["changed"], r["overlap"]):
        raise AssertionError(f"drift {r['changed']}, {r['overlap']}; "
                             f"recount {changed}, {overlap}")
    log(f"  bf16 lists on the bus tables id-equal to the plain bf16 path "
        f"on {equal}/{rows}; drift recounted; launches {launches}")
    if device.type == "cuda" and not (launches["fused_sweep"]
                                      and launches["fused_sweep_bf16"]):
        raise AssertionError(f"serving left a sweep unlaunched: {launches}")
    return launches


def ubench_phase(device, users=1024, items=VAR_ITEMS, d=UBENCH_D,
                 slabs=None, iters=10):
    """Phase ubench: ``ubench_sweep``'s point (``users`` x ``items`` at
    ``d``, fp32 and bf16; the tool holds each kernel bit for bit to its
    plain version on integer tables there first), then ``ubench_spmm`` on
    its slabs (``slabs``: {name: (n, k)}, the tool's by default), each
    form held to ``torch.sparse.mm``; the launch counts zeroed before and
    read at the end. Returns (sweep point, slabs, launches)."""
    device = torch.device(device)
    reset_launches()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        point = ubench_sweep.run(device, [users], items, [d],
                                 ["fp32", "bf16"], iters=iters)[0]
        spmm = {s: ubench_spmm.run_slab(device, s, n, k, iters=iters)
                for s, (n, k) in (slabs or ubench_spmm.SLABS).items()}
    launches = launch_counts()
    log("\n".join("  | " + ln for ln in out.getvalue().splitlines()))
    times = [f["ms"] for f in point["forms"].values()] + [
        f["ms"] for s in spmm.values() for f in s["forms"].values()]
    if not all(np.isfinite(t) and t > 0 for t in times):
        raise AssertionError(f"ubench times {times}")
    log(f"  launches {launches}")
    if device.type == "cuda" and not (launches["fused_sweep"]
                                      and launches["fused_sweep_bf16"]):
        raise AssertionError(f"ubench left a sweep unlaunched: {launches}")
    return point, spmm, launches


# ------------------------------------------------------------ phase mesh
def rank_flags(flags):
    """(CLI flags, deterministic, epoch_steps, ncl_proto, events) of a run's
    flags: ``--deterministic`` (deterministic algorithms), ``--epoch_steps
    N`` (``main.run(epoch_steps=N)``), ``--ncl_proto`` (NCL's proto term and
    e-step on from epoch 0, its warm-up cut as ``ncl_proto`` cuts it) and
    ``--events PATH`` (the run's event log) taken out."""
    rest = list(flags)
    det = "--deterministic" in rest
    proto = "--ncl_proto" in rest
    rest = [f for f in rest if f not in ("--deterministic", "--ncl_proto")]
    steps, events = 0, ""
    for flag in ("--epoch_steps", "--events"):
        if flag in rest:
            i = rest.index(flag)
            if flag == "--epoch_steps":
                steps = int(rest[i + 1])
            else:
                events = rest[i + 1]
            del rest[i:i + 2]
    return rest, det, steps, proto, events


@contextlib.contextmanager
def proto_on(on: bool = True):
    """NCL's proto term and e-step from epoch 0 inside the block."""
    was = ncl_mod.WARMUP_EPOCHS
    if on:
        ncl_mod.WARMUP_EPOCHS = 0
    try:
        yield
    finally:
        ncl_mod.WARMUP_EPOCHS = was


def _counters() -> dict:
    return {"launches": launch_counts(), "staging_s": host_staging.seconds,
            "staging_bytes": host_staging.bytes,
            "collectives": run_collective.calls,
            "collective_s": run_collective.seconds}


def _since(before: dict) -> dict:
    """The launches (zeroed at the start), collectives and staging of a run
    from the counters read before it."""
    now = _counters()
    return {k: now[k] if k == "launches" else now[k] - before[k]
            for k in now}


def cli_rank_run(flags, rank: int):
    """One CLI run of a rank (``main.run`` on ``flags``, ``rank_flags``'
    switches applied): (its stats, its device, the group's backend line if
    this run opened the group)."""
    rest, det, epoch_steps, proto, events = rank_flags(flags)
    torch.use_deterministic_algorithms(det, warn_only=True)
    if events:
        events += f".rank{rank}"
        os.environ["COLDREC_EVENT_LOG"] = events
    reset_launches()
    before = _counters()
    args = make_args(rest)
    made = []
    record = args.model if events else None
    data = read_split(args.data_dir, args.dataset, args.cold_object)
    with contextlib.redirect_stdout(io.StringIO()) as out, \
            proto_on(proto), mesh_record(record) as rec:
        tmain.run(args, made.append, data, epoch_steps)
    if rec:
        np.savez(events + ".record.npz",
                 *[a for x in rec for a in (x if isinstance(x, tuple)
                                            else (x,))])
    backend = [ln for ln in out.getvalue().splitlines()
               if ln.startswith("process group:")]
    return ({**_since(before), "bn_sha256": bn_digest(made[-1].model)},
            args.device, backend)


def rank_main(argv) -> int:
    """One rank of phase mesh: ``chip_smoke.py --rank cli FLAGS... [--then
    FLAGS...]...`` runs the port's CLI entry (``main.run``) on each run's
    flags in turn, in this one process and group; ``--rank serve SPEC``
    answers the requests of a JSON spec through a 1x2 mesh
    ``RetrievalServer``. ``--deterministic``, ``--epoch_steps N``,
    ``--ncl_proto`` and ``--events PATH`` among a run's flags act as
    ``rank_flags`` says; the event log gets ``.rank<r>`` appended, and a
    SimGCL, XSimGCL or CGRC run writes what ``mesh_record`` records beside
    it, ``<log>.record.npz``. Prints as its last
    line its device, the group's backend line and, for each run, its launch
    counts, collectives (calls, seconds) and host staging, then leaves
    through a barrier."""
    warnings.simplefilter("ignore", UserWarning)
    kind, rest = argv[0], list(argv[1:])
    rank = int(os.environ["COLDREC_PROCESS_ID"])
    runs, backend = [], []
    if kind == "cli":
        while rest:
            cut = rest.index("--then") if "--then" in rest else len(rest)
            stats, device, opened = cli_rank_run(rest[:cut], rank)
            runs.append(stats)
            backend = backend or opened
            rest = rest[cut + 1:]
    elif kind == "serve":
        reset_launches()
        before = _counters()
        device, extra = serve_rank(rest[0])
        backend = extra.pop("backend")
        runs.append({**_since(before), **extra})
    else:
        raise ValueError(f"--rank {kind!r}: cli or serve")
    line = {"rank": rank, "device": str(device), "backend": backend,
            "runs": runs}
    shutdown_distributed()
    print(json.dumps(line), flush=True)
    return 0


def bn_digest(module):
    """sha256 of the module's BatchNorm running statistics (None without
    a BatchNorm)."""
    stats = [t.detach().cpu().numpy().tobytes()
             for b in module.modules() if isinstance(b, MaskedBatchNorm1d)
             for t in (b.running_mean, b.running_var)]
    return hashlib.sha256(b"".join(stats)).hexdigest() if stats else None


def serve_rank(spec_path: str):
    """Phase mesh (a) on one rank: the bus tables behind a 1x2 mesh
    ``RetrievalServer``, every request of the spec answered in turn (rank 0
    writes the lists). Returns (device, {"request_s": [...]})."""
    with open(spec_path) as f:
        spec = json.load(f)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        init_distributed(device=spec["device"])
    device = rank_device(spec["device"])
    data = ColdStartDataset.from_split_dir(spec["root"], spec["ds"], "item")
    srv = RetrievalServer.from_checkpoint(
        spec["emb"], spec["ds"], "item", "MF", dataset=data, device=device,
        mesh=make_mesh(1, 2))
    requests = np.load(spec["requests"])
    reset_launches()
    secs, lists = [], {}
    for key in sorted(requests.files):
        t = time.perf_counter()
        lists[key] = srv.topk(requests[key], K, exclude_rated=True)[1]
        secs.append(time.perf_counter() - t)
    if int(os.environ["COLDREC_PROCESS_ID"]) == 0:
        np.savez(spec["out"], **lists)
    return device, {"request_s": secs,
                    "backend": out.getvalue().strip().splitlines()}


def run_ranks(tags, argv, n, env, device):
    """``chip_smoke.py --rank ARGV`` as ``n`` ranks, whose runs are
    ``tags`` (labels, in order); every rank must exit 0 and say it computed
    on ``device``'s type through a logged backend. Returns, for each run,
    its ranks' lines (each rank's stats of that run, with its rank, device
    and backend)."""
    t = time.perf_counter()
    runs = launch_ranks([sys.executable, os.path.abspath(__file__),
                         "--rank", *argv], n, MESH_RANK_S, env)
    failed = [(r, code, out) for r, (code, out) in enumerate(runs) if code]
    if failed:  # a rank that failed on its own before one that was stopped
        r, code, out = max(failed, key=lambda f: f[1] > 0)
        raise AssertionError(f"mesh {tags[0]}: ranks "
                             f"{[f[:2] for f in failed]} (rank, exit code); "
                             f"rank {r}:\n{out[-3000:]}")
    lines = [json.loads(out.strip().splitlines()[-1]) for _, out in runs]
    for line in lines:
        if not (any("backend" in b for b in line["backend"])
                and line["device"].startswith(device.type)):
            raise AssertionError(f"mesh {tags[0]}: rank {line['rank']} logged "
                                 f"no backend or left {device.type}: {line}")
    secs = time.perf_counter() - t
    out = []
    for i, tag in enumerate(tags):
        per_run = [{**x["runs"][i], "rank": x["rank"], "device": x["device"],
                    "backend": x["backend"]} for x in lines]
        where = (f" (run {i + 1} of {len(tags)} in the group)"
                 if len(tags) > 1 else "")
        log(f"  {tag}: {n} ranks{'' if i else f' {secs:.2f} s'}{where}"
            f"; {lines[0]['backend'][0]}; per rank: "
            + "; ".join(f"rank {x['rank']} on {x['device']}: fused_sweep "
                        f"{x['launches']['fused_sweep']}, {x['collectives']} "
                        f"collectives {x['collective_s']:.3f} s, staging "
                        f"{x['staging_s']:.3f} s / "
                        f"{x['staging_bytes'] / 2**20:.1f} MiB"
                        for x in per_run))
        out.append(per_run)
    return out


def _rank_epochs(events, n):
    """Each rank's per-batch losses, from its event log."""
    return [[x for e in read_events(f"{events}.rank{r}")
             if e["event"] == "epoch" for x in e["losses"]]
            for r in range(n)]


def _result_blocks(path) -> int:
    with open(path, encoding="utf-8") as f:
        return f.read().count("=== ColdRec Run Result ===")


def mesh_serve(device, root, ds, env, pool, d=D, seed=0, serve=MESH_SERVE):
    """Phase mesh (a): the one-rank server's lists here, the ranks started
    in ``pool``. Returns a function that waits for the ranks, holds their
    lists to the one-rank server's and returns their fused_sweep
    launches."""
    data = read_split(root, ds)
    mf = MF(data.user_num, data.item_num, d, seed=seed, device=device)
    ue, ie = (w.detach() for w in mf.forward_tables())
    emb = os.path.join(root, "emb_mesh")
    save_embeddings(emb, ds, "item", "MF", {"user_emb": ue, "item_emb": ie})
    rng = np.random.default_rng(seed + 7)
    requests = {f"r{j}": rng.choice(data.user_num, n, replace=False)
                for j, n in enumerate(serve)}
    req_path = os.path.join(root, "mesh_requests.npz")
    np.savez(req_path, **requests)
    srv = RetrievalServer(ue, ie, dataset=data, device=device)
    one_s, one_ids = [], {}
    for key in sorted(requests):
        t = time.perf_counter()
        one_ids[key] = srv.topk(requests[key], K, exclude_rated=True)[1]
        one_s.append(time.perf_counter() - t)
    out = os.path.join(root, "mesh_served.npz")
    spec = os.path.join(root, "mesh_serve.json")
    with open(spec, "w") as f:
        json.dump({"device": device.type, "root": root, "ds": ds,
                   "emb": emb, "requests": req_path, "out": out}, f)
    ranks = pool.submit(run_ranks, ["(a) serve 1x2"], ["serve", spec], 2,
                        env, device)

    def finish():
        lines = ranks.result()[0]
        got = np.load(out)
        equal = []
        for key in sorted(requests):
            rows, same = compare_lists(ue, ie, requests[key], got[key],
                                       one_ids[key])
            equal.append(f"{same}/{rows}")
        per_rank = [x["launches"]["fused_sweep"] for x in lines]
        if device.type == "cuda" and min(per_rank) < len(serve):
            raise AssertionError(f"(a): a rank left its item block "
                                 f"unswept: fused_sweep {per_rank}")
        log(f"  (a) {data.user_num} x {data.item_num} d={d}, "
            f"{data.item_num // 2} items a rank; requests {list(serve)} "
            f"users: lists id-equal to one rank's on {equal} rows (others "
            f"near-ties); seconds per request: mesh "
            f"{[round(s, 4) for s in lines[0]['request_s']]}, one rank "
            f"{[round(s, 4) for s in one_s]}; host staging rank 0 "
            f"{lines[0]['staging_s']:.3f} s")
        return sum(per_rank)

    return finish


MESH_STEPS = 10  # batches of (g)-(v)'s one epoch
MESH_RUNS = {  # tag: (ranks, "bx", "ml" or "mlc" split, model flags, mesh
    # flags: the ranks' own, and rank_flags' switches for both runs)
    # "--deterministic": deterministic algorithms in the ranks and in the
    # one-rank run; (b) and (e) are held bit for bit
    "b": (2, "bx", ["--model", "MF"], ["--mesh", "1x2", "--deterministic"]),
    "c": (2, "ml", ["--model", "MF", "--eval_backend", "xla"], []),
    "d": (4, "ml", ["--model", "LightGCN", "--layers", "2"],
          ["--mesh", "2x2"]),
    # DropoutNet on the MF bus that (c)'s two ranks wrote; (f) without the
    # atomics' noise, which Adam carries into the losses (PERF.md §6)
    "e": (2, "ml", ["--model", "DropoutNet"], ["--mesh", "1x2",
                                                "--deterministic"]),
    "f": (4, "ml", ["--model", "DropoutNet"], ["--mesh", "2x2",
                                                "--deterministic"]),
    # the graph backbones and CGRC, MESH_STEPS batches of one epoch each (the
    # one-rank runs too); (j) with NCL's proto term and e-step on from epoch
    # 0; (k) on "mlc", the ml_synth split with ML_CONTENT item columns
    "g": (4, "ml", ["--model", "XSimGCL", "--layers", "2"],
          ["--mesh", "2x2", "--deterministic", "--epoch_steps",
           str(MESH_STEPS)]),
    "h": (2, "ml", ["--model", "SimGCL", "--layers", "2"],
          ["--mesh", "1x2", "--deterministic", "--epoch_steps",
           str(MESH_STEPS)]),
    "i": (4, "ml", ["--model", "NGCF", "--layers", "2"],
          ["--mesh", "2x2", "--epoch_steps", str(MESH_STEPS)]),
    "j": (4, "ml", ["--model", "NCL", "--layers", "2"],
          ["--mesh", "2x2", "--deterministic", "--epoch_steps",
           str(MESH_STEPS), "--ncl_proto"]),
    "k": (4, "mlc", ["--model", "CGRC"],
          ["--mesh", "2x2", "--deterministic", "--epoch_steps",
           str(MESH_STEPS)]),
}
# the cold models, MESH_STEPS batches of one epoch each on "mlc": tag ->
# (model flags, mesh)
MESH_COLD = {
    "l": (["--model", "DUIF"], "1x2"),
    "m": (["--model", "KNN", "--backbone", "LightGCN", "--layers", "2"],
          "1x2"),
    "n": (["--model", "LARA"], "1x2"),
    "o": (["--model", "DeepMusic"], "1x2"),
    "p": (["--model", "Heater"], "1x2"),
    "q": (["--model", "GAR"], "2x2"),
    "r": (["--model", "CLCRec"], "2x2"),
    "s": (["--model", "CCFCRec"], "2x2"),
    "t": (["--model", "AGNN"], "2x2"),
    "u": (["--model", "MetaEmbedding"], "2x2"),
    "v": (["--model", "GoRec"], "2x2"),
}
MESH_RUNS.update({
    tag: (2 if mesh == "1x2" else 4, "mlc", model,
          ["--mesh", mesh, "--deterministic", "--epoch_steps",
           str(MESH_STEPS)])
    for tag, (model, mesh) in MESH_COLD.items()})
SIGNED_MODELS = ("SimGCL", "XSimGCL")  # their noise takes each sign
# the models whose one-rank run takes its ranks' side of each float32 tie
# (``mesh_replay``; deterministic: every data rank computes the same forward)
REPLAYED_MODELS = SIGNED_MODELS + ("CGRC",)
# these ranks (and their one-rank runs) start once the ranks of the tag they
# name have written its MF bus (a chained tag: its chain's ranks)
MESH_AFTER = {t: "c" for t in "efnopqtuv"}
# rank groups that run several tags one after another in the same processes
# (one start-up, fewer processes sharing the card): the first tag's ranks;
# the cold models that read no bus join the groups that start at once
MESH_CHAINS = {"b": "bhlm", "d": "dgijkrs", "e": "enop", "f": "fqtuv"}
MESH_BIT_EQUAL = "belmnop"
# (f)'s float32 losses part from one rank's after ~50 steps, on the CPU as on
# the card, and so do float32's from float64's (PERF.md §6; in float64 they
# stay within 1e-12: ``tools/mesh_drift.py``): its first STEP_CHECK losses
# are held, its eval tables and its metrics after the epoch
MESH_HELD_STEPS = {"f": STEP_CHECK}
MESH_KERNEL_EVAL = "bdefghijklmnopqrstuv"  # every rank launches fused_sweep


def _arg(argv, flag: str) -> str:
    return argv[argv.index(flag) + 1]


def content_split(root, ds, to, columns, seed=0):
    """The split ``root/ds`` (item cold) as ``root/to`` with an N(0,1)
    item content of ``columns`` columns in place of its own."""
    shutil.copytree(os.path.join(root, ds, "cold_item"),
                    os.path.join(root, to, "cold_item"), dirs_exist_ok=True)
    n_items = np.load(os.path.join(root, ds, f"{ds}_item_content.npy"),
                      mmap_mode="r").shape[0]
    np.save(os.path.join(root, to, f"{to}_item_content.npy"),
            np.random.default_rng(seed + 2).standard_normal(
                (n_items, columns), dtype=np.float32))


def edge_scores(model, h_u_bar, x_cold, users):
    """(C, n) edge-MLP logits of cold item c and user ``users[c, j]``, the
    logits ``CGRC.topk_users`` ranks, less the output bias: it shifts every
    logit alike, and its exact gradient is 0 (Adam walks it on rounding
    noise, differently in two runs)."""
    with torch.no_grad():
        hu, xi = model.edge_parts(h_u_bar, x_cold)
        b1, w2, _ = model.mlp_tail()
        return torch.relu(hu[users] + (xi + b1)[:, None, :]) @ w2


def _row_rel(x):
    """|x| over its row's largest |x|."""
    a = x.abs()
    return a / a.amax(1, keepdim=True).clamp_min(torch.finfo(a.dtype).tiny)


@contextlib.contextmanager
def _swapped(owner, name, fn):
    was = getattr(owner, name)
    setattr(owner, name, fn)
    try:
        yield
    finally:
        setattr(owner, name, was)


@contextlib.contextmanager
def mesh_record(model):
    """Yields a list that gets, from the forwards run inside the block on
    this thread, the values of every perturbed layer of a SimGCL or XSimGCL
    run (float32 on the host; on a mesh graph this rank's node block), or
    (users, logits) of every Ĝ top-k of a CGRC run; nothing for another
    model."""
    rec, owner = [], threading.get_ident()
    if model in SIGNED_MODELS:
        perturb = simgcl_mod.perturb

        def recording(ego, eps, noise):
            if threading.get_ident() == owner:
                rec.append(ego.detach().float().cpu().numpy())
            return perturb(ego, eps, noise)

        swap = (simgcl_mod, "perturb", recording)
    elif model == "CGRC":
        topk = cgrc_mod.CGRC.topk_users

        def recording(self, h_u_bar, x_cold, k):
            top = topk(self, h_u_bar, x_cold, k)
            if threading.get_ident() == owner:
                rec.append((top.cpu().numpy(), edge_scores(
                    self, h_u_bar, x_cold, top).float().cpu().numpy()))
            return top

        swap = (cgrc_mod.CGRC, "topk_users", recording)
    else:
        yield rec
        return
    with _swapped(*swap):
        yield rec


def _record(path, model) -> list:
    """What ``mesh_record`` recorded in a rank, from its file."""
    with np.load(path) as f:
        arrays = [f[f"arr_{i}"] for i in range(len(f.files))]
    return (list(zip(arrays[::2], arrays[1::2])) if model == "CGRC"
            else arrays)


@contextlib.contextmanager
def mesh_replay(model, ranks, n_model):
    """The one-rank run of a REPLAYED_MODELS group on its ranks' records
    (``ranks[r]``: rank r's ``mesh_record``, rank r holding node block r %
    ``n_model``). Every rank of a block must have recorded the same (CGRC:
    every rank the same Ĝ). Where this run differs from the ranks, each
    difference must be a tie (``MESH_TIE_REL``, CGRC's logits within
    ``MESH_LOGIT_DRIFT``) and the run takes the
    ranks' side: their sign of a perturbed element, their top-k users of a
    cold item in Ĝ; anything else raises. Yields {"calls", "ties"
    (elements, or users swapped), "where" (perturbed layers, or cold
    items), "worst" (the largest tie, of its row's largest), "drift" (CGRC:
    the largest gap of the two runs' logits at the ranks' top-k, of the
    row's largest)}."""
    stats = {"calls": 0, "ties": 0, "where": [], "worst": 0.0,
             "drift": 0.0}
    if model == "CGRC":
        for r, rec in enumerate(ranks):
            if len(rec) != len(ranks[0]) or any(
                    not np.array_equal(a[0], b[0])
                    for a, b in zip(rec, ranks[0])):
                raise AssertionError(f"CGRC: rank {r} built another Ĝ "
                                     "than rank 0")
        topk = cgrc_mod.CGRC.topk_users
        owner = threading.get_ident()

        def replaying(self, h_u_bar, x_cold, k):
            if threading.get_ident() != owner:
                return topk(self, h_u_bar, x_cold, k)
            i = stats["calls"]
            stats["calls"] += 1
            own = topk(self, h_u_bar, x_cold, k)
            ids, logits = ranks[0][i]
            theirs = torch.as_tensor(ids, device=own.device)
            s_own = edge_scores(self, h_u_bar, x_cold, own)
            s_theirs = edge_scores(self, h_u_bar, x_cold, theirs)
            scale = s_own.abs().amax(1).clamp_min(torch.finfo(
                s_own.dtype).tiny)
            drift = float(((torch.as_tensor(logits, device=own.device)
                            - s_theirs).abs().amax(1) / scale).max())
            stats["drift"] = max(stats["drift"], drift)
            shared = (theirs[:, :, None] == own[:, None, :]).any(2)
            kept = (own[:, :, None] == theirs[:, None, :]).any(2)
            rows = (~shared).any(1)
            worst = 0.0
            if bool(rows.any()):  # own users the ranks left out vs theirs
                gap = (torch.where(kept, -math.inf, s_own).amax(1)
                       - torch.where(shared, math.inf, s_theirs).amin(1))
                worst = float((gap / scale)[rows].max())
                stats["ties"] += int((~shared).sum())
                stats["where"].append(int(rows.sum()))
                stats["worst"] = max(stats["worst"], worst)
            limit = 2 * max(drift, MESH_TIE_REL)
            if drift > MESH_LOGIT_DRIFT or worst > limit:
                raise AssertionError(
                    f"CGRC Ĝ {i}: the ranks' top-{k} users differ from one "
                    f"rank's on {int(rows.sum())} cold items, swapped "
                    f"{worst:.3e} apart (a tie: <= {limit:.3e}), the two "
                    f"runs' logits {drift:.3e} apart (limit "
                    f"{MESH_LOGIT_DRIFT}), of the row's largest")
            return theirs

        with _swapped(cgrc_mod.CGRC, "topk_users", replaying):
            yield stats
    else:
        for r in range(n_model, len(ranks)):
            if len(ranks[r]) != len(ranks[r % n_model]) or any(
                    not np.array_equal(a, b)
                    for a, b in zip(ranks[r], ranks[r % n_model])):
                raise AssertionError(f"{model}: ranks {r % n_model} and "
                                     f"{r} hold one node block and "
                                     "perturbed it differently")
        planes = [np.concatenate(blocks) for blocks in zip(*ranks[:n_model])]
        perturb = simgcl_mod.perturb
        owner = threading.get_ident()

        def replaying(ego, eps, noise):
            if threading.get_ident() != owner:
                return perturb(ego, eps, noise)
            i = stats["calls"]
            stats["calls"] += 1
            if i >= len(planes):
                raise AssertionError(f"{model}: more perturbed layers than "
                                     f"the ranks' {len(planes)}")
            ref = torch.as_tensor(planes[i][:ego.shape[0]], device=ego.device)
            own, theirs = torch.sign(ego.detach()), torch.sign(ref)
            diff = own != theirs
            if not bool(diff.any()):
                return perturb(ego, eps, noise)
            worst = float(torch.maximum(_row_rel(ego.detach()),
                                        _row_rel(ref))[diff].max())
            stats["ties"] += int(diff.sum())
            stats["where"].append(i)
            stats["worst"] = max(stats["worst"], worst)
            if worst > MESH_TIE_REL:
                raise AssertionError(
                    f"{model} perturbed layer {i}: {int(diff.sum())} "
                    "elements took another sign than the ranks', one "
                    f"{worst:.3e} of its row's largest |value| (a tie: <= "
                    f"{MESH_TIE_REL})")
            return (ego + torch.where(diff, theirs, own)
                    * simgcl_mod._normalize(noise) * eps)

        with _swapped(simgcl_mod, "perturb", replaying):
            yield stats
        if stats["calls"] != len(planes):
            raise AssertionError(f"{model}: {stats['calls']} perturbed "
                                 f"layers, the ranks recorded {len(planes)}")
    if model == "CGRC" and stats["calls"] != len(ranks[0]):
        raise AssertionError(f"CGRC: {stats['calls']} Ĝ top-k, the ranks "
                             f"recorded {len(ranks[0])}")


def mesh_train(device, bx_root, ml_root, env, pool, bx="bx_synth",
               ml="ml_synth", d=D, bs=4096, seed=0, topN=(10, 20),
               tags="bcdefghijklmnopqrstuv"):
    """Phase mesh (b)-(v): each rank group started in ``pool`` as soon as
    its inputs exist (those of ``MESH_AFTER`` once (c)'s ranks have written
    the MF bus), the one-rank runs in this process meanwhile, then each
    group held to its one-rank run. The one-rank runs of SimGCL, XSimGCL and CGRC come
    last, once their ranks have recorded their perturbed layers or Ĝ
    (``mesh_record``), and take the ranks' side of each float32 tie
    (``mesh_replay``), so that the two runs do not part there. Returns the
    fused_sweep launches of the ranks and of the one-rank runs."""
    common = ["--cold_object", "item", "--epochs", "1", "--bs", str(bs),
              "--emb_size", str(d), "--lr", "0.001", "--reg", "0.0001",
              "--topN", ",".join(map(str, topN)), "--seed", str(seed),
              "--save_emb", "true", "--result_overwrite", "false",
              "--device", device.type]
    splits = {"bx": (bx_root, bx), "ml": (ml_root, ml),
              "mlc": (ml_root, "ml_cgrc")}
    if any(MESH_RUNS[tag][1] == "mlc" for tag in tags):
        content_split(ml_root, ml, "ml_cgrc", ML_CONTENT, seed)

    def flags(tag, who):
        n, split, model, mesh = MESH_RUNS[tag]
        root, ds = splits[split]
        out = os.path.join(root, f"mesh_{tag}_{who}")
        return [*common, *model, "--dataset", ds, "--data_dir", root,
                "--emb_dir", out, "--result_file", out + ".txt",
                *(mesh if who == "ranks" else [])]

    def start(head):
        """The rank group of ``head``'s chain: {tag: (future, run index)}."""
        chain = [t for t in MESH_CHAINS.get(head, head) if t in tags]
        argv, labels = ["cli"], []
        for t in chain:
            _, _, model, mesh = MESH_RUNS[t]
            root = _arg(flags(t, "ranks"), "--data_dir")
            argv += [*flags(t, "ranks"), "--events",
                     os.path.join(root, f"events_mesh_{t}.jsonl"), "--then"]
            labels.append(f"({t}) {' '.join(model + mesh)}")
        future = pool.submit(run_ranks, labels, argv[:-1], MESH_RUNS[head][0],
                             {k: v for k, v in env.items()
                              if k != "COLDREC_EVENT_LOG"}, device)
        return {t: (future, i) for i, t in enumerate(chain)}

    def replayed(tag):
        return MESH_RUNS[tag][2][1] in REPLAYED_MODELS

    chained = {t for chain in MESH_CHAINS.values() for t in chain[1:]}
    futures = {}
    for tag in tags:
        if tag not in MESH_AFTER and tag not in chained:
            futures.update(start(tag))
    one = {}
    reset_launches()
    # the one-rank runs that wait for a bus, then those that wait for their
    # ranks' records, last
    for tag in sorted(tags, key=lambda t: (replayed(t), t in MESH_AFTER)):
        if tag not in futures:  # the bus of MESH_AFTER[tag]'s ranks
            after = MESH_AFTER[tag]
            futures[after][0].result()
            bus = os.path.join(_arg(flags(after, "ranks"), "--emb_dir"),
                               f"{ml}_cold_item_MF_emb.npz")
            waiting = [t for t in tags if MESH_AFTER.get(t) == after
                       and t not in futures]
            for t in waiting:  # under its split's name: the ids are one
                ds = splits[MESH_RUNS[t][1]][1]
                for who in ("ranks", "one"):
                    out = _arg(flags(t, who), "--emb_dir")
                    os.makedirs(out, exist_ok=True)
                    shutil.copy(bus, os.path.join(
                        out, f"{ds}_cold_item_MF_emb.npz"))
            for t in waiting:
                if t not in chained:
                    futures.update(start(t))
        root, ds = splits[MESH_RUNS[tag][1]]
        events = os.path.join(root, f"events_one_{tag}.jsonl")
        os.environ["COLDREC_EVENT_LOG"] = events
        n, _, model, mesh = MESH_RUNS[tag]
        _, det, epoch_steps, proto, _ = rank_flags(mesh)
        replay = contextlib.nullcontext({})
        if replayed(tag):
            futures[tag][0].result()
            replay = mesh_replay(model[1], [_record(os.path.join(
                root, f"events_mesh_{tag}.jsonl.rank{r}.record.npz"),
                model[1]) for r in range(n)],
                int(_arg(mesh, "--mesh").split("x")[1]))
        t = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()), \
                deterministic(det), proto_on(proto), replay as ties:
            one[tag] = tmain.run(make_args(flags(tag, "one")),
                                 data=read_split(root, ds),
                                 epoch_steps=epoch_steps)
        one[tag]["ties"] = ties
        event_log().close()
        one[tag]["losses"] = [x for e in read_events(events)
                              if e["event"] == "epoch" for x in e["losses"]]
        log(f"  ({tag}) one rank: {time.perf_counter() - t:.2f} s")
    one_launches = launch_counts()["fused_sweep"]
    lines = {tag: fut.result()[i] for tag, (fut, i) in futures.items()}
    for tag in tags:
        n, _, model, _ = MESH_RUNS[tag]
        argv = flags(tag, "ranks")
        root, ds = _arg(argv, "--data_dir"), _arg(argv, "--dataset")
        ranks_out = _arg(argv, "--emb_dir")
        one_out = _arg(flags(tag, "one"), "--emb_dir")
        if _result_blocks(ranks_out + ".txt") != 1:
            raise AssertionError(f"({tag}): the ranks wrote "
                                 f"{_result_blocks(ranks_out + '.txt')} "
                                 "result blocks, rank 0 alone should")
        name = model[1]
        held = MESH_HELD_STEPS.get(tag)
        events = os.path.join(root, f"events_mesh_{tag}.jsonl")
        tied = tie_note(name, one[tag]["ties"], model)
        bus = load_embeddings(ranks_out, ds, "item", name)
        ref = load_embeddings(one_out, ds, "item", name)
        losses = _rank_epochs(events, n)
        log(f"  ({tag}) rank 0's epoch:")
        log_epochs(read_events(f"{events}.rank0"))
        payload = _payload(ranks_out + ".txt")
        gap = metric_gap(payload["metrics"], one[tag]["metrics"])
        gaps = np.max([np.abs(np.subtract(x, one[tag]["losses"]))
                       / np.abs(one[tag]["losses"]) for x in losses], axis=0)
        loss_gap = float(gaps.max())
        if loss_gap:  # the largest gap up to each of these steps
            log(f"  ({tag}) losses' relative gap up to step " + ", ".join(
                f"{k}: {gaps[:k].max():.2e}" for k in (1, 10, 20, 50, 100,
                                                        len(gaps))
                if k <= len(gaps)))
        table_gap = max(float(np.abs(bus[k] - ref[k]).max())
                        for k in ("user_emb", "item_emb"))
        bn = {x.get("bn_sha256") for x in lines[tag]}
        if len(bn) != 1:
            raise AssertionError(f"({tag}) the ranks' BatchNorm running "
                                 f"statistics differ: {bn}")
        if tag in MESH_BIT_EQUAL:  # the model axis alone: bit-equal
            if loss_gap or table_gap or gap:
                raise AssertionError(
                    f"({tag}) {name} 1x2 vs one rank: losses {loss_gap}, "
                    f"tables {table_gap}, metrics {gap}; bit-equal expected")
            lists = "bit-equal tables"
            held = len(gaps)
        else:
            held = len(gaps) if held is None else held
            if gaps[:held].max() > MESH_LOSS_RTOL:
                raise AssertionError(f"({tag}) losses part from one rank's "
                                     f"by {gaps[:held].max()} relative in "
                                     f"{held} steps")
            if tag in MESH_HELD_STEPS and (table_gap > MESH_TABLE_TOL
                                           or gap > MESH_DN_METRIC_TOL):
                raise AssertionError(f"({tag}) eval tables part from one "
                                     f"rank's by {table_gap}, test metrics "
                                     f"by {gap}")
            lists = "metrics within 1e-9"
            if gap > MESH_METRIC_TOL:
                data = ColdStartDataset.from_split_dir(root, ds, "item")
                tabs = [[torch.as_tensor(t[k], device=device)
                         for k in ("user_emb", "item_emb")]
                        for t in (bus, ref)]
                res = [three_way_test(data, *tb, topN=topN, backend="plain",
                                      device=device, verbose=False)
                       for tb in tabs]
                lists = {s: "/".join(map(str, compare_lists(
                    *tabs[1], data.eval_splits[SETTING_SPLITS[(s, "test")]]
                    .users, res[0][s]["rec"], res[1][s]["rec"])[::-1]))
                    for s in res[0]}
        log(f"  ({tag}) {n} ranks vs one: losses {loss_gap:.3e} relative "
            f"({len(losses[0])} steps), tables {table_gap:.3e}, metrics "
            f"{gap:.3e}; test lists: {lists}; seconds per epoch "
            + " (ranks) vs ".join(
                f"{p['efficiency']['seconds_per_completed_epoch_mean']:.3f}"
                for p in (payload, one[tag])) + " (one)"
            + ("; BatchNorm running statistics equal on every rank"
               if None not in bn else "") + tied
            + f"; losses held over {held} steps")
    kernel_eval = [x["launches"]["fused_sweep"] for tag in MESH_KERNEL_EVAL
                   if tag in lines for x in lines[tag]]
    if device.type == "cuda" and not all(v > 0 for v in kernel_eval):
        raise AssertionError("a rank's kernel eval left fused_sweep "
                             "unlaunched")
    return one_launches + sum(x["launches"]["fused_sweep"]
                              for ls in lines.values() for x in ls)


def tie_note(name, ties, model) -> str:
    """The log's account of the ties a replayed one-rank run took from its
    ranks ("" for another model)."""
    if name == "CGRC":
        return (f"; Ĝ: the ranks' top-k users (every rank's the same) "
                f"equal one rank's in {ties['calls']} evaluations but at "
                f"{sum(ties['where'])} cold items, {ties['ties']} users "
                f"swapped at ties (the ranks' side taken; gap "
                f"{ties['worst']:.2e} of the row's largest logit, limit "
                f"twice the drift, at least {2 * MESH_TIE_REL:.0e}); the "
                f"two runs' logits at the ranks' top-k {ties['drift']:.2e} "
                f"apart (limit {MESH_LOGIT_DRIFT:.0e})")
    if name in SIGNED_MODELS:
        per_step = int(_arg(model, "--layers")) * (2 if name == "SimGCL"
                                                   else 1)
        steps = sorted({i // per_step for i in ties["where"]})
        return (f"; perturbed elements of another sign than the ranks' "
                f"(ties, the ranks' side taken): {ties['ties']} in "
                f"{len(steps)} of {ties['calls'] // per_step} steps "
                f"{steps[:8]}, at most {ties['worst']:.2e} of the row's "
                f"largest |value| (limit {MESH_TIE_REL:.0e})")
    return ""


def _payload(path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.loads(f.read().split("--- JSON (machine-readable) ---",
                                         1)[1])


def metric_gap(a: dict, b: dict) -> float:
    """The largest difference of two result files' metric means."""
    return max(abs(a[tn][s][m]["mean"] - b[tn][s][m]["mean"])
               for tn in b for s in b[tn] for m in b[tn][s])


@contextlib.contextmanager
def deterministic(on: bool = True):
    """Deterministic algorithms (warnings only) inside the block."""
    was = torch.are_deterministic_algorithms_enabled()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        torch.use_deterministic_algorithms(on or was, warn_only=True)
        try:
            yield
        finally:
            torch.use_deterministic_algorithms(was)


def mesh_run(device, bx_root, ml_root, bx="bx_synth", ml="ml_synth", d=D,
             bs=4096, seed=0, topN=(10, 20), serve=MESH_SERVE):
    """Phase mesh: (a) serving and (b)-(v) training, their rank groups side
    by side in one pool. Returns the fused_sweep launches of the phase."""
    device = torch.device(device)
    if device.type == "cuda":  # the ranks share the card with this process
        torch.cuda.empty_cache()
    env = {**os.environ, "OMP_NUM_THREADS": "2"}
    with concurrent.futures.ThreadPoolExecutor(1 + len(MESH_RUNS)) as pool:
        served = mesh_serve(device, bx_root, bx, env, pool, d, seed, serve)
        trained = mesh_train(device, bx_root, ml_root, env, pool, bx, ml, d,
                             bs, seed, topN)
        served = served()
    return {"fused_sweep": served + trained}


def ubench_line(point, dtype) -> dict:
    """Phase ubench's sweep of one type for the ``kernels`` line: the
    kernel alone and its padded call, each with its bound, and the matmul
    ceiling."""
    f = point["forms"]
    return {"users": point["users"], "items": point["items"],
            "d": point["d"], "max_abs_err": point["max_abs_err"][dtype],
            **{f"{name}_{key}": f[f"{name}_{dtype}"][key]
               for name in ("kernel_raw", "kernel_padded", "mm_rowmax")
               for key in ("ms", "bound_ms")}}


def build_all():
    """The CUDA library and, on a thread beside it, the host library (the
    sampler and the PPR push); returns (BuildResult, (its path, its
    seconds))."""
    def host():
        t = time.perf_counter()
        return native.build(), time.perf_counter() - t

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        hosted = pool.submit(host)
        return kbuild.build(), hosted.result()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card; torch.cuda.is_available() "
              "is False", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = run_phase("device", smi_line)
    kind = torch.cuda.get_device_name(0)
    log(f"  {smi} | torch: {kind}, {torch.cuda.device_count()} card(s), "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    stack = contextlib.ExitStack()
    # phase scale's dataset, built on the host beside the phases before it
    scale_root = stack.enter_context(tempfile.TemporaryDirectory())
    scale_pool = stack.enter_context(concurrent.futures.ThreadPoolExecutor(
        1, thread_name_prefix="scale-build"))
    scale_built = scale_pool.submit(scale_build, scale_root)
    built, host = run_phase("build", build_all)
    scale_read = scale_pool.submit(scale_split, scale_root)
    log(f"  {built.path.name}: nvcc {built.seconds:.2f} s\n{built.ptxas}")
    log(f"  {host[0].name}: {host[1]:.2f} s")
    hmma = run_phase("sass", tensor_cores, built.path)
    CHECKS.start()

    errs = [
        run_phase("kernel-bx", kernel_vs_plain, device, 2048, BX[1]),
        run_phase("kernel-ml", kernel_ml, device),
    ]
    exact = run_phase("kernel-int", kernel_int, device)
    launches = run_phase("slice", slice_run, device, *BX)
    knn = run_phase("knn", knn_run, device)
    # phase train's split stays for phases serving and mesh
    root = bx_root = stack.enter_context(tempfile.TemporaryDirectory())
    run_phase("train", train_run, device, *BX, root=root,
              content_dim=BX_CONTENT)
    bf16_launches, _ = run_phase("cold", cold_run, device, root)
    content = run_phase("content", content_run, device, root)
    recon = run_phase("recon", recon_run, device, root)
    usim_launches, usim_trainer = run_phase("usim", usim_run, device,
                                            root)
    graph, _ = run_phase("graph", graph_run, device, root)
    graph_user = run_phase("graph-user", graph_user_run, device, root,
                           *BX)
    with tempfile.TemporaryDirectory() as root:
        run_phase("cold-signal", signal_run, device, root)
        graph_ml = run_phase("graph-ml", graph_ml_run, device, root)
    graph_launches = {name: sum(r[name] for runs in (graph, graph_user,
                                                     graph_ml)
                                for r in runs.values())
                      for name in ("fused_sweep", "merge_parts")}
    log(f"  graph phases: {graph_launches} launches (fused_sweep: graph "
        f"{sum(r['fused_sweep'] for r in graph.values())}, graph-user "
        f"{sum(r['fused_sweep'] for r in graph_user.values())}, graph-ml "
        f"{sum(r['fused_sweep'] for r in graph_ml.values())})")
    content_launches = {name: sum(r[name] for runs in (content, recon,
                                                       {"USIM": usim_launches})
                                  for r in runs.values())
                        for name in ("fused_sweep", "merge_parts")}
    log(f"  knn phase: {knn['launches']} launches; content, recon and usim "
        f"phases: {content_launches} launches (fused_sweep: content "
        f"{sum(r['fused_sweep'] for r in content.values())}, recon "
        f"{sum(r['fused_sweep'] for r in recon.values())}, usim "
        f"{usim_launches['fused_sweep']})")
    knn_sweeps_line = [{
        "shape": tag, "queries": r["queries"], "values": r["values"],
        "d": r["d"], "k": r["k"], "launches": r["launches"]["fused_sweep"],
        "max_abs_err": r["max_abs_err"],
        "ms": r["sweep_s"] * 1e3,
        "call_ms": r["kernel_s"] * 1e3, "plain_ms": r["plain_s"] * 1e3,
        "bound_ms": r["bound_s"] * 1e3, "bound_by": r["bound_by"],
        "library_ms": r["library_s"] * 1e3,
    } for tag, r in knn["shapes"].items()]
    variants = run_phase("variants", variants_run, device)
    run_phase("checks", CHECKS.join)
    _, usim_split_launches = run_phase("usim-split", usim_split_phase,
                                       usim_trainer)
    del usim_trainer
    bench_line, bench_launches = run_phase("bench", bench_run, device)
    mfstep_launches = run_phase("mfstep", mfstep_phase, device, scale_root,
                                built=scale_built, read=scale_read)
    with tempfile.TemporaryDirectory() as root:
        ml_data = run_phase("ml-split", ml_split, root)
        profile_launches = run_phase("profile", profile_run, device, root)
        fused_launches = run_phase("fused", fused_run, device, root, ml_data)
        search_launches = run_phase("search", search_run, device, root)
        run_phase("parse", parse_run, bx_root)
        scale_launches = run_phase("scale", scale_phase, device, scale_root,
                                   built=scale_built, read=scale_read)
        serving_launches = run_phase(
            "serving", serving_phase, device,
            os.path.join(bx_root, "emb", "bx_synth_cold_item_MF_emb.npz"))
        d256, _, ubench_launches = run_phase("ubench", ubench_phase, device)
        mesh_launches = run_phase("mesh", mesh_run, device, bx_root, root)
    stack.close()
    entry_launches = {name: usim_split_launches[name]
                      + bench_launches[name] + mfstep_launches[name]
                      + profile_launches[name]
                      + fused_launches[name] + search_launches[name]
                      + scale_launches[name] + serving_launches[name]
                      + ubench_launches[name]
                      for name in bench_launches}
    log(f"  usim-split, bench, mfstep, profile, fused, search, scale, "
        f"serving and ubench phases: {entry_launches} launches (usim-split "
        f"{usim_split_launches}, bench {bench_launches}, mfstep "
        f"{mfstep_launches}, profile {profile_launches}, fused "
        f"{fused_launches}, search {search_launches}, scale "
        f"{scale_launches}, serving {serving_launches}, ubench "
        f"{ubench_launches}); mesh phase fused_sweep "
        f"{mesh_launches['fused_sweep']}")
    t = run_phase("timing", time_sweep, device)
    t512 = time_sweep(device, n_users=SERVE_USERS)
    for n, r in ((2048, t), (SERVE_USERS, t512)):
        log(f"  sweep {n} x {BX[1]} d={D} [{smi}]: kernel {r['ms']:.3f} ms, "
            f"plain {r['plain_ms']:.3f} ms, library (matmul+topk) "
            f"{r['library_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms "
            f"({r['bound_by']}: {r['flops']:.3e} FLOP, {r['bytes']:.3e} B)")
    b16 = time_sweep_bf16(device)
    b16_512 = time_sweep_bf16(device, n_users=SERVE_USERS)
    for n, r in ((2048, b16), (SERVE_USERS, b16_512)):
        log(f"  bf16 sweep {n} x {BX[1]} d={D} [{smi}]: kernel "
            f"{r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, library "
            f"({r['library']} + topk({K + RATED_WIDTH})) "
            f"{r['library_ms']:.3f} ms; bound on the CUDA cores (fp32 FMA) "
            f"{r['fp32_fma_bound_ms']:.3f} ms, on the tensor cores "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']}: {r['flops']:.3e} "
            f"FLOP, {r['bytes']:.3e} B)")
    if hmma is None and not b16["ms"] < b16["fp32_fma_bound_ms"]:
        raise AssertionError(
            f"no SASS to show the bf16 sweep on the tensor cores, and its "
            f"{b16['ms']:.3f} ms is not below the FMA bound "
            f"{b16['fp32_fma_bound_ms']:.3f} ms")
    tm = time_merge(device)
    time_merge(device, n_users=2048, parts=2)
    tv = run_phase("timing-variants", time_variants, device,
                   ptxas=built.ptxas)

    kernels = [{
        "name": "fused_sweep",
        "route": "cuda",
        "source": "coldrec_tpu_torch/csrc/retrieval.cu",
        "replaces": "coldrec_tpu/ops/pallas/retrieval.py:63",
        "launches": (launches["fused_sweep"] + graph_launches["fused_sweep"]
                     + knn["launches"]["fused_sweep"]
                     + content_launches["fused_sweep"]
                     + entry_launches["fused_sweep"]
                     + mesh_launches["fused_sweep"]),
        "max_abs_err": max([e["max_abs_err"] for e in errs]
                           + [exact["fused_sweep"]]),
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": t["library_ms"],
        "knn_sweeps": knn_sweeps_line,
        "d256": ubench_line(d256, "fp32"),
    }, {
        "name": "fused_sweep_bf16",
        "route": "cuda",
        "source": "coldrec_tpu_torch/csrc/retrieval.cu",
        "replaces": "coldrec_tpu/ops/pallas/retrieval.py:281",
        "launches": (bf16_launches["fused_sweep_bf16"]
                     + entry_launches["fused_sweep_bf16"]),
        "max_abs_err": max(errs[1]["bf16_err"], exact["fused_sweep_bf16"]),
        **{k: b16[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                               "fp32_fma_bound_ms", "library_ms",
                               "library")},
        "ms_512": b16_512["ms"], "hmma": hmma,
        "d256": ubench_line(d256, "bf16"),
    }, {
        "name": "merge_parts",
        "route": "cuda",
        "source": "coldrec_tpu_torch/csrc/retrieval.cu",
        "replaces": "coldrec_tpu/ops/pallas/retrieval.py:63",
        "launches": (launches["merge_parts"] + graph_launches["merge_parts"]
                     + knn["launches"]["merge_parts"]
                     + content_launches["merge_parts"]
                     + entry_launches["merge_parts"]),
        "max_abs_err": max(errs[1]["merge_err"], exact["merge_parts"]),
        **{k: tm[k] for k in ("ms", "call_ms", "plain_ms", "bound_ms",
                              "bound_by", "library_ms")},
    }]
    for name, source, replaces in (
            ("dot_sweep", "exp_retrieval_kernels.cu",
             "tools/exp_retrieval_kernels.py:55"),
            ("stream_sweep", "exp_retrieval_kernels.cu",
             "tools/exp_retrieval_kernels.py:94"),
            ("multiacc_sweep", "exp_multiacc.cu", "tools/exp_multiacc.py:72"),
            ("skip_sweep", "exp_blockskip.cu", "tools/exp_blockskip.py:57")):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": f"coldrec_tpu_torch/csrc/{source}",
            "replaces": replaces,
            **variants[name],
            **tv[name],
        })
    log(f"total {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2:]))
    try:
        sys.exit(main())
    finally:
        CHECKS.close()
