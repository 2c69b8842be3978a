#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. the card's name and power limit, from nvidia-smi; the four Hopper
   kernels and the backward kernels of the LSTM cell, flash attention,
   WKV6 and the scan are built from their sources, one nvcc each (eight),
   started together, and nvcc's report (registers, shared memory, spills)
   of every kernel function is printed;
2. kernels: holds the Hopper LSTM-cell kernel against the plain PyTorch
   cell at GNMT's three cell shapes and a ragged one (fp32, rtol = atol =
   3e-5, as the JAX package's kernel test; h, c and the preactivations z
   it writes for the backward); times the kernel (and with z written),
   the plain cell and ``torch.lstm_cell`` (yardstick only), each as 50
   calls replayed from a CUDA graph (device time back to back, without
   the Python wrapper's cost, which the eager time per call beside it
   keeps);
2b. the LSTM backward kernel: held against the plain backward
   (``lstm_cell_bwd_plain``: dz, dxh, dc_prev) at the same four shapes
   (fp32, rtol = atol = 3e-5), a second call equal to the bit; timed as in
   2 with the plain backward and ``torch.lstm_cell``'s backward (its
   forward subtracted; the gradients of x, h and c; yardstick only)
   beside the bound;
2c. one layer at the main shape's widths over (B, S) = (16, 128), forward
   and backward through ``LSTMSequenceFunction``: 128 forward and 128
   backward launches, hs and the gradients of xs, w and b within 1e-4 of
   max |plain| against autograd through the plain cell on the card;
   ``torch.nn.LSTM`` (cuDNN) on the same weights beside it (yardstick
   only), eager times with the host's cost;
3. main path: ``run_reproduction("gnmt")`` at the paper's full GNMT width
   and depth, both tracks (wallclock and analytic), with the kernels'
   launch counts set to 0 just before and read just after; each (the
   cell's and its backward's) must equal the number of LSTM timesteps the
   timed steps run, which shows that the analytic track's counting pass
   ran the plain cell, and no plain backward may run on the card; prints
   Track A's time and speedup errors per method and machine config;
3b. the projection monitor: the main path's EpochLog and the SeqPoints
   selected from it fed to ``ProjectionMonitor``, whose Eq. 1 number must
   be the SeqPointSet's; prints its nearest-SeqPoint error beside the
   reproduction's SeqPoint error and the worst SL's residual;
4. parity at full width: one SL-32 batch's loss and LSTM-weight gradients
   with the kernels (17 x 32 forward and backward launches) against the
   plain cell under autograd (TF32 off for both);
4b. DS2 main path: ``run_reproduction("ds2")`` at the paper's DS2
   (``DS2Config()``: 161 frequency bins, 32 channels, 5 bi-GRU layers of
   800), both tracks over the plan's 23 unique SLs (192-1728 frames, 100
   iterations); DS2 has no Pallas kernel, so no kernel of the port may
   launch; it must profile the longest SL and keep the SeqPoint error
   within 2 %;
4c. DS2 parity at full width: one SL-256 batch's loss and the gradients of
   ``conv1``, ``gru.0`` and ``head`` on the card against the same weights
   on the CPU (fp32, TF32 off);
5. flash-attention kernel: holds the Hopper flash kernel against
   ``attention_ref`` in the models' (B, S, H, dh) layout, q, k and v cut
   from one wider projection so their strides are a model's, at
   starcoder2-3b's serving shapes (bf16 at S = 256, 544, 1536 and 2048,
   fp32 at 544), jamba's (bf16 at 1536), its training shapes (batch 8,
   bf16 at S = 16, 80, 144 and 256), ragged GQA shapes in bf16 and
   fp32, the JAX kernel test's non-causal shape and a causal Sq < Skv shape
   (tolerance 2e-3 in fp32, 2e-2 in bf16, as the JAX package's kernel
   test), whisper-medium's (bf16, head_dim 64, non-causal: the encoder
   over 1500 frames, cross-attention from 64 tokens and from 1 at
   decode), deepseek-v3's MLA prefill (head_dim 192: bf16 at S = 1536,
   fp32 at 256) and llava-next-34b's prompt of 2880 patches and 256
   tokens; each row says which path ran (tensor cores for bf16 at
   head_dim 64, 128 or 192, CUDA cores otherwise) and checks that path's
   launch count, and holds the rows' log-sum-exp that the kernel writes
   beside o (for the backward) to the plain version's within 5e-4;
   times the kernel and ``scaled_dot_product_attention`` (yardstick only)
   from CUDA graphs and the plain version eagerly, beside the card's bound;
5b. the flash backward kernel: held against the plain VJP
   (``flash_bwd_plain``) at the training shapes in bf16, batch 8 (the
   starcoder2-3b step at SL 144 and 2816, jamba's attention, deepseek-v3's
   MLA at head_dim 192, whisper-medium's encoder over 1500 frames, its
   decoder's self- and cross-attention) and in fp32 at head_dim 128 and
   192 (the parity runs' CUDA-core path): every gradient within 5e-4 of
   its max |plain| in fp32, 2e-2 in bf16, a second call equal to the bit,
   each path's counter moved by one a call; timed from CUDA graphs (eager
   beside it) with the grid, the plain VJP and
   SDPA's backward (its forward subtracted; yardstick only) beside the
   card's bound (8 dh operations a scored pair);
6. serving main path: starcoder2-3b at full width and depth in bf16 with
   random weights from seed 0, ``ServeEngine(batch_size=4, max_len=2048,
   sl_granularity=32)``, 16 requests served by ``run_to_completion`` and
   then by ``serve(policy=BucketAffinePolicy())``; the flash kernel's
   launch counts, set to 0 just before, must equal 30 x the prefills run,
   every one of them on the tensor-core path;
7. serving parity at full width in fp32 (TF32 off): one batch of 4 prompts
   padded to 544, prefill with the kernel against the plain attention path
   (last-position logits within a relative 1e-3) and the same greedy
   tokens over 8 decode steps;
8. WKV6 kernel: holds the Hopper WKV6 kernel against its plain version
   (``wkv6_plain``) at rwkv6-3b's serving shapes (B = 4, H = 40, dh = 64
   at S = 256, 544, 1536 and 2048), a decode step (S = 1 from a random
   state) and a ragged S = 100 with a state in: y and the final state
   within 5e-4 (fp32, the JAX package's kernel test's tolerance); times
   the kernel from CUDA graphs (eager time per call beside it) and the
   plain version beside the card's bound (no PyTorch call computes WKV6,
   so there is no library yardstick);
8b. WKV6 backward kernel: held against the plain version's VJP
   (``wkv6_bwd_plain``) at rwkv6-3b's training step (B = 8, S = 144, H =
   40, dh = 64) and at S = 4096 (batch 1), no state in, as training calls
   it: every gradient within 5e-4 of its max |plain|; timed from CUDA
   graphs (eager beside it) with the plain VJP beside the card's bound;
9. serving main path: rwkv6-3b at full width and depth in bf16, as in 6;
   the WKV6 kernel's launch count, set to 0 just before, must equal
   32 x (prefills + decode steps): every WKV, prefill and decode, runs it;
10. rwkv6-3b parity at full width in fp32 (TF32 off), as in 7, with every
   WKV on the kernel (32 x 9 launches) against the plain path (none);
11. selective-scan kernel: holds the Hopper mamba_scan kernel against its
   plain version (``mamba_scan_ref``) at jamba's serving shapes (B = 4,
   D = 8192, N = 16 at S = 256, 544, 1536 and 2048 in bf16, and at 1536
   in fp32, the parity run's type), a decode step (S = 1 from a random
   state) and a ragged S = 100 with a state in, the inputs as
   ``models/mamba.py`` hands them over (x, D and the projection that B and
   C are strided views of in the compute type; delta, A and the state in
   fp32): y and the final state within 1e-4 (both
   compute in fp32 from the same inputs; the JAX package's fp32 kernel
   tolerance); times the kernel from CUDA graphs (eager time per call
   beside it) and the plain version beside the card's bound (no PyTorch
   call computes the selective scan);
11b. the scan's backward kernel: held against the plain version's VJP
   (``mamba_scan_bwd_plain``) at jamba's training step (B = 8, S = 144,
   D = 8192, N = 16) and at S = 4096 (batch 1), x, B, C and D in bf16 as
   the model hands them over: every gradient within 5e-4 of its max
   |plain| (1e-2 in bf16); times as in 8b;
12. serving main path: jamba-v0.1-52b at full width and 16 of its 32
   layers (two of its four periods: its 51.6 B parameters do not fit one
   80 GB card in bf16) in bf16, as in 6; the scan kernel's launch count
   must equal 14 mamba layers x (prefills + decode steps) and the flash
   kernel's 2 attention layers x prefills, all on the tensor-core path;
13. jamba parity at full width and one period (8 layers, 13.3 B
   parameters, 53 GB in fp32) in fp32 (TF32 off), as in 7, with every scan
   on the kernel (7 x 9 launches) against the plain path (none);
13b. the rest of the zoo served at full width in bf16 through
   ``run_to_completion`` alone (the 16 requests of 6): mistral-nemo-12b
   and internlm2-20b at full depth, qwen2-72b at 36 of its 80 layers (1.76
   GB a layer and 5.0 GB of embedding and head in bf16), llava-next-34b at
   full depth and deepseek-v3-671b at 2 of its 61 layers (22.6 GB a layer
   with 256 + 1 experts, 3.7 GB of embedding and head) without its MTP
   head, which serving never runs; the flash kernel's launches must equal
   attention layers x prefills, every one on the path ``select_path``
   gives (tensor cores at MLA's head_dim 192 too);
13c. llava-next-34b's image-patch frontend: a prefill of 2880 patch
   embeddings and 256 tokens at batch 4 (60 flash launches at S = 3136),
   then 8 greedy decode steps on a cache built with ``init_cache(prefix=)``;
13d. whisper-medium at full width and depth (24 + 24 layers): a prefill of
   1500 frames and 64 tokens (72 flash launches) and 32 greedy decode
   steps (24 launches each, the cross-attention);
13e. deepseek-v3's loss with its MTP head, forward only, at 1 layer plus
   the MTP block (2 flash launches), every metric finite;
13f. fp32 parity as in 7 (TF32 off) for whisper-medium at full width and
   2 + 2 layers (1500 frames; 2 + 2 x 2 launches a prefill, 2 a decode
   step) and deepseek-v3 at full width and 1 layer (the CUDA-core path at
   head_dim 192);
14. training main path: ``Trainer`` trains starcoder2-3b at full width and
   depth in bf16 with fp32 moments (the reference RunConfig's dtypes;
   AdamW lr 3e-4 after a 10-step warmup, batch 8, ``lm_documents(256)``
   padded to 16s) for 40 steps, after one warmup step at lr 0; the flash
   kernel's launch counts, set to 0 just before, must be 30 x 40, all on
   the tensor-core path, and its backward kernel's as many, all on the
   tensor-core path too; every loss finite and the mean of the last 5
   under that of the first 5; prints the step time per padded SL, the
   peak memory and the run's SeqPoints; ``serve_http`` runs beside it and
   ``/metrics`` is scraped once after the first step: the
   ``train_step_time_s`` histogram must be in it;
15. training parity at full width and 2 layers in fp32 (TF32 off): three
   train steps (the first at lr 0) with the kernels (the forward's and
   the backward's CUDA-core paths, 2 x 3 launches each) and on the plain
   attention from the same weights and batches: losses,
   grad norms and the updated ``embed``, ``layers.0.mixer.wq`` and
   ``lm_head`` within 1e-4 of max |plain|;
16. the recovery drill on the tiny config of the reference's trainer tests
   (fp32, checkpoints under build/, removed after): a NaN loss rolls back
   once; a preemption resumed by a fresh Trainer gives the fault-free
   run's log, SeqPoints and losses (rtol 1e-5) under a fake clock; a
   corrupt newest checkpoint falls back one step; 2 microbatches give 1's
   losses, grad norms and update within 1e-4;
17. remat: starcoder2-3b at full width and depth, bf16 with fp32
   moments, batch 8: three train steps at SL 512 under each of ``remat``
   "none", "block" and "save_boundaries" from the same weights and
   batches (losses within 1e-3 of "none"'s; the forward runs again in the
   backward under both remat modes, so 2 x 30 flash launches a step, and
   30 of the backward kernel in every mode); peak memory and median step
   of each; then "block" at the longest SL up to 4096 that fits the card,
   tried from 4096 down in steps of 256 (an out-of-memory error there
   answers "does not fit");
17b. one training phase per kernel path of the zoo, each as 14 (bf16
   with fp32 moments, batch 8, ``lm_documents(256)`` padded to 16s, one
   warm-up step at lr 0 first): rwkv6-3b at full width and depth and
   jamba-v0.1-52b at one period (8 layers) with 4 of its 16 experts a MoE
   layer (top-2 kept; 4.84 B parameters) by ``Trainer`` for 20 steps,
   deepseek-v3-671b at 1 layer plus the MTP block with 16 of its 256
   experts (top-8 and the shared expert kept; 3.83 B) and whisper-medium
   at full width and depth (1500 random frames from a seeded generator)
   by ``build_train_step`` for 16 steps; each kernel's launch count, set
   to 0 just before, must be its layers x steps (32 WKV6 a step; 7 scan
   and 1 flash; 2 flash at head_dim 192, the layer and the MTP block; 72
   flash, 24 encoder + 24 decoder self + 24 cross), the flash kernel's
   all on the tensor cores, and the backward kernels' as many (32 WKV6
   backward a step; 7 scan and 1 flash backward; 2 and 72 flash backward,
   every one on the tensor cores); the losses must fall; prints the
   step time per padded SL, the peak memory, the log's SeqPoints and one step
   split into forward and backward;
17c. each one's fp32 training parity as in 15 (three steps, kernel
   against plain, within 1e-4; every gradient through the backward
   kernels, whose launches are counted as in 17b, flash's on the CUDA
   cores): rwkv6-3b
   at 2 layers, jamba at one period with 2 experts, deepseek at 1 layer
   with 8, whisper at 2 + 2 layers;
18. the DTensor path on a 1 x 1 ("data", "model") mesh (NCCL for the
   card, gloo for the CPU): starcoder2-3b at full width and depth in bf16
   with its parameters placed by ``param_specs``, a prefill of 4 x 1536
   against the plain model with the same weights (logits within 1e-3 of
   max |plain|, the same greedy tokens, 30 flash launches on the tensor
   cores); qwen2-moe-a2.7b's MoE layer at full width through
   ``_moe_forward_sharded`` against ``moe_forward`` (bf16, 1e-2), and
   through ``_moe_forward_full_ep`` on the card against the same on the
   CPU (fp32, 1 x 64 tokens, 1e-4).

19. the multi-pod dry run on fake tensors (``launch/dryrun.py``), in a
   subprocess of its own (``python3 chip_smoke.py dryrun OUT``: the dist
   phase owns this process's group), every cell on the card's path
   (``device="cuda"``, the kernels as the ops a fake trace
   follows): (a) compile mode on the 16 x 16 fake mesh for one cell of
   each cache and kernel family (starcoder2-3b train_4k, deepseek-v3-671b
   decode_32k, jamba-v0.1-52b long_500k, rwkv6-3b decode_32k and
   train_4k, whisper-medium prefill_32k; every one at full size), each
   "ok" with its seconds, per-device live bytes and fake kernel calls,
   the backward kernels' among them, equal to the count the
   configuration gives (``dryrun_expected_calls``); (b) roofline mode
   for starcoder2-3b train_4k with the reference's TPU_V5E terms and the
   H100's; the cells of (a) and (b) trace at once, each in a process of
   its own (``python -m repro_torch.launch.dryrun``), while (c) runs; (c) the
   trace against the card: starcoder2-3b at full width and depth, and
   rwkv6-3b at full width and 2 layers, bf16 with fp32 moments, batch 8 x
   SL 512, ``remat="block"``, one train step traced on a 1 x 1 fake mesh
   and then run for real on the same mesh: the traced peak within 10 % of
   ``torch.cuda.max_memory_allocated``, the traced operations equal to
   ``FlopCounterMode``'s on the real step, the traced kernel calls equal
   to the real launches (flash 2 x 30: the forward runs again in the
   backward, and 30 backward; WKV6 2 x 2 forward and 2 backward).

No phase's backward may run the plain flash VJP on the card: its count of
calls on CUDA tensors (``flash_bwd_plain``), outside 5b's comparisons,
must read 0 after every training phase and at the end; so must the plain
LSTM backward's (``lstm_cell_bwd_plain``) outside 2b's.

It prints one JSON line with both networks' reproduction numbers, one
with the serving numbers, one with the training numbers (remat's among
them), one with the distribution numbers, one with the dry run's, one
with the projection monitor's, the whole run's seconds, one JSON line
with the kernels' numbers and, last, the device.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import shutil
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import (  # noqa: E402
    SINGLE_POD,
    MeshConfig,
    OptimizerConfig,
    RunConfig,
    ShapeConfig,
    StepKind,
    get_model_config,
    get_shape,
    smoke_config,
)
from repro_torch.configs.base import BlockKind as BK  # noqa: E402
from repro_torch.core.profile import EpochLog  # noqa: E402
from repro_torch.core.reproduction import run_reproduction  # noqa: E402
from repro_torch.core.seqpoint import select_seqpoints  # noqa: E402
from repro_torch.data.batching import DataIterator  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    IWSLT_LIKE,
    lm_documents,
    sample_tokens,
)
from repro_torch.device import card_line  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as flash  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    ops as flash_ops,
)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref,
    attention_ref_lse,
)
from repro_torch.kernels.lstm_cell import kernel  # noqa: E402
from repro_torch.kernels.lstm_cell import ref as lstm_ref  # noqa: E402
from repro_torch.kernels.lstm_cell.ops import (  # noqa: E402
    lstm_sequence,
)
from repro_torch.kernels.lstm_cell.ref import (  # noqa: E402
    lstm_cell_bwd_plain,
    lstm_cell_fwd_plain,
    lstm_cell_ref,
)
from repro_torch.kernels.mamba_scan import kernel as mamba  # noqa: E402
from repro_torch.kernels.mamba_scan.ops import (  # noqa: E402
    mamba_scan_bwd_plain,
)
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref  # noqa: E402
from repro_torch.kernels.rwkv6_wkv import kernel as wkv6  # noqa: E402
from repro_torch.kernels.rwkv6_wkv.ops import (  # noqa: E402
    wkv6_bwd_plain,
    wkv6_plain,
)
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.models.rnn import (  # noqa: E402
    DS2,
    GNMT,
    DS2Config,
    GNMTConfig,
)
from repro_torch.models.transformer import BF16, Runtime  # noqa: E402
from repro_torch.dist import sharding as shard_rules  # noqa: E402
from repro_torch.dist.axes import placements, use_mesh  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.obs import ProjectionMonitor, serve_http, trace  # noqa: E402
from repro_torch.resilience import faults  # noqa: E402
from repro_torch.resilience.faults import FaultPlan  # noqa: E402
from repro_torch.resilience.recovery import RecoveryPolicy  # noqa: E402
from repro_torch.serve import Request, ServeEngine  # noqa: E402
from repro_torch.serve.sched import (  # noqa: E402
    BucketAffinePolicy,
    run_to_completion,
)
from repro_torch.train.optimizer import OptState  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    TrainState,
    assign_state,
    build_train_step,
    init_train_state,
)
from repro_torch.train.trainer import Trainer  # noqa: E402

TOL = 3e-5                    # kernel vs plain cell, rtol and atol
LOSS_RTOL = 1e-5              # GNMT loss, kernel vs plain cell
GRAD_REL = 1e-4               # max |dW_k - dW_p| / max |dW_p|
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12      # H100 SXM fp32 without tensor cores
# (name, B, D, H): the cell shapes of GNMT at its training batch, and a
# ragged one that fits no tile
CELL_SHAPES = [("enc_bi", 16, 1024, 512), ("enc_uni,dec1-7", 16, 1024, 1024),
               ("dec0", 16, 2048, 1024), ("ragged", 5, 77, 200)]
MAIN_SHAPE = "enc_uni,dec1-7"     # 14 of GNMT's 17 LSTM layers
SEQ_B, SEQ_S = 16, 128            # phase 2c: GNMT's batch, longest SL
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 on the tensor cores
DS2_LOSS_RTOL = 1e-4          # DS2 loss, card vs CPU
DS2_GRAD_REL = 1e-3           # max |dW_card - dW_cpu| / max |dW_cpu|
DS2_SL = 1728                 # the longest SL of the DS2 plan
# rtol, and atol where |o| reaches 1; below that atol scales down with
# max |o| (non-causal rows over 1500 keys average ~550 of them: |o| ~ 0.04)
FLASH_TOL = {torch.float32: 2e-3, torch.bfloat16: 2e-2}
# (name, B, Hq, Hkv, Sq, Skv, dh, causal, dtype): starcoder2-3b's prefill
# shapes at batch 4 (24 query heads, 2 KV heads, head_dim 128) at the
# widths the serving path runs (run_batch pads to 32s, serve() to log2
# buckets) and the parity width, jamba's (32 query, 8 KV heads), the
# training phase's (batch 8, SL padded to 16s: one below a tile, ragged
# ones, the longest), then shapes that pin the edge cases
FLASH_SHAPES = [
    ("serve S=256", 4, 24, 2, 256, 256, 128, True, torch.bfloat16),
    ("serve S=544", 4, 24, 2, 544, 544, 128, True, torch.bfloat16),
    ("serve S=1536", 4, 24, 2, 1536, 1536, 128, True, torch.bfloat16),
    ("serve S=2048", 4, 24, 2, 2048, 2048, 128, True, torch.bfloat16),
    ("jamba S=1536", 4, 32, 8, 1536, 1536, 128, True, torch.bfloat16),
    ("parity S=544 fp32", 4, 24, 2, 544, 544, 128, True, torch.float32),
    ("train S=16", 8, 24, 2, 16, 16, 128, True, torch.bfloat16),
    ("train S=80", 8, 24, 2, 80, 80, 128, True, torch.bfloat16),
    ("train S=144", 8, 24, 2, 144, 144, 128, True, torch.bfloat16),
    ("train S=256", 8, 24, 2, 256, 256, 128, True, torch.bfloat16),
    ("ragged GQA bf16", 3, 12, 1, 100, 100, 64, True, torch.bfloat16),
    ("ragged GQA", 3, 5, 1, 100, 100, 64, True, torch.float32),
    ("non-causal", 1, 4, 1, 128, 256, 128, False, torch.float32),
    ("causal Sq<Skv", 2, 2, 1, 128, 256, 128, True, torch.float32),
    # whisper-medium at batch 4 (16 heads of 64): the encoder over 1500
    # frames, the decoder's cross-attention at prefill (64 tokens) and at
    # decode; deepseek-v3's MLA prefill (128 heads, q and k 192 wide, v
    # padded to 192) at the serving width and in the parity run's type;
    # llava-next-34b's prompt of 2880 image patches and 256 tokens; every
    # served arch's own prefill shape is added by flash_shapes()
    ("whisper enc", 4, 16, 16, 1500, 1500, 64, False, torch.bfloat16),
    ("whisper cross", 4, 16, 16, 64, 1500, 64, False, torch.bfloat16),
    ("whisper cross decode", 4, 16, 16, 1, 1500, 64, False, torch.bfloat16),
    ("whisper dec self", 4, 16, 16, 64, 64, 64, True, torch.bfloat16),
    ("mla S=1536", 4, 128, 128, 1536, 1536, 192, True, torch.bfloat16),
    ("mla fp32 S=256", 1, 128, 128, 256, 256, 192, True, torch.float32),
    ("llava S=3136", 4, 56, 8, 3136, 3136, 128, True, torch.bfloat16),
]
FLASH_MAIN = "serve S=1536"       # every run_batch prefill of the main path
SERVE_ARCH = "starcoder2-3b"
LOGIT_REL = 1e-3              # max |kernel - plain| / max |plain| logits
WKV_TOL = 5e-4                # kernel vs plain, rtol and atol (y, state)
# (name, B, S, H, dh, state in): rwkv6-3b's WKV at batch 4 (40 heads of 64)
# at the widths the serving path runs, the parity width, a decode step and
# a ragged length
WKV_SHAPES = [
    ("serve S=256", 4, 256, 40, 64, False),
    ("serve S=544", 4, 544, 40, 64, False),
    ("serve S=1536", 4, 1536, 40, 64, False),
    ("serve S=2048", 4, 2048, 40, 64, False),
    ("decode S=1", 4, 1, 40, 64, True),
    ("ragged S=100", 4, 100, 40, 64, True),
]
WKV_MAIN = "serve S=1536"         # every run_batch prefill of the main path
# each backward gradient against the plain VJP's, of its max |plain|; 1e-2
# for gradients in bf16
BWD_TOL = 5e-4
BWD_TOL_BF16 = 1e-2
# the flash forward's lse against the plain version's, absolute (both in
# fp32 from the same inputs)
LSE_TOL = 5e-4
# the flash backward in bf16 against the plain VJP, of its max |plain|: as
# the forward's kernel test (P and dS are rounded to bf16 for their
# products, each gradient to bf16)
FLASH_BWD_TOL_BF16 = 2e-2
# (name, B, Hq, Hkv, Sq, Skv, dh, causal, dtype): the flash backward at the
# training phases' shapes, batch 8 and SL 144 (the first padded SL): the
# starcoder2-3b step (and at SL 2816, remat "block"'s longest before this
# kernel), jamba's attention, deepseek-v3's MLA at head_dim 192,
# whisper-medium's encoder over 1500 frames, its decoder's self- and
# cross-attention; and the fp32 parity runs' CUDA-core path at head_dim
# 128 and 192
FLASH_BWD_SHAPES = [
    ("train S=144", 8, 24, 2, 144, 144, 128, True, torch.bfloat16),
    ("train S=2816", 8, 24, 2, 2816, 2816, 128, True, torch.bfloat16),
    ("jamba S=144", 8, 32, 8, 144, 144, 128, True, torch.bfloat16),
    ("mla S=144", 8, 128, 128, 144, 144, 192, True, torch.bfloat16),
    ("whisper enc", 8, 16, 16, 1500, 1500, 64, False, torch.bfloat16),
    ("whisper dec self", 8, 16, 16, 144, 144, 64, True, torch.bfloat16),
    ("whisper cross", 8, 16, 16, 144, 1500, 64, False, torch.bfloat16),
    ("fp32 S=144", 8, 24, 2, 144, 144, 128, True, torch.float32),
    ("mla fp32 S=144", 8, 128, 128, 144, 144, 192, True, torch.float32),
]
FLASH_BWD_MAIN = "train S=144"    # the training main path's first SL
# (name, B, S, H, dh): the WKV6 backward at rwkv6-3b's training step (batch
# 8, SL 144: the training phase's first padded SL) and over one 4096-long
# sequence (the dry run's train_4k), no state in and no state cotangent,
# as the training path calls it
WKV_BWD_SHAPES = [
    ("train S=144", 8, 144, 40, 64),
    ("S=4096", 1, 4096, 40, 64),
]
WKV_BWD_MAIN = "train S=144"
WKV_DECODE = "decode S=1"         # every decode step
RWKV_ARCH = "rwkv6-3b"
MAMBA_TOL = 1e-4              # kernel vs plain, rtol and atol (y, state)
# the special-function units' exp rate: 16 per SM per clock (CUDA
# programming guide, compute capability 9.0) on 132 SMs at the H100 SXM's
# 1.98 GHz boost clock
SFU_EXP_PER_S = 16 * 132 * 1.98e9
# an exp2 computed on the FMA pipes instead: range reduction, a degree-5
# polynomial and the exponent insert, about 8 lane instructions; at the
# fp32 peak's 2 operations per lane instruction
EXP_POLY_PER_S = FP32_FLOPS_PER_S / 2 / 8
# (name, B, S, D, N, compute type, state in): jamba's scan at batch 4
# (d_inner 8192, d_state 16) at the widths the serving path runs, in the
# fp32 parity run's type, a decode step and a ragged length. The compute
# type is that of x, D and the projection that B and C are views of, as
# models/mamba.py hands them over; delta, A and the state are float32.
MAMBA_SHAPES = [
    ("serve S=256", 4, 256, 8192, 16, torch.bfloat16, False),
    ("serve S=544", 4, 544, 8192, 16, torch.bfloat16, False),
    ("serve S=1536", 4, 1536, 8192, 16, torch.bfloat16, False),
    ("serve S=2048", 4, 2048, 8192, 16, torch.bfloat16, False),
    ("parity S=1536 fp32", 4, 1536, 8192, 16, torch.float32, False),
    ("decode S=1", 4, 1, 8192, 16, torch.bfloat16, True),
    ("ragged S=100", 4, 100, 8192, 16, torch.bfloat16, True),
]
MAMBA_DT_RANK = 256           # jamba's x_proj: dt (d_model / 16), B, C
MAMBA_MAIN = "serve S=1536"       # every run_batch prefill of the main path
# (name, B, S, D, N, compute type): the scan's backward at jamba's
# training step (batch 8, SL 144) and over one 4096-long sequence, inputs
# as models/mamba.py hands them over, no state in or state cotangent
MAMBA_BWD_SHAPES = [
    ("train S=144", 8, 144, 8192, 16, torch.bfloat16),
    ("S=4096", 1, 4096, 8192, 16, torch.bfloat16),
]
MAMBA_BWD_MAIN = "train S=144"
MAMBA_DECODE = "decode S=1"       # every decode step
JAMBA_ARCH = "jamba-v0.1-52b"
JAMBA_LAYERS = 16             # two of four periods: 52.1 GB in bf16
JAMBA_PARITY_LAYERS = 8       # one period: 53.2 GB in fp32
TRAIN_ARCH = "starcoder2-3b"
TRAIN_STEPS = 40              # 30 attention layers x 40 = 1200 flash launches
TRAIN_BATCH = 8
TRAIN_MAX_SL = 256            # lm_documents(256), padded to 16s
TRAIN_PARITY_LAYERS = 2
TRAIN_REL = 1e-4              # kernel vs plain: losses, grad norms, leaves
TRAIN_PARITY_LEAVES = ("embed", "layers.0.mixer.wq", "lm_head")
RESUME_RTOL = 1e-5            # the drill's losses, as tests/test_system.py
# one training phase per kernel path of the zoo, bf16 with fp32 moments at
# ~12.5 B a parameter (starcoder2-3b's 56.5 GB peak): at most ~5 B
RWKV_TRAIN_STEPS = 20         # Trainer: 32 WKV6 launches a step
# rwkv6-3b in bf16 at lr 3e-4 spikes at step 14 (9.42 -> 13.40) and not in
# fp32; at 1e-4 its loss falls
RWKV_TRAIN_LR = 1e-4
JAMBA_TRAIN_LAYERS = 8        # one period: 7 mamba layers, 1 attention
JAMBA_TRAIN_EXPERTS = 4       # of 16 a MoE layer, top-2 kept: 4.84 B
JAMBA_TRAIN_STEPS = 20        # Trainer: 7 scan + 1 flash launches a step
DEEPSEEK_TRAIN_EXPERTS = 16   # of 256, top-8 and the shared expert kept
DEEPSEEK_TRAIN_STEPS = 16     # build_train_step: 2 flash launches a step
WHISPER_TRAIN_STEPS = 16      # build_train_step: 72 flash launches a step
# the fp32 parities hold ~16 B a parameter: jamba and deepseek keep the
# fewest experts their top-k allows
JAMBA_PARITY_EXPERTS = 2
DEEPSEEK_PARITY_EXPERTS = 8
# the rest of the zoo, served through run_to_completion at full width in
# bf16; depth cut where the weights would not leave room on an 80 GB card
# (bytes in bf16: qwen2-72b 1.76 GB a layer plus 5.0 GB of embedding and
# head; deepseek-v3 22.6 GB a layer, 256 + 1 experts, plus 3.7 GB)
ZOO_DEPTHS = [("mistral-nemo-12b", None), ("internlm2-20b", None),
              ("qwen2-72b", 36), ("llava-next-34b", None),
              ("deepseek-v3-671b", 2)]
LLAVA_ARCH = "llava-next-34b"
LLAVA_PATCHES = 2880          # anyres: 5 tiles x 576 patch tokens
LLAVA_TOKENS = 256
WHISPER_ARCH = "whisper-medium"
DEEPSEEK_ARCH = "deepseek-v3-671b"
DIST_WIDTH = 1536             # the serving mix's padded width, batch 4
DIST_REL = 1e-3               # DTensor vs plain logits, rel. to max |plain|
MOE_ARCH = "qwen2-moe-a2.7b"
MOE_REL = 1e-2                # sharded vs plain MoE (bf16), rel. to max |y|
MOE_EP_TOKENS = 64            # full-EP layer, card vs CPU, fp32
MOE_EP_REL = 1e-4             # full-EP card vs CPU, rel. to max |y|
REMAT_SL = 512                # all three remat modes fit at batch 8
REMAT_STEPS = 3
REMAT_LOSS_REL = 1e-3         # losses of the three modes, rel. to "none"
REMAT_MAX_SL = 4096           # the reference's train_4k


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """CUDA-event mean over ``iters`` eager calls: the device time when the
    device is the bottleneck, the host's cost per call when it is not."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def timed_ms(fn):
    """(fn(), its wall time in ms to a synchronized end): one call's
    result and time, for a call too long to repeat."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def time_ms_graph(fn, iters: int = 50, replays: int = 3) -> float:
    """CUDA-event mean per call over ``replays`` replays of a CUDA graph of
    ``iters`` calls: the device time of calls back to back, without the
    host's cost per call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (iters * replays)


def bound_ms(nbytes: float, flops: float):
    """(ms, what bounds it): bytes at the HBM rate or fp32 operations at
    peak, whichever takes longer."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def cell_bound_ms(b: int, k: int, h: int):
    """Least time for one cell: each input read once and each output
    written once at the HBM rate, or its fp32 operations at peak."""
    return bound_ms(4 * (b * k + k * h * 4 + h * 4 + b * h + 2 * b * h),
                    2 * b * k * 4 * h + b * 4 * h)


def cell_bwd_bound_ms(b: int, k: int, h: int):
    """Least time for one step's backward (``lstm_cell_bwd``): z, c, W, dh
    and dc read once and dz, dxh and dc_prev written once at the HBM rate,
    or dxh = dz W^T's fp32 operations at peak."""
    return bound_ms(4 * (b * h * 4 + 3 * b * h + k * h * 4 + b * h * 4
                         + b * k + b * h), 2 * b * k * 4 * h)


def ptxas_lines(report: str) -> list:
    """One line per kernel function of an nvcc ``-Xptxas -v`` report: its
    registers, barriers and shared memory, then its stack and spills."""
    out, name, spills = [], None, ""
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill" in line:
            spills = line.strip()
        elif "Used" in line and name is not None:
            out.append(f"{name}: {line.split(':', 1)[1].strip()}; {spills}")
            name, spills = None, ""
    return out


KERNEL_LIBS = ("lstm_cell", "lstm_cell_bwd", "flash_attention",
               "flash_attention_bwd", "wkv6", "wkv6_bwd", "mamba_scan",
               "mamba_scan_bwd")


def build_kernels() -> None:
    """One nvcc per kernel source, all started together; then nvcc's
    report of every kernel function built."""
    t0 = time.perf_counter()
    builds = (kernel.build, kernel.build_bwd, flash.build, flash.build_bwd,
              wkv6.build, wkv6.build_bwd, mamba.build, mamba.build_bwd)
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        for f in [pool.submit(b) for b in builds]:
            f.result()
    print(f"kernel builds ({', '.join(KERNEL_LIBS)} in parallel): "
          f"{time.perf_counter() - t0:.2f} s")
    for lib in KERNEL_LIBS:
        report = _build.REPORTS.get(lib)
        if report is None:
            print(f"ptxas {lib}: found built in build/, no report")
            continue
        for line in ptxas_lines(report):
            print(f"ptxas {lib}: {line}")


def torch_lstm_weights(w: torch.Tensor, bias: torch.Tensor, d: int):
    """(w_ih, w_hh, b_ih, b_hh) of ``torch.lstm_cell`` and ``nn.LSTM`` (the
    yardsticks) for the kernel layout's w (D+H, H, 4) and bias (H, 4):
    PyTorch's gate-blocked rows, the forget gate's +1 folded into b_ih."""
    h = w.shape[1]
    w_ih = w[:d].permute(2, 1, 0).reshape(4 * h, d).contiguous()
    w_hh = w[d:].permute(2, 1, 0).reshape(4 * h, h).contiguous()
    b_ih = (bias + torch.tensor([0.0, 1.0, 0.0, 0.0], device=w.device)
            ).T.reshape(4 * h).contiguous()
    return w_ih, w_hh, b_ih, torch.zeros_like(b_ih)


def cell_inputs(b: int, d: int, h: int, g: torch.Generator):
    """(xh, w, bias, c) of a cell at (B, D, H) on the card, from ``g``."""
    k = d + h
    return (torch.randn(b, k, device="cuda", generator=g),
            torch.randn(k, h, 4, device="cuda", generator=g) / math.sqrt(k),
            torch.randn(h, 4, device="cuda", generator=g) * 0.1,
            torch.randn(b, h, device="cuda", generator=g))


def lstm_bwd_inputs(b: int, d: int, h: int, g: torch.Generator):
    """(z, c, w, dh, dc, xh, bias) of a step's backward at (B, D, H): the
    backward's arguments (the plain forward's z at ``cell_inputs`` and
    random cotangents), then the forward's other inputs."""
    xh, w, bias, c = cell_inputs(b, d, h, g)
    dh, dc = (torch.randn(b, h, device="cuda", generator=g)
              for _ in range(2))
    return lstm_cell_fwd_plain(xh, w, bias, c)[2], c, w, dh, dc, xh, bias


def kernel_phase() -> dict:
    t0 = time.perf_counter()
    kernel.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s")
    g = torch.Generator(device="cuda").manual_seed(0)
    shapes = []
    for name, b, d, h in CELL_SHAPES:
        k = d + h
        xh, w, bias, c = cell_inputs(b, d, h, g)
        hk, ck = kernel.lstm_cell_fwd(xh, w, bias, c)
        torch.cuda.synchronize()
        hp, cp = lstm_cell_ref(xh, w, bias, c)
        err = max((hk - hp).abs().max().item(), (ck - cp).abs().max().item())
        if not (torch.allclose(hk, hp, rtol=TOL, atol=TOL)
                and torch.allclose(ck, cp, rtol=TOL, atol=TOL)):
            raise RuntimeError(f"lstm_cell kernel disagrees with the plain "
                               f"cell at {name} {(b, d, h)}: {err}")
        w_ih, w_hh, b_ih, b_hh = torch_lstm_weights(w, bias, d)
        x, hx = xh[:, :d].contiguous(), xh[:, d:].contiguous()
        hl, cl = torch.lstm_cell(x, (hx, c), w_ih, w_hh, b_ih, b_hh)
        lib_err = max((hl - hp).abs().max().item(),
                      (cl - cp).abs().max().item())
        bound, bound_by = cell_bound_ms(b, k, h)

        z = torch.empty(b, h, 4, device="cuda")
        kernel.lstm_cell_fwd(xh, w, bias, c, z_out=z)
        err = max(err, (z - lstm_cell_fwd_plain(xh, w, bias, c)[2])
                  .abs().max().item())

        def run():
            return kernel.lstm_cell_fwd(xh, w, bias, c)

        def run_z():
            return kernel.lstm_cell_fwd(xh, w, bias, c, z_out=z)

        def lib():
            return torch.lstm_cell(x, (hx, c), w_ih, w_hh, b_ih, b_hh)
        row = {
            "shape": name, "B": b, "D": d, "H": h, "max_abs_err": err,
            "ms": time_ms_graph(run), "z_ms": time_ms_graph(run_z),
            "plain_ms": time_ms_graph(lambda: lstm_cell_ref(xh, w, bias, c)),
            "library_ms": time_ms_graph(lib),
            "eager_ms": time_ms(run), "library_eager_ms": time_ms(lib),
            "library_max_abs_err": lib_err,
            "bound_ms": bound, "bound_by": bound_by,
        }
        print(f"lstm_cell {name} B={b} D={d} H={h}: max_abs_err {err:.3e} "
              f"(h, c and z) kernel {row['ms']:.4f} ms, with z written "
              f"{row['z_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
              f"torch.lstm_cell {row['library_ms']:.4f} ms (CUDA graphs); "
              f"eager per call: kernel {row['eager_ms']:.4f} ms, "
              f"torch.lstm_cell {row['library_eager_ms']:.4f} ms; "
              f"bound {bound:.4f} ms ({bound_by})")
        shapes.append(row)
    return {r["shape"]: r for r in shapes}


def seq_bound_ms(b: int, s: int, d: int, h: int) -> float:
    """Least time for one layer's forward and backward over ``s`` steps,
    the sum of its launches' bounds (a step waits for the one before):
    ``s`` forward cells writing z, ``s`` backward cells reading the
    layer's own share of dh, and one dW = XH^T dZ with db over the s * b
    rows."""
    k = d + h
    fwd = bound_ms(4 * (b * k + k * h * 4 + h * 4 + 3 * b * h + b * h * 4),
                   2 * b * k * 4 * h + b * 4 * h)[0]
    bwd = cell_bwd_bound_ms(b, k, h)[0] + 1e3 * 4 * b * h / HBM_BYTES_PER_S
    dw = bound_ms(4 * (s * b * k + s * b * h * 4 + k * h * 4 + h * 4),
                  2 * s * b * k * 4 * h + s * b * 4 * h)[0]
    return s * (fwd + bwd) + dw


def lstm_cell_bwd_library_ms(xh, w, bias, c, d, dh, dc) -> float:
    """``torch.lstm_cell``'s backward for the same function (the gradients
    of x, h and c, not of the weights; a yardstick the port never calls):
    the eager time of its forward and backward under autograd less that
    of its forward."""
    w_ih, w_hh, b_ih, b_hh = torch_lstm_weights(w, bias, d)
    x, hx, cx = (t.detach().contiguous().requires_grad_()
                 for t in (xh[:, :d], xh[:, d:], c))

    def fwd():
        with torch.no_grad():
            return torch.lstm_cell(x, (hx, cx), w_ih, w_hh, b_ih, b_hh)

    def both():
        out = torch.lstm_cell(x, (hx, cx), w_ih, w_hh, b_ih, b_hh)
        return torch.autograd.grad(out, (x, hx, cx), (dh, dc))
    return (time_ms(both, iters=20, warmup=3)
            - time_ms(fwd, iters=20, warmup=3))


def lstm_bwd_phase() -> dict:
    """2b: the LSTM backward kernel against ``lstm_cell_bwd_plain`` at
    ``CELL_SHAPES`` (fp32, rtol = atol = ``TOL``), two calls equal to the
    bit, the launch counter moved by one a call; timed from CUDA graphs
    (eager beside) with the plain version, ``torch.lstm_cell``'s backward
    (yardstick) and the bound; then the sequence row. The plain version's
    calls here are comparisons: its count on CUDA tensors is restored
    after."""
    g = torch.Generator(device="cuda").manual_seed(3)
    plain_before = lstm_ref.plain_cuda_calls
    rows = {}
    for name, b, d, h in CELL_SHAPES:
        k = d + h
        z, c, w, dh, dc, xh, bias = lstm_bwd_inputs(b, d, h, g)
        before = kernel.bwd_launches
        got = kernel.lstm_cell_bwd(z, c, w, dh, dc)
        again = kernel.lstm_cell_bwd(z, c, w, dh, dc)
        torch.cuda.synchronize()
        if kernel.bwd_launches - before != 2 \
                or not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise RuntimeError(f"lstm_cell backward {name}: two calls moved "
                               f"the counter by {kernel.bwd_launches - before}"
                               f" or differ")
        want = lstm_cell_bwd_plain(z, c, w, dh, dc)
        err = max((x - y).abs().max().item() for x, y in zip(got, want))
        if not all(torch.allclose(x, y, rtol=TOL, atol=TOL)
                   for x, y in zip(got, want)):
            raise RuntimeError(f"lstm_cell backward kernel disagrees with "
                               f"the plain backward at {name} {(b, d, h)}: "
                               f"{err}")
        bound, bound_by = cell_bwd_bound_ms(b, k, h)

        def run():
            return kernel.lstm_cell_bwd(z, c, w, dh, dc)
        row = {
            "shape": name, "B": b, "D": d, "H": h, "max_abs_err": err,
            "deterministic": True, "ms": time_ms_graph(run),
            "eager_ms": time_ms(run),
            "plain_ms": time_ms_graph(
                lambda: lstm_cell_bwd_plain(z, c, w, dh, dc)),
            "library_ms": lstm_cell_bwd_library_ms(xh, w, bias, c, d, dh,
                                                   dc),
            "library_note": "torch.lstm_cell's backward under autograd "
                            "(gradients of x, h and c), its forward "
                            "subtracted; eager",
            "bound_ms": bound, "bound_by": bound_by}
        print(f"lstm_cell backward {name} B={b} D={d} H={h}: max_abs_err "
              f"{err:.3e} (dz, dxh, dc_prev; tol {TOL}), two calls equal to "
              f"the bit; kernel {row['ms']:.4f} ms (graph; eager "
              f"{row['eager_ms']:.4f}), plain {row['plain_ms']:.4f} ms, "
              f"torch.lstm_cell backward {row['library_ms']:.4f} ms "
              f"(eager, its forward subtracted), bound {bound:.4f} ms "
              f"({bound_by})")
        rows[name] = row
    lstm_ref.plain_cuda_calls = plain_before
    return rows


def lstm_seq_phase() -> dict:
    """2c: one layer at ``MAIN_SHAPE``'s widths over (B, S) = (``SEQ_B``,
    ``SEQ_S``), forward and backward through ``LSTMSequenceFunction``
    (one cell and one backward launch a step): hs and the gradients of
    xs, w and b within ``GRAD_REL`` of max |plain| against autograd
    through the plain cell on the card; ``torch.nn.LSTM`` (cuDNN, the same
    weights, the +1 in b_ih; a yardstick) beside, its gaps printed. Eager
    times with the host's cost, the forward alone beside the whole."""
    _, _, d, h = next(r for r in CELL_SHAPES if r[0] == MAIN_SHAPE)
    b, s, k = SEQ_B, SEQ_S, d + h
    g = torch.Generator(device="cuda").manual_seed(4)
    xs = torch.randn(b, s, d, device="cuda", generator=g).requires_grad_()
    w = (torch.randn(k, h, 4, device="cuda", generator=g)
         / math.sqrt(k)).requires_grad_()
    bias = (torch.randn(h, 4, device="cuda", generator=g)
            * 0.1).requires_grad_()
    gy = torch.randn(b, s, h, device="cuda", generator=g)
    zeros = torch.zeros(b, h, device="cuda")

    def forward(use_kernel=True):
        return lstm_sequence(xs, zeros, zeros, w, bias,
                             use_kernel=use_kernel)

    def port(use_kernel=True):
        hs = forward(use_kernel)
        return (hs, *torch.autograd.grad(hs, (xs, w, bias), gy))

    before = (kernel.launches, kernel.bwd_launches)
    got = port()
    torch.cuda.synchronize()
    moved = (kernel.launches - before[0], kernel.bwd_launches - before[1])
    want = port(False)

    def rel(x, y):
        return ((x - y).abs().max() / y.abs().max()).item()
    gaps = [rel(x, y) for x, y in zip(got, want)]

    lstm = torch.nn.LSTM(d, h, batch_first=True, device="cuda")
    with torch.no_grad():
        for p, t in zip((lstm.weight_ih_l0, lstm.weight_hh_l0,
                         lstm.bias_ih_l0, lstm.bias_hh_l0),
                        torch_lstm_weights(w.detach(), bias.detach(), d)):
            p.copy_(t)
    xl = xs.detach().clone().requires_grad_()

    def lib():
        out, _ = lstm(xl)
        return (out, *torch.autograd.grad(
            out, (xl, lstm.weight_ih_l0, lstm.weight_hh_l0, lstm.bias_ih_l0,
                  lstm.bias_hh_l0), gy))
    lo = lib()
    lib_w = torch.cat([lo[2].reshape(4, h, d).permute(2, 1, 0),
                       lo[3].reshape(4, h, h).permute(2, 1, 0)])
    lib_gaps = [rel(x, y) for x, y in zip(
        (lo[0], lo[1], lib_w, lo[4].reshape(4, h).T), want)]
    row = {"shape": f"sequence B={b} S={s} D={d} H={h}", "B": b, "S": s,
           "D": d, "H": h, "launches": list(moved),
           "rel_err": dict(zip(("hs", "dxs", "dw", "db"), gaps)),
           "library_rel_err": dict(zip(("hs", "dxs", "dw", "db"), lib_gaps)),
           "ms": time_ms(port, iters=5, warmup=1),
           "forward_ms": time_ms(forward, iters=5, warmup=1),
           "plain_ms": time_ms(lambda: port(False), iters=2, warmup=1),
           "library_ms": time_ms(lib, iters=5, warmup=1),
           "library_forward_ms": time_ms(lambda: lstm(xl), iters=5,
                                         warmup=1),
           "bound_ms": seq_bound_ms(b, s, d, h)}
    print(f"lstm sequence B={b} S={s} D={d} H={h}, forward and backward: "
          f"launches {moved[0]} forward / {moved[1]} backward (expected "
          f"{s} / {s}); max|port - plain| / max|plain|: " + ", ".join(
              f"{n} {v:.2e}" for n, v in row["rel_err"].items())
          + f" (tol {GRAD_REL}); nn.LSTM (cuDNN) against plain: "
          + ", ".join(f"{n} {v:.2e}" for n, v in
                      row["library_rel_err"].items())
          + f"; port {row['ms']:.3f} ms (forward {row['forward_ms']:.3f}), "
          f"plain {row['plain_ms']:.3f} ms, nn.LSTM {row['library_ms']:.3f}"
          f" ms (forward {row['library_forward_ms']:.3f}), eager; bound "
          f"{row['bound_ms']:.3f} ms (the sum of its launches')")
    if moved != (s, s) or not all(v <= GRAD_REL for v in gaps):
        raise RuntimeError(f"lstm sequence: launches {moved}, gaps {gaps}")
    return row


def print_track_a(res: dict) -> None:
    """Track A: each method's time error per machine config (geomean
    beside) and its speedup error against config1."""
    a = res["analytic"]
    print(f"  Track A (counted FLOPs and bytes, no-overlap model): config1 "
          f"epoch {a['actual_seconds']['config1']:.4f} s; per-SL FLOPs "
          + ", ".join(f"{int(sl)}: {st['flops']:.3e}" for sl, st in
                      sorted(a["per_sl_stats"].items(),
                             key=lambda kv: int(kv[0]))[::6]))
    for name, m in a["methods"].items():
        pc = m["per_config"]
        print(f"  Track A {name:9s}: {m['num_points']:2d} points, geomean "
              f"time error {m['geomean_time_error_pct']:.3f} %; "
              + " ".join(f"c{c[-1]}: {v['time_error_pct']:.2f} % / "
                         f"{v['speedup_error_pp']:.2f} pp"
                         for c, v in pc.items()))


def main_path_phase() -> int:
    cfg = GNMTConfig()
    zero_counts(kernel)
    t0 = time.perf_counter()
    res = run_reproduction("gnmt", device="cuda", model_config=cfg,
                           force=True, tag="_chip_smoke")
    wall = time.perf_counter() - t0
    launches, bwd = kernel.launches, kernel.bwd_launches
    layers = 2 + cfg.num_enc_uni + cfg.num_dec
    expected = (1 + 3) * layers * sum(res["unique_sls"])  # warmup + repeats
    print(f"main path: run_reproduction('gnmt') at GNMTConfig() "
          f"(d_model={cfg.d_model}, vocab={cfg.vocab_size}, 1 bi + "
          f"{cfg.num_enc_uni} uni encoder, {cfg.num_dec} decoder) on "
          f"{res['device']}: {res['num_iterations']} iterations, "
          f"{res['num_unique_sls']} unique SLs, {wall:.1f} s")
    for sl, t in sorted(res["wallclock"]["runtime_by_sl"].items(),
                        key=lambda kv: int(kv[0])):
        print(f"  step SL {int(sl):4d}: {1e3 * t:9.2f} ms")
    w = res["wallclock"]
    for name, m in w["methods"].items():
        print(f"  {name:9s}: {m['num_points']:3d} points, "
              f"error {m['error_pct']:.3f} %")
    sp = w["methods"]["seqpoint"]
    print(f"  epoch {w['total_epoch_seconds']:.3f} s; profiling "
          f"{w['profiling']['full_seconds']:.1f} s full vs "
          f"{w['profiling']['seqpoint_seconds']:.1f} s at SeqPoints")
    print_track_a(res)
    print(f"  lstm_cell launches: {launches} (expected {expected}); "
          f"backward launches: {bwd} (expected {expected}); "
          f"lstm_cell_bwd_plain on CUDA tensors: {lstm_ref.plain_cuda_calls}"
          f" (expected 0)")
    if launches != expected or bwd != expected \
            or lstm_ref.plain_cuda_calls:
        raise RuntimeError(f"main path launched the LSTM kernels {launches} "
                           f"and {bwd} times, expected {expected} each; "
                           f"plain backward {lstm_ref.plain_cuda_calls}")
    times = list(w["runtime_by_sl"].values())
    if res["num_unique_sls"] < 4 or max(res["unique_sls"]) != 128:
        raise RuntimeError("main path profiled fewer than 4 SLs or not the "
                           "longest (128)")
    if not (all(math.isfinite(t) and t > 0 for t in times)
            and math.isfinite(sp["error_pct"])):
        raise RuntimeError(f"non-finite step time or SeqPoint error: {sp}")
    return launches, bwd, res


KERNEL_MODULES = {"lstm_cell": kernel, "flash_attention": flash,
                  "wkv6": wkv6, "mamba_scan": mamba}


def ds2_phase() -> dict:
    """The paper's DS2 through both tracks; it has no kernel, so every
    launch count must stay 0."""
    cfg = DS2Config()
    for kern in KERNEL_MODULES.values():
        zero_counts(kern)
    t0 = time.perf_counter()
    res = run_reproduction("ds2", device="cuda", model_config=cfg,
                           force=True, tag="_chip_smoke")
    wall = time.perf_counter() - t0
    launched = {n: k.launches for n, k in KERNEL_MODULES.items()} \
        | {"lstm_cell_bwd": kernel.bwd_launches}
    print(f"DS2 path: run_reproduction('ds2') at DS2Config() (num_freq="
          f"{cfg.num_freq}, {cfg.conv_channels} channels, {cfg.num_gru} "
          f"bi-GRU of {cfg.d_h}, vocab {cfg.vocab_size}) on {res['device']}: "
          f"{res['num_iterations']} iterations, {res['num_unique_sls']} "
          f"unique SLs, {wall:.1f} s")
    w = res["wallclock"]
    for sl, t in sorted(w["runtime_by_sl"].items(),
                        key=lambda kv: int(kv[0])):
        print(f"  step SL {int(sl):4d}: {1e3 * t:9.2f} ms")
    for name, m in w["methods"].items():
        print(f"  {name:9s}: {m['num_points']:3d} points, "
              f"error {m['error_pct']:.3f} %")
    sp = w["methods"]["seqpoint"]
    prof = res["analytic"]["per_sl_stats"]
    print(f"  epoch {w['total_epoch_seconds']:.3f} s; profiling "
          f"{w['profiling']['full_seconds']:.1f} s full vs "
          f"{w['profiling']['seqpoint_seconds']:.1f} s at SeqPoints "
          f"({w['profiling']['iterations_full']} iterations vs "
          f"{w['profiling']['iterations_seqpoint']})")
    print_track_a(res)
    print(f"  kernel launches on the DS2 path: {launched} (expected all 0: "
          f"DS2 has no Pallas kernel)")
    times = list(w["runtime_by_sl"].values())
    if any(launched.values()):
        raise RuntimeError(f"the DS2 path launched a kernel: {launched}")
    if res["num_unique_sls"] < 4 or max(res["unique_sls"]) != DS2_SL \
            or len(prof) != res["num_unique_sls"]:
        raise RuntimeError(f"DS2 profiled fewer than 4 SLs or not the "
                           f"longest ({DS2_SL})")
    if not (all(math.isfinite(t) and t > 0 for t in times)
            and sp["error_pct"] <= 2.0):
        raise RuntimeError(f"DS2: non-finite step time or SeqPoint error "
                           f"above 2 %: {sp}")
    return res


def ds2_parity_phase() -> None:
    """DS2 at full width, SL 256, batch 8: the card against the same
    weights on the CPU, both fp32 with TF32 off."""
    cfg = DS2Config()
    card = DS2(cfg, seed=0, device="cuda")
    host = DS2(cfg, seed=0, device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    names = [n for n, _ in card.named_parameters()
             if n in ("conv1", "head") or n.startswith("gru.0.")]

    def run(model):
        params = dict(model.named_parameters())
        loss, _ = model.loss(model.make_batch(256, 8, 256))
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        return loss.item(), [g.cpu() for g in grads]

    t0 = time.perf_counter()
    loss_c, grads_c = run(card)
    loss_h, grads_h = run(host)
    rel = abs(loss_c - loss_h) / abs(loss_h)
    print(f"DS2 parity at full width, SL 256: loss card {loss_c:.7f} cpu "
          f"{loss_h:.7f} (rel {rel:.2e}, tol {DS2_LOSS_RTOL}); "
          f"{time.perf_counter() - t0:.1f} s")
    if not (math.isfinite(loss_c) and rel <= DS2_LOSS_RTOL):
        raise RuntimeError("DS2 loss on the card disagrees with the CPU")
    for n, g_card, g_host in zip(names, grads_c, grads_h):
        gr = ((g_card - g_host).abs().max() / g_host.abs().max()).item()
        print(f"  grad {n} {tuple(g_card.shape)}: max|diff|/max|cpu| "
              f"{gr:.2e} (tol {DS2_GRAD_REL})")
        if not gr <= DS2_GRAD_REL:
            raise RuntimeError(f"DS2 gradient of {n} on the card disagrees "
                               f"with the CPU")
    del card, host
    gc.collect()
    torch.cuda.empty_cache()


def parity_phase() -> None:
    model = GNMT(GNMTConfig(), seed=0, device="cuda")
    batch = model.make_batch(32, 16, 32, 32)
    # enc_bi_f.w too, so that every layer's backward runs
    names = ["enc_bi_f.w", "enc_bi_b.w", "enc_uni.3.w", "dec.0.w", "dec.7.w"]
    params = dict(model.named_parameters())

    def run(use_kernel: bool):
        model.use_kernel = use_kernel
        before = (kernel.launches, kernel.bwd_launches,
                  lstm_ref.plain_cuda_calls)
        loss, _ = model.loss(batch)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        return loss.item(), grads, tuple(
            a - b for a, b in zip((kernel.launches, kernel.bwd_launches,
                                   lstm_ref.plain_cuda_calls), before))

    loss_k, grads_k, moved_k = run(True)
    loss_p, grads_p, moved_p = run(False)
    model.use_kernel = True
    rel = abs(loss_k - loss_p) / abs(loss_p)
    steps = 32 * (2 + model.cfg.num_enc_uni + model.cfg.num_dec)
    print(f"parity at full width, SL 32: loss kernel {loss_k:.7f} plain "
          f"{loss_p:.7f} (rel {rel:.2e}, tol {LOSS_RTOL}); lstm_cell "
          f"launches {moved_k[0]} (expected {steps}) / plain {moved_p[0]}, "
          f"backward {moved_k[1]} (expected {steps}) / plain {moved_p[1]}, "
          f"lstm_cell_bwd_plain on CUDA tensors {moved_k[2] + moved_p[2]}")
    if not (math.isfinite(loss_k) and rel <= LOSS_RTOL) \
            or moved_k != (steps, steps, 0) or moved_p != (0, 0, 0):
        raise RuntimeError(f"GNMT loss with the kernel disagrees or the "
                           f"launches are off: {moved_k}, {moved_p}")
    for n, gk, gp in zip(names, grads_k, grads_p):
        gr = ((gk - gp).abs().max() / gp.abs().max()).item()
        print(f"  grad {n} {tuple(gk.shape)}: max|diff|/max|plain| "
              f"{gr:.2e} (tol {GRAD_REL})")
        if not gr <= GRAD_REL:
            raise RuntimeError(f"gradient of {n} with the kernel disagrees")


def flash_pairs(sq: int, skv: int, causal: bool) -> int:
    """(query, key) pairs the function scores: key j <= query i, counted
    from 0 on both sides, when causal."""
    if not causal:
        return sq * skv
    return sum(min(i + 1, skv) for i in range(sq))


def flash_bound_ms(bh, bhkv, sq, skv, dh, causal, dtype):
    """Least time for one call: q, k, v read and o written once at the HBM
    rate, or 4 * BH * dh * pairs operations at the peak for the type."""
    size = torch.finfo(dtype).bits // 8
    nbytes = size * dh * (2 * bh * sq + 2 * bhkv * skv)
    flops = 4 * bh * dh * flash_pairs(sq, skv, causal)
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def fold(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, dh) -> (B * H, S, dh), contiguous: attention_ref's layout."""
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def flash_inputs(b, hq, hkv, sq, skv, dh, dt, g):
    """q (B, Sq, Hq, dh) and k, v (B, Skv, Hkv, dh) cut from wider
    projections, as a fused qkv projection would give them: the head
    dimension contiguous, the sequence stride wider than the heads."""
    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=g).to(dt)
    qp = randn(b, sq, (hq + 2 * hkv) * dh)
    kvp = qp if sq == skv else randn(b, skv, (hq + 2 * hkv) * dh)
    q = qp[..., :hq * dh].unflatten(-1, (hq, dh))
    k = kvp[..., hq * dh:(hq + hkv) * dh].unflatten(-1, (hkv, dh))
    v = kvp[..., (hq + hkv) * dh:].unflatten(-1, (hkv, dh))
    return q, k, v


def flash_phase() -> dict:
    """The flash kernel against attention_ref at every listed shape, in the
    models' layout; times beside the bound and the library call (not used
    by the port)."""
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, b, hq, hkv, sq, skv, dh, causal, dt in flash_shapes():
        q, k, v = flash_inputs(b, hq, hkv, sq, skv, dh, dt, g)
        path = flash.select_path(dt, dh)
        before = (flash.launches_tc, flash.launches_simt)
        out, lse = flash.flash_attention_fwd(q, k, v, causal)
        torch.cuda.synchronize()
        moved = (flash.launches_tc - before[0],
                 flash.launches_simt - before[1])
        if moved != ((1, 0) if path == "tc" else (0, 1)):
            raise RuntimeError(f"flash {name}: the {path} path was chosen "
                               f"but the counters moved by {moved}")
        ref, ref_lse = attention_ref_lse(fold(q), fold(k), fold(v), causal)
        ref = ref.unflatten(0, (b, hq)).transpose(1, 2)
        err = (out.float() - ref.float()).abs().max().item()
        lse_err = (lse - ref_lse.view(b, hq, sq)).abs().max().item()
        ref_max = ref.float().abs().max().item()
        tol = FLASH_TOL[dt]
        atol = tol * min(1.0, ref_max)
        if not torch.allclose(out.float(), ref.float(), rtol=tol, atol=atol):
            raise RuntimeError(f"flash kernel disagrees with attention_ref "
                               f"at {name}: max abs err {err} (atol {atol}, "
                               f"max |ref| {ref_max})")
        if not lse_err <= LSE_TOL:
            raise RuntimeError(f"flash kernel's lse disagrees with the plain "
                               f"version's at {name}: max abs err {lse_err}")
        # yardstick: one library call on the same inputs, as (B, H, S, dh)
        # views; its is_causal is top-left too, but it is only timed where
        # its mask is the same function for sure
        lib_ms = lib_err = None
        if not causal or sq == skv:
            qs, ks, vs = (t.transpose(1, 2) for t in (q, k, v))

            def lib():
                return F.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=causal, enable_gqa=True)
            lib_err = (lib().transpose(1, 2).float()
                       - ref.float()).abs().max().item()
            lib_ms = time_ms_graph(lib, iters=20)
        bound, bound_by = flash_bound_ms(b * hq, b * hkv, sq, skv, dh,
                                         causal, dt)
        folded = [fold(t) for t in (q, k, v)]
        row = {
            "shape": name, "B": b, "Hq": hq, "Hkv": hkv, "Sq": sq,
            "Skv": skv, "dh": dh, "causal": causal,
            "dtype": str(dt).split(".")[-1], "path": path,
            "max_abs_err": err, "tol": tol, "atol": atol,
            "ref_max_abs": ref_max, "lse_max_abs_err": lse_err,
            "ms": time_ms_graph(
                lambda: flash.flash_attention_fwd(q, k, v, causal), iters=20),
            "eager_ms": time_ms(
                lambda: flash.flash_attention_fwd(q, k, v, causal), iters=20,
                warmup=3),
            "plain_ms": time_ms(lambda: attention_ref(*folded, causal),
                                iters=20, warmup=3),
            "library_ms": lib_ms, "library_max_abs_err": lib_err,
            "bound_ms": bound, "bound_by": bound_by,
        }
        lib_txt = "n/a" if lib_ms is None else f"{lib_ms:.4f} ms"
        print(f"flash_attention {name} q {tuple(q.shape)} kv "
              f"{tuple(k.shape)} strides {q.stride()} / {k.stride()} "
              f"{row['dtype']} causal={causal}, {path} path: max_abs_err "
              f"{err:.3e} (rtol {tol}, atol {atol:.2e}; max |ref| "
              f"{ref_max:.3f}), lse {lse_err:.2e} (atol {LSE_TOL}) kernel "
              f"{row['ms']:.4f} ms (eager "
              f"{row['eager_ms']:.4f}), plain {row['plain_ms']:.4f} ms, sdpa "
              f"{lib_txt}, bound {bound:.4f} ms ({bound_by})")
        rows[name] = row
        del q, k, v, out, lse, ref, ref_lse, folded
    return rows


def flash_bwd_bound_ms(bh, bhkv, sq, skv, dh, causal, dtype):
    """Least time for one backward call, the larger of two: q, k, v, o,
    dO (and lse in fp32) read and dq, dk, dv written once at the HBM rate;
    and what the function needs at the peak for the type, 8 * BH * dh
    operations a scored pair (dV = P^T dO, dP = dO V^T, dQ = dS K, dK =
    dS^T Q). That is not the kernel's own count (``flash_bwd_flops``: it
    forms S too, and on the CUDA cores S and dP twice). Returns (ms, what
    bounds it, bytes, operations)."""
    size = torch.finfo(dtype).bits // 8
    nbytes = size * dh * (4 * bh * sq + 4 * bhkv * skv) + 4 * bh * sq
    flops = 8 * bh * dh * flash_pairs(sq, skv, causal)
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else FP32_FLOPS_PER_S
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def sdpa_bwd_ms(q, k, v, g, causal):
    """SDPA's backward on the same inputs (the yardstick: the port never
    calls it): the eager time of its forward and backward under autograd
    less that of its forward, as (B, H, S, dh) views, GQA by
    ``enable_gqa``; None where none of its backends takes the shape."""
    qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    gs = g.transpose(1, 2)

    def fwd():
        with torch.no_grad():
            return F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=causal, enable_gqa=True)

    def both():
        out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal,
                                             enable_gqa=True)
        return torch.autograd.grad(out, (qs, ks, vs), gs)
    try:
        both()
    except RuntimeError as e:
        return None, str(e).splitlines()[0][:120]
    return (time_ms(both, iters=10, warmup=2)
            - time_ms(fwd, iters=10, warmup=2)), None


def flash_bwd_grid(b, hq, hkv, sq, skv, dh, path) -> str:
    """The backward's blocks at a shape, as phase 5b prints them: on the
    tensor cores one kernel of (key tile, b, KV head, part of the GQA
    group) blocks; on the CUDA cores a dK/dV and a dQ kernel."""
    if path != "tc":
        return (f"blocks {b * hkv * -(-skv // 32)} dK/dV + "
                f"{b * hq * -(-sq // 32)} dQ")
    bk, bq = flash.TC_BWD_TILES[dh]
    parts = flash.bwd_parts(b, hq, hkv, sq, skv, dh)
    return (f"blocks {-(-skv // bk) * b * hkv * parts} ({bk}-key tiles x "
            f"{b * hkv} (b, KV head) x {parts} part(s) of group "
            f"{hq // hkv}; {bq}-row query steps)")


def flash_bwd_phase() -> dict:
    """5b: the backward kernel against the plain VJP (``flash_bwd_plain``)
    at the training shapes, every gradient within ``BWD_TOL`` (fp32) or
    ``FLASH_BWD_TOL_BF16`` of its max |plain|, and a second call equal to
    the bit (the kernel is deterministic); each row's path counter moves by
    one a call; times from CUDA graphs (eager beside), the plain VJP's
    eager time and SDPA's backward beside the bound, and the grid. The
    plain VJP's calls here are comparisons: its count on CUDA tensors is
    restored after."""
    g = torch.Generator(device="cuda").manual_seed(2)
    plain_before = flash_ops.plain_cuda_calls
    rows = {}
    for name, b, hq, hkv, sq, skv, dh, causal, dt in FLASH_BWD_SHAPES:
        q, k, v = flash_inputs(b, hq, hkv, sq, skv, dh, dt, g)
        o, lse = flash.flash_attention_fwd(q, k, v, causal)
        gy = torch.randn((b, sq, hq, dh), device="cuda", generator=g).to(dt)
        path = flash.select_path(dt, dh)
        before = (flash.bwd_launches_tc, flash.bwd_launches_simt)
        got = flash.flash_attention_bwd(q, k, v, o, lse, gy, causal)[:3]
        again = flash.flash_attention_bwd(q, k, v, o, lse, gy, causal)[:3]
        torch.cuda.synchronize()
        moved = (flash.bwd_launches_tc - before[0],
                 flash.bwd_launches_simt - before[1])
        if moved != ((2, 0) if path == "tc" else (0, 2)):
            raise RuntimeError(f"flash backward {name}: the {path} path was "
                               f"chosen but two calls moved the counters by "
                               f"{moved}")
        same = [torch.equal(x, y) for x, y in zip(got, again)]
        if not all(same):
            raise RuntimeError(f"flash backward {name}: two calls differ "
                               f"(dq, dk, dv equal: {same})")
        want, plain_ms = timed_ms(
            lambda: flash_ops.flash_bwd_plain(q, k, v, gy, causal))
        gaps = [(e, r, FLASH_BWD_TOL_BF16 if dt == torch.bfloat16 else t)
                for e, r, t in grad_gaps(got, want)]
        del got, again, want
        lib_ms, lib_note = sdpa_bwd_ms(q, k, v, gy, causal)
        row = bwd_row("flash_attention", name, lambda: flash.
                      flash_attention_bwd(q, k, v, o, lse, gy, causal),
                      lambda: flash_ops.flash_bwd_plain(q, k, v, gy, causal),
                      gaps, flash_bwd_bound_ms(
                          b * hq, b * hkv, sq, skv, dh, causal, dt),
                      iters=10 if sq * skv < 2 ** 20 else 5,
                      plain_first_ms=plain_ms)
        grid = flash_bwd_grid(b, hq, hkv, sq, skv, dh, path)
        row.update(B=b, Hq=hq, Hkv=hkv, Sq=sq, Skv=skv, dh=dh, causal=causal,
                   dtype=str(dt).split(".")[-1], path=path,
                   library_ms=lib_ms, library_note=lib_note,
                   deterministic=True, grid=grid)
        lib_txt = (f"{lib_ms:.4f} ms" if lib_ms is not None
                   else f"not run ({lib_note})")
        print(f"flash_attention backward {name} q {tuple(q.shape)} kv "
              f"{tuple(k.shape)} {row['dtype']} causal={causal}, {path} "
              f"path: max rel err {row['max_rel_err']:.3e} of max |plain| "
              f"(tol {gaps[0][2]}; abs {row['max_abs_err']:.3e}; dq dk dv), "
              f"two calls equal to the bit; kernel {row['ms']:.4f} ms "
              f"(graph; eager {row['eager_ms']:.4f}), {grid}, plain VJP "
              f"{row['plain_ms']:.2f} ms, sdpa backward {lib_txt}, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}: "
              f"{row['bound_bytes'] / 1e6:.1f} MB, "
              f"{row['bound_flops'] / 1e9:.3f} GFLOP)")
        rows[name] = row
        del q, k, v, o, lse, gy
        gc.collect()
        torch.cuda.empty_cache()
    flash_ops.plain_cuda_calls = plain_before
    return rows


def serve_requests(vocab: int) -> list:
    """16 requests from RandomState(0): every 4th prompt 1536 tokens, the
    rest in [64, 512]; max_new_tokens in [16, 64]."""
    rng = np.random.RandomState(0)
    reqs = []
    for i in range(16):
        sl = 1536 if i % 4 == 0 else int(rng.randint(64, 513))
        reqs.append(Request(
            prompt=rng.randint(1, vocab, size=sl).astype(np.int32),
            max_new_tokens=int(rng.randint(16, 65))))
    return reqs


def _spans(name: str) -> list:
    return [e for e in trace.get_tracer().events if e["name"] == name]


def _describe(cfg) -> str:
    if cfg.mla is not None:
        m = cfg.mla
        heads = (f"{cfg.num_heads} MLA heads, qk {m.qk_nope_head_dim} + "
                 f"{m.qk_rope_head_dim}, v {m.v_head_dim}, kv_lora_rank "
                 f"{m.kv_lora_rank}")
    elif cfg.num_heads:
        heads = (f"{cfg.num_heads} query / {cfg.num_kv_heads} KV heads, "
                 f"head_dim {cfg.resolved_head_dim}")
    else:
        heads = (f"{cfg.d_model // cfg.rwkv_head_dim} rwkv heads of "
                 f"{cfg.rwkv_head_dim}")
    if cfg.mamba is not None:
        heads += (f", mamba d_inner {cfg.mamba.expand * cfg.d_model} "
                  f"d_state {cfg.mamba.d_state}")
    if cfg.moe is not None:
        heads += (f", {cfg.moe.num_experts} experts top-"
                  f"{cfg.moe.experts_per_token}")
        if cfg.moe.num_shared_experts:
            heads += f" + {cfg.moe.num_shared_experts} shared"
    if cfg.encoder is not None:
        heads += (f", {cfg.encoder.num_layers} encoder layers over "
                  f"{cfg.encoder.max_source_len} frames")
    return (f"{cfg.num_layers} layers, d_model {cfg.d_model}, {heads}, "
            f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}")


def _depth(cfg) -> str:
    full = get_model_config(cfg.name)
    cut = ""
    if full.mtp_depth and not cfg.mtp_depth:
        cut = " (no MTP head)"
    if cfg.num_layers == full.num_layers and cfg.encoder == full.encoder:
        return "full width and depth" + cut
    enc = ""
    if cfg.encoder is not None:
        enc = (f", {cfg.encoder.num_layers} of its "
               f"{full.encoder.num_layers} encoder layers")
    return (f"full width, {cfg.num_layers} of its {full.num_layers} "
            f"layers{enc}{cut}")


def attention_heads(cfg) -> tuple:
    """(query heads, KV heads, head_dim) as the flash kernel sees them in
    ``cfg``'s prefill: MLA expands k and v to every query head at its q
    and k width (v is padded to it)."""
    if cfg.mla is not None:
        return cfg.num_heads, cfg.num_heads, cfg.mla.qk_head_dim
    return cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim


def flash_shapes() -> list:
    """FLASH_SHAPES, then a row for each arch of ZOO_DEPTHS at its heads
    and head_dim, batch 4, S 1536 (the longest prompt its serving
    prefills), bf16, where FLASH_SHAPES holds no row of that shape."""
    rows = list(FLASH_SHAPES)
    for arch, _ in ZOO_DEPTHS:
        hq, hkv, dh = attention_heads(get_model_config(arch))
        shape = (4, hq, hkv, 1536, 1536, dh, True, torch.bfloat16)
        if all(r[1:] != shape for r in rows):
            rows.append((f"{arch} S=1536", *shape))
    return rows


def zero_counts(kern) -> None:
    """Set every launch count of a kernel module to 0 (flash attention
    keeps one per path beside its total, WKV6 and the scan one for their
    backward kernels)."""
    for attr in dir(kern):
        if attr.startswith(("launches", "bwd_launches")):
            setattr(kern, attr, 0)


def kernel_layers(cfg, kind) -> int:
    """How many of ``cfg``'s layers have mixer ``kind``."""
    period = cfg.pattern
    return sum(period[i % len(period)][0] == kind
               for i in range(cfg.num_layers))


def expected_launches(cfg, kind, per_decode: bool, decode_steps: int) -> int:
    """A kernel's launches over one prefill and ``decode_steps`` decode
    steps: once per layer of mixer ``kind`` in the prefill and, where
    ``per_decode``, in each step; the encoder-decoder's flash kernel runs
    in every encoder layer and twice in every decoder layer (self and
    cross) of a prefill, and in every cross-attention of a step."""
    if cfg.encoder is not None:
        return (cfg.encoder.num_layers + 2 * cfg.num_layers
                + decode_steps * cfg.num_layers)
    return kernel_layers(cfg, kind) * (1 + (decode_steps if per_decode
                                            else 0))


def serving_phase(cfg, kernels, sched: bool = True) -> dict:
    """``run_to_completion`` and, where ``sched``, ``serve()`` at full
    width in bf16. ``kernels`` lists (name, module, mixer kind,
    per_decode): each kernel must launch once per layer of that kind in
    every prefill and, where ``per_decode``, in every decode step too; the
    flash kernel's launches must all take the path that ``select_path``
    gives. The peak memory is the serving's, weights included (the
    build's float32 draws are not in it)."""
    arch = cfg.name
    t0 = time.perf_counter()
    model = build_model(cfg, BF16, device="cuda", seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"serving: {arch} at {_depth(cfg)} ({_describe(cfg)}), bf16, "
          f"{n_params / 1e9:.3f} B parameters "
          f"({torch.cuda.memory_allocated() / 1e9:.2f} GB), built in "
          f"{time.perf_counter() - t0:.1f} s")

    def engine():
        return ServeEngine(model, batch_size=4, max_len=2048,
                           sl_granularity=32)

    # warm up cuBLAS and the allocator outside the counted, timed run
    engine().run_batch([Request(prompt=np.arange(1, 65, dtype=np.int32),
                                max_new_tokens=2)])
    torch.cuda.synchronize()
    tracer = trace.get_tracer()
    tracer.clear()
    trace.enable_tracing(True)
    for _, kern, _, _ in kernels:
        zero_counts(kern)
    base_eng = engine()
    with trace.span("smoke/run_to_completion"):
        base = run_to_completion(base_eng, serve_requests(cfg.vocab_size))
    runs = [("run_to_completion", base_eng, base, "serve/prefill",
             "serve/decode_token")]

    def serve_run(eng):
        return ("serve", eng, eng.serve(serve_requests(cfg.vocab_size),
                                        policy=BucketAffinePolicy()),
                "serve/sched/prefill", "serve/sched/decode_token")
    if sched:
        runs.append(serve_run(engine()))
    launches = {name: kern.launches for name, kern, _, _ in kernels}
    flash_by_path = {"tc": flash.launches_tc, "simt": flash.launches_simt}
    trace.enable_tracing(False)

    prefills = len(_spans("serve/prefill")) + len(_spans(
        "serve/sched/prefill"))
    decodes = len(_spans("serve/decode_token")) + len(_spans(
        "serve/sched/decode_token"))
    out = {"arch": arch, "num_layers": cfg.num_layers,
           "params_b": n_params / 1e9, "kernels": {},
           "prefills": prefills, "decode_steps": decodes, "paths": {}}
    run_t0 = _spans("smoke/run_to_completion")[0]["ts"]
    for path, eng, stats, pre, dec in runs:
        by_sl = {}
        for e in _spans(pre):
            by_sl.setdefault(int(e["args"]["sl"]), []).append(e["dur"] / 1e3)
        dec_ms = [e["dur"] / 1e3 for e in _spans(dec)]
        if path == "run_to_completion":
            # every request is submitted at the start; a batch's first
            # tokens come with the end of its prefill
            ttft = [(e["ts"] + e["dur"] - run_t0) / 1e6
                    for e in _spans(pre) for _ in range(eng.batch_size)]
        else:
            ttft = [it.stats["ttft_s"] for it in eng.log.iterations
                    if math.isfinite(it.stats["ttft_s"])]
        summ = stats.summary()
        row = {
            "prefill_ms_by_padded_sl": {
                sl: sorted(v) for sl, v in sorted(by_sl.items())},
            "decode_ms_per_step_mean": float(np.mean(dec_ms)),
            "decode_ms_per_step_median": float(np.median(dec_ms)),
            "decode_steps": stats.decode_steps,
            "ttft_s_median": float(np.median(ttft)),
            "ttft_s_max": float(np.max(ttft)),
            "tokens_per_s": stats.throughput,
            **{k: summ[k] for k in ("tokens_out", "prefills", "n_finished",
                                    "n_curtailed", "padding_waste",
                                    "grid_throughput", "wall_s")},
        }
        out["paths"][path] = row
        print(f"  {path}: {row['prefills']} prefills, {row['decode_steps']} "
              f"decode steps, {row['tokens_out']} tokens in "
              f"{row['wall_s']:.3f} s ({row['tokens_per_s']:.1f} tokens/s), "
              f"{row['n_curtailed']} curtailed; padding_waste "
              f"{row['padding_waste']:.4f}, grid_throughput "
              f"{row['grid_throughput']:.5f}")
        for sl, v in row["prefill_ms_by_padded_sl"].items():
            print(f"    prefill at padded SL {sl:5d}: "
                  + ", ".join(f"{t:.2f}" for t in v) + " ms")
        print(f"    decode: {row['decode_ms_per_step_mean']:.3f} ms per step "
              f"mean, {row['decode_ms_per_step_median']:.3f} median (batch "
              f"{eng.batch_size}); TTFT median {row['ttft_s_median']:.3f} s, "
              f"max {row['ttft_s_max']:.3f} s")
        values = [row["decode_ms_per_step_mean"], row["ttft_s_max"],
                  row["tokens_per_s"], row["padding_waste"]] \
            + [t for v in by_sl.values() for t in v]
        if not all(math.isfinite(x) and x >= 0 for x in values) \
                or row["n_finished"] != 16 or row["tokens_out"] <= 0:
            raise RuntimeError(f"serving path {path} gave {row}")
    if sched:
        sp = runs[-1][1].seqpoints()
        out["seqpoints"] = {"num_points": sp.num_points,
                            "seq_lens": sp.seq_lens, "error": sp.error}
        print(f"  seqpoints() of the serve log: {sp.num_points} points at "
              f"padded SLs {sp.seq_lens}, error {100 * sp.error:.3f} %")
    n_pre = sum(stats.prefills for _, _, stats, _, _ in runs)
    n_dec = sum(stats.decode_steps for _, _, stats, _, _ in runs)
    if prefills != n_pre or decodes != n_dec:
        raise RuntimeError(f"serving spans count {prefills} prefills and "
                           f"{decodes} decode steps, the stats {n_pre} and "
                           f"{n_dec}")
    for name, kern, kind, per_decode in kernels:
        layers = kernel_layers(cfg, kind)
        expected = layers * (prefills + (decodes if per_decode else 0))
        work = (f"({prefills} prefills + {decodes} decode steps)"
                if per_decode else f"{prefills} prefills")
        print(f"  {name} launches: {launches[name]} (expected {expected} = "
              f"{layers} {kind.value} layers x {work})")
        out["kernels"][name] = {"launches": launches[name],
                                "expected": expected}
        if launches[name] != expected:
            raise RuntimeError(f"serving launched the {name} kernel "
                               f"{launches[name]} times over {prefills} "
                               f"prefills and {decodes} decode steps, "
                               f"expected {expected}")
        if kern is flash:
            # bf16: every launch on the path select_path gives
            path = flash.select_path(torch.bfloat16, attention_heads(cfg)[2])
            on_path = flash_by_path[path]
            print(f"  {name} launches on the {path} path: {on_path} of "
                  f"{launches[name]}")
            out["kernels"][name][f"launches_{path}"] = on_path
            if on_path != launches[name]:
                raise RuntimeError(f"serving ran {launches[name] - on_path} "
                                   f"flash launches off the {path} path")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"  peak memory {out['peak_gb']:.2f} GB of "
          f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.2f}; "
          f"phase {time.perf_counter() - t0:.1f} s")
    del model, runs, base_eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def serving_parity_phase(cfg, kernels) -> dict:
    """One batch of 4 prompts padded to 544, fp32 at full width: prefill
    with the kernels against the plain path, then 8 greedy decode steps
    from each (through a kernel too where its ``per_decode``). An
    encoder-decoder also takes its 1500 frames from the same seed."""
    arch = cfg.name
    t0 = time.perf_counter()
    model = build_model(cfg, Runtime(), device="cuda", seed=0)
    rng = np.random.RandomState(1)
    width, steps = 544, 8
    toks = np.zeros((4, width), np.int32)
    for i, sl in enumerate((544, 300, 411, 129)):
        toks[i, -sl:] = rng.randint(1, cfg.vocab_size, size=sl)
    batch = {"tokens": torch.as_tensor(toks, dtype=torch.long,
                                       device=model.device)}
    if cfg.encoder is not None:
        batch["frames"] = torch.as_tensor(
            rng.randn(4, cfg.encoder.max_source_len, cfg.d_model),
            dtype=torch.float32, device=model.device)
    runs = {}
    with torch.inference_mode():
        for use_kernel in (True, False):
            model.use_kernel = use_kernel
            before = {name: kern.launches for name, kern, _, _ in kernels}
            logits, pre = model.prefill(batch)
            cache = model.init_cache(4, width + steps, prefix=pre)
            tokens, _, cache = _greedy_decode(model, cache, logits, width,
                                              steps)
            runs[use_kernel] = (logits[:, -1].float(), tokens.tolist(), {
                name: kern.launches - before[name]
                for name, kern, _, _ in kernels})
    (lk, tk, nk), (lp, tp, npl) = runs[True], runs[False]
    rel = ((lk - lp).abs().max() / lp.abs().max()).item()
    want = {name: expected_launches(cfg, kind, per_decode, steps)
            for name, _, kind, per_decode in kernels}
    counts = "; ".join(f"{name} launches {nk[name]} (expected {want[name]}) "
                       f"/ plain {npl[name]}" for name in want)
    print(f"serving parity, {arch} at {_depth(cfg)}, fp32, width {width}: "
          f"last-position logits max|kernel - plain| / max|plain| {rel:.2e} "
          f"(tol {LOGIT_REL}); greedy tokens over {steps} decode steps "
          f"{'identical' if tk == tp else 'DIFFER'}; {counts}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    if not (math.isfinite(rel) and rel <= LOGIT_REL) or tk != tp \
            or nk != want or any(npl.values()):
        raise RuntimeError(f"serving parity failed: rel {rel}, tokens "
                           f"{tk} vs {tp}, launches {nk}/{npl}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return {"logit_rel": rel, "tokens": tk, "launches": nk}


def wkv6_bound_ms(b, s, h, dh, with_state):
    """Least time for one call: r, k, v, lw read and y written once (and
    the state read where given, written always) at the HBM rate, or the
    recurrence's 5 * dh^2 + 5 * dh fp32 operations per (b, h, t) at the
    fp32 peak. Returns (ms, what bounds it, bytes, operations)."""
    nbytes = 4 * (5 * b * s * h * dh + (1 + with_state) * b * h * dh * dh)
    flops = b * h * s * (5 * dh * dh + 5 * dh)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def wkv6_bwd_bound_ms(b, s, h, dh, with_state, with_gs):
    """Least time for one backward call, the larger of two: r, k, v, lw
    and gy read and dr, dk, dv and dlw written once, u read and du written
    (state0 read and dstate0 written where given, gs read where given) at
    the HBM rate; and the function's least arithmetic at the fp32 peak,
    per (b, h, t) one update of dL/dS (3 dh^2) with its products by v and
    k (4 dh^2), one update of S (3 dh^2) with its product by gy (2 dh^2),
    and 21 dh for the decays' exps, the bonus u's terms and dlw by the
    state-free identity. That is not the kernel's own count
    (``wkv6_bwd_flops``), which runs the chunked form's products in
    3xTF32 on the tensor cores. Returns (ms, what bounds it, bytes,
    operations)."""
    nbytes = 4 * (9 * b * s * h * dh + 2 * h * dh
                  + (2 * with_state + with_gs) * b * h * dh * dh)
    flops = b * h * s * (12 * dh * dh + 21 * dh)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def wkv6_inputs(b, s, h, dh, with_state, g):
    """(r, k, v, lw, u, state0) in float32 in the model's layouts, drawn
    as the JAX package's kernel test draws them: log-decays in [-1, 0)."""
    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=g)
    r, k, v = randn(b, s, h, dh), randn(b, s, h, dh), randn(b, s, h, dh)
    lw = -torch.exp(randn(b, s, h, dh).clamp(-8, 0))
    u = randn(h, dh)
    s0 = randn(b, h, dh, dh) if with_state else None
    return (r, k, v, lw, u, s0)


def wkv6_phase() -> dict:
    """The WKV6 kernel against its plain version at every listed shape,
    y and the final state; times beside the bound. No single PyTorch call
    computes the WKV6 recurrence, so there is no library time."""
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, b, s, h, dh, with_state in WKV_SHAPES:
        shape = (b, s, h, dh)
        args = wkv6_inputs(b, s, h, dh, with_state, g)
        y, st = wkv6.wkv6_fwd(*args)
        torch.cuda.synchronize()
        yp, sp = wkv6_plain(*args)
        err = max((y - yp).abs().max().item(), (st - sp).abs().max().item())
        if not (torch.allclose(y, yp, rtol=WKV_TOL, atol=WKV_TOL)
                and torch.allclose(st, sp, rtol=WKV_TOL, atol=WKV_TOL)):
            raise RuntimeError(f"wkv6 kernel disagrees with wkv6_plain at "
                               f"{name}: max abs err {err}")
        bound, bound_by, nbytes, flops = wkv6_bound_ms(b, s, h, dh,
                                                       with_state)
        row = {
            "shape": name, "B": b, "S": s, "H": h, "dh": dh,
            "state_in": with_state, "max_abs_err": err, "tol": WKV_TOL,
            "max_abs_y": yp.abs().max().item(),
            "ms": time_ms_graph(lambda: wkv6.wkv6_fwd(*args), iters=20),
            "eager_ms": time_ms(lambda: wkv6.wkv6_fwd(*args), iters=20,
                                warmup=3),
            "plain_ms": time_ms(lambda: wkv6_plain(*args), iters=3,
                                warmup=1),
            "library_ms": None, "bound_ms": bound, "bound_by": bound_by,
            "bound_bytes": nbytes, "bound_flops": flops,
        }
        print(f"wkv6 {name} (B, S, H, dh) = {shape}, state in "
              f"{with_state}: max_abs_err {err:.3e} (tol {WKV_TOL}, max "
              f"|y| {row['max_abs_y']:.1f}) kernel {row['ms']:.4f} ms (graph; "
              f"eager {row['eager_ms']:.4f}), plain "
              f"{row['plain_ms']:.4f} ms, bound {bound:.4f} ms ({bound_by}: "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP)")
        rows[name] = row
        del args, y, st, yp, sp
    return rows


def grad_gaps(got, want) -> list:
    """(max |got - want|, that over max |want|, the tolerance) for each
    gradient of a backward call against the plain VJP's (None where the
    plain one is); the tolerance is ``BWD_TOL`` of max |plain|,
    ``BWD_TOL_BF16`` for a gradient in bf16."""
    out = []
    for gk, gp in zip(got, want):
        if (gk is None) != (gp is None):
            raise RuntimeError("a backward kernel returned a gradient the "
                               "plain VJP has not, or missed one")
        if gp is None:
            continue
        if gk.dtype != gp.dtype or gk.shape != gp.shape:
            raise RuntimeError(f"backward gradient {gk.dtype} "
                               f"{tuple(gk.shape)}, plain {gp.dtype} "
                               f"{tuple(gp.shape)}")
        err = (gk.float() - gp.float()).abs().max().item()
        scale = gp.float().abs().max().item()
        tol = BWD_TOL_BF16 if gp.dtype == torch.bfloat16 else BWD_TOL
        out.append((err, err / scale if scale else
                    (0.0 if err == 0 else math.inf), tol))
    return out


def bwd_row(name, shape, call, plain, gaps, bound, iters, plain_first_ms):
    """A backward kernel's row: its gradients' gaps to the plain VJP (the
    call fails on any gap over its tolerance), its time from CUDA graphs
    and eager, the plain VJP's time (where ``iters`` is short, the
    comparison's own call, ``plain_first_ms``: a long plain VJP is timed
    once) and the bound (ms, what bounds it, bytes, operations)."""
    bad = [gp for gp in gaps if not gp[1] <= gp[2]]
    if bad:
        raise RuntimeError(f"{name} backward kernel disagrees with its plain "
                           f"VJP at {shape}: (abs, rel, tol) {gaps}")
    ms, bound_by, nbytes, flops = bound[:4]
    return {"shape": shape, "max_abs_err": max(gp[0] for gp in gaps),
            "max_rel_err": max(gp[1] for gp in gaps),
            "gaps": [list(gp) for gp in gaps],
            "ms": time_ms_graph(call, iters=iters),
            "eager_ms": time_ms(call, iters=iters, warmup=2),
            "plain_ms": (plain_first_ms if iters < 10
                         else time_ms(plain, iters=2, warmup=1)),
            "library_ms": None, "bound_ms": ms, "bound_by": bound_by,
            "bound_bytes": nbytes, "bound_flops": flops}


def wkv6_bwd_phase() -> dict:
    """The WKV6 backward kernel against the plain version's VJP
    (``wkv6_bwd_plain``) at the training shapes, every gradient; times
    beside the bound. No PyTorch call computes WKV6's gradient."""
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for name, b, s, h, dh in WKV_BWD_SHAPES:
        args = wkv6_inputs(b, s, h, dh, False, g)
        gy = torch.randn((b, s, h, dh), device="cuda", generator=g)
        got = wkv6.wkv6_bwd(*args, gy)[:6]
        want, plain_ms = timed_ms(lambda: wkv6_bwd_plain(*args, gy))
        gaps = grad_gaps(got, want)
        del got, want
        row = bwd_row("wkv6", name, lambda: wkv6.wkv6_bwd(*args, gy),
                      lambda: wkv6_bwd_plain(*args, gy), gaps,
                      wkv6_bwd_bound_ms(b, s, h, dh, False, False),
                      iters=20 if s < 1024 else 5, plain_first_ms=plain_ms)
        row.update(B=b, S=s, H=h, dh=dh)
        print(f"wkv6 backward {name} (B, S, H, dh) = {(b, s, h, dh)}, no "
              f"state: max rel err {row['max_rel_err']:.3e} of max |plain| "
              f"(tol {BWD_TOL}; abs {row['max_abs_err']:.3e}; dr dk dv dlw "
              f"du) kernel {row['ms']:.4f} ms (graph; eager "
              f"{row['eager_ms']:.4f}), plain VJP {row['plain_ms']:.2f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
              f"{row['bound_bytes'] / 1e6:.1f} MB, "
              f"{row['bound_flops'] / 1e9:.3f} GFLOP)")
        rows[name] = row
        del args, gy
    torch.cuda.empty_cache()
    return rows


def mamba_bound_ms(b, s, d, n, el_bytes, with_state):
    """Least time for one call, the larger of two: x and delta read and y
    written once (B, C, A and D read, the state read where given and
    written always; x, B, C and D of ``el_bytes`` each) at the HBM rate;
    and the operations, 6 fp32 operations
    per (b, t, d, n) and 3 per (b, t, d) on the FMA pipes and one exp per
    (b, t, d, n), the exps split between the special-function units and
    polynomials on the FMA pipes so that both finish together (the card
    can do both at once, so counting every exp at the SFU rate alone would
    overstate the least time). Returns (ms, what bounds it, bytes, fp32
    operations, exps, the operations' ms, the exps' ms on the SFUs
    alone)."""
    nbytes = b * s * d * (el_bytes + 8) + el_bytes * (2 * b * s * n + d) \
        + 4 * (d * n + (1 + with_state) * b * d * n)
    flops = b * s * d * (6 * n + 3)
    exps = b * s * d * n
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_fma = flops / FP32_FLOPS_PER_S
    # T with exps - T * SFU left to the FMA pipes after their fp32 work:
    # t_fma + (exps - T * SFU) / POLY = T
    t_split = (t_fma * EXP_POLY_PER_S + exps) / (EXP_POLY_PER_S
                                                   + SFU_EXP_PER_S)
    t_ops = max(t_fma, t_split)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops,
            exps, 1e3 * t_ops, 1e3 * exps / SFU_EXP_PER_S)


def mamba_bwd_bound_ms(b, s, d, n, el_bytes, with_state, with_gs):
    """Least time for one backward call, the larger of two: x, delta and
    gy read and dx and ddelta written once, B and C read and dB and dC
    written, A and D read and dA and dD written (state0 read and dstate0
    written where given, gs read where given; x, B, C, D and their
    gradients of ``el_bytes`` each) at the HBM rate; and the function's
    least arithmetic, one forward walk for h (4 fp32 operations and an
    exp per (b, t, d, n)) and one reverse walk (16 and an exp: the
    gradient's update, its products for dx, ddelta, dA, dB and dC, and
    e^(delta A) again), plus 8 per (b, t, d), its exps shared between the
    special-function units and polynomials on the FMA pipes as in
    ``mamba_bound_ms``. That is not the kernel's own count
    (``mamba_scan_bwd_flops``: 24 N and 3 N exps, and the sums among a
    channel's threads), which walks forward twice. Returns (ms, what
    bounds it, bytes, fp32 operations, exps)."""
    nbytes = b * s * d * (2 * el_bytes + 12) + 4 * el_bytes * b * s * n \
        + 8 * d * n + 2 * el_bytes * d \
        + 4 * b * d * n * (2 * with_state + with_gs)
    exps = 2 * b * s * d * n
    flops = b * s * d * (20 * n + 8)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_fma = flops / FP32_FLOPS_PER_S
    t_split = (t_fma * EXP_POLY_PER_S + exps) / (EXP_POLY_PER_S
                                                   + SFU_EXP_PER_S)
    t_ops = max(t_fma, t_split)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops,
            exps)


def mamba_inputs(b, s, d, n, dt, with_state, g):
    """(x, delta, A, B, C, D, state0) as models/mamba.py hands them to the
    scan, drawn as the JAX package's kernel test draws them: x, D and one
    (B, S, dt_rank + 2N) projection in the compute type ``dt``, with B and
    C strided views of the projection; delta, A and the state float32."""
    def randn(*shape):
        return torch.randn(shape, device="cuda", generator=g)
    x = randn(b, s, d).to(dt)
    delta = F.softplus(randn(b, s, d) - 2)
    a = -torch.exp(randn(d, n) * 0.3)
    proj = randn(b, s, MAMBA_DT_RANK + 2 * n).to(dt)
    bm = proj[..., MAMBA_DT_RANK:MAMBA_DT_RANK + n]
    cm = proj[..., MAMBA_DT_RANK + n:]
    dd = randn(d).to(dt)
    s0 = randn(b, d, n) if with_state else None
    return (x, delta, a, bm, cm, dd, s0)


def mamba_phase() -> dict:
    """The selective-scan kernel against its plain version at every listed
    shape, y and the final state; times beside the bound. No PyTorch call
    computes the selective scan, so there is no library time."""
    g = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for name, b, s, d, n, dt, with_state in MAMBA_SHAPES:
        args = mamba_inputs(b, s, d, n, dt, with_state, g)
        y, st = mamba.mamba_scan_fwd(*args)
        torch.cuda.synchronize()
        yp, sp = mamba_scan_ref(*args)
        err = max((y - yp).abs().max().item(), (st - sp).abs().max().item())
        if not (torch.allclose(y, yp, rtol=MAMBA_TOL, atol=MAMBA_TOL)
                and torch.allclose(st, sp, rtol=MAMBA_TOL, atol=MAMBA_TOL)):
            raise RuntimeError(f"mamba_scan kernel disagrees with "
                               f"mamba_scan_ref at {name}: max abs err {err}")
        bound, bound_by, nbytes, flops, exps, ops_ms, sfu_ms = \
            mamba_bound_ms(b, s, d, n, torch.finfo(dt).bits // 8,
                           with_state)
        row = {
            "shape": name, "B": b, "S": s, "D": d, "N": n,
            "dtype": str(dt).split(".")[-1], "state_in": with_state,
            "max_abs_err": err, "tol": MAMBA_TOL,
            "max_abs_y": yp.abs().max().item(),
            "ms": time_ms_graph(lambda: mamba.mamba_scan_fwd(*args),
                                iters=20),
            "eager_ms": time_ms(lambda: mamba.mamba_scan_fwd(*args),
                                iters=20, warmup=3),
            "plain_ms": time_ms(lambda: mamba_scan_ref(*args), iters=3,
                                warmup=1),
            "library_ms": None, "bound_ms": bound, "bound_by": bound_by,
            "bound_bytes": nbytes, "bound_flops": flops, "bound_exps": exps,
            "bytes_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
            "flops_ms": 1e3 * flops / FP32_FLOPS_PER_S, "ops_ms": ops_ms,
            "exps_sfu_only_ms": sfu_ms,
        }
        print(f"mamba_scan {name} (B, S, D, N) = {(b, s, d, n)}, x B C D "
              f"{row['dtype']}, state in {with_state}: max_abs_err "
              f"{err:.3e} (tol {MAMBA_TOL}, max |y| {row['max_abs_y']:.1f}) "
              f"kernel {row['ms']:.4f} ms (graph; eager "
              f"{row['eager_ms']:.4f}), plain {row['plain_ms']:.4f} ms, "
              f"bound {bound:.4f} ms ({bound_by}: {nbytes / 1e6:.1f} MB "
              f"{row['bytes_ms']:.4f} ms, {flops / 1e9:.3f} GFLOP "
              f"{row['flops_ms']:.4f} ms, with {exps / 1e6:.1f} M exp "
              f"{ops_ms:.4f} ms; the exps on the SFUs alone {sfu_ms:.4f} "
              f"ms)")
        rows[name] = row
        del args, y, st, yp, sp
    torch.cuda.empty_cache()
    return rows


def mamba_bwd_phase() -> dict:
    """The scan's backward kernel against the plain version's VJP
    (``mamba_scan_bwd_plain``) at the training shapes, every gradient,
    inputs as the model hands them over (bf16 x, D and B, C views); times
    beside the bound. No PyTorch call computes the scan's gradient."""
    g = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for name, b, s, d, n, dt in MAMBA_BWD_SHAPES:
        args = mamba_inputs(b, s, d, n, dt, False, g)
        gy = torch.randn((b, s, d), device="cuda", generator=g)
        got = mamba.mamba_scan_bwd(*args, gy)[:7]
        want, plain_ms = timed_ms(lambda: mamba_scan_bwd_plain(*args, gy))
        gaps = grad_gaps(got, want)
        del got, want
        bound = mamba_bwd_bound_ms(b, s, d, n, torch.finfo(dt).bits // 8,
                                   False, False)
        row = bwd_row("mamba_scan", name,
                      lambda: mamba.mamba_scan_bwd(*args, gy),
                      lambda: mamba_scan_bwd_plain(*args, gy), gaps, bound,
                      iters=20 if s < 1024 else 5, plain_first_ms=plain_ms)
        row.update(B=b, S=s, D=d, N=n, dtype=str(dt).split(".")[-1],
                   bound_exps=bound[4])
        print(f"mamba_scan backward {name} (B, S, D, N) = {(b, s, d, n)}, "
              f"x B C D {row['dtype']}, no state: max rel err "
              f"{row['max_rel_err']:.3e} of max |plain| (tol {BWD_TOL}, "
              f"{BWD_TOL_BF16} in bf16; abs {row['max_abs_err']:.3e}; dx "
              f"ddelta dA dB dC dD) kernel {row['ms']:.4f} ms (graph; eager "
              f"{row['eager_ms']:.4f}), plain VJP {row['plain_ms']:.2f} ms, "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
              f"{row['bound_bytes'] / 1e6:.1f} MB, "
              f"{row['bound_flops'] / 1e9:.3f} GFLOP and "
              f"{bound[4] / 1e6:.1f} M exp)")
        rows[name] = row
        del args, gy
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# training: the Trainer at full width, kernel-vs-plain parity, the recovery
# drill


def train_run(cfg, lr: float = 3e-4, **kw) -> RunConfig:
    """The train launcher's run of ``cfg`` (AdamW at ``lr`` after a 10-step
    warmup, one device); ``kw`` overrides RunConfig fields (the default
    dtypes are the reference RunConfig's bf16 parameters and compute with
    fp32 moments)."""
    return RunConfig(model=cfg, shape=ShapeConfig(
        "train", seq_len=TRAIN_MAX_SL, global_batch=TRAIN_BATCH,
        step=StepKind.TRAIN), mesh=MeshConfig(shape=(1,), axes=("data",)),
        optimizer=OptimizerConfig(lr=lr, warmup_steps=10), **kw)


def train_data(cfg) -> DataIterator:
    return DataIterator(lm_documents(TRAIN_MAX_SL), samples_per_epoch=4096,
                        batch_size=TRAIN_BATCH, vocab_size=cfg.vocab_size,
                        granularity=16, seed=0)


def to_batch(tokens, labels, device) -> dict:
    return {"tokens": torch.as_tensor(tokens, dtype=torch.long,
                                      device=device),
            "labels": torch.as_tensor(labels, dtype=torch.long,
                                      device=device)}


def training_phase() -> dict:
    """starcoder2-3b at full width and depth in bf16 (fp32 moments) trained
    by ``Trainer`` for 40 steps; the flash kernel's launch counts, set to
    0 just before, must be 30 x 40, all on the tensor-core path."""
    cfg = get_model_config(TRAIN_ARCH)
    run = train_run(cfg)
    t0 = time.perf_counter()
    model = build_model(cfg, Runtime.from_run(run), device="cuda",
                        seed=run.seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"training: {TRAIN_ARCH} at {_depth(cfg)} ({_describe(cfg)}), "
          f"{run.param_dtype} parameters and compute, "
          f"{run.optimizer.moment_dtype} moments, "
          f"{n_params / 1e9:.3f} B parameters, built in "
          f"{time.perf_counter() - t0:.1f} s")
    # warm up cuBLAS and the allocator outside the counted, timed run: one
    # step at step 0, whose lr is 0, so the weights do not move
    warm = init_train_state(model, run)
    step = build_train_step(model, run, TRAIN_STEPS)
    tokens, labels, first_sl = next(iter(train_data(cfg)))
    step(warm, to_batch(tokens, labels, model.device))
    torch.cuda.synchronize()
    del warm, step
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    trainer = Trainer(model, run, train_data(cfg), total_steps=TRAIN_STEPS)
    server, scraped, done = serve_http(port=0), {}, threading.Event()

    def scrape():
        # one scrape of the live endpoint once the first step is logged
        while not done.is_set() and trainer.epoch_log.num_iterations < 1:
            time.sleep(0.05)
        scraped["after_steps"] = trainer.epoch_log.num_iterations
        scraped["body"] = urllib.request.urlopen(
            server.url, timeout=30).read().decode()

    scraper = threading.Thread(target=scrape, daemon=True)
    zero_counts(flash)
    scraper.start()
    t0 = time.perf_counter()
    rep = trainer.train(TRAIN_STEPS)
    wall = time.perf_counter() - t0
    done.set()
    scraper.join(timeout=60)
    server.close()
    body = scraped.get("body", "")
    print(f"  /metrics scraped once at {server.url} after "
          f"{scraped.get('after_steps')} of {TRAIN_STEPS} steps: "
          f"{len(body.splitlines())} lines, train_step_time_s histogram "
          f"{'present' if 'train_step_time_s_bucket' in body else 'MISSING'}")
    if scraper.is_alive() or "train_step_time_s_bucket" not in body \
            or not 0 < scraped.get("after_steps", 0) < TRAIN_STEPS:
        raise RuntimeError(f"metrics scrape mid-run: {scraped}")
    launches, launches_tc = flash.launches, flash.launches_tc
    bwd, bwd_tc = flash.bwd_launches, flash.bwd_launches_tc
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    fwd_ms, bwd_ms = _forward_backward_ms(
        model, to_batch(tokens, labels, model.device))
    log = trainer.epoch_log
    by_sl = {}
    for it in log.iterations:
        by_sl.setdefault(it.seq_len, []).append(1e3 * it.runtime)
    for sl, ms in sorted(by_sl.items()):
        print(f"  step at padded SL {sl:4d}: " + ", ".join(
            f"{t:.1f}" for t in ms) + " ms")
    losses = rep.losses
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    sp = trainer.seqpoints(error_threshold=0.05)
    expected = kernel_layers(cfg, BK.ATTENTION) * TRAIN_STEPS
    print(f"  {rep.steps} steps in {wall:.1f} s (epoch log "
          f"{log.total_runtime:.3f} s); loss {losses[0]:.4f} at the first "
          f"step, {losses[-1]:.4f} at the last; mean of the first 5 "
          f"{first:.4f}, of the last 5 {last:.4f}; peak memory "
          f"{peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated)")
    print(f"  seqpoints(error_threshold=0.05) of the training log: "
          f"{sp.num_points} points at padded SLs {sp.seq_lens}, error "
          f"{100 * sp.error:.3f} %")
    print(f"  one step at padded SL {first_sl}, split: forward {fwd_ms:.1f} "
          f"ms, backward {bwd_ms:.1f} ms (attention through the flash "
          f"backward kernel)")
    print(f"  flash_attention launches: {launches} (expected {expected} = "
          f"{kernel_layers(cfg, BK.ATTENTION)} attention layers x "
          f"{TRAIN_STEPS} steps); on the tensor-core path: {launches_tc}; "
          f"backward launches {bwd} (expected {expected}), on the "
          f"tensor-core path {bwd_tc}; flash_bwd_plain on CUDA tensors "
          f"{flash_ops.plain_cuda_calls}")
    if launches != expected or launches_tc != expected or bwd != expected \
            or bwd_tc != expected or flash_ops.plain_cuda_calls:
        raise RuntimeError(f"training launched flash {launches} times "
                           f"({launches_tc} on the tensor cores) and its "
                           f"backward {bwd} ({bwd_tc}), expected {expected}; "
                           f"plain VJP {flash_ops.plain_cuda_calls}")
    if not all(math.isfinite(x) for x in losses) or not last < first \
            or rep.steps != TRAIN_STEPS or len(losses) != TRAIN_STEPS:
        raise RuntimeError(f"training losses {losses}")
    if not (math.isfinite(sp.error) and sp.num_points >= 1):
        raise RuntimeError(f"training SeqPoints {sp}")
    out = {"arch": TRAIN_ARCH, "num_layers": cfg.num_layers,
           "params_b": n_params / 1e9, "steps": rep.steps,
           "batch": TRAIN_BATCH, "param_dtype": run.param_dtype,
           "moment_dtype": run.optimizer.moment_dtype,
           "step_ms_by_padded_sl": {sl: v for sl, v in sorted(
               by_sl.items())},
           "loss_first": losses[0], "loss_last": losses[-1],
           "loss_mean_first5": first, "loss_mean_last5": last,
           "peak_memory_gb": peak / 1e9, "wall_s": wall,
           "split_sl": first_sl, "forward_ms": fwd_ms,
           "backward_ms": bwd_ms,
           "seqpoints": {"num_points": sp.num_points,
                         "seq_lens": sp.seq_lens, "error": sp.error},
           "flash_launches": launches, "flash_launches_tc": launches_tc,
           "flash_bwd_launches": bwd, "flash_bwd_launches_tc": bwd_tc,
           "metrics_scraped_after_steps": scraped.get("after_steps")}
    del model, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _on_host(state: TrainState) -> TrainState:
    """A copy of a train state's parameters and moments on the host."""
    def host(d):
        return {n: t.detach().to("cpu", copy=True) for n, t in d.items()}
    return TrainState(params=host(state.params), opt=OptState(
        step=state.opt.step, m=host(state.opt.m), v=host(state.opt.v)))


def training_parity_phase(cfg, kernels, leaves, resync: bool = False
                          ) -> dict:
    """``cfg`` at full width and the depth it is given, in fp32 (TF32
    off): three train steps (the first at lr 0) with the kernels of
    ``kernels``, and the same from the same weights and batches on the
    plain path; the losses, grad norms and the updated ``leaves`` within
    ``TRAIN_REL`` of max |plain|. With ``resync`` each kernel step starts
    from the plain run's state before that step, so that only the step's
    own forward differs, not the Adam steps before it."""
    run = train_run(cfg, param_dtype="float32", compute_dtype="float32")
    t0 = time.perf_counter()
    model = build_model(cfg, Runtime.from_run(run), device="cuda", seed=0)
    init = {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}
    it = iter(train_data(cfg))
    g = torch.Generator(device=model.device).manual_seed(0)
    batches = [train_batch(model, *next(it)[:2], g) for _ in range(3)]
    runs, before_step = {}, []
    for use_kernel in (False, True):
        model.load_state_dict(init)
        model.use_kernel = use_kernel
        state = init_train_state(model, run)
        step = build_train_step(model, run, TRAIN_STEPS)
        before = [parity_counts(mod) for _, mod, *_ in kernels]
        metrics = []
        for i, b in enumerate(batches):
            if resync and use_kernel:
                assign_state(state, before_step[i])
            elif resync:
                before_step.append(_on_host(state))
            metrics.append(step(state, b)[1])
        runs[use_kernel] = (
            [float(m["loss"]) for m in metrics],
            [float(m["grad_norm"]) for m in metrics],
            {n: state.params[n].detach().to("cpu", copy=True)
             for n in leaves},
            [tuple(a - b for a, b in zip(parity_counts(mod), was))
             for (_, mod, *_), was in zip(kernels, before)])
        del state, step, metrics
        gc.collect()
        torch.cuda.empty_cache()
    del before_step
    model.use_kernel = True
    (lk, gk, pk, nk), (lp, gp, pp, npl) = runs[True], runs[False]
    rels = {"loss": max(abs(a - b) / abs(b) for a, b in zip(lk, lp)),
            "grad_norm": max(abs(a - b) / abs(b) for a, b in zip(gk, gp))}
    for n in leaves:
        rels[n] = ((pk[n] - pp[n]).abs().max() / pp[n].abs().max()).item()
    moved = {n: ((pp[n] - init[n]).abs().max()).item() for n in leaves}
    # fp32: the flash kernels on the CUDA cores, forward and backward
    want = []
    for _, mod, kind, _ in kernels:
        n = train_launches_per_step(cfg, kind) * len(batches)
        nb = n if hasattr(mod, "bwd_launches") else 0
        simt = hasattr(mod, "launches_simt")
        want.append((n, nb, n if simt else 0, nb if simt else 0))
    print(f"training parity, {cfg.name} at {_depth(cfg)} "
          f"({train_cut(cfg)}), fp32, 3 steps"
          f"{' (each kernel step from the plain state)' if resync else ''}"
          f" at padded SLs "
          f"{[b['tokens'].shape[1] for b in batches]}: losses {lk} vs {lp}; "
          f"grad norms {gk} vs {gp}")
    print("  max|kernel - plain| / max|plain|: " + ", ".join(
        f"{k} {v:.2e}" for k, v in rels.items()) + f" (tol {TRAIN_REL}); "
          f"leaves moved by up to " + ", ".join(
        f"{k} {v:.2e}" for k, v in moved.items()) + "; " + "; ".join(
        f"{name} launches {n[0]} (expected {w[0]}) / plain {p[0]}, "
        f"backward {n[1]} (expected {w[1]}) / plain {p[1]}"
        + (f", on the CUDA cores {n[2]} and {n[3]}"
           if hasattr(mod, "launches_simt") else "")
        for (name, mod, *_), n, w, p in zip(kernels, nk, want, npl))
          + f"; flash_bwd_plain on CUDA tensors {flash_ops.plain_cuda_calls}"
          + f"; phase {time.perf_counter() - t0:.1f} s")
    if not all(math.isfinite(v) and v <= TRAIN_REL for v in rels.values()) \
            or nk != want or any(any(p) for p in npl) \
            or not all(moved.values()) or flash_ops.plain_cuda_calls:
        raise RuntimeError(f"training parity of {cfg.name} failed: {rels}, "
                           f"launches {nk}/{npl} (expected {want}), moved "
                           f"{moved}, plain VJP {flash_ops.plain_cuda_calls}")
    del model, init
    gc.collect()
    torch.cuda.empty_cache()
    return {"arch": cfg.name, "num_layers": cfg.num_layers,
            "cut": train_cut(cfg), "resync": resync, "rel": rels,
            "launches": {k[0]: n[0] for k, n in zip(kernels, nk)},
            "bwd_launches": {k[0]: n[1] for k, n in zip(kernels, nk)
                             if hasattr(k[1], "bwd_launches")}}


def parity_counts(mod) -> tuple:
    """A kernel module's forward and backward launches, in all and on the
    CUDA cores (0 where it has no such counter)."""
    return tuple(getattr(mod, a, 0) for a in (
        "launches", "bwd_launches", "launches_simt", "bwd_launches_simt"))


def with_experts(cfg, n: int):
    """``cfg`` with ``n`` routed experts a MoE layer; top-k and the shared
    experts kept, every width full."""
    return cfg.with_overrides(moe=dataclasses.replace(cfg.moe,
                                                      num_experts=n))


def train_cut(cfg) -> str:
    """What ``cfg`` cuts from its arch's config, for the phase's line."""
    full = get_model_config(cfg.name)
    cut = []
    if cfg.num_layers != full.num_layers:
        cut.append(f"{cfg.num_layers} of {full.num_layers} layers")
    if cfg.moe is not None and cfg.moe.num_experts != full.moe.num_experts:
        cut.append(f"{cfg.moe.num_experts} of {full.moe.num_experts} "
                   f"routed experts a MoE layer, top-"
                   f"{cfg.moe.experts_per_token} kept")
    if cfg.encoder is not None \
            and cfg.encoder.num_layers != full.encoder.num_layers:
        cut.append(f"{cfg.encoder.num_layers} of "
                   f"{full.encoder.num_layers} encoder layers")
    if full.mtp_depth and not cfg.mtp_depth:
        cut.append("no MTP block")
    return "cut: " + ("; ".join(cut) if cut else "none")


def train_launches_per_step(cfg, kind) -> int:
    """A kernel's launches in one train step: once per layer of mixer
    ``kind`` in the forward (its backward kernel, once per such layer too,
    counts apart); the MTP block runs one more attention, the
    encoder-decoder its encoder, decoder self- and cross-attention."""
    if cfg.encoder is not None:
        return expected_launches(cfg, kind, False, 0)
    extra = 1 if cfg.mtp_depth and kind == cfg.pattern[0][0] else 0
    return kernel_layers(cfg, kind) + extra


def train_batch(model, tokens, labels, g) -> dict:
    """``to_batch`` plus, for the encoder-decoder, its source frames at
    full length in the compute type, standard normal from the generator
    ``g``."""
    cfg, batch = model.cfg, to_batch(tokens, labels, model.device)
    if cfg.encoder is not None:
        batch["frames"] = torch.randn(
            (len(tokens), cfg.encoder.max_source_len, cfg.d_model),
            generator=g, device=model.device).to(model.rt.compute_dtype)
    return batch


def _forward_backward_ms(model, batch):
    """One forward and one backward (the gradients of every parameter) on
    ``batch``, each timed to a synchronize: (forward ms, backward ms)."""
    params = [p for p in model.parameters() if p.requires_grad]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, _ = model.loss(batch)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del loss, grads
    return 1e3 * (t1 - t0), 1e3 * (t2 - t1)


def train_zoo_phase(cfg, kernels, steps: int, trainer: bool,
                    lr: float = 3e-4) -> dict:
    """``cfg`` (full width; its cuts printed) trained in bf16 with fp32
    moments at batch 8 on ``lm_documents(256)`` padded to 16s, for
    ``steps`` steps after one warm-up step at lr 0: by ``Trainer`` where
    ``trainer`` (tokens and labels only, as the reference's), otherwise by
    ``build_train_step`` with the arch's own batch keys. Each kernel of
    ``kernels``, its counts set to 0 just before, must launch
    ``train_launches_per_step`` x ``steps`` times (the flash kernel on the
    tensor cores), and WKV6's and the scan's backward kernels once per
    such layer and step; the losses must be finite and fall (mean of the
    last 5 under that of the first 5). Prints the step time by padded SL, the
    peak memory (read after the cast and the warm-up), the training log's
    SeqPoints and one step split into forward and backward at the first
    batch's SL."""
    run = train_run(cfg, lr)
    t_phase = time.perf_counter()
    model = build_model(cfg, Runtime.from_run(run), device="cuda",
                        seed=run.seed)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"training: {cfg.name} at {_depth(cfg)} ({_describe(cfg)}; "
          f"{train_cut(cfg)}), {run.param_dtype} parameters and compute, "
          f"{run.optimizer.moment_dtype} moments, {n_params / 1e9:.3f} B "
          f"parameters, AdamW lr {lr:g}, batch {TRAIN_BATCH}, {steps} "
          f"steps by {'Trainer' if trainer else 'build_train_step'}")
    g = torch.Generator(device=model.device).manual_seed(0)
    tokens, labels, first_sl = next(iter(train_data(cfg)))
    first = train_batch(model, tokens, labels, g)
    warm = init_train_state(model, run)
    build_train_step(model, run, steps)(warm, first)
    torch.cuda.synchronize()
    del warm
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    for _, mod, *_ in kernels:
        zero_counts(mod)
    t0 = time.perf_counter()
    if trainer:
        tr = Trainer(model, run, train_data(cfg), total_steps=steps)
        rep = tr.train(steps)
        log, losses = tr.epoch_log, rep.losses
        del tr
    else:
        state = init_train_state(model, run)
        step = build_train_step(model, run, steps)
        log, losses, it = EpochLog(), [], iter(train_data(cfg))
        for _ in range(steps):
            tokens, labels, sl = next(it)
            batch = train_batch(model, tokens, labels, g)
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            log.append(sl, time.perf_counter() - t)
        del state, step
    wall = time.perf_counter() - t0
    launches = {name: (mod.launches, getattr(mod, "launches_tc", None))
                for name, mod, *_ in kernels}
    bwd = {name: (mod.bwd_launches, getattr(mod, "bwd_launches_tc", None))
           for name, mod, *_ in kernels if hasattr(mod, "bwd_launches")}
    peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    fwd_ms, bwd_ms = _forward_backward_ms(model, first)

    by_sl = {}
    for itr in log.iterations:
        by_sl.setdefault(itr.seq_len, []).append(1e3 * itr.runtime)
    for sl, ms in sorted(by_sl.items()):
        print(f"  step at padded SL {sl:4d}: " + ", ".join(
            f"{t:.1f}" for t in ms) + " ms")
    head, tail = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    sp = select_seqpoints(log, error_threshold=0.05)
    print(f"  {len(losses)} steps in {wall:.1f} s (epoch log "
          f"{log.total_runtime:.3f} s); loss {losses[0]:.4f} at the first "
          f"step, {losses[-1]:.4f} at the last; mean of the first 5 "
          f"{head:.4f}, of the last 5 {tail:.4f}; peak memory "
          f"{peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated)")
    print("  losses: " + ", ".join(f"{x:.4f}" for x in losses))
    print(f"  seqpoints(error_threshold=0.05) of the training log: "
          f"{sp.num_points} points at padded SLs {sp.seq_lens}, error "
          f"{100 * sp.error:.3f} %")
    step_ms = float(np.median(by_sl[first_sl]))
    print(f"  one step at padded SL {first_sl}, split: forward "
          f"{fwd_ms:.1f} ms, backward {bwd_ms:.1f} ms (WKV6, the scan and "
          f"attention through their backward kernels), backward "
          f"{100 * bwd_ms / (fwd_ms + bwd_ms):.1f} % of the two and "
          f"{100 * bwd_ms / step_ms:.1f} % of the median step at that SL "
          f"({step_ms:.1f} ms)")
    bad = []
    for name, mod, kind, _ in kernels:
        want = train_launches_per_step(cfg, kind) * steps
        n, tc = launches[name]
        path = "" if tc is None else f"; on the tensor-core path: {tc}"
        print(f"  {name} launches: {n} (expected {want} = "
              f"{want // steps} a step x {steps} steps){path}")
        if n != want or (tc is not None and tc != want):
            bad.append((name, n, tc, want))
        if name in bwd:
            nb, tcb = bwd[name]
            path = "" if tcb is None else f"; on the tensor-core path: {tcb}"
            print(f"  {name} backward launches: {nb} (expected {want} = "
                  f"{want // steps} a step x {steps} steps){path}")
            if nb != want or (tcb is not None and tcb != want):
                bad.append((f"{name} backward", nb, tcb, want))
    print(f"  flash_bwd_plain on CUDA tensors: {flash_ops.plain_cuda_calls}")
    if bad or flash_ops.plain_cuda_calls:
        raise RuntimeError(f"training {cfg.name}: launches {bad}, plain VJP "
                           f"{flash_ops.plain_cuda_calls}")
    if not all(math.isfinite(x) for x in losses) or not tail < head \
            or len(losses) != steps:
        raise RuntimeError(f"training {cfg.name}: losses {losses}")
    if not (math.isfinite(sp.error) and sp.num_points >= 1):
        raise RuntimeError(f"training {cfg.name}: SeqPoints {sp}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  phase {time.perf_counter() - t_phase:.1f} s")
    return {"arch": cfg.name, "num_layers": cfg.num_layers,
            "cut": train_cut(cfg), "params_b": n_params / 1e9,
            "steps": steps, "batch": TRAIN_BATCH, "lr": lr,
            "driver": "Trainer" if trainer else "build_train_step",
            "step_ms_by_padded_sl": {sl: v for sl, v in sorted(
                by_sl.items())},
            "losses": losses,
            "loss_first": losses[0], "loss_last": losses[-1],
            "loss_mean_first5": head, "loss_mean_last5": tail,
            "peak_memory_gb": peak / 1e9, "wall_s": wall,
            "split_sl": first_sl, "forward_ms": fwd_ms,
            "backward_ms": bwd_ms, "split_sl_step_ms": step_ms,
            "seqpoints": {"num_points": sp.num_points,
                          "seq_lens": sp.seq_lens, "error": sp.error},
            "launches": {name: n for name, (n, _) in launches.items()},
            "bwd_launches": {name: n for name, (n, _) in bwd.items()},
            "launches_tc": {name: tc for name, (_, tc) in launches.items()
                            if tc is not None},
            "bwd_launches_tc": {name: tc for name, (_, tc) in bwd.items()
                                if tc is not None}}


class FakeClock:
    """One tick a call: every measured step takes 1.0 s, so runtimes are
    bit-identical across runs (the clock of tests/test_resilience.py)."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 1.0
        return self.t


def drill_trainer(ckpt_dir, timer=None, **kw) -> Trainer:
    """The tiny trainer of tests/test_resilience.py on the card: the
    2-layer, 64-wide starcoder2-3b smoke config in fp32, IWSLT-like SLs."""
    cfg = smoke_config(TRAIN_ARCH).with_overrides(
        num_layers=2, d_model=64, d_ff=128, vocab_size=256)
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "tiny", seq_len=32, global_batch=8, step=StepKind.TRAIN),
        mesh=MeshConfig(shape=(1,), axes=("data",)),
        optimizer=OptimizerConfig(lr=1e-3, warmup_steps=2),
        param_dtype="float32", compute_dtype="float32", **kw)
    model = build_model(cfg, Runtime.from_run(run), device="cuda", seed=0)
    data = DataIterator(IWSLT_LIKE, samples_per_epoch=256, batch_size=8,
                        vocab_size=cfg.vocab_size, granularity=8, seed=1)
    return Trainer(model, run, data, ckpt_dir=ckpt_dir, ckpt_every=4,
                   total_steps=16, timer=timer or time.perf_counter,
                   policy=RecoveryPolicy(backoff_base_s=0.0))


def with_faults(plan: str, fn):
    faults.install(FaultPlan.parse(plan))
    try:
        return fn()
    finally:
        faults.install(None)


def projection_phase(res: dict) -> dict:
    """The GNMT main path's EpochLog (its plan's SL histogram at the
    profiled step times) and the SeqPoints selected from it, fed to
    ``ProjectionMonitor``: its Eq. 1 number must be the SeqPointSet's."""
    w = res["wallclock"]
    log = EpochLog()
    for sl, n in sorted(res["sl_histogram"].items()):
        for _ in range(int(n)):
            log.append(int(sl), w["runtime_by_sl"][sl])
    sp = select_seqpoints(log, error_threshold=0.02)
    mon = ProjectionMonitor(sp)
    mon.observe_log(log)
    rep = mon.report()
    worst = rep.worst_sl()
    print(f"projection monitor: {rep.iterations} iterations of the GNMT "
          f"log, {sp.num_points} SeqPoints; eq1_predicted "
          f"{rep.eq1_predicted:.6f} s = SeqPointSet.predicted "
          f"{sp.predicted:.6f} s; monitor rel_error (nearest SeqPoint per "
          f"iteration) {100 * rep.rel_error:.3f} % beside the "
          f"reproduction's SeqPoint error (cluster weights) "
          f"{w['methods']['seqpoint']['error_pct']:.3f} %; worst SL "
          f"{worst.seq_len}: measured {1e3 * worst.measured_mean:.2f} ms, "
          f"predicted {1e3 * worst.predicted:.2f} ms, residual "
          f"{100 * worst.rel_error:.2f} %")
    if rep.eq1_predicted != sp.predicted \
            or not math.isclose(sp.predicted,
                                w["methods"]["seqpoint"]["predicted"],
                                rel_tol=1e-9) \
            or rep.iterations != res["num_iterations"] \
            or not math.isfinite(rep.rel_error):
        raise RuntimeError(f"projection monitor: {rep}")
    return {"iterations": rep.iterations, "eq1_predicted": rep.eq1_predicted,
            "monitor_rel_error": rep.rel_error,
            "seqpoint_error": w["methods"]["seqpoint"]["error_pct"] / 100,
            "worst_sl": worst.seq_len, "worst_rel_error": worst.rel_error}


def dist_phase() -> dict:
    """The DTensor path on a 1 x 1 ("data", "model") mesh of the card:
    starcoder2-3b at full width and depth in bf16, parameters distributed
    by ``param_specs``, one prefill of 4 x 1536 against the plain model
    with the same weights (30 flash launches, all on the tensor cores);
    qwen2-moe-a2.7b's sharded MoE path against the plain one at full
    width; and one full-width MoE layer's full-EP path (all-to-all) on the
    card against the same on the CPU, fp32. One process group serves both
    devices: NCCL for the card, gloo for the CPU."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    t0 = time.perf_counter()
    dist.init_process_group("cpu:gloo,cuda:nccl", store=dist.HashStore(),
                            rank=0, world_size=1)
    mcfg = MeshConfig(shape=(1, 1), axes=("data", "model"))
    mesh = make_mesh(mcfg, "cuda")
    out = {"mesh": list(mcfg.shape)}

    cfg = get_model_config(SERVE_ARCH)
    model = build_model(cfg, BF16, device="cuda", seed=0)
    g = torch.Generator(device="cuda").manual_seed(5)
    tokens = torch.randint(0, cfg.vocab_size, (4, DIST_WIDTH),
                           device="cuda", generator=g)
    with torch.no_grad():
        want = model.prefill({"tokens": tokens})[0].float()
    specs = shard_rules.param_specs(model, cfg, mcfg)
    shard_rules.distribute_params(model, mesh, specs)
    batch_spec = shard_rules.batch_specs({"tokens": tokens}, mcfg,
                                         ShapeConfig("serve", DIST_WIDTH, 4,
                                                     StepKind.PREFILL))
    tok = distribute_tensor(tokens, mesh,
                            placements(batch_spec["tokens"], mesh))
    zero_counts(flash)
    with torch.no_grad(), use_mesh(mesh):
        got = model.prefill({"tokens": tok})[0]
    launches, launches_tc = flash.launches, flash.launches_tc
    got = got.full_tensor().float()
    rel = float((got - want).abs().max() / want.abs().max())
    same = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    expected = kernel_layers(cfg, BK.ATTENTION)
    print(f"dist: {SERVE_ARCH} at {_depth(cfg)} in bf16 on a 1 x 1 "
          f"(data, model) NCCL mesh, parameters as DTensors by param_specs: "
          f"prefill of 4 x {DIST_WIDTH}, logits max |DTensor - plain| / max "
          f"|plain| = {rel:.3e} (tol {DIST_REL}); greedy next tokens "
          f"{got.argmax(-1).flatten().tolist()} (plain "
          f"{want.argmax(-1).flatten().tolist()}); flash launches "
          f"{launches} (expected {expected}), on the tensor cores "
          f"{launches_tc}")
    if rel > DIST_REL or not same or launches != expected \
            or launches_tc != expected:
        raise RuntimeError(f"dist prefill: rel {rel}, same tokens {same}, "
                           f"launches {launches} / {launches_tc}")
    out[SERVE_ARCH] = {"logits_rel": rel, "same_tokens": same,
                       "flash_launches": launches,
                       "flash_launches_tc": launches_tc}
    del model, got, want
    gc.collect()
    torch.cuda.empty_cache()

    mcfg_moe = get_model_config(MOE_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(1)
    layer = moe_mod.MoE(mcfg_moe, gen, torch.bfloat16)
    x = torch.randn((4, DIST_WIDTH, mcfg_moe.d_model), device="cuda",
                    generator=gen).to(torch.bfloat16)
    with torch.no_grad():
        want_y, want_aux = moe_mod.moe_forward(layer, x, mcfg_moe)
        shard_rules.distribute_params(
            layer, mesh, shard_rules.param_specs(layer, mcfg_moe, mcfg))
        xd = distribute_tensor(x, mesh, placements((None, None, None), mesh))
        with use_mesh(mesh):
            y, aux = moe_mod.moe_forward(layer, xd, mcfg_moe)
    y, aux = y.full_tensor().float(), float(aux.full_tensor())
    want_y = want_y.float()
    rel_moe = float((y - want_y).abs().max() / want_y.abs().max())
    rel_aux = abs(aux - float(want_aux)) / abs(float(want_aux))
    print(f"dist: {MOE_ARCH} MoE layer at full width ({_describe(mcfg_moe)}"
          f"), bf16, 4 x {DIST_WIDTH} tokens: _moe_forward_sharded vs "
          f"moe_forward max |diff| / max |plain| = {rel_moe:.3e} (tol "
          f"{MOE_REL}), aux {aux:.6f} vs {float(want_aux):.6f}")
    if rel_moe > MOE_REL or rel_aux > 1e-3:
        raise RuntimeError(f"sharded MoE: rel {rel_moe}, aux {rel_aux}")
    out["moe_sharded"] = {"rel": rel_moe, "aux_rel": rel_aux}
    del layer, x, xd, y, want_y
    gc.collect()
    torch.cuda.empty_cache()

    layer = moe_mod.MoE(mcfg_moe, gen, torch.float32)
    x = torch.randn((1, MOE_EP_TOKENS, mcfg_moe.d_model), device="cuda",
                    generator=gen)
    host = moe_mod.MoE(mcfg_moe, torch.Generator(device="cpu"),
                       torch.float32)
    host.load_state_dict({k: v.cpu() for k, v in layer.state_dict().items()})
    cpu_mesh = init_device_mesh("cpu", (1, 1),
                                mesh_dim_names=("data", "model"))
    ys = []
    for lyr, m, xx in ((layer, mesh, x), (host, cpu_mesh, x.cpu())):
        with torch.no_grad():
            shard_rules.distribute_params(lyr, m, shard_rules.param_specs(
                lyr, mcfg_moe, mcfg, moe_full_ep=True))
            xd = distribute_tensor(xx, m, placements((None, None, None), m))
            with use_mesh(m):
                yy, aa = moe_mod.moe_forward(lyr, xd, mcfg_moe, full_ep=True)
        ys.append((yy.full_tensor().cpu(), float(aa.full_tensor())))
    (y_card, aux_card), (y_cpu, aux_cpu) = ys
    rel_ep = float((y_card - y_cpu).abs().max() / y_cpu.abs().max())
    print(f"dist: {MOE_ARCH} MoE layer, _moe_forward_full_ep (all-to-all "
          f"over data x model), fp32, 1 x {MOE_EP_TOKENS} tokens: card "
          f"(NCCL) vs CPU (gloo) max |diff| / max |CPU| = {rel_ep:.3e} "
          f"(tol {MOE_EP_REL}), aux {aux_card:.6f} vs {aux_cpu:.6f}; phase "
          f"{time.perf_counter() - t0:.1f} s")
    if rel_ep > MOE_EP_REL or abs(aux_card - aux_cpu) > 1e-5 * aux_cpu:
        raise RuntimeError(f"full-EP MoE: rel {rel_ep}, aux {aux_card} vs "
                           f"{aux_cpu}")
    out["moe_full_ep"] = {"rel": rel_ep, "aux_card": aux_card,
                          "aux_cpu": aux_cpu}
    del layer, host
    dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _remat_steps(model, run, batches) -> dict:
    """``len(batches)`` train steps from the model's present weights and
    zero moments: losses, step times and the peak memory."""
    gc.collect()
    torch.cuda.empty_cache()
    state = init_train_state(model, run)
    step = build_train_step(model, run, len(batches))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(flash)
    losses, times = [], []
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(state, b)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    out = {"losses": losses, "step_s": times,
           "median_step_s": float(np.median(times)),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
           "flash_launches": flash.launches,
           "flash_bwd_launches": flash.bwd_launches,
           "flash_bwd_launches_tc": flash.bwd_launches_tc}
    del state, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def remat_phase() -> dict:
    """starcoder2-3b at full width and depth, bf16 with fp32 moments, batch
    8: three train steps with ``remat`` "none", "block" and
    "save_boundaries" from the same weights and batches at SL 512, then
    "block" at the longest SL (a multiple of 256 up to 4096) whose step
    fits the card, found by trying from 4096 down."""
    cfg = get_model_config(TRAIN_ARCH)
    run = train_run(cfg)
    model = build_model(cfg, Runtime.from_run(run), device="cuda",
                        seed=run.seed)
    init = {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}
    rng = np.random.RandomState(3)

    def batches(sl, n):
        return [to_batch(rng.randint(0, cfg.vocab_size, (TRAIN_BATCH, sl)),
                         rng.randint(0, cfg.vocab_size, (TRAIN_BATCH, sl)),
                         model.device) for _ in range(n)]

    data = batches(REMAT_SL, REMAT_STEPS)
    modes = {}
    attn_layers = kernel_layers(cfg, BK.ATTENTION)
    for mode in ("none", "block", "save_boundaries"):
        model.load_state_dict(init)
        model.rt = dataclasses.replace(model.rt, remat=mode)
        modes[mode] = r = _remat_steps(model, run, data)
        print(f"remat: {TRAIN_ARCH} at {_depth(cfg)}, bf16, batch "
              f"{TRAIN_BATCH} x SL {REMAT_SL}, remat={mode!r}: losses "
              + ", ".join(f"{x:.5f}" for x in r["losses"])
              + f"; median step {1e3 * r['median_step_s']:.1f} ms; peak "
              f"{r['peak_gb']:.2f} GB; flash launches {r['flash_launches']}, "
              f"backward {r['flash_bwd_launches']} (tensor cores "
              f"{r['flash_bwd_launches_tc']})")
    base = modes["none"]["losses"]
    gap = max(abs(a - b) / abs(b) for m in ("block", "save_boundaries")
              for a, b in zip(modes[m]["losses"], base))
    print(f"  largest loss gap against remat='none': {gap:.3e} (tol "
          f"{REMAT_LOSS_REL})")
    if gap > REMAT_LOSS_REL or not all(
            math.isfinite(x) for r in modes.values() for x in r["losses"]):
        raise RuntimeError(f"remat losses differ: {modes}")
    # the forward runs again in the backward under both remat modes, the
    # backward kernel once a layer and step in each
    want = {"none": attn_layers * REMAT_STEPS,
            "block": 2 * attn_layers * REMAT_STEPS,
            "save_boundaries": 2 * attn_layers * REMAT_STEPS}
    if any(modes[m]["flash_launches"] != n
           or modes[m]["flash_bwd_launches"] != attn_layers * REMAT_STEPS
           or modes[m]["flash_bwd_launches_tc"] != attn_layers * REMAT_STEPS
           for m, n in want.items()) or flash_ops.plain_cuda_calls:
        raise RuntimeError(f"remat flash launches: {modes}; plain VJP "
                           f"{flash_ops.plain_cuda_calls}")

    model.load_state_dict(init)
    model.rt = dataclasses.replace(model.rt, remat="block")
    longest, tried = None, []
    for sl in range(REMAT_MAX_SL, REMAT_SL - 1, -256):
        try:
            res = _remat_steps(model, run, batches(sl, 1))
        except torch.cuda.OutOfMemoryError:
            # the answer for this SL, not a failure: it does not fit
            tried.append(sl)
            continue
        longest = sl
        break
    print(f"  remat='block': SLs that do not fit at batch {TRAIN_BATCH}: "
          f"{tried}")
    if longest is None:
        raise RuntimeError("remat='block' fits no SL")
    res = _remat_steps(model, run, batches(longest, REMAT_STEPS))
    print(f"  remat='block' at the longest SL that fits, {longest} (batch "
          f"{TRAIN_BATCH}): losses " + ", ".join(
              f"{x:.5f}" for x in res["losses"])
          + f"; median step {1e3 * res['median_step_s']:.1f} ms; peak "
          f"{res['peak_gb']:.2f} GB; flash launches {res['flash_launches']}"
          f", backward {res['flash_bwd_launches']}")
    if not all(math.isfinite(x) for x in res["losses"]) \
            or res["flash_bwd_launches"] != attn_layers * REMAT_STEPS:
        raise RuntimeError(f"remat at SL {longest}: {res}")
    del model, init
    gc.collect()
    torch.cuda.empty_cache()
    return {"sl": REMAT_SL, "batch": TRAIN_BATCH, "modes": modes,
            "loss_gap": gap, "longest_block_sl": longest,
            "did_not_fit": tried, "longest": res}


# one of each cache and kernel family, at full size; each traces in a
# process of its own (on one CPU core), all at once
DRYRUN_CELLS = [("starcoder2-3b", "train_4k"),       # flash, remat, FSDP
                ("deepseek-v3-671b", "decode_32k"),  # MLA latents, MoE
                ("jamba-v0.1-52b", "long_500k"),     # scan and KV caches
                ("rwkv6-3b", "decode_32k"),          # the WKV6 state
                ("rwkv6-3b", "train_4k"),            # both WKV6 kernels
                ("whisper-medium", "prefill_32k")]   # encoder-decoder
DRYRUN_TRACE_SL = 512         # the remat phase's step: its peak was measured
DRYRUN_RWKV_LAYERS = 2        # rwkv6-3b's traced-and-run step
DRYRUN_PEAK_REL = 0.10        # traced peak against the card's
DRYRUN_TIMEOUT_S = 600


def dryrun_expected_calls(cfg, run) -> dict:
    """Each kernel's calls in one step of ``run``, from the configuration:
    a prefill or train forward calls the flash kernel once per attention
    or MLA layer (the encoder-decoder: once per encoder layer and twice
    per decoder layer, self and cross), the scan once per mamba layer and
    WKV6 once per rwkv layer; a decode step calls the scan and WKV6 once
    per such layer, the flash kernel only in the encoder-decoder's
    cross-attention (cached self-attention runs the plain decode path); a
    train step runs its forward once per microbatch, and twice under
    remat (the recompute), and the backward kernels of flash attention,
    WKV6 and the scan once per forward call of a microbatch, remat or
    not."""
    step = run.shape.step
    if cfg.encoder is not None:
        flash_n = (cfg.num_layers if step == StepKind.DECODE
                   else cfg.encoder.num_layers + 2 * cfg.num_layers)
        calls = {"flash_attention": flash_n, "mamba_scan": 0, "wkv6": 0}
    else:
        attn = kernel_layers(cfg, BK.ATTENTION) + kernel_layers(cfg, BK.MLA)
        calls = {"flash_attention": 0 if step == StepKind.DECODE else attn,
                 "mamba_scan": kernel_layers(cfg, BK.MAMBA),
                 "wkv6": kernel_layers(cfg, BK.RWKV)}
        if step == StepKind.TRAIN and cfg.mtp_depth:
            # the MTP block's attention runs in the loss only
            calls["flash_attention"] += 1
    bwd = {"flash_attention_bwd": 0, "wkv6_bwd": 0, "mamba_scan_bwd": 0}
    if step == StepKind.TRAIN:
        again = 2 if run.remat in ("block", "save_boundaries") else 1
        bwd = {f"{k}_bwd": calls[k] * run.microbatches for k in
               ("flash_attention", "wkv6", "mamba_scan")}
        calls = {k: v * run.microbatches * again for k, v in calls.items()}
    calls["lstm_cell"] = calls["lstm_cell_bwd"] = 0
    return calls | bwd


def dryrun_phase() -> dict:
    """Phase 19 in a subprocess (``python3 chip_smoke.py dryrun OUT``); its
    lines are printed here and its numbers read back from OUT."""
    import subprocess

    gc.collect()
    torch.cuda.empty_cache()
    out = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"),
                       "dryrun.json")
    try:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "dryrun", out],
            capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S + 60)
        print(proc.stdout, end="")
        if proc.returncode != 0:
            print(proc.stderr[-6000:], file=sys.stderr)
            raise RuntimeError(f"dryrun phase failed: exit {proc.returncode}")
        with open(out) as f:
            return json.load(f)
    finally:
        shutil.rmtree(os.path.dirname(out), ignore_errors=True)


def _dryrun_main(out_path: str) -> int:
    """The dry run's phase, in its own process: (a), (b) and (c) of
    phase 19; raises on any breach. The cells of (a) and (b) trace in
    processes of their own while (c) runs here."""
    from repro_torch.launch import dryrun as dr

    t_phase = time.perf_counter()
    line = card_line()
    res = {"card": line}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cells_")
    cells = _start_dryrun_cells(tmp)
    try:
        # (c) one step traced, then run for real, on a 1 x 1 mesh: the
        # remat phase's starcoder2-3b step, and rwkv6-3b's through both
        # WKV6 kernels
        res["trace"] = _trace_vs_card(
            get_model_config(TRAIN_ARCH), line,
            [("flash_attention", flash, "launches"),
             ("flash_attention_bwd", flash, "bwd_launches")])
        res["trace_rwkv"] = _trace_vs_card(
            get_model_config(RWKV_ARCH).with_overrides(
                num_layers=DRYRUN_RWKV_LAYERS), line,
            [("wkv6", wkv6, "launches"), ("wkv6_bwd", wkv6, "bwd_launches")])
        _dryrun_cells(dr, line, res, cells,
                      DRYRUN_TIMEOUT_S - (time.perf_counter() - t_phase))
    finally:
        for proc, _ in cells.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"dryrun phase: {res['seconds']:.1f} s")
    with open(out_path, "w") as f:
        json.dump(res, f)
    return 0


def _start_dryrun_cells(tmp: str) -> dict:
    """Start one ``python -m repro_torch.launch.dryrun`` process for each
    compile cell of ``DRYRUN_CELLS`` and for the roofline cell (the first
    one's), on the 16 x 16 fake mesh; returns {(arch, shape, mode):
    (process, its record's path)}."""
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    jobs = [(arch, shape, "compile") for arch, shape in DRYRUN_CELLS]
    jobs.append((*DRYRUN_CELLS[0], "roofline"))
    cells = {}
    for arch, shape, mode in jobs:
        out = os.path.join(tmp, f"{mode}_{arch}_{shape}.jsonl")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mode", mode, "--mesh", "single",
               "--device", "cuda", "--out", out]
        with open(out + ".err", "w") as err:
            cells[(arch, shape, mode)] = (subprocess.Popen(
                cmd, cwd=root, env=env, stdout=subprocess.DEVNULL,
                stderr=err), out)
    return cells


def _cell_record(cells: dict, key, deadline: float) -> dict:
    """The record of the cell process ``cells[key]``, once it has ended
    (killed at ``deadline``, a ``time.perf_counter()`` value)."""
    import subprocess

    proc, out = cells[key]
    try:
        proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise RuntimeError(f"dryrun {'/'.join(key)}: still tracing at the "
                           f"phase's {DRYRUN_TIMEOUT_S} s")
    recs = []
    if os.path.exists(out):
        with open(out) as f:
            recs = [json.loads(x) for x in f]
    if len(recs) != 1 or recs[0]["status"] != "ok":
        with open(out + ".err") as f:
            print(f.read()[-3000:], file=sys.stderr)
        if recs:
            print(recs[0].get("traceback", ""), file=sys.stderr)
        why = recs[0].get("error") if recs else "no record"
        raise RuntimeError(f"dryrun {'/'.join(key)}: exit "
                           f"{proc.returncode}, {why}")
    return recs[0]


def _dryrun_cells(dr, line: str, res: dict, cells: dict,
                  budget_s: float) -> None:
    """19(a) and (b) into ``res``: the records of the compile cells on the
    16 x 16 fake mesh and of one roofline cell, every one on fake tensors,
    from their processes (``_start_dryrun_cells``), waiting at most
    ``budget_s`` in all."""
    deadline = time.perf_counter() + budget_s
    res["compile"] = {}
    for arch, shape in DRYRUN_CELLS:
        rec = _cell_record(cells, (arch, shape, "compile"), deadline)
        cfg = get_model_config(arch)
        run = dr.default_run(cfg, get_shape(shape), SINGLE_POD)
        want = dryrun_expected_calls(cfg, run)
        mem = rec["memory"]
        live_gb = mem["live_bytes_per_device"] / 1e9
        args_gb = mem["argument_bytes"] / 1e9
        print(f"dryrun compile {arch}/{shape} on 16x16 ({line}): "
              f"{rec['seconds']:.1f} s (beside the other cells and 19(c)); "
              f"live {live_gb:.2f} GB a device (args {args_gb:.2f}, fits 80 "
              f"GiB {mem['fits_h100_80g']}); {rec['flops']:.4g} operations "
              f"a device; kernel calls {rec['kernel_calls']} (expected "
              f"{want}); collectives {rec['collectives']}")
        if rec["kernel_calls"] != want:
            raise RuntimeError(f"dryrun {arch}/{shape}: kernel calls "
                               f"{rec['kernel_calls']}, expected {want}")
        res["compile"][f"{arch}/{shape}"] = {
            "seconds": rec["seconds"], "memory": mem,
            "flops": rec["flops"], "kernel_calls": rec["kernel_calls"],
            "expected_calls": want, "collectives": rec["collectives"],
            "rel_error_claimed": rec["projection"]["rel_error_claimed"]}
    arch, shape = DRYRUN_CELLS[0]
    rec = _cell_record(cells, (arch, shape, "roofline"), deadline)
    print(f"dryrun roofline {arch}/{shape} ({line}): {rec['seconds']:.1f}"
          f" s; {rec['flops']:.4g} operations a device; TPU_V5E terms "
          f"{rec['terms']} ({rec['dominant']}, fraction "
          f"{rec['roofline_fraction']:.4f}); H100 terms "
          f"{rec['terms_h100']} ({rec['dominant_h100']}, fraction "
          f"{rec['roofline_fraction_h100']:.4f})")
    res["roofline"] = {k: rec[k] for k in (
        "seconds", "flops", "bytes", "wire_bytes", "terms", "dominant",
        "roofline_fraction", "terms_h100", "dominant_h100",
        "roofline_fraction_h100", "useful_flops_ratio", "kernel_calls")}


def _trace_vs_card(cfg, line: str, kernels) -> dict:
    """19(c): one train step of ``cfg`` (bf16, fp32 moments, batch 8 x SL
    ``DRYRUN_TRACE_SL``, ``remat="block"``) traced on a 1 x 1 fake mesh,
    then run for real on the same mesh: the traced peak within
    ``DRYRUN_PEAK_REL`` of ``torch.cuda.max_memory_allocated``, the traced
    operations equal to ``FlopCounterMode``'s on the real step, and each
    of ``kernels`` ((key of ``kernel_calls``, kernel module, its launch
    counter)) traced as often as it launched and as the configuration
    gives (``dryrun_expected_calls``)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun as dr

    mcfg = MeshConfig(shape=(1, 1), axes=("data", "model"))
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "trace", seq_len=DRYRUN_TRACE_SL, global_batch=TRAIN_BATCH,
        step=StepKind.TRAIN), mesh=mcfg,
        optimizer=OptimizerConfig(moment_dtype="float32"), remat="block")
    with dr.fake_process_group(1):
        mesh = make_mesh(mcfg, "cuda")
        t0 = time.perf_counter()
        traced = dr.trace_cell(cfg, run, mesh, "cuda")
        trace_s = time.perf_counter() - t0
        cell = dr.build_cell(cfg, run, mesh, "cuda")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _, mod, _ in kernels:
            zero_counts(mod)
        t0 = time.perf_counter()
        with FlopCounterMode(display=False) as fc, use_mesh(mesh):
            state, metrics = cell.run()
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        real_s = time.perf_counter() - t0
        real = {"peak_bytes": torch.cuda.max_memory_allocated(),
                "flops": fc.get_total_flops(), "loss": loss,
                "launches": {key: getattr(mod, counter)
                             for key, mod, counter in kernels}}
        del state, metrics, cell
    gc.collect()
    torch.cuda.empty_cache()
    peak_rel = abs(traced["peak_bytes"] - real["peak_bytes"]) \
        / real["peak_bytes"]
    want = dryrun_expected_calls(cfg, run)
    calls = {key: traced["kernel_calls"][key] for key, _, _ in kernels}
    print(f"dryrun trace vs card ({line}): {cfg.name} at {_depth(cfg)}, "
          f"bf16, fp32 moments, batch {TRAIN_BATCH} x SL "
          f"{DRYRUN_TRACE_SL}, remat='block', 1x1 mesh: traced peak "
          f"{traced['peak_bytes'] / 1e9:.3f} GB, card peak "
          f"{real['peak_bytes'] / 1e9:.3f} GB (rel {peak_rel:.4f}, tol "
          f"{DRYRUN_PEAK_REL}); operations traced {traced['flops']} / real "
          f"{real['flops']}; " + "; ".join(
              f"{key} calls traced {calls[key]} / launched "
              f"{real['launches'][key]} (expected {want[key]})"
              for key in calls)
          + f"; trace {trace_s:.1f} s, real step {real_s:.2f} s, loss "
          f"{loss:.4f}")
    if not peak_rel <= DRYRUN_PEAK_REL:
        raise RuntimeError(f"dryrun {cfg.name}: traced peak "
                           f"{traced['peak_bytes']} vs card "
                           f"{real['peak_bytes']}")
    if traced["flops"] != real["flops"]:
        raise RuntimeError(f"dryrun {cfg.name}: traced operations "
                           f"{traced['flops']} != real {real['flops']}")
    if any(not calls[k] == real["launches"][k] == want[k] for k in calls):
        raise RuntimeError(f"dryrun {cfg.name}: calls {calls} vs launches "
                           f"{real['launches']}, expected {want}")
    if not math.isfinite(loss) or flash_ops.plain_cuda_calls:
        raise RuntimeError(f"dryrun {cfg.name}: real step loss {loss}, "
                           f"plain VJP {flash_ops.plain_cuda_calls}")
    return {"arch": cfg.name, "num_layers": cfg.num_layers,
            "traced_peak_bytes": traced["peak_bytes"],
            "card_peak_bytes": real["peak_bytes"], "peak_rel": peak_rel,
            "traced_flops": traced["flops"], "real_flops": real["flops"],
            "calls": calls, "launches": real["launches"],
            "trace_s": trace_s, "real_step_s": real_s, "loss": loss}


def recovery_drill_phase() -> dict:
    """Four recovery scenarios of the reference's tests on the card, with
    checkpoints in a temporary directory under build/."""
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(root, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_drill_", dir=root)
    out = {}
    try:
        # 1. a NaN loss at step 5: one rollback, every loss finite
        rep = with_faults("nan_loss@5", lambda: drill_trainer(
            os.path.join(tmp, "nan")).train(12))
        out["nan_loss"] = {"rollbacks": rep.rollbacks, "steps": rep.steps}
        print(f"recovery drill: nan_loss@5: {rep.rollbacks} rollback, "
              f"{rep.steps} steps, losses finite "
              f"{all(math.isfinite(x) for x in rep.losses)}")
        if rep.rollbacks != 1 or rep.steps != 12 \
                or not all(math.isfinite(x) for x in rep.losses):
            raise RuntimeError(f"nan_loss drill: {rep}")

        # 2. preempted at step 6, resumed by a fresh Trainer: the same log,
        # SeqPoints and losses as a fault-free run, under a FakeClock
        ref = drill_trainer(os.path.join(tmp, "ref"), FakeClock())
        ref_rep = ref.train(12)
        ck = os.path.join(tmp, "preempt")
        rep = with_faults("preempt@6", lambda: drill_trainer(
            ck, FakeClock()).train(12))
        tr = drill_trainer(ck, FakeClock())
        rep2 = tr.train(12 - rep.steps)
        losses = rep.losses[:rep2.resumed_from] + rep2.losses
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                      ref_rep.losses))
        sp, ref_sp = (t.seqpoints(error_threshold=0.1, n_threshold=32)
                      for t in (tr, ref))
        same_log = tr.epoch_log.to_jsonable() == ref.epoch_log.to_jsonable()
        same_sp = (sp.seq_lens == ref_sp.seq_lens
                   and list(sp.weights) == list(ref_sp.weights)
                   and (sp.k, sp.predicted, sp.actual)
                   == (ref_sp.k, ref_sp.predicted, ref_sp.actual))
        out["preempt"] = {"preempted_at": rep.steps,
                          "resumed_from": rep2.resumed_from,
                          "loss_rel": rel, "same_log": same_log,
                          "same_seqpoints": same_sp}
        print(f"recovery drill: preempt@6: stopped after {rep.steps} steps, "
              f"resumed from {rep2.resumed_from}; losses vs the fault-free "
              f"run max rel {rel:.2e} (rtol {RESUME_RTOL}); SLs and runtimes "
              f"{'identical' if same_log else 'DIFFER'}; SeqPoints "
              f"{'identical' if same_sp else 'DIFFER'} ({sp.num_points} at "
              f"{sp.seq_lens})")
        if not (rep.preempted and rep.steps == 6
                and rep2.resumed_from == 6 and len(losses) == 12
                and rel <= RESUME_RTOL and same_log and same_sp):
            raise RuntimeError(f"preemption drill: {out['preempt']}")

        # 3. the newest checkpoint silently corrupted: restore falls back
        ck = os.path.join(tmp, "corrupt")
        # (step 8 is written twice, by the periodic and the final save)
        with_faults("ckpt_corrupt@8:times=2",
                    lambda: drill_trainer(ck).train(8))
        rep = drill_trainer(ck).train(4)
        out["ckpt_corrupt"] = {"resumed_from": rep.resumed_from}
        print(f"recovery drill: ckpt_corrupt@8 on the newest checkpoint: "
              f"resumed from step {rep.resumed_from} (expected 4)")
        if rep.resumed_from != 4:
            raise RuntimeError(f"corrupt-checkpoint drill resumed from "
                               f"{rep.resumed_from}")

        # 4. 2 microbatches against 1 on one batch with every label real,
        # so both halves hold the same token count and the mean of the
        # halves' means is the batch's mean
        rng = np.random.RandomState(3)
        toks = sample_tokens(rng, (8, 33), 256)
        metrics = {}
        for n in (1, 2):
            tr = drill_trainer(None, microbatches=n)
            state = init_train_state(tr.model, tr.run)
            step = build_train_step(tr.model, tr.run, 16)
            batch = to_batch(toks[:, :-1], toks[:, 1:], tr.model.device)
            m = [step(state, batch)[1] for _ in range(2)]
            metrics[n] = ([float(x["loss"]) for x in m],
                          [float(x["grad_norm"]) for x in m],
                          state.params["layers.0.mixer.wq"].clone())
        (l1, g1, p1), (l2, g2, p2) = metrics[1], metrics[2]
        mrel = max(max(abs(a - b) / abs(a) for a, b in zip(l1, l2)),
                   max(abs(a - b) / abs(a) for a, b in zip(g1, g2)),
                   ((p1 - p2).abs().max() / p1.abs().max()).item())
        out["microbatches"] = {"rel": mrel}
        print(f"recovery drill: 2 microbatches vs 1 on one batch: losses "
              f"{l2} vs {l1}, grad norms {g2} vs {g1}, updated "
              f"layers.0.mixer.wq: max rel {mrel:.2e} (tol {TRAIN_REL})")
        if not mrel <= TRAIN_REL:
            raise RuntimeError(f"microbatch drill: rel {mrel}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def _cuda_ms(fn):
    """(fn's result, its time in ms to a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def _greedy_decode(model, cache, logits, width: int, steps: int):
    """``steps`` greedy decode steps after a prefill's last logits: the
    tokens (B, steps + 1), each step's ms, the cache."""
    tok = logits[:, -1].argmax(dim=-1)[:, None]
    toks, ms = [tok], []
    for i in range(steps):
        (lg, cache), t = _cuda_ms(
            lambda: model.decode_step(cache, tok, width + i))
        if not torch.isfinite(lg).all():
            raise RuntimeError(f"decode step {i}: logits not finite")
        tok = lg.argmax(dim=-1)[:, None]
        toks.append(tok)
        ms.append(t)
    return torch.cat(toks, dim=1), ms, cache


def llava_patches_phase(cfg) -> dict:
    """The image-patch frontend at full width: 2880 patch embeddings
    (anyres: 5 tiles of 576) in front of 256 tokens, batch 4, bf16; the
    flash kernel once per layer at S = 3136; then 8 greedy decode steps on
    a cache built with ``init_cache(prefix=)``."""
    t0 = time.perf_counter()
    model = build_model(cfg, BF16, device="cuda", seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device="cuda").manual_seed(2)
    n_img, n_tok, steps = LLAVA_PATCHES, LLAVA_TOKENS, 8
    batch = {"patches": torch.randn((4, n_img, cfg.d_model), generator=g,
                                    device="cuda").to(torch.bfloat16),
             "tokens": torch.randint(1, cfg.vocab_size, (4, n_tok),
                                     generator=g, device="cuda")}
    width = n_img + n_tok
    path = flash.select_path(torch.bfloat16, attention_heads(cfg)[2])
    with torch.inference_mode():
        model.prefill(batch)                  # warm up at this width
        zero_counts(flash)
        (logits, pre), pre_ms = _cuda_ms(lambda: model.prefill(batch))
        launches = (flash.launches, getattr(flash, f"launches_{path}"))
        cache = model.init_cache(4, width + steps, prefix=pre)
        del pre
        toks, dec_ms, cache = _greedy_decode(model, cache, logits, width,
                                             steps)
        del cache
    out = {"patches": n_img, "tokens": n_tok, "prefill_ms": pre_ms,
           "decode_ms": dec_ms, "flash_launches": launches[0],
           f"launches_{path}": launches[1],
           "tokens_out": toks[:, 1:].tolist(),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"llava patches: {cfg.name} at {_depth(cfg)}, bf16; prefill of "
          f"(4, {n_img} patches + {n_tok} tokens) {pre_ms:.1f} ms, flash "
          f"launches {launches[0]} (expected {cfg.num_layers}; "
          f"{launches[1]} on the {path} path), {steps} decode steps "
          f"{np.median(dec_ms):.1f} ms median; peak {out['peak_gb']:.2f} "
          f"GB; phase {time.perf_counter() - t0:.1f} s")
    if launches != (cfg.num_layers, cfg.num_layers) \
            or not torch.isfinite(logits).all() \
            or logits.shape != (4, 1, model.vocab_p):
        raise RuntimeError(f"llava patch prefill: launches {launches}, "
                           f"logits {tuple(logits.shape)}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def whisper_phase() -> dict:
    """whisper-medium at full width and depth in bf16 (24 encoder + 24
    decoder layers): prefill of 1500 frames and 64 tokens at batch 4, then
    32 greedy decode steps; the flash kernel launches 24 + 24 + 24 = 72
    times a prefill (encoder self-attention and decoder cross-attention
    non-causal, decoder self-attention causal) and 24 a decode step (the
    cross-attention; decode self-attention is plain), all on the path
    select_path gives."""
    cfg = get_model_config(WHISPER_ARCH)
    t0 = time.perf_counter()
    model = build_model(cfg, BF16, device="cuda", seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_params = sum(p.numel() for p in model.parameters())
    g = torch.Generator(device="cuda").manual_seed(3)
    se, n_tok, steps = cfg.encoder.max_source_len, 64, 32
    batch = {"frames": torch.randn((4, se, cfg.d_model), generator=g,
                                   device="cuda").to(torch.bfloat16),
             "tokens": torch.randint(1, cfg.vocab_size, (4, n_tok),
                                     generator=g, device="cuda")}
    path = flash.select_path(torch.bfloat16, cfg.resolved_head_dim)
    want_pre = expected_launches(cfg, BK.ATTENTION, False, 0)
    want_dec = expected_launches(cfg, BK.ATTENTION, False, 1) - want_pre
    with torch.inference_mode():
        model.prefill(batch)                  # warm up
        zero_counts(flash)
        (logits, pre), pre_ms = _cuda_ms(lambda: model.prefill(batch))
        pre_launches = flash.launches
        pre_on_path = getattr(flash, f"launches_{path}")
        cache = model.init_cache(4, n_tok + steps, prefix=pre)
        del pre
        zero_counts(flash)
        toks, dec_ms, cache = _greedy_decode(model, cache, logits, n_tok,
                                             steps)
        dec_launches = flash.launches
        on_path = getattr(flash, f"launches_{path}")
        del cache
    out = {"arch": WHISPER_ARCH, "params_b": n_params / 1e9,
           "prefill_ms": pre_ms, "decode_ms_median": float(np.median(dec_ms)),
           "decode_ms": dec_ms, "flash_launches_prefill": pre_launches,
           "flash_launches_decode": dec_launches,
           f"launches_{path}_prefill": pre_on_path,
           f"launches_{path}_decode": on_path,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"whisper: {WHISPER_ARCH} at {_depth(cfg)} ({_describe(cfg)}), "
          f"bf16, {n_params / 1e9:.3f} B parameters; prefill of ({4}, {se} "
          f"frames + {n_tok} tokens) {pre_ms:.1f} ms, flash launches "
          f"{pre_launches} (expected {want_pre}), {pre_on_path} of them on "
          f"the {path} path; {steps} decode steps "
          f"{out['decode_ms_median']:.1f} ms median, flash launches "
          f"{dec_launches} (expected {want_dec} x {steps} = "
          f"{want_dec * steps}), {on_path} of them on the {path} path; "
          f"peak {out['peak_gb']:.2f} GB; phase "
          f"{time.perf_counter() - t0:.1f} s")
    if pre_launches != want_pre or pre_on_path != pre_launches \
            or dec_launches != want_dec * steps or on_path != dec_launches \
            or not torch.isfinite(logits).all():
        raise RuntimeError(f"whisper: launches {pre_launches} / "
                           f"{dec_launches} ({pre_on_path} / {on_path} on "
                           f"{path})")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mtp_loss_phase() -> dict:
    """deepseek-v3's loss with its MTP head, forward only, bf16, at full
    width and 1 of its 61 layers plus the MTP block (two MLA + MoE blocks:
    49 GB); batch 4 x 512 tokens. Every metric finite; the flash kernel
    once in the layer and once in the MTP block."""
    cfg = get_model_config(DEEPSEEK_ARCH).with_overrides(num_layers=1)
    t0 = time.perf_counter()
    model = build_model(cfg, BF16, device="cuda", seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device="cuda").manual_seed(4)
    toks = torch.randint(1, cfg.vocab_size, (4, 513), generator=g,
                         device="cuda")
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    with torch.inference_mode():
        model.loss(batch)                     # warm up
        zero_counts(flash)
        (loss, metrics), ms = _cuda_ms(lambda: model.loss(batch))
    vals = {k: float(v) for k, v in metrics.items()}
    out = {"loss": float(loss), "metrics": vals, "ms": ms,
           "flash_launches": flash.launches,
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"mtp loss: {DEEPSEEK_ARCH} at {_depth(cfg)} plus the MTP block, "
          f"bf16, batch 4 x 512: loss {out['loss']:.4f} = xent "
          f"{vals['xent']:.4f} + 0.3 x mtp {vals['mtp']:.4f} + aux "
          f"{vals['aux']:.6f}, {ms:.1f} ms; flash launches "
          f"{flash.launches} (expected 2); peak {out['peak_gb']:.2f} GB; "
          f"phase {time.perf_counter() - t0:.1f} s")
    if set(vals) != {"xent", "aux", "mtp"} \
            or not all(math.isfinite(v) for v in vals.values()) \
            or flash.launches != 2:
        raise RuntimeError(f"mtp loss: {out}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out


FLASH_KERNEL = ("flash_attention", flash, BK.ATTENTION, False)
WKV6_KERNEL = ("wkv6", wkv6, BK.RWKV, True)
MAMBA_KERNEL = ("mamba_scan", mamba, BK.MAMBA, True)
FLASH_MLA = ("flash_attention", flash, BK.MLA, False)


def zoo_training_phases() -> tuple:
    """A training phase for each kernel path of the zoo (WKV6, the scan
    beside attention and the MoE, flash at MLA's head_dim 192 with the MTP
    loss, flash at whisper's head_dim 64 over 1500 frames), then each
    one's fp32 kernel-against-plain parity at the least depth its config
    allows."""
    jamba = get_model_config(JAMBA_ARCH).with_overrides(
        num_layers=JAMBA_TRAIN_LAYERS)
    deepseek = get_model_config(DEEPSEEK_ARCH).with_overrides(num_layers=1)
    whisper = get_model_config(WHISPER_ARCH)
    trained = {
        f"{RWKV_ARCH} training": train_zoo_phase(
            get_model_config(RWKV_ARCH), [WKV6_KERNEL], RWKV_TRAIN_STEPS,
            trainer=True, lr=RWKV_TRAIN_LR),
        f"{JAMBA_ARCH} training": train_zoo_phase(
            with_experts(jamba, JAMBA_TRAIN_EXPERTS),
            [MAMBA_KERNEL, FLASH_KERNEL], JAMBA_TRAIN_STEPS, trainer=True),
        f"{DEEPSEEK_ARCH} training": train_zoo_phase(
            with_experts(deepseek, DEEPSEEK_TRAIN_EXPERTS), [FLASH_MLA],
            DEEPSEEK_TRAIN_STEPS, trainer=False),
        f"{WHISPER_ARCH} training": train_zoo_phase(
            whisper, [FLASH_KERNEL], WHISPER_TRAIN_STEPS, trainer=False)}
    parity = [
        # run free, rwkv6's third step (grad norm 99 after 19 and 37) turns
        # the lr-sized Adam differences of the first two into a grad norm
        # 1.3e-3 apart, while the WKV6 kernel's forward on its inputs is
        # 1.1e-6 of max |y| from the plain one: each step from one state
        training_parity_phase(
            get_model_config(RWKV_ARCH).with_overrides(num_layers=2),
            [WKV6_KERNEL], ("embed", "layers.0.mixer.w_r",
                            "layers.1.mixer.u", "lm_head"), resync=True),
        training_parity_phase(
            with_experts(jamba, JAMBA_PARITY_EXPERTS),
            [MAMBA_KERNEL, FLASH_KERNEL],
            ("layers.0.mixer.in_proj", "layers.0.mixer.A_log",
             "layers.1.ffn.e_wg", "layers.4.mixer.wq", "lm_head")),
        # with the MTP block (3.0 B) fp32 AdamW ran out of the card's memory
        training_parity_phase(
            with_experts(deepseek, DEEPSEEK_PARITY_EXPERTS).with_overrides(
                mtp_depth=0), [FLASH_MLA],
            ("layers.0.mixer.w_uq", "layers.0.ffn.e_wg", "lm_head")),
        training_parity_phase(
            whisper.with_overrides(num_layers=2, encoder=dataclasses.replace(
                whisper.encoder, num_layers=2)), [FLASH_KERNEL],
            ("enc_layers.0.attn.wq", "dec_layers.1.cross.wk", "embed"))]
    return trained, parity


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_run = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(card_line())
    build_kernels()
    cells = kernel_phase()
    cells_bwd = lstm_bwd_phase()
    seq = lstm_seq_phase()
    launches, bwd_launches, gnmt = main_path_phase()
    projection = projection_phase(gnmt)
    parity_phase()
    ds2 = ds2_phase()
    ds2_parity_phase()
    print("reproduction " + json.dumps({
        res["network"]: {
            "device": res["device"],
            "iterations": res["num_iterations"],
            "runtime_by_sl": res["wallclock"]["runtime_by_sl"],
            "error_pct": {n: m["error_pct"] for n, m in
                          res["wallclock"]["methods"].items()},
            "points": {n: m["num_points"] for n, m in
                       res["wallclock"]["methods"].items()},
            "profiling": res["wallclock"]["profiling"],
            "track_a": {n: {c: [v["time_error_pct"], v["speedup_error_pp"]]
                            for c, v in m["per_config"].items()}
                        for n, m in res["analytic"]["methods"].items()},
            "per_sl_stats": res["analytic"]["per_sl_stats"],
        } for res in (gnmt, ds2)}))
    fa = flash_phase()
    fa_bwd = flash_bwd_phase()
    served = serving_phase(get_model_config(SERVE_ARCH), [FLASH_KERNEL])
    serving_parity_phase(get_model_config(SERVE_ARCH), [FLASH_KERNEL])
    wk = wkv6_phase()
    wk_bwd = wkv6_bwd_phase()
    served_rwkv = serving_phase(get_model_config(RWKV_ARCH), [WKV6_KERNEL])
    serving_parity_phase(get_model_config(RWKV_ARCH), [WKV6_KERNEL])
    ms = mamba_phase()
    ms_bwd = mamba_bwd_phase()
    jamba = get_model_config(JAMBA_ARCH)
    served_jamba = serving_phase(
        jamba.with_overrides(num_layers=JAMBA_LAYERS),
        [MAMBA_KERNEL, FLASH_KERNEL])
    serving_parity_phase(jamba.with_overrides(num_layers=JAMBA_PARITY_LAYERS),
                         [MAMBA_KERNEL, FLASH_KERNEL])
    zoo = {}
    for arch, layers in ZOO_DEPTHS:
        cfg = get_model_config(arch)
        # serving runs no MTP head, so none is built
        cfg = cfg.with_overrides(num_layers=layers or cfg.num_layers,
                                 mtp_depth=0)
        zoo[arch] = serving_phase(
            cfg, [FLASH_MLA if cfg.mla is not None else FLASH_KERNEL],
            sched=False)
    patches = llava_patches_phase(get_model_config(LLAVA_ARCH))
    whisper = whisper_phase()
    mtp = mtp_loss_phase()
    wcfg = get_model_config(WHISPER_ARCH)
    serving_parity_phase(
        wcfg.with_overrides(num_layers=2, encoder=dataclasses.replace(
            wcfg.encoder, num_layers=2)),
        [FLASH_KERNEL])
    serving_parity_phase(get_model_config(DEEPSEEK_ARCH).with_overrides(
        num_layers=1, mtp_depth=0), [FLASH_MLA])
    print("serving " + json.dumps({SERVE_ARCH: served,
                                   RWKV_ARCH: served_rwkv,
                                   JAMBA_ARCH: served_jamba, **zoo,
                                   f"{LLAVA_ARCH} patches": patches,
                                   WHISPER_ARCH: whisper,
                                   f"{DEEPSEEK_ARCH} mtp loss": mtp}))
    trained = training_phase()
    parity = training_parity_phase(
        get_model_config(TRAIN_ARCH).with_overrides(
            num_layers=TRAIN_PARITY_LAYERS), [FLASH_KERNEL],
        TRAIN_PARITY_LEAVES)
    drill = recovery_drill_phase()
    remat = remat_phase()
    zoo_trained, zoo_parity = zoo_training_phases()
    print("training " + json.dumps({TRAIN_ARCH: trained, "parity": parity,
                                    "recovery_drill": drill,
                                    "remat": remat, **zoo_trained,
                                    "zoo_parity": zoo_parity}))
    dist_out = dist_phase()
    print("distribution " + json.dumps(dist_out))
    print("dryrun " + json.dumps(dryrun_phase()))
    print("projection " + json.dumps(projection))
    print(f"flash_bwd_plain calls on CUDA tensors outside phase 5b's "
          f"comparisons: {flash_ops.plain_cuda_calls} (expected 0); "
          f"lstm_cell_bwd_plain outside phase 2b's: "
          f"{lstm_ref.plain_cuda_calls} (expected 0)")
    if flash_ops.plain_cuda_calls or lstm_ref.plain_cuda_calls:
        raise RuntimeError("a backward ran a plain version on the card")

    print(f"whole run: {time.perf_counter() - t_run:.1f} s")

    def zoo_launches(name: str, key: str = "launches") -> dict:
        """A kernel's launches in each zoo training phase that runs it."""
        return {phase: out[key][name]
                for phase, out in zoo_trained.items()
                if name in out[key]}

    def bwd_entry(name, lib, replaces, rows, main, phase, note) -> dict:
        """A backward kernel's entry: launches from its training phase,
        times and bound at the training shape, every row beside."""
        row = rows[main]
        return {
            "name": f"{name}_bwd", "route": "cuda", "source": lib,
            "replaces": replaces,
            "launches": zoo_trained[phase]["bwd_launches"][name],
            "launches_by_path": zoo_launches(name, "bwd_launches"),
            "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            "max_rel_err": max(r["max_rel_err"] for r in rows.values()),
            "ms": row["ms"], "kernel_ms": row["ms"],
            "eager_ms": row["eager_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library_note": row.get("library_note") or note,
            "shape": {k: row[k] for k in row
                      if k in ("B", "S", "H", "dh", "D", "N", "dtype", "Hq",
                               "Hkv", "Sq", "Skv", "path")},
            "shapes": list(rows.values())}

    main_row = cells[MAIN_SHAPE]
    print(json.dumps({"kernels": [{
        "name": "lstm_cell", "route": "cuda",
        "source": "src/repro_torch/kernels/lstm_cell/csrc/lstm_cell.cu",
        "replaces": "src/repro/kernels/lstm_cell/kernel.py:44",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in cells.values()),
        "ms": main_row["ms"], "kernel_ms": main_row["ms"],
        "eager_ms": main_row["eager_ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": {k: main_row[k] for k in ("B", "D", "H")},
        "shapes": list(cells.values()),
    }, {
        "name": "lstm_cell_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/lstm_cell/csrc/lstm_cell_bwd.cu",
        "replaces": "src/repro/models/rnn.py:62 (XLA's autodiff of the "
                    "lax.scan over the plain cell; no Pallas backward)",
        "launches": bwd_launches,
        "max_abs_err": max(r["max_abs_err"] for r in cells_bwd.values()),
        "ms": cells_bwd[MAIN_SHAPE]["ms"],
        "kernel_ms": cells_bwd[MAIN_SHAPE]["ms"],
        "eager_ms": cells_bwd[MAIN_SHAPE]["eager_ms"],
        "plain_ms": cells_bwd[MAIN_SHAPE]["plain_ms"],
        "bound_ms": cells_bwd[MAIN_SHAPE]["bound_ms"],
        "bound_by": cells_bwd[MAIN_SHAPE]["bound_by"],
        "library_ms": cells_bwd[MAIN_SHAPE]["library_ms"],
        "library_note": cells_bwd[MAIN_SHAPE]["library_note"],
        "shape": {k: cells_bwd[MAIN_SHAPE][k] for k in ("B", "D", "H")},
        "shapes": list(cells_bwd.values()),
        "sequence": seq,
    }, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:76",
        "launches": served["kernels"]["flash_attention"]["launches"],
        "launches_by_path": {
            arch: out["kernels"]["flash_attention"]["launches"]
            for arch, out in ((SERVE_ARCH, served),
                              (JAMBA_ARCH, served_jamba), *zoo.items())}
        | {f"{LLAVA_ARCH} patches": patches["flash_launches"],
           f"{WHISPER_ARCH} prefill": whisper["flash_launches_prefill"],
           f"{WHISPER_ARCH} decode": whisper["flash_launches_decode"],
           f"{DEEPSEEK_ARCH} mtp loss": mtp["flash_launches"],
           f"{TRAIN_ARCH} training": trained["flash_launches"]}
        | zoo_launches("flash_attention"),
        "launches_tc": served["kernels"]["flash_attention"]["launches_tc"],
        "max_abs_err": max(r["max_abs_err"] for r in fa.values()),
        "ms": fa[FLASH_MAIN]["ms"], "kernel_ms": fa[FLASH_MAIN]["ms"],
        "plain_ms": fa[FLASH_MAIN]["plain_ms"],
        "bound_ms": fa[FLASH_MAIN]["bound_ms"],
        "bound_by": fa[FLASH_MAIN]["bound_by"],
        "library_ms": fa[FLASH_MAIN]["library_ms"],
        "shape": {k: fa[FLASH_MAIN][k] for k in ("B", "Hq", "Hkv", "Sq",
                                                 "Skv", "dh", "dtype",
                                                 "path")},
        "shapes": list(fa.values()),
    }, {
        **bwd_entry(
            "flash_attention",
            "src/repro_torch/kernels/flash_attention/csrc/"
            "flash_attention_bwd.cu",
            "src/repro/kernels/flash_attention/ops.py:42 (the VJP of the "
            "oracle; no Pallas backward)", fa_bwd, FLASH_BWD_MAIN,
            f"{DEEPSEEK_ARCH} training", "scaled_dot_product_attention's "
            "backward under autograd, its forward subtracted"),
        "launches": trained["flash_bwd_launches"],
        "launches_tc": trained["flash_bwd_launches_tc"],
        "launches_by_path": {f"{TRAIN_ARCH} training":
                             trained["flash_bwd_launches"]}
        | zoo_launches("flash_attention", "bwd_launches"),
    }, {
        "name": "wkv6", "route": "cuda",
        "source": "src/repro_torch/kernels/rwkv6_wkv/csrc/wkv6.cu",
        "replaces": "src/repro/kernels/rwkv6_wkv/kernel.py:66",
        "launches": served_rwkv["kernels"]["wkv6"]["launches"],
        "launches_by_path": {
            f"{RWKV_ARCH} serving":
                served_rwkv["kernels"]["wkv6"]["launches"]}
        | zoo_launches("wkv6"),
        "max_abs_err": max(r["max_abs_err"] for r in wk.values()),
        "ms": wk[WKV_MAIN]["ms"], "kernel_ms": wk[WKV_MAIN]["ms"],
        "eager_ms": wk[WKV_MAIN]["eager_ms"],
        "plain_ms": wk[WKV_MAIN]["plain_ms"],
        "bound_ms": wk[WKV_MAIN]["bound_ms"],
        "bound_by": wk[WKV_MAIN]["bound_by"],
        "library_ms": None,
        "library_note": "no single PyTorch call computes the WKV6 "
                        "recurrence",
        "decode_ms": wk[WKV_DECODE]["ms"],
        "decode_eager_ms": wk[WKV_DECODE]["eager_ms"],
        "decode_bound_ms": wk[WKV_DECODE]["bound_ms"],
        "shape": {k: wk[WKV_MAIN][k] for k in ("B", "S", "H", "dh")},
        "shapes": list(wk.values()),
    }, {
        "name": "mamba_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan/kernel.py:55",
        "launches": served_jamba["kernels"]["mamba_scan"]["launches"],
        "launches_by_path": {
            f"{JAMBA_ARCH} serving":
                served_jamba["kernels"]["mamba_scan"]["launches"]}
        | zoo_launches("mamba_scan"),
        "max_abs_err": max(r["max_abs_err"] for r in ms.values()),
        "ms": ms[MAMBA_MAIN]["ms"], "kernel_ms": ms[MAMBA_MAIN]["ms"],
        "eager_ms": ms[MAMBA_MAIN]["eager_ms"],
        "plain_ms": ms[MAMBA_MAIN]["plain_ms"],
        "bound_ms": ms[MAMBA_MAIN]["bound_ms"],
        "bound_by": ms[MAMBA_MAIN]["bound_by"],
        "library_ms": None,
        "library_note": "none: no PyTorch call computes the selective scan",
        "decode_ms": ms[MAMBA_DECODE]["ms"],
        "decode_eager_ms": ms[MAMBA_DECODE]["eager_ms"],
        "decode_bound_ms": ms[MAMBA_DECODE]["bound_ms"],
        "shape": {k: ms[MAMBA_MAIN][k] for k in ("B", "S", "D", "N",
                                                 "dtype")},
        "shapes": list(ms.values()),
    }, bwd_entry(
        "wkv6", "src/repro_torch/kernels/rwkv6_wkv/csrc/wkv6_bwd.cu",
        "src/repro/kernels/rwkv6_wkv/ops.py:34 (the VJP of the oracle; "
        "no Pallas backward)", wk_bwd, WKV_BWD_MAIN,
        f"{RWKV_ARCH} training",
        "none: no PyTorch call computes WKV6's gradient"),
        bwd_entry(
        "mamba_scan",
        "src/repro_torch/kernels/mamba_scan/csrc/mamba_scan_bwd.cu",
        "src/repro/kernels/mamba_scan/ops.py:24 (the VJP of the oracle; "
        "no Pallas backward)", ms_bwd, MAMBA_BWD_MAIN,
        f"{JAMBA_ARCH} training",
        "none: no PyTorch call computes the selective scan's gradient")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["dryrun"]:
        sys.exit(_dryrun_main(sys.argv[2]))
    sys.exit(main())
