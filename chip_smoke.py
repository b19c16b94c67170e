#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card (written for an H100) and the CUDA toolkit; it
imports nothing of JAX and nothing of the JAX package.  Phases:

1. set-up: the card's name and power limit, the kernels' build (one nvcc
   per CUDA source, all at once; the redesigned kernels, ``flash_fwd``,
   ``flash_dq``, ``flash_dkv``, the tiled selection kernels, ``local_dq``
   and ``local_dkv`` in every variant and ``local_fwd_mma``, must build
   with 0 bytes spilled at head dims 64 and 128, ``bta_fwd_mma`` /
   ``bta_bwd_mma`` at 64 and 128, ``bta_fwd_fma`` / ``bta_bwd_fma`` at 16
   and 32, and ``varlen_fwd_fma``, ``varlen_dq_fma``
   and ``varlen_dkv_fma`` at 16, 32 and 64, ``selection_fwd_groups`` at
   16, 32 and 64 and ``epilogue_bwd_vec`` at every lanes count, by ptxas's
   report: ``NO_SPILL``), TF32 off for every fp32 product;
2. kernels: each CUDA kernel against its plain PyTorch version on the card,
   in fp32 and bf16 and, for flash, in its causal modes too (fp32; the
   tiled ``flash_fwd``: register tiles in fp32, tensor cores in bf16); with
   the median time of kernel, plain version and (where one exists) the
   library call, and the least time the H100 could take for the same work.
   The ball kernels' rows also give the kernel's own device time from the
   profiler, SDPA's (forward, or forward + backward − forward) and the path
   ``bta.bta_plan`` picks (``fma`` in fp32, ``mma`` in bf16).
   The four padded forward kernels run at the shapes serving
   ``shapenet-bsa`` gives them (8 slots of 3840 points, sample 0 padded
   from a 3586-point cloud, the others 2800–3586 points, 8 heads of 32);
   the five padded backward kernels at the shapes one train step gives them
   (8 train clouds of 3586 points padded to 3840), with the upstream
   gradient zero on padded query rows as the combine gives it; the
   selection backward on each layer's own top-k picks in the model's first
   train step (mode ``topk``, the main path's traffic) and on uniform
   random picks; its warp path (``selection_bwd``) must give identical
   bits on two calls, and a ``selection_bwd_warp`` line gives its device
   time by pass (the rank pass, the kernel, the reduce), the whole call's
   and the selections each block received (max, mean).  The three
   packed-varlen kernels: ``varlen_fwd`` at the shapes packed serving gives
   the compression branch (the first 8 serving clouds packed to a capacity
   of 30,720 rows, queries against the 3840 pooled keys, ``k_offsets =
   offsets / 8``), ``varlen_dq`` and ``varlen_dkv`` at the packed train
   batch's (fp32 on the planned walks, ``varlen.varlen_plan``: the row
   tiles of ``occupancy.varlen_row_tiles`` for the forward and dQ, the key
   tiles and splits of ``occupancy.varlen_dkv_tiles`` for dK/dV; each of
   the three kernels gives identical bits on two calls: the
   ``varlen_repro`` lines), with their device times and paths; then the
   ``output_hashes`` line: hashes of every kernel's outputs on seeded
   inputs, which hold a change that moves a kernel's code to its parent's
   bits.  ``selection_fwd`` (shapenet's groups of 8 rows: the ``groups``
   path in fp32, ``selection.selection_plan``) runs on random picks and on
   each layer's own picks in the model's first train step (mode ``topk``),
   both with its device time, its path and identical bits on two calls;
   the epilogues give their device time at every shape they run (shapenet,
   the LM, D 128) and the kernel ``epilogue.epilogue_plan`` names (``vec``
   at every shape here), ``epilogue_bwd`` identical bits on two calls;
   ``epilogue_fwd`` takes per-head gates and the (B·N,) mask as the layer
   hands them over, and beside each of its rows a ``*_call`` row times the
   layer's call, ``ops.gated_combine``, which must launch ``epilogue_fwd``
   and no other kernel; the line also carries ``paths``
   (``path_hashes``): the served output of a 2-layer ``shapenet-bsa`` and
   the logits of 130 paged decode steps of a 2-layer ``tinyllama-1.1b``,
   so a change can be held to its parent's bits end to end;
3. serve, padded then packed: ``shapenet-bsa`` at full width (18 layers,
   random weights from a seed) serves 16 synthetic clouds of 2800–3586
   points through ``GeometryEngine(batch_slots=8)`` (the ball kernels on
   their ``fma`` path, ``bta.bta_plan``), ``layout="padded"``
   with ``pad_to=3840`` and ``layout="packed"`` with ``pad_to=30720`` (the
   same capacity), each after a warm-up batch; each forward kernel of the
   layout's path must have launched 18 times per batch (and no other
   kernel), the outputs must be finite with one row per point, and on one
   batch every layer of the kernel path must match the ``reference``
   backend given the same layer input (``reference_check``); the packed
   and padded outputs are compared (information: top-k near-ties may
   flip);
4. train, padded then packed: ``shapenet-bsa`` at full width and depth
   (18 layers, fp32; the ball kernels on their ``fma`` path) takes one
   warm-up step and then ``TRAIN_STEPS`` (3) timed steps of
   ``make_train_step`` (masked MSE, backward, clipping at 1.0, AdamW at lr
   1e-3 with warm-up and cosine decay over 300 steps, weight decay 0.01),
   padded on batches of 8 ShapeNet-Car train clouds padded to 3840, packed
   on batches of 8 train clouds of 2800–3586 points packed to 30,720 rows
   with their offsets on the host; loss and every gradient must be finite,
   each kernel of the layout's path must have launched 18 times per step
   (and no other kernel), and on one batch every layer's parameter and
   input gradients on the kernel path must match the ``reference``
   backend's given the same layer input and upstream gradient, within 1e-4
   of each tensor's largest value, and every layer's output within 1e-3
   (``train_reference_check``).
5. baselines: the paper's other workloads (``BASELINES``), each at full
   width and depth (18 layers, d_model 256, 8 heads of 32, fp32, weights
   from seed 0): ``shapenet-full`` (dense attention with a key mask: the
   flash kernels at 3840 queries × 3840 keys), ``shapenet-erwin`` (ball
   attention at the levels 0, 1, 2, 1, … of its layers: the ball kernels on
   pooled sequences of 4096, 2048 and 1024 tokens; its clouds pad to 4096,
   since its levels 1 and 2 need a multiple of 512 and 1024),
   ``shapenet-bsa-group-cmp`` (group compression with φ = "mlp": the flash
   kernels at 480 pooled queries × 480 pooled keys) on batches of 8
   ShapeNet-Car train clouds, and ``elasticity-bsa`` / ``elasticity-full``
   on batches of 8 ``ElasticityDataset`` plates (972 points padded to
   1024).  First the flash kernels at the full shape and the ball kernels
   at Erwin's three pooled shapes against their plain versions, timed with
   their device times beside SDPA with the same mask (``flash_dkv``: its
   row splits, identical bits on two calls); then each config takes one
   warm-up step and three timed steps of ``make_train_step`` as in phase
   4: loss and gradients finite, each kernel of its path (``train_full``:
   the flash trio; ``train_erwin``: the ball pair; the BSA configs:
   ``train_padded``) launched 18 times a step and no other kernel, the ball
   kernels on their ``fma`` path, and every layer held to the reference
   backend as in phase 4 (an Erwin layer at its own level);

6. LM kernels: ``local_fwd`` (B = 1, N = 4096, rep 8, D 64, window 256,
   a padded tail, a hole and a packed-sample boundary; bf16 on the tiled
   path, fp32 on the rows path, ``local.local_plan``), ``paged_gather``
   (the serving pool of 65 blocks of 256 rows of 4 × 64: one decode step's
   local-window gather of 8 slots, 4096 rows from ``paged_step``, as int32
   and as int64 indices, and its 8 compressed rows, int64; each timed per
   call with host work, by its device time from the profiler, and beside
   ``index_select`` on the same rows; a call must launch no other kernel)
   and ``paged_gather_pair`` (the K and V pools gathered with one row list,
   as the decode gathers them: the window's rows as int32 and int64, the 8
   compressed rows int64 and every block's 256 compressed rows int32; exact
   against the plain pair, timed likewise, with one and two
   ``index_select`` calls beside)
   in fp32 and bf16 against their plain versions, and ``flash_fwd``
   (block-causal, timed beside SDPA with the dense block-causal mask; the
   kernels line gives this row as
   ``flash_fwd``'s ``lm_prefill``), ``selection_fwd`` and ``epilogue_fwd``
   at the shapes one 32,768-token sequence of the prefill gives them (32
   query heads on 4 KV heads of 64, ℓ = 64, k* = 16, g = 64, so 512 rows a
   group); then head_dim 128: each kernel of
   the causal path, the two epilogues and ``paged_gather_pair`` in fp32 and bf16
   at phi4-mini's heads (24 query on 8 KV heads of 128, ``LM_BSA``, one
   4,096-token sequence) against its plain version, timed, with SDPA on the
   same dense mask beside ``local_fwd``, the local backward and
   ``flash_fwd``;
7. prefill: ``make_prefill_step`` on ``tinyllama-1.1b`` at full width and
   depth (22 layers, d_model 2048, 32 / 4 heads of 64, vocabulary 32,000,
   bf16, random weights from seed 0) over B = 2 × N = 32,768 random tokens
   (``prefill_32k``'s sequence length, its global batch of 32 cut to 2 for
   one card); ``local_fwd`` must take its tiled path (``local_fwd_mma``);
   it must launch exactly 22 each of ``local_fwd``,
   ``flash_fwd``, ``selection_fwd`` and ``epilogue_fwd`` and no other
   kernel (the profile line gives ``local_fwd``'s device time a launch
   beside its bound at this shape), and every layer on the kernel path must match the ``reference``
   backend given the same layer input within 4e-2 of the layer output's
   largest value (the repository's bf16 tolerance);
8. decode oracle: ``nsa_causal_decode_paged`` at the full width's heads
   (32 / 4 of 64, fp32, ``LM_BSA`` with ``group_size=0,
   query_cmp_selection=False``, the configuration whose decode is exact
   against the forward) over a shuffled block table and three staggered
   slots of 1,100–1,600 tokens must match ``nsa_causal_attention`` on the
   kernel path at every position within 1e-4 of the output's largest value;
9. serving: ``tinyllama-1.1b`` at full width and 2 of its 22 layers
   (``SERVE_LM_LAYERS``: the run's time limit), through
   ``ServingEngine(paged=True)`` with 8 slots, ``max_len`` 2048,
   pages of 256 serves 10 greedy requests of 1,100–1,600 random tokens
   (numpy seed 0), 8 new tokens each; requests 0, 1 and 8 open with the
   same 512 tokens (a shared system prompt; request 8, admitted after the
   first slot retires, reuses the sealed pages), and an 11th request is
   exactly those 512 tokens: it reuses both sealed pages and must
   copy-on-write the second (``cow_copies`` ≥ 1, ``kv.check()``); the serve
   must launch ``paged_gather_pair`` 4 times a layer and step (the φ-block,
   the completed compressed row, the window, every block's compressed row:
   each from the K and the V pool at once) and no other kernel; requests 0,
   9 and 10 are also generated by B = 1 lockstep ``generate`` (three
   processes side by side, after the serve) and their tokens must equal the
   served ones, or part at a near-tie (the lockstep top-two logit gap there
   below 4e-2 of the largest |logit|); three more decode steps are profiled,
   and three timed with the host time of their ``paged_gather_pair`` calls
   taken apart (``decode_profile``);
10. LM backward kernels: ``local_dq`` and ``local_dkv`` against their plain
   version in fp32 (the lanes path) and bf16 (the tiled path on the tensor
   cores, ``local.local_plan``) on the ``local_fwd`` case of phase 6 and at
   the LM train shapes (B = 2 × 4096 tokens, no mask), within 1e-4 (fp32)
   and 4e-2 (bf16) of each gradient's largest value, timed with one
   liveness map for both, as ``local_window_bwd`` shares it, beside SDPA
   with the dense banded mask (forward + backward − forward); and, at the train
   shapes in bf16, ``flash_dq`` / ``flash_dkv`` block-causal against the
   64 pooled keys, ``selection_fwd``, ``selection_dq`` and
   ``selection_dkv`` (the tiled path) on each layer's own picks (512 rows a
   group) beside SDPA with the dense mask, and ``epilogue_bwd``;
11. LM train: ``make_train_step`` on ``tinyllama-1.1b`` at full width and
   depth (bf16 parameters, fp32 AdamW moments, remat on, random weights
   from seed 0) over ``lm_batches(seed=0)`` at ``train_4k``'s length, B =
   2 × 4096 tokens (its global batch of 256 cut to 2 for one card): one
   warm-up step and three timed steps (AdamW as in phase 4); the loss,
   every gradient and the gradient norm must be finite, each step must
   launch every forward kernel of the prefill 44 times (22 and 22
   recomputed) and ``local_dq``, ``local_dkv``, ``flash_dq``,
   ``flash_dkv``, ``selection_dq``, ``selection_dkv`` and ``epilogue_bwd``
   22 times each (and no other kernel), and every layer's input and
   parameter gradients on the kernel path must match the ``reference``
   backend's within 6e-2 of each tensor's largest value (a parameter's
   floored at 1e-4 of the layer's largest parameter gradient), given the
   same layer input and upstream gradient (``lm_train_reference_check``).

12. quickstart (after the baselines): ``launch.quickstart`` on the card
   (sections 1–6 of ``examples/quickstart.py`` through
   ``repro_torch.core``, fp32, 4 heads of 16): its asserts pass, and
   ``bta_fwd``, ``flash_fwd``, ``selection_fwd``, ``epilogue_fwd`` and
   ``varlen_fwd`` each launch, no other kernel;
13. trainer: ``launch.train --arch shapenet-bsa --steps 3 --batch 8 --ckpt
   DIR`` through ``runtime.Trainer`` (each train-path kernel 18 times a
   step; steps numbered 0–2 as JAX numbers them), then a second ``Trainer``
   restores the checkpoint of step 2 (every parameter and AdamW moment bit
   for bit; the optimizer's count 3) and trains from step 2 on two more
   batches: its optimizer count is 5, its losses finite, and step 3's
   checkpoint exists (a fit never saves its first step, as in JAX);
14. the causal path's kernels at the new models' heads (``HEAD_ROWS``):
   stablelm-1.6b's 32 / 32 of 64 (rep 1) and granite-20b's 48 / 1 of 128
   (rep 48: selection groups of 3,072 rows) on one 4,096-token sequence in
   bf16, as phase 6 runs phi4-mini's, each against its plain version with
   its bound and SDPA's time on the same dense mask;
15. the other dense LMs (``DENSE_LMS``), after tinyllama's weights are
   freed, each at full width and at ``DENSE_DEPTH`` (stablelm 12 of its
   layers, phi4-mini 16, granite 13) with random weights from seed 0:
   ``stablelm-1.6b`` (24 layers, d 2048, 32 / 32 heads of 64, vocabulary
   100,352), ``phi4-mini-3.8b`` (32 layers, d 3072, 24 / 8 of 128,
   200,064) and ``granite-20b`` (52 layers, d 6144, 48 / 1 of 128, d_ff
   24,576, 49,152; 28.17 B parameters, 56.3 GB in bf16 at all 52).  Each prefills 1
   × 16,384 tokens (granite 1 × 4,096) as phase 7 does (launches, every
   layer within 4e-2 of the reference backend, a profiled call), decodes
   paged through ``api.paged_decode_step`` on its own config
   (``dense_decode_phase``: two staggered slots of 64 and 64 positions in
   bf16, launches, finite logits, ms a step), holds that entry point to the
   forward on the kernel path (``decode_hold``: each layer fed the
   forward's layer input, every attention output and the logits within
   1.5e-2 of the forward's largest value, position by position), and
   stablelm (2 × 4,096
   tokens) and phi4-mini (1 × 4,096) train 1 + ``DENSE_TRAIN_STEPS`` (1)
   steps as phase 11 does
   (launches, every layer's gradients within 6e-2, peak memory).  granite
   does not train: its fp32 AdamW moments alone would be 225 GB.
16. the other families (``family_phases``), each at its published widths,
   bf16, random weights from seed 0, each phase's seconds printed.  Their
   kernel rows run after phase 14's (``family_kernel_rows``), bf16, against
   their plain versions beside SDPA:
   seamless-m4t's encoder balls (``bta_fwd`` / ``bta_bwd`` on the mma
   path: 4096 frames, 16 heads of 64, balls of 256), the ball pair at
   llava's 56 / 8 heads of 128 (the mma path at D 128) and at seamless's
   heads in balls of 32 (the rows path, bf16), its cross-attention
   (the flash trio, 512 decoder rows against 4096 frames; ``flash_fwd``
   with one row at decode) and the causal path at qwen2-moe's 16 / 16
   heads of 128 (``rep1_d128``), phi3.5-moe's 32 / 8 (``rep4``) and
   llava's 56 / 8 (``rep7``: selection groups of 448 rows).  Then
   ``moe_phase``: qwen2-moe-a2.7b (24 layers, 60 routed experts top-4
   padded to 64, 4 shared; 15.15 B parameters) prefills 1 × 4,096 at full
   depth (launches; every layer held to the reference backend within 4e-2
   with the MoE routing held to the kernel path's, ``HeldRouting``: a
   router near-tie flips under bf16 rounding), decodes paged over two
   slots of 64 / 48 positions and holds that to the forward (positions
   whose last MoE layer dropped an assignment in the forward, or routed
   otherwise than the decode, left out of the logits and counted), and
   trains 1 + 2 steps at 4 of its 24 layers (fp32 moments of all 24 would
   need ~180 GB; gradients within 6e-2, the first layer's bits equal on
   two calls); phi3.5-moe prefills at 2 of its 32 layers (its bf16
   weights are 83.7 GB).  ``mamba_phase``: mamba2-1.3b (48 layers) at full
   depth prefills (no kernel: the chunked SSD is plain products), decodes
   paged with its hold (each layer's mamba output fed the forward's
   input), serves 6 requests of 64–128 tokens on 4 slots through
   ``ServingEngine(paged=True)`` (slots reused, ``cache_reset_slot``
   counted, requests 4 and 5, admitted into reused slots, against B = 1
   lockstep) and trains 1 + 2 steps.  ``encdec_phase``: seamless-m4t-medium (12 + 12 layers) trains
   1 + 2 steps on 1 × 4,096 frames (512 decoder tokens; each kernel's
   launches counted exactly), its encoder and decoder layers held to the
   reference backend (outputs 4e-2, gradients 6e-2, φ_k.pos against the
   layer's largest gradient: 0 in exact arithmetic), a layer's gradients
   bit-identical on two calls, then greedy-decodes 32 tokens through
   ``api.cache_init(params=, memory=)`` and ``api.decode_step``, held to
   ``decode_train`` with each decoder layer fed the forward's input.
   ``vlm_phase``: llava-next-34b (60 layers, d 7168, 56 / 8 heads of 128;
   34.45 B parameters) prefills 512 image + 3,584 text tokens at
   ``LLAVA_DEPTH`` (30) layers (all 60 leave 6 GB under 76 GB on an 80 GB
   card), every layer held to the reference backend.  jamba-1.5-large-398b runs
   on the CPU only (one 8-layer period is ~44 B parameters).
17. sharded (``sharded_phase``, last): the ``"sharded"`` backend in ranks
   that share the one card (spawned processes, a gloo group over
   localhost: NCCL refuses two ranks on one device; the ``kernels`` inner
   backend, the library built above).  ``shapenet-bsa`` at full width,
   ``SHARDED_PADDED_LAYERS`` (6) of its 18 layers, p = 3 (balls of 256
   split in 1,280-row shards): loss and every parameter gradient on one
   padded batch of 8 train clouds (each rank's launches: the ball, flash
   and epilogue kernels and their backwards once a layer, no selection
   kernel, the ring's products being plain), equal
   bits on every rank and on two calls, every layer held to the unsharded
   kernel path (``train_reference_check(..., backends=("sharded",
   "kernels"))``: outputs 1e-3, gradients 1e-4).  Its packed serving at
   p = 2 through ``GeometryEngine(backend="sharded")`` (8 clouds: the LPT
   segment plan, 54 output gathers and no other collective, held layer by
   layer and end to end at 1e-3 to the unsharded engine); the ball op
   warning and falling back at p = 2; the quickstart's section 7.
   ``tinyllama-1.1b`` at full width and ``SERVE_LM_LAYERS`` layers, p = 2:
   a 4,096-token prefill held layer by layer at 4e-2, then paged serving of
   5 requests on 4 slots through ``ServingEngine(backend="sharded")`` on
   row-partitioned pools (a copy-on-write across ranks), teacher-forced
   against the unsharded engine: each step's argmax equal or at a
   near-tie.  Training across ranks (``dp_train_case``, 4 ranks):
   ``Trainer(mesh=...)`` on a (2, 2) ("data", "model") mesh drives
   ``shapenet-bsa`` at full width and depth through 1 + 2 padded steps of
   8 clouds (4 a data rank; a checkpoint at the last) and a packed step,
   then a padded and a packed step from one shared state each way; held to
   the single-rank ``Trainer`` (free-running at 1e-3, the shared-state
   steps at 1e-5: loss, gradient norm, parameters; the one rank takes the
   mesh step's selection picks, ``HeldPicks``, as its ``model`` ranks
   split the heads, and its own picks may differ from them in at most
   ``PICKS_FLIP_TOL`` of the (group, head)s), parameters equal in
   bits on every rank, the moment bytes a rank against one rank's; then a
   restore on (4,) ("data",), bit-equal to one rank's restore of the same
   checkpoint, and one step.  ``remat_lm_case`` (2 ranks): tinyllama at full
   width, 2 layers, remat, one train step of 2 × 4,096 under
   ``mesh_context`` and the sharded backend (the backward and its
   recompute on autograd's device thread), held to remat off and to the
   unsharded kernel path (4e-2 / 6e-2).  ``pipeline_compress_case`` (2
   ranks): ``pipeline_apply`` over shapenet-bsa's 18 blocks as 2 stages of
   9, 4 microbatches of 2 clouds of 3,840 real points, held to the blocks
   in sequence (1e-5), and ``make_compressed_grad_fn`` over ("pod",): the
   pods' mean loss, gradients within 2e-2 of the exact mean, a non-zero
   residual.  Megatron's compute over ``model`` (``tp_train_case``, 2
   ranks on (1, 2)): tinyllama-1.1b and qwen2-moe-a2.7b (32 of 64 padded
   experts a rank) on 2 × 4,096 tokens, llava-next-34b on 512 image +
   3,584 text tokens, seamless-m4t-medium (2 + 2 layers) on 4,096 frames
   and 512 tokens and mamba2-1.3b (its scan on 32 of 64 heads a rank) on
   1 × 4,096, at full width and ``TP_LAYERS`` (2) layers, bf16, remat, 1 +
   2 steps through ``Trainer(mesh=...)``: launches (paths ``tp_train`` /
   ``tp_moe`` / ``tp_vlm`` / ``tp_encdec`` / ``tp_ssm``), the parameter
   bytes a rank holds (half of every cut weight, checked), peak memory,
   collectives and step times; parameters equal in bits on both ranks;
   each layer (llava's projector, seamless's encoder and decoder layers
   and ``frontend_proj`` too) held to one rank's given the same input and
   upstream gradient (4e-2 / 6e-2, the MoE routing held); a fp32 step from
   the same weights held to one rank's at 1e-5 (the one rank on the split
   step's selection picks: loss, gradient norm, the whole gradient, and
   every gradient but on llava and seamless, where fp32 rounds a tensor
   further; mamba2's also in float64, every gradient).  Each rank's
   launches are printed; the timings are of ranks sharing one card, no
   scaling number.

``$REPRO_TORCH_ATTENTION_BACKEND`` must be unset: it would beat every
backend the script names.  The shapenet paths run at full width and
depth but the sharded padded case (``SHARDED_PADDED_LAYERS``); the dense
LMs run at ``DENSE_DEPTH`` (stablelm 6 of 24 layers, phi4-mini 8 of 32,
granite-20b 6 of 52).  Any failed check exits
non-zero before the result lines.  On
success the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import hashlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import nsa_causal  # noqa: E402
from repro_torch.core.backend import ENV_VAR, use_backend  # noqa: E402
from repro_torch.core.balltree import pack_varlen  # noqa: E402
from repro_torch.data.elasticity import ElasticityDataset  # noqa: E402
from repro_torch.data.lm import lm_batches  # noqa: E402
from repro_torch.data.shapenet import N_POINTS, ShapeNetCarDataset, make_clouds  # noqa: E402
from repro_torch.kernels import (_build, bta, epilogue, flash, local, ops,  # noqa: E402
                                 paged, selection, varlen)
from repro_torch.kernels.common import (COUNTERS, HEAD_DIMS, reset_counters,  # noqa: E402
                                        row_delta)
from repro_torch.kernels.occupancy import (ranges_live_map, tile_seg_ranges,  # noqa: E402
                                           varlen_dkv_tiles, varlen_maps,
                                           varlen_row_tiles)
from repro_torch.launch.steps import make_prefill_step, make_train_step  # noqa: E402
from repro_torch.layers.losses import masked_mean_nll  # noqa: E402
from repro_torch.layers.nn import dense, embed, rmsnorm  # noqa: E402
from repro_torch.models.api import model_api  # noqa: E402
from repro_torch.models.attention_layer import (attention_layer_apply,  # noqa: E402
                                                attention_layer_decode_paged)
from repro_torch.models.pointcloud import erwin_levels, pc_layer  # noqa: E402
from repro_torch.models import encdec, mamba2, transformer, vlm  # noqa: E402
from repro_torch.models.moe import moe_apply  # noqa: E402
from repro_torch.models.transformer import lm_layer  # noqa: E402
from repro_torch.numerics import NEG_INF  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.serving.engine import GeometryEngine, ServingEngine  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bytes/s, fp32
# outside the tensor cores, bf16 tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 4e-2}
SEL_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 6e-2}
GRAD_REL_TOL = 1e-4          # train_reference_check, relative to each tensor's max
# gradients that are 0 in exact arithmetic (train_reference_check holds them
# against the layer's largest parameter gradient): φ_k's output bias under
# φ = "mlp" shifts every pooled key alike
ZERO_GRADS = ("attn.bsa.phi_k.fc2.b",)
TRAIN_STEPS = 3             # 5, then 4, until the cases across ranks needed the time

# the kernels, their sources and the TPU kernels they replace
KERNELS = {
    "bta_fwd": ("src/repro_torch/csrc/bta_fwd.cu", "src/repro/kernels/bta.py:57"),
    "flash_fwd": ("src/repro_torch/csrc/flash_fwd.cu", "src/repro/kernels/flash.py:87"),
    "selection_fwd": ("src/repro_torch/csrc/selection_fwd.cu",
                      "src/repro/kernels/selection.py:53"),
    "epilogue_fwd": ("src/repro_torch/csrc/epilogue_fwd.cu",
                     "src/repro/kernels/epilogue.py:36"),
    "bta_bwd": ("src/repro_torch/csrc/bta_bwd.cu", "src/repro/kernels/bta.py:90"),
    "flash_dq": ("src/repro_torch/csrc/flash_bwd.cu", "src/repro/kernels/flash.py:141"),
    "flash_dkv": ("src/repro_torch/csrc/flash_bwd.cu", "src/repro/kernels/flash.py:183"),
    "selection_bwd": ("src/repro_torch/csrc/selection_bwd.cu",
                      "src/repro/kernels/selection.py:103"),
    "selection_dq": ("src/repro_torch/csrc/selection_bwd.cu",
                     "src/repro/kernels/selection.py:103"),
    "selection_dkv": ("src/repro_torch/csrc/selection_bwd.cu",
                      "src/repro/kernels/selection.py:103"),
    "epilogue_bwd": ("src/repro_torch/csrc/epilogue_bwd.cu",
                     "src/repro/kernels/epilogue.py:43"),
    "varlen_fwd": ("src/repro_torch/csrc/varlen_fwd.cu", "src/repro/kernels/varlen.py:67"),
    "varlen_dq": ("src/repro_torch/csrc/varlen_bwd.cu", "src/repro/kernels/varlen.py:117"),
    "varlen_dkv": ("src/repro_torch/csrc/varlen_bwd.cu", "src/repro/kernels/varlen.py:154"),
    "local_fwd": ("src/repro_torch/csrc/local_fwd.cu", "src/repro/kernels/local.py:72"),
    "local_dq": ("src/repro_torch/csrc/local_bwd.cu", "src/repro/kernels/local.py:126"),
    "local_dkv": ("src/repro_torch/csrc/local_bwd.cu", "src/repro/kernels/local.py:126"),
    "paged_gather": ("src/repro_torch/csrc/paged_gather.cu",
                     "src/repro/kernels/paged.py:23"),
    "paged_gather_pair": ("src/repro_torch/csrc/paged_gather.cu",
                          "src/repro/kernels/paged.py:23"),
}
# the kernels each path runs (every other kernel must stay at 0 launches there)
PATHS = {"serve_padded": ("bta_fwd", "flash_fwd", "selection_fwd", "epilogue_fwd"),
         "serve_packed": ("bta_fwd", "varlen_fwd", "selection_fwd", "epilogue_fwd")}
PATHS["train_padded"] = PATHS["serve_padded"] + (
    "bta_bwd", "flash_dq", "flash_dkv", "selection_bwd", "epilogue_bwd")
PATHS["train_packed"] = PATHS["serve_packed"] + (
    "bta_bwd", "varlen_dq", "varlen_dkv", "selection_bwd", "epilogue_bwd")
PATHS["prefill"] = ("local_fwd", "flash_fwd", "selection_fwd", "epilogue_fwd")
# the paged decode gathers each of its four row sets from the K and the V
# pool in one launch; no main path gathers a single pool any more
PATHS["decode_oracle"] = ("paged_gather_pair",)
PATHS["serve_lm"] = ("paged_gather_pair",)
DECODE_GATHERS = 4                       # pair launches a layer and decode step
PATHS["train_lm"] = PATHS["prefill"] + ("local_dq", "local_dkv", "flash_dq", "flash_dkv",
                                        "selection_dq", "selection_dkv", "epilogue_bwd")
PATHS["train_full"] = ("flash_fwd", "flash_dq", "flash_dkv")
PATHS["train_erwin"] = ("bta_fwd", "bta_bwd")
PATHS["train_group_cmp"] = PATHS["train_padded"]
PATHS["quickstart"] = ("bta_fwd", "flash_fwd", "selection_fwd", "epilogue_fwd", "varlen_fwd")
PATHS["trainer"] = PATHS["train_padded"]                # Trainer on shapenet-bsa
PATHS["trainer_resume"] = PATHS["train_padded"]
# the sharded phase (ranks that share the one card): shapenet-bsa's loss and
# gradients at p = 3 (the ring selection's per-hop products are plain
# PyTorch, so no selection kernel), its packed serving at p = 2, tinyllama's
# prefill and paged serving at p = 2; the launches are each rank's
PATHS["sharded_padded"] = ("bta_fwd", "flash_fwd", "epilogue_fwd", "bta_bwd", "flash_dq",
                           "flash_dkv", "epilogue_bwd")
PATHS["sharded_packed"] = PATHS["serve_packed"]
PATHS["sharded_prefill"] = ("local_fwd", "flash_fwd", "epilogue_fwd")
PATHS["sharded_serve_lm"] = ("paged_gather_pair",)
# training across ranks (each rank's launches): Trainer(mesh=...) on
# shapenet-bsa (padded steps, a packed step, the step after a restore on
# another mesh), tinyllama's sharded remat step (its forward kernels twice a
# layer), the pipeline's and the int8 reduction's shapenet steps
PATHS["dp_train"] = PATHS["train_padded"]
PATHS["dp_train_packed"] = PATHS["train_packed"]
PATHS["dp_resume"] = PATHS["train_padded"]
PATHS["remat_lm"] = PATHS["sharded_prefill"] + ("local_dq", "local_dkv", "flash_dq",
                                                "flash_dkv", "epilogue_bwd")
# Megatron's compute over "model" (Trainer(mesh=(1, 2))): tinyllama's,
# qwen2-moe's and llava's train steps at per-rank heads, remat on (forward
# kernels twice); seamless's (its launches counted exactly by
# seamless_train_launches); mamba2's, whose scan runs no kernel
PATHS["tp_train"] = PATHS["train_lm"]
PATHS["tp_moe"] = PATHS["train_lm"]
PATHS["tp_vlm"] = PATHS["train_lm"]
PATHS["tp_ssm"] = ()
PATHS["pipeline"] = PATHS["train_padded"]
PATHS["compressed"] = PATHS["train_padded"]
# the path, dtype and mode whose launches and row the kernels line reports
# for the LM kernels; the others report the shapenet train paths' (fp32)
LM_MAIN = {"local_fwd": ("prefill", "bfloat16", "lm_window"),
           "paged_gather": ("serve_lm", "float32", "decode_window"),
           "paged_gather_pair": ("serve_lm", "float32", "pair_window"),
           "local_dq": ("train_lm", "bfloat16", "lm_train"),
           "local_dkv": ("train_lm", "bfloat16", "lm_train"),
           "selection_dq": ("train_lm", "bfloat16", "lm_train_topk"),
           "selection_dkv": ("train_lm", "bfloat16", "lm_train_topk")}

# the slice's shapes: shapenet-bsa served 8 clouds at a time, padded to 3840
B, N, H, D = 8, 3840, 8, 32
BALL, ELL, KSTAR, GROUP = 256, 8, 4, 8
NB = N // ELL
REAL_POINTS = N_POINTS                  # sample 0: a full ShapeNet-Car cloud
CAPACITY = B * N                        # packed rows: the padded batch's 8 × 3840

# the paper's other workloads, trained at full width and depth (the baselines
# phase): config -> (its path, the padded length of its batches).  Erwin's
# levels 1 and 2 need a multiple of 512 and 1024 (3840 is neither), so its
# clouds pad to 4096; Elasticity's 972-point plates pad to 1024
ERWIN_N, ELASTICITY_N = 4096, 1024
BASELINES = {"shapenet-full": ("train_full", N),
             "shapenet-erwin": ("train_erwin", ERWIN_N),
             "shapenet-bsa-group-cmp": ("train_group_cmp", N),
             "elasticity-bsa": ("train_padded", ELASTICITY_N),
             "elasticity-full": ("train_full", ELASTICITY_N)}
BASELINE_STEPS = 3
LAYER_TOL = 1e-3             # each layer's output against the reference backend's

# the LM slice: tinyllama-1.1b (32 query heads on 4 KV heads of 64, LM_BSA)
LM = "tinyllama-1.1b"
LM_HQ, LM_HKV, LM_D = 32, 4, 64
LM_W, LM_ELL, LM_KSTAR, LM_G = 256, 64, 16, 64
PREFILL_B, PREFILL_N = 2, 32768          # prefill_32k's length, its batch of 32 cut to 2
LM_LAYER_TOL = 4e-2                      # bf16, of each layer output's largest value
DECODE_TOL = 1e-4                        # fp32, of the output's largest value
SLOTS, MAX_LEN, PAGE = 8, 2048, 256
# the paged serving phase (and its lockstep processes) runs tinyllama at 2
# of its 22 layers, at full width: it is host-bound and its time goes with
# the depth (the phase took ~300 s at 22 layers, 285 s at 11 on a slow host
# and 86–89 s at 4), and at 11 layers the whole run took 1,016 s there before
# the dense LMs' main-path decode (~85 s more) was added, against a limit
# of 1,200 s; 4 layers until the other families' phases came in
SERVE_LM_LAYERS = 2
N_REQUESTS, NEW_TOKENS, SHARED = 10, 8, 512
NEAR_TIE = 4e-2                          # of the largest |logit|
TRAIN_LM_B, TRAIN_LM_N = 2, 4096         # train_4k's length, its global batch of 256 cut to 2
TRAIN_LM_STEPS = 3
DENSE_TRAIN_STEPS = 1    # stablelm's and phi4-mini's steps (3 before the families, 2
                         # before the training cases across ranks)
# the LM's backward kernels against their plain versions, of each gradient's
# largest value; the LM train check against the reference backend (the
# repository's bf16 selection-gradient tolerance), of each gradient's
# largest value, a parameter's floored at 1e-4 of its layer's largest
# parameter gradient (only φ_k.pos, whose exact gradient is 0, falls under it)
LM_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 4e-2}
LM_GRAD_REL_TOL = 6e-2
LM_GRAD_FLOOR = 1e-4
# the dense LMs beside tinyllama (dense_lm_phase), at full width and depth,
# LM_BSA, bf16, weights from seed 0: config -> ((prefill B, N), (train B, N)
# or None).  The prefill takes half of prefill_32k's length with its batch
# of 32 cut to 1 (granite-20b: 4,096 tokens; 32,768 and 8,192 until the
# sharded phase came in, which the run's time limit had to make room for);
# training takes train_4k's length (phi4-mini one sequence: its fp32
# moments alone are 35.6 GB); granite-20b does not train (its AdamW moments
# are 225 GB)
DENSE_LMS = {"stablelm-1.6b": ((1, 16384), (2, 4096)),
             "phi4-mini-3.8b": ((1, 16384), (1, 4096)),
             "granite-20b": ((1, 4096), None)}
# depth cuts of the dense LMs, to make room in the run's time limit for
# the training cases across ranks: granite-20b at 6 of its 52 layers,
# stablelm-1.6b at 6 of 24 and phi4-mini-3.8b at 8 of 32 (their phases took
# 67 and 90 s of a 1,200-second limit at full depth; 26 / 24 / 32, then 13
# / 12 / 16 layers, until the tensor-parallel cases of every family)
DENSE_DEPTH = {"stablelm-1.6b": 6, "phi4-mini-3.8b": 8, "granite-20b": 6}
for _arch in DENSE_LMS:                                  # their paths
    PATHS[f"prefill:{_arch}"] = PATHS["prefill"]
    PATHS[f"decode:{_arch}"] = ("paged_gather_pair",)
    PATHS[f"train:{_arch}"] = PATHS["train_lm"]
# their paged decode: two staggered slots (lengths, first steps), bf16,
# over a complete φ-block in each slot (the decode and its hold are
# host-bound, so their steps set the phases' time: 300 / 200 positions took
# 400 of a 1,085-second run on a slow host, 200 / 130 210 s of a 795-second
# one; 96 / 64 since the other families' phases came in, 64 / 64 from steps
# 0 / 16 since the tensor-parallel cases); its hold against the forward
# (decode_hold), of the forward's largest value: on the H100 the three
# models' attention outputs read at most 6.9e-3 and their logits 5.5e-3 at
# 300 / 200 positions, and stablelm's decode with its compression branch
# scaled by 0.9 reads 1.6e-2 to 3.2e-2 in every layer
DECODE_LENS, DECODE_STARTS = (64, 64), (0, 16)
DECODE_HOLD_TOL = 1.5e-2
# the causal path's kernel rows at each model's heads (head_rows_phase):
# tag -> (config, query heads, KV heads, head dim), one 4,096-token sequence
HEAD_ROWS = {"d128": ("phi4-mini-3.8b", 24, 8, 128),
             "rep1": ("stablelm-1.6b", 32, 32, 64),
             "rep48": ("granite-20b", 48, 1, 128),
             "rep1_d128": ("qwen2-moe-a2.7b", 16, 16, 128),
             "rep4": ("phi3.5-moe-42b-a6.6b", 32, 8, 128),
             "rep7": ("llava-next-34b", 56, 8, 128)}
HEAD_ROWS_N = 4096

# the other families (family phases), each at its published widths, bf16,
# weights from seed 0: qwen2-moe-a2.7b prefills 1 × 4096 at full depth,
# decodes paged (two staggered slots of FAMILY_DECODE_LENS positions) and
# trains 1 + FAMILY_TRAIN_STEPS steps of 1 × 4096 at MOE_TRAIN_LAYERS of
# its 24 layers (fp32 AdamW moments of all 24 would take ~180 GB);
# phi3.5-moe prefills at PHIMOE_LAYERS of 32 (83.7 GB of bf16 weights);
# mamba2-1.3b prefills, decodes, serves and trains at full depth;
# seamless-m4t-medium trains 1 × 4096 frames (512 decoder tokens) and
# decodes SEAMLESS_DECODE greedy tokens; llava-next-34b prefills 512 image
# + 3584 text tokens at LLAVA_DEPTH of its 60 layers (all 60, which leave
# LLAVA_ROOM_GB under LLAVA_PEAK_GB, until the tensor-parallel cases of
# every family needed the time).  jamba-1.5-large-398b is not run on the card: one
# period of 8 layers holds ~44 B parameters (88 GB in bf16)
QWEN, PHIMOE, MAMBA = "qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b", "mamba2-1.3b"
SEAMLESS, LLAVA = "seamless-m4t-medium", "llava-next-34b"
FAMILY_N = 4096
FAMILY_TRAIN_STEPS = 2
MOE_TRAIN_LAYERS, PHIMOE_LAYERS = 4, 2
FAMILY_DECODE_LENS, FAMILY_DECODE_STARTS = (64, 48), (0, 16)
SEAMLESS_DECODE, SEAMLESS_MAX_LEN = 32, 512
MAMBA_SLOTS, MAMBA_REQUESTS, MAMBA_NEW, MAMBA_MAX_LEN = 4, 6, 16, 256
LLAVA_PEAK_GB, LLAVA_ROOM_GB, LLAVA_DEPTH = 76.0, 6.0, 30
# gradients that are 0 in exact arithmetic in the encoder-decoder check
# (grad_rows), held against the layer's largest parameter gradient
EXACT_ZERO = "bsa.phi_k.pos"
# mamba serving: the requests also generated by B = 1 lockstep, the two
# admitted into reused slots
MAMBA_LOCKSTEP = (4, 5)
for _arch in (QWEN, PHIMOE, LLAVA):
    PATHS[f"prefill:{_arch}"] = PATHS["prefill"]
PATHS[f"decode:{QWEN}"] = ("paged_gather_pair",)
PATHS[f"train:{QWEN}"] = PATHS["train_lm"]
for _kind in ("prefill", "decode", "serve", "train"):        # mamba2 runs no kernel
    PATHS[f"{_kind}:{MAMBA}"] = ()
# seamless: the encoder's non-causal BSA (ball, compression, selection,
# combine), the decoder's causal BSA and its cross-attention (flash)
PATHS[f"train:{SEAMLESS}"] = ("bta_fwd", "flash_fwd", "selection_fwd", "epilogue_fwd",
                              "local_fwd", "bta_bwd", "flash_dq", "flash_dkv",
                              "selection_dq", "selection_dkv", "epilogue_bwd", "local_dq",
                              "local_dkv")
PATHS[f"decode:{SEAMLESS}"] = ("paged_gather_pair", "flash_fwd")
PATHS["tp_encdec"] = PATHS[f"train:{SEAMLESS}"]
TRAINED = {a for a, (_, t) in DENSE_LMS.items() if t} | {QWEN, MAMBA}
# the redesigned kernels must build without spills at these head dims, every
# variant named: mma (bf16 tensor cores), fma (fp32 register tiles) and, for
# the local backward, lanes (fp32 and small windows, both dtypes); the ball
# kernels' mma variants at 64 and 128 and their fma variants at the head dims
# their fma path takes (16, 32), the
# varlen kernels' at theirs (16, 32, 64), selection_fwd's groups variant at
# its (16, 32, 64); epilogue_bwd's vec variant at every lanes count (in
# place of a head dim), fp32 and bf16.  (kernel, head dims, variants)
NO_SPILL = [*((name, (64, 128), ("mma", "fma"))
              for name in ("flash_fwd", "flash_dq", "flash_dkv", "selection_fwd",
                           "selection_dq", "selection_dkv")),
            ("selection_fwd", selection.GROUPS_DIMS, ("groups",)),
            ("local_fwd", (64, 128), ("mma",)),
            ("local_dq", (64, 128), ("mma", "lanes")),
            ("local_dkv", (64, 128), ("mma", "lanes")),
            *((name, bta.FMA_DIMS, ("fma",)) for name in ("bta_fwd", "bta_bwd")),
            *((name, (64, 128), ("mma",)) for name in ("bta_fwd", "bta_bwd")),
            *((name, HEAD_DIMS[name], ("fma",))
              for name in ("varlen_fwd", "varlen_dq", "varlen_dkv")),
            *((name, (1, 2, 4, 8, 16, 32), ("vec",))
              for name in ("epilogue_fwd", "epilogue_bwd"))]
# a kernel's further rows in the kernels line, beside its main path's (name
# -> [(key, path whose launches it reports or None, dtype, mode)]): the LM
# prefill's flash_fwd beside the shapenet train path's, selection_fwd on the
# model's picks beside random ones, the epilogues at the LM's shapes, the
# D 128 rows, the gathers on int64 rows beside int32 (the pair also on the
# 8 compressed rows and every block's), the layer's epilogue call beside the
# kernel's (``call``), and the baselines'
# shapes: the flash kernels at shapenet-full's 3840 queries × 3840 keys, the
# ball kernels at shapenet-erwin's levels 0–2 (4096, 2048, 1024 tokens)
LM_ALSO = {"flash_fwd": [("lm_prefill", "prefill", "bfloat16", "lm_block_causal"),
                         ("full", "shapenet-full", "float32", "full")],
           "flash_dq": [("full", "shapenet-full", "float32", "full")],
           "flash_dkv": [("full", "shapenet-full", "float32", "full")],
           **{name: [(f"erwin_l{lv}", "shapenet-erwin", "float32", f"erwin_l{lv}")
                     for lv in range(3)] for name in ("bta_fwd", "bta_bwd")},
           "selection_fwd": [("topk", "train_padded", "float32", "topk")],
           "epilogue_fwd": [("call", "serve_padded", "float32", "rows_call"),
                            ("lm_prefill", "prefill", "bfloat16", "lm_rows"),
                            ("lm_prefill_call", "prefill", "bfloat16", "lm_rows_call")],
           "epilogue_bwd": [("lm_train", "train_lm", "bfloat16", "lm_train_rows")],
           "paged_gather": [("int64_rows", "serve_lm", "float32", "decode_window_i64"),
                            ("crow_int64", "serve_lm", "float32", "decode_crow_i64")],
           "paged_gather_pair": [
               ("int64_rows", "serve_lm", "float32", "pair_window_i64"),
               ("crow_int64", "serve_lm", "float32", "pair_crow_i64"),
               ("cmp_rows", "serve_lm", "float32", "pair_cmp_rows")]}
# the rows at each model's heads (bf16) under their tag, with the launches of
# that model's path (its prefill for the forward kernels, its training for the
# backward ones, None where it does not train, its decode for the gather)
HEAD_ROW_MODES = {"local_fwd": "lm_window", "local_dq": "lm_window",
                  "local_dkv": "lm_window", "flash_fwd": "block_causal",
                  "flash_dq": "block_causal", "flash_dkv": "block_causal",
                  "selection_fwd": "groups", "selection_dq": "groups",
                  "selection_dkv": "groups", "epilogue_fwd": "rows", "epilogue_bwd": "rows",
                  "paged_gather_pair": "pair_window"}
for _tag, (_arch, *_) in HEAD_ROWS.items():
    for _name, _mode in HEAD_ROW_MODES.items():
        _path = (f"decode:{_arch}" if _name == "paged_gather_pair"
                 else f"prefill:{_arch}" if _name in PATHS["prefill"]
                 else f"train:{_arch}" if _arch in TRAINED else None)
        LM_ALSO.setdefault(_name, []).append(
            (_tag, _path if _path in PATHS else None, "bfloat16", f"{_tag}_{_mode}"))
# seamless's encoder ball (bf16, 16 heads of 64: the mma path), the ball pair
# at llava's 56 / 8 heads of 128 (the mma path at D 128) and at seamless's
# heads in balls of 32 (the rows path; no main path runs either), and
# seamless's cross-attention (512 decoder rows against 4096 frames; one row
# at decode)
for _name in ("bta_fwd", "bta_bwd"):
    LM_ALSO[_name] += [("seamless", f"train:{SEAMLESS}", "bfloat16", "seamless_ball"),
                       ("llava_d128", None, "bfloat16", "llava_ball"),
                       ("rows_ball32", None, "bfloat16", "rows_ball32")]
for _name in ("flash_fwd", "flash_dq", "flash_dkv"):
    LM_ALSO[_name].append(("cross", f"train:{SEAMLESS}", "bfloat16", "cross"))
LM_ALSO["flash_fwd"].append(("cross_decode", f"decode:{SEAMLESS}", "bfloat16",
                             "cross_decode"))


# kernels that no main path launches, with the reason the kernels line gives
NOT_ON_A_MAIN_PATH = {
    "paged_gather": "the single-pool entry, kept for callers with one pool: the "
                    "decode gathers each row set from its K and V pools at once "
                    "(paged_gather_pair); its launches are those of serve_lm, 0"}
# a kernel row's optional keys, carried into the kernels line
EXTRA_KEYS = ("device_ms", "library_device_ms", "index", "rows", "path", "bit_identical",
              "splits", "index_select_ms", "index_select_pair_ms",
              "index_select_device_ms")


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, warmup: int = 3, reps: int = 15) -> float:
    """Median of per-call CUDA-event times after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(bytes_moved: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want, rows=None, tol_table=TOL) -> tuple[float, bool]:
    """(max |got − want| over finite comparisons, within tolerance?)"""
    errs, ok = [], True
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        if rows is not None:
            g, w = g[rows], w[rows]
        if not torch.isfinite(g).all():
            return float("nan"), False
        d = (g - w).abs()
        tol = tol_table[got[0].dtype] * (1 + w.abs())
        ok = ok and bool((d <= tol).all())
        errs.append(float(d.max()))
    return max(errs), ok


def slice_mask(dev) -> torch.Tensor:
    """(B, N) bool: sample 0 is a 3586-point cloud padded to 3840; the others
    are 2800–3586-point clouds, as serving gets them."""
    g = torch.Generator().manual_seed(11)
    sizes = torch.randint(2800, REAL_POINTS + 1, (B,), generator=g)
    sizes[0] = REAL_POINTS
    return (torch.arange(N)[None, :] < sizes[:, None]).to(dev)


def rand(shape, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def device_ms(fn, pattern: str | None = None, reps: int = 20,
              per_call: bool = False) -> tuple[float | None, list[str]]:
    """(mean device time of one launch of the kernels whose name matches
    ``pattern`` (every kernel when None), the names of every device kernel
    the calls launched), from the profiler over ``reps`` calls of ``fn``
    after a warm-up.  Mean over the launches the trace holds: it may miss a
    few of the first calls' kernels, and now and then a trace holds no
    device kernel of ``fn`` at all, so such a one is taken again (up to
    ``TRACE_TRIES`` times; then the time is None, not measured, and a
    ``device_ms_missing`` line names what the trace held).  ``per_call``:
    their device time a call instead (a library call may launch several
    kernels)."""
    ks = device_trace(fn, reps, pattern)
    mine = [e for e in ks if pattern is None or re.search(pattern, e.key)]
    if pattern is not None and not mine:
        print(json.dumps({"device_ms_missing": {"pattern": pattern,
                                                "trace": sorted(e.key[:80] for e in ks)}}),
              flush=True)
        return None, sorted(e.key for e in ks)
    total = sum(e.device_time_total for e in mine) / 1e3
    return (total / reps if per_call else total / max(1, sum(e.count for e in mine)),
            sorted(e.key for e in ks))


# traces a device_trace takes at most: three empty traces in a row were
# seen once on the card (a paged_gather_pair row)
TRACE_TRIES = 6


def device_trace(fn, reps: int, pattern: str | None = None) -> list:
    """The device kernels' profiler averages over ``reps`` calls of ``fn``
    after a warm-up call (a trace with no kernel, or none whose name matches
    ``pattern``, is taken again, up to ``TRACE_TRIES`` times)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_TRIES):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ks = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        if any(pattern is None or re.search(pattern, e.key) for e in ks):
            return ks
    return ks


def per_call_ms(ks, reps: int, pattern: str | None = None) -> float:
    """Device time a call of the kernels in ``ks`` whose name matches
    ``pattern`` (every kernel when None)."""
    return sum(e.device_time_total for e in ks
               if pattern is None or re.search(pattern, e.key)) / 1e3 / reps


def recorder(results: list):
    def record(name, mode, dtype, err, ok, k_ms, p_ms, b_ms, b_by, lib_ms, **extra):
        row = {"name": name, "mode": mode, "dtype": str(dtype).replace("torch.", ""),
               "max_abs_err": err, "within_tol": ok, "kernel_ms": k_ms,
               "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": lib_ms, **extra}
        print(json.dumps(row), flush=True)
        results.append(row)
        check(ok, f"{name} [{mode}, {row['dtype']}] disagrees with its plain "
                  f"version: max abs err {err}")
    return record


def library_bwd_ms(fn, leaves, warmup: int = 3, reps: int = 15) -> float:
    """Backward time of one library call: median (forward + backward) minus
    median forward."""
    out = fn()
    g = torch.randn_like(out)

    def fwd_bwd():
        for t in leaves:
            t.grad = None
        fn().backward(g)
    with torch.no_grad():
        f_ms = median_ms(fn, warmup, reps)
    return median_ms(fwd_bwd, warmup, reps) - f_ms


def library_bwd_device_ms(fn, leaves) -> float:
    """Device time of one library call's backward: the kernels of a forward
    + backward call minus those of a forward call, a call each."""
    out = fn()
    g = torch.randn_like(out)

    def fwd_bwd():
        for t in leaves:
            t.grad = None
        fn().backward(g)
    with torch.no_grad():
        f_ms = device_ms(fn, per_call=True)[0]
    return device_ms(fwd_bwd, per_call=True)[0] - f_ms


def selection_dense_case(qg, kb, vb, idx, tok_bias):
    """One SDPA call's inputs for the function the selection kernels compute:
    the queries (B, Hkv, G·M, D), the un-blocked keys and values (B, Hkv,
    NB·ℓ, D) and a bool mask (B, Hkv, G·M, NB·ℓ) that lets row (g, r) see key
    (blk, c) iff blk is one of idx[b, h, g] and tok_bias[b, blk, c] >
    NEG_INF/2.  (A block picked twice by one group counts twice in the
    kernel and once here; top-k picks are distinct.)"""
    Bc, Hkv, G, M, Dh = qg.shape
    nb, ell = kb.shape[2], kb.shape[3]
    sel = torch.zeros((Bc, Hkv, G, nb + 1), dtype=torch.bool, device=qg.device)
    sel.scatter_(3, torch.where((idx >= 0) & (idx < nb), idx, nb).long(), True)
    tok = (tok_bias > NEG_INF / 2)[:, None, None]                 # (B, 1, 1, NB, ℓ)
    mask = (sel[..., :nb, None] & tok).reshape(Bc, Hkv, G, 1, nb * ell)
    mask = mask.expand(Bc, Hkv, G, M, nb * ell).reshape(Bc, Hkv, G * M, nb * ell)
    return (qg.reshape(Bc, Hkv, G * M, Dh), kb.reshape(Bc, Hkv, nb * ell, Dh),
            vb.reshape(Bc, Hkv, nb * ell, Dh), mask)


def selection_library_ms(qg, kb, vb, idx, tok_bias, backward: bool = False) -> float:
    """SDPA with the dense selection mask (:func:`selection_dense_case`), one
    warm-up and three timed calls, as the slow plain rows are timed; with
    ``backward`` its backward time, (forward + backward) − forward.  The
    mask is built once for the call and freed."""
    qs, ks, vs, mask = selection_dense_case(qg, kb, vb, idx, tok_bias)
    if backward:
        qs, ks, vs = (t.clone().requires_grad_(True) for t in (qs, ks, vs))
        ms = library_bwd_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                                   attn_mask=mask),
                            (qs, ks, vs), warmup=1, reps=3)
    else:
        ms = median_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask),
                       warmup=1, reps=3)
    del qs, ks, vs, mask
    torch.cuda.empty_cache()
    return ms


def selection_tiled_rows(record, mode, qg, kb, vb, idxs, tok_bias, do) -> None:
    """The tiled path's kernels (``selection_fwd``, ``selection_dq``,
    ``selection_dkv``) on each pick set of ``idxs`` against the plain
    versions, one row each (errors the worst, times and bounds the mean over
    the pick sets; dq and dkv share the plain backward's time), SDPA with the
    dense mask on the first pick set; and a ``selection_backward`` line: the
    whole backward (both kernels and the inverse index) and the bytes of its
    staging buffer, written once and read once."""
    dtype, es = qg.dtype, qg.element_size()
    Bc, Hkv, G, M, Dh = qg.shape
    nb, ell = kb.shape[2], kb.shape[3]
    check(selection.selection_plan(M, ell, Dh, dtype).path == "tiles",
          f"selection [{mode}]: groups of {M} rows should take the tiled path")
    rows = {n: ([], [], [], [], []) for n in ("selection_fwd", "selection_dq", "selection_dkv")}
    total, staged = [], []
    side = 4 * idxs[0].numel() + 4 * tok_bias.numel() + 4 * qg.numel() // Dh
    for idx in idxs:
        valid_sel = int(((idx >= 0) & (idx < nb)).sum())
        used = torch.zeros(Bc, Hkv, nb, dtype=torch.bool, device=qg.device)
        used.scatter_(2, idx.clamp(min=0).reshape(Bc, Hkv, -1).long(),
                      (idx >= 0).reshape(Bc, Hkv, -1))
        kv_bytes = 2 * int(used.sum()) * ell * Dh * es
        pairs = float(M * ell * valid_sel)

        def add(name, err_ok, k_ms, p_ms, b):
            for lst, x in zip(rows[name], (*err_ok, k_ms, p_ms, b)):
                lst.append(x)
        o, lse = selection.selection_attention_fwd(qg, kb, vb, idx, tok_bias)
        want = selection.selection_attention_fwd_plain(qg, kb, vb, idx, tok_bias)
        torch.cuda.synchronize()
        add("selection_fwd", max_err((o, lse), want),
            median_ms(lambda: selection.selection_attention_fwd(qg, kb, vb, idx, tok_bias),
                      warmup=1, reps=3),
            median_ms(lambda: selection.selection_attention_fwd_plain(qg, kb, vb, idx,
                                                                      tok_bias),
                      warmup=1, reps=1),
            bound(2 * qg.numel() * es + kv_bytes + side, 4.0 * Dh * pairs, dtype))
        del want
        args = (qg, kb, vb, idx, tok_bias, do, lse, row_delta(do, o))
        dq = selection.selection_attention_dq(*args)
        dkv = selection.selection_attention_dkv(*args)
        want = selection.selection_attention_bwd_plain(*args)
        torch.cuda.synchronize()
        p_ms = median_ms(lambda: selection.selection_attention_bwd_plain(*args), warmup=1,
                         reps=1)
        add("selection_dq", rel_err((dq,), want[:1], tol_table=SEL_BWD_TOL),
            median_ms(lambda: selection.selection_attention_dq(*args), warmup=1, reps=3),
            p_ms, bound(3 * qg.numel() * es + kv_bytes + side + 4 * qg.numel() // Dh,
                        6.0 * Dh * pairs, dtype))
        add("selection_dkv", rel_err(dkv, want[1:], tol_table=SEL_BWD_TOL),
            median_ms(lambda: selection.selection_attention_dkv(*args), warmup=1, reps=3),
            p_ms, bound(2 * qg.numel() * es + kv_bytes + 2 * kb.numel() * es + side
                        + 4 * qg.numel() // Dh, 8.0 * Dh * pairs, dtype))
        total.append(median_ms(lambda: selection.selection_attention_bwd(*args), warmup=1,
                               reps=3))
        staged.append(2 * 2 * valid_sel * ell * Dh * 4)
        del o, lse, args, dq, dkv, want
    lib = {"selection_fwd": selection_library_ms(qg, kb, vb, idxs[0], tok_bias)}
    lib["selection_dq"] = lib["selection_dkv"] = selection_library_ms(
        qg, kb, vb, idxs[0], tok_bias, backward=True)
    for name, (errs, oks, k_ms, p_ms, b_ms) in rows.items():
        record(name, mode, dtype,
               max(errs) if all(math.isfinite(e) for e in errs) else math.nan, all(oks),
               statistics.fmean(k_ms), statistics.fmean(p_ms),
               statistics.fmean(t for t, _ in b_ms), b_ms[0][1], lib[name])
    line = {"mode": mode, "dtype": str(dtype).replace("torch.", ""),
            "dq_ms": statistics.fmean(rows["selection_dq"][2]),
            "dkv_ms": statistics.fmean(rows["selection_dkv"][2]),
            "backward_ms": statistics.fmean(total),
            "plain_ms": statistics.fmean(rows["selection_dq"][3]),
            "library_ms": lib["selection_dq"],
            "staging_bytes": statistics.fmean(staged),
            "staging_ms": statistics.fmean(staged) / HBM_BYTES_PER_S * 1e3}
    print(json.dumps({"selection_backward": line}), flush=True)


def selection_fwd_bound(qg, idx, tok_bias) -> tuple[float, str]:
    """``selection_fwd``'s bound on these picks: Q read and O written once,
    each block some group picked read once (K and V), the picks, the token
    bias and lse; 4·M·ℓ·D FLOP a valid pick."""
    Bc, Hkv, G, M, Dh = qg.shape
    nb, ell = tok_bias.shape[1], tok_bias.shape[2]
    es = qg.element_size()
    valid = (idx >= 0) & (idx < nb)
    used = torch.zeros(Bc, Hkv, nb, dtype=torch.bool, device=qg.device)
    used.scatter_(2, idx.clamp(0, nb - 1).reshape(Bc, Hkv, -1).long(),
                  valid.reshape(Bc, Hkv, -1))
    nbytes = (2 * qg.numel() + 2 * int(used.sum()) * ell * Dh) * es \
        + 4 * idx.numel() + 4 * tok_bias.numel() + 4 * qg.numel() // Dh
    return bound(nbytes, 4.0 * M * ell * Dh * int(valid.sum()), qg.dtype)


def selection_fwd_repro(mode, dtype, call) -> bool:
    """Two calls of ``selection_fwd`` on the same inputs: a failed check
    unless their bits are equal."""
    first, second = call(), call()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    check(same, f"selection_fwd [{mode}, {dtype}]: two calls on the same inputs differ")
    return same


def epilogue_bwd_row(record, mode, args, err_fn=max_err) -> None:
    """``epilogue_bwd`` on ``args`` (o₁..o₃, g₁..g₃, m, dO) against its plain
    version (by ``err_fn``), its bits equal on two calls, timed per call and
    on the device, with the kernel :func:`epilogue.epilogue_plan`
    names."""
    R, Dh = args[0].shape
    dtype, es = args[0].dtype, args[0].element_size()
    call = lambda: epilogue.gated_combine_bwd(*args)            # noqa: E731
    got, again = call(), call()
    want = epilogue.gated_combine_bwd_plain(*args)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    check(same, f"epilogue_bwd [{mode}, {dtype}]: two calls on the same inputs differ")
    err, ok = err_fn(got, want)
    b_ms, b_by = bound(7 * R * Dh * es + 7 * 4 * R, 10.0 * R * Dh, torch.float32)
    record("epilogue_bwd", mode, dtype, err, ok, median_ms(call),
           median_ms(lambda: epilogue.gated_combine_bwd_plain(*args), reps=5),
           b_ms, b_by, None, device_ms=device_ms(call, "epilogue_bwd")[0],
           bit_identical=same, path=epilogue.epilogue_plan(Dh, dtype).path)


def epilogue_fwd_rows(record, mode: str, dtype, dev, shape, mask, seed: int) -> None:
    """``epilogue_fwd`` on three (B, N, H, D) branch outputs with the gates
    and mask as the layer hands them over: one gate a head (``gate_mode``
    "scalar", every config's), the (B, N) mask or None.  Row ``mode``: the
    kernel's wrapper against its plain version, its device time; row
    ``{mode}_call``: the layer's call, ``ops.gated_combine`` (views, the
    autograd op, the launch), which must launch ``epilogue_fwd`` and no
    other kernel.  Bound: the three outputs read and the result written
    once, the gates and the mask read once."""
    Bx, Nx, Hx, Dx = shape
    R, T = Bx * Nx * Hx, Bx * Nx
    es = torch.tensor([], dtype=dtype).element_size()
    outs = [rand(shape, dtype, dev, seed + i) for i in range(3)]
    leaves = [torch.sigmoid(rand((Hx,), torch.float32, dev, seed + 3 + i)) for i in range(3)]
    gates = [g[None, None, :, None] for g in leaves]     # core.branches.gate_values
    os_, gs = [o.view(R, Dx) for o in outs], [g[None] for g in leaves]
    m = None if mask is None else mask.reshape(T)
    call = lambda: epilogue.gated_combine_fwd(*os_, *gs, m)  # noqa: E731
    plain = lambda: epilogue.gated_combine_fwd_plain(*os_, *gs, m)  # noqa: E731
    layer = lambda: ops.gated_combine(outs, gates, mask)  # noqa: E731
    got, want, via_layer = call(), plain(), layer()
    torch.cuda.synchronize()
    err, ok = max_err((got,), (want,))
    b_ms, b_by = bound(4 * R * Dx * es + 12 * Hx + (0 if m is None else T), 6.0 * R * Dx,
                       torch.float32)
    path = epilogue.epilogue_plan(Dx, dtype).path
    p_ms = median_ms(plain, reps=5)
    record("epilogue_fwd", mode, dtype, err, ok, median_ms(call), p_ms, b_ms, b_by, None,
           device_ms=device_ms(call, "epilogue_fwd")[0], path=path)
    d_ms, names = device_ms(layer, "epilogue_fwd")
    check(bool(names) and all("epilogue_fwd" in k for k in names),
          f"ops.gated_combine [{mode}]: launched other kernels than epilogue_fwd: {names}")
    err, ok = max_err((via_layer.view(R, Dx),), (want,))
    record("epilogue_fwd", f"{mode}_call", dtype, err, ok, median_ms(layer), p_ms, b_ms, b_by,
           None, device_ms=d_ms, path=path)


def kernel_phase(dev) -> list[dict]:
    mask = slice_mask(dev)
    key_bias = torch.where(mask, 0.0, NEG_INF).float()
    blk_valid = mask.reshape(B, NB, ELL).any(-1)
    blk_bias = torch.where(blk_valid, 0.0, NEG_INF).float()
    results = []
    record = recorder(results)

    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        # ---- bta: (B·H, 1, N, D) against its ball's keys
        q = rand((B * H, 1, N, D), dtype, dev, 1)
        k = rand((B * H, N, D), dtype, dev, 2)
        v = rand((B * H, N, D), dtype, dev, 3)
        kw = dict(ball_size=BALL, n_heads=H)
        got = bta.ball_attention_fwd(q, k, v, key_bias, **kw)
        want = bta.ball_attention_fwd_plain(q, k, v, key_bias, **kw)
        torch.cuda.synchronize()
        err, ok = max_err(got, want)
        live_balls = int(mask.reshape(B, N // BALL, BALL).any(-1).sum()) * H
        nbytes = 4 * q.numel() * es + 4 * B * N + 4 * B * (N // BALL) + 4 * q.numel() // D
        b_ms, b_by = bound(nbytes, 4.0 * BALL * BALL * D * live_balls, dtype)
        qs, ks, vs = (t.reshape(B, H, N // BALL, BALL, D).transpose(1, 2)
                      .reshape(B * (N // BALL), H, BALL, D).contiguous() for t in (q, k, v))
        bmask = mask.reshape(B * (N // BALL), 1, 1, BALL)
        lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bmask)  # noqa: E731
        record("bta_fwd", "ball", dtype, err, ok,
               median_ms(lambda: bta.ball_attention_fwd(q, k, v, key_bias, **kw)),
               median_ms(lambda: bta.ball_attention_fwd_plain(q, k, v, key_bias, **kw),
                         reps=5),
               b_ms, b_by, median_ms(lib),
               device_ms=device_ms(lambda: bta.ball_attention_fwd(q, k, v, key_bias, **kw),
                                   "bta_fwd")[0],
               library_device_ms=device_ms(lib, per_call=True)[0],
               path=bta.bta_plan(BALL, D, 1, dtype).path)

        # ---- flash: N queries against L = N/ℓ pooled keys
        k = rand((B * H, NB, D), dtype, dev, 4)
        v = rand((B * H, NB, D), dtype, dev, 5)
        modes = [("key_bias", {}, mask)]
        if dtype == torch.float32:
            modes += [("causal", {"causal": True}, None),
                      ("block_causal", {"block_causal": True, "ell": ELL}, None)]
        for mode, mkw, q_valid in modes:
            kw = dict(n_heads=H, **mkw)
            got = flash.flash_attention_fwd(q, k, v, blk_bias, q_valid, **kw)
            want = flash.flash_attention_fwd_plain(q, k, v, blk_bias, q_valid, **kw)
            torch.cuda.synchronize()
            rows = None
            if q_valid is not None:      # rows of padding queries are unspecified
                rows = q_valid.repeat_interleave(H, 0)[:, None, :]
            err, ok = max_err(got, want, rows)
            vis = flash.visible_keys(N, NB, causal=mkw.get("causal", False),
                                     block_causal=mkw.get("block_causal", False),
                                     ell=ELL, device=dev)
            pairs = blk_valid[:, None, :].expand(B, N, NB)
            if vis is not None:
                pairs = pairs & vis[None]
            if q_valid is not None:
                pairs = pairs & q_valid[:, :, None]
            flops = 4.0 * D * H * float(pairs.sum())
            nbytes = (2 * q.numel() + 2 * k.numel()) * es + 4 * B * NB + B * N \
                + 4 * q.numel() // D
            b_ms, b_by = bound(nbytes, flops, dtype)
            lib_ms = None
            if mode == "key_bias":
                qs = q.reshape(B, H, N, D)
                ks, vs = k.reshape(B, H, NB, D), v.reshape(B, H, NB, D)
                fmask = blk_valid[:, None, None, :]
                lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=fmask))
            record("flash_fwd", mode, dtype, err, ok,
                   median_ms(lambda: flash.flash_attention_fwd(q, k, v, blk_bias,
                                                               q_valid, **kw)),
                   median_ms(lambda: flash.flash_attention_fwd_plain(
                       q, k, v, blk_bias, q_valid, **kw), reps=5),
                   b_ms, b_by, lib_ms)

        # ---- selection: G = NB groups of g·rep = 8 rows, k* blocks of ℓ keys
        M = GROUP * 1
        qg = rand((B, H, NB, M, D), dtype, dev, 6)
        kb = rand((B, H, NB, ELL, D), dtype, dev, 7)
        vb = rand((B, H, NB, ELL, D), dtype, dev, 8)
        g = torch.Generator(device=dev).manual_seed(9)
        idx = torch.randint(0, NB, (B, H, NB, KSTAR), generator=g, device=dev)
        idx = torch.where(blk_valid[:, None, :, None], idx, -1)   # dead groups
        idx = torch.where(blk_valid[:, None, None, :].expand(B, H, NB, NB)
                          .gather(3, idx.clamp(min=0)), idx, -1).int().contiguous()
        tok_bias = key_bias.reshape(B, NB, ELL).contiguous()
        got = selection.selection_attention_fwd(qg, kb, vb, idx, tok_bias)
        want = selection.selection_attention_fwd_plain(qg, kb, vb, idx, tok_bias)
        torch.cuda.synchronize()
        err, ok = max_err(got, want)
        b_ms, b_by = selection_fwd_bound(qg, idx, tok_bias)
        call = lambda: selection.selection_attention_fwd(qg, kb, vb, idx, tok_bias)  # noqa: E731
        same = selection_fwd_repro("groups", dtype, call)
        record("selection_fwd", "groups", dtype, err, ok, median_ms(call),
               median_ms(lambda: selection.selection_attention_fwd_plain(
                   qg, kb, vb, idx, tok_bias), reps=5),
               b_ms, b_by, selection_library_ms(qg, kb, vb, idx, tok_bias),
               device_ms=device_ms(call, "selection_fwd")[0], bit_identical=same,
               path=selection.selection_plan(M, ELL, D, dtype, KSTAR).path)

        # ---- epilogue: R = B·N·H rows of D
        epilogue_fwd_rows(record, "rows", dtype, dev, (B, N, H, D), mask, 10)
    return results


def selection_picks(dev, batch) -> list[torch.Tensor]:
    """Each layer's selections, as the selection kernel gets them (B, Hkv,
    G, k*), in the kernel path's forward of ``shapenet-bsa`` (weights from
    seed 0, as the train phase starts) on ``batch``."""
    cfg = get_config("shapenet-bsa")
    api = model_api(cfg)
    model = api.init(seed=0, device=dev)
    apply, picks = selection.SelectionAttentionFn.apply, []

    def spy(qg, kb, vb, idx, tok_bias):
        picks.append(idx.clone())
        return apply(qg, kb, vb, idx, tok_bias)

    with mock.patch.object(selection.SelectionAttentionFn, "apply", spy), \
            use_backend("kernels"):
        api.forward(model, batch)
    check(len(picks) == cfg.n_layers, f"{len(picks)} selection calls in "
                                      f"{cfg.n_layers} layers")
    return picks


def backward_kernel_phase(dev, batch) -> list[dict]:
    """The five backward kernels against their plain versions at the shapes
    one train step gives them; each gets the forward kernel's (o, lse), an
    upstream gradient dO that is zero on padded query rows, and
    δ = rowsum(dO·O).  ``batch`` is the train phase's first batch: the
    selection rows use the model's own picks on it."""
    picks = selection_picks(dev, batch)
    mask = batch["mask"]
    check(mask.shape == (B, N) and bool((mask.sum(1) == REAL_POINTS).all()),
          "train batch: 8 clouds of 3586 points padded to 3840")
    key_bias = torch.where(mask, 0.0, NEG_INF).float()
    blk_valid = mask.reshape(B, NB, ELL).any(-1)
    blk_bias = torch.where(blk_valid, 0.0, NEG_INF).float()
    row_ok = mask.repeat_interleave(H, 0)[:, None, :, None]      # (B·H, 1, N, 1)
    results = []
    record = recorder(results)

    def upstream(o, seed):                     # o: (B·H, 1, N, D)
        do = rand(o.shape, o.dtype, dev, seed)
        return torch.where(row_ok, do, torch.zeros_like(do))

    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        # ---- bta: (B·H, 1, N, D), one ball of 256 keys per query row
        q = rand((B * H, 1, N, D), dtype, dev, 31)
        k = rand((B * H, N, D), dtype, dev, 32)
        v = rand((B * H, N, D), dtype, dev, 33)
        kw = dict(ball_size=BALL, n_heads=H)
        o, lse = bta.ball_attention_fwd(q, k, v, key_bias, **kw)
        do = upstream(o, 34)
        args = (q, k, v, key_bias, do, lse, row_delta(do, o))
        got = bta.ball_attention_bwd(*args, **kw)
        want = bta.ball_attention_bwd_plain(*args, **kw)
        torch.cuda.synchronize()
        err, ok = max_err(got, want)
        live_balls = int(mask.reshape(B, N // BALL, BALL).any(-1).sum()) * H
        nbytes = 7 * q.numel() * es + 2 * 4 * q.numel() // D + 4 * B * N \
            + 4 * B * (N // BALL)
        b_ms, b_by = bound(nbytes, 10.0 * BALL * BALL * D * live_balls, dtype)
        qs, ks, vs = (t.reshape(B, H, N // BALL, BALL, D).transpose(1, 2)
                      .reshape(B * (N // BALL), H, BALL, D).contiguous()
                      .requires_grad_(True) for t in (q, k, v))
        bmask = mask.reshape(B * (N // BALL), 1, 1, BALL)
        lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bmask)  # noqa: E731
        record("bta_bwd", "ball", dtype, err, ok,
               median_ms(lambda: bta.ball_attention_bwd(*args, **kw)),
               median_ms(lambda: bta.ball_attention_bwd_plain(*args, **kw), reps=5),
               b_ms, b_by, library_bwd_ms(lib, (qs, ks, vs)),
               device_ms=device_ms(lambda: bta.ball_attention_bwd(*args, **kw), "bta_bwd")[0],
               library_device_ms=library_bwd_device_ms(lib, (qs, ks, vs)),
               path=bta.bta_plan(BALL, D, 1, dtype).path)

        # ---- flash: N queries against L = N/ℓ pooled keys; the q_valid skip
        # in key-bias mode (the path's mode), the causal modes in fp32
        modes = [("key_bias", {}, mask, NB)]
        if dtype == torch.float32:
            modes += [("causal", {"causal": True}, None, N),
                      ("block_causal", {"block_causal": True, "ell": ELL}, None, NB)]
        for mode, mkw, q_valid, L in modes:
            kf = rand((B * H, L, D), dtype, dev, 35)
            vf = rand((B * H, L, D), dtype, dev, 36)
            kb_ = blk_bias if L == NB else key_bias
            kw = dict(n_heads=H, **mkw)
            o, lse = flash.flash_attention_fwd(q, kf, vf, kb_, q_valid, **kw)
            do = upstream(o, 37)
            args = (q, kf, vf, kb_, do, lse, row_delta(do, o))
            dq = flash.flash_attention_dq(*args, **kw)
            dkv = flash.flash_attention_dkv(*args, **kw)
            want = flash.flash_attention_bwd_plain(*args, **kw)
            torch.cuda.synchronize()
            vis = flash.visible_keys(N, L, causal=mkw.get("causal", False),
                                     block_causal=mkw.get("block_causal", False),
                                     ell=ELL, device=dev)
            pairs = (kb_ > NEG_INF / 2)[:, None, :].expand(B, N, L)
            if vis is not None:
                pairs = pairs & vis[None]
            pairs = pairs & mask[:, :, None]
            n_pairs = H * float(pairs.sum())
            side = 2 * 4 * q.numel() // D + 4 * B * L
            p_ms = median_ms(lambda: flash.flash_attention_bwd_plain(*args, **kw), reps=5)
            lib_ms = None
            if mode == "key_bias":
                qs = q.reshape(B, H, N, D).clone().requires_grad_(True)
                ks, vs = (t.reshape(B, H, L, D).clone().requires_grad_(True)
                          for t in (kf, vf))
                fmask = blk_valid[:, None, None, :]
                lib_ms = library_bwd_ms(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=fmask), (qs, ks, vs))
            err, ok = max_err((dq,), want[:1])
            b_ms, b_by = bound((3 * q.numel() + 2 * kf.numel()) * es + side,
                               6.0 * D * n_pairs, dtype)
            record("flash_dq", mode, dtype, err, ok,
                   median_ms(lambda: flash.flash_attention_dq(*args, **kw)), p_ms,
                   b_ms, b_by, lib_ms)
            err, ok = max_err(dkv, want[1:])
            b_ms, b_by = bound((2 * q.numel() + 4 * kf.numel()) * es + side,
                               8.0 * D * n_pairs, dtype)
            record("flash_dkv", mode, dtype, err, ok,
                   median_ms(lambda: flash.flash_attention_dkv(*args, **kw)), p_ms,
                   b_ms, b_by, lib_ms)

        # ---- selection: G = NB groups of g·rep = 8 rows, k* blocks of ℓ keys.
        # "topk": each layer's picks in the model's first train step (many
        # groups pick the same blocks, so their atomic adds meet), one call
        # per layer, times and bounds the mean over the layers; "random":
        # uniform picks; dead groups pick nothing in both
        M = GROUP * 1
        qg = rand((B, H, NB, M, D), dtype, dev, 38)
        kb = rand((B, H, NB, ELL, D), dtype, dev, 39)
        vb = rand((B, H, NB, ELL, D), dtype, dev, 40)
        g = torch.Generator(device=dev).manual_seed(41)
        idx = torch.randint(0, NB, (B, H, NB, KSTAR), generator=g, device=dev)
        idx = torch.where(blk_valid[:, None, :, None], idx, -1)
        idx = torch.where(blk_valid[:, None, None, :].expand(B, H, NB, NB)
                          .gather(3, idx.clamp(min=0)), idx, -1).int().contiguous()
        tok_bias = key_bias.reshape(B, NB, ELL).contiguous()
        do = rand((B, H, NB, M, D), dtype, dev, 42)
        do = torch.where(mask.reshape(B, 1, NB, M, 1), do, torch.zeros_like(do))
        # the forward on each layer's own picks (the main path's traffic):
        # errors the worst over the layers, times and bounds their mean
        errs, oks, k_ms, d_ms, p_ms, b_ms = ([] for _ in range(6))
        for layer_idx in picks:
            call = functools.partial(selection.selection_attention_fwd, qg, kb, vb, layer_idx,
                                     tok_bias)
            got = call()
            want = selection.selection_attention_fwd_plain(qg, kb, vb, layer_idx, tok_bias)
            torch.cuda.synchronize()
            err, ok = max_err(got, want)
            errs.append(err)
            oks.append(ok and selection_fwd_repro("topk", dtype, call))
            k_ms.append(median_ms(call))
            t = device_ms(call, "selection_fwd")[0]
            if t is not None:
                d_ms.append(t)
            p_ms.append(median_ms(functools.partial(selection.selection_attention_fwd_plain,
                                                    qg, kb, vb, layer_idx, tok_bias), reps=3))
            b_ms.append(selection_fwd_bound(qg, layer_idx, tok_bias))
        record("selection_fwd", "topk", dtype,
               max(errs) if all(math.isfinite(e) for e in errs) else math.nan, all(oks),
               statistics.fmean(k_ms), statistics.fmean(p_ms),
               statistics.fmean(t for t, _ in b_ms), b_ms[0][1],
               selection_library_ms(qg, kb, vb, picks[0], tok_bias),
               device_ms=statistics.fmean(d_ms) if d_ms else None, bit_identical=True,
               path=selection.selection_plan(M, ELL, D, dtype, KSTAR).path)
        for mode, idxs in (("topk", picks), ("random", [idx])):
            errs, oks, k_ms, p_ms, b_ms, d_ms, c_ms, r_ms, same = ([] for _ in range(9))
            lib_ms = selection_library_ms(qg, kb, vb, idxs[0], tok_bias, backward=True)
            for idx in idxs:
                o, lse = selection.selection_attention_fwd(qg, kb, vb, idx, tok_bias)
                args = (qg, kb, vb, idx, tok_bias, do, lse, row_delta(do, o))
                got = selection.selection_attention_bwd(*args)
                again = selection.selection_attention_bwd(*args)
                want = selection.selection_attention_bwd_plain(*args)
                torch.cuda.synchronize()
                err, ok = max_err(got, want, tol_table=SEL_BWD_TOL)
                errs.append(err)
                oks.append(ok)
                same.append(all(torch.equal(a, b) for a, b in zip(got, again)))
                ks = device_trace(lambda: selection.selection_attention_bwd(*args), 5)
                d_ms.append(per_call_ms(ks, 5, "selection_bwd"))
                c_ms.append(per_call_ms(ks, 5))
                r_ms.append([per_call_ms(ks, 5, "selection_bwd_" + part)
                             for part in ("ranks", "kernel", "reduce")])
                valid_sel = int((idx >= 0).sum())
                used = torch.zeros(B, H, NB, dtype=torch.bool, device=dev)
                used.scatter_(2, idx.clamp(min=0).reshape(B, H, -1).long(),
                              (idx >= 0).reshape(B, H, -1))
                nbytes = (3 * qg.numel() + 2 * int(used.sum()) * ELL * D) * es \
                    + 4 * 2 * kb.numel() + 4 * idx.numel() + 4 * tok_bias.numel() \
                    + 2 * 4 * qg.numel() // D
                b_ms.append(bound(nbytes, 10.0 * M * ELL * D * valid_sel, dtype))
                k_ms.append(median_ms(lambda: selection.selection_attention_bwd(*args)))
                p_ms.append(median_ms(lambda: selection.selection_attention_bwd_plain(*args),
                                      reps=5))
            valid = torch.stack(idxs) >= 0
            per_block = torch.zeros(len(idxs) * B * H * NB + 1, dtype=torch.long, device=dev)
            flat = (torch.arange(len(idxs) * B * H, device=dev).reshape(len(idxs), B, H, 1, 1)
                    * NB + torch.stack(idxs).long())
            per_block.index_add_(0, torch.where(valid, flat, per_block.numel() - 1).reshape(-1),
                                 torch.ones(valid.numel(), dtype=torch.long, device=dev))
            per_block = per_block[:-1].float()
            print(json.dumps({"selection_bwd_warp": {
                "mode": mode, "dtype": str(dtype).replace("torch.", ""),
                "bit_identical": all(same), "device_ms": statistics.fmean(d_ms),
                "call_device_ms": statistics.fmean(c_ms),
                **{f"{part}_device_ms": statistics.fmean(r[i] for r in r_ms)
                   for i, part in enumerate(("ranks", "kernel", "reduce"))},
                "selections_per_block_max": int(per_block.max()),
                "selections_per_block_mean": float(per_block.mean()),
                "selections_per_picked_block_mean": float(per_block[per_block > 0].mean()),
                "staging_bytes": 2 * 4 * B * H * NB * KSTAR * ELL * D}}), flush=True)
            check(all(same), f"selection_bwd [{mode}, {dtype}]: two calls on the same "
                             "inputs differ")
            record("selection_bwd", mode, dtype,
                   max(errs) if all(math.isfinite(e) for e in errs) else math.nan, all(oks),
                   statistics.fmean(k_ms), statistics.fmean(p_ms),
                   statistics.fmean(t for t, _ in b_ms), b_ms[0][1], lib_ms,
                   device_ms=statistics.fmean(d_ms),
                   path=selection.selection_plan(M, ELL, D, dtype).path)

        # ---- epilogue: R = B·N·H rows of D
        R = B * N * H
        os_ = [rand((R, D), dtype, dev, 43 + i) for i in range(3)]
        gs = [torch.sigmoid(rand((R,), torch.float32, dev, 46 + i)) for i in range(3)]
        m = mask[:, :, None].expand(B, N, H).reshape(R).float()
        epilogue_bwd_row(record, "rows", (*os_, *gs, m, rand((R, D), dtype, dev, 49)))
    return results


def same_segment_pairs(offsets, mask) -> int:
    """(valid row, valid pooled key) pairs of one segment, summed over the
    segments: the varlen kernels' work for one head on this data."""
    blk = mask.reshape(-1, ELL).any(-1)
    return sum(int(mask[a:b].sum()) * int(blk[a // ELL:b // ELL].sum())
               for a, b in zip(offsets[:-1], offsets[1:]))


def varlen_case(dev, offsets, mask, dtype, seed):
    """The compression branch's varlen call on a packed batch: T rows
    against L = T/ℓ pooled keys, the block validity as key bias, the maps
    of ``q_offsets = offsets`` and ``k_offsets = offsets / ℓ``."""
    T = mask.shape[0]
    L = T // ELL
    maps = varlen_maps(offsets, offsets // ELL, T, L, dev)
    blk = torch.from_numpy(mask.reshape(L, ELL).any(-1)).to(dev)
    args = (rand((H, 1, T, D), dtype, dev, seed), rand((H, L, D), dtype, dev, seed + 1),
            rand((H, L, D), dtype, dev, seed + 2),
            torch.where(blk, 0.0, NEG_INF).float()[None], maps.qseg[None],
            maps.kseg[None], maps.q_bounds, maps.k_bounds)
    dense_mask = (maps.qseg[:, None] == maps.kseg[None, :]) & blk[None, :]   # (T, L)
    return args, dense_mask


def varlen_repro(name, dtype, calls, **plan) -> None:
    """Two calls of a varlen kernel on the same inputs: the ``varlen_repro``
    line, and a failed check unless their bits are equal."""
    first, second = calls(), calls()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    line = {"name": name, "dtype": str(dtype).replace("torch.", ""), "bit_identical": same}
    print(json.dumps({"varlen_repro": {**line, **plan}}), flush=True)
    check(same, f"{name} [{dtype}]: two calls on the same inputs differ")


def varlen_kernel_phase(dev, serve_offsets, serve_mask, train_batch) -> list[dict]:
    """The three varlen kernels against their plain versions: the forward at
    packed serving's shapes, the backward at the packed train batch's, with
    an upstream gradient that is zero on padded query rows; the host
    offsets go to every call, as ``VarlenAttentionFn`` passes them."""
    results = []
    record = recorder(results)
    T = CAPACITY
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        plan = varlen.varlen_plan(D, dtype)
        # ---- forward: the first 8 serving clouds packed to 30,720 rows
        args, dense = varlen_case(dev, serve_offsets, serve_mask, dtype, 60)
        q, k, v = args[:3]
        off = dict(offsets=(serve_offsets, serve_offsets // ELL))
        fwd_call = lambda: varlen.flash_attention_varlen_fwd(*args, **off)  # noqa: E731
        got = fwd_call()
        want = varlen.flash_attention_varlen_fwd_plain(*args[:6])
        torch.cuda.synchronize()
        err, ok = max_err(got, want)
        row_plan = {}
        if plan.path == "fma":
            row_plan = dict(row_tiles=varlen_row_tiles(*off["offsets"], T, k.shape[1], dev,
                                                       rows=plan.rows).shape[0])
        varlen_repro("varlen_fwd", dtype, fwd_call, path=plan.path, **row_plan)
        pairs = H * same_segment_pairs(serve_offsets, serve_mask)
        nbytes = (2 * q.numel() + 2 * k.numel()) * es + 4 * 3 * k.shape[1] + 4 * T \
            + 4 * q.numel() // D
        b_ms, b_by = bound(nbytes, 4.0 * D * pairs, dtype)
        qs, ks, vs = q.reshape(1, H, T, D), k[None], v[None]
        record("varlen_fwd", "packed_serve", dtype, err, ok, median_ms(fwd_call),
               median_ms(lambda: varlen.flash_attention_varlen_fwd_plain(*args[:6]), reps=5),
               b_ms, b_by,
               median_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                                attn_mask=dense)),
               device_ms=device_ms(fwd_call, "varlen_fwd")[0], path=plan.path)
        if dtype == torch.float32:
            qrng, krng = tile_seg_ranges(args[4][0], 128), tile_seg_ranges(args[5][0], 64)
            live = ranges_live_map(qrng, krng)
            print(json.dumps({"varlen_live_tiles": {
                "query_tiles_of_128": live.shape[0], "key_tiles_of_64": live.shape[1],
                "live": int(live.sum()), "total": live.numel(),
                "same_segment_pairs_per_head": pairs // H,
                "dense_pairs_per_head": T * k.shape[1]}}), flush=True)

        # ---- backward: the packed train batch (8 clouds of 2800–3586 points)
        offsets = train_batch["offsets"].numpy()
        mask = train_batch["mask"][0].cpu().numpy()
        args, dense = varlen_case(dev, offsets, mask, dtype, 70)
        q, k, v = args[:3]
        off = dict(offsets=(offsets, offsets // ELL))
        o, lse = varlen.flash_attention_varlen_fwd(*args, **off)
        do = rand(o.shape, dtype, dev, 73)
        row_ok = torch.from_numpy(mask).to(dev)[None, None, :, None]
        do = torch.where(row_ok, do, torch.zeros_like(do))
        rest = (do, lse, row_delta(do, o))
        dq_call = lambda: (varlen.flash_attention_varlen_dq(*args, *rest, **off),)  # noqa: E731
        dkv_call = lambda: varlen.flash_attention_varlen_dkv(*args, *rest, **off)  # noqa: E731
        dq, dkv = dq_call()[0], dkv_call()
        want = varlen.flash_attention_varlen_bwd_plain(*args[:6], *rest)
        torch.cuda.synchronize()
        dq_plan, dkv_plan = {}, {}
        if plan.path == "fma":
            dq_plan = dict(row_tiles=varlen_row_tiles(*off["offsets"], T, k.shape[1], dev,
                                                      rows=plan.rows).shape[0])
            tiles = varlen_dkv_tiles(*off["offsets"], T, k.shape[1], dev, keys=plan.keys,
                                     rows=plan.row_tile, heads=H,
                                     sms=torch.cuda.get_device_properties(dev)
                                     .multi_processor_count)
            dkv_plan = dict(key_tiles=tiles.table.shape[0], splits=tiles.splits)
        varlen_repro("varlen_dq", dtype, dq_call, path=plan.path, **dq_plan)
        varlen_repro("varlen_dkv", dtype, dkv_call, path=plan.path, **dkv_plan)
        pairs = H * same_segment_pairs(offsets, mask)
        side = 2 * 4 * q.numel() // D + 4 * 3 * k.shape[1] + 4 * T
        p_ms = median_ms(lambda: varlen.flash_attention_varlen_bwd_plain(*args[:6], *rest),
                         reps=5)
        qs = q.reshape(1, H, T, D).clone().requires_grad_(True)
        ks, vs = (t[None].clone().requires_grad_(True) for t in (k, v))
        lib_ms = library_bwd_ms(lambda: F.scaled_dot_product_attention(
            qs, ks, vs, attn_mask=dense), (qs, ks, vs))
        err, ok = max_err((dq,), want[:1])
        b_ms, b_by = bound((3 * q.numel() + 2 * k.numel()) * es + side, 6.0 * D * pairs,
                           dtype)
        record("varlen_dq", "packed_train", dtype, err, ok, median_ms(dq_call), p_ms,
               b_ms, b_by, lib_ms, device_ms=device_ms(dq_call, "varlen_dq")[0],
               path=plan.path)
        err, ok = max_err(dkv, want[1:])
        b_ms, b_by = bound((2 * q.numel() + 4 * k.numel()) * es + side, 8.0 * D * pairs,
                           dtype)
        record("varlen_dkv", "packed_train", dtype, err, ok, median_ms(dkv_call), p_ms,
               b_ms, b_by, lib_ms,
               device_ms=device_ms(dkv_call, "varlen_dkv", per_call=True)[0],
               path=plan.path)
    return results


# output_hashes: (B*Hkv, n_heads, rep, N, L, D, mask) of shapenet's compression
# branch, the LM's block-causal pooled keys and causal D 128
def baseline_kernel_phase(dev, mask) -> list[dict]:
    """The kernels at the shapes the baselines' train steps give them, fp32,
    against their plain versions, timed beside SDPA with the same mask.
    ``mask``: the train batch's (B, 4096) mask (8 clouds of 3586 points).

    shapenet-full: ``flash_fwd``, ``flash_dq``, ``flash_dkv`` with 3840
    queries against 3840 keys, a key bias from the padding mask and no
    ``q_valid`` (every query row is computed; dO is zero on padded rows, as
    the masked loss gives it); ``flash_dkv``'s row splits and identical bits
    on two calls.  shapenet-erwin: ``bta_fwd`` / ``bta_bwd`` at each level's
    pooled sequence (4096, 2048, 1024 tokens, ball 256; a pooled token is
    valid iff one of its tokens is)."""
    results = []
    record = recorder(results)
    es = 4
    # ---- flash: N queries against N keys, key bias
    n = N
    key_mask = mask[:, :n]
    key_bias = torch.where(key_mask, 0.0, NEG_INF).float()
    q = rand((B * H, 1, n, D), torch.float32, dev, 90)
    k = rand((B * H, n, D), torch.float32, dev, 91)
    v = rand((B * H, n, D), torch.float32, dev, 92)
    kw = dict(n_heads=H)
    call = functools.partial(flash.flash_attention_fwd, q, k, v, key_bias, None, **kw)
    plain = functools.partial(flash.flash_attention_fwd_plain, q, k, v, key_bias, None, **kw)
    o, lse = call()
    err, ok = max_err((o, lse), plain())
    valid_keys = float(key_mask.sum()) * n * H            # (row, key) pairs, every row
    b_ms, b_by = bound((2 * q.numel() + 2 * k.numel()) * es + 4 * B * n
                       + 4 * q.numel() // D, 4.0 * D * valid_keys, torch.float32)
    qs, ks, vs = (t.reshape(B, H, n, D).clone().requires_grad_(True) for t in (q, k, v))
    fmask = key_mask[:, None, None, :]
    lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=fmask)  # noqa: E731
    with torch.no_grad():
        lib_ms, lib_dev = median_ms(lib), device_ms(lib, per_call=True)[0]
    record("flash_fwd", "full", torch.float32, err, ok, median_ms(call),
           median_ms(plain, reps=5), b_ms, b_by, lib_ms,
           device_ms=device_ms(call, "flash_fwd")[0], library_device_ms=lib_dev,
           path=flash.flash_fwd_plan(D, torch.float32).path)
    do = rand(o.shape, torch.float32, dev, 93)
    do = torch.where(key_mask.repeat_interleave(H, 0)[:, None, :, None], do,
                     torch.zeros_like(do))
    args = (q, k, v, key_bias, do, lse, row_delta(do, o))
    dq = flash.flash_attention_dq(*args, **kw)
    dkv = flash.flash_attention_dkv(*args, **kw)
    again = flash.flash_attention_dkv(*args, **kw)
    want = flash.flash_attention_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(dkv, again))
    check(same, "flash_dkv [full]: two calls on the same inputs differ")
    live_pairs = float(key_mask.sum(1).mul(key_mask.sum(1)).sum()) * H   # real rows only
    side = 2 * 4 * q.numel() // D + 4 * B * n
    p_ms = median_ms(lambda: flash.flash_attention_bwd_plain(*args, **kw), reps=5)
    lib_bwd = library_bwd_ms(lib, (qs, ks, vs))
    lib_bwd_dev = library_bwd_device_ms(lib, (qs, ks, vs))
    splits = flash.dkv_splits(n, n, B * H, D, sms=torch.cuda.get_device_properties(
        dev).multi_processor_count)
    for name, got, ref, nbytes, flops in (
            ("flash_dq", (dq,), want[:1], (3 * q.numel() + 2 * k.numel()) * es + side,
             6.0 * D * live_pairs),
            ("flash_dkv", dkv, want[1:], (2 * q.numel() + 4 * k.numel()) * es + side,
             8.0 * D * live_pairs)):
        fn = getattr(flash, "flash_attention_" + name.split("_")[1])
        err, ok = max_err(got, ref)
        b_ms, b_by = bound(nbytes, flops, torch.float32)
        extra = {"bit_identical": same, "splits": splits} if name == "flash_dkv" else {}
        record(name, "full", torch.float32, err, ok,
               median_ms(functools.partial(fn, *args, **kw)), p_ms, b_ms, b_by, lib_bwd,
               device_ms=device_ms(functools.partial(fn, *args, **kw), name)[0],
               library_device_ms=lib_bwd_dev, **extra)
    del qs, ks, vs, want

    # ---- bta: each Erwin level's pooled sequence, one ball of 256 keys per row
    for level in range(3):
        s_ = 1 << level
        n = ERWIN_N // s_
        pmask = mask.reshape(B, n, s_).any(-1)
        kb = torch.where(pmask, 0.0, NEG_INF).float()
        q = rand((B * H, 1, n, D), torch.float32, dev, 94 + level)
        k = rand((B * H, n, D), torch.float32, dev, 97 + level)
        v = rand((B * H, n, D), torch.float32, dev, 100 + level)
        kw = dict(ball_size=BALL, n_heads=H)
        mode = f"erwin_l{level}"
        path = bta.bta_plan(BALL, D, 1, torch.float32).path
        live_balls = int(pmask.reshape(B, n // BALL, BALL).any(-1).sum()) * H
        qs, ks, vs = (t.reshape(B, H, n // BALL, BALL, D).transpose(1, 2)
                      .reshape(B * (n // BALL), H, BALL, D).contiguous()
                      .requires_grad_(True) for t in (q, k, v))
        bmask = pmask.reshape(B * (n // BALL), 1, 1, BALL)
        lib = lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=bmask)  # noqa: E731
        call = functools.partial(bta.ball_attention_fwd, q, k, v, kb, **kw)
        o, lse = call()
        err, ok = max_err((o, lse), bta.ball_attention_fwd_plain(q, k, v, kb, **kw))
        b_ms, b_by = bound(4 * q.numel() * es + 4 * B * n + 4 * B * (n // BALL)
                           + 4 * q.numel() // D, 4.0 * BALL * BALL * D * live_balls,
                           torch.float32)
        with torch.no_grad():
            lib_ms, lib_dev = median_ms(lib), device_ms(lib, per_call=True)[0]
        record("bta_fwd", mode, torch.float32, err, ok, median_ms(call),
               median_ms(lambda: bta.ball_attention_fwd_plain(q, k, v, kb, **kw), reps=5),
               b_ms, b_by, lib_ms, device_ms=device_ms(call, "bta_fwd")[0],
               library_device_ms=lib_dev, path=path)
        do = rand(o.shape, torch.float32, dev, 103 + level)
        do = torch.where(pmask.repeat_interleave(H, 0)[:, None, :, None], do,
                         torch.zeros_like(do))
        args = (q, k, v, kb, do, lse, row_delta(do, o))
        call = functools.partial(bta.ball_attention_bwd, *args, **kw)
        err, ok = max_err(call(), bta.ball_attention_bwd_plain(*args, **kw))
        b_ms, b_by = bound(7 * q.numel() * es + 2 * 4 * q.numel() // D + 4 * B * n
                           + 4 * B * (n // BALL), 10.0 * BALL * BALL * D * live_balls,
                           torch.float32)
        record("bta_bwd", mode, torch.float32, err, ok, median_ms(call),
               median_ms(lambda: bta.ball_attention_bwd_plain(*args, **kw), reps=5),
               b_ms, b_by, library_bwd_ms(lib, (qs, ks, vs)),
               device_ms=device_ms(call, "bta_bwd")[0],
               library_device_ms=library_bwd_device_ms(lib, (qs, ks, vs)), path=path)
    return results


HASH_CASES = {"shapenet_cmp": (64, 8, 1, 3840, 480, 32, {}),
              "lm_block_causal": (8, 4, 8, 4096, 64, 64, dict(block_causal=True, ell=64)),
              "causal_d128": (8, 8, 3, 1024, 1024, 128, dict(causal=True))}
# the packed case of output_hashes: three clouds packed to 3,072 rows
HASH_OFFSETS = np.array([0, 1024, 2304, 2816, 3072], np.int32)


def output_hashes(dev) -> dict:
    """sha256 (16 hex digits) of every kernel's outputs in fp32 and bf16 on
    inputs drawn from fixed seeds, on the paths the main paths take: equal
    hashes from two trees mean equal bits, so a change that moves a kernel's
    code can be held to its parent.  ``flash_fwd`` / ``flash_dq`` on
    ``HASH_CASES`` (about a sixth of the keys dead), ``flash_dkv`` beside
    them; ``bta_fwd`` / ``bta_bwd`` on 16 heads of 1,024 positions (balls of
    256, D 32, a padded tail; in bf16 also at D 64 with rep 2, ``mma_d64``,
    and in balls of 32, ``rows_ball32``); ``selection_fwd`` on groups of 8 rows (ℓ 8,
    D 32, k* 4: shapenet's) and of 64 rows (ℓ 64, D 64), ``selection_bwd``
    on the former, ``selection_dq`` / ``selection_dkv`` on the latter; the
    epilogues on 8,192 rows of 32 and 64; the varlen kernels on three clouds
    packed to 3,072 rows (``HASH_OFFSETS``); the local kernels on
    ``lm_window_case(dev, 2048)``; ``paged_gather`` and ``paged_gather_pair``
    on one decode step's rows.  Every backward kernel gets its inputs from the
    plain forward, so its hash holds only its own code.  ``epilogue_fwd``
    takes the rows' gates as (8,192, 1) (H = 1: one gate a row) and the mask
    as bool, the same values the (R,) fp32 form of the first version gave.
    ``paths``: :func:`path_hashes`."""
    def draw(shape, seed, dtype):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def digest(*ts):
        m = hashlib.sha256()
        for t in ts:
            m.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return m.hexdigest()[:16]

    out = {}
    for name, (BH, nh, rep, n, L, d, mode) in HASH_CASES.items():
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (draw(shape, seed, dtype) for shape, seed in
                       (((BH, rep, n, d), 1), ((BH, L, d), 2), ((BH, L, d), 3)))
            kb = torch.where(draw((BH // nh, L), 4, torch.float32) > -1.0, 0.0, -1e30).float()
            o, lse = flash.flash_attention_fwd(q, k, v, kb, n_heads=nh, **mode)
            do = draw(o.shape, 5, dtype)
            dq = flash.flash_attention_dq(q, k, v, kb, do, lse, row_delta(do, o), n_heads=nh,
                                          **mode)
            dkv = flash.flash_attention_dkv(q, k, v, kb, do, lse, row_delta(do, o),
                                            n_heads=nh, **mode)
            out[f"{name}/{str(dtype).replace('torch.', '')}"] = {
                "flash_fwd": digest(o, lse), "flash_dq": digest(dq), "flash_dkv": digest(*dkv)}
    for dtype in (torch.float32, torch.bfloat16):
        dt, row = str(dtype).replace("torch.", ""), {}
        # bta: 2 samples × 8 heads of 1,024 positions, the second padded from 700
        ok = torch.arange(1024, device=dev)[None] < torch.tensor([[1024], [700]], device=dev)
        kbias = torch.where(ok, 0.0, NEG_INF).float()
        q, k, v = (draw(sh, s, dtype) for sh, s in (((16, 1, 1024, 32), 10),
                                                    ((16, 1024, 32), 11), ((16, 1024, 32), 12)))
        kw = dict(ball_size=BALL, n_heads=8)
        o, lse = bta.ball_attention_fwd(q, k, v, kbias, **kw)
        row["bta_fwd"] = digest(o, lse)
        o, lse = bta.ball_attention_fwd_plain(q, k, v, kbias, **kw)
        do = draw(o.shape, 13, dtype)
        row["bta_bwd"] = digest(*bta.ball_attention_bwd(q, k, v, kbias, do, lse,
                                                        row_delta(do, o), **kw))
        if dtype == torch.bfloat16:
            # the bf16 paths at other shapes: mma at D 64 (rep 2), rows at balls of 32
            for tag, (rep_, d, ball) in (("mma_d64", (2, 64, BALL)), ("rows_ball32", (1, 32, 32))):
                q, k, v = (draw(sh, s, dtype) for sh, s in (((16, rep_, 1024, d), 14),
                                                            ((16, 1024, d), 15),
                                                            ((16, 1024, d), 16)))
                kw = dict(ball_size=ball, n_heads=8)
                o, lse = bta.ball_attention_fwd(q, k, v, kbias, **kw)
                row[f"bta_fwd/{tag}"] = digest(o, lse)
                o, lse = bta.ball_attention_fwd_plain(q, k, v, kbias, **kw)
                do = draw(o.shape, 17, dtype)
                row[f"bta_bwd/{tag}"] = digest(*bta.ball_attention_bwd(
                    q, k, v, kbias, do, lse, row_delta(do, o), **kw))
        # selection: groups of 8 rows (shapenet's), of 64 rows (the tiled path)
        for tag, (G, M, NB_, ell, d) in (("m8", (48, 8, 48, 8, 32)),
                                         ("m64", (8, 64, 16, 64, 64))):
            qg = draw((2, 2, G, M, d), 20, dtype)
            kb_, vb_ = draw((2, 2, NB_, ell, d), 21, dtype), draw((2, 2, NB_, ell, d), 22, dtype)
            g = torch.Generator(device=dev).manual_seed(23)
            idx = torch.randint(-1, NB_, (2, 2, G, 4), generator=g, device=dev).int()
            tok = torch.where(draw((2, NB_, ell), 24, torch.float32) > -1.5, 0.0,
                              NEG_INF).float()
            o, lse = selection.selection_attention_fwd(qg, kb_, vb_, idx, tok)
            row[f"selection_fwd/{tag}"] = digest(o, lse)
            o, lse = selection.selection_attention_fwd_plain(qg, kb_, vb_, idx, tok)
            do = draw(o.shape, 25, dtype)
            args = (qg, kb_, vb_, idx, tok, do, lse, row_delta(do, o))
            if tag == "m8":
                row["selection_bwd"] = digest(*selection.selection_attention_bwd(*args))
            else:
                row["selection_dq"] = digest(selection.selection_attention_dq(*args))
                row["selection_dkv"] = digest(*selection.selection_attention_dkv(*args))
        # epilogues: 8,192 rows of 32 and of 64
        for d in (32, 64):
            os_ = [draw((8192, d), 30 + i, dtype) for i in range(3)]
            gs = [torch.sigmoid(draw((8192,), 33 + i, torch.float32)) for i in range(3)]
            m = draw((8192,), 36, torch.float32) > -1.0
            row[f"epilogue_fwd/d{d}"] = digest(epilogue.gated_combine_fwd(
                *os_, *(g[:, None] for g in gs), m))
            row[f"epilogue_bwd/d{d}"] = digest(*epilogue.gated_combine_bwd(
                *os_, *gs, m.float(), draw((8192, d), 37, dtype)))
        # varlen: three clouds packed to 3,072 rows (and a capacity tail)
        T = int(HASH_OFFSETS[-1]) + 512
        vmask = np.zeros(T, bool)
        for a, b in zip(HASH_OFFSETS[:-1], HASH_OFFSETS[1:]):
            vmask[a:b - 100] = True
        args, _ = varlen_case(dev, HASH_OFFSETS, vmask, dtype, 40)
        off = dict(offsets=(HASH_OFFSETS, HASH_OFFSETS // ELL))
        row["varlen_fwd"] = digest(*varlen.flash_attention_varlen_fwd(*args, **off))
        o, lse = varlen.flash_attention_varlen_fwd_plain(*args[:6])
        do = draw(o.shape, 43, dtype)
        rest = (do, lse, row_delta(do, o))
        row["varlen_dq"] = digest(varlen.flash_attention_varlen_dq(*args, *rest, **off))
        row["varlen_dkv"] = digest(*varlen.flash_attention_varlen_dkv(*args, *rest, **off))
        # local: one 2,048-token sequence (a tail, a hole, a sample boundary)
        key_bias, blk_seg = lm_window_case(dev, 2048)
        q = draw((LM_HKV, LM_HQ // LM_HKV, 2048, LM_D), 50, dtype)
        k, v = draw((LM_HKV, 2048, LM_D), 51, dtype), draw((LM_HKV, 2048, LM_D), 52, dtype)
        lkw = dict(window=LM_W, n_heads=LM_HKV)
        row["local_fwd"] = digest(*local.local_window_fwd(q, k, v, key_bias, blk_seg, **lkw))
        o, lse = local.local_window_fwd_plain(q, k, v, key_bias, blk_seg, **lkw)
        do = draw(o.shape, 53, dtype)
        args = (q, k, v, key_bias, blk_seg, do, lse, row_delta(do, o))
        live = local.live_map(key_bias, blk_seg, LM_W)
        row["local_dq"] = digest(local.local_window_dq(*args, live=live, **lkw))
        row["local_dkv"] = digest(*local.local_window_dkv(*args, live=live, **lkw))
        # paged_gather: one decode step's window rows and compressed rows
        win_rows, crow, _, R = decode_rows(dev)
        pool = draw((R, LM_HKV, LM_D), 60, dtype)
        row["paged_gather"] = digest(paged.paged_gather(pool, win_rows),
                                     paged.paged_gather(pool, crow))
        v_pool = draw((R, LM_HKV, LM_D), 61, dtype)
        row["paged_gather_pair"] = digest(*paged.paged_gather_pair(pool, v_pool, win_rows),
                                          *paged.paged_gather_pair(pool, v_pool, crow))
        out[f"kernels/{dt}"] = row
    out["paths"] = path_hashes(dev)
    return out


def path_hashes(dev) -> dict:
    """sha256 (16 hex digits) of what two main paths give on seeded inputs,
    through model-level entry points only, so the same code runs on a
    parent's kernels: ``serve``, a 2-layer ``shapenet-bsa`` at full width
    (fp32, weights from seed 0) on two clouds of 3840 rows (the second
    padded from 3,000) through ``api.forward``; ``decode``, the logits of
    130 steps of ``api.paged_decode_step`` on a 2-layer ``tinyllama-1.1b``
    at full width (bf16, weights from seed 0) over two slots (pages of 256,
    lengths 130 and 100 from steps 0 and 30), which gathers from its pools
    and completes compressed blocks on the way."""
    def digest(*ts):
        m = hashlib.sha256()
        for t in ts:
            m.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return m.hexdigest()[:16]

    out = {}
    with torch.inference_mode():
        api = model_api(get_config("shapenet-bsa").scaled(n_layers=2))
        model = api.init(seed=0, device=dev)
        batch = api.make_batch(np.random.default_rng(0), 2, N, device=dev)
        batch["mask"][1, 3000:] = False
        out["serve"] = digest(api.forward(model, batch))
        del model
        api = model_api(get_config(LM).scaled(n_layers=2))
        model = api.init(seed=0, device=dev)
        lens, starts, steps = (130, 100), (0, 30), 130
        n_pages = 2                          # a slot holds two local windows
        num_blocks = 2 * n_pages
        caches = api.paged_cache_init(2, num_blocks, PAGE, api.mcfg.cdtype(), device=dev)
        tokens = torch.from_numpy(np.random.default_rng(5).integers(
            0, api.mcfg.vocab_size, (2, steps), dtype=np.int32)).to(dev)
        logits = []
        for t in range(steps):
            live = [0 <= t - s < n for s, n in zip(starts, lens)]
            table = torch.tensor([[b * n_pages + p if live[b] else num_blocks
                                   for p in range(n_pages)] for b in range(2)], device=dev)
            lengths = torch.tensor([max(t - s, 0) if ok else 0
                                    for s, ok in zip(starts, live)], device=dev)
            pos = lengths.clamp(max=steps - 1)
            step_logits, caches = api.paged_decode_step(
                model, tokens[torch.arange(2, device=dev), pos], caches, table, lengths, PAGE)
            logits.append(step_logits)
        out["decode"] = digest(*logits)
    return out


def check_launches(launches: dict, path: str, per_kernel: int,
                   per_forward_kernel: int | None = None) -> None:
    """Every kernel of ``path`` launched ``per_kernel`` times (its forward
    kernels ``per_forward_kernel`` times, when given), every other kernel
    never."""
    for name, n in launches.items():
        want = per_kernel if name in PATHS[path] else 0
        if want and per_forward_kernel is not None and name.endswith("_fwd"):
            want = per_forward_kernel
        check(n == want, f"{name} launched {n} times on {path}, expected {want}")


def check_ball_path(cfg, what: str) -> None:
    """The paper's shape takes the ball kernels' register-tiled path."""
    plan = bta.bta_plan(cfg.bsa.ball_size, cfg.resolved_head_dim,
                        cfg.n_heads // cfg.n_kv_heads, getattr(torch, cfg.compute_dtype))
    check(plan.path == "fma", f"{what}: bta_fwd / bta_bwd not on the fma path: {plan}")


def serve_phase(dev, api, model, clouds, layout: str) -> tuple[dict, list]:
    """Serve ``clouds`` in batches of 8 through ``GeometryEngine`` in
    ``layout`` at the capacity of 8 × 3840 rows."""
    cfg = api.mcfg
    check_ball_path(cfg, f"serve {layout}")
    pad_to = N if layout == "padded" else CAPACITY

    def engine(backend=None):
        return GeometryEngine(api, model, batch_slots=8, pad_to=pad_to, layout=layout,
                              backend=backend)

    engine().predict(clouds[:8])                        # warm-up batch
    torch.cuda.synchronize()
    eng = engine()
    reset_counters()                                    # just before the main path
    outs, latency = [], []
    for s in range(0, len(clouds), 8):
        t0 = time.perf_counter()
        outs += eng.predict(clouds[s:s + 8])
        torch.cuda.synchronize()
        latency.append((time.perf_counter() - t0) * 1e3)
    launches = {name: c.n for name, c in COUNTERS.items()}  # just after it
    batches = len(latency)
    stats = {"layout": layout, "pad_to": pad_to, "clouds_served": eng.clouds_served,
             "points_served": eng.points_served,
             "points_per_second": eng.points_per_second, "batch_latency_ms": latency,
             "launches": launches}
    print(json.dumps({"serve": stats}), flush=True)
    check_launches(launches, f"serve_{layout}", cfg.n_layers * batches)
    for out, c in zip(outs, clouds):
        check(out.shape == (c["points"].shape[0], 1), f"output shape {out.shape}")
        check(bool(torch.isfinite(torch.from_numpy(out)).all()), "non-finite output")

    stats["reference_check"] = reference_check(
        engine(), model, cfg, clouds[:8], outs[:8],
        engine(backend="reference").predict(clouds[:8]))
    profile_batch(engine(), clouds[:8])
    return stats, outs


def compare_layouts(clouds, padded, packed) -> dict:
    """The packed and padded engines' outputs for the same clouds: reported,
    not held (a top-k near-tie may pick another block in one of them)."""
    diff = [np.abs(a - b) for a, b in zip(packed, padded)]
    beyond = [int((d > 1e-3 * (1 + np.abs(b))).sum()) for d, b in zip(diff, padded)]
    stats = {"max_abs_diff": float(max(d.max() for d in diff)),
             "points_beyond_1e-3": sum(beyond),
             "clouds_with_points_beyond_1e-3": sum(1 for n in beyond if n),
             "points": sum(c["points"].shape[0] for c in clouds)}
    print(json.dumps({"packed_vs_padded": stats}), flush=True)
    return stats


def train_batches(dev) -> list[dict]:
    """1 + ``TRAIN_STEPS`` batches of 8 ShapeNet-Car train clouds (seed 0
    order), padded to 3840, on the card."""
    t0 = time.perf_counter()
    ds = ShapeNetCarDataset("train")
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
               for _, b in zip(range(TRAIN_STEPS + 1), ds.batches(B, seed=0, pad_to=N))]
    print(f"# made {len(batches) * B} train clouds in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return batches


def packed_train_batches(dev) -> list[dict]:
    """1 + ``TRAIN_STEPS`` packed batches of 8 ShapeNet-Car train clouds of
    2800–3586 points (seed 0 order): each item's feats, target and mask
    (already ball multiples long) packed to ``CAPACITY`` rows; feats,
    target and mask (1, T, ·) on the card, offsets (9,) on the host."""
    t0 = time.perf_counter()
    ds = ShapeNetCarDataset("train", n_points_range=(2800, REAL_POINTS))
    order = np.random.default_rng(0).permutation(len(ds))
    batches = []
    for s in range(0, (TRAIN_STEPS + 1) * B, B):
        items = [ds[int(j)] for j in order[s:s + B]]
        b = {}
        for key in ("feats", "target", "mask"):
            rows, offsets, _ = pack_varlen([it[key] for it in items], BALL, pad_to=CAPACITY,
                                           max_samples=B)
            b[key] = torch.from_numpy(rows[None]).to(dev)
        b["offsets"] = torch.from_numpy(offsets)
        batches.append(b)
    print(f"# made {len(batches) * B} packed train clouds in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return batches


def train_phase(dev, batches, layout: str, arch: str = "shapenet-bsa",
                path: str | None = None) -> dict:
    """``arch`` at full width and depth: a warm-up step on ``batches[0]``,
    then a timed step on each other batch; each kernel of ``path`` (default
    ``train_<layout>``) must launch once a layer and step, and no other
    kernel; every layer is held to the reference backend on ``batches[1]``."""
    cfg = get_config(arch)
    if cfg.attention != "full":                         # a ball kernel runs
        check_ball_path(cfg, f"train {arch} {layout}")
    path = path or f"train_{layout}"
    steps = len(batches) - 1
    api = model_api(cfg)
    model = api.init(seed=0, device=dev)
    opt_state = adamw_init(dict(model.named_parameters()))
    step = make_train_step(api, base_lr=1e-3, weight_decay=0.01, total_steps=300,
                           warmup_steps=30)                 # paper App. A settings
    model, opt_state, _ = step(model, opt_state, batches[0])      # warm-up step
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()                                    # just before the main path
    metrics, step_ms = [], []
    for batch in batches[1:]:
        t0 = time.perf_counter()
        model, opt_state, out = step(model, opt_state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(out)
    launches = {name: c.n for name, c in COUNTERS.items()}  # just after it
    points = sum(int(b["mask"].sum()) for b in batches[1:])
    stats = {"arch": arch, "layout": layout, "path": path, "steps": steps, "batch": B,
             "pad_to": batches[0]["mask"].shape[1] if layout == "padded" else CAPACITY,
             "points": points,
             "loss": [float(m["loss"]) for m in metrics],
             "grad_norm": [float(m["grad_norm"]) for m in metrics],
             "lr": [m["lr"] for m in metrics], "step_ms": step_ms,
             "median_step_ms": statistics.median(step_ms),
             "trained_points_per_second": points / (sum(step_ms) / 1e3),
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches": launches}
    print(json.dumps({"train": stats}), flush=True)
    check(all(math.isfinite(x) for x in stats["loss"] + stats["grad_norm"]),
          f"{arch}: non-finite loss or gradient norm")
    check(all(bool(torch.isfinite(p.grad).all()) for p in model.parameters()
              if p.grad is not None), f"{arch}: non-finite gradient")  # φ_q: top-k only
    check_launches(launches, path, cfg.n_layers * steps)
    stats["reference_check"] = train_reference_check(model, cfg, batches[1])
    profile_train_step(step, model, opt_state, batches[1], layout, arch)
    return stats


def baselines_phase(dev, shapenet_batches) -> dict:
    """The paper's other workloads (``BASELINES``) trained at full width and
    depth: 1 + ``BASELINE_STEPS`` batches of 8 each, ShapeNet-Car train
    clouds (the padded train phase's first batches; Erwin's padded on to
    4096 rows, as ``ShapeNetCarDataset.batches(pad_to=4096)`` gives them) or
    ``ElasticityDataset("train")`` plates padded to 1024.  Returns config →
    its train stats."""
    shapenet = shapenet_batches[:BASELINE_STEPS + 1]
    elastic = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for _, b in zip(
        range(BASELINE_STEPS + 1),
        ElasticityDataset("train").batches(B, seed=0, pad_to=ELASTICITY_N))]
    out = {}
    for arch, (path, n) in BASELINES.items():
        batches = elastic if arch.startswith("elasticity") else [
            pad_rows(b, n) for b in shapenet]
        t0 = time.perf_counter()
        out[arch] = train_phase(dev, batches, "padded", arch, path)
        print(f"# {arch}: {time.perf_counter() - t0:.1f} s", flush=True)
        torch.cuda.empty_cache()
    return out


def pad_rows(batch: dict, n: int) -> dict:
    """A padded batch padded on to ``n`` rows: zero features and targets,
    mask False, as ``pack_items`` pads."""
    return {k: F.pad(v, (0, 0, 0, n - v.shape[1]) if v.ndim == 3 else (0, n - v.shape[1]))
            for k, v in batch.items()}


def train_reference_check(model, cfg, batch, backends=("kernels", "reference")) -> dict:
    """Hold each layer's output and gradients on the kernel path to the
    ``reference`` backend's, given the same layer input and the same
    upstream gradient (an Erwin layer at its own level).  ``backends``
    names the path under test and the one it is held to (the sharded
    phase holds ``"sharded"`` to ``"kernels"``).

    The kernel path runs forward with a cut between layers, the loss's
    gradient is carried down layer by layer through the kernel path's own
    backward, and at every layer the reference backend differentiates the
    same layer at the same input against the same upstream gradient.  The
    selections agree: both backends score blocks with the same plain code.

    Each gradient tensor of each layer (its input's and every parameter's)
    is held by max|kernel − reference| / max|reference| ≤ ``GRAD_REL_TOL``:
    the loss is a mean over ~29k outputs, so the gradients are far below 1
    and an absolute limit would let a wrong one through.  A gradient that
    is 0 in exact arithmetic (``ZERO_GRADS``) is held against the layer's
    largest parameter gradient instead: φ = "mlp"'s φ_k.fc2.b adds the same
    vector to every pooled key, and softmax ignores a shift shared by every
    key, so both backends return rounding noise for it.  Each layer's
    output is held on every real point within ``LAYER_TOL``·(1 + |ref|)."""
    mask, offsets = batch["mask"], batch.get("offsets")
    eps = cfg.norm_eps
    levels = erwin_levels(cfg)
    xs, ys = [], []
    h = dense(model.embed, batch["feats"]).detach()
    with use_backend(backends[0]):
        for lp, level in zip(model.layers, levels):
            x = h.detach().requires_grad_(True)
            h = pc_layer(lp, x, mcfg=cfg, mask=mask, offsets=offsets, erwin_level=level)
            xs.append(x)
            ys.append(h)
    top = h.detach().requires_grad_(True)
    pred = dense(model.head, rmsnorm(model.final_norm, top, eps)).float()
    err = torch.where(mask[..., None], (pred - batch["target"]) ** 2, 0.0)
    gy, = torch.autograd.grad(err.sum() / (mask.sum() * cfg.out_dim), top)
    rows, elements, fwd_worst, fwd_beyond = [], 0, 0.0, 0
    for i in reversed(range(len(model.layers))):
        lp = model.layers[i]
        names = [n for n, p in lp.named_parameters() if p.requires_grad]
        wrt = [xs[i]] + [p for _, p in lp.named_parameters() if p.requires_grad]
        gk = torch.autograd.grad(ys[i], wrt, gy, allow_unused=True)
        with use_backend(backends[1]):
            yr = pc_layer(lp, xs[i], mcfg=cfg, mask=mask, offsets=offsets,
                          erwin_level=levels[i])
        gr = torch.autograd.grad(yr, wrt, gy, allow_unused=True)
        d = (ys[i] - yr).detach().abs()[mask]
        fwd_worst = max(fwd_worst, float(d.max()))
        fwd_beyond += int((d > LAYER_TOL * (1 + yr.detach().abs()[mask])).any(-1).sum())
        pairs = []
        for name, a, b in zip(["input"] + names, gk, gr):
            check((a is None) == (b is None), f"layer {i} {name}: gradient on one side only")
            if a is None:
                continue
            check(bool(torch.isfinite(a).all()), f"layer {i} {name}: non-finite gradient")
            pairs.append((name, float((a - b).abs().max()), float(b.abs().max())))
            elements += a.numel()
        largest = max(ref for name, _, ref in pairs if name != "input")
        for name, diff, ref in pairs:
            den = largest if name in ZERO_GRADS else ref
            rows.append({"layer": i, "name": name, "max_abs_diff": diff,
                         "ref_max_abs": ref, "of_largest": name in ZERO_GRADS,
                         "rel": diff / den if den > 0 else (0.0 if diff == 0 else math.inf)})
        gy = gk[0]
    worst = max(rows, key=lambda r: r["rel"])
    smallest = min(rows, key=lambda r: r["ref_max_abs"])
    stats = {"arch": cfg.name, "layout": "padded" if offsets is None else "packed",
             "erwin_levels": levels if cfg.attention == "erwin" else None,
             "forward_tol": LAYER_TOL, "forward_max_abs_diff": fwd_worst,
             "forward_points_beyond_tol": fwd_beyond,
             "rel_tol": GRAD_REL_TOL, "worst": worst, "smallest_ref": smallest,
             "zero_grads": [r for r in rows if r["of_largest"]][:4],
             "max_abs_diff": max(r["max_abs_diff"] for r in rows),
             "input_grad_ref_max_abs": [r["ref_max_abs"] for r in reversed(rows)
                                        if r["name"] == "input"],
             "tensors_compared": len(rows), "grad_elements_compared": elements,
             "layers": len(model.layers), "backends": list(backends)}
    print(json.dumps({"train_reference_check": stats}), flush=True)
    what = f"{backends[0]}-path {{}} vs the {backends[1]} backend"
    check(fwd_beyond == 0, f"{cfg.name}: {what.format('layer outputs')}: "
                           f"{fwd_beyond} points beyond {LAYER_TOL} (max {fwd_worst})")
    beyond = [f"layer {r['layer']} {r['name']} ({r['rel']:.2e})" for r in rows
              if not r["rel"] <= GRAD_REL_TOL]
    check(not beyond, f"{what.format('gradients')} beyond "
                      f"{GRAD_REL_TOL} of their largest value: {', '.join(beyond[:8])}")
    return stats


def profile_train_step(step, model, opt_state, batch, layout: str,
                       arch: str = "shapenet-bsa") -> None:
    """Where one train step spends device time (torch.profiler): kernel time
    on the card, each ported kernel's share, the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(model, opt_state, batch)
        torch.cuda.synchronize()
    print(json.dumps({"train_profile": {"arch": arch, "layout": layout,
                                        **device_summary(prof)}}), flush=True)


# device kernels by kind, first match wins (device_summary's
# ``by_category_ms``): the ported kernels, GEMMs, sorts (the MoE dispatch's
# and top-k's), index / gather / scatter kernels (the MoE dispatch and
# combine, embeddings), copies and casts, other elementwise kernels (the
# SSD's exponentials and products among them), reductions
DEVICE_CATEGORIES = (("ported", "|".join(KERNELS)),
                     ("gemm", r"gemm|xmma|gemv"),
                     ("sort", r"sort|radix|topk"),
                     ("index_gather_scatter", r"index|gather|scatter"),
                     ("copy_cast", r"copy|cast"),
                     ("elementwise", r"elementwise"),
                     ("reduce", r"reduce|softmax|norm"))


def device_summary(prof) -> dict:
    """Device time by kernel: only events that ran on the card (CPU-side ops,
    autograd nodes included, carry their kernels' time too and are left
    out); ``by_category_ms`` sums it by ``DEVICE_CATEGORIES``."""
    from torch.autograd import DeviceType
    kernels = [(e.key, e.device_time_total / 1e3, e.count) for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.device_time_total > 0]
    ported = {}
    for name, ms, _ in kernels:
        hit = re.search(r"(" + "|".join(KERNELS)
                        + r")_(?:(?:kernel|mma|fma|rows|lanes|reduce|groups|warp|vec)<|ranks\()",
                        name)
        if hit:
            ported[hit.group(1)] = ported.get(hit.group(1), 0.0) + ms
    top = sorted(kernels, key=lambda r: -r[1])[:12]
    by_category = {}
    for name, ms, _ in kernels:
        cat = next((c for c, pattern in DEVICE_CATEGORIES
                    if re.search(pattern, name, re.IGNORECASE)), "other")
        by_category[cat] = by_category.get(cat, 0.0) + ms
    return {"device_kernel_ms": sum(ms for _, ms, _ in kernels), "ported_kernels_ms": ported,
            "by_category_ms": by_category,
            "topk_ms": sum(ms for n, ms, _ in kernels if "topk" in n.lower()),
            "top_device_kernels": [{"name": n[:90], "ms": t, "calls": c} for n, t, c in top]}


def profile_batch(eng, clouds) -> None:
    """Where one served batch spends device time (torch.profiler): the sum
    of kernel time on the card, each ported kernel's share, and the top
    kernels by device time.  The profiled batch's wall time is not a
    latency (the profiler's own start-up is in it)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        eng.predict(clouds)
        torch.cuda.synchronize()
    print(json.dumps({"profile": {"layout": eng.layout, **device_summary(prof)}}),
          flush=True)


def reference_check(eng, model, cfg, clouds, served, free_ref,
                    backends=("kernels", "reference")) -> dict:
    """Hold the kernel path to the ``reference`` backend on one served batch
    (``backends``: the path under test and the one it is held to).

    The check is per layer: along the kernel path's own trajectory, every
    layer's kernel-path output must match the reference backend's output
    for the same layer input within 1e-3 on every real point.  Top-k
    selection is discontinuous in its scores, so two free-running paths
    whose logits differ by ~1e-7 may pick different blocks for a group
    whose k-th and (k+1)-th scores nearly tie, and the difference then
    grows through the later layers; the free-running comparison (kernel
    engine vs reference engine, end to end) is therefore reported, with
    the layer where the two trajectories first part, not required."""
    batch, _, _ = eng.pack_batch([(c["points"], c["feats"]) for c in clouds])
    mask, offsets = batch["mask"], batch.get("offsets")
    step_worst, step_beyond, parted = 0.0, 0, []
    with torch.no_grad():
        xk = xr = dense(model.embed, batch["feats"])
        for i, lp in enumerate(model.layers):
            with use_backend(backends[0]):
                yk = pc_layer(lp, xk, mcfg=cfg, mask=mask, offsets=offsets)
            with use_backend(backends[1]):
                want = pc_layer(lp, xk, mcfg=cfg, mask=mask, offsets=offsets)  # same input
                yr = pc_layer(lp, xr, mcfg=cfg, mask=mask, offsets=offsets)    # free-running
            d = (yk - want).abs()[mask]
            step_worst = max(step_worst, float(d.max()))
            step_beyond += int((d > 1e-3 * (1 + want.abs()[mask])).any(-1).sum())
            far = (yk - yr).abs()[mask] > 1e-3 * (1 + yr.abs()[mask])
            parted.append(int(far.any(-1).sum()))
            xk, xr = yk, yr
    end_diff = [abs(g - w) for g, w in zip(served, free_ref)]
    stats = {"layout": eng.layout, "per_layer_max_abs_diff": step_worst,
             "per_layer_points_beyond_1e-3": step_beyond, "layers": len(model.layers),
             "points_compared": int(mask.sum()),
             "free_running_points_apart_per_layer": parted,
             "free_running_output_max_abs_diff": float(max(d.max() for d in end_diff)),
             "free_running_output_points_beyond_1e-3": int(sum(
                 (d > 1e-3 * (1 + abs(w))).sum() for d, w in zip(end_diff, free_ref))),
             "backends": list(backends)}
    print(json.dumps({"reference_check": stats}), flush=True)
    check(step_beyond == 0, f"{backends[0]} path vs {backends[1]} backend: {step_beyond} "
                            f"points beyond 1e-3 in some layer (max {step_worst})")
    return stats


# ---------------------------------------------------------------------------
# the causal LM: tinyllama-1.1b
# ---------------------------------------------------------------------------

def local_visible_pairs(key_bias, blk_seg, w: int) -> int:
    """(query position, key) pairs the local kernel attends, per query head:
    each row of block i sees the valid keys of block i−1 (when it exists and
    lies in the same segment) and the valid keys of its own block up to
    itself."""
    Bk, n = key_bias.shape
    valid = (key_bias > NEG_INF / 2).reshape(Bk, n // w, w)
    prev = torch.cat([torch.zeros_like(valid[:, :1, 0], dtype=torch.long),
                      valid[:, :-1].sum(-1)], dim=1)                   # (B, nb)
    if blk_seg is not None:
        same = torch.cat([torch.zeros_like(blk_seg[:, :1], dtype=torch.bool),
                          blk_seg[:, 1:] == blk_seg[:, :-1]], dim=1)
        prev = torch.where(same, prev, 0)
    return int((prev[..., None] + valid.long().cumsum(-1)).sum())


def local_dense_mask(key_bias, blk_seg, w: int) -> torch.Tensor:
    """(B, 1, N, N) bool of the same rule, per sample (SDPA's yardstick)."""
    Bk, n = key_bias.shape
    t = torch.arange(n, device=key_bias.device)
    bt, bj = t[:, None] // w, t[None, :] // w
    seg = (torch.zeros((Bk, n), dtype=torch.int32, device=key_bias.device)
           if blk_seg is None else blk_seg[:, t // w])
    ok = ((bt == bj) & (t[None, :] <= t[:, None]))[None] | \
        ((bj == bt - 1)[None] & (seg[:, None, :] == seg[:, :, None]))
    return (ok & (key_bias > NEG_INF / 2)[:, None, :])[:, None]


def lm_window_case(dev, n: int = 4096) -> tuple[torch.Tensor, torch.Tensor]:
    """The local kernels' test sequence: B = 1, a padded tail, a hole and a
    packed-sample boundary at block 6.  Returns (key_bias, blk_seg)."""
    mask = torch.ones(1, n, dtype=torch.bool, device=dev)
    mask[0, 1000:1100] = False
    mask[0, n - 300:] = False
    key_bias = torch.where(mask, 0.0, NEG_INF).float()
    blk_seg = (torch.arange(n // LM_W, device=dev) >= 6).int()[None].contiguous()
    return key_bias, blk_seg


def decode_rows(dev, seed: int = 0) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """One paged decode step's gather indices at the serving shape, from
    ``nsa_causal.paged_step``: 8 slots of 1,100–1,600 tokens over a shuffled
    block table of the pool of 65 blocks of 256 rows.  Returns (win_rows
    (8, 512) int32, the local window's; crow (8,) int64, the compressed
    rows the new tokens complete; cmp_rows (8, 32) int32, every block's
    compressed row; the pool's rows R)."""
    n_pages = MAX_LEN // PAGE
    rng = np.random.default_rng(seed)
    table = torch.from_numpy(rng.permutation(SLOTS * n_pages).reshape(SLOTS, n_pages)).to(dev)
    lengths = torch.from_numpy(rng.integers(1100, 1601, SLOTS)).to(dev)
    st = nsa_causal.paged_step(table, lengths, cfg=get_config(LM).bsa, page=PAGE)
    return st.win_rows, st.crow, st.cmp_rows, (SLOTS * n_pages + 1) * PAGE


def paged_rows(record, mode: str, pool, rows, dtype) -> None:
    """``paged_gather`` on ``rows`` against its plain version (exact), with
    ``ms`` a CUDA-event time around one call (host work included),
    ``device_ms`` the kernel's own duration (profiler), and
    ``index_select`` on the same rows beside both; the calls must launch no
    kernel but their own (no cast, no copy)."""
    got = paged.paged_gather(pool, rows)
    want = paged.paged_gather_plain(pool, rows)
    torch.cuda.synchronize()
    err, ok = max_err((got,), (want,))
    n = rows.numel()
    b_ms, b_by = bound(2 * n * pool[0].numel() * pool.element_size() + n * rows.element_size(),
                       0.0, dtype)
    k_dev, names = device_ms(lambda: paged.paged_gather(pool, rows), "paged_gather")
    check(bool(names) and all("paged_gather" in k for k in names),
          f"paged_gather [{mode}]: a call launched other kernels than its own: {names}")
    flat = rows.reshape(-1)
    lib_dev, _ = device_ms(lambda: torch.index_select(pool, 0, flat))
    record("paged_gather", mode, dtype, err, ok,
           median_ms(lambda: paged.paged_gather(pool, rows), reps=50),
           median_ms(lambda: paged.paged_gather_plain(pool, rows), reps=5),
           b_ms, b_by, median_ms(lambda: torch.index_select(pool, 0, flat), reps=50),
           device_ms=k_dev, library_device_ms=lib_dev, index=str(rows.dtype), rows=n)


def paged_pair_rows(record, mode: str, k_pool, v_pool, rows, dtype) -> None:
    """``paged_gather_pair`` on ``rows`` against the plain pair (exact),
    with ``ms`` a CUDA-event time around one call (host work included),
    ``device_ms`` the kernel's own duration (profiler; the call must launch
    one kernel, its own), and ``index_select`` on the same rows beside it:
    ``index_select_ms`` one call (one pool), ``index_select_pair_ms`` the
    two calls that gather both pools.  No one PyTorch call gathers both
    pools, so ``library_ms`` is None."""
    call = lambda: paged.paged_gather_pair(k_pool, v_pool, rows)  # noqa: E731
    got = call()
    want = paged.paged_gather_pair_plain(k_pool, v_pool, rows)
    torch.cuda.synchronize()
    err, ok = max_err(got, want)
    ok = ok and all(torch.equal(g, w) for g, w in zip(got, want))
    n = rows.numel()
    b_ms, b_by = bound(4 * n * k_pool[0].numel() * k_pool.element_size()
                       + n * rows.element_size(), 0.0, dtype)
    k_dev, names = device_ms(call, "paged_gather")
    check(bool(names) and all("paged_gather" in k for k in names),
          f"paged_gather_pair [{mode}]: a call launched other kernels than its own: {names}")
    flat = rows.reshape(-1)
    one = lambda: torch.index_select(k_pool, 0, flat)  # noqa: E731
    two = lambda: (torch.index_select(k_pool, 0, flat),  # noqa: E731
                   torch.index_select(v_pool, 0, flat))
    record("paged_gather_pair", mode, dtype, err, ok, median_ms(call, reps=50),
           median_ms(lambda: paged.paged_gather_pair_plain(k_pool, v_pool, rows), reps=5),
           b_ms, b_by, None, device_ms=k_dev, index=str(rows.dtype), rows=n,
           index_select_ms=median_ms(one, reps=50), index_select_pair_ms=median_ms(two, reps=50),
           index_select_device_ms=device_ms(one)[0])


def lm_kernel_phase(dev) -> list[dict]:
    """The two LM kernels against their plain versions, and the three
    forward kernels the LM shares with shapenet at the LM's shapes."""
    results = []
    record = recorder(results)
    rep = LM_HQ // LM_HKV
    # local_fwd: one 4096-token sequence, a padded tail, a hole, a sample boundary
    n = 4096
    key_bias, blk_seg = lm_window_case(dev, n)
    pairs = LM_HQ * local_visible_pairs(key_bias, blk_seg, LM_W)
    dense_ok = local_dense_mask(key_bias, blk_seg, LM_W)
    # flash (block-causal), selection, epilogue: one prefill sequence
    N1 = PREFILL_N
    NB1 = N1 // LM_ELL
    vis = flash.visible_keys(N1, NB1, causal=False, block_causal=True, ell=LM_ELL,
                             device=dev)
    g = torch.Generator(device=dev).manual_seed(90)
    grp = torch.arange(NB1, device=dev)
    past = grp[None, :] < grp[:, None]                       # block j ends before group g
    score = torch.where(past[None, None], torch.rand((1, LM_HKV, NB1, NB1), generator=g,
                                                     device=dev), -1.0)
    score[..., 0] += torch.where(grp > 0, 2.0, 0.0)           # force_first_block
    val, idx = torch.topk(score, LM_KSTAR, dim=-1)
    idx = torch.where(val > -0.5, idx, -1).int().contiguous()  # (1, Hkv, G, k*)
    M = LM_G * rep
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        # ---- local_fwd
        check(local.local_plan(LM_W, LM_D, dtype).path ==
              ("tiles" if dtype == torch.bfloat16 else "lanes"),
              f"local_fwd [{dtype}]: not on the path local_plan names")
        q = rand((LM_HKV, rep, n, LM_D), dtype, dev, 91)
        k = rand((LM_HKV, n, LM_D), dtype, dev, 92)
        v = rand((LM_HKV, n, LM_D), dtype, dev, 93)
        kw = dict(window=LM_W, n_heads=LM_HKV)
        got = local.local_window_fwd(q, k, v, key_bias, blk_seg, **kw)
        want = local.local_window_fwd_plain(q, k, v, key_bias, blk_seg, **kw)
        torch.cuda.synchronize()
        err, ok = max_err(got, want)
        nbytes = (2 * q.numel() + 2 * k.numel()) * es + 4 * n + 4 * 2 * (n // LM_W) \
            + 4 * q.numel() // LM_D
        b_ms, b_by = bound(nbytes, 4.0 * LM_D * pairs, dtype)
        qs = q.reshape(1, LM_HQ, n, LM_D)
        ks, vs = (t.repeat_interleave(rep, 0)[None] for t in (k, v))
        record("local_fwd", "lm_window", dtype, err, ok,
               median_ms(lambda: local.local_window_fwd(q, k, v, key_bias, blk_seg, **kw)),
               median_ms(lambda: local.local_window_fwd_plain(q, k, v, key_bias, blk_seg,
                                                              **kw), reps=5),
               b_ms, b_by,
               median_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                                attn_mask=dense_ok)),
               device_ms=device_ms(lambda: local.local_window_fwd(q, k, v, key_bias, blk_seg,
                                                                  **kw), "local_fwd")[0],
               path=local.local_plan(LM_W, LM_D, dtype).path)
        del q, k, v, qs, ks, vs, got, want

        # ---- paged_gather: one decode step's window gather of 8 slots (int32
        # rows, as the decode passes them), the same rows as int64, and the
        # compressed rows (int64, as the decode passes them)
        win_rows, crow, cmp_rows, R = decode_rows(dev)
        pool = rand((R, LM_HKV, LM_D), dtype, dev, 94)
        paged_rows(record, "decode_window", pool, win_rows, dtype)
        paged_rows(record, "decode_window_i64", pool, win_rows.long(), dtype)
        paged_rows(record, "decode_crow_i64", pool, crow, dtype)
        # ---- paged_gather_pair: the same row sets from a K and a V pool, as
        # the decode gathers them, and every block's compressed rows (int32)
        v_pool = rand((R, LM_HKV, LM_D), dtype, dev, 93)
        paged_pair_rows(record, "pair_window", pool, v_pool, win_rows, dtype)
        paged_pair_rows(record, "pair_window_i64", pool, v_pool, win_rows.long(), dtype)
        paged_pair_rows(record, "pair_crow_i64", pool, v_pool, crow, dtype)
        paged_pair_rows(record, "pair_cmp_rows", pool, v_pool, cmp_rows, dtype)
        del pool, v_pool

        # ---- flash_fwd, block-causal: 32,768 queries against 512 pooled keys
        q = rand((LM_HKV, rep, N1, LM_D), dtype, dev, 95)
        k = rand((LM_HKV, NB1, LM_D), dtype, dev, 96)
        v = rand((LM_HKV, NB1, LM_D), dtype, dev, 97)
        zb = torch.zeros((1, NB1), dtype=torch.float32, device=dev)
        kw = dict(n_heads=LM_HKV, block_causal=True, ell=LM_ELL)
        got = flash.flash_attention_fwd(q, k, v, zb, None, **kw)
        want = flash.flash_attention_fwd_plain(q, k, v, zb, None, **kw)
        torch.cuda.synchronize()
        err, ok = max_err(got, want)
        del got, want
        nbytes = (2 * q.numel() + 2 * k.numel()) * es + 4 * NB1 + 4 * q.numel() // LM_D
        b_ms, b_by = bound(nbytes, 4.0 * LM_D * LM_HQ * float(vis.sum()), dtype)
        qs = q.reshape(1, LM_HQ, N1, LM_D)
        ks, vs = (t.repeat_interleave(rep, 0)[None] for t in (k, v))
        record("flash_fwd", "lm_block_causal", dtype, err, ok,
               median_ms(lambda: flash.flash_attention_fwd(q, k, v, zb, None, **kw)),
               median_ms(lambda: flash.flash_attention_fwd_plain(q, k, v, zb, None, **kw),
                         warmup=1, reps=3),
               b_ms, b_by,
               median_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=vis)))
        del q, k, v, qs, ks, vs

        # ---- selection_fwd: 512 groups of g·rep = 512 rows, 16 blocks of 64 keys
        qg = rand((1, LM_HKV, NB1, M, LM_D), dtype, dev, 98)
        kb = rand((1, LM_HKV, NB1, LM_ELL, LM_D), dtype, dev, 99)
        vb = rand((1, LM_HKV, NB1, LM_ELL, LM_D), dtype, dev, 100)
        tok_bias = torch.zeros((1, NB1, LM_ELL), dtype=torch.float32, device=dev)
        got = selection.selection_attention_fwd(qg, kb, vb, idx, tok_bias)
        want = selection.selection_attention_fwd_plain(qg, kb, vb, idx, tok_bias)
        torch.cuda.synchronize()
        err, ok = max_err(got, want)
        del got, want
        valid_sel = int((idx >= 0).sum())
        used = torch.zeros(1, LM_HKV, NB1, dtype=torch.bool, device=dev)
        used.scatter_(2, idx.clamp(min=0).reshape(1, LM_HKV, -1).long(),
                      (idx >= 0).reshape(1, LM_HKV, -1))
        nbytes = (2 * qg.numel() + 2 * int(used.sum()) * LM_ELL * LM_D) * es \
            + 4 * idx.numel() + 4 * tok_bias.numel() + 4 * qg.numel() // LM_D
        b_ms, b_by = bound(nbytes, 4.0 * M * LM_ELL * LM_D * valid_sel, dtype)
        # no library time here: SDPA's dense mask would be 4 × 262,144 ×
        # 32,768 bools (34 GB); the LM train shape times it instead
        record("selection_fwd", "lm_groups", dtype, err, ok,
               median_ms(lambda: selection.selection_attention_fwd(qg, kb, vb, idx,
                                                                   tok_bias)),
               median_ms(lambda: selection.selection_attention_fwd_plain(
                   qg, kb, vb, idx, tok_bias), warmup=1, reps=3),
               b_ms, b_by, None)
        del qg, kb, vb

        # ---- epilogue_fwd: R = N·Hq rows of 64 (the prefill passes no mask)
        epilogue_fwd_rows(record, "lm_rows", dtype, dev, (1, N1, LM_HQ, LM_D), None, 101)
        torch.cuda.empty_cache()
    return results


def head_rows_phase(dev, tag: str, dtypes) -> list[dict]:
    """The causal LM path's kernels at one model's heads (``HEAD_ROWS[tag]``)
    against their plain versions, in ``dtypes``, with ``LM_BSA`` on B = 1 ×
    4096 tokens; each row's mode starts with ``tag``.  ``local_fwd`` /
    ``local_dq`` / ``local_dkv`` on ``lm_window_case`` (a padded tail, a
    hole, a sample boundary), ``flash_fwd`` / ``flash_dq`` / ``flash_dkv``
    block-causal against the 64 pooled keys, ``selection_fwd`` /
    ``selection_bwd`` on 64 groups of g·rep rows (phi4-mini's heads: 192;
    granite's: 3,072) picking 16 of the past blocks of 64 keys, the two
    epilogues on 4096 · Hq rows and ``paged_gather`` on one decode step's
    window (8 slots of 512 rows of Hkv × D); SDPA with the same dense mask
    beside the local and flash kernels, forward and backward."""
    results = []
    record = recorder(results)
    _, Hq, Hkv, Dh = HEAD_ROWS[tag]
    n = HEAD_ROWS_N
    rep = Hq // Hkv
    key_bias, blk_seg = lm_window_case(dev, n)
    pairs = Hq * local_visible_pairs(key_bias, blk_seg, LM_W)
    dense_ok = local_dense_mask(key_bias, blk_seg, LM_W)
    nb = n // LM_ELL
    vis = flash.visible_keys(n, nb, causal=False, block_causal=True, ell=LM_ELL, device=dev)
    f_pairs = Hq * float(vis.sum())
    G, M = n // LM_G, LM_G * rep
    g = torch.Generator(device=dev).manual_seed(140)
    grp = torch.arange(G, device=dev)
    blk = torch.arange(nb, device=dev)
    past = blk[None, :] * LM_ELL + LM_ELL - 1 < grp[:, None] * LM_G   # block ends before group
    score = torch.where(past[None, None], torch.rand((1, Hkv, G, nb), generator=g, device=dev),
                        -1.0)
    score[..., 0] += torch.where(grp > 0, 2.0, 0.0)            # force_first_block
    val, idx = torch.topk(score, LM_KSTAR, dim=-1)
    idx = torch.where(val > -0.5, idx, -1).int().contiguous()  # (1, Hkv, G, k*)
    lkw = dict(window=LM_W, n_heads=Hkv)
    fkw = dict(n_heads=Hkv, block_causal=True, ell=LM_ELL)
    for dtype in dtypes:
        es = torch.tensor([], dtype=dtype).element_size()
        # ---- local_fwd, local_dq, local_dkv
        q = rand((Hkv, rep, n, Dh), dtype, dev, 141)
        k = rand((Hkv, n, Dh), dtype, dev, 142)
        v = rand((Hkv, n, Dh), dtype, dev, 143)
        got = local.local_window_fwd(q, k, v, key_bias, blk_seg, **lkw)
        want = local.local_window_fwd_plain(q, k, v, key_bias, blk_seg, **lkw)
        torch.cuda.synchronize()
        err, ok = max_err(got, want)
        side = 4 * n + 4 * 2 * (n // LM_W) + 4 * q.numel() // Dh
        b_ms, b_by = bound((2 * q.numel() + 2 * k.numel()) * es + side, 4.0 * Dh * pairs, dtype)
        # SDPA with the same dense mask: the library yardstick of the local
        # forward and (forward + backward − forward) of its backward
        qs = q.reshape(1, Hq, n, Dh).clone().requires_grad_(True)
        ks, vs = (t.repeat_interleave(rep, 0)[None].clone().requires_grad_(True) for t in (k, v))
        with torch.no_grad():
            lib_fwd = median_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                                       attn_mask=dense_ok))
        lib_bwd = library_bwd_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                                        attn_mask=dense_ok),
                                 (qs, ks, vs))
        del qs, ks, vs
        record("local_fwd", f"{tag}_lm_window", dtype, err, ok,
               median_ms(lambda: local.local_window_fwd(q, k, v, key_bias, blk_seg, **lkw)),
               median_ms(lambda: local.local_window_fwd_plain(q, k, v, key_bias, blk_seg, **lkw),
                         warmup=1, reps=3), b_ms, b_by, lib_fwd,
               device_ms=device_ms(lambda: local.local_window_fwd(q, k, v, key_bias, blk_seg,
                                                                  **lkw), "local_fwd")[0],
               path=local.local_plan(LM_W, Dh, dtype).path)
        o, lse = got
        do = rand(o.shape, dtype, dev, 144)
        args = (q, k, v, key_bias, blk_seg, do, lse, row_delta(do, o))
        live = local.live_map(key_bias, blk_seg, LM_W)
        dq = local.local_window_dq(*args, live=live, **lkw)
        dkv = local.local_window_dkv(*args, live=live, **lkw)
        want = local.local_window_bwd_plain(*args, **lkw)
        torch.cuda.synchronize()
        p_ms = median_ms(lambda: local.local_window_bwd_plain(*args, **lkw), warmup=1, reps=3)
        side += 4 * q.numel() // Dh
        err, ok = rel_err((dq,), want[:1])
        b_ms, b_by = bound((3 * q.numel() + 2 * k.numel()) * es + side, 6.0 * Dh * pairs, dtype)
        record("local_dq", f"{tag}_lm_window", dtype, err, ok,
               median_ms(lambda: local.local_window_dq(*args, live=live, **lkw)), p_ms, b_ms,
               b_by, lib_bwd)
        err, ok = rel_err(dkv, want[1:])
        b_ms, b_by = bound((2 * q.numel() + 4 * k.numel()) * es + side, 8.0 * Dh * pairs, dtype)
        record("local_dkv", f"{tag}_lm_window", dtype, err, ok,
               median_ms(lambda: local.local_window_dkv(*args, live=live, **lkw)), p_ms, b_ms,
               b_by, lib_bwd)
        del k, v, o, lse, do, args, live, dq, dkv, want, got

        # ---- flash_fwd, flash_dq, flash_dkv: block-causal against 64 pooled keys
        kf = rand((Hkv, nb, Dh), dtype, dev, 145)
        vf = rand((Hkv, nb, Dh), dtype, dev, 146)
        zb = torch.zeros((1, nb), dtype=torch.float32, device=dev)
        got = flash.flash_attention_fwd(q, kf, vf, zb, None, **fkw)
        want = flash.flash_attention_fwd_plain(q, kf, vf, zb, None, **fkw)
        torch.cuda.synchronize()
        err, ok = max_err(got, want)
        side = 4 * nb + 4 * q.numel() // Dh
        b_ms, b_by = bound((2 * q.numel() + 2 * kf.numel()) * es + side, 4.0 * Dh * f_pairs,
                           dtype)
        qs = q.reshape(1, Hq, n, Dh).clone().requires_grad_(True)
        ks, vs = (t.repeat_interleave(rep, 0)[None].clone().requires_grad_(True)
                  for t in (kf, vf))
        with torch.no_grad():
            lib_fwd = median_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                                       attn_mask=vis))
        lib_bwd = library_bwd_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs,
                                                                        attn_mask=vis),
                                 (qs, ks, vs))
        del qs, ks, vs
        record("flash_fwd", f"{tag}_block_causal", dtype, err, ok,
               median_ms(lambda: flash.flash_attention_fwd(q, kf, vf, zb, None, **fkw)),
               median_ms(lambda: flash.flash_attention_fwd_plain(q, kf, vf, zb, None, **fkw),
                         warmup=1, reps=3), b_ms, b_by, lib_fwd)
        o, lse = got
        do = rand(o.shape, dtype, dev, 147)
        args = (q, kf, vf, zb, do, lse, row_delta(do, o))
        dq = flash.flash_attention_dq(*args, **fkw)
        dkv = flash.flash_attention_dkv(*args, **fkw)
        want = flash.flash_attention_bwd_plain(*args, **fkw)
        torch.cuda.synchronize()
        p_ms = median_ms(lambda: flash.flash_attention_bwd_plain(*args, **fkw), warmup=1, reps=3)
        side += 4 * q.numel() // Dh
        err, ok = rel_err((dq,), want[:1])
        b_ms, b_by = bound((3 * q.numel() + 2 * kf.numel()) * es + side, 6.0 * Dh * f_pairs,
                           dtype)
        record("flash_dq", f"{tag}_block_causal", dtype, err, ok,
               median_ms(lambda: flash.flash_attention_dq(*args, **fkw)), p_ms, b_ms, b_by,
               lib_bwd)
        err, ok = rel_err(dkv, want[1:])
        b_ms, b_by = bound((2 * q.numel() + 4 * kf.numel()) * es + side, 8.0 * Dh * f_pairs,
                           dtype)
        record("flash_dkv", f"{tag}_block_causal", dtype, err, ok,
               median_ms(lambda: flash.flash_attention_dkv(*args, **fkw)), p_ms, b_ms, b_by,
               lib_bwd)
        del q, kf, vf, o, lse, do, args, dq, dkv, want, got

        # ---- selection_fwd, selection_dq, selection_dkv
        qg = rand((1, Hkv, G, M, Dh), dtype, dev, 148)
        kb = rand((1, Hkv, nb, LM_ELL, Dh), dtype, dev, 149)
        vb = rand((1, Hkv, nb, LM_ELL, Dh), dtype, dev, 150)
        tok_bias = torch.zeros((1, nb, LM_ELL), dtype=torch.float32, device=dev)
        do = rand(qg.shape, dtype, dev, 151)
        selection_tiled_rows(record, f"{tag}_groups", qg, kb, vb, [idx], tok_bias, do)
        del qg, kb, vb, do

        # ---- epilogue_fwd, epilogue_bwd: R = N·Hq rows of 128 (the backward
        # kernel takes (R,) gates and mask)
        epilogue_fwd_rows(record, f"{tag}_rows", dtype, dev, (1, n, Hq, Dh), None, 152)
        R = n * Hq
        os_ = [rand((R, Dh), dtype, dev, 152 + i) for i in range(3)]
        gs = [torch.sigmoid(rand((R,), torch.float32, dev, 155 + i)) for i in range(3)]
        m = torch.ones(R, dtype=torch.float32, device=dev)
        epilogue_bwd_row(record, f"{tag}_rows", (*os_, *gs, m, rand((R, Dh), dtype, dev, 158)),
                         rel_err)
        del os_, gs

        # ---- paged_gather_pair: one decode step's window gather of 8 slots
        # from the K and the V pool, int32 and int64 rows
        win_rows, _, _, Rp = decode_rows(dev, seed=1)
        pools = [rand((Rp, Hkv, Dh), dtype, dev, 159 + i) for i in range(2)]
        paged_pair_rows(record, f"{tag}_pair_window", *pools, win_rows, dtype)
        paged_pair_rows(record, f"{tag}_pair_window_i64", *pools, win_rows.long(), dtype)
        del pools
        torch.cuda.empty_cache()
    return results


def ptxas_table(log: str) -> list[dict]:
    """Registers and spill bytes of each instantiation of the kernels in
    ``NO_SPILL`` in the nvcc -Xptxas=-v log: kernel, variant, head dim (for
    ``epilogue_bwd_vec``, lanes a row)."""
    out, cur = [], None
    names = "|".join(sorted({name for name, _, _ in NO_SPILL}))
    variants = "|".join(sorted({v for _, _, vs in NO_SPILL for v in vs}))
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"(%s)_(%s)I\w*?Li(\d+)E" % (names, variants), m.group(1))
            cur = None
            if k:
                cur = {"kernel": k.group(1), "variant": k.group(2), "head_dim": int(k.group(3))}
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur.update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    return out


def prefill_phase(dev, api, model, batch_size: int = PREFILL_B, seq_len: int = PREFILL_N,
                  path: str = "prefill") -> dict:
    """``make_prefill_step`` on ``batch_size`` × ``seq_len`` random tokens
    (tinyllama: B = 2 × N = 32,768): one warm-up call, one timed call (its
    launches checked against ``path``), the per-layer reference check and a
    profiled call."""
    cfg = api.mcfg
    hq, hkv, dh, w = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                      cfg.bsa.effective_local_window)
    attn = has_attention(cfg)
    check(not attn or local.local_plan(w, dh, getattr(torch, cfg.compute_dtype)).path
          == "tiles", f"prefill {cfg.name}: local_fwd is not on the tiled path "
                      "(local_fwd_mma)")
    batch = api.make_batch(np.random.default_rng(0), batch_size, seq_len, device=dev)
    step = make_prefill_step(api)
    t0 = time.perf_counter()
    step(model, batch)                                   # warm-up
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_counters()                                     # just before the main path
    t0 = time.perf_counter()
    logits = step(model, batch)
    torch.cuda.synchronize()
    latency = time.perf_counter() - t0
    launches = {name: c.n for name, c in COUNTERS.items()}  # just after it
    stats = {"arch": cfg.name, "batch": batch_size, "seq_len": seq_len,
             "layers": cfg.n_layers, "d_model": cfg.d_model, "heads": [hq, hkv, dh],
             "dtype": cfg.compute_dtype, "latency_s": latency, "warmup_s": warm_s,
             "tokens_per_second": batch_size * seq_len / latency,
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches": launches}
    print(json.dumps({"prefill": stats}), flush=True)
    check_launches(launches, path, cfg.n_layers if attn else 0)
    check(logits.shape == (batch_size, cfg.vocab_size) and bool(torch.isfinite(logits).all()),
          f"prefill {cfg.name} logits: shape {tuple(logits.shape)} or non-finite")
    if attn:
        stats["reference_check"] = prefill_reference_check(
            model, cfg, embed_input(api, model, batch))
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(model, batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summary = device_summary(prof)
    summary["profiled_wall_ms"] = wall * 1e3
    summary["device_busy_share"] = summary["device_kernel_ms"] / (wall * 1e3)
    if not attn:
        print(json.dumps({"prefill_profile": {"arch": cfg.name, **summary}}), flush=True)
        return stats
    # local_fwd at the prefill shape: its device time a launch beside its bound
    # (B × N positions, the config's heads, every token valid)
    kb = torch.zeros((batch_size, seq_len), device=dev)
    n_q, n_kv = batch_size * seq_len * hq * dh, batch_size * seq_len * hkv * dh
    b_ms, b_by = bound(2 * 2 * (n_q + n_kv) + 4 * batch_size * seq_len * (1 + hq),
                       4.0 * dh * hq * local_visible_pairs(kb, None, w), torch.bfloat16)
    summary["local_fwd"] = {"device_ms_per_launch":
                            summary["ported_kernels_ms"].get("local_fwd", 0.0) / cfg.n_layers,
                            "bound_ms": b_ms, "bound_by": b_by}
    print(json.dumps({"prefill_profile": {"arch": cfg.name, **summary}}), flush=True)
    return stats


class HeldRouting:
    """Holds the two sides of a layer check to one MoE routing: on the
    ``kernels`` backend each MoE call records the experts its router picks;
    on the ``reference`` backend the calls take those experts, in order,
    weighted by their own router's probabilities (``moe_apply(top_e=)``), and
    the tokens whose own pick differs are counted (a near-tie of the router
    flips under the bf16 rounding of the attention before it; a flipped
    token runs other experts, which no tolerance of the layer's output can
    hold).  Without MoE layers it only selects the backend."""

    def __init__(self, record: str = "kernels"):
        self.record = record                # the backend whose routing the other takes
        self.routes, self.flipped, self.tokens = [], 0, 0

    def _record(self, p, x, mcfg, top_e=None):
        y, aux = moe_apply(p, x, mcfg)
        self.routes.append(aux["top_e"])
        return y, aux

    def _replay(self, p, x, mcfg, top_e=None):
        held = self.routes.pop(0)
        own = torch.topk(torch.softmax(dense(p.router, x).float(), -1),
                         mcfg.experts_per_token, dim=-1).indices
        self.flipped += int((own.sort(-1).values != held.sort(-1).values).any(-1).sum())
        self.tokens += own.shape[0] * own.shape[1]
        return moe_apply(p, x, mcfg, top_e=held)

    @contextlib.contextmanager
    def __call__(self, backend: str):
        fn = self._record if backend == self.record else self._replay
        with use_backend(backend), mock.patch.object(transformer, "moe_apply", fn):
            yield


def embed_input(api, model, batch) -> torch.Tensor:
    """The first layer's input of the LM stack (the VLM's: the projected
    image tokens, then the text's embeddings)."""
    cfg = api.mcfg
    if cfg.family == "vlm":
        img = vlm._project(model.projector, batch["patch_embeds"], cfg.cdtype())
        return torch.cat([img, embed(model.lm.embed, batch["tokens"], dtype=cfg.cdtype())], 1)
    return embed(model.embed, batch["tokens"], dtype=cfg.cdtype())


def lm_stack(model):
    return (model.lm if hasattr(model, "lm") else model).layers


def prefill_reference_check(model, cfg, x0, backends=("kernels", "reference")) -> dict:
    """Every layer on the kernel path against the ``reference`` backend given
    the same layer input ``x0`` (B, N, d) along the kernel path's own
    trajectory (the reference runs one sequence at a time, to bound its
    memory; an MoE layer's routing held to the kernel path's:
    ``HeldRouting``).  ``backends``: the path under test and the one it is
    held to."""
    B_, N_, _ = x0.shape
    pos = torch.arange(N_, device=x0.device)[None].expand(B_, N_)
    rows, held = [], HeldRouting(record=backends[0])
    with torch.no_grad():
        x = x0
        for i, period in enumerate(lm_stack(model)):
            lp = period.pos0
            with held(backends[0]):
                yk = lm_layer(lp, x, mcfg=cfg, positions=pos)
            with held(backends[1]):
                yr = torch.cat([lm_layer(lp, x[b:b + 1], mcfg=cfg, positions=pos[b:b + 1])
                                for b in range(B_)])
            check(bool(torch.isfinite(yk).all()), f"layer {i}: non-finite output")
            diff = float((yk.float() - yr.float()).abs().max())
            ref = float(yr.float().abs().max())
            rows.append({"layer": i, "max_abs_diff": diff, "ref_max_abs": ref,
                         "rel": diff / ref})
            x = yk
            del yr
    stats = {"arch": cfg.name, "rel_tol": LM_LAYER_TOL, "layers": len(rows),
             "worst": max(rows, key=lambda r: r["rel"]),
             "rel_by_layer": [r["rel"] for r in rows], "backends": list(backends)}
    if held.tokens:
        stats["moe_routing"] = {"held_tokens": held.tokens,
                                "router_flips_on_reference": held.flipped}
    print(json.dumps({"prefill_reference_check": stats}), flush=True)
    beyond = [f"layer {r['layer']} ({r['rel']:.2e})" for r in rows
              if not r["rel"] <= LM_LAYER_TOL]
    check(not beyond, f"prefill {backends[0]} path vs {backends[1]} backend beyond "
                      f"{LM_LAYER_TOL}: {', '.join(beyond)}")
    return stats


def decode_oracle_phase(dev) -> dict:
    """Paged decode over a shuffled block table with three staggered slots,
    against the full-sequence forward on the kernel path, per position."""
    cfg = dataclasses.replace(get_config(LM).bsa, group_size=0, query_cmp_selection=False)
    lens, starts = [1600, 1350, 1100], [0, 150, 450]
    Bs, n_pad = 3, 1792                                  # 7 windows of 256
    n_pages = n_pad // PAGE
    num_blocks = Bs * n_pages
    g = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn((Bs, n_pad, LM_HQ, LM_D), generator=g, device=dev)
    k = torch.randn((Bs, n_pad, LM_HKV, LM_D), generator=g, device=dev)
    v = torch.randn((Bs, n_pad, LM_HKV, LM_D), generator=g, device=dev)
    params = nsa_causal.nsa_init(cfg, n_heads=LM_HQ, n_kv_heads=LM_HKV, head_dim=LM_D,
                                 d_model=LM_HQ * LM_D, generator=g, device=dev)
    with torch.no_grad():                                # gates apart, so each branch shows
        for i, b in enumerate(("ball", "cmp", "slc")):
            getattr(params.gates, b).copy_(torch.linspace(-1, 1, LM_HQ) * (i + 1))
    got = torch.zeros_like(q)
    with torch.no_grad(), use_backend("kernels"):
        ref = nsa_causal.nsa_causal_attention(params, q, k, v, cfg=cfg)
        cache = nsa_causal.init_paged_decode_cache(num_blocks, PAGE, LM_HKV, LM_D, cfg,
                                                   dtype=torch.float32, device=dev)
        blocks = np.random.default_rng(0).permutation(num_blocks)
        table = np.full((Bs, n_pages), num_blocks, np.int32)
        next_blk, steps = 0, 0
        sl = torch.arange(Bs, device=dev)
        reset_counters()
        t0 = time.perf_counter()
        for t in range(max(s + n for s, n in zip(starts, lens))):
            for s in range(Bs):
                p = t - starts[s]
                if 0 <= p < lens[s] and p % PAGE == 0:
                    table[s, p // PAGE] = blocks[next_blk]
                    next_blk += 1
            active = np.array([0 <= t - starts[s] < lens[s] for s in range(Bs)])
            pos = np.minimum([max(t - starts[s], 0) for s in range(Bs)], np.array(lens) - 1)
            lengths = torch.from_numpy(np.where(active, pos, 0)).to(dev)
            pt = torch.from_numpy(pos).to(dev)
            out, cache = nsa_causal.nsa_causal_decode_paged(
                params, q[sl, pt][:, None], k[sl, pt][:, None], v[sl, pt][:, None], cache,
                torch.from_numpy(table.copy()).to(dev), lengths, cfg=cfg, page=PAGE)
            act = torch.from_numpy(active).to(dev)
            got[sl[act], pt[act]] = out[act, 0]
            steps += 1
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = {name: c.n for name, c in COUNTERS.items()}
    check_launches(launches, "decode_oracle", DECODE_GATHERS * steps)
    valid = torch.zeros((Bs, n_pad), dtype=torch.bool, device=dev)
    for s in range(Bs):
        valid[s, :lens[s]] = True
    diff = (got - ref).abs()[valid]
    scale = float(ref[valid].abs().max())
    worst = float(diff.max())
    beyond = (diff > DECODE_TOL * scale).flatten(1).any(-1)
    stats = {"slots": Bs, "lens": lens, "starts": starts, "steps": steps,
             "positions": int(valid.sum()), "max_abs_diff": worst, "ref_max_abs": scale,
             "rel": worst / scale, "rel_tol": DECODE_TOL,
             "positions_beyond_tol": int(beyond.sum()), "seconds": seconds,
             "launches": launches}
    print(json.dumps({"decode_oracle": stats}), flush=True)
    check(stats["positions_beyond_tol"] == 0,
          f"paged decode vs forward: {stats['positions_beyond_tol']} positions beyond "
          f"{DECODE_TOL} of the largest value (max {worst / scale:.2e})")
    return stats


def serve_requests(vocab: int) -> list[np.ndarray]:
    """10 prompts of 1,100–1,600 random tokens (numpy seed 0); requests 0, 1
    and 8 open with the same 512 tokens; request 10 is exactly those 512
    tokens (two full pages): admitted after they are sealed, it reuses both
    and must copy-on-write the second before it recomputes its last
    position."""
    rng = np.random.default_rng(0)
    lens = rng.integers(1100, 1601, N_REQUESTS)
    prompts = [rng.integers(0, vocab, int(n), dtype=np.int32) for n in lens]
    for r in (1, 8):
        prompts[r][:SHARED] = prompts[0][:SHARED]
    prompts.append(prompts[0][:SHARED].copy())
    return prompts


def serve_lm_phase(dev, api, model) -> dict:
    """Paged continuous batching of the 11 requests (the last one forces a
    copy-on-write), then B = 1 lockstep generation of requests 0, 9 and 10
    (three processes side by side, after the serve) against the served
    tokens."""
    cfg = api.mcfg
    prompts = serve_requests(cfg.vocab_size)
    eng = ServingEngine(api, model, batch_slots=SLOTS, max_len=MAX_LEN, paged=True,
                        page=PAGE)
    windows = []
    wstep = eng._wstep

    def timed_window(*args):                             # CUDA events: no host sync
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = wstep(*args)
        end.record()
        windows.append((start, end, args[2].shape[0]))
        return out
    eng._wstep = timed_window
    torch.cuda.synchronize()
    reset_counters()                                     # just before the main path
    t0 = time.perf_counter()
    served = eng.serve(prompts, NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.n for name, c in COUNTERS.items()}  # just after it
    eng.kv.check()
    per_step = [s.elapsed_time(e) / w for s, e, w in windows]
    stats = {"arch": LM, "layers": cfg.n_layers, "slots": SLOTS, "max_len": MAX_LEN,
             "page": PAGE, "requests": len(prompts),
             "prompt_tokens": int(sum(len(p) for p in prompts)),
             "new_tokens": NEW_TOKENS, "serve_steps": eng.serve_steps,
             "windows": len(windows), "wall_s": wall,
             "tokens_per_second": eng.tokens_per_second,
             "tokens_generated": eng.tokens_generated,
             "tokens_processed_per_second":
                 (sum(len(p) for p in prompts) + eng.tokens_generated) / wall,
             "steps_per_second": eng.serve_steps / wall,
             "median_step_ms": statistics.median(per_step),
             "blocks_reused": eng.kv.blocks_reused, "cow_copies": eng.kv.cow_copies,
             "launches": launches}
    print(json.dumps({"serve_lm": stats}), flush=True)
    check_launches(launches, "serve_lm", DECODE_GATHERS * cfg.n_layers * eng.serve_steps)
    check(all(len(o) == NEW_TOKENS for o in served), "a request got the wrong token count")
    check(eng.kv.blocks_reused > 0, "the shared prompt prefix was not reused")
    check(eng.kv.cow_copies >= 1, "request 10 (the shared 512 tokens) made no "
                                  "copy-on-write")
    profile_decode(eng)
    stats["lockstep"] = lockstep_checks(cfg, dev, prompts, served, (0, 9, 10))
    return stats


def lockstep_worker(cfg, prompt, out_path, device, max_len, new_tokens):
    """One B = 1 lockstep generation, in a process of its own: the same
    weights (seed 0, drawn on ``device``), the tokens and the logits of the
    generated positions saved to ``out_path`` (.npz)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    api = model_api(cfg)
    model = api.init(seed=0, device=torch.device(device))
    eng = ServingEngine(api, model, batch_slots=1, max_len=max_len)
    logits = []
    step = eng._step

    def keep_logits(*args):
        nxt, lg, caches = step(*args)
        logits.append(lg[0])
        del logits[:-new_tokens]
        return nxt, lg, caches
    eng._step = keep_logits
    t0 = time.perf_counter()
    toks = eng.generate(prompt[None], new_tokens)[0]
    seconds = time.perf_counter() - t0
    np.savez(out_path, tokens=toks, logits=torch.stack(logits).float().cpu().numpy(),
             seconds=seconds, tokens_per_second=eng.tokens_per_second)


def lockstep_checks(cfg, dev, prompts, served, rids) -> list[dict]:
    """B = 1 lockstep generation of requests ``rids``, one process each (the
    decode is host-bound, so two processes take the time of one), held to
    the served tokens; where they part, the lockstep top-two logit gap says
    whether it is a near-tie."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    out_dir = ROOT / "build" / "lockstep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for rid in rids:
        path = out_dir / f"request_{rid}.npz"
        path.unlink(missing_ok=True)
        args = (cfg, prompts[rid], str(path), str(dev), MAX_LEN, NEW_TOKENS)
        procs[rid] = (ctx.Process(target=lockstep_worker, args=args), path)
        procs[rid][0].start()
    rows = []
    try:
        for rid, (proc, path) in procs.items():
            proc.join(timeout=900)
            check(proc.exitcode == 0 and path.exists(),
                  f"lockstep process for request {rid} failed (exit {proc.exitcode})")
            res = np.load(path)
            toks = res["tokens"]
            row = {"request": rid, "prompt_tokens": len(prompts[rid]),
                   "served": served[rid].tolist(), "lockstep": toks.tolist(),
                   "seconds": float(res["seconds"]),
                   "lockstep_tokens_per_second": float(res["tokens_per_second"])}
            apart = np.nonzero(toks != served[rid])[0]
            if len(apart):
                j = int(apart[0])
                lg = res["logits"][j]
                top2 = np.sort(lg)[-2:]
                gap, scale = float(top2[1] - top2[0]), float(np.abs(lg).max())
                row.update(parted_at=j, top2_gap=gap, max_abs_logit=scale,
                           near_tie=gap < NEAR_TIE * scale)
            print(json.dumps({"lockstep_check": row}), flush=True)
            check(not len(apart) or row["near_tie"],
                  f"request {rid}: served tokens part from lockstep at "
                  f"{row.get('parted_at')} with a top-two logit gap of {row.get('top2_gap')}")
            rows.append(row)
    finally:
        for proc, _ in procs.values():
            if proc.is_alive():
                proc.kill()
            proc.join()
    return rows


def profile_decode(eng) -> None:
    """Where three paged decode steps of the serving engine (8 slots, after
    the serve) spend their time: device kernel time against the wall time;
    then three unprofiled steps with the host time of every
    ``paged_gather_pair`` call (the wrapper's work and the launch) taken
    apart."""
    from torch.profiler import ProfilerActivity, profile
    tok = torch.zeros(SLOTS, dtype=torch.int64, device=eng.device)
    table = torch.from_numpy(eng.kv.table.copy()).to(eng.device)
    lengths = torch.from_numpy(eng.kv.lengths.astype(np.int64)).to(eng.device)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            eng._pstep(eng.model, eng.caches, tok, table, lengths)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summary = device_summary(prof)
    summary.update(steps=3, profiled_wall_ms=wall * 1e3,
                   device_busy_share=summary["device_kernel_ms"] / (wall * 1e3))
    host, real = [], paged.paged_gather_pair

    def timed_gather(k_pool, v_pool, rows):
        t0 = time.perf_counter()
        out = real(k_pool, v_pool, rows)
        host.append(time.perf_counter() - t0)
        return out
    with mock.patch.object(paged, "paged_gather_pair", timed_gather):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            eng._pstep(eng.model, eng.caches, tok, table, lengths)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summary.update(step_ms=wall * 1e3 / 3, gather_calls_per_step=len(host) / 3,
                   gather_host_ms_per_step=sum(host) * 1e3 / 3,
                   gather_host_share=sum(host) / wall)
    print(json.dumps({"decode_profile": summary}), flush=True)


def rel_err(got, want, tol_table=LM_BWD_TOL) -> tuple[float, bool]:
    """(max |got − want|, within the tolerance of each tensor's largest
    value?)"""
    errs, ok = [], True
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        if not torch.isfinite(g).all():
            return float("nan"), False
        d = float((g - w).abs().max())
        ok = ok and d <= tol_table[got[0].dtype] * float(w.abs().max())
        errs.append(d)
    return max(errs), ok


def lm_train_batches(dev, vocab: int, batch_size: int = TRAIN_LM_B,
                     seq_len: int = TRAIN_LM_N, steps: int = TRAIN_LM_STEPS) -> list[dict]:
    """1 + ``steps`` batches of ``lm_batches(seed=0)`` at ``train_4k``'s
    length (tinyllama: B = 2 × 4096 tokens), tokens and labels on the
    card."""
    return [{k: torch.from_numpy(b[k]).to(dev) for k in ("tokens", "labels")}
            for _, b in zip(range(steps + 1),
                            lm_batches(vocab_size=vocab, batch_size=batch_size,
                                       seq_len=seq_len, seed=0))]


def lm_selection_picks(api, model, batch) -> list[torch.Tensor]:
    """Each layer's selections (B, Hkv, G, k*) as the selection kernel gets
    them in the kernel path's forward of the LM on ``batch``."""
    apply, picks = selection.SelectionAttentionFn.apply, []

    def spy(qg, kb, vb, idx, tok_bias):
        picks.append(idx.clone())
        return apply(qg, kb, vb, idx, tok_bias)

    with mock.patch.object(selection.SelectionAttentionFn, "apply", spy), \
            use_backend("kernels"):
        api.forward(model, batch)
    check(len(picks) == api.mcfg.n_layers, f"{len(picks)} selection calls in "
                                           f"{api.mcfg.n_layers} layers")
    return picks


def lm_backward_kernel_phase(dev, picks) -> list[dict]:
    """``local_dq`` and ``local_dkv`` against their plain version in fp32
    and bf16, on the ``local_fwd`` case (B = 1, 4096 tokens, a padded tail,
    a hole, a sample boundary) and at the LM train shapes (B = 2 × 4096, no
    mask); then, at the train shapes in bf16, the backward kernels the LM
    shares with shapenet: flash_dq / flash_dkv block-causal against the
    N/64 pooled keys, selection_bwd on each layer's own picks (512 rows a
    group) and epilogue_bwd.  Each gets the forward kernel's (o, lse), a
    random dO and δ = rowsum(dO·O)."""
    results = []
    record = recorder(results)
    rep = LM_HQ // LM_HKV
    n, Bt = TRAIN_LM_N, TRAIN_LM_B
    cases = [("lm_window", 1, *lm_window_case(dev, n)),
             ("lm_train", Bt, torch.zeros((Bt, n), dtype=torch.float32, device=dev), None)]
    kw = dict(window=LM_W, n_heads=LM_HKV)
    for dtype in (torch.float32, torch.bfloat16):
        es = torch.tensor([], dtype=dtype).element_size()
        for mode, Bc, key_bias, blk_seg in cases:
            q = rand((Bc * LM_HKV, rep, n, LM_D), dtype, dev, 110)
            k = rand((Bc * LM_HKV, n, LM_D), dtype, dev, 111)
            v = rand((Bc * LM_HKV, n, LM_D), dtype, dev, 112)
            o, lse = local.local_window_fwd(q, k, v, key_bias, blk_seg, **kw)
            do = rand(o.shape, dtype, dev, 113)
            args = (q, k, v, key_bias, blk_seg, do, lse, row_delta(do, o))
            live = local.live_map(key_bias, blk_seg, LM_W)   # shared, as in local_window_bwd
            dq = local.local_window_dq(*args, live=live, **kw)
            dkv = local.local_window_dkv(*args, live=live, **kw)
            want = local.local_window_bwd_plain(*args, **kw)
            torch.cuda.synchronize()
            pairs = LM_HQ * local_visible_pairs(key_bias, blk_seg, LM_W)
            side = 2 * 4 * q.numel() // LM_D + 4 * key_bias.numel() + 4 * 2 * Bc * (n // LM_W)
            p_ms = median_ms(lambda: local.local_window_bwd_plain(*args, **kw), warmup=1,
                             reps=3)
            qs = q.reshape(Bc, LM_HQ, n, LM_D).clone().requires_grad_(True)
            ks, vs = (t.reshape(Bc, LM_HKV, n, LM_D).repeat_interleave(rep, 1).clone()
                      .requires_grad_(True) for t in (k, v))
            dense_ok = local_dense_mask(key_bias, blk_seg, LM_W)
            lib_ms = library_bwd_ms(lambda: F.scaled_dot_product_attention(
                qs, ks, vs, attn_mask=dense_ok), (qs, ks, vs))
            del qs, ks, vs, dense_ok
            err, ok = rel_err((dq,), want[:1])
            b_ms, b_by = bound((3 * q.numel() + 2 * k.numel()) * es + side,
                               6.0 * LM_D * pairs, dtype)
            record("local_dq", mode, dtype, err, ok,
                   median_ms(lambda: local.local_window_dq(*args, live=live, **kw)), p_ms,
                   b_ms, b_by, lib_ms)
            err, ok = rel_err(dkv, want[1:])
            b_ms, b_by = bound((2 * q.numel() + 4 * k.numel()) * es + side,
                               8.0 * LM_D * pairs, dtype)
            record("local_dkv", mode, dtype, err, ok,
                   median_ms(lambda: local.local_window_dkv(*args, live=live, **kw)), p_ms,
                   b_ms, b_by, lib_ms)
            del q, k, v, o, lse, do, args, live, dq, dkv, want
            torch.cuda.empty_cache()

    dtype, es = torch.bfloat16, 2
    # ---- flash_dq / flash_dkv, block-causal: 4096 queries against 64 pooled keys
    NBt = n // LM_ELL
    q = rand((Bt * LM_HKV, rep, n, LM_D), dtype, dev, 120)
    kf = rand((Bt * LM_HKV, NBt, LM_D), dtype, dev, 121)
    vf = rand((Bt * LM_HKV, NBt, LM_D), dtype, dev, 122)
    zb = torch.zeros((Bt, NBt), dtype=torch.float32, device=dev)
    fkw = dict(n_heads=LM_HKV, block_causal=True, ell=LM_ELL)
    o, lse = flash.flash_attention_fwd(q, kf, vf, zb, None, **fkw)
    do = rand(o.shape, dtype, dev, 123)
    args = (q, kf, vf, zb, do, lse, row_delta(do, o))
    dq = flash.flash_attention_dq(*args, **fkw)
    dkv = flash.flash_attention_dkv(*args, **fkw)
    want = flash.flash_attention_bwd_plain(*args, **fkw)
    torch.cuda.synchronize()
    vis = flash.visible_keys(n, NBt, causal=False, block_causal=True, ell=LM_ELL, device=dev)
    n_pairs = Bt * LM_HQ * float(vis.sum())
    side = 2 * 4 * q.numel() // LM_D + 4 * Bt * NBt
    p_ms = median_ms(lambda: flash.flash_attention_bwd_plain(*args, **fkw), warmup=1, reps=3)
    qs = q.reshape(Bt, LM_HQ, n, LM_D).clone().requires_grad_(True)
    ks, vs = (t.reshape(Bt, LM_HKV, NBt, LM_D).repeat_interleave(rep, 1).clone()
              .requires_grad_(True) for t in (kf, vf))
    lib_ms = library_bwd_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=vis),
                            (qs, ks, vs))
    err, ok = rel_err((dq,), want[:1])
    b_ms, b_by = bound((3 * q.numel() + 2 * kf.numel()) * es + side, 6.0 * LM_D * n_pairs,
                       dtype)
    record("flash_dq", "lm_train_block_causal", dtype, err, ok,
           median_ms(lambda: flash.flash_attention_dq(*args, **fkw)), p_ms, b_ms, b_by, lib_ms)
    err, ok = rel_err(dkv, want[1:])
    b_ms, b_by = bound((2 * q.numel() + 4 * kf.numel()) * es + side, 8.0 * LM_D * n_pairs,
                       dtype)
    record("flash_dkv", "lm_train_block_causal", dtype, err, ok,
           median_ms(lambda: flash.flash_attention_dkv(*args, **fkw)), p_ms, b_ms, b_by,
           lib_ms)
    del q, kf, vf, o, lse, do, args, dq, dkv, want, qs, ks, vs

    # ---- selection_fwd, selection_dq, selection_dkv: each layer's picks, 64
    # groups of g·rep = 512 rows, 16 blocks of 64 keys
    G, M = n // LM_G, LM_G * rep
    for idx in picks:
        check(idx.shape == (Bt, LM_HKV, G, LM_KSTAR), f"LM picks {tuple(idx.shape)}")
    qg = rand((Bt, LM_HKV, G, M, LM_D), dtype, dev, 124)
    kb = rand((Bt, LM_HKV, NBt, LM_ELL, LM_D), dtype, dev, 125)
    vb = rand((Bt, LM_HKV, NBt, LM_ELL, LM_D), dtype, dev, 126)
    tok_bias = torch.zeros((Bt, NBt, LM_ELL), dtype=torch.float32, device=dev)
    do = rand(qg.shape, dtype, dev, 127)
    selection_tiled_rows(record, "lm_train_topk", qg, kb, vb, picks, tok_bias, do)
    del qg, kb, vb, do
    torch.cuda.empty_cache()

    # ---- epilogue_bwd: R = B·N·Hq rows of 64
    R = Bt * n * LM_HQ
    os_ = [rand((R, LM_D), dtype, dev, 128 + i) for i in range(3)]
    gs = [torch.sigmoid(rand((R,), torch.float32, dev, 131 + i)) for i in range(3)]
    m = torch.ones(R, dtype=torch.float32, device=dev)
    epilogue_bwd_row(record, "lm_train_rows", (*os_, *gs, m, rand((R, LM_D), dtype, dev, 134)),
                     rel_err)
    del os_, gs
    torch.cuda.empty_cache()
    return results


def has_attention(cfg) -> bool:
    return any(mixer == "attn" for mixer, _ in transformer.layer_spec(cfg))


def train_lm_phase(dev, api, model, batches, path: str = "train_lm",
                   reference: bool = True, profile: bool = True) -> dict:
    """``make_train_step`` on the LM at full width (bf16 parameters, fp32
    AdamW moments, remat on): one warm-up step, then ``len(batches) − 1``
    timed steps (their launches checked against ``path``), the per-layer
    gradient check against the reference backend (``reference``; a stack
    without attention runs the same code on both backends), identical
    gradient bits on two calls of the first layer, and a profiled step
    (``profile``: the profiler's summary of mamba2's 48-layer step took 42
    s on the host, so its split comes from its prefill's profile)."""
    cfg = api.mcfg
    n_steps = len(batches) - 1
    check(cfg.remat, f"{cfg.name} trains with remat on")
    check(not has_attention(cfg)
          or local.local_plan(cfg.bsa.effective_local_window, cfg.resolved_head_dim,
                              getattr(torch, cfg.compute_dtype)).path == "tiles",
          f"{cfg.name} train: local_fwd is not on the tiled path (local_fwd_mma)")
    opt_state = adamw_init(dict(model.named_parameters()),
                           state_dtype=getattr(torch, cfg.opt_state_dtype))
    step = make_train_step(api, base_lr=1e-3, weight_decay=0.01, total_steps=300,
                           warmup_steps=30)
    t0 = time.perf_counter()
    model, opt_state, _ = step(model, opt_state, batches[0])       # warm-up step
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_counters()                                    # just before the main path
    metrics, step_ms = [], []
    for batch in batches[1:]:
        t0 = time.perf_counter()
        model, opt_state, out = step(model, opt_state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(out)
    launches = {name: c.n for name, c in COUNTERS.items()}  # just after it
    batch_size, seq_len = batches[0]["tokens"].shape
    tokens = n_steps * batch_size * seq_len
    stats = {"arch": cfg.name, "steps": n_steps, "batch": batch_size,
             "seq_len": seq_len,
             "layers": cfg.n_layers, "param_dtype": cfg.param_dtype,
             "opt_state_dtype": cfg.opt_state_dtype, "remat": cfg.remat,
             "loss": [float(m["loss"]) for m in metrics],
             "grad_norm": [float(m["grad_norm"]) for m in metrics],
             "lr": [m["lr"] for m in metrics], "warmup_s": warm_s, "step_ms": step_ms,
             "median_step_ms": statistics.median(step_ms),
             "trained_tokens_per_second": tokens / (sum(step_ms) / 1e3),
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches": launches}
    print(json.dumps({"train_lm": stats}), flush=True)
    check(all(math.isfinite(x) for x in stats["loss"] + stats["grad_norm"]),
          f"{cfg.name} train: non-finite loss or gradient norm")
    check(all(bool(torch.isfinite(p.grad).all()) for p in model.parameters()
              if p.grad is not None), f"{cfg.name} train: non-finite gradient")   # φ_q: none
    n_attn = cfg.n_layers * sum(m == "attn" for m, _ in transformer.layer_spec(cfg)) \
        // len(transformer.layer_spec(cfg))
    check_launches(launches, path, n_attn * n_steps,
                   per_forward_kernel=2 * n_attn * n_steps)   # + recompute
    if reference:
        stats["reference_check"] = lm_train_reference_check(model, cfg, batches[1])
    stats["bit_identical"] = lm_layer_bits(model, cfg, batches[1])
    if not profile:
        return stats
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(model, opt_state, batches[1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    summary = device_summary(prof)
    summary.update(profiled_wall_ms=wall * 1e3,
                   device_busy_share=summary["device_kernel_ms"] / (wall * 1e3))
    print(json.dumps({"train_lm_profile": {"arch": cfg.name, **summary}}), flush=True)
    return stats


def lm_train_reference_check(model, cfg, batch) -> dict:
    """Hold each LM layer's gradients on the kernel path to the ``reference``
    backend's, given the same layer input and the same upstream gradient
    (the ``train_reference_check`` recipe).  The layer inputs come from a
    no-grad forward on the kernel path; walking down, each layer runs again
    with grad on each backend, so one layer's graph is held at a time.

    Each gradient tensor is held by max|kernel − reference| / max|reference|
    ≤ ``LM_GRAD_REL_TOL``, a parameter's denominator floored at
    ``LM_GRAD_FLOOR`` × the layer's largest parameter gradient.  The floor
    is for a gradient that is 0 in exact arithmetic: φ_k.pos adds the same
    mean(pos) to every pooled key when no token is padded, and softmax
    ignores a shift shared by every key, so both backends return rounding
    noise for it.  ``by_name`` reports, per tensor name over the layers, the
    held ratio, the unfloored one and the smallest share of the layer's
    largest parameter gradient."""
    tokens, labels = batch["tokens"], batch["labels"]
    B_, N_ = tokens.shape
    pos = torch.arange(N_, device=tokens.device)[None].expand(B_, N_)
    layers = [period.pos0 for period in model.layers]
    xs, held = [], HeldRouting()
    with torch.no_grad(), use_backend("kernels"):
        h = embed(model.embed, tokens, dtype=cfg.cdtype())
        for lp in layers:
            xs.append(h)
            h = lm_layer(lp, h, mcfg=cfg, positions=pos)
    top = h.detach().requires_grad_(True)
    logits = dense(model.lm_head, rmsnorm(model.final_norm, top, cfg.norm_eps)).float()
    gy, = torch.autograd.grad(masked_mean_nll(logits, labels), top)
    del logits
    rows = []
    for i in reversed(range(len(layers))):
        lp = layers[i]
        names = [n for n, p in lp.named_parameters() if p.requires_grad]
        x = xs[i].detach().requires_grad_(True)
        wrt = [x] + [p for _, p in lp.named_parameters() if p.requires_grad]
        grads = {}
        for backend in ("kernels", "reference"):
            with held(backend):
                y = lm_layer(lp, x, mcfg=cfg, positions=pos)
                grads[backend] = torch.autograd.grad(y, wrt, gy, allow_unused=True)
            del y
        pairs = []
        for name, a, b in zip(["input"] + names, grads["kernels"], grads["reference"]):
            check((a is None) == (b is None), f"LM layer {i} {name}: gradient on one side only")
            if a is None:                              # φ_q only feeds top-k
                continue
            check(bool(torch.isfinite(a).all()), f"LM layer {i} {name}: non-finite gradient")
            pairs.append((name, float((a.float() - b.float()).abs().max()),
                          float(b.float().abs().max())))
        floor = LM_GRAD_FLOOR * max(ref for name, _, ref in pairs if name != "input")
        for name, diff, ref in pairs:
            den = ref if name == "input" else max(ref, floor)
            rows.append({"layer": i, "name": name, "max_abs_diff": diff, "ref_max_abs": ref,
                         "rel": diff / den if den > 0 else (0.0 if diff == 0 else math.inf),
                         "rel_own": diff / ref if ref > 0 else (0.0 if diff == 0 else math.inf),
                         "floored": den > ref, "share": ref / (floor / LM_GRAD_FLOOR)})
        gy = grads["kernels"][0]
        del grads
    worst = max(rows, key=lambda r: r["rel"])
    by_name = {}
    for r in rows:
        b = by_name.setdefault(r["name"], {"rel": 0.0, "rel_own": 0.0, "share": math.inf,
                                           "floored_layers": 0})
        b.update(rel=max(b["rel"], r["rel"]), rel_own=max(b["rel_own"], r["rel_own"]),
                 share=min(b["share"], r["share"]),
                 floored_layers=b["floored_layers"] + r["floored"])
    stats = {"arch": cfg.name, "rel_tol": LM_GRAD_REL_TOL, "floor": LM_GRAD_FLOOR,
             "worst": worst,
             "by_name": by_name, "tensors_compared": len(rows), "layers": len(layers),
             "rel_by_layer": [max(r["rel"] for r in rows if r["layer"] == i)
                              for i in range(len(layers))]}
    if held.tokens:
        stats["moe_routing"] = {"held_tokens": held.tokens,
                                "router_flips_on_reference": held.flipped}
    print(json.dumps({"train_lm_reference_check": stats}), flush=True)
    beyond = [f"layer {r['layer']} {r['name']} ({r['rel']:.2e})" for r in rows
              if not r["rel"] <= LM_GRAD_REL_TOL]
    check(not beyond, f"LM kernel-path gradients vs reference backend beyond "
                      f"{LM_GRAD_REL_TOL}: {', '.join(beyond[:8])}")
    return stats


def lm_layer_bits(model, cfg, batch) -> bool:
    """The first layer's input and parameter gradients on the kernel path
    (its attention or mamba mixer, its FFN or MoE), computed twice from the
    same input and upstream gradient: identical bits, checked."""
    tokens = batch["tokens"]
    B_, N_ = tokens.shape
    pos = torch.arange(N_, device=tokens.device)[None].expand(B_, N_)
    lp = model.layers[0].pos0
    with torch.no_grad():
        x = embed(model.embed, tokens, dtype=cfg.cdtype())
    x = x.requires_grad_(True)
    wrt = [x] + [p for p in lp.parameters() if p.requires_grad]
    runs = []
    with use_backend("kernels"):
        for _ in range(2):
            y = lm_layer(lp, x, mcfg=cfg, positions=pos)
            gy = torch.ones_like(y) / y.numel() ** 0.5
            runs.append(torch.autograd.grad(y, wrt, gy, allow_unused=True))
            del y
    same = all((a is None and b is None) or torch.equal(a, b) for a, b in zip(*runs))
    print(json.dumps({"lm_layer_bits": {"arch": cfg.name, "tensors": len(wrt),
                                        "bit_identical": same}}), flush=True)
    check(same, f"{cfg.name}: the first layer's gradients differ between two calls")
    return same


def decode_schedule(dev, lens=DECODE_LENS, starts=DECODE_STARTS
                    ) -> tuple[torch.Tensor, torch.Tensor, int, int]:
    """The LMs' decode schedule: two slots of ``lens`` positions (the dense
    LMs: ``DECODE_LENS``) from steps ``starts`` over a shuffled block table;
    each slot's pages are mapped from its first step and an idle slot's
    table row names the trash block.  Returns (tables (steps, Bs, n_pages)
    int32, lengths (steps, Bs), num_blocks, n_pad), on the card up front,
    so a decode loop never waits for the host."""
    Bs = len(lens)
    n_pad = max(-(-max(lens) // PAGE) * PAGE, 2 * LM_W)   # a slot holds two windows
    n_pages = n_pad // PAGE
    num_blocks = Bs * n_pages
    blocks = np.random.default_rng(0).permutation(num_blocks).reshape(Bs, n_pages)
    steps = max(s + n for s, n in zip(starts, lens))
    tables = np.full((steps, Bs, n_pages), num_blocks, np.int32)
    lengths = np.zeros((steps, Bs), np.int64)
    for t in range(steps):
        for b in range(Bs):
            if 0 <= t - starts[b] < lens[b]:
                tables[t, b], lengths[t, b] = blocks[b], t - starts[b]
    return (torch.from_numpy(tables).to(dev), torch.from_numpy(lengths).to(dev),
            num_blocks, n_pad)


def start_slots(api, caches, t: int, starts):
    """A recurrent (mamba) slot's state zeroed at its first step, as the
    engine resets a slot on admission (attention pools need no reset)."""
    for b, s0 in enumerate(starts):
        if t == s0 and api.has_recurrent_state:
            caches = api.cache_reset_slot(caches, b)
    return caches


def dense_decode_phase(dev, api, model, lens=DECODE_LENS, starts=DECODE_STARTS) -> dict:
    """The LM's paged decode through the user's entry point,
    ``api.paged_decode_step`` on the model's own config (``LM_BSA``, bf16):
    the two staggered slots of ``decode_schedule(lens, starts)``, each fed
    random tokens (numpy seed 3); every attention layer launches
    ``paged_gather_pair`` 4 times a step (a mamba layer none), the logits
    are finite, and ``ms_per_step`` is this loop's wall time a step.  Then
    ``decode_hold`` holds the same entry point to the forward."""
    cfg = api.mcfg
    tables, lengths, num_blocks, n_pad = decode_schedule(dev, lens, starts)
    steps, Bs = lengths.shape
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (Bs, n_pad), dtype=np.int32)).to(dev)
    slot = torch.arange(Bs, device=dev)
    caches = api.paged_cache_init(Bs, num_blocks, PAGE, cfg.cdtype(), device=dev)
    with torch.inference_mode():
        finite = torch.ones((), dtype=torch.bool, device=dev)
        torch.cuda.synchronize()
        reset_counters()                                 # just before the main path
        t0 = time.perf_counter()
        for t in range(steps):
            caches = start_slots(api, caches, t, starts)
            logits, caches = api.paged_decode_step(model, tokens[slot, lengths[t]], caches,
                                                   tables[t], lengths[t], PAGE)
            finite &= torch.isfinite(logits).all()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = {name: c.n for name, c in COUNTERS.items()}  # just after it
    del caches
    n_attn = sum(hasattr(lp, "attn") for period in model.layers for lp in period.positions())
    check_launches(launches, f"decode:{cfg.name}", DECODE_GATHERS * n_attn * steps)
    check(tuple(logits.shape) == (Bs, cfg.vocab_size) and bool(finite),
          f"{cfg.name} decode: logits of shape {tuple(logits.shape)}, finite {bool(finite)}")
    stats = {"arch": cfg.name, "slots": Bs, "lens": list(lens),
             "starts": list(starts), "steps": steps, "dtype": cfg.compute_dtype,
             "positions": sum(lens), "seconds": seconds,
             "ms_per_step": seconds / steps * 1e3, "launches": launches}
    print(json.dumps({"dense_decode": stats}), flush=True)
    stats["hold"] = decode_hold(dev, api, model, tokens, tables, lengths, num_blocks,
                                lens, starts)
    return stats


def decode_hold(dev, api, model, tokens, tables, lengths, num_blocks,
                lens=DECODE_LENS, starts=DECODE_STARTS) -> dict:
    """The paged decode held to the forward on the kernel path, position by
    position, by teacher forcing.  The forward (``api.forward`` with
    ``group_size=0, query_cmp_selection=False``: per-token selection, the
    selection the decode makes; the decode reads neither field) records
    each layer's input and mixer output (attention or mamba) through taps on
    ``transformer.lm_layer``, ``transformer.attention_layer_apply`` and
    ``transformer.mamba2_apply``.  Then ``transformer.lm_paged_decode_step``,
    which ``api.paged_decode_step`` calls, runs the schedule again with
    ``layer_input`` feeding each layer the forward's input at its slot's
    position, and taps on ``transformer.attention_layer_decode_paged`` and
    ``transformer.mamba2_decode`` record each mixer output.  Every layer's
    mixer output and the logits (of the last layer fed the forward's input)
    must lie within ``DECODE_HOLD_TOL`` of the forward's largest value.
    Free-running, or with only the attention fed, the bf16 rounding of 24 to
    52 random-weight layers grows past that however either side computes:
    ``free_running`` reports the forward on the reference backend against
    the kernel path's.

    With MoE, the logits pass the last layer's MoE, which at the forward's
    sequence length may drop an assignment over its capacity (a decode step
    never drops) and whose router may break a near-tie the other way: the
    positions where the forward dropped one of the last layer's
    assignments, or where its expert set differs from the decode's, are left
    out of the logits' hold and counted (a mixer output is read before the
    layer's MoE, so every one is held)."""
    cfg = api.mcfg
    xapi = model_api(cfg.scaled(bsa=dataclasses.replace(cfg.bsa, group_size=0,
                                                        query_cmp_selection=False)))
    n_layers = cfg.n_layers
    steps, Bs = lengths.shape
    slot = torch.arange(Bs, device=dev)
    fwd_in, fwd_mix, fwd_moe = [], [], []          # layer inputs, mixer outputs, MoE aux

    def tap_layer(lp, x, **kw):
        fwd_in.append(x)
        return lm_layer(lp, x, **kw)

    def tap_forward(p, x, **kw):
        fwd_mix.append(attention_layer_apply(p, x, **kw))
        return fwd_mix[-1]

    def tap_mamba(p, x, mcfg):
        fwd_mix.append(mamba2.mamba2_apply(p, x, mcfg))
        return fwd_mix[-1]

    def tap_moe(collect):
        def moe(p, x, mcfg, top_e=None):
            y, aux = moe_apply(p, x, mcfg, top_e)
            collect.append(aux)
            return y, aux
        return moe

    with torch.inference_mode():
        with use_backend("kernels"), mock.patch.multiple(
                transformer, lm_layer=tap_layer, attention_layer_apply=tap_forward,
                mamba2_apply=tap_mamba, moe_apply=tap_moe(fwd_moe)):
            ref = xapi.forward(model, {"tokens": tokens})
        with use_backend("reference"):                   # the bf16 noise floor
            alt = xapi.forward(model, {"tokens": tokens})
    check(len(fwd_in) == len(fwd_mix) == n_layers,
          f"{cfg.name} forward: {len(fwd_in)} layers and {len(fwd_mix)} mixer calls "
          f"tapped, expected {n_layers}")
    outs, logits, calls, dec_moe = [[] for _ in range(n_layers)], [], [0], []

    def tap_decode(*args, **kw):
        out, cache = attention_layer_decode_paged(*args, **kw)
        outs[calls[0] % n_layers].append(out[:, 0])
        calls[0] += 1
        return out, cache

    def tap_mamba_decode(*args, **kw):
        out, cache = mamba2.mamba2_decode(*args, **kw)
        outs[calls[0] % n_layers].append(out[:, 0])
        calls[0] += 1
        return out, cache

    caches = api.paged_cache_init(Bs, num_blocks, PAGE, cfg.cdtype(), device=dev)
    t0 = time.perf_counter()
    with torch.inference_mode(), mock.patch.multiple(
            transformer, attention_layer_decode_paged=tap_decode,
            mamba2_decode=tap_mamba_decode, moe_apply=tap_moe(dec_moe)):
        for t in range(steps):
            caches = start_slots(api, caches, t, starts)
            length = lengths[t]
            lg, caches = transformer.lm_paged_decode_step(
                model, tokens[slot, length], caches, tables[t], length, mcfg=cfg, page=PAGE,
                layer_input=lambda i, x: fwd_in[i][slot, length][:, None])
            logits.append(lg)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    del caches
    check(calls[0] == n_layers * steps, f"{cfg.name} decode: {calls[0]} mixer calls "
                                        f"tapped, expected {n_layers * steps}")
    # the logits' positions left out: the last MoE layer dropped an assignment
    # in the forward, or picked another expert set than the decode
    keep = torch.ones(tokens.shape, dtype=torch.bool, device=dev)
    moe_left_out = {}
    if fwd_moe:
        per_layer = len(dec_moe) // steps
        last_f, last_d = fwd_moe[-1], dec_moe[per_layer - 1::per_layer]
        dec_sets = torch.stack([a["top_e"][:, 0].sort(-1).values for a in last_d])  # (T,Bs,k)
        differ = torch.zeros_like(keep)
        for b in range(Bs):
            idx = torch.arange(lens[b], device=dev)
            differ[b, idx] = (dec_sets[starts[b] + idx, b]
                              != last_f["top_e"][b, idx].sort(-1).values).any(-1)
        keep &= ~last_f["dropped"] & ~differ
        moe_left_out = {"dropped_in_forward": int(sum(last_f["dropped"][b, :lens[b]].sum()
                                                      for b in range(Bs))),
                        "expert_set_differs": int(sum(differ[b, :lens[b]].sum()
                                                      for b in range(Bs)))}

    def held(pick, want, keep_rows=None) -> dict:
        """``pick(b, positions)``'s rows against the forward's rows ``want``
        (Bs, n_pad, ·) at each slot's positions (those of ``keep_rows``):
        the worst distance, the largest value and the positions beyond the
        limit."""
        diff, top = [], []
        for b in range(Bs):
            idx = torch.arange(lens[b], device=dev)
            if keep_rows is not None:
                idx = idx[keep_rows[b, :lens[b]]]
            g, w = pick(b, idx).float(), want[b, idx].float()
            check(bool(torch.isfinite(g).all()), f"{cfg.name} decode: non-finite values")
            diff.append((g - w).abs().amax(-1))
            top.append(w.abs().amax())
        diff, scale = torch.cat(diff), float(max(top))
        return {"max_abs_diff": float(diff.max()), "ref_max_abs": scale,
                "rel": float(diff.max()) / scale, "positions": int(diff.numel()),
                "beyond": int((diff > DECODE_HOLD_TOL * scale).sum())}

    def decoded(rows):
        got = torch.stack(rows)                          # (steps, Bs, ·)
        return lambda b, idx: got[starts[b] + idx, b]

    by_layer = [held(decoded(o), fwd_mix[i]) for i, o in enumerate(outs)]
    final = held(decoded(logits), ref, keep if fwd_moe else None)
    free = held(lambda b, idx: alt[b, idx], ref)         # reference vs kernel forward
    stats = {"arch": cfg.name, "rel_tol": DECODE_HOLD_TOL, "logits": final,
             "worst_layer": max(range(n_layers), key=lambda i: by_layer[i]["rel"]),
             "mixer_rel_by_layer": [r["rel"] for r in by_layer],
             "positions_beyond_tol": final["beyond"] + sum(r["beyond"] for r in by_layer),
             "free_running": {"reference_vs_kernel_forward_logits_rel": free["rel"]},
             "seconds": seconds}
    if fwd_moe:
        stats["moe_positions_left_out"] = moe_left_out
    print(json.dumps({"dense_decode_hold": stats}), flush=True)
    beyond = [f"layer {i} ({r['rel']:.2e})" for i, r in enumerate(by_layer) if r["beyond"]]
    if final["beyond"]:
        beyond.append(f"logits ({final['rel']:.2e})")
    check(not beyond, f"{cfg.name} paged decode vs forward beyond {DECODE_HOLD_TOL} of the "
                      f"largest value: {', '.join(beyond[:8])}")
    return stats


def dense_lm_phase(dev, arch: str) -> dict:
    """One dense LM of ``DENSE_LMS`` at full width and its depth (``DENSE_DEPTH``
    cuts it): its weights
    from seed 0 on the card (peak memory of the init reported), the prefill
    (``prefill_phase``: launches, every layer held to the reference backend
    within 4e-2, a profiled call), the paged decode
    (``dense_decode_phase``) and, where it trains, 1 + 3 steps with remat
    and fp32 moments (``train_lm_phase``: launches, every layer's gradients
    within 6e-2, peak memory).  Returns its paths' stats."""
    (pb, pn), train = DENSE_LMS[arch]
    out = {}
    cfg = get_config(arch)
    api = model_api(cfg.scaled(n_layers=DENSE_DEPTH.get(arch, cfg.n_layers)))
    cfg = api.mcfg
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = api.init(seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    init = {"arch": arch, "parameters": n_params, "dtype": cfg.param_dtype,
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim],
            "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
            "weights_gb": sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9,
            "init_peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "seconds": time.perf_counter() - t0}
    print(json.dumps({"dense_lm_init": init}), flush=True)
    print(f"# {arch}: {n_params / 1e9:.3f} B parameters ({cfg.param_dtype}) made in "
          f"{init['seconds']:.1f} s", flush=True)
    t0 = time.perf_counter()
    out[f"prefill:{arch}"] = prefill_phase(dev, api, model, pb, pn, f"prefill:{arch}")
    torch.cuda.empty_cache()
    print(f"# {arch} prefill: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    out[f"decode:{arch}"] = dense_decode_phase(dev, api, model)
    torch.cuda.empty_cache()
    print(f"# {arch} decode: {time.perf_counter() - t0:.1f} s", flush=True)
    if train is None:
        moments = 2 * n_params * 4 / 1e9
        print(json.dumps({"train_skipped": {
            "arch": arch, "reason": f"its fp32 AdamW moments alone are {moments:.1f} GB, "
                                    "beside its weights, on a card of 80 GB"}}), flush=True)
        return out
    t0 = time.perf_counter()
    batches = lm_train_batches(dev, cfg.vocab_size, *train, steps=DENSE_TRAIN_STEPS)
    out[f"train:{arch}"] = train_lm_phase(dev, api, model, batches, f"train:{arch}")
    print(f"# {arch} train: {time.perf_counter() - t0:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# the other families: MoE, SSM, VLM, encoder-decoder (family phases)
# ---------------------------------------------------------------------------

def ball_kernel_rows(record, dev, mode: str, Hkv: int, rep: int, Dh: int, m: int, n: int,
                     seed: int, want_path: str) -> tuple:
    """``bta_fwd`` / ``bta_bwd`` in bf16 on one sequence of n positions
    (every one valid) in balls of m, Hkv KV heads of rep query heads each,
    against their plain versions (the backward fed the kernel's own lse),
    timed with their device times beside SDPA on the same balls (K and V
    repeated to the query heads), forward and backward; ``bta_plan`` must
    name ``want_path``.  Returns the inputs (q, k, v, key_bias)."""
    dt, es = torch.bfloat16, 2
    kb = torch.zeros((1, n), dtype=torch.float32, device=dev)
    q = rand((Hkv, rep, n, Dh), dt, dev, seed)
    k = rand((Hkv, n, Dh), dt, dev, seed + 1)
    v = rand((Hkv, n, Dh), dt, dev, seed + 2)
    kw = dict(ball_size=m, n_heads=Hkv)
    path = bta.bta_plan(m, Dh, rep, dt).path
    check(path == want_path, f"{mode}: bta_plan names {path}, expected {want_path}")
    nb = n // m
    balls = nb * Hkv * rep                     # (query head, ball) pairs
    qs = q.reshape(Hkv * rep, nb, m, Dh).transpose(0, 1).contiguous().requires_grad_(True)
    ks, vs = (t.reshape(Hkv, nb, m, Dh).transpose(0, 1).repeat_interleave(rep, 1).contiguous()
              .requires_grad_(True) for t in (k, v))
    lib = lambda: F.scaled_dot_product_attention(qs, ks, vs)  # noqa: E731
    call = functools.partial(bta.ball_attention_fwd, q, k, v, kb, **kw)
    plain = functools.partial(bta.ball_attention_fwd_plain, q, k, v, kb, **kw)
    o, lse = call()
    err, ok = max_err((o, lse), plain())
    side = 4 * n + 4 * nb + 4 * q.numel() // Dh              # bias, live, lse
    b_ms, b_by = bound((2 * q.numel() + 2 * k.numel()) * es + side,
                       4.0 * m * m * Dh * balls, dt)
    with torch.no_grad():
        lib_ms, lib_dev = median_ms(lib), device_ms(lib, per_call=True)[0]
    record("bta_fwd", mode, dt, err, ok, median_ms(call), median_ms(plain, reps=5),
           b_ms, b_by, lib_ms, device_ms=device_ms(call, "bta_fwd")[0],
           library_device_ms=lib_dev, path=path)
    do = rand(o.shape, dt, dev, seed + 3)
    args = (q, k, v, kb, do, lse, row_delta(do, o))
    call = functools.partial(bta.ball_attention_bwd, *args, **kw)
    err, ok = rel_err(call(), bta.ball_attention_bwd_plain(*args, **kw))
    b_ms, b_by = bound((3 * q.numel() + 4 * k.numel()) * es + side + 4 * q.numel() // Dh,
                       10.0 * m * m * Dh * balls, dt)
    record("bta_bwd", mode, dt, err, ok, median_ms(call),
           median_ms(lambda: bta.ball_attention_bwd_plain(*args, **kw), reps=5), b_ms, b_by,
           library_bwd_ms(lib, (qs, ks, vs)), device_ms=device_ms(call, "bta_bwd")[0],
           library_device_ms=library_bwd_device_ms(lib, (qs, ks, vs)), path=path)
    return q, k, v, kb


def family_kernel_phase(dev) -> list[dict]:
    """seamless-m4t's own kernel shapes in bf16 against the plain versions,
    timed beside SDPA: ``bta_fwd`` / ``bta_bwd`` on its encoder's ball
    attention (4096 frames, 16 heads of 64, balls of 256: ``bta_plan``'s
    mma path), the flash trio on its cross-attention (512 decoder rows
    against 4096 frames, every frame valid; ``flash_dkv`` identical bits on
    two calls) and ``flash_fwd`` on a decode step's single row against the
    4096 frames.  Beside them the ball pair at llava's heads (56 / 8 of
    128, rep 7: the mma path at D 128) and at seamless's heads in balls of
    32 (the rows path, which bf16 keeps there)."""
    results = []
    record = recorder(results)
    dt, es = torch.bfloat16, 2
    cfg = get_config(SEAMLESS)
    Hs, Dh, n, m = cfg.n_heads, cfg.resolved_head_dim, FAMILY_N, cfg.bsa.ball_size
    nd = n // cfg.dec_ratio
    # ---- bta: the encoder's balls; llava's heads at D 128; balls of 32
    _, k, v, kb = ball_kernel_rows(record, dev, "seamless_ball", Hs, 1, Dh, m, n, 170, "mma")
    lv = get_config(LLAVA)
    ball_kernel_rows(record, dev, "llava_ball", lv.n_kv_heads, lv.n_heads // lv.n_kv_heads,
                     lv.resolved_head_dim, lv.bsa.ball_size, n, 180, "mma")
    ball_kernel_rows(record, dev, "rows_ball32", Hs, 1, Dh, 32, n, 190, "rows")
    # ---- flash: cross-attention, nd rows (and one at decode) against n frames
    fkw = dict(n_heads=Hs)
    for mode, rows in (("cross", nd), ("cross_decode", 1)):
        q = rand((Hs, 1, rows, Dh), dt, dev, 174)
        call = functools.partial(flash.flash_attention_fwd, q, k, v, kb, None, **fkw)
        plain = functools.partial(flash.flash_attention_fwd_plain, q, k, v, kb, None, **fkw)
        o, lse = call()
        err, ok = max_err((o, lse), plain())
        pairs = float(rows * n * Hs)
        side = 4 * n + 4 * q.numel() // Dh
        b_ms, b_by = bound((2 * q.numel() + 2 * k.numel()) * es + side, 4.0 * Dh * pairs, dt)
        qs = q.reshape(1, Hs, rows, Dh).clone().requires_grad_(True)
        ks, vs = (t[None].clone().requires_grad_(True) for t in (k, v))
        lib = lambda: F.scaled_dot_product_attention(qs, ks, vs)  # noqa: E731
        with torch.no_grad():
            lib_ms, lib_dev = median_ms(lib), device_ms(lib, per_call=True)[0]
        record("flash_fwd", mode, dt, err, ok, median_ms(call), median_ms(plain, reps=5),
               b_ms, b_by, lib_ms, device_ms=device_ms(call, "flash_fwd")[0],
               library_device_ms=lib_dev, path=flash.flash_fwd_plan(Dh, dt).path)
        if mode != "cross":
            continue
        do = rand(o.shape, dt, dev, 175)
        args = (q, k, v, kb, do, lse, row_delta(do, o))
        dq = flash.flash_attention_dq(*args, **fkw)
        dkv = flash.flash_attention_dkv(*args, **fkw)
        again = flash.flash_attention_dkv(*args, **fkw)
        want = flash.flash_attention_bwd_plain(*args, **fkw)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(dkv, again))
        check(same, "flash_dkv [cross]: two calls on the same inputs differ")
        p_ms = median_ms(lambda: flash.flash_attention_bwd_plain(*args, **fkw), reps=5)
        lib_bwd = library_bwd_ms(lib, (qs, ks, vs))
        lib_bwd_dev = library_bwd_device_ms(lib, (qs, ks, vs))
        side += 4 * q.numel() // Dh
        for name, got, ref, nbytes, flops in (
                ("flash_dq", (dq,), want[:1], (3 * q.numel() + 2 * k.numel()) * es + side,
                 6.0 * Dh * pairs),
                ("flash_dkv", dkv, want[1:], (2 * q.numel() + 4 * k.numel()) * es + side,
                 8.0 * Dh * pairs)):
            fn = functools.partial(getattr(flash, "flash_attention_" + name.split("_")[1]),
                                   *args, **fkw)
            err, ok = rel_err(got, ref)
            b_ms, b_by = bound(nbytes, flops, dt)
            extra = {"bit_identical": same} if name == "flash_dkv" else {}
            record(name, "cross", dt, err, ok, median_ms(fn), p_ms, b_ms, b_by, lib_bwd,
                   device_ms=device_ms(fn, name)[0], library_device_ms=lib_bwd_dev, **extra)
        del qs, ks, vs, args, want, dq, dkv, again
    torch.cuda.empty_cache()
    return results


def family_init(dev, cfg, cut: str | None = None):
    """``model_api(cfg).init(seed=0)`` on the card; prints the parameter
    count, the weights' size, the init's peak memory and ``cut`` (a depth
    cut and its reason)."""
    api = model_api(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = api.init(seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    init = {"arch": cfg.name, "family": cfg.family, "parameters": n_params,
            "dtype": cfg.param_dtype, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "heads": [cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim],
            "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
            "weights_gb": sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9,
            "init_peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "seconds": time.perf_counter() - t0, "depth_cut": cut}
    print(json.dumps({"family_init": init}), flush=True)
    print(f"# {cfg.name}: {n_params / 1e9:.3f} B parameters ({cfg.param_dtype}) at "
          f"{cfg.n_layers} layers made in {init['seconds']:.1f} s"
          + (f"; depth cut: {cut}" if cut else ""), flush=True)
    return api, model


def free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def moe_phase(dev) -> dict:
    """qwen2-moe-a2.7b at full width: the prefill at full depth (every layer
    held to the reference backend with its routing held: ``HeldRouting``),
    the paged decode and its hold (positions whose last MoE layer dropped an
    assignment in the forward, or routed otherwise, left out of the logits'
    hold and counted), then 1 + 2 train steps at ``MOE_TRAIN_LAYERS`` layers
    (gradients per layer within 6e-2, the first layer's gradients
    bit-identical on two calls); phi3.5-moe's prefill at ``PHIMOE_LAYERS``
    layers."""
    out = {}
    cfg = get_config(QWEN)
    api, model = family_init(dev, cfg)
    t0 = time.perf_counter()
    out[f"prefill:{QWEN}"] = prefill_phase(dev, api, model, 1, FAMILY_N, f"prefill:{QWEN}")
    print(f"# {QWEN} prefill: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    out[f"decode:{QWEN}"] = dense_decode_phase(dev, api, model, FAMILY_DECODE_LENS,
                                               FAMILY_DECODE_STARTS)
    print(f"# {QWEN} decode: {time.perf_counter() - t0:.1f} s", flush=True)
    del model
    free()
    t0 = time.perf_counter()
    api, model = family_init(dev, cfg.scaled(n_layers=MOE_TRAIN_LAYERS),
                             f"train at {MOE_TRAIN_LAYERS} of {cfg.n_layers} layers: fp32 "
                             "AdamW moments of all 24 need ~180 GB")
    batches = lm_train_batches(dev, cfg.vocab_size, 1, FAMILY_N, FAMILY_TRAIN_STEPS)
    out[f"train:{QWEN}"] = train_lm_phase(dev, api, model, batches, f"train:{QWEN}")
    print(f"# {QWEN} train: {time.perf_counter() - t0:.1f} s", flush=True)
    del model, batches
    free()
    t0 = time.perf_counter()
    pcfg = get_config(PHIMOE)
    api, model = family_init(dev, pcfg.scaled(n_layers=PHIMOE_LAYERS),
                             f"{PHIMOE_LAYERS} of {pcfg.n_layers} layers: its bf16 weights "
                             "are 83.7 GB")
    out[f"prefill:{PHIMOE}"] = prefill_phase(dev, api, model, 1, FAMILY_N,
                                             f"prefill:{PHIMOE}")
    print(f"# {PHIMOE} prefill: {time.perf_counter() - t0:.1f} s", flush=True)
    del model
    free()
    return out


def mamba_serve_phase(dev, api, model) -> dict:
    """``ServingEngine(paged=True)`` on mamba2 with ``MAMBA_SLOTS`` slots and
    ``MAMBA_REQUESTS`` prompts of 64–128 tokens (numpy seed 5), greedy,
    ``MAMBA_NEW`` new tokens each: slots are reused, ``cache_reset_slot``
    zeroes each admitted slot's state (counted), prefix reuse is off for
    recurrent state, and no kernel launches.  Requests ``MAMBA_LOCKSTEP``
    (the two admitted into reused slots) are then
    generated alone by B = 1 lockstep ``generate`` (``api.decode_step``):
    their tokens must equal the served ones, or part at a near-tie (the
    lockstep top-two logit gap there below 4e-2 of the largest |logit|: the
    logits are rounded to bf16, so exact ties occur)."""
    cfg = api.mcfg
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, int(n), dtype=np.int32)
               for n in rng.integers(64, 129, MAMBA_REQUESTS)]
    resets = []

    def reset_slot(caches, slot):
        resets.append(slot)
        return api.cache_reset_slot(caches, slot)

    eng = ServingEngine(dataclasses.replace(api, cache_reset_slot=reset_slot), model,
                        batch_slots=MAMBA_SLOTS, max_len=MAMBA_MAX_LEN, paged=True, page=PAGE)
    torch.cuda.synchronize()
    reset_counters()                                     # just before the main path
    t0 = time.perf_counter()
    served = eng.serve(prompts, MAMBA_NEW)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: c.n for name, c in COUNTERS.items()}  # just after it
    stats = {"arch": cfg.name, "slots": MAMBA_SLOTS, "requests": len(prompts),
             "prompt_tokens": [len(p) for p in prompts], "new_tokens": MAMBA_NEW,
             "serve_steps": eng.serve_steps, "wall_s": wall, "slot_resets": len(resets),
             "prefix_reuse": eng._prefix_enabled,
             "tokens_per_second": eng.tokens_per_second,
             "steps_per_second": eng.serve_steps / wall, "launches": launches}
    print(json.dumps({"serve_mamba": stats}), flush=True)
    check_launches(launches, f"serve:{MAMBA}", 0)
    check(len(resets) == len(prompts), f"mamba serve: {len(resets)} slot resets for "
                                       f"{len(prompts)} admissions")
    check(not eng._prefix_enabled, "mamba serve: prefix reuse on for recurrent state")
    check(all(len(o) == MAMBA_NEW for o in served), "mamba serve: wrong token counts")
    rows, t0 = [], time.perf_counter()
    for rid in MAMBA_LOCKSTEP:
        prompt = prompts[rid]
        one = ServingEngine(api, model, batch_slots=1, max_len=MAMBA_MAX_LEN)
        logits, step = [], one._step

        def keep_logits(*args, step=step, logits=logits):
            nxt, lg, caches = step(*args)
            logits.append(lg[0])
            return nxt, lg, caches
        one._step = keep_logits
        toks = one.generate(prompt[None], MAMBA_NEW)[0]
        row = {"request": rid, "served": served[rid].tolist(), "lockstep": toks.tolist()}
        apart = np.nonzero(toks != served[rid])[0]
        if len(apart):
            j = int(apart[0])
            lg = logits[len(prompt) - 1 + j].float().cpu().numpy()
            top2 = np.sort(lg)[-2:]
            gap, scale = float(top2[1] - top2[0]), float(np.abs(lg).max())
            row.update(parted_at=j, top2_gap=gap, max_abs_logit=scale,
                       near_tie=gap < NEAR_TIE * scale)
        check(not len(apart) or row["near_tie"],
              f"mamba request {rid}: served tokens part from lockstep at "
              f"{row.get('parted_at')} with a top-two logit gap of {row.get('top2_gap')}")
        rows.append(row)
    stats["lockstep"] = {"requests": rows, "seconds": time.perf_counter() - t0,
                         "equal": sum("parted_at" not in r for r in rows)}
    print(json.dumps({"serve_mamba_lockstep": stats["lockstep"]}), flush=True)
    return stats


def mamba_phase(dev) -> dict:
    """mamba2-1.3b at full width and depth (48 layers): the prefill (no
    kernel: the SSD is plain products), the paged decode and its hold (each
    layer's mamba output and the logits, fed the forward's layer input),
    the serving engine with slot reuse against lockstep, and 1 + 2 train
    steps (the first layer's gradients bit-identical on two calls)."""
    out = {}
    api, model = family_init(dev, get_config(MAMBA))
    cfg = api.mcfg
    for key, fn in ((f"prefill:{MAMBA}", lambda: prefill_phase(dev, api, model, 1, FAMILY_N,
                                                               f"prefill:{MAMBA}")),
                    (f"decode:{MAMBA}", lambda: dense_decode_phase(
                        dev, api, model, FAMILY_DECODE_LENS, FAMILY_DECODE_STARTS)),
                    (f"serve:{MAMBA}", lambda: mamba_serve_phase(dev, api, model))):
        t0 = time.perf_counter()
        out[key] = fn()
        free()
        print(f"# {key}: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    batches = lm_train_batches(dev, cfg.vocab_size, 1, FAMILY_N, FAMILY_TRAIN_STEPS)
    out[f"train:{MAMBA}"] = train_lm_phase(dev, api, model, batches, f"train:{MAMBA}",
                                           reference=False, profile=False)
    print(f"# train:{MAMBA}: {time.perf_counter() - t0:.1f} s", flush=True)
    del model, batches
    free()
    return out


def grad_rows(tag: str, i: int, names, got, want) -> list[dict]:
    """One layer's gradients (kernels ``got``, reference ``want``) as rows of
    max|diff| / max|reference|, a parameter's floored at ``LM_GRAD_FLOOR``
    of the layer's largest parameter gradient (inputs unfloored).  φ_k's
    ``pos`` (``EXACT_ZERO``) is held against the layer's largest parameter
    gradient itself: with no padded token it adds the same mean(pos) to
    every pooled key, which neither the compression softmax nor the
    selection's ranking sees, so its gradient is 0 in exact arithmetic and
    both backends return rounding noise for it (seamless's decoder: 6–11%
    of its own largest value on the card)."""
    pairs = []
    for name, a, b in zip(names, got, want):
        check((a is None) == (b is None), f"{tag} {i} {name}: gradient on one side only")
        if a is None:
            continue
        check(bool(torch.isfinite(a).all()), f"{tag} {i} {name}: non-finite gradient")
        pairs.append((name, float((a.float() - b.float()).abs().max()),
                      float(b.float().abs().max())))
    floor = LM_GRAD_FLOOR * max(ref for name, _, ref in pairs if name not in ("input",
                                                                              "memory"))
    rows = []
    for name, diff, ref in pairs:
        den = (ref if name in ("input", "memory")
               else floor / LM_GRAD_FLOOR if name.endswith(EXACT_ZERO) else max(ref, floor))
        rows.append({"part": tag, "layer": i, "name": name, "max_abs_diff": diff,
                     "rel": diff / den if den > 0 else (0.0 if diff == 0 else math.inf)})
    return rows


def encdec_reference_check(model, cfg, batch) -> dict:
    """seamless's encoder and decoder layers on the kernel path against the
    ``reference`` backend given the same layer inputs: every layer's output
    within ``LM_LAYER_TOL`` of its largest value, then (walking down from
    the loss) every layer's input, memory and parameter gradients within
    ``LM_GRAD_REL_TOL`` (``grad_rows``); the decoder layers' memory
    gradients, summed, are the encoder's upstream gradient."""
    frames, toks, labels = batch["frames"], batch["dec_tokens"], batch["labels"]
    pos = torch.arange(toks.shape[1], device=toks.device)[None].expand(*toks.shape)
    xs_e, xs_d, fwd = [], [], []
    with torch.no_grad():
        with use_backend("kernels"):
            h = dense(model.frontend_proj, frames.to(cfg.cdtype()))
            for lp in model.enc_layers:
                xs_e.append(h)
                h = encdec.enc_layer(lp, h, mcfg=cfg)
            top_e = h
            memory = rmsnorm(model.enc_norm, h, cfg.norm_eps)
            h = embed(model.tok_embed, toks, dtype=cfg.cdtype())
            for lp in model.dec_layers:
                xs_d.append(h)
                h = encdec.dec_layer(lp, h, memory, mcfg=cfg, positions=pos)
        calls = [("encoder", i, lambda lp=lp, x=x: encdec.enc_layer(lp, x, mcfg=cfg))
                 for i, (lp, x) in enumerate(zip(model.enc_layers, xs_e))]
        calls += [("decoder", i, lambda lp=lp, x=x: encdec.dec_layer(
            lp, x, memory, mcfg=cfg, positions=pos))
            for i, (lp, x) in enumerate(zip(model.dec_layers, xs_d))]
        for part, i, fn in calls:
            with use_backend("kernels"):
                yk = fn()
            with use_backend("reference"):
                yr = fn()
            fwd.append({"part": part, "layer": i,
                        "rel": float((yk.float() - yr.float()).abs().max())
                        / float(yr.float().abs().max())})
    top = h.detach().requires_grad_(True)
    logits = dense(model.lm_head, rmsnorm(model.dec_norm, top, cfg.norm_eps)).float()
    gy, = torch.autograd.grad(masked_mean_nll(logits, labels), top)
    del logits
    rows = []
    g_mem = torch.zeros_like(memory, dtype=torch.float32)
    for i in reversed(range(len(xs_d))):
        lp = model.dec_layers[i]
        x = xs_d[i].detach().requires_grad_(True)
        mem = memory.detach().requires_grad_(True)
        named = [(n, p) for n, p in lp.named_parameters() if p.requires_grad]
        wrt = [x, mem] + [p for _, p in named]
        grads = {}
        for backend in ("kernels", "reference"):
            with use_backend(backend):
                y = encdec.dec_layer(lp, x, mem, mcfg=cfg, positions=pos)
                grads[backend] = torch.autograd.grad(y, wrt, gy, allow_unused=True)
            del y
        rows += grad_rows("decoder", i, ["input", "memory"] + [n for n, _ in named],
                          grads["kernels"], grads["reference"])
        gy, g_mem = grads["kernels"][0], g_mem + grads["kernels"][1].float()
        del grads
    xt = top_e.detach().requires_grad_(True)
    gy, = torch.autograd.grad(rmsnorm(model.enc_norm, xt, cfg.norm_eps), xt,
                              g_mem.to(xt.dtype))
    for i in reversed(range(len(xs_e))):
        lp = model.enc_layers[i]
        x = xs_e[i].detach().requires_grad_(True)
        named = [(n, p) for n, p in lp.named_parameters() if p.requires_grad]
        wrt = [x] + [p for _, p in named]
        grads = {}
        for backend in ("kernels", "reference"):
            with use_backend(backend):
                y = encdec.enc_layer(lp, x, mcfg=cfg)
                grads[backend] = torch.autograd.grad(y, wrt, gy, allow_unused=True)
            del y
        rows += grad_rows("encoder", i, ["input"] + [n for n, _ in named],
                          grads["kernels"], grads["reference"])
        gy = grads["kernels"][0]
        del grads
    stats = {"arch": cfg.name, "layer_rel_tol": LM_LAYER_TOL, "grad_rel_tol": LM_GRAD_REL_TOL,
             "floor": LM_GRAD_FLOOR, "layer_outputs": fwd,
             "worst_output": max(fwd, key=lambda r: r["rel"]),
             "worst_gradient": max(rows, key=lambda r: r["rel"]),
             "tensors_compared": len(rows)}
    print(json.dumps({"encdec_reference_check": stats}), flush=True)
    beyond = [f"{r['part']} {r['layer']} ({r['rel']:.2e})" for r in fwd
              if not r["rel"] <= LM_LAYER_TOL]
    beyond += [f"{r['part']} {r['layer']} {r['name']} ({r['rel']:.2e})" for r in rows
               if not r["rel"] <= LM_GRAD_REL_TOL]
    check(not beyond, f"seamless kernel path vs reference backend: {', '.join(beyond[:8])}")
    return stats


def encdec_bits(model, cfg, batch) -> bool:
    """The first encoder layer's and the first decoder layer's input (and
    memory) and parameter gradients on the kernel path, twice from the same
    inputs: identical bits, checked."""
    toks = batch["dec_tokens"]
    pos = torch.arange(toks.shape[1], device=toks.device)[None].expand(*toks.shape)
    with torch.no_grad(), use_backend("kernels"):
        xe = dense(model.frontend_proj, batch["frames"].to(cfg.cdtype()))
        mem = rmsnorm(model.enc_norm, xe, cfg.norm_eps)
        xd = embed(model.tok_embed, toks, dtype=cfg.cdtype())
    same = True
    for fn, lp, ins in ((lambda lp, x: encdec.enc_layer(lp, x, mcfg=cfg),
                         model.enc_layers[0], [xe]),
                        (lambda lp, x, m: encdec.dec_layer(lp, x, m, mcfg=cfg, positions=pos),
                         model.dec_layers[0], [xd, mem])):
        ins = [t.detach().requires_grad_(True) for t in ins]
        wrt = ins + [p for p in lp.parameters() if p.requires_grad]
        runs = []
        with use_backend("kernels"):
            for _ in range(2):
                y = fn(lp, *ins)
                runs.append(torch.autograd.grad(y, wrt, torch.ones_like(y) / y.numel() ** 0.5,
                                                allow_unused=True))
                del y
        same = same and all((a is None and b is None) or torch.equal(a, b)
                            for a, b in zip(*runs))
    print(json.dumps({"encdec_layer_bits": {"bit_identical": same}}), flush=True)
    check(same, "seamless: a layer's gradients differ between two calls")
    return same


def seamless_train_launches(cfg, steps: int) -> dict:
    """Each kernel's launches in ``steps`` train steps of seamless with remat
    (each forward kernel twice a layer and step): the encoder's BSA (ball,
    compression, selection, combine) a layer, the decoder's causal BSA and
    cross-attention a layer."""
    Le, Ld = cfg.n_encoder_layers or cfg.n_layers, cfg.n_layers
    fwd = {"bta_fwd": Le, "flash_fwd": Le + 2 * Ld, "selection_fwd": Le + Ld,
           "epilogue_fwd": Le + Ld, "local_fwd": Ld}
    bwd = {"bta_bwd": Le, "flash_dq": Le + 2 * Ld, "flash_dkv": Le + 2 * Ld,
           "selection_dq": Le + Ld, "selection_dkv": Le + Ld, "epilogue_bwd": Le + Ld,
           "local_dq": Ld, "local_dkv": Ld}
    return {**{k: 2 * n * steps for k, n in fwd.items()},
            **{k: n * steps for k, n in bwd.items()}}


def check_counts(launches: dict, want: dict, what: str) -> None:
    for name, n in launches.items():
        check(n == want.get(name, 0),
              f"{name} launched {n} times on {what}, expected {want.get(name, 0)}")


def encdec_phase(dev) -> dict:
    """seamless-m4t-medium at full width and depth (12 + 12 layers): 1 + 2
    train steps on 1 × 4096 frames (512 decoder tokens; each kernel's
    launches counted exactly: ``seamless_train_launches``), the layers held
    to the reference backend (``encdec_reference_check``), a layer's
    gradients bit-identical on two calls, a profiled step; then the decode
    (``encdec_decode_phase``)."""
    out = {}
    api, model = family_init(dev, get_config(SEAMLESS))
    cfg = api.mcfg
    check(bta.bta_plan(cfg.bsa.ball_size, cfg.resolved_head_dim,
                       cfg.n_heads // cfg.n_kv_heads, cfg.cdtype()).path == "mma",
          "seamless train: the encoder's balls are not on bta_plan's mma path")
    batches = [api.make_batch(np.random.default_rng(s), 1, FAMILY_N, device=dev)
               for s in range(FAMILY_TRAIN_STEPS + 1)]
    t0 = time.perf_counter()
    opt_state = adamw_init(dict(model.named_parameters()),
                           state_dtype=getattr(torch, cfg.opt_state_dtype))
    step = make_train_step(api, base_lr=1e-3, weight_decay=0.01, total_steps=300,
                           warmup_steps=30)
    model, opt_state, _ = step(model, opt_state, batches[0])       # warm-up step
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_counters()                                    # just before the main path
    metrics, step_ms = [], []
    for batch in batches[1:]:
        t1 = time.perf_counter()
        model, opt_state, m = step(model, opt_state, batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        metrics.append(m)
    launches = {name: c.n for name, c in COUNTERS.items()}  # just after it
    stats = {"arch": cfg.name, "steps": FAMILY_TRAIN_STEPS, "frames": FAMILY_N,
             "decoder_tokens": int(batches[0]["dec_tokens"].shape[1]),
             "layers": [len(model.enc_layers), len(model.dec_layers)],
             "loss": [float(m["loss"]) for m in metrics],
             "grad_norm": [float(m["grad_norm"]) for m in metrics], "warmup_s": warm_s,
             "step_ms": step_ms, "median_step_ms": statistics.median(step_ms),
             "frames_per_second": FAMILY_TRAIN_STEPS * FAMILY_N / (sum(step_ms) / 1e3),
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
             "launches": launches}
    print(json.dumps({"train_encdec": stats}), flush=True)
    check(all(math.isfinite(x) for x in stats["loss"] + stats["grad_norm"]),
          "seamless train: non-finite loss or gradient norm")
    check_counts(launches, seamless_train_launches(cfg, FAMILY_TRAIN_STEPS), "seamless train")
    stats["reference_check"] = encdec_reference_check(model, cfg, batches[1])
    stats["bit_identical"] = encdec_bits(model, cfg, batches[1])
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        step(model, opt_state, batches[1])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    summary = device_summary(prof)
    summary.update(profiled_wall_ms=wall * 1e3,
                   device_busy_share=summary["device_kernel_ms"] / (wall * 1e3))
    print(json.dumps({"train_encdec_profile": {"arch": cfg.name, **summary}}), flush=True)
    out[f"train:{SEAMLESS}"] = stats
    print(f"# {SEAMLESS} train: {time.perf_counter() - t0:.1f} s", flush=True)
    del opt_state
    free()
    t0 = time.perf_counter()
    out[f"decode:{SEAMLESS}"] = encdec_decode_phase(dev, api, model, batches[1])
    print(f"# {SEAMLESS} decode: {time.perf_counter() - t0:.1f} s", flush=True)
    del model
    free()
    return out


def encdec_decode_phase(dev, api, model, batch) -> dict:
    """Greedy decode of ``SEAMLESS_DECODE`` tokens through the user's entry
    points: ``api.cache_init(1, 512, params=, memory=)`` over the encoder's
    output (cross-attention K/V computed once) and ``api.decode_step``
    (self-attention: 4 ``paged_gather_pair`` a layer and step; cross-attention:
    ``flash_fwd`` with one row against the 4096 frames), counted exactly.
    Then the hold: ``decode_train`` on the greedy tokens (padded to 512 with
    random ones) records each decoder layer's input and output (a tap on
    ``encdec.dec_layer``), and the decode runs again with each layer fed the
    forward's input (``encdec_decode_step(layer_input=)``): every layer's
    output and the logits within ``DECODE_HOLD_TOL`` of the forward's
    largest value, position by position."""
    cfg = api.mcfg
    with torch.inference_mode(), use_backend("kernels"):
        memory = encdec.encode(model, batch["frames"], mcfg=cfg)
    caches = api.cache_init(1, SEAMLESS_MAX_LEN, cfg.cdtype(), device=dev, params=model,
                            memory=memory)
    tok = batch["dec_tokens"][:, 0]
    greedy = [tok]
    torch.cuda.synchronize()
    reset_counters()                                    # just before the main path
    t0 = time.perf_counter()
    for _ in range(SEAMLESS_DECODE):
        logits, caches = api.decode_step(model, tok, caches)
        tok = logits.argmax(-1).to(torch.int32)
        greedy.append(tok)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {name: c.n for name, c in COUNTERS.items()}  # just after it
    del caches
    L = cfg.n_layers
    check_counts(launches, {"paged_gather_pair": DECODE_GATHERS * L * SEAMLESS_DECODE,
                            "flash_fwd": L * SEAMLESS_DECODE}, "seamless decode")
    check(bool(torch.isfinite(logits).all()), "seamless decode: non-finite logits")
    stats = {"arch": cfg.name, "tokens": SEAMLESS_DECODE, "seconds": seconds,
             "ms_per_token": seconds / SEAMLESS_DECODE * 1e3, "launches": launches,
             "greedy": torch.stack(greedy[1:], 1)[0].tolist()}
    # the hold: teacher forcing over the greedy tokens
    seq = torch.stack(greedy[:SEAMLESS_DECODE], 1)                     # (1, 32)
    pad = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (1, SEAMLESS_MAX_LEN - SEAMLESS_DECODE), dtype=np.int32)).to(dev)
    fwd_in, fwd_out, dec_layer = [], [], encdec.dec_layer

    def tap(lp, x, *args, **kw):
        fwd_in.append(x)
        fwd_out.append(dec_layer(lp, x, *args, **kw))
        return fwd_out[-1]

    with torch.inference_mode(), use_backend("kernels"), \
            mock.patch.object(encdec, "dec_layer", tap):
        ref = encdec.decode_train(model, torch.cat([seq, pad], 1), memory, mcfg=cfg)
    got_out = [[] for _ in range(L)]
    got_logits = []
    caches = api.cache_init(1, SEAMLESS_MAX_LEN, cfg.cdtype(), device=dev, params=model,
                            memory=memory)
    with torch.inference_mode(), use_backend("kernels"):
        for t in range(SEAMLESS_DECODE):
            def feed(n, x, t=t):
                if n:
                    got_out[n - 1].append(x[:, 0])
                return fwd_in[n][:, t:t + 1]
            lg, caches = encdec.encdec_decode_step(model, seq[:, t], caches, mcfg=cfg,
                                                   layer_input=feed)
            got_logits.append(lg)
    rows = []
    for name, got, want in [(f"layer {i}", torch.stack(got_out[i], 1),
                             fwd_out[i][:, :SEAMLESS_DECODE]) for i in range(L - 1)] + [
            ("logits", torch.stack(got_logits, 1), ref[:, :SEAMLESS_DECODE])]:
        check(bool(torch.isfinite(got).all()), f"seamless decode hold {name}: non-finite")
        d = float((got.float() - want.float()).abs().max())
        rows.append({"what": name, "rel": d / float(want.float().abs().max())})
    stats["hold"] = {"rel_tol": DECODE_HOLD_TOL, "rows": rows,
                     "greedy_equals_teacher_argmax": bool(torch.equal(
                         ref[0, :SEAMLESS_DECODE].argmax(-1).int(),
                         torch.stack(greedy[1:], 1)[0].int()))}
    print(json.dumps({"decode_encdec": stats}), flush=True)
    beyond = [f"{r['what']} ({r['rel']:.2e})" for r in rows if not r["rel"] <= DECODE_HOLD_TOL]
    check(not beyond, f"seamless decode vs decode_train beyond {DECODE_HOLD_TOL}: "
                      f"{', '.join(beyond)}")
    return stats


def vlm_phase(dev) -> dict:
    """llava-next-34b at full width: the depth is the most layers whose bf16
    weights leave ``LLAVA_ROOM_GB`` under ``LLAVA_PEAK_GB`` (measured on one-
    and two-layer models: the weights outside the stack and a layer's), at
    most ``LLAVA_DEPTH``; then the prefill of 512 image + 3,584 text tokens
    (``prefill_phase``: launches, every layer of the backbone held to the
    reference backend, a profiled call) with its peak memory."""
    cfg = get_config(LLAVA)
    sizes = []
    for n in (1, 2):
        model = model_api(cfg.scaled(n_layers=n)).init(seed=0, device=dev)
        sizes.append(sum(p.numel() * p.element_size() for p in model.parameters()))
        del model
        free()
    per_layer, outside = sizes[1] - sizes[0], 2 * sizes[0] - sizes[1]
    room = int((LLAVA_PEAK_GB - LLAVA_ROOM_GB) * 1e9 - outside) // per_layer
    depth = min(cfg.n_layers, LLAVA_DEPTH, room)
    cut = None if depth == cfg.n_layers else (
        f"{depth} of {cfg.n_layers} layers: {per_layer / 1e9:.3f} GB a layer, "
        f"{outside / 1e9:.2f} GB outside the stack; {room} leave {LLAVA_ROOM_GB} GB for the "
        f"prefill under {LLAVA_PEAK_GB} GB, LLAVA_DEPTH {LLAVA_DEPTH} the run's time")
    api, model = family_init(dev, cfg.scaled(n_layers=depth), cut)
    t0 = time.perf_counter()
    stats = prefill_phase(dev, api, model, 1, FAMILY_N, f"prefill:{LLAVA}")
    stats.update(image_tokens=cfg.vision_tokens, text_tokens=FAMILY_N - cfg.vision_tokens,
                 depth_cut=cut)
    print(f"# {LLAVA} prefill ({depth} layers): {time.perf_counter() - t0:.1f} s, peak "
          f"{stats['peak_memory_gb']:.1f} GB", flush=True)
    check(stats["peak_memory_gb"] < 80.0, f"llava prefill peak {stats['peak_memory_gb']} GB")
    del model
    free()
    return {f"prefill:{LLAVA}": stats}


def family_kernel_rows(dev) -> list[dict]:
    """The other families' kernel rows: seamless's ball and cross-attention
    shapes, the causal path at qwen2-moe's, phi3.5-moe's and llava's heads
    (run beside the other head rows, before the models' phases)."""
    t0 = time.perf_counter()
    rows = family_kernel_phase(dev)
    for tag in ("rep1_d128", "rep4", "rep7"):
        rows += head_rows_phase(dev, tag, (torch.bfloat16,))
    print(f"# family kernel rows: {time.perf_counter() - t0:.1f} s", flush=True)
    return rows


def family_phases(dev, paths: dict) -> None:
    """The other families' models (``moe_phase``, ``mamba_phase``,
    ``encdec_phase``, ``vlm_phase``), each phase's seconds printed; their
    paths go into ``paths``."""
    for phase in (moe_phase, mamba_phase, encdec_phase, vlm_phase):
        t0 = time.perf_counter()
        paths.update(phase(dev))
        free()
        print(f"# {phase.__name__}: {time.perf_counter() - t0:.1f} s", flush=True)


def quickstart_phase() -> dict:
    """``launch.quickstart`` on the card (fp32, D 16): its asserts pass and
    each kernel of its path launches, no other."""
    from repro_torch.launch import quickstart
    t0 = time.perf_counter()
    reset_counters()
    out = quickstart.main(["--device", "cuda"])
    torch.cuda.synchronize()
    launches = {name: c.n for name, c in COUNTERS.items()}
    for name, n in launches.items():
        if name in PATHS["quickstart"]:
            check(n >= 1, f"quickstart: {name} never launched")
        else:
            check(n == 0, f"quickstart: {name} launched {n} times, expected 0")
    check(all(bool(torch.isfinite(t).all()) for t in out.values()),
          "quickstart: non-finite output")
    stats = {"seconds": time.perf_counter() - t0, "launches": launches}
    print(json.dumps({"quickstart": stats}), flush=True)
    print(f"# quickstart phase: {stats['seconds']:.1f} s", flush=True)
    return stats


def trainer_phase(dev, next_batches) -> dict:
    """``launch.train --arch shapenet-bsa --steps 3 --batch 8 --ckpt DIR`` on
    the card (``runtime.Trainer``, steps 0–2 numbered as JAX numbers them: a
    checkpoint at the last, step 2), then a second ``Trainer`` restores it
    (every parameter and moment bit for bit, the optimizer's count 3, the
    resumed step 2) and trains from step 2 on ``next_batches``, two batches
    of the same order: its optimizer count is 5, its losses finite, and step
    3's checkpoint exists (a fit's first step is never saved, as in JAX).
    Each run launches each kernel of the padded train path once a layer and
    step.  DIR is ``build/``'s, removed after."""
    from repro_torch.checkpoint import latest_step
    from repro_torch.launch import train as train_cli
    from repro_torch.runtime import Trainer
    t0 = time.perf_counter()
    ckpt = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    fits, fit = [], Trainer.fit

    def spy(self, *args, **kw):                          # keeps the CLI's trainer
        out = fit(self, *args, **kw)
        fits.append((self, out))
        return out

    try:
        reset_counters()
        with mock.patch.object(Trainer, "fit", spy):
            loss = train_cli.main(["--arch", "shapenet-bsa", "--steps", "3", "--batch", "8",
                                   "--ckpt", str(ckpt)])
        torch.cuda.synchronize()
        launches = {name: c.n for name, c in COUNTERS.items()}
        trainer, (model, opt_state) = fits[0]
        n_layers = trainer.api.mcfg.n_layers
        check_launches(launches, "trainer", 3 * n_layers)
        check(math.isfinite(loss) and latest_step(ckpt) == 2 and opt_state["step"] == 3,
              f"trainer: loss {loss}, checkpoint {latest_step(ckpt)}, "
              f"steps {opt_state['step']} after 3 steps")
        again = Trainer(trainer.api, trainer.cfg, device=dev)
        model2, opt2 = again.init_state()
        model2, opt2, done = again.maybe_restore(model2, opt2)
        saved = {"params": dict(model.named_parameters()), "m": opt_state["m"],
                 "v": opt_state["v"]}
        restored = {"params": dict(model2.named_parameters()), "m": opt2["m"],
                    "v": opt2["v"]}
        same = all(torch.equal(restored[k][n], t) for k in saved for n, t in saved[k].items())
        check(done == 2 and opt2["step"] == 3 and same,
              f"trainer: restored step {done}, optimizer step {opt2['step']}, bits equal "
              f"{same}")
        reset_counters()
        model2, opt2 = again.fit(iter(next_batches), steps=len(next_batches), model=model2,
                                 opt_state=opt2, start_step=done)
        torch.cuda.synchronize()
        resumed = {name: c.n for name, c in COUNTERS.items()}
        check_launches(resumed, "trainer_resume", len(next_batches) * n_layers)
        loss2 = again.metrics_history[-1]["loss"]
        check(opt2["step"] == 5 and latest_step(ckpt) == 3 and math.isfinite(loss2)
              and [m["step"] for m in again.metrics_history] == [2, 3],
              f"trainer resume: optimizer step {opt2['step']}, checkpoint "
              f"{latest_step(ckpt)}, loss {loss2}, logged steps "
              f"{[m['step'] for m in again.metrics_history]}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    stats = {"arch": "shapenet-bsa", "loss": [m["loss"] for m in trainer.metrics_history],
             "step_s": [m["step_time_s"] for m in trainer.metrics_history],
             "wall_s": trainer.wall_time, "restored_step": done, "bits_equal": same,
             "resumed_loss": loss2, "resumed_optimizer_step": opt2["step"],
             "launches": launches, "resumed_launches": resumed,
             "seconds": time.perf_counter() - t0}
    print(json.dumps({"trainer": stats}), flush=True)
    print(f"# trainer phase: {stats['seconds']:.1f} s", flush=True)
    return stats


# ---------------------------------------------------------------------------
# the sharded phase: ranks on one card, a gloo group over localhost
# ---------------------------------------------------------------------------

# ranks of each case: shapenet's balls of 256 split at p = 3 (1,280 rows, 5
# balls a rank) and not at p = 2 (1,920 rows: the ball op falls back, which
# the packed case checks); tinyllama's 4,096 tokens split at p = 2
SHARDED_P = {"padded": 3, "packed": 2, "lm": 2, "dp_train": 4, "remat_lm": 2,
             "pipeline_compress": 2, "tp_train": 2}
SHARDED_TIMEOUT_S = 300                 # a rank's wait in one collective
# the padded case's depth: 6 of shapenet-bsa's 18 layers (full depth before
# the training cases across ranks needed the run's time)
SHARDED_PADDED_LAYERS = 6
SHARDED_LM_SLOTS, SHARDED_LM_NEW = 4, 8


class CollectiveCount:
    """Counts the sharded ops' collectives by kind (``comm.all_gather`` and
    ``comm.rotate_plain``, which every other collective goes through)."""

    def __init__(self):
        from repro_torch.distributed import comm
        self.comm, self.n = comm, {"all_gather": 0, "rotate": 0}
        self.gathered_bytes = 0               # the all-gathers' inputs, this rank's
        self._orig = (comm.all_gather, comm.rotate_plain)

    def __enter__(self):
        gather, rot = self._orig

        def counted_gather(x, ax):
            self.n["all_gather"] += 1
            self.gathered_bytes += x.numel() * x.element_size()
            return gather(x, ax)

        def counted_rotate(x, ax, **kw):
            self.n["rotate"] += 1
            return rot(x, ax, **kw)
        self.comm.all_gather, self.comm.rotate_plain = counted_gather, counted_rotate
        return self

    def __exit__(self, *exc):
        self.comm.all_gather, self.comm.rotate_plain = self._orig


def rank_digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def same_on_every_rank(digest: str, ax) -> bool:
    from repro_torch.distributed import comm
    mine = torch.frombuffer(bytearray(bytes.fromhex(digest)), dtype=torch.uint8)
    return all(torch.equal(t, mine) for t in comm.all_gather(mine, ax))


def differing_on_ranks(tensors: dict, ax) -> list[str]:
    """The names of ``tensors`` whose bits are not the same on every rank
    of ``ax`` (a collective: every rank calls it)."""
    return [n for n, t in tensors.items() if not same_on_every_rank(rank_digest([t]), ax)]


def sharded_padded_case(dev, mesh, inputs, res) -> None:
    """shapenet-bsa at full width, ``SHARDED_PADDED_LAYERS`` of its layers:
    loss and every parameter gradient through the sharded backend on 8
    padded clouds (the main path), equal bits on every rank and over two
    calls, then every layer held to the unsharded kernel path
    (``train_reference_check``)."""
    from repro_torch.distributed import mesh_context
    api = model_api(get_config("shapenet-bsa").scaled(n_layers=SHARDED_PADDED_LAYERS))
    cfg = api.mcfg
    model = api.init(seed=0, device=dev)
    batch = {k: v.to(dev) for k, v in inputs["padded"].items()}
    params = [p for p in model.parameters() if p.requires_grad]

    def step():
        with mesh_context(mesh), use_backend("sharded"):
            loss, _ = api.loss(model, batch)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            return loss, [g for g in grads if g is not None]   # φ_q feeds only top-k
    torch.cuda.synchronize()
    with CollectiveCount() as cc:
        reset_counters()                                 # just before the main path
        t0 = time.perf_counter()
        loss, grads = step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res["launches"] = {name: c.n for name, c in COUNTERS.items()}  # just after it
    check_launches(res["launches"], "sharded_padded", cfg.n_layers)
    check(bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in grads),
          "sharded shapenet-bsa: non-finite loss or gradient")
    digest = rank_digest(grads)
    _, again = step()
    ax = mesh.axis_group("data")
    res.update(loss=float(loss.detach()), step_s=wall, collectives=cc.n,
               bits_equal_across_calls=rank_digest(again) == digest,
               bits_equal_across_ranks=same_on_every_rank(digest, ax),
               peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    check(res["bits_equal_across_calls"], "sharded gradients differ between two calls")
    check(res["bits_equal_across_ranks"], "sharded gradients differ between ranks")
    with mesh_context(mesh), contextlib.redirect_stdout(io.StringIO()) as buf:
        st = train_reference_check(model, cfg, batch, backends=("sharded", "kernels"))
    if mesh.rank == 0:
        print(buf.getvalue(), end="", flush=True)
    res["hold"] = {k: st[k] for k in ("forward_max_abs_diff", "worst", "max_abs_diff",
                                      "tensors_compared")}


def sharded_packed_case(dev, mesh, inputs, res) -> None:
    """shapenet-bsa's packed serving through ``GeometryEngine(backend=
    "sharded")`` (the main path: LPT segment sharding, one output gather a
    branch and no other collective), held layer by layer and end to end to
    the unsharded kernel engine; the ball op's fallback at p = 2; the
    quickstart's section 7 on the card."""
    from repro_torch.distributed import mesh_context
    from repro_torch.launch import quickstart
    api = model_api(get_config("shapenet-bsa"))
    cfg = api.mcfg
    model = api.init(seed=0, device=dev)
    clouds = inputs["clouds"]

    def engine(backend):
        return GeometryEngine(api, model, batch_slots=B, pad_to=CAPACITY, layout="packed",
                              backend=backend)
    with mesh_context(mesh):
        eng = engine("sharded")
    eng.predict(clouds)                                  # warm-up
    torch.cuda.synchronize()
    with CollectiveCount() as cc:
        reset_counters()                                 # just before the main path
        t0 = time.perf_counter()
        outs = eng.predict(clouds)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        res["launches"] = {name: c.n for name, c in COUNTERS.items()}  # just after it
    check_launches(res["launches"], "sharded_packed", cfg.n_layers)
    # each of the three branches gathers its output once a layer, and that is all
    check(cc.n == {"all_gather": 3 * cfg.n_layers, "rotate": 0},
          f"packed sharded serving: collectives {cc.n}, expected "
          f"{3 * cfg.n_layers} output gathers and nothing else")
    free_ref = engine("kernels").predict(clouds)
    with mesh_context(mesh), contextlib.redirect_stdout(io.StringIO()) as buf:
        st = reference_check(eng, model, cfg, clouds, outs, free_ref,
                             backends=("sharded", "kernels"))
    if mesh.rank == 0:
        print(buf.getvalue(), end="", flush=True)
    diff = max(float(np.abs(a - b).max()) for a, b in zip(outs, free_ref))
    beyond = sum(int((np.abs(a - b) > 1e-3 * (1 + np.abs(b))).sum())
                 for a, b in zip(outs, free_ref))
    res.update({"predict_s": wall, "collectives": cc.n, "output_max_abs_diff": diff,
                "output_points_beyond_1e-3": beyond,
                "layer_max_abs_diff": st["per_layer_max_abs_diff"],
                "points": sum(len(o) for o in outs)})
    check(beyond == 0, f"packed sharded serving vs the unsharded kernel engine: {beyond} "
                       f"points beyond 1e-3 (max {diff})")

    # p = 2 does not split shapenet's balls of 256: the op warns and falls back
    from repro_torch.core.backend import get_backend
    from repro_torch.distributed.sharded_backend import reset_warnings
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((2, N, H, D), generator=g, device=dev) for _ in range(3))
    reset_warnings()
    with mesh_context(mesh), warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = get_backend("sharded").ball(q, k, v, None, ball_size=BALL)
    res["ball_fallback_warning"] = [str(r.message) for r in rec if "falls back" in str(
        r.message)]
    check(len(res["ball_fallback_warning"]) == 1 and "granule" in res[
        "ball_fallback_warning"][0], f"ball at p = 2: no fallback warning ({rec})")
    check(torch.equal(got, get_backend("kernels").ball(q, k, v, None, ball_size=BALL)),
          "ball at p = 2: the fallback differs from the kernels backend")
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        quickstart.main([])
    res["quickstart_section_7"] = "sharded over 2 ranks == single-device: OK" in buf.getvalue()
    check(res["quickstart_section_7"], "quickstart section 7 did not run on two ranks")


def sharded_lm_case(dev, mesh, inputs, res) -> None:
    """tinyllama-1.1b at full width, ``SERVE_LM_LAYERS`` of its layers: a
    4,096-token prefill through the sharded backend (the main path), held
    layer by layer to the unsharded kernel path; then paged serving through
    ``ServingEngine(backend="sharded")`` on row-partitioned pools (the main
    path of the decode), against the unsharded engine."""
    from repro_torch.distributed import mesh_context
    api = model_api(get_config(LM).scaled(n_layers=SERVE_LM_LAYERS))
    cfg = api.mcfg
    model = api.init(seed=0, device=dev)
    batch = api.make_batch(np.random.default_rng(0), 1, 4096, device=dev)
    step = make_prefill_step(api)
    with mesh_context(mesh), use_backend("sharded"):
        step(model, batch)                               # warm-up
        torch.cuda.synchronize()
        with CollectiveCount() as cc:
            reset_counters()                             # just before the main path
            t0 = time.perf_counter()
            logits = step(model, batch)
            torch.cuda.synchronize()
            res["prefill_s"] = time.perf_counter() - t0
            res["prefill_launches"] = {n: c.n for n, c in COUNTERS.items()}  # just after
    res["prefill_collectives"] = cc.n
    check_launches(res["prefill_launches"], "sharded_prefill", cfg.n_layers)
    want = step(model, batch)                            # unsharded, kernels
    res["prefill_logits_max_abs_diff"] = float((logits - want).abs().max())
    check(bool(torch.isfinite(logits).all()), "sharded prefill: non-finite logits")
    with mesh_context(mesh), contextlib.redirect_stdout(io.StringIO()) as buf:
        st = prefill_reference_check(model, cfg, embed_input(api, model, batch),
                                     backends=("sharded", "kernels"))
    if mesh.rank == 0:
        print(buf.getvalue(), end="", flush=True)
    res["prefill_hold"] = {"rel_by_layer": st["rel_by_layer"]}

    res["serve"] = sharded_serve_lm(api, model, mesh, inputs["lm_prompts"])


def sharded_serve_lm(api, model, mesh, prompts) -> dict:
    """Paged serving of ``prompts`` one step at a time (EOS −1: never
    sampled) on the unsharded kernel engine, then through
    ``ServingEngine(backend="sharded")`` on row-partitioned pools (the main
    path), teacher-forced with the unsharded engine's samples so both run
    one schedule: at every step and slot the sharded argmax must equal the
    unsharded sample unless the unsharded top-two logit gap is under
    ``NEAR_TIE`` of its largest |logit|."""
    from repro_torch.distributed import mesh_context
    kw = dict(batch_slots=SHARDED_LM_SLOTS, max_len=MAX_LEN, paged=True, page=PAGE)
    ref = ServingEngine(api, model, backend="kernels", **kw)
    rec = []
    sample = ref._sample

    def keep(logits):
        t = sample(logits)
        rec.append((logits.float().cpu(), t.cpu()))
        return t
    ref._sample = keep
    want = ref.serve(prompts, SHARDED_LM_NEW, eos_id=-1)
    with mesh_context(mesh):
        eng = ServingEngine(api, model, backend="sharded", **kw)
    it, rows = iter(rec), []

    def forced(logits):
        lg, t = next(it)
        mine = logits.float().cpu()
        top2 = torch.topk(lg, 2, dim=-1).values
        tie = (top2[:, 0] - top2[:, 1]) < NEAR_TIE * lg.abs().amax(-1)
        apart = mine.argmax(-1) != t.long()
        rows.append((int(apart.sum()), int((apart & ~tie).sum()),
                     float((mine - lg).abs().max() / lg.abs().max())))
        return t.to(logits.device)
    eng._sample = forced
    torch.cuda.synchronize()
    reset_counters()                                     # just before the main path
    t0 = time.perf_counter()
    got = eng.serve(prompts, SHARDED_LM_NEW, eos_id=-1)  # outside the with-block
    torch.cuda.synchronize()
    stats = {"serve_s": time.perf_counter() - t0,
             "launches": {n: c.n for n, c in COUNTERS.items()},   # just after it
             "steps": eng.serve_steps, "cow_copies": eng.kv.cow_copies,
             "pool_rows": int(eng.caches[0]["pos0"]["k"].shape[0]),
             "num_blocks": eng.num_blocks, "argmax_apart": sum(r[0] for r in rows),
             "apart_not_near_tie": sum(r[1] for r in rows),
             "max_rel_logit_diff": max(r[2] for r in rows)}
    eng.kv.check()
    check_launches(stats["launches"], "sharded_serve_lm",
                   DECODE_GATHERS * api.mcfg.n_layers * eng.serve_steps)
    check(len(rows) == len(rec) and all(np.array_equal(a, b) for a, b in zip(got, want)),
          f"teacher-forced serving: {len(rows)} steps vs {len(rec)}, or other tokens")
    check(eng.kv.cow_copies >= 1, "sharded serving made no copy-on-write")
    check(stats["apart_not_near_tie"] == 0,
          f"sharded decode picks another token than the unsharded one away from a "
          f"near-tie: {stats}")
    return stats


# training across ranks: Trainer(mesh=...), remat under a mesh, the pipeline
# and the int8 reduction
DP_STEPS = 3                            # 1 + 2 steps on the (2, 2) mesh, a save at the last
DP_HOLD = 1e-5                          # of the largest |value|, against one rank
# a step from one shared state: of the (group, head)s whose picks the one
# rank replays from the mesh step, the share where its own top-k picks
# differ (4 of 517,248 padded, 6 of 462,240 packed on an H100: near-ties
# that the head split rounds otherwise); a fault in the split selection
# (φ, the score sums, the gates' heads) moves far more
PICKS_FLIP_TOL = 1e-4
# paper App. A settings, as the train phases (lr 1e-3 from the first step
# sends the loss from 1.8 to 4.9, where AdamW's normalised update turns the
# reduced gradient's rounding into 9.5e-5 of the largest parameter)
DP_TRAIN = dict(base_lr=1e-3, weight_decay=0.01, total_steps=300, warmup_steps=30,
                log_every=1)
PIPE_STAGES, PIPE_MICRO, PIPE_CLOUDS = 2, 4, 2
COMPRESS_TOL = 2e-2                     # tests/test_distributed.py's int8 bound


def _rel(got: torch.Tensor, want: torch.Tensor, floor: float = 0.0) -> float:
    """max |got − want| over max(max |want|, floor)."""
    den = max(float(want.abs().max()), floor)
    return float((got.float() - want.float()).abs().max()) / den if den else 0.0


@torch.no_grad()
def _params_rel(got: dict, want: dict) -> tuple[float, str]:
    """(the parameters' largest difference over their largest |value|, the
    parameter where it is)."""
    big = max(float(t.abs().max()) for t in want.values())
    diff, name = max((float((got[n].float() - t.float()).abs().max()), n)
                     for n, t in want.items())
    return diff / big, name


def _rank0_only(mesh, fn):
    """``fn()`` on rank 0 while the others wait; its result on rank 0, None
    elsewhere."""
    from repro_torch.distributed import comm
    out = fn() if mesh.rank == 0 else None
    comm.all_gather(torch.zeros(1), mesh.axis_group("data"))   # the others wait here
    return out


class _Topk:
    """``torch`` as ``core.nsa_causal`` sees it, with ``topk`` replaced
    (the causal selection's top-k* over its final scores)."""

    def __init__(self, topk):
        self.topk = topk

    def __getattr__(self, name):
        return getattr(torch, name)


class HeldPicks:
    """Holds the one-rank side of a step to the selection picks of the step
    across ranks, as ``HeldRouting`` holds an MoE routing: under ``record``
    each BSA layer's valid picks are kept (this rank's groups and heads;
    the non-causal selection's and the causal one's, in call order);
    :meth:`masks` gathers them over the mesh into the whole batch's, and
    under ``replay`` each layer's scores rank those blocks first (the
    blocks that are valid on this side too).  The products of a rank's
    heads round otherwise than the whole layer's, and top-k over nearly
    tied scores is discontinuous: a flipped block moves the step by more
    than any rounding does."""

    def __init__(self):
        self.picks = []

    @contextlib.contextmanager
    def record(self):
        from repro_torch.core import bsa as bsa_core
        scores = bsa_core._selection_scores

        def recorded(*args, **kw):
            s = scores(*args, **kw)
            vals, idx = torch.topk(s, min(args[5].top_k, s.shape[-1]), dim=-1)
            self.picks.append((idx, vals > NEG_INF / 2, s.shape[-1]))
            return s

        def causal_topk(s, k, dim=-1):
            vals, idx = torch.topk(s, k, dim=dim)
            self.picks.append((idx, vals > NEG_INF / 2, s.shape[-1]))
            return vals, idx
        with mock.patch.object(bsa_core, "_selection_scores", recorded), \
                mock.patch.object(nsa_causal, "torch", _Topk(causal_topk)):
            yield

    def masks(self, mesh22, T: int, nb: int, rows=None, n_kv: int | None = None) -> list:
        """Each layer's (B, G, Hkv, blocks) bool mask of the whole batch's
        picks (the blocks its scores ranked): the kv heads gathered over
        ``model`` (where ranks share a kv head, ``n_kv`` of them in all, one
        rank's picks of it: theirs are the same, their scores summed over
        ``model``), the batch over ``data``; ``rows``, for a packed batch
        (B = 1, T rows, nb blocks), each data rank's global row of each of
        its rows (T for a padding row), whose groups and blocks are mapped
        to the whole axis's."""
        from repro_torch.distributed import comm
        out = []
        for idx, ok, blocks in self.picks:
            idx = idx.masked_fill(~ok, -1)
            kv = comm.all_gather(idx.contiguous(), mesh22.axis_group("model"))
            share = len(kv) * idx.shape[2] // (n_kv or len(kv) * idx.shape[2])
            idx = torch.cat(kv[::share], 2)
            parts = comm.all_gather(idx.contiguous(), mesh22.axis_group("data"))
            if rows is None:
                idx = torch.cat(parts, 0)
                out.append((F.one_hot(idx.clamp(min=0), blocks).bool()
                            & (idx >= 0)[..., None]).any(-2))
                continue
            g = len(rows[0]) // parts[0].shape[1]          # rows a group
            ell = T // nb
            mask = torch.zeros((1, T // g, idx.shape[2], nb), dtype=torch.bool,
                               device=idx.device)
            for part, r in zip(parts, rows):
                r = torch.as_tensor(r, device=idx.device)
                g0 = r[torch.arange(part.shape[1], device=idx.device) * g]       # (G_l,)
                blocks = r[part.clamp(min=0) * ell]
                keep = (part >= 0) & (blocks < T) & (g0 < T)[None, :, None, None]
                hot = (F.one_hot(torch.where(keep, blocks // ell, 0), nb).bool()
                       & keep[..., None]).any(-2)[0]                          # (G_l, H, nb)
                live = g0 < T
                mask[0, g0[live] // g] |= hot[live]
            out.append(mask)
        self.picks = []
        return out

    @contextlib.contextmanager
    def replay(self, masks: list):
        """Under it, each layer's scores rank the held blocks first;
        ``flipped`` counts the (group, head)s whose own picks differed."""
        from repro_torch.core import bsa as bsa_core
        scores, left = bsa_core._selection_scores, list(masks)
        self.flipped = self.groups = 0

        def held_first(s, k, mask):
            held = left.pop(0) & (s > NEG_INF / 2)
            vals, own = torch.topk(s, k, dim=-1)
            mine = (F.one_hot(own, s.shape[-1]).bool() & (vals > NEG_INF / 2)[..., None]).any(-2)
            G = s.shape[1]                             # groups with a real query only
            live = (torch.ones(s.shape[:2], dtype=torch.bool, device=s.device) if mask is None
                    else mask.reshape(mask.shape[0], G, -1).any(-1))
            self.flipped += int(((mine != held).any(-1) & live[..., None]).sum())
            self.groups += int(live.sum()) * s.shape[2]
            return torch.where(held, -NEG_INF, s)

        def replayed(*args, **kw):
            s = scores(*args, **kw)
            return held_first(s, min(args[5].top_k, s.shape[-1]), args[4])

        def causal_topk(s, k, dim=-1):                 # the LM batches here have no mask
            return torch.topk(held_first(s, k, None), k, dim=dim)
        with mock.patch.object(bsa_core, "_selection_scores", replayed), \
                mock.patch.object(nsa_causal, "torch", _Topk(causal_topk)):
            yield


def dp_train_case(dev, mesh, inputs, res) -> None:
    """shapenet-bsa at full width and depth through ``Trainer(mesh=...)``
    on a (2, 2) ("data", "model") mesh (the main path): 1 + 2 steps of 8
    padded clouds (4 a data rank), a checkpoint at the last, then one
    packed step; losses and parameters held to the single-rank ``Trainer``
    on the same seed and batches (rank 0 runs it; free-running, at
    ``LAYER_TOL``), then a padded and a packed step from the same state each
    way (this mesh's, gathered) held at ``DP_HOLD`` (loss, gradient norm,
    parameters; the one rank replays the mesh step's picks, ``HeldPicks``,
    and its own differ in at most ``PICKS_FLIP_TOL`` of them); parameters equal in bits on every rank, each rank's AdamW
    moment bytes beside one rank's.  Then a restore on a (4,) ("data",) mesh
    and one step, held to the single-rank ``Trainer`` resumed from the same
    checkpoint at ``DP_HOLD``."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import Trainer, TrainerConfig
    api = model_api(get_config("shapenet-bsa"))
    n_layers = api.mcfg.n_layers
    padded, packed = inputs["dp_padded"], inputs["dp_packed"]
    cfg = TrainerConfig(**DP_TRAIN, ckpt_dir=str(ROOT / "build" / "sharded" / "dp_ckpt"))
    quiet = contextlib.redirect_stdout(io.StringIO())
    ax = mesh.axis_group("data")                         # every rank
    mesh22 = make_mesh((2, 2), ("data", "model"))
    tr = Trainer(api, cfg, mesh=mesh22, device=dev)
    model, opt = tr.init_state()
    res["paths"] = {}
    with use_backend("kernels"), quiet:
        torch.cuda.synchronize()
        with CollectiveCount() as cc:
            reset_counters()                             # just before the main path
            t0 = time.perf_counter()
            model, opt = tr.fit(iter(padded[:DP_STEPS]), steps=DP_STEPS, model=model,
                                opt_state=opt)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            res["paths"]["dp_train"] = {n: c.n for n, c in COUNTERS.items()}  # just after
        steps = list(tr.metrics_history)
        reset_counters()                                 # the packed step: its own path
        model, opt = tr.fit(iter([packed]), steps=1, model=model, opt_state=opt,
                            start_step=DP_STEPS)
        torch.cuda.synchronize()
        res["paths"]["dp_train_packed"] = {n: c.n for n, c in COUNTERS.items()}
    check_launches(res["paths"]["dp_train"], "dp_train", n_layers * DP_STEPS)
    check_launches(res["paths"]["dp_train_packed"], "dp_train_packed", n_layers)
    losses = [m["loss"] for m in steps] + [tr.metrics_history[-1]["loss"]]
    params = {n: p.detach() for n, p in model.named_parameters()}
    res.update(mesh=str(mesh22.shape), loss=losses, step_s=[m["step_time_s"] for m in steps],
               packed_step_s=tr.metrics_history[-1]["step_time_s"], wall_s=wall,
               collectives_a_step={k: v / DP_STEPS for k, v in cc.n.items()},
               gathered_bytes_a_step=cc.gathered_bytes / DP_STEPS,
               moment_bytes=tr.moment_bytes(opt),
               bits_equal_across_ranks=same_on_every_rank(rank_digest(params.values()), ax))
    if not res["bits_equal_across_ranks"]:
        res["differing"] = differing_on_ranks(params, ax)
    check(res["bits_equal_across_ranks"],
          f"dp_train: parameters differ between ranks: {res.get('differing', [])[:12]}")
    check(all(math.isfinite(x) for x in losses), f"dp_train: losses {losses}")

    def one_rank():
        ref = Trainer(api, TrainerConfig(**DP_TRAIN), device=dev)
        m, o = ref.init_state()
        with use_backend("kernels"), contextlib.redirect_stdout(io.StringIO()):
            m, o = ref.fit(iter(padded[:DP_STEPS]), steps=DP_STEPS, model=m, opt_state=o)
            m, o = ref.fit(iter([packed]), steps=1, model=m, opt_state=o, start_step=DP_STEPS)
        want = [x["loss"] for x in ref.metrics_history]
        rel, where = _params_rel(params, dict(m.named_parameters()))
        return {"loss": want, "moment_bytes": ref.moment_bytes(o),
                "loss_rel": max(abs(a - b) / abs(b) for a, b in zip(losses, want)),
                "param_rel": rel, "param_rel_at": where}
    ref = _rank0_only(mesh, one_rank)
    if ref is not None:
        # free-running, rounding compounds through AdamW's normalised steps
        # and top-k: held at the whole-model tolerance the port meets against
        # JAX's step; the step-by-step holds below are the 1e-5 ones
        res["one_rank"] = ref
        check(ref["loss_rel"] <= LAYER_TOL and ref["param_rel"] <= LAYER_TOL,
              f"dp_train vs one rank, free-running: {ref}")
        # ZeRO-1 over data and the Megatron dims over model: about a quarter
        check(3 * res["moment_bytes"] < ref["moment_bytes"],
              f"dp_train: moment bytes {res['moment_bytes']} vs one rank's "
              f"{ref['moment_bytes']}")

    # one step each way from the same state (this mesh's, gathered), held
    # to one rank's at DP_HOLD: loss, gradient norm, parameters; the one
    # rank takes the mesh step's selection picks (HeldPicks: its heads are
    # split over "model", whose products round otherwise)
    res["same_state"] = {}
    for layout, batch in (("padded", padded[DP_STEPS]), ("packed", packed)):
        full = tr.full_state(model, opt)                 # live tensors where whole
        full = {"params": {n: t.detach().clone() for n, t in full["params"].items()},
                "opt": {"step": full["opt"]["step"],
                        **{key: {n: t.clone() for n, t in full["opt"][key].items()}
                           for key in ("m", "v")}}}
        k = opt["step"]
        picks = HeldPicks()
        with use_backend("kernels"), contextlib.redirect_stdout(io.StringIO()), \
                picks.record():
            model, opt = tr.fit(iter([batch]), steps=1, model=model, opt_state=opt,
                                start_step=k)
        got = tr.metrics_history[-1]
        after = {n: p.detach() for n, p in model.named_parameters()}
        rows, T = None, batch["feats"].shape[1]
        if layout == "packed":                 # each data rank's rows of the packed axis
            from repro_torch.distributed import ring
            offsets = tuple(int(o) for o in np.asarray(batch["offsets"]))
            plan = ring.plan_segments(offsets, mesh22.shape["data"])
            idx = ring.axis_layout(plan, offsets, T, api.mcfg.bsa.ball_size)[0]
            rows = list(idx.reshape(mesh22.shape["data"], -1).astype(np.int64))
        masks = picks.masks(mesh22, T, T // api.mcfg.bsa.cmp_block, rows)

        def one_step(full=full, batch=batch, got=got, after=after, masks=masks):
            one = Trainer(api, TrainerConfig(**DP_TRAIN), device=dev)
            m = api.init(seed=0, device=dev)
            with torch.no_grad():
                for n, p in m.named_parameters():
                    p.copy_(full["params"][n])
            o = full["opt"]
            held = HeldPicks()
            with use_backend("kernels"), contextlib.redirect_stdout(io.StringIO()), \
                    held.replay(masks):
                m, _ = one.fit(iter([batch]), steps=1, model=m, opt_state=o)
            want = one.metrics_history[-1]
            rel, where = _params_rel(after, dict(m.named_parameters()))
            return {"loss_rel": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
                    "grad_norm_rel": abs(got["grad_norm"] - want["grad_norm"])
                    / abs(want["grad_norm"]), "param_rel": rel, "param_rel_at": where,
                    "picks_flipped": held.flipped, "picks_held": held.groups}
        held = _rank0_only(mesh, one_step)
        if held is not None:
            res["same_state"][layout] = held
            check(max(held["loss_rel"], held["grad_norm_rel"], held["param_rel"]) <= DP_HOLD,
                  f"dp_train {layout} step from the same state vs one rank: {held}")
            check(held["picks_held"] > 0
                  and held["picks_flipped"] <= PICKS_FLIP_TOL * held["picks_held"],
                  f"dp_train {layout}: the one rank's own selection picks differ from the "
                  f"mesh step's in {held['picks_flipped']} of {held['picks_held']} "
                  f"(group, head)s, above {PICKS_FLIP_TOL}")

    # elastic: the step-2 checkpoint restored on (4,) ("data",)
    mesh4 = make_mesh((4,), ("data",))
    tr4 = Trainer(api, cfg, mesh=mesh4, device=dev)
    m4, o4 = tr4.init_state()
    m4, o4, step0 = tr4.maybe_restore(m4, o4)
    check(step0 == DP_STEPS - 1 and o4["step"] == DP_STEPS,
          f"dp_train restore on (4,): step {step0}, optimizer step {o4['step']}")
    restored = tr4.full_state(m4, o4)                    # live tensors where whole
    restored = [t.detach().clone() for t in (*restored["params"].values(),
                                             *restored["opt"]["m"].values(),
                                             *restored["opt"]["v"].values())]
    with use_backend("kernels"), contextlib.redirect_stdout(io.StringIO()):
        reset_counters()
        m4, o4 = tr4.fit(iter(padded[DP_STEPS:DP_STEPS + 1]), steps=1, model=m4,
                         opt_state=o4, start_step=step0)
        torch.cuda.synchronize()
        res["paths"]["dp_resume"] = {n: c.n for n, c in COUNTERS.items()}
    check_launches(res["paths"]["dp_resume"], "dp_resume", n_layers)
    resumed = {n: p.detach() for n, p in m4.named_parameters()}
    res["resumed"] = {"mesh": str(mesh4.shape), "loss": tr4.metrics_history[-1]["loss"],
                      "step_s": tr4.metrics_history[-1]["step_time_s"],
                      "moment_bytes": tr4.moment_bytes(o4)}

    def resumed_one_rank():
        ref = Trainer(api, cfg, device=dev)
        m, o = ref.init_state()
        m, o, s0 = ref.maybe_restore(m, o)
        same = all(torch.equal(a, b) for a, b in zip(restored, (
            *dict(m.named_parameters()).values(), *o["m"].values(), *o["v"].values())))
        batch = {k: v.to(dev) for k, v in padded[DP_STEPS].items()}
        with use_backend("kernels"):                     # 2 clouds (a rank's) against 8
            two = api.forward(m, {k: v[:2] for k, v in batch.items()})
            eight = api.forward(m, batch)[:2]
        with use_backend("kernels"), contextlib.redirect_stdout(io.StringIO()):
            m, _ = ref.fit(iter(padded[DP_STEPS:DP_STEPS + 1]), steps=1, model=m, opt_state=o,
                           start_step=s0)
        want = ref.metrics_history[-1]["loss"]
        rel, where = _params_rel(resumed, dict(m.named_parameters()))
        return {"restored_bits_equal": same, "loss": want,
                "forward_2_vs_8_clouds_max_abs_diff": float((two - eight).abs().max()),
                "loss_rel": abs(res["resumed"]["loss"] - want) / abs(want),
                "param_rel": rel, "param_rel_at": where}
    ref = _rank0_only(mesh, resumed_one_rank)
    if ref is not None:
        # the restore is exact; the step after it runs 2 clouds a rank, whose
        # products round otherwise than 8's and can flip a near-tie of the
        # top-k (1.8e-5 of the loss on an H100): free-running's hold
        res["resumed"]["one_rank"] = ref
        check(ref["restored_bits_equal"], "dp_train: the restore on (4,) differs from one "
                                          "rank's restore of the same checkpoint")
        check(ref["loss_rel"] <= LAYER_TOL and ref["param_rel"] <= LAYER_TOL,
              f"dp_train resumed on (4,) vs one rank: {ref}")


def remat_lm_case(dev, mesh, inputs, res) -> None:
    """tinyllama-1.1b at full width, 2 layers, remat on: one train step of 2
    × 4,096 tokens under ``mesh_context`` and the ``"sharded"`` backend (the
    main path; the backward, with the periods' recompute, runs on autograd's
    device thread), held to remat off on the same ranks and (rank 0) to the
    unsharded kernel path."""
    from repro_torch.distributed import mesh_context
    rng = np.random.default_rng(3)
    cfg = get_config(LM).scaled(n_layers=2)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (TRAIN_LM_B, TRAIN_LM_N),
                                         dtype=np.int32)).to(dev)
    batch = {"tokens": toks, "labels": toks}
    grads, res["paths"] = {}, {}
    for remat in (True, False):
        api = model_api(cfg.scaled(remat=remat))
        model = api.init(seed=0, device=dev)
        torch.cuda.synchronize()
        with CollectiveCount() as cc:
            reset_counters()                             # just before the main path
            t0 = time.perf_counter()
            with mesh_context(mesh), use_backend("sharded"):
                loss, _ = api.loss(model, batch)
                loss.backward()
            torch.cuda.synchronize()
            launches = {n: c.n for n, c in COUNTERS.items()}             # just after it
        grads[remat] = (float(loss.detach()), {n: p.grad for n, p in model.named_parameters()
                                               if p.grad is not None})
        res[f"remat_{remat}"] = {"loss": grads[remat][0], "step_s": time.perf_counter() - t0,
                                 "collectives": cc.n}
        if remat:
            res["paths"]["remat_lm"] = launches
            check_launches(launches, "remat_lm", cfg.n_layers,
                           per_forward_kernel=2 * cfg.n_layers)
    (loss_on, on), (loss_off, off) = grads[True], grads[False]
    check(sorted(on) == sorted(off), "remat_lm: remat on and off reach other parameters")
    big = max(float(g.abs().max()) for g in off.values())
    res["remat_vs_off"] = {"loss_equal": loss_on == loss_off,
                           "bits_equal": all(torch.equal(on[n], g) for n, g in off.items()),
                           "grad_rel": max(_rel(on[n], g, LM_GRAD_FLOOR * big)
                                           for n, g in off.items())}
    check(res["remat_vs_off"]["grad_rel"] <= 1e-3 and abs(loss_on - loss_off)
          <= 1e-3 * abs(loss_off), f"remat_lm: remat on vs off {res['remat_vs_off']}")

    def unsharded():
        api = model_api(cfg.scaled(remat=True))
        model = api.init(seed=0, device=dev)
        with use_backend("kernels"):
            loss, _ = api.loss(model, batch)
            loss.backward()
        want = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
        top = max(float(g.abs().max()) for g in want.values())
        loss = float(loss.detach())
        rel, where = max((_rel(on[n], g, LM_GRAD_FLOOR * top), n) for n, g in want.items())
        return {"loss_rel": abs(loss_on - loss) / abs(loss), "grad_rel": rel,
                "grad_rel_at": where}
    ref = _rank0_only(mesh, unsharded)
    if ref is not None:
        res["vs_unsharded_kernels"] = ref
        check(ref["loss_rel"] <= LM_LAYER_TOL and ref["grad_rel"] <= LM_GRAD_REL_TOL,
              f"remat_lm vs the unsharded kernel path: {ref}")


class _Block(torch.nn.Module):
    """One shapenet-bsa block as a module call, for ``functional_call``."""

    def __init__(self, layer, mcfg):
        super().__init__()
        self.layer, self.mcfg = layer, mcfg

    def forward(self, x):
        return pc_layer(self.layer, x, mcfg=self.mcfg)


def pipeline_compress_case(dev, mesh, inputs, res) -> None:
    """``pipeline_apply`` runs shapenet-bsa's 18 blocks as 2 stages of 9 over
    4 microbatches of 2 clouds of 3,840 real points (the main path), its
    output and gradients held (rank 0) to the blocks applied in sequence;
    then ``make_compressed_grad_fn`` over ("pod",) on the same model and 4
    clouds (the main path of the int8 reduction): the loss the mean of a
    forward of each pod's slice (rank 0), the gradients within ``COMPRESS_TOL`` of the exact sum, a non-zero
    residual."""
    from repro_torch.distributed import comm
    from repro_torch.distributed.pipeline import pipeline_apply
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.compress import make_compressed_grad_fn
    api = model_api(get_config("shapenet-bsa"))
    mcfg, per = api.mcfg, api.mcfg.n_layers // PIPE_STAGES
    model = api.init(seed=0, device=dev)
    block = _Block(model.layers[0], mcfg)
    names = [n for n, _ in model.layers[0].named_parameters()]
    stacked = {n: torch.stack([torch.stack([model.layers[s * per + j].get_parameter(n)
                                            for j in range(per)])
                               for s in range(PIPE_STAGES)]).detach()
               for n in names}                           # (2, 9, ...)
    g = torch.Generator(device=dev).manual_seed(5)
    n_clouds = PIPE_MICRO * PIPE_CLOUDS
    feats = torch.randn((n_clouds, N, mcfg.in_dim), generator=g, device=dev)
    with torch.no_grad():
        x0 = dense(model.embed, feats).reshape(PIPE_MICRO, PIPE_CLOUDS, N, mcfg.d_model)
    cot = torch.randn(x0.shape, generator=g, device=dev)

    def run(fn):
        params = {n: t.clone().requires_grad_() for n, t in stacked.items()}
        x = x0.clone().requires_grad_()
        with use_backend("kernels"):
            y = fn(params, x)
            (y * cot).sum().backward()
        return y.detach(), {n: t.grad if t.grad is not None else torch.zeros_like(t)
                            for n, t in params.items()}, x.grad   # φ_q: top-k only

    def stage_fn(p, h):
        for j in range(per):
            h = torch.func.functional_call(block, {f"layer.{n}": t[j] for n, t in p.items()},
                                           (h,))
        return h
    stage_mesh = make_mesh((PIPE_STAGES,), ("stage",))
    torch.cuda.synchronize()
    with CollectiveCount() as cc:
        reset_counters()                                 # just before the main path
        t0 = time.perf_counter()
        y, dp, dx = run(lambda p, x: pipeline_apply(stage_fn, p, x, mesh=stage_mesh))
        torch.cuda.synchronize()
        res["paths"] = {"pipeline": {n: c.n for n, c in COUNTERS.items()}}   # just after
    res["pipeline"] = {"wall_s": time.perf_counter() - t0, "collectives": cc.n,
                       "ticks": PIPE_MICRO + PIPE_STAGES - 1}
    check_launches(res["paths"]["pipeline"], "pipeline", per * PIPE_MICRO)
    ax = mesh.axis_group("data")
    res["pipeline"]["bits_equal_across_ranks"] = same_on_every_rank(
        rank_digest([y, dx, *dp.values()]), ax)
    check(res["pipeline"]["bits_equal_across_ranks"], "pipeline: ranks differ")

    def sequential():
        def apply(p, x):
            outs = []
            for m in range(PIPE_MICRO):
                h = x[m]
                for s in range(PIPE_STAGES):
                    h = stage_fn({n: t[s] for n, t in p.items()}, h)
                outs.append(h)
            return torch.stack(outs)
        wy, wdp, wdx = run(apply)
        top = max(float(t.abs().max()) for t in wdp.values())
        return {"out_rel": _rel(y, wy), "dx_rel": _rel(dx, wdx),
                "dparam_rel": max(_rel(dp[n], t, GRAD_REL_TOL * top) for n, t in wdp.items())}
    ref = _rank0_only(mesh, sequential)
    if ref is not None:
        res["pipeline"]["vs_sequential"] = ref
        check(max(ref.values()) <= DP_HOLD, f"pipeline vs the blocks in sequence: {ref}")

    pods = make_mesh((PIPE_STAGES,), ("pod",))
    batch = {"feats": feats[:4], "target": torch.randn((4, N, 1), generator=g, device=dev),
             "mask": torch.ones((4, N), dtype=torch.bool, device=dev)}
    fn = make_compressed_grad_fn(api.loss, pods, axis_name="pod")
    err = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    torch.cuda.synchronize()
    with CollectiveCount() as cc, use_backend("kernels"):
        reset_counters()                                 # just before the main path
        t0 = time.perf_counter()
        loss, grads, err = fn(model, batch, err)
        torch.cuda.synchronize()
        res["paths"]["compressed"] = {n: c.n for n, c in COUNTERS.items()}   # just after it
    check_launches(res["paths"]["compressed"], "compressed", mcfg.n_layers)
    pax = pods.axis_group("pod")
    wall = time.perf_counter() - t0
    with use_backend("kernels"):                         # the exact sum, for the hold
        mine = {k: comm.local_slice(v, pax, 0) for k, v in batch.items()}
        local_loss, _ = api.loss(model, mine)
        local = dict(zip(grads, torch.autograd.grad(local_loss, list(model.parameters()),
                                                    allow_unused=True)))
    local = {n: t if t is not None else torch.zeros_like(grads[n]) for n, t in local.items()}
    exact = {n: comm.all_reduce_sum(t, pax) / pax.size for n, t in local.items()}
    # an int8 block's error is at most half a step of its scale, max|block| / 127:
    # hold each tensor relative to the largest of the exact mean and the pods'
    # own gradients (the exact mean alone, where the pods' gradients cancel, is
    # reported beside it)
    summed = {n: comm.all_reduce_max(t.abs().amax().reshape(1), pax) for n, t in local.items()}
    top = max(float(t.abs().max()) for t in exact.values())
    res["compressed"] = {"wall_s": wall, "collectives": cc.n, "loss": float(loss),
                         "grad_rel": max(_rel(grads[n], t, max(float(summed[n]),
                                                                LM_GRAD_FLOOR * top))
                                         for n, t in exact.items()),
                         "grad_rel_of_exact": max(_rel(grads[n], t, LM_GRAD_FLOOR * top)
                                                  for n, t in exact.items()),
                         "residual_max": max(float(e.abs().max()) for e in err.values())}
    check(res["compressed"]["grad_rel"] <= COMPRESS_TOL and res["compressed"]["residual_max"] > 0,
          f"compressed reduction: {res['compressed']}")

    def loss_refs():
        # rank 0 alone: a forward of each pod's slice, whose mean the reported
        # loss must be (no collective between them: DP_HOLD), and the 4 clouds
        # in one forward, where 2 clouds a pod round otherwise on the card
        # (dp_train's forward_2_vs_8_clouds_max_abs_diff): the whole-model
        # tolerance
        n = batch["feats"].shape[0] // pax.size
        with use_backend("kernels"), torch.no_grad():
            pods = [api.loss(model, {k: v[i * n:(i + 1) * n] for k, v in batch.items()})[0]
                    for i in range(pax.size)]
            whole, _ = api.loss(model, batch)
        mean = float(sum(pods[1:], pods[0]) / pax.size)
        return {"loss_rel_pods": abs(float(loss) - mean) / abs(mean),
                "loss_rel_whole_batch": abs(float(loss) - float(whole)) / abs(float(whole))}
    ref = _rank0_only(mesh, loss_refs)
    if ref is not None:
        res["compressed"].update(ref)
        check(ref["loss_rel_pods"] <= DP_HOLD, f"compressed reduction: loss {ref} from a "
                                               f"forward of each pod's slice")
        check(ref["loss_rel_whole_batch"] <= LAYER_TOL,
              f"compressed reduction: loss {ref} from one forward of the 4 clouds")


# Megatron's compute over "model": 2 layers of each model at full width
# (seamless: 2 encoder + 2 decoder layers), 1 + 2 bf16 steps (tinyllama
# and qwen2-moe: B 2 x 4096 tokens, TRAIN_LM_B x TRAIN_LM_N; llava: its
# prefill shape, 512 image + 3,584 text tokens; seamless: 4,096 frames and
# 512 decoder tokens; mamba2: 1 x 4,096 tokens), then the holds
TP_LAYERS = 2
TP_ARCHS = {"tp_train": "tinyllama-1.1b", "tp_moe": "qwen2-moe-a2.7b", "tp_vlm": LLAVA,
            "tp_encdec": SEAMLESS, "tp_ssm": MAMBA}
TP_SCALED = {"tp_encdec": dict(n_layers=TP_LAYERS, n_encoder_layers=TP_LAYERS)}
TP_TRAIN = DP_TRAIN
TP_STEPS = 2
TP_HOLD = 1e-5              # fp32: the step's loss, gradient norm and gradients vs one rank
TP_GRAD_FLOOR = 1e-3        # a gradient's denominator, of the model's largest (φ_k.pos: 0)
# mamba's per-head vectors, whose gradients sum over every position with
# heavy cancellation: one rank's own fp32 ones lie up to 1.6e-4 / 2.4e-5 of
# their largest from a float64 step at the smoke size
# (tools/mamba_fp64_grads.py); the fp32 hold reports them, and a float64
# step, split and on one rank, holds them with every other gradient
TP_FP32_UNRESOLVED = ("mamba.A_log", "mamba.dt_bias")
# the paths whose fp32 step is held on its whole gradient (the relative L2
# difference, with the loss and the gradient norm) and not tensor by
# tensor: at llava's and seamless's widths on 4,096 positions a tensor's
# largest difference from one rank's reaches 1.2e-5 of its largest value
# with every selection pick held, 0 flipped, and the whole gradient's
# difference 6.9e-6–8.7e-6: fp32's rounding of sums over the positions,
# not the split (PERF.md §6); every other path is held on both
TP_FP32_WHOLE_ONLY = ("tp_vlm", "tp_encdec")


@contextlib.contextmanager
def held_moe_routing(routes: list, record: bool):
    """Record each MoE layer's experts (``record``) or replay them in order
    (``moe_apply(top_e=)``): both sides of a layer hold take one routing."""
    def recorded(p, x, mcfg, top_e=None):
        y, aux = moe_apply(p, x, mcfg)
        routes.append(aux["top_e"])
        return y, aux

    def replayed(p, x, mcfg, top_e=None):
        return moe_apply(p, x, mcfg, top_e=routes.pop(0))
    with mock.patch.object(transformer, "moe_apply", recorded if record else replayed):
        yield


def _grad_rels(got: dict, want: dict, floor_share: float) -> dict:
    """{tensor: max |got − want| over max |want|, the denominator floored
    at ``floor_share`` of the largest |want| of all}."""
    big = max(float(t.abs().max()) for t in want.values())
    return {n: float((got[n].double() - t.double()).abs().max())
            / max(float(t.abs().max()), floor_share * big) for n, t in want.items()}


@contextlib.contextmanager
def float64_compute():
    """The model code in float64: its fp32 casts (``.float()``), its fp32
    zero states and ``layers.nn``'s widening product keep float64 (a model
    whose path runs no kernel: mamba's)."""
    from repro_torch.layers import nn as nn_layers
    zeros = torch.zeros

    def zeros64(*a, dtype=None, **kw):
        return zeros(*a, dtype=torch.float64 if dtype in (None, torch.float32) else dtype, **kw)
    with mock.patch.object(torch.Tensor, "float", lambda self: self.double()), \
            mock.patch.object(torch, "zeros", zeros64), \
            mock.patch.object(nn_layers, "_product", lambda w, x: F.linear(x, w.to(x.dtype))):
        yield


def float64_grads(api, batch: dict, dev, mesh=None) -> dict:
    """The loss's gradients on ``batch`` at ``api``'s seed-0 weights,
    computed in float64 (``float64_compute``), whole by name: on one rank,
    or, with ``mesh``, split over its ``model`` axis as ``Trainer(mesh=...)``
    splits the step, and gathered (a collective: every rank calls it)."""
    from repro_torch.distributed import tensor_parallel
    from repro_torch.distributed.params import full_tensor
    from repro_torch.distributed.sharding import axis_rules
    from repro_torch.runtime import Trainer, TrainerConfig
    api64 = model_api(api.mcfg.scaled(param_dtype="float64", compute_dtype="float64"))
    model = api64.init(seed=0, device=dev)
    if mesh is None:
        with float64_compute():
            api64.loss(model, batch)[0].backward()
        return {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
    tr = Trainer(api64, TrainerConfig(**TP_TRAIN), mesh=mesh, device=dev)
    tr._layouts(model)
    tr.hold(model, "model")
    with float64_compute(), axis_rules(mesh, {"batch": None}):
        api64.loss(model, batch)[0].backward()
    return {n: p.grad if tensor_parallel.cut_dim(p) is None
            else full_tensor(p.grad.contiguous(), tr.tp_sh[n], tr._shapes[n], mesh)
            for n, p in model.named_parameters() if p.grad is not None}


def _clipped(grads: dict, max_norm: float) -> dict:
    """``grads`` scaled as the train step clips them to ``max_norm``."""
    norm = float(torch.sqrt(sum(g.double().pow(2).sum() for g in grads.values())))
    return {n: g * min(1.0, max_norm / norm) for n, g in grads.items()}


def _grad_l2(got: dict, want: dict) -> float:
    """‖got − want‖ over ‖want‖, of the whole gradient (every tensor of
    ``want``)."""
    d = sum(float((got[n].double() - t.double()).pow(2).sum()) for n, t in want.items())
    return (d / sum(float(t.double().pow(2).sum()) for t in want.values())) ** 0.5


def _tp_unit(tr, mesh, name: str, mine, whole, fn, inputs: dict, gy, routes: list,
             zero: tuple = ()) -> tuple:
    """One unit of :func:`tp_layer_hold`: ``fn(mine, *inputs)`` on this
    rank's parts under the mesh's axis rules against ``fn(whole, *inputs)``
    on one rank, given the same inputs (``{name: tensor}``) and upstream
    gradient ``gy`` (the MoE routing held to the split side's): the output
    at ``LM_LAYER_TOL`` and every gradient (this rank's part of a cut one)
    at ``LM_GRAD_REL_TOL`` of its largest value, a parameter's floored at
    ``LM_GRAD_FLOOR`` of the unit's largest parameter gradient; those
    ending in ``zero`` (0 in exact arithmetic) against that largest itself,
    as ``grad_rows`` holds them.  Returns (its row, the reference's input
    gradients)."""
    from repro_torch.distributed.params import local_part
    from repro_torch.distributed.sharding import axis_rules
    names = [f"{name}.{n}" for n, _ in whole.named_parameters()]
    xs = [t.detach().requires_grad_(True) for t in inputs.values()]
    with use_backend("kernels"), axis_rules(mesh), held_moe_routing(routes, True):
        y_tp = fn(mine, *xs)
        g_tp = torch.autograd.grad(y_tp, [*xs, *mine.parameters()], gy, allow_unused=True)
    with use_backend("kernels"), held_moe_routing(routes, False):
        y = fn(whole, *xs)
        g = torch.autograd.grad(y, [*xs, *whole.parameters()], gy, allow_unused=True)
    out_rel = _rel(y_tp.detach(), y.detach())
    del y, y_tp
    pairs = []
    for key, a, b in zip([*inputs, *names], g_tp, g):
        check((a is None) == (b is None), f"{key}: a gradient on one side only")
        if b is None:                            # φ_q only feeds top-k; cross-attention's BSA
            continue
        if key in names:
            b = local_part(b, tr.tp_sh[key], tr.mesh)
        pairs.append((key, float((a.float() - b.float()).abs().max()),
                      float(b.float().abs().max())))
    floor = LM_GRAD_FLOOR * max(r for n, _, r in pairs if n in names)
    rel = {n: d / (r if n not in names else floor / LM_GRAD_FLOOR if zero and n.endswith(zero)
                   else max(r, floor)) for n, d, r in pairs}
    worst = max(rel, key=rel.get)
    check(out_rel <= LM_LAYER_TOL and rel[worst] <= LM_GRAD_REL_TOL,
          f"{tr.api.mcfg.name} tensor-parallel {name} vs one rank: output {out_rel:.2e}, "
          f"{worst} gradient {rel[worst]:.2e}")
    return ({"unit": name, "out_rel": out_rel, "grad_rel": rel[worst], "grad_rel_at": worst},
            g[:len(xs)])


def _top_grad(lm_head, norm, top, cfg, labels, loss_mask=None):
    """The loss's gradient at the final norm's input ``top`` (one rank's
    whole head)."""
    top = top.detach().requires_grad_(True)
    logits = dense(lm_head, rmsnorm(norm, top, cfg.norm_eps)).float()
    gy, = torch.autograd.grad(masked_mean_nll(logits[:, -labels.shape[1]:], labels, loss_mask),
                              top)
    return gy


def _tp_lm_units(tr, mesh, mine, whole, cfg, x0, labels, prefix: str, routes) -> tuple:
    """The LM backbone's layers, last first, each given the reference
    forward's input and the upstream gradient chained through the
    reference (the ``lm_train_reference_check`` recipe): (rows, the
    gradient at the first layer's input)."""
    B_, N_ = x0.shape[:2]
    pos = torch.arange(N_, device=x0.device)[None].expand(B_, N_)
    xs = []
    with torch.no_grad(), use_backend("kernels"):
        h = x0
        for period in whole.layers:
            xs.append(h)
            h = lm_layer(period.pos0, h, mcfg=cfg, positions=pos)
    gy = _top_grad(whole.lm_head, whole.final_norm, h, cfg, labels)
    rows = []
    for i in reversed(range(len(xs))):
        row, (gy,) = _tp_unit(tr, mesh, f"{prefix}layers.{i}.pos0", mine.layers[i].pos0,
                              whole.layers[i].pos0,
                              lambda m, x: lm_layer(m, x, mcfg=cfg, positions=pos),
                              {"input": xs[i]}, gy, routes)
        rows.append(row)
    return rows, gy


def _tp_encdec_units(tr, mesh, mine, whole, cfg, batch, routes) -> list:
    """seamless's units, last first: the decoder layers (self-attention,
    cross-attention on the memory, SwiGLU; the memory's gradient summed
    over them), the encoder layers (the gradient through the reference's
    ``enc_norm``), then ``frontend_proj`` on the frames; φ_k.pos
    (``EXACT_ZERO``) held as ``encdec_reference_check`` holds it."""
    cdt, eps = cfg.cdtype(), cfg.norm_eps
    frames, fmask = batch["frames"].to(cdt), batch.get("frame_mask")
    tokens = batch["dec_tokens"]
    pos = torch.arange(tokens.shape[1], device=tokens.device)[None].expand(*tokens.shape)
    xe, xd = [], []
    with torch.no_grad(), use_backend("kernels"):
        x = encdec._frontend(whole.frontend_proj, frames)
        for lp in whole.enc_layers:
            xe.append(x)
            x = encdec.enc_layer(lp, x, mcfg=cfg, mask=fmask)
        pre = x
        memory = rmsnorm(whole.enc_norm, pre, eps)
        h = embed(whole.tok_embed, tokens, dtype=cdt)
        for lp in whole.dec_layers:
            xd.append(h)
            h = encdec.dec_layer(lp, h, memory, mcfg=cfg, positions=pos, mem_mask=fmask)
    gy = _top_grad(whole.lm_head, whole.dec_norm, h, cfg, batch["labels"],
                   batch.get("loss_mask"))
    rows, g_mem = [], 0
    for i in reversed(range(len(xd))):
        row, (gy, gm) = _tp_unit(
            tr, mesh, f"dec_layers.{i}", mine.dec_layers[i], whole.dec_layers[i],
            lambda m, x, mem: encdec.dec_layer(m, x, mem, mcfg=cfg, positions=pos,
                                               mem_mask=fmask),
            {"input": xd[i], "memory": memory}, gy, routes, zero=(EXACT_ZERO,))
        rows.append(row)
        g_mem = g_mem + gm
    pre = pre.detach().requires_grad_(True)
    gy, = torch.autograd.grad(rmsnorm(whole.enc_norm, pre, eps), pre, g_mem)
    for i in reversed(range(len(xe))):
        row, (gy,) = _tp_unit(tr, mesh, f"enc_layers.{i}", mine.enc_layers[i],
                              whole.enc_layers[i],
                              lambda m, x: encdec.enc_layer(m, x, mcfg=cfg, mask=fmask),
                              {"input": xe[i]}, gy, routes, zero=(EXACT_ZERO,))
        rows.append(row)
    row, _ = _tp_unit(tr, mesh, "frontend_proj", mine.frontend_proj, whole.frontend_proj,
                      encdec._frontend, {"frames": frames}, gy, routes)
    return rows + [row]


def tp_layer_hold(tr, model, ref, cfg, batch, mesh) -> dict:
    """Each layer of the tensor-parallel ``model`` (this rank's parts)
    against the same layer of the whole ``ref`` on one rank, given the same
    input and upstream gradient (``_tp_unit``): an LM's layers; llava's
    backbone layers, then its projector on the patch embeddings; seamless's
    decoder layers (with the memory as an input), its encoder layers and
    ``frontend_proj``."""
    routes: list = []
    tr.hold(model, "model")
    if cfg.family == "audio":
        rows = _tp_encdec_units(tr, mesh, model, ref, cfg, batch, routes)
    elif cfg.family == "vlm":
        cdt = cfg.cdtype()
        patches = batch["patch_embeds"].to(cdt)
        with torch.no_grad():
            x0 = vlm._embeds(ref, batch["tokens"], patches, cdt)
        rows, gy = _tp_lm_units(tr, mesh, model.lm, ref.lm, cfg, x0, batch["labels"], "lm.",
                                routes)
        row, _ = _tp_unit(tr, mesh, "projector", model.projector, ref.projector,
                          lambda m, pe: vlm._project(m, pe, cdt), {"patches": patches},
                          gy[:, :patches.shape[1]], routes)
        rows.append(row)
    else:
        with torch.no_grad():
            x0 = embed(ref.embed, batch["tokens"], dtype=cfg.cdtype())
        rows, _ = _tp_lm_units(tr, mesh, model, ref, cfg, x0, batch["labels"], "", routes)
    tr.hold(model, None)
    return {"units": rows, "out_tol": LM_LAYER_TOL, "grad_tol": LM_GRAD_REL_TOL}


def tp_batches(dev, path: str, api) -> list[dict]:
    """1 + ``TP_STEPS`` batches: the LM train batches (tinyllama, qwen2-moe:
    2 x 4096 tokens; mamba2: 1 x 4096), else ``api.make_batch`` at 1 x
    ``FAMILY_N`` (llava: 512 image + 3,584 text tokens; seamless: 4,096
    frames and 512 decoder tokens)."""
    cfg = api.mcfg
    if path in ("tp_train", "tp_moe"):
        return lm_train_batches(dev, cfg.vocab_size, steps=TP_STEPS)
    if path == "tp_ssm":
        return lm_train_batches(dev, cfg.vocab_size, batch_size=1, steps=TP_STEPS)
    return [api.make_batch(np.random.default_rng(s), 1, FAMILY_N, device=dev)
            for s in range(TP_STEPS + 1)]


def _tp_arch(dev, mesh, path: str, arch: str, res) -> dict:
    """One model through ``Trainer(mesh=(1, 2))`` (see :func:`tp_train_case`)."""
    from repro_torch.distributed.params import full_tensor
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.runtime import Trainer, TrainerConfig
    t0 = time.perf_counter()
    api = model_api(get_config(arch).scaled(**TP_SCALED.get(path, dict(n_layers=TP_LAYERS))))
    cfg = api.mcfg
    mesh12 = make_mesh((1, 2), ("data", "model"))
    batches = tp_batches(dev, path, api)
    quiet = contextlib.redirect_stdout(io.StringIO())
    ax = mesh.axis_group("data")                          # both ranks
    tr = Trainer(api, TrainerConfig(**TP_TRAIN), mesh=mesh12, device=dev)
    model, opt = tr.init_state()
    whole_bytes = tr.param_bytes(model)
    held, step = [], tr._step

    def spied(model, opt_state, batch):
        out = step(model, opt_state, batch)
        held.append(tr.param_bytes(model))
        return out
    tr._step = spied
    with use_backend("kernels"), quiet:
        model, opt = tr.fit(iter(batches[:1]), steps=1, model=model, opt_state=opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with CollectiveCount() as cc:
            reset_counters()                             # just before the main path
            model, opt = tr.fit(iter(batches[1:]), steps=TP_STEPS, model=model,
                                opt_state=opt, start_step=1)
            torch.cuda.synchronize()
            res["paths"][path] = {n: c.n for n, c in COUNTERS.items()}   # just after
    if cfg.family == "audio":
        check_counts(res["paths"][path], seamless_train_launches(cfg, TP_STEPS), path)
    else:
        check_launches(res["paths"][path], path, cfg.n_layers * TP_STEPS,
                       per_forward_kernel=2 * cfg.n_layers * TP_STEPS)
    steps = tr.metrics_history[1:]
    params = {n: p.detach() for n, p in model.named_parameters()}
    cut = sum(p.numel() * p.element_size() for n, p in params.items()
              if tr.tp_sh[n] != (None,) * p.dim())
    out = {"arch": arch, "layers": [len(model.enc_layers), len(model.dec_layers)]
           if cfg.family == "audio" else cfg.n_layers, "mesh": str(mesh12.shape),
           "batch": {k: list(v.shape) for k, v in batches[0].items()},
           "param_dtype": cfg.param_dtype,
           "loss": [m["loss"] for m in tr.metrics_history],
           "grad_norm": [m["grad_norm"] for m in tr.metrics_history],
           "step_ms": [m["step_time_s"] * 1e3 for m in steps],
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "param_bytes_whole": whole_bytes, "param_bytes_cut_whole": cut,
           "param_bytes_held": held[1:],
           "collectives_a_step": {k: v / TP_STEPS for k, v in cc.n.items()},
           "gathered_bytes_a_step": cc.gathered_bytes / TP_STEPS,
           "bits_equal_across_ranks": same_on_every_rank(rank_digest(params.values()), ax)}
    check(out["bits_equal_across_ranks"], f"{path}: parameters differ between ranks")
    check(all(math.isfinite(x) for x in out["loss"] + out["grad_norm"]),
          f"{path}: losses {out['loss']}, gradient norms {out['grad_norm']}")
    check(all(b == whole_bytes - cut // 2 for b in held),
          f"{path}: a rank held {held} parameter bytes, not {whole_bytes - cut // 2}")

    # bf16, layer by layer against one rank on the same whole weights, on
    # the first sequence of a batch (qwen2-moe's whole-vocabulary logits of
    # both sequences and their gradient outgrow the card shared by 2 ranks)
    del opt
    model.zero_grad(set_to_none=True)
    gc.collect()
    torch.cuda.empty_cache()
    ref = api.init(seed=0, device=dev)
    with torch.no_grad():
        for n, p in ref.named_parameters():
            p.copy_(params[n])
    out["layer_hold"] = tp_layer_hold(tr, model, ref, cfg,
                                      {k: v[:1] for k, v in batches[1].items()}, mesh12)
    del ref, model, params, tr
    gc.collect()
    torch.cuda.empty_cache()

    # fp32: a step from the same weights, held to one rank's at TP_HOLD
    api32 = model_api(cfg.scaled(param_dtype="float32", compute_dtype="float32"))
    batch = {k: v[:1] for k, v in batches[1].items()}     # one sequence
    tr = Trainer(api32, TrainerConfig(**TP_TRAIN), mesh=mesh12, device=dev)
    grads, step, picks = {}, tr._step, HeldPicks()

    def keep_grads(model, opt_state, b):
        res_ = step(model, opt_state, b)
        for n, p in model.named_parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[n] = (g if tr.tp_sh[n] == (None,) * g.dim()
                        else full_tensor(g.contiguous(), tr.tp_sh[n], tr._shapes[n], tr.mesh))
        return res_
    tr._step = keep_grads
    with use_backend("kernels"), quiet, picks.record():
        tr.fit(iter([batch]), steps=1, model=api32.init(seed=0, device=dev))
    got = tr.metrics_history[-1]
    masks = picks.masks(mesh12, None, None, n_kv=cfg.n_kv_heads)
    del tr
    if mesh.rank != 0:                                   # only rank 0 compares
        grads.clear()
    gc.collect()
    torch.cuda.empty_cache()

    def one_rank():
        one = Trainer(api32, TrainerConfig(**TP_TRAIN), device=dev)
        held = HeldPicks()
        with use_backend("kernels"), contextlib.redirect_stdout(io.StringIO()), \
                held.replay(masks):
            m, _ = one.fit(iter([batch]), steps=1, model=api32.init(seed=0, device=dev))
        want = one.metrics_history[-1]
        wg = {n: p.grad for n, p in m.named_parameters() if p.grad is not None}   # φ_q: none
        del m
        rel = _grad_rels(grads, wg, TP_GRAD_FLOOR)
        apart = {n for n in rel if cfg.family == "ssm" and n.endswith(TP_FP32_UNRESOLVED)}
        worst = sorted(((r, n) for n, r in rel.items() if n not in apart), reverse=True)[:5]
        out = {"loss_rel": abs(got["loss"] - want["loss"]) / abs(want["loss"]),
               "grad_norm_rel": abs(got["grad_norm"] - want["grad_norm"])
               / abs(want["grad_norm"]), "grad_rel": worst[0][0], "grad_rel_at": worst[0][1],
               "grad_rel_worst": worst, "grad_l2": _grad_l2(grads, wg),
               "picks_flipped": held.flipped, "picks_held": held.groups}
        if cfg.family == "ssm":        # no kernel on the path: the step in float64 beside
            one64.update(float64_grads(api32, batch, dev))
            fp32 = _grad_rels(wg, _clipped(one64, TrainerConfig(**TP_TRAIN).max_grad_norm),
                              TP_GRAD_FLOOR)
            out["unresolved_in_fp32"] = {n: {"split_vs_one": rel[n], "one_vs_float64": fp32[n]}
                                         for n in sorted(apart)}
        out["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        return out
    torch.cuda.reset_peak_memory_stats()
    one64: dict = {}                                     # rank 0's float64 gradients
    hold = _rank0_only(mesh, one_rank)
    grads.clear()
    if cfg.family == "ssm":
        # the same step in float64, split and on one rank, every gradient
        # held at TP_HOLD (TP_FP32_UNRESOLVED's too)
        split64 = float64_grads(api32, batch, dev, mesh12)

        def float64_hold():
            rel = _grad_rels(split64, one64, TP_GRAD_FLOOR)
            n = max(rel, key=rel.get)
            return {"grad_rel": rel[n], "grad_rel_at": n}
        held64 = _rank0_only(mesh, float64_hold)
        del split64
        one64.clear()
        if hold is not None:
            hold["float64"] = held64
    if hold is not None:
        out["fp32_hold"] = hold
        check(max(hold["loss_rel"], hold["grad_norm_rel"], hold["grad_l2"],
                  0.0 if path in TP_FP32_WHOLE_ONLY else hold["grad_rel"],
                  hold.get("float64", {}).get("grad_rel", 0.0)) <= TP_HOLD,
              f"{path} fp32 step from the same weights vs one rank: {hold}")
        check(hold["picks_flipped"] <= PICKS_FLIP_TOL * hold["picks_held"],
              f"{path}: the one rank's own selection picks differ from the split step's in "
              f"{hold['picks_flipped']} of {hold['picks_held']} (group, head)s, above "
              f"{PICKS_FLIP_TOL}")
    out["seconds"] = time.perf_counter() - t0
    return out


def tp_train_case(dev, mesh, inputs, res) -> None:
    """Megatron's compute over ``model`` (``distributed/tensor_parallel.py``)
    through ``Trainer(mesh=(1, 2))`` (the main path), bf16 with remat, 1 +
    ``TP_STEPS`` steps at full width and ``TP_LAYERS`` layers:
    tinyllama-1.1b and qwen2-moe-a2.7b (32 of its 64 padded experts a rank)
    on B 2 x 4096 tokens, llava-next-34b (28 / 4 heads of 128 a rank; the
    projector and the vocabulary split) on its prefill shape,
    seamless-m4t-medium (2 encoder + 2 decoder layers, 8 of 16 heads a rank
    in each attention, cross-attention included; the vocabulary split) on
    4,096 frames and mamba2-1.3b (its scan on 32 of 64 heads a rank) on 1 x
    4096 tokens.  Each rank's launches, the parameter bytes it holds between
    steps (half of every cut weight), its peak memory, the collectives and
    the step time; parameters equal in bits on both ranks; each layer held
    to one rank's given the same input and upstream gradient (bf16,
    ``tp_layer_hold``); then a fp32 step from the same weights held to one
    rank's at ``TP_HOLD`` (loss, gradient norm, every gradient)."""
    res["paths"] = {}
    for path, arch in TP_ARCHS.items():
        res[path] = _tp_arch(dev, mesh, path, arch, res)
        print(json.dumps({path: res[path]}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()


SHARDED_CASES = {"padded": sharded_padded_case, "packed": sharded_packed_case,
                 "lm": sharded_lm_case, "dp_train": dp_train_case, "remat_lm": remat_lm_case,
                 "pipeline_compress": pipeline_compress_case, "tp_train": tp_train_case}


def sharded_rank(rank: int, world: int, case: str, init_file: str, in_path: str,
                 out_path: str) -> None:
    """One rank of a sharded case (a spawned process): a gloo group over
    localhost, the kernels built by the parent, the kernels inner backend."""
    import datetime
    import torch.distributed as dist
    from repro_torch.distributed.sharded_backend import INNER_ENV
    from repro_torch.launch.mesh import make_local_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ[INNER_ENV] = "kernels"
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", world_size=world,
                            rank=rank,
                            timeout=datetime.timedelta(seconds=SHARDED_TIMEOUT_S))
    res = {"rank": rank, "case": case}
    try:
        _build.load()
        SHARDED_CASES[case](dev, make_local_mesh(), torch.load(in_path, weights_only=False),
                            res)
    except Exception as e:                               # reported by the parent
        res["failed"] = f"{type(e).__name__}: {e}"
        import traceback
        res["traceback"] = traceback.format_exc()[-4000:]
    finally:
        Path(out_path).write_text(json.dumps(res))
        dist.destroy_process_group()
    if "failed" in res:
        sys.exit(1)


def sharded_inputs(path: Path, batches: list, packed: dict, clouds: list,
                   vocab: int) -> None:
    """What the ranks read: the padded train batches (the first for the
    sharded backend, ``DP_STEPS`` + 1 for ``Trainer(mesh=...)``), a packed
    one, 8 clouds to serve and the LM's requests (5 prompts of 260–400
    tokens; requests 1 and 3 open with request 0's first page, and request
    4 is that page alone, which forces a copy-on-write on the
    row-partitioned pools)."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, vocab, int(n), dtype=np.int32)
               for n in rng.integers(260, 401, 4)]
    for r in (1, 3):
        prompts[r][:PAGE] = prompts[0][:PAGE]
    prompts.append(prompts[0][:PAGE].copy())
    torch.save({"padded": {k: v.cpu() for k, v in batches[0].items()},
                "dp_padded": [{k: v.cpu() for k, v in b.items()}
                              for b in batches[:DP_STEPS + 1]],
                "dp_packed": {k: v.cpu() for k, v in packed.items()},
                "clouds": clouds[:B], "lm_prompts": prompts}, path)


def sharded_phase(paths: dict) -> None:
    """Run each sharded case in ``SHARDED_P`` ranks that share the card
    (spawned processes; NCCL refuses two ranks on one device, so the ranks
    talk over a gloo group, which stages CUDA tensors through the host).
    The timings are of ranks sharing one card: no scaling number."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    out_dir = ROOT / "build" / "sharded"
    in_path = out_dir / "inputs.pt"
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    shutil.rmtree(out_dir / "dp_ckpt", ignore_errors=True)   # dp_train's checkpoints
    for case, p in SHARDED_P.items():
        t0 = time.perf_counter()
        init = out_dir / f"{case}.group"
        init.unlink(missing_ok=True)
        outs = [out_dir / f"{case}_rank{r}.json" for r in range(p)]
        for o in outs:
            o.unlink(missing_ok=True)
        procs = [ctx.Process(target=sharded_rank, args=(r, p, case, str(init), str(in_path),
                                                        str(outs[r])))
                 for r in range(p)]
        for pr in procs:
            pr.start()
        try:
            while any(pr.is_alive() for pr in procs):   # one failed rank ends the case
                if any(pr.exitcode not in (None, 0) for pr in procs):
                    break
                check(time.perf_counter() - t0 < 3 * SHARDED_TIMEOUT_S,
                      f"sharded {case}: ranks still running")
                time.sleep(0.5)
        finally:
            for pr in procs:
                if pr.is_alive():
                    pr.kill()
                pr.join()
        results = [json.loads(o.read_text()) if o.exists() else {"failed": "no result"}
                   for o in outs]
        seconds = time.perf_counter() - t0
        for r in results:
            print(json.dumps({"sharded": {"p": p, **r}}), flush=True)
        failed = [f"rank {i}: {r['failed']}" for i, r in enumerate(results) if "failed" in r]
        check(not failed and all(pr.exitcode == 0 for pr in procs),
              f"sharded {case} (p = {p}): {'; '.join(failed)}")
        print(f"# sharded {case} (p = {p}): {seconds:.1f} s", flush=True)
        for name, get in (
                (f"sharded_{case}", lambda r: r.get("launches")),
                ("sharded_prefill", lambda r: r.get("prefill_launches")),
                ("sharded_serve_lm", lambda r: r.get("serve", {}).get("launches")),
                *((name, lambda r, name=name: r["paths"][name])
                  for name in results[0].get("paths", {}))):
            if get(results[0]) is not None:
                paths[name] = {"launches": get(results[0]),
                               "launches_by_rank": [get(r) for r in results]}
    print(f"# sharded phase: {time.perf_counter() - t_phase:.1f} s", flush=True)


def kernels_line(rows: list[dict], paths: dict) -> list[dict]:
    """The kernels line: one entry a kernel with its main path's row and
    launches, and the further rows of ``LM_ALSO`` under their keys."""
    summary = []
    for name, (src, replaces) in KERNELS.items():
        # the main path's mode and dtype (fp32 and the key-bias flash for the
        # shapenet kernels, the prefill's bf16 for local_fwd, the engine's fp32
        # cache for paged_gather, the LM train shapes in bf16 for local_dq and
        # local_dkv); launches of the main path (the train paths for the
        # shapenet kernels, packed where it runs them), and of every path
        main_path, dt, mode = LM_MAIN.get(name, (None, "float32", None))
        row = next(r for r in rows if r["name"] == name and r["dtype"] == dt
                   and mode in (None, r["mode"]))
        by_path = {p: st["launches"][name] for p, st in paths.items()}
        if main_path is None:
            main_path = "train_packed" if name in PATHS["train_packed"] else "train_padded"
        entry = {"name": name, "route": "cuda", "source": src, "replaces": replaces,
                 "launches": by_path[main_path], "max_abs_err": row["max_abs_err"],
                 "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                 "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                 "library_ms": row["library_ms"], "launches_by_path": by_path}
        entry.update({k: row[k] for k in EXTRA_KEYS if k in row})
        if name in NOT_ON_A_MAIN_PATH:
            entry["note"] = NOT_ON_A_MAIN_PATH[name]
        for key, path, dt, mode in LM_ALSO.get(name, ()):
            row = next(r for r in rows if r["name"] == name and r["dtype"] == dt
                       and r["mode"] == mode)
            entry[key] = {"launches": by_path[path] if path else None,
                          "max_abs_err": row["max_abs_err"],
                          "ms": row["kernel_ms"], "plain_ms": row["plain_ms"],
                          "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                          "library_ms": row["library_ms"],
                          **{k: row[k] for k in EXTRA_KEYS if k in row}}
        summary.append(entry)
    return summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device: this script runs on the GPU only",
              file=sys.stderr)
        return 2
    check(not os.environ.get(ENV_VAR),
          f"${ENV_VAR} is set ({os.environ.get(ENV_VAR)!r}): it would override every "
          "backend this script names, so its launch checks could pass by accident; unset it")
    dev = torch.device("cuda")
    smi = smi_line()
    print(f"# card: {smi}", flush=True)
    print(f"# torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load()
    info = _build.last_build
    verb = "built" if info["built"] else "found built"
    print(f"# kernels {verb} in {info['seconds']:.1f} s -> {info['path']}", flush=True)
    for line in info["log"].splitlines():
        if re.search(r"entry function|registers|spill|error", line):
            print("# ptxas " + line.strip(), flush=True)
    if info["built"]:                      # the log of this build: no spills where it matters
        table = ptxas_table(info["log"])
        print(json.dumps({"ptxas_no_spill": table}), flush=True)
        for name, dims, variants in NO_SPILL:
            for d in dims:
                got = [r for r in table if r["kernel"] == name and r["head_dim"] == d
                       and r["variant"] in variants]
                check({r["variant"] for r in got} == set(variants),
                      f"ptxas: {name} at D {d}: variants {[r['variant'] for r in got]}, "
                      f"expected {variants}")
                for r in got:
                    check(r.get("spill_stores") == 0 and r.get("spill_loads") == 0,
                          f"ptxas: {name} ({r['variant']}) at D {d} spills: {r}")

    batches = train_batches(dev)
    packed_batches = packed_train_batches(dev)
    t0 = time.perf_counter()
    clouds = make_clouds(16, (2800, REAL_POINTS), seed=2024)
    print(f"# made 16 clouds in {time.perf_counter() - t0:.1f} s", flush=True)
    (ROOT / "build" / "sharded").mkdir(parents=True, exist_ok=True)
    sharded_inputs(ROOT / "build" / "sharded" / "inputs.pt", batches, packed_batches[0],
                   clouds, get_config(LM).vocab_size)
    _, serve_offsets, serve_mask = pack_varlen(
        [np.zeros((c["points"].shape[0], 1), np.float32) for c in clouds[:8]], BALL,
        pad_to=CAPACITY, max_samples=B)
    rows = (kernel_phase(dev) + backward_kernel_phase(dev, batches[0])
            + varlen_kernel_phase(dev, serve_offsets, serve_mask, packed_batches[0]))
    print(json.dumps({"output_hashes": output_hashes(dev)}), flush=True)

    api = model_api(get_config("shapenet-bsa"))
    model = api.init(seed=0, device=dev)
    paths = {}
    paths["serve_padded"], padded_outs = serve_phase(dev, api, model, clouds, "padded")
    paths["serve_packed"], packed_outs = serve_phase(dev, api, model, clouds, "packed")
    compare_layouts(clouds, padded_outs, packed_outs)
    del model
    paths["train_padded"] = train_phase(dev, batches, "padded")
    paths["train_packed"] = train_phase(dev, packed_batches, "packed")
    del packed_batches
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rows += baseline_kernel_phase(dev, pad_rows(batches[0], ERWIN_N)["mask"])
    paths.update(baselines_phase(dev, batches))
    print(f"# baselines phase: {time.perf_counter() - t0:.1f} s", flush=True)
    paths["quickstart"] = quickstart_phase()
    paths["trainer"] = trainer_phase(dev, batches[-2:])
    paths["trainer_resume"] = {"launches": paths["trainer"]["resumed_launches"]}
    del batches
    torch.cuda.empty_cache()

    rows += lm_kernel_phase(dev)
    t0 = time.perf_counter()
    rows += head_rows_phase(dev, "d128", (torch.float32, torch.bfloat16))
    print(f"# head_dim 128 phase: {time.perf_counter() - t0:.1f} s", flush=True)
    for tag in ("rep1", "rep48"):                        # stablelm's and granite's heads
        t0 = time.perf_counter()
        rows += head_rows_phase(dev, tag, (torch.bfloat16,))
        print(f"# {tag} heads phase: {time.perf_counter() - t0:.1f} s", flush=True)
    rows += family_kernel_rows(dev)
    lm_api = model_api(get_config(LM))
    t0 = time.perf_counter()
    lm_model = lm_api.init(seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"# {LM}: {sum(p.numel() for p in lm_model.parameters()) / 1e9:.3f} B "
          f"parameters ({lm_api.mcfg.param_dtype}) made in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    paths["prefill"] = prefill_phase(dev, lm_api, lm_model)
    torch.cuda.empty_cache()
    paths["decode_oracle"] = decode_oracle_phase(dev)
    serve_api = model_api(lm_api.mcfg.scaled(n_layers=SERVE_LM_LAYERS))
    serve_model = serve_api.init(seed=0, device=dev)
    t0 = time.perf_counter()
    paths["serve_lm"] = serve_lm_phase(dev, serve_api, serve_model)
    print(f"# serve_lm phase ({SERVE_LM_LAYERS} layers): {time.perf_counter() - t0:.1f} s",
          flush=True)
    del serve_model
    torch.cuda.empty_cache()
    lm_batches_ = lm_train_batches(dev, lm_api.mcfg.vocab_size)
    rows += lm_backward_kernel_phase(dev, lm_selection_picks(lm_api, lm_model,
                                                             lm_batches_[0]))
    paths["train_lm"] = train_lm_phase(dev, lm_api, lm_model, lm_batches_)
    del lm_model, lm_batches_                            # tinyllama's weights and batches
    gc.collect()
    torch.cuda.empty_cache()
    for arch in DENSE_LMS:
        t0 = time.perf_counter()
        paths.update(dense_lm_phase(dev, arch))
        gc.collect()
        torch.cuda.empty_cache()
        print(f"# {arch} phase: {time.perf_counter() - t0:.1f} s", flush=True)
    family_phases(dev, paths)
    sharded_phase(paths)

    summary = kernels_line(rows, paths)
    print(json.dumps({"kernels": summary}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
