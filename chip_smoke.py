#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --paged-shapes-of DIR [--paged-symbols S ...]
        # another checkout's paged decode at [3]'s four shapes
    python3 chip_smoke.py --train-of DIR
        # a checkout's AdamW timings ([3]), training step ([6]) and
        # recompute policies ([8])
    python3 chip_smoke.py --moe-of DIR
        # a checkout's GPT-MoE training step ([16])
    python3 chip_smoke.py --mp-of DIR
        # [3]'s checks at the mp and ZeRO shapes, [18b] and [19] alone
    python3 chip_smoke.py --dp-worker DIR
        # one rank of [18b]; the port's launcher starts two
    python3 chip_smoke.py --tp-worker DIR | --zero-worker DIR
        # one rank of [19a] | [19b]; the port's launcher starts two
    python3 chip_smoke.py --zero3-of DIR
        # [3]'s AdamW timing, [18b], [19b] and [20] alone
    python3 chip_smoke.py --z3-worker DIR | --reduce-worker DIR
        # one rank of [20a] | [20b]; the port's launcher starts two
    python3 chip_smoke.py --ep-of DIR
        # a checkout's expert parallelism ([21]) alone
    python3 chip_smoke.py --ep-worker DIR | --ep4-worker DIR
        # one rank of [21a] | [21b]; the port's launcher starts two | four
    python3 chip_smoke.py --mx-of DIR
        # a checkout's GPT-MoE at mp, grad_reduce at ep and resharding
        # ([22]) alone, with [21a]'s one process as its reference
    python3 chip_smoke.py --mx-worker DIR | --mx4-worker DIR
        # one rank of [22] | [22a]'s ep 2 x mp 2; the launcher starts two |
        # four
    python3 chip_smoke.py --split-of DIR | --pp-of DIR
        # a checkout's serving over ranks and sharded save ([23]) | its
        # pipeline parallelism ([24]) alone
    python3 chip_smoke.py --pp-worker DIR | --pp4-worker DIR
        # one rank of [24] | [24a]'s pp 2 x dp 2 and pp 2 x mp 2; the
        # launcher starts two | four

Phases, each of which exits non-zero on failure:

1. device: the card's name and power limit (``nvidia-smi``); TF32 is turned
   off for float32 products and convolutions so fp32 checks are fp32;
2. build: every CUDA source under ``paddle_tpu_torch/kernels/csrc`` is
   compiled with ``nvcc`` for sm_90a (one process per source, in parallel;
   ptxas's registers and spills printed per kernel), the HGMMA instructions
   of the bf16 flash forward's and backward's kernels are counted in their
   SASS (``cuobjdump -sass``; none fails), the norms are launched once, and
   the primitives that ``kernels.primitive`` generates for this script's
   functions are JIT-compiled (Triton);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the serving and training slices' shapes (the primitives at the 1.3B's
   hidden-state shapes and at ragged ones), in bf16 and fp32, with the
   stated tolerance (LayerNorm and RMSNorm forward and backward at 1 to
   32768 rows of H 7 to 2050, on both routes, and at GPT-MoE's rows of H
   1024, with two backward calls bitwise equal; the flash forward and
   backward also at GPT-MoE's D 64 shapes ([16], [17]) and at the
   edges of their 64-row tiles, with GQA 16/1, and on the fused qkv
   projection's column slices, each call on its dtype's route; the forward
   also on a view TMA cannot read, which is copied first; two bf16 calls
   at the training shape bitwise equal; paged decode on its vector route,
   two calls bitwise equal (also at GPT-MoE's H 16/16 D 64), timed at
   four shapes: the serving slice's decode batch, every slot and one slot
   at a 2048-token context, and the GQA serving config; the fused AdamW
   as one launch over a mixed list, one per dtype group: the six
   (param, grad, moments) combinations at sizes 0 to 50304 x 2048 and on
   aligned and unaligned slice views, then [6]'s whole parameter list with
   the bf16 copies, bitwise); the fp32 flash kernels (CUDA cores) at the
   shapes [5], [7] and [9] give them, beside ``F.sdpa`` in fp32; then
   timed with
   CUDA events and the profiler beside the plain version, a library yardstick the port
   never calls, and the H100 bound (a flash, norm or paged kernel the
   profiler does not see fails the run; others print "not seen");
4. serving slice at full width: GPT-3 1.3B (24 layers, bf16, random
   weights from the seed) behind ``Engine.generate``, 16 greedy requests
   through 8 slots, each prefill bucket's program and the decode step a
   CUDA graph captured once (by warm-up requests, one per bucket) and
   replayed: from the counts' reset, the warm-ups and the 16 requests
   under the profiler, each wrapper's launch count (the captures' warm-up
   runs and the captures; every flash forward on the bf16 route, wgmma;
   every paged decode on the vector route), none of them eager in the 16
   requests, and each kernel's launches on the card by the profiler's
   events (a window short of them, having lost records, is profiled
   again, up to 3 windows), which must equal the replays' (2L + 1 LayerNorms a decode or
   prefill replay, L paged decodes a decode replay, L flash forwards a
   prefill replay); the captures per program and the graphs' memory;
   then the 16 requests again without the profiler for tokens/s, TTFT
   and TPOT p50; [4b]: the device time of a decode step beside its host
   clock, with the paged decode's share, the decode step alone on the
   same buffers as a graph replay and as its eager function, and a
   1024-token prefill's program the same way (and its forward alone,
   eager), with the capture's cost; [4c]: [4]'s requests again, each
   prefill replay followed by its eager call on the same buffers (logits
   and the slot's written pages bitwise equal) and each decode replay by
   the eager step (greedy tokens identical at every step);
5. serving vs plain: at full width and depth 2 in fp32, the same weights
   serve 3 greedy prompts on the card (every flash forward on the fp32
   route, the CUDA cores) and on the CPU (plain versions);
   tokens must match and the last decode logits agree; on the card, flash
   prefill over the generated text agrees with the paged decode step;
6. training slice at full width: GPT-3 1.3B (bf16, full recompute, chunked
   loss) through ``make_sharded_train_step(model, AdamW(...))`` with fp32
   master weights and bf16 moments, batch 16 x 2048; one warm-up step,
   five timed steps and one profiled step, with each kernel's launch
   count over the timed steps (the flash kernels' on the tensor-core
   route; 4L + 1 LayerNorm forwards and 2L + 1 backwards a step; one
   AdamW launch a step and no master copied by ``copy_``) and the bf16
   flash kernels', the LayerNorm kernels' and AdamW's device time in the
   profiled step, ``apply_gradients``' host clock, and a digest of the
   losses and the state after the steps (equal to another checkout's
   under ``--train-of`` iff bitwise); the loss must be finite and fall;
7. training vs plain: at full width and depth 2 in fp32, the same weights
   take 3 AdamW steps on the card (every flash launch on the CUDA-core
   route) and on the CPU; losses, the first step's gradients and the
   parameters' updates after step 3 agree;
8. training surface at full width: GPT-3 1.3B (bf16) at batch 16 x 2048
   with a LinearWarmup over a CosineAnnealingDecay, a GradScaler and each
   recompute policy (None, save_flash, dots_saveable): one warm-up step,
   then ``run_steps`` over 3 stacked batches, the scheduler stepped between
   calls; step time, tokens/s, MFU, peak memory and flash forwards per
   step for each policy; the loss must be finite and fall, save_flash must
   launch half the flash forwards, every flash launch takes the wgmma
   route, and the rates used follow the schedule;
9. surface vs plain: at full width and depth 2 in fp32, with the
   scheduler, the scaler, save_flash and ``run_steps``: gradients under
   None and save_flash are bitwise equal on the card; a first step with an
   infinite scale is skipped on the card and on the CPU alike, then 3
   steps run; losses, the scaler's automaton and the updates agree;
10. user-facing path at full width: ``nn.RMSNorm`` forward and backward
   (held to the plain versions), ``nn.functional.rms_norm``, ``incubate``
   ``fused_rms_norm`` and the two primitive factories on the 1.3B's
   hidden states at batch 16 x 2048, with each kernel's launch count over
   that run;
11. prefix cache and speculative decoding at full width (run after 4):
   GPT-3 1.3B (bf16) behind ``Engine(prefix_cache=True, speculative=3)``,
   16 greedy requests sharing a 512-token prefix with distinct 64-256
   token suffixes (half a repeated 32-token phrase), 64 new tokens each,
   after a warm-up of the same lengths that captures every prefill and
   extend program they use: prefix hits (at least 15), the drafts'
   acceptance, one capture of each program, tokens/s, TTFT and TPOT p50,
   each wrapper's launches, and
   the kernels 4 verify replays run on the card by the profiler's events
   (2L + 1 LayerNorms each, nothing else of the port's); the
   page pool all free after ``prefix_cache.clear()``; the token agreement
   with the plain engine, reported;
12. prefix and speculative vs plain (run after 5): [11]'s traffic at full
   width and depth 2 in fp32 on the card (verify step captured) and on
   the CPU (plain versions): tokens must match each other and the plain
   engine's on the card;
13. ``GPTForCausalLM.generate`` at full width (run after 11): GPT-3 1.3B
   (bf16), 8 prompts of 512 tokens, 64 new greedy tokens; the first call
   captures the prefill and decode step, the second replays them
   (tokens/s, and no new capture); the prefill's and decode step's host
   clock against device busy, the dense ``decode_attend``'s share of the
   step, the kernels a prefill and a decode replay run on the card by the
   profiler (L flash forwards and 2L + 1 LayerNorms; 2L + 1 LayerNorms)
   and a call's replays (1 and 63), the step's sampling against its
   argmax alone, and the first tokens against the paged engine's (a
   differing prompt must be a tie
   within the two prefills' logit difference);
14. the dense layout at full width: [4]'s requests through
   ``Engine(kv_layout="dense")`` (tokens/s, TTFT and TPOT p50, one
   capture per program, no paged decode, the decode step's host clock,
   device busy and ``decode_attend``'s share); then (run after 12) at
   depth 2 in fp32, the dense engine and ``generate`` on the card and on
   the CPU: tokens must match;
15. checkpoint, data and resume at full width (run after 10): GPT-3 1.3B
   with 6's configuration and optimizer, fed by the port's pipeline
   (``TokenBinSource`` over token files written from the seed,
   ``SequencePacker``, ``GlobalBatchFeeder`` with prefetch depth 2);
   run A takes 2 steps, saves them through ``CheckpointManager`` (async:
   ``state_for_checkpoint()`` and the pipeline's state) and takes 2 more;
   run B builds a model from other weights, restores the save and the
   pipeline's position and takes the same 2 steps: its losses and every
   parameter and optimizer slot must equal run A's bit for bit (every
   flash launch on the wgmma route). It prints the state's bytes on disk,
   the save's blocking against its total ms, the restore's ms and GB/s,
   the pipeline's host wait per step and the step time under the feeder
   against 6's, each beside the card's name and power limit. Then the
   same resume with dropout 0.1 at full width and depth 2 (the attention
   plain: the flash kernels have no dropout), run A 1 step, a save and 2
   steps, run B restored into other weights bitwise equal to run A, the
   save restored under another seed drawing other masks; and the port's
   ``Dropout`` timed against ``torch.nn.Dropout`` on a block's output;
16. GPT-MoE training at full width: BASELINE config 5 (``bench.py``'s
   ``gpt_moe``: vocab 32768, hidden 1024, 8 layers, 16 heads, 8 experts in
   every 2nd block, top-2 GShard at capacity factor 1.25, aux weight
   0.01, recompute every block; bf16, random weights from the seed)
   through ``make_sharded_train_step`` with AdamW at lr 1e-4, bf16
   moments and no master weights, batch 8 x 1024: one warm-up step (the
   aux loss and each MoE block's share of choices dropped at capacity),
   five timed steps (step ms, tokens/s, MFU by ``bench.py``'s
   activated-parameter count, peak memory, each kernel's launches per
   step held to what the code gives, one AdamW launch, every flash launch
   on wgmma, ``apply_gradients``' host clock) and one profiled step
   (device busy, idle share, device time by group: the experts'
   products, their bias and GELU, the routing, flash, LayerNorm, AdamW,
   the rest); the loss must fall, the digest as [6]'s, and two steps
   from one state must be bitwise equal. Then depth 2 (one dense block, one
   MoE block) in fp32: 3 AdamW steps on the card and on the CPU; the
   first forward's routing identical (or a tie, reported), losses,
   gradients and updates agree;
17. GPT-MoE serving at [16]'s width (bf16, 8 layers): ``generate`` on 8
   prompts of 512 tokens, 64 new greedy tokens (the second call replays,
   tokens/s), then the paged ``Engine`` (8 slots, S_max 1024, page 16) on
   [4]'s request shape after one warm-up per bucket (tokens/s, TTFT and
   TPOT p50, one capture per program; the wrappers' launches counted
   from the warm-up on, apart from ``generate``'s), the kernels a decode
   and a prefill replay run on the card (the profiler: 2L + 1 LayerNorms
   and L paged decodes; 2L + 1 LayerNorms and L flash forwards), the
   decode step's dropped share (T = 8 slots, capacity 1); then depth 2 in fp32:
   the greedy tokens of ``generate`` and of the paged engine equal on the
   card and on the CPU;
18. data parallelism: [18a] 6's model, optimizer and batch through
   ``fleet.init`` (a file-store master) and ``make_sharded_train_step(
   mesh=)`` over an NCCL group of one rank: two steps bitwise equal to the
   step without a mesh (losses and every parameter), then 3 timed steps
   (host clock against 6's, each kernel's launches per step, which must
   be 6's) and one profiled (its NCCL kernels), and the gradients'
   all-reduce alone (bytes, CUDA-event ms, its kernels); the group is
   destroyed after. [18b] two ranks on the one card, started by the
   port's launcher (``--dp-worker``) over gloo: GPT-3 1.3B's width at
   depth 2 in fp32, half of a 4 x 512 batch each, 3 AdamW steps; every
   parameter on the card, the replicas bitwise equal after every step
   (rank 0's parameters broadcast to rank 1), an async checkpoint saved
   by both ranks (rank 0 merges and commits); against one process on the
   whole batch on the card within the CPU tests' trajectory tolerances,
   and the one-process restore of the checkpoint bitwise equal to rank
   0's state. The launcher's and each rank's exit code fail the phase;
19. tensor parallelism and ZeRO stages 1-2, two gloo ranks on the card:
   [19a] mp 2 ([18b]'s model against its one process; the 1.3B cut to
   8 of its 24 layers at batch 2 x 1024 a rank: launches, mp
   collectives, step, memory and bytes against one process of the same
   cut); [19b] sharding 2 at ``os`` and ``os_g``
   (parity, replicas, optimizer bytes, a checkpoint one process
   restores);
20. ZeRO stage 3 and the gradient reductions: [20a] (0) 6's model and
   optimizer at ``p_g_os`` over an NCCL group of one rank (two steps
   bitwise equal to the no-mesh step; gathers, reduce-scatters, launches
   and step against 6's); (i) two gloo ranks at sharding 2 on [18b]'s
   model, 3 steps within 1e-6 of its one process and bitwise equal to
   [19b]'s ``os_g`` run, the whole parameters equal on both ranks, a
   checkpoint one process restores bitwise; (ii) the 1.3B cut to 8
   layers at ``p_g_os``, batch 2 x 1024 a rank: launches (flash on wgmma,
   LayerNorm, AdamW on slices), gathers and their share of the host
   clock in a further step that times each, the gathered weights alive at most against a block's, step,
   peak memory and bytes against one process's and ``os_g``'s; [20b] two
   gloo ranks at dp 2 on [18b]'s model, 6 steps under ``grad_reduce``
   None, fp32 (bitwise None's), int8 with error feedback (within 1% of
   fp32 at every step) and bf16, one int8 and one bf16 reduction
   repeated on the CPU tensors of the same per-rank gradients (reduced
   gradients bitwise, residuals within a rounding): each mode's plan
   bytes, reduction host clock and step. Each multi-rank phase holds
   AdamW to one launch a step and no master copied by ``copy_``. In [3],
   the fused AdamW against ``torch._fused_adamw_`` and against the
   per-tensor path (a launch and a ``copy_`` a tensor): on all-fp32
   tensors at n 16.8M and at [20a] (ii)'s slice, in [6]'s dtypes with the
   bf16 copy at n 16.8M, over [6]'s list in fp32 and in its dtypes, and
   over [16]'s list in bf16, 12 interleaved CUDA-event readings each and
   the profiler's device time;
21. expert parallelism (GPT-MoE routed over the global batch across
   ranks), gloo ranks on the card started by the port's launcher: [21a]
   two ranks at ep 2 (``--ep-worker``): config 5's width at depth 2 in
   fp32, half of an 8 x 1024 batch each, 3 steps dense and 3 quant,
   against one process on the whole batch on the card ([18b]'s
   tolerances; quant within the CPU tests' quant bounds); then the full
   config 5 in bf16 at 4 x 1024 a rank, dense and quant: a warm-up step
   (the dropped share), 3 timed steps (host clock against [16]'s, the
   exchanges' calls, received bytes and host-clock share, launches and
   master copies), one profiled (flash on wgmma, LayerNorm and one AdamW
   a step by kernel symbol), the loss finite and falling, dense against
   quant (exchange bytes and the plan's wire bytes, step); [21b] four
   ranks at sharding 2 x ep 2 at ``p_g_os`` (``--ep4-worker``): the same
   depth-2 fp32 model on 2 x 1024 a rank, 3 steps against the same one
   process, the expert stacks stored as stage-3 slices, each rank's bytes
   against one process's, and the one-process restore of their
   checkpoint bitwise equal to rank 0's gathered state;
22. GPT-MoE at mp, grad_reduce at ep and resharding, gloo ranks on the
   card, one launcher start for each world size (``--mx-worker``,
   ``--mx4-worker``): [22a] [21a]'s depth-2 fp32 model at mp 2 (the
   experts whole on both ranks, the whole batch) and at ep 2 x mp 2
   (four ranks), 3 steps each against [21a]'s one process ([18b]'s
   tolerances); the full config 5 in bf16 at mp 2 (8 heads a rank), 4 x
   1024 a rank: a warm-up step, 3 timed (host clock against [16]'s,
   launches, no master copy), one profiled (flash on wgmma, LayerNorm,
   one AdamW by kernel symbol), the loss finite and falling; [22b] the
   depth-2 model at ep 2 under grad_reduce fp32 and int8 (each rank
   routing its own rows over the whole stacks): a reduction repeated on
   the CPU (reduced gradients bitwise), the losses and parameters against
   one process routing each rank's rows alone (fp32 within [18b]'s
   tolerances, int8 within 1% of it and Adam's bound); [22c] the full GPT-3
   1.3B at [6]'s configuration and optimizer, 1 step at mp 2 and saved;
   restored from the files onto a ``p_g_os`` step at sharding 2 (every
   leaf bitwise the saved global arrays' block, each rank's bytes read
   equal to its blocks' bytes) and whole by rank 0 alone; then device to
   device from the mp-2 step's live blocks through the resharding
   executor (the bytes received over both ranks equal to the plans'
   ``bytes_wire``, printed beside ``bytes_naive``, bitwise the file path,
   the restore's time); one more step on the new layout, its loss finite;
23. serving a split model and the sharded save, gloo ranks on the card in
   [22]'s launcher starts (``--split-worker``, ``--split4-worker``): [23a]
   [22c]'s mp-2 step (held from [22]'s worker) saved through
   ``CheckpointManager`` with nothing gathered: no tensor collective,
   each rank's bytes written equal to its replica-0 blocks', the two
   ranks' together [22c]'s gathered save's; restored whole on rank 0 and
   onto [22c]'s ``p_g_os`` step at sharding 2, both bitwise [22c]'s
   save's; [23b] the 1.3B at mp 2 behind the paged engine ([4]'s 8 slots,
   S_max 2048, page 16, requests and warm-ups), its weights by
   ``load_weights`` device to device from the stage-3 step's live blocks
   (the bytes received over both ranks equal to the plans'
   ``bytes_wire``): throughput, TTFT and TPOT beside [4]'s, the programs
   eager over gloo (no capture), a decode step's collectives and their
   share of its host clock, KV-cache and parameter bytes a rank against
   one process's; one step that prefills a request and decodes it
   profiled (2 (2L + 1) LayerNorms, L bf16 flash forwards on wgmma at 8
   heads, L paged decodes' split and combine on the vector route); both
   ranks' tokens equal; rank 0's one process on the same weights: the
   first request's prefill logits within ``SPLIT_LOGIT_TOL`` of the
   largest, the share of greedy tokens equal; [23c] the 1.3B's width at mp
   2 and config 5's at ep 2 (two ranks) and at ep 2 x mp 2 (four), depth
   2, fp32, their weights from a sharded save of the same model: the
   paged engine with the prefix cache and speculation, the dense engine
   and ``generate``, greedy tokens equal to one process on the card and
   on every rank, sampled ones equal on every rank; [23d] a
   ``MoELayer(group=)`` of config 5's FFN width at ep 2 under grad_reduce
   fp32 and int8 (every expert's gradient reduced under its JAX name): a
   reduction repeated on the CPU, the reduced gradients bitwise.
24. pipeline parallelism, gloo ranks on the card in the same launcher
   starts (``--pp-worker``, ``--pp4-worker``): [24a] the 1.3B's width at
   depth 4 in fp32 at pp 2 under 1f1b (M 2 and 4), gpipe, no remat and 2
   virtual stages, config 5's width with every block MoE under 1f1b and
   gpipe, and four ranks at pp 2 x dp 2 and pp 2 x mp 2, each against one
   process's plain step on the card on the same weights (losses within
   ``DP_LOSS_TOL``, every parameter, the stages joined, within
   ``DP_PARAM_TOL``), every fp32 flash launch on the CUDA cores; with
   dropout the 1f1b, gpipe and no-remat runs and a repeat equal to the
   bit; [24b] GPT-3 1.3B whole at pp 2 (12 blocks a stage), bf16, [6]'s
   AdamW, ``PP_MAIN_B`` x ``PP_MAIN_S`` at M ``PP_MAIN_M``, 1f1b with
   remat: each rank's step by host clock against one process's at the
   batch, the transfers' calls and bytes against the 1F1B table's and
   their host share, parameter and optimizer elements against the whole
   model's, launches and the profiler's kernels against the counts the
   code gives (2 flash forwards, 1 dq and 1 dk/dv a block a microbatch,
   4 + 2 LayerNorm forwards and 2 + 1 backwards on the last stage, one
   AdamW), and peak memory at ``PP_MEM_M`` microbatches under 1f1b with
   remat against gpipe without; [24c] [24a]'s model in bf16 saved
   sharded (no tensor collective, each rank's bytes its replica-0
   blocks'), restored onto a step of other weights bitwise and resumed
   within ``DP_LOSS_TOL``. The two ranks share the card, so their stages'
   work serialises: no pipeline bubble is measured.

The ranks of [18b]-[24] start once for each world size: each rank runs
the phases' workers in turn (``launch_chain``), and each phase then checks
its ranks' records (``chained_records``); ``--mp-of``, ``--zero3-of``,
``--ep-of``, ``--mx-of``, ``--split-of`` and ``--pp-of`` chain only their
own phases' workers (``--split-of``'s take [22c]'s step and gathered save
themselves).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
``paddle_tpu_torch`` package beside this file, it exits non-zero and
prints no result.
"""

from __future__ import annotations

import argparse
import functools
import gc
import hashlib
import importlib
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense): bf16 tensor cores, fp32 CUDA cores,
# device memory
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

TOL = {  # max |kernel - plain| accepted, by (kernel, dtype)
    ("layer_norm", "float32"): 1e-4,
    # bf16 outputs of |y| < 8 differ by at most one rounding step (2^-5)
    ("layer_norm", "bfloat16"): 3.2e-2,
    ("flash", "float32"): 1e-4,
    ("flash_lse", "float32"): 1e-4,
    # P is rounded to bf16 against the running (tile) max in the kernel and
    # against the row max in the plain version: ~2^-8 relative on O
    ("flash", "bfloat16"): 2e-2,
    ("flash_lse", "bfloat16"): 1e-3,
    ("paged", "float32"): 1e-4,
    ("paged", "bfloat16"): 2e-2,
    ("flash_bwd", "float32"): 1e-4,
    # dq/dk/dv of |d| < 8 round to bf16: one rounding step is 2^-5; ds and
    # P are rounded to bf16 in both versions, so a rounding that flips on
    # an fp32 ulp moves a sum by about that much as well
    ("flash_bwd", "bfloat16"): 3.2e-2,
    ("rms_norm", "float32"): 1e-4,
    # as LayerNorm: bf16 outputs of |y| < 8 within one rounding step
    ("rms_norm", "bfloat16"): 3.2e-2,
}
# the norms' gradients, relative to their largest entry: in bf16 one
# rounding step of that entry (the kernel's fp32 sums run in another order
# than the plain version's, so a value's rounding may flip); in fp32 1e-5
# (dw and db sum up to 32768 rows, dx a row of up to 2050 values)
NORM_GRAD_STEP = {"float32": 1e-5, "bfloat16": 2 ** -7}
# the norm kernels, by symbol (csrc/norms.cu): the warp route's forward and
# backward, and the backward's sum of its per-block partials of dw and db
NORM_SYMBOLS = {"fwd": "norm_fwd_warp_kernel", "bwd": "norm_bwd_warp_kernel",
                "reduce": "norm_bwd_reduce_kernel"}
# the paged-decode kernels, by symbol (csrc/paged_decode.cu): each split of
# a slot's live pages, then the merge of a slot's splits
PAGED_SYMBOLS = {"split": "paged_decode_split_kernel",
                 "combine": "paged_decode_combine_kernel"}
# the primitives' tolerance, relative to the largest output: one rounding
# step of the output dtype (the kernels' tanh, contractions and summation
# order differ from PyTorch's by ulps of fp32)
PRIMITIVE_STEP = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}
# the kernels and the path that launches them
SERVING_KERNELS = ("fused_layer_norm", "flash_attention_fwd",
                   "paged_attention")
TRAINING_KERNELS = ("fused_layer_norm", "layer_norm_bwd",
                    "flash_attention_fwd", "flash_attention_bwd_dq",
                    "flash_attention_bwd_dkv", "fused_adamw_multi")
USER_API_KERNELS = ("fused_rms_norm", "rms_norm_bwd", "elementwise_kernel",
                    "row_reduce_kernel")
# the bf16 flash kernels, by symbol: the forward (csrc/flash_fwd_sm90.cu)
# and the backward's two (csrc/flash_bwd_sm90.cu); the fp32 route's
# CUDA-core kernels (csrc/flash_fwd.cu, csrc/flash_bwd.cu)
FWD_SYMBOL = "flash_fwd_sm90_kernel"
BWD_SYMBOLS = {"dq": "flash_bwd_dq_sm90_kernel",
               "dkv": "flash_bwd_dkv_sm90_kernel"}
SM90_LIBS = {"flash_fwd_sm90": (FWD_SYMBOL,),
             "flash_bwd_sm90": tuple(BWD_SYMBOLS.values())}
FP32_FWD_SYMBOL = "flash_fwd_kernel"
FP32_BWD_SYMBOLS = {"dq": "flash_bwd_dq_kernel",
                    "dkv": "flash_bwd_dkv_kernel"}
# the fp32 (CUDA-core) flash calls of the fp32 phases, (B, S, H, D): [5]'s
# largest prefill bucket, and [7]'s and [9]'s training batch (both 2 x 128
# at full width, causal)
FP32_FLASH = {"[5] prefill": (1, 128, 16, 128),
              "[7], [9] training": (2, 128, 16, 128)}
# the serving kernels' symbols on the card, by wrapper
SERVING_SYMBOLS = {"fused_layer_norm": (NORM_SYMBOLS["fwd"],),
                   "flash_attention_fwd": (FWD_SYMBOL,),
                   "paged_attention": tuple(PAGED_SYMBOLS.values())}
# the kernels that open every profiler window (``torch.cuda._sleep``'s),
# launched LEAD_IN_WAIT seconds after it opens
LEAD_IN, LEAD_SYMBOL, LEAD_IN_WAIT = 64, "spin_kernel", 0.1
# profiler windows over the same graph replays before a count short of
# what they launch fails (``replay_launches``)
REPLAY_WINDOWS = 3
FLASH_WRAPPERS = ("flash_attention_fwd", "flash_attention_bwd_dq",
                  "flash_attention_bwd_dkv")
# the shapes GPT-MoE ([16], [17]; H 1024, 16 heads of 64) gives the flash
# kernels, as (B, S, Hq, Hkv, D, causal): the training batch, generate's
# prefill, the engine's prefill buckets, and the depth-2 fp32 runs' training
# batch and generate prefill; at ep 2 a rank's rows ([21], [22b]); at mp 2
# ([22a]) a rank's 8 heads, on the main path's 4 x 1024 a rank and the
# depth-2 runs' whole batch
MOE_FLASH = [(8, 1024, 16, 16, 64, True), (8, 512, 16, 16, 64, True),
             (1, 128, 16, 16, 64, True), (1, 512, 16, 16, 64, True),
             (1, 1024, 16, 16, 64, True), (2, 256, 16, 16, 64, True),
             (4, 64, 16, 16, 64, True), (4, 1024, 16, 16, 64, True),
             (4, 1024, 8, 8, 64, True), (8, 1024, 8, 8, 64, True)]
# ... and the LayerNorm: the training rows, decode, a prefill bucket's rows,
# generate's prefill, the depth-2 runs' training batch and generate
# prefill, and a rank's 4 x 1024 rows at ep 2 and at mp 2
MOE_NORM = [(8192, 1024), (8, 1, 1024), (1, 128, 1024), (1, 512, 1024),
            (1, 1024, 1024), (8, 512, 1024), (2, 256, 1024), (4, 64, 1024),
            (2, 1, 1024), (4, 1024, 1024)]
ALL_KERNELS = ("fused_layer_norm", "layer_norm_bwd", "flash_attention_fwd",
               "paged_attention", "flash_attention_bwd_dq",
               "flash_attention_bwd_dkv", "fused_adamw_multi") \
    + USER_API_KERNELS
# the functions this script lifts into primitives
ELEMENTWISE_FNS = {
    "x + a*y": lambda x, y, a: x + a * y,
    "x + a*tanh(y)": lambda x, y, a: x + a * torch.tanh(y),
}
REDUCE_FNS = {
    "row sum": (lambda acc, b: acc + b.sum(-1), 0.0),
    "row max": (lambda acc, b: torch.maximum(acc, b.amax(-1)),
                float("-inf")),
}
# where phase 15 writes its token files and its 1.3B checkpoint (13.2 GB):
# the temp directory (``tempfile``'s, TMPDIR when set), a disk with 75 GB
# free on the card's machine, where /dev/shm is memory
CKPT_PARENT = None
ADAMW_HP = dict(lr=1e-4, beta1=0.9, beta2=0.999, eps=1e-8, weight_decay=0.01,
                beta1_pow=0.9 ** 3, beta2_pow=0.999 ** 3)
# the (param, grad, moments) dtype combinations the fused AdamW takes: the
# grad in the param's dtype, or bf16 beside an fp32 master
ADAMW_COMBOS = [(pd, gd, md) for pd in (torch.float32, torch.bfloat16)
                for gd in (torch.float32, torch.bfloat16)
                for md in (torch.float32, torch.bfloat16)
                if gd == pd or gd == torch.bfloat16]


def adamw_wrapper(K) -> str:
    """The fused AdamW wrapper a train step launches through: the grouped
    one, or the per-tensor one of a tree that has no grouped launch (an
    earlier checkout under --train-of or --moe-of)."""
    return "fused_adamw_multi" if hasattr(K, "fused_adamw_multi") \
        else "fused_adamw_update"


def training_kernels(K):
    """``TRAINING_KERNELS`` by the wrapper names of the package ``K``."""
    return tuple(adamw_wrapper(K) if k == "fused_adamw_multi" else k
                 for k in TRAINING_KERNELS)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def timed_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, kernel: str, iters: int):
    """Device time of one launch of ``kernel`` (a substring of its name),
    read by ``torch.profiler`` over ``iters`` calls of ``fn``: unlike
    ``timed_ms`` it excludes the host's launch cost. None when the profile
    holds no kernel of that name (a renamed kernel, or one the profiler
    missed), never 0."""
    fn()
    return kernel_ms(profile_kernels(lambda: [fn() for _ in range(iters)]),
                     kernel, iters)


def kernel_ms(kernels, kernel: str, per: int = 1):
    """Device ms of the kernels named ``*kernel*`` in ``kernels`` (as
    ``profile_kernels`` returns them) over ``per``; None if none is there."""
    seen = [t for name, t in kernels if kernel in name]
    return sum(seen) / per * 1e3 if seen else None


def fmt(ms, spec: str) -> str:
    return "not seen" if ms is None else format(ms, spec)


def bound(bytes_moved: float, ops: float, peak_ops: float):
    t_bytes, t_ops = bytes_moved / PEAK_BYTES, ops / peak_ops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def sass_counts(lib, opcode: str):
    """{kernel symbol: number of SASS instructions with ``opcode``} of a
    built library, read with ``cuobjdump -sass``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass {lib} failed: {out.stderr}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.search(rf"\b{opcode}\b", line):
            counts[fn] += 1
    return counts


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def check_flash_routes(K, route: str, what: str):
    """Every launch of the three flash wrappers since the counts were last
    reset took ``route`` (``wgmma`` on a bf16 path, ``cuda_cores`` on an
    fp32 one); returns their ``route_launches``."""
    counts = K.launch_counts()
    routes = {w: dict(getattr(K, w).route_launches) for w in FLASH_WRAPPERS}
    check(all(r[route] == sum(r.values()) == counts[w]
              for w, r in routes.items()),
          f"{what}: a flash launch left the {route} route: {routes}")
    return routes


def flash_inputs(randn, B, S, Hq, Hkv, D, dtype, view=None):
    """q [B, S, Hq, D], k and v [B, S, Hkv, D]. ``view``: None for three
    tensors; "fused" for the column slices of one [B, S, (Hq + 2 Hkv) D]
    projection, as models/gpt.py makes them (TMA reads them in place);
    "copied" for slices of a projection 4 elements wider, whose sequence
    stride is not a 16-byte multiple (the bf16 route copies them first)."""

    if view is None:
        return (randn(B, S, Hq, D, dtype=dtype),
                randn(B, S, Hkv, D, dtype=dtype),
                randn(B, S, Hkv, D, dtype=dtype))
    FA = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    pad = 4 if view == "copied" else 0
    qkv = randn(B, S, (Hq + 2 * Hkv) * D + pad, dtype=dtype)
    q, k, v = (t.unflatten(-1, (-1, D)) for t in qkv.split(
        [Hq * D, Hkv * D, Hkv * D, pad], dim=-1)[:3])
    kept = [FA._for_tma(t) is t for t in (q, k, v)]
    check(all(kept) if view == "fused" else not any(kept),
          f"{view} views: kept in place for TMA: {kept}")
    return q, k, v


# ---------------------------------------------------------------- phase 3
def kernel_checks(K, gen):
    """Kernel vs plain on the card; returns the JSON rows (launch counts are
    filled in from the slice run)."""

    dev = torch.device("cuda")
    F = torch.nn.functional
    rows = {}

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    # -- flash forward: the serving shapes (prefill B=1, H=16, D=128,
    #    causal; a ragged S, GQA 16/4, D 64; the engine's captured prefill
    #    buckets S 128 and 512 and generate's B 8 S 512; GPT-MoE's D 64
    #    at MOE_FLASH) on both routes (bf16 on the tensor cores, fp32 on the
    #    CUDA cores); then, in bf16, the edges of
    #    the 64-row tiles (S 1, 63, 64, 65, 200), GQA 16/1 and D 64, q/k/v
    #    as the fused qkv projection's column slices read in place by TMA,
    #    and slices TMA cannot read, which are copied first. Each call must
    #    add one launch to its dtype's route

    FA = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    FWD = K.flash_attention_fwd
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [(1, 1024, 16, 16, 128, True), (1, 200, 16, 16, 128, True),
             (2, 130, 16, 4, 128, False), (1, 256, 16, 16, 64, True),
             (8, 512, 16, 16, 128, True), (1, 512, 16, 16, 128, True),
             (1, 128, 16, 16, 128, True)] + MOE_FLASH
    edges = [(1, 1, 16, 16, 128, True), (1, 63, 16, 16, 128, True),
             (1, 64, 16, 16, 128, False), (2, 65, 16, 16, 128, True),
             (1, 200, 16, 1, 128, True), (2, 65, 16, 4, 64, True),
             (2, 63, 16, 1, 64, False)]
    fused = [(2, 200, 16, 16, 128, True), (2, 130, 16, 4, 128, False),
             (1, 65, 16, 1, 64, True)]
    runs = ([(dt, c, None) for dt in (f32, bf16) for c in cases]
            + [(bf16, c, None) for c in edges]
            + [(bf16, c, "fused") for c in fused]
            + [(bf16, (2, 77, 16, 4, 128, True), "copied")])
    for dtype, (B, S, Hq, Hkv, D, causal), view in runs:
        dn = str(dtype).split(".")[1]
        q, k, v = flash_inputs(randn, B, S, Hq, Hkv, D, dtype, view)
        route = FA.FWD_ROUTES[dtype]
        want_routes = dict(FWD.route_launches)
        want_routes[route] += 1
        o, lse = FWD(q, k, v, causal=causal)
        o_ref, lse_ref = K.flash_attention_ref(q, k, v, causal=causal)
        eo, el = max_err(o, o_ref), max_err(lse, lse_ref)
        to, tl = TOL[("flash", dn)], TOL[("flash_lse", dn)]
        print(f"  flash_fwd {str(dtype):15s} B{B} S{S} H{Hq}/{Hkv} D{D} "
              f"causal={causal}{f' {view} views' if view else ''} ({route}): "
              f"O err {eo:.3e} (tol {to:.1e}), LSE err {el:.3e} (tol "
              f"{tl:.1e})", flush=True)
        check(FWD.route_launches == want_routes,
              f"flash_fwd {dtype} did not take its {route} route once: "
              f"{FWD.route_launches}")
        check(eo <= to and el <= tl and o.shape == o_ref.shape
              and o.dtype == o_ref.dtype, f"flash {dtype} S{S} H{Hq}/{Hkv} "
              f"D{D}{f' {view}' if view else ''}: O {eo}, LSE {el}")
    B, S, Hq, D = 1, 1024, 16, 128
    q, k, v = (randn(B, S, Hq, D, dtype=bf16) for _ in range(3))
    ms = timed_ms(lambda: FWD(q, k, v, causal=True), 20)
    plain = timed_ms(lambda: K.flash_attention_ref(q, k, v, causal=True), 20)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    lib = timed_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), 20)
    pairs = S * (S + 1) // 2
    ops = 4 * D * pairs * B * Hq
    bms, by = bound(4 * B * S * Hq * D * 2 + B * Hq * S * 4, ops, PEAK_BF16)
    err = max_err(FWD(q, k, v, causal=True)[0],
                  K.flash_attention_ref(q, k, v, causal=True)[0])
    dms = device_ms(lambda: FWD(q, k, v, causal=True), FWD_SYMBOL, 10)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    f32_dms = device_ms(lambda: FWD(q32, k32, v32, causal=True),
                        FP32_FWD_SYMBOL, 10)
    print(f"  flash_fwd bf16 S{S} (wgmma): kernel {ms:.4f} ms (device "
          f"{fmt(dms, '.4f')} ms), plain {plain:.4f} ms, F.sdpa {lib:.4f} "
          f"ms, bound {bms:.5f} ms ({by}); fp32 route (CUDA cores) on the "
          f"same values: device {fmt(f32_dms, '.4f')} ms", flush=True)
    check(dms is not None and f32_dms is not None,
          f"the profiler did not see {FWD_SYMBOL} / {FP32_FWD_SYMBOL}: "
          f"{dms} / {f32_dms}")
    rows["flash_attention_fwd"] = dict(
        name="flash_attention_fwd", route="cuda",
        routes={"bfloat16": "cuda wgmma", "float32": "cuda fp32 CUDA cores"},
        source="paddle_tpu_torch/kernels/csrc/flash_fwd_sm90.cu",
        float32_source="paddle_tpu_torch/kernels/csrc/flash_fwd.cu",
        replaces="paddle_tpu/kernels/flash_attention.py:44",
        shape="bf16 B1 S1024 H16 D128 causal (prefill bucket)",
        max_abs_err=err, ms=ms, device_ms=dms, tflops=ops / dms * 1e-9,
        float32_device_ms=f32_dms, plain_ms=plain, bound_ms=bms,
        bound_by=by, library_ms=lib)

    # -- paged decode: the slice's shapes (B 8, H 16/16, D 128, ps 16,
    #    S_max 2048), the repo's GQA serving config (H 16/4, D 64, S_max
    #    1024) and GPT-MoE's paged engine (H 16/16, D 64, S_max 1024);
    #    ragged positions, sentinel tails, and one empty slot; every call
    #    on the vector route, two calls bitwise equal
    PAGED = K.paged_attention
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for B, Hq, Hkv, D, S_max in ((8, 16, 16, 128, 2048),
                                     (8, 16, 4, 64, 1024),
                                     (8, 16, 16, 64, 1024)):
            args = paged_case(gen, B, Hq, Hkv, D, 16, S_max, dtype, 1,
                              S_max - 1)
            want = PAGED.route_launches["vector"] + 2
            out = PAGED(*args)
            again = PAGED(*args)
            ref = K.paged_attention_ref(*args)
            err = max_err(out, ref)
            tol = TOL[("paged", dn)]
            print(f"  paged_decode {str(dtype):15s} B{B} H{Hq}/{Hkv} D{D} "
                  f"S_max {S_max}: max_abs_err {err:.3e} (tol {tol:.1e}), "
                  f"finite={bool(torch.isfinite(out).all())}, two calls "
                  f"bitwise equal={torch.equal(out, again)}", flush=True)
            check(err <= tol and bool(torch.isfinite(out).all()),
                  f"paged_decode {dtype} H{Hq}/{Hkv}: {err}")
            check(torch.equal(out, again), f"paged_decode {dtype} "
                  f"H{Hq}/{Hkv}: two calls differ")
            check(PAGED.route_launches["vector"] == want,
                  f"paged_decode {dtype} left the vector route: "
                  f"{PAGED.route_launches}")
    PA = importlib.import_module("paddle_tpu_torch.kernels.paged_attention")
    shapes = paged_shapes(K, gen, PAGED_SYMBOLS)
    for sh, (_, case) in zip(shapes, PAGED_SHAPES):
        _, Hq, Hkv, D, ps, S_max = case[:6]
        sh["plan"] = PA.plan(Hq, Hkv, ps, S_max // ps, D, 2, (0,))._asdict()
        print(f"  paged_decode plan at {sh['shape']}: {sh['plan']}",
              flush=True)
        check(sh["device_ms"] is not None,
              f"the profiler did not see {' and '.join(PAGED_SYMBOLS.values())}"
              f" at {sh['shape']}: {sh['kernels_ms']}")
        check(sh["max_abs_err"] <= TOL[("paged", "bfloat16")],
              f"paged_decode at {sh['shape']}: {sh['max_abs_err']}")
    sl = shapes[0]
    rows["paged_attention"] = dict(
        name="paged_attention", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/paged_decode.cu",
        replaces="paddle_tpu/kernels/paged_attention.py:43",
        shape=sl["shape"], max_abs_err=sl["max_abs_err"], ms=sl["ms"],
        device_ms=sl["device_ms"], kernels_ms=sl["kernels_ms"],
        plain_ms=sl["plain_ms"], bound_ms=sl["bound_ms"],
        bound_by=sl["bound_by"], library_ms=None, plan=sl["plan"],
        shapes=shapes[1:])
    return rows


def paged_case(gen, B, Hq, Hkv, D, ps, S_max, dtype, lo, hi, empty=True,
               at=None):
    """q, pools of B * S_max / ps + 1 pages, a table and positions: ragged
    positions in [lo, hi) (or every slot at ``at``), slot b's live pages
    distinct random pool pages and the rest of its row the sentinel; with
    ``empty`` the last slot is at position 0 with an all-sentinel row."""
    from paddle_tpu_torch.serving.kv_cache import PAGE_SENTINEL

    dev = torch.device("cuda")
    nb = S_max // ps
    P = B * nb + 1
    kp = torch.randn(P, Hkv, ps, D, generator=gen, device=dev).to(dtype)
    vp = torch.randn(P, Hkv, ps, D, generator=gen, device=dev).to(dtype)
    pos = torch.randint(lo, hi, (B,), generator=gen, device=dev) \
        if at is None else torch.full((B,), at, device=dev)
    if empty:
        pos[-1] = 0
    table = torch.full((B, nb), PAGE_SENTINEL, dtype=torch.int32)
    perm = torch.randperm(P - 1, generator=gen, device=dev).cpu() + 1
    used = 0
    for b in range(B - 1 if empty else B):
        n = int(pos[b]) // ps + 1
        table[b, :n] = perm[used:used + n]
        used += n
    q = torch.randn(B, Hq, 1, D, generator=gen, device=dev).to(dtype)
    return (q, kp, vp, table.to(dev), pos.to(torch.int32))


# the paged decode's timed shapes, bf16 at ps 16, as ``paged_case``'s
# arguments: the serving slice's decode batch (8 slots with prompts of 128
# and 300-700 tokens plus up to 32 generated, one empty), every slot of it
# at the table's last token, one slot there, and the GQA serving config at
# random positions
PAGED_SHAPES = [
    ("B8 H16/16 D128 nb128, positions 128-733 (slice)",
     (8, 16, 16, 128, 16, 2048, torch.bfloat16, 128, 733)),
    ("B8 H16/16 D128 nb128, every slot at 2047",
     (8, 16, 16, 128, 16, 2048, torch.bfloat16, 0, 0, False, 2047)),
    ("B1 H16/16 D128 nb128, position 2047",
     (1, 16, 16, 128, 16, 2048, torch.bfloat16, 0, 0, False, 2047)),
    ("B8 H16/4 D64 nb64, random positions (GQA config)",
     (8, 16, 4, 64, 16, 1024, torch.bfloat16, 1, 1023))]


def paged_shapes(K, gen, symbols):
    """``K.paged_attention`` timed at ``PAGED_SHAPES``. Device ms is the
    sum over ``symbols`` (substrings of kernel names; None when one is not
    seen) per call."""
    out = []
    for label, case in PAGED_SHAPES:
        args = paged_case(gen, *case)
        q, kp, _, table, pos = args
        Bc, Hq, _, Dc = q.shape
        _, Hkv, ps, _ = kp.shape
        live_pages = sum(int(p) // ps + 1 for p in pos.tolist())
        tokens = sum(int(p) + 1 for p in pos.tolist())
        call = functools.partial(K.paged_attention, *args)
        ms = timed_ms(call, 200)
        plain = timed_ms(functools.partial(K.paged_attention_ref, *args), 20)
        bms, by = bound(live_pages * Hkv * ps * Dc * 2 * 2
                        + 2 * Bc * Hq * Dc * 2 + table.numel() * 4 + Bc * 4,
                        4 * Dc * Hq * tokens, PEAK_BF16)
        err = max_err(call(), K.paged_attention_ref(*args))
        call()
        kernels = profile_kernels(lambda: [call() for _ in range(50)])
        per = {name: kernel_ms(kernels, sym, 50)
               for name, sym in symbols.items()}
        dms = None if None in per.values() else sum(per.values())
        print(f"  paged_decode bf16 {label}: {live_pages} live pages, "
              f"kernel {ms:.4f} ms (device {fmt(dms, '.4f')} ms = "
              f"{per}), plain {plain:.4f} ms, bound {bms:.5f} ms ({by}), "
              f"max_abs_err {err:.3e}", flush=True)
        out.append(dict(shape=f"bf16 {label}, ps16, {live_pages} live pages",
                        live_pages=live_pages, ms=ms, device_ms=dms,
                        kernels_ms=per, plain_ms=plain, bound_ms=bms,
                        bound_by=by, max_abs_err=err))
        del args, kp, call
        torch.cuda.empty_cache()
    return out


def norm_checks(K, gen, rows):
    """LayerNorm and RMSNorm, forward and backward, vs plain on the card:
    every route and ragged edge, then timed at decode rows [8, 2048] and
    training rows [32768, 2048]; adds the four kernels' rows to ``rows``."""
    dev = torch.device("cuda")
    F = torch.nn.functional
    f32, bf16 = torch.float32, torch.bfloat16
    H = 2048
    norms = {  # forward, backward, plain forward, plain backward, eps
        "layer_norm": (K.fused_layer_norm, K.layer_norm_bwd,
                       K.layer_norm_ref, K.layer_norm_bwd_ref, 1e-5),
        "rms_norm": (K.fused_rms_norm, K.rms_norm_bwd, K.rms_norm_ref,
                     K.rms_norm_bwd_ref, 1e-6)}

    def case(norm, shape, dtype):
        Hc = shape[-1]
        x = (torch.randn(*shape, generator=gen, device=dev) * 2 + 0.5) \
            .to(dtype)
        w = (1 + 0.1 * torch.randn(Hc, generator=gen, device=dev)).to(dtype)
        b = (0.1 * torch.randn(Hc, generator=gen, device=dev)).to(dtype)
        dy = torch.randn(*shape, generator=gen, device=dev).to(dtype)
        return x, ((w, b) if norm == "layer_norm" else (w,)), dy

    # -- every route and edge: R 1, 3, 8 (decode), 231, 32768 (training)
    #    rows by H 7, 100, 768, 2048, 2050 in both dtypes, and the serving
    #    slices' leading shapes (decode [8, 1], prefill [1, 1024], the
    #    verify step's [8, k+1] = [8, 4] rows, the prefix hits' suffix
    #    buckets [1, 64 / 128 / 256], the prefill bucket [1, 512] and
    #    generate's prefill [8, 512]) and GPT-MoE's at H 1024 (MOE_NORM);
    #    one forward and one backward launch
    #    per call on the expected route (warp: H a multiple of the 16-byte
    #    vector and at most 2048; else block)
    shapes = [(R, Hc) for R in (1, 3, 8, 32, 231, 32768)
              for Hc in (7, 100, 768, 2048, 2050)] + [
        (8, 1, H), (1, 1024, H), (3, 77, H), (8, 4, H), (1, 64, H),
        (1, 128, H), (1, 256, H), (1, 512, H), (8, 512, H)] + MOE_NORM
    for norm, (fwd, bwd, fwd_ref, bwd_ref, eps) in norms.items():
        for dtype in (f32, bf16):
            dn = str(dtype).split(".")[1]
            tol = TOL[(norm, dn)]
            for shape in shapes:
                x, params, dy = case(norm, shape, dtype)
                Hc = shape[-1]
                route = ("warp" if Hc % (16 // x.element_size()) == 0
                         and Hc <= 2048 else "block")
                before = [(w.launches, w.route_launches[route])
                          for w in (fwd, bwd)]
                y = fwd(x, *params, eps)
                grads = bwd(x, params[0], dy, eps)
                check([(w.launches, w.route_launches[route])
                       for w in (fwd, bwd)] == [(n + 1, r + 1)
                                                for n, r in before],
                      f"{norm} {dtype} {shape}: not one launch of each on "
                      f"the {route} route")
                err_y = max_err(y, fwd_ref(x, *params, eps))
                errs = [(max_err(g, r), norm_grad_tol(r)) for g, r in
                        zip(grads, bwd_ref(x, params[0], dy, eps))]
                print(f"  {norm} {dn:8s} x{list(shape)} ({route}): y err "
                      f"{err_y:.2e} (tol {tol:.1e}); dx/dw"
                      f"{'/db' if len(errs) == 3 else ''} err "
                      f"{' '.join(f'{e:.2e}' for e, _ in errs)} (tol "
                      f"{' '.join(f'{t:.2e}' for _, t in errs)})",
                      flush=True)
                check(err_y <= tol and y.shape == x.shape
                      and all(e <= t for e, t in errs),
                      f"{norm} {dtype} {shape} ({route}): y {err_y} (tol "
                      f"{tol}), grads (err, tol) {errs}")

    # -- two backward calls at the training rows equal to the bit (a fixed
    #    grid and no atomics); then the times
    for norm, (fwd, bwd, fwd_ref, bwd_ref, eps) in norms.items():
        x, params, dy = case(norm, (32768, H), bf16)
        same = all(torch.equal(a, b) for a, b in zip(
            bwd(x, params[0], dy, eps), bwd(x, params[0], dy, eps)))
        print(f"  {norm} backward bf16 [32768, {H}]: two calls bitwise "
              f"equal {same}", flush=True)
        check(same, f"the {norm} backward is not deterministic")

    names = {"layer_norm": ("fused_layer_norm", "layer_norm_bwd", ":20",
                            ":78", "F.layer_norm"),
             "rms_norm": ("fused_rms_norm", "rms_norm_bwd", ":29", ":128",
                          "F.rms_norm")}
    for norm, (fwd, bwd, fwd_ref, bwd_ref, eps) in norms.items():
        fname, bname, fline, bline, libname = names[norm]
        ln = norm == "layer_norm"

        def lib_fwd(x, *params):
            return (F.layer_norm(x, (H,), *params, eps) if ln
                    else F.rms_norm(x, (H,), *params, eps))

        t = {}
        for R in (8, 32768):
            x, params, dy = case(norm, (R, H), bf16)
            n_par = len(params)
            ms = timed_ms(lambda: fwd(x, *params, eps), 200)
            plain = timed_ms(lambda: fwd_ref(x, *params, eps), 200)
            lib = timed_ms(lambda: lib_fwd(x, *params), 200)
            dms = device_ms(lambda: fwd(x, *params, eps), NORM_SYMBOLS["fwd"],
                            50)
            # the library call's device time: every kernel it launches
            lib_k = profile_kernels(
                lambda: [lib_fwd(x, *params) for _ in range(50)])
            lib_dms = sum(s for _, s in lib_k) / 50 * 1e3
            err = max_err(fwd(x, *params, eps), fwd_ref(x, *params, eps))
            bms, by = bound(2 * R * H * 2 + n_par * H * 2,
                            (8 if ln else 4) * R * H, PEAK_FP32)
            t[R] = dict(ms=ms, device_ms=dms, plain_ms=plain, library_ms=lib,
                        library_device_ms=lib_dms, bound_ms=bms, bound_by=by,
                        max_abs_err=err)
            print(f"  {fname} bf16 [{R}, {H}]: kernel {ms:.4f} ms (device "
                  f"{fmt(dms, '.4f')} ms), plain {plain:.4f} ms, {libname} "
                  f"{lib:.4f} ms (device {lib_dms:.4f} ms over "
                  f"{len(lib_k)} kernel(s) {[k for k, _ in lib_k][:2]}), "
                  f"bound {bms:.5f} ms ({by})", flush=True)
            check(dms is not None, f"the profiler did not see "
                  f"{NORM_SYMBOLS['fwd']} for {fname}")
        # the backward at the training rows: the kernel pair (rows, then
        # the partial sums of dw/db), the plain version, and the library's
        # backward through autograd (forward + backward - forward)
        R = 32768
        x, params, dy = case(norm, (R, H), bf16)
        ms = timed_ms(lambda: bwd(x, params[0], dy, eps), 50)
        kern = profile_kernels(
            lambda: [bwd(x, params[0], dy, eps) for _ in range(20)])
        dms_rows = kernel_ms(kern, NORM_SYMBOLS["bwd"], 20)
        dms_red = kernel_ms(kern, NORM_SYMBOLS["reduce"], 20)
        check(None not in (dms_rows, dms_red), f"the profiler did not see "
              f"{NORM_SYMBOLS['bwd']} / {NORM_SYMBOLS['reduce']}: {kern[:4]}")
        dms = dms_rows + dms_red
        plain = timed_ms(lambda: bwd_ref(x, params[0], dy, eps), 20)
        xs = [v.clone().requires_grad_() for v in (x, *params)]
        lib_f = timed_ms(lambda: lib_fwd(*xs), 50)
        lib_fb = timed_ms(lambda: torch.autograd.grad(lib_fwd(*xs), xs, dy),
                          50)
        got = bwd(x, params[0], dy, eps)
        err = max(max_err(g, r) for g, r in zip(
            got, bwd_ref(x, params[0], dy, eps)))
        # read x and g, write dx (bf16), read w, write dw (and db)
        bms, by = bound(3 * R * H * 2 + (1 + len(params)) * H * 2,
                        (15 if ln else 11) * R * H, PEAK_FP32)
        print(f"  {bname} bf16 [{R}, {H}]: kernel {ms:.4f} ms (device "
              f"{dms:.4f} ms = rows {dms_rows:.4f} + partial sums "
              f"{dms_red:.4f}), plain {plain:.4f} ms, {libname} backward "
              f"{lib_fb - lib_f:.4f} ms (fwd+bwd {lib_fb:.4f} - fwd "
              f"{lib_f:.4f}), bound {bms:.4f} ms ({by})", flush=True)
        del xs, x, params, dy, got
        common = dict(route="cuda",
                      source="paddle_tpu_torch/kernels/csrc/norms.cu")
        dec, tr = t[8], t[32768]
        rows[fname] = dict(
            name=fname, replaces=f"paddle_tpu/kernels/norms.py{fline}",
            shape=f"bf16 x[8, {H}] (decode rows)", **common, **dec,
            train_shape=f"bf16 x[32768, {H}] (training rows, B16 x S2048)",
            **{f"train_{k}": v for k, v in tr.items()})
        rows[bname] = dict(
            name=bname, replaces=f"paddle_tpu/kernels/norms.py{bline}",
            replaces_note="the backward rule, jnp that XLA fuses on the TPU",
            shape=f"bf16 x[32768, {H}], g (training rows)", **common,
            max_abs_err=err, ms=ms, device_ms=dms, rows_device_ms=dms_rows,
            partial_sums_device_ms=dms_red, plain_ms=plain,
            bound_ms=bms, bound_by=by, library_ms=lib_fb - lib_f)
    torch.cuda.empty_cache()


def norm_grad_tol(ref):
    """A norm gradient's tolerance: ``NORM_GRAD_STEP`` of its largest
    entry."""
    step = NORM_GRAD_STEP[str(ref.dtype).split(".")[1]]
    return step * ref.float().abs().max().item()


def train_kernel_checks(K, gen, rows):
    """The training kernels (flash backward, fused AdamW) vs plain on the
    card, then timed at the training slice's shapes; adds their rows to
    ``rows`` and the flash forward's training-shape numbers to its row."""

    # the module, not the package attribute of the same name (a function)
    FA = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    _delta = FA._delta

    BWD_WRAPPERS = (K.flash_attention_bwd_dq, K.flash_attention_bwd_dkv)
    dev = torch.device("cuda")
    F = torch.nn.functional

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    # -- flash backward: dq, dk, dv vs flash_attention_bwd_ref, from the
    #    forward kernel's O and LSE; ragged S, GQA 16/4 (dk/dv summed over
    #    each KV head's query heads) and D 64 in both dtypes (bf16 on the
    #    tensor cores, fp32 on the CUDA cores), and GPT-MoE's D 64 at
    #    MOE_FLASH; then, in bf16, the edges of
    #    the 64-row tiles (S 1, 63, 65, 200), GQA 16/1, D 64, and q/k/v as
    #    the column slices of a fused qkv projection, read in place by TMA
    cases = [(1, 1024, 16, 16, 128, True), (1, 200, 16, 16, 128, True),
             (2, 130, 16, 4, 128, False),
             (1, 256, 16, 16, 64, True)] + MOE_FLASH
    edges = [(1, 1, 16, 16, 128, True), (1, 63, 16, 16, 128, True),
             (2, 65, 16, 4, 128, False), (1, 200, 16, 1, 128, True),
             (2, 65, 16, 16, 64, True), (2, 63, 16, 1, 64, False)]
    fused = [(2, 200, 16, 16, 128, True), (2, 130, 16, 4, 128, False),
             (1, 65, 16, 1, 64, True)]
    bf16 = torch.bfloat16
    runs = ([(dt, c, False) for dt in (torch.float32, bf16) for c in cases]
            + [(bf16, c, False) for c in edges]
            + [(bf16, c, True) for c in fused])
    for dtype, (B, S, Hq, Hkv, D, causal), sliced in runs:
        dn = str(dtype).split(".")[1]
        tol = TOL[("flash_bwd", dn)]
        q, k, v = flash_inputs(randn, B, S, Hq, Hkv, D, dtype,
                               "fused" if sliced else None)
        do = randn(B, S, Hq, D, dtype=dtype)
        o, lse = K.flash_attention_fwd(q, k, v, causal=causal)
        route = FA.BWD_ROUTES[dtype]
        before = [w.route_launches[route] for w in BWD_WRAPPERS]
        got = K.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        want = K.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
        errs = [max_err(a, b) for a, b in zip(got, want)]
        mags = [b.float().abs().max().item() for b in want]
        print(f"  flash_bwd {str(dtype):15s} B{B} S{S} H{Hq}/{Hkv} D{D} "
              f"causal={causal}{' fused-qkv views' if sliced else ''} "
              f"({route}): dq/dk/dv err "
              f"{' '.join(f'{e:.3e}' for e in errs)} (tol {tol:.1e}; "
              f"max |d| {' '.join(f'{m:.2f}' for m in mags)})", flush=True)
        check([w.route_launches[route] for w in BWD_WRAPPERS]
              == [n + 1 for n in before],
              f"flash_bwd {dtype} did not take its {route} route once")
        check(all(e <= tol for e in errs) and all(
            g.shape == w.shape and g.dtype == w.dtype
            for g, w in zip(got, want)),
            f"flash_bwd {dtype} S{S} H{Hq}/{Hkv} D{D}: {errs}")

    # the training slice's shape, bf16 B16 S2048 H16 D128 causal: forward
    # (O and LSE), dq and dk/dv against their plain versions, which hold
    # [B, H, S, S] fp32 scores, so they run one batch row at a time. The
    # backward's plain version starts from the forward kernel's O and LSE,
    # which are held to theirs first
    B, S, Hq, D = 16, 2048, 16, 128
    q, k, v, do = (randn(B, S, Hq, D, dtype=bf16) for _ in range(4))
    o, lse = K.flash_attention_fwd(q, k, v, causal=True)
    o2, lse2 = K.flash_attention_fwd(q, k, v, causal=True)
    same = torch.equal(o, o2) and torch.equal(lse, lse2)
    print(f"  flash_fwd bf16 B{B} S{S} H{Hq} D{D} causal: two calls bitwise "
          f"equal {same}", flush=True)
    check(same, "the bf16 flash forward is not deterministic")
    del o2, lse2
    delta = _delta(o, do)

    def bwd():
        return (K.flash_attention_bwd_dq(q, k, v, do, lse, delta, True),
                *K.flash_attention_bwd_dkv(q, k, v, do, lse, delta, True))

    dq, dk, dv = bwd()
    same = all(torch.equal(a, b) for a, b in zip((dq, dk, dv), bwd()))
    print(f"  flash_bwd bf16 B{B} S{S} H{Hq} D{D} causal: two calls bitwise "
          f"equal {same}", flush=True)
    check(same, "the bf16 flash backward is not deterministic")
    err = dict(o=0.0, lse=0.0, dq=0.0, dkv=0.0)
    for b in range(B):
        r, rh = slice(b, b + 1), slice(b * Hq, (b + 1) * Hq)
        o_ref, lse_ref = K.flash_attention_ref(q[r], k[r], v[r], causal=True)
        ref = K.flash_attention_bwd_ref(q[r], k[r], v[r], o[r], lse[rh],
                                        do[r], causal=True)
        err["o"] = max(err["o"], max_err(o[r], o_ref))
        err["lse"] = max(err["lse"], max_err(lse[rh], lse_ref))
        err["dq"] = max(err["dq"], max_err(dq[r], ref[0]))
        err["dkv"] = max(err["dkv"], max_err(dk[r], ref[1]),
                         max_err(dv[r], ref[2]))
    del o_ref, lse_ref, ref
    tol_o, tol_l = TOL[("flash", "bfloat16")], TOL[("flash_lse", "bfloat16")]
    tol_b = TOL[("flash_bwd", "bfloat16")]
    print(f"  flash bf16 B{B} S{S} H{Hq} D{D} causal (training shape), plain "
          f"one batch row at a time: O err {err['o']:.3e} (tol {tol_o:.1e}), "
          f"LSE err {err['lse']:.3e} (tol {tol_l:.1e}), dq err "
          f"{err['dq']:.3e}, dk/dv err {err['dkv']:.3e} (tol {tol_b:.1e})",
          flush=True)
    check(err["o"] <= tol_o and err["lse"] <= tol_l and err["dq"] <= tol_b
          and err["dkv"] <= tol_b, f"flash at the training shape: {err}")
    err_dq, err_dkv = err["dq"], err["dkv"]
    fwd_ms = timed_ms(lambda: K.flash_attention_fwd(q, k, v, causal=True), 20)
    fwd_dms = device_ms(lambda: K.flash_attention_fwd(q, k, v, causal=True),
                        FWD_SYMBOL, 10)
    fwd_plain = timed_ms(lambda: K.flash_attention_ref(q, k, v, causal=True),
                         3)
    torch.cuda.empty_cache()
    ms_dq = timed_ms(lambda: K.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                      True), 20)
    ms_dkv = timed_ms(lambda: K.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                        delta, True), 20)
    dms_dq = device_ms(lambda: K.flash_attention_bwd_dq(
        q, k, v, do, lse, delta, True), BWD_SYMBOLS["dq"], 10)
    dms_dkv = device_ms(lambda: K.flash_attention_bwd_dkv(
        q, k, v, do, lse, delta, True), BWD_SYMBOLS["dkv"], 10)
    check(None not in (fwd_dms, dms_dq, dms_dkv),
          f"the profiler did not see {FWD_SYMBOL} / {BWD_SYMBOLS['dq']} / "
          f"{BWD_SYMBOLS['dkv']}: {fwd_dms} / {dms_dq} / {dms_dkv}")
    plain = timed_ms(lambda: K.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                       causal=True), 3)
    # the fp32 route (CUDA cores) on the same values, for the route table
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    f32_fwd = device_ms(lambda: K.flash_attention_fwd(
        q32, k32, v32, causal=True), FP32_FWD_SYMBOL, 2)
    f32_dq = device_ms(lambda: K.flash_attention_bwd_dq(
        q32, k32, v32, do32, lse, delta, True), "flash_bwd_dq_kernel", 2)
    f32_dkv = device_ms(lambda: K.flash_attention_bwd_dkv(
        q32, k32, v32, do32, lse, delta, True), "flash_bwd_dkv_kernel", 2)
    del q32, k32, v32, do32
    torch.cuda.empty_cache()
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()

    def sdpa_fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

    lib_f = timed_ms(sdpa_fwd, 10)
    lib_fb = timed_ms(lambda: torch.autograd.grad(sdpa_fwd(), (qt, kt, vt),
                                                  dot), 10)
    lib = lib_fb - lib_f
    pairs = S * (S + 1) // 2
    io = B * S * Hq * D * 2  # one bf16 [B, S, H, D] tensor
    stats = 2 * B * Hq * S * 4  # lse and delta
    ops_dq, ops_dkv = 6 * D * pairs * B * Hq, 8 * D * pairs * B * Hq
    b_dq, by_dq = bound(5 * io + stats, ops_dq, PEAK_BF16)
    b_dkv, by_dkv = bound(6 * io + stats, ops_dkv, PEAK_BF16)
    ops_fwd = 4 * D * pairs * B * Hq
    b_fwd, by_fwd = bound(4 * io + stats // 2, ops_fwd, PEAK_BF16)
    tf_fwd = ops_fwd / fwd_dms * 1e-9
    tf_dq, tf_dkv = ops_dq / dms_dq * 1e-9, ops_dkv / dms_dkv * 1e-9
    print(f"  flash bf16 B{B} S{S} H{Hq} D{D} causal (training shape): fwd "
          f"kernel (wgmma) {fwd_ms:.3f} ms (device {fwd_dms:.3f} ms = "
          f"{tf_fwd:.1f} TFLOP/s, bound {b_fwd:.4f} ms {by_fwd}), plain fwd "
          f"{fwd_plain:.3f} ms, F.sdpa fwd {lib_f:.3f} ms; fp32 route (CUDA "
          f"cores) on the same values: fwd device {fmt(f32_fwd, '.3f')} ms",
          flush=True)
    print(f"  flash backward, bf16 route (wgmma): dq kernel {ms_dq:.3f} ms "
          f"(device {dms_dq:.3f} ms = {tf_dq:.1f} TFLOP/s, bound {b_dq:.4f} "
          f"ms {by_dq}), dk/dv kernel {ms_dkv:.3f} ms (device {dms_dkv:.3f} "
          f"ms = {tf_dkv:.1f} TFLOP/s, bound {b_dkv:.4f} ms {by_dkv}); fp32 "
          f"route (CUDA cores) on the same values: dq device "
          f"{fmt(f32_dq, '.3f')} ms, dk/dv device {fmt(f32_dkv, '.3f')} ms; "
          f"plain backward (dq+dk+dv) {plain:.3f} ms; F.sdpa backward "
          f"{lib:.3f} ms (fwd+bwd {lib_fb:.3f} - fwd {lib_f:.3f})",
          flush=True)
    common = dict(route="cuda",
                  routes={"bfloat16": "cuda wgmma",
                          "float32": "cuda fp32 CUDA cores"},
                  source="paddle_tpu_torch/kernels/csrc/flash_bwd_sm90.cu",
                  float32_source="paddle_tpu_torch/kernels/csrc/flash_bwd.cu",
                  shape=f"bf16 B{B} S{S} H{Hq} D{D} causal (training)",
                  plain_ms=plain, library_ms=lib)
    rows["flash_attention_bwd_dq"] = dict(
        name="flash_attention_bwd_dq",
        replaces="paddle_tpu/kernels/flash_attention.py:145",
        max_abs_err=err_dq, ms=ms_dq, device_ms=dms_dq, tflops=tf_dq,
        float32_device_ms=f32_dq, bound_ms=b_dq, bound_by=by_dq, **common)
    rows["flash_attention_bwd_dkv"] = dict(
        name="flash_attention_bwd_dkv",
        replaces="paddle_tpu/kernels/flash_attention.py:182",
        max_abs_err=err_dkv, ms=ms_dkv, device_ms=dms_dkv, tflops=tf_dkv,
        float32_device_ms=f32_dkv, bound_ms=b_dkv, bound_by=by_dkv,
        **common)
    rows["flash_attention_fwd"].update(
        train_shape=common["shape"], train_max_abs_err=err["o"],
        train_lse_max_abs_err=err["lse"], train_ms=fwd_ms,
        train_device_ms=fwd_dms, train_tflops=tf_fwd,
        train_float32_device_ms=f32_fwd, train_plain_ms=fwd_plain,
        train_bound_ms=b_fwd, train_bound_by=by_fwd, train_library_ms=lib_f)
    del q, k, v, do, o, lse, delta, dq, dk, dv, qt, kt, vt, dot
    torch.cuda.empty_cache()

    # -- fused AdamW: one launch over a mixed list, grouped by the six
    #    (param, grad, moments) dtype combinations the optimizer makes, at
    #    sizes 0, 33 (a tail only), 65553 (past a chunk, with a partial
    #    vector), fc1's 2048 x 8192 and the word embedding's 50304 x 2048
    #    (the train step's largest tensor), and dim-0 slice views of a leaf
    #    (16-byte aligned and not), each with its own learning rate, decay
    #    and step powers, a bf16 copy beside every other fp32 param; the
    #    kernel repeats the plain version's roundings op by op, so every
    #    output, the copies included, agrees to the bit
    adamw_list_check(K, gen, ADAMW_COMBOS,
                     (0, 33, 65553, 2048 * 8192, 50304 * 2048), "[3]")
    torch.cuda.empty_cache()
    # the same on [6]'s whole parameter list (fp32 master, bf16 g/m/v and
    # the bf16 parameter), which one launch updates on the main path
    shapes = param_shapes("dense")
    adamw_list_check(K, gen, [(torch.float32, torch.bfloat16,
                               torch.bfloat16)], shapes, "[3] on [6]'s list",
                     copies="all")
    torch.cuda.empty_cache()
    n = 2048 * 8192
    p, g, m, v, low = adamw_tensors(gen, n, torch.float32, torch.bfloat16,
                                    torch.bfloat16, copy=True)

    def ours():
        K.fused_adamw_multi([p], [g], [m], [v], **ADAMW_HP, low=[low])

    def plain():
        new = K.adamw_ref(p, g, m, v, **ADAMW_HP)
        return new, new[0].to(torch.bfloat16)

    ms = timed_ms(ours, 50)
    dms = device_ms(ours, "fused_adamw", 20)
    plain_ms = timed_ms(plain, 20)
    want, want_low = plain()
    got = [t.clone() for t in (p, m, v, low)]
    K.fused_adamw_multi([got[0]], [g], [got[1]], [got[2]], **ADAMW_HP,
                        low=[got[3]])
    err = max(max_err(a, b) for a, b in zip(got, (*want, want_low)))
    # read p 4 + g 2 + m 2 + v 2, write p 4 + m 2 + v 2 + the copy 2
    bms, by = bound(20 * n, 15 * n, PEAK_FP32)
    print(f"  fused_adamw_multi fp32 master + bf16 g/m/v + the bf16 copy, "
          f"n={n}: kernel {ms:.4f} ms (device {fmt(dms, '.4f')} ms), plain "
          f"(and the copy) {plain_ms:.4f} ms, bound {bms:.4f} ms ({by}); "
          f"err {err:.1e} (tol 0)", flush=True)
    check(err == 0, f"adamw with the bf16 copy at n={n}: {err}")
    rows["fused_adamw_multi"] = dict(
        name="fused_adamw_multi", route="cuda",
        source="paddle_tpu_torch/kernels/csrc/fused_adamw.cu",
        replaces="paddle_tpu/kernels/fused_optim.py:24",
        shape=f"n {n} (fc1), p fp32 master, g/m/v bf16, the bf16 copy",
        max_abs_err=err, ms=ms, device_ms=dms, plain_ms=plain_ms,
        bound_ms=bms, bound_by=by, library_ms=None)
    del p, g, m, v, low, got, want, want_low


def flash_fp32_routes(K, gen, rows):
    """[3]: the fp32 flash kernels (CUDA cores, ``csrc/flash_fwd.cu`` and
    ``csrc/flash_bwd.cu``) at the shapes the fp32 phases give them
    (``FP32_FLASH``): each kernel's CUDA-event and device ms, its bound
    (fp32 operations at the CUDA cores' peak against bytes), and
    ``F.scaled_dot_product_attention``'s fp32 forward and backward on the
    same values (TF32 off), into the three flash rows."""
    F = torch.nn.functional
    dev = torch.device("cuda")
    for what, (B, S, H, D) in FP32_FLASH.items():
        q, k, v, do = (torch.randn(B, S, H, D, generator=gen, device=dev)
                       for _ in range(4))
        o, lse = K.flash_attention_fwd(q, k, v, causal=True)
        delta = importlib.import_module(
            "paddle_tpu_torch.kernels.flash_attention")._delta(o, do)
        calls = {
            "fwd": (lambda: K.flash_attention_fwd(q, k, v, causal=True),
                    FP32_FWD_SYMBOL),
            "dq": (lambda: K.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                    True),
                   FP32_BWD_SYMBOLS["dq"]),
            "dkv": (lambda: K.flash_attention_bwd_dkv(q, k, v, do, lse,
                                                      delta, True),
                    FP32_BWD_SYMBOLS["dkv"])}
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                      for t in (q, k, v))
        dot = do.transpose(1, 2).contiguous()

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        lib_f = timed_ms(sdpa, 20)
        lib_b = timed_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt),
                                                     dot), 20) - lib_f
        pairs = S * (S + 1) // 2
        io = B * S * H * D * 4  # one fp32 [B, S, H, D] tensor
        stats = B * H * S * 4
        # bytes: q, k, v in, o out (and lse); the backward's dq reads q, k,
        # v, do, lse, delta and writes dq, its dk/dv the same with dk, dv
        work = {"fwd": (4 * io + stats, 4 * D * pairs * B * H),
                "dq": (5 * io + 2 * stats, 6 * D * pairs * B * H),
                "dkv": (6 * io + 2 * stats, 8 * D * pairs * B * H)}
        out = {}
        for name, (fn, sym) in calls.items():
            ms = timed_ms(fn, 20)
            dms = device_ms(fn, sym, 10)
            bms, by = bound(*work[name], PEAK_FP32)
            out[name] = dict(ms=ms, device_ms=dms, bound_ms=bms, bound_by=by)
            check(dms is not None, f"the profiler did not see {sym}")
        print(f"  flash fp32 (CUDA cores) at {what}'s B{B} S{S} H{H} D{D} "
              f"causal: " + "; ".join(
                  f"{name} {r['ms']:.4f} ms (device {r['device_ms']:.4f}, "
                  f"bound {r['bound_ms']:.5f} {r['bound_by']})"
                  for name, r in out.items())
              + f"; F.sdpa fp32 forward {lib_f:.4f} ms, backward (dq+dk+dv) "
              f"{lib_b:.4f} ms ({nvidia_smi_line()})", flush=True)
        for name, row in (("fwd", "flash_attention_fwd"),
                          ("dq", "flash_attention_bwd_dq"),
                          ("dkv", "flash_attention_bwd_dkv")):
            rows[row].setdefault("float32_routes", {})[what] = dict(
                shape=f"fp32 B{B} S{S} H{H} D{D} causal", **out[name],
                library_ms=lib_f if name == "fwd" else lib_b)


def adamw_tensors(gen, shape, pd, gd, md, copy=False):
    """p, g, m, v (and the bf16 copy of p when ``copy``) on the card."""
    dev = torch.device("cuda")

    def randn(scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=dev)

    p, g, m, v = (randn().to(pd), randn().to(gd), randn(0.1).to(md),
                  randn(0.1).abs().to(md))
    return (p, g, m, v, p.to(torch.bfloat16)) if copy else (p, g, m, v, None)


def param_shapes(which: str):
    """The parameter shapes of [6]'s GPT-3 1.3B ("dense") or [16]'s GPT-MoE
    ("moe"), from a model built on the card and dropped."""
    from paddle_tpu_torch.models.gpt import GPT3_1p3B, GPTConfig, GPTForCausalLM

    cfg = GPTConfig(**(GPT3_1p3B if which == "dense" else MOE5))
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16)
    shapes = [tuple(p.shape) for p in model.parameters()]
    del model
    torch.cuda.empty_cache()
    return shapes


def adamw_list_check(K, gen, combos, sizes, what, copies="every other"):
    """One ``fused_adamw_multi`` call over tensors of every dtype
    combination of ``combos`` and every shape of ``sizes``, plus two dim-0
    slice views per combination (rows 2:4 of a [4, 2048] leaf, 16-byte
    aligned; row 1 of a [3, 5] leaf, not), with per-tensor learning rates,
    decays and step powers; a bf16 copy beside every other fp32 param
    (``copies="all"``: every one). Holds every output to ``adamw_ref``
    bitwise, the leaves' other rows untouched and the launches to one per
    combination."""
    entries, leaves, aligned = [], [], set()
    for pd, gd, md in combos:
        for shape in sizes:
            entries.append(adamw_tensors(gen, shape, pd, gd, md))
        for shape, part in (((4, 2048), slice(2, 4)), ((3, 5), slice(1, 2))):
            leaf = adamw_tensors(gen, shape, pd, gd, md)[:4]
            leaves.append((leaf, [t.clone() for t in leaf], part))
            entries.append(tuple(t[part] for t in leaf) + (None,))
            aligned.add(all(t.data_ptr() % 16 == 0 for t in entries[-1][:4]))
    entries = [(p, g, m, v, p.to(torch.bfloat16) if p.dtype == torch.float32
                and (copies == "all" or i % 2) else None)
               for i, (p, g, m, v, _) in enumerate(entries)]
    hp = [dict(lr=1e-4 * (1 + i % 3), weight_decay=0.01 * (i % 2),
               beta1_pow=0.9 ** (1 + i % 4), beta2_pow=0.999 ** (1 + i % 4))
          for i in range(len(entries))]
    want = [K.adamw_ref(*e[:4], beta1=0.9, beta2=0.999, eps=1e-8, **h)
            for e, h in zip(entries, hp)]
    n0 = K.fused_adamw_multi.launches
    K.fused_adamw_multi(
        *[[e[k] for e in entries] for k in range(4)],
        beta1=0.9, beta2=0.999, eps=1e-8,
        **{k: [h[k] for h in hp] for k in hp[0]},
        low=[e[4] for e in entries])
    groups = {(e[0].dtype, e[1].dtype, e[2].dtype) for e in entries
              if e[0].numel()}
    errs = []
    for (p, g, m, v, low), w in zip(entries, want):
        got = (p, m, v) + (() if low is None else (low,))
        ref = w + (() if low is None else (w[0].to(torch.bfloat16),))
        errs.append((max([max_err(a, b) for a, b in zip(got, ref)
                          if a.numel()], default=0.0),
                     f"{p.dtype}/{g.dtype}/{m.dtype} {tuple(p.shape)}"))
    rest = all(torch.equal(torch.cat([a[:part.start], a[part.stop:]]),
                           torch.cat([b[:part.start], b[part.stop:]]))
               for leaf, whole, part in leaves for a, b in zip(leaf, whole))
    launched = K.fused_adamw_multi.launches - n0
    print(f"  fused_adamw_multi {what}: {len(entries)} tensors "
          f"({sum(e[0].numel() for e in entries)} elements; "
          f"{sum(e[4] is not None for e in entries)} bf16 copies; slice "
          f"views 16-byte aligned {sorted(aligned)}) in {launched} "
          f"launches for {len(groups)} dtype combinations; largest "
          f"|kernel - plain| {max(errs)[0]:.1e} (tol 0), the leaves' "
          f"other rows untouched {rest}", flush=True)
    check(max(errs)[0] == 0 and rest and launched == len(groups)
          and aligned == {True, False},
          f"{what}: adamw list {[e for e in errs if e[0]][:8]}, untouched "
          f"{rest}, launches {launched} for {len(groups)} combinations, "
          f"aligned {aligned}")


def adamw_vs_library(K, gen, rows):
    """[3]: the fused AdamW timed against ``torch._fused_adamw_`` and
    against the per-tensor path (a launch, and a ``copy_`` of each master,
    per tensor), 12 CUDA-event readings of each, interleaved (each the mean
    of 20 calls on one tensor, of 5 on a list), and the profiler's device
    time of a call (every kernel in the window):
    (a) all-fp32 tensors at fc1's n 16.8M and at [20a] (ii)'s slice of it
    (n 8.4M), the one-tensor form against the library;
    (b) fp32 master, bf16 g/m/v and the bf16 copy at n 16.8M;
    (c) [6]'s parameter list, all fp32, against the library over the list;
    (d) [6]'s list in [6]'s dtypes with the bf16 copies;
    (e) [16]'s parameter list, all bf16, against the library on bf16
    p/g/m/v.
    With a tree that has no grouped launch (``fused_adamw_multi``), only
    the per-tensor path and the library. Medians, spreads and bounds go to
    the kernel line (a tree without the grouped launch has no such line)."""
    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    multi = getattr(K, "fused_adamw_multi", None)
    hp = {k: v for k, v in ADAMW_HP.items()}
    step_t = torch.tensor(3.0, device=dev)

    def variants(ps, gs, ms, vs, lows, library):
        per_tensor = [(p, g, m, v, low) for p, g, m, v, low
                      in zip(ps, gs, ms, vs, lows)]

        def each():
            for p, g, m, v, low in per_tensor:
                K.fused_adamw_update(p, g, m, v, **hp)
                if low is not None:
                    low.copy_(p)

        out = {"per-tensor path": each}
        if multi is not None:
            def grouped():
                multi(ps, gs, ms, vs, **hp, low=lows)
            out["kernel"] = grouped
        if library:
            steps = [step_t] * len(ps)

            def lib():
                torch._fused_adamw_(ps, gs, ms, vs, [], steps, lr=hp["lr"],
                                    beta1=0.9, beta2=0.999,
                                    weight_decay=0.01, eps=1e-8,
                                    amsgrad=False, maximize=False)
            out["torch._fused_adamw_"] = lib
        return out

    def measure(what, fns, iters, nbytes, n):
        reads = {k: [] for k in fns}
        for _ in range(12):
            for k, fn in fns.items():
                reads[k].append(timed_ms(fn, iters))
        dev_ms = {}
        for k, fn in fns.items():
            fn()
            ks = profile_kernels(lambda: [fn() for _ in range(iters)])
            dev_ms[k] = sum(t for _, t in ks) / iters * 1e3 if ks else None
        med = {k: float(np.median(r)) for k, r in reads.items()}
        spread = {k: (min(r), max(r)) for k, r in reads.items()}
        bms, by = bound(nbytes, 15 * n, PEAK_FP32)
        print(f"  fused AdamW, {what}: bound {bms:.4f} ms ({by}); medians of "
              f"12 interleaved readings (spread; device ms): " + "; ".join(
                  f"{k} {med[k]:.4f} ({spread[k][0]:.4f}-{spread[k][1]:.4f}"
                  f"; {fmt(dev_ms[k], '.4f')})" for k in fns), flush=True)
        return {"n": n, "bound_ms": bms, "median_ms": med,
                "spread_ms": spread, "device_ms": dev_ms}

    def tensors(shapes, pd, gd, md, copy):
        ts = [adamw_tensors(gen, sh, pd, gd, md, copy) for sh in shapes]
        return [list(col) for col in zip(*ts)]

    out = {}
    # (a), (b): one tensor; p, g, m, v read (16 B) and p, m, v written
    # (12 B) per element in fp32; 10 + 8 + the copy's 2 in (b)
    for n, what in ((2048 * 8192, "fc1"), (1024 * 8192, "fc1 at sharding 2")):
        ps, gs, ms, vs, lows = tensors([n], f32, f32, f32, False)
        fns = {"kernel": lambda: K.fused_adamw_update(ps[0], gs[0], ms[0],
                                                      vs[0], **hp),
               "torch._fused_adamw_": variants(
                   ps, gs, ms, vs, lows, True)["torch._fused_adamw_"]}
        out[f"all fp32, n {n} ({what})"] = measure(
            f"all fp32, n {n} ({what})", fns, 20, 28 * n, n)
        del ps, gs, ms, vs, lows, fns
    n = 2048 * 8192
    cols = tensors([n], f32, bf16, bf16, True)
    out["fp32 master, bf16 g/m/v, the copy, n 16.8M"] = measure(
        f"fp32 master + bf16 g/m/v + the bf16 copy, n {n} (fc1)",
        variants(*cols, False), 20, 20 * n, n)
    del cols
    for which, dtypes, copy, key in (
            ("dense", (f32, f32, f32), False, "[6]'s list, all fp32"),
            ("dense", (f32, bf16, bf16), True,
             "[6]'s list, fp32 master, bf16 g/m/v, the copies"),
            ("moe", (bf16, bf16, bf16), False, "[16]'s list, all bf16")):
        shapes = param_shapes(which)
        n = sum(int(np.prod(sh)) for sh in shapes)
        per = {f32: 28, bf16: 14}[dtypes[0]] if not copy else 20
        cols = tensors(shapes, *dtypes, copy)
        out[key] = measure(f"{key}: {len(shapes)} tensors, n {n}",
                           variants(*cols, not copy), 5, per * n, n)
        del cols
        torch.cuda.empty_cache()
    if multi is not None:
        a = out["all fp32, n 16777216 (fc1)"]
        row = rows.setdefault("fused_adamw_multi", {})
        row["library_ms"] = a["median_ms"]["torch._fused_adamw_"]
        row["library_note"] = (
            "torch._fused_adamw_ on fp32 p/g/m/v, median of 12 readings; the "
            f"kernel on the same tensors {a['median_ms']['kernel']:.4f} ms")
        row["vs_library"] = out
    return out


def mp_kernel_checks(K, gen, rows):
    """[3] at the shapes tensor and ZeRO parallelism give the kernels
    ([19]): the bf16 flash forward, dq and dk/dv at mp 2's local heads of
    the 1.3B (B2 S1024 H8/8 D128 causal, the wgmma route) against their
    plain versions; the fused AdamW on dim-0 slice views of a state leaf
    (ZeRO's slices, at a storage offset), one 16-byte aligned and one not
    (a [3, 5] leaf's second row), in the mixed dtypes and in fp32,
    bitwise equal to the plain version, the rest of the leaf untouched."""
    dev = torch.device("cuda")
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    B, S, H, D = 2, 1024, 8, 128
    q, k, v = flash_inputs(randn, B, S, H, H, D, bf16)
    do = randn(B, S, H, D, dtype=bf16)
    wrappers = [getattr(K, w) for w in FLASH_WRAPPERS]
    before = [w.route_launches["wgmma"] for w in wrappers]
    o, lse = K.flash_attention_fwd(q, k, v, causal=True)
    got = K.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    o_ref, lse_ref = K.flash_attention_ref(q, k, v, causal=True)
    want = K.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    err_o, err_l = max_err(o, o_ref), max_err(lse, lse_ref)
    errs = [max_err(a, b) for a, b in zip(got, want)]
    tol_o, tol_l = TOL[("flash", "bfloat16")], TOL[("flash_lse", "bfloat16")]
    tol_b = TOL[("flash_bwd", "bfloat16")]
    on_route = [w.route_launches["wgmma"] - b
                for w, b in zip(wrappers, before)]
    print(f"  flash bf16 B{B} S{S} H{H}/{H} D{D} causal (mp 2's local heads "
          f"of the 1.3B): O err {err_o:.3e} (tol {tol_o:.1e}), LSE err "
          f"{err_l:.3e} (tol {tol_l:.1e}), dq/dk/dv err "
          f"{' '.join(f'{e:.3e}' for e in errs)} (tol {tol_b:.1e}); wgmma "
          f"launches fwd/dq/dkv {on_route}", flush=True)
    check(err_o <= tol_o and err_l <= tol_l and all(e <= tol_b for e in errs)
          and on_route == [1, 1, 1], f"flash at mp 2's heads: {err_o}, "
          f"{err_l}, {errs}, routes {on_route}")
    rows["flash_attention_fwd"]["mp2_max_abs_err"] = err_o
    rows["flash_attention_bwd_dq"]["mp2_max_abs_err"] = errs[0]
    rows["flash_attention_bwd_dkv"]["mp2_max_abs_err"] = max(errs[1:])
    del q, k, v, do, o, lse, got, o_ref, lse_ref, want

    worst = 0.0
    for pd, gd, md in ((f32, bf16, bf16), (f32, f32, f32)):
        for shape, part in (((3, 5), slice(1, 2)), ((4, 2048), slice(2, 4))):
            leaf = [randn(*shape, dtype=f32).to(pd),
                    randn(*shape, dtype=f32).to(gd),
                    (0.1 * randn(*shape, dtype=f32)).to(md),
                    (0.1 * randn(*shape, dtype=f32)).abs().to(md)]
            whole = [t.clone() for t in leaf]
            views = [t[part] for t in leaf]
            aligned = all(t.data_ptr() % 16 == 0 for t in views)
            want = K.adamw_ref(*views, **ADAMW_HP)
            n0 = K.fused_adamw_update.launches
            K.fused_adamw_update(*views, **ADAMW_HP)
            errs = [max_err(a, b) for a, b in zip(
                (views[0], views[2], views[3]), want)]
            rest = all(torch.equal(torch.cat([a[:part.start],
                                              a[part.stop:]]),
                                   torch.cat([b[:part.start],
                                              b[part.stop:]]))
                       for a, b in zip(leaf, whole))
            worst = max(worst, *errs)
            print(f"  fused_adamw on rows {part.start}:{part.stop} of a "
                  f"{list(shape)} leaf (offset {part.start * shape[1]} "
                  f"elements, 16-byte aligned {aligned}) p {pd} g {gd} m/v "
                  f"{md}: p/m/v err {' '.join(f'{e:.1e}' for e in errs)} "
                  f"(tol 0), the other rows untouched {rest}", flush=True)
            check(all(e == 0 for e in errs) and rest
                  and K.fused_adamw_update.launches == n0 + 1
                  and aligned == (shape[0] == 4),
                  f"adamw on a slice view {shape}[{part}]: {errs}, {rest}")
    rows["fused_adamw_multi"]["slice_view_max_abs_err"] = worst


def primitive_err(got, want):
    """(max |got - want|, the tolerance for the output's dtype)."""
    scale = max(1.0, want.float().abs().max().item())
    return max_err(got, want), PRIMITIVE_STEP[want.dtype] * scale


def primitive_checks(P, ops, gen, rows):
    """The two primitive factories vs plain on the card, then timed at the
    1.3B's hidden-state shapes; adds their rows to ``rows``."""
    dev = torch.device("cuda")
    H = 2048

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    # -- the elementwise primitive: both functions at the hidden states'
    #    shape in bf16 and at ragged shapes in both dtypes
    cases = [((16, 2048, H), torch.bfloat16)] + [
        (s, d) for s in ((130,), (3, 5, 7))
        for d in (torch.float32, torch.bfloat16)]
    for name, fn in ELEMENTWISE_FNS.items():
        for shape, dtype in cases:
            args = [randn(*shape, dtype=dtype) for _ in range(3)]
            err, tol = primitive_err(ops[name](*args),
                                     P.elementwise_ref(fn, *args))
            print(f"  elementwise {name:14s} {str(dtype):15s} {list(shape)}: "
                  f"max_abs_err {err:.3e} (tol {tol:.1e})", flush=True)
            check(err <= tol, f"elementwise {name} {dtype} {shape}: {err}")
    x, y, a = (randn(16, 2048, H, dtype=torch.bfloat16) for _ in range(3))
    n = x.numel()
    axpy, fn = ops["x + a*y"], ELEMENTWISE_FNS["x + a*y"]
    ms = timed_ms(lambda: axpy(x, y, a), 50)
    dms = device_ms(lambda: axpy(x, y, a), "primitive_elementwise", 20)
    plain = timed_ms(lambda: P.elementwise_ref(fn, x, y, a), 10)
    lib = timed_ms(lambda: torch.addcmul(x, a, y), 50)
    tanh_ms = timed_ms(lambda: ops["x + a*tanh(y)"](x, y, a), 50)
    bms, by = bound(4 * n * 2, 2 * n, PEAK_FP32)
    err, _ = primitive_err(axpy(x, y, a), P.elementwise_ref(fn, x, y, a))
    print(f"  elementwise x + a*y bf16 [16, 2048, {H}]: kernel {ms:.4f} ms "
          f"(device {fmt(dms, '.4f')} ms), plain {plain:.4f} ms, "
          f"torch.addcmul {lib:.4f} ms, bound {bms:.4f} ms ({by}); "
          f"x + a*tanh(y) kernel {tanh_ms:.4f} ms", flush=True)
    rows["elementwise_kernel"] = dict(
        name="elementwise_kernel", route="triton",
        source="paddle_tpu_torch/kernels/primitive.py",
        replaces="paddle_tpu/kernels/primitive.py:62",
        shape=f"x + a*y, three bf16 operands [16, 2048, {H}]",
        max_abs_err=err, ms=ms, device_ms=dms, plain_ms=plain, bound_ms=bms,
        bound_by=by, library_ms=lib, tanh_ms=tanh_ms)
    del x, y, a

    # -- the row reduction: sum and max over the hidden states' rows in
    #    bf16, and ragged rows (C = 1280: blocks of 256; C = 33: of 1)
    cases = [((16 * 2048, H), torch.bfloat16)] + [
        (s, d) for s in ((8, 1280), (5, 33))
        for d in (torch.float32, torch.bfloat16)]
    for name, (fn, init) in REDUCE_FNS.items():
        for shape, dtype in cases:
            x = randn(*shape, dtype=dtype)
            got, want = ops[name](x), P.row_reduce_ref(fn, init, x)
            err, tol = primitive_err(got, want)
            tol = 0.0 if name == "row max" else tol  # a max does not round
            print(f"  row_reduce {name:8s} {str(dtype):15s} {list(shape)}: "
                  f"max_abs_err {err:.3e} (tol {tol:.1e})", flush=True)
            check(err <= tol and got.shape == want.shape,
                  f"row_reduce {name} {dtype} {shape}: {err}")
    x = randn(16 * 2048, H, dtype=torch.bfloat16)
    R = x.shape[0]
    row_sum, (fn, init) = ops["row sum"], REDUCE_FNS["row sum"]
    ms = timed_ms(lambda: row_sum(x), 100)
    dms = device_ms(lambda: row_sum(x), "primitive_row_reduce", 50)
    plain = timed_ms(lambda: P.row_reduce_ref(fn, init, x), 20)
    lib = timed_ms(lambda: torch.sum(x, dim=-1), 100)
    max_ms = timed_ms(lambda: ops["row max"](x), 100)
    max_lib = timed_ms(lambda: torch.amax(x, dim=-1), 100)
    bms, by = bound(R * H * 2 + R * 2, R * H, PEAK_FP32)
    err, _ = primitive_err(row_sum(x), P.row_reduce_ref(fn, init, x))
    print(f"  row_reduce row sum bf16 [{R}, {H}]: kernel {ms:.4f} ms (device "
          f"{fmt(dms, '.4f')} ms), plain {plain:.4f} ms, torch.sum "
          f"{lib:.4f} ms, bound {bms:.4f} ms ({by}); row max kernel "
          f"{max_ms:.4f} ms, torch.amax {max_lib:.4f} ms", flush=True)
    rows["row_reduce_kernel"] = dict(
        name="row_reduce_kernel", route="triton",
        source="paddle_tpu_torch/kernels/primitive.py",
        replaces="paddle_tpu/kernels/primitive.py:100",
        shape=f"row sum, bf16 x[{R}, {H}]", max_abs_err=err, ms=ms,
        device_ms=dms, plain_ms=plain, bound_ms=bms, bound_by=by,
        library_ms=lib, max_ms=max_ms, max_library_ms=max_lib)
    del x
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 4b
def profile_launches(fn):
    """Run ``fn`` under ``torch.profiler``; returns [(kernel name, device
    seconds, launches)] summed by name, largest time first. A kernel a
    CUDA graph replay runs is an event of its own, as an eager launch is.
    The window opens with ``LEAD_IN`` spin kernels, left out of what it
    returns: late in this script's process a window has come back without
    its first ~23 kernel records (643 of a decode replay's 666; a short
    process kept them all), and the lead-in absorbs that loss. Windows
    have also lost the whole lead-in (in [3] and [17], in two of four
    whole-script runs). Kineto keeps only the activities timestamped
    after the window's start on the host's clock, so the window waits
    ``LEAD_IN_WAIT`` seconds before its lead-in, in case the device's
    timestamps lag the host's; that cause is a guess, not verified, and
    a window that still loses its lead-in fails with the first device
    and host records' times against the window's start."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(LEAD_IN_WAIT)
        for _ in range(LEAD_IN):
            torch.cuda._sleep(1)
        fn()
        torch.cuda.synchronize()
    kernels = [(e.key, e.self_device_time_total * 1e-6, e.count)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if not any(LEAD_SYMBOL in name for name, _, _ in kernels):
        starts = {kind: sorted(e.time_range.start for e in prof.events()
                               if e.device_type == kind)
                  for kind in (DeviceType.CUDA, DeviceType.CPU)}
        check(False, f"the profiler saw none of the lead-in's "
              f"{LEAD_SYMBOL}s: {[name for name, _, _ in kernels][:4]}; "
              + "; ".join(f"{len(t)} {kind.name} records, the first at "
                          f"{t[:3]} us from the window's start"
                          for kind, t in starts.items()))
    return sorted([k for k in kernels if LEAD_SYMBOL not in k[0]],
                  key=lambda kv: -kv[1])


def profile_kernels(fn):
    """Run ``fn`` under ``torch.profiler``; returns [(kernel name, device
    seconds)] summed by name, largest first."""
    return [(name, t) for name, t, _ in profile_launches(fn)]


def launches_of(kernels, symbols):
    """{symbol: launches} of the kernels named ``*symbol*`` in ``kernels``
    (as ``profile_launches`` returns them)."""
    return {sym: sum(n for name, _, n in kernels if sym in name)
            for sym in symbols}


def replay_launches(fn, syms, want, what):
    """``launches_of`` over a profiler window of ``fn``, which replays CUDA
    graphs (the same kernels on every replay), held to ``want``. A count
    above it fails at once. A window short of it lost kernel records (late
    in this script's process one came back a LayerNorm short of a
    ``prefill:128`` replay's 17, its lead-in seen): it is printed and the
    replays profiled again, up to ``REPLAY_WINDOWS`` windows; none equal
    to ``want`` fails."""
    for k in range(REPLAY_WINDOWS):
        got = launches_of(profile_launches(fn), syms)
        check(all(got[s] <= want[s] for s in syms),
              f"{what} launched {got}, more than {want}")
        if got == want:
            return got
        print(f"    {what}: profiler window {k + 1} of {REPLAY_WINDOWS} saw "
              f"{got}, short of {want}", flush=True)
    fail(f"{what} launched {got} in each of {REPLAY_WINDOWS} windows, not "
         f"{want}")


def p50(values) -> float:
    return sorted(values)[len(values) // 2]


def request_latencies(reqs):
    """(TTFT p50, TPOT p50) in ms of finished requests, by the host clock."""
    return (p50([r.first_token_time - r.arrival_time for r in reqs]) * 1e3,
            p50([(r.finish_time - r.first_token_time)
                 / max(r.num_generated - 1, 1) for r in reqs]) * 1e3)


def host_and_busy(fn, steps: int):
    """(host clock ms, device busy ms, the kernels) per step of ``fn``, which
    runs ``steps`` steps: the host clock around a first run that ends in a
    synchronisation, the profiler's kernel time over a second."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    kernels = profile_kernels(fn)
    return wall, sum(t for _, t in kernels) / steps * 1e3, kernels


def graph_programs(eng):
    """{program: (captures, replays, capture ms)} of an engine's programs."""
    return {name: (st.captures, st.replays,
                   round(st.capture_seconds * 1e3, 1))
            for name, st in eng.steps.items()}


def replays_of(eng):
    return {name: st.replays for name, st in eng.steps.items()}


def where_time_goes(model, eng, prompts, SamplingParams):
    """Host-clock time of 8 engine steps with all 8 slots live (each a
    replay of the captured decode step), beside the device busy time the
    profiler reads for the same work; the difference is the device's idle
    share. Then the decode step alone on the same buffers: the graph's
    replay against its eager function. Then one 1024-token prefill."""
    reqs = [eng.add_request(p, SamplingParams(max_new_tokens=30))
            for p in prompts[1::2][:8]]
    eng.step()  # admit all 8 + one decode step
    ttft = p50([r.first_token_time - r.arrival_time for r in reqs]) * 1e3
    steps = 8

    def decode():
        for _ in range(steps):
            eng.step()

    wall, busy, kernels = host_and_busy(decode, steps)
    paged = {name: kernel_ms(kernels, sym, steps)
             for name, sym in PAGED_SYMBOLS.items()}
    # each step emits one token per live slot: its host clock is the TPOT
    print(f"[4b] decode step (8 live slots, graph replay): {wall:.2f} ms host "
          f"clock (the TPOT), device busy {busy:.2f} ms, idle share "
          f"{1 - busy / wall:.3f}, {8 / wall * 1e3:.1f} tokens/s; the 8 "
          f"admissions' TTFT p50 {ttft:.1f} ms", flush=True)
    check(None not in paged.values(), f"[4b]: the profiler did not see "
          f"{' and '.join(PAGED_SYMBOLS.values())}: {paged}")
    print(f"     paged decode {sum(paged.values()):.3f} ms/step ({paged}), "
          f"{sum(paged.values()) / busy:.3f} of device busy", flush=True)
    for name, t in kernels[:6]:
        print(f"     {t / steps * 1e3:8.3f} ms/step  {name[:90]}", flush=True)
    step = eng.steps["decode"]

    def eager():
        for _ in range(steps):
            step.fn()[0].cpu()

    def replayed():
        for _ in range(steps):
            step.replay()
            step.outputs[0].cpu()

    # eager first: the replays then leave the graph's own K/V in place
    for name, fn in (("eager step", eager), ("graph replay", replayed)):
        wall, busy, _ = host_and_busy(fn, steps)
        print(f"[4b] decode step alone on the same buffers, {name}: "
              f"{wall:.2f} ms host clock, device busy {busy:.2f} ms, idle "
              f"share {1 - busy / wall:.3f}", flush=True)
    while eng.has_unfinished:
        eng.step()
    print(f"[4b] decode captures {step.captures}", flush=True)
    check(step.captures == 1, f"[4b]: {step.captures} decode captures")
    # a 1024-token prefill through the engine's program for its bucket, on
    # one set of host inputs (slot 0's row, all sentinels now: the writes
    # land on the trash page): the graph's run (the host state copied in,
    # one replay) against the eager function on the same buffers
    pre = eng.step_program("prefill:1024")
    host = dict(ids=np.asarray([(prompts[1] * 4)[:1024]]),
                length=np.array([1024]), row=eng.cache.page_table[:1])

    def graph_run():
        pre.run(**host)

    def eager_run():
        pre.buffers.write(**host)
        pre.fn()

    for name, fn in (("graph replay", graph_run), ("eager call", eager_run)):
        fn()
        wall, busy, kernels = host_and_busy(fn, 1)
        print(f"[4b] prefill T=1024, {name}: {wall:.2f} ms host clock, "
              f"device busy {busy:.2f} ms, idle share {1 - busy / wall:.3f}",
              flush=True)
        for kname, t in kernels[:6]:
            print(f"     {t * 1e3:8.3f} ms  {kname[:90]}", flush=True)
    ids = torch.from_numpy(host["ids"]).cuda()
    with torch.no_grad():
        wall, busy, _ = host_and_busy(
            lambda: model.prefill_with_cache(
                ids, lengths=torch.tensor([1024], device="cuda")), 1)
    print(f"[4b] prefill T=1024, the forward alone without the page writes, "
          f"eager: {wall:.2f} ms host clock, device busy "
          f"{busy:.2f} ms, idle share {1 - busy / wall:.3f}", flush=True)
    print(f"[4b] prefill:1024 captured {pre.captures} time(s); the capture "
          f"with its warm-up run took {pre.capture_seconds * 1e3:.1f} ms of "
          f"host clock", flush=True)
    check(pre.captures == 1, f"[4b]: {pre.captures} prefill:1024 captures")


# --------------------------------------------------------------- phase 4c
def graph_vs_eager(model, prompts, sp, want_outs):
    """[4]'s requests through a new engine whose decode step, after each
    replay, also runs its eager function on the same buffers: the sampled
    (greedy) tokens must be identical at every step; the logits' largest
    difference is reported. A second replay then puts the graph's own K/V
    back, so the engine goes on along the graph's path."""
    from paddle_tpu_torch.serving import Engine, EngineConfig

    eng = Engine(model, EngineConfig(max_batch_size=8, max_seq_len=2048),
                 device="cuda")
    step = eng.step_program("decode")
    graph_run = step.run
    seen = {"steps": 0, "differ": 0, "logits": 0.0}

    def run(**host):
        out = graph_run(**host)
        g_tok, g_logits = out[0].clone(), out[1].clone()
        e_tok, e_logits = step.fn()
        seen["steps"] += 1
        seen["differ"] += int(not torch.equal(g_tok, e_tok))
        seen["logits"] = max(seen["logits"], max_err(g_logits, e_logits))
        step.replay()
        return out

    step.run = run
    pre = {"runs": 0, "differ": 0}
    make = eng.step_program

    def step_program(name):
        st = make(name)
        if name.startswith("prefill:") and "run" not in vars(st):
            st.run = functools.partial(prefill_vs_eager, eng, st,
                                       int(name.split(":")[1]), st.run, pre)
        return st

    eng.step_program = step_program
    t0 = time.perf_counter()
    outs = eng.generate(prompts, sp)
    print(f"[4c] prefill graphs vs their eager calls on the same buffers: "
          f"{pre['runs']} prefills, {pre['differ']} with logits or written "
          f"pages not bitwise equal; programs {graph_programs(eng)}",
          flush=True)
    check(pre["runs"] == len(prompts) and pre["differ"] == 0,
          f"[4c]: prefill graph and eager differ at {pre['differ']} of "
          f"{pre['runs']} prefills")
    print(f"[4c] decode graph vs its eager step on the same buffers, "
          f"{len(prompts)} requests: {seen['steps']} steps, "
          f"{seen['differ']} with differing tokens, logits max_abs_err "
          f"{seen['logits']:.3e} (reported; bitwise equal: "
          f"{seen['logits'] == 0.0}); outputs equal [4]'s: "
          f"{outs == want_outs}; {time.perf_counter() - t0:.1f} s",
          flush=True)
    check(seen["steps"] > 0 and seen["differ"] == 0,
          f"[4c]: the graph's tokens differ from the eager step's at "
          f"{seen['differ']} of {seen['steps']} steps")
    check(step.captures == 1, f"[4c]: {step.captures} decode captures")


def prefill_vs_eager(eng, step, T, graph_run, seen, **host):
    """A prefill program's run, then its eager function on the same
    buffers: the logits and the slot's pages the prompt was written to
    must be bitwise equal (``seen`` counts runs and differences). The
    trash page, where the bucket's blocks past the slot's pages all write
    in no set order, is not compared. A second replay puts the graph's
    own values back."""
    out = graph_run(**host)
    ps = eng.cache.page_size
    row = host["row"][0, :(T + ps - 1) // ps]
    pages = torch.from_numpy(row[row > 0].astype(np.int64)).cuda()
    g = (out[0].clone(), eng.cache.k[:, pages].clone(),
         eng.cache.v[:, pages].clone())
    e = (step.fn()[0], eng.cache.k[:, pages], eng.cache.v[:, pages])
    seen["runs"] += 1
    seen["differ"] += int(not all(map(torch.equal, g, e)))
    step.replay()
    return out


def graph_memory(model, eng_cfg):
    """[4d]: the memory an engine's graphs reserve with every bucket's
    prefill and extend program captured (paged, prefix cache on, [4]'s
    envelope), all in the one pool the engine shares among its programs,
    and for comparison each in a private pool of its own. The bucket
    programs run on slot 0's row, all sentinels: their writes land on the
    trash page. Engines kept by reference cycles ([4c]'s) are collected
    first: freeing their graphs during a capture would release memory
    inside the measurement."""
    from paddle_tpu_torch.serving import Engine, EngineConfig

    seen = {}
    for kind in ("shared", "private"):
        eng = Engine(model, EngineConfig(
            max_batch_size=eng_cfg.max_batch_size,
            max_seq_len=eng_cfg.max_seq_len, prefix_cache=True),
            device="cuda")
        if kind == "private":
            eng._graph_pool = None
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        for T in eng.config.prefill_buckets:
            for prog in ("prefill", "extend"):
                eng.step_program(f"{prog}:{T}").run(
                    ids=np.zeros((1, T), np.int64), length=np.array([T]),
                    row=eng.cache.page_table[:1],
                    start=np.array([0], np.int32))
        torch.cuda.synchronize()
        seen[kind] = (torch.cuda.memory_reserved() - mem0) / 2**30
        pools = {st.pool for st in eng.steps.values()}
        print(f"[4d] every bucket's prefill and extend captured "
              f"({len(eng.steps)} programs, buckets "
              f"{list(eng.config.prefill_buckets)}), {kind} pool"
              f"{'' if kind == 'shared' else 's'}: memory reserved +"
              f"{seen[kind]:.3f} GiB, captures {time.perf_counter() - t0:.1f}"
              f" s", flush=True)
        check(all(st.captures == 1 for st in eng.steps.values())
              and pools == {eng._graph_pool},
              f"[4d] {kind}: captures or pools wrong ({pools})")
        del eng
    torch.cuda.empty_cache()
    check(seen["shared"] <= seen["private"],
          f"[4d]: the shared pool reserved more than private ones: {seen}")


# ------------------------------------------------------------ phases 11, 12
def prefix_spec_prompts(vocab, rng, suffix_lengths=None):
    """16 prompts: a 512-token shared prefix and a distinct suffix of 64-256
    tokens (or of ``suffix_lengths``), the even ones a repeated 32-token
    phrase (drafts match there), the odd ones random."""
    prefix = torch.randint(0, vocab, (512,), generator=rng).tolist()
    prompts = []
    for i in range(16):
        n = int(torch.randint(64, 257, (1,), generator=rng))
        if suffix_lengths is not None:
            n = suffix_lengths[i]
        if i % 2 == 0:
            phrase = torch.randint(0, vocab, (32,), generator=rng).tolist()
            suffix = (phrase * 8)[:n]
        else:
            suffix = torch.randint(0, vocab, (n,), generator=rng).tolist()
        prompts.append(prefix + suffix)
    return prompts


def serve_prefix_spec(K, model, device, prompts, sp, what, warm=()):
    """The prefix-and-speculative engine (8 slots, page 16, verify k = 3)
    serving ``prompts`` after a warm-up request that captures the verify
    step (and, with ``warm``, those prompts served first, which capture
    the prefill and extend programs ``prompts`` use; the trie is cleared
    after them); returns (engine, requests, seconds of ``prompts``,
    launch counts from the warm-up on)."""
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    eng = Engine(model, EngineConfig(max_batch_size=8, max_seq_len=2048,
                                     page_size=16, prefix_cache=True,
                                     speculative=3), device=device)
    K.reset_launch_counts()
    eng.generate([list(range(1, 65))], SamplingParams(max_new_tokens=4))
    if warm:
        eng.generate(list(warm), sp)
        eng.prefix_cache.clear()
    eng.spec_drafted = eng.spec_accepted = 0
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.add_request(p, sp) for p in prompts]
    while eng.has_unfinished:
        eng.step()
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    outs = [r.output_ids for r in reqs]
    check(all(len(o) == sp.max_new_tokens for o in outs)
          and all(0 <= t < model.cfg.vocab_size for o in outs for t in o),
          f"{what}: a request did not generate {sp.max_new_tokens} tokens "
          "in the vocabulary")
    kinds = {name.split(":")[0] for name in eng.steps}
    check("verify" in eng.steps and kinds <= {"verify", "prefill", "extend"}
          and all(st.captures == (device == "cuda")
                  for st in eng.steps.values()),
          f"{what}: programs {graph_programs(eng)}")
    return eng, reqs, wall, counts


def pool_all_free(eng, what):
    dropped = eng.prefix_cache.clear()
    free, total = eng.page_alloc.num_free, eng.page_alloc.num_allocatable
    print(f"    prefix_cache.clear() dropped {dropped} nodes: {free} of "
          f"{total} pages free", flush=True)
    check(free == total, f"{what}: the pool is not all free after clear()")


def prefix_spec_slice(K, model, prompts):
    """[11]: GPT-3 1.3B (bf16) behind the prefix-and-speculative engine, 16
    greedy requests sharing a 512-token prefix, 64 new tokens each; prefix
    hits, draft acceptance, one verify capture, throughput and latency,
    each kernel's launches; the pool all free after the trie is cleared;
    the token agreement with the plain engine, reported."""
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    sp = SamplingParams(max_new_tokens=64)
    # the warm-up: prompts of the same lengths, other tokens (another
    # shared prefix), so the timed run replays every program it uses
    warm = prefix_spec_prompts(model.cfg.vocab_size,
                               torch.Generator().manual_seed(len(prompts)),
                               [len(p) - 512 for p in prompts])
    mem0 = torch.cuda.memory_reserved()
    eng, reqs, wall, counts = serve_prefix_spec(K, model, "cuda", prompts,
                                                sp, "[11]", warm)
    n_tok = sum(r.num_generated for r in reqs)
    hits = sum(r.prefix_hit_blocks > 0 for r in reqs)
    ttft, tpot = request_latencies(reqs)
    print(f"[11] GPT-3 1.3B bf16, prefix cache + speculative k=3: "
          f"{len(reqs)} requests (512-token shared prefix + suffixes "
          f"{[len(p) - 512 for p in prompts]}), {n_tok} tokens in "
          f"{wall:.3f} s = {n_tok / wall:.1f} tokens/s", flush=True)
    print(f"    prefix hits {hits} of {len(reqs)} (blocks "
          f"{[r.prefix_hit_blocks for r in reqs]}); drafts accepted "
          f"{eng.spec_accepted} of {eng.spec_drafted} = "
          f"{eng.spec_accepted / max(eng.spec_drafted, 1):.3f}; verify "
          f"captures {eng.steps['verify'].captures}", flush=True)
    print(f"    TTFT p50 {ttft:.1f} ms, TPOT p50 {tpot:.2f} ms", flush=True)
    step = eng.steps["verify"]
    print(f"    programs (captures, replays, capture ms), all captured in "
          f"the warm-up: {graph_programs(eng)}; memory reserved "
          f"{mem0 / 2**30:.2f} -> {torch.cuda.memory_reserved() / 2**30:.2f} "
          f"GiB", flush=True)
    print(f"    wrapper launches from the warm-up on (the captures; replays "
          f"call no wrapper): {counts}", flush=True)
    check(hits >= 15, f"[11]: {hits} prefix hits of 16")

    def verify():
        for _ in range(4):
            step.replay()
            step.outputs[0].cpu()

    # what a replay runs on the card: 2 LayerNorms a block and the final
    # one, no flash forward and no paged decode (the verify step's
    # attention is plain PyTorch)
    L = model.cfg.num_layers
    syms = (NORM_SYMBOLS["fwd"], FWD_SYMBOL, *PAGED_SYMBOLS.values())
    want = dict.fromkeys(syms, 0)
    want[NORM_SYMBOLS["fwd"]] = 4 * (2 * L + 1)
    per = replay_launches(verify, syms, want, "[11]: 4 verify replays")
    print(f"    kernel launches on the card in 4 verify replays (profiler): "
          f"{per}", flush=True)

    # the step's device time depends on static shapes only, so replays on
    # its last buffers time it
    wall, busy, kernels = host_and_busy(verify, 4)
    print(f"    verify step alone (graph replay): {wall:.2f} ms host clock, "
          f"device busy {busy:.2f} ms, idle share {1 - busy / wall:.3f}",
          flush=True)
    for name, t in kernels[:6]:
        print(f"     {t / 4 * 1e3:8.3f} ms/step  {name[:90]}", flush=True)
    check(counts["fused_layer_norm"] > 0 and counts["flash_attention_fwd"] > 0,
          f"[11]: a kernel of the path was never launched: {counts}")
    check_flash_routes(K, "wgmma", "[11]")
    outs = [r.output_ids for r in reqs]
    pool_all_free(eng, "[11]")
    del eng
    plain = Engine(model, EngineConfig(max_batch_size=8, max_seq_len=2048),
                   device="cuda").generate(prompts, sp)
    same = sum(a == b for o, q in zip(outs, plain) for a, b in zip(o, q))
    print(f"    token agreement with the plain engine (bf16; reported, not "
          f"checked): {same} of {n_tok} tokens, "
          f"{sum(o == q for o, q in zip(outs, plain))} of {len(outs)} "
          f"requests identical", flush=True)


def prefix_spec_vs_plain(K, gpu_model, cpu_model, prompts):
    """[12]: [11]'s traffic at full width and depth 2 in fp32: the
    prefix-and-speculative engine on the card (its verify step captured)
    and on the CPU (plain versions) give the same tokens, which are also
    the plain engine's on the card."""
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    t0 = time.perf_counter()
    sp = SamplingParams(max_new_tokens=64)
    eng, reqs, _, counts = serve_prefix_spec(K, gpu_model, "cuda", prompts,
                                             sp, "[12] card")
    card = [r.output_ids for r in reqs]
    hits = sum(r.prefix_hit_blocks > 0 for r in reqs)
    accepted, drafted = eng.spec_accepted, eng.spec_drafted
    routes = check_flash_routes(K, "cuda_cores", "[12]")
    check(counts["fused_layer_norm"] > 0 and counts["flash_attention_fwd"] > 0,
          f"[12]: a kernel of the path was never launched: {counts}")
    pool_all_free(eng, "[12]")
    del eng
    _, reqs, cpu_s, _ = serve_prefix_spec(K, cpu_model, "cpu", prompts, sp,
                                          "[12] CPU")
    cpu = [r.output_ids for r in reqs]
    plain = Engine(gpu_model, EngineConfig(max_batch_size=8,
                                           max_seq_len=2048),
                   device="cuda").generate(prompts, sp)
    print(f"[12] depth-2 fp32 full width, prefix cache + speculative k=3: "
          f"prefix hits {hits} of 16, drafts accepted {accepted} of "
          f"{drafted}; flash forward by route on the card "
          f"{routes['flash_attention_fwd']}; the CPU run {cpu_s:.1f} s",
          flush=True)
    print(f"    card == CPU (plain versions): {card == cpu}; card == the "
          f"plain engine on the card: {card == plain}; first request "
          f"{card[0][:12]}...", flush=True)
    check(card == cpu, "[12]: tokens differ between the card and the CPU")
    check(card == plain, "[12]: tokens differ from the plain engine's")
    print(f"    phase 12 took {time.perf_counter() - t0:.1f} s", flush=True)


# ------------------------------------------------------------ phases 13, 14
def attend_share(cache, positions, step_busy_ms):
    """Device ms of the dense ``decode_attend`` over one layer's slice of
    ``cache`` at ``positions``, times the layers, and its share of a step
    of ``step_busy_ms``."""
    from paddle_tpu_torch.serving import decode_attend

    L, B, Hkv, _, D = cache.k.shape
    q = torch.randn(B, Hkv, 1, D, device="cuda").to(cache.k.dtype)

    def attend():
        for _ in range(L):
            decode_attend(q, cache.k[0], cache.v[0], positions)

    _, busy, _ = host_and_busy(attend, 1)
    return busy, busy / step_busy_ms


def replay_clock(step, n: int = 8):
    """(host clock ms, device busy ms, kernels) per replay of ``step`` on
    its buffers as they are."""
    def replays():
        for _ in range(n):
            step.replay()

    return host_and_busy(replays, n)


def generate_slice(K, model, rows, seed):
    """[13]: GPT-3 1.3B (bf16) through ``GPTForCausalLM.generate``: 8
    prompts of 512 tokens, 64 new greedy tokens. The first call captures
    the prefill and the decode step, later calls replay them; tokens/s of
    the second, the prefill and decode step's host clock against device
    busy, ``decode_attend``'s share of the step, the kernels a prefill
    and a decode replay run on the card by the profiler (24 flash
    forwards and 49 LayerNorms; 49 LayerNorms) and a call's replays (1
    and 63), and the first tokens against the paged engine's."""
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    t_phase = time.perf_counter()
    cfg, L, new = model.cfg, model.cfg.num_layers, 64
    ids = torch.randint(0, cfg.vocab_size, (8, 512),
                        generator=torch.Generator().manual_seed(seed + 13))
    ids = ids.cuda()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_reserved()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = model.generate(ids, max_new_tokens=new)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = K.launch_counts()
    state = model._generate_state
    r0 = (state.prefill.replays, state.decode.replays)
    t0 = time.perf_counter()
    again = model.generate(ids, max_new_tokens=new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    calls = (state.prefill.replays - r0[0], state.decode.replays - r0[1])
    check(out.shape == (8, 512 + new) and torch.equal(out[:, :512], ids)
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          f"[13]: generate returned {tuple(out.shape)} or ids out of range")
    check(torch.equal(out, again), "[13]: a replayed generate differs from "
          "the captured one")
    print(f"[13] GPT-3 1.3B bf16 GPTForCausalLM.generate, 8 prompts x 512 "
          f"tokens, {new} new greedy: first call (captures) {first_s:.3f} s, "
          f"second (replays) {wall:.3f} s = {8 * new / wall:.1f} tokens/s; "
          f"dense caches {state.cache.nbytes / 2**30:.2f} GiB, memory "
          f"reserved {mem0 / 2**30:.2f} -> "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB", flush=True)
    print(f"    captures: prefill {state.prefill.captures} "
          f"({state.prefill.capture_seconds * 1e3:.1f} ms with its warm-up "
          f"run), decode {state.decode.captures} "
          f"({state.decode.capture_seconds * 1e3:.1f} ms); wrapper launches "
          f"in the first call: {counts}", flush=True)
    check(state.prefill.captures == 1 and state.decode.captures == 1
          and model._generate_state is state,
          "[13]: the second call with the same key captured again")
    check(counts["fused_layer_norm"] > 0 and counts["flash_attention_fwd"] > 0,
          f"[13]: a kernel of the path was never launched: {counts}")
    check_flash_routes(K, "wgmma", "[13]")
    for name in ("fused_layer_norm", "flash_attention_fwd"):
        rows[name]["launches_generate"] = counts[name]
    # what a call runs on the card: its replays (the programs' counters over
    # the second call) times what a replay runs (the profiler's kernel
    # events over replays of each program). A whole call under the
    # profiler, ~45k kernel events, once came back short of what its
    # graphs hold (3030 LayerNorms, not a multiple of 49)
    syms = (NORM_SYMBOLS["fwd"], FWD_SYMBOL, *PAGED_SYMBOLS.values())
    per_replay = {"prefill": (state.prefill, 1, {NORM_SYMBOLS["fwd"]:
                                                2 * L + 1, FWD_SYMBOL: L}),
                  "decode step": (state.decode, 8,
                                  {NORM_SYMBOLS["fwd"]: 2 * L + 1})}
    for what, (step, n, each) in per_replay.items():
        w, busy, kernels = replay_clock(step, n)
        want = {sym: n * each.get(sym, 0) for sym in syms}
        got = replay_launches(lambda: [step.replay() for _ in range(n)],
                              syms, want, f"[13]: {n} {what} replay(s)")
        print(f"    {what} alone (graph replay): {w:.2f} ms host clock, "
              f"device busy {busy:.2f} ms, idle share {1 - busy / w:.3f}; "
              f"kernel launches on the card in {n} replay(s) (profiler): "
              f"{got}", flush=True)
        for kname, t in kernels[:5]:
            print(f"     {t / n * 1e3:8.3f} ms  {kname[:90]}", flush=True)
    print(f"    a call: {calls[0]} prefill and {calls[1]} decode step "
          f"replays, so {L * calls[0]} flash forwards and "
          f"{(2 * L + 1) * sum(calls)} LayerNorms on the card", flush=True)
    check(calls == (1, new - 1), f"[13]: a call replayed {calls}")
    attend, share = attend_share(state.cache, state.decode.buffers.positions,
                                 busy)
    print(f"    dense decode_attend, {L} layers over [8, 16, {512 + new}, "
          f"128]: {attend:.3f} ms device busy, {share:.3f} of the decode "
          f"step", flush=True)
    # the step's sampling (the engine's decode program's: a draw for the
    # greedy rows too) against the argmax alone, on the step's last logits
    from paddle_tpu_torch.serving.sampling import sample_batched

    bufs, logits = state.decode.buffers, state.decode.outputs[1]
    draw = host_and_busy(lambda: [sample_batched(
        logits, state.generator, bufs.temps, bufs.top_ks, bufs.greedy)
        for _ in range(8)], 8)[1]
    argmax = host_and_busy(lambda: [logits.float().argmax(dim=-1)
                                    for _ in range(8)], 8)[1]
    print(f"    the step's sampling over [8, {cfg.vocab_size}]: "
          f"{draw:.4f} ms device busy, the argmax alone {argmax:.4f} ms",
          flush=True)
    # the first token against the paged engine's on the same prompts; a
    # prompt whose two best logits lie within the two prefills' logit
    # difference (B 8 against B 1 GEMMs, bf16) is a tie, reported
    first = out[:, 512].tolist()
    eng = Engine(model, EngineConfig(max_batch_size=8, max_seq_len=2048),
                 device="cuda")
    paged = [o[0] for o in eng.generate(ids.tolist(),
                                        SamplingParams(max_new_tokens=1))]
    del eng
    with torch.no_grad():
        ref = torch.cat([model.prefill_with_cache(ids[b:b + 1])[0]
                         for b in range(8)]).float()
    err = max_err(state.prefill.outputs[0], ref)
    top2 = ref.topk(2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    ties = [b for b in range(8) if first[b] != paged[b]]
    print(f"    first tokens: generate {first}, paged engine {paged}; "
          f"prefill logits max_abs_err {err:.3e}; differing prompts {ties} "
          f"(top-2 gaps there {[round(gaps[b], 4) for b in ties]})",
          flush=True)
    check(all(gaps[b] <= 2 * err for b in ties),
          f"[13]: first tokens differ from the paged engine's at {ties} "
          f"beyond a tie")
    model._generate_state = None  # the caches and graphs go
    torch.cuda.empty_cache()
    print(f"    phase 13 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def dense_engine_slice(K, model, prompts, lengths, sp, paged_outs, rows):
    """[14]: [4]'s requests through the dense ``Engine`` (8 slots, S_max
    2048): warm-up requests capture each bucket's prefill and the decode
    step, then the 16 requests for tokens/s, TTFT and TPOT p50; the
    decode step's host clock against device busy and ``decode_attend``'s
    share of it; the token agreement with the paged engine, reported."""
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    t_phase = time.perf_counter()
    eng = Engine(model, EngineConfig(max_batch_size=8, max_seq_len=2048,
                                     kv_layout="dense"), device="cuda")
    buckets = sorted({eng._bucket(n) for n in [64] + lengths})
    warm = prompts[0][:64]
    torch.cuda.synchronize()
    K.reset_launch_counts()
    eng.generate([warm * (T // 64) for T in buckets],
                 SamplingParams(max_new_tokens=4))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.add_request(p, sp) for p in prompts]
    while eng.has_unfinished:
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    outs = [r.output_ids for r in reqs]
    check(all(len(o) == sp.max_new_tokens for o in outs)
          and all(0 <= t < model.cfg.vocab_size for o in outs for t in o),
          "[14]: a request did not generate its tokens in the vocabulary")
    n_tok = sum(len(o) for o in outs)
    ttft, tpot = request_latencies(reqs)
    print(f"[14] GPT-3 1.3B bf16, dense Engine (B 8, S_max 2048, KV "
          f"{eng.cache.nbytes / 2**30:.2f} GiB), [4]'s 16 requests: {n_tok} "
          f"tokens in {wall:.3f} s = {n_tok / wall:.1f} tokens/s; TTFT p50 "
          f"{ttft:.1f} ms, TPOT p50 {tpot:.2f} ms", flush=True)
    print(f"    programs (captures, replays, capture ms): "
          f"{graph_programs(eng)}; wrapper launches from the warm-up on: "
          f"{counts}", flush=True)
    check(set(graph_programs(eng)) == {"decode",
                                       *(f"prefill:{T}" for T in buckets)}
          and all(st.captures == 1 for st in eng.steps.values()),
          f"[14]: programs {graph_programs(eng)}")
    check(counts["fused_layer_norm"] > 0 and counts["flash_attention_fwd"] > 0
          and counts["paged_attention"] == 0,
          f"[14]: the dense path's launches {counts}")
    for name in ("fused_layer_norm", "flash_attention_fwd"):
        rows[name]["launches_dense"] = counts[name]
    same = sum(a == b for o, q in zip(outs, paged_outs) for a, b in zip(o, q))
    print(f"    token agreement with the paged engine ([4], bf16; reported, "
          f"not checked): {same} of {n_tok} tokens, "
          f"{sum(o == q for o, q in zip(outs, paged_outs))} of {len(outs)} "
          f"requests identical", flush=True)
    step = eng.steps["decode"]
    w, busy, kernels = replay_clock(step)
    syms = (NORM_SYMBOLS["fwd"], FWD_SYMBOL, *PAGED_SYMBOLS.values())
    want = {**dict.fromkeys(syms, 0),
            NORM_SYMBOLS["fwd"]: 2 * model.cfg.num_layers + 1}
    per = replay_launches(lambda: step.replay(), syms, want,
                          "[14]: a dense decode replay")
    attend, share = attend_share(eng.cache, step.buffers.positions, busy)
    print(f"    dense decode step alone (graph replay): {w:.2f} ms host "
          f"clock, device busy {busy:.2f} ms, idle share {1 - busy / w:.3f}; "
          f"decode_attend {attend:.3f} ms, {share:.3f} of it; a replay "
          f"launched {per}", flush=True)
    for kname, t in kernels[:5]:
        print(f"     {t / 8 * 1e3:8.3f} ms  {kname[:90]}", flush=True)
    del eng
    torch.cuda.empty_cache()
    print(f"    phase 14 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def dense_vs_plain(K, gpu_model, cpu_model, rng):
    """[14], depth 2 fp32 at full width: ``generate`` and the dense engine
    on the card (every flash forward on the CUDA cores) and on the CPU
    (plain versions) give identical tokens."""
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    t0 = time.perf_counter()
    V = cpu_model.cfg.vocab_size
    prompts = [torch.randint(0, V, (n,), generator=rng).tolist()
               for n in (17, 100, 45)]
    ids = torch.randint(0, V, (2, 100), generator=rng)
    sp = SamplingParams(max_new_tokens=8)
    cfg = EngineConfig(max_batch_size=2, max_seq_len=2048, kv_layout="dense")
    K.reset_launch_counts()
    card = (Engine(gpu_model, cfg, device="cuda").generate(prompts, sp),
            gpu_model.generate(ids.cuda(), max_new_tokens=8).cpu())
    counts = K.launch_counts()
    routes = check_flash_routes(K, "cuda_cores", "[14] fp32")
    cpu = (Engine(cpu_model, cfg, device="cpu").generate(prompts, sp),
           cpu_model.generate(ids, max_new_tokens=8))
    print(f"[14] depth-2 fp32 full width: dense engine card {card[0]}, CPU "
          f"{cpu[0]}; generate card == CPU: {torch.equal(card[1], cpu[1])} "
          f"({card[1][:, 100:].tolist()}); flash forward by route "
          f"{routes['flash_attention_fwd']}; {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    check(counts["fused_layer_norm"] > 0 and counts["flash_attention_fwd"] > 0,
          f"[14] fp32: a kernel of the path was never launched: {counts}")
    check(card[0] == cpu[0], "[14]: the dense engine's tokens differ between "
          "the card and the CPU")
    check(torch.equal(card[1], cpu[1]), "[14]: generate's tokens differ "
          "between the card and the CPU")
    gpu_model._generate_state = cpu_model._generate_state = None


# ---------------------------------------------------------------- phase 5
def decode_logits(model, prompt, gen_tokens, device):
    """Prefill ``prompt`` into a one-slot paged cache, then feed all but the
    last generated token through ``decode_step``; returns the logits that
    predicted the last generated token."""
    from paddle_tpu_torch.serving.kv_cache import PagedKVCache

    cfg = model.cfg
    cache = PagedKVCache(cfg.num_layers, 1, cfg.num_kv_heads, 2048,
                         cfg.head_dim, model.dtype, page_size=16,
                         device=device)
    cache.assign_pages(0, list(range(1, cache.num_blocks + 1)))
    n = len(prompt)
    T = 1 << max(3, (n - 1).bit_length())
    ids = torch.zeros((1, T), dtype=torch.long)
    ids[0, :n] = torch.tensor(prompt)
    logits, kvs = model.prefill_with_cache(
        ids.to(device), lengths=torch.tensor([n], device=device))
    cache.write_prefill(kvs, cache.page_table[0], T)
    for i, tok in enumerate(gen_tokens[:-1]):
        logits, _ = model.decode_step(
            torch.tensor([tok], device=device), cache.layer_caches(),
            torch.tensor([n + i], dtype=torch.int32, device=device))
    return logits[0]


# ---------------------------------------------------------------- phase 6
def train_model(seed: int):
    """[6]'s configuration (bench_gpt_dp's), its model on the card in bf16
    from the seed, its AdamW (fp32 master weights, bf16 moments) and its
    one fixed batch of 16 x 2048."""
    from paddle_tpu_torch.models.gpt import GPT3_1p3B, GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig(**GPT3_1p3B, dropout=0.0, use_recompute=True,
                    recompute_interval=1, loss_chunk=128)
    model = GPTForCausalLM(
        cfg, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(seed))
    model.train()
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                multi_precision=True, moment_dtype="bfloat16")
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    x = torch.randint(0, cfg.vocab_size, (16, 2048), generator=g,
                      device="cuda")
    return cfg, model, opt, x, torch.roll(x, -1, dims=1)


def train_slice(K, seed: int, rows):
    """GPT-3 1.3B train steps at full width (bench_gpt_dp's configuration
    at its batch of 16); fills the training kernels' launch counts into
    ``rows``."""
    import math

    from paddle_tpu_torch.distributed.fleet import make_sharded_train_step

    timed = 5
    t_phase = t0 = time.perf_counter()
    cfg, model, opt, x, y = train_model(seed)
    B, S = x.shape
    step = make_sharded_train_step(model, opt)
    n = sum(p.numel() for p in model.parameters())
    n_tensors = sum(1 for _ in model.parameters())
    torch.cuda.synchronize()
    print(f"[6] GPT-3 1.3B train step ({n / 1e9:.3f} B params in {n_tensors} "
          f"tensors, bf16, fp32 master weights, bf16 moments, recompute every "
          f"block, loss_chunk {cfg.loss_chunk}), batch {B} x {S}; built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    losses = [step(x, y)]
    torch.cuda.synchronize()
    print(f"    warm-up step {time.perf_counter() - t0:.2f} s", flush=True)
    K.reset_launch_counts()
    copies0 = getattr(opt, "master_copies", None)
    clock = HostClock(step.optimizer, "apply_gradients")
    t0 = time.perf_counter()
    for _ in range(timed):
        losses.append(step(x, y))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / timed
    clock.close()
    counts = K.launch_counts()
    copies = None if copies0 is None else opt.master_copies - copies0
    routes = check_flash_routes(K, "wgmma", "[6]")
    peak = torch.cuda.max_memory_allocated()
    launched = profile_launches(lambda: losses.append(step(x, y)))
    kernels = [(name, t) for name, t, _ in launched]
    busy, top = sum(t for _, t in kernels), kernels[:10]
    adamw_ms, adamw_n = optimizer_device_ms(
        lambda: losses.append(step(x, y)), opt)
    flash_ms = {k: kernel_ms(kernels, sym) for k, sym in
                (("fwd", FWD_SYMBOL), *BWD_SYMBOLS.items())}
    norm_ms = {k: kernel_ms(kernels, sym) for k, sym in NORM_SYMBOLS.items()}
    losses = [float(v) for v in losses]
    tokens = B * S
    # bench.py's FLOP count (bench_gpt_dp): 6N + 12*L*H*S per token; it
    # leaves out the recomputed forward
    flops = (6 * n + 12 * cfg.num_layers * cfg.hidden_size * S) * tokens
    print(f"    losses {' '.join(f'{v:.4f}' for v in losses)} (ln V = "
          f"{math.log(cfg.vocab_size):.4f})", flush=True)
    print(f"    step {step_s * 1e3:.1f} ms host clock over {timed} steps = "
          f"{tokens / step_s:.1f} tokens/s; MFU {flops / step_s / PEAK_BF16:.4f}"
          f" ({flops:.4e} FLOP/step, recompute not counted, vs 989 TFLOP/s); "
          f"max memory allocated {peak / 2**30:.2f} GiB", flush=True)
    print(f"    profiled step: device busy {busy * 1e3:.1f} ms, idle share "
          f"{1 - busy / step_s:.4f} (against the timed steps' mean)",
          flush=True)
    for name, t in top:
        print(f"     {t * 1e3:9.3f} ms  {name[:90]}", flush=True)
    print(f"    kernel launches over the {timed} timed steps: {counts}; "
          f"flash kernels by route: {routes}", flush=True)
    adamw = adamw_wrapper(K)
    # one launch for the one dtype combination (fp32 master, bf16 g/m/v);
    # a tree without the grouped launch: one per tensor
    want_adamw = 1 if adamw == "fused_adamw_multi" else n_tensors
    print(f"    AdamW: {counts[adamw] / timed:g} launches of {adamw} a step "
          f"({n_tensors} tensors), master weights copied by copy_ "
          f"{'not counted' if copies is None else copies / timed:} a step; "
          f"apply_gradients {clock.seconds / timed * 1e3:.2f} ms host clock "
          f"a step (a launch blocks once the launch queue is full); a "
          f"further profiled step: apply_gradients' {adamw_n} kernels on "
          f"the card, {adamw_ms:.3f} ms of device time "
          f"({nvidia_smi_line()})", flush=True)
    print(f"    profiled step: {FWD_SYMBOL} {fmt(flash_ms['fwd'], '.3f')} ms, "
          f"{BWD_SYMBOLS['dq']} {fmt(flash_ms['dq'], '.3f')} ms, "
          f"{BWD_SYMBOLS['dkv']} {fmt(flash_ms['dkv'], '.3f')} ms of device "
          f"time", flush=True)
    L = cfg.num_layers
    print(f"    profiled step: LayerNorm {NORM_SYMBOLS['fwd']} "
          f"{fmt(norm_ms['fwd'], '.3f')} ms ({counts['fused_layer_norm'] / timed:g}"
          f" launches per step), backward {NORM_SYMBOLS['bwd']} "
          f"{fmt(norm_ms['bwd'], '.3f')} ms + {NORM_SYMBOLS['reduce']} "
          f"{fmt(norm_ms['reduce'], '.3f')} ms "
          f"({counts['layer_norm_bwd'] / timed:g} launches per step) of "
          f"device time", flush=True)
    check(None not in flash_ms.values(), f"the profiled step shows no "
          f"{FWD_SYMBOL} or {' or '.join(BWD_SYMBOLS.values())}: {flash_ms}")
    check(None not in norm_ms.values(), f"the profiled step shows no "
          f"{' or '.join(NORM_SYMBOLS.values())}: {norm_ms}")
    # LayerNorm: two per block, replayed by the recompute, and the final
    # one; one backward each for the 2L + 1 of the loss's graph
    check(counts["fused_layer_norm"] == (4 * L + 1) * timed
          and counts["layer_norm_bwd"] == (2 * L + 1) * timed,
          f"LayerNorm launches per step differ from 4L + 1 forwards and "
          f"2L + 1 backwards: {counts}")
    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    check(abs(losses[0] - math.log(cfg.vocab_size)) <= 0.5,
          f"first loss {losses[0]} is not within 0.5 of ln V")
    check(losses[-1] < losses[0], f"the loss did not fall: {losses}")
    check(all(counts[k] > 0 for k in training_kernels(K)),
          f"a kernel of the training path was never launched: {counts}")
    check(counts["flash_attention_fwd"] == 2 * L * timed
          and counts["flash_attention_bwd_dq"] == L * timed
          and counts["flash_attention_bwd_dkv"] == L * timed
          and counts[adamw] == want_adamw * timed and copies in (None, 0)
          and (adamw_n == want_adamw or copies is None),
          f"launches per step differ from 2L flash forwards (recompute), L "
          f"dq and dk/dv, {want_adamw} AdamW and no master copy: {counts}, "
          f"copies {copies}, AdamW kernels in the profiled step {adamw_n}")
    print(f"    digest of the {len(losses)} losses, the parameters and the "
          f"AdamW state after them: {state_digest(losses, state_tensors(step))}",
          flush=True)
    for name, kname in zip(TRAINING_KERNELS, training_kernels(K)):
        # LayerNorm and flash fwd serve as well
        key = "launches_train" if "launches" in rows[name] else "launches"
        rows[name][key] = counts[kname]
    rows["fused_adamw_multi"].update(
        train_apply_gradients_host_ms=clock.seconds / timed * 1e3,
        train_device_ms=adamw_ms, train_master_copies=copies)
    print(f"    phase 6 took {time.perf_counter() - t_phase:.1f} s", flush=True)
    del model, opt, step
    torch.cuda.empty_cache()
    return step_s


# ---------------------------------------------------------------- phase 7
def train_vs_plain(K, seed: int):
    """Full width, depth 2, fp32: 3 AdamW steps on the card (kernels) and
    on the CPU (plain versions) from the same weights and batches."""
    from paddle_tpu_torch.distributed.fleet import make_sharded_train_step
    from paddle_tpu_torch.models.gpt import GPT3_1p3B, GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    t0 = time.perf_counter()
    cfg = GPTConfig(**{**GPT3_1p3B, "num_layers": 2}, dropout=0.0,
                    use_recompute=True, loss_chunk=64)
    cpu = GPTForCausalLM(cfg, device="cpu", dtype=torch.float32,
                         generator=torch.Generator().manual_seed(seed))
    gpu = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32)
    gpu.load_state_dict(cpu.state_dict())
    p0 = {k: p.detach().clone() for k, p in cpu.named_parameters()}
    lr = 1e-3
    steps = {}
    for side, dev, m in (("card", "cuda", gpu), ("cpu", "cpu", cpu)):
        m.train()
        steps[side] = make_sharded_train_step(
            m, AdamW(learning_rate=lr, parameters=m.named_parameters()),
            device=dev)
    rng = torch.Generator().manual_seed(seed + 2)
    K.reset_launch_counts()
    for i in range(3):
        x = torch.randint(0, cfg.vocab_size, (2, 128), generator=rng)
        y = torch.roll(x, -1, dims=1)
        lg = float(steps["card"](x, y))
        lc = float(steps["cpu"](x, y))
        # fp32 CE near ln V: GEMM summation orders differ (cuBLAS / CPU)
        print(f"[7] step {i + 1}: loss card {lg:.6f} CPU {lc:.6f} (|diff| "
              f"{abs(lg - lc):.2e}, tol 1e-4)", flush=True)
        check(abs(lg - lc) <= 1e-4, f"step {i + 1} losses differ: {lg} {lc}")
        if i == 0:
            # the autograd repair: every parameter has a gradient on the
            # card, and it agrees with the CPU's to 1e-3 of its largest
            # entry (fp32 summation order through two blocks and the head)
            missing = [k for k, p in gpu.named_parameters() if p.grad is None]
            check(not missing, f"parameters without a gradient on the card: "
                  f"{missing}")
            worst = max((max_err(p.grad.cpu(), q.grad)
                         / max(q.grad.abs().max().item(), 1e-30), k)
                        for (k, p), q in zip(gpu.named_parameters(),
                                             cpu.parameters()))
            print(f"    step 1 gradients: every parameter has one on the "
                  f"card; worst max|diff| / max|grad| {worst[0]:.2e} "
                  f"({worst[1]}, tol 1e-3)", flush=True)
            check(worst[0] <= 1e-3, f"gradients differ: {worst}")
    counts = K.launch_counts()
    check(all(counts[k] > 0 for k in TRAINING_KERNELS),
          f"kernels not used on the card: {counts}")
    check_flash_routes(K, "cuda_cores", "[7]")
    print(f"    after step 3 (3 steps of lr {lr} move a parameter up to "
          f"~{3 * lr:.0e}); launches {counts}, every flash launch on the "
          f"fp32 route", flush=True)
    compare_updates(cfg, p0, gpu, cpu, 3, lr)
    print(f"    phase 7 took {time.perf_counter() - t0:.1f} s", flush=True)


def compare_updates(cfg, p0, card, cpu, steps, lr):
    """||update on the card - update on the CPU|| / ||update on the CPU||
    over the model and per tensor, with the K third of each qkv bias set
    apart (its true gradient is zero; Adam moves its rounding noise by up
    to lr a step, so it is held to 2 * steps * lr); checks 1e-2 each."""
    k_part = slice(cfg.num_heads * cfg.head_dim,
                   (cfg.num_heads + cfg.num_kv_heads) * cfg.head_dim)
    num = den = 0.0
    worst, k_bias = (0.0, ""), 0.0
    for (k, p), q in zip(card.named_parameters(), cpu.parameters()):
        dg, dc = p.detach().cpu() - p0[k], q.detach() - p0[k]
        if k.endswith("attn.qkv.bias"):
            k_bias = max(k_bias, max_err(dg[k_part], dc[k_part]))
            dg[k_part] = dc[k_part] = 0
        d2, c2 = (dg - dc).square().sum().item(), dc.square().sum().item()
        num, den = num + d2, den + c2
        worst = max(worst, ((d2 / max(c2, 1e-30)) ** 0.5, k))
    total = (num / den) ** 0.5
    print(f"    updates, the K third of the qkv biases set apart: {total:.2e} "
          f"over the model, worst tensor {worst[0]:.2e} ({worst[1]}) (tol "
          f"1e-2 each); the K third {k_bias:.2e} (tol {2 * steps * lr:.0e})",
          flush=True)
    check(total <= 1e-2 and worst[0] <= 1e-2 and k_bias <= 2 * steps * lr,
          f"parameter updates differ: {total}, {worst}, K bias {k_bias}")


# ---------------------------------------------------------------- phase 8
def warmup_cosine(sched_mod, base_lr, warmup, start_lr):
    return sched_mod.LinearWarmup(
        sched_mod.CosineAnnealingDecay(base_lr, 1000), warmup, start_lr,
        base_lr)


def train_surface(K, seed):
    """GPT-3 1.3B (bf16, batch 16 x 2048) through the training surface:
    scheduler, loss scaler and run_steps, under each recompute policy."""
    import math

    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.distributed.fleet import make_sharded_train_step
    from paddle_tpu_torch.models.gpt import GPT3_1p3B, GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as sched_mod

    B, S, KS = 16, 2048, 3
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    x = torch.randint(0, GPT3_1p3B["vocab_size"], (B, S), generator=g,
                      device="cuda")
    y = torch.roll(x, -1, dims=1)
    xs, ys = x.expand(KS, B, S), y.expand(KS, B, S)
    # LinearWarmup(CosineAnnealingDecay(1e-4, 1000), 2, 0.0, 1e-4): epochs
    # 0 and 1 of the warm-up, (end - start) * e / warmup + start
    want_lrs = [(1e-4 - 0.0) * e / 2 + 0.0 for e in (0, 1)]
    results = {}
    for policy in (None, "save_flash", "dots_saveable"):
        t0 = time.perf_counter()
        cfg = GPTConfig(**GPT3_1p3B, dropout=0.0, use_recompute=True,
                        recompute_policy=policy, loss_chunk=128)
        model = GPTForCausalLM(
            cfg, device="cuda", dtype=torch.bfloat16,
            generator=torch.Generator(device="cuda").manual_seed(seed))
        model.train()
        sched = warmup_cosine(sched_mod, 1e-4, 2, 0.0)
        opt = AdamW(learning_rate=sched, parameters=model.named_parameters(),
                    multi_precision=True, moment_dtype="bfloat16")
        scaler = GradScaler(init_loss_scaling=2.0 ** 15)
        step = make_sharded_train_step(model, opt, scaler=scaler)
        n = sum(p.numel() for p in model.parameters())
        lrs = [opt.get_lr()]
        losses = [float(step(x, y))]
        sched.step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        lrs.append(opt.get_lr())
        t1 = time.perf_counter()
        out = step.run_steps(xs, ys)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t1) / KS
        counts = K.launch_counts()
        sched.step()
        peak = torch.cuda.max_memory_allocated()
        losses += [float(v) for v in out]
        tokens = B * S
        flops = (6 * n + 12 * cfg.num_layers * cfg.hidden_size * S) * tokens
        fwd = counts["flash_attention_fwd"] / KS
        results[policy] = (step_s, peak, fwd, losses)
        print(f"[8] policy {policy}: losses {' '.join(f'{v:.4f}' for v in losses)}"
              f"; rates used {lrs} (schedule {want_lrs}); loss scale "
              f"{step.loss_scaling():g}", flush=True)
        print(f"    run_steps({KS}): {step_s * 1e3:.1f} ms/step = "
              f"{tokens / step_s:.1f} tokens/s, MFU "
              f"{flops / step_s / PEAK_BF16:.4f}; max memory allocated "
              f"{peak / 2**30:.2f} GiB; per step: flash fwd {fwd:g}, dq "
              f"{counts['flash_attention_bwd_dq'] / KS:g}, dk/dv "
              f"{counts['flash_attention_bwd_dkv'] / KS:g}, AdamW "
              f"{counts[adamw_wrapper(K)] / KS:g}, LayerNorm "
              f"{counts['fused_layer_norm'] / KS:g}; policy took "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        L = cfg.num_layers
        check(all(math.isfinite(v) for v in losses), f"non-finite loss "
              f"under {policy}: {losses}")
        check(losses[-1] < losses[0], f"the loss did not fall under "
              f"{policy}: {losses}")
        check(lrs == want_lrs, f"rates {lrs} differ from the schedule "
              f"{want_lrs}")
        check(all(counts[k] > 0 for k in training_kernels(K)),
              f"a kernel of the training path was never launched: {counts}")
        check(fwd == (L if policy == "save_flash" else 2 * L),
              f"flash forwards per step under {policy}: {fwd}")
        check_flash_routes(K, "wgmma", f"[8] {policy}")
        del model, opt, step, sched, scaler, out
        torch.cuda.empty_cache()
    base = results[None][3]
    for policy, (_, _, _, losses) in results.items():
        print(f"    {policy}: losses - those of None "
              f"{max(abs(a - b) for a, b in zip(losses, base)):.2e}",
              flush=True)


# ---------------------------------------------------------------- phase 9
def surface_vs_plain(K, seed):
    """Full width, depth 2, fp32, save_flash, scheduler, scaler and
    run_steps on the card and on the CPU from the same weights."""
    import math

    from paddle_tpu_torch.amp import GradScaler
    from paddle_tpu_torch.distributed.fleet import make_sharded_train_step
    from paddle_tpu_torch.models.gpt import GPT3_1p3B, GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.optimizer import lr as sched_mod

    t0 = time.perf_counter()
    cfg = GPTConfig(**{**GPT3_1p3B, "num_layers": 2}, dropout=0.0,
                    use_recompute=True, recompute_policy="save_flash",
                    loss_chunk=64)
    cpu = GPTForCausalLM(cfg, device="cpu", dtype=torch.float32,
                         generator=torch.Generator().manual_seed(seed))
    gpu = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32)
    gpu.load_state_dict(cpu.state_dict())
    rng = torch.Generator().manual_seed(seed + 3)

    def batch(*lead):
        x = torch.randint(0, cfg.vocab_size, (*lead, 2, 128), generator=rng)
        return x, torch.roll(x, -1, dims=-1)

    # the kernels are deterministic: keeping O and LSE (save_flash) instead
    # of replaying the forward kernel gives the same gradients to the bit
    x, y = batch()
    grads, fwd = {}, {}
    for policy in (None, "save_flash"):
        gpu.cfg.recompute_policy = policy
        gpu.zero_grad(set_to_none=True)
        K.reset_launch_counts()
        gpu.forward_with_loss(x.cuda(), y.cuda()).backward()
        fwd[policy] = K.launch_counts()["flash_attention_fwd"]
        grads[policy] = {k: p.grad.clone() for k, p in gpu.named_parameters()}
    gpu.cfg.recompute_policy = "save_flash"
    gpu.zero_grad(set_to_none=True)
    same = all(torch.equal(grads[None][k], grads["save_flash"][k])
               for k in grads[None])
    print(f"[9] gradients under None and save_flash on the card: bitwise "
          f"equal {same}; flash forwards {fwd[None]} and "
          f"{fwd['save_flash']}", flush=True)
    check(same and fwd[None] == 2 * fwd["save_flash"] == 4,
          f"save_flash changed the gradients or the forwards: {fwd}")
    del grads
    p0 = {k: p.detach().clone() for k, p in cpu.named_parameters()}
    lr = 1e-3
    sides = {}
    for side, dev, m in (("card", "cuda", gpu), ("cpu", "cpu", cpu)):
        m.train()
        sched = warmup_cosine(sched_mod, lr, 2, 1e-4)
        # no finite fp32 scale overflows these fp32 gradients (the largest
        # is ~0.02 of the scale), so the first step's scale is infinite
        scaler = GradScaler(init_loss_scaling=float("inf"),
                            incr_every_n_steps=2)
        # epsilon 1e-6: Adam moves an entry whose gradient is at rounding
        # level by a full lr in the direction of that rounding; in a
        # 2048-entry tensor one such sign flip differs by ~1.5% in L2
        opt = AdamW(learning_rate=sched, epsilon=1e-6,
                    parameters=m.named_parameters())
        sides[side] = (make_sharded_train_step(m, opt, scaler=scaler,
                                               device=dev), sched, scaler)
    x, y = batch()
    K.reset_launch_counts()
    losses = {s: float(st(x, y)) for s, (st, _, _) in sides.items()}
    auto = {s: (sc._scale, sc._good_steps, sc._bad_steps)
            for s, (_, _, sc) in sides.items()}
    kept = {s: all(torch.equal(p.detach().cpu(), p0[k])
                   for k, p in m.named_parameters())
            for s, m in (("card", gpu), ("cpu", cpu))}
    moments = all(not s["moment1"].any() and s["beta1_pow"] == 1
                  for st, _, _ in sides.values()
                  for s in st.optimizer.state.values())
    print(f"    step 1 (scale inf): losses {losses}; parameters bitwise "
          f"unchanged {kept}; AdamW state untouched {moments}; automaton "
          f"(scale, good, bad) {auto}", flush=True)
    check(not any(math.isfinite(v) for v in losses.values())
          and all(kept.values())
          and moments and auto["card"] == auto["cpu"],
          "the overflowing step was not skipped alike on both sides")
    xs, ys = batch(3)
    out, lrs = {}, {}
    for s, (st, sched, sc) in sides.items():
        sc.set_init_loss_scaling(2.0 ** 15)
        sched.step()
        lrs[s] = st.optimizer.get_lr()
        out[s] = [float(v) for v in st.run_steps(xs, ys)]
    auto = {s: (sc._scale, sc._good_steps, sc._bad_steps)
            for s, (_, _, sc) in sides.items()}
    counts = K.launch_counts()
    diff = max(abs(a - b) for a, b in zip(out["card"], out["cpu"]))
    print(f"    run_steps(3) at lr {lrs}: losses card {out['card']}, CPU "
          f"{out['cpu']} (max |diff| {diff:.2e}, tol 1e-4); automaton "
          f"{auto}; launches {counts}", flush=True)
    check(diff <= 1e-4 and all(math.isfinite(v) for v in out["card"]),
          f"losses differ: {out}")
    check(auto["card"] == auto["cpu"] == (2.0 ** 16, 1, 0),
          f"the scaler's automaton differs: {auto}")
    check(lrs["card"] == lrs["cpu"], f"rates differ: {lrs}")
    check(all(counts[k] > 0 for k in TRAINING_KERNELS),
          f"kernels not used on the card: {counts}")
    check_flash_routes(K, "cuda_cores", "[9]")
    compare_updates(cfg, p0, gpu, cpu, 3, lr)
    print(f"    phase 9 took {time.perf_counter() - t0:.1f} s", flush=True)
    del cpu, gpu, sides
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 10
def user_api_path(K, ops, rows):
    """RMSNorm and the primitives through the user-facing API on the 1.3B's
    hidden states at the training batch; fills their launch counts."""
    from paddle_tpu_torch.incubate.nn.functional import fused_rms_norm
    from paddle_tpu_torch.nn import RMSNorm
    from paddle_tpu_torch.nn import functional as PF

    g = torch.Generator(device="cuda").manual_seed(10)
    H = 2048
    h = torch.randn(16, 2048, H, generator=g, device="cuda") \
        .to(torch.bfloat16).requires_grad_()
    dy = torch.randn(16, 2048, H, generator=g, device="cuda") \
        .to(torch.bfloat16)
    bias = torch.zeros(H, device="cuda", dtype=torch.bfloat16)
    alpha = torch.full_like(dy, 0.5)
    norm = RMSNorm(H, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * torch.randn(H, generator=g,
                                                device="cuda"))
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    y = norm(h)
    y.backward(dy)
    with torch.no_grad():
        y2 = PF.rms_norm(h, norm.weight)
        y3 = fused_rms_norm(h, norm.weight, bias, begin_norm_axis=-1)
        r = ops["x + a*y"](h.detach(), y.detach(), alpha)
        t = ops["x + a*tanh(y)"](h.detach(), y.detach(), alpha)
        s, mx = ops["row sum"](r), ops["row max"](t)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    finite = all(bool(torch.isfinite(v).all()) for v in
                 (y, h.grad, norm.weight.grad, r, t, s, mx))
    print(f"[10] nn.RMSNorm fwd+bwd, F.rms_norm, incubate fused_rms_norm, "
          f"x + a*y, x + a*tanh(y), row sum and row max over bf16 "
          f"[16, 2048, {H}] in {wall * 1e3:.1f} ms: finite {finite}; "
          f"launches {counts}", flush=True)
    check(finite and s.shape == mx.shape == (16, 2048),
          "the user-facing path's outputs are not finite or misshapen")
    check(torch.equal(y2, y.detach()) and torch.equal(y3, y.detach()),
          "the RMSNorm entry points disagree")
    # nn.RMSNorm's forward and backward (the kernels, through
    # RMSNormFunction) against the plain versions from the same values
    w = norm.weight.detach()
    err_y = max_err(y, K.rms_norm_ref(h.detach(), w))
    dx, dw = K.rms_norm_bwd_ref(h.detach(), w, dy)
    errs = [(max_err(got, want), norm_grad_tol(want))
            for got, want in ((h.grad, dx), (norm.weight.grad, dw))]
    print(f"     nn.RMSNorm vs plain: forward err {err_y:.3e} (tol "
          f"{TOL[('rms_norm', 'bfloat16')]:.1e}), backward dx err "
          f"{errs[0][0]:.3e} (tol {errs[0][1]:.3e}), dw err {errs[1][0]:.3e} "
          f"(tol {errs[1][1]:.3e})", flush=True)
    check(err_y <= TOL[("rms_norm", "bfloat16")]
          and all(e <= tol for e, tol in errs),
          f"nn.RMSNorm on the card: {err_y} {errs}")
    del dx, dw
    check(all(counts[k] > 0 for k in USER_API_KERNELS),
          f"a kernel of the user-facing path was never launched: {counts}")
    for name in USER_API_KERNELS:
        rows[name]["launches"] = counts[name]
    del h, dy, alpha, y, y2, y3, r, t
    torch.cuda.empty_cache()


# --------------------------------------------------------------- phase 15
def state_tensors(step):
    """The train step's state by name: each parameter, and each optimizer
    slot as ``name/slot`` (tensors; the step powers fp32 host scalars)."""
    out = dict(step.params)
    for name, slots in step.optimizer.state.items():
        out.update({f"{name}/{k}": v for k, v in slots.items()})
    return out


def state_checksum(state) -> int:
    """Sum over the tensors of their words as integers (int64 sums mod
    2**64), a summary printed beside the bitwise comparison."""
    total = 0
    for v in state.values():
        if isinstance(v, torch.Tensor):
            words = v.detach().reshape(-1).view(
                {1: torch.uint8, 2: torch.int16, 4: torch.int32}[
                    v.element_size()])
            total += int(words.to(torch.int64).sum())
        else:
            total += int(np.asarray(v).view(np.int32))
    return total % 2 ** 64


def state_digest(losses, state) -> str:
    """A SHA-256 over the losses' and every state entry's bits, by name:
    two runs of the same steps on the same inputs (in two checkouts, each
    in its own process) print the same digest iff every value is bitwise
    equal. Each tensor enters by its words' sum and their sum weighted by
    position (int64 on the card, mod 2**64), and its shape and dtype."""
    h = hashlib.sha256(np.asarray(losses, np.float32).tobytes())
    for name in sorted(state):
        v = state[name]
        h.update(name.encode())
        if isinstance(v, torch.Tensor):
            words = v.detach().reshape(-1).view(
                {1: torch.uint8, 2: torch.int16, 4: torch.int32}[
                    v.element_size()]).to(torch.int64)
            pos = torch.arange(1, words.numel() + 1, device=words.device)
            h.update(f"{v.dtype}{tuple(v.shape)}{int(words.sum())}"
                     f"{int((words * pos).sum())}".encode())
        else:
            h.update(np.asarray(v, np.float32).tobytes())
    return h.hexdigest()[:32]


def optimizer_device_ms(step_fn, opt):
    """(device ms, kernels) of ``opt.apply_gradients`` in one call of
    ``step_fn``, by the profiler: the kernels of the ops it runs inside a
    profiler range (a master's ``copy_``, a plain update) and the fused
    AdamW's, which ``ctypes`` launches outside any op (by name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    label = "chip_smoke::apply_gradients"
    opt.apply_gradients = scoped(opt.apply_gradients, label)
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step_fn()
            torch.cuda.synchronize()
    finally:
        del opt.apply_gradients
    ms, n = 0.0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and "fused_adamw" in e.name:
            ms, n = ms + (e.time_range.end - e.time_range.start) * 1e-3, n + 1
        scope = e
        while scope is not None and scope.name != label:
            scope = scope.cpu_parent
        if scope is None:
            continue
        for kern in e.kernels:
            if "fused_adamw" not in kern.name:
                ms, n = ms + kern.duration * 1e-3, n + 1
    return ms, n


class HostClock:
    """Host seconds spent in ``obj.name`` (a method wrapped on the
    instance until ``close``)."""

    def __init__(self, obj, name):
        self.obj, self.name, self.seconds = obj, name, 0.0
        fn = getattr(obj, name)

        @functools.wraps(fn)
        def clocked(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds += time.perf_counter() - t0
        setattr(obj, name, clocked)

    def close(self):
        delattr(self.obj, self.name)


def write_token_shards(directory: Path, seed: int, vocab: int, n_tokens: int,
                       n_shards: int = 4):
    """uint16 token shards of EOS-ended documents of 64 to 2048 tokens
    (EOS = 0), ``n_tokens`` in all, from ``seed``."""
    rng = np.random.default_rng(seed)
    per = n_tokens // n_shards
    paths = []
    for i in range(n_shards):
        toks = rng.integers(1, vocab, per, dtype=np.int64).astype(np.uint16)
        ends = np.cumsum(rng.integers(64, 2049, per // 64 + 1))
        toks[ends[ends < per] - 1] = 0
        toks[-1] = 0
        path = directory / f"tokens_{i:02d}.bin"
        toks.tofile(path)
        paths.append(str(path))
    return paths


def ckpt_resume_slice(K, seed: int, rows, step6_s):
    """GPT-3 1.3B (phase 6's configuration and optimizer) fed by the port's
    pipeline, saved through ``CheckpointManager`` after k steps and resumed
    into a model of other weights: the n steps after the save must be
    bitwise those of the run that kept going."""
    import math
    import os
    import tempfile

    from paddle_tpu_torch.checkpoint import CheckpointManager, TrainState
    from paddle_tpu_torch.data import build_pretrain_pipeline
    from paddle_tpu_torch.distributed.fleet import make_sharded_train_step
    from paddle_tpu_torch.models.gpt import GPT3_1p3B, GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    t_phase = time.perf_counter()
    cfg = GPTConfig(**GPT3_1p3B, dropout=0.0, use_recompute=True,
                    recompute_interval=1, loss_chunk=128)
    B, S, k, n, depth = 16, 2048, 2, 2, 2
    for where in (tempfile.gettempdir(), "/dev/shm"):
        if os.path.isdir(where):
            print(f"[15] free bytes in {where}: "
                  f"{shutil.disk_usage(where).free}", flush=True)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=CKPT_PARENT))
    try:
        files = write_token_shards(work, seed + 15, cfg.vocab_size,
                                   16 * B * S)

        def build(init_seed):
            model = GPTForCausalLM(
                cfg, device="cuda", dtype=torch.bfloat16,
                generator=torch.Generator(device="cuda").manual_seed(
                    init_seed))
            model.train()
            opt = AdamW(learning_rate=1e-4,
                        parameters=model.named_parameters(),
                        multi_precision=True, moment_dtype="bfloat16")
            step = make_sharded_train_step(model, opt, seed=seed)
            pipe = build_pretrain_pipeline(
                files, B, S, eos_id=0, seed=seed, process_index=0,
                process_count=1, prefetch_depth=depth, device="cuda")
            return step, pipe

        def train(step, it, steps):
            losses, times = [], []
            for _ in range(steps):
                t0 = time.perf_counter()
                x = next(it)["tokens"]
                loss = step(x, torch.roll(x, -1, dims=1))
                losses.append(float(loss))  # one read: the step's end
                times.append(time.perf_counter() - t0)
            return losses, times

        K.reset_launch_counts()
        step, pipe = build(seed)
        it = iter(pipe)
        losses_a, _ = train(step, it, k)
        mgr = CheckpointManager(str(work / "ckpt"), keep_last_n=1)
        ts = step.state_for_checkpoint()
        ts.data_position = pipe.get_state()
        torch.cuda.synchronize()
        mgr.save(step.step_index, ts.to_tree())
        blocking_ms = mgr.last_save["blocking_s"] * 1e3
        more_a, times_a = train(step, it, n)
        mgr.wait_until_finished()
        saved = mgr.last_save
        it.close()
        want = {name: (v.clone() if isinstance(v, torch.Tensor) else v)
                for name, v in state_tensors(step).items()}
        sum_a = state_checksum(want)
        wait_a = pipe.host_wait_ms_mean
        del step, pipe, it, ts
        gc.collect()
        torch.cuda.empty_cache()

        step, pipe = build(seed + 1)
        restored = CheckpointManager(str(work / "ckpt"))
        t0 = time.perf_counter()
        tree = restored.restore()
        read_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        step.restore_from_checkpoint(tree)
        pipe.set_state(TrainState.from_tree(tree).data_position)
        torch.cuda.synchronize()
        copy_s = time.perf_counter() - t1
        del tree
        it = iter(pipe)
        losses_b, times_b = train(step, it, n)
        it.close()
        counts = K.launch_counts()
        routes = check_flash_routes(K, "wgmma", "[15]")
        got = state_tensors(step)
        sum_b = state_checksum(got)
        differ = [name for name, v in want.items()
                  if not (torch.equal(v, got[name])
                          if isinstance(v, torch.Tensor)
                          else np.asarray(v).tobytes()
                          == np.asarray(got[name]).tobytes())]
        gb = saved["bytes"] / 1e9
        smi = nvidia_smi_line()
        print(f"[15] GPT-3 1.3B ({smi}) fed by TokenBinSource -> "
              f"SequencePacker -> GlobalBatchFeeder (prefetch {depth}) over "
              f"{len(files)} token files; run A: {k} steps, an async save "
              f"of step {k}, {n} steps; run B: other init weights, restored, "
              f"{n} steps", flush=True)
        print(f"    state on disk {saved['bytes']} bytes ({gb:.3f} GB) in "
              f"{work.parent}; save blocking {blocking_ms:.1f} ms (the "
              f"device-to-host snapshot), total {saved['total_s'] * 1e3:.1f} "
              f"ms ({smi})", flush=True)
        print(f"    restore: read and checked {read_s * 1e3:.1f} ms "
              f"({gb / read_s:.2f} GB/s), copied into the live state "
              f"{copy_s * 1e3:.1f} ms ({smi})", flush=True)
        print(f"    host wait per step (host_wait_ms_mean): run A "
              f"{wait_a:.3f} ms, run B {pipe.host_wait_ms_mean:.3f} ms; "
              f"step under the feeder: run A after the save "
              f"{' '.join(f'{t * 1e3:.1f}' for t in times_a)} ms (the "
              f"write in flight), run B "
              f"{' '.join(f'{t * 1e3:.1f}' for t in times_b)} ms, against "
              f"[6]'s {step6_s * 1e3:.1f} ms ({smi})", flush=True)
        print(f"    losses run A {losses_a + more_a}, run B {losses_b}; "
              f"state checksum A {sum_a} B {sum_b}; tensors that differ: "
              f"{len(differ)} of {len(want)}", flush=True)
        print(f"    kernel launches over both runs: {counts}; flash by "
              f"route: {routes}", flush=True)
        check(all(math.isfinite(v) for v in losses_a + more_a + losses_b),
              "[15]: a loss is not finite")
        check(losses_b == more_a, f"[15]: run B's losses {losses_b} are not "
              f"run A's {more_a}")
        check(not differ, f"[15]: run B's state differs from run A's in "
              f"{differ[:6]}")
        check(all(counts[name] > 0 for name in TRAINING_KERNELS),
              f"[15]: a kernel of the training path was never launched: "
              f"{counts}")
        for name in TRAINING_KERNELS:
            rows[name]["launches_resume"] = counts[name]
        mgr.close()
        restored.close()
        del step, pipe, it, want, got
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"    phase 15 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def dropout_resume(seed: int):
    """[15]'s resume with dropout 0.1: 6's model and optimizer at full width
    and depth 2 (attention with dropout is the plain attention, in the JAX
    package as in the port: the flash kernels have no dropout). Run A
    takes 1 step, saves it through ``CheckpointManager`` and takes 2 more;
    run B, from other weights, restores the save and takes the same 2
    steps bitwise; the save restored under another seed must draw other
    masks. Then the port's ``Dropout`` against ``torch.nn.Dropout`` on a
    block's output, [16, 2048, 2048] bf16, by CUDA events."""
    import math
    import tempfile

    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed.fleet import make_sharded_train_step
    from paddle_tpu_torch.models.gpt import GPT3_1p3B, GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn import Dropout
    from paddle_tpu_torch.optimizer import AdamW

    t_phase = time.perf_counter()
    cfg = GPTConfig(**{**GPT3_1p3B, "num_layers": 2}, dropout=0.1,
                    use_recompute=True, recompute_interval=1, loss_chunk=128)
    B, S, k, n = 16, 2048, 1, 2
    g = torch.Generator(device="cuda").manual_seed(seed + 16)
    xs = torch.randint(0, cfg.vocab_size, (k + n, B, S), generator=g,
                       device="cuda")

    def build(init_seed):
        model = GPTForCausalLM(
            cfg, device="cuda", dtype=torch.bfloat16,
            generator=torch.Generator(device="cuda").manual_seed(init_seed))
        model.train()
        opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                    multi_precision=True, moment_dtype="bfloat16")
        return make_sharded_train_step(model, opt, seed=seed)

    def train(step, batches):
        losses, times = [], []
        for x in batches:
            t0 = time.perf_counter()
            losses.append(float(step(x, torch.roll(x, -1, dims=1))))
            times.append(time.perf_counter() - t0)
        return losses, times

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_dropout_",
                                 dir=CKPT_PARENT))
    try:
        step = build(seed)
        train(step, xs[:k])
        mgr = CheckpointManager(str(work), async_=False)
        mgr.save(step.step_index, step.state_for_checkpoint().to_tree())
        more_a, times_a = train(step, xs[k:])
        want = {name: (v.clone() if isinstance(v, torch.Tensor) else v)
                for name, v in state_tensors(step).items()}
        del step
        torch.cuda.empty_cache()
        step = build(seed + 1)
        step.restore_from_checkpoint(mgr.restore())
        losses_b, times_b = train(step, xs[k:])
        got = state_tensors(step)
        differ = [name for name, v in want.items()
                  if not (torch.equal(v, got[name])
                          if isinstance(v, torch.Tensor)
                          else np.asarray(v).tobytes()
                          == np.asarray(got[name]).tobytes())]
        n_state = len(want)
        tree = mgr.restore()
        tree["rng"]["seed"] = seed + 1
        step.restore_from_checkpoint(tree)
        other, _ = train(step, xs[k:k + 1])
        mgr.close()
        del step, want, got, tree
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    x = torch.randn(B, S, cfg.hidden_size, device="cuda",
                    dtype=torch.bfloat16)
    port, lib = Dropout(0.1), torch.nn.Dropout(0.1)
    port_ms, lib_ms = timed_ms(lambda: port(x), 20), timed_ms(
        lambda: lib(x), 20)
    smi = nvidia_smi_line()
    print(f"[15] dropout 0.1, depth 2 ({smi}): run A {k} step, a save, "
          f"{n} steps {' '.join(f'{t * 1e3:.1f}' for t in times_a)} ms; run "
          f"B restored into other weights, {n} steps "
          f"{' '.join(f'{t * 1e3:.1f}' for t in times_b)} ms", flush=True)
    print(f"    losses run A {more_a}, run B {losses_b}; tensors that "
          f"differ: {len(differ)} of {n_state}; the save restored under seed "
          f"{seed + 1}: first loss {other[0]}", flush=True)
    print(f"    port Dropout(0.1) {port_ms:.4f} ms, torch.nn.Dropout(0.1) "
          f"{lib_ms:.4f} ms on [{B}, {S}, {cfg.hidden_size}] bf16, CUDA "
          f"events ({smi}); took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    check(all(math.isfinite(v) for v in more_a + losses_b + other),
          "[15] dropout: a loss is not finite")
    check(losses_b == more_a, f"[15] dropout: run B's losses {losses_b} "
          f"are not run A's {more_a}")
    check(not differ, f"[15] dropout: run B's state differs from run A's "
          f"in {differ[:6]}")
    check(other[0] != more_a[0], f"[15] dropout: seed {seed + 1} drew "
          f"seed {seed}'s masks")


# --------------------------------------------------------------- phase 16
# BASELINE config 5 (bench.py:650-655, its TPU branch): GPT-MoE, 8 experts
# in every 2nd block, top-2 GShard, capacity factor 1.25, aux weight 0.01
MOE5 = dict(vocab_size=32768, hidden_size=1024, num_layers=8, num_heads=16,
            max_seq_len=1024, dropout=0.0, moe_num_experts=8, moe_every_k=2,
            use_recompute=True, recompute_interval=1)
# the profiled step's device time by group: the port's kernels by their
# symbols; then the kernels of the MoE FFN's ranges (chip_smoke wraps
# moe_route and GPTMoEMLP._experts in them for the profiled step; a
# backward kernel takes the range of the forward op that made its
# autograd node); the rest is the remainder of the busy time
MOE_KERNEL_GROUPS = (("flash", ("flash_",)),
                     ("LayerNorm", tuple(NORM_SYMBOLS.values())),
                     ("AdamW", ("fused_adamw",)))
MOE_GROUPS = [g for g, _ in MOE_KERNEL_GROUPS] + [
    "experts: products", "experts: bias, GELU", "routing", "the rest"]


def moe_parts(model):
    """(dense blocks, MoE blocks, the MoE FFNs by block index)."""
    from paddle_tpu_torch.models.gpt import GPTMoEMLP

    mlps = {i: b.mlp for i, b in enumerate(model.gpt.layers)
            if isinstance(b.mlp, GPTMoEMLP)}
    return len(model.gpt.layers) - len(mlps), len(mlps), mlps


def moe_active_flops(model, B, S):
    """bench.py:672-683's count: activated parameters (an expert stack
    counts top_k / E of its size) and (6 N_active + 12 L H S) B S FLOP."""
    cfg = model.cfg
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    n_active = sum(p.numel() * k // E
                   if ".mlp.w" in name or ".mlp.b" in name else p.numel()
                   for name, p in model.named_parameters())
    return n_active, (6 * n_active + 12 * cfg.num_layers * cfg.hidden_size
                      * S) * B * S


class MoEInputs:
    """Keeps each MoE FFN's input of the forwards run inside the ``with``
    (forward hooks; the last forward's wins)."""

    def __init__(self, model):
        self.mlps = moe_parts(model)[2]
        self.seen = {}

    def __enter__(self):
        self.hooks = [m.register_forward_hook(
            lambda mod, args, out, i=i: self.seen.__setitem__(
                i, args[0].detach())) for i, m in self.mlps.items()]
        return self

    def __exit__(self, *exc):
        for h in self.hooks:
            h.remove()

    def routing(self):
        """{block: (slots, fp32 logits, dropped share)}: each MoE FFN's
        last input routed again as ``moe_route`` routes it."""
        from paddle_tpu_torch.incubate.distributed.models.moe.gate import \
            _route

        out = {}
        for i, x in sorted(self.seen.items()):
            mlp, cfg = self.mlps[i], self.mlps[i].cfg
            xt = x.reshape(-1, x.shape[-1])
            E = cfg.moe_num_experts
            C = max(1, int(cfg.moe_capacity_factor * xt.shape[0] / E))
            with torch.no_grad():
                logits = xt @ mlp.gate_weight
                slots = _route(logits, C, cfg.moe_top_k)[0]
            out[i] = (slots, logits.float(),
                      (slots == E * C).float().mean().item())
        return out


def scoped(fn, label):
    """``fn`` inside a profiler range named ``label``."""
    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with record_function(label):
            return fn(*args, **kwargs)
    return wrapper


def moe_breakdown(step_fn):
    """Device ms of one call of ``step_fn`` by ``MOE_GROUPS``, each
    range's and the rest's kernels by name, the busy total and the number
    of kernels. A kernel's launching op and its
    enclosing ranges come from the profiler's event tree; a backward op
    (``autograd::engine::evaluate_function``) takes the range of the
    forward op with its (thread, sequence number)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.incubate.distributed.models.moe import moe_layer
    from paddle_tpu_torch.models import gpt as gpt_mod

    saved = moe_layer.moe_route, gpt_mod.GPTMoEMLP._experts
    moe_layer.moe_route = scoped(saved[0], "moe::routing")
    gpt_mod.GPTMoEMLP._experts = scoped(saved[1], "moe::experts")
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step_fn()
            torch.cuda.synchronize()
    finally:
        moe_layer.moe_route, gpt_mod.GPTMoEMLP._experts = saved
    events = prof.events()

    def scope_of(e):
        while e is not None:
            if e.name.startswith("moe::"):
                return e.name
            e = e.cpu_parent
        return None

    fwd = {}
    for e in events:
        s = scope_of(e)
        if s is not None and e.sequence_nr >= 0:
            fwd.setdefault((e.thread, e.sequence_nr), s)

    def backward_scope(e):
        while e is not None:
            if e.name.startswith("autograd::engine::evaluate_function"):
                return fwd.get((e.fwd_thread, e.sequence_nr))
            e = e.cpu_parent
        return None

    def by_symbol(name):
        return next((g for g, syms in MOE_KERNEL_GROUPS
                     if any(sym in name for sym in syms)), None)

    ms, rest, busy, n = {g: 0.0 for g in MOE_GROUPS}, {}, 0.0, 0
    for e in events:  # every kernel, linked to an op or not (ctypes);
        # not the ranges' own spans on the device timeline
        if e.device_type == DeviceType.CUDA and not e.name.startswith("moe::") \
                and not getattr(e, "is_user_annotation", False):
            t = (e.time_range.end - e.time_range.start) * 1e-3
            busy, n = busy + t, n + 1
            if by_symbol(e.name):
                ms[by_symbol(e.name)] += t
    for e in events:  # the kernels each op launched
        for kern in e.kernels:
            if by_symbol(kern.name):
                continue
            scope = scope_of(e) or backward_scope(e)
            group = ("routing" if scope == "moe::routing" else
                     None if scope != "moe::experts" else
                     "experts: products" if e.name == "aten::bmm" else
                     "experts: bias, GELU")
            t = kern.duration * 1e-3
            if group:
                ms[group] += t
            names = rest.setdefault(group or "the rest", {})
            names[kern.name] = names.get(kern.name, 0.0) + t
    ms["the rest"] = busy - sum(ms.values())
    return ms, {g: sorted(k.items(), key=lambda kv: -kv[1])
                for g, k in rest.items()}, busy, n


def moe_snapshot(step):
    """A deep copy of the train step's state (``TrainState``)."""
    ts = step.state_for_checkpoint()
    ts.params = {k: v.detach().clone() for k, v in ts.params.items()}
    ts.opt_state = {n: {k: v.clone() if torch.is_tensor(v) else v
                        for k, v in s.items()}
                    for n, s in ts.opt_state.items()}
    return ts


def moe_train_slice(K, seed: int, rows):
    """[16]: BASELINE config 5 at full width on the card (see the module
    docstring); fills the training kernels' MoE launch counts into
    ``rows``."""
    import math

    from paddle_tpu_torch.distributed.fleet import make_sharded_train_step
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    smi = nvidia_smi_line()
    cfg = GPTConfig(**MOE5)
    B, S, timed = 8, 1024, 5
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    model = GPTForCausalLM(
        cfg, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(seed + 16))
    model.train()
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                moment_dtype="bfloat16")
    step = make_sharded_train_step(model, opt)
    n = sum(p.numel() for p in model.parameters())
    n_tensors = sum(1 for _ in model.parameters())
    n_active, flops = moe_active_flops(model, B, S)
    L_dense, L_moe, mlps = moe_parts(model)
    E = cfg.moe_num_experts
    C = max(1, int(cfg.moe_capacity_factor * B * S / E))
    g = torch.Generator(device="cuda").manual_seed(seed + 17)
    x = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device="cuda")
    y = torch.roll(x, -1, dims=1)
    print(f"[16] GPT-MoE, BASELINE config 5 ({n / 1e6:.1f} M params in "
          f"{n_tensors} tensors, {n_active / 1e6:.1f} M active per token; "
          f"{cfg.num_layers} layers, {L_moe} with {E} experts, top-2 GShard, "
          f"capacity {C} of {B * S} tokens; bf16, bf16 moments, no master "
          f"weights, recompute every dense block), batch {B} x {S} ({smi})",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with MoEInputs(model) as seen:
        losses = [step(x, y)]
    torch.cuda.synchronize()
    routed = seen.routing()
    aux = float(model.gpt.moe_aux_loss.detach())
    print(f"    warm-up step {time.perf_counter() - t0:.2f} s; aux loss "
          f"(sum over {L_moe} MoE blocks) {aux:.4f}; choices dropped at "
          f"capacity by block: "
          f"{ {i: round(d, 4) for i, (_, _, d) in routed.items()} } ({smi})",
          flush=True)
    # the host launches ~1200 kernels a step: a full collection first, so
    # no earlier phase's garbage is traversed inside the timed steps
    t0 = time.perf_counter()
    gc.collect()
    gc_ms = (time.perf_counter() - t0) * 1e3
    K.reset_launch_counts()

    def timed_steps():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed):
            losses.append(step(x, y))
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / timed

    copies0 = getattr(opt, "master_copies", None)
    clock = HostClock(opt, "apply_gradients")
    step_s = timed_steps()
    clock.close()
    counts = K.launch_counts()
    copies = None if copies0 is None else opt.master_copies - copies0
    routes = check_flash_routes(K, "wgmma", "[16]")
    peak = torch.cuda.max_memory_allocated()
    ms, rest, busy, n_kernels = moe_breakdown(
        lambda: losses.append(step(x, y)))
    # the same steps once the profiler has run in this process (its
    # callbacks may stay subscribed and cost every launch)
    after_s = timed_steps()
    tokens = B * S
    print(f"    step {step_s * 1e3:.1f} ms host clock over {timed} steps = "
          f"{tokens / step_s:.1f} tokens/s; MFU {flops / step_s / PEAK_BF16:.4f}"
          f" ({flops:.4e} FLOP/step by bench.py's activated-parameter count, "
          f"recompute not counted, vs 989 TFLOP/s); max memory allocated "
          f"{peak / 2**30:.2f} GiB ({smi}); {len(gc.get_objects())} "
          f"objects tracked by gc, a full collection before the timed "
          f"steps {gc_ms:.1f} ms", flush=True)
    print(f"    profiled step: {n_kernels} kernels, device busy "
          f"{busy:.1f} ms, idle share {1 - busy / (step_s * 1e3):.4f} "
          f"(against the timed steps' mean); "
          f"by group (ms): { {k: round(v, 2) for k, v in ms.items()} } "
          f"({smi})", flush=True)
    for group, n in (("routing", 6), ("the rest", 8)):
        for name, t in rest.get(group, [])[:n]:
            print(f"     {group}: {t:8.3f} ms  {name[:90]}", flush=True)
    print(f"    {timed} more steps after the profiled one: "
          f"{after_s * 1e3:.1f} ms a step ({smi})", flush=True)
    losses = [float(v) for v in losses]
    print(f"    losses {' '.join(f'{v:.4f}' for v in losses)} (ln V = "
          f"{math.log(cfg.vocab_size):.4f}); kernel launches over the "
          f"{timed} timed steps: {counts}; flash kernels by route: {routes}",
          flush=True)
    # recompute replays each dense block's forward (flash and its two
    # LayerNorms twice); MoE blocks run outside recompute; AdamW: one
    # launch for the one dtype combination (all bf16), or one per tensor
    # in a tree without the grouped launch
    adamw = adamw_wrapper(K)
    want = {"flash_attention_fwd": 2 * L_dense + L_moe,
            "flash_attention_bwd_dq": L_dense + L_moe,
            "flash_attention_bwd_dkv": L_dense + L_moe,
            "fused_layer_norm": 4 * L_dense + 2 * L_moe + 1,
            "layer_norm_bwd": 2 * (L_dense + L_moe) + 1,
            adamw: 1 if adamw == "fused_adamw_multi" else n_tensors}
    got = {k: counts[k] / timed for k in want}
    print(f"    launches per step {got}, as the code gives {want}; master "
          f"weights copied {copies} (none kept); apply_gradients "
          f"{clock.seconds / timed * 1e3:.2f} ms host clock a step over the "
          f"{timed} timed steps; the AdamW group {ms['AdamW']:.3f} ms of "
          f"device time in the profiled step ({smi})", flush=True)
    check(got == want and copies in (None, 0),
          f"[16]: launches per step {got}, not {want}; copies {copies}")
    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")
    check(losses[-1] < losses[0], f"[16]: the loss did not fall: {losses}")
    check(all(v > 0 for v in ms.values()),
          f"[16]: a group of the breakdown saw no device time: {ms}")
    print(f"    digest of the {len(losses)} losses, the parameters and the "
          f"AdamW state after them: {state_digest(losses, state_tensors(step))}",
          flush=True)
    for name, kname in zip(TRAINING_KERNELS, training_kernels(K)):
        rows[name]["launches_moe_train"] = counts[kname]
    rows["fused_adamw_multi"].update(
        moe_apply_gradients_host_ms=clock.seconds / timed * 1e3,
        moe_device_ms=ms["AdamW"])
    # two steps from one state, bit for bit (no atomics in the route's sums)
    snap = moe_snapshot(step)
    la = step(x, y)
    after = {k: v.detach().clone() for k, v in model.named_parameters()}
    step.restore_from_checkpoint(snap)
    lb = step(x, y)
    same = torch.equal(la, lb) and all(
        torch.equal(after[k], v) for k, v in model.named_parameters())
    print(f"    two steps from one state: losses {float(la):.6f} / "
          f"{float(lb):.6f}, every parameter bitwise equal: {same}",
          flush=True)
    check(same, "[16]: two steps from the same state differ")
    del model, opt, step, snap, after, seen
    torch.cuda.empty_cache()
    print(f"    phase 16 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return step_s


def route_ties(card, cpu, what):
    """Holds the first forward's routing on the card to the CPU's, block
    by block: slots equal, or every token whose expert choice differs a
    tie within twice the two sides' largest logit difference (its two
    experts' gate logits that close), reported as [13] reports its."""
    for i in sorted(cpu):
        s_g, lg, d_g = card[i]
        s_c, lc, d_c = cpu[i]
        err = max_err(lg.cpu(), lc)
        same = torch.equal(s_g.cpu(), s_c)
        pick = [torch.topk(t.cpu(), 2, dim=-1).indices for t in (lg, lc)]
        diff = (pick[0] != pick[1]).any(dim=-1).nonzero()[:, 0].tolist()
        # at each differing rank, the gap between the two sides' experts
        gaps = [max(abs(lc[t, pick[0][t, j]] - lc[t, pick[1][t, j]]).item()
                    for j in range(2) if pick[0][t, j] != pick[1][t, j])
                for t in diff]
        print(f"    {what} block {i}: slots equal {same}; dropped "
              f"{d_g:.4f} / {d_c:.4f}; gate logits max_abs_err {err:.3e}; "
              f"tokens whose choice differs {diff[:8]} (gaps "
              f"{[round(v, 7) for v in gaps[:8]]})", flush=True)
        check(same or (diff and all(v <= 2 * err for v in gaps)),
              f"{what}: block {i}'s routing differs beyond a tie")


def moe_train_vs_plain(K, seed: int):
    """[16], depth 2 (one dense block, one MoE block) in fp32 at full
    width: 3 AdamW steps on the card (kernels; flash on the CUDA cores)
    and on the CPU (plain versions) from the same weights and batches."""
    from paddle_tpu_torch.distributed.fleet import make_sharded_train_step
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    t0 = time.perf_counter()
    cfg = GPTConfig(**{**MOE5, "num_layers": 2})
    cpu = GPTForCausalLM(cfg, device="cpu", dtype=torch.float32,
                         generator=torch.Generator().manual_seed(seed + 16))
    gpu = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32)
    gpu.load_state_dict(cpu.state_dict())
    p0 = {k: p.detach().clone() for k, p in cpu.named_parameters()}
    lr = 1e-3
    steps = {}
    for side, dev, m in (("card", "cuda", gpu), ("cpu", "cpu", cpu)):
        m.train()
        steps[side] = make_sharded_train_step(
            m, AdamW(learning_rate=lr, parameters=m.named_parameters()),
            device=dev)
    rng = torch.Generator().manual_seed(seed + 18)
    K.reset_launch_counts()
    for i in range(3):
        x = torch.randint(0, cfg.vocab_size, (2, 256), generator=rng)
        y = torch.roll(x, -1, dims=1)
        with MoEInputs(gpu) as hg, MoEInputs(cpu) as hc:
            lg = float(steps["card"](x, y))
            lc = float(steps["cpu"](x, y))
        print(f"[16] depth-2 fp32 step {i + 1}: loss card {lg:.6f} CPU "
              f"{lc:.6f} (|diff| {abs(lg - lc):.2e}, tol 1e-4)", flush=True)
        if i == 0:
            route_ties(hg.routing(), hc.routing(), "[16] depth 2")
        check(abs(lg - lc) <= 1e-4, f"step {i + 1} losses differ: {lg} {lc}")
        if i == 0:
            missing = [k for k, p in gpu.named_parameters() if p.grad is None]
            check(not missing, f"parameters without a gradient on the card: "
                  f"{missing}")
            errs = {k: max_err(p.grad.cpu(), q.grad)
                    / max(q.grad.abs().max().item(), 1e-30)
                    for (k, p), q in zip(gpu.named_parameters(),
                                         cpu.parameters())}
            worst = max((v, k) for k, v in errs.items())
            moe = {k.split(".mlp.")[1]: f"{v:.1e}" for k, v in errs.items()
                   if ".mlp." in k and "fc" not in k}
            print(f"    step 1 gradients: max|diff| / max|grad| worst "
                  f"{worst[0]:.2e} ({worst[1]}), the MoE FFN's {moe} (tol "
                  f"1e-3)", flush=True)
            check(worst[0] <= 1e-3, f"gradients differ: {worst}")
    counts = K.launch_counts()
    check(all(counts[k] > 0 for k in TRAINING_KERNELS),
          f"kernels not used on the card: {counts}")
    check_flash_routes(K, "cuda_cores", "[16] depth 2")
    compare_updates(cfg, p0, gpu, cpu, 3, lr)
    print(f"    phase 16 depth 2 took {time.perf_counter() - t0:.1f} s",
          flush=True)


# --------------------------------------------------------------- phase 17
def moe_serve_slice(K, seed: int, rows):
    """[17]: [16]'s model (bf16, 8 layers) behind ``generate`` and the
    paged ``Engine`` (see the module docstring)."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    smi = nvidia_smi_line()
    t_phase = time.perf_counter()
    cfg = GPTConfig(**MOE5)
    model = GPTForCausalLM(
        cfg, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(seed + 16))
    model.eval()
    L, new = cfg.num_layers, 64
    rng = torch.Generator().manual_seed(seed + 19)
    # generate: 8 prompts of 512 tokens, 64 new greedy tokens
    ids = torch.randint(0, cfg.vocab_size, (8, 512), generator=rng).cuda()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    out = model.generate(ids, max_new_tokens=new)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    state = model._generate_state
    t0 = time.perf_counter()
    again = model.generate(ids, max_new_tokens=new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    caps = (state.prefill.captures, state.decode.captures)
    print(f"[17] GPT-MoE (config 5's model, bf16) generate, 8 prompts x 512, "
          f"{new} new greedy: first call (captures) {first_s:.3f} s, second "
          f"(replays) {wall:.3f} s = {8 * new / wall:.1f} tokens/s; captures "
          f"prefill/decode {caps}; wrapper launches (the captures) {counts} "
          f"({smi})", flush=True)
    check(out.shape == (8, 512 + new) and torch.equal(out, again)
          and caps == (1, 1) and model._generate_state is state,
          f"[17]: generate {tuple(out.shape)}, replay equal "
          f"{torch.equal(out, again)}, captures {caps}")
    check(counts["fused_layer_norm"] > 0 and counts["flash_attention_fwd"] > 0,
          f"[17]: generate never launched a kernel of its path: {counts}")
    check_flash_routes(K, "wgmma", "[17] generate")
    for name in ("fused_layer_norm", "flash_attention_fwd"):
        rows[name]["launches_moe_generate"] = counts[name]
    model._generate_state = None
    torch.cuda.empty_cache()
    # the paged engine: [4]'s request shape
    eng = Engine(model, EngineConfig(max_batch_size=8, max_seq_len=1024,
                                     page_size=16), device="cuda")
    lengths = [128 if i % 2 == 0 else
               int(torch.randint(300, 701, (1,), generator=rng))
               for i in range(16)]
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in lengths]
    sp = SamplingParams(max_new_tokens=32)
    # one warm-up request per prefill bucket captures its program (the
    # first also the decode step)
    warm = {eng._bucket(len(p)): p for p in prompts}
    buckets = sorted(warm)
    K.reset_launch_counts()
    eng.generate([warm[T] for T in buckets], SamplingParams(max_new_tokens=4))

    def serve():
        reqs = [eng.add_request(p, sp) for p in prompts]
        while eng.has_unfinished:
            eng.step()
        torch.cuda.synchronize()
        return reqs

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = serve()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    outs = [r.output_ids for r in reqs]
    n_tok = sum(len(o) for o in outs)
    ttft, tpot = request_latencies(reqs)
    captures = {name: st.captures for name, st in eng.steps.items()}
    print(f"    paged Engine (8 slots, S_max 1024, page 16), 16 requests "
          f"(prompts {lengths}): {n_tok} tokens in {wall:.3f} s = "
          f"{n_tok / wall:.1f} tokens/s; TTFT p50 {ttft:.1f} ms, TPOT p50 "
          f"{tpot:.2f} ms; captures per program {captures} ({smi})",
          flush=True)
    check(all(len(o) == 32 for o in outs) and set(captures)
          == {"decode", *(f"prefill:{T}" for T in buckets)}
          and set(captures.values()) == {1}, f"[17]: captures {captures}")
    check(all(counts[k] > 0 for k in SERVING_KERNELS),
          f"[17]: a kernel of the path was never launched: {counts}")
    check_flash_routes(K, "wgmma", "[17] paged engine")
    for name in SERVING_KERNELS:
        rows[name]["launches_moe_serve"] = counts[name]
    # what a replay runs on the card, by the profiler (no request is live:
    # the replays write only free pages)
    syms = (NORM_SYMBOLS["fwd"], FWD_SYMBOL, *PAGED_SYMBOLS.values())
    checks = {"decode": (4, {NORM_SYMBOLS["fwd"]: 2 * L + 1,
                             **{s: L for s in PAGED_SYMBOLS.values()}}),
              f"prefill:{buckets[0]}": (1, {NORM_SYMBOLS["fwd"]: 2 * L + 1,
                                            FWD_SYMBOL: L})}
    for name, (n, each) in checks.items():
        st = eng.steps[name]
        w, busy, _ = replay_clock(st, n)
        print(f"    {name} alone (graph replay): {w:.2f} ms host clock, "
              f"device busy {busy:.2f} ms ({smi})", flush=True)
        want = {s: n * each.get(s, 0) for s in syms}
        got = replay_launches(lambda: [st.replay() for _ in range(n)], syms,
                              want, f"[17]: {name} replays")
        print(f"    {name}: {n} replay(s) launched on the card (profiler) "
              f"{got}", flush=True)
    # the decode step's dropped share (its T is the 8 slots, so C = 1),
    # from its eager call on the same buffers, every slot live
    for p in prompts[:8]:
        eng.add_request(p, SamplingParams(max_new_tokens=8))
    for _ in range(3):
        eng.step()
    with MoEInputs(model) as seen:
        eng.steps["decode"].fn()
    torch.cuda.synchronize()
    dropped = {i: round(d, 4) for i, (_, _, d) in seen.routing().items()}
    print(f"    the decode step (T 8, capacity 1): choices dropped by MoE "
          f"block {dropped} ({smi})", flush=True)
    while eng.has_unfinished:
        eng.step()
    del eng, model
    torch.cuda.empty_cache()
    print(f"    phase 17 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def moe_serve_vs_plain(K, seed: int):
    """[17] at depth 2 in fp32, full width: ``generate`` and the paged
    engine on the card and on the CPU from the same weights; tokens must
    be equal."""
    from paddle_tpu_torch.models.gpt import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    t0 = time.perf_counter()
    cfg = GPTConfig(**{**MOE5, "num_layers": 2})
    cpu = GPTForCausalLM(cfg, device="cpu", dtype=torch.float32,
                         generator=torch.Generator().manual_seed(seed + 17))
    gpu = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32)
    gpu.load_state_dict(cpu.state_dict())
    cpu.eval()
    gpu.eval()
    rng = torch.Generator().manual_seed(seed + 20)
    ids = torch.randint(0, cfg.vocab_size, (4, 64), generator=rng)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=rng).tolist()
               for n in (17, 100, 45, 70)]
    sp = SamplingParams(max_new_tokens=8)
    small = dict(max_batch_size=2, max_seq_len=1024, page_size=16)
    K.reset_launch_counts()
    got = {}
    for side, dev, m in (("card", "cuda", gpu), ("cpu", "cpu", cpu)):
        got[side] = (m.generate(ids.to(dev), max_new_tokens=8).cpu(),
                     Engine(m, EngineConfig(**small),
                            device=dev).generate(prompts, sp))
    counts = K.launch_counts()
    print(f"[17] depth-2 fp32: generate card {got['card'][0][:, 64:].tolist()}"
          f"\n                     CPU  {got['cpu'][0][:, 64:].tolist()}\n"
          f"    paged engine card {got['card'][1]}\n"
          f"                 CPU  {got['cpu'][1]}", flush=True)
    check(torch.equal(got["card"][0], got["cpu"][0])
          and got["card"][1] == got["cpu"][1],
          "[17]: greedy tokens differ between the card and the CPU")
    check(all(counts[k] > 0 for k in SERVING_KERNELS),
          f"[17] depth 2: kernels not used: {counts}")
    check_flash_routes(K, "cuda_cores", "[17] depth 2")
    del cpu, gpu
    torch.cuda.empty_cache()
    print(f"    phase 17 depth 2 took {time.perf_counter() - t0:.1f} s",
          flush=True)


# --------------------------------------------------------------- phase 18
# [18b]'s two ranks: GPT-3 1.3B's width at depth 2 in fp32, half of a
# 4 x 512 batch each, 3 AdamW steps (epsilon 1e-6, as [9]); the CPU tests'
# trajectory tolerances against one process on the whole batch
DP_B, DP_S, DP_STEPS, DP_LR = 4, 512, 3, 1e-4
DP_LOSS_TOL, DP_PARAM_TOL = 1e-5, 3e-5


def dp_env(**values):
    """Set (a value) or clear (None) the launcher's variables in this
    process's environment; returns the previous values."""
    import os

    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    return old


def dp_nccl_slice(K, seed: int, rows, step6_s):
    """[18a]: [6]'s model and optimizer through ``fleet.init`` and
    ``make_sharded_train_step(mesh=)`` over an NCCL group of one rank
    (file-store master): two steps bitwise equal to the step without a
    mesh, then the step's time and kernel launches against [6]'s, and the
    gradients' all-reduce alone."""
    import tempfile

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import make_sharded_train_step

    t_phase = time.perf_counter()
    smi = f"{nvidia_smi_line()}, {torch.cuda.device_count()} card(s)"
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_dp_", dir=CKPT_PARENT))
    old = dp_env(PADDLE_MASTER=f"file://{work / 'store'}",
                 PADDLE_TRAINERS_NUM="1", PADDLE_TRAINER_ID="0",
                 PADDLE_DISTRI_BACKEND=None, MASTER_ADDR=None)
    try:
        cfg, model, opt, x, y = train_model(seed)
        step = make_sharded_train_step(model, opt)
        want = [step(x, y) for _ in range(2)]
        ref = {k: p.detach().clone() for k, p in model.named_parameters()}
        del model, opt, step
        torch.cuda.empty_cache()
        cfg, model, opt, x, y = train_model(seed)
        st = fleet.DistributedStrategy()
        st.hybrid_configs = {"dp_degree": 1}
        fleet.init(is_collective=True, strategy=st)
        hcg = fleet.get_hybrid_communicate_group()
        step = make_sharded_train_step(
            fleet.distributed_model(model), fleet.distributed_optimizer(opt),
            mesh=hcg.get_mesh())
        group = hcg.get_data_parallel_group()
        print(f"[18a] GPT-3 1.3B ([6]'s model, optimizer and batch "
              f"{x.shape[0]} x {x.shape[1]}) over fleet.init's dp mesh "
              f"{hcg.get_mesh().shape}: backend {dist.get_backend()}, dp "
              f"group ranks {group.ranks} ({smi})", flush=True)
        check(dist.get_backend() == "NCCL" and group.process_group is not None,
              f"[18a]: not an NCCL group: {dist.get_backend()}")
        got = [step(x, y) for _ in range(2)]
        same_loss = all(torch.equal(a, b) for a, b in zip(want, got))
        diff = [k for k, p in model.named_parameters()
                if not torch.equal(ref[k], p)]
        print(f"    two steps: losses {[float(v) for v in got]} against "
              f"{[float(v) for v in want]} without a mesh, bitwise "
              f"{same_loss}; parameters differing: {len(diff)} of "
              f"{len(ref)}", flush=True)
        check(same_loss and not diff, f"[18a]: the world-1 NCCL steps differ "
              f"from the no-mesh steps: losses {same_loss}, {diff[:4]}")
        del ref
        timed, L = 3, cfg.num_layers
        K.reset_launch_counts()
        copies0 = opt.master_copies
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed):
            step(x, y)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / timed
        counts = K.launch_counts()
        check_flash_routes(K, "wgmma", "[18a]")
        kernels = profile_launches(lambda: step(x, y))
        nccl = [(name[:60], f"{t * 1e3:.3f} ms", n)
                for name, t, n in kernels if "nccl" in name.lower()]
        bufs = step._grads
        reduce_ms = timed_ms(bufs.reduce, 5)
        t0 = time.perf_counter()
        for _ in range(5):
            bufs.reduce()
        torch.cuda.synchronize()
        reduce_host_ms = (time.perf_counter() - t0) / 5 * 1e3
        reduce_kernels = [(name[:60], f"{t * 1e3:.3f} ms", n) for name, t, n
                          in profile_launches(bufs.reduce)[:4]]
        one = torch.zeros((), device="cuda")
        calls = 200
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            dist.all_reduce(one, group=group)
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) / calls * 1e3
        print(f"    step {step_s * 1e3:.1f} ms host clock over {timed} steps "
              f"([6]: {step6_s * 1e3:.1f} ms); launches per step "
              f"{ {k: v / timed for k, v in counts.items() if v} } ({smi})",
              flush=True)
        print(f"    the profiled step's NCCL kernels: "
              f"{nccl or 'none'}"
              f" (an in-place SUM over one rank may launch none); the "
              f"gradients' all-reduce alone: {bufs.nbytes / 1e9:.3f} GB "
              f"of {bufs.buffers[0].dtype} in {len(bufs.params)} views of "
              f"{len(bufs.buffers)} flat buffer(s), {len(bufs.buckets)} "
              f"bucket(s), {reduce_ms:.3f} ms by CUDA events, "
              f"{reduce_host_ms:.3f} ms host clock, its kernels "
              f"{reduce_kernels}; one all-reduce of one value "
              f"{call_ms:.4f} ms a call (host clock over {calls}) ({smi})",
              flush=True)
        check(counts["flash_attention_fwd"] == 2 * L * timed
              and counts["flash_attention_bwd_dq"] == L * timed
              and counts["flash_attention_bwd_dkv"] == L * timed
              and counts["fused_layer_norm"] == (4 * L + 1) * timed
              and counts["layer_norm_bwd"] == (2 * L + 1) * timed
              and counts["fused_adamw_multi"] == timed
              and opt.master_copies == copies0,
              f"[18a]: launches per step differ from [6]'s (one AdamW, no "
              f"master copy): {counts}, copies "
              f"{opt.master_copies - copies0}")
        for name in TRAINING_KERNELS:
            rows[name]["launches_dp"] = counts[name]
        del model, opt, step, bufs
    finally:
        dist.destroy_process_group()
        dp_env(**old)
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    print(f"    phase 18a took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def dp_model(seed: int):
    """[18b]'s model on the card from the seed, its AdamW and batches."""
    from paddle_tpu_torch.models.gpt import (GPT3_1p3B, GPTConfig,
                                             GPTForCausalLM)
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig(**{**GPT3_1p3B, "num_layers": 2}, dropout=0.0)
    model = GPTForCausalLM(
        cfg, device="cuda", dtype=torch.float32,
        generator=torch.Generator(device="cuda").manual_seed(seed))
    model.train()
    opt = AdamW(learning_rate=DP_LR, epsilon=1e-6, weight_decay=0.01,
                parameters=model.named_parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    g = torch.Generator(device="cuda").manual_seed(seed + 18)
    x = torch.randint(0, cfg.vocab_size, (DP_STEPS, DP_B, DP_S), generator=g,
                      device="cuda")
    return cfg, model, opt, x, torch.roll(x, -1, dims=2)


def dp_worker(directory: Path, seed: int) -> int:
    """One rank of [18b], started by the port's launcher: fleet.init at
    dp 2, this rank's half of each batch, the replicas compared after every
    step (rank 0's parameters broadcast to rank 1), an async save by both
    ranks, and rank 0's state for the one-process restore to match."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed import fleet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 2}
    fleet.init(is_collective=True, strategy=st)
    rank = fleet.worker_index()
    hcg = fleet.get_hybrid_communicate_group()
    cfg, model, opt, x, y = dp_model(seed)
    step = fleet.make_sharded_train_step(
        fleet.distributed_model(model), fleet.distributed_optimizer(opt),
        mesh=hcg.get_mesh())
    rows = slice(rank * DP_B // 2, (rank + 1) * DP_B // 2)
    rec = {"rank": rank, "backend": dist.get_backend(),
           "device": str(torch.cuda.current_device()),
           "on_cuda": all(p.is_cuda for p in model.parameters()),
           "losses": [], "step_s": [], "replicas_equal": []}
    K.reset_launch_counts()
    for k in range(DP_STEPS):
        t0 = time.perf_counter()
        rec["losses"].append(step(x[k, rows], y[k, rows]).item())
        rec["step_s"].append(time.perf_counter() - t0)
        same = torch.ones((), device="cuda")
        for p in model.parameters():
            buf = p.detach().clone()
            dist.broadcast(buf, src=0)
            same *= float(torch.equal(buf, p))
        dist.all_reduce(same, dist.ReduceOp.MIN)
        rec["replicas_equal"].append(bool(same))
    rec["launches"] = K.launch_counts()
    rec["flash_routes"] = {w: dict(getattr(K, w).route_launches)
                           for w in FLASH_WRAPPERS}
    t0 = time.perf_counter()
    mgr = CheckpointManager(directory / "ck")
    mgr.save(step.step_index, step.state_for_checkpoint().to_tree())
    rec["save_blocking_s"] = mgr.last_save["blocking_s"]
    mgr.wait_until_finished()
    mgr.close()
    rec["save_total_s"] = time.perf_counter() - t0
    if rank == 0:
        torch.save({k: v.detach().cpu() if torch.is_tensor(v)
                    else torch.as_tensor(np.asarray(v))
                    for k, v in state_tensors(step).items()},
                   directory / "rank0_state.pt")
    (directory / f"rank{rank}.json").write_text(json.dumps(rec))
    return 0


def dp_two_ranks(K, seed: int, rows):
    """[18b]: two ranks on the one card through the port's launcher over
    gloo; each rank's result and kernel launches, one process on the whole
    batch (whose launches each rank's must equal), and the one-process
    restore of the ranks' checkpoint. Returns the one process's losses and
    parameters (on the host), [19]'s reference too."""
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed.fleet import make_sharded_train_step

    t_phase = time.perf_counter()
    smi = f"{nvidia_smi_line()}, {torch.cuda.device_count()} card(s)"
    work = CHAINED["--dp-worker"]
    try:
        recs = chained_records(
            "--dp-worker",
            f"[18b] two ranks on one card (GPT-3 1.3B width, depth 2, fp32; "
            f"half of {DP_B} x {DP_S} each, {DP_STEPS} steps)")
        for rec in recs:
            print(f"    rank {rec['rank']}: {rec['backend']} on cuda:"
                  f"{rec['device']}, every parameter on cuda "
                  f"{rec['on_cuda']}; losses {rec['losses']}; step s "
                  f"{[round(t, 4) for t in rec['step_s']]} host clock "
                  f"(the first builds); replicas "
                  f"bitwise equal after each step {rec['replicas_equal']}; "
                  f"save blocking {rec['save_blocking_s']:.3f} s, total "
                  f"{rec['save_total_s']:.3f} s", flush=True)
            check(rec["backend"] == "GLOO" and rec["on_cuda"]
                  and all(rec["replicas_equal"])
                  and rec["losses"] == recs[0]["losses"],
                  f"[18b]: rank {rec['rank']}: {rec}")

        cfg, model, opt, x, y = dp_model(seed)
        step = make_sharded_train_step(model, opt)
        K.reset_launch_counts()
        one = [step(x[k], y[k]).item() for k in range(DP_STEPS)]
        one_counts = K.launch_counts()
        for rec in recs:
            routes = rec["flash_routes"]
            print(f"    rank {rec['rank']}'s launches over its {DP_STEPS} "
                  f"steps: { {k: v for k, v in rec['launches'].items() if v} }"
                  f", flash routes {routes}; one process on the whole "
                  f"batch: { {k: v for k, v in one_counts.items() if v} }",
                  flush=True)
            check(all(rec["launches"][k] == one_counts[k] > 0
                      for k in TRAINING_KERNELS)
                  and all(r["cuda_cores"] == sum(r.values())
                          == rec["launches"][w] for w, r in routes.items()),
                  f"[18b]: rank {rec['rank']}'s launches differ from one "
                  f"process's or left the fp32 flash route: "
                  f"{rec['launches']}, {routes}, {one_counts}")
        for name in TRAINING_KERNELS:
            rows[name]["launches_dp2"] = recs[0]["launches"][name]
        loss_err = max(abs(a - b) for a, b in zip(one, recs[0]["losses"]))
        t0 = time.perf_counter()
        restored = CheckpointManager(work / "ck").restore()
        restore_s = time.perf_counter() - t0
        rank0 = torch.load(work / "rank0_state.pt")
        flat = dict(restored["params"])
        for name, slots in restored["opt_state"].items():
            flat.update({f"{name}/{k}": v for k, v in slots.items()})
        differ = [k for k, v in rank0.items() if not (
            flat[k].dtype == v.dtype and torch.equal(flat[k], v))]
        k_part = slice(cfg.num_heads * cfg.head_dim,
                       (cfg.num_heads + cfg.num_kv_heads) * cfg.head_dim)
        worst, worst_k = 0.0, 0.0
        for name, p in model.named_parameters():
            d = (p.detach().cpu() - flat[name]).abs()
            if name.endswith("attn.qkv.bias"):
                worst_k = max(worst_k, float(d[k_part].max()))
                d[k_part] = 0
            worst = max(worst, float(d.max()))
        print(f"    one process on the whole batch: losses {one}, max |diff| "
              f"{loss_err:.3e} (tol {DP_LOSS_TOL:g}); parameters max |diff| "
              f"{worst:.3e} (tol {DP_PARAM_TOL:g}), the qkv biases' K third "
              f"{worst_k:.3e} (Adam's bound {2 * DP_STEPS * DP_LR:g})",
              flush=True)
        print(f"    one-process restore of the ranks' checkpoint "
              f"({restore_s:.2f} s): {len(rank0) - len(differ)} of "
              f"{len(rank0)} tensors bitwise equal to rank 0's state; "
              f"manifest parts left: "
              f"{len(list((work / 'ck').rglob('manifest.part*')))} ({smi})",
              flush=True)
        check(loss_err <= DP_LOSS_TOL and worst <= DP_PARAM_TOL
              and worst_k <= 2 * DP_STEPS * DP_LR,
              "[18b]: two ranks differ from one process beyond tolerance")
        check(not differ and int(restored["step"]) == DP_STEPS,
              f"[18b]: the restore differs from rank 0's state: {differ[:4]}")
        check(not list((work / "ck").rglob("manifest.part*")),
              "[18b]: manifest parts left behind")
        ref = {"losses": one, "params": {
            k: p.detach().cpu() for k, p in model.named_parameters()}}
        del model, opt, step, restored, rank0, flat
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    print(f"    phase 18b took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return ref


# --------------------------------------------------------------- phase 19
# [19a]'s main-path leg: GPT-3 1.3B at [6]'s configuration and optimizer,
# mp 2, batch 2 x 1024, one warm-up step and 2 timed ones
TP_B, TP_S, TP_TIMED = 2, 1024, 2
# [19a] (ii), [20a] (ii) and their one process run the 1.3B cut to
# MR_LAYERS of its 24 layers: with [22] the whole script passed 1050 s
# at 24 and read 1041.6 s at 12 (PR 18); [22c] keeps all 24
MR_LAYERS = 8


def rank_init(dims):
    """fleet.init over the launcher's world on this rank's card."""
    from paddle_tpu_torch.distributed import fleet

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    st = fleet.DistributedStrategy()
    st.hybrid_configs = dims
    fleet.init(is_collective=True, strategy=st)
    return fleet.get_hybrid_communicate_group()


def replicas_equal(step, group) -> bool:
    """Every parameter that is not this rank's block of an mp-split one
    (every parameter without mp), bitwise equal to the group's first
    rank's (each broadcast from it and compared)."""
    from paddle_tpu_torch import distributed as dist

    same = torch.ones((), device="cuda")
    for p in step.params.values():
        if step._mp.nranks > 1 and getattr(p, "is_distributed", False):
            continue
        buf = p.detach().clone()
        dist.broadcast(buf, src=group.ranks[0], group=group)
        same *= float(torch.equal(buf, p))
    dist.all_reduce(same, dist.ReduceOp.MIN, group=group)
    return bool(same)


def tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def opt_state_bytes(step) -> int:
    return tensor_bytes(v for s in step.optimizer.state.values()
                        for v in s.values())


def gathered_state(step):
    """The step's ``TrainState`` with every array whole: the blocks of
    ``state_for_checkpoint()`` gathered by the explicit
    ``resharding.gather_tree`` (collective: every rank calls it)."""
    from paddle_tpu_torch.distributed.resharding import gather_tree

    ts = step.state_for_checkpoint()
    ts.params = gather_tree(ts.params)
    ts.opt_state = gather_tree(ts.opt_state)
    return ts


def count_collectives():
    """Wrap ``mp_ops``' collectives: returns a dict whose ``calls`` and
    ``seconds`` (host clock inside them) grow with every call, and a
    function that puts them back."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_ops

    tally = {"calls": 0, "seconds": 0.0}
    saved = {n: getattr(mp_ops, n) for n in ("all_reduce", "gather_blocks")}

    def wrap(fn):
        def counted(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                tally["calls"] += 1
                tally["seconds"] += time.perf_counter() - t0
        return counted

    for n, fn in saved.items():
        setattr(mp_ops, n, wrap(fn))
    return tally, lambda: [setattr(mp_ops, n, fn) for n, fn in saved.items()]


def tp_worker(directory: Path, seed: int) -> int:
    """One rank of [19a], started by the port's launcher: mp 2 over gloo
    on the one card. (i) [18b]'s model (1.3B's width, depth 2, fp32) as
    this rank's blocks of the seed's whole model, 3 AdamW steps on the
    whole batch, the replicated parameters compared after every step,
    rank 0 keeping the gathered global parameters; (ii) the full 1.3B in
    bf16 with [6]'s optimizer and recompute at batch 2 x 1024: one warm-up
    step, 2 timed ones with every kernel's launches, the mp collectives'
    calls and host time, and this rank's peak memory and bytes."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.distributed import communication, fleet
    from paddle_tpu_torch.distributed.sharding_utils import local_block
    from paddle_tpu_torch.models.gpt import GPT3_1p3B, GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.weights import mp_layout

    cfg, whole, _, x, y = dp_model(seed)  # built before the mp group forms
    state = {k: v.detach() for k, v in whole.state_dict().items()}
    del whole
    hcg = rank_init({"mp_degree": 2})
    rank, mp_rank = fleet.worker_index(), hcg.get_model_parallel_rank()
    group = hcg.get_model_parallel_group()
    shapes = {k: tuple(v.shape) for k, v in state.items()}
    blocks = {}
    for k, v in state.items():
        lay = mp_layout(k, shapes)
        blocks[k] = v if lay is None else local_block(
            v, lay[0], mp_rank, 2, lay[1]).contiguous()
    del state
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32)
    model.load_state_dict(blocks)
    model.train()
    del blocks
    opt = AdamW(learning_rate=DP_LR, epsilon=1e-6, weight_decay=0.01,
                parameters=model.named_parameters(),
                grad_clip=ClipGradByGlobalNorm(1.0))
    step = fleet.make_sharded_train_step(
        fleet.distributed_model(model), fleet.distributed_optimizer(opt),
        mesh=hcg.get_mesh())
    rec = {"rank": rank, "mp_rank": mp_rank, "backend": dist.get_backend(),
           "losses": [], "replicas_equal": []}
    K.reset_launch_counts()
    for k in range(DP_STEPS):
        rec["losses"].append(step(x[k], y[k]).item())
        rec["replicas_equal"].append(replicas_equal(step, group))
    rec["parity_routes"] = {w: dict(getattr(K, w).route_launches)
                            for w in FLASH_WRAPPERS}
    tree = gathered_state(step)
    if rank == 0:
        torch.save({k: v.detach().cpu() for k, v in tree.params.items()},
                   directory / "tp_params.pt")
    del model, opt, step, tree
    torch.cuda.empty_cache()

    # (ii) the main path at full width
    tcfg = GPTConfig(**{**GPT3_1p3B, "num_layers": MR_LAYERS}, dropout=0.0,
                     use_recompute=True, recompute_interval=1,
                     loss_chunk=128)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = GPTForCausalLM(
        tcfg, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(seed))
    model.train()
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                multi_precision=True, moment_dtype="bfloat16")
    step = fleet.make_sharded_train_step(
        fleet.distributed_model(model), fleet.distributed_optimizer(opt),
        mesh=hcg.get_mesh())
    g = torch.Generator(device="cuda").manual_seed(seed + 19)
    xm = torch.randint(0, tcfg.vocab_size, (TP_B, TP_S), generator=g,
                       device="cuda")
    ym = torch.roll(xm, -1, dims=1)
    rec["warmup_loss"] = step(xm, ym).item()
    tally, restore = count_collectives()
    K.reset_launch_counts()
    copies0 = opt.master_copies
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(xm, ym) for _ in range(TP_TIMED)]
    torch.cuda.synchronize()
    rec["step_s"] = (time.perf_counter() - t0) / TP_TIMED
    rec["master_copies"] = opt.master_copies - copies0
    restore()
    rec["main_losses"] = [float(v) for v in losses]
    rec["launches"] = K.launch_counts()
    rec["flash_routes"] = {w: dict(getattr(K, w).route_launches)
                           for w in FLASH_WRAPPERS}
    rec["collectives_per_step"] = tally["calls"] / TP_TIMED
    rec["collective_s_per_step"] = tally["seconds"] / TP_TIMED
    rec["peak_bytes"] = torch.cuda.max_memory_allocated() - base
    rec["param_bytes"] = tensor_bytes(step.params.values())
    rec["grad_bytes"] = step._grads.nbytes if step._grads is not None \
        else tensor_bytes(p.grad for p in step.params.values())
    rec["opt_bytes"] = opt_state_bytes(step)
    rec["replicas_equal_main"] = replicas_equal(step, group)
    rec["staged"] = dict(communication.staged_ops)
    (directory / f"rank{rank}.json").write_text(json.dumps(rec))
    return 0


def zero_worker(directory: Path, seed: int) -> int:
    """One rank of [19b], started by the port's launcher: sharding 2 over
    gloo on the one card; for levels ``os`` and ``os_g``, [18b]'s model
    and this rank's half of each batch, 3 AdamW steps with the replicas
    compared after each, this rank's optimizer-state bytes, every kernel's
    launches, and rank 0's gathered global parameters; then an async save
    by both ranks of the ``os_g`` run, rank 0 keeping its global state."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed import communication, fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        group_sharded_parallel)

    hcg = rank_init({"sharding_degree": 2})
    rank = fleet.worker_index()
    group = hcg.get_sharding_parallel_group()
    rows = slice(rank * DP_B // 2, (rank + 1) * DP_B // 2)
    rec = {"rank": rank, "backend": dist.get_backend()}
    for level in ("os", "os_g"):
        cfg, model, opt, x, y = dp_model(seed)
        model, opt, _ = group_sharded_parallel(
            fleet.distributed_model(model), opt, level=level)
        step = fleet.make_sharded_train_step(
            model, fleet.distributed_optimizer(opt), mesh=hcg.get_mesh())
        r = {"losses": [], "replicas_equal": [], "step_s": []}
        K.reset_launch_counts()
        for k in range(DP_STEPS):
            t0 = time.perf_counter()
            r["losses"].append(step(x[k, rows], y[k, rows]).item())
            r["step_s"].append(time.perf_counter() - t0)
            r["replicas_equal"].append(replicas_equal(step, group))
        r["launches"] = K.launch_counts()
        r["flash_routes"] = {w: dict(getattr(K, w).route_launches)
                             for w in FLASH_WRAPPERS}
        r["opt_bytes"] = opt_state_bytes(step)
        r["slice_dims"] = sorted(set(step._zero.dims.values()))
        tree = gathered_state(step)
        if rank == 0:
            torch.save({k: v.detach().cpu() for k, v in tree.params.items()},
                       directory / f"{level}_params.pt")
        rec[level] = r
        if level == "os_g":
            t0 = time.perf_counter()
            mgr = CheckpointManager(directory / "ck")
            mgr.save(step.step_index, tree.to_tree())
            rec["save_blocking_s"] = mgr.last_save["blocking_s"]
            mgr.wait_until_finished()
            mgr.close()
            rec["save_total_s"] = time.perf_counter() - t0
            if rank == 0:
                flat = dict(tree.params)
                for name, slots in tree.opt_state.items():
                    flat.update({f"{name}/{k}": v for k, v in slots.items()})
                torch.save({k: v.detach().cpu() if torch.is_tensor(v)
                            else torch.as_tensor(np.asarray(v))
                            for k, v in flat.items()},
                           directory / "rank0_state.pt")
        del model, opt, step, tree
        torch.cuda.empty_cache()
    rec["staged"] = dict(communication.staged_ops)
    (directory / f"rank{rank}.json").write_text(json.dumps(rec))
    return 0


# the multi-rank phases' workers in the order one process runs them when
# a launch chains them (``launch_chain``): each world size's launcher then
# starts once for the whole script
WORKERS = ("dp_worker", "tp_worker", "zero_worker", "z3_worker",
           "reduce_worker", "ep_worker", "mx_worker", "split_worker",
           "pp_worker", "ep4_worker", "mx4_worker", "split4_worker",
           "pp4_worker")
# flag -> the work directory its ranks wrote, in a chained launch
CHAINED = {}
# [4]'s one-process readings, which [23b] prints beside its own
SERVED = {}
# what a worker of a chained launch leaves to the next one in its process
# ([22c]'s mp-2 step, its gathered save and its stage-3 step for [23a])
HELD = {}


def run_launcher(args, nproc: int, log_dir: Path, what: str):
    """``nproc`` ranks of this script with ``args`` through the port's
    launcher over gloo on the one card; every process killed on the way
    out. Fails on a nonzero exit, after printing the workers' logs."""
    import os
    import signal

    repo = Path(__file__).resolve().parent
    env = {**os.environ, "PADDLE_DISTRI_BACKEND": "gloo",
           "PYTHONPATH": str(repo)}
    for k in ("PADDLE_MASTER", "MASTER_ADDR", "PADDLE_TRAINERS_NUM",
              "PADDLE_TRAINER_ID"):
        env.pop(k, None)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(nproc), "--log_dir", str(log_dir),
           str(Path(__file__).resolve()), *args]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, cwd=repo, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    try:
        out = proc.communicate(timeout=1000)[0]
    finally:
        if proc.poll() is None:  # the launcher and its workers
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    codes = re.findall(r"worker exit codes \[[^\]]*\]", out or "")
    print(f"{what} through the port's launcher over gloo: launcher exit "
          f"code {proc.returncode}, {codes} in {time.perf_counter() - t0:.1f}"
          f" s ({nvidia_smi_line()})", flush=True)
    if proc.returncode != 0:
        for log in sorted(log_dir.glob("workerlog.*")):
            print(f"    --- {log.name}\n{log.read_text()[-3000:]}",
                  flush=True)
    check(proc.returncode == 0, f"{what}: the launcher exited with "
          f"{proc.returncode}")


def launch_chain(flags, seed: int, nproc: int, what: str):
    """One launcher start for the phases whose ranks run ``flags``: each
    rank runs their workers one after another in one process (``main``),
    each into its phase's directory, which ``chained_records`` then
    reads."""
    import tempfile

    dirs = {f: Path(tempfile.mkdtemp(
        prefix="chip_smoke_" + f.strip("-").replace("-", "_") + "_",
        dir=CKPT_PARENT)) for f in flags}
    run_launcher(["--seed", str(seed)] + [a for f in flags
                                          for a in (f, str(dirs[f]))],
                 nproc, dirs[flags[0]] / "log", what)
    CHAINED.update(dirs)


def chained_records(flag: str, what: str, nproc: int = 2):
    """Each rank's record of the phase whose ranks ran ``flag`` in a
    ``launch_chain``."""
    print(f"{what}: its ranks ran in the chained launch", flush=True)
    return [json.loads((CHAINED[flag] / f"rank{r}.json").read_text())
            for r in range(nproc)]


def parity_errors(cfg, ref, losses, params):
    """Losses and parameters against the one-process reference: the
    largest loss difference, parameter difference, and the qkv biases' K
    third's (held to Adam's bound)."""
    loss_err = max(abs(a - b) for a, b in zip(ref["losses"], losses))
    k_part = slice(cfg.num_heads * cfg.head_dim,
                   (cfg.num_heads + cfg.num_kv_heads) * cfg.head_dim)
    worst, worst_k = 0.0, 0.0
    for name, want in ref["params"].items():
        d = (params[name].float() - want.float()).abs()
        if name.endswith("attn.qkv.bias"):
            worst_k = max(worst_k, float(d[k_part].max()))
            d[k_part] = 0
        worst = max(worst, float(d.max()))
    return loss_err, worst, worst_k


def parity_ok(errs) -> bool:
    return errs[0] <= DP_LOSS_TOL and errs[1] <= DP_PARAM_TOL \
        and errs[2] <= 2 * DP_STEPS * DP_LR


def tp_two_ranks(K, seed: int, rows, ref, one):
    """[19a]: tensor parallelism at mp 2, two ranks sharing the card: the
    parity leg against [18b]'s one process on the whole model, the
    main-path leg's launches, collectives, step and memory per rank
    against one process of the same configuration (``one``)."""
    from paddle_tpu_torch.models.gpt import GPT3_1p3B, GPTConfig

    t_phase = time.perf_counter()
    smi = f"{nvidia_smi_line()}, {torch.cuda.device_count()} card(s)"
    work = CHAINED["--tp-worker"]
    try:
        recs = chained_records("--tp-worker",
                               "[19a] mp 2, two ranks on one card")
        cfg = GPTConfig(**{**GPT3_1p3B, "num_layers": 2}, dropout=0.0)
        errs = parity_errors(cfg, ref, recs[0]["losses"],
                             torch.load(work / "tp_params.pt"))
        print(f"    (i) 1.3B width, depth 2, fp32, {DP_STEPS} steps on "
              f"{DP_B} x {DP_S}: losses {recs[0]['losses']}; against one "
              f"process on the whole model: losses {errs[0]:.3e} (tol "
              f"{DP_LOSS_TOL:g}), the gathered global parameters "
              f"{errs[1]:.3e} (tol {DP_PARAM_TOL:g}), the qkv biases' K "
              f"third {errs[2]:.3e} (Adam's bound {2 * DP_STEPS * DP_LR:g});"
              f" replicated parameters bitwise equal on both ranks after "
              f"each step {[r['replicas_equal'] for r in recs]}; flash "
              f"routes {recs[0]['parity_routes']} ({smi})", flush=True)
        check(parity_ok(errs) and all(all(r["replicas_equal"]) for r in recs)
              and recs[0]["losses"] == recs[1]["losses"]
              and all(r["backend"] == "GLOO" for r in recs),
              f"[19a] parity: {errs}, {recs}")
        for r in recs:
            check(all(v["cuda_cores"] == sum(v.values()) > 0
                      for v in r["parity_routes"].values()),
                  f"[19a] parity: a flash launch left the fp32 route: "
                  f"{r['parity_routes']}")

        L = MR_LAYERS
        one_s = one["step_s"]
        for r in recs:
            ln = r["launches"]
            per = {k: v / TP_TIMED for k, v in ln.items() if v}
            share = r["collective_s_per_step"] / r["step_s"]
            mine = r["param_bytes"] + r["grad_bytes"] + r["opt_bytes"]
            theirs = one["param"] + one["grad"] + one["opt"]
            print(f"    (ii) rank {r['rank']}, GPT-3 1.3B bf16 cut to "
                  f"{L} layers at mp 2 (recompute, fp32 master, bf16 "
                  f"moments), batch {TP_B} x "
                  f"{TP_S}: warm-up loss {r['warmup_loss']:.4f}, timed "
                  f"losses {r['main_losses']}; step {r['step_s'] * 1e3:.1f} "
                  f"ms host clock (one process {one_s * 1e3:.1f} ms); "
                  f"launches per step {per}; flash routes "
                  f"{r['flash_routes']}; mp collectives "
                  f"{r['collectives_per_step']:.0f} a step, "
                  f"{r['collective_s_per_step'] * 1e3:.1f} ms host clock = "
                  f"{share:.3f} of the step; peak memory "
                  f"{r['peak_bytes'] / 2**30:.2f} GiB (one process "
                  f"{one['peak'] / 2**30:.2f}); parameters, gradients, "
                  f"optimizer state {r['param_bytes'] / 2**30:.2f} + "
                  f"{r['grad_bytes'] / 2**30:.2f} + "
                  f"{r['opt_bytes'] / 2**30:.2f} GiB = {mine / theirs:.3f} "
                  f"of one process's {theirs / 2**30:.2f}; ops staged "
                  f"through the host {r['staged'] or 'none'} ({smi})",
                  flush=True)
            check(all(np.isfinite(r["main_losses"]))
                  and r["replicas_equal_main"]
                  and ln["flash_attention_fwd"] == 2 * L * TP_TIMED
                  and ln["flash_attention_bwd_dq"] == L * TP_TIMED
                  and ln["flash_attention_bwd_dkv"] == L * TP_TIMED
                  and ln["fused_layer_norm"] == (4 * L + 1) * TP_TIMED
                  and ln["layer_norm_bwd"] == (2 * L + 1) * TP_TIMED
                  and ln["fused_adamw_multi"] == TP_TIMED
                  and r["master_copies"] == 0
                  and all(v["wgmma"] == sum(v.values()) > 0
                          for v in r["flash_routes"].values())
                  and mine / theirs <= 0.55,
                  f"[19a] rank {r['rank']}: {r}")
        for name in TRAINING_KERNELS:
            rows[name]["launches_tp"] = recs[0]["launches"][name]
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    print(f"    phase 19a took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def zero_two_ranks(K, seed: int, rows, ref):
    """[19b]: ZeRO at sharding 2, levels os and os_g, two ranks sharing the
    card: each against [18b]'s one process on the whole batch, the
    replicas, each rank's optimizer-state bytes against one process's, the
    ops staged through the host, and the one-process restore of the ranks'
    checkpoint. Returns the os_g run's losses and global parameters (on
    the host), [20a]'s bitwise reference."""
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.models.gpt import GPT3_1p3B, GPTConfig

    t_phase = time.perf_counter()
    smi = f"{nvidia_smi_line()}, {torch.cuda.device_count()} card(s)"
    work = CHAINED["--zero-worker"]
    try:
        recs = chained_records(
            "--zero-worker", "[19b] ZeRO at sharding 2, two ranks on one card")
        cfg = GPTConfig(**{**GPT3_1p3B, "num_layers": 2}, dropout=0.0)
        n_params = tensor_bytes(ref["params"].values())
        for level in ("os", "os_g"):
            errs = parity_errors(cfg, ref, recs[0][level]["losses"],
                                 torch.load(work / f"{level}_params.pt"))
            for r in recs:
                lv = r[level]
                # AdamW's two fp32 moments of every parameter
                one_opt = 2 * n_params
                print(f"    level {level}, rank {r['rank']}: losses "
                      f"{lv['losses']}; step s "
                      f"{[round(t, 4) for t in lv['step_s']]} host clock; "
                      f"replicas bitwise equal after each step "
                      f"{lv['replicas_equal']}; optimizer state "
                      f"{lv['opt_bytes'] / 2**30:.3f} GiB = "
                      f"{lv['opt_bytes'] / one_opt:.3f} of one process's "
                      f"{one_opt / 2**30:.3f}; slices on dims "
                      f"{lv['slice_dims']}; launches "
                      f"{ {k: v for k, v in lv['launches'].items() if v} }",
                      flush=True)
                check(all(lv["replicas_equal"])
                      and lv["losses"] == recs[0][level]["losses"]
                      and lv["opt_bytes"] / one_opt <= 0.55
                      and all(v["cuda_cores"] == sum(v.values()) > 0
                              for v in lv["flash_routes"].values()),
                      f"[19b] {level} rank {r['rank']}: {lv}")
            print(f"    level {level} against one process on the whole "
                  f"batch: losses {errs[0]:.3e} (tol {DP_LOSS_TOL:g}), "
                  f"parameters {errs[1]:.3e} (tol {DP_PARAM_TOL:g}), the "
                  f"qkv biases' K third {errs[2]:.3e} (Adam's bound "
                  f"{2 * DP_STEPS * DP_LR:g}) ({smi})", flush=True)
            check(parity_ok(errs), f"[19b] {level}: {errs}")
        print(f"    ops staged through the host (gloo on CUDA tensors): "
              f"{[r['staged'] for r in recs]}; save blocking "
              f"{[round(r['save_blocking_s'], 3) for r in recs]} s, total "
              f"{[round(r['save_total_s'], 3) for r in recs]} s", flush=True)
        for name in TRAINING_KERNELS:
            rows[name]["launches_zero"] = recs[0]["os_g"]["launches"][name]
        t0 = time.perf_counter()
        restored = CheckpointManager(work / "ck").restore()
        restore_s = time.perf_counter() - t0
        rank0 = torch.load(work / "rank0_state.pt")
        flat = dict(restored["params"])
        for name, slots in restored["opt_state"].items():
            flat.update({f"{name}/{k}": v for k, v in slots.items()})
        differ = [k for k, v in rank0.items() if not (
            flat[k].dtype == v.dtype and torch.equal(flat[k], v))]
        print(f"    one-process restore of the ranks' os_g checkpoint "
              f"({restore_s:.2f} s): {len(rank0) - len(differ)} of "
              f"{len(rank0)} tensors bitwise equal to the gathered global "
              f"state ({smi})", flush=True)
        check(not differ and int(restored["step"]) == DP_STEPS,
              f"[19b]: the restore differs from the global state: "
              f"{differ[:4]}")
        os_g = {"losses": recs[0]["os_g"]["losses"],
                "params": torch.load(work / "os_g_params.pt")}
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    print(f"    phase 19b took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return os_g


# --------------------------------------------------------------- phase 20
# [20b]'s runs: [18b]'s model at dp 2, each rank on its half of GR_STEPS
# batches of 4 x 512, under every gradient-reduction mode
GR_STEPS = 10
GR_MODES = (None, "fp32", "int8", "bf16")
# the step whose reduction [20b] repeats on the CPU (its residuals nonzero)
GR_CHECK_STEP = 3
# [20a] (ii): the full 1.3B at [6]'s configuration and optimizer, batch
# 2 x 1024 a rank, one warm-up step and 2 timed ones (the cut of [19a] (ii))
Z3_TIMED = 2


def one_process_main(seed: int):
    """[19a] (ii)'s and [20a] (ii)'s reference: the full 1.3B at [6]'s
    configuration and optimizer at batch 2 x 1024 in this process, a
    warm-up step and 2 timed ones: the step's host clock, its peak memory
    and the parameter, gradient and optimizer-state bytes."""
    from paddle_tpu_torch.distributed.fleet import make_sharded_train_step
    from paddle_tpu_torch.models.gpt import GPT3_1p3B, GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    tcfg = GPTConfig(**{**GPT3_1p3B, "num_layers": MR_LAYERS}, dropout=0.0,
                     use_recompute=True, recompute_interval=1,
                     loss_chunk=128)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    model = GPTForCausalLM(
        tcfg, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(seed))
    model.train()
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                multi_precision=True, moment_dtype="bfloat16")
    step = make_sharded_train_step(model, opt)
    g = torch.Generator(device="cuda").manual_seed(seed + 19)
    xm = torch.randint(0, tcfg.vocab_size, (TP_B, TP_S), generator=g,
                       device="cuda")
    ym = torch.roll(xm, -1, dims=1)
    step(xm, ym)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TP_TIMED):
        step(xm, ym)
    torch.cuda.synchronize()
    one = {"step_s": (time.perf_counter() - t0) / TP_TIMED,
           "peak": torch.cuda.max_memory_allocated() - base,
           "param": tensor_bytes(step.params.values()),
           "grad": tensor_bytes(p.grad for p in step.params.values()),
           "opt": opt_state_bytes(step)}
    del model, opt, step
    torch.cuda.empty_cache()
    return one


def update_grad_bytes(step) -> int:
    """Bytes of the gradients the update reads: a ZeRO rank's slices, the
    whole gradient of the other parameters."""
    zero = step._zero
    total = 0
    for name, p in step.params.items():
        n = p.numel()
        if zero is not None and name in zero.dims and name not in zero.z3:
            n //= zero.n
        total += n * p.element_size()
    return total


def whole_params_equal(step, group) -> bool:
    """The parameters stage 3 keeps whole (the vectors), bitwise equal to
    the group's first rank's."""
    from paddle_tpu_torch import distributed as dist

    same = torch.ones((), device="cuda")
    for name, p in step.params.items():
        if name in step._z3:
            continue
        buf = p.detach().clone()
        dist.broadcast(buf, src=group.ranks[0], group=group)
        same *= float(torch.equal(buf, p))
    dist.all_reduce(same, dist.ReduceOp.MIN, group=group)
    return bool(same)


def z3_gather_timer():
    """Time every stage-3 gather (host clock, the card synchronised first):
    returns a tally and a function that puts ``gather`` back."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import sharding

    tally = {"seconds": 0.0}
    orig = sharding._Z3Param.gather

    def timed(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return orig(self)
        finally:
            tally["seconds"] += time.perf_counter() - t0

    sharding._Z3Param.gather = timed
    return tally, lambda: setattr(sharding._Z3Param, "gather", orig)


def z3_nccl_slice(K, seed: int, rows, step6_s):
    """[20a] (0): [6]'s model and optimizer at ``p_g_os`` through
    ``fleet.init`` over an NCCL group of one rank: two steps bitwise equal
    to the step without a mesh, then 3 timed steps (host clock against
    [6]'s), the gathers and reduce-scatters per step and each kernel's
    launches, which must be [6]'s."""
    import tempfile

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet import make_sharded_train_step
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        group_sharded_parallel)

    t_phase = time.perf_counter()
    smi = f"{nvidia_smi_line()}, {torch.cuda.device_count()} card(s)"
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_z3_", dir=CKPT_PARENT))
    old = dp_env(PADDLE_MASTER=f"file://{work / 'store'}",
                 PADDLE_TRAINERS_NUM="1", PADDLE_TRAINER_ID="0",
                 PADDLE_DISTRI_BACKEND=None, MASTER_ADDR=None)
    try:
        cfg, model, opt, x, y = train_model(seed)
        step = make_sharded_train_step(model, opt)
        want = [step(x, y) for _ in range(2)]
        ref = {k: p.detach().clone() for k, p in model.named_parameters()}
        del model, opt, step
        torch.cuda.empty_cache()
        cfg, model, opt, x, y = train_model(seed)
        st = fleet.DistributedStrategy()
        st.hybrid_configs = {"sharding_degree": 1}
        fleet.init(is_collective=True, strategy=st)
        hcg = fleet.get_hybrid_communicate_group()
        model, opt, _ = group_sharded_parallel(model, opt, level="p_g_os")
        step = make_sharded_train_step(model, opt, mesh=hcg.get_mesh())
        print(f"[20a] (0) GPT-3 1.3B ([6]'s model, optimizer and batch "
              f"{x.shape[0]} x {x.shape[1]}) at p_g_os over fleet.init's "
              f"mesh {hcg.get_mesh().shape}: backend {dist.get_backend()}, "
              f"{len(model.z3)} matrices held as slices (one rank: the "
              f"whole) ({smi})", flush=True)
        check(dist.get_backend() == "NCCL",
              f"[20a] (0): not an NCCL group: {dist.get_backend()}")
        got = [step(x, y) for _ in range(2)]
        same_loss = all(torch.equal(a, b) for a, b in zip(want, got))
        diff = [k for k, p in model._layers.named_parameters()
                if not torch.equal(ref[k], p)]
        print(f"    two steps: losses {[float(v) for v in got]} against "
              f"{[float(v) for v in want]} without a mesh, bitwise "
              f"{same_loss}; parameters differing: {len(diff)} of "
              f"{len(ref)}", flush=True)
        check(same_loss and not diff, f"[20a] (0): the world-1 p_g_os steps "
              f"differ from the no-mesh steps: {same_loss}, {diff[:4]}")
        del ref
        timed, L = 3, cfg.num_layers
        K.reset_launch_counts()
        copies0 = opt.master_copies
        model.stats.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(timed):
            step(x, y)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t0) / timed
        counts = K.launch_counts()
        check_flash_routes(K, "wgmma", "[20a] (0)")
        print(f"    step {step_s * 1e3:.1f} ms host clock over {timed} steps "
              f"([6]: {step6_s * 1e3:.1f} ms); gathers "
              f"{model.stats.gathers / timed:g} and reduce-scatters "
              f"{model.stats.reduce_scatters / timed:g} a step; launches "
              f"per step { {k: v / timed for k, v in counts.items() if v} } "
              f"({smi})", flush=True)
        check(counts["flash_attention_fwd"] == 2 * L * timed
              and counts["flash_attention_bwd_dq"] == L * timed
              and counts["flash_attention_bwd_dkv"] == L * timed
              and counts["fused_layer_norm"] == (4 * L + 1) * timed
              and counts["layer_norm_bwd"] == (2 * L + 1) * timed
              and counts["fused_adamw_multi"] == timed
              and opt.master_copies == copies0
              and model.stats.reduce_scatters == len(model.z3) * timed,
              f"[20a] (0): launches per step differ from [6]'s (one AdamW, "
              f"no master copy): {counts}, copies "
              f"{opt.master_copies - copies0}")
        for name in TRAINING_KERNELS:
            rows[name]["launches_z3_nccl"] = counts[name]
        del model, opt, step
    finally:
        dist.destroy_process_group()
        dp_env(**old)
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    print(f"    phase 20a (0) took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def z3_worker(directory: Path, seed: int) -> int:
    """One rank of [20a], started by the port's launcher: sharding 2 over
    gloo on the one card. (i) [18b]'s model at p_g_os, this rank's half
    of each batch, 3 AdamW steps with the whole parameters compared after
    each, the gathers and reduce-scatters, rank 0's gathered global
    parameters, and an async save by both ranks; (ii) the full 1.3B in
    bf16 at [6]'s configuration and optimizer, batch 2 x 1024 a rank, at
    p_g_os (one warm-up step and 2 timed ones: launches, gathers and their
    host clock, the live gathered bytes, peak memory and bytes) and at
    os_g (one step: peak memory and bytes)."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed import communication, fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        group_sharded_parallel)
    from paddle_tpu_torch.models.gpt import GPT3_1p3B, GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    hcg = rank_init({"sharding_degree": 2})
    rank = fleet.worker_index()
    group = hcg.get_sharding_parallel_group()
    rows = slice(rank * DP_B // 2, (rank + 1) * DP_B // 2)
    rec = {"rank": rank, "backend": dist.get_backend()}

    # (i) parity, replicas and the checkpoint
    cfg, model, opt, x, y = dp_model(seed)
    model, opt, _ = group_sharded_parallel(model, opt, level="p_g_os")
    step = fleet.make_sharded_train_step(model, opt, mesh=hcg.get_mesh())
    r = {"losses": [], "replicas_equal": [], "sliced": len(step._z3),
         "params": len(step.params)}
    K.reset_launch_counts()
    model.stats.reset()
    for k in range(DP_STEPS):
        r["losses"].append(step(x[k, rows], y[k, rows]).item())
        r["replicas_equal"].append(whole_params_equal(step, group))
    r["gathers"] = model.stats.gathers / DP_STEPS
    r["reduce_scatters"] = model.stats.reduce_scatters / DP_STEPS
    r["launches"] = K.launch_counts()
    r["flash_routes"] = {w: dict(getattr(K, w).route_launches)
                         for w in FLASH_WRAPPERS}
    tree = gathered_state(step)
    if rank == 0:
        torch.save({k: v.detach().cpu() for k, v in tree.params.items()},
                   directory / "z3_params.pt")
    mgr = CheckpointManager(directory / "ck")
    mgr.save(step.step_index, tree.to_tree())
    mgr.wait_until_finished()
    mgr.close()
    if rank == 0:
        flat = dict(tree.params)
        for name, slots in tree.opt_state.items():
            flat.update({f"{name}/{k}": v for k, v in slots.items()})
        torch.save({k: v.detach().cpu() if torch.is_tensor(v)
                    else torch.as_tensor(np.asarray(v))
                    for k, v in flat.items()}, directory / "rank0_state.pt")
    rec["parity"] = r
    del model, opt, step, tree
    torch.cuda.empty_cache()

    # (ii) the main path at full width, p_g_os then os_g
    tcfg = GPTConfig(**{**GPT3_1p3B, "num_layers": MR_LAYERS}, dropout=0.0,
                     use_recompute=True, recompute_interval=1,
                     loss_chunk=128)
    g = torch.Generator(device="cuda").manual_seed(seed + 20 + rank)
    xm = torch.randint(0, tcfg.vocab_size, (TP_B, TP_S), generator=g,
                       device="cuda")
    ym = torch.roll(xm, -1, dims=1)
    for level in ("p_g_os", "os_g"):
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model = GPTForCausalLM(
            tcfg, device="cuda", dtype=torch.bfloat16,
            generator=torch.Generator(device="cuda").manual_seed(seed))
        model.train()
        opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                    multi_precision=True, moment_dtype="bfloat16")
        model, opt, _ = group_sharded_parallel(model, opt, level=level)
        step = fleet.make_sharded_train_step(model, opt,
                                             mesh=hcg.get_mesh())
        m = {"warmup_loss": step(xm, ym).item()}
        if level == "p_g_os":
            K.reset_launch_counts()
            copies0 = opt.master_copies
            model.stats.reset()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses = [step(xm, ym) for _ in range(Z3_TIMED)]
            torch.cuda.synchronize()
            m["step_s"] = (time.perf_counter() - t0) / Z3_TIMED
            m["master_copies"] = opt.master_copies - copies0
            m["losses"] = [float(v) for v in losses]
            m["launches"] = K.launch_counts()
            m["flash_routes"] = {w: dict(getattr(K, w).route_launches)
                                 for w in FLASH_WRAPPERS}
            m["gathers"] = model.stats.gathers / Z3_TIMED
            m["reduce_scatters"] = model.stats.reduce_scatters / Z3_TIMED
            m["gathered_peak"] = model.stats.peak_bytes
            # the gathers' share: one more step with each gather timed (the
            # card synchronised before each, so this step runs slower)
            tally, restore = z3_gather_timer()
            t0 = time.perf_counter()
            step(xm, ym)
            torch.cuda.synchronize()
            m["gather_step_s"] = time.perf_counter() - t0
            restore()
            m["gather_s"] = tally["seconds"]
            m["block_bytes"] = max(
                sum(int(np.prod(z.shape)) * 2 for n, z in model.z3.items()
                    if f".layers.{i}." in n) for i in range(tcfg.num_layers))
            m["largest_bytes"] = max(int(np.prod(z.shape)) * 2
                                     for z in model.z3.values())
        m["peak_bytes"] = torch.cuda.max_memory_allocated() - base
        m["param_bytes"] = tensor_bytes(step.params.values())
        m["grad_bytes"] = update_grad_bytes(step)
        m["opt_bytes"] = opt_state_bytes(step)
        rec[level] = m
        del model, opt, step
    rec["staged"] = dict(communication.staged_ops)
    (directory / f"rank{rank}.json").write_text(json.dumps(rec))
    return 0


def z3_two_ranks(K, seed: int, rows, ref, os_g, one):
    """[20a] (i) and (ii): ZeRO stage 3 at sharding 2, two ranks sharing the
    card: against [18b]'s one process and bitwise against [19b]'s os_g
    run; the one-process restore of the ranks' checkpoint; the full
    1.3B's launches, gathers, step, memory and bytes per rank against one
    process's and os_g's."""
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.models.gpt import GPT3_1p3B, GPTConfig

    t_phase = time.perf_counter()
    smi = f"{nvidia_smi_line()}, {torch.cuda.device_count()} card(s)"
    work = CHAINED["--z3-worker"]
    try:
        recs = chained_records(
            "--z3-worker", "[20a] ZeRO stage 3 at sharding 2, two ranks on "
            "one card")
        cfg = GPTConfig(**{**GPT3_1p3B, "num_layers": 2}, dropout=0.0)
        params = torch.load(work / "z3_params.pt")
        errs = parity_errors(cfg, ref, recs[0]["parity"]["losses"], params)
        same_os_g = recs[0]["parity"]["losses"] == os_g["losses"] and all(
            torch.equal(params[k], v) for k, v in os_g["params"].items())
        for r in recs:
            p = r["parity"]
            print(f"    (i) rank {r['rank']}, 1.3B width, depth 2, fp32, "
                  f"{DP_STEPS} steps on half of {DP_B} x {DP_S}: losses "
                  f"{p['losses']}; {p['sliced']} of {p['params']} parameters "
                  f"held as slices; whole parameters bitwise equal on both "
                  f"ranks after each step {p['replicas_equal']}; gathers "
                  f"{p['gathers']:g} and reduce-scatters "
                  f"{p['reduce_scatters']:g} a step; launches over the "
                  f"steps { {k: v for k, v in p['launches'].items() if v} }"
                  f"; flash routes {p['flash_routes']}", flush=True)
            check(all(p["replicas_equal"]) and p["sliced"] > 0
                  and p["losses"] == recs[0]["parity"]["losses"]
                  and all(v["cuda_cores"] == sum(v.values()) > 0
                          for v in p["flash_routes"].values()),
                  f"[20a] (i) rank {r['rank']}: {p}")
        print(f"    (i) against one process on the whole batch: losses "
              f"{errs[0]:.3e}, the gathered global parameters "
              f"{errs[1]:.3e} (tol 1e-6 both), the qkv biases' K third "
              f"{errs[2]:.3e} (Adam's bound {2 * DP_STEPS * DP_LR:g}); "
              f"losses and global parameters bitwise [19b]'s os_g "
              f"{same_os_g} ({smi})", flush=True)
        check(errs[0] <= 1e-6 and errs[1] <= 1e-6
              and errs[2] <= 2 * DP_STEPS * DP_LR and same_os_g,
              f"[20a] (i): {errs}, bitwise os_g {same_os_g}")
        restored = CheckpointManager(work / "ck").restore()
        rank0 = torch.load(work / "rank0_state.pt")
        flat = dict(restored["params"])
        for name, slots in restored["opt_state"].items():
            flat.update({f"{name}/{k}": v for k, v in slots.items()})
        differ = [k for k, v in rank0.items() if not (
            flat[k].dtype == v.dtype and torch.equal(flat[k], v))]
        print(f"    (i) one-process restore of the ranks' checkpoint: "
              f"{len(rank0) - len(differ)} of {len(rank0)} tensors bitwise "
              f"equal to the gathered global state", flush=True)
        check(not differ and int(restored["step"]) == DP_STEPS,
              f"[20a] (i): the restore differs: {differ[:4]}")
        del restored, rank0, flat, params

        L = MR_LAYERS
        theirs = one["param"] + one["grad"] + one["opt"]
        for r in recs:
            m, o = r["p_g_os"], r["os_g"]
            ln = m["launches"]
            mine = m["param_bytes"] + m["grad_bytes"] + m["opt_bytes"]
            os_g_b = o["param_bytes"] + o["grad_bytes"] + o["opt_bytes"]
            print(f"    (ii) rank {r['rank']}, GPT-3 1.3B bf16 cut to {L} "
                  f"layers at p_g_os (recompute, fp32 master, bf16 "
                  f"moments), batch {TP_B} x "
                  f"{TP_S} a rank: warm-up loss {m['warmup_loss']:.4f}, timed"
                  f" losses {m['losses']}; step {m['step_s'] * 1e3:.1f} ms "
                  f"host clock (one process {one['step_s'] * 1e3:.1f} ms); "
                  f"gathers {m['gathers']:g} a step; in a further step "
                  f"with each gather timed ({m['gather_step_s'] * 1e3:.1f} "
                  f"ms, the card synchronised before every gather) they "
                  f"took {m['gather_s'] * 1e3:.1f} ms host clock = "
                  f"{m['gather_s'] / m['gather_step_s']:.3f} of it; "
                  f"reduce-scatters {m['reduce_scatters']:g} a step; "
                  f"gathered weights alive at most "
                  f"{m['gathered_peak'] / 2**20:.1f} MiB (a block's "
                  f"{m['block_bytes'] / 2**20:.1f} MiB, the largest weight "
                  f"{m['largest_bytes'] / 2**20:.1f}); launches per step "
                  f"{ {k: v / Z3_TIMED for k, v in ln.items() if v} }; "
                  f"flash routes {m['flash_routes']} ({smi})", flush=True)
            print(f"    (ii) rank {r['rank']}: parameters, gradients, "
                  f"optimizer state {m['param_bytes'] / 2**30:.2f} + "
                  f"{m['grad_bytes'] / 2**30:.2f} + "
                  f"{m['opt_bytes'] / 2**30:.2f} GiB = {mine / theirs:.3f} "
                  f"of one process's {theirs / 2**30:.2f} and "
                  f"{mine / os_g_b:.3f} of os_g's {os_g_b / 2**30:.2f} "
                  f"({o['param_bytes'] / 2**30:.2f} + "
                  f"{o['grad_bytes'] / 2**30:.2f} + "
                  f"{o['opt_bytes'] / 2**30:.2f}); peak memory "
                  f"{m['peak_bytes'] / 2**30:.2f} GiB (one process "
                  f"{one['peak'] / 2**30:.2f}, os_g "
                  f"{o['peak_bytes'] / 2**30:.2f}); ops staged through the "
                  f"host {r['staged']}", flush=True)
            check(all(np.isfinite(m["losses"]))
                  and ln["flash_attention_fwd"] == 2 * L * Z3_TIMED
                  and ln["flash_attention_bwd_dq"] == L * Z3_TIMED
                  and ln["flash_attention_bwd_dkv"] == L * Z3_TIMED
                  and ln["fused_layer_norm"] == (4 * L + 1) * Z3_TIMED
                  and ln["layer_norm_bwd"] == (2 * L + 1) * Z3_TIMED
                  and ln["fused_adamw_multi"] == Z3_TIMED
                  and m["master_copies"] == 0
                  and all(v["wgmma"] == sum(v.values()) > 0
                          for v in m["flash_routes"].values())
                  and mine / theirs <= 0.55
                  and m["gathered_peak"] <= max(2 * m["block_bytes"],
                                                m["largest_bytes"]),
                  f"[20a] (ii) rank {r['rank']}: {m}")
        for name in TRAINING_KERNELS:
            rows[name]["launches_z3"] = recs[0]["p_g_os"]["launches"][name]
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    print(f"    phase 20a took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def diff_dicts(got, want):
    """Two ``{name: tensor}`` of the same keys: the largest absolute
    difference, how many entries differ, of how many, and the largest
    magnitude in ``want``."""
    d = {"max_abs_err": 0.0, "differ": 0, "of": 0, "max_abs": 0.0}
    for k, a in got.items():
        a, b = a.float(), want[k].float()
        d["max_abs_err"] = max(d["max_abs_err"], float((a - b).abs().max()))
        d["differ"] += int((a != b).sum())
        d["of"] += a.numel()
        d["max_abs"] = max(d["max_abs"], float(b.abs().max()))
    return d


def reduce_worker(directory: Path, seed: int) -> int:
    """One rank of [20b], started by the port's launcher: dp 2 over gloo
    on the one card, [18b]'s model on this rank's half of GR_STEPS
    batches under each gradient-reduction mode: losses, step and
    reduction host clock, launches, the plan's bytes, and whether fp32's
    parameters are bitwise None's."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.distributed import communication, fleet

    hcg = rank_init({"dp_degree": 2})
    rank = fleet.worker_index()
    rows = slice(rank * DP_B // 2, (rank + 1) * DP_B // 2)
    g = torch.Generator(device="cuda").manual_seed(seed + 20)
    rec = {"rank": rank, "backend": dist.get_backend(), "modes": {}}
    ref = None
    for mode in GR_MODES:
        cfg, model, opt, _, _ = dp_model(seed)
        if ref is None:
            xs = torch.randint(0, cfg.vocab_size, (GR_STEPS, DP_B, DP_S),
                               generator=g, device="cuda")
            ys = torch.roll(xs, -1, dims=2)
        step = fleet.make_sharded_train_step(
            fleet.distributed_model(model), fleet.distributed_optimizer(opt),
            mesh=hcg.get_mesh(), grad_reduce=mode)
        red = step._reducer
        owner, attr = (red, "reduce") if red is not None \
            else (step._grads, "reduce")
        tally = {"seconds": 0.0, "calls": 0}
        orig = getattr(owner, attr)
        held = {}

        def timed(*a, _orig=orig, _red=red, **kw):
            if _red is not None and tally["calls"] == GR_CHECK_STEP:
                held["in"] = [{k: v.detach().cpu().clone()
                               for k, v in x.items()} if isinstance(x, dict)
                              else None if x is None else x.detach().cpu()
                              for x in a]
            tally["calls"] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                out = _orig(*a, **kw)
            finally:
                torch.cuda.synchronize()
                tally["seconds"] += time.perf_counter() - t0
            if "in" in held and "out" not in held:
                held["out"] = [{k: v.cpu() for k, v in x.items()}
                               for x in out]
            return out

        setattr(owner, attr, timed)
        K.reset_launch_counts()
        losses, step_s = [], []
        for k in range(GR_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(step(xs[k, rows], ys[k, rows]).item())
            step_s.append(time.perf_counter() - t0)
        m = {"losses": losses, "step_s": step_s,
             "reduce_ms": tally["seconds"] / GR_STEPS * 1e3,
             "launches": K.launch_counts()}
        if red is not None:
            # step GR_CHECK_STEP's reduction again on the CPU tensors of the
            # same per-rank gradients and residuals (gloo's CPU path, no
            # pinned staging): reduced gradients and new residuals against
            # the card's
            cpu = orig(*held["in"])
            m["cpu_check"] = {part: diff_dicts(a, b) for part, a, b in (
                ("grads", held["out"][0], cpu[0]),
                ("residuals", held["out"][1], cpu[1]))}
            # the largest entry a bucket can hold before its quantization
            m["cpu_check"]["input_max_abs"] = sum(
                max((float(v.abs().max()) for v in d.values()), default=0.0)
                for d in held["in"][:2])
            p = red.plan
            m["plan"] = {"buckets": len(p.buckets), "raw": p.bytes_raw_per_step,
                         "wire": p.bytes_wire_per_step,
                         "ratio": p.compression_ratio,
                         "stages": [str(a) for a in red.stage_axes]}
            m["ef_bucket_rows"] = sorted({tuple(v.shape) for v in
                                          step.ef_state.values()})[:1]
        else:
            m["plan"] = {"raw": step._grads.nbytes, "buffers":
                         len(step._grads.buffers)}
        if mode is None:
            ref = {k: p.detach().clone() for k, p in step.params.items()}
        elif mode == "fp32":
            m["bitwise_none"] = all(torch.equal(ref[k], p)
                                    for k, p in step.params.items())
        rec["modes"][str(mode)] = m
        del model, opt, step, red, owner
        torch.cuda.empty_cache()
    rec["staged"] = dict(communication.staged_ops)
    (directory / f"rank{rank}.json").write_text(json.dumps(rec))
    return 0


def reduce_two_ranks(K, seed: int, rows):
    """[20b]: gradient reduction at dp 2, two ranks sharing the card: fp32
    bitwise the plain all-reduce's run, int8 with error feedback within 1%
    of fp32 at every step, bf16 trains; one int8 and one bf16 reduction
    repeated by the same reducer on CPU tensors (reduced gradients
    bitwise, residuals within a rounding); each mode's plan bytes,
    reduction host clock and step."""
    t_phase = time.perf_counter()
    smi = f"{nvidia_smi_line()}, {torch.cuda.device_count()} card(s)"
    work = CHAINED["--reduce-worker"]
    try:
        recs = chained_records("--reduce-worker",
                               "[20b] grad_reduce at dp 2, two ranks on one "
                               "card")
        for r in recs:
            modes = r["modes"]
            base, fp32 = modes["None"], modes["fp32"]
            for name, m in modes.items():
                step_ms = 1e3 * float(np.median(m["step_s"][1:]))
                print(f"    rank {r['rank']} grad_reduce={name}: losses "
                      f"{[round(v, 6) for v in m['losses']]}; step "
                      f"{step_ms:.1f} ms host clock (median after the first)"
                      f", the reduction {m['reduce_ms']:.1f} ms a step; plan "
                      f"{m['plan']}", flush=True)
            worst = max(abs(q - b) / abs(b) for q, b in zip(
                modes["int8"]["losses"], fp32["losses"]))
            ratio = fp32["plan"]["wire"] / modes["int8"]["plan"]["wire"]
            print(f"    rank {r['rank']}: fp32 bitwise None's losses "
                  f"{fp32['losses'] == base['losses']} and parameters "
                  f"{fp32['bitwise_none']}; int8 against fp32: largest "
                  f"relative loss difference {worst:.2e} over {GR_STEPS} "
                  f"steps (tol 1e-2); wire bytes a step fp32 "
                  f"{fp32['plan']['wire'] / 2**20:.2f} MiB, int8 "
                  f"{modes['int8']['plan']['wire'] / 2**20:.2f} MiB "
                  f"({ratio:.3f}x less), bf16 "
                  f"{modes['bf16']['plan']['wire'] / 2**20:.2f} MiB; int8's "
                  f"launches over its {GR_STEPS} steps "
                  f"{ {k: v for k, v in modes['int8']['launches'].items() if v} }"
                  f"; ops staged through the host {r['staged']} ({smi})",
                  flush=True)
            check(r["backend"] == "GLOO"
                  and fp32["losses"] == base["losses"] and fp32["bitwise_none"]
                  and worst < 1e-2 and 3.8 < ratio < 3.9
                  and all(np.isfinite(modes["bf16"]["losses"]))
                  and modes["int8"]["losses"] == recs[0]["modes"]["int8"][
                      "losses"],
                  f"[20b] rank {r['rank']}: {modes}")
            for name in ("int8", "bf16"):
                c = modes[name]["cpu_check"]
                # the reduced gradients bitwise; the residuals within 8
                # units in the last place of the largest entry a bucket
                # held: the stage error addcmul(v, q, s, value=-1) is
                # rounded once on one device and twice on the other
                # (int8 read 9.313e-10 = 2^-30 at gradients of up to
                # 1.4e-2 on an H100 80GB HBM3 at 700 W)
                tol = 2.0 ** -20 * c["input_max_abs"]
                print(f"    rank {r['rank']} grad_reduce={name}: step "
                      f"{GR_CHECK_STEP}'s reduction repeated on CPU tensors "
                      f"of the same per-rank gradients and residuals "
                      f"(largest entry {c['input_max_abs']:.3e}): "
                      + "; ".join(
                          f"{part} {c[part]['differ']} of {c[part]['of']} "
                          f"entries differ (largest "
                          f"{c[part]['max_abs_err']:.3e}; the CPU's largest "
                          f"magnitude {c[part]['max_abs']:.3e})"
                          for part in ("grads", "residuals"))
                      + f"; residual tol {tol:.3e}", flush=True)
                check(c["grads"]["differ"] == 0 and c["grads"]["max_abs"] > 0
                      and c["residuals"]["max_abs_err"] <= tol
                      and c["residuals"]["max_abs"] > 0,
                      f"[20b] rank {r['rank']} {name}: the card's reduction "
                      f"is not the CPU's: {c}")
        for name in TRAINING_KERNELS:
            rows[name]["launches_reduce"] = \
                recs[0]["modes"]["int8"]["launches"][name]
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    print(f"    phase 20b took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# --------------------------------------------------------------- phase 21
# [21]: expert parallelism over gloo ranks sharing the card. The parity
# runs take BASELINE config 5's width at depth 2 (one dense block, one MoE
# block of 8 experts) in fp32 on a global batch of EP_B x EP_S, each rank
# on its part of it, EP_STEPS AdamW steps ([18b]'s optimizer); the main
# path runs the full config 5 in bf16 at EP_MAIN_B x EP_S a rank (the two
# ranks' batch is [16]'s), one warm-up step and EP_TIMED timed ones
EP_B, EP_S, EP_STEPS, EP_MAIN_B, EP_TIMED = 8, 1024, 3, 4, 3
# quant against one dense process: the CPU tests' bound of quant training
# against dense (the JAX package's own, 1%) on the losses, Adam's bound
# (2 * steps * lr) on the parameters
EP_QUANT_LOSS_RTOL = 1e-2
# the block collectives of the token exchange, as this script counts them:
# where they are looked up by the route's code
# (the dispatch's reduce-scatter, ``reduce_scatter_in_trace``, and its
# backward run in ``mp_ops``)
EP_EXCHANGES = {"communication": ("reduce_scatter_blocks", "gather_blocks",
                                  "all_to_all_blocks"),
                "mp_ops": ("reduce_scatter_blocks", "gather_blocks"),
                "dispatch": ("all_to_all_blocks",)}


def ep_config(**over):
    from paddle_tpu_torch.models.gpt import GPTConfig

    return GPTConfig(**{**MOE5, **over})


def ep_weights(seed: int, cfg, dtype):
    """The whole model's state from the seed, on the card (built with no
    expert-parallel groups: call it before ``fleet.init``)."""
    from paddle_tpu_torch.models.gpt import GPTForCausalLM

    model = GPTForCausalLM(
        cfg, device="cuda", dtype=dtype,
        generator=torch.Generator(device="cuda").manual_seed(seed))
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    del model
    return sd


def ep_model(cfg, whole, dtype, rank: int, n: int, **opt_kw):
    """The model on this rank's experts of ``whole`` and its AdamW."""
    from paddle_tpu_torch.distributed.sharding_utils import local_block
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.weights import expert_stack

    model = GPTForCausalLM(cfg, device="cuda", dtype=dtype)
    model.load_state_dict({k: local_block(v, 0, rank, n) if expert_stack(k)
                           else v for k, v in whole.items()})
    model.train()
    return model, AdamW(parameters=model.named_parameters(), **opt_kw)


def ep_parity_opt():
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm

    return dict(learning_rate=DP_LR, epsilon=1e-6, weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(1.0))


def ep_batches(seed: int, vocab: int):
    g = torch.Generator(device="cuda").manual_seed(seed + 21)
    x = torch.randint(0, vocab, (EP_STEPS, EP_B, EP_S), generator=g,
                      device="cuda")
    return x, torch.roll(x, -1, dims=2)


class ExchangeTally:
    """Calls, receive-side bytes and host seconds of the token exchange's
    block collectives (``EP_EXCHANGES``, wrapped until ``close``)."""

    def __init__(self):
        from paddle_tpu_torch.distributed import communication
        from paddle_tpu_torch.distributed.fleet.meta_parallel import mp_ops
        from paddle_tpu_torch.incubate.distributed.models.moe import dispatch

        self.mods = {"communication": communication, "mp_ops": mp_ops,
                     "dispatch": dispatch}
        self.saved, self.ops = [], {}
        for mod, names in EP_EXCHANGES.items():
            for name in names:
                fn = getattr(self.mods[mod], name)
                self.saved.append((self.mods[mod], name, fn))
                setattr(self.mods[mod], name, self._wrap(name, fn))

    def _wrap(self, name, fn):
        def counted(t, group):
            n = group.nranks
            t0 = time.perf_counter()
            try:
                return fn(t, group)
            finally:
                rec = self.ops.setdefault(name, [0, 0, 0.0])
                whole = t.numel() * t.element_size()
                rec[0] += 1
                rec[1] += {"reduce_scatter_blocks": whole * (n - 1) // n,
                           "gather_blocks": whole * (n - 1),
                           "all_to_all_blocks": whole * (n - 1) // n}[name]
                rec[2] += time.perf_counter() - t0
        return counted

    def reset(self):
        self.ops = {}

    def totals(self):
        return (sum(v[0] for v in self.ops.values()),
                sum(v[1] for v in self.ops.values()),
                sum(v[2] for v in self.ops.values()))

    def close(self):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


class DropTally:
    """The share of the route's choices dropped at capacity, over the
    calls of ``gate._route`` while it is open."""

    def __init__(self):
        from paddle_tpu_torch.incubate.distributed.models.moe import \
            moe_layer

        self.mod, self.fn = moe_layer, moe_layer._route
        self.dropped = self.choices = 0

        def counted(logits, capacity, top_k, **kw):
            out = self.fn(logits, capacity, top_k, **kw)
            self.dropped += int((out[0] == logits.shape[1] * int(capacity))
                                .sum())
            self.choices += out[0].numel()
            return out
        moe_layer._route = counted

    def close(self):
        self.mod._route = self.fn
        return self.dropped / max(self.choices, 1)


def ep_parity_run(step, x, y, rows, directory, tag, rank):
    """EP_STEPS steps on ``rows``; the losses, the launches and flash
    routes; rank 0 keeps the gathered global parameters."""
    from paddle_tpu_torch import kernels as K

    K.reset_launch_counts()
    losses = [step(x[k, rows], y[k, rows]).item() for k in range(EP_STEPS)]
    rec = {"losses": losses, "launches": K.launch_counts(),
           "flash_routes": {w: dict(getattr(K, w).route_launches)
                            for w in FLASH_WRAPPERS}}
    tree = gathered_state(step)
    if rank == 0:
        torch.save({k: v.detach().cpu() for k, v in tree.params.items()},
                   directory / f"{tag}_params.pt")
    return rec, tree


def ep_worker(directory: Path, seed: int) -> int:
    """One rank of [21a], started by the port's launcher: ep 2 over gloo on
    the one card. (i) config 5's width at depth 2 in fp32, this rank's
    half of every batch, dense then quant, rank 0 keeping the gathered
    global parameters; (ii) the full config 5 in bf16 at EP_MAIN_B x EP_S
    a rank, dense then quant: a warm-up step (its dropped share), EP_TIMED
    timed steps (host clock, launches, master copies, the exchanges'
    calls, bytes and host seconds) and one profiled (its kernels)."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.distributed import communication, fleet
    from paddle_tpu_torch.incubate.distributed.models.moe.dispatch import \
        plan_quant_dispatch

    cfg2 = ep_config(num_layers=2)
    whole2 = ep_weights(seed, cfg2, torch.float32)
    cfg5 = ep_config()
    whole5 = ep_weights(seed + 16, cfg5, torch.bfloat16)
    hcg = rank_init({"ep_degree": 2})
    rank, n = fleet.worker_index(), hcg.get_expert_parallel_world_size()
    x, y = ep_batches(seed, cfg2.vocab_size)
    rows = slice(rank * EP_B // 2, (rank + 1) * EP_B // 2)
    rec = {"rank": rank, "backend": dist.get_backend(),
           "ep": [hcg.get_expert_parallel_rank(), n,
                  hcg.get_expert_parallel_group().ranks]}
    for mode in ("dense", "quant"):
        cfg = ep_config(num_layers=2, moe_dispatch=mode)
        model, opt = ep_model(cfg, whole2, torch.float32, rank, n,
                              **ep_parity_opt())
        step = fleet.make_sharded_train_step(model, opt, mesh=hcg.get_mesh())
        rec[f"parity_{mode}"], _ = ep_parity_run(step, x, y, rows, directory,
                                                 mode, rank)
        rec[f"parity_{mode}"]["experts"] = sorted(step._experts)
        del model, opt, step
    del whole2
    torch.cuda.empty_cache()

    g = torch.Generator(device="cuda").manual_seed(seed + 17 + rank)
    xm = torch.randint(0, cfg5.vocab_size, (EP_MAIN_B, EP_S), generator=g,
                       device="cuda")
    ym = torch.roll(xm, -1, dims=1)
    for mode in ("dense", "quant"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model, opt = ep_model(ep_config(moe_dispatch=mode), whole5,
                              torch.bfloat16, rank, n, learning_rate=1e-4,
                              moment_dtype="bfloat16")
        step = fleet.make_sharded_train_step(model, opt, mesh=hcg.get_mesh())
        drops = DropTally()
        losses = [step(xm, ym)]
        m = {"dropped": drops.close()}
        plan = None if mode == "dense" else plan_quant_dispatch(
            EP_MAIN_B * EP_S, cfg5.moe_num_experts,
            max(1, int(cfg5.moe_capacity_factor * EP_MAIN_B * EP_S * n
                       / cfg5.moe_num_experts)), cfg5.hidden_size,
            groups=model.gpt.layers[1].mlp.groups)
        m["plan"] = None if plan is None else {
            "block": plan.block, "bytes_wire": plan.bytes_wire,
            "bytes_raw": plan.bytes_raw,
            "bytes_wire_train_step": plan.bytes_wire_train_step,
            "compression_ratio": plan.compression_ratio}
        gc.collect()
        K.reset_launch_counts()
        staged0 = dict(communication.staged_ops)
        copies0 = opt.master_copies
        tally = ExchangeTally()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(EP_TIMED):
            losses.append(step(xm, ym))
        torch.cuda.synchronize()
        m["step_s"] = (time.perf_counter() - t0) / EP_TIMED
        tally.close()
        m["exchanges"] = {k: [c / EP_TIMED, b / EP_TIMED, s / EP_TIMED]
                          for k, (c, b, s) in tally.ops.items()}
        m["launches"] = {k: v / EP_TIMED
                         for k, v in K.launch_counts().items()}
        m["master_copies"] = opt.master_copies - copies0
        m["flash_routes"] = {w: dict(getattr(K, w).route_launches)
                             for w in FLASH_WRAPPERS}
        m["staged"] = {k: (v - staged0.get(k, 0)) / EP_TIMED
                       for k, v in communication.staged_ops.items()}
        kernels = profile_launches(lambda: losses.append(step(xm, ym)))
        m["profiled"] = launches_of(kernels, (
            FWD_SYMBOL, *BWD_SYMBOLS.values(), FP32_FWD_SYMBOL,
            *FP32_BWD_SYMBOLS.values(), NORM_SYMBOLS["fwd"],
            NORM_SYMBOLS["bwd"], "fused_adamw"))
        m["losses"] = [float(v) for v in losses]
        m["peak_bytes"] = torch.cuda.max_memory_allocated()
        m["param_bytes"] = tensor_bytes(step.params.values())
        rec[f"main_{mode}"] = m
        del model, opt, step
    (directory / f"rank{rank}.json").write_text(json.dumps(rec))
    return 0


def ep4_worker(directory: Path, seed: int) -> int:
    """One rank of [21b], started by the port's launcher: sharding 2 x ep
    2 at ``p_g_os`` over gloo on the one card, config 5's width at depth 2
    in fp32, this rank's quarter of every batch: the losses, launches,
    whole parameters equal across the sharding group after each step,
    this rank's bytes, rank 0's gathered global state, and a save by
    every rank."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        group_sharded_parallel)

    cfg = ep_config(num_layers=2)
    whole = ep_weights(seed, cfg, torch.float32)
    hcg = rank_init({"sharding_degree": 2, "ep_degree": 2})
    rank = fleet.worker_index()
    ep_r, n = (hcg.get_expert_parallel_rank(),
               hcg.get_expert_parallel_world_size())
    x, y = ep_batches(seed, cfg.vocab_size)
    model, opt = ep_model(cfg, whole, torch.float32, ep_r, n,
                          **ep_parity_opt())
    del whole
    model, opt, _ = group_sharded_parallel(model, opt, level="p_g_os")
    step = fleet.make_sharded_train_step(model, opt, mesh=hcg.get_mesh())
    rows = slice(rank * EP_B // 4, (rank + 1) * EP_B // 4)
    rec, tree = ep_parity_run(step, x, y, rows, directory, "z3", rank)
    rec.update(rank=rank, backend=dist.get_backend(),
               sliced=len(step._z3), experts=sorted(step._experts),
               z3={k: [list(p.shape), p.zero3_dim]
                   for k, p in step.params.items()
                   if k in step._z3 and k in step._experts},
               param_bytes=tensor_bytes(step.params.values()),
               grad_bytes=update_grad_bytes(step),
               opt_bytes=opt_state_bytes(step))
    mgr = CheckpointManager(directory / "ck")
    mgr.save(step.step_index, tree.to_tree())
    mgr.wait_until_finished()
    mgr.close()
    if rank == 0:
        flat = dict(tree.params)
        for name, slots in tree.opt_state.items():
            flat.update({f"{name}/{k}": v for k, v in slots.items()})
        torch.save({k: v.detach().cpu() if torch.is_tensor(v)
                    else torch.as_tensor(np.asarray(v))
                    for k, v in flat.items()}, directory / "rank0_state.pt")
    (directory / f"rank{rank}.json").write_text(json.dumps(rec))
    return 0


def ep_reference(seed: int):
    """One process on the whole batch, on the card: config 5's width at
    depth 2 in fp32, EP_STEPS steps; its losses, parameters (on the host)
    and the parameter, gradient and optimizer-state bytes."""
    from paddle_tpu_torch.distributed.fleet import make_sharded_train_step
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = ep_config(num_layers=2)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32)
    model.load_state_dict(ep_weights(seed, cfg, torch.float32))
    model.train()
    opt = AdamW(parameters=model.named_parameters(), **ep_parity_opt())
    step = make_sharded_train_step(model, opt)
    x, y = ep_batches(seed, cfg.vocab_size)
    losses = [step(x[k], y[k]).item() for k in range(EP_STEPS)]
    ref = {"losses": losses, "params": {
        k: p.detach().cpu() for k, p in model.named_parameters()},
        "bytes": tensor_bytes(step.params.values())
        + tensor_bytes(p.grad for p in step.params.values())
        + opt_state_bytes(step)}
    del model, opt, step
    torch.cuda.empty_cache()
    return cfg, ref


def ep_parity(cfg, ref, losses, params, quant=False):
    """``parity_errors`` against the one process, and whether they hold:
    [18b]'s trajectory tolerances, or for quant the CPU tests' quant
    bounds (losses relative, parameters Adam's)."""
    errs = parity_errors(cfg, ref, losses, params)
    if not quant:
        return errs, parity_ok(errs)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"]))
    return errs, (rel <= EP_QUANT_LOSS_RTOL
                  and max(errs[1:]) <= 2 * EP_STEPS * DP_LR)


def ep_two_ranks(K, seed: int, rows, step16_s):
    """[21a]: expert parallelism at ep 2, two ranks sharing the card (see
    ``ep_worker``): parity with one process, dense and quant; the full
    config 5's steps, exchanges, launches, dropped share and losses, dense
    against quant. Returns the one process's reference for [21b]."""
    t_phase = time.perf_counter()
    smi = f"{nvidia_smi_line()}, {torch.cuda.device_count()} card(s)"
    work = CHAINED["--ep-worker"]
    try:
        recs = chained_records(
            "--ep-worker", "[21a] expert parallelism at ep 2, two ranks on "
            "one card")
        cfg, ref = ep_reference(seed)
        print(f"    one process on the whole {EP_B} x {EP_S} batch (config "
              f"5's width, depth 2, fp32, {EP_STEPS} steps): losses "
              f"{ref['losses']} ({smi})", flush=True)
        for mode in ("dense", "quant"):
            params = torch.load(work / f"{mode}_params.pt")
            errs, ok = ep_parity(cfg, ref, recs[0][f"parity_{mode}"]["losses"],
                                 params, quant=mode == "quant")
            for r in recs:
                p = r[f"parity_{mode}"]
                ln = p["launches"]
                print(f"    (i) {mode}, rank {r['rank']} ({r['backend']}, "
                      f"ep {r['ep']}): losses {p['losses']}; expert stacks "
                      f"{len(p['experts'])}; launches over the steps "
                      f"{ {k: v for k, v in ln.items() if v} }; flash routes "
                      f"{p['flash_routes']}", flush=True)
                check(p["losses"] == recs[0][f"parity_{mode}"]["losses"]
                      and len(p["experts"]) == 4
                      and all(v["cuda_cores"] == sum(v.values()) > 0
                              for v in p["flash_routes"].values())
                      and ln["fused_adamw_multi"] == EP_STEPS,
                      f"[21a] (i) {mode} rank {r['rank']}: {p}")
            tol = (f"rel {EP_QUANT_LOSS_RTOL:g} on the losses, Adam's bound "
                   f"{2 * EP_STEPS * DP_LR:g} on the parameters"
                   if mode == "quant" else
                   f"{DP_LOSS_TOL:g} and {DP_PARAM_TOL:g}, the qkv biases' K "
                   f"third Adam's bound {2 * EP_STEPS * DP_LR:g}")
            print(f"    (i) {mode} against one process: losses "
                  f"{errs[0]:.3e}, gathered global parameters {errs[1]:.3e}, "
                  f"the qkv biases' K third {errs[2]:.3e} (tol {tol}) "
                  f"({smi})", flush=True)
            check(ok, f"[21a] (i) {mode}: {errs} beyond tolerance")
            del params
        L = MOE5["num_layers"]
        L_moe = L // MOE5["moe_every_k"]
        L_dense = L - L_moe
        want = {FWD_SYMBOL: 2 * L_dense + L_moe,
                BWD_SYMBOLS["dq"]: L_dense + L_moe,
                BWD_SYMBOLS["dkv"]: L_dense + L_moe,
                FP32_FWD_SYMBOL: 0, FP32_BWD_SYMBOLS["dq"]: 0,
                FP32_BWD_SYMBOLS["dkv"]: 0,
                NORM_SYMBOLS["fwd"]: 4 * L_dense + 2 * L_moe + 1,
                NORM_SYMBOLS["bwd"]: 2 * (L_dense + L_moe) + 1,
                "fused_adamw": 1}
        steps = {}
        for mode in ("dense", "quant"):
            for r in recs:
                m = r[f"main_{mode}"]
                calls, nbytes, secs = (sum(v[i] for v in
                                           m["exchanges"].values())
                                       for i in range(3))
                steps[mode, r["rank"]] = m["step_s"]
                ln = {k: v for k, v in m["launches"].items() if v}
                print(f"    (ii) {mode}, rank {r['rank']}: the full config 5 "
                      f"in bf16 ({L} layers, {L_moe} MoE blocks of "
                      f"{MOE5['moe_num_experts']} experts, this rank's "
                      f"{MOE5['moe_num_experts'] // 2}), {EP_MAIN_B} x {EP_S}"
                      f" a rank: step {m['step_s'] * 1e3:.1f} ms host clock "
                      f"over {EP_TIMED} ([16], one process on the two ranks' "
                      f"{2 * EP_MAIN_B} x {EP_S}: {step16_s * 1e3:.1f} ms); "
                      f"losses {[round(v, 4) for v in m['losses']]}; dropped "
                      f"share of this rank's choices in the warm-up step "
                      f"{m['dropped']:.4f} (its tokens queue after the "
                      f"earlier ranks') ({smi})", flush=True)
                print(f"    (ii) {mode}, rank {r['rank']}: exchanges a step "
                      f"{calls:g} calls, {nbytes / 2**20:.2f} MiB received, "
                      f"{secs * 1e3:.1f} ms host clock = "
                      f"{secs / m['step_s']:.3f} of the step; by op "
                      f"{ {k: [round(v[0], 2), round(v[1] / 2**20, 3), round(v[2] * 1e3, 2)] for k, v in m['exchanges'].items()} }"
                      f" (calls, MiB, ms); staged through the host a step "
                      f"{m['staged']}; plan {m['plan']}", flush=True)
                print(f"    (ii) {mode}, rank {r['rank']}: wrapper launches "
                      f"a step {ln}; master copies {m['master_copies']}; the "
                      f"profiled step's kernels {m['profiled']} (as the code "
                      f"gives {want}); flash routes {m['flash_routes']}; "
                      f"peak memory {m['peak_bytes'] / 2**30:.2f} GiB, "
                      f"parameters {m['param_bytes'] / 2**30:.3f} GiB",
                      flush=True)
                check(all(math.isfinite(v) for v in m["losses"])
                      and m["losses"][-1] < m["losses"][0]
                      and m["profiled"] == want
                      and m["launches"].get("fused_adamw_multi") == 1
                      and m["master_copies"] == 0
                      and all(v["wgmma"] == sum(v.values()) > 0
                              for v in m["flash_routes"].values())
                      and calls > 0,
                      f"[21a] (ii) {mode} rank {r['rank']}: {m}")
        dense, quant = recs[0]["main_dense"], recs[0]["main_quant"]
        for mode in ("dense", "quant"):
            print(f"    (ii) {mode}: dropped share of the global batch's "
                  f"choices in the warm-up step "
                  f"{sum(r[f'main_{mode}']['dropped'] for r in recs) / len(recs):.4f}"
                  f" (as many choices a rank)", flush=True)
        d_bytes = sum(v[1] for v in dense["exchanges"].values())
        q_bytes = sum(v[1] for v in quant["exchanges"].values())
        plan = quant["plan"]
        print(f"    (ii) dense against quant, rank 0: exchange bytes a step "
              f"{d_bytes / 2**20:.2f} / {q_bytes / 2**20:.2f} MiB = "
              f"{d_bytes / q_bytes:.3f}x (predicted 1.94x); the plan's wire "
              f"bytes a train step per MoE block "
              f"{plan['bytes_wire_train_step'] / 2**20:.3f} MiB (block "
              f"{plan['block']}, {plan['compression_ratio']:.3f}x of fp32); "
              f"step {dense['step_s'] * 1e3:.1f} / "
              f"{quant['step_s'] * 1e3:.1f} ms ({smi})", flush=True)
        check(dense["plan"] is None and plan is not None and q_bytes < d_bytes,
              f"[21a] (ii): plans {dense['plan']} / {plan}, bytes "
              f"{d_bytes} / {q_bytes}")
        for name in TRAINING_KERNELS:
            rows[name]["launches_ep"] = dense["launches"].get(name, 0)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    print(f"    phase 21a took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return cfg, ref


def ep_four_ranks(K, seed: int, rows, cfg, ref):
    """[21b]: sharding 2 x ep 2 at ``p_g_os``, four ranks sharing the card
    (see ``ep4_worker``): parity with [21a]'s one process, each rank's
    bytes against its, and the one-process restore of their checkpoint."""
    from paddle_tpu_torch.checkpoint import CheckpointManager

    t_phase = time.perf_counter()
    smi = f"{nvidia_smi_line()}, {torch.cuda.device_count()} card(s)"
    work = CHAINED["--ep4-worker"]
    try:
        recs = chained_records(
            "--ep4-worker",
            f"[21b] sharding 2 x ep 2 at p_g_os (config 5's width cut to "
            f"depth 2, fp32; {EP_B // 4} x {EP_S} a rank), four ranks on "
            f"one card", nproc=4)
        params = torch.load(work / "z3_params.pt")
        errs, ok = ep_parity(cfg, ref, recs[0]["losses"], params)
        for r in recs:
            mine = r["param_bytes"] + r["grad_bytes"] + r["opt_bytes"]
            print(f"    rank {r['rank']} ({r['backend']}): losses "
                  f"{r['losses']}; {r['sliced']} parameters held as slices, "
                  f"the expert stacks' (shape, dim) {r['z3']}; parameters, "
                  f"gradients, optimizer state "
                  f"{r['param_bytes'] / 2**20:.1f} + "
                  f"{r['grad_bytes'] / 2**20:.1f} + "
                  f"{r['opt_bytes'] / 2**20:.1f} MiB = "
                  f"{mine / ref['bytes']:.3f} of one process's "
                  f"{ref['bytes'] / 2**20:.1f} MiB; launches "
                  f"{ {k: v for k, v in r['launches'].items() if v} }",
                  flush=True)
            check(r["losses"] == recs[0]["losses"] and r["sliced"] > 0
                  and all(d == 1 for _, d in r["z3"].values())
                  and len(r["z3"]) == 4 and mine < ref["bytes"] / 2
                  and r["launches"]["fused_adamw_multi"] == EP_STEPS,
                  f"[21b] rank {r['rank']}: {r}")
        print(f"    against one process on the whole batch: losses "
              f"{errs[0]:.3e}, gathered global parameters {errs[1]:.3e} "
              f"(tol {DP_LOSS_TOL:g}, {DP_PARAM_TOL:g}), the qkv biases' K "
              f"third {errs[2]:.3e} ({smi})", flush=True)
        check(ok, f"[21b]: {errs} beyond tolerance")
        restored = CheckpointManager(work / "ck").restore()
        rank0 = torch.load(work / "rank0_state.pt")
        flat = dict(restored["params"])
        for name, slots in restored["opt_state"].items():
            flat.update({f"{name}/{k}": v for k, v in slots.items()})
        differ = [k for k, v in rank0.items() if not (
            flat[k].dtype == v.dtype and torch.equal(flat[k], v))]
        print(f"    one-process restore of the four ranks' checkpoint: "
              f"{len(rank0) - len(differ)} of {len(rank0)} tensors bitwise "
              f"equal to the gathered global state", flush=True)
        check(not differ and int(restored["step"]) == EP_STEPS,
              f"[21b]: the restore differs: {differ[:4]}")
        for name in TRAINING_KERNELS:
            rows[name]["launches_ep_z3"] = recs[0]["launches"][name]
    finally:
        shutil.rmtree(work, ignore_errors=True)
        torch.cuda.empty_cache()
    print(f"    phase 21b took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# --------------------------------------------------------------- phase 22
# [22]: GPT-MoE at mp, grad_reduce at ep and resharding, gloo ranks on the
# card, each world size's launcher started once. [22a] runs [21]'s models
# at mp: config 5's width at depth 2 in fp32 on [21a]'s whole EP_B x EP_S
# batch against [21a]'s one process (the mp ranks route the same rows),
# then the full config 5 in bf16 at EP_MAIN_B x EP_S a rank; [22b] [21a]'s
# depth-2 model at ep 2 under fp32 and int8 reductions, each rank routing
# its own rows over the whole stacks, against one process that routes each
# rank's rows alone (``accumulate_steps=2`` on the batch with the ranks'
# rows interleaved, so microbatch m is rank m's rows); [22c] the full
# GPT-3 1.3B at [6]'s configuration and optimizer trained MX_SAVE_STEPS at
# mp 2 (TP_B x TP_S, both ranks on the same rows), saved, and restored
# onto sharding 2 at ``p_g_os`` and onto one process
MX_TIMED, MX_SAVE_STEPS = 3, 1
# [22b]'s reduction repeated on the CPU: the second step's
MX_CHECK_STEP = 1
# the int8 reduction against the fp32 one process, set from the chip's
# readings (H100 80GB HBM3, 700 W): the sound int8 run reads 7.687e-04 on
# the losses, the one process routing the global batch (the route the
# reducer must not take) 2.505e-03 against the local one; the check also
# asks the run's own global-route reading to stay above the bound. On the
# parameters Adam's 2 * steps * lr (the CPU tests' int8 bound)
MX_INT8_LOSS_TOL = 1.5e-3


def mx_blocks(whole, mp_rank: int, mp_n: int, ep_rank: int = 0,
              ep_n: int = 1):
    """This rank's blocks of the whole state: the mp layers' (the qkv
    projection's heads of each of q, k and v) and the expert stacks' ep
    block; the experts whole on every mp rank."""
    from paddle_tpu_torch.distributed.sharding_utils import local_block
    from paddle_tpu_torch.weights import expert_stack, mp_layout

    shapes = {k: tuple(v.shape) for k, v in whole.items()}
    out = {}
    for k, v in whole.items():
        lay = mp_layout(k, shapes)
        if lay is not None:
            v = local_block(v, lay[0], mp_rank, mp_n, lay[1])
        if expert_stack(k):
            v = local_block(v, 0, ep_rank, ep_n)
        out[k] = v.contiguous()
    return out


def mx_model(cfg, blocks, dtype, **opt_kw):
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    model = GPTForCausalLM(cfg, device="cuda", dtype=dtype)
    model.load_state_dict(blocks)
    model.train()
    return model, AdamW(parameters=model.named_parameters(), **opt_kw)


def mx_reduce_run(step, x, y, rows):
    """EP_STEPS steps of a step with a reducer on ``rows``, step
    MX_CHECK_STEP's reduction held on the host and repeated by the same
    reducer on its CPU tensors (reduced gradients and residuals against
    the card's, as [20b])."""
    red = step._reducer
    orig, held, calls = red.reduce, {}, [0]

    def captured(*a, **kw):
        if calls[0] == MX_CHECK_STEP:
            held["in"] = [{k: v.detach().cpu().clone() for k, v in t.items()}
                          if isinstance(t, dict) else
                          None if t is None else t.detach().cpu() for t in a]
        calls[0] += 1
        out = orig(*a, **kw)
        if "in" in held and "out" not in held:
            held["out"] = [{k: v.cpu() for k, v in t.items()} for t in out]
        return out

    red.reduce = captured
    losses = [step(x[k, rows], y[k, rows]).item() for k in range(EP_STEPS)]
    red.reduce = orig
    cpu = orig(*held["in"])
    check_ = {part: diff_dicts(a, b) for part, a, b in (
        ("grads", held["out"][0], cpu[0]),
        ("residuals", held["out"][1], cpu[1]))}
    check_["input_max_abs"] = sum(
        max((float(v.abs().max()) for v in d.values()), default=0.0)
        for d in held["in"][:2])
    return losses, check_


def mx_worker(directory: Path, seed: int) -> int:
    """One rank of [22], started by the port's launcher: two ranks over
    gloo on the one card. [22a] mp 2: (i) config 5's width at depth 2 in
    fp32 as this rank's blocks of the seed's whole model, 3 steps on the
    whole batch, rank 0 keeping the gathered global parameters; (ii) the
    full config 5 in bf16 at EP_MAIN_B x EP_S (both ranks the same rows):
    a warm-up step, MX_TIMED timed (host clock, launches, master copies,
    flash routes) and one profiled. [22b] ep 2: the depth-2 model under
    grad_reduce fp32 and int8, this rank's half of every batch, a
    reduction repeated on the CPU, rank 0 keeping the global parameters.
    [22c] the 1.3B at mp 2 trained and saved; a ``p_g_os`` step at
    sharding 2 restored from the files (the bytes each rank read, every
    block against the saved global arrays' block), rank 0 restoring the
    whole save alone, then the restore from the mp-2 step's live blocks
    through the resharding executor (its plans' bytes, the bytes received,
    bitwise the file path), and one more step on the new layout."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.checkpoint import arrays as ck_arrays
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import resharding as rs
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        group_sharded_parallel)
    from paddle_tpu_torch.models.gpt import GPT3_1p3B, GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg2 = ep_config(num_layers=2)
    whole2 = ep_weights(seed, cfg2, torch.float32)  # before fleet.init
    x, y = ep_batches(seed, cfg2.vocab_size)
    hcg = rank_init({"mp_degree": 2})
    rank, mp_rank = fleet.worker_index(), hcg.get_model_parallel_rank()
    rec = {"rank": rank, "backend": dist.get_backend(), "seconds": {}}
    t_sub = time.perf_counter()

    # [22a] (i): depth 2, fp32, mp 2 on the whole batch
    model, opt = mx_model(cfg2, mx_blocks(whole2, mp_rank, 2),
                          torch.float32, **ep_parity_opt())
    step = fleet.make_sharded_train_step(model, opt, mesh=hcg.get_mesh())
    rec["mp_parity"], _ = ep_parity_run(step, x, y, slice(None), directory,
                                        "mp", rank)
    rec["mp_parity"]["w1"] = list(model.gpt.layers[1].mlp.w1.shape)
    del model, opt, step
    torch.cuda.empty_cache()

    # [22a] (ii): the full config 5 in bf16 at mp 2
    cfg5 = ep_config()
    torch.cuda.reset_peak_memory_stats()
    model = GPTForCausalLM(
        cfg5, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(seed + 16))
    model.train()
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                moment_dtype="bfloat16")
    step = fleet.make_sharded_train_step(model, opt, mesh=hcg.get_mesh())
    g = torch.Generator(device="cuda").manual_seed(seed + 22)
    xm = torch.randint(0, cfg5.vocab_size, (EP_MAIN_B, EP_S), generator=g,
                       device="cuda")
    ym = torch.roll(xm, -1, dims=1)
    losses = [step(xm, ym)]
    K.reset_launch_counts()
    copies0 = opt.master_copies
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(MX_TIMED):
        losses.append(step(xm, ym))
    torch.cuda.synchronize()
    m = {"step_s": (time.perf_counter() - t0) / MX_TIMED,
         "launches": {k: v / MX_TIMED for k, v in K.launch_counts().items()},
         "master_copies": opt.master_copies - copies0,
         "flash_routes": {w: dict(getattr(K, w).route_launches)
                          for w in FLASH_WRAPPERS}}
    kernels = profile_launches(lambda: losses.append(step(xm, ym)))
    m["profiled"] = launches_of(kernels, (
        FWD_SYMBOL, *BWD_SYMBOLS.values(), FP32_FWD_SYMBOL,
        *FP32_BWD_SYMBOLS.values(), NORM_SYMBOLS["fwd"],
        NORM_SYMBOLS["bwd"], "fused_adamw"))
    m["losses"] = [float(v) for v in losses]
    m["peak_bytes"] = torch.cuda.max_memory_allocated()
    m["heads"] = model.gpt.layers[0].attn.num_heads
    rec["mp_main"] = m
    del model, opt, step
    torch.cuda.empty_cache()
    rec["seconds"]["22a"] = time.perf_counter() - t_sub
    t_sub = time.perf_counter()

    # [22b]: grad_reduce at ep 2, each rank's rows routed alone
    hcg = rank_init({"ep_degree": 2})
    ep_r = hcg.get_expert_parallel_rank()
    rows = slice(ep_r * EP_B // 2, (ep_r + 1) * EP_B // 2)
    rec["reduce"] = {}
    for mode in ("fp32", "int8"):
        model, opt = ep_model(cfg2, whole2, torch.float32, ep_r, 2,
                              **ep_parity_opt())
        step = fleet.make_sharded_train_step(model, opt, mesh=hcg.get_mesh(),
                                             grad_reduce=mode)
        K.reset_launch_counts()
        losses, cpu_check = mx_reduce_run(step, x, y, rows)
        r = {"losses": losses, "cpu_check": cpu_check,
             "local": len(step._whole), "launches": K.launch_counts(),
             "stages": [str(a) for a in step._reducer.stage_axes]}
        tree = gathered_state(step)
        if rank == 0:
            torch.save({k: v.detach().cpu() for k, v in tree.params.items()},
                       directory / f"gr_{mode}_params.pt")
        rec["reduce"][mode] = r
        del model, opt, step, tree
        torch.cuda.empty_cache()
    del whole2
    rec["seconds"]["22b"] = time.perf_counter() - t_sub
    t_sub = time.perf_counter()

    # [22c]: the 1.3B saved at mp 2, restored at sharding 2 and whole
    tcfg = GPTConfig(**GPT3_1p3B, dropout=0.0, use_recompute=True,
                     recompute_interval=1, loss_chunk=128)
    hcg = rank_init({"mp_degree": 2})
    model = GPTForCausalLM(
        tcfg, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(seed))
    model.train()
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                multi_precision=True, moment_dtype="bfloat16")
    mp_step = fleet.make_sharded_train_step(model, opt, mesh=hcg.get_mesh())
    g = torch.Generator(device="cuda").manual_seed(seed + 19)
    xt = torch.randint(0, tcfg.vocab_size, (TP_B, TP_S), generator=g,
                       device="cuda")
    yt = torch.roll(xt, -1, dims=1)
    c = {"mp_losses": [mp_step(xt, yt).item() for _ in range(MX_SAVE_STEPS)]}
    t0 = time.perf_counter()
    saved = gathered_state(mp_step).to_tree()
    torch.cuda.synchronize()
    c["gather_s"] = time.perf_counter() - t0
    mgr = CheckpointManager(directory / "ck")
    t0 = time.perf_counter()
    mgr.save(MX_SAVE_STEPS, saved)
    mgr.wait_until_finished()
    c["save_s"] = time.perf_counter() - t0
    c["bytes"] = mgr.manifest(MX_SAVE_STEPS)["bytes_written"]
    hcg2 = rank_init({"sharding_degree": 2})
    model2 = GPTForCausalLM(
        tcfg, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(seed + 1))
    model2.train()
    opt2 = AdamW(learning_rate=1e-4, parameters=model2.named_parameters(),
                 multi_precision=True, moment_dtype="bfloat16")
    model2, opt2, _ = group_sharded_parallel(model2, opt2, level="p_g_os")
    z3 = fleet.make_sharded_train_step(model2, opt2, mesh=hcg2.get_mesh())
    shardings = z3.checkpoint_shardings()
    pos = [int(r) for r in hcg2.get_mesh().devices.reshape(-1)].index(rank)

    def leaves(tree):
        for part in ("params", "opt_state"):
            for n, v in tree[part].items():
                if isinstance(v, dict):
                    for k, w in v.items():
                        yield (part, n, k), w
                else:
                    yield (part, n), v

    def pick(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def block(v):
        return v.block if isinstance(v, rs.ShardedTensor) else v

    def same(a, b) -> bool:
        a, b = torch.as_tensor(block(a)), torch.as_tensor(block(b))
        return a.dtype == b.dtype and a.shape == b.shape \
            and torch.equal(a.cpu(), b.cpu())

    # from the files, onto the stage-3 step's placements: each rank reads
    # its blocks' byte ranges alone (no CRC32 then: the manifest's covers
    # a whole file; the whole restore below checks every file's)
    mgr.validate_on_restore = False
    ck_arrays.reset_read_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    files = mgr.restore(shardings=shardings)
    c["file_s"] = time.perf_counter() - t0
    c["file_read"] = ck_arrays.read_stats()
    mgr.validate_on_restore = True
    block_bytes, differ, sharded, placed = 0, [], 0, True
    for path, leaf in leaves(files):
        whole = pick(saved, path)
        sh = pick(shardings, path)
        if torch.is_tensor(whole) and not sh.is_replicated:
            sharded += 1
            placed &= isinstance(leaf, rs.ShardedTensor) \
                and leaf.sharding == sh
            want = rs.block_of(whole.__getitem__, whole.shape, sh, pos)
        else:
            want = whole
        leaf = torch.as_tensor(block(leaf))
        block_bytes += leaf.numel() * leaf.element_size()
        if not same(leaf, want):
            differ.append("/".join(path))
    c.update(file_block_bytes=block_bytes, file_differ=differ,
             file_sharded=sharded, file_placed=placed)
    # rank 0 alone restores the whole save, as one process does
    if rank == 0:
        ck_arrays.reset_read_stats()
        t0 = time.perf_counter()
        one = mgr.restore()
        c["one_s"] = time.perf_counter() - t0
        c["one_read"] = ck_arrays.read_stats()
        c["one_differ"] = ["/".join(p) for p, leaf in leaves(one)
                           if not same(leaf, pick(saved, p))]
    else:
        one = None
    dist.barrier()
    del saved
    gc.collect()
    torch.cuda.empty_cache()
    # device to device from the mp-2 step's live blocks
    rs.reset_stats()
    ck_arrays.reset_read_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    live = mgr.restore(shardings=shardings, live_state=mp_step.live_state())
    torch.cuda.synchronize()
    c["live_s"] = time.perf_counter() - t0
    c["live_stats"] = rs.stats()
    c["live_read"] = ck_arrays.read_stats()
    got = torch.tensor([c["live_stats"]["bytes_received"]], device="cuda",
                       dtype=torch.float64)
    dist.all_reduce(got)
    c["live_received_all"] = int(got.item())
    c["live_differ"] = ["/".join(p) for p, leaf in leaves(live)
                        if not same(leaf, pick(files, p))]
    c["live_on_card"] = sum(1 for _, leaf in leaves(live)
                            if torch.is_tensor(block(leaf))
                            and block(leaf).is_cuda)
    # [23a] (the next worker of a chained launch) saves this step's state
    # sharded and holds that save to this one: the step, the save's
    # directory and readings, and the stage-3 step stay held for it
    # and the two restores of this save, its whole (rank 0) and its blocks
    # onto the stage-3 step, which the sharded save's must equal
    HELD["mx"] = {"step": mp_step, "gathered": directory / "ck",
                  "gather_s": c["gather_s"], "save_s": c["save_s"],
                  "bytes": c["bytes"], "z3": z3, "whole": one,
                  "files": files}
    del files, one, mp_step, model, opt
    gc.collect()
    torch.cuda.empty_cache()
    z3.restore_from_checkpoint(live)
    del live
    r2 = slice(rank * TP_B // 2, (rank + 1) * TP_B // 2)
    t0 = time.perf_counter()
    c["z3_loss"] = z3(xt[r2], yt[r2]).item()
    c["z3_step_s"] = time.perf_counter() - t0
    c["z3_step_index"] = z3.step_index
    rec["reshard"] = c
    rec["seconds"]["22c"] = time.perf_counter() - t_sub
    (directory / f"rank{rank}.json").write_text(json.dumps(rec))
    return 0


def mx4_worker(directory: Path, seed: int) -> int:
    """One rank of [22a]'s four ranks, started by the port's launcher: ep
    2 x mp 2 over gloo on the one card, config 5's width at depth 2 in
    fp32, this ep rank's half of every batch (the mp ranks the same rows):
    the losses, launches and flash routes; rank 0 keeps the gathered
    global parameters."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import fleet

    cfg2 = ep_config(num_layers=2)
    whole2 = ep_weights(seed, cfg2, torch.float32)
    x, y = ep_batches(seed, cfg2.vocab_size)
    hcg = rank_init({"ep_degree": 2, "mp_degree": 2})
    rank = fleet.worker_index()
    ep_r = hcg.get_expert_parallel_rank()
    model, opt = mx_model(cfg2, mx_blocks(
        whole2, hcg.get_model_parallel_rank(), 2, ep_r, 2), torch.float32,
        **ep_parity_opt())
    del whole2
    step = fleet.make_sharded_train_step(model, opt, mesh=hcg.get_mesh())
    rows = slice(ep_r * EP_B // 2, (ep_r + 1) * EP_B // 2)
    rec, _ = ep_parity_run(step, x, y, rows, directory, "epmp", rank)
    rec.update(rank=rank, backend=dist.get_backend(),
               experts=sorted(step._experts),
               coords=[ep_r, hcg.get_model_parallel_rank()])
    (directory / f"rank{rank}.json").write_text(json.dumps(rec))
    return 0


def mx_local_reference(seed: int):
    """[22b]'s reference, one process on the card: [21a]'s depth-2 fp32
    model, EP_STEPS steps with ``accumulate_steps=2`` on each batch with
    the two ranks' rows interleaved (microbatch m is rank m's rows, routed
    alone at its own capacity)."""
    from paddle_tpu_torch.distributed.fleet import make_sharded_train_step
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = ep_config(num_layers=2)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32)
    model.load_state_dict(ep_weights(seed, cfg, torch.float32))
    model.train()
    opt = AdamW(parameters=model.named_parameters(), **ep_parity_opt())
    step = make_sharded_train_step(model, opt, accumulate_steps=2)
    x, y = ep_batches(seed, cfg.vocab_size)
    half = EP_B // 2
    order = torch.arange(EP_B, device="cuda").view(2, half).t().reshape(-1)
    losses = [step(x[k, order], y[k, order]).item() for k in range(EP_STEPS)]
    ref = {"losses": losses, "params": {
        k: p.detach().cpu() for k, p in model.named_parameters()}}
    del model, opt, step
    torch.cuda.empty_cache()
    return ref


def mx_ranks(K, seed: int, rows, cfg, ref, step16_s):
    """[22] (see ``mx_worker`` and ``mx4_worker``): [22a] GPT-MoE at mp 2
    and ep 2 x mp 2 against [21a]'s one process, and the full config 5 at
    mp 2 (step, launches, flash on wgmma at H 8); [22b] grad_reduce at ep
    2 (the reductions bitwise their CPU repeat, the losses and parameters
    against one process routing each rank's rows alone); [22c] the 1.3B's
    mp-2 save restored at sharding 2 from the files and live, and whole."""
    t_phase = time.perf_counter()
    smi = f"{nvidia_smi_line()}, {torch.cuda.device_count()} card(s)"
    work = CHAINED["--mx-worker"]
    work4 = CHAINED["--mx4-worker"]
    try:
        recs = chained_records("--mx-worker",
                               "[22] GPT-MoE at mp, grad_reduce at ep, "
                               "resharding: two ranks on one card")
        print(f"    [22] seconds in the two ranks' sub-phases "
              f"{ {k: round(v, 1) for k, v in recs[0]['seconds'].items()} }",
              flush=True)
        recs4 = chained_records("--mx4-worker",
                                "[22a] GPT-MoE at ep 2 x mp 2: four ranks on "
                                "one card", nproc=4)
        # [22a] parity: mp 2 and ep 2 x mp 2 against one process
        for tag, rs_, what, wd in (
                ("mp", [r["mp_parity"] for r in recs], "mp 2", work),
                ("epmp", recs4, "ep 2 x mp 2", work4)):
            params = torch.load(wd / f"{tag}_params.pt")
            errs, ok = ep_parity(cfg, ref, rs_[0]["losses"], params)
            for r in rs_:
                print(f"    [22a] {what}: losses {r['losses']}; launches "
                      f"over the steps "
                      f"{ {k: v for k, v in r['launches'].items() if v} }; "
                      f"flash routes {r['flash_routes']}", flush=True)
                check(r["losses"] == rs_[0]["losses"]
                      and all(v["cuda_cores"] == sum(v.values()) > 0
                              for v in r["flash_routes"].values())
                      and r["launches"]["fused_adamw_multi"] == EP_STEPS,
                      f"[22a] {what}: {r}")
            print(f"    [22a] {what} against one process on the whole batch"
                  f": losses {errs[0]:.3e}, gathered global parameters "
                  f"{errs[1]:.3e}, the qkv biases' K third {errs[2]:.3e} "
                  f"(tol {DP_LOSS_TOL:g}, {DP_PARAM_TOL:g}, "
                  f"{2 * EP_STEPS * DP_LR:g}) ({smi})", flush=True)
            check(ok, f"[22a] {what}: {errs} beyond tolerance")
            del params
        E = MOE5["moe_num_experts"]
        check(all(r["mp_parity"]["w1"][0] == E for r in recs)
              and all(len(r["experts"]) == 4 for r in recs4),
              "[22a]: the experts are not whole over mp and split over ep")
        # [22a] (ii): the full config 5 at mp 2
        L = MOE5["num_layers"]
        L_moe = L // MOE5["moe_every_k"]
        L_dense = L - L_moe
        want = {FWD_SYMBOL: 2 * L_dense + L_moe,
                BWD_SYMBOLS["dq"]: L_dense + L_moe,
                BWD_SYMBOLS["dkv"]: L_dense + L_moe,
                FP32_FWD_SYMBOL: 0, FP32_BWD_SYMBOLS["dq"]: 0,
                FP32_BWD_SYMBOLS["dkv"]: 0,
                NORM_SYMBOLS["fwd"]: 4 * L_dense + 2 * L_moe + 1,
                NORM_SYMBOLS["bwd"]: 2 * (L_dense + L_moe) + 1,
                "fused_adamw": 1}
        for r in recs:
            m = r["mp_main"]
            ln = {k: v for k, v in m["launches"].items() if v}
            print(f"    [22a] (ii) rank {r['rank']} ({r['backend']}): the "
                  f"full config 5 in bf16 at mp 2 ({m['heads']} heads a "
                  f"rank), {EP_MAIN_B} x {EP_S} a rank: step "
                  f"{m['step_s'] * 1e3:.1f} ms host clock over {MX_TIMED} "
                  f"([16], one process on {2 * EP_MAIN_B} x {EP_S}: "
                  f"{step16_s * 1e3:.1f} ms); losses "
                  f"{[round(v, 4) for v in m['losses']]}; wrapper launches "
                  f"a step {ln}; master copies {m['master_copies']}; the "
                  f"profiled step's kernels {m['profiled']} (as the code "
                  f"gives {want}); flash routes {m['flash_routes']}; peak "
                  f"memory {m['peak_bytes'] / 2**30:.2f} GiB ({smi})",
                  flush=True)
            check(all(math.isfinite(v) for v in m["losses"])
                  and m["losses"][-1] < m["losses"][0]
                  and m["profiled"] == want and m["heads"] == 8
                  and m["launches"].get("fused_adamw_multi") == 1
                  and m["master_copies"] == 0
                  and all(v["wgmma"] == sum(v.values()) > 0
                          for v in m["flash_routes"].values()),
                  f"[22a] (ii) rank {r['rank']}: {m}")
        for name in TRAINING_KERNELS:
            rows[name]["launches_moe_mp"] = \
                recs[0]["mp_main"]["launches"].get(name, 0)

        # [22b]: grad_reduce at ep 2 against one process routing alone
        local = mx_local_reference(seed)
        routing_gap = max(abs(a - b) for a, b in zip(ref["losses"],
                                                     local["losses"]))
        print(f"    [22b] one process, each rank's rows routed alone "
              f"(accumulate_steps 2): losses {local['losses']}; the global "
              f"route's ([21a]'s one process) {routing_gap:.3e} from them "
              f"(above the int8 bound {MX_INT8_LOSS_TOL:g}: "
              f"{routing_gap > MX_INT8_LOSS_TOL})", flush=True)
        check(routing_gap > MX_INT8_LOSS_TOL, f"[22b] the int8 bound "
              f"{MX_INT8_LOSS_TOL:g} does not tell the global route "
              f"({routing_gap:.3e}) from the local one")
        for mode in ("fp32", "int8"):
            params = torch.load(work / f"gr_{mode}_params.pt")
            errs = parity_errors(cfg, local, recs[0]["reduce"][mode]["losses"],
                                 params)
            rel = max(abs(a - b) / abs(b) for a, b in zip(
                recs[0]["reduce"][mode]["losses"], local["losses"]))
            ok = parity_ok(errs) if mode == "fp32" else (
                errs[0] <= MX_INT8_LOSS_TOL
                and max(errs[1:]) <= 2 * EP_STEPS * DP_LR)
            for r in recs:
                g = r["reduce"][mode]
                cc = g["cpu_check"]
                tol = 2.0 ** -20 * cc["input_max_abs"]
                print(f"    [22b] {mode}, rank {r['rank']}: losses "
                      f"{g['losses']}; {g['local']} expert stacks routed "
                      f"locally, reduced over {g['stages']}; step "
                      f"{MX_CHECK_STEP}'s reduction on the CPU: "
                      + "; ".join(f"{p} {cc[p]['differ']} of {cc[p]['of']} "
                                  f"entries differ (largest "
                                  f"{cc[p]['max_abs_err']:.3e})"
                                  for p in ("grads", "residuals"))
                      + f" (residual tol {tol:.3e})", flush=True)
                check(g["losses"] == recs[0]["reduce"][mode]["losses"]
                      and g["local"] == 4 and cc["grads"]["differ"] == 0
                      and cc["grads"]["max_abs"] > 0
                      and cc["residuals"]["max_abs_err"] <= tol
                      and g["launches"]["fused_adamw_multi"] == EP_STEPS,
                      f"[22b] {mode} rank {r['rank']}: {g}")
            bounds = (f"{DP_LOSS_TOL:g}, {DP_PARAM_TOL:g}" if mode == "fp32"
                      else f"{MX_INT8_LOSS_TOL:g}, "
                      f"{2 * EP_STEPS * DP_LR:g}")
            print(f"    [22b] {mode} against the one process: losses "
                  f"{errs[0]:.3e} (rel {rel:.2e}), gathered global "
                  f"parameters {errs[1]:.3e},"
                  f" the qkv biases' K third {errs[2]:.3e} (tol {bounds}) "
                  f"({smi})", flush=True)
            check(ok, f"[22b] {mode}: {errs} beyond tolerance")
            del params

        # [22c]: the 1.3B's save restored at sharding 2, whole and live
        for r in recs:
            c = r["reshard"]
            st = c["live_stats"]
            print(f"    [22c] rank {r['rank']}: the 1.3B at mp 2 (losses "
                  f"{c['mp_losses']}), global state gathered in "
                  f"{c['gather_s']:.2f} s and saved ({c['bytes'] / 1e9:.3f} "
                  f"GB) in {c['save_s']:.2f} s; restored from the files "
                  f"onto sharding 2 at p_g_os in {c['file_s']:.2f} s: "
                  f"{c['file_sharded']} sharded leaves, read "
                  f"{c['file_read']['bytes'] / 1e9:.4f} GB in "
                  f"{c['file_read']['ranges']} ranges against its blocks' "
                  f"{c['file_block_bytes'] / 1e9:.4f} GB, "
                  f"{len(c['file_differ'])} leaves differing from the saved "
                  f"global arrays' blocks ({smi})", flush=True)
            print(f"    [22c] rank {r['rank']}: live from the mp-2 blocks "
                  f"in {c['live_s']:.2f} s through the executor: "
                  f"{st['plans']} plans ({st['steps']} steps), "
                  f"{c['live_read']['live']} leaves moved and "
                  f"{c['live_read']['files']} read "
                  f"({c['live_read']['bytes'] / 1e9:.4f} GB; the move "
                  f"{st['seconds']:.2f} s); received "
                  f"{st['bytes_received'] / 1e9:.4f} GB here, "
                  f"{c['live_received_all'] / 1e9:.4f} GB over both ranks "
                  f"against the plans' bytes_wire {st['bytes_wire'] / 1e9:.4f}"
                  f" GB (bytes_naive {st['bytes_naive'] / 1e9:.4f} GB, "
                  f"{st['bytes_naive'] / max(st['bytes_wire'], 1):.2f}x); "
                  f"gathered and sliced {st['assembled']} ({st['reasons']});"
                  f" {len(c['live_differ'])} leaves differing from the file "
                  f"path; one more step on the new layout: loss "
                  f"{c['z3_loss']:.4f} in {c['z3_step_s']:.2f} s ({smi})",
                  flush=True)
            check(not c["file_differ"] and c["file_sharded"] > 0
                  and c["file_placed"]
                  and c["file_read"]["bytes"] == c["file_block_bytes"]
                  and 2 * c["file_block_bytes"] <= 1.01 * c["bytes"]
                  and not c["live_differ"] and st["plans"] > 0
                  and st["assembled"] == 0
                  and c["live_received_all"] == st["bytes_wire"] > 0
                  and math.isfinite(c["z3_loss"])
                  and c["z3_step_index"] == MX_SAVE_STEPS + 1,
                  f"[22c] rank {r['rank']}: {c}")
        c0 = recs[0]["reshard"]
        print(f"    [22c] rank 0 alone, the whole save as one process: "
              f"{c0['one_read']['bytes'] / 1e9:.4f} GB read in "
              f"{c0['one_s']:.2f} s ({c0['one_read']['bytes'] / 1e9 / c0['one_s']:.2f}"
              f" GB/s, the page cache warm from the save), "
              f"{len(c0['one_differ'])} leaves differing from the saved "
              f"global arrays ({smi})", flush=True)
        check(not c0["one_differ"]
              and c0["one_read"]["bytes"] == c0["bytes"],
              f"[22c] the whole restore: {c0['one_differ'][:4]}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(work4, ignore_errors=True)
        torch.cuda.empty_cache()
    print(f"    phase 22 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# [23]: serving a split model and the sharded save, gloo ranks on the card
# in [22]'s launcher starts. [23a] saves [22c]'s mp-2 step of the full
# GPT-3 1.3B sharded (each rank its replica-0 blocks, no collective) and
# holds that save to [22c]'s gathered one: restored whole on rank 0, and
# onto [22c]'s stage-3 step at sharding 2, bitwise. [23b] serves the 1.3B
# at mp 2 through the paged engine ([4]'s slots, S_max, page and
# requests), its weights moved device to device from the stage-3 step's
# live blocks. [23c] the 1.3B's width at mp 2 and config 5's at ep 2 (and
# at ep 2 x mp 2 on four ranks), depth 2, fp32, through the paged engine
# with the prefix cache and speculation, the dense engine and generate,
# against one process on the card, the weights from a sharded save.
# [23d] a MoELayer at ep 2 under grad_reduce fp32 and int8 (A5.4d), a
# reduction repeated on the CPU as [22b]'s
SPLIT_SLOTS, SPLIT_SMAX = 8, 2048
# [23b]'s split prefill logits against one process's on the same bf16
# weights: the mp ranks' partial products are rounded to bf16 before
# their all-reduce sums them, where one process rounds the whole sum
# once, so the two differ by a few bf16 roundings (2^-8 relative) of each
# layer's output; over 24 layers' residual stream that is a few percent
# of the logits' scale: 1/16 of the largest |logit| is the bound
SPLIT_LOGIT_TOL = 1 / 16
# [23c]: 4 slots of SPLIT_D2_SMAX positions, SPLIT_D2_NEW new tokens
SPLIT_D2_SLOTS, SPLIT_D2_SMAX, SPLIT_D2_NEW = 4, 256, 12
# [23d]: the MoELayer (config 5's FFN width, its 8 experts) and its batch
SPLIT_LAYER_B, SPLIT_LAYER_S = 8, 256
# the tensor collectives of torch.distributed, barriers aside
DIST_COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
                    "reduce_scatter_tensor", "all_to_all_single",
                    "all_to_all", "broadcast", "send", "recv", "isend",
                    "irecv", "reduce", "gather", "scatter")


class DistCalls:
    """The calls of ``torch.distributed``'s tensor collectives while it is
    entered (the port's modules look them up there at call time)."""

    def __enter__(self):
        import torch.distributed as tdist

        self.calls, self._saved = [], {}
        for name in DIST_COLLECTIVES:
            fn = getattr(tdist, name, None)
            if fn is None:
                continue
            self._saved[name] = fn

            def counted(*a, _fn=fn, _name=name, **kw):
                self.calls.append(_name)
                return _fn(*a, **kw)

            setattr(tdist, name, counted)
        return self

    def __exit__(self, *exc):
        import torch.distributed as tdist

        for name, fn in self._saved.items():
            setattr(tdist, name, fn)


def served_prompts(rng, vocab: int):
    """[4]'s requests drawn from ``rng`` (a CPU generator seeded with the
    seed): a 64-token warm-up prompt, and 16 prompts of 128 tokens and of
    300-700 tokens, alternately."""
    warm = torch.randint(0, vocab, (64,), generator=rng).tolist()
    lengths = [128 if i % 2 == 0 else
               int(torch.randint(300, 701, (1,), generator=rng))
               for i in range(16)]
    prompts = [torch.randint(0, vocab, (n,), generator=rng).tolist()
               for n in lengths]
    return warm, lengths, prompts


def split_prompts(seed: int, vocab: int):
    """[23c]'s six prompts: four share a 48-token prefix, two of them a
    repeated 8-token phrase (drafts get accepted)."""
    g = torch.Generator().manual_seed(seed + 23)

    def draw(n):
        return torch.randint(0, vocab, (n,), generator=g).tolist()

    prefix, phrase = draw(48), draw(8)
    return [prefix + phrase * 3, prefix + draw(20), draw(30),
            prefix + phrase * 2 + draw(5), prefix + draw(9), draw(70)]


def sharded_params(eng):
    """The served parameters as a checkpoint tree: each split one a
    ``ShardedTensor`` of this rank's block and its placement
    (``Engine.shardings()``), each whole one the tensor."""
    from paddle_tpu_torch.distributed.resharding import ShardedTensor

    own = eng.shardings()
    return {n: p.detach() if own[n].is_replicated
            else ShardedTensor(p.detach(), own[n])
            for n, p in eng.model.state_dict(keep_vars=True).items()}


def d2_engines(model, prompts, load=None):
    """[23c]'s runs of ``model`` (fp32, depth 2): the paged engine with
    the prefix cache and speculation (greedy, then sampled from a
    generator seeded alike on every rank), the dense engine (greedy),
    ``generate`` greedy and sampled. ``load`` (a function of the first
    engine) loads the weights. Each run's tokens, and the slot table after
    every step of the first."""
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    greedy = SamplingParams(max_new_tokens=SPLIT_D2_NEW)
    sampled = SamplingParams(max_new_tokens=SPLIT_D2_NEW, do_sample=True,
                             temperature=0.8, top_k=50)
    out = {}
    for name, kw, sp in (("spec", dict(prefix_cache=True, speculative=3),
                          greedy),
                         ("sampled", dict(prefix_cache=True, speculative=3),
                          sampled),
                         ("dense", dict(kv_layout="dense"), greedy)):
        eng = Engine(model, EngineConfig(max_batch_size=SPLIT_D2_SLOTS,
                                         max_seq_len=SPLIT_D2_SMAX, **kw),
                     device="cuda")
        if load is not None:
            load(eng)
            load = None
        reqs = [eng.add_request(p, sp) for p in prompts]
        slots = []
        while eng.has_unfinished:
            eng.step()
            slots.append([None if r is None else reqs.index(r)
                          for r in eng._slots])
        out[name] = {"tokens": [r.output_ids for r in reqs],
                     "slots": slots, "hits": sum(
                         r.prefix_hit_blocks > 0 for r in reqs),
                     "accepted": eng.spec_accepted,
                     "captures": sum(st.captures for st in eng.steps.values()),
                     "eager": sum(st.eager_steps for st in eng.steps.values())}
        del eng
    ids = torch.tensor([p[:16] for p in prompts[:4]], device="cuda")
    out["generate"] = model.generate(ids, max_new_tokens=SPLIT_D2_NEW
                                     ).tolist()
    out["generate_sampled"] = model.generate(
        ids, max_new_tokens=SPLIT_D2_NEW, do_sample=True, top_k=50,
        generator=torch.Generator(device="cuda").manual_seed(23)).tolist()
    model._generate_state = None
    return out


def d2_split(cfg, whole, prompts, directory: Path, tag: str):
    """[23c] on the current topology: ``cfg``'s model split over it, its
    weights from a sharded save of the same model (``whole`` loaded whole
    into it by ``load_weights``, saved as ``sharded_params``, the
    parameters zeroed, the save restored onto ``Engine.shardings()`` and
    loaded), through ``d2_engines``."""
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.models.gpt import GPTForCausalLM

    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32)
    model.eval()
    mgr = CheckpointManager(directory / f"{tag}_ck")
    info = {}

    def load(eng):
        eng.load_weights(whole)
        with DistCalls() as calls:
            mgr.save(0, {"params": sharded_params(eng)})
            mgr.wait_until_finished()
        info.update(save_collectives=len(calls.calls),
                    save_bytes=mgr.last_save["bytes"])
        with torch.no_grad():
            for p in model.parameters():
                p.zero_()
        own = eng.shardings()
        tree = mgr.restore(shardings={"params": own})
        eng.load_weights(tree["params"], shardings=own)

    out = d2_engines(model, prompts, load)
    out.update(info, kv_heads=model.local_kv_heads,
               w1=list(model.gpt.layers[-1].mlp.w1.shape)
               if cfg.moe_num_experts else None)
    mgr.close()
    del model
    torch.cuda.empty_cache()
    return out


def moe_layer_reduce(seed: int, hcg, rank: int):
    """[23d]: a MoELayer(group=) of config 5's FFN width, its ep rank's
    experts of 8 drawn from the seed, trained EP_STEPS steps on the mean
    square of its output under grad_reduce fp32 and int8, each rank on its
    half of every batch; step MX_CHECK_STEP's reduction repeated on the
    CPU (``mx_reduce_run``)."""
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.incubate.distributed.models.moe import (ExpertMLP,
                                                                  MoELayer)
    from paddle_tpu_torch.optimizer import AdamW

    cfg = ep_config()
    d, f, E = cfg.hidden_size, cfg.intermediate_size, cfg.moe_num_experts
    ep_r, n = hcg.get_expert_parallel_rank(), E // 2
    g = torch.Generator(device="cuda").manual_seed(seed + 234)
    gate = torch.randn(d, E, generator=g, device="cuda") * 0.02
    experts = [[torch.randn(*shape, generator=g, device="cuda") * 0.02
                for shape in ((d, f), (f,), (f, d), (d,))] for _ in range(E)]
    x = torch.randn(EP_STEPS, SPLIT_LAYER_B, SPLIT_LAYER_S, d, generator=g,
                    device="cuda")
    rows = slice(ep_r * SPLIT_LAYER_B // 2, (ep_r + 1) * SPLIT_LAYER_B // 2)
    out = {}
    for mode in ("fp32", "int8"):
        mine = [ExpertMLP(d, f, activation="gelu", device="cuda")
                for _ in range(n)]
        layer = MoELayer(d, mine, group=hcg.get_expert_parallel_group(),
                         device="cuda")
        with torch.no_grad():
            layer.gate_weight.copy_(gate)
            for i, e in enumerate(mine):
                w1, b1, w2, b2 = experts[ep_r * n + i]
                e.fc1.weight.copy_(w1)
                e.fc1.bias.copy_(b1)
                e.fc2.weight.copy_(w2)
                e.fc2.bias.copy_(b2)
        net = torch.nn.Sequential(layer)
        step = fleet.make_sharded_train_step(
            net, AdamW(learning_rate=DP_LR, epsilon=1e-6, weight_decay=0.01,
                       parameters=net.named_parameters()),
            loss_fn=lambda o, y: o.float().square().mean(),
            mesh=hcg.get_mesh(), grad_reduce=mode)
        K.reset_launch_counts()
        losses, cpu_check = mx_reduce_run(step, x, x, rows)
        out[mode] = {"losses": losses, "cpu_check": cpu_check,
                     "reduced": len(step._whole_experts),
                     "launches": K.launch_counts()}
        del net, layer, step
        torch.cuda.empty_cache()
    return out


def split_worker(directory: Path, seed: int) -> int:
    """One rank of [23], chained after [22]'s worker in its launch (two
    ranks over gloo on the one card). Before any topology: rank 0 builds
    the whole 1.3B (bf16), and the depth-2 fp32 models of the 1.3B's and
    config 5's width serve [23c]'s requests as one process on the card.
    [23a] [22c]'s mp-2 step saved sharded, the save against [22c]'s
    gathered one; [23b] the 1.3B at mp 2 served, its weights from the
    stage-3 step's live blocks, rank 0 also serving them whole; [23c] the
    depth-2 models at mp 2 and at ep 2; [23d] a MoELayer at ep 2 under
    grad_reduce. Without [22]'s worker before it in the process, it takes
    [22c]'s step and gathered save itself."""
    import shutil

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.checkpoint import arrays as ck_arrays
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed import resharding as rs
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        group_sharded_parallel)
    from paddle_tpu_torch.models.gpt import GPT3_1p3B, GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    import os

    rank = int(os.environ["PADDLE_TRAINER_ID"])
    rec = {"rank": rank, "seconds": {}}
    t_sub = time.perf_counter()
    scfg = GPTConfig(**GPT3_1p3B)
    one = GPTForCausalLM(scfg, device="cuda", dtype=torch.bfloat16) \
        if rank == 0 else None
    # [23c]'s one process on the card, before any topology
    d2 = {"mp": GPTConfig(**{**GPT3_1p3B, "num_layers": 2}),
          "ep": ep_config(num_layers=2)}
    d2_prompts, d2_whole, d2_one = {}, {}, {}
    for tag, cfg in d2.items():
        d2_whole[tag] = ep_weights(seed + 23, cfg, torch.float32)
        d2_prompts[tag] = split_prompts(seed, cfg.vocab_size)
        model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32)
        model.load_state_dict(d2_whole[tag])
        model.eval()
        d2_one[tag] = d2_engines(model, d2_prompts[tag])
        del model
    rec["d2_one"] = d2_one
    torch.cuda.empty_cache()

    # [23a]: the 1.3B's mp-2 step saved sharded
    held = HELD.pop("mx", None)
    tcfg = GPTConfig(**GPT3_1p3B, dropout=0.0, use_recompute=True,
                     recompute_interval=1, loss_chunk=128)
    a = {"held": held is not None}
    if held is None:  # [22c]'s step and gathered save, taken again
        hcg = rank_init({"mp_degree": 2})
        model = GPTForCausalLM(
            tcfg, device="cuda", dtype=torch.bfloat16,
            generator=torch.Generator(device="cuda").manual_seed(seed))
        model.train()
        opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                    multi_precision=True, moment_dtype="bfloat16")
        mp_step = fleet.make_sharded_train_step(model, opt,
                                                mesh=hcg.get_mesh())
        g = torch.Generator(device="cuda").manual_seed(seed + 19)
        xt = torch.randint(0, tcfg.vocab_size, (TP_B, TP_S), generator=g,
                           device="cuda")
        for _ in range(MX_SAVE_STEPS):
            mp_step(xt, torch.roll(xt, -1, dims=1))
        t0 = time.perf_counter()
        saved = gathered_state(mp_step).to_tree()
        torch.cuda.synchronize()
        gather_s = time.perf_counter() - t0
        mgr = CheckpointManager(directory / "gathered")
        mgr.save(MX_SAVE_STEPS, saved)
        mgr.wait_until_finished()
        held = {"step": mp_step, "gathered": directory / "gathered",
                "gather_s": gather_s,
                "save_s": time.perf_counter() - t0 - gather_s,
                "bytes": mgr.manifest(MX_SAVE_STEPS)["bytes_written"]}
        mgr.close()
        del saved, model, opt
        hcg2 = rank_init({"sharding_degree": 2})
        model2 = GPTForCausalLM(tcfg, device="cuda", dtype=torch.bfloat16)
        model2.train()
        opt2 = AdamW(learning_rate=1e-4, parameters=model2.named_parameters(),
                     multi_precision=True, moment_dtype="bfloat16")
        model2, opt2, _ = group_sharded_parallel(model2, opt2,
                                                 level="p_g_os")
        held["z3"] = fleet.make_sharded_train_step(model2, opt2,
                                                   mesh=hcg2.get_mesh())
    mp_step, z3, gathered_dir = held["step"], held["z3"], held["gathered"]
    # [22c]'s restores of its gathered save, whole on rank 0 and onto the
    # stage-3 step (None when it did not run in this process: read below)
    held_whole, held_files = held.get("whole"), held.get("files")
    a.update(gather_s=held["gather_s"], gathered_save_s=held["save_s"],
             gathered_bytes=held["bytes"])
    mgr = CheckpointManager(directory / "sharded")
    mgr_g = CheckpointManager(gathered_dir)
    torch.cuda.synchronize()
    with DistCalls() as calls:
        t0 = time.perf_counter()
        tree = mp_step.state_for_checkpoint().to_tree()
        mgr.save(MX_SAVE_STEPS, tree)
        a["blocking_s"] = time.perf_counter() - t0
        mgr.wait_until_finished()
        a["total_s"] = time.perf_counter() - t0
    a["collectives"] = calls.calls
    a["bytes"] = mgr.last_save["bytes"]
    leaves = [v for part in ("params", "opt_state")
              for v in ck_arrays.flatten_tree(tree[part]).values()]
    a["sharded"] = sum(isinstance(v, rs.ShardedTensor) for v in leaves)
    a["block_bytes"] = sum(tensor_bytes([v.block]) for v in leaves
                           if isinstance(v, rs.ShardedTensor))
    a["whole_bytes"] = sum(
        tensor_bytes([torch.as_tensor(np.asarray(v))
                      if not torch.is_tensor(v) else v])
        for v in leaves if not isinstance(v, rs.ShardedTensor)
        and v is not None and not isinstance(v, (int, float, str)))
    del tree, leaves
    HELD.pop("mx", None)
    del held
    mp_step = None
    gc.collect()
    torch.cuda.empty_cache()

    def flat(tree):
        return {k: v for k, v in ck_arrays.flatten_tree(tree).items()
                if torch.is_tensor(v) or isinstance(v, rs.ShardedTensor)}

    def bits(v):
        v = v.block if isinstance(v, rs.ShardedTensor) else v
        return v.cpu().contiguous().view(torch.uint8) if v.dim() else \
            v.cpu().reshape(1).view(torch.uint8)

    # rank 0 restores both saves whole, as one process does
    if rank == 0:
        t0 = time.perf_counter()
        mine = flat(mgr.restore())
        a["whole_s"] = time.perf_counter() - t0
        theirs = flat(held_whole if held_whole is not None
                      else mgr_g.restore())
        del held_whole
        a["whole_leaves"] = len(mine)
        a["whole_differ"] = sorted(k for k in theirs if k not in mine
                                   or not torch.equal(bits(mine[k]),
                                                      bits(theirs[k])))[:8]
        del mine, theirs
        gc.collect()
    dist.barrier()
    # each rank's blocks onto the stage-3 step's placements, from both
    # saves' byte ranges
    shardings = z3.checkpoint_shardings()
    mgr.validate_on_restore = mgr_g.validate_on_restore = False
    ck_arrays.reset_read_stats()
    t0 = time.perf_counter()
    mine = mgr.restore(shardings=shardings)
    a["z3_s"] = time.perf_counter() - t0
    a["z3_read"] = ck_arrays.read_stats()
    theirs = flat(held_files if held_files is not None
                  else mgr_g.restore(shardings=shardings))
    del held_files
    fm = flat(mine)
    a["z3_leaves"] = len(fm)
    a["z3_differ"] = sorted(k for k in theirs if k not in fm
                            or not torch.equal(bits(fm[k]), bits(theirs[k])))
    del theirs, fm
    z3.restore_from_checkpoint(mine)
    del mine
    mgr.close()
    mgr_g.close()
    dist.barrier()
    if rank == 0:  # two 13.2 GB saves do not stay on the disk
        shutil.rmtree(directory / "sharded", ignore_errors=True)
        shutil.rmtree(gathered_dir, ignore_errors=True)
    rec["save"] = a
    gc.collect()
    torch.cuda.empty_cache()
    rec["seconds"]["23a"] = time.perf_counter() - t_sub
    t_sub = time.perf_counter()

    # [23b]: the 1.3B at mp 2 served, the weights from the stage-3 step
    hcg = rank_init({"mp_degree": 2})
    model = GPTForCausalLM(scfg, device="cuda", dtype=torch.bfloat16)
    eng = Engine(model, EngineConfig(max_batch_size=SPLIT_SLOTS,
                                     max_seq_len=SPLIT_SMAX), device="cuda")
    b = {"captured": eng.captured, "heads": model.gpt.layers[0].attn.num_heads,
         "kv_bytes": eng.cache.nbytes,
         "param_bytes": tensor_bytes(model.parameters())}
    live = z3.live_state()["params"]
    rs.reset_stats()
    torch.cuda.synchronize()
    dist.barrier()  # both ranks start the move's clock together
    t0 = time.perf_counter()
    eng.load_weights(live, shardings=eng.shardings())
    torch.cuda.synchronize()
    b["load_s"] = time.perf_counter() - t0
    st = rs.stats()
    got = torch.tensor([st["bytes_received"]], device="cuda",
                       dtype=torch.float64)
    dist.all_reduce(got)
    b.update(received=st["bytes_received"], received_all=int(got.item()),
             wire=st["bytes_wire"], naive=st["bytes_naive"],
             plans=st["plans"], assembled=st["assembled"])
    whole = rs.gather_tree(live)  # explicit: rank 0's one process
    del live, z3
    gc.collect()
    torch.cuda.empty_cache()
    warm, lengths, prompts = served_prompts(
        torch.Generator().manual_seed(seed), scfg.vocab_size)
    buckets = sorted({eng._bucket(n) for n in [len(warm)] + lengths})
    eng.generate([warm * (T // len(warm)) for T in buckets],
                 SamplingParams(max_new_tokens=4))
    sp = SamplingParams(max_new_tokens=32)
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reqs = [eng.add_request(p, sp) for p in prompts]
    while eng.has_unfinished:
        eng.step()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    outs = [r.output_ids for r in reqs]
    ttft, tpot = request_latencies(reqs)
    b.update(tokens=outs, wall_s=wall, ttft_ms=ttft, tpot_ms=tpot,
             tokens_per_s=sum(map(len, outs)) / wall,
             captures=sum(s.captures for s in eng.steps.values()),
             eager=sum(s.eager_steps for s in eng.steps.values()),
             launches=K.launch_counts(),
             routes={"flash": dict(K.flash_attention_fwd.route_launches),
                     "paged": dict(K.paged_attention.route_launches)})
    # collectives of a decode step with every slot live: 8 requests
    # admitted by one step, then 8 decode steps timed
    for p in prompts[:SPLIT_SLOTS]:
        eng.add_request(p[:128], SamplingParams(max_new_tokens=10))
    eng.step()
    tally, restore = count_collectives()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(8):
        eng.step()
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 8
    restore()
    b.update(decode_step_ms=step_s * 1e3, decode_collectives=tally["calls"] / 8,
             decode_collective_ms=tally["seconds"] / 8 * 1e3)
    while eng.has_unfinished:
        eng.step()
    # the profiler on one step that prefills a request and decodes it
    eng.add_request(prompts[1], SamplingParams(max_new_tokens=3))
    K.reset_launch_counts()
    kernels = profile_launches(eng.step)
    b["profiled"] = launches_of(kernels, (
        FWD_SYMBOL, FP32_FWD_SYMBOL, NORM_SYMBOLS["fwd"],
        *PAGED_SYMBOLS.values()))
    b["profiled_wrappers"] = K.launch_counts()
    b["profiled_routes"] = {
        "flash": dict(K.flash_attention_fwd.route_launches),
        "paged": dict(K.paged_attention.route_launches)}
    while eng.has_unfinished:
        eng.step()
    # the first request's prefill logits, split, and on rank 0 whole
    n0 = len(prompts[0])
    ids = torch.tensor([prompts[0]], device="cuda")
    with torch.no_grad():
        split_logits = model.prefill_with_cache(ids)[0].float()
    if rank == 0:
        one.load_state_dict(whole)
        one.eval()
        with torch.no_grad():
            want = one.prefill_with_cache(ids)[0].float()
        b["logit_err"] = float((split_logits - want).abs().max())
        b["logit_scale"] = float(want.abs().max())
        b["argmax_equal"] = int(split_logits.argmax()) == int(want.argmax())
        one_eng = Engine(one, EngineConfig(max_batch_size=SPLIT_SLOTS,
                                           max_seq_len=SPLIT_SMAX),
                         device="cuda")
        one_outs = one_eng.generate(prompts, sp)
        b["one_kv_bytes"] = one_eng.cache.nbytes
        b["one_param_bytes"] = tensor_bytes(one.parameters())
        b["equal_share"] = sum(x == y for o, w in zip(outs, one_outs)
                               for x, y in zip(o, w)) / sum(map(len, outs))
        del one_eng
    del one, whole
    b["n0"] = n0
    rec["serve"] = b
    dist.barrier()
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    rec["seconds"]["23b"] = time.perf_counter() - t_sub
    t_sub = time.perf_counter()

    # [23c]: depth 2, fp32, at mp 2 and at ep 2
    rank_init({"mp_degree": 2})
    rec["d2_mp"] = d2_split(d2["mp"], d2_whole["mp"], d2_prompts["mp"],
                            directory, "mp")
    hcg = rank_init({"ep_degree": 2})
    rec["d2_ep"] = d2_split(d2["ep"], d2_whole["ep"], d2_prompts["ep"],
                            directory, "ep")
    rec["seconds"]["23c"] = time.perf_counter() - t_sub
    t_sub = time.perf_counter()

    # [23d]: a MoELayer's experts under grad_reduce at ep 2
    rec["layer"] = moe_layer_reduce(seed, hcg, rank)
    rec["seconds"]["23d"] = time.perf_counter() - t_sub
    (directory / f"rank{rank}.json").write_text(json.dumps(rec))
    return 0


def split4_worker(directory: Path, seed: int) -> int:
    """One rank of [23c]'s four ranks, chained after [22a]'s in their
    launch: config 5's width at depth 2 in fp32 at ep 2 x mp 2 through
    ``d2_split`` (the one process's tokens are the two-rank chain's)."""
    import os

    rank = int(os.environ["PADDLE_TRAINER_ID"])
    cfg = ep_config(num_layers=2)
    whole = ep_weights(seed + 23, cfg, torch.float32)
    rank_init({"ep_degree": 2, "mp_degree": 2})
    rec = {"rank": rank, "d2_ep_mp": d2_split(
        cfg, whole, split_prompts(seed, cfg.vocab_size), directory, "epmp")}
    (directory / f"rank{rank}.json").write_text(json.dumps(rec))
    return 0


def split_ranks(K, seed: int, rows):
    """[23] (see ``split_worker`` and ``split4_worker``): [23a] the
    sharded save against [22c]'s gathered one; [23b] the 1.3B served at
    mp 2 against [4]'s one process; [23c] depth 2 at mp 2, ep 2 and ep 2 x
    mp 2 against one process on the card; [23d] the MoELayer's reductions
    against their CPU repeat."""
    t_phase = time.perf_counter()
    smi = f"{nvidia_smi_line()}, {torch.cuda.device_count()} card(s)"
    work, work4 = CHAINED["--split-worker"], CHAINED["--split4-worker"]
    try:
        recs = chained_records("--split-worker",
                               "[23] serving a split model and the sharded "
                               "save: two ranks on one card")
        recs4 = chained_records("--split4-worker",
                                "[23c] ep 2 x mp 2: four ranks on one card",
                                nproc=4)
        print(f"    [23] seconds in the two ranks' sub-phases "
              f"{ {k: round(v, 1) for k, v in recs[0]['seconds'].items()} }",
              flush=True)
        # [23a]: the sharded save
        total = sum(r["save"]["bytes"] for r in recs)
        for r in recs:
            a = r["save"]
            want = a["block_bytes"] + (a["whole_bytes"] if r["rank"] == 0
                                       else 0)
            print(f"    [23a] rank {r['rank']}: [22c]'s mp-2 step "
                  f"({'held from [22c]' if a['held'] else 'taken again'}) "
                  f"saved sharded: {len(a['collectives'])} tensor "
                  f"collectives; {a['bytes'] / 1e9:.4f} GB written against "
                  f"its replica-0 blocks' {want / 1e9:.4f} GB "
                  f"({a['sharded']} sharded leaves); blocking "
                  f"{a['blocking_s']:.2f} s, total {a['total_s']:.2f} s, "
                  f"against [22c]'s gather {a['gather_s']:.2f} s and write "
                  f"{a['gathered_save_s']:.2f} s; its blocks onto sharding 2 "
                  f"at p_g_os read in {a['z3_s']:.2f} s "
                  f"({a['z3_read']['bytes'] / 1e9:.4f} GB), "
                  f"{len(a['z3_differ'])} of {a['z3_leaves']} leaves "
                  f"differing from [22c]'s save's ({smi})", flush=True)
            check(not a["collectives"] and a["bytes"] == want
                  and a["sharded"] > 0 and not a["z3_differ"]
                  and a["z3_leaves"] > 0, f"[23a] rank {r['rank']}: "
                  f"{ {k: v for k, v in a.items() if k != 'z3_read'} }")
        a0 = recs[0]["save"]
        print(f"    [23a] both ranks wrote {total / 1e9:.4f} GB, [22c]'s "
              f"gathered save {a0['gathered_bytes'] / 1e9:.4f} GB; rank 0's "
              f"whole restore ({a0['whole_s']:.2f} s): "
              f"{len(a0['whole_differ'])} of {a0['whole_leaves']} leaves "
              f"differing from [22c]'s ({smi})", flush=True)
        check(total == a0["gathered_bytes"] and not a0["whole_differ"]
              and a0["whole_leaves"] > 0,
              f"[23a]: {total} bytes against {a0['gathered_bytes']}; "
              f"differing {a0['whole_differ']}")

        # [23b]: the 1.3B served at mp 2
        from paddle_tpu_torch.models.gpt import GPT3_1p3B

        L = GPT3_1p3B["num_layers"]
        b0 = recs[0]["serve"]
        for r in recs:
            b = r["serve"]
            want = {FWD_SYMBOL: L, FP32_FWD_SYMBOL: 0,
                    NORM_SYMBOLS["fwd"]: 2 * (2 * L + 1),
                    **{s: L for s in PAGED_SYMBOLS.values()}}
            pr = b["profiled_routes"]
            print(f"    [23b] rank {r['rank']}: weights moved from the "
                  f"stage-3 step's blocks in {b['load_s']:.2f} s: "
                  f"{b['plans']} plans, received {b['received'] / 1e9:.4f} "
                  f"GB here, {b['received_all'] / 1e9:.4f} GB over both "
                  f"ranks against bytes_wire {b['wire'] / 1e9:.4f} GB "
                  f"(bytes_naive {b['naive'] / 1e9:.4f} GB); gathered and "
                  f"sliced {b['assembled']} ({smi})", flush=True)
            print(f"    [23b] rank {r['rank']}: 16 requests in "
                  f"{b['wall_s']:.2f} s = {b['tokens_per_s']:.1f} tokens/s, "
                  f"TTFT p50 {b['ttft_ms']:.1f} ms, TPOT p50 "
                  f"{b['tpot_ms']:.2f} ms (one process in [4]: "
                  f"{SERVED.get('summary', 'not run')}); captures "
                  f"{b['captures']}, eager steps {b['eager']}; a decode step "
                  f"with 8 slots live {b['decode_step_ms']:.1f} ms, "
                  f"{b['decode_collectives']:.0f} collectives in "
                  f"{b['decode_collective_ms']:.1f} ms of it "
                  f"({b['decode_collective_ms'] / b['decode_step_ms']:.0%});"
                  f" KV cache {b['kv_bytes'] / 2**30:.3f} GiB and "
                  f"parameters {b['param_bytes'] / 2**30:.3f} GiB a rank "
                  f"({smi})", flush=True)
            print(f"    [23b] rank {r['rank']}: one step that prefills a "
                  f"request and decodes it (profiler): {b['profiled']}; "
                  f"routes {pr}; query heads a rank {b['heads']}",
                  flush=True)
            check(b["received_all"] == b["wire"] > 0
                  and b["assembled"] == 0 and not b["captured"]
                  and b["captures"] == 0 and b["eager"] > 0
                  and b["tokens"] == b0["tokens"]
                  and all(len(o) == 32 for o in b["tokens"])
                  and b["profiled"] == want and b["heads"] == 8
                  and pr["flash"].get("wgmma", 0) == L
                  and sum(pr["flash"].values()) == L
                  and pr["paged"].get("vector", 0) == L
                  and sum(pr["paged"].values()) == L
                  and b["routes"]["flash"].get("wgmma", 0)
                  == sum(b["routes"]["flash"].values()) > 0
                  and b["routes"]["paged"].get("vector", 0)
                  == sum(b["routes"]["paged"].values()) > 0,
                  f"[23b] rank {r['rank']}: "
                  f"{ {k: v for k, v in b.items() if k != 'tokens'} }")
        print(f"    [23b] rank 0's one process on the same weights: the "
              f"first request's prefill logits ({b0['n0']} tokens) within "
              f"{b0['logit_err']:.3e} of the split engine's (bound "
              f"{SPLIT_LOGIT_TOL:g} x {b0['logit_scale']:.3f}), argmax "
              f"equal {b0['argmax_equal']}; greedy tokens equal "
              f"{b0['equal_share']:.1%} over all 16 requests; KV cache "
              f"{b0['one_kv_bytes'] / 2**30:.3f} GiB and parameters "
              f"{b0['one_param_bytes'] / 2**30:.3f} GiB in one process "
              f"({smi})", flush=True)
        check(b0["logit_err"] <= SPLIT_LOGIT_TOL * b0["logit_scale"]
              and 2 * b0["kv_bytes"] == b0["one_kv_bytes"]
              and b0["param_bytes"] < b0["one_param_bytes"],
              f"[23b] against one process: {b0['logit_err']}, "
              f"{b0['kv_bytes']}, {b0['param_bytes']}")
        for name in SERVING_KERNELS:
            rows[name]["launches_split"] = b0["launches"].get(name, 0)

        # [23c]: depth 2, fp32, against one process on the card
        for tag, rs_, key in (("mp", recs, "d2_mp"), ("ep", recs, "d2_ep"),
                              ("ep", recs4, "d2_ep_mp")):
            one = recs[0]["d2_one"][tag]
            first = rs_[0][key]
            for r in rs_:
                d = r[key]
                same = {k: d[k]["tokens"] == one[k]["tokens"]
                        for k in ("spec", "dense")}
                same["generate"] = d["generate"] == one["generate"]
                print(f"    [23c] {key} rank {r['rank']}: greedy tokens "
                      f"equal to one process on the card {same}; prefix "
                      f"hits {d['spec']['hits']}, drafts accepted "
                      f"{d['spec']['accepted']}; sampled equal to rank 0's "
                      f"{d['sampled']['tokens'] == first['sampled']['tokens']}"
                      f"; captures {d['spec']['captures']}, eager steps "
                      f"{d['spec']['eager']}; the sharded save "
                      f"{d['save_bytes'] / 1e6:.1f} MB with "
                      f"{d['save_collectives']} collectives; K/V heads a rank"
                      f" {d['kv_heads']}", flush=True)
                check(all(same.values())
                      and d["sampled"]["tokens"] == first["sampled"]["tokens"]
                      and d["generate_sampled"] == first["generate_sampled"]
                      and d["spec"]["slots"] == first["spec"]["slots"]
                      and d["spec"]["captures"] == 0 and d["spec"]["eager"] > 0
                      and d["save_collectives"] == 0,
                      f"[23c] {key} rank {r['rank']}: {same}")

        # [23d]: the MoELayer's reductions against their CPU repeat
        for mode in ("fp32", "int8"):
            for r in recs:
                g = r["layer"][mode]
                cc = g["cpu_check"]
                tol = 2.0 ** -20 * cc["input_max_abs"]
                print(f"    [23d] {mode}, rank {r['rank']}: losses "
                      f"{g['losses']}; {g['reduced']} expert parameters "
                      f"reduced under their global names; step "
                      f"{MX_CHECK_STEP}'s reduction on the CPU: "
                      + "; ".join(f"{p} {cc[p]['differ']} of {cc[p]['of']} "
                                  f"entries differ (largest "
                                  f"{cc[p]['max_abs_err']:.3e})"
                                  for p in ("grads", "residuals"))
                      + f" (residual tol {tol:.3e}) ({smi})", flush=True)
                check(g["losses"] == recs[0]["layer"][mode]["losses"]
                      and g["reduced"] == 32 and cc["grads"]["differ"] == 0
                      and cc["grads"]["max_abs"] > 0
                      and cc["residuals"]["max_abs_err"] <= tol
                      and g["launches"]["fused_adamw_multi"] == EP_STEPS
                      and all(math.isfinite(v) for v in g["losses"]),
                      f"[23d] {mode} rank {r['rank']}: {g}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(work4, ignore_errors=True)
        torch.cuda.empty_cache()
    print(f"    phase 23 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


# --------------------------------------------------------------- phase 24
# [24a]: the 1.3B's width (hidden 2048, 16 heads) at depth PP_LAYERS in
# fp32, two gloo ranks at pp 2, PP_STEPS steps on PP_B x PP_S batches,
# against one process's plain step on the card on the same weights and
# with the same accumulate_steps; config 5's width with every block MoE
# the same way; the four-rank chain's pp 2 x dp 2 and pp 2 x mp 2. With
# dropout PP_DROPOUT the 1f1b, gpipe and no-remat runs and a repeat agree
# to the bit (the stated bound: 0)
PP_B, PP_S, PP_STEPS, PP_LAYERS, PP_DROPOUT = 4, 256, 3, 4, 0.1
# [24b]: GPT-3 1.3B whole at pp 2, bf16, [6]'s AdamW, B x S, M
# microbatches, 1f1b with remat; peak memory at PP_MEM_M under 1f1b with
# remat against gpipe without it
PP_MAIN_B, PP_MAIN_S, PP_MAIN_M, PP_MEM_M, PP_TIMED = 8, 2048, 4, 8, 3
#: the [24a] runs: (name, accumulate_steps, step options)
PP_RUNS = (("1f1b_m2", 2, {}), ("1f1b_m4", 4, {}),
           ("gpipe_m2", 2, {"pp_schedule": "gpipe"}),
           ("noremat_m2", 2, {"pp_remat": False}),
           ("vpp2_m2", 2, {"virtual_pp_degree": 2}))


def pp_config(moe: bool, **over):
    """[24a]'s model: the 1.3B's width at depth PP_LAYERS, or config 5's
    width with every block MoE."""
    from paddle_tpu_torch.models.gpt import GPT3_1p3B, GPTConfig

    if moe:
        return GPTConfig(**{**MOE5, "num_layers": PP_LAYERS,
                            "moe_every_k": 1, "use_recompute": False,
                            **over})
    return GPTConfig(**{**GPT3_1p3B, "num_layers": PP_LAYERS,
                        "dropout": 0.0, **over})


def pp_batches(seed: int, vocab: int):
    g = torch.Generator(device="cuda").manual_seed(seed + 24)
    x = torch.randint(0, vocab, (PP_STEPS, PP_B, PP_S), generator=g,
                      device="cuda")
    return x, torch.roll(x, -1, dims=2)


def pp_run(cfg, weights, x, y, M, rows=slice(None), mesh=None, steps=None,
           **kw):
    """``steps`` (PP_STEPS) steps of ``cfg`` on ``weights`` (this rank's,
    or the whole model's in one process) at ``M`` microbatches: the
    losses, the parameters after them (on the host) and the step."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32)
    model.load_state_dict(weights)
    model.train()
    opt = AdamW(parameters=model.named_parameters(), **ep_parity_opt())
    step = fleet.make_sharded_train_step(model, opt, accumulate_steps=M,
                                         mesh=mesh, **kw)
    losses = [step(x[k][rows], y[k][rows]).item()
              for k in range(steps or PP_STEPS)]
    params = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return losses, params, step


def pp_digest(params) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        h.update(params[k].contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def pp_p2p_plan(n: int, M: int, rank: int, nbytes: int):
    """What the 1F1B table (``_1f1b_ticks``) makes rank ``rank`` exchange
    in a step after the first on batches of one shape (the transfers'
    shapes known, no shape headers): exchange calls, tensors sent and
    received, and bytes sent and received (``nbytes`` an activation or
    gradient)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        pipeline_parallel as PPm

    plan = dict(calls=0, sent=0, received=0, bytes_sent=0, bytes_received=0)
    for row in PPm._1f1b_ticks(n, M):
        mine = [m for m in PPm._messages(row, n, n) if rank in m[:2]]
        if not mine:
            continue
        out = sum(m[0] == rank for m in mine)
        plan["calls"] += 1
        plan["sent"] += out
        plan["received"] += len(mine) - out
        plan["bytes_sent"] += out * nbytes
        plan["bytes_received"] += (len(mine) - out) * nbytes
    return plan


class P2PTally:
    """The pipeline's transfers while it is open: host seconds inside
    ``pipeline_parallel.p2p_exchange`` (where the schedules look it up),
    and ``communication.p2p_counts``' growth at ``close``."""

    def __init__(self):
        from paddle_tpu_torch.distributed import communication
        from paddle_tpu_torch.distributed.fleet.meta_parallel import \
            pipeline_parallel as PPm

        self.mod, self.comm = PPm, communication
        self.counts0 = dict(communication.p2p_counts)
        self.seconds = 0.0
        fn = self.fn = PPm.p2p_exchange

        def clocked(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.seconds += time.perf_counter() - t0
        PPm.p2p_exchange = clocked

    def close(self):
        self.mod.p2p_exchange = self.fn
        return {k: v - self.counts0[k]
                for k, v in self.comm.p2p_counts.items()}


def pp_main_model(seed: int):
    """[24b]'s GPT-3 1.3B (bf16, [6]'s AdamW) at pp 2 and its whole
    parameter count; this rank's batch of PP_MAIN_B x PP_MAIN_S."""
    from paddle_tpu_torch.models.gpt import GPT3_1p3B, GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg = GPTConfig(**GPT3_1p3B, dropout=0.0, use_recompute=True,
                    recompute_interval=1, loss_chunk=128)
    model = GPTForCausalLM(
        cfg, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(seed))
    model.train()
    whole = sum(p.numel() for p in model.parameters())
    opt = AdamW(learning_rate=1e-4, parameters=model.named_parameters(),
                multi_precision=True, moment_dtype="bfloat16")
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    x = torch.randint(0, cfg.vocab_size, (PP_MAIN_B, PP_MAIN_S), generator=g,
                      device="cuda")
    return cfg, model, opt, whole, x, torch.roll(x, -1, dims=1)


def pp_worker(directory: Path, seed: int) -> int:
    """One rank of [24], chained after [23]'s worker in its launch (two
    ranks over gloo on the one card). [24a] the depth-4 fp32 runs of
    PP_RUNS, the GPT-MoE under 1f1b and gpipe, the dropout runs; [24b] the
    1.3B at pp 2: a warm-up step, PP_TIMED timed steps (host clock,
    launches, transfers), one profiled, the parameter and optimizer
    elements against the whole model's, and peak memory at PP_MEM_M
    microbatches under 1f1b with remat and gpipe without; [24c] the
    depth-4 model in bf16 saved sharded, restored onto a fresh step and
    resumed."""
    import shutil

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.checkpoint import CheckpointManager
    from paddle_tpu_torch.distributed import communication, fleet
    from paddle_tpu_torch.models.gpt import GPTForCausalLM
    from paddle_tpu_torch.optimizer import AdamW

    cfg, cfg_moe = pp_config(False), pp_config(True)
    whole = ep_weights(seed + 24, cfg, torch.float32)
    whole_moe = ep_weights(seed + 25, cfg_moe, torch.float32)
    hcg = rank_init({"pp_degree": 2})
    rank = fleet.worker_index()
    x, y = pp_batches(seed, cfg.vocab_size)
    xm, ym = pp_batches(seed + 1, cfg_moe.vocab_size)
    rec = {"rank": rank, "backend": dist.get_backend(),
           "stage": hcg.get_stage_id(),
           "pp_group": hcg.get_pipe_parallel_group().ranks}
    # ---- [24a]
    K.reset_launch_counts()
    for name, M, kw in PP_RUNS:
        losses, params, step = pp_run(cfg, whole, x, y, M, **kw)
        rec[name] = {"losses": losses, "peak_stash": step.pp_stats["peak_stash"]}
        torch.save(params, directory / f"{name}.{rank}.pt")
        del step
    rec["parity_routes"] = {w: dict(getattr(K, w).route_launches)
                            for w in FLASH_WRAPPERS}
    for name, kw in (("moe_1f1b", {}), ("moe_gpipe", {"pp_schedule": "gpipe"})):
        losses, params, step = pp_run(cfg_moe, whole_moe, xm, ym, 2, **kw)
        rec[name] = {"losses": losses}
        torch.save(params, directory / f"{name}.{rank}.pt")
        del step
    cfg_d = pp_config(False, dropout=PP_DROPOUT)
    for name, kw in (("drop_1f1b", {}), ("drop_gpipe", {"pp_schedule": "gpipe"}),
                     ("drop_noremat", {"pp_remat": False}), ("drop_again", {})):
        losses, params, step = pp_run(cfg_d, whole, x, y, 2, **kw)
        rec[name] = {"losses": losses, "digest": pp_digest(params)}
        del step
    del whole, whole_moe
    gc.collect()
    torch.cuda.empty_cache()

    # ---- [24b] the 1.3B at pp 2
    cfg_b, model, opt, n_whole, xb, yb = pp_main_model(seed)
    step = fleet.make_sharded_train_step(model, opt,
                                         accumulate_steps=PP_MAIN_M)
    rec["main_elements"] = [sum(p.numel() for p in step.params.values()),
                            n_whole]
    torch.cuda.reset_peak_memory_stats()
    losses = [step(xb, yb)]
    gc.collect()
    K.reset_launch_counts()
    staged0 = dict(communication.staged_ops)
    tally = P2PTally()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PP_TIMED):
        losses.append(step(xb, yb))
    torch.cuda.synchronize()
    m = {"step_s": (time.perf_counter() - t0) / PP_TIMED}
    counts = tally.close()
    m["p2p"] = {k: v / PP_TIMED for k, v in counts.items()}
    m["p2p_s"] = tally.seconds / PP_TIMED
    m["launches"] = {k: v / PP_TIMED for k, v in K.launch_counts().items()}
    m["staged"] = {k: (v - staged0.get(k, 0)) / PP_TIMED
                   for k, v in communication.staged_ops.items()}
    m["flash_routes"] = {w: dict(getattr(K, w).route_launches)
                         for w in FLASH_WRAPPERS}
    m["master_copies"] = opt.master_copies
    m["peak_m4"] = torch.cuda.max_memory_allocated()
    kernels = profile_launches(lambda: losses.append(step(xb, yb)))
    m["profiled"] = launches_of(kernels, (
        FWD_SYMBOL, *BWD_SYMBOLS.values(), NORM_SYMBOLS["fwd"],
        NORM_SYMBOLS["bwd"], "fused_adamw"))
    m["losses"] = [float(v) for v in losses]
    m["param_bytes"] = tensor_bytes(step.params.values())
    m["opt_bytes"] = opt_state_bytes(step)
    m["stash_m4"] = step.pp_stats["peak_stash"]
    del step
    # peak memory at PP_MEM_M microbatches: 1f1b with remat, gpipe without
    for name, kw in (("1f1b", {}), ("gpipe", {"pp_schedule": "gpipe",
                                              "pp_remat": False})):
        gc.collect()
        torch.cuda.empty_cache()
        step = fleet.make_sharded_train_step(
            model, opt, accumulate_steps=PP_MEM_M, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        m[f"mem_{name}"] = [float(step(xb, yb)), base,
                            torch.cuda.max_memory_allocated(),
                            step.pp_stats["peak_stash"]]
        del step
    rec["main"] = m
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()

    # ---- [24c] the save: the depth-4 model in bf16 at pp 2
    sd = ep_weights(seed + 26, cfg, torch.bfloat16)

    def bf16_step(weights):
        mdl = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16)
        mdl.load_state_dict(weights)
        mdl.train()
        return fleet.make_sharded_train_step(
            mdl, AdamW(learning_rate=1e-4, parameters=mdl.named_parameters(),
                       multi_precision=True, moment_dtype="bfloat16"),
            accumulate_steps=2)

    step = bf16_step(sd)
    for k in range(2):
        step(x[k], y[k])
    ck = directory / "pp_ck"
    mgr = CheckpointManager(ck)
    with DistCalls() as calls:
        tree = step.state_for_checkpoint().to_tree()
        mgr.save(2, tree)
        mgr.wait_until_finished()
    from paddle_tpu_torch.distributed.resharding import ShardedTensor

    def leaves(t):
        if isinstance(t, dict):
            return [v for x_ in t.values() for v in leaves(x_)]
        return [t]

    def host(v):
        return v if isinstance(v, torch.Tensor) \
            else torch.as_tensor(np.asarray(v))

    flat = [v for part in ("params", "opt_state") for v in leaves(tree[part])
            if v is not None]
    mine = sum(v.block.numel() * v.block.element_size() for v in flat
               if isinstance(v, ShardedTensor))
    repl = sum(host(v).numel() * host(v).element_size() for v in flat
               if not isinstance(v, ShardedTensor))
    # what was saved, copied before the next step updates the live tensors
    saved = [(v.block if isinstance(v, ShardedTensor) else host(v))
             .detach().clone() for v in flat]
    c = {"collectives": calls.calls, "bytes": mgr.last_save["bytes"],
         "expected": mine + (repl if rank == 0 else 0)}
    mgr.close()
    c["third"] = float(step(x[2], y[2]))
    del step, tree, flat
    fresh = bf16_step({k: v * 0.5 for k, v in sd.items()})
    mgr = CheckpointManager(ck)
    fresh.restore_from_checkpoint(mgr.restore(
        shardings=fresh.checkpoint_shardings()))
    mgr.close()
    back = fresh.state_for_checkpoint().to_tree()
    back = [v for part in ("params", "opt_state") for v in leaves(back[part])
            if v is not None]
    c["bitwise"] = len(back) == len(saved) and all(
        torch.equal((v.block if isinstance(v, ShardedTensor) else host(v))
                    .detach().cpu(), w.cpu()) for v, w in zip(back, saved))
    c["resumed"] = float(fresh(x[2], y[2]))
    rec["save"] = c
    del fresh, sd
    shutil.rmtree(ck, ignore_errors=True)
    (directory / f"rank{rank}.json").write_text(json.dumps(rec))
    return 0


def pp4_worker(directory: Path, seed: int) -> int:
    """One rank of [24a]'s four-rank runs, chained after [23c]'s worker:
    the depth-4 fp32 model at pp 2 x dp 2 (this rank's half of each
    batch) and at pp 2 x mp 2 (its mp blocks), M 2."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.weights import from_paddle_tpu

    cfg = pp_config(False)
    whole = ep_weights(seed + 24, cfg, torch.float32)
    x, y = pp_batches(seed, cfg.vocab_size)
    hcg = rank_init({"dp_degree": 2, "pp_degree": 2})
    rank = fleet.worker_index()
    r = hcg.get_data_parallel_rank()
    rows = slice(r * PP_B // 2, (r + 1) * PP_B // 2)
    rec = {"rank": rank}
    losses, params, step = pp_run(cfg, whole, x, y, 2, rows=rows,
                                  mesh=hcg.get_mesh())
    rec["dp"] = {"losses": losses}
    torch.save(params, directory / f"dp.{rank}.pt")
    del step
    hcg = rank_init({"pp_degree": 2, "mp_degree": 2})
    np_whole = {k: v.cpu().numpy() for k, v in whole.items()}
    blocks = {k: v.cuda() for k, v in from_paddle_tpu(
        np_whole, mp_rank=hcg.get_model_parallel_rank(), mp_degree=2).items()}
    losses, params, step = pp_run(cfg, blocks, x, y, 2, mesh=hcg.get_mesh())
    rec["mp"] = {"losses": losses}
    torch.save(params, directory / f"mp.{rank}.pt")
    del step
    (directory / f"rank{rank}.json").write_text(json.dumps(rec))
    return 0


def pp_ranks(K, seed: int, rows):
    """[24]: the pipeline's two- and four-rank runs against one process on
    the card; the 1.3B pipelined against [6]'s step at its batch; the
    save."""
    import math

    from paddle_tpu_torch.weights import to_paddle_tpu

    t_phase = time.perf_counter()
    smi = f"{nvidia_smi_line()}, {torch.cuda.device_count()} card(s)"
    work, work4 = CHAINED["--pp-worker"], CHAINED["--pp4-worker"]
    try:
        recs = chained_records("--pp-worker", "[24] pp 2, two ranks on one "
                               "card")
        recs4 = chained_records("--pp4-worker", "[24a] pp 2 x dp 2 and pp 2 "
                                "x mp 2, four ranks on one card", 4)
        cfg, cfg_moe = pp_config(False), pp_config(True)
        x, y = pp_batches(seed, cfg.vocab_size)
        xm, ym = pp_batches(seed + 1, cfg_moe.vocab_size)
        refs = {}
        for key, c, wseed, xx, yy, M in (
                ("m2", cfg, 24, x, y, 2), ("m4", cfg, 24, x, y, 4),
                ("moe", cfg_moe, 25, xm, ym, 2)):
            w = ep_weights(seed + wseed, c, torch.float32)
            losses, params, step = pp_run(c, w, xx, yy, M, mesh=None)
            refs[key] = {"losses": losses, "params": params}
            del step, w
        torch.cuda.empty_cache()
        print(f"    [24a] one process on the card (depth {PP_LAYERS}, fp32, "
              f"{PP_STEPS} steps on {PP_B} x {PP_S}): losses M 2 "
              f"{refs['m2']['losses']}, M 4 {refs['m4']['losses']}, GPT-MoE "
              f"{refs['moe']['losses']}", flush=True)

        ok = True
        for name, M, _ in PP_RUNS:
            ref = refs["m4" if M == 4 else "m2"]
            got = to_paddle_tpu([torch.load(work / f"{name}.{r}.pt")
                                 for r in range(2)], pp_degree=2)
            errs = parity_errors(cfg, ref, recs[0][name]["losses"], got)
            print(f"    (i) 1.3B width, depth {PP_LAYERS}, fp32, pp 2, "
                  f"{name}: losses {recs[0][name]['losses']}; against one "
                  f"process: losses {errs[0]:.3e} (tol {DP_LOSS_TOL:g}), "
                  f"every parameter joined over the stages {errs[1]:.3e} "
                  f"(tol {DP_PARAM_TOL:g}), the qkv biases' K third "
                  f"{errs[2]:.3e}; stash peak "
                  f"{[r[name]['peak_stash'] for r in recs]} cells ({smi})",
                  flush=True)
            ok &= parity_ok(errs) and recs[0][name]["losses"] == \
                recs[1][name]["losses"]
        for name in ("moe_1f1b", "moe_gpipe"):
            got = to_paddle_tpu([torch.load(work / f"{name}.{r}.pt")
                                 for r in range(2)], pp_degree=2)
            errs = parity_errors(cfg_moe, refs["moe"],
                                 recs[0][name]["losses"], got)
            print(f"    (i) config 5's width, every block MoE, depth "
                  f"{PP_LAYERS}, fp32, pp 2, {name}: losses "
                  f"{recs[0][name]['losses']}; against one process: losses "
                  f"{errs[0]:.3e}, parameters {errs[1]:.3e}, K third "
                  f"{errs[2]:.3e}", flush=True)
            ok &= parity_ok(errs)
        for key, stages, join in (("dp", [(0,), (1,)], {}),
                                  ("mp", [(0, 1), (2, 3)], {"mp_degree": 2})):
            files = [work4 / f"{key}.{r}.pt" for st in stages for r in st]
            got = to_paddle_tpu([torch.load(f) for f in files], pp_degree=2,
                                **join)
            errs = parity_errors(cfg, refs["m2"], recs4[0][key]["losses"], got)
            print(f"    (i) pp 2 x {key} 2, four ranks: losses "
                  f"{recs4[0][key]['losses']}; against one process: losses "
                  f"{errs[0]:.3e}, parameters {errs[1]:.3e}, K third "
                  f"{errs[2]:.3e}", flush=True)
            ok &= parity_ok(errs) and all(
                r[key]["losses"] == recs4[0][key]["losses"] for r in recs4)
        drops = {n: (recs[0][n]["losses"], [r[n]["digest"] for r in recs])
                 for n in ("drop_1f1b", "drop_gpipe", "drop_noremat",
                           "drop_again")}
        same = len({str(v) for v in drops.values()}) == 1
        print(f"    (i) dropout {PP_DROPOUT}: losses and parameter digests "
              f"{drops}; all equal to the bit: {same} (bound 0)", flush=True)
        routes = recs[0]["parity_routes"]
        check(ok and same and all(v["cuda_cores"] == sum(v.values()) > 0
                                  for v in routes.values())
              and all(r["backend"] == "GLOO" for r in recs),
              f"[24a]: parity failed or a flash launch left the fp32 route "
              f"{routes}")

        # ---- [24b]
        one = pp_one_process(seed)
        nbytes = PP_MAIN_B // PP_MAIN_M * PP_MAIN_S * 2048 * 2
        L = 12
        for r in recs:
            mm = r["main"]
            last = r["stage"] == 1
            ln, prof = mm["launches"], mm["profiled"]
            M = PP_MAIN_M
            want = {"flash_attention_fwd": 2 * L * M,
                    "flash_attention_bwd_dq": L * M,
                    "flash_attention_bwd_dkv": L * M,
                    "fused_layer_norm": 4 * L * M + 2 * M * last,
                    "layer_norm_bwd": 2 * L * M + M * last,
                    "fused_adamw_multi": 1}
            want_prof = {FWD_SYMBOL: want["flash_attention_fwd"],
                         BWD_SYMBOLS["dq"]: L * M, BWD_SYMBOLS["dkv"]: L * M,
                         NORM_SYMBOLS["fwd"]: want["fused_layer_norm"],
                         NORM_SYMBOLS["bwd"]: want["layer_norm_bwd"],
                         "fused_adamw": 1}
            plan = pp_p2p_plan(2, M, r["stage"], nbytes)
            frac = r["main_elements"]
            share = frac[0] / frac[1]
            mem = {k: mm[f"mem_{k}"] for k in ("1f1b", "gpipe")}
            print(f"    (ii) rank {r['rank']} (stage {r['stage']}), GPT-3 "
                  f"1.3B bf16 whole ({L} blocks a stage) at pp 2, batch "
                  f"{PP_MAIN_B} x {PP_MAIN_S}, M {M}, 1f1b with remat: "
                  f"losses {mm['losses']}; step {mm['step_s'] * 1e3:.1f} ms "
                  f"host clock (one process {one['step_s'] * 1e3:.1f} ms; "
                  f"the two ranks share the card, so their stages' work "
                  f"serialises and no bubble is saved); transfers a step "
                  f"{mm['p2p']} (the table's {plan}), "
                  f"{mm['p2p_s'] * 1e3:.1f} ms host clock inside them = "
                  f"{mm['p2p_s'] / mm['step_s']:.3f} of the step (waits on "
                  f"the peer included); staged through the host "
                  f"{mm['staged']}; parameter and optimizer elements "
                  f"{frac[0]} of {frac[1]} = {share:.4f}, bytes "
                  f"{(mm['param_bytes'] + mm['opt_bytes']) / 2**30:.2f} GiB "
                  f"(one process {one['bytes'] / 2**30:.2f} GiB = "
                  f"{(mm['param_bytes'] + mm['opt_bytes']) / one['bytes']:.4f})"
                  f"; peak memory at M {M} {mm['peak_m4'] / 2**30:.2f} GiB "
                  f"(one process at the batch {one['peak'] / 2**30:.2f}), "
                  f"stash {mm['stash_m4']} cells; launches a step "
                  f"{ {k: v for k, v in ln.items() if v} }; profiled step "
                  f"{prof} ({smi})", flush=True)
            print(f"    (iii) rank {r['rank']} at M {PP_MEM_M}: [loss, "
                  f"allocated before, peak, stash cells] 1f1b with remat "
                  f"{mem['1f1b']}, gpipe without {mem['gpipe']}: peak gap "
                  f"{(mem['gpipe'][2] - mem['1f1b'][2]) / 2**30:.2f} GiB",
                  flush=True)
            check(all(math.isfinite(v) for v in mm["losses"])
                  and abs(mm["losses"][0] - one["losses"][0]) <= 2e-2
                  and all(ln[k] == v for k, v in want.items())
                  and prof == want_prof
                  and {k: mm["p2p"][k] for k in plan} == plan
                  and mm["master_copies"] == 0
                  and all(v["wgmma"] == sum(v.values()) > 0
                          for v in mm["flash_routes"].values())
                  and abs(share - 0.54) <= 0.01
                  and mem["gpipe"][2] > mem["1f1b"][2]
                  and mem["1f1b"][3] <= 2 and mem["gpipe"][3] == PP_MEM_M,
                  f"[24b] rank {r['rank']}: launches {ln} (want {want}), "
                  f"profiled {prof} (want {want_prof}), transfers "
                  f"{mm['p2p']} (want {plan}), share {share}, memory {mem}, "
                  f"first loss {mm['losses'][0]} against one process's "
                  f"{one['losses'][0]}")
        for name in TRAINING_KERNELS:
            rows[name]["launches_pp"] = [r["main"]["launches"].get(name)
                                         for r in recs]

        # ---- [24c]
        for r in recs:
            c = r["save"]
            print(f"    (iv) rank {r['rank']}: depth {PP_LAYERS} bf16 at pp "
                  f"2 saved sharded: {len(c['collectives'])} tensor "
                  f"collectives, {c['bytes']} bytes written against its "
                  f"replica-0 blocks' {c['expected']}; restored onto a step "
                  f"of other weights bitwise: {c['bitwise']}; resumed loss "
                  f"{c['resumed']:.6f} against the uninterrupted "
                  f"{c['third']:.6f} (tol {DP_LOSS_TOL:g})", flush=True)
            check(not c["collectives"] and c["bytes"] == c["expected"]
                  and c["bitwise"]
                  and abs(c["resumed"] - c["third"]) <= DP_LOSS_TOL,
                  f"[24c] rank {r['rank']}: {c}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(work4, ignore_errors=True)
        torch.cuda.empty_cache()
    print(f"    phase 24 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)


def pp_one_process(seed: int):
    """[24b]'s model as one process at its batch (M 1, the plain step):
    its first loss, step time, peak memory and parameter and optimizer
    bytes."""
    from paddle_tpu_torch.distributed import fleet

    cfg, model, opt, _, x, y = pp_main_model(seed)
    step = fleet.make_sharded_train_step(model, opt)
    torch.cuda.reset_peak_memory_stats()
    losses = [float(step(x, y))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PP_TIMED):
        losses.append(float(step(x, y)))
    torch.cuda.synchronize()
    out = {"step_s": (time.perf_counter() - t0) / PP_TIMED,
           "losses": losses, "peak": torch.cuda.max_memory_allocated(),
           "bytes": tensor_bytes(step.params.values()) + opt_state_bytes(step)}
    del model, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged-shapes-of", metavar="DIR", type=Path,
                    help="only time the paged_attention of the package in "
                    "DIR (a checkout of another commit) at [3]'s four "
                    "shapes, and exit")
    ap.add_argument("--paged-symbols", metavar="SYMBOL", nargs="+",
                    help="with --paged-shapes-of: the kernels whose device "
                    "time is summed, where DIR's differ from "
                    f"{' and '.join(PAGED_SYMBOLS.values())}")
    ap.add_argument("--dp-worker", metavar="DIR", type=Path,
                    help="run as one rank of phase 18b (the port's launcher "
                    "starts two), writing its results into DIR")
    ap.add_argument("--tp-worker", metavar="DIR", type=Path,
                    help="run as one rank of phase 19a (the port's launcher "
                    "starts two), writing its results into DIR")
    ap.add_argument("--zero-worker", metavar="DIR", type=Path,
                    help="run as one rank of phase 19b (the port's launcher "
                    "starts two), writing its results into DIR")
    ap.add_argument("--z3-worker", metavar="DIR", type=Path,
                    help="run as one rank of phase 20a (the port's launcher "
                    "starts two), writing its results into DIR")
    ap.add_argument("--reduce-worker", metavar="DIR", type=Path,
                    help="run as one rank of phase 20b (the port's launcher "
                    "starts two), writing its results into DIR")
    ap.add_argument("--ep-worker", metavar="DIR", type=Path,
                    help="run as one rank of phase 21a (the port's launcher "
                    "starts two), writing its results into DIR")
    ap.add_argument("--ep4-worker", metavar="DIR", type=Path,
                    help="run as one rank of phase 21b (the port's launcher "
                    "starts four), writing its results into DIR")
    ap.add_argument("--mx-worker", metavar="DIR", type=Path,
                    help="run as one rank of phase 22 (the port's launcher "
                    "starts two), writing its results into DIR")
    ap.add_argument("--mx4-worker", metavar="DIR", type=Path,
                    help="run as one rank of phase 22a's ep 2 x mp 2 (the "
                    "port's launcher starts four), writing its results into "
                    "DIR")
    ap.add_argument("--split-worker", metavar="DIR", type=Path,
                    help="run as one rank of phase 23 (the port's launcher "
                    "starts two), writing its results into DIR")
    ap.add_argument("--split4-worker", metavar="DIR", type=Path,
                    help="run as one rank of phase 23c's ep 2 x mp 2 (the "
                    "port's launcher starts four), writing its results into "
                    "DIR")
    ap.add_argument("--pp-worker", metavar="DIR", type=Path,
                    help="run as one rank of phase 24 (the port's launcher "
                    "starts two), writing its results into DIR")
    ap.add_argument("--pp4-worker", metavar="DIR", type=Path,
                    help="run as one rank of phase 24a's pp 2 x dp 2 and pp "
                    "2 x mp 2 (the port's launcher starts four), writing its "
                    "results into DIR")
    ap.add_argument("--pp-of", metavar="DIR", type=Path,
                    help="only build and run phase 24 with the package in "
                    "DIR, and exit")
    ap.add_argument("--split-of", metavar="DIR", type=Path,
                    help="only build and run phase 23 (its workers take "
                    "[22c]'s step and gathered save themselves) with the "
                    "package in DIR, and exit")
    ap.add_argument("--mx-of", metavar="DIR", type=Path,
                    help="only build and run phase 22 (with [21a]'s one "
                    "process, its reference) with the package in DIR, and "
                    "exit")
    ap.add_argument("--ep-of", metavar="DIR", type=Path,
                    help="only build and run phase 21 with the package in "
                    "DIR, and exit")
    ap.add_argument("--zero3-of", metavar="DIR", type=Path,
                    help="only build, run phase 3's AdamW timing, [18b] and "
                    "[19b] (the references) and [20] with the package in "
                    "DIR, and exit")
    ap.add_argument("--mp-of", metavar="DIR", type=Path,
                    help="only build, run phase 3's checks at the mp and "
                    "ZeRO shapes, [18b] (the reference) and [19] with the "
                    "package in DIR, and exit")
    ap.add_argument("--train-of", metavar="DIR", type=Path,
                    help="only run phase 3's AdamW timings, phase 6's step "
                    "and phase 8's recompute policies with the package in "
                    "DIR (a checkout of another commit, or this one), and "
                    "exit")
    ap.add_argument("--moe-of", metavar="DIR", type=Path,
                    help="only run phase 16's GPT-MoE step with the package "
                    "in DIR (a checkout of another commit, or this one), "
                    "and exit")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test runs on the "
              "card only", file=sys.stderr)
        return 2
    repo = (args.paged_shapes_of or args.train_of or args.moe_of
            or args.mp_of or args.zero3_of or args.ep_of or args.mx_of
            or args.split_of or args.pp_of
            or Path(__file__).parent).resolve()
    if not (repo / "paddle_tpu_torch" / "__init__.py").exists():
        print(f"chip_smoke: no paddle_tpu_torch package in {repo}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    chain = [(name, getattr(args, name)) for name in WORKERS
             if getattr(args, name)]
    if chain:  # one rank of one phase, or of several chained (WORKERS)
        from paddle_tpu_torch import distributed as dist
        from paddle_tpu_torch.distributed import (communication, mesh,
                                                  topology)

        for name, directory in chain:
            # each phase starts as a process of its own would: no
            # topology or mesh yet (a model built before its fleet.init
            # is whole), its own staged-op counts
            topology.set_hybrid_communicate_group(None)
            mesh.reset_global_mesh()
            communication.staged_ops.clear()
            globals()[name](directory, args.seed)
            gc.collect()  # the next phase starts with the card's memory free
            torch.cuda.empty_cache()
        HELD.clear()
        dist.barrier()  # no rank leaves while a peer's receive is in flight
        dist.destroy_process_group()
        return 0
    t_start = time.perf_counter()
    if args.paged_shapes_of:
        from paddle_tpu_torch import kernels as K

        print(f"[1] device: {nvidia_smi_line()}; paged_attention of {repo}",
              flush=True)
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        symbols = dict(zip(args.paged_symbols, args.paged_symbols)) \
            if args.paged_symbols else PAGED_SYMBOLS
        shapes = paged_shapes(K, gen, symbols)
        check(all(sh["device_ms"] is not None for sh in shapes),
              f"the profiler did not see {' and '.join(symbols.values())}")
        print(json.dumps({"paged_shapes": shapes}), flush=True)
        return 0
    if args.mp_of:
        from paddle_tpu_torch import kernels as K
        from paddle_tpu_torch.kernels import _build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"[1] device: {nvidia_smi_line()}; mp and ZeRO of {repo}",
              flush=True)
        print(f"[2] nvcc built in {_build.build_all():.1f} s", flush=True)
        rows = {name: {} for name in ALL_KERNELS}
        mp_kernel_checks(K, torch.Generator(device="cuda").manual_seed(
            args.seed), rows)
        launch_chain(["--dp-worker", "--tp-worker", "--zero-worker"],
                     args.seed, 2, "[18b], [19]: two ranks on one card")
        ref = dp_two_ranks(K, args.seed, rows)
        tp_two_ranks(K, args.seed, rows, ref, one_process_main(args.seed))
        zero_two_ranks(K, args.seed, rows, ref)
        print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.zero3_of:
        from paddle_tpu_torch import kernels as K
        from paddle_tpu_torch.kernels import _build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"[1] device: {nvidia_smi_line()}; ZeRO-3 and grad_reduce of "
              f"{repo}", flush=True)
        print(f"[2] nvcc built in {_build.build_all():.1f} s", flush=True)
        rows = {name: {} for name in ALL_KERNELS}
        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        adamw_vs_library(K, gen, rows)
        launch_chain(["--dp-worker", "--zero-worker", "--z3-worker",
                      "--reduce-worker"], args.seed, 2,
                     "[18b], [19b], [20]: two ranks on one card")
        ref = dp_two_ranks(K, args.seed, rows)
        os_g = zero_two_ranks(K, args.seed, rows, ref)
        z3_nccl_slice(K, args.seed, rows, float("nan"))
        z3_two_ranks(K, args.seed, rows, ref, os_g,
                     one_process_main(args.seed))
        reduce_two_ranks(K, args.seed, rows)
        print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.ep_of:
        from paddle_tpu_torch import kernels as K
        from paddle_tpu_torch.kernels import _build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"[1] device: {nvidia_smi_line()}; expert parallelism of "
              f"{repo}", flush=True)
        print(f"[2] nvcc built in {_build.build_all():.1f} s", flush=True)
        rows = {name: {} for name in ALL_KERNELS}
        launch_chain(["--ep-worker"], args.seed, 2,
                     "[21a]: two ranks on one card")
        launch_chain(["--ep4-worker"], args.seed, 4,
                     "[21b]: four ranks on one card")
        cfg_ep, ref_ep = ep_two_ranks(K, args.seed, rows, float("nan"))
        ep_four_ranks(K, args.seed, rows, cfg_ep, ref_ep)
        print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.mx_of:
        from paddle_tpu_torch import kernels as K
        from paddle_tpu_torch.kernels import _build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"[1] device: {nvidia_smi_line()}; GPT-MoE at mp, grad_reduce "
              f"at ep and resharding of {repo}", flush=True)
        print(f"[2] nvcc built in {_build.build_all():.1f} s", flush=True)
        rows = {name: {} for name in ALL_KERNELS}
        launch_chain(["--mx-worker"], args.seed, 2,
                     "[22]: two ranks on one card")
        launch_chain(["--mx4-worker"], args.seed, 4,
                     "[22a]: four ranks on one card")
        cfg_ep, ref_ep = ep_reference(args.seed)
        mx_ranks(K, args.seed, rows, cfg_ep, ref_ep, float("nan"))
        print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.split_of:
        from paddle_tpu_torch import kernels as K
        from paddle_tpu_torch.kernels import _build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"[1] device: {nvidia_smi_line()}; serving a split model and "
              f"the sharded save of {repo}", flush=True)
        print(f"[2] nvcc built in {_build.build_all():.1f} s", flush=True)
        rows = {name: {} for name in ALL_KERNELS}
        launch_chain(["--split-worker"], args.seed, 2,
                     "[23]: two ranks on one card")
        launch_chain(["--split4-worker"], args.seed, 4,
                     "[23c]: four ranks on one card")
        split_ranks(K, args.seed, rows)
        print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.pp_of:
        from paddle_tpu_torch import kernels as K
        from paddle_tpu_torch.kernels import _build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"[1] device: {nvidia_smi_line()}; pipeline parallelism of "
              f"{repo}", flush=True)
        print(f"[2] nvcc built in {_build.build_all():.1f} s", flush=True)
        rows = {name: {} for name in ALL_KERNELS}
        launch_chain(["--pp-worker"], args.seed, 2,
                     "[24]: two ranks on one card")
        launch_chain(["--pp4-worker"], args.seed, 4,
                     "[24a]: four ranks on one card")
        pp_ranks(K, args.seed, rows)
        print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
        return 0
    if args.train_of:
        from paddle_tpu_torch import kernels as K
        from paddle_tpu_torch.kernels import _build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"[1] device: {nvidia_smi_line()}; training of {repo}",
              flush=True)
        print(f"[2] nvcc built in {_build.build_all():.1f} s", flush=True)
        rows = {name: {} for name in TRAINING_KERNELS}
        adamw_vs_library(K, torch.Generator(device="cuda").manual_seed(
            args.seed), rows)
        train_slice(K, args.seed, rows)
        t0 = time.perf_counter()
        train_surface(K, args.seed)
        print(f"    phase 8 took {time.perf_counter() - t0:.1f} s",
              flush=True)
        return 0
    if args.moe_of:
        from paddle_tpu_torch import kernels as K
        from paddle_tpu_torch.kernels import _build

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"[1] device: {nvidia_smi_line()}; GPT-MoE training of {repo}",
              flush=True)
        print(f"[2] nvcc built in {_build.build_all():.1f} s", flush=True)
        moe_train_slice(K, args.seed, {name: {} for name in TRAINING_KERNELS})
        return 0

    # ---- 1. device
    smi = nvidia_smi_line()
    print(f"[1] device: {smi}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("    TF32 off for float32 matmul and cuDNN", flush=True)

    # ---- 2. build
    from paddle_tpu_torch import kernels as K
    from paddle_tpu_torch.kernels import _build

    secs = _build.build_all()
    print(f"[2] nvcc built {_build.sources()} in {secs:.1f} s "
          f"into {_build.BUILD}", flush=True)
    for name, log in sorted(_build.build_log.items()):
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                print(f"    {name}: {m.group(1)}", flush=True)
            elif "registers" in line or "spill" in line:
                print(f"    {name}:   {line.strip()}", flush=True)
    # the bf16 flash kernels' products run on the tensor cores: HGMMA in
    # their SASS
    for lib, symbols in SM90_LIBS.items():
        hgmma = sass_counts(_build.BUILD / f"lib{lib}.so", "HGMMA")
        for sym in symbols:
            found = {fn: n for fn, n in hgmma.items() if sym in fn}
            print(f"    HGMMA instructions in {sym}: {found}", flush=True)
            check(found and all(n > 0 for n in found.values()),
                  f"no HGMMA in {sym}: {found}")
    t0 = time.perf_counter()
    x = torch.randn(4, 2048, device="cuda")
    K.fused_layer_norm(x, torch.ones(2048, device="cuda"),
                       torch.zeros(2048, device="cuda"))
    K.fused_rms_norm(x, torch.ones(2048, device="cuda"))
    torch.cuda.synchronize()
    print(f"    CUDA LayerNorm and RMSNorm first launches "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    P = K.primitive
    ops = {name: P.elementwise_kernel(fn)
           for name, fn in ELEMENTWISE_FNS.items()}
    ops.update({name: P.row_reduce_kernel(fn, init)
                for name, (fn, init) in REDUCE_FNS.items()})
    for dtype in (torch.float32, torch.bfloat16):
        xd = x.to(dtype)
        for name in ELEMENTWISE_FNS:
            ops[name](xd, xd, xd)
        for name in REDUCE_FNS:
            ops[name](xd)
    torch.cuda.synchronize()
    print(f"    Triton primitives {sorted(ops)} (fp32, bf16) JIT + first "
          f"launch {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 3. kernels vs plain
    print("[3] kernels vs plain on the card", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rows = kernel_checks(K, gen)
    norm_checks(K, gen, rows)
    train_kernel_checks(K, gen, rows)
    flash_fp32_routes(K, gen, rows)
    mp_kernel_checks(K, gen, rows)
    adamw_vs_library(K, gen, rows)
    primitive_checks(P, ops, gen, rows)

    # ---- 4. slice at full width
    from paddle_tpu_torch.models.gpt import GPT3_1p3B, GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.serving import Engine, EngineConfig, SamplingParams

    cfg = GPTConfig(**GPT3_1p3B)
    t0 = time.perf_counter()
    model = GPTForCausalLM(
        cfg, device="cuda", dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(args.seed))
    nparams = sum(p.numel() for p in model.parameters())
    eng_cfg = EngineConfig(max_batch_size=8, max_seq_len=2048)
    eng = Engine(model, eng_cfg, device="cuda")
    torch.cuda.synchronize()
    print(f"[4] GPT-3 1.3B ({nparams / 1e9:.3f} B params, bf16, "
          f"{cfg.num_layers} layers) + engine (B {eng_cfg.max_batch_size}, "
          f"S_max {eng_cfg.max_seq_len}, page {eng.cache.page_size}, KV "
          f"{eng.cache.nbytes / 2**30:.2f} GiB) in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rng = torch.Generator().manual_seed(args.seed)
    warm, lengths, prompts = served_prompts(rng, cfg.vocab_size)
    sp = SamplingParams(max_new_tokens=32)

    def serve():
        reqs = [eng.add_request(p, sp) for p in prompts]
        while eng.has_unfinished:
            eng.step()
        torch.cuda.synchronize()
        return reqs

    def check_outs(outs, what):
        check(all(len(o) == 32 for o in outs),
              f"{what}: a request did not generate 32 tokens")
        check(all(0 <= t < cfg.vocab_size for o in outs for t in o),
              f"{what}: token id out of range")

    # the main path's run, from the counts' reset: one warm-up request per
    # prefill bucket of the 16 prompts and the 64-token one (each captures
    # its bucket's prefill program, the first also the decode step), then
    # the 16 requests under the profiler. The wrappers count their
    # launches (eager ones, a capture's warm-up run and the capture); the
    # profiler's kernel events count what ran on the card, graph replays
    # included, and are held to the wrappers' eager launches (none: every
    # program is a replay by then) and the replays
    K.reset_launch_counts()
    buckets = sorted({eng._bucket(n) for n in [len(warm)] + lengths})
    mem0 = torch.cuda.memory_reserved()
    eng.generate([warm * (T // len(warm)) for T in buckets],
                 SamplingParams(max_new_tokens=4))
    torch.cuda.synchronize()
    print(f"    warm-up requests of {buckets} tokens: graph programs "
          f"{graph_programs(eng)}; memory reserved {mem0 / 2**30:.2f} -> "
          f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB", flush=True)
    L = cfg.num_layers
    served = []

    def profiled_requests():
        """The 16 requests under a profiler window: the replays and the
        eager launches in it, the kernels the card ran by the profiler,
        and what the replays run: a decode step 2 LayerNorms a block and
        the final one, one paged decode (split + combine) a block; a
        prefill the same LayerNorms and one flash forward a block."""
        eager0, replays0 = K.launch_counts(), replays_of(eng)
        kernels = profile_launches(lambda: served.append(serve()))
        got = K.launch_counts()
        replays = {k: n - replays0.get(k, 0)
                   for k, n in replays_of(eng).items()}
        eager = {k: got[k] - eager0[k] for k in SERVING_KERNELS}
        n_dec = replays["decode"]
        n_pre = sum(n for k, n in replays.items() if k.startswith("prefill:"))
        want = {"fused_layer_norm": {NORM_SYMBOLS["fwd"]:
                                     (2 * L + 1) * (n_dec + n_pre)},
                "flash_attention_fwd": {FWD_SYMBOL: L * n_pre},
                "paged_attention": {sym: L * n_dec
                                    for sym in PAGED_SYMBOLS.values()}}
        device = {k: launches_of(kernels, syms)
                  for k, syms in SERVING_SYMBOLS.items()}
        return replays, eager, device, want, n_dec, n_pre

    replays, eager, device, want, n_dec, n_pre = profiled_requests()
    counts = K.launch_counts()
    check_outs([r.output_ids for r in served[0]], "[4]")
    # a window short of what the replays ran lost kernel records, as
    # ``replay_launches`` allows: the requests run again under a new
    # window, up to REPLAY_WINDOWS windows; a count above it fails
    for k in range(1, REPLAY_WINDOWS):
        over = any(device[w][s] > want[w][s] for w in want for s in want[w])
        if device == want or over or any(eager.values()):
            break
        print(f"    [4]: profiler window {k} of {REPLAY_WINDOWS} saw "
              f"{device}, short of {want}", flush=True)
        replays, eager, device, want, n_dec, n_pre = profiled_requests()
    print(f"    the main path's run: the warm-up requests, then "
          f"{len(prompts)} requests (prompt lengths {lengths}) under the "
          f"profiler: replays {replays}", flush=True)
    print(f"    wrapper launches over the run: {counts} (of them in the 16 "
          f"requests, eager: {eager})", flush=True)
    print(f"    kernel launches on the card in the 16 requests (profiler): "
          f"{device}", flush=True)
    check(n_dec > 0 and n_pre == len(prompts)
          and not any(eager.values()) and device == want,
          f"[4]: the profiler's kernel launches {device} are not the "
          f"replays' ({replays}) {want}, or a kernel ran eagerly: {eager}")

    # the same requests again, without the profiler, for the clocks
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    reqs = serve()
    wall = time.perf_counter() - t0
    outs = [r.output_ids for r in reqs]
    check_outs(outs, "[4] timed")
    n_tok = sum(len(o) for o in outs)
    ttft, tpot = request_latencies(reqs)
    captures = {name: st.captures for name, st in eng.steps.items()}
    print(f"    the 16 requests again: {n_tok} tokens in {wall:.3f} s = "
          f"{n_tok / wall:.1f} tokens/s; tokens equal the profiled run's: "
          f"{outs == [r.output_ids for r in served[0]]}", flush=True)
    print(f"    TTFT p50 {ttft:.1f} ms, TPOT p50 {tpot:.2f} ms, max memory "
          f"allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"captures per program {captures}", flush=True)
    SERVED["summary"] = (f"{n_tok / wall:.1f} tokens/s, TTFT p50 {ttft:.1f} "
                         f"ms, TPOT p50 {tpot:.2f} ms, KV cache "
                         f"{eng.cache.nbytes / 2**30:.3f} GiB")
    check(set(captures) == {"decode", *(f"prefill:{T}" for T in buckets)}
          and set(captures.values()) == {1}, f"[4]: captures {captures}")
    check(all(counts[k] > 0 for k in SERVING_KERNELS),
          f"a kernel of the path was never launched: {counts}")
    routes = check_flash_routes(K, "wgmma", "[4]")
    paged_routes = dict(K.paged_attention.route_launches)
    print(f"    flash forward by route: {routes['flash_attention_fwd']}; "
          f"paged decode by route: {paged_routes}", flush=True)
    check(paged_routes["vector"] == counts["paged_attention"],
          f"[4]: a paged decode left the vector route: {paged_routes}")
    for name in SERVING_KERNELS:
        rows[name]["launches"] = counts[name]
        rows[name]["device_launches"] = device[name]
    rows["flash_attention_fwd"]["route_launches"] = \
        routes["flash_attention_fwd"]
    rows["paged_attention"]["route_launches"] = paged_routes
    where_time_goes(model, eng, prompts, SamplingParams)
    del eng
    graph_vs_eager(model, prompts, sp, outs)
    torch.cuda.empty_cache()
    graph_memory(model, eng_cfg)

    # ---- 11. prefix cache + speculative decoding at full width
    t0 = time.perf_counter()
    spec_prompts = prefix_spec_prompts(
        cfg.vocab_size, torch.Generator().manual_seed(args.seed + 11))
    prefix_spec_slice(K, model, spec_prompts)
    print(f"    phase 11 took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 13. GPTForCausalLM.generate; 14. the dense engine, at full width
    generate_slice(K, model, rows, args.seed)
    dense_engine_slice(K, model, prompts, lengths, sp, outs, rows)
    del model
    torch.cuda.empty_cache()

    # ---- 5. slice vs plain, fp32, depth 2
    cfg2 = GPTConfig(**{**GPT3_1p3B, "num_layers": 2})
    t0 = time.perf_counter()
    cpu_model = GPTForCausalLM(
        cfg2, device="cpu", dtype=torch.float32,
        generator=torch.Generator().manual_seed(args.seed))
    gpu_model = GPTForCausalLM(cfg2, device="cuda", dtype=torch.float32)
    gpu_model.load_state_dict(cpu_model.state_dict())
    prompts = [torch.randint(0, cfg2.vocab_size, (n,), generator=rng).tolist()
               for n in (17, 100, 45)]
    sp = SamplingParams(max_new_tokens=8)
    small = dict(max_batch_size=2, max_seq_len=2048)
    K.reset_launch_counts()
    out_gpu = Engine(gpu_model, EngineConfig(**small),
                     device="cuda").generate(prompts, sp)
    counts = K.launch_counts()
    out_cpu = Engine(cpu_model, EngineConfig(**small),
                     device="cpu").generate(prompts, sp)
    print(f"[5] depth-2 fp32 full width: card {out_gpu}", flush=True)
    print(f"    plain on the CPU            {out_cpu}", flush=True)
    check(out_gpu == out_cpu, "greedy tokens differ between the kernels on "
          "the card and the plain versions on the CPU")
    check(all(counts[k] > 0 for k in SERVING_KERNELS),
          f"kernels not used: {counts}")
    routes = check_flash_routes(K, "cuda_cores", "[5]")
    print(f"    flash forward by route on the card: "
          f"{routes['flash_attention_fwd']}", flush=True)
    with torch.no_grad():
        lg = decode_logits(gpu_model, prompts[1], out_gpu[1], "cuda")
        lc = decode_logits(cpu_model, prompts[1], out_cpu[1], "cpu")
        err = max_err(lg.cpu(), lc)
        print(f"    last decode logits card vs CPU: max_abs_err {err:.3e} "
              f"(tol 1e-3)", flush=True)
        check(err <= 1e-3, f"decode logits differ: {err}")
        full = prompts[1] + out_gpu[1][:-1]
        n = len(full)
        T = 1 << max(3, (n - 1).bit_length())
        ids = torch.zeros((1, T), dtype=torch.long)
        ids[0, :n] = torch.tensor(full)
        lp, _ = gpu_model.prefill_with_cache(
            ids.cuda(), lengths=torch.tensor([n], device="cuda"))
        err = max_err(lp[0], lg)
        print(f"    flash prefill vs paged decode logits on the card: "
              f"max_abs_err {err:.3e} (tol 1e-3); argmax "
              f"{int(lp[0].argmax())} vs generated {out_gpu[1][-1]}",
              flush=True)
        check(err <= 1e-3 and int(lp[0].argmax()) == out_gpu[1][-1],
              f"prefill/decode disagree: {err}")
    print(f"    phase 5 took {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 12. prefix cache + speculative decoding vs plain, fp32, depth 2
    prefix_spec_vs_plain(K, gpu_model, cpu_model, spec_prompts)
    dense_vs_plain(K, gpu_model, cpu_model, rng)
    del cpu_model, gpu_model
    torch.cuda.empty_cache()

    # ---- 6. training slice at full width; 7. training vs plain
    step6_s = train_slice(K, args.seed, rows)
    train_vs_plain(K, args.seed)

    # ---- 8. training surface at full width; 9. surface vs plain;
    #      10. RMSNorm and the primitives through the user-facing API
    t0 = time.perf_counter()
    train_surface(K, args.seed)
    print(f"    phase 8 took {time.perf_counter() - t0:.1f} s", flush=True)
    surface_vs_plain(K, args.seed)
    user_api_path(K, ops, rows)

    # ---- 15. checkpoint, data and resume at full width; with dropout
    ckpt_resume_slice(K, args.seed, rows, step6_s)
    dropout_resume(args.seed)

    # ---- 16. GPT-MoE training (config 5); 17. GPT-MoE serving
    step16_s = moe_train_slice(K, args.seed, rows)
    moe_train_vs_plain(K, args.seed)
    moe_serve_slice(K, args.seed, rows)
    moe_serve_vs_plain(K, args.seed)

    # ---- 18. data parallelism: NCCL at world size 1; two ranks on the card
    dp_nccl_slice(K, args.seed, rows, step6_s)
    # the ranks of [18b]-[22]: one launcher start for each world size, its
    # ranks running every phase's worker in turn; each phase then reads
    # its ranks' records
    launch_chain(["--dp-worker", "--tp-worker", "--zero-worker",
                  "--z3-worker", "--reduce-worker", "--ep-worker",
                  "--mx-worker", "--split-worker", "--pp-worker"], args.seed,
                 2, "[18b]-[24]: two ranks on one card, every phase's worker")
    launch_chain(["--ep4-worker", "--mx4-worker", "--split4-worker",
                  "--pp4-worker"], args.seed, 4,
                 "[21b], [22a], [23c], [24a]: four ranks on one card, every "
                 "phase's worker")
    ref = dp_two_ranks(K, args.seed, rows)

    # ---- 19. tensor parallelism and ZeRO, two ranks on the card
    one = one_process_main(args.seed)
    tp_two_ranks(K, args.seed, rows, ref, one)
    os_g = zero_two_ranks(K, args.seed, rows, ref)

    # ---- 20. ZeRO stage 3 (one NCCL rank; two ranks on the card) and the
    #      gradient reductions at dp 2
    z3_nccl_slice(K, args.seed, rows, step6_s)
    z3_two_ranks(K, args.seed, rows, ref, os_g, one)
    reduce_two_ranks(K, args.seed, rows)

    # ---- 21. expert parallelism: ep 2, and sharding 2 x ep 2 at p_g_os
    cfg_ep, ref_ep = ep_two_ranks(K, args.seed, rows, step16_s)
    ep_four_ranks(K, args.seed, rows, cfg_ep, ref_ep)

    # ---- 22. GPT-MoE at mp and at ep x mp, grad_reduce at ep, resharding
    mx_ranks(K, args.seed, rows, cfg_ep, ref_ep, step16_s)

    # ---- 23. serving a split model and the sharded save; grad_reduce over
    #      a MoELayer's experts at ep
    split_ranks(K, args.seed, rows)

    # ---- 24. pipeline parallelism: pp 2 (with dp 2 and mp 2), the 1.3B
    #      pipelined, the sharded save
    pp_ranks(K, args.seed, rows)

    # ---- results
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"kernels": [rows[k] for k in ALL_KERNELS]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
