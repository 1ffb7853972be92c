#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, trainer, int8 serving, transformer (ViT) and ResNet paths,
its model loading, its serving CLI, its evals, its real-data sources, its frozen serving programs, its
release, its C++ tokenizer and its data-parallel layer on one CUDA card and check its kernels.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) when it fails:

1. Build every ``clip_mixer_tpu_torch/csrc/*.cu`` with ``nvcc`` (one process
   per source, all started together) and hold each kernel against its plain
   PyTorch version on the card at the shapes the serving and training paths
   give it (``ln_mlp`` at both towers' buckets 128 and 8 (the text tower's
   bucket 8 is what the serving CLI's text requests send) and at the train
   batches 256 and 4096, ``preprocess`` at B = 128, 8 and 1 and at other
   input shapes, odd widths too, in bf16 and f32, at 384x384 -> 336
   (``vit-l14-336``'s output size) in bf16, and at the ResNet presets'
   sizes, 256 -> 288, 384 -> 384 and 512 -> 448 at B = 8 in both dtypes,
   each plan within 110,672 bytes of shared memory), and ``fused_mixer_block_tbd``
   at both towers' buckets 128 and 8 and the train batch 256, a B no batch
   tile divides, and f32), and each of
   ``ln_mlp``'s three bf16 stages (LN pass, GEMM 1 with QuickGELU, GEMM 2
   with the residual) against its plain version, and the bf16 block's
   first launch alone (``token_mix``: z and y2 = LN_ch(z)) against
   ``token_mix_plain`` in both layouts, its three launches composed against
   the fused call; one backward in f32 and one in bf16 (x in bf16, the
   parameters f32 masters) through ``mixer_block_fused`` and through
   ``ln_mlp`` against autograd of the model's unfused chain; then a small f32 model with the fused channel mix, and the
   same model with its towers through ``mixer_tower_fused``, on the card
   against the CPU.
2. The main path, with every launch counter set to 0 first: a full-width
   Mixer-B/32 (bf16, ``fused_mlp=True``, random weights from seed 0) behind
   an ``InferenceEngine`` that takes 256x256 uint8 images, warmed up, then
   serving text, image and similarity requests through the engine API and
   ``/healthz`` + ``/encode_text`` through the HTTP server on 127.0.0.1; then
   the bench front end, ``make_batch_preprocess(backend="kernel")`` ->
   ``encode_image`` at batch 128. Each call's launches are checked, and the
   features against the same weights with the plain channel mix
   (``fused_mlp=False``): cosine >= 0.999.
2b. The fused-block path, with every launch counter set to 0 first: the
   same Mixer-B/32 with ``fused_mlp=False`` and both towers' ``forward``
   bound to ``mixer_tower_fused`` (the model's own ``encode_image`` /
   ``encode_text`` run unchanged), warmed up, then ``encode_text`` of 5 and
   40 captions, ``encode_image_arrays`` of 7 and 100 images and the kernel
   front end at batch 128: 12 block launches per tower call and none of
   ``ln_mlp``; features against the plain towers: cosine >= 0.999.
3. Time each kernel and its plain version with CUDA events (``preprocess``
   warm, on the same inputs, and cold, on inputs rotated over more than
   twice the 50 MB L2, at B = 128 and 8; ``ln_mlp``
   and the bf16 block also stage by stage, each beside the model's own bf16
   chain for the same function, ``torch_chain_ms``: the non-fused channel
   mix, and ``MixerBlock.forward``), and each tower at bucket 128 three
   ways: through ``mixer_tower_fused``, with ``fused_mlp=True``, and plain.
4. Training, with every launch counter set to 0 before each run: full-width
   Mixer-B/32 (bf16 compute, f32 masters, ``TrainConfig`` defaults, weights
   from seed 0) takes 8 steps of ``parallel/train_step.py`` on a fixed
   batch of 256 (numpy seed) on each of three routes: plain, ``fused_mlp``
   (24 ``ln_mlp`` launches a step) and fused-block (``route_towers``; 24
   ``fused_mixer_block`` launches a step). Each route's loss must fall, and
   at step 1 the kernel routes' loss and every parameter's gradient must
   match the plain route's. Then GradCache (``accum_steps=4``): its first
   step against the full batch's; plain under each remat policy at 256
   (the same loss as without remat, peak memory ordered none < mlp_hidden <
   all_hidden < no remat), and ``fused_mlp`` with ``all_hidden``; and at
   the reference's per-card batch of 4096 ``fused_mlp`` with full remat (24
   ``ln_mlp`` launches a step: a block's recompute launches nothing) and
   plain with ``accum_steps=8``, two steps each, the second timed, whose
   first steps' loss and gradient norm must agree.
   Reports step time (CUDA events over steps 3-8 on the routes), images a
   second, peak memory and
   ``train_mfu`` (3x the analytic forward FLOPs of both towers over the
   989 TFLOP/s bf16 peak).

5. The trainer stack, with every launch counter set to 0 before each run:
   full-width Mixer-B/32 (bf16 compute, f32 masters, ``fused_mlp=True``,
   remat on, EMA 0.999) trained by ``train/trainer.py`` at B = 256 over a
   disk-backed ``CacheSource(SyntheticSource(n_batches=4))`` for 3 epochs
   (12 steps), checkpointing every 4 steps and keeping 2. Run A runs
   through; run C runs the same in a fresh directory (the determinism
   witness); run B is crashed by the ``crash_after_steps=6`` drill, which
   must raise, and a new Trainer resumes it from step 4. B's and C's final
   parameters, Adam moments and EMA are held against A's: bit for bit when
   C is A bit for bit, else no further from A than C is. Each run launches
   ``ln_mlp`` 24 times a step and nothing else; A's 12th loss is below its
   first, its 12 losses are those of ``make_train_step`` run bare over the
   same batches, bit for bit (the bare step is also timed, and run at three
   other learning rates, ``LR_PROBE``, whose losses are reported), and its
   ``metrics.jsonl`` holds a Loss row a step and a Throughput row a
   boundary. Then one epoch fed straight from
   ``SyntheticSource``, the export of run A loaded by ``load_pretrained``
   into ``InferenceEngine`` (5 captions and 7 images against A's EMA through
   the same towers: cosine >= 0.999 a row), and ``train_cli`` in a
   subprocess (B = 64, 2 steps), which must exit 0 and write
   ``export/model.pt``. Reports images a second (steady, cached and not),
   ms a step and its data wait, save ms and bytes, restore, export and
   load ms, and peak memory.

6. int8 (W8A8) serving, with every launch counter set to 0 first:
   full-width Mixer-B/32 (bf16, weights from seed 0) behind an
   ``InferenceEngine`` that ``enable_int8`` calibrates on 128
   ``synthetic_images`` at 224x224 and 128 fixed captions (the vision
   ch_hidden site holds 19.7 M values, above ``torch.quantile``'s 2^24) and
   saves as an artifact, which a second engine loads: the same features bit
   for bit. The int8 text tower in f32 compute on the card must give its
   CPU computation (same weights and scales) block by block at per-row
   cosine >= 0.9999 (a block with a bias zeroed must not), and its
   features at >= 0.999. Then per-row cosine of the int8 features against bf16; the
   three noise-floor gates, each on 4096 inputs: model-sized images and the
   planar front end from 256x256, which must pass, and the text tower on
   4096 fixed captions, whose verdict decides whether text is served int8
   (a tower is served int8 only if its gate passed, as the JAX package's
   release refuses int8 on a failed gate; the JAX package's own text gate
   fails at this width too, ``scripts/torch_int8_text_gate_witness.py``);
   an int8 engine on 256x256 sources
   (the planar front end) serving
   ``/encode_text``, ``/encode_image`` (``.npy`` images), ``/classify``,
   ``/index`` and ``/retrieve`` over HTTP; a 262,144 x 512 f32 bank on the
   card, whose top-5 ids must equal the host bank's. None of the three
   kernels may launch. Then the timing (CUDA events): each int8 tower at
   buckets 8 and 128 beside the fused-block, ``fused_mlp`` and plain bf16
   towers, in turns; ``torch._int_mm`` alone at the channel-mix shapes
   (the modules' [out, in] layout) beside a bf16 ``torch.matmul``, in TOPS
   against the 1,979 int8 peak; the planar front end at B = 128 beside
   ``preprocess``.

7. The transformer towers, with every launch counter set to 0 before each
   part and read after it (no kernel of ours runs in the towers: attention
   and the MLP are plain PyTorch, op for op the JAX chain). 7a: full-width
   ViT-B/32 (bf16, weights from seed 0) behind an ``InferenceEngine`` on
   256x256 sources, warmed up, serving ``encode_text`` of 5 captions,
   ``encode_image_arrays`` of 7 images and ``similarity``; then
   ``make_batch_preprocess(backend="kernel")`` -> ``encode_image`` at
   B = 128 (one ``preprocess`` launch) against the ``"torch"`` front end
   with the same towers (cosine >= 0.999); the towers at buckets 8 and 128
   (CUDA events, 10 calls, in turns); f32 on the card (TF32 off) against
   f32 on the CPU at B = 4 (cosine >= 0.99999). 7c: ViT-B/32 int8:
   calibration on 128 images and 128 captions, its artifact served bit for
   bit by a second engine, the image and text gates at n = 4096, an engine
   on 256x256 sources that serves int8 only the towers whose gate passed,
   the int8 text features unmoved by tokens after the EOT (bit for bit on
   the card), and the int8 towers timed beside the bf16 ones. 7b:
   full-width ViT-L/14 (bf16): the towers at buckets 8 and 128, the front
   end + ``encode_image`` at B = 128 both ways, f32 on the card against the
   CPU at B = 2 (>= 0.99999) and bf16 against f32 on the card
   (``VIT_L_BF16_COSINE``). 7d: ViT-B/32 trains 8 steps at B = 256 on one
   fixed batch at ``TrainConfig``'s defaults in bf16 and in f32 (reported:
   it falls to the uniform-logit plateau) and at ``VIT_TRAIN_LR`` (the 8th
   loss <= 0.9x the first), then one step under each
   remat policy (the same loss bits, the gradient norm within 1e-4);
   step ms, images a second, peak memory and ``train_mfu`` from
   ``vit_flops``.

8. The ResNet vision tower, with every launch counter set to 0 before each
   part and read after it: full-width RN50 (bf16, weights from seed 0 with
   every BN site drawn from a numpy seed, ``perturb_bn``: the seed-0 init's
   zero ``bn3`` scales would leave each bottleneck's main branch adding
   nothing). 8a: an ``InferenceEngine`` on 256x256 sources, warmed up,
   serving ``encode_text`` of 5 captions, ``encode_image_arrays`` of 7
   images, ``similarity`` and ``/healthz`` + ``/encode_text`` over HTTP; the
   front end through ``preprocess`` (one launch) -> ``encode_image`` at
   B = 128 against the ``"torch"`` front end (cosine >= 0.999); the towers
   at buckets 8 and 128 in turns. 8b: f32 on the card (cuDNN without TF32)
   against the CPU at B = 2 (cosine >= 0.99999; one block's ``bn3`` skipped
   must fail it), bf16 against f32 on the card (``RN_BF16_COSINE``). 8c:
   int8: one bottleneck's int32 conv sums (and the stem's, K = 27) on the
   card equal to the CPU's; calibration on 128 images and 128 captions, its
   artifact (the per-stage scale tree) served bit for bit by a second
   engine; the image and text gates at n = 4096 (the image gate through
   the float front end); an engine on 256x256 sources serving int8 only
   the towers whose gate passed; the int8 towers timed beside bf16. 8d: 8
   steps at B = 256 on one fixed batch at ``TrainConfig``'s defaults
   (reported) and at ``VIT_TRAIN_LR`` (the 8th loss below the first, every
   running statistic moved); one step under ``freeze="visual"`` (every
   running statistic bit for bit) and one under per-bottleneck remat (step
   1's loss and running statistics bit for bit those without remat);
   step ms, images a second, peak memory and ``train_mfu`` from
   ``rn_flops``.

9. Model loading and the serving CLI, full-width Mixer-B/32 (seed-0
   weights, ``ln_final`` drawn from a numpy seed). 9a: the state dict as a
   reference-keyed fp16 ``.pt`` and as an Accelerate directory
   (``pytorch_model.bin``, ``{"state_dict"}`` with ``module.`` keys), each
   through ``api.load`` on the card: the sniffed config is the preset's,
   every tensor the fp16 value in f32, the two loads' features identical
   (a file with ``ln_final.bias`` zeroed must fail that check); f32 files
   of the seed ViT-B/32 and RN50 (BN drawn, ``num_batches_tracked`` left
   out) loaded and run at B = 2 against their source models (cosine >=
   0.99999). 9b: ``compat.load(<the .pt>, device="cuda")``, bf16, its
   triple on uint8 NHWC images against the engine's features (>= 0.999).
   9c: ``scripts/torch_calibrate_int8.py``'s ``run`` on 512 synthetic
   samples (the text tower only if phase 6's text gate passed), and
   ``scripts/torch_embed_dataset.py``'s ``embed`` over a tar of 1,024
   ``.npy`` 256x256 images through the int8 engine on 256x256 sources.
   9d: an export with ``fused_mlp=True`` served by ``build_server``
   (``--int8 --index --warmup --classifier --input-size 256``) in-process;
   with every launch counter set to 0 first, the port's ``ServingClient``
   calls every endpoint, each answer held to an in-process engine on the
   same export and artifact (cosine >= 0.99999, the same classify labels
   and retrieve ids) and the features also to an engine on the same
   weights and artifact with the unfused channel mix (cosine >= 0.999),
   and ``ln_mlp`` must launch 12 times for each call of
   a tower served bf16 and never for an int8 one; then ``python -m
   clip_mixer_tpu_torch.serving`` in a subprocess, timed to its first
   ``/healthz`` and asked one ``/encode_text``.

10. The evals and the real-data sources, full-width Mixer-B/32 (bf16, seed-0
   weights), every launch counter set to 0 before each part and read after
   it; ``CLIP_MIXER_OFFLINE=1`` for the whole run, so the remote-dataset
   validators skip without a DNS probe. 10a: the ImageNet zero-shot head,
   1000 classes x 80 templates (80,000 prompts), on the ``fused_mlp=True``
   config: the host tokenizer and the encode timed apart; an
   ``ImageNetValidator`` pass over 1,024 injected uint8 224x224 images
   (numpy seed) in batches of 256, which must launch ``ln_mlp`` exactly
   ceil(80000 / 1024) x 12 + 4 x 12 = 996 times and nothing else, its top-1
   and top-5 equal to a numpy count from the logits it computed (themselves
   within 1e-3 of numpy's 100 f @ W from its features and W); the same head
   through the fused-block route (``fused_mixer_block`` launched, no
   ``ln_mlp``) and the plain route (nothing launched), each kernel route
   against plain: every class column at cosine >= 0.999 and the logits
   within ``HEAD_LOGIT_TOL`` (the fused-block route with every text block's
   channel-mix output bias dropped must fail). 10b: two tar globs of 1,024
   ``.npy`` 224x224 samples with captions and a held-out glob of 2,048,
   written with ``tarfile``; ``TarShardSource`` (thread decode, 8 workers)
   and ``FileListSource.from_folder`` over 512 ``.npy`` files timed;
   ``MixtureSource`` at weights 2:1 over 64 batches of 256, the first
   corpus's share within 0.02 of 2/3; ``RetrievalValidator`` (2,048
   samples) on the fused-block route, its result equal to a numpy count of
   ranks from the features it computed. 10c: ``train_cli`` on the mixture
   (``::2`` / ``::1``, B = 256, 8 steps) with ``--val-data`` and the default
   validators, as a subprocess: the four remote ones skip at steps 4 and 8,
   each pass timed, and ``metrics.jsonl`` holds the retrieval rows at both;
   ``train_cli --cache-data`` over one glob; ``eval_cli`` with all five
   validators on the run's export; and a shard with a ``.jpg`` member under
   ``--on-decode-error substitute`` (``mixer-debug``: the decode is tested), which must exit non-zero with the
   ``ImportError`` naming Pillow where Pillow is absent (train where present).

11. Frozen serving programs, the release and the C++ tokenizer, full-width
   Mixer-B/32 (bf16, seed-0 weights), every launch counter set to 0 before
   each part and read after it. 11a: ``aot.export_servable`` of the
   ``fused_mlp`` model and of the fused-block route (buckets 8 and 128),
   each loaded by ``load_servable``: ``encode_text`` of 5 and 40 captions
   and ``encode_image_arrays`` of 7 and 100 images bit for bit the live
   engine's on the same model, with 12 ``ln_mlp`` (``fused_mlp``) or 12
   ``fused_mixer_block`` launches a tower call and nothing else; the plain
   route's programs (bucket 8) launch neither. Export seconds and ``.pt2``
   bytes a program, load seconds, and each tower at bucket 128 frozen
   beside live (CUDA events, in turns). 11b: int8 programs from an
   artifact of both towers (phase 6's calibration recipe), bit for bit the
   live int8 engine's, launching nothing. 11c: ``scripts/torch_release.py``
   on a port export: with its default int8 it must abort (``RELEASE
   ABORTED``: the text gate fails on these weights, n = 4,096) and freeze
   nothing; ``--no-int8`` then releases, ``--verify`` passes on it, and
   ``python -m clip_mixer_tpu_torch.serving`` started on it says it serves
   frozen programs and answers ``/healthz``, ``/encode_text`` and
   ``/encode_image`` bit for bit as an in-process ``load_servable``
   engine; ``train_cli --freeze-serving`` (``mixer-debug``, 2 steps)
   writes an export that ``load_servable`` serves. 11d: the C++
   tokenizer's build (before phase 1), and the 80,000 ImageNet prompts
   tokenized cold and warm, equal to the Python BPE's tokens, beside its
   time; the engine's tokens on the CPU tests' corpus equal the Python
   BPE's.

12. The data-parallel layer at full width in a world of one over NCCL (the
   card's host has one card, and NCCL takes no two ranks on one card),
   every launch counter read around the calls it counts. 12a: full-width
   Mixer-B/32 (bf16, f32 masters, EMA 0.999, augmentation on: 256x256
   sources cropped to 224) takes 3 steps at B = 256 on each route (plain,
   ``fused_mlp``: 24 ``ln_mlp`` launches a step, fused-block: 24
   ``fused_mixer_block`` launches a step) through ``make_train_step(...,
   group=)``, in turns with the single-device step on the same state and
   batches: each loss, and after the last step every parameter, buffer,
   Adam moment and EMA, bit for bit; one step each with
   ``grad_through_gather=True`` and with GradCache (``accum_steps=2``),
   bit for bit too. Reports each step's ms (CUDA events) and peak memory,
   both ways, and the flat gradient bucket: ``average_gradients`` ms and
   its all-reduce alone. 12b: RN50 (BN drawn) 2 steps at B = 256 with
   SyncBN, and one Mixer-B/32 SigLIP step through the ring's form of the
   loss (at a world of one, one tick and no hop), each bit for bit the
   single-device step. 12c: ``python -m clip_mixer_tpu_torch.train_cli
   --coordinator 127.0.0.1:<port> --num-processes 1 --process-id 0``
   (full-width Mixer-B/32, ``--fused-mlp``, global batch 256): 4 steps
   straight, beside a run the drill stops after its checkpoint at step 2,
   resumed by a third process; the two final checkpoints bit for bit;
   seconds to the first step. 12d: ``InferenceEngine(devices=[the card])``
   and ``export_servable(mesh=[the card])`` of full-width Mixer-B/32 on the
   fused-block and ``fused_mlp`` routes on 256x256 sources: text and image
   features bit for bit the single-device engine's, the bench front end
   (``preprocess`` a device chunk, then the image tower) split over the
   mesh bit for bit the single-device one, the device bank's top-5 alike,
   and the towers at bucket 128 timed three ways in turns.
13. Sharded training (FSDP2 and tensor parallelism), a world of one over
   NCCL. 13a: full-width Mixer-B/32 (bf16, EMA, augmentation) at B = 256
   takes 3 steps on each route (plain, ``fused_mlp``, fused-block) through
   ``make_fsdp_train_step`` on a model sharded by ``apply_fsdp``, beside the
   single-device and the data-parallel steps in turns: every loss, and every
   parameter, Adam moment and EMA entry after the last, bit for bit the
   single-device step's; 24 ``ln_mlp`` or ``fused_mixer_block`` launches a
   step on their routes; step ms (steps 2-3) and peak memory of the three.
   13b: ``shard_model_tp`` over a model group of one on Mixer-B/32 (plain)
   and ViT-B/32 (head-split attention), 2 steps each, bit for bit the whole
   model's (a group of one moves nothing across cards). 13c: ``train_cli
   --fsdp`` in a world of one: a run straight through, one stopped by the
   drill after its save at step 2 and resumed; the two last sharded
   checkpoints bit for bit; seconds to the first step.

Standard output ends with a JSON line per phase result, the kernels line,
the card's name and power limit, and last ``{"ok": true, "device": ...}``.
Without a CUDA device it exits 1 before doing anything.
"""

from __future__ import annotations

import base64
import copy
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

# Published H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and
# operations/s by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}

BF16_REL_TOL = 1e-2  # relative Frobenius error: bf16 keeps 8 significant bits
# ln_mlp bf16 is held on its branch, out - x, not on out: the residual is
# about 90% of the output's norm and would hide a dropped bias. Sound runs
# differ from the plain version by about 1e-3 of the branch (rare rounding
# flips of h and of the output); one that drops b_in or b_out differs by
# 4e-2 or more. Each run checks that the plain version with b_out zeroed
# fails the check.
LN_MLP_BRANCH_TOL = 5e-3
LN_MLP_F32_TOL = dict(atol=2e-4, rtol=1e-3)  # tests/test_pallas_kernels.py:57
# ln_mlp's bf16 stages y = LN(x) and h = QuickGELU(y W_in^T + b_in), each
# against its plain version on the same input: the same bf16 rounding of f32
# values that differ only in summation order, so sound runs differ by about
# 1e-4 (rare one-ulp flips). The third stage is held on its branch, as
# ln_mlp is (LN_MLP_BRANCH_TOL).
LN_MLP_STAGE_TOL = 1e-3
PREPROCESS_F32_ATOL = 1e-4  # banded vs dense f32 sums: summation order only
L2_BYTES = 50 * 2**20  # an H100's L2 cache
COSINE_MIN = 0.999

# (label, R, W, H, dtype): the towers at buckets 128 and 8, at the train
# batch of 256 and the per-card batch of 4096 (phase 4), ragged R, 128-wide
# tiles, f32
LN_MLP_CASES = [
    ("vision", 128 * 50, 768, 3072, torch.bfloat16),
    ("text", 128 * 77, 512, 2048, torch.bfloat16),
    ("vision_train", 256 * 50, 768, 3072, torch.bfloat16),
    ("text_train", 256 * 77, 512, 2048, torch.bfloat16),
    ("vision_b4096", 4096 * 50, 768, 3072, torch.bfloat16),
    ("text_b4096", 4096 * 77, 512, 2048, torch.bfloat16),
    ("vision_b8", 8 * 50, 768, 3072, torch.bfloat16),
    ("text_b8", 8 * 77, 512, 2048, torch.bfloat16),  # the serving CLI's text requests (5 captions, bucket 8)
    ("ragged", 3 * 77, 512, 2048, torch.bfloat16),
    ("narrow", 151, 384, 1536, torch.bfloat16),  # W % 256 != 0: GEMM 2 on 128-column tiles
    ("f32", 8 * 50, 768, 3072, torch.float32),
]
PREPROCESS_CASES = [  # (label, input_hw, n_px, B, dtype): the bench front end, small B, other input shapes
    ("bf16", (256, 256), 224, 128, torch.bfloat16),
    ("f32", (256, 256), 224, 128, torch.float32),
    ("b8_bf16", (256, 256), 224, 8, torch.bfloat16),
    ("b8_f32", (256, 256), 224, 8, torch.float32),
    ("b1_bf16", (256, 256), 224, 1, torch.bfloat16),
    ("b1_f32", (256, 256), 224, 1, torch.float32),
    ("480x640_bf16", (480, 640), 224, 8, torch.bfloat16),
    ("480x640_f32", (480, 640), 224, 8, torch.float32),
    ("480x640_b1_f32", (480, 640), 224, 1, torch.float32),
    ("300x200_bf16", (300, 200), 224, 8, torch.bfloat16),
    ("300x200_f32", (300, 200), 224, 8, torch.float32),
    ("300x200_b1_bf16", (300, 200), 224, 1, torch.bfloat16),
    ("90x131_f32", (90, 131), 64, 3, torch.float32),  # W % 4 != 0: the kernel's byte loads
    ("384x384_336_bf16", (384, 384), 336, 8, torch.bfloat16),  # vit-l14-336's output size
    # the ResNet presets' output sizes: rn50x4 (288), rn50x16 (384), rn50x64 (448)
    ("256_288_bf16", (256, 256), 288, 8, torch.bfloat16),
    ("256_288_f32", (256, 256), 288, 8, torch.float32),
    ("384_384_bf16", (384, 384), 384, 8, torch.bfloat16),
    ("384_384_f32", (384, 384), 384, 8, torch.float32),
    ("512_448_bf16", (512, 512), 448, 8, torch.bfloat16),
    ("512_448_f32", (512, 512), 448, 8, torch.float32),
]
# The most shared memory a plan at the RN sizes takes (the host plan's
# reckoning for 512 -> 448); phase 1 holds each RN-size plan to it.
RN_PLAN_SMEM_MAX = 110672
# timed warm and cold in phase 3
PREPROCESS_TIMED = ("bf16", "b8_bf16", "f32", "256_288_bf16", "384_384_bf16", "512_448_bf16")
# (label, B, T, D, dtype): both towers at buckets 128 and 8 and at the train
# batch of 256 (phase 4), a B no batch tile divides, f32
BLOCK_CASES = [
    ("vision", 128, 50, 768, torch.bfloat16),
    ("text", 128, 77, 512, torch.bfloat16),
    ("vision_train", 256, 50, 768, torch.bfloat16),
    ("text_train", 256, 77, 512, torch.bfloat16),
    ("vision_b8", 8, 50, 768, torch.bfloat16),
    ("text_b12", 12, 77, 512, torch.bfloat16),
    ("f32", 8, 50, 768, torch.float32),
]
# The residual branches' last biases: a kernel that drops either must fail
# the bf16 branch check.
BLOCK_PLANTED = ("token_mix_seq.lin2.bias", "channel_mix_seq.lin4.bias")
GRAD_TOL = dict(atol=1e-4, rtol=1e-3)  # tests/test_pallas_kernels.py:121

TEXTS = [
    f"a {adj} photo of a {noun}"
    for adj in ("blurry", "bright", "dark", "close-up", "black and white")
    for noun in ("cat", "dog", "bicycle", "mountain lake", "red car", "bowl of soup", "city street", "person")
]  # 40 captions


def require(ok: bool, what) -> None:
    """Fail the run (exit 1) when a check does not hold."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", file=sys.stderr, flush=True)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def branch_err(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor) -> float:
    """Relative Frobenius error of the residual branch ``out - x``."""
    return rel_err(got.float() - x.float(), want.float() - x.float())


def max_abs(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cuda_ms_cycling(fn, inputs, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, each on
    the next of ``inputs`` in turn."""
    turn = iter(range(10**9))
    return cuda_ms(lambda: fn(inputs[next(turn) % len(inputs)]), iters)


def bound(n_bytes: float, n_ops: float, dtype: torch.dtype):
    """(least ms on the card, what bounds it) against the published peaks."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---- phase 1: kernels against their plain versions -------------------------


def ln_mlp_args(R, W, H, dtype, device, seed):
    """Inputs at the model's init scales, cast to ``dtype`` as the model does."""
    g = torch.Generator().manual_seed(seed)
    ts = (
        torch.randn(R, W, generator=g) * 2.0,
        1.0 + 0.1 * torch.randn(W, generator=g),
        0.1 * torch.randn(W, generator=g),
        (torch.rand(H, W, generator=g) * 2 - 1) * W**-0.5,
        (torch.rand(H, generator=g) * 2 - 1) * W**-0.5,
        (torch.rand(W, H, generator=g) * 2 - 1) * H**-0.5,
        (torch.rand(W, generator=g) * 2 - 1) * H**-0.5,
    )
    return [t.to(device=device, dtype=dtype).contiguous() for t in ts]


def ln_mlp_cost(R, W, H, dtype):
    e = torch.finfo(dtype).bits // 8
    n_bytes = e * (2 * R * W + 2 * W * H + 3 * W + H)  # x in, out, w_in, w_out, vectors
    return n_bytes, 4 * R * W * H  # two products of 2*R*W*H


def check_ln_mlp_stages(label, args, fused):
    """Each bf16 stage of ``ln_mlp`` alone against its plain version on the
    same input, and the three composed against the fused call (the same
    launches, so the same bits). Returns the errors and the stages' inputs."""
    from clip_mixer_tpu_torch.ops.kernels import ln_mlp as kln

    x, ln_w, ln_b, w_in, b_in, w_out, b_out = args
    y = kln.ln_rows(x, ln_w, ln_b)
    h = kln.linear_gelu(y, w_in, b_in)
    out = kln.linear_residual(h, w_out, b_out, x)
    torch.cuda.synchronize()
    errs = {
        "ln_rows": rel_err(y, kln.ln_rows_plain(x, ln_w, ln_b)),
        "linear_gelu": rel_err(h, kln.linear_gelu_plain(y, w_in, b_in)),
        "linear_residual_branch": branch_err(out, kln.linear_residual_plain(h, w_out, b_out, x), x),
    }
    for name, err in errs.items():
        tol = LN_MLP_BRANCH_TOL if name.endswith("branch") else LN_MLP_STAGE_TOL
        require(err <= tol, f"ln_mlp {label} stage {name}: relative error {err} > {tol}")
    require(torch.equal(out, fused), f"ln_mlp {label}: its stages composed differ from the fused call")
    return errs, (y, h)


def check_ln_mlp(dev):
    from clip_mixer_tpu_torch.ops.kernels.ln_mlp import ln_mlp, ln_mlp_plain

    results = {}
    for label, R, W, H, dtype in LN_MLP_CASES:
        args = ln_mlp_args(R, W, H, dtype, dev, seed=R)
        got = ln_mlp(*args)
        torch.cuda.synchronize()
        want = ln_mlp_plain(*args)
        err, rel = max_abs(got, want), branch_err(got, want, args[0])
        case = dict(R=R, W=W, H=H, dtype=str(dtype), max_abs_err=err, rel_err=rel)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, **LN_MLP_F32_TOL)
            case["tol"] = "allclose atol 2e-4 rtol 1e-3 (f32 sums in another order)"
        else:
            require(rel <= LN_MLP_BRANCH_TOL, f"ln_mlp {label}: branch error {rel} > {LN_MLP_BRANCH_TOL}")
            no_b_out = ln_mlp_plain(*args[:6], torch.zeros_like(args[6]))
            case["planted_fault_err"] = branch_err(no_b_out, want, args[0])
            require(case["planted_fault_err"] > LN_MLP_BRANCH_TOL, f"ln_mlp {label}: the check passes b_out = 0")
            case["tol"] = f"branch (out - x) relative Frobenius <= {LN_MLP_BRANCH_TOL} (bf16, same rounding points)"
            case["stage_err"], stage_inputs = check_ln_mlp_stages(label, args, got)
            case["stage_tol"] = (f"relative Frobenius <= {LN_MLP_STAGE_TOL} (y, h), branch <= {LN_MLP_BRANCH_TOL} "
                                 "(out); stages composed == fused call")
            case["stage_inputs"] = stage_inputs
        results[label] = dict(case, args=args)
        log(f"ln_mlp {label} R={R} W={W} H={H} {dtype}: max_abs {err:.3g} branch rel {rel:.3g} "
            f"stages {case.get('stage_err')} ok")
    return results


def preprocess_cost(bands, B, dtype):
    h, w = bands.input_hw
    n = bands.n_px
    e = torch.finfo(dtype).bits // 8
    n_bytes = B * h * w * 3 + B * n * n * 3 * e + 4 * (bands.rh_taps.numel() + bands.rw_taps.numel() + 2 * n + 6)
    # the banded sums: every non-zero tap of R_h over a W*3 row, of R_w over
    # an n*3 row (a multiply and an add each), then the normalisation
    nnz_h = int((bands.rh != 0).sum())
    nnz_w = int((bands.rw != 0).sum())
    n_ops = B * (2 * nnz_h * w * 3 + 2 * nnz_w * n * 3 + 2 * n * n * 3)
    return n_bytes, n_ops


def dropped_tap(bands):
    """``bands`` with the middle tap of every R_w row zeroed in its dense
    matrix: the plain version of a kernel that drops a tap column."""
    import dataclasses

    rw = bands.rw.clone()
    rows = torch.arange(rw.shape[0], device=rw.device)
    rw[rows, bands.rw_start.long() + bands.rw_taps.shape[1] // 2] = 0.0
    return dataclasses.replace(bands, rw=rw)


def check_preprocess(dev):
    from clip_mixer_tpu_torch.ops.kernels import preprocess as kpre

    g = torch.Generator().manual_seed(1)
    results = {}
    for label, hw, n, B, dtype in PREPROCESS_CASES:
        bands = kpre.ResizeBands.build(hw, n, dev)
        imgs = torch.randint(0, 256, (B, *hw, 3), dtype=torch.uint8, generator=g).to(dev)
        got = kpre.preprocess(imgs, bands, dtype)
        torch.cuda.synchronize()
        want = kpre.preprocess_plain(imgs, bands, dtype)
        err, rel = max_abs(got, want), rel_err(got, want)
        case = dict(input_hw=hw, n_px=n, B=B, dtype=str(dtype), max_abs_err=err, rel_err=rel)
        plan, _ = kpre._plan(bands, B)
        case["plan"] = dict(rows=plan.rows, group=plan.group, n_bands=plan.n_bands, warp_pixels=plan.warp_pixels,
                            smem_bytes=plan.smem_bytes, ctas_per_sm=plan.ctas_per_sm, grid=plan.grid)
        if dtype == torch.float32:
            require(err <= PREPROCESS_F32_ATOL, f"preprocess {label}: max abs error {err} > {PREPROCESS_F32_ATOL}")
            case["tol"] = f"max abs <= {PREPROCESS_F32_ATOL} (f32, banded vs dense summation)"
            fault = max_abs(got, kpre.preprocess_plain(imgs, dropped_tap(bands), dtype))
            require(fault > PREPROCESS_F32_ATOL, f"preprocess {label}: the check passes a dropped R_w tap")
            case["planted_fault_err"] = fault
        else:
            require(rel <= BF16_REL_TOL, f"preprocess {label}: relative error {rel} > {BF16_REL_TOL}")
            case["tol"] = f"relative Frobenius <= {BF16_REL_TOL} (bf16 store)"
        if n in (288, 384, 448):
            require(plan.smem_bytes <= RN_PLAN_SMEM_MAX,
                    f"preprocess {label}: {plan.smem_bytes} B of shared memory > {RN_PLAN_SMEM_MAX}")
        if label in PREPROCESS_TIMED:
            case.update(imgs=imgs, bands=bands)
        results[label] = case
        log(f"preprocess {label} B={B} {hw}->{n} {dtype}: max_abs {err:.3g} rel {rel:.3g} "
            f"plan {case['plan']} ok")
    empty = kpre.preprocess(torch.zeros((0, 256, 256, 3), dtype=torch.uint8, device=dev), results["bf16"]["bands"])
    require(empty.shape == (0, 224, 224, 3), f"preprocess B=0: shape {tuple(empty.shape)}")
    return results


def block_case(label, B, T, D, dtype, dev, seed):
    """A MixerBlock at its tower's init scales (LN parameters perturbed so
    the affine counts), in ``dtype`` on ``dev``, and x [T, B, D]."""
    from clip_mixer_tpu_torch.models.mixer import MixerBlock, init_mixer_block

    g = torch.Generator().manual_seed(seed)
    block = MixerBlock(D, T)
    init_mixer_block(block, text_tower=label.startswith("text"), n_layers=12, generator=g)
    with torch.no_grad():
        for ln in (block.layerNorm1, block.layerNorm2):
            ln.weight.add_(0.1 * torch.randn(D, generator=g))
            ln.bias.add_(0.1 * torch.randn(D, generator=g))
    x = torch.randn(T, B, D, generator=g)
    return block.to(device=dev, dtype=dtype), x.to(device=dev, dtype=dtype)


def token_mix_cost(B, T, D, U, dtype):
    """Bytes (x read, z and y2 written, the token weights and vectors) and
    operations of the block's first launch alone."""
    e = torch.finfo(dtype).bits // 8
    return e * (3 * B * T * D + 2 * T * U + 4 * D + U + T), 2 * B * D * 2 * T * U


def block_cost(B, T, D, U, H, dtype):
    """Bytes and operations the JAX CostEstimate counts (block_kernel.py:181-185)."""
    e = torch.finfo(dtype).bits // 8
    n_bytes = e * (2 * B * T * D + 2 * T * U + 2 * D * H + 5 * D + U + T + H)  # x, out, weights, vectors
    return n_bytes, 2 * B * D * 2 * T * U + 2 * B * T * 2 * D * H


def check_mixer_block(dev):
    from clip_mixer_tpu_torch.ops.kernels.mixer_block import fused_mixer_block_tbd, mixer_block_plain

    results = {}
    for label, B, T, D, dtype in BLOCK_CASES:
        block, x = block_case(label, B, T, D, dtype, dev, seed=B * T)
        block.requires_grad_(False)
        got = fused_mixer_block_tbd(block, x)
        torch.cuda.synchronize()
        want = mixer_block_plain(block, x)
        err, rel = max_abs(got, want), branch_err(got, want, x)
        case = dict(B=B, T=T, D=D, U=4 * T, H=4 * D, dtype=str(dtype), max_abs_err=err, rel_err=rel)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, **LN_MLP_F32_TOL)
            case["tol"] = "allclose atol 2e-4 rtol 1e-3 (f32 sums in another order)"
        else:
            require(rel <= LN_MLP_BRANCH_TOL, f"fused_mixer_block {label}: branch error {rel} > {LN_MLP_BRANCH_TOL}")
            case["planted_fault_err"] = {}
            for bias in BLOCK_PLANTED:
                faulty = copy.deepcopy(block)
                faulty.get_parameter(bias).zero_()
                fault = branch_err(mixer_block_plain(faulty, x), want, x)
                require(fault > LN_MLP_BRANCH_TOL, f"fused_mixer_block {label}: the check passes {bias} = 0")
                case["planted_fault_err"][bias] = fault
            case["tol"] = f"branch (out - x) relative Frobenius <= {LN_MLP_BRANCH_TOL} (bf16, same rounding points)"
        results[label] = dict(case, block=block, x=x)
        log(f"fused_mixer_block {label} B={B} T={T} D={D} {dtype}: max_abs {err:.3g} branch rel {rel:.3g} ok")
    return results


def rows(t: torch.Tensor) -> torch.Tensor:
    """A [T, B, D] tensor in either of the block's layouts as its [B*T, D]
    rows in memory order, the rows the block's GEMMs take."""
    return t.as_strided((t.shape[0] * t.shape[1], t.shape[2]), (t.shape[2], 1))


def check_token_mix(block_cases):
    """The bf16 block's first launch alone (``token_mix``) against
    ``token_mix_plain`` at every bf16 block shape, in both layouts: z on its
    branch z - x (the plain version without b2 must fail that check), y2
    against LN_ch of the kernel's own z; and the block's three launches
    (``token_mix``, then ``ln_mlp``'s two GEMM stages) composed against the
    fused call, bit for bit. Keeps the tower layout's stage outputs for the
    timing."""
    from clip_mixer_tpu_torch.ops.kernels import ln_mlp as kln
    from clip_mixer_tpu_torch.ops.kernels import mixer_block as kmb

    for label, case in block_cases.items():
        block, x = case["block"], case["x"]
        if x.dtype != torch.bfloat16:
            continue
        p = kmb.block_params(block, x.dtype)
        errs = {}
        for layout, xl in (("TBD", x), ("BTD view", x.transpose(0, 1).contiguous().transpose(0, 1))):
            z, y2 = kmb.token_mix(xl, *p[:8])
            torch.cuda.synchronize()
            want, _ = kmb.token_mix_plain(xl, *p[:8])
            no_b2, _ = kmb.token_mix_plain(xl, *p[:5], torch.zeros_like(p[5]), *p[6:8])
            e = dict(z_branch=branch_err(z, want, xl), planted_b2=branch_err(no_b2, want, xl),
                     y2=rel_err(y2, kln.ln_rows_plain(z, p[6], p[7])))
            what = f"token_mix {label} {layout}"
            require(e["z_branch"] <= LN_MLP_BRANCH_TOL, f"{what}: z branch error {e['z_branch']} > {LN_MLP_BRANCH_TOL}")
            require(e["planted_b2"] > LN_MLP_BRANCH_TOL, f"{what}: the check passes b2 = 0")
            require(e["y2"] <= LN_MLP_STAGE_TOL, f"{what}: y2 error {e['y2']} > {LN_MLP_STAGE_TOL}")
            h = kln.linear_gelu(rows(y2), p[8], p[9])
            out = kln.linear_residual(h, p[10], p[11], rows(z))
            require(torch.equal(out, rows(kmb.fused_mixer_block_tbd(block, xl))),
                    f"{what}: the block's three launches composed differ from the fused call")
            errs[layout] = e
        case["token_stage_err"] = errs
        case["token_stage_tol"] = (f"z branch (z - x) relative Frobenius <= {LN_MLP_BRANCH_TOL}, y2 against LN_ch of "
                                   f"the kernel's z <= {LN_MLP_STAGE_TOL}; the three launches composed == fused call")
        case["stage_inputs"] = (xl, z, y2, h)  # the tower's layout, the last one checked
        log(f"token_mix {label}: {errs} ok")


def check_gradients(dev):
    """One backward through each kernel's autograd wrapper, in f32 and in
    bf16 (x in bf16, the parameters f32 masters), against autograd of the
    model's unfused chain: the block's own forward (``fused_mlp=False``) and
    ``channel_mlp``."""
    from clip_mixer_tpu_torch.models.layers import channel_mlp
    from clip_mixer_tpu_torch.ops.kernels.ln_mlp import ln_mlp
    from clip_mixer_tpu_torch.ops.kernels.mixer_block import fused_mixer_block_tbd, mixer_block_fused

    g = torch.Generator().manual_seed(7)
    for dtype, tol in ((torch.float32, GRAD_TOL), (torch.bfloat16, dict(atol=1e-2, rtol=1e-2))):
        block, x = block_case("vision", 8, 50, 768, torch.float32, dev, seed=5)
        x = x.to(dtype).requires_grad_()
        x_ln, *p_ln = ln_mlp_args(400, 768, 3072, torch.float32, dev, seed=6)
        x_ln = x_ln.to(dtype).requires_grad_()
        p_ln = [t.requires_grad_() for t in p_ln]
        for name, wrapper, fused, plain, inputs in (
            ("mixer_block_fused", fused_mixer_block_tbd, lambda: mixer_block_fused(block, x),
             lambda: block(x.transpose(0, 1)).transpose(0, 1), [x, *block.parameters()]),
            ("ln_mlp", ln_mlp, lambda: ln_mlp(x_ln, *p_ln), lambda: channel_mlp(x_ln, *p_ln), [x_ln, *p_ln]),
        ):
            before = wrapper.launches
            out = fused()
            require(wrapper.launches == before + 1, f"{name}: the forward did not launch the kernel")
            grad = torch.randn(out.shape, generator=g).to(device=dev, dtype=dtype)
            got = torch.autograd.grad(out, inputs, grad)
            want = torch.autograd.grad(plain(), inputs, grad)
            for a, b in zip(got, want):
                require(a.dtype == b.dtype, f"{name} {dtype}: gradient dtype {a.dtype}, expected {b.dtype}")
                torch.testing.assert_close(a, b, **tol)
            log(f"{name} {dtype} backward: {len(inputs)} gradients match autograd of the unfused chain")


def check_small_model(dev):
    """A two-layer f32 model with the fused channel mix, then with its towers
    through ``mixer_tower_fused``: card against CPU."""
    from clip_mixer_tpu_torch import CLIP, PRESETS
    from clip_mixer_tpu_torch.ops.kernels.mixer_block import route_towers
    from clip_mixer_tpu_torch.text.tokenize import tokenize

    res = PRESETS["mixer-debug"].image_resolution
    images = torch.randn(4, res, res, 3, generator=torch.Generator().manual_seed(4))
    for what, over, fused_towers in (("fused channel mix", dict(fused_mlp=True), False), ("fused towers", {}, True)):
        cfg = PRESETS["mixer-debug"].replace(**over)
        models = {d: CLIP(cfg, device=d, generator=torch.Generator().manual_seed(3)) for d in ("cpu", dev)}
        for m in models.values():
            if fused_towers:
                route_towers(m, True)
        text = torch.from_numpy(tokenize(TEXTS[:4], cfg.context_length, truncate=True))
        with torch.inference_mode():
            out = {d: (m.encode_image(images.to(d)).cpu(), m.encode_text(text.to(d)).cpu()) for d, m in models.items()}
        for got, want in zip(out[dev], out["cpu"]):
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-3)
        log(f"mixer-debug f32 model, {what}: card matches CPU")


# ---- phase 2: the main path -------------------------------------------------


class Counters:
    def __init__(self):
        from clip_mixer_tpu_torch.ops.kernels import preprocess as kpre
        from clip_mixer_tpu_torch.ops.kernels.ln_mlp import ln_mlp
        from clip_mixer_tpu_torch.ops.kernels.mixer_block import fused_mixer_block_tbd

        self.wrappers = {"ln_mlp": ln_mlp, "preprocess": kpre.preprocess, "fused_mixer_block": fused_mixer_block_tbd}

    def reset(self):
        for w in self.wrappers.values():
            w.launches = 0

    def read(self):
        return {n: w.launches for n, w in self.wrappers.items()}


def expect(counters, before, what, **deltas):
    now = counters.read()
    for name, d in deltas.items():
        got = now[name] - before[name]
        require(got == d, f"{what}: {name} launched {got} times, expected {d}")
    return now


def check_features(feats, n, embed_dim, what):
    require(feats.shape == (n, embed_dim), f"{what}: shape {feats.shape}")
    require(np.isfinite(feats).all(), f"{what}: non-finite features")
    norms = np.linalg.norm(feats, axis=-1)
    require(np.allclose(norms, 1.0, atol=1e-2), f"{what}: norms {norms.min()}..{norms.max()}")


def min_cosine(a, b):
    return float((a * b).sum(-1).min())


def http_requests(engine, texts):
    from clip_mixer_tpu_torch.serving import serve

    server = serve(engine, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        require(health["status"] == "ok" and health["device"] == str(engine.device), health)
        req = urllib.request.Request(
            f"{base}/encode_text", data=json.dumps({"texts": texts}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=120) as r:
            feats = np.asarray(json.loads(r.read())["features"], np.float32)
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    return health, feats


def main_path(dev, counters):
    from clip_mixer_tpu_torch import CLIP, PRESETS
    from clip_mixer_tpu_torch.ops.preprocess import make_batch_preprocess
    from clip_mixer_tpu_torch.serving import InferenceEngine

    cfg = PRESETS["mixer-b32"].replace(fused_mlp=True)
    per_tower = {"image": cfg.vision_layers, "text": cfg.text_layers}
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (128, 256, 256, 3), dtype=np.uint8)
    summary = {}

    model = CLIP(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    engine = InferenceEngine(model, input_hw=(256, 256))
    counters.reset()
    c = counters.read()
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    summary["warmup_s"] = time.perf_counter() - t0
    c = expect(counters, c, "warmup", ln_mlp=len(engine.buckets) * (per_tower["image"] + per_tower["text"]))

    feats = {}
    for n in (1, 5, 40):
        t0 = time.perf_counter()
        feats[f"text{n}"] = engine.encode_text(TEXTS[:n])
        summary[f"encode_text_{n}_ms"] = (time.perf_counter() - t0) * 1e3
        check_features(feats[f"text{n}"], n, cfg.embed_dim, f"encode_text({n})")
        c = expect(counters, c, f"encode_text({n})", ln_mlp=per_tower["text"], preprocess=0)
    for n in (1, 7, 100):
        t0 = time.perf_counter()
        feats[f"image{n}"] = engine.encode_image_arrays(images[:n])
        summary[f"encode_image_{n}_ms"] = (time.perf_counter() - t0) * 1e3
        check_features(feats[f"image{n}"], n, cfg.embed_dim, f"encode_image_arrays({n})")
        c = expect(counters, c, f"encode_image_arrays({n})", ln_mlp=per_tower["image"], preprocess=0)
    sims = engine.similarity(images[:3], TEXTS[:4])
    require(sims.shape == (3, 4) and np.isfinite(sims).all(), sims)
    np.testing.assert_allclose(sims, 100.0 * feats["image7"][:3] @ feats["text5"][:4].T, atol=1e-3)
    c = expect(counters, c, "similarity", ln_mlp=per_tower["image"] + per_tower["text"])

    health, http_feats = http_requests(engine, TEXTS[:2])
    np.testing.assert_allclose(http_feats, feats["text5"][:2], atol=1e-6)
    c = expect(counters, c, "HTTP /encode_text", ln_mlp=per_tower["text"])
    summary["healthz"] = health

    # the bench front end: the preprocess kernel -> encode_image at batch 128
    pre_kernel = make_batch_preprocess((256, 256), cfg.image_resolution, dtype=torch.bfloat16, backend="kernel")
    x = torch.from_numpy(images).to(dev)
    with torch.inference_mode():
        front = model.encode_image(pre_kernel(x)).float()
    torch.cuda.synchronize()
    c = expect(counters, c, "front end", ln_mlp=per_tower["image"], preprocess=1)
    launches = counters.read()
    log(f"main path launches: {launches}")
    require(launches["fused_mixer_block"] == 0, "the fused_mlp path launched the whole-block kernel")

    # reference: the same weights with the plain channel mix, and the "torch" front end
    ref_model = CLIP(cfg.replace(fused_mlp=False), device=dev, generator=torch.Generator().manual_seed(0))
    ref = InferenceEngine(ref_model, input_hw=(256, 256))
    cos = {
        "text40": min_cosine(feats["text40"], ref.encode_text(TEXTS[:40])),
        "image100": min_cosine(feats["image100"], ref.encode_image_arrays(images[:100])),
    }
    pre_torch = make_batch_preprocess((256, 256), cfg.image_resolution, dtype=torch.bfloat16, backend="torch")
    with torch.inference_mode():
        front_ref = ref_model.encode_image(pre_torch(x)).float()
    front_cos = torch.nn.functional.cosine_similarity(front, front_ref, dim=-1)
    cos["front_end128"] = float(front_cos.min())
    require(counters.read() == launches, "the plain reference launched a kernel")
    for k, v in cos.items():
        require(v >= COSINE_MIN, f"{k}: fused vs plain cosine {v} < {COSINE_MIN}")
    summary["min_cosine_vs_plain"] = cos
    log(f"fused vs plain channel mix, min cosine: {cos}")

    # the front end's time at batch 128, kernels against the plain model and "torch" preprocess
    def run(m, pre):
        with torch.inference_mode():
            m.encode_image(pre(x))

    summary["front_end128_ms"] = cuda_ms(lambda: run(model, pre_kernel), iters=10)
    summary["front_end128_plain_ms"] = cuda_ms(lambda: run(ref_model, pre_torch), iters=10)
    summary["launches"] = launches
    del ref_model, ref, model, engine
    return summary, launches


# ---- phase 2b: the fused-block path ------------------------------------------


def fused_block_path(dev, counters):
    """Full-width Mixer-B/32 bf16 served with both towers through
    ``mixer_tower_fused``; returns (summary, launches, the model)."""
    from clip_mixer_tpu_torch import CLIP, PRESETS
    from clip_mixer_tpu_torch.ops.kernels.mixer_block import route_towers
    from clip_mixer_tpu_torch.ops.preprocess import make_batch_preprocess
    from clip_mixer_tpu_torch.serving import InferenceEngine

    cfg = PRESETS["mixer-b32"]
    require(not cfg.fused_mlp, "the fused-block path runs the plain channel mix's config")
    per_tower = {"image": cfg.vision_layers, "text": cfg.text_layers}
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (128, 256, 256, 3), dtype=np.uint8)
    summary = {}

    model = CLIP(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    engine = InferenceEngine(model, input_hw=(256, 256))
    route_towers(model, True)
    counters.reset()
    c = counters.read()
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    summary["warmup_s"] = time.perf_counter() - t0
    c = expect(counters, c, "warmup", fused_mixer_block=len(engine.buckets) * (per_tower["image"] + per_tower["text"]),
               ln_mlp=0)

    feats = {}
    for n in (5, 40):
        t0 = time.perf_counter()
        feats[f"text{n}"] = engine.encode_text(TEXTS[:n])
        summary[f"encode_text_{n}_ms"] = (time.perf_counter() - t0) * 1e3
        check_features(feats[f"text{n}"], n, cfg.embed_dim, f"fused towers: encode_text({n})")
        c = expect(counters, c, f"fused towers: encode_text({n})", fused_mixer_block=per_tower["text"], ln_mlp=0)
    for n in (7, 100):
        t0 = time.perf_counter()
        feats[f"image{n}"] = engine.encode_image_arrays(images[:n])
        summary[f"encode_image_{n}_ms"] = (time.perf_counter() - t0) * 1e3
        check_features(feats[f"image{n}"], n, cfg.embed_dim, f"fused towers: encode_image_arrays({n})")
        c = expect(counters, c, f"fused towers: encode_image_arrays({n})", fused_mixer_block=per_tower["image"],
                   ln_mlp=0, preprocess=0)

    pre_kernel = make_batch_preprocess((256, 256), cfg.image_resolution, dtype=torch.bfloat16, backend="kernel")
    with torch.inference_mode():
        pixels = pre_kernel(torch.from_numpy(images).to(dev))
        front = model.encode_image(pixels).float()
    torch.cuda.synchronize()
    c = expect(counters, c, "fused towers: front end", fused_mixer_block=per_tower["image"], ln_mlp=0, preprocess=1)
    launches = counters.read()
    log(f"fused-block path launches: {launches}")

    # reference: the same model and inputs with the plain towers
    route_towers(model, False)
    with torch.inference_mode():
        front_ref = model.encode_image(pixels).float()
    cos = {
        "text40": min_cosine(feats["text40"], engine.encode_text(TEXTS[:40])),
        "image100": min_cosine(feats["image100"], engine.encode_image_arrays(images[:100])),
        "front_end128": float(torch.nn.functional.cosine_similarity(front, front_ref, dim=-1).min()),
    }
    require(counters.read() == launches, "the plain towers launched a kernel")
    for k, v in cos.items():
        require(v >= COSINE_MIN, f"{k}: fused towers vs plain cosine {v} < {COSINE_MIN}")
    summary["min_cosine_vs_plain"] = cos
    summary["launches"] = launches
    log(f"fused towers vs plain towers, min cosine: {cos}")
    del engine
    return summary, launches, model


# ---- phase 3: timing ----------------------------------------------------------


def torch_chain(x, ln_w, ln_b, w_in, b_in, w_out, b_out):
    """The model's non-fused channel mix (``MixerBlock.forward`` with
    ``fused_mlp=False``) on weights already in ``x.dtype``: a yardstick for
    ``ln_mlp`` that the port never calls."""
    from clip_mixer_tpu_torch.models.layers import layer_norm, quick_gelu

    y = layer_norm(x, ln_w, ln_b)
    h = quick_gelu(y @ w_in.t() + b_in)
    return x + (h @ w_out.t() + b_out)


def time_towers(model, dev):
    """Each tower at bucket 128, bf16: through ``mixer_tower_fused``, through
    ``fused_mlp=True`` (``ln_mlp``), and plain; in turns A B C C B A, each
    the mean of 10 back-to-back calls."""
    from clip_mixer_tpu_torch.ops.kernels.mixer_block import mixer_tower_fused

    cfg = model.cfg
    g = torch.Generator().manual_seed(8)
    rows = {}
    for name, tower, T, D in (("vision", model.visual.transformer, cfg.vision_tokens, cfg.vision_width),
                              ("text", model.transformer, cfg.context_length, cfg.text_width)):
        x = torch.randn(128, T, D, generator=g).to(device=dev, dtype=torch.bfloat16)

        ways = {
            "fused_block_ms": lambda: mixer_tower_fused(tower, x),
            "fused_mlp_ms": lambda: tower(x),  # with every block's fused_mlp set
            "plain_ms": lambda: tower(x),
        }
        times = {k: [] for k in ways}
        with torch.inference_mode():
            for k in [*ways, *reversed(ways)]:
                for block in tower.mixBlocks:
                    block.fused_mlp = k == "fused_mlp_ms"
                times[k].append(cuda_ms(ways[k], iters=10))
        rows[name] = {k: sum(v) / len(v) for k, v in times.items()}
        rows[name]["each_run_ms"] = times
        log(f"tower {name} at bucket 128: {rows[name]}")
    return rows



def time_kernels(ln_cases, pre_cases, block_cases, launches):
    from clip_mixer_tpu_torch.ops.kernels import ln_mlp as kln
    from clip_mixer_tpu_torch.ops.kernels import preprocess as kpre
    from clip_mixer_tpu_torch.ops.kernels import mixer_block as kmb
    from clip_mixer_tpu_torch.ops.kernels.mixer_block import fused_mixer_block_tbd, mixer_block_plain

    table = []
    for kernel, cases, main_label in (
        ("ln_mlp", ln_cases, "vision"), ("preprocess", pre_cases, "bf16"), ("fused_mixer_block", block_cases, "vision"),
    ):
        timed = {}
        for label, case in cases.items():
            if kernel == "fused_mixer_block":
                block, x = case.pop("block"), case.pop("x")
                ms = cuda_ms(lambda: fused_mixer_block_tbd(block, x), iters=20)
                plain_ms = cuda_ms(lambda: mixer_block_plain(block, x), iters=5)
                if "stage_inputs" in case:  # bf16: three launches, each timed alone
                    (xl, z, y2, h), p = case.pop("stage_inputs"), kmb.block_params(block, x.dtype)
                    case["stage_ms"] = {
                        "token_mix": cuda_ms(lambda: kmb.token_mix(xl, *p[:8]), iters=20),
                        "linear_gelu": cuda_ms(lambda: kln.linear_gelu(rows(y2), p[8], p[9]), iters=20),
                        "linear_residual": cuda_ms(lambda: kln.linear_residual(h, p[10], p[11], rows(z)), iters=20),
                    }
                    t_bytes, t_ops = token_mix_cost(case["B"], case["T"], case["D"], case["U"], x.dtype)
                    case["token_mix_bound_ms"], case["token_mix_bound_by"] = bound(t_bytes, t_ops, x.dtype)
                    # the model's own bf16 block (fused_mlp=False) on the same [B, T, D] input
                    x_btd = x.transpose(0, 1).contiguous()
                    with torch.inference_mode():
                        case["torch_chain_ms"] = cuda_ms(lambda: block(x_btd), iters=20)
                n_bytes, n_ops = block_cost(case["B"], case["T"], case["D"], case["U"], case["H"], x.dtype)
                dtype = x.dtype
            elif kernel == "ln_mlp":
                args = case.pop("args")
                ms = cuda_ms(lambda: kln.ln_mlp(*args), iters=20)
                plain_ms = cuda_ms(lambda: kln.ln_mlp_plain(*args), iters=5)
                if "stage_inputs" in case:  # bf16: three launches, each timed alone
                    (y, h), (x, ln_w, ln_b, w_in, b_in, w_out, b_out) = case.pop("stage_inputs"), args
                    case["stage_ms"] = {
                        "ln_rows": cuda_ms(lambda: kln.ln_rows(x, ln_w, ln_b), iters=20),
                        "linear_gelu": cuda_ms(lambda: kln.linear_gelu(y, w_in, b_in), iters=20),
                        "linear_residual": cuda_ms(lambda: kln.linear_residual(h, w_out, b_out, x), iters=20),
                    }
                    case["torch_chain_ms"] = cuda_ms(lambda: torch_chain(*args), iters=20)
                n_bytes, n_ops = ln_mlp_cost(case["R"], case["W"], case["H"], args[0].dtype)
                dtype = args[0].dtype
            else:
                if "imgs" not in case:  # checked, not timed
                    timed[label] = case
                    continue
                imgs, bands = case.pop("imgs"), case.pop("bands")
                dtype = torch.bfloat16 if case["dtype"] == str(torch.bfloat16) else torch.float32
                ms = cuda_ms(lambda: kpre.preprocess(imgs, bands, dtype), iters=20)
                # cold: fresh batches, more than twice the L2 in all, in turn
                rot = [torch.randint_like(imgs, 0, 256) for _ in range(max(4, -(-2 * L2_BYTES // imgs.numel())))]
                case["ms_cold"] = cuda_ms_cycling(lambda v: kpre.preprocess(v, bands, dtype), rot, iters=2 * len(rot))
                case["cold_batches"] = len(rot)
                del rot
                plain_ms = cuda_ms(lambda: kpre.preprocess_plain(imgs, bands, dtype), iters=5)
                n_bytes, n_ops = preprocess_cost(bands, case["B"], dtype)
                # the preprocess arithmetic is f32 whatever it stores
                dtype = torch.float32
            bound_ms, bound_by = bound(n_bytes, n_ops, dtype)
            timed[label] = dict(case, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                bytes=n_bytes, operations=n_ops)
            log(f"{kernel} {label}: {ms:.4f} ms{' (cold ' + format(case['ms_cold'], '.4f') + ')' if 'ms_cold' in case else ''}"
                f" (plain {plain_ms:.4f}, bound {bound_ms:.4f} by {bound_by}"
                + (f", torch chain {case['torch_chain_ms']:.4f}, stages {case['stage_ms']}" if "stage_ms" in case else "")
                + ")")
        main = timed.pop(main_label)
        source = {
            "ln_mlp": "clip_mixer_tpu_torch/csrc/ln_mlp.cu",
            "preprocess": "clip_mixer_tpu_torch/csrc/preprocess.cu",
            "fused_mixer_block": "clip_mixer_tpu_torch/csrc/mixer_block.cu",
        }
        replaces = {
            "ln_mlp": "clip_mixer_tpu/ops/pallas/mlp_kernel.py:61",
            "preprocess": "clip_mixer_tpu/ops/pallas/preprocess_kernel.py:72",
            "fused_mixer_block": "clip_mixer_tpu/ops/pallas/block_kernel.py:127",
        }
        table.append({
            "name": kernel,
            "route": "cuda",
            "source": source[kernel],
            "replaces": replaces[kernel],
            "launches": launches[kernel],
            "shape": main_label,
            **main,
            # no single PyTorch call computes the same function (a fused
            # LN + two-layer MLP; a cropped antialiased bicubic resize of
            # uint8 NHWC with CLIP normalisation; a whole mixer block)
            "library_ms": None,
            "other_cases": timed,
        })
    return table


# ---- phase 4: training ----------------------------------------------------------

TRAIN_PRESET = "mixer-b32"
TRAIN_STEPS = 8  # on each route; steps 3..8 are timed
TRAIN_WARMUP = 2
TRAIN_B = 256
BIG_B = 4096  # the reference's 32 768 global batch over 8 cards
BIG_ACCUM = 8
GRADCACHE_ACCUM = 4
SOT, EOT = 49406, 49407
# Limits from the first two runs on an H100 80GB HBM3 (PERF.md §6), bf16. Each
# route's 8th loss read 0.810 of its first (a spike at step 4, where the lr
# peaks, included); at step 1 the kernel routes' loss read 0.9-1.1e-4 from
# the plain route's, every parameter's gradient 2.6-2.8e-2 (median) and at
# most 3.6e-2 / 3.9e-2 (relative Frobenius): the kernels round the forward
# at other points than the plain chain, over 12 blocks. GradCache read 0 on
# the loss and 5.9e-6 on the gradient norm.
TRAIN_LOSS_FALL = 0.9  # each route's 8th loss <= 0.9 x its first
ROUTE_LOSS_TOL = 1e-3  # |loss_route - loss_plain| / loss_plain at step 1
ROUTE_GRAD_TOL = 6e-2  # per parameter, relative Frobenius against the plain route at step 1
# A token-mix output bias (lin2.bias) adds one constant to a token across the
# width, and every consumer of the token mix's output is a LayerNorm over
# the width (the next block's, ln_post, ln_final): its exact gradient is
# zero, and any route's is rounding noise. It is held on its size against
# its block's lin2.weight gradient, not on its difference between routes.
NULL_GRAD = "token_mix_seq.lin2.bias"
NULL_GRAD_RATIO = 1e-2  # read at most 2.6e-3
GRADCACHE_LOSS_TOL = 1e-4  # accum_steps=4 against 1: |dloss| / loss
GRADCACHE_NORM_TOL = 1e-4  # and |d grad_norm| / grad_norm
REMAT_POLICIES = ("none", "mlp_hidden", "all_hidden")
# A remat step's forward is the same computation as without remat: its loss
# must be the same bits, and its gradient norm read the same too (H100
# runs, PERF.md §6); held at the GradCache limit.
REMAT_NORM_TOL = GRADCACHE_NORM_TOL
# B = 4096, step 1: fused_mlp + full remat against plain accum_steps=8, two
# bf16 routes of one step (the kernel's rounding points against the plain
# chain's, and the microbatches' sums against the full batch's). Read:
# loss 6.0e-6 and gradient norm 2.8e-3 relative (H100, PERF.md §6; at
# B = 256 the routes read 1.1e-4 and 5.7e-4). The gradient norm is held at
# 3.5x its reading, the loss at the B = 256 route limit.
BIG_LOSS_TOL = ROUTE_LOSS_TOL
BIG_NORM_TOL = 1e-2


def train_batch(cfg, B, seed):
    """A fixed batch from a numpy seed: uint8 [B, R, R, 3] images and token
    rows SOT, random ids, EOT (the argmax id), zeros."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (B, cfg.image_resolution, cfg.image_resolution, 3), dtype=np.uint8)
    ctx = cfg.context_length
    texts = rng.integers(1, SOT, (B, ctx)).astype(np.int32)
    ends = rng.integers(3, ctx, B)
    texts[:, 0] = SOT
    texts[np.arange(B), ends] = EOT
    texts[np.arange(ctx)[None, :] > ends[:, None]] = 0
    return {"images": images, "texts": texts}


def train_flops_per_sample(cfg) -> float:
    """3 x the analytic forward FLOPs of both towers: ``bench.py``'s vision
    formula (patchify, mixer tower, proj) without its resize, since the
    train step takes images at the model's resolution, and the same tower
    formula for text (77 tokens, width 512) with its projection."""
    def tower(t, w, layers):
        return layers * (2 * (2 * w * t * 4 * t) + 2 * (2 * t * w * 4 * w))

    g, p, w = cfg.grid_size, cfg.vision_patch_size, cfg.vision_width
    vision = 2 * (g * g) * (p * p * 3) * w + tower(cfg.vision_tokens, w, cfg.vision_layers) + 2 * w * cfg.embed_dim
    text = tower(cfg.context_length, cfg.text_width, cfg.text_layers) + 2 * cfg.text_width * cfg.embed_dim
    return 3.0 * float(vision + text)


def train_setup(cfg, dev, fused_block=False, accum_steps=1, steps=TRAIN_STEPS, tcfg=None):
    """CLIP from seed 0 (optionally with its Mixer towers through
    ``mixer_tower_fused``), its state and its train step at ``tcfg``
    (TrainConfig's defaults when None), with ``total_steps`` the steps run."""
    from clip_mixer_tpu_torch import CLIP
    from clip_mixer_tpu_torch.config import TrainConfig
    from clip_mixer_tpu_torch.ops.kernels.mixer_block import route_towers
    from clip_mixer_tpu_torch.parallel.train_step import init_train_state, make_train_step
    from clip_mixer_tpu_torch.train.optimizer import make_optimizer

    tcfg = TrainConfig() if tcfg is None else tcfg
    model = CLIP(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    if fused_block:
        route_towers(model, True)
    opt = make_optimizer(tcfg, total_steps=steps)
    return init_train_state(model, opt), make_train_step(cfg, tcfg, opt, accum_steps=accum_steps)


def on_device(batch, dev):
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def free_card():
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def train_route(dev, counters, route, batch):
    """TRAIN_STEPS steps on one route from seed 0; steps after the first
    TRAIN_WARMUP timed with CUDA events. Returns the readings, the step-1
    gradients (on the host) and the launches."""
    from clip_mixer_tpu_torch import PRESETS

    cfg = PRESETS[TRAIN_PRESET].replace(fused_mlp=route == "fused_mlp")
    state, step = train_setup(cfg, dev, fused_block=route == "fused_block")
    free_card()
    counters.reset()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    metrics, grads1 = [], None
    for i in range(TRAIN_STEPS):
        if i == TRAIN_WARMUP:
            start.record()
        state, m = step(state, batch)
        metrics.append(m)
        if i == 0:
            grads1 = {n: p.grad.detach().float().cpu() for n, p in state.model.named_parameters()}
    end.record()
    end.synchronize()
    launches = counters.read()
    ms = start.elapsed_time(end) / (TRAIN_STEPS - TRAIN_WARMUP)
    B = batch["images"].shape[0]
    out = {
        "step_ms": ms,
        "images_per_s": B / ms * 1e3,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "train_mfu": B * train_flops_per_sample(cfg) / (ms * 1e-3) / PEAK_OPS_PER_S[torch.bfloat16],
        "losses": [float(m["loss"]) for m in metrics],
        "grad_norms": [float(m["grad_norm"]) for m in metrics],
        "logit_scale": float(metrics[-1]["logit_scale"]),
        "launches": launches,
    }
    del state, step, metrics
    free_card()
    return out, grads1, launches


def grad_agreement(got, want):
    """Per parameter, the relative Frobenius error of ``got`` against
    ``want``; and for each token-mix output bias (NULL_GRAD), the larger of
    the two routes' gradient norms over the plain route's norm for the same
    block's lin2.weight."""
    errs, null = {}, {}
    for n, w in want.items():
        if n.endswith(NULL_GRAD):
            ref = want[n.replace(".bias", ".weight")].norm()
            null[n] = float(torch.maximum(got[n].norm(), w.norm()) / ref)
        else:
            errs[n] = float((got[n] - w).norm() / w.norm())
    return errs, null


def two_steps(dev, counters, cfg, batch, **kw):
    """Two steps from seed 0: the first's loss and gradient norm, the second
    timed with CUDA events (the first pays the allocator's first calls), the
    peak memory and the launches of both."""
    state, step = train_setup(cfg, dev, steps=2, **kw)
    free_card()
    counters.reset()
    state, m1 = step(state, batch)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    state, m2 = step(state, batch)
    end.record()
    end.synchronize()
    B = batch["images"].shape[0]
    ms = start.elapsed_time(end)
    out = dict(B=B, loss=float(m1["loss"]), grad_norm=float(m1["grad_norm"]), loss_step2=float(m2["loss"]),
               step_ms=ms, images_per_s=B / ms * 1e3, peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
               train_mfu=B * train_flops_per_sample(cfg) / (ms * 1e-3) / PEAK_OPS_PER_S[torch.bfloat16],
               launches=counters.read())
    require(all(np.isfinite([out["loss"], out["grad_norm"], out["loss_step2"]])), f"two steps: {out}")
    del state, step, m1, m2
    free_card()
    return out


def train_path(dev, counters):
    """Phase 4: full-width Mixer-B/32 (bf16 compute, f32 masters) trains
    TRAIN_STEPS steps at B = TRAIN_B on three routes from one init; then
    GradCache against the full batch; then the reference's per-card batch
    with full remat and with accumulation."""
    from clip_mixer_tpu_torch import PRESETS

    t0 = time.perf_counter()
    free_card()
    # what earlier phases left allocated, inside every peak below
    summary = {"allocated_at_start_gb": torch.cuda.memory_allocated() / 1e9}
    cfg = PRESETS[TRAIN_PRESET]
    blocks = cfg.vision_layers + cfg.text_layers
    batch = on_device(train_batch(cfg, TRAIN_B, seed=0), dev)
    summary.update(B=TRAIN_B, steps=TRAIN_STEPS)
    grads = {}
    per_step = {"plain": {}, "fused_mlp": {"ln_mlp": blocks}, "fused_block": {"fused_mixer_block": blocks}}
    for route, expected in per_step.items():
        r, grads[route], launches = train_route(dev, counters, route, batch)
        for name, n in launches.items():
            require(n == expected.get(name, 0) * TRAIN_STEPS,
                    f"train {route}: {name} launched {n} times in {TRAIN_STEPS} steps, expected "
                    f"{expected.get(name, 0)} a step")
        losses = r["losses"]
        require(all(np.isfinite(losses)) and all(np.isfinite(r["grad_norms"])), f"train {route}: {losses}")
        require(losses[-1] <= TRAIN_LOSS_FALL * losses[0], f"train {route}: loss {losses[0]} -> {losses[-1]}")
        summary[route] = r
        log(f"train {route} B={TRAIN_B}: {r['step_ms']:.2f} ms/step, {r['images_per_s']:.0f} img/s, "
            f"peak {r['peak_mem_gb']:.2f} GB, train_mfu {r['train_mfu']:.3f}, losses {losses}")
    plain_loss = summary["plain"]["losses"][0]
    for route in ("fused_mlp", "fused_block"):
        dl = abs(summary[route]["losses"][0] - plain_loss) / plain_loss
        errs, null = grad_agreement(grads[route], grads["plain"])
        ranked = sorted(errs, key=errs.get, reverse=True)
        worst, worst_null = ranked[0], max(null, key=null.get)
        summary[route]["step1_vs_plain"] = {
            "loss_rel": dl, "grad_rel_max": errs[worst], "grad_rel_max_param": worst,
            "grad_rel_median": float(np.median(list(errs.values()))),
            "grad_rel_top5": {n: errs[n] for n in ranked[:5]},
            "null_grad_ratio_max": null[worst_null], "null_grad_ratio_max_param": worst_null,
        }
        log(f"train {route} step 1 against plain: {summary[route]['step1_vs_plain']}")
        require(dl <= ROUTE_LOSS_TOL, f"train {route}: step-1 loss {dl} from the plain route's > {ROUTE_LOSS_TOL}")
        require(errs[worst] <= ROUTE_GRAD_TOL,
                f"train {route}: step-1 gradient of {worst} {errs[worst]} from the plain route's > {ROUTE_GRAD_TOL}")
        require(null[worst_null] <= NULL_GRAD_RATIO,
                f"train {route}: step-1 gradient of {worst_null} is {null[worst_null]} of its lin2.weight's, "
                f"> {NULL_GRAD_RATIO}")
    summary["tol"] = (f"step 1 against plain: loss <= {ROUTE_LOSS_TOL} relative, every parameter's gradient "
                      f"<= {ROUTE_GRAD_TOL} relative Frobenius but the token-mix output biases, whose exact "
                      f"gradient is zero: <= {NULL_GRAD_RATIO} of their block's lin2.weight gradient on both routes; "
                      f"8th loss <= {TRAIN_LOSS_FALL} x the first")
    del grads

    # 4b: GradCache on the plain route, its step 1 against the full batch's
    gc_step = two_steps(dev, counters, cfg, batch, accum_steps=GRADCACHE_ACCUM)
    full = summary["plain"]
    gc_step["loss_rel"] = abs(gc_step["loss"] - full["losses"][0]) / full["losses"][0]
    gc_step["grad_norm_rel"] = abs(gc_step["grad_norm"] - full["grad_norms"][0]) / full["grad_norms"][0]
    summary[f"gradcache_accum{GRADCACHE_ACCUM}"] = gc_step
    log(f"train GradCache accum {GRADCACHE_ACCUM}: {gc_step}")
    require(gc_step["loss_rel"] <= GRADCACHE_LOSS_TOL and gc_step["grad_norm_rel"] <= GRADCACHE_NORM_TOL,
            f"GradCache accum_steps={GRADCACHE_ACCUM} against the full batch: {gc_step}")

    # 4c: what each remat policy saves at B = 256, then the reference's
    # per-card batch
    plain1 = summary["plain"]["losses"][0], summary["plain"]["grad_norms"][0]
    fused1 = summary["fused_mlp"]["losses"][0], summary["fused_mlp"]["grad_norms"][0]
    remat_runs = [(f"plain_remat_{p}_B{TRAIN_B}", cfg.replace(remat=True, remat_policy=p), plain1, {})
                  for p in REMAT_POLICIES]
    remat_runs.append((f"fused_mlp_remat_all_hidden_B{TRAIN_B}",
                       cfg.replace(fused_mlp=True, remat=True, remat_policy="all_hidden"), fused1,
                       {"ln_mlp": 2 * blocks}))
    for key, remat_cfg, (loss1, norm1), launches in remat_runs:
        r = two_steps(dev, counters, remat_cfg, batch)
        summary[key] = r
        log(f"train {key}: {r}")
        require(r["loss"] == loss1, f"{key}: step-1 loss {r['loss']}, {loss1} without remat")
        require(abs(r["grad_norm"] - norm1) <= REMAT_NORM_TOL * norm1,
                f"{key}: step-1 gradient norm {r['grad_norm']}, {norm1} without remat")
        for name, n in r["launches"].items():
            require(n == launches.get(name, 0), f"{key}: {name} launched {n} times in two steps")
    peaks = [summary[f"plain_remat_{p}_B{TRAIN_B}"]["peak_mem_gb"] for p in REMAT_POLICIES]
    peaks.append(summary["plain"]["peak_mem_gb"])
    require(all(a < b for a, b in zip(peaks, peaks[1:])),
            f"B={TRAIN_B} peak memory under remat none, mlp_hidden, all_hidden and without: {peaks} GB")
    del batch
    free_card()
    big = on_device(train_batch(cfg, BIG_B, seed=1), dev)
    r = two_steps(dev, counters, cfg.replace(fused_mlp=True, remat=True), big)
    require(r["launches"]["ln_mlp"] == 2 * blocks, f"B={BIG_B} fused_mlp + remat: launches {r['launches']} "
            f"in two steps, expected ln_mlp {blocks} a step (a block's recompute launches nothing)")
    summary[f"fused_mlp_remat_B{BIG_B}"] = r
    r = two_steps(dev, counters, cfg, big, accum_steps=BIG_ACCUM)
    require(sum(r["launches"].values()) == 0, f"B={BIG_B} plain accum: launches {r['launches']}")
    summary[f"plain_accum{BIG_ACCUM}_B{BIG_B}"] = r
    remat_big = summary[f"fused_mlp_remat_B{BIG_B}"]
    agree = {"loss_rel": abs(remat_big["loss"] - r["loss"]) / r["loss"],
             "grad_norm_rel": abs(remat_big["grad_norm"] - r["grad_norm"]) / r["grad_norm"],
             "tol": f"loss <= {BIG_LOSS_TOL}, gradient norm <= {BIG_NORM_TOL} relative (bf16, step 1)"}
    summary[f"B{BIG_B}_fused_mlp_remat_vs_plain_accum{BIG_ACCUM}"] = agree
    log(f"train B={BIG_B} fused_mlp + remat against plain accum {BIG_ACCUM}: {agree}")
    require(agree["loss_rel"] <= BIG_LOSS_TOL and agree["grad_norm_rel"] <= BIG_NORM_TOL,
            f"B={BIG_B}: fused_mlp + remat against plain accum_steps={BIG_ACCUM}: {agree}")
    for k in (f"fused_mlp_remat_B{BIG_B}", f"plain_accum{BIG_ACCUM}_B{BIG_B}"):
        log(f"train {k}: {summary[k]}")
    del big
    free_card()
    summary["phase_s"] = time.perf_counter() - t0
    return summary


# ---- phase 5: the trainer ------------------------------------------------------

TRAINER_B = 256
TRAINER_BATCHES = 4  # the cached epoch: 1024 samples
TRAINER_EPOCHS = 3  # 12 steps
TRAINER_EVERY = 4  # checkpoint cadence, and so the Throughput windows
TRAINER_KEEP = 2
TRAINER_CRASH = 6  # run B's drill: the crash after step 6 resumes from step 4
TRAINER_EMA = 0.999
EXPORT_CAPTIONS, EXPORT_IMAGES = 5, 7
# The same 12 bare steps at other learning rates and warmups: whether any
# makes the loss fall 10% in 12 steps (the default's 12th loss read 0.979x
# its first, with a spike at step 3, where the lr peaks). Reported, not held.
LR_PROBE = ((1e-4, 2), (2e-4, 6), (2e-3, 2))
CLI_ARGS = ["--synthetic", "--preset", "mixer-b32", "--global-batch-size", "64", "--steps-per-epoch", "2",
            "--epochs", "1", "--checkpoint-every", "2"]
CLI_TIMEOUT_S = 600


def trainer_configs():
    """Full-width Mixer-B/32, bf16 compute, f32 masters, ``fused_mlp`` and
    remat on (``train.py``'s default), B = 256, EMA 0.999."""
    from clip_mixer_tpu_torch import PRESETS
    from clip_mixer_tpu_torch.config import TrainConfig

    cfg = PRESETS[TRAIN_PRESET].replace(fused_mlp=True, remat=True)
    tcfg = TrainConfig(global_batch_size=TRAINER_B, epochs=TRAINER_EPOCHS, checkpoint_every_steps=TRAINER_EVERY,
                       keep_checkpoints=TRAINER_KEEP, ema_decay=TRAINER_EMA)
    return cfg, tcfg


def trainer_source(cfg, cache_dir=None):
    """``CacheSource(SyntheticSource(...))``, disk-backed when ``cache_dir``
    (the first source fills it; later ones memmap the files)."""
    from clip_mixer_tpu_torch.data.pipeline import CacheSource, SyntheticSource

    inner = SyntheticSource(batch_size=TRAINER_B, image_size=cfg.image_resolution, n_batches=TRAINER_BATCHES,
                            context_length=cfg.context_length)
    return inner if cache_dir is None else CacheSource(inner, cache_dir=cache_dir)


def host_state(state):
    """Every tensor of a TrainState on the host: parameters, moments, EMA."""
    out = {f"model.{k}": v.detach().cpu() for k, v in state.model.state_dict().items()}
    for slot in ("mu", "nu", "ema"):
        out.update({f"{slot}.{k}": v.detach().cpu() for k, v in getattr(state.opt_state, slot).items()})
    return out


def state_gap(got, want):
    """(max |got - want| over every tensor, the tensor where it is, the
    number of tensors that differ at all)."""
    gaps = {k: float((got[k] - want[k]).abs().max()) for k in want}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst, sum(g > 0 for g in gaps.values())


def metric_rows(run_dir):
    with open(f"{run_dir}/runs/metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    series = {}
    for r in rows:
        series.setdefault(r["name"], {})[r["step"]] = r["value"]
    return series


def data_wait_ms(timings, steps_per_epoch):
    """A run's wait for each batch: the mean a step, at epoch starts (the
    prefetch thread starts with each epoch) and at the other steps."""
    waits = [w * 1e3 for w in timings["data_wait_s"]]
    starts = waits[::steps_per_epoch]
    others = [w for i, w in enumerate(waits) if i % steps_per_epoch]
    return {"per_step": float(np.mean(waits)), "epoch_start": float(np.mean(starts)),
            "other_steps": float(np.mean(others)) if others else None}


def bare_steps(cfg, tcfg, data, dev, steps):
    """The same training without the trainer: ``make_train_step`` from the
    same seed over the same batches, moved to the card up front. Returns
    each step's loss and the mean ms of the steps after the first epoch
    (CUDA events)."""
    from clip_mixer_tpu_torch import CLIP
    from clip_mixer_tpu_torch.parallel.train_step import init_train_state, make_train_step
    from clip_mixer_tpu_torch.train.optimizer import make_optimizer

    batches = [on_device(b, dev) for e in range(tcfg.epochs) for b in data.iter_batches(e)]
    opt = make_optimizer(tcfg, total_steps=steps)
    state = init_train_state(CLIP(cfg, device=dev, generator=torch.Generator().manual_seed(tcfg.seed)), opt)
    step = make_train_step(cfg, tcfg, opt, accum_steps=tcfg.accum_steps)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    metrics = []
    for i, b in enumerate(batches):
        if i == TRAINER_BATCHES:
            start.record()
        state, m = step(state, b)
        metrics.append(m)
    end.record()
    end.synchronize()
    losses = [float(m["loss"]) for m in metrics]
    return losses, start.elapsed_time(end) / (len(batches) - TRAINER_BATCHES)


def trainer_run(cfg, tcfg, data, run_dir, dev, counters, expect_steps, what):
    """One Trainer from seed 0 to the end of ``tcfg``'s epochs, its launches
    counted: ``ln_mlp`` 24 a step, nothing else."""
    from clip_mixer_tpu_torch.train.trainer import Trainer

    blocks = cfg.vision_layers + cfg.text_layers
    counters.reset()
    tr = Trainer(cfg, tcfg, data, run_dir, device=dev)
    start = tr.global_step
    tr.train()
    torch.cuda.synchronize()
    launches = counters.read()
    steps = tr.global_step - start
    require(steps == expect_steps, f"{what}: {steps} steps, expected {expect_steps}")
    require(launches == {"ln_mlp": blocks * steps, "preprocess": 0, "fused_mixer_block": 0},
            f"{what}: launches {launches} in {steps} steps, expected ln_mlp {blocks} a step")
    return tr, launches


def trainer_path(dev, counters):
    """Phase 5: the trainer stack on full-width Mixer-B/32 (bf16, f32
    masters, ``fused_mlp``, remat, EMA) over a disk-backed CacheSource:
    run A uninterrupted, run C the same in a fresh directory (the
    determinism witness), run B crashed by the drill after 6 steps and
    resumed from step 4 by a new Trainer; then one epoch fed straight from
    SyntheticSource, the export served through InferenceEngine, and the CLI
    in a subprocess."""
    import os
    import shutil
    import tempfile
    import dataclasses

    from clip_mixer_tpu_torch import CLIP
    from clip_mixer_tpu_torch.api import load_pretrained
    from clip_mixer_tpu_torch.serving import InferenceEngine
    from clip_mixer_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    cfg, tcfg = trainer_configs()
    steps = TRAINER_BATCHES * TRAINER_EPOCHS
    blocks = cfg.vision_layers + cfg.text_layers
    root = tempfile.mkdtemp(prefix="chip_smoke_trainer_")
    cache = os.path.join(root, "cache")
    out = {"B": TRAINER_B, "steps": steps, "checkpoint_every": TRAINER_EVERY, "ema_decay": TRAINER_EMA,
           "route": "fused_mlp, remat (policy none)"}
    try:
        t0 = time.perf_counter()
        data = trainer_source(cfg, cache)
        require(data.batches_per_epoch == TRAINER_BATCHES, f"cache holds {data.batches_per_epoch} batches")
        out["cache_fill_s"] = time.perf_counter() - t0

        # run A, uninterrupted
        free_card()
        a, launches_a = trainer_run(cfg, tcfg, data, os.path.join(root, "a"), dev, counters, steps, "run A")
        out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
        state_a = host_state(a.state)
        series = metric_rows(a.run_dir)
        losses = [series["Loss"][s] for s in range(1, steps + 1)]
        require(sorted(series["Loss"]) == list(range(1, steps + 1)), f"run A Loss rows at {sorted(series['Loss'])}")
        boundaries = list(range(TRAINER_EVERY, steps + 1, TRAINER_EVERY))
        require(sorted(series["Throughput (imgs/s)"]) == boundaries,
                f"run A Throughput rows at {sorted(series['Throughput (imgs/s)'])}, expected {boundaries}")
        ips = [series["Throughput (imgs/s)"][s] for s in boundaries]
        steady = float(np.mean(ips[1:]))
        timings = a.timings
        out.update(
            launches=launches_a, losses=losses, throughput_imgs_per_s=ips,
            steady_imgs_per_s=steady, step_ms=TRAINER_B / steady * 1e3,
            data_wait_ms=data_wait_ms(timings, TRAINER_BATCHES),
            save_ms=[t * 1e3 for t in timings["save_s"]], save_bytes=timings["save_bytes"],
            export_ms=timings["export_s"] * 1e3, checkpoints_kept=a.checkpointer.all_steps(),
        )
        log(f"trainer run A: {steady:.0f} img/s steady ({ips}), losses {losses}, "
            f"data wait {out['data_wait_ms']} ms, saves {out['save_ms']} ms "
            f"({out['save_bytes']} bytes), export {out['export_ms']:.0f} ms, peak {out['peak_mem_gb']:.2f} GB")
        require(out["checkpoints_kept"] == boundaries[-TRAINER_KEEP:], f"run A kept {out['checkpoints_kept']}")
        require(all(np.isfinite(losses)), f"run A losses {losses}")
        require(losses[-1] < losses[0], f"run A: loss {losses[0]} -> {losses[-1]}")
        ema_sd = {k: v.detach().clone() for k, v in a.state.model.state_dict().items()}
        ema_sd.update({k: v.detach().clone() for k, v in a.state.opt_state.ema.items()})
        del a
        shutil.rmtree(os.path.join(root, "a", "checkpoints"))  # A's export stays for the serving check
        free_card()

        # the bare step over the same batches: the trainer adds nothing to the numbers
        bare_losses, bare_ms = bare_steps(cfg, tcfg, data, dev, steps)
        out["bare_step"] = {"ms": bare_ms, "losses_equal": bare_losses == losses,
                            "trainer_step_ms_over_bare": out["step_ms"] / bare_ms}
        require(bare_losses == losses, f"run A's losses {losses} are not the bare step's {bare_losses}")
        free_card()
        probe = {}
        for lr, warmup in LR_PROBE:
            probe_losses, _ = bare_steps(cfg, dataclasses.replace(tcfg, learning_rate=lr, warmup_steps=warmup),
                                         data, dev, steps)
            probe[f"lr={lr},warmup={warmup}"] = {"last_over_first": probe_losses[-1] / probe_losses[0],
                                                 "max": max(probe_losses)}
            free_card()
        out["bare_step"]["lr_probe"] = probe
        log(f"trainer against the bare step: {out['bare_step']}")

        # run C: the same run in a fresh directory, the determinism witness
        c, _ = trainer_run(cfg, tcfg, trainer_source(cfg, cache), os.path.join(root, "c"), dev, counters, steps,
                           "run C")
        gap_c = state_gap(host_state(c.state), state_a)
        del c
        shutil.rmtree(os.path.join(root, "c"))
        free_card()

        # run B: the crash drill after step 6, then a new Trainer resumes from step 4
        run_b = os.path.join(root, "b")
        counters.reset()
        crashing = Trainer(cfg, dataclasses.replace(tcfg, crash_after_steps=TRAINER_CRASH),
                           trainer_source(cfg, cache), run_b, device=dev)
        crashed = False
        try:
            crashing.train()
        except RuntimeError as e:
            crashed = "crash_after_steps" in str(e)
            if not crashed:
                raise
        require(crashed, f"run B: the crash_after_steps={TRAINER_CRASH} drill did not raise")
        require(counters.read()["ln_mlp"] == blocks * TRAINER_CRASH,
                f"run B before the crash: launches {counters.read()} in {TRAINER_CRASH} steps")
        resume_from = crashing.checkpointer.latest_step()
        del crashing
        free_card()
        b, launches_b = trainer_run(cfg, tcfg, trainer_source(cfg, cache), run_b, dev, counters,
                                    steps - resume_from, "run B resumed")
        require(resume_from == TRAINER_EVERY, f"run B resumed from step {resume_from}")
        out["restore_ms"] = b.timings["restore_s"] * 1e3
        gap_b = state_gap(host_state(b.state), state_a)
        del b
        shutil.rmtree(run_b)
        free_card()
        out["resume"] = {"resumed_from_step": resume_from, "launches_after_resume": launches_b,
                         "C_vs_A": {"max_abs": gap_c[0], "at": gap_c[1], "tensors_differing": gap_c[2]},
                         "B_vs_A": {"max_abs": gap_b[0], "at": gap_b[1], "tensors_differing": gap_b[2]}}
        log(f"trainer resume: {out['resume']}")
        if gap_c[0] == 0.0:
            require(gap_b[0] == 0.0, f"run C is run A bit for bit, but the resumed run B is not: {gap_b}")
            out["resume"]["tol"] = "bit for bit (C equals A bit for bit)"
        else:
            require(gap_b[0] <= gap_c[0], f"run B is {gap_b[0]} from run A, more than the {gap_c[0]} between "
                                           f"two uninterrupted runs")
            out["resume"]["tol"] = f"B - A <= max |C - A| = {gap_c[0]}"

        # one epoch fed straight from SyntheticSource, no cache
        free_card()
        uncached_tcfg = dataclasses.replace(tcfg, epochs=1)
        u, _ = trainer_run(cfg, uncached_tcfg, trainer_source(cfg), os.path.join(root, "u"), dev, counters,
                           TRAINER_BATCHES, "uncached run")
        u_ips = metric_rows(u.run_dir)["Throughput (imgs/s)"][TRAINER_BATCHES]
        out["uncached"] = {"imgs_per_s": u_ips, "step_ms": TRAINER_B / u_ips * 1e3,
                           "data_wait_ms": data_wait_ms(u.timings, TRAINER_BATCHES),
                           "cached_first_window_imgs_per_s": ips[0]}
        log(f"trainer uncached: {out['uncached']}")
        del u
        shutil.rmtree(os.path.join(root, "u"))
        free_card()

        # the export through InferenceEngine against run A's EMA through the same towers
        t0 = time.perf_counter()
        model, exp_cfg = load_pretrained(os.path.join(root, "a", "export"), device=dev)
        torch.cuda.synchronize()
        out["load_pretrained_ms"] = (time.perf_counter() - t0) * 1e3
        require(exp_cfg == cfg, f"the export's config {exp_cfg}")
        ref_model = CLIP(cfg, device=dev)
        ref_model.load_state_dict(ema_sd, strict=True)
        images = next(iter(trainer_source(cfg).iter_batches(0)))["images"][:EXPORT_IMAGES]
        captions = TEXTS[:EXPORT_CAPTIONS]
        served, ref = InferenceEngine(model), InferenceEngine(ref_model)
        cos = {}
        encoders = (("text", lambda e: e.encode_text(captions)), ("image", lambda e: e.encode_image_arrays(images)))
        for what, fn in encoders:
            got, want = fn(served), fn(ref)
            check_features(got, len(want), cfg.embed_dim, f"export encode_{what}")
            # a true cosine: bf16 features are unit vectors only to within their rounding
            got64, want64 = got.astype(np.float64), want.astype(np.float64)
            cos[what] = float(((got64 * want64).sum(-1) / np.linalg.norm(got64, axis=-1)
                               / np.linalg.norm(want64, axis=-1)).min())
            require(cos[what] >= COSINE_MIN, f"export {what} features: cosine {cos[what]} < {COSINE_MIN}")
        out["export_min_cosine_vs_ema"] = cos
        del model, ref_model, served, ref, ema_sd
        free_card()

        # the command line, in a process of its own
        run_name = f"chip_smoke_cli_{os.getpid()}"
        repo = os.path.dirname(os.path.abspath(__file__))
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "clip_mixer_tpu_torch.train_cli", *CLI_ARGS,
                               "--run-name", run_name], cwd=repo, capture_output=True, text=True,
                              timeout=CLI_TIMEOUT_S)
        out["cli_s"] = time.perf_counter() - t0
        cli_dir = os.path.join(repo, "outputs", run_name)
        exported = os.path.isfile(os.path.join(cli_dir, "export", "model.pt"))
        shutil.rmtree(cli_dir, ignore_errors=True)
        if proc.returncode != 0 or not exported:
            log(f"train_cli stdout: {proc.stdout[-4000:]}")
            log(f"train_cli stderr: {proc.stderr[-4000:]}")
        require(proc.returncode == 0, f"train_cli exited {proc.returncode}")
        require(exported, "train_cli wrote no export/model.pt")
        out["cli"] = {"argv": CLI_ARGS, "rc": proc.returncode, "export": True}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["blocks"] = blocks
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---- phase 6: int8 serving ----------------------------------------------------

INT8_CALIB_N = 128  # calibration images and captions
INT8_GATE_N = 4096  # each gate's set: the size at which the JAX package's flip ratios are resolved
INT8_GATE_BATCH = 256
INT8_BANK_ROWS = 262144  # x 512 f32: 512 MB on the card
INT8_RETRIEVE_TOP = 5
INT8_TOWER_BUCKETS = (8, 128)
INT8_INT_MM_SHAPES = {  # (M, K, N) of the channel mixes at bucket 128
    "vision_in": (128 * 50, 768, 3072), "vision_out": (128 * 50, 3072, 768),
    "text_in": (128 * 77, 512, 2048), "text_out": (128 * 77, 2048, 512),
}
INT8_TEXT_CPU_N = 64  # captions through the int8 text tower on the card and on the CPU
BLOCK_COSINE = 0.9999  # per row, each int8 text block on the card against the CPU (both f32 compute)
FEATURES_COSINE = 0.999  # per row, the int8 text features on the card against the CPU, end to end
INT8_PEAK_OPS_PER_S = 1979e12  # H100 SXM int8 tensor cores, dense
GATE_CLASSES = [
    "cat", "dog", "horse", "cow", "sheep", "bird", "eagle", "owl", "fish", "shark", "whale", "frog", "snake",
    "turtle", "spider", "butterfly", "bee", "car", "truck", "bus", "bicycle", "motorcycle", "airplane", "boat",
    "train", "tractor", "house", "castle", "bridge", "tower", "church", "barn", "tree", "flower", "mushroom",
    "mountain", "lake", "beach", "forest", "desert", "chair", "table", "lamp", "clock", "phone", "laptop",
    "guitar", "piano", "violin", "drum", "cup", "bottle", "plate", "bowl of soup", "pizza", "banana", "apple",
    "orange", "cake", "sandwich", "shoe", "hat", "umbrella", "backpack",
]  # 64 classes
GATE_TEMPLATES = ["a photo of a {}.", "a blurry photo of a {}.", "a close-up photo of a {}.", "a drawing of a {}."]
GATE_ADJECTIVES = ("small", "big", "red", "old", "young", "dark", "bright", "wet", "wooden", "plastic", "metal",
                   "striped", "spotted", "broken", "new", "tiny")
GATE_CAPTION_TEMPLATES = ("a photo of a {} {}.", "an image of a {} {}.", "a close-up of a {} {}.",
                          "a {} {} in the picture.")
CAPTIONS = [
    f"a {adj} photo of a {noun}"
    for adj in ("blurry", "bright", "dark", "close-up", "black and white", "cropped", "old", "good")
    for noun in GATE_CLASSES[:16]
]  # 128 fixed captions


def gate_captions():
    """The text gate's set: 4096 fixed captions, 16 adjectives x 4 templates
    x the 64 gate classes."""
    return [t.format(a, c) for a in GATE_ADJECTIVES for t in GATE_CAPTION_TEMPLATES for c in GATE_CLASSES]


def npy_b64(images):
    import base64
    import io

    out = []
    for img in images:
        buf = io.BytesIO()
        np.save(buf, img)
        out.append(base64.b64encode(buf.getvalue()).decode())
    return out


def post(base, path, payload):
    req = urllib.request.Request(f"{base}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def int8_http(engine, images, texts, paths):
    """/encode_text, /encode_image, /classify, /index and /retrieve against
    the engine's own calls; the images go as ``.npy`` (the card's host has
    no PIL); /healthz must report ``paths``. Returns the /healthz and
    /metrics payloads."""
    from clip_mixer_tpu_torch.serving import serve

    server = serve(engine, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{server.server_address[1]}"
        blobs = npy_b64(images)
        feats = np.asarray(post(base, "/encode_text", {"texts": texts})["features"], np.float32)
        np.testing.assert_allclose(feats, engine.encode_text(texts), atol=1e-6)
        feats = np.asarray(post(base, "/encode_image", {"images_b64": blobs})["features"], np.float32)
        np.testing.assert_allclose(feats, engine.encode_image_arrays(images), atol=1e-6)
        got = post(base, "/classify", {"images_b64": blobs, "top_k": 3})["results"]
        require(got == engine.classify(images, top_k=3), "HTTP /classify differs from classify()")
        ids = [f"img{i}" for i in range(len(images))]
        require(post(base, "/index", {"images_b64": blobs, "ids": ids}) == {"indexed": len(ids)}, "HTTP /index")
        got = post(base, "/retrieve", {"texts": texts, "top_k": 3})["results"]
        require(got == engine.retrieve(texts, top_k=3), "HTTP /retrieve differs from retrieve()")
        require(all(r["id"] in ids for row in got for r in row), got)
        with urllib.request.urlopen(f"{base}/healthz", timeout=60) as r:
            health = json.loads(r.read())
        with urllib.request.urlopen(f"{base}/metrics", timeout=60) as r:
            metrics = json.loads(r.read())["endpoints"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    require(health["paths"] == paths and health["index_size"] == len(images), health)
    for ep in ("/encode_text", "/encode_image", "/classify", "/index", "/retrieve"):
        require(metrics[ep]["count"] == 1 and metrics[ep]["errors"] == 0, f"{ep}: {metrics.get(ep)}")
    return health, metrics


def int8_device_bank(engine, dev):
    """A 262,144 x 512 f32 bank through ``load_index`` (automatically on the
    card at this size): ``retrieve`` against the host bank's top-5 ids."""
    g = torch.Generator(device=dev).manual_seed(6)
    feats = torch.randn(INT8_BANK_ROWS, engine.cfg.embed_dim, generator=g, device=dev).cpu().numpy()
    ids = [str(i) for i in range(INT8_BANK_ROWS)]
    queries = TEXTS[:40]
    out = {"rows": INT8_BANK_ROWS, "bytes": feats.nbytes, "queries": len(queries)}
    engine.load_index(feats, ids, device=False)
    t0 = time.perf_counter()
    host = engine.retrieve(queries, top_k=INT8_RETRIEVE_TOP)
    out["host_retrieve_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    engine.load_index(feats, ids)
    torch.cuda.synchronize()
    out["load_ms"] = (time.perf_counter() - t0) * 1e3
    bank = engine._index[0]
    require(isinstance(bank, torch.Tensor) and bank.is_cuda, "a 262,144-row bank did not land on the card")
    engine.warmup()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        dev_rows = engine.retrieve(queries, top_k=INT8_RETRIEVE_TOP)
        times.append((time.perf_counter() - t0) * 1e3)
    out["device_retrieve_ms"] = times
    require([[r["id"] for r in row] for row in dev_rows] == [[r["id"] for r in row] for row in host],
            "device-bank top-5 ids differ from the host bank's")
    gap = max(abs(a["score"] - b["score"]) for ra, rb in zip(dev_rows, host) for a, b in zip(ra, rb))
    out["max_score_gap"] = gap
    q = np.random.default_rng(7).normal(size=(128, engine.cfg.embed_dim)).astype(np.float32)
    out["sims_ms_q128"] = cuda_ms(lambda: engine._device_sims(q, bank), iters=5)
    out["sims_bound_ms"] = bank.numel() * 4 / HBM_BYTES_PER_S * 1e3  # the bank read once
    log(f"device bank: {out}")
    return out


def int8_text_card_vs_cpu(model, a_scales, n=INT8_TEXT_CPU_N):
    """The int8 text tower at full width on the card against its CPU
    computation: the same weights and activation scales in f32 compute, on
    ``n`` gate captions. Each block is fed the CPU's input to it and must
    give the CPU's output at per-row cosine >= ``BLOCK_COSINE``; the
    features, end to end, at ``FEATURES_COSINE``. Neither bound is f32's: a
    static scale turns an ulp of difference at a rounding boundary into a
    whole quantisation step, which moves a row of the first blocks (whose
    residual stream is still the small embedding) by a few 1e-5 in cosine,
    and the steps compound over the blocks. Block 0 with its ``b_in``
    zeroed must fail the block bound."""
    from clip_mixer_tpu_torch import CLIP
    from clip_mixer_tpu_torch.evals.quant_gate import float32_twin
    from clip_mixer_tpu_torch.models.clip import l2_normalize
    from clip_mixer_tpu_torch.ops.quant import encode_text_q, quantize_text_tower
    from clip_mixer_tpu_torch.text.tokenize import tokenize

    def row_cos(a, b):
        a, b = a.double().flatten(0, -2), b.double().flatten(0, -2)
        return (a * b).sum(-1) / (a.norm(dim=-1) * b.norm(dim=-1))

    texts = torch.from_numpy(tokenize(gate_captions()[:n], model.cfg.context_length, truncate=True))
    cpu = CLIP(model.cfg.replace(compute_dtype="float32"), device="cpu")
    cpu.load_state_dict(model.state_dict())
    t0 = time.perf_counter()
    with torch.inference_mode():
        q_cpu = quantize_text_tower(cpu.eval(), a_scales)
        q_card = quantize_text_tower(float32_twin(model), a_scales)

        def card_block(i, x):
            return q_card.blocks[i](x.to(model.device), q_card.a_ch_in[i], q_card.a_ch_hidden[i]).cpu()

        x0 = x = q_cpu.token_embedding.weight[texts.long()]
        blocks, outs = [], []
        for i, block in enumerate(q_cpu.blocks):
            outs.append(block(x, q_cpu.a_ch_in[i], q_cpu.a_ch_hidden[i]))
            blocks.append(float(row_cos(card_block(i, x), outs[-1]).min()))
            x = outs[-1]
        want = l2_normalize(encode_text_q(q_cpu, texts))
        got = l2_normalize(encode_text_q(q_card, texts.to(model.device))).cpu()
        b0 = q_card.blocks[0]
        b_in = b0.b_in
        b0.b_in = torch.nn.Parameter(torch.zeros_like(b_in), requires_grad=False)
        fault = float(row_cos(card_block(0, x0), outs[0]).min())
        b0.b_in = b_in
    feats = row_cos(got, want)
    out = {"n": n, "block_min_cosine": blocks, "features_min_cosine": float(feats.min()),
           "features_mean_cosine": float(feats.mean()), "block0_without_b_in_min_cosine": fault,
           "s": time.perf_counter() - t0}
    log(f"int8 text tower (f32 compute), card against CPU: {out}")
    require(min(blocks) >= BLOCK_COSINE and feats.min() >= FEATURES_COSINE,
            f"the int8 text tower on the card differs from its CPU computation: {out}")
    require(fault < BLOCK_COSINE, f"block 0 without its b_in passed the block bound: {out}")
    return out


def time_int8_towers(model, qvis, qtext, dev):
    """Each tower at buckets 8 and 128, bf16: the int8 blocks beside the
    fused-block, ``fused_mlp`` and plain bf16 towers, in turns A B C D D C B
    A, each the mean of 10 back-to-back calls."""
    from clip_mixer_tpu_torch.ops.kernels.mixer_block import mixer_tower_fused

    cfg = model.cfg
    g = torch.Generator().manual_seed(9)
    rows = {}
    for name, tower, qtower, T, D in (("vision", model.visual.transformer, qvis, cfg.vision_tokens, cfg.vision_width),
                                      ("text", model.transformer, qtext, cfg.context_length, cfg.text_width)):
        for B in INT8_TOWER_BUCKETS:
            x = torch.randn(B, T, D, generator=g).to(device=dev, dtype=torch.bfloat16)
            ways = {
                "int8_ms": lambda: qtower.run_blocks(x),
                "fused_block_ms": lambda: mixer_tower_fused(tower, x),
                "fused_mlp_ms": lambda: tower(x),  # with every block's fused_mlp set
                "plain_ms": lambda: tower(x),
            }
            times = {k: [] for k in ways}
            with torch.inference_mode():
                for k in [*ways, *reversed(ways)]:
                    for block in tower.mixBlocks:
                        block.fused_mlp = k == "fused_mlp_ms"
                    times[k].append(cuda_ms(ways[k], iters=10))
                for block in tower.mixBlocks:
                    block.fused_mlp = False
            row = {k: sum(v) / len(v) for k, v in times.items()}
            row["each_run_ms"] = times
            rows[f"{name}_b{B}"] = row
            log(f"int8 tower {name} at bucket {B}: {row}")
    return rows


def time_int_mm(dev):
    """``torch._int_mm`` alone at the channel-mix shapes, with the weight as
    the transposed view of [out, in] (the quant modules' layout; the
    [in, out] layout is timed by ``scripts/torch_int8_gate_anatomy.py``),
    beside a bf16 ``torch.matmul`` of the same shape, in turns."""
    g = torch.Generator().manual_seed(10)
    rows = {}
    for label, (M, K, N) in INT8_INT_MM_SHAPES.items():
        a = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8).to(dev)
        w = torch.randint(-127, 128, (N, K), generator=g, dtype=torch.int8).to(dev)
        ab, wb = a.to(torch.bfloat16), w.to(torch.bfloat16)
        ways = {
            "out_in_view_ms": lambda: torch._int_mm(a, w.t()),
            "bf16_matmul_ms": lambda: torch.matmul(ab, wb.t()),
        }
        times = {k: [] for k in ways}
        for k in [*ways, *reversed(ways)]:
            times[k].append(cuda_ms(ways[k], iters=20))
        row = {k: sum(v) / len(v) for k, v in times.items()}
        ops = 2.0 * M * K * N
        for k in ways:
            row[k.replace("_ms", "_tops")] = ops / (row[k] * 1e-3) / 1e12
        row["int8_bound_ms"] = ops / INT8_PEAK_OPS_PER_S * 1e3
        row["shape"] = [M, K, N]
        rows[label] = row
        log(f"_int_mm {label} {M}x{K}x{N}: {row}")
    return rows


def time_int8_front_end(model, qvis, dev):
    """B = 128 from 256x256 uint8: the planar front end against the
    ``preprocess`` kernel and the ``"torch"`` preprocess, alone and with
    the tower behind each (int8 planar; bf16 fused-block and plain)."""
    from clip_mixer_tpu_torch.ops.kernels.mixer_block import route_towers
    from clip_mixer_tpu_torch.ops.preprocess import make_batch_preprocess
    from clip_mixer_tpu_torch.ops.quant import encode_image_q_patches, make_planar_front_end

    cfg = model.cfg
    x = torch.from_numpy(np.random.default_rng(11).integers(0, 256, (128, 256, 256, 3), dtype=np.uint8)).to(dev)
    planar = make_planar_front_end(cfg, (256, 256), qvis.a_patch)
    kernel = make_batch_preprocess((256, 256), cfg.image_resolution, dtype=torch.bfloat16, backend="kernel")
    plain = make_batch_preprocess((256, 256), cfg.image_resolution, dtype=torch.bfloat16, backend="torch")
    ways = {
        "planar_ms": lambda: planar(x),
        "preprocess_kernel_ms": lambda: kernel(x),
        "preprocess_torch_ms": lambda: plain(x),
        "int8_planar_encode_ms": lambda: encode_image_q_patches(qvis, planar(x)),
        "bf16_fused_block_encode_ms": lambda: model.encode_image(kernel(x)),
        "bf16_plain_encode_ms": lambda: model.encode_image(plain(x)),
    }
    times = {k: [] for k in ways}
    with torch.inference_mode():
        for k in [*ways, *reversed(ways)]:
            route_towers(model, k == "bf16_fused_block_encode_ms")
            times[k].append(cuda_ms(ways[k], iters=10))
    route_towers(model, False)
    row = {k: sum(v) / len(v) for k, v in times.items()}
    row["each_run_ms"] = times
    log(f"int8 front end at B = 128: {row}")
    return row


def int8_path(dev, counters):
    """Phase 6: int8 (W8A8) serving of full-width Mixer-B/32 (bf16, random
    weights from seed 0): calibrate from 128 images and 128 captions, save
    the artifact and serve it from a second engine bit for bit; the three
    noise-floor gates; feature agreement with bf16; the HTTP endpoints of an
    int8 engine with ``input_hw=(256, 256)`` (the planar front end); a
    262,144-row device bank. The kernel launch counters stay at 0 through
    all of it; then the timing."""
    import os
    import shutil
    import tempfile

    from clip_mixer_tpu_torch import CLIP, PRESETS
    from clip_mixer_tpu_torch.evals import quant_gate as gates
    from clip_mixer_tpu_torch.serving import InferenceEngine
    from clip_mixer_tpu_torch.text.tokenize import tokenize

    t_phase = time.perf_counter()
    cfg = PRESETS["mixer-b32"]
    require(not cfg.fused_mlp and cfg.compute_dtype == "bfloat16", "phase 6 serves the bf16 plain-chain config")
    sites = INT8_CALIB_N * cfg.vision_tokens * 4 * cfg.vision_width
    require(sites > 2**24, f"the vision ch_hidden site holds {sites} elements, not above 2^24")
    out = {"calibration_images": INT8_CALIB_N, "calibration_captions": len(CAPTIONS), "ch_hidden_site_elements": sites,
           "gate_n": INT8_GATE_N}
    root = tempfile.mkdtemp(prefix="chip_smoke_int8_")
    try:
        free_card()
        model = CLIP(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        calib = gates.synthetic_images(INT8_CALIB_N, cfg.image_resolution, seed=0)
        artifact = os.path.join(root, "scales.npz")
        counters.reset()

        # calibrate, quantize, save; a second engine from the artifact
        a = InferenceEngine(model)
        t0 = time.perf_counter()
        a.enable_int8(calib, CAPTIONS, save_calibration=artifact)
        torch.cuda.synchronize()
        out["enable_int8_s"] = time.perf_counter() - t0
        require(a.path_kinds == {"image": "int8", "text": "int8"}, a.path_kinds)
        qvis, qtext = a._image_path[1], a._text_path[1]
        out["a_scales"] = {"image": {k: v.float().cpu().numpy().tolist() for k, v in qvis.a_scales().items()},
                           "text": {k: v.float().cpu().numpy().tolist() for k, v in qtext.a_scales().items()}}
        out["artifact_bytes"] = os.path.getsize(artifact)
        b = InferenceEngine(model)
        b.enable_int8(calibration=artifact)
        probe = gates.synthetic_images(100, cfg.image_resolution, seed=5)
        img_a, txt_a = a.encode_image_arrays(probe), a.encode_text(TEXTS)
        check_features(img_a, 100, cfg.embed_dim, "int8 encode_image_arrays(100)")
        check_features(txt_a, len(TEXTS), cfg.embed_dim, "int8 encode_text(40)")
        require(np.array_equal(b.encode_image_arrays(probe), img_a), "the artifact's engine: image features differ")
        require(np.array_equal(b.encode_text(TEXTS), txt_a), "the artifact's engine: text features differ")
        del b
        out["text_int8_card_vs_cpu"] = int8_text_card_vs_cpu(model, qtext.a_scales())

        # feature agreement with the bf16 engine on the same weights
        f = InferenceEngine(model)
        cos_img = (img_a * f.encode_image_arrays(probe)).sum(-1)
        cos_txt = (txt_a * f.encode_text(TEXTS)).sum(-1)
        out["cosine_int8_vs_bf16"] = {"image_min": float(cos_img.min()), "image_mean": float(cos_img.mean()),
                                      "text_min": float(cos_txt.min()), "text_mean": float(cos_txt.mean())}
        log(f"int8 vs bf16 features: {out['cosine_int8_vs_bf16']}")

        # the three noise-floor gates
        classifier = gates.build_float_classifier(model, GATE_CLASSES, GATE_TEMPLATES, batch_size=INT8_GATE_BATCH)
        gate_out = {}
        t0 = time.perf_counter()
        imgs = gates.synthetic_images(INT8_GATE_N, cfg.image_resolution, seed=3)
        gate_out["image"] = gates.noise_floor_gate(model, imgs, classifier, calibrate_n=INT8_CALIB_N,
                                                   batch_size=INT8_GATE_BATCH)
        gate_out["image"]["s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        src = gates.synthetic_images(INT8_GATE_N, 256, seed=1)
        gate_out["frontend_planar"] = gates.frontend_noise_floor_gate(
            model, src, classifier, calibrate_n=INT8_CALIB_N, batch_size=INT8_GATE_BATCH, front_end="planar")
        gate_out["frontend_planar"]["s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        f32 = gates.float32_twin(model)
        bank_imgs = torch.from_numpy(gates.synthetic_images(512, cfg.image_resolution, seed=2)).to(dev)
        from clip_mixer_tpu_torch.models.clip import l2_normalize
        from clip_mixer_tpu_torch.ops.preprocess import normalize_images

        with torch.inference_mode():
            bank = l2_normalize(f32.encode_image(normalize_images(bank_imgs, dtype=torch.float32))).cpu().numpy()
        del f32, bank_imgs
        captions = tokenize(gate_captions()[:INT8_GATE_N], cfg.context_length, truncate=True)
        require(len(captions) == INT8_GATE_N, f"{len(captions)} gate captions")
        gate_out["text"] = gates.text_noise_floor_gate(model, captions, bank.T, calibrate_n=INT8_CALIB_N,
                                                       batch_size=512)
        gate_out["text"]["s"] = time.perf_counter() - t0
        for k, g in gate_out.items():
            log(f"gate {k}: flips bf16 {g['flips_bf16']} int8 {g['flips_int8']} of {g['n']}, ratio "
                f"{g['flip_ratio']:.3f} (CI {g['flip_ratio_ci_low']:.3f}..{g['flip_ratio_ci_high']:.3f}), "
                f"passed {g['passed']}")
        out["gates"] = gate_out
        del imgs, src
        # A tower is served int8 only if its gate passed (the JAX package's release refuses
        # int8 on a failed gate). The int8 image path through the planar front end is this
        # phase's main path: its two gates must pass. The text gate's verdict decides how
        # text is served; the JAX package's own text gate fails at this width on the same
        # weights (scripts/torch_int8_text_gate_witness.py, PERF.md section 6).
        for k in ("image", "frontend_planar"):
            require(gate_out[k]["passed"], f"the {k} noise-floor gate failed: {gate_out[k]}")
        int8_text = gate_out["text"]["passed"]
        out["served_int8"] = {"image": True, "text": int8_text}
        if not int8_text:
            log("the text gate failed: the serving engine keeps the text tower in bf16 (PERF.md, PR 9)")

        # the serving surface of an int8 engine on 256x256 sources (planar front end)
        c = InferenceEngine(model, input_hw=(256, 256))
        c.enable_int8(gates.synthetic_images(INT8_CALIB_N, 256, seed=0), CAPTIONS if int8_text else None)
        c.load_classifier(GATE_CLASSES, GATE_TEMPLATES)
        c.warmup()
        http_imgs = gates.synthetic_images(12, 256, seed=8)
        health, metrics = int8_http(c, http_imgs, TEXTS[:6], {"image": "int8", "text": "int8" if int8_text else "float"})
        out["http"] = {"healthz": health, "metrics": metrics}
        out["bank"] = int8_device_bank(c, dev)
        launches = counters.read()
        log(f"int8 path launches: {launches}")
        require(launches == {"ln_mlp": 0, "preprocess": 0, "fused_mixer_block": 0},
                f"the int8 path launched a kernel: {launches}")
        out["launches"] = launches

        # timing: the towers, _int_mm alone, the front end
        qvis_c = c._image_path[1]
        out["towers_ms"] = time_int8_towers(model, qvis, qtext, dev)
        out["int_mm"] = time_int_mm(dev)
        out["front_end_b128"] = time_int8_front_end(model, qvis_c, dev)
        del a, c, f, model, qvis, qtext, qvis_c
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---- phase 7: the transformer towers (ViT-B/32 and ViT-L/14) ---------------------

VIT_PRESET = "vit-b32"  # served in bf16 and int8 and trained
VIT_L_PRESET = "vit-l14"  # served in bf16
VIT_BUCKETS = (8, 128)
VIT_F32_N = {VIT_PRESET: 4, VIT_L_PRESET: 2}  # rows held in f32, card against CPU
VIT_F32_COSINE = 0.99999  # per row, f32 on the card (TF32 off) against f32 on the CPU
# per row, ViT-L/14 bf16 against f32 on the card; set from the first reading
# on an H100 80GB HBM3 (CHANGES.md), never below 0.99
VIT_L_BF16_COSINE = 0.9995  # read 0.99992 (image) and 0.99992 (text) at B = 2
VIT_TEXT_TAIL = 7  # a token id written after the EOT: the text features must not move
VIT_REMAT_NORM_TOL = 1e-4  # one step under remat: |d grad_norm| / grad_norm against no remat
# At TrainConfig's defaults (lr 5e-4, 2 warmup steps) ViT-B/32 on one fixed
# batch of 256 falls to the plateau of uniform logits, ln 256 = 5.545, and
# stays there (8th loss 0.998 of the first, in f32 as in bf16: the model's
# dynamics, not the port's rounding; H100 runs, PERF.md section 6).
# Those 8 steps are run and reported, in both; the fall TRAIN_LOSS_FALL is required
# at VIT_TRAIN_LR (read 0.859), near the reference's 5e-4 scaled from its
# 32,768 batch to 256 with its 2,000-step warmup.
VIT_TRAIN_LR = 5e-5


def vit_flops(cfg) -> float:
    """The analytic forward FLOPs of one sample through both transformer
    towers: per block 24 T W^2 (QKV 6, out 2, MLP 16) + 4 T^2 W (scores and
    their product with v), the patch embed, both projections."""
    def tower(t, w, layers):
        return layers * (24 * t * w * w + 4 * t * t * w)

    g, p, w = cfg.grid_size, cfg.vision_patch_size, cfg.vision_width
    vision = 2 * (g * g) * (p * p * 3) * w + tower(cfg.vision_tokens, w, cfg.vision_layers) + 2 * w * cfg.embed_dim
    text = tower(cfg.context_length, cfg.text_width, cfg.text_layers) + 2 * cfg.text_width * cfg.embed_dim
    return float(vision + text)


def in_turns(ways, iters=10):
    """Each of ``ways`` timed with CUDA events, in turns A B .. B A, each the
    mean of ``iters`` back-to-back calls: the mean of the two runs and each
    run."""
    times = {k: [] for k in ways}
    with torch.inference_mode():
        for k in [*ways, *reversed(ways)]:
            times[k].append(cuda_ms(ways[k], iters=iters))
    row = {k: sum(v) / len(v) for k, v in times.items()}
    row["each_run_ms"] = times
    return row


def tower_inputs(cfg, B, dev, seed):
    """Random bf16 inputs of both towers at batch ``B``."""
    g = torch.Generator().manual_seed(seed)
    xv = torch.randn(B, cfg.vision_tokens, cfg.vision_width, generator=g).to(device=dev, dtype=torch.bfloat16)
    xt = torch.randn(B, cfg.context_length, cfg.text_width, generator=g).to(device=dev, dtype=torch.bfloat16)
    return xv, xt


def time_vit_towers(model, dev):
    """Both bf16 towers at each of VIT_BUCKETS, in turns."""
    rows = {}
    for B in VIT_BUCKETS:
        xv, xt = tower_inputs(model.cfg, B, dev, seed=12)
        rows[f"b{B}"] = in_turns({"vision_ms": lambda: model.visual.transformer(xv),
                                  "text_ms": lambda: model.transformer(xt)})
        log(f"{model.cfg.vision_width}-wide ViT towers at bucket {B}: {rows[f'b{B}']}")
    return rows


def vit_cosines(model, n):
    """Per-row cosines on ``n`` images and captions of the same weights: f32
    on the card against f32 on the CPU, and ``model`` (bf16 on the card)
    against f32 on the card."""
    from clip_mixer_tpu_torch import CLIP
    from clip_mixer_tpu_torch.evals.quant_gate import float32_twin, synthetic_images
    from clip_mixer_tpu_torch.ops.preprocess import normalize_images
    from clip_mixer_tpu_torch.text.tokenize import tokenize

    cfg = model.cfg
    images = normalize_images(torch.from_numpy(synthetic_images(n, cfg.image_resolution, seed=13)))
    text = torch.from_numpy(tokenize(TEXTS[:n], cfg.context_length, truncate=True))
    cpu = CLIP(cfg.replace(compute_dtype="float32"), device="cpu")
    cpu.load_state_dict(model.state_dict())
    card = float32_twin(model)
    dev = model.device
    out = {}
    with torch.inference_mode():
        for what, fn in (("image", lambda m, d: m.encode_image(images.to(d))),
                         ("text", lambda m, d: m.encode_text(text.to(d)))):
            want, got = fn(cpu.eval(), "cpu"), fn(card, dev).float()
            bf16 = fn(model, dev).float()
            out[f"{what}_f32_card_vs_cpu"] = float(torch.nn.functional.cosine_similarity(got.cpu(), want, dim=-1).min())
            out[f"{what}_bf16_vs_f32_card"] = float(torch.nn.functional.cosine_similarity(bf16, got, dim=-1).min())
    del cpu, card
    return out


def vit_serving(dev, counters):
    """7a: full-width ViT-B/32 (bf16, seed 0) behind an InferenceEngine on
    256x256 sources, and the bench front end through the preprocess kernel."""
    from clip_mixer_tpu_torch import CLIP, PRESETS
    from clip_mixer_tpu_torch.ops.preprocess import make_batch_preprocess
    from clip_mixer_tpu_torch.serving import InferenceEngine

    cfg = PRESETS[VIT_PRESET]
    require(cfg.use_transformer and cfg.compute_dtype == "bfloat16", f"{VIT_PRESET}: {cfg}")
    images = np.random.default_rng(0).integers(0, 256, (128, 256, 256, 3), dtype=np.uint8)
    model = CLIP(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    out = {"preset": VIT_PRESET, "params": sum(p.numel() for p in model.parameters())}
    engine = InferenceEngine(model, input_hw=(256, 256))
    counters.reset()
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    out["warmup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    txt = engine.encode_text(TEXTS[:5])
    out["encode_text_5_ms"] = (time.perf_counter() - t0) * 1e3
    check_features(txt, 5, cfg.embed_dim, "ViT encode_text(5)")
    t0 = time.perf_counter()
    img = engine.encode_image_arrays(images[:7])
    out["encode_image_7_ms"] = (time.perf_counter() - t0) * 1e3
    check_features(img, 7, cfg.embed_dim, "ViT encode_image_arrays(7)")
    sims = engine.similarity(images[:3], TEXTS[:4])
    require(sims.shape == (3, 4) and np.isfinite(sims).all(), sims)
    np.testing.assert_allclose(sims, 100.0 * img[:3] @ txt[:4].T, atol=1e-3)

    # the bench front end: the preprocess kernel -> encode_image at batch 128,
    # against the "torch" front end with the same towers
    pre_kernel = make_batch_preprocess((256, 256), cfg.image_resolution, dtype=torch.bfloat16, backend="kernel")
    pre_torch = make_batch_preprocess((256, 256), cfg.image_resolution, dtype=torch.bfloat16, backend="torch")
    x = torch.from_numpy(images).to(dev)
    with torch.inference_mode():
        front = model.encode_image(pre_kernel(x)).float()
    torch.cuda.synchronize()
    launches = counters.read()
    log(f"ViT-B/32 serving launches: {launches}")
    require(launches["preprocess"] == 1 and launches["ln_mlp"] == 0 and launches["fused_mixer_block"] == 0,
            f"ViT-B/32 serving launched {launches}: expected preprocess once, no mixer kernel")
    with torch.inference_mode():
        front_ref = model.encode_image(pre_torch(x)).float()
    cos = float(torch.nn.functional.cosine_similarity(front, front_ref, dim=-1).min())
    require(cos >= COSINE_MIN, f"ViT-B/32 front end: kernel vs torch preprocess cosine {cos} < {COSINE_MIN}")
    out["front_end128_min_cosine_vs_torch"] = cos
    out["launches"] = launches
    out["front_end128_ms"] = in_turns({"kernel_ms": lambda: model.encode_image(pre_kernel(x)),
                                       "torch_ms": lambda: model.encode_image(pre_torch(x))})
    out["towers_ms"] = time_vit_towers(model, dev)
    out["cosines"] = vit_cosines(model, VIT_F32_N[VIT_PRESET])
    log(f"ViT-B/32 cosines: {out['cosines']}")
    for what in ("image", "text"):
        got = out["cosines"][f"{what}_f32_card_vs_cpu"]
        require(got >= VIT_F32_COSINE, f"ViT-B/32 {what}: f32 card vs CPU cosine {got} < {VIT_F32_COSINE}")
    del engine
    return out, model


def vit_large(dev, counters):
    """7b: full-width ViT-L/14 (bf16, seed 0): the towers at each bucket, the
    front end + encode_image at B = 128, and the card against the CPU."""
    from clip_mixer_tpu_torch import CLIP, PRESETS
    from clip_mixer_tpu_torch.ops.preprocess import make_batch_preprocess

    cfg = PRESETS[VIT_L_PRESET]
    free_card()
    t0 = time.perf_counter()
    model = CLIP(cfg, device=dev, generator=torch.Generator().manual_seed(0))
    out = {"preset": VIT_L_PRESET, "params": sum(p.numel() for p in model.parameters()),
           "build_s": time.perf_counter() - t0}
    x = torch.from_numpy(np.random.default_rng(14).integers(0, 256, (128, 256, 256, 3), dtype=np.uint8)).to(dev)
    pre_kernel = make_batch_preprocess((256, 256), cfg.image_resolution, dtype=torch.bfloat16, backend="kernel")
    pre_torch = make_batch_preprocess((256, 256), cfg.image_resolution, dtype=torch.bfloat16, backend="torch")
    counters.reset()
    with torch.inference_mode():
        front = model.encode_image(pre_kernel(x)).float()
        front_ref = model.encode_image(pre_torch(x)).float()
    launches = counters.read()
    require(launches["preprocess"] == 1 and launches["ln_mlp"] == 0 and launches["fused_mixer_block"] == 0,
            f"ViT-L/14 launched {launches}")
    cos = float(torch.nn.functional.cosine_similarity(front, front_ref, dim=-1).min())
    require(cos >= COSINE_MIN, f"ViT-L/14 front end: kernel vs torch preprocess cosine {cos} < {COSINE_MIN}")
    out.update(launches=launches, front_end128_min_cosine_vs_torch=cos)
    out["front_end128_ms"] = in_turns({"kernel_ms": lambda: model.encode_image(pre_kernel(x)),
                                       "torch_ms": lambda: model.encode_image(pre_torch(x))})
    out["towers_ms"] = time_vit_towers(model, dev)
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del x, front, front_ref
    out["cosines"] = vit_cosines(model, VIT_F32_N[VIT_L_PRESET])
    out["tol"] = (f"f32 card vs CPU >= {VIT_F32_COSINE}, bf16 vs f32 on the card >= {VIT_L_BF16_COSINE} "
                  "(per row, both towers)")
    log(f"ViT-L/14: {out}")
    for what in ("image", "text"):
        got = out["cosines"][f"{what}_f32_card_vs_cpu"]
        require(got >= VIT_F32_COSINE, f"ViT-L/14 {what}: f32 card vs CPU cosine {got} < {VIT_F32_COSINE}")
        got = out["cosines"][f"{what}_bf16_vs_f32_card"]
        require(got >= VIT_L_BF16_COSINE, f"ViT-L/14 {what}: bf16 vs f32 cosine {got} < {VIT_L_BF16_COSINE}")
    del model
    free_card()
    return out


def vit_int8(dev, counters, model):
    """7c: ViT-B/32 int8: calibrate on 128 images and 128 captions, the
    artifact served bit for bit by a second engine, the image and text
    gates at INT8_GATE_N (a tower is served int8 only if its gate passed),
    the int8 text tower's causality on the card, and the int8 towers timed
    beside the bf16 ones."""
    import os
    import shutil
    import tempfile

    from clip_mixer_tpu_torch.evals import quant_gate as gates
    from clip_mixer_tpu_torch.models.clip import l2_normalize
    from clip_mixer_tpu_torch.ops.preprocess import normalize_images
    from clip_mixer_tpu_torch.ops.quant import encode_text_q
    from clip_mixer_tpu_torch.serving import InferenceEngine
    from clip_mixer_tpu_torch.text.tokenize import tokenize

    cfg = model.cfg
    out = {"calibration_images": INT8_CALIB_N, "calibration_captions": len(CAPTIONS), "gate_n": INT8_GATE_N}
    root = tempfile.mkdtemp(prefix="chip_smoke_vit_int8_")
    try:
        counters.reset()
        calib = gates.synthetic_images(INT8_CALIB_N, cfg.image_resolution, seed=0)
        artifact = os.path.join(root, "scales.npz")
        a = InferenceEngine(model)
        a.enable_int8(calib, CAPTIONS, save_calibration=artifact)
        require(a.path_kinds == {"image": "int8", "text": "int8"}, a.path_kinds)
        qvis, qtext = a._image_path[1], a._text_path[1]
        b = InferenceEngine(model)
        b.enable_int8(calibration=artifact)
        probe = gates.synthetic_images(32, cfg.image_resolution, seed=5)
        img_a, txt_a = a.encode_image_arrays(probe), a.encode_text(TEXTS)
        check_features(img_a, 32, cfg.embed_dim, "ViT int8 encode_image_arrays(32)")
        check_features(txt_a, len(TEXTS), cfg.embed_dim, "ViT int8 encode_text(40)")
        require(np.array_equal(b.encode_image_arrays(probe), img_a), "ViT int8 artifact: image features differ")
        require(np.array_equal(b.encode_text(TEXTS), txt_a), "ViT int8 artifact: text features differ")
        del b
        f = InferenceEngine(model)
        cos_img, cos_txt = (img_a * f.encode_image_arrays(probe)).sum(-1), (txt_a * f.encode_text(TEXTS)).sum(-1)
        out["cosine_int8_vs_bf16"] = {"image_min": float(cos_img.min()), "image_mean": float(cos_img.mean()),
                                      "text_min": float(cos_txt.min()), "text_mean": float(cos_txt.mean())}

        # the int8 text tower ignores the tokens after the EOT, bit for bit
        tokens = torch.from_numpy(tokenize(TEXTS, cfg.context_length, truncate=True)).to(dev)
        after = torch.arange(cfg.context_length, device=dev)[None, :] > tokens.argmax(-1, keepdim=True)
        with torch.inference_mode():
            same = torch.equal(encode_text_q(qtext, tokens),
                               encode_text_q(qtext, torch.where(after, VIT_TEXT_TAIL, tokens)))
        require(same, "the ViT int8 text features moved with tokens after the EOT")
        out["text_int8_ignores_tokens_after_eot"] = same

        # the gates, at the JAX package's n
        classifier = gates.build_float_classifier(model, GATE_CLASSES, GATE_TEMPLATES, batch_size=INT8_GATE_BATCH)
        gate_out = {}
        t0 = time.perf_counter()
        imgs = gates.synthetic_images(INT8_GATE_N, cfg.image_resolution, seed=3)
        gate_out["image"] = gates.noise_floor_gate(model, imgs, classifier, calibrate_n=INT8_CALIB_N,
                                                   batch_size=INT8_GATE_BATCH)
        gate_out["image"]["s"] = time.perf_counter() - t0
        del imgs
        t0 = time.perf_counter()
        f32 = gates.float32_twin(model)
        bank_imgs = torch.from_numpy(gates.synthetic_images(512, cfg.image_resolution, seed=2)).to(dev)
        with torch.inference_mode():
            bank = l2_normalize(f32.encode_image(normalize_images(bank_imgs, dtype=torch.float32))).cpu().numpy()
        del f32, bank_imgs
        captions = tokenize(gate_captions()[:INT8_GATE_N], cfg.context_length, truncate=True)
        gate_out["text"] = gates.text_noise_floor_gate(model, captions, bank.T, calibrate_n=INT8_CALIB_N,
                                                       batch_size=512)
        gate_out["text"]["s"] = time.perf_counter() - t0
        for k, g in gate_out.items():
            log(f"ViT gate {k}: flips bf16 {g['flips_bf16']} int8 {g['flips_int8']} of {g['n']}, ratio "
                f"{g['flip_ratio']:.3f} (CI {g['flip_ratio_ci_low']:.3f}..{g['flip_ratio_ci_high']:.3f}), "
                f"passed {g['passed']}")
        out["gates"] = gate_out

        # a tower is served int8 only if its gate passed
        served = {k: bool(gate_out[k]["passed"]) for k in ("image", "text")}
        out["served_int8"] = served
        c = InferenceEngine(model, input_hw=(256, 256))
        if any(served.values()):
            c.enable_int8(gates.synthetic_images(INT8_CALIB_N, 256, seed=0) if served["image"] else None,
                          CAPTIONS if served["text"] else None)
        kinds = {k: "int8" if v else "float" for k, v in served.items()}
        require(c.path_kinds == kinds, f"ViT serving engine: {c.path_kinds}, gates say {kinds}")
        u8 = np.random.default_rng(15).integers(0, 256, (7, 256, 256, 3), dtype=np.uint8)
        check_features(c.encode_image_arrays(u8), 7, cfg.embed_dim, "ViT gated engine: encode_image_arrays(7)")
        check_features(c.encode_text(TEXTS[:5]), 5, cfg.embed_dim, "ViT gated engine: encode_text(5)")
        out["path_kinds"] = c.path_kinds
        launches = counters.read()
        require(launches == {"ln_mlp": 0, "preprocess": 0, "fused_mixer_block": 0},
                f"the ViT int8 path launched a kernel: {launches}")
        out["launches"] = launches

        # the int8 towers beside the bf16 ones
        rows = {}
        for B in VIT_BUCKETS:
            xv, xt = tower_inputs(cfg, B, dev, seed=16)
            for name, q, tower, x in (("vision", qvis, model.visual.transformer, xv),
                                      ("text", qtext, model.transformer, xt)):
                rows[f"{name}_b{B}"] = in_turns({"int8_ms": lambda: q.run_blocks(x), "bf16_ms": lambda: tower(x)})
                log(f"ViT int8 tower {name} at bucket {B}: {rows[f'{name}_b{B}']}")
        out["towers_ms"] = rows
        del a, c, f, qvis, qtext
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def vit_train_steps(dev, counters, cfg, batch, tcfg):
    """TRAIN_STEPS steps from seed 0 at ``tcfg``, steps after TRAIN_WARMUP
    timed with CUDA events: the readings and the launches."""
    state, step = train_setup(cfg, dev, tcfg=tcfg)
    free_card()
    counters.reset()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    metrics = []
    for i in range(TRAIN_STEPS):
        if i == TRAIN_WARMUP:
            start.record()
        state, m = step(state, batch)
        metrics.append(m)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (TRAIN_STEPS - TRAIN_WARMUP)
    flops = 3.0 * vit_flops(cfg)
    B = batch["images"].shape[0]
    peak = PEAK_OPS_PER_S[torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32]
    out = {"B": B, "steps": TRAIN_STEPS, "compute_dtype": cfg.compute_dtype, "learning_rate": tcfg.learning_rate,
           "warmup_steps": tcfg.warmup_steps, "step_ms": ms, "images_per_s": B / ms * 1e3,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "train_flops_per_sample": flops,
           "train_mfu": B * flops / (ms * 1e-3) / peak,
           "losses": [float(m["loss"]) for m in metrics], "grad_norms": [float(m["grad_norm"]) for m in metrics],
           "launches": counters.read()}
    del state, step, metrics
    free_card()
    log(f"ViT-B/32 train B={B} {cfg.compute_dtype} lr {tcfg.learning_rate}: {ms:.2f} ms/step, {out['images_per_s']:.0f} img/s, peak "
        f"{out['peak_mem_gb']:.2f} GB, train_mfu {out['train_mfu']:.3f}, losses {out['losses']}")
    require(all(np.isfinite(out["losses"])) and all(np.isfinite(out["grad_norms"])), f"ViT train: {out}")
    require(sum(out["launches"].values()) == 0, f"ViT train launched {out['launches']}")
    return out


def vit_train(dev, counters):
    """7d: full-width ViT-B/32 (bf16 compute, f32 masters, seed 0) takes
    TRAIN_STEPS steps at TRAIN_B on one fixed batch at TrainConfig's
    defaults (reported; also in f32 compute) and at VIT_TRAIN_LR (the 8th
    loss must be <= TRAIN_LOSS_FALL x the first); then one step under each
    remat policy against the latter's first step."""
    from clip_mixer_tpu_torch import PRESETS
    from clip_mixer_tpu_torch.config import TrainConfig

    cfg = PRESETS[VIT_PRESET]
    batch = on_device(train_batch(cfg, TRAIN_B, seed=0), dev)
    # the defaults, in bf16 and in f32 (whether the plateau is the model's or the rounding's)
    out = {"defaults": vit_train_steps(dev, counters, cfg, batch, TrainConfig()),
           "defaults_f32": vit_train_steps(dev, counters, cfg.replace(compute_dtype="float32"), batch, TrainConfig())}
    tcfg = TrainConfig(learning_rate=VIT_TRAIN_LR)
    out["lr"] = r = vit_train_steps(dev, counters, cfg, batch, tcfg)
    losses = r["losses"]
    require(losses[-1] <= TRAIN_LOSS_FALL * losses[0], f"ViT train at lr {VIT_TRAIN_LR}: loss {losses[0]} -> "
            f"{losses[-1]}")
    out["launches"] = {k: sum(out[run]["launches"][k] for run in ("defaults", "defaults_f32", "lr"))
                       for k in r["launches"]}
    loss1, norm1 = losses[0], r["grad_norms"][0]
    for policy in REMAT_POLICIES:
        state, step = train_setup(cfg.replace(remat=True, remat_policy=policy), dev, tcfg=tcfg)
        free_card()
        counters.reset()
        state, m = step(state, batch)
        one = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counters.read()}
        del state, step, m
        free_card()
        out[f"remat_{policy}"] = one
        log(f"ViT-B/32 train remat {policy}: {one}")
        require(one["loss"] == loss1, f"ViT remat {policy}: step-1 loss {one['loss']}, {loss1} without remat")
        require(abs(one["grad_norm"] - norm1) <= VIT_REMAT_NORM_TOL * norm1,
                f"ViT remat {policy}: step-1 gradient norm {one['grad_norm']}, {norm1} without remat")
        require(sum(one["launches"].values()) == 0, f"ViT remat {policy} launched {one['launches']}")
    del batch
    free_card()
    return out


def vit_path(dev, counters):
    """Phase 7: the transformer towers, each part with the counters set to 0
    just before it and read just after."""
    t0 = time.perf_counter()
    out = {}
    out["vit_b32_serving"], model = vit_serving(dev, counters)
    out["vit_b32_int8"] = vit_int8(dev, counters, model)
    del model
    out["vit_l14"] = vit_large(dev, counters)
    out["vit_b32_train"] = vit_train(dev, counters)
    out["phase_s"] = time.perf_counter() - t0
    out["launches"] = {k: out[k]["launches"] for k in ("vit_b32_serving", "vit_b32_int8", "vit_l14", "vit_b32_train")}
    return out


# ---- phase 8: the ResNet vision tower (RN50) ------------------------------------

RN_PRESET = "rn50"
RN_BUCKETS = (8, 128)
RN_F32_N = 2  # rows held in f32, card against CPU
RN_F32_COSINE = 0.99999  # per row, f32 on the card (TF32 off) against f32 on the CPU
# per row, RN50 bf16 against f32 on the card; set from the first reading on
# an H100 80GB HBM3 (0.9999927 at B = 2; CHANGES.md)
RN_BF16_COSINE = 0.9999
RN_BN_SEED = 0  # the numpy seed every BN site of phase 8's RN50 is drawn from
RN_SUMS_B = 8  # the batch of the int32-sums check


def perturb_bn(visual, seed=RN_BN_SEED):
    """Every BN site of a ``ModifiedResNet`` drawn from a numpy seed, as the
    JAX suite's RN tests draw them (``tests/test_quant.py``): scale U(0.5,
    1.5), bias N(0, 0.1), running mean N(0, 0.2), var U(0.5, 2). The seed-0
    init has every ``bn3`` scale at 0, where each bottleneck's main branch
    would add nothing."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for bn in visual.bn_sites().values():
            c = bn.num_features
            for t, draw in ((bn.weight, rng.uniform(0.5, 1.5, c)), (bn.bias, rng.normal(0, 0.1, c)),
                            (bn.running_mean, rng.normal(0, 0.2, c)), (bn.running_var, rng.uniform(0.5, 2.0, c))):
                t.copy_(torch.from_numpy(draw.astype(np.float32)))
    return visual


def rn_model(dev, cfg=None):
    """Full-width RN50 from seed 0 with its BN sites drawn (``perturb_bn``)."""
    from clip_mixer_tpu_torch import CLIP, PRESETS

    model = CLIP(cfg or PRESETS[RN_PRESET], device=dev, generator=torch.Generator().manual_seed(0))
    perturb_bn(model.visual)
    return model


def rn_flops(cfg) -> float:
    """The analytic forward FLOPs of one sample through both towers: every
    convolution 2 H' W' Cin Cout k^2 at its output size (the ResNet tower),
    the attention pool (one query), and the transformer text tower as
    ``vit_flops`` counts it."""
    def conv(h, cin, cout, k):
        return 2 * h * h * cin * cout * k * k

    w, h = cfg.vision_width, cfg.image_resolution // 2
    f = conv(h, 3, w // 2, 3) + conv(h, w // 2, w // 2, 3) + conv(h, w // 2, w, 3)
    h //= 2
    inplanes = w
    for i, blocks in enumerate(cfg.vision_layers):
        planes = w * 2**i
        for b in range(blocks):
            stride = 2 if i > 0 and b == 0 else 1
            f += conv(h, inplanes, planes, 1) + conv(h, planes, planes, 3)
            h //= stride
            f += conv(h, planes, planes * 4, 1)
            if stride > 1 or inplanes != planes * 4:
                f += conv(h, inplanes, planes * 4, 1)
            inplanes = planes * 4
    c, t = w * 32, h * h + 1
    f += 2 * c * c + 2 * 2 * t * c * c + 2 * 2 * t * c + 2 * c * cfg.embed_dim
    text = cfg.text_layers * (24 * cfg.context_length * cfg.text_width**2 + 4 * cfg.context_length**2 * cfg.text_width)
    return float(f + text + 2 * cfg.text_width * cfg.embed_dim)


def rn_tower_inputs(cfg, B, dev, seed):
    """Random bf16 inputs of both towers at batch ``B``: normalised-range
    images [B, R, R, 3] and text-tower activations [B, 77, W]."""
    g = torch.Generator().manual_seed(seed)
    r = cfg.image_resolution
    xv = torch.randn(B, r, r, 3, generator=g).to(device=dev, dtype=torch.bfloat16)
    xt = torch.randn(B, cfg.context_length, cfg.text_width, generator=g).to(device=dev, dtype=torch.bfloat16)
    return xv, xt


def rn_serving(dev, counters):
    """8a: RN50 (bf16) behind an InferenceEngine on 256x256 sources, HTTP,
    the bench front end through the preprocess kernel, the towers timed."""
    from clip_mixer_tpu_torch.ops.preprocess import make_batch_preprocess
    from clip_mixer_tpu_torch.serving import InferenceEngine

    model = rn_model(dev)
    cfg = model.cfg
    require(cfg.is_resnet and cfg.compute_dtype == "bfloat16", f"{RN_PRESET}: {cfg}")
    images = np.random.default_rng(0).integers(0, 256, (128, 256, 256, 3), dtype=np.uint8)
    out = {"preset": RN_PRESET, "params": sum(p.numel() for p in model.parameters()),
           "bn_running_elements": sum(b.numel() for k, b in model.named_buffers() if k.endswith(("_mean", "_var")))}
    engine = InferenceEngine(model, input_hw=(256, 256))
    counters.reset()
    t0 = time.perf_counter()
    engine.warmup()
    torch.cuda.synchronize()
    out["warmup_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    txt = engine.encode_text(TEXTS[:5])
    out["encode_text_5_ms"] = (time.perf_counter() - t0) * 1e3
    check_features(txt, 5, cfg.embed_dim, "RN encode_text(5)")
    t0 = time.perf_counter()
    img = engine.encode_image_arrays(images[:7])
    out["encode_image_7_ms"] = (time.perf_counter() - t0) * 1e3
    check_features(img, 7, cfg.embed_dim, "RN encode_image_arrays(7)")
    sims = engine.similarity(images[:3], TEXTS[:4])
    require(sims.shape == (3, 4) and np.isfinite(sims).all(), sims)
    np.testing.assert_allclose(sims, 100.0 * img[:3] @ txt[:4].T, atol=1e-3)
    health, http_feats = http_requests(engine, TEXTS[:2])
    np.testing.assert_allclose(http_feats, txt[:2], atol=1e-6)
    out["healthz"] = health

    # the bench front end: the preprocess kernel -> encode_image at batch 128,
    # against the "torch" front end with the same tower
    pre_kernel = make_batch_preprocess((256, 256), cfg.image_resolution, dtype=torch.bfloat16, backend="kernel")
    pre_torch = make_batch_preprocess((256, 256), cfg.image_resolution, dtype=torch.bfloat16, backend="torch")
    x = torch.from_numpy(images).to(dev)
    with torch.inference_mode():
        front = model.encode_image(pre_kernel(x)).float()
    torch.cuda.synchronize()
    launches = counters.read()
    log(f"RN50 serving launches: {launches}")
    require(launches["preprocess"] == 1 and launches["ln_mlp"] == 0 and launches["fused_mixer_block"] == 0,
            f"RN50 serving launched {launches}: expected preprocess once, no mixer kernel")
    with torch.inference_mode():
        front_ref = model.encode_image(pre_torch(x)).float()
    cos = float(torch.nn.functional.cosine_similarity(front, front_ref, dim=-1).min())
    require(cos >= COSINE_MIN, f"RN50 front end: kernel vs torch preprocess cosine {cos} < {COSINE_MIN}")
    out["front_end128_min_cosine_vs_torch"] = cos
    out["launches"] = launches
    out["front_end128_ms"] = in_turns({"kernel_ms": lambda: model.encode_image(pre_kernel(x)),
                                       "torch_ms": lambda: model.encode_image(pre_torch(x))})
    rows = {}
    for B in RN_BUCKETS:
        xv, xt = rn_tower_inputs(cfg, B, dev, seed=17)
        rows[f"b{B}"] = in_turns({"vision_ms": lambda: model.visual(xv), "text_ms": lambda: model.transformer(xt)})
        log(f"RN50 towers at bucket {B}: {rows[f'b{B}']}")
    out["towers_ms"] = rows
    out["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del engine, x, front, front_ref
    return out, model


def rn_cosines(model, n):
    """8b: per-row image cosines on ``n`` images of the same weights: f32 on
    the card against f32 on the CPU, bf16 against f32 on the card, and the
    planted fault (one block's bn3 skipped) in f32 on the card against the
    CPU, which must fail the first bound."""
    from clip_mixer_tpu_torch import CLIP
    from clip_mixer_tpu_torch.evals.quant_gate import float32_twin, synthetic_images
    from clip_mixer_tpu_torch.ops.preprocess import normalize_images

    cfg = model.cfg
    images = normalize_images(torch.from_numpy(synthetic_images(n, cfg.image_resolution, seed=13)))
    cpu = CLIP(cfg.replace(compute_dtype="float32"), device="cpu")
    cpu.load_state_dict(model.state_dict())
    card = float32_twin(model)
    dev = model.device

    def cos(a, b):
        return float(torch.nn.functional.cosine_similarity(a.float().cpu(), b.float().cpu(), dim=-1).min())

    with torch.inference_mode():
        want = cpu.eval().encode_image(images)
        got = card.encode_image(images.to(dev))
        out = {"image_f32_card_vs_cpu": cos(got, want),
               "image_bf16_vs_f32_card": cos(model.encode_image(images.to(dev)), got)}
        bn3 = card.visual.layer2[-1].bn3
        bn3.forward = lambda y: y  # the planted fault
        out["planted_skip_bn3"] = cos(card.encode_image(images.to(dev)), want)
        del bn3.forward
        out["after_undo"] = cos(card.encode_image(images.to(dev)), want)
    del cpu, card
    return out


def rn_int8(dev, counters, model):
    """8c: RN50 int8: one bottleneck's int32 conv sums on the card against
    the CPU's; calibration on 128 images and 128 captions, its artifact
    served bit for bit by a second engine; the gates at INT8_GATE_N; an
    engine on 256x256 sources serving int8 only the towers whose gate
    passed; the int8 towers timed beside the bf16 ones."""
    import os
    import shutil
    import tempfile

    from clip_mixer_tpu_torch.evals import quant_gate as gates
    from clip_mixer_tpu_torch.models.clip import l2_normalize
    from clip_mixer_tpu_torch.ops import quant as tq
    from clip_mixer_tpu_torch.ops.preprocess import normalize_images
    from clip_mixer_tpu_torch.serving import InferenceEngine
    from clip_mixer_tpu_torch.text.tokenize import tokenize

    cfg = model.cfg
    out = {"calibration_images": INT8_CALIB_N, "calibration_captions": len(CAPTIONS), "gate_n": INT8_GATE_N}
    root = tempfile.mkdtemp(prefix="chip_smoke_rn_int8_")
    try:
        counters.reset()
        calib = gates.synthetic_images(INT8_CALIB_N, cfg.image_resolution, seed=0)
        artifact = os.path.join(root, "scales.npz")
        a = InferenceEngine(model)
        t0 = time.perf_counter()
        a.enable_int8(calib, CAPTIONS, save_calibration=artifact)
        out["enable_int8_s"] = time.perf_counter() - t0
        require(a.path_kinds == {"image": "int8", "text": "int8"}, a.path_kinds)
        qvis, qtext = a._image_path[1], a._text_path[1]
        require(isinstance(qvis, tq.QuantResNet), f"RN int8 image tower: {type(qvis).__name__}")

        # one bottleneck's int32 sums (and the stem's, K = 27) on the card against the CPU
        rng = np.random.default_rng(18)
        sums = {}
        blk = qvis.layer2[0]
        r = cfg.image_resolution
        w = cfg.vision_width  # layer2's planes are 2w, its input 4w wide
        sites = {"stem.conv1": (qvis.conv1, r, 3, 2, 1), "layer2.0.conv1": (blk.conv1, r // 4, 4 * w, 1, 0),
                 "layer2.0.conv2": (blk.conv2, r // 4, 2 * w, 1, 1), "layer2.0.conv3": (blk.conv3, r // 8, 2 * w, 1, 0),
                 "layer2.0.downsample": (blk.downsample, r // 8, 4 * w, 1, 0)}
        for name, (qc, hw, cin, stride, padding) in sites.items():
            xq = torch.from_numpy(rng.integers(-127, 128, (RN_SUMS_B, hw, hw, cin)).astype(np.int8))
            got = tq.conv_sums(xq.to(dev), qc.q, qc.kernel_size, stride, padding).cpu()
            want = tq.conv_sums(xq, qc.q.cpu(), qc.kernel_size, stride, padding)
            sums[name] = {"shape": list(got.shape), "K": int(qc.q.shape[1]), "equal": bool(torch.equal(got, want))}
            require(sums[name]["equal"], f"RN int8 {name}: int32 sums on the card differ from the CPU's")
        out["int32_sums_card_vs_cpu"] = sums

        b = InferenceEngine(model)
        b.enable_int8(calibration=artifact)
        probe = gates.synthetic_images(32, cfg.image_resolution, seed=5)
        img_a, txt_a = a.encode_image_arrays(probe), a.encode_text(TEXTS)
        check_features(img_a, 32, cfg.embed_dim, "RN int8 encode_image_arrays(32)")
        check_features(txt_a, len(TEXTS), cfg.embed_dim, "RN int8 encode_text(40)")
        require(np.array_equal(b.encode_image_arrays(probe), img_a), "RN int8 artifact: image features differ")
        require(np.array_equal(b.encode_text(TEXTS), txt_a), "RN int8 artifact: text features differ")
        del b
        f = InferenceEngine(model)
        cos_img, cos_txt = (img_a * f.encode_image_arrays(probe)).sum(-1), (txt_a * f.encode_text(TEXTS)).sum(-1)
        out["cosine_int8_vs_bf16"] = {"image_min": float(cos_img.min()), "image_mean": float(cos_img.mean()),
                                      "text_min": float(cos_txt.min()), "text_mean": float(cos_txt.mean())}

        classifier = gates.build_float_classifier(model, GATE_CLASSES, GATE_TEMPLATES, batch_size=INT8_GATE_BATCH)
        gate_out = {}
        t0 = time.perf_counter()
        imgs = gates.synthetic_images(INT8_GATE_N, cfg.image_resolution, seed=3)
        gate_out["image"] = gates.noise_floor_gate(model, imgs, classifier, calibrate_n=INT8_CALIB_N,
                                                   batch_size=INT8_GATE_BATCH)
        gate_out["image"]["s"] = time.perf_counter() - t0
        del imgs
        t0 = time.perf_counter()
        f32 = gates.float32_twin(model)
        bank_imgs = torch.from_numpy(gates.synthetic_images(512, cfg.image_resolution, seed=2)).to(dev)
        with torch.inference_mode():
            bank = l2_normalize(f32.encode_image(normalize_images(bank_imgs, dtype=torch.float32))).cpu().numpy()
        del f32, bank_imgs
        captions = tokenize(gate_captions()[:INT8_GATE_N], cfg.context_length, truncate=True)
        gate_out["text"] = gates.text_noise_floor_gate(model, captions, bank.T, calibrate_n=INT8_CALIB_N,
                                                       batch_size=512)
        gate_out["text"]["s"] = time.perf_counter() - t0
        for k, g in gate_out.items():
            log(f"RN gate {k}: flips bf16 {g['flips_bf16']} int8 {g['flips_int8']} of {g['n']}, ratio "
                f"{g['flip_ratio']:.3f} (CI {g['flip_ratio_ci_low']:.3f}..{g['flip_ratio_ci_high']:.3f}), "
                f"passed {g['passed']}")
        out["gates"] = gate_out

        served = {k: bool(gate_out[k]["passed"]) for k in ("image", "text")}
        out["served_int8"] = served
        c = InferenceEngine(model, input_hw=(256, 256))
        if any(served.values()):
            c.enable_int8(gates.synthetic_images(INT8_CALIB_N, 256, seed=0) if served["image"] else None,
                          CAPTIONS if served["text"] else None)
        kinds = {k: "int8" if v else "float" for k, v in served.items()}
        require(c.path_kinds == kinds, f"RN serving engine: {c.path_kinds}, gates say {kinds}")
        u8 = np.random.default_rng(15).integers(0, 256, (7, 256, 256, 3), dtype=np.uint8)
        check_features(c.encode_image_arrays(u8), 7, cfg.embed_dim, "RN gated engine: encode_image_arrays(7)")
        check_features(c.encode_text(TEXTS[:5]), 5, cfg.embed_dim, "RN gated engine: encode_text(5)")
        out["path_kinds"] = c.path_kinds
        launches = counters.read()
        require(launches == {"ln_mlp": 0, "preprocess": 0, "fused_mixer_block": 0},
                f"the RN int8 path launched a kernel: {launches}")
        out["launches"] = launches

        rows = {}
        for B in RN_BUCKETS:
            xv, xt = rn_tower_inputs(cfg, B, dev, seed=16)
            rows[f"vision_b{B}"] = in_turns({"int8_ms": lambda: tq.encode_image_rn_q(qvis, xv),
                                             "bf16_ms": lambda: model.visual(xv)})
            rows[f"text_b{B}"] = in_turns({"int8_ms": lambda: qtext.run_blocks(xt),
                                           "bf16_ms": lambda: model.transformer(xt)})
            log(f"RN int8 towers at bucket {B}: {rows[f'vision_b{B}']} / {rows[f'text_b{B}']}")
        out["towers_ms"] = rows
        del a, c, f, qvis, qtext
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


def rn_running_stats(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()
            if k.endswith(("running_mean", "running_var", "num_batches_tracked"))}


def rn_train_steps(dev, counters, cfg, batch, tcfg, steps=TRAIN_STEPS):
    """``steps`` steps from seed 0 (BN drawn) at ``tcfg``, steps after
    TRAIN_WARMUP timed with CUDA events: the readings, the launches, the
    running statistics before and after step 1 and after the last."""
    from clip_mixer_tpu_torch.parallel.train_step import init_train_state, make_train_step
    from clip_mixer_tpu_torch.train.optimizer import make_optimizer

    model = rn_model(dev, cfg)
    opt = make_optimizer(tcfg, total_steps=steps)
    state, step = init_train_state(model, opt), make_train_step(cfg, tcfg, opt)
    free_card()
    counters.reset()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    stats = {"init": rn_running_stats(model)}
    metrics = []
    for i in range(steps):
        if i == TRAIN_WARMUP:
            start.record()
        state, m = step(state, batch)
        metrics.append(m)
        if i == 0:
            stats["step1"] = rn_running_stats(model)
    end.record()
    end.synchronize()
    stats["last"] = rn_running_stats(model)
    B = batch["images"].shape[0]
    out = {"B": B, "steps": steps, "compute_dtype": cfg.compute_dtype, "remat": cfg.remat,
           "learning_rate": tcfg.learning_rate, "warmup_steps": tcfg.warmup_steps, "freeze": tcfg.freeze,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "losses": [float(m["loss"]) for m in metrics], "grad_norms": [float(m["grad_norm"]) for m in metrics],
           "launches": counters.read()}
    if steps > TRAIN_WARMUP:
        ms = start.elapsed_time(end) / (steps - TRAIN_WARMUP)
        flops = 3.0 * rn_flops(cfg)
        out.update(step_ms=ms, images_per_s=B / ms * 1e3, train_flops_per_sample=flops,
                   train_mfu=B * flops / (ms * 1e-3) / PEAK_OPS_PER_S[torch.bfloat16])
    del state, step, metrics, model
    free_card()
    log(f"RN50 train B={B} lr {tcfg.learning_rate} remat {cfg.remat} freeze {tcfg.freeze}: "
        f"{ {k: out[k] for k in ('step_ms', 'images_per_s', 'peak_mem_gb', 'train_mfu') if k in out} }, "
        f"losses {out['losses']}")
    require(all(np.isfinite(out["losses"])) and all(np.isfinite(out["grad_norms"])), f"RN train: {out}")
    require(sum(out["launches"].values()) == 0, f"RN train launched {out['launches']}")
    return out, stats


def rn_train(dev, counters):
    """8d: RN50 (bf16 compute, f32 masters) takes TRAIN_STEPS steps at
    TRAIN_B on one fixed batch at TrainConfig's defaults (reported) and at
    VIT_TRAIN_LR (the 8th loss below the first, every BN site's running
    statistics moved); one step under freeze="visual" (every running
    statistic bit for bit) and one under per-bottleneck remat (step 1's
    loss and running statistics bit for bit those without remat)."""
    from clip_mixer_tpu_torch import PRESETS
    from clip_mixer_tpu_torch.config import TrainConfig

    cfg = PRESETS[RN_PRESET]
    batch = on_device(train_batch(cfg, TRAIN_B, seed=0), dev)
    out = {}
    out["defaults"], _ = rn_train_steps(dev, counters, cfg, batch, TrainConfig())
    tcfg = TrainConfig(learning_rate=VIT_TRAIN_LR)
    out["lr"], stats = rn_train_steps(dev, counters, cfg, batch, tcfg)
    losses = out["lr"]["losses"]
    require(losses[-1] < losses[0], f"RN train at lr {VIT_TRAIN_LR}: loss {losses[0]} -> {losses[-1]}")
    unmoved = [k for k in stats["init"] if not k.endswith("num_batches_tracked")
               and torch.equal(stats["init"][k], stats["last"][k])]
    require(not unmoved, f"RN train: running statistics that did not move: {unmoved[:5]}")
    out["running_stats_moved"] = sum(not k.endswith("num_batches_tracked") for k in stats["init"])
    frozen, fstats = rn_train_steps(dev, counters, cfg, batch, TrainConfig(learning_rate=VIT_TRAIN_LR,
                                                                            freeze="visual"), steps=1)
    changed = [k for k in fstats["init"] if not torch.equal(fstats["init"][k], fstats["last"][k])]
    require(not changed, f"RN freeze='visual' moved running statistics: {changed[:5]}")
    out["freeze_visual"] = dict(frozen, running_stats_bit_for_bit=True)
    remat, rstats = rn_train_steps(dev, counters, cfg.replace(remat=True), batch, tcfg, steps=1)
    require(remat["losses"][0] == losses[0], f"RN remat: step-1 loss {remat['losses'][0]}, {losses[0]} without")
    diff = [k for k in rstats["last"] if not torch.equal(rstats["last"][k], stats["step1"][k])]
    require(not diff, f"RN remat: step-1 running statistics differ from no remat: {diff[:5]}")
    out["remat"] = dict(remat, step1_loss_and_running_stats_bit_for_bit=True)
    out["launches"] = {k: sum(out[r]["launches"][k] for r in ("defaults", "lr", "freeze_visual", "remat"))
                       for k in out["lr"]["launches"]}
    del batch
    free_card()
    return out


def rn_path(dev, counters):
    """Phase 8: RN50, each part with the counters set to 0 just before it and
    read just after."""
    t0 = time.perf_counter()
    out = {}
    out["rn50_serving"], model = rn_serving(dev, counters)
    out["rn50_cosines"] = c = rn_cosines(model, RN_F32_N)
    log(f"RN50 cosines: {c}")
    require(c["image_f32_card_vs_cpu"] >= RN_F32_COSINE,
            f"RN50 f32 card vs CPU cosine {c['image_f32_card_vs_cpu']} < {RN_F32_COSINE}")
    require(c["image_bf16_vs_f32_card"] >= RN_BF16_COSINE,
            f"RN50 bf16 vs f32 cosine {c['image_bf16_vs_f32_card']} < {RN_BF16_COSINE}")
    require(c["planted_skip_bn3"] < RN_F32_COSINE, f"RN50: a skipped bn3 passes the f32 bound ({c})")
    require(c["after_undo"] >= RN_F32_COSINE, f"RN50: the planted fault was not undone ({c})")
    out["rn50_cosines"]["tol"] = (f"f32 card vs CPU >= {RN_F32_COSINE}; bf16 vs f32 on the card >= {RN_BF16_COSINE}; "
                                  "a skipped bn3 must fail the first")
    out["rn50_int8"] = rn_int8(dev, counters, model)
    del model
    free_card()
    out["rn50_train"] = rn_train(dev, counters)
    out["phase_s"] = time.perf_counter() - t0
    out["launches"] = {k: out[k]["launches"] for k in ("rn50_serving", "rn50_int8", "rn50_train")}
    return out



# ---- phase 9: model loading, compat, the tools and the serving CLI ----------------

LOAD_COSINE = 0.99999  # per row, f32: a loaded ViT-B/32 / RN50 on the card against its source model
COMPAT_COSINE = 0.999  # per row: compat's bf16 triple against the engine's features
CLI_COSINE = 0.99999  # per row: the CLI's answers against an in-process engine on the same export and artifact
LOAD_B = 2
CLI_IMAGES = 8
CLI_CLASSES = 16  # of GATE_CLASSES, each through PROMPT_TEMPLATES
CALIB_N = 512
EMBED_N = 1024  # .npy 256x256 images in the bank's tar
EMBED_BATCH = 256
SERVE_TIMEOUT_S = 300
SERVE_ARGS = []  # extra CLI flags for both servers (a CPU rehearsal passes --device cpu)


def ln_final_perturbed(model, seed=9):
    """``ln_final`` drawn from a numpy seed (the init's is 1 / 0, where a
    zeroed bias would be no fault)."""
    rng = np.random.default_rng(seed)
    w = model.cfg.text_width
    with torch.no_grad():
        model.ln_final.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, w).astype(np.float32)))
        model.ln_final.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, w).astype(np.float32)))
    return model


def timed_load(path, dev, **kw):
    """``api.load`` of ``path`` on ``dev``: (model, cfg, ms, peak GB)."""
    from clip_mixer_tpu_torch import api

    free_card()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, cfg, _ = api.load(path, device=dev, **kw)
    torch.cuda.synchronize()
    return model, cfg, (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated() / 1e9


def mixer_features(model, images, texts):
    """Unnormalised bf16 (image, text) features of a Mixer-B/32 model."""
    from clip_mixer_tpu_torch.ops.preprocess import normalize_images
    from clip_mixer_tpu_torch.text.tokenize import tokenize

    with torch.inference_mode():
        x = normalize_images(torch.from_numpy(images).to(model.device), dtype=torch.bfloat16)
        t = torch.from_numpy(tokenize(texts, model.cfg.context_length, truncate=True)).to(model.device)
        return model.encode_image(x).float().cpu(), model.encode_text(t).float().cpu()


def row_cosine(a, b) -> float:
    return float(torch.nn.functional.cosine_similarity(torch.as_tensor(a).double(), torch.as_tensor(b).double(),
                                                       dim=-1).min())


def load_tower_kinds(dev, root):
    """Reference-keyed f32 files of the port's seed ViT-B/32 and RN50 (the
    RN50's BN sites drawn, its ``num_batches_tracked`` left out): sniffed,
    loaded on the card, one f32 forward at B = 2 against the source model."""
    from clip_mixer_tpu_torch import CLIP, PRESETS

    out = {}
    for name in (VIT_PRESET, RN_PRESET):
        cfg = PRESETS[name].replace(compute_dtype="float32")
        if name == RN_PRESET:
            src = rn_model(dev, cfg)
        else:
            src = CLIP(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        sd = {k: v.detach().cpu() for k, v in src.state_dict().items() if not k.endswith("num_batches_tracked")}
        path = f"{root}/{name}.pt"
        torch.save(sd, path)
        model, got, ms, peak = timed_load(path, dev, compute_dtype="float32")
        arch = {f: getattr(got, f) for f in ("vision_layers", "vision_width", "vision_patch_size",
                                             "image_resolution", "embed_dim", "text_width", "text_layers", "tower")}
        require(got == cfg, f"{name}: sniffed {arch}, not the preset's architecture")
        rng = np.random.default_rng(3)
        R = cfg.image_resolution
        x = torch.from_numpy(rng.normal(0, 1, (LOAD_B, R, R, 3)).astype(np.float32)).to(dev)
        t = torch.from_numpy(tokenize_texts(TEXTS[:LOAD_B], cfg.context_length)).to(dev)
        with torch.inference_mode():
            cos = {"image": row_cosine(model.encode_image(x).cpu(), src.encode_image(x).cpu()),
                   "text": row_cosine(model.encode_text(t).cpu(), src.encode_text(t).cpu())}
        for k, v in cos.items():
            require(v >= LOAD_COSINE, f"{name} loaded {k} features against the source: cosine {v} < {LOAD_COSINE}")
        out[name] = {"load_ms": ms, "peak_gb": peak, "min_cosine_vs_source": cos, "file_mb": os.path.getsize(path) / 1e6}
        del src, model
        os.remove(path)
        free_card()
    return out


def tokenize_texts(texts, context_length):
    from clip_mixer_tpu_torch.text.tokenize import tokenize

    return tokenize(texts, context_length, truncate=True)


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cli_subprocess(export, dev, log_path):
    """``python -m clip_mixer_tpu_torch.serving`` on the card in a process of
    its own (its standard error to ``log_path``): ms to its first answered
    /healthz, and one /encode_text."""
    from clip_mixer_tpu_torch.client import ServingClient

    port = free_port()
    repo = os.path.dirname(os.path.abspath(__file__))
    with open(log_path, "w") as err:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "clip_mixer_tpu_torch.serving", "--model", export,
                                 "--port", str(port), *SERVE_ARGS], cwd=repo, stdout=subprocess.DEVNULL, stderr=err)
    try:
        client = ServingClient(f"http://127.0.0.1:{port}", timeout=60, retries=0)
        health = None
        while health is None:
            if proc.poll() is not None:
                with open(log_path) as f:
                    require(False, f"the serving CLI exited {proc.returncode}: {f.read()[-4000:]}")
            require(time.perf_counter() - t0 < SERVE_TIMEOUT_S, "the serving CLI never answered /healthz")
            try:
                health = client.healthz()
            except Exception:
                time.sleep(0.2)
        first_ms = (time.perf_counter() - t0) * 1e3
        require(health["status"] == "ok" and health["device"].split(":")[0] == dev.type, health)
        feats = client.encode_text(TEXTS[:2])
        check_features(feats, 2, health["embed_dim"], "CLI subprocess /encode_text")
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return {"first_healthz_ms": first_ms, "rc_after_terminate": proc.returncode}


def cli_requests(server, engine, ref, plain, images, counters):
    """Every endpoint through the port's client against the CLI's server,
    each answer held to ``ref`` (the same export and artifact) and the
    features also to ``plain`` (the same weights and artifact with the
    unfused channel mix, so ``ln_mlp`` at the shapes these requests send
    is held to the plain chain); returns (readings, launches over the
    requests, the expected launches)."""
    from clip_mixer_tpu_torch.client import ServingClient

    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    texts = TEXTS[:5]
    blobs = [base64.b64decode(b) for b in npy_b64(images)]
    ms, cos = {}, {}

    def call(name, fn):
        t0 = time.perf_counter()
        result = fn()
        ms[name] = (time.perf_counter() - t0) * 1e3
        return result

    try:
        c = ServingClient(f"http://127.0.0.1:{server.server_address[1]}", timeout=300)
        counters.reset()
        before = counters.read()
        health = call("healthz", c.healthz)
        require(health["paths"] == engine.path_kinds and health["input_hw"] == [256, 256], health)
        text = call("encode_text", lambda: c.encode_text(texts))
        image = call("encode_image", lambda: c.encode_image_files(blobs))
        sim = call("similarity", lambda: c.similarity(blobs[:3], texts[:4]))
        got_cls = call("classify", lambda: c.classify(blobs, top_k=5))
        got_ret = call("retrieve", lambda: c.retrieve(texts, top_k=5))
        n_index = call("index", lambda: c.index(blobs, [f"q{i}" for i in range(len(blobs))]))
        metrics = call("metrics", c.metrics)
        after = counters.read()
        index_size = c.healthz()["index_size"]
    finally:
        server.shutdown()
        server.server_close()
        thread.join()
    per_call = {k: 12 if v == "float" else 0 for k, v in engine.path_kinds.items()}
    want = per_call["text"] * 3 + per_call["image"] * 4  # text: encode_text, similarity, retrieve
    launches = {k: after[k] - before[k] for k in after}

    cos["encode_text"] = row_cosine(text, ref.encode_text(texts))
    ref_img = ref.encode_image_arrays(images)
    cos["encode_image"] = row_cosine(image, ref_img)
    ref_sim = 100.0 * ref_img[:3] @ ref.encode_text(texts[:4]).T
    cos["similarity"] = row_cosine(sim["logits_per_image"], ref_sim)
    for k, v in cos.items():
        require(v >= CLI_COSINE, f"CLI {k}: cosine {v} against the in-process engine < {CLI_COSINE}")
    b = counters.read()
    plain_img = plain.encode_image_arrays(images)
    cos_plain = {"encode_text": row_cosine(text, plain.encode_text(texts)),
                 "encode_image": row_cosine(image, plain_img),
                 "similarity": row_cosine(sim["logits_per_image"],
                                          100.0 * plain_img[:3] @ plain.encode_text(texts[:4]).T)}
    require(counters.read()["ln_mlp"] == b["ln_mlp"], "the unfused engine launched ln_mlp")
    for k, v in cos_plain.items():
        require(v >= COSINE_MIN, f"CLI {k}: cosine {v} against the unfused engine < {COSINE_MIN}")
    def labels(rows, key):
        return [[r[key] for r in row] for row in rows]

    require(labels(got_cls, "label") == labels(ref.classify(images, top_k=5), "label"),
            "CLI /classify labels differ from the in-process engine's")
    require(labels(got_ret, "id") == labels(ref.retrieve(texts, top_k=5), "id"),
            "CLI /retrieve ids differ from the in-process engine's")
    require(n_index == len(blobs) and index_size == len(blobs), f"/index {n_index}, index_size {index_size}")
    for ep in ("/encode_text", "/encode_image", "/similarity", "/classify", "/retrieve", "/index"):
        require(metrics[ep]["count"] == 1 and metrics[ep]["errors"] == 0, f"{ep}: {metrics.get(ep)}")
    require(launches["ln_mlp"] == want, f"CLI requests: ln_mlp launched {launches['ln_mlp']} times, expected {want} "
            f"(paths {engine.path_kinds})")
    require(launches["preprocess"] == 0 and launches["fused_mixer_block"] == 0, f"CLI requests: {launches}")
    return {"request_ms": ms, "min_cosine_vs_engine": cos, "min_cosine_vs_unfused": cos_plain,
            "paths": dict(engine.path_kinds),
            "server_p50_ms": {ep: m["p50_ms"] for ep, m in metrics.items()}}, launches, want


def load_cli_path(dev, counters, text_int8=False):
    """Phase 9: ``api.load`` of reference-keyed files, ``compat``, the
    calibration and bank tools, and the serving CLI, on full-width
    Mixer-B/32. ``text_int8``: phase 6's text gate passed, so the
    artifact covers the text tower too."""
    import importlib.util
    import shutil
    import tempfile

    from clip_mixer_tpu_torch import CLIP, PRESETS, compat
    from clip_mixer_tpu_torch.api import save_pretrained
    from clip_mixer_tpu_torch.evals.prompts import PROMPT_TEMPLATES
    from clip_mixer_tpu_torch.serving import InferenceEngine, build_server

    def script(name):
        spec = importlib.util.spec_from_file_location(name, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                                                         "scripts", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    t_phase = time.perf_counter()
    cfg = PRESETS["mixer-b32"]
    root = tempfile.mkdtemp(prefix="chip_smoke_load_")
    out = {}
    rng = np.random.default_rng(11)
    model_images = rng.integers(0, 256, (CLI_IMAGES, cfg.image_resolution, cfg.image_resolution, 3), dtype=np.uint8)
    try:
        # 9a: reference-keyed fp16 files in two wrappings
        src = ln_final_perturbed(CLIP(cfg, device=dev, generator=torch.Generator().manual_seed(0)))
        half = {k: v.detach().half().cpu() for k, v in src.state_dict().items()}
        del src
        pt, acc = f"{root}/mixer_b32_fp16.pt", f"{root}/accelerate"
        torch.save(half, pt)
        os.makedirs(acc)
        torch.save({"state_dict": {f"module.{k}": v for k, v in half.items()}}, f"{acc}/pytorch_model.bin")
        loads, feats = {}, {}
        for wrap, path in (("pt", pt), ("accelerate_dir", acc)):
            model, got, ms, peak = timed_load(path, dev)
            require(got == cfg, f"{wrap}: sniffed {got}, not mixer-b32's architecture")
            sd = model.state_dict()
            bad = [k for k, v in half.items() if not torch.equal(sd[k].cpu(), v.float())]
            require(not bad and sd.keys() == half.keys(), f"{wrap}: tensors not the fp16 file's in f32: {bad[:5]}")
            feats[wrap] = mixer_features(model, model_images, TEXTS[:5])
            loads[wrap] = {"load_ms": ms, "peak_gb": peak}
            if wrap == "pt":
                loaded = model
            del model
        for a, b in zip(feats["pt"], feats["accelerate_dir"]):
            require(torch.equal(a, b), "the two wrappings' features differ")
        bad_path = f"{root}/fault.pt"
        torch.save({**half, "ln_final.bias": torch.zeros_like(half["ln_final.bias"])}, bad_path)
        fault, _, _, _ = timed_load(bad_path, dev)
        fault_img, fault_txt = mixer_features(fault, model_images, TEXTS[:5])
        fault_equal = torch.equal(fault_txt, feats["pt"][1])
        require(not fault_equal, "planted fault: a file with ln_final.bias zeroed passed the feature check")
        loads["fault_text_min_cosine"] = row_cosine(fault_txt, feats["pt"][1])
        loads["fault_image_equal"] = bool(torch.equal(fault_img, feats["pt"][0]))
        del fault
        os.remove(bad_path)
        out["load"] = loads
        out["load_tower_kinds"] = load_tower_kinds(dev, root)
        log(f"phase 9a load: {out['load']} {out['load_tower_kinds']}")

        # 9b: compat on the card, against the engine on the loaded model
        cm, _ = compat.load(pt, device=str(dev))
        require(cm.dtype == torch.bfloat16 and cm.device.type == dev.type, f"compat: {cm.dtype} on {cm.device}")
        img_f, txt_f, scale = cm(torch.from_numpy(model_images), compat.tokenize(TEXTS[:5]))
        require(img_f.device.type == dev.type, "compat outputs left the card")
        engine = InferenceEngine(loaded)
        cos = {"image": row_cosine(img_f.cpu(), engine.encode_image_arrays(model_images)),
               "text": row_cosine(txt_f.cpu(), engine.encode_text(TEXTS[:5]))}
        for k, v in cos.items():
            require(v >= COMPAT_COSINE, f"compat {k}: cosine {v} against the engine < {COMPAT_COSINE}")
        out["compat"] = {"min_cosine_vs_engine": cos, "logit_scale": float(scale)}
        del cm, engine

        # 9c: the tools: the artifact (text only if its gate passed), then the bank
        export = f"{root}/export"
        save_pretrained(loaded, cfg.replace(fused_mlp=True), export)
        art = f"{root}/scales.npz"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        script("torch_calibrate_int8").run(loaded, cfg, art, n=CALIB_N, no_text=not text_int8)
        out["calibrate_ms"] = (time.perf_counter() - t0) * 1e3
        del loaded
        free_card()
        tar_path, bank = f"{root}/bank_shard.tar", f"{root}/bank.npz"
        write_npy_tar(tar_path, EMBED_N)
        emb = script("torch_embed_dataset")
        served, _, _ = timed_load(export, dev)[:3]
        embed_engine = InferenceEngine(served, batch_buckets=(EMBED_BATCH,), input_hw=(256, 256))
        embed_engine.enable_int8(calibration=art)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats_bank, ids, skipped, meta = emb.embed(embed_engine, [tar_path], batch=EMBED_BATCH, source=export)
        embed_s = time.perf_counter() - t0
        emb.write_bank(bank, feats_bank, ids, meta)
        require(len(ids) == EMBED_N and not skipped, f"bank: {len(ids)} ids, {len(skipped)} skipped")
        check_features(feats_bank, EMBED_N, cfg.embed_dim, "bank")
        out["embed"] = {"ms": embed_s * 1e3, "images_per_s": EMBED_N / embed_s, "path": meta["path"]}
        del embed_engine, served
        free_card()

        # 9d: the serving CLI in-process with every flag, the port's client against it
        names = f"{root}/classes.txt"
        with open(names, "w") as f:
            f.write("\n".join(GATE_CLASSES[:CLI_CLASSES]) + "\n")
        ref_model, _, _ = timed_load(export, dev)[:3]
        ref = InferenceEngine(ref_model, input_hw=(256, 256))
        ref.enable_int8(calibration=art)
        ref.load_index_file(bank)
        ref.load_classifier(GATE_CLASSES[:CLI_CLASSES], PROMPT_TEMPLATES)
        plain_model, _, _, _ = timed_load(export, dev)
        for m in plain_model.modules():
            if hasattr(m, "fused_mlp"):
                m.fused_mlp = False
        plain = InferenceEngine(plain_model, input_hw=(256, 256))
        plain.enable_int8(calibration=art)
        t0 = time.perf_counter()
        server, engine = build_server(["--model", export, "--port", "0", "--int8", art, "--index", bank, "--warmup",
                                       "--classifier", names, "--input-size", "256", *SERVE_ARGS])
        out["build_server_ms"] = (time.perf_counter() - t0) * 1e3
        require(engine.path_kinds == ref.path_kinds and engine.path_kinds["image"] == "int8", engine.path_kinds)
        images256 = np.random.default_rng(12).integers(0, 256, (CLI_IMAGES, 256, 256, 3), dtype=np.uint8)
        cli, launches, want = cli_requests(server, engine, ref, plain, images256, counters)
        out["cli"] = cli
        out["launches"] = launches
        out["expected_ln_mlp"] = want
        del server, engine, ref, ref_model, plain, plain_model
        free_card()
        out["cli_subprocess"] = cli_subprocess(export, dev, f"{root}/serve_stderr.log")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---- phase 10: evaluation and real data -------------------------------------------

EVAL_IMAGES = 1024  # the ImageNetValidator pass's injected images, in batches of EVAL_BATCH
EVAL_BATCH = 256
TEXT_BATCH = 1024  # encode_texts_batched's default batch
HEAD_COSINE = 0.999  # each class column of W, a kernel route against the plain route
# max |100 f @ W| difference of a kernel route's logits from the plain route's, over 1,024 images x
# 1,000 classes (bf16 towers): ~2.3x the first card reading (fused_mlp 0.2019, fused-block 0.2199; the
# planted fault 1.6197; H100 80GB HBM3, 700 W)
HEAD_LOGIT_TOL = 0.5
LOGIT_RECOMPUTE_TOL = 1e-3  # the validator's f32 logits against numpy's 100 f @ W in f64
CORPUS_N = 1024  # samples in each training glob (.npy 224x224)
HELD_OUT_N = 2048
SHARD_N = 512  # samples a shard
FOLDER_N = 512  # .npy files in the FileListSource.from_folder timing
DECODE_WORKERS = 8
MIX_WEIGHTS = (2.0, 1.0)
MIX_BATCHES, MIX_B = 64, 256
MIX_SHARE_TOL = 0.02  # |realised share of corpus a - 2/3| over 64 x 256 samples: ~5.4 binomial sigmas
EVAL_CLI_TIMEOUT_S = 600
EVAL_CLI_ARGS = ["--preset", "mixer-b32", "--epochs", "1"]  # the training runs of phase 10c (a CPU rehearsal: its preset)
EVAL_CLI_B = 256
EVAL_CLI_DEVICE = []  # every phase 10c command line's extra flags (a CPU rehearsal: --device cpu)
JPG_PRESET = "mixer-debug"  # the .jpg member's run tests the decode, not the model: the smallest preset
REMOTE_VALIDATORS = ("ImageNetValidator", "CosineSimValidator", "SST2Validator", "MNISTValidator")


def write_caption_tar(path, start, n, word, res, seed):
    """A webdataset tar of ``n`` uint8 [res, res, 3] ``.npy`` images with
    captions ``"<word> picture number <i>"``, numpy seed ``seed``."""
    import io
    import tarfile

    rng = np.random.default_rng(seed)
    with tarfile.open(path, "w") as tar:
        for i in range(start, start + n):
            buf = io.BytesIO()
            np.save(buf, rng.integers(0, 256, (res, res, 3), dtype=np.uint8))
            for name, data in ((f"{i:06d}.npy", buf.getvalue()), (f"{i:06d}.txt", f"{word} picture number {i}".encode())):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))


def write_corpus(root, word, n, res, seed):
    """``root/<word>/*.tar``: ``n`` samples in shards of ``SHARD_N``; returns the glob."""
    os.makedirs(f"{root}/{word}")
    for s, start in enumerate(range(0, n, SHARD_N)):
        write_caption_tar(f"{root}/{word}/{s:03d}.tar", start, min(SHARD_N, n - start), word, res, seed + s)
    return f"{root}/{word}/*.tar"


def head_route(model, tokens, images, n_classes, n_templates, counters):
    """One route's zero-shot head on ``tokens`` and ``images``: (W, logits,
    launches, seconds), the counters set to 0 first."""
    from clip_mixer_tpu_torch.evals import zeroshot

    counters.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w = zeroshot.class_embeddings(zeroshot.encode_texts_batched(model, tokens, TEXT_BATCH), n_classes, n_templates)
    classify = zeroshot.make_image_classifier(model, w)
    logits = np.concatenate([classify(images[i:i + EVAL_BATCH]) for i in range(0, len(images), EVAL_BATCH)])
    torch.cuda.synchronize()
    return w, logits, counters.read(), time.perf_counter() - t0


def head_gap(w, logits, w_ref, logits_ref):
    """(least cosine of a class column, largest |logit| difference) against the plain route."""
    return float((w.astype(np.float64) * w_ref).sum(0).min()), float(np.abs(logits - logits_ref).max())


def numpy_topk(logits, targets):
    """Top-1 and top-5 in %, from each target's rank among its row's logits
    (ties counted against it): independent of ``topk_accuracy``'s sort."""
    rank = (logits > logits[np.arange(len(targets)), targets][:, None]).sum(1)
    return 100.0 * float((rank < 1).mean()), 100.0 * float((rank < 5).mean())


def numpy_retrieval(img_f, txt_f):
    """The retrieval result from the features, ranks counted directly: the
    entries above the true pair, and the equal ones before it (the stable
    sort's order)."""
    sim = img_f @ txt_f.T
    res = {"n": float(sim.shape[0])}
    for name, s in (("image_to_text", sim), ("text_to_image", sim.T)):
        diag = np.diag(s)[:, None]
        before = np.tri(s.shape[0], k=-1, dtype=bool)
        ranks = (s > diag).sum(1) + ((s == diag) & before).sum(1)
        for k in (1, 5, 10):
            res[f"{name}_r@{k}"] = float((ranks < k).mean() * 100.0)
        res[f"{name}_median_rank"] = float(np.median(ranks) + 1.0)
    return res


def zero_shot_head(dev, counters, cfg, images, targets):
    """Phase 10a: the ImageNet head (1000 classes x 80 templates) and the
    ImageNetValidator on the fused_mlp config, the head through the
    fused-block and plain routes, their agreement, and top-k against numpy."""
    from clip_mixer_tpu_torch import CLIP
    from clip_mixer_tpu_torch.evals import validators, zeroshot
    from clip_mixer_tpu_torch.evals.prompts import IMAGENET_CLASSNAMES, PROMPT_TEMPLATES
    from clip_mixer_tpu_torch.ops.kernels.mixer_block import route_towers
    from clip_mixer_tpu_torch.text.tokenize import tokenize
    from clip_mixer_tpu_torch.train.metrics import MetricsWriter

    out = {}
    n_c, n_t = len(IMAGENET_CLASSNAMES), len(PROMPT_TEMPLATES)
    prompts = [t.format(c) for c in IMAGENET_CLASSNAMES for t in PROMPT_TEMPLATES]
    t0 = time.perf_counter()
    tokens = tokenize(prompts, cfg.context_length, truncate=True)
    out["prompts"] = len(prompts)
    out["tokenize_s"] = time.perf_counter() - t0
    fm_cfg = cfg.replace(fused_mlp=True)
    model = CLIP(fm_cfg, device=dev, generator=torch.Generator().manual_seed(0)).eval()
    zeroshot.encode_texts_batched(model, tokens[:TEXT_BATCH], TEXT_BATCH)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zeroshot.class_embeddings(zeroshot.encode_texts_batched(model, tokens, TEXT_BATCH), n_c, n_t)
    torch.cuda.synchronize()
    out["encode_s"] = time.perf_counter() - t0

    # the validator's pass, its features, W and logits captured on the way
    seen = {"feats": [], "logits": []}
    real_features, real_classifier = zeroshot._image_features, zeroshot.make_image_classifier

    def features(m, x):
        f = real_features(m, x)
        seen["feats"].append(f.cpu().numpy())
        return f

    def classifier(m, w):
        seen["w"] = w
        classify = real_classifier(m, w)

        def logged(x):
            seen["logits"].append(classify(x))
            return seen["logits"][-1]

        return logged

    batches = [(images[i:i + EVAL_BATCH], targets[i:i + EVAL_BATCH]) for i in range(0, len(images), EVAL_BATCH)]
    writer = MetricsWriter()
    v = validators.ImageNetValidator(model, fm_cfg, writer=writer, image_batches_fn=lambda: iter(batches))
    zeroshot._image_features, zeroshot.make_image_classifier = features, classifier
    try:
        counters.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = v.validate(step=0, verbose=True)
        torch.cuda.synchronize()
        out["validator_s"] = time.perf_counter() - t0
        launches = counters.read()
    finally:
        zeroshot._image_features, zeroshot.make_image_classifier = real_features, real_classifier
    want_ln = -(-len(prompts) // TEXT_BATCH) * cfg.text_layers + len(batches) * cfg.vision_layers
    require(launches == {"ln_mlp": want_ln, "preprocess": 0, "fused_mixer_block": 0},
            f"the ImageNetValidator pass launched {launches}, expected ln_mlp {want_ln} and nothing else")
    require(set(res) == {"top1", "top5"} and sorted(writer.history) == ["Top-1 accuracy", "Top-5 accuracy"], res)
    # numpy from the same features and W: the logits, then top-k from them
    logits = np.concatenate([l_[:len(t)] for l_, (_, t) in zip(seen["logits"], batches)])
    feats = np.concatenate([f[:len(t)] for f, (_, t) in zip(seen["feats"], batches)]).astype(np.float64)
    recomputed = 100.0 * feats @ seen["w"].astype(np.float64)
    out["logit_recompute_max_abs"] = float(np.abs(recomputed - logits).max())
    require(out["logit_recompute_max_abs"] <= LOGIT_RECOMPUTE_TOL,
            f"validator logits against numpy's 100 f @ W: {out['logit_recompute_max_abs']}")
    np_top = numpy_topk(logits, targets)
    require(np_top == (res["top1"], res["top5"]), f"topk: validator {res}, numpy {np_top}")
    out["imagenet"] = {**res, "numpy_top1_top5": np_top,
                       "numpy_top1_top5_from_f64_logits": numpy_topk(recomputed, targets)}
    out["launches"] = {"imagenet_validator": launches}
    out["expected_ln_mlp"] = want_ln
    w_fm, logits_fm = seen["w"], logits
    log(f"phase 10a validator: {res} in {out['validator_s']:.2f} s, launches {launches}")
    del model, v, seen, feats
    free_card()

    # the same head through the fused-block route and plain, one set of weights
    model = CLIP(cfg, device=dev, generator=torch.Generator().manual_seed(0)).eval()
    route_towers(model, True)
    w_fb, logits_fb, out["launches"]["fused_block_head"], out["fused_block_head_s"] = head_route(
        model, tokens, images, n_c, n_t, counters)
    require(out["launches"]["fused_block_head"]["fused_mixer_block"] > 0
            and out["launches"]["fused_block_head"]["ln_mlp"] == 0, out["launches"]["fused_block_head"])
    # the planted fault: every text block's channel-mix output bias dropped on the fused-block route
    saved = [blk.channel_mix_seq.lin4.bias.detach().clone() for blk in model.transformer.mixBlocks]
    with torch.no_grad():
        for blk in model.transformer.mixBlocks:
            blk.channel_mix_seq.lin4.bias.zero_()
    w_fault, logits_fault, _, _ = head_route(model, tokens, images, n_c, n_t, counters)
    with torch.no_grad():
        for blk, b in zip(model.transformer.mixBlocks, saved):
            blk.channel_mix_seq.lin4.bias.copy_(b)
    route_towers(model, False)
    w_pl, logits_pl, out["launches"]["plain_head"], out["plain_head_s"] = head_route(
        model, tokens, images, n_c, n_t, counters)
    require(not any(out["launches"]["plain_head"].values()), out["launches"]["plain_head"])
    gaps = {"fused_mlp": head_gap(w_fm, logits_fm, w_pl, logits_pl), "fused_block": head_gap(w_fb, logits_fb, w_pl, logits_pl),
            "planted_fault": head_gap(w_fault, logits_fault, w_pl, logits_pl)}
    for route in ("fused_mlp", "fused_block"):
        cos, dl = gaps[route]
        require(cos >= HEAD_COSINE and dl <= HEAD_LOGIT_TOL,
                f"{route} head against plain: column cosine {cos} (>= {HEAD_COSINE}), logits {dl} (<= {HEAD_LOGIT_TOL})")
    cos, dl = gaps["planted_fault"]
    require(cos < HEAD_COSINE or dl > HEAD_LOGIT_TOL,
            f"planted fault: the fused-block head without its channel-mix biases passed ({cos}, {dl})")
    out["head_vs_plain"] = {k: {"min_column_cosine": c, "max_abs_logit": d} for k, (c, d) in gaps.items()}
    out["plain_top1_top5"] = numpy_topk(logits_pl, targets)
    del model
    free_card()
    return out


def sources_and_retrieval(dev, counters, cfg, root):
    """Phase 10b: the tar, folder and mixture sources on the host, and
    RetrievalValidator on the fused-block route."""
    from clip_mixer_tpu_torch import CLIP
    from clip_mixer_tpu_torch.data.pipeline import FileListSource, MixtureSource, TarShardSource, expand_shard_pattern
    from clip_mixer_tpu_torch.evals import validators
    from clip_mixer_tpu_torch.ops.kernels.mixer_block import route_towers
    from clip_mixer_tpu_torch.text.tokenize import tokenize

    res = cfg.image_resolution
    out = {}
    t0 = time.perf_counter()
    globs = {w: write_corpus(root, w, n, res, seed) for w, n, seed in
             (("alpha", CORPUS_N, 100), ("omega", CORPUS_N, 200), ("heldout", HELD_OUT_N, 300))}
    out["write_s"] = time.perf_counter() - t0
    out["corpus_bytes"] = sum(os.path.getsize(p) for w in globs.values() for p in expand_shard_pattern(w))
    kw = dict(image_size=res, context_length=cfg.context_length)

    def rate(source):
        t0 = time.perf_counter()
        n = sum(len(b["images"]) for b in source.iter_batches(0))
        s = time.perf_counter() - t0
        return {"samples": n, "s": s, "images_per_s": n / s}

    out["tar_decode"] = rate(TarShardSource(expand_shard_pattern(globs["alpha"]), batch_size=EVAL_BATCH,
                                            decode_workers=DECODE_WORKERS, **kw))
    folder = f"{root}/folder"
    os.makedirs(folder)
    rng = np.random.default_rng(400)
    for i in range(FOLDER_N):
        np.save(f"{folder}/image_{i:05d}.npy", rng.integers(0, 256, (res, res, 3), dtype=np.uint8))
    out["folder_decode"] = rate(FileListSource.from_folder(folder, batch_size=EVAL_BATCH, caption_from="stem",
                                                           decode_workers=DECODE_WORKERS, **kw))
    require(out["tar_decode"]["samples"] == CORPUS_N and out["folder_decode"]["samples"] == FOLDER_N, out)

    mix = MixtureSource([expand_shard_pattern(globs[w]) for w in ("alpha", "omega")], batch_size=MIX_B,
                        weights=MIX_WEIGHTS, shuffle_buffer=1000, decode_workers=DECODE_WORKERS, **kw)
    marker = tokenize(["alpha"], cfg.context_length)[0, 1]
    t0 = time.perf_counter()
    it, hits = mix.iter_batches(0), 0
    for _ in range(MIX_BATCHES):
        hits += int((next(it)["texts"][:, 1] == marker).sum())
    mix_s = time.perf_counter() - t0
    share = hits / (MIX_BATCHES * MIX_B)
    want = MIX_WEIGHTS[0] / sum(MIX_WEIGHTS)
    require(abs(share - want) <= MIX_SHARE_TOL, f"mixture share {share}, not {want} +- {MIX_SHARE_TOL}")
    out["mixture"] = {"share_alpha": share, "want": want, "tol": MIX_SHARE_TOL, "s": mix_s,
                      "images_per_s": MIX_BATCHES * MIX_B / mix_s}
    log(f"phase 10b sources: {out}")

    model = CLIP(cfg, device=dev, generator=torch.Generator().manual_seed(0)).eval()
    route_towers(model, True)
    held_out = TarShardSource(expand_shard_pattern(globs["heldout"]), batch_size=EVAL_BATCH, drop_last=False,
                              decode_workers=DECODE_WORKERS, **kw)
    seen = {}
    real_img, real_txt = validators.encode_images_batched, validators.encode_texts_batched
    validators.encode_images_batched = lambda m, x: seen.setdefault("img", real_img(m, x))
    validators.encode_texts_batched = lambda m, x: seen.setdefault("txt", real_txt(m, x))
    try:
        counters.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = validators.RetrievalValidator(model, cfg, data_source=held_out, max_samples=HELD_OUT_N).validate(
            step=0, verbose=True)
        torch.cuda.synchronize()
        out["retrieval_s"] = time.perf_counter() - t0
        out["launches"] = {"retrieval": counters.read()}
    finally:
        validators.encode_images_batched, validators.encode_texts_batched = real_img, real_txt
    require(out["launches"]["retrieval"]["fused_mixer_block"] > 0 and out["launches"]["retrieval"]["ln_mlp"] == 0,
            out["launches"]["retrieval"])
    want_res = numpy_retrieval(seen["img"], seen["txt"])
    require(got == want_res, f"retrieval {got} against numpy {want_res}")
    require(got["n"] == HELD_OUT_N, got)
    out["retrieval"] = got
    del model
    free_card()
    return out, globs


def cli_run(argv, cwd, log_path, timeout=EVAL_CLI_TIMEOUT_S):
    """``python -m <argv>`` in ``cwd`` with this repo on the path; (rc,
    stdout, seconds), standard error to ``log_path``."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([repo, os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    with open(log_path, "w") as err:
        proc = subprocess.run([sys.executable, "-m", *argv], cwd=cwd, env=env, stdout=subprocess.PIPE,
                              stderr=err, text=True, timeout=timeout)
    s = time.perf_counter() - t0
    if proc.returncode:
        with open(log_path) as f:
            log(f"{argv[0]} exited {proc.returncode}: stdout {proc.stdout[-3000:]} stderr {f.read()[-3000:]}")
    return proc.returncode, proc.stdout, s


def clis(cfg, root, globs):
    """Phase 10c: train_cli on the mixture with --val-data and the default
    validators, train_cli --cache-data, eval_cli on the export, and a .jpg
    member on a host without Pillow."""
    import io
    import re
    import tarfile

    from clip_mixer_tpu_torch import PRESETS

    out = {}
    run = ["clip_mixer_tpu_torch.train_cli", *EVAL_CLI_ARGS, *EVAL_CLI_DEVICE, "--global-batch-size", str(EVAL_CLI_B),
           "--steps-per-epoch", "8", "--validate-every", "4", "--checkpoint-every", "8", "--keep-checkpoints", "1",
           "--verbose", "--data", f"{globs['alpha']}::2", "--data", f"{globs['omega']}::1",
           "--val-data", globs["heldout"], "--run-name", "mix"]
    rc, stdout, out["train_cli_s"] = cli_run(run, root, f"{root}/train_cli.err")
    require(rc == 0, f"train_cli on the mixture exited {rc}")
    passes = [(int(s), name, float(t)) for s, name, t in
              re.findall(r"^validate step (\d+): (\w+) ([0-9.]+) s$", stdout, flags=re.M)]
    require(sorted({(s, n) for s, n, _ in passes}) == sorted(
        (s, n) for s in (4, 8) for n in REMOTE_VALIDATORS + ("RetrievalValidator",)), passes)
    skipped = {tag: stdout.count(f"[{tag}] skipped") for tag in ("imagenet", "sst2", "mnist")}
    skipped["sts"] = stdout.count("[sts:")
    require(skipped["imagenet"] == skipped["sst2"] == skipped["mnist"] == 2 and skipped["sts"] == 12,
            f"the remote validators did not skip offline at steps 4 and 8: {skipped}")
    out["validator_pass_s"] = {f"{n}@{s}": t for s, n, t in passes}
    with open(f"{root}/outputs/mix/runs/metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    scored = sorted((r["step"], r["name"]) for r in rows if r["name"].startswith("Retrieval"))
    require(scored == sorted((s, f"Retrieval {d} R@{k}") for s in (4, 8) for d in ("I->T", "T->I") for k in (1, 5)),
            f"metrics.jsonl retrieval rows: {scored}")
    out["retrieval_rows"] = {f"{r['name']}@{r['step']}": r["value"] for r in rows if r["name"].startswith("Retrieval")}
    export = f"{root}/outputs/mix/export"

    rc, _, out["cache_cli_s"] = cli_run(
        ["clip_mixer_tpu_torch.train_cli", *EVAL_CLI_ARGS, *EVAL_CLI_DEVICE, "--global-batch-size", str(EVAL_CLI_B),
         "--steps-per-epoch", "2", "--checkpoint-every", "2", "--no-validators",
         "--data", globs["alpha"], "--cache-data", f"{root}/cache", "--run-name", "cached"],
        root, f"{root}/cache_cli.err")
    require(rc == 0 and len(os.listdir(f"{root}/cache")) == 2, f"train_cli --cache-data exited {rc}")

    rc, stdout, out["eval_cli_s"] = cli_run(
        ["clip_mixer_tpu_torch.eval_cli", "--model", export, "--validators", "sts", "sst2", "mnist", "imagenet",
         "retrieval", "--val-data", globs["heldout"], *EVAL_CLI_DEVICE],
        root, f"{root}/eval_cli.err")
    found = re.findall(r"^\[retrieval\] (\{.*\})$", stdout, flags=re.M)
    require(rc == 0 and len(found) == 1, f"eval_cli exited {rc}; retrieval lines {found}")
    out["eval_cli_retrieval"] = json.loads(found[0].replace("'", '"'))
    require(out["eval_cli_retrieval"]["n"] == HELD_OUT_N, out["eval_cli_retrieval"])

    # a .jpg member: without Pillow an ImportError naming it, nothing substituted
    try:
        from PIL import Image
    except ImportError:
        jpg, pillow = b"\xff\xd8\xff\xe0 never decoded", False
    else:
        buf = io.BytesIO()
        Image.fromarray(np.full((32, 32, 3), 128, np.uint8)).save(buf, "JPEG")
        jpg, pillow = buf.getvalue(), True
    os.makedirs(f"{root}/jpg")
    npy = io.BytesIO()
    res = PRESETS[JPG_PRESET].image_resolution
    np.save(npy, np.zeros((res, res, 3), np.uint8))
    with tarfile.open(f"{root}/jpg/000.tar", "w") as tar:
        for name, data in (("a.jpg", jpg), ("a.txt", b"a grey square"), ("b.npy", npy.getvalue()),
                           ("b.txt", b"a black square")):
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))
    rc, _, s = cli_run(["clip_mixer_tpu_torch.train_cli", "--preset", JPG_PRESET, "--epochs", "1", *EVAL_CLI_DEVICE,
                        "--global-batch-size", "2",
                        "--steps-per-epoch", "1", "--no-validators", "--on-decode-error",
                        "substitute", "--data", f"{root}/jpg/*.tar", "--run-name", "jpg"], root, f"{root}/jpg.err")
    with open(f"{root}/jpg.err") as f:
        err = f.read()
    if pillow:
        require(rc == 0, f"with Pillow the .jpg member did not train: rc {rc}")
    else:
        require(rc != 0 and "ImportError: decoding .jpg/.jpeg/.png records needs Pillow" in err
                and "substituted" not in err, f"without Pillow: rc {rc}, stderr {err[-2000:]}")
    out["jpg_member"] = {"pillow": pillow, "rc": rc, "s": s}
    return out


def eval_path(dev, counters):
    """Phase 10: the evals and the real-data sources on full-width Mixer-B/32."""
    import shutil
    import tempfile

    from clip_mixer_tpu_torch import PRESETS

    t_phase = time.perf_counter()
    cfg = PRESETS["mixer-b32"]
    rng = np.random.default_rng(21)
    images = rng.integers(0, 256, (EVAL_IMAGES, cfg.image_resolution, cfg.image_resolution, 3), dtype=np.uint8)
    targets = rng.integers(0, 1000, EVAL_IMAGES)
    root = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    try:
        out = {"head": zero_shot_head(dev, counters, cfg, images, targets)}
        emit({"eval_head": out["head"]})
        out["sources"], globs = sources_and_retrieval(dev, counters, cfg, root)
        emit({"eval_sources": out["sources"]})
        out["clis"] = clis(cfg, root, globs)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = {**out["head"]["launches"], **out["sources"]["launches"]}
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---- phase 11: frozen serving programs, the release and the fast tokenizer -------

FROZEN_BUCKETS = (8, 128)  # the float programs of 11a
FROZEN_SMALL_BUCKETS = (8,)  # the plain witness, the int8 programs and the release
RELEASE_GATE_N = 4096  # the release's gates, phase 6's n
FROZEN_TRAIN_ARGS = ["--synthetic", "--preset", "mixer-debug", "--global-batch-size", "8", "--steps-per-epoch", "2",
                     "--epochs", "1", "--checkpoint-every", "2", "--no-validators", "--freeze-serving"]
# the CPU tests' tokenizer corpus (tests/test_torch_port_fast_tokenizer.py, from tests/test_fast_tokenizer.py)
TOKENIZER_CORPUS = [
    "a photo of a cat", "A Photo   of\ta DOG!!", "it's can't we're I've i'm they'll she'd", "12345 67 8",
    "naïve café résumé", "日本語のテキスト", "emoji 🚀🔥 test", "x", "", "&amp;amp; &lt;tag&gt;",
    "punctuation... --- ???!!", "don''t '' 'x ''s", "!!'s mid-run contraction swallow",
    "<|startoftext|> embedded <|endoftext|>", "!!<|endoftext|> swallowed special", "a" * 300,
    "the quick brown fox jumps over the lazy dog", "ｆｕｌｌｗｉｄｔｈ", "tab\tand\nnewline  collapse",
    "mixed 'll'd're endings", "прекрасный день сегодня", "数字123と文字",
    "aͅb", "it'ſ ok", "xͅͅ!",  # where the JAX package's C++ tokenizer leaves the Python contract
]


def tower_call(engine, modality, x):
    """One call of an engine's tower path on a device batch (no host copy)."""
    fn, module = engine._image_path if modality == "image" else engine._text_path
    with torch.inference_mode():
        return fn(module, x)


def host_ms(fn, iters=3):
    """Host milliseconds a call takes to enqueue its work (no synchronise
    inside the timed calls): above the call's device time, the host sets
    the pace."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def program_files(out):
    sdir = os.path.join(out, "servable")
    return {f: os.path.getsize(os.path.join(sdir, f)) for f in sorted(os.listdir(sdir)) if f.endswith(".pt2")}


def frozen_route(dev, counters, cfg, route, root, images, buckets=FROZEN_BUCKETS):
    """Export one route of full-width Mixer-B/32 (seed-0 weights), load it,
    and hold its features and launches a tower call against a live engine
    on the same model; tower ms at the largest bucket beside the live one."""
    from clip_mixer_tpu_torch import CLIP, aot
    from clip_mixer_tpu_torch.ops.kernels.mixer_block import route_towers
    from clip_mixer_tpu_torch.serving import InferenceEngine

    kernel = {"fused_mlp": "ln_mlp", "fused_block": "fused_mixer_block", "plain": None}[route]
    model = CLIP(cfg.replace(fused_mlp=route == "fused_mlp"), device=dev, generator=torch.Generator().manual_seed(0))
    if route == "fused_block":
        route_towers(model, True)
    out_dir = os.path.join(root, route)
    t0 = time.perf_counter()
    aot.export_servable(model, out_dir, batch_buckets=buckets)
    export_s = time.perf_counter() - t0
    files = program_files(out_dir)
    t0 = time.perf_counter()
    frozen = aot.load_servable(out_dir, device=dev)
    load_s = time.perf_counter() - t0
    require(frozen.frozen and aot.serving_route(frozen.model) == route, f"{route}: {aot.read_manifest(out_dir)}")
    live = InferenceEngine(model, batch_buckets=buckets)
    out = {"export_s": export_s, "programs": len(files), "export_s_per_program": export_s / len(files),
           "pt2_bytes": files, "model_pt_bytes": os.path.getsize(os.path.join(out_dir, "model.pt")),
           "load_servable_s": load_s}

    calls = [("text", n, lambda e, n=n: e.encode_text(TEXTS[:n])) for n in (5, 40)]
    calls += [("image", n, lambda e, n=n: e.encode_image_arrays(images[:n])) for n in (7, 100)]
    if max(buckets) < 100:
        calls = [k for k in calls if k[1] <= max(buckets)]
    launches = {k: 0 for k in ("ln_mlp", "fused_mixer_block", "preprocess")}
    for modality, n, call in calls:
        deltas = dict.fromkeys(launches, 0)
        if kernel:
            deltas[kernel] = cfg.vision_layers if modality == "image" else cfg.text_layers
        counters.reset()  # the frozen programs' own launches, read just after their call
        got = call(frozen)
        c = expect(counters, dict.fromkeys(launches, 0), f"frozen {route} {modality}({n})", **deltas)
        launches = {k: v + c[k] for k, v in launches.items()}
        check_features(got, n, cfg.embed_dim, f"frozen {route} {modality}({n})")
        want = call(live)
        expect(counters, c, f"live {route} {modality}({n})", **deltas)
        require(np.array_equal(got, want), f"frozen {route} {modality}({n}): features differ from the live engine "
                f"(max abs {float(np.abs(got - want).max())})")
    out["launches"] = launches
    B = max(buckets)
    R, ctx = cfg.image_resolution, cfg.context_length
    x_img = torch.from_numpy(np.ascontiguousarray(images[:B, :R, :R])).to(dev)
    x_txt = torch.from_numpy(tokenize_texts((TEXTS * (-(-B // len(TEXTS))))[:B], ctx)).to(dev)
    for modality, x in (("image", x_img), ("text", x_txt)):
        ways = {"frozen": lambda: tower_call(frozen, modality, x), "live": lambda: tower_call(live, modality, x)}
        out[f"{modality}_b{B}_ms"] = in_turns(ways)
        out[f"{modality}_b{B}_host_ms"] = {k: host_ms(fn) for k, fn in ways.items()}
    log(f"phase 11a {route}: export {export_s:.1f} s ({len(files)} programs), load {load_s:.1f} s, "
        f"bucket {B} ms {out.get(f'image_b{B}_ms')} / {out.get(f'text_b{B}_ms')}, launches {out['launches']}")
    return out, model, frozen


def frozen_int8(dev, counters, model, root):
    """11b: int8 programs from an artifact of both towers (phase 6's
    calibration recipe), bit for bit the live int8 engine's."""
    from clip_mixer_tpu_torch import aot
    from clip_mixer_tpu_torch.evals import quant_gate as gates
    from clip_mixer_tpu_torch.serving import InferenceEngine

    cfg = model.cfg
    artifact = os.path.join(root, "scales.npz")
    calib = gates.synthetic_images(INT8_CALIB_N, cfg.image_resolution, seed=0)
    InferenceEngine(model).enable_int8(calib, CAPTIONS, save_calibration=artifact)
    out_dir = os.path.join(root, "int8")
    t0 = time.perf_counter()
    aot.export_servable(model, out_dir, batch_buckets=FROZEN_SMALL_BUCKETS, int8_calibration=artifact)
    out = {"export_s": time.perf_counter() - t0, "pt2_bytes": program_files(out_dir)}
    t0 = time.perf_counter()
    frozen = aot.load_servable(out_dir, device=dev)
    out["load_servable_s"] = time.perf_counter() - t0
    live = InferenceEngine(model, batch_buckets=FROZEN_SMALL_BUCKETS)
    live.enable_int8(calibration=artifact)
    require(frozen.path_kinds == live.path_kinds == {"image": "int8", "text": "int8"}, frozen.path_kinds)
    probe = gates.synthetic_images(7, cfg.image_resolution, seed=5)
    counters.reset()
    for what, fn in (("image", lambda e: e.encode_image_arrays(probe)), ("text", lambda e: e.encode_text(TEXTS[:5]))):
        got = fn(frozen)
        check_features(got, len(got), cfg.embed_dim, f"frozen int8 {what}")
        require(np.array_equal(got, fn(live)), f"frozen int8 {what}: features differ from the live int8 engine")
    out["launches"] = counters.read()
    require(not any(out["launches"].values()), f"the int8 programs launched a kernel: {out['launches']}")
    log(f"phase 11b int8: {out}")
    return out


def serve_frozen_subprocess(release, engine, images, log_path):
    """``python -m clip_mixer_tpu_torch.serving --model <release>`` in a
    process of its own: it must say it serves frozen programs, and its
    /healthz, /encode_text and /encode_image must answer bit for bit as
    ``engine`` (an in-process ``load_servable`` of the same release)."""
    from clip_mixer_tpu_torch.client import ServingClient

    port = free_port()
    repo = os.path.dirname(os.path.abspath(__file__))
    out_path = log_path + ".out"
    with open(log_path, "w") as err, open(out_path, "w") as stdout:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "clip_mixer_tpu_torch.serving", "--model", release,
                                 "--port", str(port), *SERVE_ARGS], cwd=repo, stdout=stdout, stderr=err)
    try:
        client = ServingClient(f"http://127.0.0.1:{port}", timeout=120, retries=0)
        health = None
        while health is None:
            if proc.poll() is not None:
                with open(log_path) as f:
                    require(False, f"the serving CLI exited {proc.returncode}: {f.read()[-4000:]}")
            require(time.perf_counter() - t0 < SERVE_TIMEOUT_S, "the serving CLI never answered /healthz")
            try:
                health = client.healthz()
            except Exception:
                time.sleep(0.2)
        first_ms = (time.perf_counter() - t0) * 1e3
        with open(out_path) as f:
            said = f.read()
        require(f"frozen programs loaded from {release}/servable" in said and "frozen=True" in said, said)
        require(health["frozen"] is True and health["paths"] == engine.path_kinds, health)
        text = client.encode_text(TEXTS[:5])
        image = client.encode_image_files([base64.b64decode(b) for b in npy_b64(images)])
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    require(np.array_equal(text, engine.encode_text(TEXTS[:5])), "the CLI's /encode_text differs from load_servable's")
    require(np.array_equal(image, engine.encode_image_arrays(images)),
            "the CLI's /encode_image differs from load_servable's")
    return {"first_healthz_ms": first_ms, "said": said.strip().splitlines()}


def frozen_release(dev, counters, model, root):
    """11c: scripts/torch_release.py on a port export of the plain model:
    int8 aborts on the text gate with nothing frozen; --no-int8 releases;
    --verify passes; the serving CLI serves it frozen; train_cli
    --freeze-serving writes an export that load_servable serves."""
    import contextlib
    import io

    from clip_mixer_tpu_torch import aot
    from clip_mixer_tpu_torch.api import save_pretrained

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts"))
    import torch_release

    cfg = model.cfg
    src = os.path.join(root, "export")
    save_pretrained(model, cfg, src)
    out = {}
    dev_flags = list(SERVE_ARGS)
    buckets = ",".join(map(str, FROZEN_SMALL_BUCKETS))

    def release(*argv):
        said = io.StringIO()
        t0 = time.perf_counter()
        code = 0
        with contextlib.redirect_stdout(said):
            try:
                torch_release.main([*argv, *dev_flags])
            except SystemExit as e:
                code = e.code if e.code is not None else 0
        return code, said.getvalue(), time.perf_counter() - t0

    aborted = os.path.join(root, "release_int8")
    code, said, s = release("--model", src, "--out", aborted, "--gate-n", str(RELEASE_GATE_N), "--buckets", buckets)
    require(code not in (0, None) and "RELEASE ABORTED" in str(code), f"the int8 release did not abort: {code} {said}")
    require(not os.path.exists(os.path.join(aborted, "servable")), "the aborted release froze programs")
    require(not os.path.exists(os.path.join(aborted, "RELEASE.json")), "the aborted release wrote RELEASE.json")
    out["int8_release"] = {"s": s, "exit": str(code), "gates": [line for line in said.splitlines() if "gate" in line]}
    log(f"phase 11c int8 release: {out['int8_release']}")

    rel = os.path.join(root, "release")
    code, said, s = release("--model", src, "--out", rel, "--no-int8", "--buckets", buckets)
    require(code == 0, f"the --no-int8 release failed: {code} {said}")
    out["float_release_s"] = s
    code, said, s = release("--out", rel, "--verify")
    require(code == 0 and "VERIFY OK: float release" in said, f"--verify: {code} {said}")
    out["verify"] = {"s": s, "said": said.strip()}

    engine = aot.load_servable(rel, device=dev)
    images = np.random.default_rng(11).integers(0, 256, (4, cfg.image_resolution, cfg.image_resolution, 3),
                                                dtype=np.uint8)
    counters.reset()
    out["cli"] = serve_frozen_subprocess(rel, engine, images, os.path.join(root, "cli.log"))
    out["cli_check_launches"] = counters.read()  # the in-process engine's: the plain route, none

    # train_cli in this process (it writes outputs/<run-name> under the working directory)
    from clip_mixer_tpu_torch import train_cli

    run = os.path.join(root, "train")
    os.makedirs(run)
    cwd = os.getcwd()
    t0 = time.perf_counter()
    try:
        os.chdir(run)
        with contextlib.redirect_stdout(io.StringIO()):
            train_cli.main([*FROZEN_TRAIN_ARGS, *SERVE_ARGS, "--run-name", "frozen"])
    finally:
        os.chdir(cwd)
    s = time.perf_counter() - t0
    export = os.path.join(run, "outputs", "frozen", "export")
    trained = aot.load_servable(export, device=dev)
    feats = trained.encode_text(TEXTS[:3])
    check_features(feats, 3, trained.cfg.embed_dim, "train_cli --freeze-serving export")
    out["train_cli"] = {"s": s, "buckets": aot.read_manifest(export)["buckets"], "frozen": trained.frozen}
    log(f"phase 11c: {out}")
    return out


def fast_tokenizer_check(dev, build_s):
    """11d: the C++ tokenizer on the 80,000 ImageNet prompts, cold and warm,
    against the Python BPE's tokens and time, and the engine's tokens on the
    CPU tests' corpus."""
    from clip_mixer_tpu_torch import CLIP, PRESETS
    from clip_mixer_tpu_torch.evals.prompts import IMAGENET_CLASSNAMES, PROMPT_TEMPLATES
    from clip_mixer_tpu_torch.serving import InferenceEngine
    from clip_mixer_tpu_torch.text import fast
    from clip_mixer_tpu_torch.text.bpe import get_tokenizer
    from clip_mixer_tpu_torch.text.tokenize import tokenize

    prompts = [t.format(c) for c in IMAGENET_CLASSNAMES for t in PROMPT_TEMPLATES]
    out = {"build_s": build_s, "prompts": len(prompts)}
    fast.clear_cache()
    t0 = time.perf_counter()
    cold = fast.fast_tokenize(prompts, 77, truncate=True)
    out["cold_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    warm = fast.fast_tokenize(prompts, 77, truncate=True)
    out["warm_s"] = time.perf_counter() - t0
    get_tokenizer().clear_cache()
    t0 = time.perf_counter()
    want = tokenize(prompts, 77, truncate=True)
    out["python_s"] = time.perf_counter() - t0
    require(np.array_equal(cold, want) and np.array_equal(warm, want), "fast_tokenize differs from the Python BPE")

    cfg = PRESETS["mixer-debug"]
    engine = InferenceEngine(CLIP(cfg, device=dev, generator=torch.Generator().manual_seed(0)), batch_buckets=(32,))
    fn, module = engine._text_path
    seen = []
    engine._text_path = (lambda m, t: (seen.append(t.cpu().numpy()), fn(m, t))[1], module)
    engine.encode_text(TOKENIZER_CORPUS)
    got = np.concatenate(seen)[: len(TOKENIZER_CORPUS)]
    require(np.array_equal(got, tokenize(TOKENIZER_CORPUS, cfg.context_length, truncate=True)),
            "the engine's tokens differ from the Python BPE's on the corpus")
    out["engine_corpus_texts"] = len(TOKENIZER_CORPUS)
    log(f"phase 11d tokenizer: {out}")
    return out


def frozen_path(dev, counters, tokenizer_build_s):
    """Phase 11: frozen serving programs of full-width Mixer-B/32 (bf16,
    seed-0 weights) on three routes and in int8, the release, the CLI on a
    release, train_cli --freeze-serving, and the C++ tokenizer."""
    import shutil
    import tempfile

    from clip_mixer_tpu_torch import PRESETS

    t_phase = time.perf_counter()
    cfg = PRESETS["mixer-b32"]
    R = cfg.image_resolution
    images = np.random.default_rng(0).integers(0, 256, (128, R, R, 3), dtype=np.uint8)
    root = tempfile.mkdtemp(prefix="chip_smoke_frozen_")
    out, launches = {}, {}
    try:
        free_card()
        for route in ("fused_mlp", "fused_block"):
            out[route], model, _ = frozen_route(dev, counters, cfg, route, root, images)
            launches[route] = out[route]["launches"]
            del model
            free_card()
        out["plain"], plain_model, _ = frozen_route(dev, counters, cfg, "plain", root, images, FROZEN_SMALL_BUCKETS)
        launches["plain"] = out["plain"]["launches"]
        require(not any(launches["plain"].values()), f"the plain programs launched a kernel: {launches['plain']}")
        emit({"frozen_programs": {k: out[k] for k in ("fused_mlp", "fused_block", "plain")}})
        out["int8"] = frozen_int8(dev, counters, plain_model, root)
        launches["int8"] = out["int8"]["launches"]
        out["release"] = frozen_release(dev, counters, plain_model, root)
        emit({"frozen_release": {"int8": out["int8"], "release": out["release"]}})
        del plain_model
        free_card()
        out["tokenizer"] = fast_tokenizer_check(dev, tokenizer_build_s)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    return out


def write_npy_tar(path, n):
    """A webdataset-style tar of ``n`` uint8 256x256 ``.npy`` images (numpy seed 13)."""
    import io
    import tarfile

    rng = np.random.default_rng(13)
    with tarfile.open(path, "w") as tar:
        for i in range(n):
            buf = io.BytesIO()
            np.save(buf, rng.integers(0, 256, (256, 256, 3), dtype=np.uint8))
            info = tarfile.TarInfo(f"{i:06d}.npy")
            info.size = buf.tell()
            buf.seek(0)
            tar.addfile(info, buf)


def tokenizer_build_times() -> dict:
    """Build the C++ tokenizer (``g++``, into ``build/tokenizer/``), its
    scanner tables and its merge table, each timed; phase 11d reports them."""
    from clip_mixer_tpu_torch.text import fast

    out = {}
    for what, fn in (("compile_s", fast.build), ("tables_s", fast.build_tables), ("load_s", fast._instance)):
        t0 = time.perf_counter()
        fn()
        out[what] = time.perf_counter() - t0
    return out


# ---- phase 12: data-parallel training and multi-device serving --------------

DP_B = 256  # 12a/12b's global batch (a world of one holds all of it)
DP_STEPS = 3  # 12a: steps on each route, each beside the single-device step
DP_RN_STEPS = 2  # 12b: RN50 steps with SyncBN
DP_EMA = 0.999
DP_ALLREDUCE_ITERS = 5
DP_CLI_B = 256
DP_CLI_STEPS = 4  # 12c: the uninterrupted run; the interrupted one stops after DP_CLI_CRASH and resumes
DP_CLI_CRASH = 2
DP_CLI_ARGS = ["--synthetic", "--preset", "mixer-b32", "--fused-mlp", "--no-validators", "--epochs", "1"]
DP_CLI_DEVICE = []  # extra train_cli flags (a CPU rehearsal: --device cpu)
DP_CLI_TIMEOUT_S = 300
DP_BUCKET = 128  # 12d: the engines' and the mesh programs' bucket
DP_BANK_ROWS = 16384  # 12d: the device bank (DEVICE_BANK_MIN_ROWS)


def same_bits(a: dict, b: dict, what: str) -> None:
    """Every tensor of ``a`` equal to ``b``'s bit for bit (the same keys)."""
    require(set(a) == set(b), f"{what}: keys differ {sorted(set(a) ^ set(b))[:5]}")
    diff = [k for k in a if not torch.equal(a[k], b[k])]
    require(not diff, f"{what}: not bit for bit at {diff[:5]} (max abs "
            f"{max(float((a[k].float() - b[k].float()).abs().max()) for k in diff[:5]) if diff else 0})")


def train_state_tensors(state) -> dict:
    """A train state's parameters and buffers, Adam moments and EMA, by name."""
    out = {f"model.{k}": v.detach() for k, v in state.model.state_dict().items()}
    opt = state.opt_state
    for what, d in (("mu", opt.mu), ("nu", opt.nu), ("ema", opt.ema)):
        out.update({f"{what}.{k}": v for k, v in (d or {}).items()})
    return out


def dp_pair(dev, cfg, tcfg, group, fused_block=False, **kw):
    """The single-device step and the data-parallel one (over ``group``), each
    on its own CLIP from seed 0 (for a ResNet, BN drawn)."""
    from clip_mixer_tpu_torch import CLIP
    from clip_mixer_tpu_torch.ops.kernels.mixer_block import route_towers
    from clip_mixer_tpu_torch.parallel.mesh import replicate
    from clip_mixer_tpu_torch.parallel.train_step import init_train_state, make_train_step
    from clip_mixer_tpu_torch.train.optimizer import make_optimizer

    pair = {}
    for name, g in (("single", None), ("dp", group)):
        model = CLIP(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        if cfg.is_resnet:
            perturb_bn(model.visual)
        replicate(g, model)
        if fused_block:
            route_towers(model, True)
        opt = make_optimizer(tcfg, total_steps=DP_STEPS)
        pair[name] = (init_train_state(model, opt), make_train_step(cfg, tcfg, opt, group=g, **kw))
    return pair


def dp_steps(dev, counters, cfg, tcfg, group, batches, what, per_step=None, fused_block=False, **kw):
    """The single-device and the data-parallel step in turns over ``batches``
    (a device batch each): each step's loss and, after the last, every
    parameter, buffer, Adam moment and EMA bit for bit; each step timed with
    CUDA events and its peak memory read; the data-parallel steps' launches
    (``per_step`` a step, where given)."""
    pair = dp_pair(dev, cfg, tcfg, group, fused_block=fused_block, **kw)
    free_card()
    times = {"single": [], "dp": []}
    peaks = {"single": [], "dp": []}
    launches = dict.fromkeys(counters.read(), 0)
    dp_losses = []
    for i, batch in enumerate(batches):
        losses = {}
        for name in ("single", "dp"):
            state, step = pair[name]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            before = counters.read()
            start.record()
            state, m = step(state, batch)
            end.record()
            end.synchronize()
            if name == "dp":
                c = counters.read()
                launches = {k: v + c[k] - before[k] for k, v in launches.items()}
                if per_step is not None:
                    expect(counters, before, f"{what} step {i + 1}", **per_step)
            times[name].append(start.elapsed_time(end))
            peaks[name].append(torch.cuda.max_memory_allocated() / 1e9)
            losses[name] = m["loss"].detach().clone()
            require(bool(torch.isfinite(m["loss"])), f"{what} {name} step {i + 1}: loss {float(m['loss'])}")
        require(torch.equal(losses["single"], losses["dp"]),
                f"{what} step {i + 1}: loss {float(losses['dp'])} data-parallel, {float(losses['single'])} single")
        dp_losses.append(float(losses["dp"]))
    same_bits(train_state_tensors(pair["dp"][0]), train_state_tensors(pair["single"][0]), f"{what} final state")
    out = {"steps": len(batches), "step_ms": times, "peak_mem_gb": peaks, "launches": launches,
           "losses": dp_losses, "bit_for_bit": True}
    return out, pair


def allreduce_ms(state, group):
    """The flat gradient bucket of ``state``'s last step: ``average_gradients``
    (flatten, all-reduce, unflatten) and its all-reduce alone, ms each with
    CUDA events over DP_ALLREDUCE_ITERS calls (at a world of one the mean
    leaves every gradient's bits as they were)."""
    import torch.distributed as dist

    from clip_mixer_tpu_torch.parallel.train_step import average_gradients

    params = dict(state.model.named_parameters())
    flat = torch.cat([p.grad.reshape(-1) for p in params.values() if p.grad is not None])
    loss = torch.zeros((), device=flat.device)
    out = {"bucket_bytes": flat.numel() * 4,
           "average_gradients_ms": cuda_ms(lambda: average_gradients(params, loss, group), DP_ALLREDUCE_ITERS),
           "all_reduce_ms": cuda_ms(lambda: dist.all_reduce(flat, group=group), DP_ALLREDUCE_ITERS)}
    out["bucket_gb_per_s"] = out["bucket_bytes"] / (out["all_reduce_ms"] * 1e-3) / 1e9
    return out


def dp_train(dev, counters, group):
    """12a: full-width Mixer-B/32 (bf16, f32 masters, EMA, augmentation on)
    takes DP_STEPS steps at DP_B on each route through the data-parallel
    step, beside the single-device step on the same state and batches, bit
    for bit; one step each with grad_through_gather and with GradCache."""
    import dataclasses

    from clip_mixer_tpu_torch import PRESETS
    from clip_mixer_tpu_torch.config import TrainConfig
    from clip_mixer_tpu_torch.ops.augment import source_size

    base = PRESETS["mixer-b32"]
    tcfg = TrainConfig(augment=True, ema_decay=DP_EMA)
    src = dataclasses.replace(base, image_resolution=source_size(base.image_resolution))
    batches = [on_device(train_batch(src, DP_B, seed=s), dev) for s in (20, 21, 22)]
    blocks = base.vision_layers + base.text_layers
    out = {"B": DP_B, "source_hw": src.image_resolution, "ema_decay": DP_EMA}
    for route in ("plain", "fused_mlp", "fused_block"):
        cfg = base.replace(fused_mlp=route == "fused_mlp")
        # a launch a block in the forward; the backward runs the unfused chain (phase 4's count)
        per_step = {"ln_mlp": blocks if route == "fused_mlp" else 0,
                    "fused_mixer_block": blocks if route == "fused_block" else 0, "preprocess": 0}
        out[route], pair = dp_steps(dev, counters, cfg, tcfg, group, batches, f"12a {route}", per_step,
                                    fused_block=route == "fused_block")
        if route == "plain":
            out["bucket"] = allreduce_ms(pair["dp"][0], group)
        del pair
        free_card()
        log(f"phase 12a {route}: bit for bit; step ms {out[route]['step_ms']}, peak GB {out[route]['peak_mem_gb']}")
    for name, kw in (("grad_through_gather", dict(grad_through_gather=True)), ("gradcache_accum2", dict(accum_steps=2))):
        out[name], pair = dp_steps(dev, counters, base, tcfg, group, batches[:1], f"12a {name}", **kw)
        del pair
        free_card()
    out["launches"] = {k: sum(out[r]["launches"][k] for r in ("plain", "fused_mlp", "fused_block")) for k in
                       out["plain"]["launches"]}
    return out


def dp_syncbn_siglip(dev, counters, group):
    """12b: RN50 (BN drawn) takes DP_RN_STEPS steps at DP_B with SyncBN over
    the group, beside the single-device step: loss, parameters and running
    statistics bit for bit; and one SigLIP step of Mixer-B/32 through the
    ring's form of the loss, beside the single-device SigLIP step."""
    from clip_mixer_tpu_torch import PRESETS
    from clip_mixer_tpu_torch.config import SIGLIP_LOGIT_SCALE_MAX, TrainConfig

    out = {}
    cfg = PRESETS[RN_PRESET]
    batches = [on_device(train_batch(cfg, DP_B, seed=s), dev) for s in (23, 24)][:DP_RN_STEPS]
    none = dict(ln_mlp=0, fused_mixer_block=0, preprocess=0)
    out["rn50_syncbn"], pair = dp_steps(dev, counters, cfg, TrainConfig(learning_rate=VIT_TRAIN_LR), group,
                                        batches, "12b RN50 SyncBN", none)
    del pair, batches
    free_card()
    cfg = PRESETS["mixer-b32"].for_siglip()
    batch = on_device(train_batch(cfg, DP_B, seed=25), dev)
    out["siglip"], pair = dp_steps(dev, counters, cfg, TrainConfig(loss="siglip",
                                                                  logit_scale_max=SIGLIP_LOGIT_SCALE_MAX),
                                   group, [batch], "12b SigLIP", none)
    del pair, batch
    free_card()
    log(f"phase 12b: RN50 SyncBN and SigLIP bit for bit; {out}")
    return out


def dp_cli_run(root, run_name, extra, dev_log, args=None):
    """Start one ``train_cli`` process of a world of one (its own free port)
    in ``root``, with ``args`` (DP_CLI_ARGS when None): (the process, its
    start time, its heartbeat file and that file's mtime before the start,
    None where it was absent)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    argv = [sys.executable, "-m", "clip_mixer_tpu_torch.train_cli", *(DP_CLI_ARGS if args is None else args),
            *DP_CLI_DEVICE,
            "--global-batch-size", str(DP_CLI_B), "--steps-per-epoch", str(DP_CLI_STEPS),
            "--checkpoint-every", str(DP_CLI_CRASH), "--run-name", run_name,
            "--coordinator", f"127.0.0.1:{free_port()}", "--num-processes", "1", "--process-id", "0", *extra]
    hb = os.path.join(root, "outputs", run_name, "heartbeat-0")
    old = os.stat(hb).st_mtime_ns if os.path.exists(hb) else None
    t0 = time.perf_counter()
    with open(dev_log, "w") as logf:
        proc = subprocess.Popen(argv, cwd=root, env=env, stdout=logf, stderr=subprocess.STDOUT)
    return proc, t0, hb, old


def heartbeat_mtime(hb):
    try:
        return os.stat(hb).st_mtime_ns
    except FileNotFoundError:
        return None


def dp_cli_wait(proc, t0, hb, old, log_path):
    """Wait for a ``dp_cli_run`` process: its return code, seconds, the
    seconds to its loop's start (the heartbeat's first beat) and to its
    first step (the next), read from the file's mtime every 20 ms, and its
    output."""
    first, seen = {}, old
    while proc.poll() is None:
        require(time.perf_counter() - t0 < DP_CLI_TIMEOUT_S, f"train_cli passed {DP_CLI_TIMEOUT_S} s")
        mtime = heartbeat_mtime(hb)
        if mtime is not None and mtime != seen:
            seen = mtime
            first.setdefault("ready_s" if "ready_s" not in first else "first_step_s", time.perf_counter() - t0)
        time.sleep(0.02)
    with open(log_path) as f:
        text = f.read()
    return proc.returncode, time.perf_counter() - t0, first, text


def dp_cli(dev):
    """12c: ``train_cli --coordinator 127.0.0.1:<port> --num-processes 1
    --process-id 0`` (NCCL, a world of one), full-width Mixer-B/32 on the
    ``fused_mlp`` route, global batch DP_CLI_B: an uninterrupted run of
    DP_CLI_STEPS steps beside one that the drill stops after DP_CLI_CRASH
    (a checkpoint at that step), then resumed by a third process; the two
    runs' final checkpoints bit for bit."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_dp_cli_")
    out = {"argv": DP_CLI_ARGS, "B": DP_CLI_B, "steps": DP_CLI_STEPS, "crash_after": DP_CLI_CRASH}
    try:
        runs = {"straight": dp_cli_run(root, "straight", [], os.path.join(root, "straight.log")),
                "crashed": dp_cli_run(root, "resumed", ["--crash-after-steps", str(DP_CLI_CRASH)],
                                      os.path.join(root, "crashed.log"))}
        res = {k: dp_cli_wait(*runs[k], os.path.join(root, f"{k}.log")) for k in runs}
        rc, s, first, text = res["straight"]
        require(rc == 0, f"train_cli (uninterrupted) exited {rc}: {text[-3000:]}")
        out["straight"] = {"s": s, **first}
        rc, s, first, text = res["crashed"]
        require(rc != 0 and "fault injection" in text, f"the crash drill: exit {rc}: {text[-3000:]}")
        out["crashed"] = {"rc": rc, "s": s}
        rc, s, first, text = dp_cli_wait(*dp_cli_run(root, "resumed", [], os.path.join(root, "resume.log")),
                                         os.path.join(root, "resume.log"))
        require(rc == 0, f"train_cli (resumed) exited {rc}: {text[-3000:]}")
        out["resumed"] = {"s": s, **first}
        ck = {k: os.path.join(root, "outputs", r, "checkpoints") for k, r in (("straight", "straight"),
                                                                               ("resumed", "resumed"))}
        require(sorted(os.listdir(ck["resumed"])) == sorted(os.listdir(ck["straight"])),
                f"checkpoints {os.listdir(ck['resumed'])} vs {os.listdir(ck['straight'])}")
        last = str(DP_CLI_STEPS)
        for f in ("model.pt", "train_state.pt"):
            a = torch.load(os.path.join(ck["resumed"], last, f), map_location="cpu", weights_only=True)
            b = torch.load(os.path.join(ck["straight"], last, f), map_location="cpu", weights_only=True)
            if f == "train_state.pt":
                require(a["step"] == b["step"] == DP_CLI_STEPS, f"steps {a['step']} / {b['step']}")
                a = {f"{w}.{k}": v for w in ("mu", "nu") for k, v in a["opt_state"][w].items()}
                b = {f"{w}.{k}": v for w in ("mu", "nu") for k, v in b["opt_state"][w].items()}
            same_bits(a, b, f"12c resumed {f}")
        out["resume_bit_for_bit"] = True
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase 12c: {out}")
    return out


def dp_serving(dev, counters):
    """12d: full-width Mixer-B/32 (bf16, seed 0) on the fused-block and the
    fused_mlp routes behind ``InferenceEngine(devices=[the card])`` and a
    frozen ``export_servable(mesh=[the card])``, each on 256x256 sources:
    text and images bit for bit the single-device engine's (the engines
    resize with the "torch" front end, as JAX's engine takes its default
    one); the bench front end (``preprocess``, then the image tower) split
    over the mesh by ``split_over``, one ``preprocess`` launch a device
    chunk, bit for bit the single-device front end; the device bank's top-5
    the same; launches counted; the towers at DP_BUCKET timed beside the
    single-device engine's."""
    import shutil
    import tempfile

    from clip_mixer_tpu_torch import CLIP, PRESETS, aot
    from clip_mixer_tpu_torch.models.clip import l2_normalize
    from clip_mixer_tpu_torch.ops.kernels.mixer_block import route_towers
    from clip_mixer_tpu_torch.ops.preprocess import make_batch_preprocess
    from clip_mixer_tpu_torch.serving import InferenceEngine, split_over

    base = PRESETS["mixer-b32"]
    pre_kernel = make_batch_preprocess((256, 256), base.image_resolution, dtype=torch.bfloat16, backend="kernel")

    def front_end(m, x):
        return l2_normalize(m.encode_image(pre_kernel(x)))

    hw = (256, 256)
    rng = np.random.default_rng(26)
    images = rng.integers(0, 256, (DP_BUCKET, *hw, 3), dtype=np.uint8)
    bank = rng.normal(size=(DP_BANK_ROWS, base.embed_dim)).astype(np.float32)
    ids = [f"row{i}" for i in range(DP_BANK_ROWS)]
    root = tempfile.mkdtemp(prefix="chip_smoke_dp_serving_")
    out, launches = {}, dict.fromkeys(counters.read(), 0)
    try:
        for route in ("fused_block", "fused_mlp"):
            kernel = {"fused_mlp": "ln_mlp", "fused_block": "fused_mixer_block"}[route]
            model = CLIP(base.replace(fused_mlp=route == "fused_mlp"), device=dev,
                         generator=torch.Generator().manual_seed(0))
            if route == "fused_block":
                route_towers(model, True)
            single = InferenceEngine(model, batch_buckets=(DP_BUCKET,), input_hw=hw)
            meshed = InferenceEngine(model, batch_buckets=(DP_BUCKET,), input_hw=hw, devices=[dev])
            t0 = time.perf_counter()
            aot.export_servable(model, os.path.join(root, route), batch_buckets=(DP_BUCKET,), mesh=[dev],
                                input_hw=hw)
            export_s = time.perf_counter() - t0
            manifest = aot.read_manifest(os.path.join(root, route))
            require(manifest["mesh"] == {"axis_names": ["data"], "shape": [1]} and manifest["route"] == route,
                    f"12d {route} manifest: {manifest}")
            frozen = aot.load_servable(os.path.join(root, route), device=dev)
            require(len(frozen.replicas) == 1 and frozen.frozen, f"12d {route}: the mesh programs' engine")
            row = {"export_s": export_s}
            calls = [("text", 5, lambda e: e.encode_text(TEXTS[:5])),
                     ("image", 7, lambda e: e.encode_image_arrays(images[:7]))]
            for modality, n, call in calls:
                want = call(single)
                for name, eng in (("mesh_engine", meshed), ("mesh_programs", frozen)):
                    deltas = {"ln_mlp": 0, "fused_mixer_block": 0, "preprocess": 0}
                    deltas[kernel] = base.vision_layers if modality == "image" else base.text_layers
                    before = counters.read()
                    got = call(eng)
                    c = expect(counters, before, f"12d {route} {name} {modality}({n})", **deltas)
                    launches = {k: v + c[k] - before[k] for k, v in launches.items()}
                    check_features(got, n, base.embed_dim, f"12d {route} {name} {modality}")
                    require(np.array_equal(got, want), f"12d {route} {name} {modality}({n}): features differ from "
                            f"the single-device engine's (max abs {float(np.abs(got - want).max())})")
            # the bench front end over the mesh layout: a preprocess launch a device chunk
            x_img = torch.from_numpy(images).to(dev)
            mesh_front = split_over([front_end], meshed.devices)
            with torch.inference_mode():
                want = front_end(model, x_img)
                before = counters.read()
                got = mesh_front(meshed.replicas, x_img)
                c = expect(counters, before, f"12d {route} mesh front end", preprocess=len(meshed.devices),
                           **{k: base.vision_layers if k == kernel else 0 for k in ("ln_mlp", "fused_mixer_block")})
            launches = {k: v + c[k] - before[k] for k, v in launches.items()}
            require(torch.equal(got, want), f"12d {route} mesh front end: differs from the single-device one")
            row["front_end_ms"] = in_turns({"single": lambda: front_end(model, x_img),
                                            "mesh": lambda: mesh_front(meshed.replicas, x_img)})
            single.load_index(bank, ids, device=True)
            meshed.load_index(bank, ids, device=True)
            top = {k: [[r["id"] for r in row_] for row_ in e.retrieve(TEXTS[:5], top_k=5)]
                   for k, e in (("single", single), ("mesh", meshed))}
            require(top["single"] == top["mesh"], f"12d {route} device bank top-5: {top}")
            x_txt = torch.from_numpy(tokenize_texts((TEXTS * (-(-DP_BUCKET // len(TEXTS))))[:DP_BUCKET],
                                                    base.context_length)).to(dev)
            for modality, x in (("image", x_img), ("text", x_txt)):
                ways = {"single": lambda e=single: tower_call(e, modality, x),
                        "mesh_engine": lambda e=meshed: tower_call(e, modality, x),
                        "mesh_programs": lambda e=frozen: tower_call(e, modality, x)}
                row[f"{modality}_b{DP_BUCKET}_ms"] = in_turns(ways)
            out[route] = row
            log(f"phase 12d {route}: bit for bit, top-5 alike; {row}")
            del model, single, meshed, frozen, x_img, x_txt
            free_card()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = launches
    return out


def dp_path(dev, counters):
    """Phase 12: the data-parallel layer in a world of one over NCCL (the
    card's host has one card; NCCL takes no two ranks on one card), every
    part with the counters read around its own calls."""
    import torch.distributed as dist

    from clip_mixer_tpu_torch.parallel.dist import maybe_initialize_distributed
    from clip_mixer_tpu_torch.parallel.mesh import data_group, make_mesh

    t_phase = time.perf_counter()
    require(not dist.is_initialized(), "a process group is already up")
    require(maybe_initialize_distributed(dev, coordinator=f"127.0.0.1:{free_port()}", num_processes=1,
                                         process_id=0, timeout_s=300), "init_process_group")
    try:
        mesh = make_mesh(device=dev)
        group = data_group(mesh)
        out = {"backend": dist.get_backend(group), "world": dist.get_world_size(group),
               "device_count": torch.cuda.device_count()}
        log(f"phase 12: {out['backend']} world of {out['world']} on {out['device_count']} card(s)")
        out["train"] = dp_train(dev, counters, group)
        emit({"dp_train": out["train"]})
        out["syncbn_siglip"] = dp_syncbn_siglip(dev, counters, group)
        emit({"dp_syncbn_siglip": out["syncbn_siglip"]})
    finally:
        dist.destroy_process_group()
    out["cli"] = dp_cli(dev)
    out["serving"] = dp_serving(dev, counters)
    out["launches"] = {"train": out["train"]["launches"], "serving": out["serving"]["launches"]}
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---- phase 13: sharded training: FSDP2 and tensor parallelism -----------------

SHARD_B = 256  # 13a/13b's global batch (a world of one holds all of it)
SHARD_STEPS = 3  # 13a: steps on each route; steps 2-3 are timed
SHARD_TP_STEPS = 2  # 13b: steps of each model with a model group of one
SHARD_CLI_ARGS = ["--synthetic", "--preset", "mixer-b32", "--no-validators", "--epochs", "1", "--fsdp"]


def shard_steps(dev, counters, cfg, tcfg, mesh, batches, what, per_step, fused_block=False):
    """The single-device step, the data-parallel step (both with
    ``grad_through_gather``) and the FSDP step (``apply_fsdp`` over the
    mesh's data group) in turns over ``batches``,
    each on its own CLIP from seed 0: each step's loss and, after the last,
    every parameter, buffer, Adam moment and EMA entry of the FSDP step bit
    for bit the single-device step's (the FSDP state gathered whole); each
    step timed with CUDA events and its peak memory read; the FSDP steps'
    launches, ``per_step`` a step."""
    from clip_mixer_tpu_torch import CLIP
    from clip_mixer_tpu_torch.ops.kernels.mixer_block import route_towers
    from clip_mixer_tpu_torch.parallel.fsdp import apply_fsdp, gather_full, make_fsdp_train_step
    from clip_mixer_tpu_torch.parallel.mesh import data_group
    from clip_mixer_tpu_torch.parallel.train_step import init_train_state, make_train_step
    from clip_mixer_tpu_torch.train.optimizer import make_optimizer

    runs = {}
    for name in ("single", "dp", "fsdp"):
        model = CLIP(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        if fused_block:
            route_towers(model, True)
        opt = make_optimizer(tcfg, total_steps=SHARD_STEPS)
        if name == "fsdp":
            apply_fsdp(model, mesh)
            step = make_fsdp_train_step(cfg, tcfg, opt, mesh)
        else:
            # the exact global loss, as the FSDP step trains it
            step = make_train_step(cfg, tcfg, opt, grad_through_gather=True,
                                   group=data_group(mesh) if name == "dp" else None)
        runs[name] = (init_train_state(model, opt), step)
    free_card()
    times = {k: [] for k in runs}
    host = {k: [] for k in runs}
    peaks = {k: [] for k in runs}
    launches = dict.fromkeys(counters.read(), 0)
    losses = []
    for i, batch in enumerate(batches):
        got = {}
        for name, (state, step) in runs.items():
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            before = counters.read()
            start.record()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            host[name].append((time.perf_counter() - t0) * 1e3)  # the step's dispatch on the host
            end.record()
            end.synchronize()
            if name == "fsdp":
                c = expect(counters, before, f"{what} step {i + 1}", **per_step)
                launches = {k: v + c[k] - before[k] for k, v in launches.items()}
            times[name].append(start.elapsed_time(end))
            peaks[name].append(torch.cuda.max_memory_allocated() / 1e9)
            got[name] = m["loss"].detach().clone()
            require(bool(torch.isfinite(m["loss"])), f"{what} {name} step {i + 1}: loss {float(m['loss'])}")
        require(torch.equal(got["single"], got["fsdp"]),
                f"{what} step {i + 1}: loss {float(got['fsdp'])} FSDP, {float(got['single'])} single")
        losses.append(float(got["fsdp"]))
    single, fsdp = runs["single"][0], runs["fsdp"][0]
    whole = {f"model.{k}": v for k, v in gather_full(fsdp.model).items()}
    opt = fsdp.opt_state
    for w, d in (("mu", opt.mu), ("nu", opt.nu)):
        whole.update({f"{w}.{k}": v for k, v in d.items()})
    whole.update({f"ema.{k}": v for k, v in gather_full(fsdp.model, opt.ema).items()})
    same_bits(whole, train_state_tensors(single), f"{what} final state")
    sharded = [n for n, p in fsdp.model.named_parameters() if hasattr(p, "placements")]
    out = {"steps": len(batches), "step_ms": {k: v[1:] for k, v in times.items()}, "step1_ms": {k: v[0] for k, v in
           times.items()}, "host_ms": {k: v[1:] for k, v in host.items()}, "peak_mem_gb": peaks, "launches": launches, "losses": losses, "bit_for_bit": True,
           "fsdp_managed_params": len(sharded), "params": sum(1 for _ in fsdp.model.parameters())}
    del runs, single, fsdp, whole
    free_card()
    return out


def shard_fsdp(dev, counters, mesh):
    """13a: full-width Mixer-B/32 (bf16, f32 masters, EMA, augmentation on)
    takes SHARD_STEPS steps at SHARD_B on each route through the FSDP step,
    beside the single-device and the data-parallel steps, bit for bit."""
    import dataclasses

    from clip_mixer_tpu_torch import PRESETS
    from clip_mixer_tpu_torch.config import TrainConfig
    from clip_mixer_tpu_torch.ops.augment import source_size

    base = PRESETS["mixer-b32"]
    tcfg = TrainConfig(augment=True, ema_decay=DP_EMA)
    src = dataclasses.replace(base, image_resolution=source_size(base.image_resolution))
    batches = [on_device(train_batch(src, SHARD_B, seed=s), dev) for s in (30, 31, 32)]
    blocks = base.vision_layers + base.text_layers
    out = {"B": SHARD_B, "ema_decay": DP_EMA}
    for route in ("plain", "fused_mlp", "fused_block"):
        cfg = base.replace(fused_mlp=route == "fused_mlp")
        per_step = {"ln_mlp": blocks if route == "fused_mlp" else 0,
                    "fused_mixer_block": blocks if route == "fused_block" else 0, "preprocess": 0}
        out[route] = shard_steps(dev, counters, cfg, tcfg, mesh, batches, f"13a {route}", per_step,
                                 fused_block=route == "fused_block")
        log(f"phase 13a {route}: bit for bit; step ms {out[route]['step_ms']}, peak GB {out[route]['peak_mem_gb']}")
    out["launches"] = {k: sum(out[r]["launches"][k] for r in ("plain", "fused_mlp", "fused_block")) for k in
                       out["plain"]["launches"]}
    return out


def tp_pair(dev, counters, cfg, tcfg, group, batches, what):
    """SHARD_TP_STEPS steps of ``cfg`` whole and cut by ``shard_model_tp``
    over ``group`` (a model group of one), in turns: the losses and the
    final state (the slices gathered whole) against each other; the
    largest difference where they are not bit for bit."""
    from clip_mixer_tpu_torch import CLIP
    from clip_mixer_tpu_torch.parallel.tp import gather_tp, heads_of, shard_model_tp
    from clip_mixer_tpu_torch.parallel.train_step import init_train_state, make_train_step
    from clip_mixer_tpu_torch.train.optimizer import make_optimizer

    runs = {}
    for name in ("whole", "tp"):
        model = CLIP(cfg, device=dev, generator=torch.Generator().manual_seed(0))
        if name == "tp":
            shard_model_tp(model, group)
        opt = make_optimizer(tcfg, total_steps=SHARD_TP_STEPS)
        runs[name] = (init_train_state(model, opt), make_train_step(cfg, tcfg, opt))
    free_card()
    losses, times, host = {k: [] for k in runs}, {k: [] for k in runs}, {k: [] for k in runs}
    before = counters.read()
    for batch in batches:
        for name, (state, step) in runs.items():
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            host[name].append((time.perf_counter() - t0) * 1e3)
            end.record()
            end.synchronize()
            times[name].append(start.elapsed_time(end))
            losses[name].append(m["loss"].detach().clone())
    expect(counters, before, what, ln_mlp=0, fused_mixer_block=0, preprocess=0)

    def tensors(state):
        model, tp = state.model, getattr(state.model, "tp_group", None)
        out = {}
        for what_, d in (("model", model.state_dict()), ("mu", state.opt_state.mu), ("nu", state.opt_state.nu),
                         ("ema", state.opt_state.ema or {})):
            out.update({f"{what_}.{k}": gather_tp(k, v, tp, heads_of(model, k)) for k, v in d.items()})
        return out

    a, b = tensors(runs["whole"][0]), tensors(runs["tp"][0])
    diff = {k: float((a[k].float() - b[k].float()).abs().max()) for k in a if not torch.equal(a[k], b[k])}
    out = {"losses": {k: [float(x) for x in v] for k, v in losses.items()}, "step_ms": times, "host_ms": host,
           "losses_bit_for_bit": all(torch.equal(x, y) for x, y in zip(losses["whole"], losses["tp"])),
           "state_bit_for_bit": not diff, "max_abs_diff": max(diff.values(), default=0.0),
           "differing": sorted(diff, key=diff.get)[-5:]}
    del runs
    free_card()
    return out


def shard_tp(dev, counters, mesh):
    """13b: the tensor-parallel code on the card with a model group of one:
    full-width Mixer-B/32 (the plain route) and ViT-B/32 (head-split
    attention), SHARD_TP_STEPS steps each, bit for bit the whole model's.
    A group of one runs the collectives on one rank: what they move across
    cards is not measured here."""
    from clip_mixer_tpu_torch import PRESETS
    from clip_mixer_tpu_torch.config import TrainConfig
    from clip_mixer_tpu_torch.parallel.mesh import MODEL_AXIS

    group = mesh.get_group(MODEL_AXIS)
    out = {"model_group_size": torch.distributed.get_world_size(group)}
    for name, preset, tcfg in (("mixer_b32", "mixer-b32", TrainConfig(ema_decay=DP_EMA)),
                               ("vit_b32", VIT_PRESET, TrainConfig(learning_rate=VIT_TRAIN_LR, ema_decay=DP_EMA))):
        cfg = PRESETS[preset]
        batches = [on_device(train_batch(cfg, SHARD_B, seed=s), dev) for s in (33, 34)][:SHARD_TP_STEPS]
        out[name] = tp_pair(dev, counters, cfg, tcfg, group, batches, f"13b {name}")
        log(f"phase 13b {name}: {out[name]}")
        require(out[name]["losses_bit_for_bit"] and out[name]["state_bit_for_bit"],
                f"13b {name}: not bit for bit, largest difference {out[name]['max_abs_diff']} at "
                f"{out[name]['differing']}")
    return out


def shard_cli(dev):
    """13c: ``train_cli --fsdp`` (full-width Mixer-B/32, a world of one over
    NCCL, global batch DP_CLI_B): DP_CLI_STEPS steps straight, beside a run
    the drill stops after its checkpoint at step DP_CLI_CRASH, resumed by a
    third process; the two runs' last sharded checkpoints (``shard-0.pt``:
    the parameters, Adam's moments, the step) bit for bit; seconds to the
    first step."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_shard_cli_")
    out = {"argv": SHARD_CLI_ARGS, "B": DP_CLI_B, "steps": DP_CLI_STEPS, "crash_after": DP_CLI_CRASH}
    try:
        runs = {"straight": dp_cli_run(root, "straight", [], os.path.join(root, "straight.log"), SHARD_CLI_ARGS),
                "crashed": dp_cli_run(root, "resumed", ["--crash-after-steps", str(DP_CLI_CRASH)],
                                      os.path.join(root, "crashed.log"), SHARD_CLI_ARGS)}
        res = {k: dp_cli_wait(*runs[k], os.path.join(root, f"{k}.log")) for k in runs}
        rc, s, first, text = res["straight"]
        require(rc == 0, f"train_cli --fsdp (uninterrupted) exited {rc}: {text[-3000:]}")
        out["straight"] = {"s": s, **first}
        rc, s, first, text = res["crashed"]
        require(rc != 0 and "fault injection" in text, f"the crash drill: exit {rc}: {text[-3000:]}")
        out["crashed"] = {"rc": rc, "s": s}
        rc, s, first, text = dp_cli_wait(*dp_cli_run(root, "resumed", [], os.path.join(root, "resume.log"),
                                                     SHARD_CLI_ARGS), os.path.join(root, "resume.log"))
        require(rc == 0, f"train_cli --fsdp (resumed) exited {rc}: {text[-3000:]}")
        out["resumed"] = {"s": s, **first}
        last = os.path.join("checkpoints", str(DP_CLI_STEPS))
        files = sorted(os.listdir(os.path.join(root, "outputs", "straight", last)))
        require(files == ["layout.json", "meta.json", "shard-0.pt"], f"13c checkpoint files {files}")
        a, b = (torch.load(os.path.join(root, "outputs", r, last, "shard-0.pt"), map_location="cpu",
                           weights_only=True) for r in ("resumed", "straight"))
        require(a["step"] == b["step"] == DP_CLI_STEPS, f"steps {a['step']} / {b['step']}")
        flat = [{**{f"model.{k}": v for k, v in x["model"].items()},
                 **{f"{w}.{k}": v for w in ("mu", "nu") for k, v in x["opt_state"][w].items()}} for x in (a, b)]
        same_bits(*flat, "13c resumed shard-0.pt")
        with open(os.path.join(root, "outputs", "straight", last, "layout.json")) as f:
            lay = json.load(f)
        out["layout"] = {k: lay[k] for k in ("world", "n_data", "n_model", "fsdp")}
        out["resume_bit_for_bit"] = True
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"phase 13c: {out}")
    return out


def shard_path(dev, counters):
    """Phase 13: FSDP2 and tensor parallelism in a world of one over NCCL,
    every part with the counters read around its own calls."""
    import inspect

    import torch.distributed as dist
    from torch.distributed.fsdp import fully_shard

    from clip_mixer_tpu_torch.parallel.dist import maybe_initialize_distributed
    from clip_mixer_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    log(f"phase 13: fully_shard{inspect.signature(fully_shard)}")
    require(not dist.is_initialized(), "a process group is already up")
    require(maybe_initialize_distributed(dev, coordinator=f"127.0.0.1:{free_port()}", num_processes=1,
                                         process_id=0, timeout_s=300), "init_process_group")
    try:
        mesh = make_mesh(n_data=1, n_model=1, device=dev)
        out = {"backend": dist.get_backend(), "world": dist.get_world_size(),
               "fully_shard": str(inspect.signature(fully_shard))}
        out["fsdp"] = shard_fsdp(dev, counters, mesh)
        emit({"shard_fsdp": out["fsdp"]})
        out["tp"] = shard_tp(dev, counters, mesh)
        emit({"shard_tp": out["tp"]})
    finally:
        dist.destroy_process_group()
    out["cli"] = shard_cli(dev)
    out["launches"] = out["fsdp"]["launches"]
    out["phase_s"] = time.perf_counter() - t_phase
    return out



def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from clip_mixer_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the validators' remote datasets: skip without a DNS probe, here and in every subprocess
    os.environ["CLIP_MIXER_OFFLINE"] = "1"
    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    t_run = time.perf_counter()

    t0 = time.perf_counter()
    _build.build(_build.all_sources())
    build_s = time.perf_counter() - t0
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "wgmma", "setmaxnreg")) or "error" in line.lower():
                log(f"ptxas {name}: {line.strip()}")
    log(f"built {_build.all_sources()} in {build_s:.1f} s")
    tokenizer_build = tokenizer_build_times()
    log(f"built the C++ tokenizer: {tokenizer_build}")

    ln_cases = check_ln_mlp(dev)
    pre_cases = check_preprocess(dev)
    block_cases = check_mixer_block(dev)
    check_token_mix(block_cases)
    check_gradients(dev)
    check_small_model(dev)
    torch.cuda.synchronize()

    counters = Counters()
    summary, launches = main_path(dev, counters)
    for name in ("ln_mlp", "preprocess"):
        require(launches[name] > 0, f"the main path never launched {name}")
    summary["build_s"] = build_s
    emit({"main_path": summary})

    block_summary, block_launches, model = fused_block_path(dev, counters)
    for name in ("fused_mixer_block", "preprocess"):
        require(block_launches[name] > 0, f"the fused-block path never launched {name}")
    emit({"fused_block_path": block_summary})

    emit({"towers_bucket128_ms": time_towers(model, dev)})
    del model
    # each kernel's launches on the path that carries it
    path_launches = {"ln_mlp": launches["ln_mlp"], "preprocess": launches["preprocess"],
                     "fused_mixer_block": block_launches["fused_mixer_block"]}
    kernels = time_kernels(ln_cases, pre_cases, block_cases, path_launches)

    train = train_path(dev, counters)
    emit({"train": train})
    trainer = trainer_path(dev, counters)
    emit({"trainer": trainer})
    int8 = int8_path(dev, counters)
    emit({"int8_serving": int8})
    vit = vit_path(dev, counters)
    emit({"vit": vit})
    for row in kernels:  # each kernel's launches in the train phase's 8 steps on its route, and in the trainer's run A
        row["train_launches"] = {r: train[r]["launches"][row["name"]] for r in ("plain", "fused_mlp", "fused_block")}
        row["train_launches"]["trainer"] = trainer["launches"][row["name"]]
        row["int8_launches"] = int8["launches"][row["name"]]
        row["vit_launches"] = {k: v[row["name"]] for k, v in vit["launches"].items()}
    require(all(vit["launches"][k]["preprocess"] > 0 for k in ("vit_b32_serving", "vit_l14")),
            "the ViT serving paths never launched preprocess")
    rn = rn_path(dev, counters)
    emit({"resnet": rn})
    require(rn["launches"]["rn50_serving"]["preprocess"] > 0, "the RN50 serving path never launched preprocess")
    for row in kernels:  # each kernel's launches in phase 8's parts
        row["rn_launches"] = {k: v[row["name"]] for k, v in rn["launches"].items()}
    load_cli = load_cli_path(dev, counters, text_int8=int8["gates"]["text"]["passed"])
    emit({"load_cli": load_cli})
    if load_cli["expected_ln_mlp"]:
        require(load_cli["launches"]["ln_mlp"] > 0, "the serving CLI's requests never launched ln_mlp")
    for row in kernels:  # each kernel's launches over phase 9d's requests through the CLI
        row["cli_launches"] = load_cli["launches"][row["name"]]
    evals = eval_path(dev, counters)
    emit({"evals": evals})
    for row in kernels:  # each kernel's launches in phase 10's parts
        row["eval_launches"] = {k: v[row["name"]] for k, v in evals["launches"].items()}
    frozen = frozen_path(dev, counters, tokenizer_build)
    emit({"frozen_tokenizer": frozen["tokenizer"]})
    require(frozen["launches"]["fused_mlp"]["ln_mlp"] > 0, "the fused_mlp programs never launched ln_mlp")
    require(frozen["launches"]["fused_block"]["fused_mixer_block"] > 0,
            "the fused-block programs never launched fused_mixer_block")
    for row in kernels:  # each kernel's launches by the frozen programs of phase 11, added to the path's
        row["frozen_launches"] = {k: v[row["name"]] for k, v in frozen["launches"].items()}
        row["launches"] += sum(row["frozen_launches"].values())
    dp = dp_path(dev, counters)
    emit({"dp": {k: v for k, v in dp.items() if k not in ("train", "syncbn_siglip")}})
    for part, names in (("train", ("ln_mlp", "fused_mixer_block")), ("serving", ("ln_mlp", "fused_mixer_block",
                                                                                 "preprocess"))):
        for name in names:
            require(dp["launches"][part][name] > 0, f"phase 12 {part} never launched {name}")
    for row in kernels:  # each kernel's launches in phase 12's data-parallel steps and mesh serving, added
        row["dp_launches"] = {part: dp["launches"][part][row["name"]] for part in ("train", "serving")}
        row["launches"] += sum(row["dp_launches"].values())
    shard = shard_path(dev, counters)
    emit({"shard": {k: v for k, v in shard.items() if k not in ("fsdp", "tp")}})
    for name in ("ln_mlp", "fused_mixer_block"):
        require(shard["launches"][name] > 0, f"phase 13's FSDP steps never launched {name}")
    for row in kernels:  # each kernel's launches in phase 13's FSDP steps, added
        row["shard_launches"] = shard["launches"][row["name"]]
        row["launches"] += row["shard_launches"]
    emit({"run_s": time.perf_counter() - t_run, "load_cli_s": load_cli["phase_s"], "eval_s": evals["phase_s"],
          "frozen_s": frozen["phase_s"], "dp_s": dp["phase_s"], "shard_s": shard["phase_s"]})
    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
