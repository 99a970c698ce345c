#!/usr/bin/env python3
"""Smoke run of the edtr_torch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failed check raises, so the script exits non-zero and prints
no result line):

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. build the hand-written kernels, one ``nvcc`` per source, started
   together: ``edtr_torch/csrc/{flash_attention,flash_attention_bwd,gn_conv,
   ln_matmul,geglu,window_attention,swin_block}.cu`` (ptxas register, spill
   and wgmma-serialisation lines printed);
3. each flash kernel against its plain PyTorch version at the 512² bs-1
   main-path shapes, in bf16: O and lse errors, two calls bit-identical,
   kernel / plain / SDPA (``library_ms``, a yardstick the port never calls)
   device times from a trace (CUDA-event times beside them) and the bound;
   then each flash backward kernel against ``plain_bwd`` at the training
   step's shapes (bs 2), as ``proj_bench.py --flash-bwd`` holds them: dq,
   dk, dv errors, two calls bit-identical, kernel / plain / SDPA's backward
   alone (``library_ms``) device times from a trace (CUDA-event times
   beside them) and the bound;
4. the full-width EDTR-s4 ``EDTRPipeline.restore`` at 512², bs 1, bf16,
   seeded random weights, the empty prompt's CLIP embedding computed by
   the restore (``c_txt=None``; its ``text`` stage, the OpenCLIP ViT-H
   text tower), in four configurations on the same weights, input and
   noise: stock (the pipeline's ``fused_conv``, ``fused_proj``
   and ``fused_swin`` False), fused (the gn_conv kernels), fused+proj (also
   the projection kernels) and fused+swin (the gn_conv and Swin kernels,
   the projections as ``pipeline.FUSED_PROJ_DEFAULT``). Each is counted
   once (launch counts set to 0 just before it, read just after, and held
   to their exact values; no layout copies in the fused ones), the fused
   outputs are held against the stock ones, then the stage times and
   end-to-end ms/img of all four, in turns, 9 rounds, then 8 more of
   fused and fused+proj alone (the pairs won: stock vs fused against
   ``pipeline.FUSED_CONV_DEFAULT`` over 9 pairs, fused vs fused+proj
   against ``FUSED_PROJ_DEFAULT`` over 17, and fused vs fused+swin over 9
   on the ``swinir`` stage, the only one the switch changes, against
   ``FUSED_SWIN_DEFAULT``),
   and a ``torch.profiler`` trace of each (device-busy ms, idle share,
   host-to-device copies, none allowed in the ``swinir`` stage, kernel
   families);
5. each conv kernel against its plain version at every shape the fused
   restore launched it with: errors, kernel / plain / ``F.conv2d``
   (``library_ms``: the cuDNN conv alone, on the activated or upsampled
   bf16 input, never called by the fused path) device times from a trace
   (CUDA-event times beside them) and the bound; the restore's K5 shapes
   must be the ones ``proj_bench.py`` pins;
6. each projection kernel against its plain version at every shape the
   fused+proj restore launched it with (and ``geglu_proj``, which it does
   not launch, at the flagship's three token levels, :data:`GEGLU_HELD`):
   errors, two calls bit-identical, device times of kernel / plain /
   ``F.linear`` (``library_ms``: the cuBLAS GEMM alone on the
   already-normalised bf16 tokens, never called by the port) and the bound;
7. each Swin kernel (window attention, swin_pre, swin_post) against its
   plain version at every shape the fused+swin restore launched it with
   (the swin_pre shapes must be the ones ``proj_bench.py`` pins):
   errors, two calls bit-identical (the window attention at bs 2 also on a
   random mask of the same period, each window's row w mod nW), device
   times of kernel / plain /
   library (``library_ms``, never
   called by the port: SDPA with the bias and mask as one additive mask;
   the ``F.linear`` GEMMs on already-normalised bf16 tokens) and the bound;
8. the GroupNorm statistics at every shape of the fused restore, in
   channels-last memory and on an NCHW copy: equal, and device ms of each;
   the text tower alone on the empty prompt: bf16 against fp32 on the same
   weights, no port-kernel launch, host ms (median of 9), device-busy ms,
   kernels and host-to-device copies from a trace of 2;
9. one full-width ControlLDM eps forward (on the empty prompt's embedding) through the flash kernels and
   through the plain attention (test hook), and fused and fused+proj
   against stock;
10. restore then detect, as ``bench.py:_run_split`` runs it: the restore in
   the pipeline's default configuration (bs 1, 512²), clamped to [0, 1],
   then the Faster R-CNN MobileNetV3-Large-FPN detector (21 classes, bf16,
   seeded random weights, the heads scaled on the restored image:
   ``faster_rcnn.calibrate_heads_``) at 800²: its parameter count; one
   restore+detect counted (exact launches of the restore's kernels; the
   detector launches none of the port's: its box ops, RoIAlign, convs and
   GEMMs are stock PyTorch, as JAX leaves them to XLA), its NMS calls and
   host synchronisations, its detections checked (valid ones, scores,
   labels, boxes in the image); the bf16 detector against the fp32 one on
   the same image (FPN maps, objectness, deltas, class logits at the bf16
   run's proposals); the stage split swinir / vae_encode / text / scan /
   decode+wavelet / detect over 9 rounds with the restore+detect ms/img,
   and a trace of 2 (device-busy ms, idle share, kernels; no host-to-device
   copy in the ``swinir`` and ``detect`` stages); one detect call at
   ``bench.py``'s batch of 8: ms and peak memory;
11. restore then segment, built from ``configs/seg/voc2012/test/
   007_edtr-s4.yaml`` (``load_config``, ``build_pipeline_from_config``: its
   parameter names and shapes those of ``build_flagship()``, whose weights
   it takes; ``instantiate_from_config`` of its ``segnet``:
   DeepLabV3-MobileNetV3-Large, 21 classes, no auxiliary head, seeded
   weights calibrated on the input, :func:`task_net`, its logits moving
   with the input, :func:`input_sensitivity`), bf16, 512², the config's
   batch of 1: one run counted (exact
   launches, no layout copies), the logits' shape, the bf16 net against
   an fp32 one on the same restored image, the restored image against the
   stock configuration, every kernel the run launched held against its
   plain version at its shapes (untimed), the stage split over
   :data:`TASK_ROUNDS` rounds and a trace (no host-to-device copy in
   ``swinir`` or ``segment``); the confusion matrix and IoU of its
   argmax against seeded masks (``edtr_torch.utils.metrics``) on the card,
   equal to the CPU's;
12. restore then classify, the same from ``configs/cls/cub200/test/
   007_edtr-s4.yaml`` (ResNet-18, 200 classes) at the config's batch of 8:
   the restore's kernels at bs-8 shapes; its top-1 and top-5 counts
   against seeded labels on the card, equal to the CPU's;
13. the full-width EDTR-s4 training step (``build_flagship(train=True)``,
   ``EDTRTrainState``, ``make_edtr_train_step``; the restore's pipeline is
   freed first) at 512², bs 2, bf16 compute, seeded weights, batch, t and
   noise: one step's gradients on the kernel path, in the pipeline's
   configuration and again with ``fused_proj`` on (the projection
   kernels' autograd Functions; counted: exact launches of K8a, K8b and
   K7b in the forward and the remat recompute), against the plain path
   (plain attention, stock convs, stock SwinIR, stock projections) on the
   same weights, the ControlNet's and the decoder's each within the limit;
   one step counted
   (exact launches of every kernel, the remat recomputes and the backward
   kernels included; the shapes each kernel was launched with), loss and
   gradients finite; 2 warm-up and 3 timed ``step(...)`` calls; peak
   memory; a traced step, whose ranges (set inside the step) split it into
   forward+loss / backward / optimizer; then every trainable parameter
   moved and every frozen one bit-identical;
14. on the same pipeline, the step with a detector: student and teacher
   Faster R-CNN MobileNetV3-Large-FPN (21 classes, bf16, no named weights
   so ``norm_frozen`` False; the teacher a copy of the student, both
   randomised and calibrated as ``detector_pair`` does), a batch of seeded
   coloured boxes on noise (gt; lq a noisier copy) with their boxes as
   targets (up to 8 an image, sides 32-256 px inside 512², labels 1-20, a
   slot padded at least), ``cast_frozen_bf16`` on (frozen bytes before
   and after). Kernel path against plain path on the same weights, batch
   and draws (:func:`step_kernel_vs_plain`): the EDTR half's ControlNet
   and decoder gradients for the plain path's cotangent of its restored
   image under the step's HLF, and the task-net half's walk image, each
   within the limit; printed: the same for the pixel L1's cotangent, the
   step's own gradients, and each of these for the plain path run again
   and computing in fp32 (the control).
   One step counted (exact launches ``TRAIN_LAUNCHES_DET``), its losses
   finite; 2 warm-up and 3 timed steps; a traced step split into
   forward+loss / sample / backward / optimizer; peak memory; then the
   ControlNet, decoder and trainable detnet tensors moved, the frozen
   detnet stages bit-identical while their BatchNorm running statistics
   moved, the teacher and every frozen pipeline tensor bit-identical;
15. on phase 13's seeded weights, the generic step of each task, built
   from its train config (``configs/{seg/voc2012,cls/cub200}/train/
   007_edtr-s4.yaml`` through ``build_pipeline_from_config``, parameter
   names and shapes those of ``build_flagship(train=True)``): the config's
   student and teacher (DeepLabV3-MobileNetV3-Large, 21 classes;
   ResNet-18, 200 classes; bf16, seeded weights of their own calibrated
   on gt, the student's logits moving with the input), the config's
   learning rates and loss weights, ``cast_frozen_bf16``, 512², bs 2,
   seeded masks with 255 borders or labels: kernel path against plain
   path as phase 14 holds it (gated: the HLF's cotangent, the walk's
   image; printed: the rest and the fp32 control); one step
   counted (exact launches, those of the detector step), losses finite;
   step ms (median of 3), a traced step's split, peak memory; the
   ControlNet, decoder and task-net tensors moved, the student's running
   statistics moved, the teacher and the frozen pipeline bit-identical;
16. the training recipes of ``configs/seg/voc2012/train`` (JAX's
   ``runner.task_train`` and ``diffbir_train``; ``edtr_torch.train.
   recipes``) on phase 13's seeded weights, each from its config's keys
   (learning rates, ``pix_weight``, ``weight_ce``, ``weight_fm``,
   ``train_steps``), its seg net DeepLabV3-MobileNetV3-Large (21 classes,
   bf16, seeded weights calibrated on gt), seeded batches at 512², masks
   with 255 borders. Each recipe phase: one warm-up step, one counted
   (exact launches, derived from :data:`RECIPE_PASSES`; peak memory), 3
   timed (median) and one traced (its ranges ``RECIPE_STAGES``,
   device-busy ms and kernels of the step, no host-to-device copy in it);
   losses finite; the tensors that train moved, the frozen ones
   bit-identical. Gradients, kernel path against plain path on the same
   weights, batch and draws, with the control (the plain path again and
   computing in fp32): gated at :data:`TOL_GRAD_REL`, or where the plain
   path in bf16 is itself farther than that from fp32, the kernel path no
   farther from fp32 than :data:`TOL_CONTROL_RATIO` times the plain path
   (:func:`gate_rule`). SwinIR pre-training (``002_swinir-pre.yaml``, bs 4
   of the config's 48): the full-width SwinIR with a gradient (K9, K10a,
   K10b, K6 with LeakyReLU forward, their backward JAX's recompute),
   AdamW without decay; its gradients gated over the whole SwinIR, each
   RSTB's printed; every kernel held against its plain version at the
   step's bs-4 shapes;
17. SR4IR (``004_swinir-sr4ir.yaml``, bs 2 of 16; the task half on 6
   images, the CutMix cells seeded): the SwinIR half's gradients gated as
   phase 16's, the task half's reported; the running statistics moved;
18. the seg net trained on the frozen SwinIR (``003_swinir.yaml``, bs 2):
   the Swin kernels and the tail's upsample launched as in a bs-2
   restore's ``swinir`` stage, under no grad;
19. DiffBIR (``005_diffbir.yaml`` through ``build_pipeline_from_config``,
   the flagship's parameters, ``cast_frozen_bf16``, bs 2, student and
   teacher seg nets): ``p_losses`` at seeded t and noise on gt's posterior
   sample trains the ControlNet (its gradient gated as phase 16's), then
   the 25-step walk from pure noise on 1 image (the recipe's 50 cut for
   time), decode, wavelet fix, and
   the seg net's CE + feature matching on ``[restored ; gt[1:]]``; the
   walk's image, kernel vs plain and the fp32 control, reported; exact
   launches (K1/K2 x 7 a walk step x 25, the K11 backward, K3 in the two
   bs-2 encodes and the bs-1 decode);
20. ``make_edtr_sample_fn``, the evaluation loops' entry point, on
   DiffBIR's pipeline at 512², bs 1: counted (the restore's launches),
   its image NHWC, finite, and ``restore``'s on the same draws (it returns
   that; ``tests/test_torch_sampler.py`` holds it against JAX's);
21. each forward kernel of the training step (flash, conv, Swin; the
   projection kernels of the fused_proj step) against its plain version at
   every bs-2 shape the counted steps launched it with, as phases 3, 5, 6
   and 7 hold them at the restore's shapes; the step's backward shapes must
   be those phase 3 held;
22. (run after phase 12, on ``configs/det/demo.yaml`` through
   ``build_pipeline_from_config`` with the flagship's weights) restore then
   detect with the config's ResNet50-FPN-v2 (COCO's 91 classes, bf16,
   seeded weights, heads calibrated on the restored image) at 512², bs 1:
   one run counted (exact launches, the restore's), its NMS calls and host
   synchronisations, bf16 against fp32 on the five FPN maps (gated) and the
   heads (reported), a trace (the detect stage's device ms and kernels; no
   host-to-device copy in ``swinir`` or ``detect``);
23. the real-world demo (``edtr_torch.demo.restore_and_detect``) at
   ``--scale 1`` on a seeded 768 x 1024 image, untiled, ``resize``
   detection: one run counted, its launches exact as :func:`demo_launches`
   derives them from JAX's dispatch (K4, ``flash_fwd``, on its first path:
   the 12288-token level), peak memory, 3 timed calls, a trace (each
   stage's host and busy ms, idle share, kernels; no host-to-device copy
   but ``text``'s token ids), every kernel held against its plain version
   at every shape the run launched it with, K3 timed at its 12288-token
   shape (kernel / plain / SDPA device ms, the bound; phase 3 times K4 at
   its own, this path's);
24. the same all tiled with the demo's default tiles (SwinIR 512 / 256,
   encoder 256, decoder 256 shrunk to the latent, latent 512 / 256
   pixels) and ``tile`` detection: exact launches over the tile plans
   (:func:`tile_counts`), held shapes, timing and trace as phase 23; the
   kernel route against the plain route of the whole tiled demo (gated),
   the tiled VAE against the untiled one with and without the GroupNorm
   sync (reported);
25. LPIPS (AlexNet, random weights written to a temporary ``lpips`` state
   dict) through ``calculate_lpips`` on the card against the CPU;
26. (run after phase 15) the two-half step with the ResNet50-FPN-v2, built
   from ``configs/det/coco/train/001_edtr-s4-r50.yaml`` (its learning rates
   and loss weights; student and teacher from their nodes, drawn apart),
   bs 2 (the config's 16 cut for time and memory), 512²: gated kernel vs
   plain as phase 14; one step counted (exact launches, K11 included),
   losses finite; step ms (median of 3), busy ms and kernels of a traced
   step, peak memory; the trainable tensors moved, ``conv1``, ``bn1`` and
   ``layer1`` bit-identical with their running statistics moved, the FPN's
   and box head's running statistics moved, the teacher unchanged;
27. (run after phase 16's recipes but DiffBIR) the training data path of
   ``configs/det/coco/train/100_swinir-pre-v2.yaml`` on a synthetic COCO
   tree (``edtr_torch.data.synthetic``: 40 images of 480-640 px with
   coloured boxes, only ``root`` overridden): its
   ``DegradedDetectionDatasetCocov2``, ``make_dataloader`` (the config's
   aspect-ratio groups and seed) and ``RealESRGANBatchTransform`` on the
   card; one batch of the config's 32 loaded (host ms), ``prepare_batch``
   timed (median of 3) and traced (busy ms, kernels, host-to-device
   copies, no device-to-host copy), and run once under
   ``torch.cuda.set_sync_debug_mode("error")`` (no call in it may wait for
   the card: no device-to-host copy, no synchronisation); the batch the steps take recorded
   stage by stage and each stage recomputed on the CPU for its first 2
   images on the card's inputs and draws (:data:`TOL_DATA_STAGE`; JPEG
   blocks whose coefficients flip at a rounding tie left out; GT at 1e-6,
   LQ equal but one-level flips at ties); GT and LQ finite in [0, 1], LQ
   away from GT; USM's, a 21 x 21 blur's and the resize products' device
   ms at bs 32; then 3 SwinIR-pre steps from the config (full width, 8 RSTB
   x 6, C 180, AdamW) on that batch: the first counted (exact launches of
   K6, K9, K10a, K10b), step ms, losses finite, peak memory, every kernel
   held at its bs-32 shapes;
28. (run after phase 12) the evaluation path: a synthetic VOC tree (8
   images with XML annotations, ``ImageSets/Main``), degraded by
   ``edtr_torch.data.val_data_generation.generate`` from
   ``configs/det/voc2012/train/002_swinir-pre.yaml``'s dataset (seed 231),
   loaded by ``configs/det/voc2012/test/007_edtr-s4.yaml``'s
   ``PairedDetectionDataset``; each image padded to 512² by
   ``list_to_batch``, restored by ``make_edtr_sample_fn`` on the config's
   pipeline (the flagship's seeded weights) and detected by the config's
   detector (seeded, calibrated on the first restored image), as JAX's
   ``runner.edtr_eval`` composes them; the 8 counted (exact launches, 8
   restores' counts); PSNR and the 12 COCO stats of ``CocoEvaluator`` over
   ``gt_from_dataset`` (near 0 on random weights);
29. (run after phase 27) the entry points, in process through
   ``edtr_torch.cli.main`` as ``python -m edtr_torch.cli`` runs them: a
   synthetic VOC tree of 16 VOC-sized images (333-500 px), its val split
   the first 4, and that split's det and seg pairs (``val_data_generation``
   on the config's degradation); copies of the flagship det
   train and test configs (``007_edtr-s4``) and the seg SwinIR test config,
   only the dataset roots, the experiment directories, ``accum_steps: 8``
   (the train config's global batch of 16 as 8 microbatches of 2) and the
   test copy's ``resume_*`` (the training run's ``_last.pt`` files)
   changed, each change printed, ``sd_path`` left pointing at no file, so
   the weights are seeded. ``det train_edtr --debug``: 2 steps, each
   logged, saved (the four submodules and the whole train state), a grid
   and a 2-image restore+detect validation; a resumed run (``resume_state``,
   ``train_steps: 3``): the train state loaded back bit for bit, one step;
   ``det test_edtr --debug --save-img --calc-fd``: 4 images, PSNR, the COCO
   stats, the feature distance, 4 PNGs, image 0's detections equal to a
   direct restore + detect on the same input and generator; ``seg
   test_swinir --debug``: 2 images at full width. Each run counted (exact
   launches, :func:`runner_launches`), its wall seconds, peak GiB and the
   bytes it wrote; the directory removed;
30. a ``{"kernels": [...]}`` line with every ported kernel (launches: the
   most of any counted path, restore+detect, the bs-8 restore+classify,
   the training steps, the recipes, the demo, the data paths and the
   runner's runs among them), then the result line.

Every device time comes from :func:`device_ms`, which takes a trace only
with each launch's kernel in it and times a call by CUDA events, naming it
in the output's ``device_ms_traces``, where five traces lost kernels.

Needs one CUDA card and ``nvcc`` (``CUDA_HOME``); imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# proj_bench's functions, which this script calls, import chip_smoke: run as
# a script, this module is __main__, so name it chip_smoke too, or they
# would load a second copy with its own TRACE_STATS
sys.modules.setdefault("chip_smoke", sys.modules[__name__])

import proj_bench

# NVIDIA H100 SXM data-sheet peaks at the full 700 W: dense bf16 tensor
# core FLOP/s and HBM3 bytes/s
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

FA_BWD_SOURCE = "edtr_torch/csrc/flash_bwd_wgmma.cuh"
CONV_SOURCE = "edtr_torch/csrc/gn_conv.cu"
SOURCES = ("flash_attention", "flash_attention_bwd", "gn_conv", "ln_matmul", "geglu",
           "window_attention", "swin_block")
FA_WGMMA_SOURCE = "edtr_torch/csrc/flash_wgmma.cuh"
FA_STREAMKV_SOURCE = "edtr_torch/csrc/flash_streamkv.cuh"
# wrapper -> (flat (BH, N, D) at 512² bs 1, the TPU kernel it replaces,
#             launches in one 512² restore (None: not on that path), source)
KERNELS = {
    "wholekv_fwd": ((5, 4096, 64), "edtr_tpu/ops/flash_attention.py:181", 28, FA_WGMMA_SOURCE),
    "whole_fwd": ((10, 1024, 64), "edtr_tpu/ops/flash_attention.py:352", 28, FA_WGMMA_SOURCE),
    "streamkv_fwd": ((1, 4096, 512), "edtr_tpu/ops/flash_attention.py:264", 2,
                     FA_STREAMKV_SOURCE),
    # N > 4096: not run at 512²; timed at its first path's shape, the demo's
    # 768 x 1024 level 0 (12288 tokens, 5 heads)
    "flash_fwd": ((5, 12288, 64), "edtr_tpu/ops/flash_attention.py:123", None,
                  FA_WGMMA_SOURCE),
}
# flash backward wrapper -> (flat (BH, N, D) in the 512² bs-2 training step,
# the TPU kernel it replaces, launches per step): the backward reaches every
# ControlNet self-attention and the UNet's output blocks (its input blocks
# and middle block see no gradient: frozen weights on a no-grad latent), 2 +
# 3 at 1024 tokens and 2 + 3 at 4096; the VAE decoder's D = 512 attention
# takes plain_bwd, as JAX's _xla_bwd_flat
BWD_KERNELS = {
    "whole_bwd": ((20, 1024, 64), "edtr_tpu/ops/flash_attention.py:369", 5),
    "flash_bwd_dq": ((10, 4096, 64), "edtr_tpu/ops/flash_attention.py:391", 5),
    "flash_bwd_dkv": ((10, 4096, 64), "edtr_tpu/ops/flash_attention.py:413", 5),
}
TRAIN_BATCH = 2
# launches of every kernel in one training step (fused_conv, the Swin
# kernels on, fused_proj off: the pipeline's defaults). Forward: K1/K2 at
# 4096/1024 tokens in ControlNet 2 + UNet 2 + 3 self-attentions each, then
# the ControlNet's and the UNet output blocks' remat recomputes (2 + 3); K3 in
# the VAE encoder and decoder (the decoder's attention is not remat'd). K5:
# the forward of the VAE encoder's 10, the ControlNet's 10, the UNet's 22
# and the decoder's 14 ResBlocks x 2 halves, then the recomputes of the
# ControlNet's 10, the UNet output blocks' 12 and the decoder's 14 (x 2);
# those at the 8² latent level (ControlNet 4 + 4 recomputed, UNet 7 + 3)
# take the whole-image tier. K6: SwinIR tail 3,
# UNet 3, decoder 3 (not remat'd). The Swin kernels as in a restore (SwinIR
# runs once, under no grad). The backward kernels as BWD_KERNELS.
TRAIN_LAUNCHES = {
    "wholekv_fwd": 12, "whole_fwd": 12, "streamkv_fwd": 2, "flash_fwd": 0,
    "gn_conv_whole": 36, "gn_conv_band": 148, "upsample_conv": 9,
    "ln_matmuls": 0, "affine_matmul": 0, "geglu_proj": 0, "ln_geglu_proj": 0,
    "window_attention": 48, "swin_pre": 48, "swin_post": 48,
    **{name: n for name, (_, _, n) in BWD_KERNELS.items()},
}
# the same step with fused_proj on: every transformer block at >= 256
# tokens (ControlNet 2 + UNet 5 at each of 4096, 1024 and 256 tokens in the
# forward, the ControlNet's 2 and the UNet output blocks' 3 again in the
# remat recompute: 21 + 15 = 36 blocks) runs one affine_matmul, two
# ln_matmuls (q/k/v, query) and one ln_geglu_proj through the autograd
# Functions, whose backward recomputes the plain versions
TRAIN_LAUNCHES_PROJ = {**TRAIN_LAUNCHES, "ln_matmuls": 72, "affine_matmul": 36,
                       "ln_geglu_proj": 36}
# the step with a detector adds, after the EDTR half, the task-net half's
# no-grad walk at bs 1 (bs2 = max(bs // 2, 1)): 4 steps of ControlNet + UNet
# (K1, K2: 7 self-attentions each a step; K5: 88 at the 8² level and 168 in
# bands; K6: 3 UNet upsamples a step) and the decoder (K3 1, K5 28 bands,
# K6 3); its SwinIR and encoder outputs are the EDTR half's, reused. The
# detector launches none of the port's kernels.
WALK_LAUNCHES = {"wholekv_fwd": 28, "whole_fwd": 28, "streamkv_fwd": 1,
                 "gn_conv_whole": 88, "gn_conv_band": 196, "upsample_conv": 15}
TRAIN_LAUNCHES_DET = {name: n + WALK_LAUNCHES.get(name, 0)
                      for name, n in TRAIN_LAUNCHES.items()}
TRAIN_WARMUP = 2
TRAIN_TIMED = 3
# the detector step's seeded targets: up to DET_BOXES boxes an image, sides
# DET_SIDES pixels, inside the 512² image, VOC's 20 classes, one slot
# padded at least
DET_BOXES = 8
DET_SIDES = (32, 256)
# the detector step's batch: seeded coloured rectangles on noise (each class
# one colour, boxes as det_targets draws them) as gt, a noisier copy as lq,
# their boxes the targets
# the configs this slice builds from: restore then segment (bs 1) and
# restore then classify (the config's batch of 8), and the generic step of
# each task (bs 2)
SEG_TEST_CONFIG = "configs/seg/voc2012/test/007_edtr-s4.yaml"
CLS_TEST_CONFIG = "configs/cls/cub200/test/007_edtr-s4.yaml"
SEG_TRAIN_CONFIG = "configs/seg/voc2012/train/007_edtr-s4.yaml"
CLS_TRAIN_CONFIG = "configs/cls/cub200/train/007_edtr-s4.yaml"
# task -> (the config's node of its task net, its classes, its stage name)
TASK_NETS = {"seg": ("segnet", 21, "segment"), "cls": ("clsnet", 200, "classify")}
# the restore then segment / classify phases: stage split over TASK_ROUNDS
# rounds, a trace of TASK_TRACE_ITERS
TASK_ROUNDS = 7
TASK_TRACE_ITERS = 2
# VOC's 255 border of the seeded segmentation masks, in pixels
SEG_BORDER = 16
# the training recipes of configs/seg/voc2012/train (JAX's runner.task_train
# and diffbir_train): SwinIR pre-training, SR4IR, the task net on the frozen
# SwinIR, DiffBIR
SWINIR_PRE_CONFIG = "configs/seg/voc2012/train/002_swinir-pre.yaml"
TASK_SWINIR_CONFIG = "configs/seg/voc2012/train/003_swinir.yaml"
SR4IR_CONFIG = "configs/seg/voc2012/train/004_swinir-sr4ir.yaml"
DIFFBIR_CONFIG = "configs/seg/voc2012/train/005_diffbir.yaml"
# their batches: the configs' 48 (SwinIR pre-training) and 16 (the others)
# cut for the run's time and memory to 4 and 2 (SR4IR's task half then
# trains on 6 images, DiffBIR walks 1 image from pure noise)
SWINIR_PRE_BATCH = 4
RECIPE_BATCH = 2
# each recipe phase's steps: a warm-up, the counted one, RECIPE_TIMED timed
# (their median), a traced one
RECIPE_TIMED = 3
# DiffBIR's walk from pure noise: make_diffbir_train_step's (and JAX's) 50
# cut to 25 for the run's time (its launches scale with it)
DIFFBIR_STEPS = 25
# the gradient gates where the control shows bf16 itself (plain path, bf16
# vs fp32) farther than TOL_GRAD_REL from fp32: the kernel path no farther
# from fp32 than this many times the plain path (fixed before the first
# run of the recipes on the card)
TOL_CONTROL_RATIO = 1.1
# launches of each pass through a part of the paths at 512², any batch
# (every kernel batches): SwinIR's forward (8 RSTBs x 6 blocks, 3 tail
# upsamples; its backward recomputes the plain versions); the VAE encoder
# (1 mid attention, 10 ResBlocks in bands) and decoder (1 attention, 14
# ResBlocks, 3 upsamples); one ControlNet + UNet eps forward (7
# self-attentions at each of 4096 and 1024 tokens; 11 ResBlocks at the 8²
# level, 21 in bands; 3 UNet upsamples), the remat recompute in its
# backward (the ControlNet and the UNet output blocks: 5 attentions at each
# level, 7 ResBlocks at 8², 15 in bands) and the flash backward kernels;
# the trainable decoder's recompute. TRAIN_LAUNCHES and WALK_LAUNCHES are
# sums of them (recipe_launches checks it).
SWINIR_PASS = {"window_attention": 48, "swin_pre": 48, "swin_post": 48, "upsample_conv": 3}
ENCODE_PASS = {"streamkv_fwd": 1, "gn_conv_band": 20}
DECODE_PASS = {"streamkv_fwd": 1, "gn_conv_band": 28, "upsample_conv": 3}
DECODE_REMAT = {"gn_conv_band": 28}
EPS_PASS = {"wholekv_fwd": 7, "whole_fwd": 7, "gn_conv_whole": 22, "gn_conv_band": 42,
            "upsample_conv": 3}
EPS_REMAT = {"wholekv_fwd": 5, "whole_fwd": 5, "gn_conv_whole": 14, "gn_conv_band": 30}
EPS_BWD = {name: n for name, (_, _, n) in BWD_KERNELS.items()}
# each recipe step's passes: SwinIR pre-training one SwinIR forward with
# grad; SR4IR that and the updated SwinIR again under no grad; the task
# step the frozen SwinIR under no grad; DiffBIR the frozen SwinIR, the
# encoder on lq and on gt, the eps forward with grad and its backward, the
# walk's DIFFBIR_STEPS eps forwards and the decode. The task nets launch
# none of the port's kernels.
RECIPE_PASSES = {
    "swinir_pre": (SWINIR_PASS,),
    "sr4ir": ((2, SWINIR_PASS),),
    "task_swinir": (SWINIR_PASS,),
    "diffbir": (SWINIR_PASS, (2, ENCODE_PASS), EPS_PASS, EPS_REMAT, EPS_BWD,
                (DIFFBIR_STEPS, EPS_PASS), DECODE_PASS),
}
# the real-world demo (edtr_torch/demo.py after demo.py) from
# configs/det/demo.yaml, on the flagship's weights: restore then detect with
# the ResNet50-FPN-v2 detector (COCO's 91 classes) at 512², bs 1, then the
# demo at --scale 1 on a seeded DEMO_SIZE image, untiled with ``resize``
# detection and all tiled (the demo's default tiles) with ``tile`` detection
DEMO_CONFIG = "configs/det/demo.yaml"
DEMO_SIZE = (768, 1024)
DEMO_TILED = dict(pre_res_tiled=True, vae_encoder_tiled=True, vae_decoder_tiled=True,
                  cldm_tiled=True, detection_type="tile")
# the v2 two-half step from this COCO train config, at TRAIN_BATCH (the
# config's 16 cut for time and memory) and 512²
DET_V2_TRAIN_CONFIG = "configs/det/coco/train/001_edtr-s4-r50.yaml"
# LPIPS on the card against the CPU on the same random weights and images
TOL_LPIPS_REL = 1e-4
LPIPS_IMAGES = (2, 3, 128, 160)
# the data path: the Real-ESRGAN training data of this config on a
# synthetic COCO tree (DATA_COCO_IMAGES images of DATA_COCO_SIDES px, the
# last without annotations) through its dataset, loader and batch transform
# at its batch of 32, feeding DATA_STEPS SwinIR-pre steps; the transform's
# stages recomputed on the CPU for the first DATA_CPU_IMAGES images
DATA_TRAIN_CONFIG = "configs/det/coco/train/100_swinir-pre-v2.yaml"
DATA_COCO_IMAGES = 40
DATA_COCO_SIDES = (480, 640)
DATA_STEPS = 3
DATA_TIMED = 3
DATA_CPU_IMAGES = 2
# the evaluation path: a synthetic VOC tree (DATA_VOC_IMAGES images),
# degraded by val_data_generation from the first config's training
# dataset, loaded by the second's val dataset, restored and detected
DATA_GEN_CONFIG = "configs/det/voc2012/train/002_swinir-pre.yaml"
DATA_EVAL_CONFIG = "configs/det/voc2012/test/007_edtr-s4.yaml"
DATA_VOC_IMAGES = 8
DATA_VOC_SIDES = (360, 500)
# the runner (``python -m edtr_torch.cli``): the flagship det train and test
# configs and the seg SwinIR test config on a synthetic VOC tree of
# RUNNER_VOC_IMAGES VOC-sized images (at least the train config's global
# batch of 16, which RUNNER_ACCUM microbatches of 2 carry on one card)
RUNNER_TRAIN_CONFIG = "configs/det/voc2012/train/007_edtr-s4.yaml"
RUNNER_TEST_CONFIG = "configs/det/voc2012/test/007_edtr-s4.yaml"
RUNNER_SEG_CONFIG = "configs/seg/voc2012/test/004_swinir-sr4ir.yaml"
RUNNER_SEG_GEN_CONFIG = "configs/seg/voc2012/train/002_swinir-pre.yaml"
RUNNER_VOC_IMAGES = 16
RUNNER_VOC_SIDES = (333, 500)
# the tree's val split (the first images): what the runs validate and test
RUNNER_VAL_IMAGES = 4
RUNNER_ACCUM = 8
# --debug: 2 steps, 2 validation images a step, 4 test images, 2 seg images
RUNNER_DEBUG = dict(steps=2, val=2, test=4, seg=2)
# the transform's stages, card vs CPU on the card's inputs and draws (the
# CPU tests hold the port's to JAX's at these): max abs per stage; a JPEG
# stage outside the 8 x 8 blocks (16 x 16 for chroma) whose quantised
# coefficients flip, at most DATA_FLIP_SHARE of them, each within
# DATA_TIE of a rounding tie; LQ one 1/255 level apart at most
# DATA_FLIP_SHARE of its pixels, each a tie of the last stage's output
TOL_DATA_STAGE = {"filter2d": 1e-6, "resize": 1e-5, "gaussian": 1e-4, "poisson": 1e-4,
                  "diff_jpeg": 1e-4}
DATA_FLIP_SHARE = 1e-3
DATA_TIE = 1e-4
# conv wrapper -> (the TPU kernel it replaces, launches in one fused 512²
# restore): 4 steps x (UNet 22 + ControlNet 10 ResBlocks) x 2 halves, of
# them 4 x 22 at the 8² latent level (whole-image tier), plus the VAE's
# 10 + 14 ResBlocks x 2 (row bands); 4 x 3 UNet, 3 VAE and 3 SwinIR-tail
# upsamples.
CONV_KERNELS = {
    "gn_conv_whole": ("edtr_tpu/ops/gn_conv.py:438", 88),
    "gn_conv_band": ("edtr_tpu/ops/gn_conv.py:526", 216),
    "upsample_conv": ("edtr_tpu/ops/gn_conv.py:841", 18),
}
# projection wrapper -> (source, the TPU kernel it replaces, launches in one
# fused+proj 512² restore; None: not on that path). 4 steps x (UNet 5 +
# ControlNet 2) transformer blocks at 4096, 1024 and 256 tokens = 28 x 3 =
# 84 blocks, each one affine_matmul (proj_in), two ln_matmuls (K = 3 q/k/v,
# K = 1 cross query) and one ln_geglu_proj; the 64-token mid blocks stay on
# the plain math, as in JAX. geglu_proj (no LN; K7a, on the wgmma kernel of
# proj_wgmma.cuh) is held at the three token levels and not
# launched by the restore.
PROJ_KERNELS = {
    "ln_matmuls": ("edtr_torch/csrc/ln_matmul.cu", "edtr_tpu/ops/ln_matmul.py:120", 168),
    "affine_matmul": ("edtr_torch/csrc/ln_matmul.cu", "edtr_tpu/ops/ln_matmul.py:201", 84),
    "geglu_proj": ("edtr_torch/csrc/proj_wgmma.cuh", "edtr_tpu/ops/geglu.py:159", None),
    "ln_geglu_proj": ("edtr_torch/csrc/geglu.cu", "edtr_tpu/ops/geglu.py:218", 84),
}
GEGLU_HELD = tuple(("geglu_proj", 1, n, c, 4 * c) for n, c in ((4096, 320), (1024, 640),
                                                                 (256, 1280)))
# Swin wrapper -> (source, the TPU kernel it replaces, launches in one
# fused+swin 512² restore): 8 RSTBs x 6 blocks, each one swin_pre, one
# window attention (masked in the 24 shifted blocks) and one swin_post
SWIN_KERNELS = {
    "window_attention": ("edtr_torch/csrc/window_attention.cu",
                         "edtr_tpu/ops/window_attention.py:76", 48),
    "swin_pre": ("edtr_torch/csrc/swin_block.cu", "edtr_tpu/ops/swin_block.py:168", 48),
    "swin_post": ("edtr_torch/csrc/swin_block.cu", "edtr_tpu/ops/swin_block.py:297", 48),
}
SWIN_MASKED = 24
# O is small here: randn q, k, v with scale D^-0.5 give unit-variance
# logits, so O has std sqrt(e/N) (0.026 at N = 4096, 0.05 at 1024, 0.018 at
# 8192) and max |O| ~0.13-0.5. Both sides round O to bf16 (one ulp is 2^-8
# of the value), and the kernel rounds the unnormalised P to bf16 before PV
# where the plain version rounds the normalised one, so a right kernel
# differs by about one ulp of the largest output. The limits are relative
# to the outputs: max abs error <= 2^-6 * max|O_plain| (4 such ulps), and
# relative L2 of the whole O <= 1e-2 (rounding alone gives ~2e-3). A wrong
# tile or row block breaks both. lse is fp32 on both sides, |lse| ~ 9; the
# kernel sums exp() in another order with __expf (~1e-6); one missing KV
# tile of 64 rows at N = 8192 moves it by 8e-3.
TOL_O_MAX = 2.0 ** -6
TOL_O_L2 = 1e-2
TOL_LSE = 1e-4
# Conv kernels vs plain: both apply the affine and SiLU with the same fp32
# operations and roundings, both accumulate the conv in fp32 (in different
# orders, ~1e-6 relative) and round to bf16 at the same places, so an output
# differs by at most an ulp or two of bf16 (2^-8 of its value) where a
# rounding flips; the bias/emb/res adds can carry one such flip. Limits:
# max abs error <= 2^-6 * max|out_plain| (4 ulps of the largest output) and
# relative L2 <= 1e-2 (rounding alone gives ~1e-3). A wrong tap, halo row
# or channel block moves whole pixels by O(|out|) and fails both.
TOL_CONV_MAX = 2.0 ** -6
TOL_CONV_L2 = 1e-2
# Projection kernels vs plain: the same LN / affine in fp32 (the kernel's
# row statistics in another summation order and rsqrtf, ~1e-6 relative),
# rounded to bf16 where the plain version rounds, products accumulated in
# fp32 in another order, outputs rounded once (K8b: twice, around the bf16
# bias add; K7: erff GELU in fp32, as F.gelu). A right kernel differs by a
# bf16 ulp where a rounding flips; a wrong row, chunk or column block moves
# whole outputs by O(|out|). The same limits as the conv kernels.
TOL_PROJ_MAX = 2.0 ** -6
TOL_PROJ_L2 = 1e-2
# Swin kernels vs plain: the same fp32 LN, biases, softmax and GELU (erff;
# rsqrtf, expf and other summation orders, ~1e-6 relative), rounded to
# bf16 where the plain versions round (P after its normalisation, each
# projection once after its fp32 bias, the residuals), products in fp32.
# A right kernel differs by a bf16 ulp where a rounding flips, and a flip
# in x1 or the hidden reaches the output through one more GEMM; a wrong
# roll, window, head or column block moves whole outputs by O(|out|). The
# limits of the conv and projection kernels.
TOL_SWIN_MAX = 2.0 ** -6
TOL_SWIN_L2 = 1e-2
# ControlLDM eps, kernels vs plain attention: the two paths round P at
# different places in 14 attention calls, and the difference passes through
# ~50 bf16 layers; relative L2 error of the whole eps tensor (measured
# 0.0152 on the H100).
TOL_EPS_REL = 5e-2
# Fused vs stock conv configuration, on the same weights, input and noise:
# every one of the ~300 convs may flip bf16 roundings (the accumulation
# order differs from cuDNN's), and the flips pass through up to ~100 bf16
# layers with random weights and the 4-step walk; the same bound as the
# attention comparison above, for eps and for the restored image.
TOL_FUSED_REL = 5e-2
# Flash backward kernels vs plain_bwd, in bf16: both compute p = exp(s -
# lse) in fp32 and round p (for dV) and dS to bf16 at the same places, and
# accumulate every product in fp32 in other orders (exp2 with log2(e)
# folded in, another logit summation order: ~1e-6 relative), so a rounding
# of p or dS flips by a bf16 ulp here and there and a right kernel differs
# by about an ulp of the
# largest gradient; a wrong tile, row block or transpose moves whole rows
# by O(|grad|). The limits of the forward: max abs error <= 2^-6 *
# max|grad_plain| for each of dq, dk, dv, relative L2 <= 1e-2.
TOL_BWD_MAX = 2.0 ** -6
TOL_BWD_L2 = 1e-2
# Training-step gradients, kernel path vs plain path (plain attention and
# stock convs) on the same weights, batch, t and noise: the forward differs
# as the eps comparison above (rounding flips through ~100 bf16 layers) and
# the backward adds the flash backward's roundings; relative L2 over all
# trainable gradients, the fused-vs-stock bound. The loss is a mean over
# 2 x 512² x 3 pixels: within 1e-2 relative.
TOL_GRAD_REL = 5e-2
TOL_TRAIN_LOSS = 1e-2
# the CLIP text tower on the empty prompt, bf16 compute against fp32 on the
# same weights: 23 pre-LN blocks of bf16 GEMMs (~100 layers) on one
# 77-token sequence; the detector's bf16 bound
TOL_TEXT_REL = 5e-2
# GroupNorm statistics, channels-last (Welford) vs two-pass on NCHW: both
# fp32 over the same bf16 values, in other orders (~1e-7 relative), over
# up to 2^21 elements a group; a dropped or doubled row moves them by
# more than 1e-4
TOL_GN_STATS = 1e-5
# the detector of bench.py's main path (bench.py:176-201): Faster R-CNN
# MobileNetV3-Large-FPN on VOC's 21 classes, the restored 512² image resized
# to 800²; bench.py's batch (bench.py:45) for one batched call
DETECT_CLASSES = 21
DETECT_BATCH = 8
# bf16 vs fp32 detector on the same image and weights: FPN maps, objectness,
# deltas, and class logits at the bf16 run's proposals; every one of the
# ~60 convs and GEMMs may flip bf16 roundings, through up to ~25 layers: the
# configuration bound above
TOL_DETECT_REL = 5e-2
# bf16 vs fp32 segmentation and classification nets on the same restored
# image: DeepLabV3-MobileNetV3 (~60 layers) and ResNet-18 (~20), the
# detector's bound
TOL_TASK_REL = 5e-2
# the calibrated random segmentation and classification nets' fp32 logits
# must move with their input: by at least TOL_TASK_MOVES relative L2 for
# input noise of std TASK_NOISE (DeepLabV3-MobileNetV3 on randomize_'s
# weights alone stays below it: its biases, not its input, set its output)
TOL_TASK_MOVES = 1e-2
TASK_NOISE = 0.1
IMAGE = 512
# restores per configuration in the interleaved timing (single host times
# of one configuration spread over 300-550 ms on the card's machine), and
# traced; 21 and 41 until the demo phases came, 15 and 31 until the runner
# phase came, cut to keep the whole run within its limit on a slow host
# (the verdicts' sign test needs 8 of 9 and 13 of 17)
TIME_ITERS = 9
TRACE_ITERS = 2
# fused vs fused+proj pairs: the projection switch's verdict has read both
# ways at 21 pairs, so these two configurations run 8 more rounds alone
PROJ_PAIRS = 17
# a configuration wins end to end beyond the ~5% drift between runs
# (edtr_tpu/ops/dispatch.py) only if it also wins a clear majority of the
# interleaved pairs: a one-sided sign test at this level
SIGN_TEST_ALPHA = 0.05


def configs() -> dict:
    """The pipeline's (fused_conv, fused_proj, fused_swin) in each
    configuration; fused+swin keeps the projections as the pipeline's
    default does, so that it differs from one of the others in the Swin
    switch alone."""
    from edtr_torch.pipeline import FUSED_PROJ_DEFAULT

    return {"stock": (False, False, False), "fused": (True, False, False),
            "fused+proj": (True, True, False), "fused+swin": (True, FUSED_PROJ_DEFAULT, True)}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device ms per call over ``iters`` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
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


# device_ms's traces that lost kernels (taken again), and the calls it timed
# by CUDA events after TRACE_TRIES such traces, by name
TRACE_STATS = {"traces_taken_again": 0, "event_timed": 0, "event_timed_calls": []}
TRACE_TRIES = 5


def trace_accepted(kernels: int, launches: int, per_call: int, iters: int) -> bool:
    """:func:`device_ms`'s rule for a trace of ``iters`` calls: the call's
    own count of kernel launches, ``per_call`` (> 0, from the launch records
    of a trace of one call), times ``iters`` launches recorded, and a kernel
    for each of them. A trace that lost kernels fails it, also when what it
    kept is a whole number of calls' (a 3-kernel call that lost one kernel
    a call, seen on the card)."""
    return per_call > 0 and launches == per_call * iters and kernels == launches


def trace_kernels(fn, iters: int) -> tuple:
    """(durations in us of the kernels, count of kernel launches) in a
    ``torch.profiler`` trace of ``iters`` back-to-back calls. The launches
    are the host's runtime and driver API records (``cudaLaunchKernel``,
    ``cudaLaunchKernelExC``, ``cuLaunchKernel``...), which CUPTI takes on
    the launching thread; a kernel counts only with the correlation id of
    one of them. The profiler first runs one cycle of the same calls whose
    events it drops: without it, late in this script's run, one-kernel
    calls read 2.2x fast, below their bound, as if 11 of a trace's 20
    kernels were missing (on an NVIDIA H100 80GB HBM3)."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    finally:
        os.remove(path)
    launched = {e.get("args", {}).get("correlation") for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "Launch" in e.get("name", "") and "Kernel" in e.get("name", "")}
    durs = [e["dur"] for e in events if e.get("cat") == "kernel"
            and e.get("args", {}).get("correlation") in launched]
    return durs, len(launched)


def device_ms(fn, iters: int, warmup: int = 2, what: str = "unnamed call") -> float:
    """Device ms per call: the kernels' time in a trace of ``iters``
    back-to-back calls (:func:`trace_kernels`), over ``iters``. Unlike
    :func:`time_ms` it leaves out the host's time to launch, which sets
    CUDA-event times of calls shorter than the wrapper's Python. The trace
    is taken only with the call's own launch count, from a trace of one
    call, times ``iters``, and every launched kernel in it
    (:func:`trace_accepted`); else both are taken again, and after
    :data:`TRACE_TRIES` such traces the call ``what`` is timed by CUDA
    events, printed and named in :data:`TRACE_STATS`."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for _ in range(TRACE_TRIES):
        _, per_call = trace_kernels(fn, 1)
        kernels, launches = trace_kernels(fn, iters)
        if trace_accepted(len(kernels), launches, per_call, iters):
            return sum(kernels) / 1e3 / iters
        TRACE_STATS["traces_taken_again"] += 1
    TRACE_STATS["event_timed"] += 1
    TRACE_STATS["event_timed_calls"].append(what)
    print(f"device_ms: {what} timed by CUDA events ({TRACE_TRIES} traces lost kernels or "
          f"launched {launches} kernels, {per_call} a call, for {len(kernels)} in the trace)",
          flush=True)
    return time_ms(fn, iters, 0)


def host_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def rel_l2_over(a: dict, b: dict, names) -> float:
    """Relative L2 of the tensors ``a[n]`` against ``b[n]`` over ``names``,
    taken together (a gradient's parts)."""
    num = sum((a[n].float() - b[n].float()).pow(2).sum() for n in names)
    return (num / sum(b[n].float().pow(2).sum() for n in names)).sqrt().item()


def sign_test_wins(n: int, alpha: float = SIGN_TEST_ALPHA) -> int:
    """The fewest wins of ``n`` pairs that a one-sided sign test at
    ``alpha`` takes for a real difference (15 of 21)."""
    tail = 0
    for k in range(n, -1, -1):
        tail += math.comb(n, k)
        if tail / 2 ** n > alpha:
            return k + 1
    return 0


def build() -> None:
    from edtr_torch.ops import _cuda

    t0 = time.perf_counter()
    nvcc_s = _cuda.build_all(list(SOURCES))
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc in parallel: {nvcc_s})", flush=True)
    for name in nvcc_s:
        log = _cuda.so_path(name).with_suffix(".log")
        for line in log.read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "C75")):
                print(f"ptxas {name}:", line.strip())


def flash_case(device, name, shape, gen, timed: bool = True) -> dict:
    """One flash forward kernel against :func:`plain_fwd` at one (BH, N, D),
    in bf16: O and lse errors, kernel / plain / SDPA device times from a
    trace (the kernel's CUDA-event time beside them; None unless
    ``timed``) and the bound."""
    from edtr_torch.ops import flash_attention as FA

    bh, n, d = shape
    q, k, v = (torch.randn((bh, n, d), generator=gen, device=device,
                           dtype=torch.bfloat16) for _ in range(3))
    scale = d ** -0.5
    fwd = FA.FWD[name]
    before = FA.launches[name]
    (o_k, lse_k), (o_2, lse_2) = fwd(q, k, v, scale), fwd(q, k, v, scale)
    check(FA.launches[name] == before + 2, f"{name} launched its kernel once a call")
    o_p, lse_p = FA.plain_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    same = bool(torch.equal(o_k, o_2) and torch.equal(lse_k, lse_2))
    diff = o_k.float() - o_p.float()
    err_o = diff.abs().max().item()
    o_max = o_p.float().abs().max().item()
    rel = rel_l2(o_k, o_p)
    err_l = (lse_k - lse_p).abs().max().item()
    ms = plain_ms = library_ms = event_ms = None
    if timed:
        ms = device_ms(lambda: fwd(q, k, v, scale), 20, what=f"{name} {shape}")
        plain_ms = device_ms(lambda: FA.plain_fwd(q, k, v, scale), 3, 1,
                             what=f"plain_fwd {shape}")
        q4, k4, v4 = (t.view(1, bh, n, d) for t in (q, k, v))
        library_ms = device_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale),
                               20, what=f"SDPA {shape}")
        event_ms = time_ms(lambda: fwd(q, k, v, scale), 20)
    t_ops = 4.0 * n * n * d * bh / PEAK_BF16_FLOPS * 1e3
    t_bytes = (4 * bh * n * d * 2 + bh * n * 4) / PEAK_BYTES * 1e3
    row = dict(name=name, shape=[bh, n, d], max_abs_err=max(err_o, err_l), ms=ms,
               plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               library_ms=library_ms, event_ms=event_ms, err_o=err_o, o_max=o_max,
               rel_l2_o=rel, err_lse=err_l, same_twice=same,
               ok=bool(err_o <= TOL_O_MAX * o_max and rel <= TOL_O_L2 and err_l <= TOL_LSE
                       and same))
    row["bound_share"] = row["bound_ms"] / ms if timed else None
    print("kernel:", json.dumps(row), flush=True)
    check(row["ok"], f"{name} at {shape} vs plain: err_o {err_o} (tol {TOL_O_MAX * o_max}), "
                     f"rel L2 {rel} (tol {TOL_O_L2}), err_lse {err_l} (tol {TOL_LSE}), "
                     f"bit-identical twice: {same}")
    return row


def kernel_phase(device) -> dict:
    """Each flash forward kernel at its 512² bs-1 shape (:data:`KERNELS`)."""
    rows = {}
    gen = torch.Generator(device=device).manual_seed(0)
    for name, (shape, replaces, expected, source) in KERNELS.items():
        rows[name] = dict(name=name, route="cuda", source=source, replaces=replaces,
                          launches=None, on_path=expected is not None,
                          scope="one call; ms, plain_ms, library_ms: device time (profiler), "
                                "event_ms: CUDA events",
                          **{k: v for k, v in flash_case(device, name, shape, gen).items()
                             if k != "name"})
    return rows


def bwd_kernel_phase(device) -> dict:
    """Each flash backward wrapper at its shape in the training step
    (:data:`BWD_KERNELS`, the shapes ``proj_bench.BWD_SHAPES`` pins), held
    against ``plain_bwd`` in bf16 by ``proj_bench.bwd_shape``: dq, dk, dv
    errors, two calls bit-identical, device times of the wrapper, of
    ``plain_bwd`` and of SDPA's backward alone (``library_ms``, a yardstick
    the port never calls) from a trace, CUDA-event times beside them, and
    the bound of the function the wrapper computes."""
    want = {(name, *shape[:2]): n for name, (shape, _, n) in BWD_KERNELS.items()}
    check(want == proj_bench.BWD_SHAPES, f"backward shapes {want}, pinned "
                                         f"{proj_bench.BWD_SHAPES} (proj_bench.py)")
    rows = {}
    gen = torch.Generator(device=device).manual_seed(13)
    for name, (shape, replaces, _) in BWD_KERNELS.items():
        r = proj_bench.bwd_shape(device, (name, *shape[:2]), gen)
        rows[name] = dict(
            name=name, route="cuda", source=FA_BWD_SOURCE, replaces=replaces, launches=None,
            on_path=True, scope="one call at the training step's shape; ms, plain_ms, "
                                "library_ms: device time (profiler), event_ms, "
                                "library_event_ms: CUDA events; library: SDPA's whole "
                                "backward (dq, dk, dv)",
            shape=list(shape), ok=True, **r)
        rows[name]["bound_share"] = r["bound_ms"] / r["ms"]
        print("bwd kernel:", json.dumps(rows[name]), flush=True)
    return rows


def conv_case(device, key, gen, timed: bool = True) -> dict:
    """One conv kernel against its plain version at one shape ``key``
    (``gn_conv.shapes``' key): errors, times (None unless ``timed``) and the
    bound."""
    from edtr_torch.ops import gn_conv as GC

    name, b, cin, h, w, cout, has_emb, has_res, act = key
    bf16 = torch.bfloat16

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return torch.randn(shape, generator=gen, device=device).mul_(scale).to(dtype)

    up = name == "upsample_conv"
    hin, win = (h // 2, w // 2) if up else (h, w)
    x = randn(b, cin, hin, win, dtype=bf16).contiguous(memory_format=torch.channels_last)
    w32 = randn(cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
    bias = randn(cout, scale=0.05)
    wp = GC.fold_subpixel_weights(w32, bf16) if up else GC.pack_weight(w32, bf16)
    wb = w32.to(bf16).contiguous(memory_format=torch.channels_last)
    if up:
        def kern():
            return GC.upsample_conv(x, w32, bias, act, w_packed=wp)

        def plain():
            return GC.plain_upsample_conv(x, w32, bias, act)
        lib_in = F.interpolate(x, scale_factor=2.0, mode="nearest")
        res_bytes = 0
    else:
        mul = 1.0 + randn(b, cin, scale=0.1)
        add = randn(b, cin, scale=0.1)
        emb = randn(b, cout, dtype=bf16, scale=0.5) if has_emb else None
        res = (randn(b, cout, h, w, dtype=bf16).contiguous(memory_format=torch.channels_last)
               if has_res else None)

        def kern():
            return GC.gn_silu_conv(x, mul, add, w32, bias, emb, res, w_packed=wp)

        def plain():
            return GC.plain_gn_silu_conv(x, mul, add, w32, bias, emb, res)
        lib_in = F.silu((x.float() * mul[:, :, None, None] + add[:, :, None, None]).to(bf16))
        res_bytes = b * h * w * cout * 2 if has_res else 0
    before = GC.launches[name]
    out_k = kern()
    check(GC.launches[name] == before + 1, f"{name} launched its kernel")
    out_p = plain()
    torch.cuda.synchronize()
    err = (out_k.float() - out_p.float()).abs().max().item()
    o_max = out_p.float().abs().max().item()
    rel = rel_l2(out_k, out_p)
    # the work the function needs: nearest-2x then conv3x3 meets each input
    # pixel in only 4 of the 9 taps per output phase (JAX's ``_ups_subpixel``
    # form, which the kernel computes), so K6's bound counts 4 taps
    flops = 2.0 * b * h * w * (4 if up else 9) * cin * cout
    iters = max(3, min(20, int(2e12 / flops)))
    # calls of 10-400 us, at or below the wrapper's host-side launch at the
    # small sites: device time from a trace, as the projection kernels are
    # timed, CUDA events beside it
    ms = plain_ms = library_ms = event_ms = None
    if timed:
        ms = device_ms(kern, iters, what=f"{key}")
        plain_ms = device_ms(plain, 3, 1, what=f"plain {key}")
        library_ms = device_ms(lambda: F.conv2d(lib_in, wb, None, 1, 1), iters,
                               what=f"F.conv2d {key}")
        event_ms = time_ms(kern, iters)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = ((b * hin * win * cin + b * h * w * cout + 9 * cin * cout) * 2 + res_bytes) \
        / PEAK_BYTES * 1e3
    if up:  # conv_wgmma.cuh: 8 x 16 low-res tiles, all 4 phases of 64 channels
        bm, bn = 128, GC.UPS_BN
        tw, splits, _ = GC.ups_plan(b, hin, win, cin, cout)
    else:  # gnconv_wgmma.cuh: th x 8 tiles of GN_TILES[wn, th] channels
        wn, th, splits, _ = GC.gn_plan(b, h, w, cin, cout, name)
        bm, bn, tw = 8 * th, GC.GN_TILES[wn, th], 8
    items = b * -(-hin // (bm // tw)) * -(-win // tw) * (cout // bn) * splits
    row = dict(name=name, shape=dict(b=b, cin=cin, h=h, w=w, cout=cout, emb=has_emb,
                                     res=has_res, act=act),
               # K5 walks its items (tiles x splits) with at most one block an SM
               tile=dict(bm=bm, bn=bn, tw=tw, splits=splits, items=items,
                         blocks=items if up else min(items, GC.SMS)),
               max_abs_err=err, out_max=o_max, rel_l2=rel, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, event_ms=event_ms, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               gflop=flops / 1e9, mb=t_bytes * PEAK_BYTES / 1e9,
               ok=bool(err <= TOL_CONV_MAX * o_max and rel <= TOL_CONV_L2))
    row["bound_share"] = row["bound_ms"] / ms if timed else None
    print("conv kernel:", json.dumps(row), flush=True)
    check(row["ok"], f"{key} vs plain: max abs {err} (tol {TOL_CONV_MAX * o_max}), "
                     f"rel L2 {rel} (tol {TOL_CONV_L2})")
    return row


def conv_kernel_phase(device, shape_counts: dict, per: str = "restore") -> dict:
    """Each conv kernel at every shape of ``shape_counts`` (shape key ->
    launches in one restore, or in one ``per`` run); per kernel, the
    launch-weighted sums over its shapes: the time the run spends in it, and
    the same for the plain version, ``F.conv2d`` and the bound."""
    gen = torch.Generator(device=device).manual_seed(5)
    rows = {}
    for key, count in sorted(shape_counts.items(), key=str):
        r = conv_case(device, key, gen)
        agg = rows.setdefault(key[0], dict(
            name=key[0], route="cuda", source=CONV_SOURCE,
            replaces=CONV_KERNELS[key[0]][0], launches=None, on_path=True,
            scope=f"per {per}: launch-weighted sum over its shapes; ms, plain_ms, "
                  "library_ms: device time (profiler), event_ms: CUDA events",
            max_abs_err=0.0, max_err_share=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
            library_ms=0.0, event_ms=0.0, ops_bound_ms=0.0, bytes_bound_ms=0.0, shapes=0))
        agg["max_abs_err"] = max(agg["max_abs_err"], r["max_abs_err"])
        agg["max_err_share"] = max(agg["max_err_share"], r["max_abs_err"] / r["out_max"])
        for k in ("ms", "plain_ms", "bound_ms", "library_ms", "event_ms"):
            agg[k] += count * r[k]
        agg["ops_bound_ms" if r["bound_by"] == "operations" else "bytes_bound_ms"] += (
            count * r["bound_ms"])
        agg["shapes"] += 1
    for agg in rows.values():
        agg["bound_by"] = ("operations" if agg["ops_bound_ms"] >= agg["bytes_bound_ms"]
                           else "bytes")
        agg["bound_share"] = agg["bound_ms"] / agg["ms"]
    return rows


def proj_case(device, key, gen) -> dict:
    """One projection kernel against its plain version at one shape ``key``
    (``ln_matmul.shapes``' or ``geglu.shapes``' key): errors, times and the
    bound. ``library_ms``: ``F.linear`` alone on the already-transformed
    bf16 tokens with the same bf16 weight (all K*O or 2*inner rows), a
    yardstick the port never calls."""
    from edtr_torch.ops import geglu as GG
    from edtr_torch.ops import ln_matmul as LM
    from edtr_torch.ops._norms import ln_f32
    from edtr_torch.ops._proj import lnproj_plan, lnproj_stages

    name, b, n, c = key[:4]
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device).mul_(scale)

    # tokens with a mean and a spread per row, as a residual stream has
    x = (randn(b, n, c, scale=2.0) + 0.5).to(bf16)
    ln_s, ln_b = 1.0 + randn(c, scale=0.1), randn(c, scale=0.1)
    if name in ("ln_matmuls", "affine_matmul"):
        o, k = key[4], key[5]
        ws = [randn(o, c, scale=c ** -0.5) for _ in range(k)]
        wp = torch.cat([w.to(bf16) for w in ws])
        slab = k * o
        if name == "ln_matmuls":
            def kern():
                return LM.ln_matmuls(x, ln_s, ln_b, ws, w_packed=wp)

            def plain():
                return LM.plain_ln_matmuls(x, ln_s, ln_b, ws)
            lib_in = ln_f32(x, ln_s, ln_b).to(bf16)
            small_bytes = 2 * c * 4
        else:
            mul, add = 1.0 + randn(b, c, scale=0.1), randn(b, c, scale=0.1)
            bias = randn(o, scale=0.05)

            def kern():
                return LM.affine_matmul(x, mul, add, ws[0], bias, w_packed=wp)

            def plain():
                return LM.plain_affine_matmul(x, mul, add, ws[0], bias)
            lib_in = (x.float() * mul[:, None] + add[:, None]).to(bf16)
            small_bytes = (2 * b * c + o) * 4
        out_cols = slab
        launched = LM.launches
    else:
        inner = key[4]
        w = randn(2 * inner, c, scale=c ** -0.5)
        bias = randn(2 * inner, scale=0.05)
        wp = w.to(bf16)
        slab, out_cols = 2 * inner, inner
        if name == "ln_geglu_proj":
            def kern():
                return GG.ln_geglu_proj(x, ln_s, ln_b, w, bias, w_packed=wp)

            def plain():
                return GG.plain_ln_geglu_proj(x, ln_s, ln_b, w, bias)
            lib_in = ln_f32(x, ln_s, ln_b).to(bf16)
            small_bytes = (2 * c + 2 * inner) * 4
        else:
            def kern():
                return GG.geglu_proj(x, w, bias, w_packed=wp)

            def plain():
                return GG.plain_geglu_proj(x, w, bias)
            lib_in = x
            small_bytes = 2 * inner * 4
        launched = GG.launches
    before = launched[name]
    out_k, out_2 = kern(), kern()
    check(launched[name] == before + 2, f"{name} launched its kernel once a call")
    out_p = plain()
    if name == "ln_matmuls":  # the K outputs side by side, outside the timed calls
        out_k, out_2, out_p = (torch.cat(o, -1) for o in (out_k, out_2, out_p))
    torch.cuda.synchronize()
    same = bool(torch.equal(out_k, out_2))
    err = (out_k.float() - out_p.float()).abs().max().item()
    o_max = out_p.float().abs().max().item()
    rel = rel_l2(out_k, out_p)
    m = b * n
    flops = 2.0 * m * c * slab
    # device time from a trace: these calls (15-100 us) are shorter than
    # the wrapper's host-side launch, which CUDA events would time instead
    iters = 20
    ms = device_ms(kern, iters, what=f"{key}")
    plain_ms = device_ms(plain, 3, 1, what=f"plain {key}")
    library_ms = device_ms(lambda: F.linear(lib_in, wp), iters, what=f"F.linear {key}")
    event_ms = time_ms(kern, iters)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    # bf16 tokens, outputs and weight; fp32 LN / affine vectors and biases
    t_bytes = ((m * c + m * out_cols + slab * c) * 2 + small_bytes) / PEAK_BYTES * 1e3
    bm, bn, groups = lnproj_plan(m, c, slab, name)  # proj_wgmma.cuh: column groups
    tile = dict(bm=bm, bn=bn, groups=groups, blocks=(m // bm) * groups,
                stages=lnproj_stages(bn, c, max(bm, 64)))
    row = dict(name=name, shape=dict(b=b, n=n, c=c, cols=out_cols, k=key[5] if len(key) > 5
                                     else 1),
               tile=tile,
               max_abs_err=err, out_max=o_max, rel_l2=rel, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, event_ms=event_ms, bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               gflop=flops / 1e9, mb=t_bytes * PEAK_BYTES / 1e9, same_twice=same,
               ok=bool(err <= TOL_PROJ_MAX * o_max and rel <= TOL_PROJ_L2 and same))
    row["bound_share"] = row["bound_ms"] / ms
    print("proj kernel:", json.dumps(row), flush=True)
    check(row["ok"], f"{key} vs plain: max abs {err} (tol {TOL_PROJ_MAX * o_max}), "
                     f"rel L2 {rel} (tol {TOL_PROJ_L2}), bit-identical twice: {same}")
    return row


def proj_kernel_phase(device, shape_counts: dict) -> dict:
    """Each projection kernel at every shape of ``shape_counts`` (shape key
    -> launches in one fused+proj restore), plus ``geglu_proj`` at
    :data:`GEGLU_HELD`; per kernel the launch-weighted sums over its shapes,
    as :func:`conv_kernel_phase` computes them (one call at each shape for a
    kernel the restore does not launch)."""
    gen = torch.Generator(device=device).manual_seed(7)
    rows = {}
    cases = dict(shape_counts)
    for key in GEGLU_HELD:
        cases.setdefault(key, 0)
    for key, count in sorted(cases.items(), key=str):
        r = proj_case(device, key, gen)
        source, replaces, expected = PROJ_KERNELS[key[0]]
        agg = rows.setdefault(key[0], dict(
            name=key[0], route="cuda", source=source, replaces=replaces, launches=None,
            on_path=expected is not None,
            scope=("per restore: launch-weighted sum over its shapes" if expected is not None
                   else "sum of one call at each of " + ", ".join(
                       "x".join(map(str, k[1:])) for k in GEGLU_HELD))
            + "; ms, plain_ms, library_ms: device time (profiler), event_ms: CUDA events",
            max_abs_err=0.0, max_err_share=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
            library_ms=0.0, ops_bound_ms=0.0, bytes_bound_ms=0.0, gflop=0.0, mb=0.0,
            shapes=0))
        weight = count if expected is not None else 1
        agg["max_abs_err"] = max(agg["max_abs_err"], r["max_abs_err"])
        agg["max_err_share"] = max(agg["max_err_share"], r["max_abs_err"] / r["out_max"])
        for k in ("ms", "plain_ms", "bound_ms", "library_ms", "event_ms", "gflop", "mb"):
            agg[k] = agg.get(k, 0.0) + weight * r[k]
        agg["ops_bound_ms" if r["bound_by"] == "operations" else "bytes_bound_ms"] += (
            weight * r["bound_ms"])
        agg["shapes"] += 1
    for agg in rows.values():
        agg["bound_by"] = ("operations" if agg["ops_bound_ms"] >= agg["bytes_bound_ms"]
                           else "bytes")
        agg["bound_share"] = agg["bound_ms"] / agg["ms"]
    return rows


def swin_case(device, key, gen, timed: bool = True) -> dict:
    """One Swin kernel against its plain version at one shape ``key``
    (``window_attention.shapes``' or ``swin_block.shapes``' key): errors,
    device times, the bound. ``library_ms``: for the window attention, SDPA
    on contiguous (BW, H, N, D) copies with bias + mask as one bf16 additive
    mask; for the block halves, ``F.linear`` alone on already-normalised
    bf16 tokens (qkv; proj + fc1 + fc2), yardsticks the port never calls.
    The times are None unless ``timed``."""
    from edtr_torch.models.swinir import shift_mask
    from edtr_torch.ops import swin_block as SB
    from edtr_torch.ops import window_attention as WA
    from edtr_torch.ops._norms import ln_f32

    name = key[0]
    bf16 = torch.bfloat16

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device).mul_(scale)

    if name == "window_attention":
        _, bw, n, heads, d, nw = key
        c = heads * d
        # q/k/v as the block hands them over: slices of the packed windows
        q, k, v = randn(bw, n, 3 * c).to(bf16).view(bw, n, 3, heads, d).unbind(2)
        bias = randn(heads, n, n, scale=0.5)
        # the shifted blocks' mask of a window grid with nW windows: the most
        # nearly square one (8 x 8 at 512², 12 x 16 at 768 x 1024)
        gh = max(r for r in range(1, math.isqrt(max(nw, 1)) + 1) if nw % r == 0) if nw else 1
        mask = shift_mask(gh * 8, nw // gh * 8, 8, 4, device) if nw else None
        scale = d ** -0.5

        def kern():
            return WA.window_attention(q, k, v, bias, mask, scale)

        def plain():
            return WA.plain_window_attention(q, k, v, bias, mask, scale)
        q4, k4, v4 = (t.permute(0, 2, 1, 3).contiguous() for t in (q, k, v))
        am = bias[None] + (mask.repeat(bw // nw, 1, 1)[:, None] if nw else 0.0)
        am = am.to(bf16).expand(bw, heads, n, n).contiguous()

        def lib():
            return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=am, scale=scale)
        flops = 4.0 * bw * heads * n * n * d
        nbytes = 4 * bw * n * c * 2 + heads * n * n * 4 + nw * n * n * 4
        shape = dict(bw=bw, n=n, heads=heads, d=d, mask_windows=nw)
        launched = WA.launches
    else:
        _, b, hh, ww, c, win, extra = key
        l, nw = hh * ww, (hh // win) * (ww // win)
        x = (randn(b, l, c, scale=2.0) + 0.5).to(bf16)
        if name == "swin_pre":
            d = extra
            ln_s, ln_b = 1.0 + randn(c, scale=0.1), randn(c, scale=0.1)
            w, bias = randn(3 * c, c, scale=c ** -0.5), randn(3 * c, scale=0.05)
            wp, wb = SB.pad_weight(w), w.to(bf16)

            def kern():
                return SB.swin_pre(x, ln_s, ln_b, w, bias, hh, ww, win, d, w_packed=wp)

            def plain():
                return SB.plain_swin_pre(x, ln_s, ln_b, w, bias, hh, ww, win, d)
            xln = ln_f32(x, ln_s, ln_b).to(bf16)

            def lib():
                return F.linear(xln, wb)
            flops = 2.0 * b * l * c * 3 * c
            nbytes = (5 * b * l * c + 3 * c * c) * 2 + 5 * c * 4
            shape = dict(b=b, h=hh, w=ww, c=c, win=win, d=d)
        else:
            hidden = extra
            attn = randn(b, nw, win * win, c).to(bf16)
            ws = [randn(c, c, scale=c ** -0.5), randn(c, scale=0.05),
                  1.0 + randn(c, scale=0.1), randn(c, scale=0.1),
                  randn(hidden, c, scale=c ** -0.5), randn(hidden, scale=0.05),
                  randn(c, hidden, scale=hidden ** -0.5), randn(c, scale=0.05)]
            packed = [SB.pad_weight(ws[i]) for i in (0, 4, 6)]  # as Linear.padded_weight

            def kern():
                return SB.swin_post(attn, x, *ws, hh, ww, win, packed=packed)

            def plain():
                return SB.plain_swin_post(attn, x, *ws, hh, ww, win)
            a2 = attn.reshape(b, l, c)
            hid = randn(b, l, hidden).to(bf16)

            wb = [ws[i].to(bf16) for i in (0, 4, 6)]

            def lib():
                return (F.linear(a2, wb[0]), F.linear(x, wb[1]), F.linear(hid, wb[2]))
            flops = 2.0 * b * l * (c * c + 2 * c * hidden)
            nbytes = (3 * b * l * c + c * c + 2 * c * hidden) * 2 + (4 * c + hidden) * 4
            shape = dict(b=b, h=hh, w=ww, c=c, win=win, hidden=hidden)
        launched = SB.launches
    before = launched[name]
    out_k, out_2 = kern(), kern()
    check(launched[name] == before + 2, f"{name} launched its kernel once a call")
    period = None
    if name == "window_attention" and 0 < nw < bw:
        # the mask's period: window w takes row w mod nW (a random mask, as
        # the shift mask is zero in most windows)
        rmask = randn(nw, n, n, scale=2.0)
        got = WA.window_attention(q, k, v, bias, rmask, scale)
        want = WA.plain_window_attention(q, k, v, bias, rmask, scale)
        period = ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()
        check(period <= TOL_SWIN_MAX and rel_l2(got, want) <= TOL_SWIN_L2,
              f"{key} with a random mask of period {nw}: max abs {period} of max|out|")
    out_p = plain()
    if name == "swin_pre":  # both outputs, outside the timed calls
        out_k, out_2, out_p = (torch.cat([o.flatten() for o in outs])
                               for outs in (out_k, out_2, out_p))
    torch.cuda.synchronize()
    same = bool(torch.equal(out_k, out_2))
    err = (out_k.float() - out_p.float()).abs().max().item()
    o_max = out_p.float().abs().max().item()
    rel = rel_l2(out_k, out_p)
    iters = 20
    ms = plain_ms = library_ms = event_ms = None
    if timed:
        ms = device_ms(kern, iters, what=f"{key}")
        plain_ms = device_ms(plain, 3, 1, what=f"plain {key}")
        library_ms = device_ms(lib, iters, what=f"library {key}")
        event_ms = time_ms(kern, iters)
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    row = dict(name=name, shape=shape, max_abs_err=err, out_max=o_max, rel_l2=rel, ms=ms,
               plain_ms=plain_ms, library_ms=library_ms, event_ms=event_ms,
               bound_ms=max(t_ops, t_bytes),
               bound_by="operations" if t_ops >= t_bytes else "bytes",
               gflop=flops / 1e9, mb=nbytes / 1e6, same_twice=same, period_err_share=period,
               ok=bool(err <= TOL_SWIN_MAX * o_max and rel <= TOL_SWIN_L2 and same))
    row["bound_share"] = row["bound_ms"] / ms if timed else None
    print("swin kernel:", json.dumps(row), flush=True)
    check(row["ok"], f"{key} vs plain: max abs {err} (tol {TOL_SWIN_MAX * o_max}), "
                     f"rel L2 {rel} (tol {TOL_SWIN_L2}), bit-identical twice: {same}")
    return row


def swin_kernel_phase(device, shape_counts: dict, per: str = "restore") -> dict:
    """Each Swin kernel at every shape of ``shape_counts`` (shape key ->
    launches in one fused+swin restore, or in one ``per`` run); per kernel
    the launch-weighted sums over its shapes, as :func:`conv_kernel_phase`
    computes them."""
    gen = torch.Generator(device=device).manual_seed(11)
    rows = {}
    for key, count in sorted(shape_counts.items(), key=str):
        r = swin_case(device, key, gen)
        source, replaces, _ = SWIN_KERNELS[key[0]]
        agg = rows.setdefault(key[0], dict(
            name=key[0], route="cuda", source=source, replaces=replaces, launches=None,
            on_path=True,
            scope=f"per {per}: launch-weighted sum over its shapes; ms, plain_ms, "
                  "library_ms: device time (profiler), event_ms: CUDA events",
            max_abs_err=0.0, max_err_share=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
            library_ms=0.0, event_ms=0.0, ops_bound_ms=0.0, bytes_bound_ms=0.0, gflop=0.0,
            mb=0.0, shapes=0))
        agg["max_abs_err"] = max(agg["max_abs_err"], r["max_abs_err"])
        agg["max_err_share"] = max(agg["max_err_share"], r["max_abs_err"] / r["out_max"])
        for k in ("ms", "plain_ms", "bound_ms", "library_ms", "event_ms", "gflop", "mb"):
            agg[k] += count * r[k]
        agg["ops_bound_ms" if r["bound_by"] == "operations" else "bytes_bound_ms"] += (
            count * r["bound_ms"])
        agg["shapes"] += 1
    for agg in rows.values():
        agg["bound_by"] = ("operations" if agg["ops_bound_ms"] >= agg["bytes_bound_ms"]
                           else "bytes")
        agg["bound_share"] = agg["bound_ms"] / agg["ms"]
    return rows


def launch_counters() -> tuple:
    """Every kernel module's ``launches`` dict."""
    from edtr_torch.ops import flash_attention as FA
    from edtr_torch.ops import gn_conv as GC
    from edtr_torch.ops import geglu as GG
    from edtr_torch.ops import ln_matmul as LM
    from edtr_torch.ops import swin_block as SB
    from edtr_torch.ops import window_attention as WA

    return (FA.launches, GC.launches, LM.launches, GG.launches, WA.launches, SB.launches)


def zero_counts() -> None:
    """Every kernel module's launch counts, per-shape logs and layout-copy
    counts set to 0."""
    from edtr_torch.ops import flash_attention as FA
    from edtr_torch.ops import gn_conv as GC
    from edtr_torch.ops import geglu as GG
    from edtr_torch.ops import ln_matmul as LM
    from edtr_torch.ops import swin_block as SB
    from edtr_torch.ops import window_attention as WA

    for counts in launch_counters():
        for key in counts:
            counts[key] = 0
    for shapes in (FA.shapes, GC.shapes, LM.shapes, GG.shapes, WA.shapes, SB.shapes):
        shapes.clear()
    GC.layout_copies["count"] = LM.layout_copies["count"] = 0


def read_counts() -> tuple:
    """(launches per wrapper, shapes per kernel family, layout copies (conv,
    proj)) since :func:`zero_counts`."""
    from edtr_torch.ops import flash_attention as FA
    from edtr_torch.ops import gn_conv as GC
    from edtr_torch.ops import geglu as GG
    from edtr_torch.ops import ln_matmul as LM
    from edtr_torch.ops import swin_block as SB
    from edtr_torch.ops import window_attention as WA

    launches = {k: n for counts in launch_counters() for k, n in counts.items()}
    shapes = dict(flash=dict(FA.shapes), conv=dict(GC.shapes),
                  proj={**LM.shapes, **GG.shapes}, swin={**WA.shapes, **SB.shapes})
    copies = dict(conv=GC.layout_copies["count"], proj=LM.layout_copies["count"])
    return launches, shapes, copies


def counted_restore(pipe, args) -> tuple:
    """One restore with every launch count set to 0 just before it and read
    just after: (outputs, launches, shapes per kernel family, layout copies
    (conv, proj), host ms)."""
    zero_counts()
    out = {}
    ms = host_ms(lambda: out.update(pipe.restore(*args)))
    launches, shapes, copies = read_counts()
    return out, launches, shapes, copies, ms


def expected_launches(flags: tuple) -> dict:
    fused_conv, fused_proj, fused_swin = flags
    want = {name: expected or 0 for name, (_, _, expected, _) in KERNELS.items()}
    want.update({name: expected if fused_conv else 0
                 for name, (_, expected) in CONV_KERNELS.items()})
    want.update({name: (expected or 0) if fused_proj else 0
                 for name, (_, _, expected) in PROJ_KERNELS.items()})
    want.update({name: expected if fused_swin else 0
                 for name, (_, _, expected) in SWIN_KERNELS.items()})
    want.update({name: 0 for name in BWD_KERNELS})  # a restore has no backward
    return want


def verdict(base_runs: list, new_runs: list, default: bool) -> dict:
    """``edtr_tpu/ops/dispatch.py``'s rule on interleaved pairs (base, new):
    the new configuration is the default only when it wins a clear majority
    of pairs and its median is more than 5% (the drift between runs) below;
    the base when the base wins a clear majority; else unresolved. Pair i
    is the i-th run of each, as many pairs as the shorter list has."""
    n = min(len(base_runs), len(new_runs))
    base_runs, new_runs = base_runs[:n], new_runs[:n]
    wins = sum(nw < bs for bs, nw in zip(base_runs, new_runs))
    need = sign_test_wins(n)
    ratio = statistics.median(new_runs) / statistics.median(base_runs)
    if wins >= need and ratio < 0.95:
        word = "new"
    elif n - wins >= need:
        word = "base"
    else:
        word = "unresolved"
    return dict(ratio=ratio, wins=wins, pairs=n, wins_needed=need, verdict=word,
                default_by_rule=word == "new", default_in_code=default,
                default_agrees=(word == "new") == default)


def restore_args(device) -> tuple:
    """The restore's seeded inputs: (lq, c_txt, noise, step_noise); c_txt
    None, so the restore computes the empty prompt's CLIP embedding (its
    ``text`` stage), as JAX's restore does."""
    g = torch.Generator(device=device).manual_seed(1)
    lat = IMAGE // 8
    return (torch.rand((1, IMAGE, IMAGE, 3), generator=g, device=device), None,
            torch.randn((1, lat, lat, 4), generator=g, device=device),
            torch.randn((4, 1, lat, lat, 4), generator=g, device=device))


def restore_phase(device) -> tuple:
    from torch.profiler import record_function

    from edtr_torch.models.layers import randomize_
    from edtr_torch.pipeline import (FUSED_CONV_DEFAULT, FUSED_PROJ_DEFAULT,
                                     FUSED_SWIN_DEFAULT, build_flagship)
    from edtr_torch.profile_restore import STAGES, trace_restores

    cfgs = configs()
    t0 = time.perf_counter()
    pipe = build_flagship(tiny=False, dtype=torch.bfloat16, device=device)
    randomize_(pipe, torch.Generator(device=device).manual_seed(0)).eval()
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in pipe.parameters())
    print(f"pipeline: EDTR-s4 full width, {n_params} params (fp32), bf16 compute, "
          f"built + randomised in {time.perf_counter() - t0:.1f} s; configurations "
          f"{cfgs} (pipeline.fused_conv, pipeline.fused_proj, pipeline.fused_swin)",
          flush=True)

    def configured(cfg):
        pipe.fused_conv, pipe.fused_proj, pipe.fused_swin = cfgs[cfg]
        return pipe

    args = restore_args(device)
    lq, _, noise, step_noise = args
    lat = IMAGE // 8

    # the main paths: counts set to 0 just before each, read just after
    counted = {}
    for cfg in cfgs:
        first_ms = host_ms(lambda: configured(cfg).restore(*args))
        torch.cuda.reset_peak_memory_stats()
        out, launches, shapes, copies, ms = counted_restore(configured(cfg), args)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        counted[cfg] = dict(out=out, launches=launches, shapes=shapes, copies=copies)
        print(f"restore {cfg}: first call {first_ms:.1f} ms, counted call {ms:.1f} ms, "
              f"launches {launches}, layout copies {copies}, peak memory "
              f"{peak:.2f} GiB", flush=True)
        for name in ("restored", "pre_restored"):
            check(tuple(out[name].shape) == (1, IMAGE, IMAGE, 3), f"{cfg} {name} shape")
        check(tuple(out["z"].shape) == (1, lat, lat, 4), f"{cfg} z shape")
        for name, t in out.items():
            check(bool(torch.isfinite(t).all()), f"{cfg} {name} finite")
        want = expected_launches(cfgs[cfg])
        check(launches == want, f"{cfg} launches {launches}, want {want}")
        fused_conv, fused_proj, fused_swin = cfgs[cfg]
        if fused_conv:
            check(copies == dict(conv=0, proj=0), f"{cfg} layout copies {copies}")
        if fused_proj:
            by_k = {k: sum(n for key, n in shapes["proj"].items()
                           if key[0] == "ln_matmuls" and key[5] == k) for k in (1, 3)}
            check(by_k == {1: 84, 3: 84}, f"{cfg} ln_matmuls launches by K {by_k}")
        if fused_swin:
            masked = sum(n for key, n in shapes["swin"].items()
                         if key[0] == "window_attention" and key[5])
            check(masked == SWIN_MASKED, f"{cfg} masked window attention launches {masked}")
    vs_stock = {cfg: {name: rel_l2(counted[cfg]["out"][name], counted["stock"]["out"][name])
                      for name in ("pre_restored", "z", "restored")}
                for cfg in cfgs if cfg != "stock"}
    print("restore vs stock, relative L2:", json.dumps(vs_stock), flush=True)
    for cfg, rels in vs_stock.items():
        for name, rel in rels.items():
            check(rel <= TOL_FUSED_REL, f"{cfg} vs stock {name}: relative L2 {rel} > "
                                        f"{TOL_FUSED_REL}")

    # stage breakdown, named as bench.py:_run_split names them; each stage
    # under its own profiler range for the traced passes below
    x = lq.permute(0, 3, 1, 2)
    stages = {cfg: {s: [] for s in STAGES} for cfg in cfgs}
    res = {}

    def chain(cfg):
        def timed(stage, fn):
            with record_function(stage):
                stages[cfg][stage].append(host_ms(lambda: res.update({stage: fn()})))
            return res[stage]

        def run():
            configured(cfg)
            pre = timed("swinir", lambda: pipe.pre_restore(x))
            z = timed("vae_encode", lambda: pipe.encode(pre))
            c_txt = timed("text", lambda: pipe.text(1))
            z0 = timed("scan", lambda: pipe.denoise(z, c_txt, noise.permute(0, 3, 1, 2),
                                                    step_noise.permute(0, 1, 4, 2, 3)))
            timed("decode+wavelet", lambda: pipe.decode(z0, pre))
        return run

    e2e = {cfg: [] for cfg in cfgs}
    for i in range(max(TIME_ITERS, PROJ_PAIRS)):  # in turns, reversed every other round
        order = list(cfgs) if i < TIME_ITERS else ["fused", "fused+proj"]
        for cfg in (order if i % 2 == 0 else order[::-1]):
            chain(cfg)()
            e2e[cfg].append(host_ms(lambda: configured(cfg).restore(*args)))
    timing = {}
    for cfg in cfgs:
        stage_ms = {s: statistics.median(v) for s, v in stages[cfg].items()}
        e2e_ms = statistics.median(e2e[cfg])
        print(f"stages_ms {cfg}:", json.dumps(stage_ms), flush=True)
        print(f"e2e {cfg}: {e2e_ms:.2f} ms/img (median of {len(e2e[cfg])}: {e2e[cfg]}; bs 1, "
              f"512², host clock around synchronised calls)", flush=True)
        t0 = time.perf_counter()
        trace = trace_restores(chain(cfg), TRACE_ITERS)
        print(f"trace {cfg} of {TRACE_ITERS} restores ({time.perf_counter() - t0:.1f} s):",
              json.dumps(trace), flush=True)
        htod = trace["stages"]["swinir"]["htod_memcpy"]
        check(htod == 0, f"{cfg}: {htod} host-to-device copies per swinir stage")
        timing[cfg] = dict(stage_ms=stage_ms, e2e_ms=e2e_ms, e2e_runs_ms=e2e[cfg],
                           trace=trace)
    # pair i: the i-th restore of each configuration, run next to each other;
    # reported, not a failed check: host timing on a shared machine is not a
    # correctness result, and PERF.md weighs the runs together
    # the Swin switch changes the swinir stage alone: its verdict reads that
    # stage's pairs, with the end-to-end pairs printed beside them
    for what, base, new, default, runs in (
            ("conv", "stock", "fused", FUSED_CONV_DEFAULT, e2e),
            ("proj", "fused", "fused+proj", FUSED_PROJ_DEFAULT, e2e),
            ("swin", "fused", "fused+swin", FUSED_SWIN_DEFAULT,
             {cfg: stages[cfg]["swinir"][:TIME_ITERS] for cfg in cfgs})):  # not the traced
        v = verdict(runs[base], runs[new], default)
        scope = "end to end" if runs is e2e else "swinir stage"
        print(f"{scope}, {what}: {new}/{base} {v['ratio']:.4f} "
              f"({statistics.median(runs[base]):.2f} {base} vs "
              f"{statistics.median(runs[new]):.2f} {new} ms); {new} won {v['wins']} of "
              f"{v['pairs']} pairs (a clear majority: {v['wins_needed']}); verdict "
              f"{v['verdict']} ({new} is new), on by the rule {v['default_by_rule']}, in the "
              f"code {default}"
              f"{'' if v['default_agrees'] else ' -- THIS RUN DISAGREES WITH THE DEFAULT'}",
              flush=True)
        if runs is not e2e:
            ve = verdict(e2e[base], e2e[new], default)
            print(f"  beside it, end to end: {new}/{base} {ve['ratio']:.4f}, {new} won "
                  f"{ve['wins']} of {ve['pairs']} pairs", flush=True)
            v["e2e"] = ve
        timing[f"verdict_{what}"] = dict(base=base, new=new, scope=scope, **v)
    timing["vs_stock_rel_l2"] = vs_stock
    return pipe, counted, timing


def norm_phase(pipe, device) -> dict:
    """The GroupNorm statistics of the fused configurations (channels-last
    activations): every ``gn_stats`` shape of one fused restore, recorded
    around ``GroupNorm32.fold``; at each, ``gn_stats`` on channels-last
    memory (the one-pass Welford form) against the two-pass form on the
    same memory (strided reductions) and on an NCHW copy (the stock path):
    equal to fp32 rounding, and the device ms of each, summed per restore."""
    from edtr_torch.models import layers
    from edtr_torch.ops._norms import gn_stats, gn_stats_two_pass

    calls = {}

    def rec(x, num_groups=32):
        if x.is_contiguous(memory_format=torch.channels_last) and not x.is_contiguous():
            key = (tuple(x.shape), num_groups)
            calls[key] = calls.get(key, 0) + 1
        return gn_stats(x, num_groups)
    pipe.fused_conv, pipe.fused_proj, pipe.fused_swin = configs()["fused"]
    layers.gn_stats = rec
    try:
        pipe.restore(*restore_args(device))
    finally:
        layers.gn_stats = gn_stats
    gen = torch.Generator(device=device).manual_seed(9)
    forms = {"channels_last": lambda x, xn, g: gn_stats(x, g),
             "two_pass_channels_last": lambda x, xn, g: gn_stats_two_pass(x, g),
             "two_pass_nchw": lambda x, xn, g: gn_stats_two_pass(xn, g)}
    per_restore = {name: 0.0 for name in forms}
    err = 0.0
    for (shape, groups), n in sorted(calls.items()):
        xn = (torch.randn(shape, generator=gen, device=device) * 2 + 0.5).to(torch.bfloat16)
        x = xn.contiguous(memory_format=torch.channels_last)
        want = gn_stats_two_pass(xn, groups)
        for got, ref in zip(gn_stats(x, groups), want):
            err = max(err, ((got - ref).abs() / (ref.abs() + 1e-3)).max().item())
        for name, fn in forms.items():
            per_restore[name] += n * device_ms(lambda: fn(x, xn, groups), 10,
                                                what=f"gn_stats {name} {tuple(x.shape)}")
    res = dict(calls_per_restore=sum(calls.values()), shapes=len(calls),
               device_ms_per_restore=per_restore, max_rel_err_vs_nchw=err,
               tol_rel=TOL_GN_STATS)
    print("gn_stats (fused restore's shapes, channels-last bf16):", json.dumps(res), flush=True)
    check(err <= TOL_GN_STATS, f"gn_stats channels-last vs NCHW: {err} > {TOL_GN_STATS}")
    return res


def cldm_phase(pipe, device) -> dict:
    from edtr_torch.models.layers import fused_conv, fused_proj
    from edtr_torch.ops.attention import force_plain

    g = torch.Generator(device=device).manual_seed(3)
    lat = (1, 4, IMAGE // 8, IMAGE // 8)
    x = torch.randn(lat, generator=g, device=device)
    cond = dict(c_img=torch.randn(lat, generator=g, device=device), c_txt=pipe.text(1))
    t = torch.full((1,), 200, dtype=torch.long, device=device)
    with torch.no_grad():
        with fused_conv(False):
            eps_k = pipe.cldm(x, t, cond)
            with force_plain():
                eps_p = pipe.cldm(x, t, cond)
        with fused_conv(True):
            eps_f = pipe.cldm(x, t, cond)
            with fused_proj(True):
                eps_fp = pipe.cldm(x, t, cond)
    for name, eps in (("flash", eps_k), ("fused", eps_f), ("fused+proj", eps_fp)):
        check(bool(torch.isfinite(eps).all()), f"{name} eps finite")
        check(tuple(eps.shape) == lat, f"{name} eps shape")
    res = dict(rel_l2=rel_l2(eps_k, eps_p), max_abs=(eps_k - eps_p).abs().max().item(),
               eps_rms=eps_p.pow(2).mean().sqrt().item(), tol_rel_l2=TOL_EPS_REL,
               fused_vs_stock_rel_l2=rel_l2(eps_f, eps_k),
               fused_vs_stock_max_abs=(eps_f - eps_k).abs().max().item(),
               fused_proj_vs_stock_rel_l2=rel_l2(eps_fp, eps_k),
               fused_proj_vs_stock_max_abs=(eps_fp - eps_k).abs().max().item(),
               tol_fused_rel_l2=TOL_FUSED_REL)
    print("cldm_eps kernels vs plain attention, fused and fused+proj vs stock:",
          json.dumps(res), flush=True)
    check(res["rel_l2"] <= TOL_EPS_REL, f"eps relative L2 {res['rel_l2']} > {TOL_EPS_REL}")
    for k in ("fused_vs_stock_rel_l2", "fused_proj_vs_stock_rel_l2"):
        check(res[k] <= TOL_FUSED_REL, f"{k} {res[k]} > {TOL_FUSED_REL}")
    return res


def text_phase(pipe, device) -> dict:
    """The CLIP text tower at full width (OpenCLIP ViT-H's, penultimate), the
    restore's ``text`` stage: the empty prompt's embedding in bf16 against
    an fp32 tower on the same weights, the port's kernels it launches
    (none: its biased 77-token attention and its GEMMs are stock, as JAX
    leaves them to XLA), host ms (median of 9) and a trace of 2
    (device-busy ms, kernels, host-to-device copies)."""
    from torch.profiler import record_function

    from edtr_torch.models.clip import CLIPTextEncoder
    from edtr_torch.profile_restore import trace_restores

    clip = pipe.cldm.clip
    zero_counts()
    got = pipe.text(1)
    launches, _, _ = read_counts()
    with torch.device(device):
        fp32 = CLIPTextEncoder(vocab_size=clip.vocab_size, width=clip.width,
                               heads=clip.transformer.resblocks[0].attn.heads,
                               layers=len(clip.transformer.resblocks) + 1)
    fp32.load_state_dict(clip.state_dict(), strict=True)
    with torch.no_grad():
        want = fp32.encode([""])
    del fp32
    check(tuple(got.shape) == (1, 77, clip.width) and got.dtype == torch.float32,
          f"text embedding {tuple(got.shape)} {got.dtype}")
    check(bool(torch.isfinite(got).all()), "text embedding finite")
    check(not any(launches.values()), f"the text tower launched port kernels: {launches}")
    rel = rel_l2(got, want)
    runs = [host_ms(lambda: pipe.text(1)) for _ in range(TIME_ITERS)]

    def chain():
        with record_function("text"):
            pipe.text(1)
    trace = trace_restores(chain, TRACE_ITERS, ("text",))
    st = trace["stages"]["text"]
    res = dict(params=sum(p.numel() for p in clip.parameters()), rel_l2_bf16_vs_fp32=rel,
               tol_rel_l2=TOL_TEXT_REL, host_ms=statistics.median(runs), runs_ms=runs,
               host_ms_traced=st["host_ms"], device_busy_ms=st["device_busy_ms"],
               idle_share=st["idle_share"], kernels=st["kernels"],
               htod_memcpy=st["htod_memcpy"], by_family_ms=trace["by_family_ms"])
    print("text (CLIP ViT-H text tower, empty prompt, bs 1, bf16 vs fp32):", json.dumps(res),
          flush=True)
    check(rel <= TOL_TEXT_REL, f"text bf16 vs fp32: relative L2 {rel} > {TOL_TEXT_REL}")
    return res


def detector_pair(device, images: torch.Tensor, build=None, seed: int = 7) -> tuple:
    """(bf16, fp32) detectors on one set of seeded random weights
    (``randomize_``: N(0, 1/fan_in) kernels), the layers after the body
    scaled to unit output RMS on ``images`` in fp32 (``calibrate_heads_``),
    so the heads' features stay O(1) and class scores pass the 0.05
    threshold, as trained weights' do. ``build(dtype=, device=)``: the
    detector (the MobileNet one, 21 classes, by default)."""
    from edtr_torch.models.faster_rcnn import calibrate_heads_, fasterrcnn_mobilenet_v3_large_fpn
    from edtr_torch.models.layers import randomize_

    if build is None:
        def build(**kw):
            return fasterrcnn_mobilenet_v3_large_fpn(num_classes=DETECT_CLASSES, **kw)
    fp32 = build(device=device)
    randomize_(fp32, torch.Generator(device=device).manual_seed(seed))
    calibrate_heads_(fp32, images)
    bf16 = build(dtype=torch.bfloat16, device=device)
    bf16.load_state_dict(fp32.state_dict(), strict=True)
    return bf16, fp32


def detect_phase(pipe, device) -> tuple:
    """Restore then detect (module docstring, phase 10): (the phase's
    results, the counted restore+detect's launches, shapes and copies)."""
    from torch.profiler import record_function

    from edtr_torch.ops import boxes
    from edtr_torch.pipeline import FUSED_CONV_DEFAULT, FUSED_PROJ_DEFAULT, FUSED_SWIN_DEFAULT
    from edtr_torch.profile_restore import RESTORE_DETECT_STAGES, trace_restores

    flags = (FUSED_CONV_DEFAULT, FUSED_PROJ_DEFAULT, FUSED_SWIN_DEFAULT)
    pipe.fused_conv, pipe.fused_proj, pipe.fused_swin = flags
    lq, _, noise, step_noise = restore_args(device)
    x, noise, step_noise = (lq.permute(0, 3, 1, 2), noise.permute(0, 3, 1, 2),
                            step_noise.permute(0, 1, 4, 2, 3))

    def restore():  # NCHW, as bench.py:_run_split's stages, the text one added
        pre = pipe.pre_restore(x)
        z = pipe.encode(pre)
        return pipe.decode(pipe.denoise(z, pipe.text(1), noise, step_noise), pre)

    def detect(img):  # the restored image clamped to [0, 1], as a detector takes it
        with torch.no_grad():
            return det(img.clamp(0, 1))

    t0 = time.perf_counter()
    restored = restore().clamp(0, 1)
    det, det32 = detector_pair(device, restored)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in det.parameters())
    print(f"detector: Faster R-CNN MobileNetV3-Large-FPN, {DETECT_CLASSES} classes, {n_params} "
          f"params (fp32), bf16 compute, built + randomised + calibrated in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    detect(restored)  # its anchors are made once per input shape

    # the main path, restore then detect: counts set to 0 just before, read just after
    zero_counts()
    boxes.host_syncs.update(calls=0, syncs=0)
    dets = {}
    ms = host_ms(lambda: dets.update(detect(restore())[0]))
    launches, shapes, copies = read_counts()
    syncs = dict(boxes.host_syncs)
    print(f"restore+detect counted: {ms:.1f} ms, launches {launches}, layout copies {copies}, "
          f"NMS calls {syncs['calls']} with {syncs['syncs']} host synchronisations",
          flush=True)
    check(launches == expected_launches(flags), f"restore+detect launches {launches}")
    if flags[0]:
        check(copies == dict(conv=0, proj=0), f"restore+detect layout copies {copies}")
    check(syncs["calls"] == 2, f"NMS calls per detect {syncs['calls']}, want 2 (RPN, box head)")
    check(tuple(dets["boxes"].shape) == (1, 100, 4), "detections' shape")
    check(all(bool(torch.isfinite(dets[k]).all()) for k in ("boxes", "scores")),
          "detections finite")
    valid = dets["valid"][0]
    labels = dets["labels"][0][valid]
    check(int(valid.sum()) > 0, "no valid detection")
    check(bool((dets["scores"][0][valid] > 0.05).all()), "valid scores above the threshold")
    check(bool(((labels >= 1) & (labels < DETECT_CLASSES)).all()), "valid labels are classes")
    bx = dets["boxes"][0][valid]
    check(bool((bx >= 0).all() and (bx <= IMAGE).all() and (bx[:, 2:] >= bx[:, :2]).all()),
          "valid boxes inside the 512² image")

    # bf16 against fp32 on the same image and weights; the class logits at
    # the bf16 run's proposals (manual_proposals), which the RPN's discrete
    # choices would otherwise move
    with torch.no_grad():
        _, _, f16 = det(restored)
        d32, _, f32 = det32(restored)
        ones = torch.ones(f16["proposals"].shape[:2], dtype=torch.bool, device=device)
        _, _, f32m = det32(restored, manual_proposals=(f16["proposals"], ones))
    rels = {f"fpn_{k}": rel_l2(f16["features"][k], f32["features"][k])
            for k in ("0", "1", "pool")}
    for key in ("objectness", "pred_bbox_deltas"):
        rels.update({f"{key}_{i}": rel_l2(a, b) for i, (a, b) in enumerate(zip(f16[key],
                                                                                f32[key]))})
    rels["class_logits_at_bf16_proposals"] = rel_l2(f16["class_logits"], f32m["class_logits"])
    for name, rel in rels.items():
        check(rel <= TOL_DETECT_REL, f"detector bf16 vs fp32 {name}: {rel} > {TOL_DETECT_REL}")
    check(int(d32["valid"].sum()) > 0, "no valid fp32 detection")

    # the stage split, named as bench.py:_run_split names it, and the
    # restore+detect ms/img; each stage under its own profiler range
    stages = {s: [] for s in RESTORE_DETECT_STAGES}
    out = {}

    def timed(stage, fn):
        with record_function(stage):
            stages[stage].append(host_ms(lambda: out.update({stage: fn()})))
        return out[stage]

    def chain():
        pre = timed("swinir", lambda: pipe.pre_restore(x))
        z = timed("vae_encode", lambda: pipe.encode(pre))
        c_txt = timed("text", lambda: pipe.text(1))
        z0 = timed("scan", lambda: pipe.denoise(z, c_txt, noise, step_noise))
        img = timed("decode+wavelet", lambda: pipe.decode(z0, pre))
        timed("detect", lambda: detect(img))

    e2e = []
    boxes.host_syncs.update(calls=0, syncs=0)
    for _ in range(TIME_ITERS):
        chain()
        e2e.append(host_ms(lambda: detect(restore())))
    sync_stats = dict(boxes.host_syncs)
    stage_ms = {s: statistics.median(v) for s, v in stages.items()}
    t0 = time.perf_counter()
    trace = trace_restores(chain, TRACE_ITERS, RESTORE_DETECT_STAGES)
    print(f"stages_ms restore+detect (pipeline defaults {flags}):", json.dumps(stage_ms),
          flush=True)
    print(f"e2e restore+detect: {statistics.median(e2e):.2f} ms/img (median of {len(e2e)}: "
          f"{e2e}; bs 1, 512² -> 800², host clock around synchronised calls)", flush=True)
    print(f"trace restore+detect of {TRACE_ITERS} ({time.perf_counter() - t0:.1f} s):",
          json.dumps(trace), flush=True)
    for stage in ("swinir", "detect"):
        htod = trace["stages"][stage]["htod_memcpy"]
        check(htod == 0, f"restore+detect: {htod} host-to-device copies per {stage} stage")

    # one call at bench.py's batch: eight placements of the restored image
    batch = torch.cat([restored.roll((37 * i, 53 * i), (2, 3)) for i in range(DETECT_BATCH)])
    detect(batch)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    boxes.host_syncs.update(calls=0, syncs=0)
    res8 = {}
    runs8 = [host_ms(lambda: res8.update(dets=detect(batch)[0])) for _ in range(5)]
    peak = torch.cuda.max_memory_allocated()
    valid8 = res8["dets"]["valid"].sum(1).tolist()
    check(min(valid8) > 0, f"bs {DETECT_BATCH}: valid detections per image {valid8}")
    det_trace = trace["stages"]["detect"]
    res = dict(
        params=n_params, configuration=dict(zip(("fused_conv", "fused_proj", "fused_swin"),
                                                flags)),
        rel_l2_vs_fp32=rels, tol_rel_l2=TOL_DETECT_REL, valid_detections=int(valid.sum()),
        valid_detections_fp32=int(d32["valid"].sum()), stage_ms=stage_ms,
        e2e_ms=statistics.median(e2e), e2e_runs_ms=e2e,
        detect_stage=dict(host_ms=stage_ms["detect"], host_ms_traced=det_trace["host_ms"],
                          device_busy_ms=det_trace["device_busy_ms"],
                          idle_share=det_trace["idle_share"], kernels=det_trace["kernels"],
                          htod_memcpy=det_trace["htod_memcpy"]),
        nms_host_syncs_per_call=sync_stats["syncs"] / sync_stats["calls"], trace=trace,
        batch=dict(bs=DETECT_BATCH, ms=statistics.median(runs8), runs_ms=runs8,
                   ms_per_img=statistics.median(runs8) / DETECT_BATCH,
                   peak_memory_gib=peak / 2 ** 30,
                   call_peak_gib=(peak - before) / 2 ** 30,
                   valid_detections_per_img=valid8,
                   nms_host_syncs_per_call=boxes.host_syncs["syncs"] / boxes.host_syncs["calls"]))
    print("detect (bf16, bs 1, restored 512² -> 800²; bs-8 call):",
          json.dumps({k: v for k, v in res.items() if k != "trace"}), flush=True)
    counts = dict(launches=launches, shapes=shapes, copies=copies)
    return res, counts


def train_phase(device) -> dict:
    """The full-width training step (module docstring, phase 13)."""
    from edtr_torch.models.layers import randomize_
    from edtr_torch.pipeline import build_flagship
    from edtr_torch.profile_restore import TRAIN_STAGES, trace_restores
    from edtr_torch.train.edtr_step import EDTRTrainState, make_edtr_train_step

    t0 = time.perf_counter()
    pipe = build_flagship(tiny=False, dtype=torch.bfloat16, device=device, train=True)
    randomize_(pipe, torch.Generator(device=device).manual_seed(0))
    seeded = host_weights(pipe)  # the generic steps start from them
    state = EDTRTrainState.create(pipe)
    step = make_edtr_train_step(pipe)
    params = dict(pipe.named_parameters())
    trainable = {n: p for n, p in params.items() if p.requires_grad}
    frozen = {n: p for n, p in params.items() if not p.requires_grad}
    torch.cuda.synchronize()
    print(f"train: EDTR-s4 full width, train=True (remat), {sum(p.numel() for p in trainable.values())}"
          f" trainable (ControlNet + VAE decoder) and {sum(p.numel() for p in frozen.values())} "
          f"frozen params (fp32), bf16 compute, built + randomised in "
          f"{time.perf_counter() - t0:.1f} s; configuration (fused_conv, fused_proj, fused_swin) "
          f"{(pipe.fused_conv, pipe.fused_proj, pipe.fused_swin)}", flush=True)
    check(all(n.startswith(("cldm.controlnet.", "cldm.vae.decoder.")) for n in trainable),
          "trainable partition")
    g = torch.Generator(device=device).manual_seed(2)
    lat = IMAGE // 8
    batch = dict(lq=torch.rand((TRAIN_BATCH, IMAGE, IMAGE, 3), generator=g, device=device),
                 gt=torch.rand((TRAIN_BATCH, IMAGE, IMAGE, 3), generator=g, device=device),
                 c_txt=pipe.text(TRAIN_BATCH))  # the empty prompt's, once
    t, noise = step.draw(torch.empty((TRAIN_BATCH, 4, lat, lat), device=device), g)

    # one step's gradients on the plain path (plain attention, stock convs,
    # stock SwinIR, stock projections), then on the kernel path in the
    # pipeline's configuration and with fused_proj on, same weights, batch,
    # t and noise; the fused_proj step counted (counts set to 0 just before
    # it, read just after)
    with pipe_path(pipe, False):
        loss_p = step.grads(state, batch, t, noise).item()
    grads_p = {n: p.grad.detach().clone() for n, p in trainable.items()}
    loss_k = step.grads(state, batch, t, noise).item()
    grads_k = {n: p.grad.detach().clone() for n, p in trainable.items()}
    fused_proj = pipe.fused_proj
    pipe.fused_proj = True
    zero_counts()
    loss_kp = step.grads(state, batch, t, noise).item()
    launches_proj, shapes_proj, _ = read_counts()
    pipe.fused_proj = fused_proj
    grads_kp = {n: p.grad.detach().clone() for n, p in trainable.items()}
    cmp = {}
    for what, loss, grads in (("kernel", loss_k, grads_k), ("kernel_fused_proj", loss_kp,
                                                              grads_kp)):
        check(all(bool(torch.isfinite(v).all()) for v in grads.values()),
              f"{what}-path grads finite")
        rel = {part.strip(".") or "all": rel_l2_over(
                   grads, grads_p, [n for n in trainable if n.startswith(part)])
               for part in ("cldm.controlnet.", "cldm.vae.decoder.", "")}
        cmp[what] = dict(loss=loss, loss_rel=abs(loss - loss_p) / abs(loss_p),
                         grads_rel_l2=rel)
    del grads_p, grads_k, grads_kp
    cmp.update(loss_plain=loss_p, tol_grad_rel_l2=TOL_GRAD_REL, tol_loss_rel=TOL_TRAIN_LOSS,
               fused_proj_launches=launches_proj)
    print("train grads kernel path (pipeline configuration; fused_proj on) vs plain path "
          "(plain attention, stock convs, stock SwinIR, stock projections):", json.dumps(cmp),
          flush=True)
    check(math.isfinite(loss_k) and math.isfinite(loss_kp) and math.isfinite(loss_p),
          "train losses finite")
    for what in ("kernel", "kernel_fused_proj"):
        check(cmp[what]["loss_rel"] <= TOL_TRAIN_LOSS,
              f"train loss {what} vs plain {cmp[what]['loss_rel']}")
        for part, r in cmp[what]["grads_rel_l2"].items():  # each part alone
            check(r <= TOL_GRAD_REL, f"train grads {what} vs plain, {part}: relative L2 {r}")
    check(launches_proj == TRAIN_LAUNCHES_PROJ,
          f"fused_proj train launches {launches_proj}, want {TRAIN_LAUNCHES_PROJ}")

    before = {n: p.detach().clone() for n, p in params.items()}
    for _ in range(TRAIN_WARMUP):
        step(state, batch, generator=g)
    # the main path: counts set to 0 just before the step, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    out = {}
    first_ms = host_ms(lambda: out.update(step(state, batch, t, noise)))
    launches, shapes, _ = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss = out["loss_hlf"].item()
    print(f"train step counted: {first_ms:.1f} ms, loss_hlf {loss}, launches {launches}, peak "
          f"memory {peak:.2f} GiB (max_memory_allocated)", flush=True)
    check(launches == TRAIN_LAUNCHES, f"train launches {launches}, want {TRAIN_LAUNCHES}")
    check(math.isfinite(loss), "train loss finite")
    check(all(bool(torch.isfinite(p.grad).all()) for p in trainable.values()), "train grads finite")

    # the step as a caller makes it, timed on the host clock; its phases
    # from a trace of one more step (the step's own profiler ranges)
    steps = [host_ms(lambda: step(state, batch, generator=g)) for _ in range(TRAIN_TIMED)]
    t0 = time.perf_counter()
    trace = trace_restores(lambda: step(state, batch, generator=g), 1, TRAIN_STAGES)
    timing = dict(step_ms=statistics.median(steps), step_runs_ms=steps,
                  phase_host_ms_traced={s: trace["stages"][s]["host_ms"] for s in TRAIN_STAGES},
                  peak_memory_gib=peak, batch=TRAIN_BATCH, image=IMAGE)
    print(f"train step: {timing['step_ms']:.2f} ms (median of {TRAIN_TIMED}, bs {TRAIN_BATCH}, "
          f"512², host clock around synchronised steps; phases from the traced step):",
          json.dumps(timing), flush=True)
    print(f"trace of one train step ({time.perf_counter() - t0:.1f} s):", json.dumps(trace),
          flush=True)

    moved = [n for n in trainable if not torch.equal(params[n], before[n])]
    changed = [n for n in frozen if not torch.equal(params[n], before[n])]
    print(f"train: {len(moved)} of {len(trainable)} trainable tensors moved, {len(changed)} of "
          f"{len(frozen)} frozen tensors changed after {state.step} steps", flush=True)
    check(len(moved) == len(trainable), "every trainable tensor moved")
    check(not changed, f"frozen tensors changed: {changed[:5]}")
    # the optimizer's in-place updates reach the kernels' cached bf16 weights,
    # the nearest-2x convs' folded ones included
    from edtr_torch.ops.gn_conv import fold_subpixel_weights, pack_weight

    convs = [m for name, m in pipe.named_modules() if name.startswith(
        ("cldm.controlnet.", "cldm.vae.decoder.")) and hasattr(m, "packed_weight")
             and m.weight.ndim == 4 and m.weight.shape[-1] == 3]
    stale = [c for c in convs if not torch.equal(c.packed_weight(torch.bfloat16),
                                                 pack_weight(c.weight, torch.bfloat16))]
    check(convs and not stale, f"{len(stale)} of {len(convs)} cached conv weights stale")
    ups = [c for c in convs if c._folded.value is not None]
    stale = [c for c in ups if not torch.equal(c.folded_weight(torch.bfloat16),
                                               fold_subpixel_weights(c.weight, torch.bfloat16))]
    check(ups and not stale, f"{len(stale)} of {len(ups)} cached folded conv weights stale")
    return dict(launches=launches, shapes=shapes, loss_hlf=loss, kernel_vs_plain=cmp,
                launches_fused_proj=launches_proj, shapes_fused_proj=shapes_proj["proj"],
                timing=timing, trace=trace, steps=state.step, pipe=pipe, seeded_weights=seeded)


def det_targets(device, gen: torch.Generator, batch: int = TRAIN_BATCH) -> dict:
    """Seeded padded targets of the detector step: 1 to DET_BOXES - 1 valid
    boxes an image (a slot padded at least), sides in DET_SIDES, inside the
    512² image, labels 1-20."""
    lo, hi = DET_SIDES
    n = torch.randint(1, DET_BOXES, (batch,), generator=gen, device=device)
    wh = lo + torch.rand((batch, DET_BOXES, 2), generator=gen, device=device) * (hi - lo)
    xy = torch.rand((batch, DET_BOXES, 2), generator=gen, device=device) * (IMAGE - wh)
    valid = torch.arange(DET_BOXES, device=device)[None] < n[:, None]
    labels = torch.randint(1, DETECT_CLASSES, (batch, DET_BOXES), generator=gen,
                           device=device)
    return dict(boxes=torch.cat([xy, xy + wh], -1) * valid[..., None], labels=labels * valid,
                valid=valid)


def box_images(device, gen: torch.Generator, targets: dict) -> torch.Tensor:
    """(B, 3, 512, 512) images in [0, 1]: noise around grey, each valid box
    of ``targets`` painted in its class's colour (later boxes over
    earlier ones)."""
    palette = torch.rand((DETECT_CLASSES, 3), generator=torch.Generator().manual_seed(3))
    colours = palette.to(device)[targets["labels"]]
    b = targets["boxes"].shape[0]
    img = (0.5 + 0.2 * torch.randn((b, 3, IMAGE, IMAGE), generator=gen, device=device)).clamp(0, 1)
    pix = torch.arange(IMAGE, device=device) + 0.5
    for j in range(targets["boxes"].shape[1]):
        x0, y0, x1, y1 = (c[:, None, None] for c in targets["boxes"][:, j].unbind(-1))
        inside = ((pix[None, None] >= x0) & (pix[None, None] < x1) & (pix[None, :, None] >= y0)
                  & (pix[None, :, None] < y1) & targets["valid"][:, j, None, None])
        img = torch.where(inside[:, None], colours[:, j, :, None, None], img)
    return img


@contextlib.contextmanager
def computing_in(dtype: torch.dtype, *modules):
    """Inside the block every submodule of ``modules`` that computes in a
    dtype of its own (``.dtype``: bf16 here) computes in ``dtype``, its
    stored weights cast at each call as ever: the plain path's fp32 run,
    the control that reads how far bf16 alone moves a result."""
    saved = [(m, m.dtype) for module in modules for m in module.modules()
             if isinstance(getattr(m, "dtype", None), torch.dtype)]
    for m, _ in saved:
        m.dtype = dtype
    try:
        yield
    finally:
        for m, d in saved:
            m.dtype = d


@contextlib.contextmanager
def pipe_path(pipe, kernel: bool, flash: bool = None):
    """Inside the block ``pipe`` runs its kernel path (its configuration)
    or, with ``kernel`` False, the plain path: stock convs, stock SwinIR,
    stock projections and plain attention; with ``flash`` True as well the
    stock configuration (the flash kernels on)."""
    from edtr_torch.ops.attention import force_plain

    flags = pipe.fused_conv, pipe.fused_proj, pipe.fused_swin
    if not kernel:
        pipe.fused_conv = pipe.fused_proj = pipe.fused_swin = False
    try:
        with force_plain(not (kernel if flash is None else flash)):
            yield
    finally:
        pipe.fused_conv, pipe.fused_proj, pipe.fused_swin = flags


def step_kernel_vs_plain(step, state, batch: dict, t: torch.Tensor, noise: torch.Tensor,
                         draws: dict, trainable: dict, task_params: dict,
                         seed: int = None) -> dict:
    """A two-half step's kernel path against its plain path (plain
    attention, stock convs, stock SwinIR, stock projections) on the same
    weights, batch and draws (a detector's sampler draws from a generator
    seeded ``seed`` anew for each path), the task net's running statistics
    put back after each half; and the control: the plain path computing in
    fp32 (:func:`computing_in`) on the same stored weights and draws.

    ``gated_rel_l2``: (1) the EDTR half's ControlNet and decoder gradients
    for one cotangent of its restored image, the plain path's d loss / d
    restored of the step's HLF, the kernels' forward and backward as the
    restoration-only step holds them; (2) the task-net half's restored image
    from the walk, the kernels' only way into that half.
    ``cotangent_rel_l2_reported``: (1) for the pixel L1's cotangent.
    ``step_grads_rel_l2``: the step's own gradients of both halves, where
    the L1 losses' signs, the nets' ReLU gates and train-mode norms (and a
    detector's top-k, NMS and matching) turn the paths' ~1e-2 differences
    of the restored images into larger ones. ``control``: each of these for
    the plain path against its fp32 run (bf16's own distance) and for the
    kernel path against it. Every path's losses must be finite."""

    pipe = step.pipe
    student, teacher = step.task.student, step.task.teacher
    stats0 = {n: b.clone() for n, b in student.named_buffers()}
    losses = {"hlf": step.hlf, "pixel": lambda res, gt: (res - gt).abs().mean()}

    def edtr_vjp(kind, cot=None):
        state.tx_edtr.zero_grad(set_to_none=True)
        with pipe.configuration():
            sh = step.shared(batch)
            res = step.restored(sh, t, noise)
            if cot is None:
                leaf = res.detach().requires_grad_()
                cot = torch.autograd.grad(losses[kind](leaf, sh[0]), leaf)[0]
            res.backward(cot.to(res.dtype))
        return cot, {n: p.grad.detach().clone() for n, p in trainable.items()}

    def walk():
        sh = step.shared(batch)
        z = pipe.denoise(sh[2][:1], sh[3][:1], draws["noise"], draws["step_noise"])
        return pipe.decode(z, sh[1][:1])

    def run(cots=None):
        """(d loss / d restored of each loss, the EDTR half's gradients for
        each, the walk's image, the step's losses, its own gradients of the
        EDTR half and of the task net)."""
        vjps = {kind: edtr_vjp(kind, None if cots is None else cots[kind])
                for kind in ("hlf", "pixel")}
        img = walk()
        gen = None if seed is None else torch.Generator(device=t.device).manual_seed(seed)
        loss = step.grads(state, batch, t, noise).item()
        eg = {n: p.grad.detach().clone() for n, p in trainable.items()}
        m = step.task_grads(state, batch, [step.shared(batch)], [draws], gen)
        tg = {n: p.grad.detach().clone() for n, p in task_params.items()}
        with torch.no_grad():
            for n, b in student.named_buffers():
                b.copy_(stats0[n])
        m = dict(loss_hlf=loss, **{k: v.item() for k, v in m.items()})
        return ({k: v[0] for k, v in vjps.items()}, {k: v[1] for k, v in vjps.items()},
                img, m, eg, tg)

    with pipe_path(pipe, False):
        plain = run()
        again = run(plain[0])
        with computing_in(torch.float32, pipe, student, teacher):
            fp32 = run(plain[0])
    kernel = run(plain[0])

    parts = {part: [n for n in trainable if n.startswith(f"cldm.{part}.")]
             for part in ("controlnet", "vae.decoder")}

    def compare(a, b):
        by_cot = {kind: {part: rel_l2_over(a[1][kind], b[1][kind], names)
                         for part, names in parts.items() if names} for kind in a[1]}
        own = {part: rel_l2_over(a[4], b[4], names) for part, names in parts.items() if names}
        own["tasknet"] = rel_l2_over(a[5], b[5], list(task_params))
        return dict(hlf=by_cot["hlf"], pixel=by_cot["pixel"], walk_restored=rel_l2(a[2], b[2]),
                    step_grads=own)

    for what, r in (("kernel", kernel), ("plain", plain), ("fp32 plain", fp32)):
        check(all(math.isfinite(v) for v in r[3].values()), f"{what}-path step losses {r[3]}")
    kp = compare(kernel, plain)
    return dict(losses_kernel=kernel[3], losses_plain=plain[3], losses_plain_fp32=fp32[3],
                tol_rel_l2=TOL_GRAD_REL, gated_cotangent="hlf",
                gated_rel_l2=dict(kp["hlf"], walk_restored=kp["walk_restored"]),
                cotangent_rel_l2_reported=dict(pixel=kp["pixel"]),
                step_grads_rel_l2=kp["step_grads"],
                control=dict(plain_vs_plain_again=compare(again, plain),
                             plain_vs_fp32=compare(plain, fp32),
                             kernel_vs_fp32=compare(kernel, fp32)))


def train_det_phase(pipe, device) -> dict:
    """The full-width EDTR step with a detector (module docstring, phase
    14), on the training pipeline of :func:`train_phase`."""
    import copy

    from edtr_torch.ops import boxes
    from edtr_torch.ops.gn_conv import pack_weight
    from edtr_torch.profile_restore import TRAIN_STAGES, trace_restores
    from edtr_torch.train.edtr_step import (EDTRTrainState, cast_frozen_bf16,
                                            make_edtr_train_step)

    t0 = time.perf_counter()
    g = torch.Generator(device=device).manual_seed(4)
    lat = IMAGE // 8
    targets = det_targets(device, g)
    gt = box_images(device, g, targets)
    lq = (gt + 0.1 * torch.randn(gt.shape, generator=g, device=device)).clamp(0, 1)
    batch = dict(lq=lq.permute(0, 2, 3, 1), gt=gt.permute(0, 2, 3, 1),
                 c_txt=pipe.text(TRAIN_BATCH), targets=targets)
    t, noise = make_edtr_train_step(pipe).draw(
        torch.empty((TRAIN_BATCH, 4, lat, lat), device=device), g)
    student, _ = detector_pair(device, gt)
    teacher = copy.deepcopy(student)
    state = EDTRTrainState.create(pipe, detnet=student, teacher_detnet=teacher)
    step = make_edtr_train_step(pipe, detnet=student, teacher_detnet=teacher)
    params = dict(pipe.named_parameters())
    trainable = {n: p for n, p in params.items() if p.requires_grad}
    frozen = {n: p for n, p in params.items() if not p.requires_grad}
    det_params = dict(student.named_parameters())
    det_train = {n: p for n, p in det_params.items() if p.requires_grad}
    det_frozen = {n: p for n, p in det_params.items() if not p.requires_grad}

    def nbytes(ts):
        return sum(t.numel() * t.element_size() for t in ts)

    bytes_before = nbytes(list(frozen.values()) + list(teacher.state_dict().values()))
    cast_frozen_bf16(pipe, pipe.cldm.vae.train_decoder, teacher)
    bytes_after = nbytes(list(frozen.values()) + list(teacher.state_dict().values()))
    # the kernels' cached bf16 weights follow the cast weights
    convs = [m for name, m in pipe.named_modules() if name.startswith("cldm.unet.")
             and hasattr(m, "packed_weight") and m.weight.ndim == 4 and m.weight.shape[-1] == 3]
    stale = [c for c in convs if not torch.equal(c.packed_weight(torch.bfloat16),
                                                 pack_weight(c.weight, torch.bfloat16))]
    check(convs and not stale and all(c.weight.dtype == torch.bfloat16 for c in convs),
          f"{len(stale)} of {len(convs)} cast UNet conv weights' caches stale")
    torch.cuda.synchronize()
    print(f"train with a detector: student and teacher Faster R-CNN MobileNetV3-Large-FPN, "
          f"{DETECT_CLASSES} classes, bf16 compute, norm_frozen {student.norm_frozen}, "
          f"{sum(p.numel() for p in det_train.values())} trainable and "
          f"{sum(p.numel() for p in det_frozen.values())} frozen detnet params; "
          f"cast_frozen_bf16: frozen pipeline + teacher {bytes_before / 2 ** 30:.3f} -> "
          f"{bytes_after / 2 ** 30:.3f} GiB; targets valid per image "
          f"{batch['targets']['valid'].sum(1).tolist()}; set up in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    draws = dict(noise=torch.randn((1, 4, lat, lat), generator=g, device=device),
                 step_noise=torch.randn((4, 1, 4, lat, lat), generator=g, device=device),
                 uniforms=None)

    cmp = step_kernel_vs_plain(step, state, batch, t, noise, draws, trainable, det_train,
                               seed=6)
    print("train with a detector, kernel path vs plain path (gated: the EDTR half's "
          "gradients for the plain path's cotangent of the restored image under the step's "
          "HLF, the walk's restored image; reported: the same under the pixel L1, the step's "
          "own gradients, and each of them for the plain path computing in fp32):",
          json.dumps(cmp), flush=True)
    for part, r in cmp["gated_rel_l2"].items():
        check(r <= TOL_GRAD_REL, f"detector step kernel vs plain, {part}: relative L2 {r}")

    before = {n: p.detach().clone() for n, p in params.items()}
    det_before = {n: v.clone() for n, v in student.state_dict().items()}
    teacher_before = {n: v.clone() for n, v in teacher.state_dict().items()}
    for _ in range(TRAIN_WARMUP):
        step(state, batch, generator=g)
    # the main path: counts set to 0 just before the step, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    boxes.host_syncs.update(calls=0, syncs=0)
    out = {}
    first_ms = host_ms(lambda: out.update(step(state, batch, t, noise, generator=g,
                                                task_draws=[draws])))
    launches, shapes, _ = read_counts()
    syncs = dict(boxes.host_syncs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    metrics = {k: v.item() for k, v in out.items()}
    print(f"train step with a detector counted: {first_ms:.1f} ms, metrics {metrics}, launches "
          f"{launches}, NMS calls {syncs['calls']} with {syncs['syncs']} host synchronisations, "
          f"peak memory {peak:.2f} GiB (max_memory_allocated)", flush=True)
    check(set(metrics) == {"loss_hlf", "loss_det", "loss_fm", "loss_objectness",
                           "loss_rpn_box_reg", "loss_classifier", "loss_box_reg"},
          f"detector step metrics {sorted(metrics)}")
    check(all(math.isfinite(v) for v in metrics.values()), f"detector step losses {metrics}")
    check(launches == TRAIN_LAUNCHES_DET,
          f"detector step launches {launches}, want {TRAIN_LAUNCHES_DET}")

    steps = [host_ms(lambda: step(state, batch, generator=g)) for _ in range(TRAIN_TIMED)]
    t0 = time.perf_counter()
    trace = trace_restores(lambda: step(state, batch, generator=g), 1, TRAIN_STAGES)
    timing = dict(step_ms=statistics.median(steps), step_runs_ms=steps,
                  phase_host_ms_traced={s: trace["stages"][s]["host_ms"] for s in TRAIN_STAGES},
                  phase_device_busy_ms_traced={s: trace["stages"][s]["device_busy_ms"]
                                               for s in TRAIN_STAGES},
                  peak_memory_gib=peak, batch=TRAIN_BATCH, image=IMAGE,
                  frozen_bytes_before_cast=bytes_before, frozen_bytes_after_cast=bytes_after)
    print(f"train step with a detector: {timing['step_ms']:.2f} ms (median of {TRAIN_TIMED}, bs "
          f"{TRAIN_BATCH}, 512², host clock around synchronised steps; phases from the traced "
          f"step):", json.dumps(timing), flush=True)
    print(f"trace of one train step with a detector ({time.perf_counter() - t0:.1f} s):",
          json.dumps(trace), flush=True)

    moved = [n for n in trainable if not torch.equal(params[n], before[n])]
    changed = [n for n in frozen if not torch.equal(params[n], before[n])]
    det_now = student.state_dict()
    det_moved = [n for n in det_train if not torch.equal(det_now[n], det_before[n])]
    det_changed = [n for n in det_frozen if not torch.equal(det_now[n], det_before[n])]
    frozen_stages = {n.split(".")[3] for n in det_frozen if n.startswith("backbone.body.")}
    stats = [n for n in det_now if n.endswith(("running_mean", "running_var"))
             and n.startswith("backbone.body.features.") and n.split(".")[3] in frozen_stages]
    stats_moved = [n for n in stats if not torch.equal(det_now[n], det_before[n])]
    teacher_changed = [n for n, v in teacher.state_dict().items()
                       if not torch.equal(v, teacher_before[n])]
    res = dict(moved=len(moved), trainable=len(trainable), frozen_changed=len(changed),
               detnet_moved=len(det_moved), detnet_trainable=len(det_train),
               detnet_frozen_changed=len(det_changed), frozen_stages=sorted(frozen_stages, key=int),
               frozen_stage_stats_moved=len(stats_moved), frozen_stage_stats=len(stats),
               teacher_changed=len(teacher_changed), steps=state.step)
    print("train with a detector, after the steps:", json.dumps(res), flush=True)
    check(len(moved) == len(trainable), "every ControlNet and decoder tensor moved")
    check(not changed, f"frozen pipeline tensors changed: {changed[:5]}")
    check(len(det_moved) == len(det_train), f"trainable detnet tensors moved: {len(det_moved)} "
                                            f"of {len(det_train)}")
    check(not det_changed and frozen_stages, f"frozen detnet stages changed: {det_changed[:5]}")
    check(stats and len(stats_moved) == len(stats),
          f"frozen stages' running statistics moved: {len(stats_moved)} of {len(stats)}")
    check(not teacher_changed, f"teacher tensors changed: {teacher_changed[:5]}")
    return dict(launches=launches, shapes=shapes, metrics=metrics, kernel_vs_plain=cmp,
                timing=timing, trace=trace, checks=res,
                nms_host_syncs_per_call=syncs["syncs"] / max(syncs["calls"], 1))


def config_pipeline(path: str, weights: dict, device) -> tuple:
    """(the config at ``path``, the pipeline ``build_pipeline_from_config``
    builds from it on the card in bf16, ``weights`` loaded): its parameter
    names and shapes must be those of ``weights``, a ``build_flagship``
    pipeline's state dict."""
    from edtr_torch.config import load_config
    from edtr_torch.pipeline import build_pipeline_from_config

    cfg = load_config(path)
    pipe = build_pipeline_from_config(cfg, dtype=torch.bfloat16, device=device)
    got = {n: tuple(t.shape) for n, t in pipe.state_dict().items()}
    want = {n: tuple(t.shape) for n, t in weights.items()}
    check(got == want, f"{path}: parameters other than build_flagship's "
                       f"({sorted(set(got) ^ set(want))[:5]})")
    pipe.load_state_dict(weights, strict=True)
    return cfg, pipe


def host_weights(pipe) -> dict:
    """``pipe``'s state dict copied to host memory, so the pipeline can be
    freed before the next one is built from it."""
    return {n: t.detach().cpu() for n, t in pipe.state_dict().items()}


def task_net(cfg, task: str, device, images: torch.Tensor, node: str = None,
             seed: int = 9) -> tuple:
    """(bf16, fp32) task nets of ``cfg.model[node]`` (the task's own node by
    default) through the registry on one set of weights: random from
    ``seed`` (``randomize_``; BatchNorm running statistics 0 and 1), then
    each conv and linear layer scaled to unit output RMS on ``images``
    (NCHW in [0, 1]) in fp32, eval mode (``calibrate_unit_rms_``), so the
    logits move with the input, as trained weights' do."""
    from edtr_torch.config import instantiate_from_config
    from edtr_torch.models.layers import Conv2d, Linear, calibrate_unit_rms_, randomize_

    node = cfg.model[node or TASK_NETS[task][0]]
    fp32 = instantiate_from_config(node, device=device)
    randomize_(fp32, torch.Generator(device=device).manual_seed(seed))
    calibrate_unit_rms_([m for m in fp32.modules() if isinstance(m, (Conv2d, Linear))],
                        lambda: task_logits(fp32, task, images))
    bf16 = instantiate_from_config(node, dtype=torch.bfloat16, device=device)
    bf16.load_state_dict(fp32.state_dict(), strict=True)
    return bf16, fp32


def task_logits(net, task: str, img: torch.Tensor) -> torch.Tensor:
    """A segmentation net's ``out`` logits (B, classes, H, W), or a
    classification net's (B, classes), of NCHW images in [0, 1]."""
    out = net(img)
    return out["out"] if task == "seg" else out


@torch.no_grad()
def input_sensitivity(net, task: str, images: torch.Tensor, seed: int = 23) -> float:
    """Relative L2 by which ``net``'s logits of ``images`` move for input
    noise of std :data:`TASK_NOISE` (clamped to [0, 1]); must reach
    :data:`TOL_TASK_MOVES`."""
    g = torch.Generator(device=images.device).manual_seed(seed)
    noisy = (images + TASK_NOISE * torch.randn(images.shape, generator=g,
                                               device=images.device)).clamp(0, 1)
    moved = rel_l2(task_logits(net, task, noisy), task_logits(net, task, images))
    check(moved >= TOL_TASK_MOVES, f"{type(net).__name__} logits moved {moved} for input "
                                   f"noise {TASK_NOISE}, want >= {TOL_TASK_MOVES}")
    return moved


def hold_shapes(device, shapes: dict) -> dict:
    """Each flash forward, conv and Swin kernel (and projection kernel, if
    the run launched one) against its plain version at every shape of
    ``shapes`` (:func:`read_counts`), untimed: per kernel the shapes held
    and its largest error over its largest output."""
    gen = torch.Generator(device=device).manual_seed(19)
    held = {}

    def add(name, share):
        agg = held.setdefault(name, dict(shapes=0, max_err_share=0.0))
        agg["shapes"] += 1
        agg["max_err_share"] = max(agg["max_err_share"], share)

    for key in sorted(shapes["flash"], key=str):
        if key[0] in KERNELS:
            r = flash_case(device, key[0], key[1:], gen, timed=False)
            add(key[0], r["err_o"] / r["o_max"])
    for key in sorted(shapes["conv"], key=str):
        r = conv_case(device, key, gen, timed=False)
        add(key[0], r["max_abs_err"] / r["out_max"])
    for key in sorted(shapes["swin"], key=str):
        r = swin_case(device, key, gen, timed=False)
        add(key[0], r["max_abs_err"] / r["out_max"])
    for key in sorted(shapes["proj"], key=str):
        r = proj_case(device, key, gen)
        add(key[0], r["max_abs_err"] / r["out_max"])
    return held


def restore_task_phase(task: str, path: str, weights: dict, device) -> tuple:
    """Restore then segment or classify, built from the test config at
    ``path`` (module docstring, phases 11-12): (the phase's results, the
    counted run's launches, shapes and copies)."""
    from torch.profiler import record_function

    from edtr_torch.profile_restore import (RESTORE_CLASSIFY_STAGES, RESTORE_SEGMENT_STAGES,
                                            trace_restores)

    t0 = time.perf_counter()
    cfg, pipe = config_pipeline(path, weights, device)
    _, classes, stage = TASK_NETS[task]
    stages_all = RESTORE_SEGMENT_STAGES if task == "seg" else RESTORE_CLASSIFY_STAGES
    bs = int(cfg.test.batch_size)
    flags = (pipe.fused_conv, pipe.fused_proj, pipe.fused_swin)
    g = torch.Generator(device=device).manual_seed(1)
    lat = IMAGE // 8
    x = torch.rand((bs, 3, IMAGE, IMAGE), generator=g, device=device)
    noise = torch.randn((bs, 4, lat, lat), generator=g, device=device)
    step_noise = torch.randn((4, bs, 4, lat, lat), generator=g, device=device)
    net, net32 = task_net(cfg, task, device, x)
    moved = input_sensitivity(net32, task, x)
    torch.cuda.synchronize()
    print(f"restore then {stage}: {path}, bs {bs}, {type(net).__name__} {classes} classes, "
          f"{sum(p.numel() for p in net.parameters())} params, calibrated on the input (logits "
          f"move {moved} for noise {TASK_NOISE}), configuration {flags}; built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def restore():
        pre = pipe.pre_restore(x)
        return pipe.decode(pipe.denoise(pipe.encode(pre), pipe.text(bs), noise, step_noise), pre)

    def run_task(img):
        with torch.no_grad():
            return task_logits(net, task, img.clamp(0, 1))

    restored = restore()
    run_task(restored)
    # the main path: counts set to 0 just before, read just after
    zero_counts()
    out = {}
    ms = host_ms(lambda: out.update(logits=run_task(restore())))
    launches, shapes, copies = read_counts()
    print(f"restore+{stage} counted: {ms:.1f} ms, launches {launches}, layout copies {copies}",
          flush=True)
    check(launches == expected_launches(flags), f"restore+{stage} launches {launches}")
    check(copies == dict(conv=0, proj=0), f"restore+{stage} layout copies {copies}")
    want_shape = (bs, classes, IMAGE, IMAGE) if task == "seg" else (bs, classes)
    check(tuple(out["logits"].shape) == want_shape and out["logits"].dtype == torch.float32,
          f"{stage} logits {tuple(out['logits'].shape)} {out['logits'].dtype}")
    check(bool(torch.isfinite(out["logits"]).all()), f"{stage} logits finite")
    metric = task_metric(task, out["logits"], device)
    with torch.no_grad():
        rel_net = rel_l2(task_logits(net, task, restored.clamp(0, 1)),
                         task_logits(net32, task, restored.clamp(0, 1)))
    with pipe_path(pipe, False, flash=True):
        rel_stock = rel_l2(restored, restore())
    held = hold_shapes(device, shapes)
    print(f"restore+{stage}: bf16 vs fp32 {stage} logits {rel_net}, restored vs stock "
          f"{rel_stock}; kernels held at the run's shapes: {json.dumps(held)}", flush=True)
    check(rel_net <= TOL_TASK_REL, f"{stage} bf16 vs fp32: {rel_net} > {TOL_TASK_REL}")
    check(rel_stock <= TOL_FUSED_REL, f"bs-{bs} restore vs stock: {rel_stock}")
    check(set(held) == {k for k, n in launches.items() if n}, f"held {sorted(held)}")

    times = {s_: [] for s_ in stages_all}
    res_ = {}

    def timed(name, fn):
        with record_function(name):
            times[name].append(host_ms(lambda: res_.update({name: fn()})))
        return res_[name]

    def chain():
        pre = timed("swinir", lambda: pipe.pre_restore(x))
        z = timed("vae_encode", lambda: pipe.encode(pre))
        c_txt = timed("text", lambda: pipe.text(bs))
        z0 = timed("scan", lambda: pipe.denoise(z, c_txt, noise, step_noise))
        img = timed("decode+wavelet", lambda: pipe.decode(z0, pre))
        timed(stage, lambda: run_task(img))

    e2e = []
    for _ in range(TASK_ROUNDS):
        chain()
        e2e.append(host_ms(lambda: run_task(restore())))
    stage_ms = {k: statistics.median(v) for k, v in times.items()}
    trace = trace_restores(chain, TASK_TRACE_ITERS, stages_all)
    for name in ("swinir", stage):
        htod = trace["stages"][name]["htod_memcpy"]
        check(htod == 0, f"restore+{stage}: {htod} host-to-device copies per {name} stage")
    st = trace["stages"][stage]
    res = dict(config=path, batch=bs, net=type(net).__name__, classes=classes,
               params=sum(p.numel() for p in net.parameters()), logits_moved_by_noise=moved,
               configuration=dict(zip(("fused_conv", "fused_proj", "fused_swin"), flags)),
               rel_l2_bf16_vs_fp32=rel_net, restored_vs_stock_rel_l2=rel_stock, metric=metric,
               tol_rel_l2=TOL_TASK_REL, held=held, stage_ms=stage_ms,
               e2e_ms=statistics.median(e2e), e2e_runs_ms=e2e,
               ms_per_img=statistics.median(e2e) / bs,
               device_busy_ms_by_stage={k: v["device_busy_ms"] for k, v in trace["stages"].items()},
               task_stage=dict(host_ms=stage_ms[stage], host_ms_traced=st["host_ms"],
                               device_busy_ms=st["device_busy_ms"], idle_share=st["idle_share"],
                               kernels=st["kernels"], htod_memcpy=st["htod_memcpy"]),
               trace=trace)
    print(f"restore then {stage} (bf16, bs {bs}, 512²):",
          json.dumps({k: v for k, v in res.items() if k != "trace"}), flush=True)
    print(f"trace restore+{stage} of {TASK_TRACE_ITERS}:", json.dumps(trace), flush=True)
    return res, dict(launches=launches, shapes=shapes, copies=copies)


def task_metric(task: str, logits: torch.Tensor, device) -> dict:
    """The task's metric of ``logits`` against seeded targets
    (:func:`task_target`) on the card, gated equal to the CPU's on the same
    tensors: the confusion matrix, its IoU and mean IoU (seg); the top-1
    and top-5 counts (cls)."""
    from edtr_torch.utils import metrics as M

    classes = TASK_NETS[task][1]
    target = task_target(task, logits.shape[0], torch.Generator(device=device).manual_seed(31),
                         device)
    if task == "seg":
        pred = logits.argmax(1)
        mat = M.confusion_matrix(pred, target, classes)
        mat_cpu = M.confusion_matrix(pred.cpu(), target.cpu(), classes)
        iou, miou = M.compute_iou(mat)
        iou_cpu, miou_cpu = M.compute_iou(mat_cpu)
        check(mat.device == device and torch.equal(mat.cpu(), mat_cpu), "confusion matrix "
                                                                        "card vs CPU")
        check(torch.equal(iou.cpu(), iou_cpu) and miou == miou_cpu, "IoU card vs CPU")
        res = dict(miou=miou, pixels=int(mat_cpu.sum()), classes_present=int((iou_cpu > 0).sum()))
    else:
        acc = [int(v) for v in M.topk_accuracy(logits, target, (1, 5))]
        acc_cpu = [int(v) for v in M.topk_accuracy(logits.cpu(), target.cpu(), (1, 5))]
        check(acc == acc_cpu, f"top-k card {acc} vs CPU {acc_cpu}")
        res = dict(top1=acc[0], top5=acc[1], images=logits.shape[0])
    print(f"{task} metric on the card (equal to the CPU's):", json.dumps(res), flush=True)
    return res


def task_target(task: str, batch: int, g: torch.Generator, device) -> torch.Tensor:
    """Seeded targets of ``batch`` images: masks (B, 512, 512) of the seg
    net's classes with VOC's 255 border of :data:`SEG_BORDER` pixels, or
    labels (B,) of the cls net's."""
    classes = TASK_NETS[task][1]
    if task == "cls":
        return torch.randint(0, classes, (batch,), generator=g, device=device)
    target = torch.randint(0, classes, (batch, IMAGE, IMAGE), generator=g, device=device)
    border = torch.ones_like(target, dtype=torch.bool)
    border[:, SEG_BORDER:-SEG_BORDER, SEG_BORDER:-SEG_BORDER] = False
    return target.masked_fill(border, 255)


def train_task_phase(task: str, path: str, weights: dict, device) -> dict:
    """The generic EDTR step of ``task``, built from the train config at
    ``path`` (module docstring, phase 15), on ``weights``."""
    from edtr_torch.profile_restore import TRAIN_STAGES, trace_restores
    from edtr_torch.train.edtr_step import (EDTRTrainState, cast_frozen_bf16,
                                            make_edtr_generic_train_step)
    from edtr_torch.train.tasks import task_apply_for

    t0 = time.perf_counter()
    cfg, pipe = config_pipeline(path, weights, device)
    node, classes, _ = TASK_NETS[task]
    tc = cfg.train
    g = torch.Generator(device=device).manual_seed(5)
    lat = IMAGE // 8
    target = task_target(task, TRAIN_BATCH, g, device)
    batch = dict(lq=torch.rand((TRAIN_BATCH, IMAGE, IMAGE, 3), generator=g, device=device),
                 gt=torch.rand((TRAIN_BATCH, IMAGE, IMAGE, 3), generator=g, device=device),
                 c_txt=pipe.text(TRAIN_BATCH), target=target)
    gt = batch["gt"].permute(0, 3, 1, 2)
    # both calibrated on gt; the teacher's weights are drawn apart from the
    # student's: with equal ones the feature matching's L1 sits at its kink
    # on gt (PERF.md §6)
    student, student32 = task_net(cfg, task, device, gt)
    teacher = task_net(cfg, task, device, gt, f"teacher_{node}", seed=10)[0]
    moved = input_sensitivity(student32, task, gt)
    del student32
    cast_frozen_bf16(pipe, pipe.cldm.vae.train_decoder, teacher)
    state = EDTRTrainState.create(pipe, learning_rate_edtr=float(tc.learning_rate_edtr),
                                  train_steps=int(tc.train_steps), detnet=student,
                                  teacher_detnet=teacher,
                                  learning_rate_detnet=float(tc[f"learning_rate_{node}"]))
    loss_fn, feats_fn = task_apply_for(task)
    weights = dict(weight_hlf=float(tc.weight_hlf), weight_task=float(tc.weight_ce),
                   weight_fm=float(tc.weight_fm))
    step = make_edtr_generic_train_step(pipe, student, teacher, feats_fn, loss_fn, **weights)
    params = dict(pipe.named_parameters())
    trainable = {n: p for n, p in params.items() if p.requires_grad}
    frozen = {n: p for n, p in params.items() if not p.requires_grad}
    task_params = dict(student.named_parameters())
    t, noise = step.draw(torch.empty((TRAIN_BATCH, 4, lat, lat), device=device), g)
    draws = dict(noise=torch.randn((1, 4, lat, lat), generator=g, device=device),
                 step_noise=torch.randn((4, 1, 4, lat, lat), generator=g, device=device))
    torch.cuda.synchronize()
    print(f"train {task}: {path}, student and teacher {type(student).__name__} ({classes} "
          f"classes, {sum(p.numel() for p in task_params.values())} params, calibrated on gt: "
          f"the student's logits move {moved} for noise {TASK_NOISE}), {weights}, "
          f"cast_frozen_bf16; set up in {time.perf_counter() - t0:.1f} s", flush=True)

    cmp = step_kernel_vs_plain(step, state, batch, t, noise, draws, trainable, task_params)
    cmp["logits_moved_by_noise"] = moved
    print(f"train {task}, kernel path vs plain path (gated: the EDTR half's gradients for "
          f"the plain path's cotangent of the restored image under the step's HLF, the walk's "
          f"restored image; reported: the same under the pixel L1, the step's own gradients, "
          f"and each of them for the plain path computing in fp32):", json.dumps(cmp),
          flush=True)
    for part, r in cmp["gated_rel_l2"].items():
        check(r <= TOL_GRAD_REL, f"{task} step kernel vs plain, {part}: relative L2 {r}")

    before = {n: p.detach().clone() for n, p in params.items()}
    task_before = {n: v.clone() for n, v in student.state_dict().items()}
    teacher_before = {n: v.clone() for n, v in teacher.state_dict().items()}
    step(state, batch, generator=g)
    # the main path: counts set to 0 just before the step, read just after
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    out = {}
    first_ms = host_ms(lambda: out.update(step(state, batch, t, noise, generator=g,
                                                task_draws=[draws])))
    launches, shapes, _ = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    metrics = {k: v.item() for k, v in out.items()}
    print(f"train {task} step counted: {first_ms:.1f} ms, metrics {metrics}, launches "
          f"{launches}, peak memory {peak:.2f} GiB", flush=True)
    check(set(metrics) == {"loss_hlf", "loss_task", "loss_fm"}, f"{task} metrics {metrics}")
    check(all(math.isfinite(v) for v in metrics.values()), f"{task} step losses {metrics}")
    # the task net launches none of the port's kernels: the detector step's counts
    check(launches == TRAIN_LAUNCHES_DET, f"{task} step launches {launches}, want "
                                          f"{TRAIN_LAUNCHES_DET}")

    steps = [host_ms(lambda: step(state, batch, generator=g)) for _ in range(TRAIN_TIMED)]
    trace = trace_restores(lambda: step(state, batch, generator=g), 1, TRAIN_STAGES)
    timing = dict(step_ms=statistics.median(steps), step_runs_ms=steps,
                  phase_host_ms_traced={s_: trace["stages"][s_]["host_ms"] for s_ in TRAIN_STAGES},
                  phase_device_busy_ms_traced={s_: trace["stages"][s_]["device_busy_ms"]
                                               for s_ in TRAIN_STAGES},
                  peak_memory_gib=peak, batch=TRAIN_BATCH, image=IMAGE)
    print(f"train {task} step: {timing['step_ms']:.2f} ms (median of {TRAIN_TIMED}, bs "
          f"{TRAIN_BATCH}, 512²; phases from a traced step):", json.dumps(timing), flush=True)
    print(f"trace of one train {task} step:", json.dumps(trace), flush=True)

    moved = [n for n in trainable if not torch.equal(params[n], before[n])]
    changed = [n for n in frozen if not torch.equal(params[n], before[n])]
    now = student.state_dict()
    stats = [n for n in now if n.endswith(("running_mean", "running_var"))]
    task_moved = [n for n in task_params if not torch.equal(now[n], task_before[n])]
    stats_moved = [n for n in stats if not torch.equal(now[n], task_before[n])]
    teacher_changed = [n for n, v in teacher.state_dict().items()
                       if not torch.equal(v, teacher_before[n])]
    res = dict(moved=len(moved), trainable=len(trainable), frozen_changed=len(changed),
               tasknet_moved=len(task_moved), tasknet_params=len(task_params),
               stats_moved=len(stats_moved), stats=len(stats),
               teacher_changed=len(teacher_changed), steps=state.step)
    print(f"train {task}, after the steps:", json.dumps(res), flush=True)
    check(len(moved) == len(trainable), "every ControlNet and decoder tensor moved")
    check(not changed, f"frozen pipeline tensors changed: {changed[:5]}")
    check(len(task_moved) == len(task_params), f"task-net tensors moved: {len(task_moved)}")
    check(stats and len(stats_moved) == len(stats), f"running statistics moved: "
                                                    f"{len(stats_moved)} of {len(stats)}")
    check(not teacher_changed, f"teacher tensors changed: {teacher_changed[:5]}")
    return dict(config=path, launches=launches, metrics=metrics, kernel_vs_plain=cmp,
                timing=timing, trace=trace, checks=res)


def demo_detector(cfg, device, images: torch.Tensor, node: str = "detnet", seed: int = 7):
    """(bf16, fp32) of the config's ResNet50-FPN-v2 node through the
    registry (:func:`detector_pair`: seeded weights, heads calibrated on
    ``images``)."""
    from edtr_torch.config import instantiate_from_config

    return detector_pair(device, images,
                         lambda **kw: instantiate_from_config(cfg.model[node], **kw), seed)


def detect_v2_phase(cfg, pipe, device) -> tuple:
    """Restore then detect with the demo config's ResNet50-FPN-v2 (module
    docstring, phase 22): (the phase's results, the counted run's launches,
    shapes and copies, the bf16 detector)."""
    from torch.profiler import record_function

    from edtr_torch.ops import boxes
    from edtr_torch.pipeline import FUSED_CONV_DEFAULT, FUSED_PROJ_DEFAULT, FUSED_SWIN_DEFAULT
    from edtr_torch.profile_restore import RESTORE_DETECT_STAGES, trace_restores

    flags = (FUSED_CONV_DEFAULT, FUSED_PROJ_DEFAULT, FUSED_SWIN_DEFAULT)
    lq, _, noise, step_noise = restore_args(device)
    x, noise, step_noise = (lq.permute(0, 3, 1, 2), noise.permute(0, 3, 1, 2),
                            step_noise.permute(0, 1, 4, 2, 3))

    def restore():
        pre = pipe.pre_restore(x)
        return pipe.decode(pipe.denoise(pipe.encode(pre), pipe.text(1), noise, step_noise), pre)

    t0 = time.perf_counter()
    restored = restore().clamp(0, 1)
    det, det32 = demo_detector(cfg, device, restored)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in det.parameters())
    print(f"detector v2: {cfg.model.detnet.target} {dict(cfg.model.detnet.params)}, "
          f"{det.num_classes} classes, {n_params} params (fp32), bf16 compute, built + "
          f"randomised + calibrated in {time.perf_counter() - t0:.1f} s", flush=True)

    def detect(img):
        with torch.no_grad():
            return det(img.clamp(0, 1))

    detect(restored)
    zero_counts()
    boxes.host_syncs.update(calls=0, syncs=0)
    dets = {}
    ms = host_ms(lambda: dets.update(detect(restore())[0]))
    launches, shapes, copies = read_counts()
    syncs = dict(boxes.host_syncs)
    print(f"restore+detect v2 counted: {ms:.1f} ms, launches {launches}, NMS calls "
          f"{syncs['calls']} with {syncs['syncs']} host synchronisations", flush=True)
    check(launches == expected_launches(flags), f"restore+detect v2 launches {launches}")
    check(syncs["calls"] == 2, f"NMS calls per v2 detect {syncs['calls']}")
    valid = dets["valid"][0]
    check(int(valid.sum()) > 0, "no valid v2 detection")
    check(all(bool(torch.isfinite(dets[k]).all()) for k in ("boxes", "scores")),
          "v2 detections finite")
    with torch.no_grad():
        _, _, f16 = det(restored)
        _, _, f32 = det32(restored)
    rels = {f"fpn_{k}": rel_l2(f16["features"][k], f32["features"][k])
            for k in det.feature_names}
    for key in ("objectness", "pred_bbox_deltas"):
        rels.update({f"{key}_{i}": rel_l2(a, b) for i, (a, b) in enumerate(zip(f16[key],
                                                                                f32[key]))})
    for k in det.feature_names:
        check(rels[f"fpn_{k}"] <= TOL_DETECT_REL,
              f"v2 detector bf16 vs fp32 FPN {k}: {rels[f'fpn_{k}']} > {TOL_DETECT_REL}")
    del det32

    def chain():
        with record_function("swinir"):
            pre = pipe.pre_restore(x)
        with record_function("vae_encode"):
            z = pipe.encode(pre)
        with record_function("text"):
            c_txt = pipe.text(1)
        with record_function("scan"):
            z0 = pipe.denoise(z, c_txt, noise, step_noise)
        with record_function("decode+wavelet"):
            img = pipe.decode(z0, pre)
        with record_function("detect"):
            detect(img)

    boxes.host_syncs.update(calls=0, syncs=0)
    trace = trace_restores(chain, TRACE_ITERS, RESTORE_DETECT_STAGES)
    st = trace["stages"]["detect"]
    for stage in ("swinir", "detect"):
        check(trace["stages"][stage]["htod_memcpy"] == 0,
              f"restore+detect v2: host-to-device copies in {stage}")
    res = dict(config=DEMO_CONFIG, params=n_params, classes=det.num_classes,
               rel_l2_bf16_vs_fp32=rels, tol_rel_l2=TOL_DETECT_REL,
               valid_detections=int(valid.sum()), counted_ms=ms,
               detect_stage=dict(host_ms_traced=st["host_ms"],
                                 device_busy_ms=st["device_busy_ms"],
                                 idle_share=st["idle_share"], kernels=st["kernels"],
                                 htod_memcpy=st["htod_memcpy"]),
               nms_host_syncs_per_call=boxes.host_syncs["syncs"] / boxes.host_syncs["calls"],
               stages={k: {kk: v[kk] for kk in ("host_ms", "device_busy_ms", "idle_share",
                                                 "kernels", "htod_memcpy")}
                       for k, v in trace["stages"].items()})
    print("restore+detect v2 (bf16, bs 1, 512² -> 800²):", json.dumps(res), flush=True)
    return res, dict(launches=launches, shapes=shapes, copies=copies), det


def demo_inputs(device) -> tuple:
    """The demo's seeded (1, H, W, 3) image at :data:`DEMO_SIZE` and its
    q_sample and walk draws (NCHW latent)."""
    g = torch.Generator(device=device).manual_seed(12)
    h, w = DEMO_SIZE
    lat = (1, 4, h // 8, w // 8)
    return (torch.rand((1, h, w, 3), generator=g, device=device),
            torch.randn(lat, generator=g, device=device),
            torch.randn((4,) + lat, generator=g, device=device))


def demo_phase(pipe, det, device, tiled: bool) -> tuple:
    """The demo (module docstring, phases 23-24) on the seeded
    :data:`DEMO_SIZE` image: untiled with ``resize`` detection, or all
    tiled (:data:`DEMO_TILED`) with ``tile`` detection: (results, the
    counted run's launches, shapes and copies, its restored image)."""
    from edtr_torch.demo import restore_and_detect
    from edtr_torch.ops import boxes
    from edtr_torch.profile_restore import RESTORE_DETECT_STAGES, trace_restores

    what = "demo tiled" if tiled else "demo"
    image, noise, step_noise = demo_inputs(device)
    opts = DEMO_TILED if tiled else {}

    def run():
        return restore_and_detect(pipe, det, image, noise=noise, step_noise=step_noise, **opts)

    first = host_ms(run)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    boxes.host_syncs.update(calls=0, syncs=0)
    out = {}
    ms = host_ms(lambda: out.update(run()))
    launches, shapes, copies = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    syncs = dict(boxes.host_syncs)
    h, w = DEMO_SIZE
    want = demo_launches(h, w, tiled)
    print(f"{what} counted ({h}x{w}): first call {first:.1f} ms, counted {ms:.1f} ms, launches "
          f"{launches}, layout copies {copies}, NMS calls {syncs['calls']} with "
          f"{syncs['syncs']} host synchronisations, peak {peak:.2f} GiB", flush=True)
    check(launches == want, f"{what} launches {launches}, want {want}")
    if not tiled:
        check(launches["flash_fwd"] > 0, "K4 (flash_fwd) launched on the untiled demo")
    check(copies == dict(conv=0, proj=0), f"{what} layout copies {copies}")
    check(tuple(out["restored"].shape) == (1, h, w, 3), f"{what} restored shape")
    check(bool(torch.isfinite(out["restored"]).all()), f"{what} restored finite")
    dets = out["detections"]
    check(all(bool(torch.isfinite(dets[k]).all()) for k in ("boxes", "scores")),
          f"{what} detections finite")
    runs = [host_ms(run) for _ in range(3)]
    trace = trace_restores(run, 1, RESTORE_DETECT_STAGES)
    for stage, st in trace["stages"].items():
        allowed = 1 if stage == "text" else 0  # the token ids
        check(st["htod_memcpy"] <= allowed, f"{what}: {st['htod_memcpy']} host-to-device "
                                            f"copies in {stage}")
    held = hold_shapes(device, shapes)  # each case checks its own limits
    check(set(held) == {k for k, n in launches.items() if n}, f"{what} held {sorted(held)}")
    # K3 timed at the 12288 tokens only this path gives it (three times the
    # restore's), beside its bound; K4's row is timed at this path's shape
    gen = torch.Generator(device=device).manual_seed(20)
    timed = [flash_case(device, key[0], key[1:], gen) for key in sorted(shapes["flash"], key=str)
             if not tiled and key[0] == "streamkv_fwd"]
    res = dict(size=list(DEMO_SIZE), options=opts, counted_ms=ms, first_ms=first,
               e2e_ms=statistics.median(runs), e2e_runs_ms=runs, peak_memory_gib=peak,
               valid_detections=int(dets["valid"].sum()), launches=launches,
               expected_launches=want, tiles=tile_counts(h, w) if tiled else None,
               nms_calls=syncs["calls"], nms_host_syncs=syncs["syncs"], held_shapes=held,
               stages={k: {kk: v[kk] for kk in ("host_ms", "device_busy_ms", "idle_share",
                                                 "kernels", "htod_memcpy")}
                       for k, v in trace["stages"].items()},
               by_family_ms=trace["by_family_ms"], timed_at_new_shapes=timed)
    if tiled:
        with pipe_path(pipe, False):
            plain = run()
        res["kernel_vs_plain_rel_l2"] = rel_l2(out["restored"], plain["restored"])
        check(res["kernel_vs_plain_rel_l2"] <= TOL_FUSED_REL,
              f"tiled demo kernel vs plain route: {res['kernel_vs_plain_rel_l2']}")
        res["tiled_vae_vs_untiled"] = tiled_vae_distance(pipe, out["pre_restored"], out["z"])
    print(f"{what} ({h}x{w}, bf16, the demo config's pipeline and v2 detector):",
          json.dumps(res), flush=True)
    return res, dict(launches=launches, shapes=shapes, copies=copies)


def tiled_vae_distance(pipe, pre_nhwc: torch.Tensor, z: torch.Tensor) -> dict:
    """The tiled VAE (the demo's 256-pixel encoder and 256-latent decoder
    tiles) against the untiled one on the demo's images, relative L2, with
    the GroupNorm statistics synced across tiles and with each tile on its
    own (no sync pass)."""
    from edtr_torch.utils.tiling import tiled_vae_decode, tiled_vae_encode

    vae = pipe.cldm.vae
    img = pre_nhwc.permute(0, 3, 1, 2) * 2 - 1
    zu = z / pipe.cldm.scale_factor
    out = {}
    with torch.no_grad(), pipe.configuration():
        enc = vae.encode(img).mode()
        dec = vae.decode(zu)
        for iters, name in ((1, "gn_synced"), (0, "per_tile")):
            out[f"encode_{name}"] = rel_l2(tiled_vae_encode(vae, img, 256, iters).mode(), enc)
            out[f"decode_{name}"] = rel_l2(tiled_vae_decode(vae, zu, 256, iters), dec)
    return out


def train_det_v2_phase(weights: dict, device) -> dict:
    """The two-half step with the ResNet50-FPN-v2 (module docstring, phase
    26), built from :data:`DET_V2_TRAIN_CONFIG` on ``weights``."""
    from edtr_torch.ops import boxes
    from edtr_torch.profile_restore import TRAIN_STAGES, trace_restores
    from edtr_torch.train.edtr_step import (EDTRTrainState, cast_frozen_bf16,
                                            make_edtr_train_step)

    t0 = time.perf_counter()
    cfg, pipe = config_pipeline(DET_V2_TRAIN_CONFIG, weights, device)
    tc = cfg.train
    g = torch.Generator(device=device).manual_seed(4)
    lat = IMAGE // 8
    targets = det_targets(device, g)
    gt = box_images(device, g, targets)
    lq = (gt + 0.1 * torch.randn(gt.shape, generator=g, device=device)).clamp(0, 1)
    batch = dict(lq=lq.permute(0, 2, 3, 1), gt=gt.permute(0, 2, 3, 1),
                 c_txt=pipe.text(TRAIN_BATCH), targets=targets)
    student = demo_detector(cfg, device, gt)[0]
    teacher = demo_detector(cfg, device, gt, "teacher_detnet", seed=8)[0]
    cast_frozen_bf16(pipe, pipe.cldm.vae.train_decoder, teacher)
    state = EDTRTrainState.create(pipe, learning_rate_edtr=float(tc.learning_rate_edtr),
                                  train_steps=int(tc.train_steps), detnet=student,
                                  teacher_detnet=teacher,
                                  learning_rate_detnet=float(tc.learning_rate_detnet))
    loss_w = dict(weight_hlf=float(tc.weight_hlf), weight_det=float(tc.weight_det),
                  weight_fm=float(tc.weight_fm))
    step = make_edtr_train_step(pipe, detnet=student, teacher_detnet=teacher, **loss_w)
    t, noise = step.draw(torch.empty((TRAIN_BATCH, 4, lat, lat), device=device), g)
    params = dict(pipe.named_parameters())
    trainable = {n: p for n, p in params.items() if p.requires_grad}
    frozen = {n: p for n, p in params.items() if not p.requires_grad}
    det_params = dict(student.named_parameters())
    det_train = {n: p for n, p in det_params.items() if p.requires_grad}
    det_frozen = {n: p for n, p in det_params.items() if not p.requires_grad}
    draws = dict(noise=torch.randn((1, 4, lat, lat), generator=g, device=device),
                 step_noise=torch.randn((4, 1, 4, lat, lat), generator=g, device=device),
                 uniforms=None)
    torch.cuda.synchronize()
    print(f"train with the v2 detector: {DET_V2_TRAIN_CONFIG}, {loss_w}, student and teacher "
          f"ResNet50-FPN-v2 ({student.num_classes} classes, drawn apart), "
          f"{sum(p.numel() for p in det_train.values())} trainable and "
          f"{sum(p.numel() for p in det_frozen.values())} frozen detnet params; set up in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    cmp = step_kernel_vs_plain(step, state, batch, t, noise, draws, trainable, det_train,
                               seed=6)
    print("train with the v2 detector, kernel path vs plain path:", json.dumps(cmp), flush=True)
    for part, r in cmp["gated_rel_l2"].items():
        check(r <= TOL_GRAD_REL, f"v2 detector step kernel vs plain, {part}: relative L2 {r}")

    before = {n: p.detach().clone() for n, p in params.items()}
    det_before = {n: v.clone() for n, v in student.state_dict().items()}
    teacher_before = {n: v.clone() for n, v in teacher.state_dict().items()}
    step(state, batch, generator=g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    boxes.host_syncs.update(calls=0, syncs=0)
    out = {}
    first_ms = host_ms(lambda: out.update(step(state, batch, t, noise, generator=g,
                                                task_draws=[draws])))
    launches, shapes, _ = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    metrics = {k: v.item() for k, v in out.items()}
    print(f"train step with the v2 detector counted: {first_ms:.1f} ms, metrics {metrics}, "
          f"launches {launches}, peak {peak:.2f} GiB", flush=True)
    check(all(math.isfinite(v) for v in metrics.values()), f"v2 step losses {metrics}")
    check(launches == TRAIN_LAUNCHES_DET, f"v2 step launches {launches}, want "
                                          f"{TRAIN_LAUNCHES_DET}")
    steps = [host_ms(lambda: step(state, batch, generator=g)) for _ in range(RECIPE_TIMED)]
    trace = trace_restores(lambda: step(state, batch, generator=g), 1, TRAIN_STAGES)
    timing = dict(step_ms=statistics.median(steps), step_runs_ms=steps,
                  device_busy_ms=sum(trace["stages"][s_]["device_busy_ms"]
                                     for s_ in TRAIN_STAGES),
                  kernels=sum(trace["stages"][s_]["kernels"] for s_ in TRAIN_STAGES),
                  phase_host_ms_traced={s_: trace["stages"][s_]["host_ms"] for s_ in TRAIN_STAGES},
                  phase_device_busy_ms_traced={s_: trace["stages"][s_]["device_busy_ms"]
                                               for s_ in TRAIN_STAGES},
                  peak_memory_gib=peak, batch=TRAIN_BATCH, image=IMAGE)
    print(f"train step with the v2 detector: {timing['step_ms']:.2f} ms (median of "
          f"{RECIPE_TIMED}):", json.dumps(timing), flush=True)

    moved = [n for n in trainable if not torch.equal(params[n], before[n])]
    changed = [n for n in frozen if not torch.equal(params[n], before[n])]
    det_now = student.state_dict()
    det_moved = [n for n in det_train if not torch.equal(det_now[n], det_before[n])]
    det_changed = [n for n in det_frozen if not torch.equal(det_now[n], det_before[n])]
    frozen_mods = {n.split(".")[2] for n in det_frozen}
    stats = [n for n in det_now if n.endswith(("running_mean", "running_var"))
             and n.startswith("backbone.body.") and n.split(".")[2] in frozen_mods]
    stats_moved = [n for n in stats if not torch.equal(det_now[n], det_before[n])]
    head_stats = [n for n in det_now if n.endswith("running_mean")
                  and not n.startswith("backbone.body.")]
    head_moved = [n for n in head_stats if not torch.equal(det_now[n], det_before[n])]
    teacher_changed = [n for n, v in teacher.state_dict().items()
                       if not torch.equal(v, teacher_before[n])]
    res = dict(moved=len(moved), trainable=len(trainable), frozen_changed=len(changed),
               detnet_moved=len(det_moved), detnet_trainable=len(det_train),
               detnet_frozen_changed=len(det_changed), frozen_modules=sorted(frozen_mods),
               frozen_stats_moved=len(stats_moved), frozen_stats=len(stats),
               fpn_head_stats_moved=len(head_moved), fpn_head_stats=len(head_stats),
               teacher_changed=len(teacher_changed), steps=state.step)
    print("train with the v2 detector, after the steps:", json.dumps(res), flush=True)
    check(len(moved) == len(trainable), "every ControlNet and decoder tensor moved")
    check(not changed, f"frozen pipeline tensors changed: {changed[:5]}")
    check(len(det_moved) == len(det_train), f"trainable v2 tensors moved: {len(det_moved)}")
    check(frozen_mods == {"conv1", "bn1", "layer1"} and not det_changed,
          f"frozen v2 modules {sorted(frozen_mods)}, changed {det_changed[:5]}")
    check(stats and len(stats_moved) == len(stats),
          f"frozen stages' running statistics moved: {len(stats_moved)} of {len(stats)}")
    check(head_stats and len(head_moved) == len(head_stats),
          f"FPN and box-head running statistics moved: {len(head_moved)} of {len(head_stats)}")
    check(not teacher_changed, f"teacher tensors changed: {teacher_changed[:5]}")
    return dict(config=DET_V2_TRAIN_CONFIG, launches=launches, metrics=metrics,
                kernel_vs_plain=cmp, timing=timing, checks=res)


def lpips_phase(device) -> dict:
    """LPIPS (AlexNet, random weights written as an ``lpips`` state dict
    to a temporary file) through ``calculate_lpips`` on the card against
    the CPU, relative, at :data:`TOL_LPIPS_REL`."""
    import os
    import tempfile

    from edtr_torch.models.lpips import LPIPS
    from edtr_torch.utils.image import calculate_lpips

    torch.manual_seed(13)
    sd = LPIPS("alex").state_dict()
    for v in sd.values():
        v.copy_(torch.rand_like(v) * 0.1 if v.ndim == 4 and v.shape[0] == 1 else v)
    g = torch.Generator().manual_seed(14)
    a, b = torch.rand(LPIPS_IMAGES, generator=g), torch.rand(LPIPS_IMAGES, generator=g)
    fd, path = tempfile.mkstemp(suffix=".pth")
    os.close(fd)
    try:
        torch.save(sd, path)
        cpu = calculate_lpips(a, b, weights_path=path)
        card = calculate_lpips(a.to(device), b.to(device), weights_path=path)
        ms = host_ms(lambda: calculate_lpips(a.to(device), b.to(device), weights_path=path))
    finally:
        os.remove(path)
    rel = float(((card.cpu() - cpu).abs() / cpu.abs()).max())
    res = dict(images=list(LPIPS_IMAGES), card=card.tolist(), cpu=cpu.tolist(),
               max_rel=rel, tol_rel=TOL_LPIPS_REL, host_ms=ms)
    print("lpips (alex, random weights, card vs CPU):", json.dumps(res), flush=True)
    check(rel <= TOL_LPIPS_REL, f"LPIPS card vs CPU: {rel} > {TOL_LPIPS_REL}")
    return res


STAGE_FUNCTIONS = {"filter2d": "filter2d", "resize": "resize",
                   "random_add_gaussian_noise_pt": "gaussian",
                   "random_add_poisson_noise_pt": "poisson", "diff_jpeg": "diff_jpeg"}


@contextlib.contextmanager
def recorded_stages(n: int):
    """Inside, each stage of ``edtr_torch.data.realesrgan``'s transform
    records (stage, its input, its other arguments, its output), the
    first ``n`` images of each on the host, the per-image arguments (blur
    kernels, qualities, noise draws) sliced alike."""
    from edtr_torch.data import realesrgan as RG

    records = []

    def first(v):  # a per-image tensor, or a dict of them
        if isinstance(v, dict):
            return {k: first(x) for k, x in v.items()}
        return v[:n].cpu() if isinstance(v, torch.Tensor) else v

    def per_image(name, args):
        if name == "filter2d":  # a (B, K, K) stack or USM's one (K, K) kernel
            return (first(args[0]) if args[0].ndim == 3 else args[0].cpu(),)
        if name == "diff_jpeg":
            return (first(args[0]) if isinstance(args[0], torch.Tensor) else args[0],)
        return args  # resize: sizes and mode; noise: ranges and probabilities

    def wrap(fn, name):
        def stage(img, *args, **kw):
            out = fn(img, *args, **kw)
            records.append((name, first(img), per_image(name, args), first(kw),
                            first(out)))
            return out
        return stage

    saved = {attr: getattr(RG, attr) for attr in STAGE_FUNCTIONS}
    for attr, name in STAGE_FUNCTIONS.items():
        setattr(RG, attr, wrap(saved[attr], name))
    try:
        yield records
    finally:
        for attr, fn in saved.items():
            setattr(RG, attr, fn)


def jpeg_scaled(x: torch.Tensor, q: torch.Tensor) -> list:
    """The DCT coefficients over their quantisation steps of each JPEG
    component of an NCHW batch, (B, blocks, 8, 8), with the component's
    width in blocks (``edtr_torch.data.diffjpeg``'s stages)."""
    from edtr_torch.data import diffjpeg as DJ

    h, w = x.shape[-2:]
    ycc = DJ.rgb_to_ycbcr(F.pad(x, (0, (16 - w % 16) % 16, 0, (16 - h % 16) % 16)) * 255.0)
    factor = DJ.quality_to_factor(q).to(x.device)
    out = []
    for comp, table in ((ycc[:, 0], "y"), (DJ._avg_pool_2x2(ycc[:, 1]), "c"),
                        (DJ._avg_pool_2x2(ycc[:, 2]), "c")):
        step = DJ._table(table, x.device)[None, None] * factor[:, None, None, None]
        out.append(((DJ.block_dct(DJ._blockify(comp)) / step).cpu(), comp.shape[-1] // 8))
    return out


def jpeg_flips(x_card: torch.Tensor, x_cpu: torch.Tensor, q: torch.Tensor) -> tuple:
    """(share of the blocks whose quantised coefficients differ between the
    card and the CPU on one input, (B, H, W) pixels of those blocks, the
    largest distance of a flipped coefficient from a rounding tie)."""
    b, _, h, w = x_cpu.shape
    mask = torch.zeros((b, h + 16, w + 16), dtype=torch.bool)
    flipped = total = 0
    worst = 0.0
    for ci, ((sc, cw), (sh, _)) in enumerate(zip(jpeg_scaled(x_card, q.to(x_card.device)),
                                                 jpeg_scaled(x_cpu, q.cpu()))):
        flip = torch.round(sc) != torch.round(sh)
        if bool(flip.any()):
            worst = max(worst, float(((sh - sh.floor()) - 0.5).abs()[flip].max()))
        blocks = flip.any(-1).any(-1)
        flipped += int(blocks.sum())
        total += blocks.numel()
        px = 8 if ci == 0 else 16
        for bi, nb in blocks.nonzero().tolist():
            y0, x0 = (nb // cw) * px, (nb % cw) * px
            mask[bi, y0:y0 + px, x0:x0 + px] = True
    return flipped / total, mask[:, :h, :w], worst


def transform_vs_cpu(records: list, device) -> dict:
    """Each recorded stage of a card run recomputed on the CPU on its input
    and arguments (the card's draws) and held at :data:`TOL_DATA_STAGE`."""
    from edtr_torch.data import realesrgan as RG

    fns = {name: getattr(RG, attr) for attr, name in STAGE_FUNCTIONS.items()}
    worst, flips, tie = {}, 0.0, 0.0
    last_cpu = None
    for name, img, args, kw, out in records:
        got = fns[name](img, *args, **kw)
        err = (got - out).abs()
        if name == "diff_jpeg":
            share, mask, far = jpeg_flips(img.to(device), img, args[0])
            flips, tie = max(flips, share), max(tie, far)
            check(share <= DATA_FLIP_SHARE and far <= DATA_TIE,
                  f"JPEG card vs CPU: {share} of the blocks flipped, {far} from a tie")
            err = err.masked_fill(mask[:, None], 0)
        e = float(err.max())
        worst[name] = max(worst.get(name, 0.0), e)
        check(e <= TOL_DATA_STAGE[name], f"transform stage {name} card vs CPU: {e}")
        last_cpu = got
    return dict(stages=len(records), max_abs_by_stage=worst, jpeg_flipped_block_share=flips,
                jpeg_flip_tie_distance=tie, last_cpu=last_cpu)


def lq_vs_cpu(lq_card: torch.Tensor, last_cpu: torch.Tensor) -> dict:
    """The card's LQ (NCHW, first images) against the CPU's rounding of its
    last stage: the same 1/255 levels but one-level flips at ties (the
    card divides by 255 to within an ulp of the CPU)."""
    v = torch.clamp(last_cpu * 255.0, 0, 255)
    lq_card = lq_card.cpu()
    level = torch.round(lq_card * 255.0)
    flips = level != torch.round(v)
    share = float(flips.float().mean())
    tie = float(((v - v.floor()) - 0.5).abs()[flips].max()) if bool(flips.any()) else 0.0
    check(share <= DATA_FLIP_SHARE, f"LQ card vs CPU: {share} of the pixels differ")
    check(bool(((level - torch.round(v)).abs()[flips] == 1).all()), "LQ flips of one level")
    check(tie <= 255 * TOL_DATA_STAGE["resize"], f"LQ flips {tie} from a tie")
    ulp = float((lq_card - level / 255.0).abs().max())
    check(ulp <= 2.0 ** -24, f"LQ {ulp} off its level")
    return dict(lq_flipped_share=share, lq_flip_tie_distance=tie, lq_off_level=ulp)


def data_train_phase(weights: dict, device, batch_size: int = None, gt_size: int = None
                     ) -> dict:
    """The Real-ESRGAN training data path into SwinIR-pre v2 steps (module
    docstring, phase 27); ``batch_size`` and the dataset's ``gt_size`` the
    config's unless given (a CPU rehearsal shrinks them)."""
    import tempfile

    from torch.profiler import record_function

    from edtr_torch.config import instantiate_from_config, load_config
    from edtr_torch.data import realesrgan as RG
    from edtr_torch.data import synthetic
    from edtr_torch.data.degradation import filter2d
    from edtr_torch.profile_restore import trace_restores
    from edtr_torch.train import harness as H
    from edtr_torch.train import recipes as R

    cfg = load_config(DATA_TRAIN_CONFIG)
    tc = cfg.train
    bs = batch_size or int(tc.batch_size)
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        synthetic.write_coco_tree(root, n=DATA_COCO_IMAGES, size_range=DATA_COCO_SIDES,
                                  split="train", seed=27)
        write_s = time.perf_counter() - t0
        node = cfg.dataset.train.to_dict()
        node["params"] = dict(node["params"], root=root,
                              **(dict(gt_size=gt_size, out_size=gt_size) if gt_size else {}))
        dataset = instantiate_from_config(node)
        transform = instantiate_from_config(cfg.dataset.batch_transform, device=device)
        check(type(transform).__module__ == "edtr_torch.data.realesrgan",
              f"the config's transform builds {type(transform)}")
        loader = H.make_dataloader(dataset, batch_size=bs, shuffle=True, num_workers=0,
                                   aspect_ratio_group_factor=int(tc.aspect_ratio_group_factor),
                                   seed=int(tc.seed))
        t0 = time.perf_counter()
        batch = next(iter(loader))
        load_ms = (time.perf_counter() - t0) * 1e3
    check(len(batch[0]) == bs and len(dataset) == DATA_COCO_IMAGES - 1,
          f"loader batch {len(batch[0])}, dataset {len(dataset)}")
    print(f"data train: {DATA_TRAIN_CONFIG}, synthetic COCO tree of {DATA_COCO_IMAGES} images "
          f"{DATA_COCO_SIDES} px written in {write_s:.1f} s, {type(dataset).__name__} of "
          f"{len(dataset)}, a batch of {bs} loaded in {load_ms:.1f} ms (host, no workers)",
          flush=True)

    def prepare():
        return H.prepare_batch(batch, IMAGE, batch_transform=transform)

    prepare()  # the resize matrices, the tables and USM's kernel made on the card
    times = [host_ms(prepare) for _ in range(DATA_TIMED)]

    def traced():
        with record_function("transform"):
            prepare()

    trace = trace_restores(traced, 1, ("transform",))
    st = trace["stages"]["transform"]
    check(st["dtoh_memcpy"] == 0, f"{st['dtoh_memcpy']} device-to-host copies in the transform")
    # no device-to-host copy, and no other wait for the card: any
    # synchronising call inside the transform raises
    torch.cuda.set_sync_debug_mode("error")
    try:
        prepare()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    # the batch the steps train on, its stages recorded and recomputed on the CPU
    with recorded_stages(DATA_CPU_IMAGES) as records:
        _, _, gt_b, lq_b, _, _, _ = prepare()
    stages = transform_vs_cpu(records, device)
    hq = torch.from_numpy(H.list_to_batch([np.asarray(g) for g in batch[0][:DATA_CPU_IMAGES]],
                                          IMAGE)).permute(0, 3, 1, 2)
    gt_err = float((transform.usm(hq.contiguous()) - gt_b[:DATA_CPU_IMAGES].permute(
        0, 3, 1, 2).cpu()).abs().max())
    check(gt_err <= TOL_DATA_STAGE["filter2d"], f"GT card vs CPU {gt_err}")
    lq_check = lq_vs_cpu(lq_b[:DATA_CPU_IMAGES].permute(0, 3, 1, 2), stages.pop("last_cpu"))
    for name, t in (("GT", gt_b), ("LQ", lq_b)):
        check(t.device.type == device.type and tuple(t.shape) == (bs, IMAGE, IMAGE, 3),
              f"{name} {t.device} {tuple(t.shape)}")
        check(bool(torch.isfinite(t).all()) and float(t.min()) >= 0 and float(t.max()) <= 1,
              f"{name} finite in [0, 1]")
    lq_gt = float((lq_b - gt_b).abs().mean())
    check(lq_gt > 1e-3, f"LQ equals GT ({lq_gt})")
    # USM's two 51 x 51 filters and the resize products at this batch
    g = torch.Generator(device=device).manual_seed(28)
    x = torch.rand((bs, 3, IMAGE, IMAGE), generator=g, device=device)
    k21 = torch.rand((bs, 21, 21), generator=g, device=device)
    small = torch.rand((bs, 3, IMAGE // 4, IMAGE // 4), generator=g, device=device)
    op_ms = dict(usm=device_ms(lambda: transform.usm(x), 3, what="usm"),
                 filter2d_21=device_ms(lambda: filter2d(x, k21), 3, what="filter2d 21"),
                 resize_down_bicubic=device_ms(lambda: RG.resize(x, IMAGE // 4, IMAGE // 4,
                                                                 "bicubic"), 3,
                                               what="resize down"),
                 resize_back_bicubic=device_ms(lambda: RG.resize(small, IMAGE, IMAGE,
                                                                 "bicubic"), 3,
                                               what="resize back"))
    del x, k21, small
    res = dict(config=DATA_TRAIN_CONFIG, batch=bs, dataset=len(dataset), load_ms=load_ms,
               transform_ms=statistics.median(times), transform_runs_ms=times,
               transform_device_busy_ms=st["device_busy_ms"], transform_kernels=st["kernels"],
               transform_htod_memcpy=st["htod_memcpy"], transform_dtoh_memcpy=st["dtoh_memcpy"],
               transform_idle_share=st["idle_share"], card_vs_cpu=stages, gt_card_vs_cpu=gt_err,
               **lq_check, lq_gt_mean_abs=lq_gt, op_device_ms=op_ms)
    print(f"data train transform (bs {bs}, {IMAGE}²):", json.dumps(res), flush=True)

    # SwinIR-pre v2 steps from the config on that batch
    sw = recipe_swinir(cfg, weights, device)
    state = R.SimpleTrainState.create(sw, R.cosine_tx("adamw", float(tc.learning_rate),
                                                      int(tc.train_steps), weight_decay=0.0))
    step = R.make_swinir_pre_train_step(sw)
    batch_t = dict(lq=lq_b, gt=gt_b)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    out = {}
    first_ms = host_ms(lambda: out.update(step(state, batch_t)))
    launches, shapes, _ = read_counts()
    want = recipe_launches("swinir_pre")
    check(launches == want, f"data train step launches {launches}, want {want}")
    losses = [out["loss"].item()]
    step_ms = [first_ms]
    for _ in range(DATA_STEPS - 1):
        step_ms.append(host_ms(lambda: out.update(step(state, batch_t))))
        losses.append(out["loss"].item())
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    check(all(math.isfinite(v) for v in losses), f"data train losses {losses}")
    held = hold_shapes(device, shapes)
    check(set(held) == {k for k, n in launches.items() if n}, f"held {sorted(held)}")
    res.update(steps=DATA_STEPS, step_ms=step_ms, losses=losses, peak_memory_gib=peak,
               launches=launches, held=held)
    print(f"data train: {DATA_STEPS} SwinIR-pre v2 steps at bs {bs}: step ms {step_ms}, "
          f"losses {losses}, peak {peak:.2f} GiB, launches {launches}; kernels held at the "
          f"bs-{bs} shapes: {json.dumps(held)}", flush=True)
    del sw, state, step, batch_t, gt_b, lq_b
    return res


def data_eval_phase(weights: dict, device, gt_size: int = None, detector_kw: dict = None
                    ) -> dict:
    """The VOC evaluation path (module docstring, phase 28); the datasets'
    ``gt_size`` the configs' unless given, ``detector_kw`` more keywords of
    the detector (a CPU rehearsal shrinks both)."""
    import os
    import tempfile

    import yaml

    from edtr_torch.config import instantiate_from_config
    from edtr_torch.data.coco import gt_from_dataset
    from edtr_torch.data import synthetic
    from edtr_torch.data.val_data_generation import generate
    from edtr_torch.pipeline import FUSED_CONV_DEFAULT, FUSED_PROJ_DEFAULT, FUSED_SWIN_DEFAULT
    from edtr_torch.train.edtr_step import make_edtr_sample_fn
    from edtr_torch.train.harness import list_to_batch
    from edtr_torch.utils.coco_eval import CocoEvaluator
    from edtr_torch.utils.image import calculate_psnr

    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        synthetic.write_voc_tree(root, n=DATA_VOC_IMAGES, size_range=DATA_VOC_SIDES, seed=29)
        with open(DATA_GEN_CONFIG) as f:
            gen = yaml.safe_load(f)
        gen["dataset"]["train"]["params"].update(
            root=root, **(dict(gt_size=gt_size, out_size=gt_size) if gt_size else {}))
        gen_path = os.path.join(root, "gen.yaml")
        with open(gen_path, "w") as f:
            yaml.safe_dump(gen, f)
        out_dir = generate(gen_path, "det", seed=231)
        gen_s = time.perf_counter() - t0
        pairs = sorted(os.listdir(os.path.join(out_dir, "lq")))
        check(len(pairs) == DATA_VOC_IMAGES, f"val_data_generation wrote {pairs}")
        cfg, pipe = config_pipeline(DATA_EVAL_CONFIG, weights, device)
        node = cfg.dataset.val.to_dict()
        node["params"] = dict(node["params"], root=root,
                              **(dict(gt_size=gt_size) if gt_size else {}))
        dataset = instantiate_from_config(node)
        items = [dataset[i] for i in range(len(dataset))]
        gt_index = gt_from_dataset(dataset)
    flags = (FUSED_CONV_DEFAULT, FUSED_PROJ_DEFAULT, FUSED_SWIN_DEFAULT)
    check((pipe.fused_conv, pipe.fused_proj, pipe.fused_swin) == flags,
          "the eval config's pipeline in the default configuration")
    sample = make_edtr_sample_fn(pipe)
    c_txt = pipe.text(1)
    g = torch.Generator(device=device).manual_seed(30)

    def restore(lq):
        lq_b = torch.from_numpy(list_to_batch([lq], IMAGE)).to(device)
        return sample(lq_b, c_txt, generator=g)

    first = restore(items[0][1]).permute(0, 3, 1, 2).clamp(0, 1)
    # the config's detector without its named ImageNet backbone (not in the
    # repository; the port loads no weights by name): seeded, calibrated
    node = cfg.model.detnet.to_dict()
    params = {k: v for k, v in node["params"].items() if k not in ("weights", "weights_backbone")}
    det, _ = detector_pair(device, first, lambda **kw: instantiate_from_config(
        dict(node, params=params), **(detector_kw or {}), **kw))
    with torch.no_grad():
        det(first)
    evaluator = CocoEvaluator(gt_index)
    psnrs, found = [], 0
    torch.cuda.synchronize()
    # the main path: counts set to 0 just before the loop, read just after
    zero_counts()
    t0 = time.perf_counter()
    for gt, lq, annot, _ in items:
        h, w = gt.shape[:2]
        restored = restore(lq)
        gt_b = torch.from_numpy(list_to_batch([gt], IMAGE)).to(device)
        psnrs.append(float(calculate_psnr(restored[:, :h, :w].permute(0, 3, 1, 2),
                                          gt_b[:, :h, :w].permute(0, 3, 1, 2))[0]))
        with torch.no_grad():
            dets = det(restored.permute(0, 3, 1, 2).clamp(0, 1))[0]
        valid = dets["valid"][0]
        found += int(valid.sum())
        evaluator.update({annot["image_id"]: dict(boxes=dets["boxes"][0][valid],
                                                  scores=dets["scores"][0][valid],
                                                  labels=dets["labels"][0][valid])})
    torch.cuda.synchronize()
    loop_ms = (time.perf_counter() - t0) * 1e3
    launches, shapes, copies = read_counts()
    want = {k: n * len(items) for k, n in expected_launches(flags).items()}
    check(launches == want, f"data eval launches {launches}, want {want}")
    evaluator.synchronize_between_processes()
    evaluator.accumulate()
    stats = evaluator.summarize(verbose=False)
    check(len(stats) == 12 and all(math.isfinite(v) and -1 <= v <= 1 for v in stats.values()),
          f"COCO stats {stats}")
    check(all(math.isfinite(p) for p in psnrs), f"PSNR {psnrs}")
    res = dict(config=DATA_EVAL_CONFIG, generated_by=DATA_GEN_CONFIG, images=len(items),
               generate_s=gen_s, ms_per_image=loop_ms / len(items), psnr=statistics.mean(psnrs),
               detections=found, coco_stats=stats, launches=launches, layout_copies=copies)
    print(f"data eval (VOC, restore+detect, {IMAGE}²):", json.dumps(res), flush=True)
    del pipe, det
    return dict(res, shapes=shapes)


def runner_launches(run: str, seg_sizes=()) -> dict:
    """The exact launches of each runner run (module docstring, phase 29):
    ``train`` 2 steps of RUNNER_ACCUM bs-2 microbatches (each the detector
    step's ``TRAIN_LAUNCHES_DET``), a step's grid (a bs-4 restore and its
    pre-restore) and 2 validation restores; ``resume`` one step; ``test``
    4 restores; ``seg_swinir`` a SwinIR pass at each image's size."""
    from edtr_torch.pipeline import FUSED_CONV_DEFAULT, FUSED_PROJ_DEFAULT, FUSED_SWIN_DEFAULT

    restore = expected_launches((FUSED_CONV_DEFAULT, FUSED_PROJ_DEFAULT, FUSED_SWIN_DEFAULT))
    steps, val, test = RUNNER_DEBUG["steps"], RUNNER_DEBUG["val"], RUNNER_DEBUG["test"]
    return {"train": lambda: launch_sum((steps * RUNNER_ACCUM, TRAIN_LAUNCHES_DET),
                                        (steps * (1 + val), restore), (steps, SWINIR_PASS)),
            "resume": lambda: launch_sum((RUNNER_ACCUM, TRAIN_LAUNCHES_DET)),
            "test": lambda: launch_sum((test, restore)),
            "seg_swinir": lambda: launch_sum(*[swinir_launches(h, w) for h, w in seg_sizes]),
            }[run]()


def _same_state(a, b) -> bool:
    """Nested state dicts equal, tensors bit for bit (on the host)."""
    if isinstance(a, torch.Tensor):
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.detach().cpu(), b.detach().cpu()))
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same_state(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_state(x, y) for x, y in zip(a, b))
    return a == b


def _dir_bytes(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def _config_copy(src: str, dst: str, changes: dict) -> str:
    """``src`` (a repo config) written to ``dst`` with ``changes`` ({section:
    {key: value}} for ``train``/``test``/``val``, {"dataset": root} for every
    dataset root), each printed."""
    import yaml

    with open(src) as f:
        cfg = yaml.safe_load(f)
    for section, items in changes.items():
        if section == "dataset":
            for name, node in cfg["dataset"].items():
                if isinstance(node, dict) and "params" in node:
                    print(f"  {src}: dataset.{name}.params.root: "
                          f"{node['params']['root']!r} -> {items!r}", flush=True)
                    node["params"]["root"] = items
            continue
        for key, value in items.items():
            print(f"  {src}: {section}.{key}: {cfg[section].get(key, '(absent)')!r} -> "
                  f"{value!r}", flush=True)
            cfg[section][key] = value
    with open(dst, "w") as f:
        yaml.safe_dump(cfg, f)
    return dst


def runner_run(name: str, argv: list, exp_dirs: tuple, want: dict) -> dict:
    """``cli.main(argv)`` with every launch count set to 0 just before it and
    read just after, held to ``want``; its wall seconds, peak GiB and the
    bytes its experiment directories gained."""
    from edtr_torch import cli

    before = sum(_dir_bytes(d) for d in exp_dirs)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    out = cli.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, _, copies = read_counts()
    check(launches == want, f"runner {name}: launches {launches}, want {want}")
    res = dict(argv=" ".join(argv[:2] + [a for a in argv[2:] if a.startswith("--")]),
               wall_s=wall, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               bytes_written=sum(_dir_bytes(d) for d in exp_dirs) - before,
               launches=launches, layout_copies=copies)
    print(f"runner {name}: {wall:.1f} s, peak {res['peak_gib']:.2f} GiB, "
          f"{res['bytes_written'] / 1e9:.2f} GB written", flush=True)
    return dict(res, out=out)


def runner_phase(device, n_images: int = RUNNER_VOC_IMAGES, sides: tuple = RUNNER_VOC_SIDES,
                 edit=None) -> dict:
    """Phase 29 (module docstring): the entry points of ``python -m
    edtr_torch.cli`` from the flagship det configs and the seg SwinIR test
    config on a synthetic VOC tree; ``edit(cfg_path)`` rewrites each config
    copy further (a CPU rehearsal shrinks the models and images)."""
    import json as _json
    import os
    import shutil
    import tempfile

    import yaml

    from edtr_torch.config import instantiate_from_config, load_config
    from edtr_torch.data import synthetic
    from edtr_torch.data.val_data_generation import generate
    from edtr_torch.train import runner as RUN
    from edtr_torch.train.harness import list_to_batch
    from edtr_torch.utils import checkpoint as ckpt

    edit = edit or (lambda path: path)
    tmp = tempfile.mkdtemp(prefix="edtr_runner_")
    res = {}
    try:
        root = os.path.join(tmp, "voc")
        t0 = time.perf_counter()
        synthetic.write_voc_tree(root, n=n_images, size_range=sides, seed=41)
        base = os.path.join(root, "VOCdevkit", "VOC2012", "ImageSets")
        names = [f"2012_{i:06d}" for i in range(RUNNER_VAL_IMAGES)]
        for sub in ("Main", "Segmentation"):
            with open(os.path.join(base, sub, "val.txt"), "w") as f:
                f.write("\n".join(names) + "\n")
        for src, task in ((DATA_GEN_CONFIG, "det"), (RUNNER_SEG_GEN_CONFIG, "seg")):
            # the val pairs of the val split alone, from the config's degradation
            path = _config_copy(src, os.path.join(tmp, f"gen_{task}.yaml"), {"dataset": root})
            with open(path) as f:
                gen = yaml.safe_load(f)
            gen["dataset"]["train"]["params"]["image_set"] = "val"
            with open(path, "w") as f:
                yaml.safe_dump(gen, f)
            generate(edit(path), task, seed=231)
        res["data_s"] = time.perf_counter() - t0
        exp, exp_test, exp_seg = (os.path.join(tmp, n) for n in ("exp", "exp_test", "exp_seg"))
        ck = os.path.join(exp, "checkpoints")
        print("runner configs (copies; the changes):", flush=True)
        train_cfg = edit(_config_copy(RUNNER_TRAIN_CONFIG, os.path.join(tmp, "train.yaml"),
                                      {"dataset": root, "train": dict(
                                          exp_dir=exp, accum_steps=RUNNER_ACCUM)}))
        resume_cfg = edit(_config_copy(train_cfg, os.path.join(tmp, "resume.yaml"), {
            "train": dict(resume_state=True, train_steps=RUNNER_DEBUG["steps"] + 1)}))
        last = {k: os.path.join(ck, f"{part}_last.pt") for k, part in (
            ("resume_cldm", "controlnet"), ("resume_swinir", "swinir"),
            ("resume_decoder", "decoder"), ("resume_detnet", "detnet"),
            ("resume_teacher_detnet", "detnet"))}
        test_cfg = edit(_config_copy(RUNNER_TEST_CONFIG, os.path.join(tmp, "test.yaml"),
                                     {"dataset": root, "test": dict(exp_dir=exp_test, **last)}))
        seg_cfg = edit(_config_copy(RUNNER_SEG_CONFIG, os.path.join(tmp, "seg.yaml"),
                                    {"dataset": root, "test": dict(exp_dir=exp_seg)}))

        # det train_edtr --debug: 2 steps, each logged, saved, a grid, validated
        run = runner_run("train", ["det", "train_edtr", "--config", train_cfg, "--debug"],
                         (exp,), runner_launches("train"))
        state = run.pop("out")
        check(state.step == RUNNER_DEBUG["steps"], f"train_edtr took {state.step} steps")
        del state
        want = {f"{p}_{t}.pt" for p in ("controlnet", "decoder", "detnet", "swinir")
                for t in ("1", "2", "last")} | {"trainstate_last.pt"}
        check(set(os.listdir(ck)) == want, f"checkpoints {sorted(os.listdir(ck))}")
        with open(os.path.join(exp, "logs", "scalars.jsonl")) as f:
            scalars = [_json.loads(line) for line in f]
        losses = [r for r in scalars if r["tag"].startswith("train/")]
        check(len({r["step"] for r in losses}) == RUNNER_DEBUG["steps"]
              and all(math.isfinite(r["value"]) for r in losses), f"train scalars {losses}")
        log = open(os.path.join(exp, "run.log")).read()
        check(all(f"val @ step {i + 1}:" in log for i in range(RUNNER_DEBUG["steps"])),
              "a val line at every step")
        grids = sorted(os.listdir(os.path.join(exp, "images")))
        check(grids == [f"step_{i + 1:07d}.png" for i in range(RUNNER_DEBUG["steps"])],
              f"grids {grids}")
        run["losses"] = {r["tag"][len("train/"):]: r["value"] for r in losses
                         if r["step"] == RUNNER_DEBUG["steps"]}
        run["val"] = [{k: v["value"] for k, v in ((r["tag"][4:], r) for r in scalars
                                                   if r["tag"].startswith("val/")
                                                   and r["step"] == i + 1)}
                      for i in range(RUNNER_DEBUG["steps"])]
        run["checkpoint_bytes"] = {n: os.path.getsize(os.path.join(ck, n)) for n in sorted(want)
                                   if n.endswith("_last.pt")}
        res["train"] = run

        # the resumed run: the saved train state loads back bit for bit, one step
        restored = {}
        real_restore = ckpt.restore_checkpoint

        def restore_and_compare(path, state):
            real_restore(path, state)
            saved = torch.load(path, map_location="cpu", weights_only=True)
            parts = ckpt._stateful(state)
            restored["differ"] = [n for n, p in parts.items()
                                  if not _same_state(p.state_dict(), saved[n])]
            restored["parts"] = sorted(parts)
            restored["step"] = (state.step, saved["step"])

        ckpt.restore_checkpoint = restore_and_compare
        try:
            run = runner_run("resume", ["det", "train_edtr", "--config", resume_cfg], (exp,),
                             runner_launches("resume"))
        finally:
            ckpt.restore_checkpoint = real_restore
        state = run.pop("out")
        check(restored.get("differ") == [] and restored["step"] == (2, 2),
              f"resume: {restored}")
        check(state.step == RUNNER_DEBUG["steps"] + 1, f"resumed run ended at {state.step}")
        check(len(restored["parts"]) == 7, f"train state parts {restored['parts']}")
        run["restored_bit_identical"] = restored["parts"]
        del state
        res["resume"] = run

        # det test_edtr --debug --save-img --calc-fd; image 0 against a direct call
        seen = {}
        real_sample, real_det = RUN.make_edtr_sample_fn, RUN.det_eval_fn

        def sample_spy(pipe):
            seen["pipe"] = pipe
            return real_sample(pipe)

        def det_spy(det, images):
            out = real_det(det, images)
            seen.setdefault("dets", []).append({k: v.clone() for k, v in out.items()})
            seen["det"] = det
            return out

        RUN.make_edtr_sample_fn, RUN.det_eval_fn = sample_spy, det_spy
        try:
            run = runner_run("test", ["det", "test_edtr", "--config", test_cfg, "--debug",
                                      "--save-img", "--calc-fd"], (exp_test,),
                             runner_launches("test"))
        finally:
            RUN.make_edtr_sample_fn, RUN.det_eval_fn = real_sample, real_det
        stats = run.pop("out")
        check(math.isfinite(stats["psnr"]) and math.isfinite(stats["feature_distance"])
              and -1 <= stats["AP"] <= 1, f"test stats {stats}")
        pngs = sorted(os.listdir(os.path.join(exp_test, "images")))
        check(pngs == [f"{i:05d}.png" for i in range(RUNNER_DEBUG["test"])], f"pngs {pngs}")
        check(len(seen["dets"]) == RUNNER_DEBUG["test"], "a detection call an image")
        cfg = load_config(test_cfg)
        gt, lq, _, _ = instantiate_from_config(cfg.dataset.val)[0]
        pipe = seen.pop("pipe")
        with torch.no_grad():
            c_txt = pipe.cldm.encode_text([cfg.test.get("default_prompt", "")])
        g = torch.Generator(device=device).manual_seed(231)
        lq_b = torch.from_numpy(list_to_batch([lq], RUN.IMG_SIZE)).to(device)
        direct = real_det(seen.pop("det"), pipe.restore(lq_b, c_txt, generator=g)["restored"])
        first = seen.pop("dets")[0]
        check(all(torch.equal(first[k], direct[k]) for k in ("boxes", "scores", "labels",
                                                               "valid")),
              "test_edtr's image 0 detections equal restore + detect called directly")
        del pipe
        run.update(stats={k: stats[k] for k in ("psnr", "AP", "AP50", "feature_distance")},
                   detections_image0=int(first["valid"].sum()), image0_equal_direct=True)
        res["test"] = run

        # seg test_swinir --debug: the restore-then-segment loop at full width
        seg_ds = instantiate_from_config(load_config(seg_cfg).dataset.val)
        sizes = [seg_ds[i][0].shape[:2] for i in range(RUNNER_DEBUG["seg"])]
        run = runner_run("seg_swinir", ["seg", "test_swinir", "--config", seg_cfg, "--debug"],
                         (exp_seg,), runner_launches("seg_swinir", sizes))
        stats = run.pop("out")
        check(math.isfinite(stats["psnr"]) and math.isfinite(stats["miou"]),
              f"seg stats {stats}")
        run.update(stats=stats, image_sizes=[list(s) for s in sizes])
        res["seg_swinir"] = run
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print("runner:", json.dumps({k: {kk: vv for kk, vv in v.items() if kk != "launches"}
                                 if isinstance(v, dict) else v for k, v in res.items()}),
          flush=True)
    return res


def demo_phases(weights: dict, device, counted: dict) -> dict:
    """Phases 22-25 on the demo config's pipeline (the flagship's weights):
    restore then detect with the v2, the untiled and the all-tiled demo
    (their counted runs' launches into ``counted``), then LPIPS."""
    cfg, pipe = config_pipeline(DEMO_CONFIG, weights, device)
    out = {}
    out["restore_detect_v2"], counted["restore+detect v2"], det = detect_v2_phase(cfg, pipe,
                                                                                  device)
    for tiled, name in ((False, "demo"), (True, "demo tiled")):
        out[name.replace(" ", "_")], counted[name] = demo_phase(pipe, det, device, tiled)
    del pipe, det
    gc.collect()
    torch.cuda.empty_cache()
    out["lpips"] = lpips_phase(device)
    return out


def launch_sum(*parts) -> dict:
    """Launches of every kernel wrapper summed over ``parts``, each a dict
    of launches per pass or (passes, that dict); 0 for the others."""
    total = {name: 0 for name in TRAIN_LAUNCHES}
    for part in parts:
        n, counts = part if isinstance(part, tuple) else (1, part)
        for name, k in counts.items():
            total[name] += n * k
    return total


def recipe_launches(recipe: str) -> dict:
    """The exact launches of one step of ``recipe`` (:data:`RECIPE_PASSES`),
    after checking that the same passes sum to the training step's and the
    walk's counts, which earlier phases hold."""
    check(launch_sum(SWINIR_PASS, ENCODE_PASS, EPS_PASS, EPS_REMAT, EPS_BWD, DECODE_PASS,
                     DECODE_REMAT) == TRAIN_LAUNCHES, "the passes sum to TRAIN_LAUNCHES")
    walk = launch_sum((4, EPS_PASS), DECODE_PASS)
    check({k: n for k, n in walk.items() if n} == WALK_LAUNCHES,
          "the passes sum to WALK_LAUNCHES")
    return launch_sum(*RECIPE_PASSES[recipe])


def attention_wrapper(n: int, d: int):
    """The flash wrapper JAX's dispatch sends an N-token, D-wide
    self-attention to (``shapes_supported``, then ``kernel_for``), or None
    (JAX leaves it to XLA; the port to the plain math)."""
    from edtr_torch.ops import flash_attention as FA

    q = torch.empty((1, n, 1, d), device="meta")
    return FA.kernel_for(n, d) if FA.shapes_supported(q, q, q) else None


def _add(counts: dict, name, n: int = 1) -> None:
    if name is not None:
        counts[name] = counts.get(name, 0) + n


def eps_launches(lh: int, lw: int) -> dict:
    """One ControlNet + UNet eps forward on an (lh, lw) latent: at each of
    the four levels (each half the last) its ResBlock halves (ControlNet 2
    + UNet 5 ResBlocks at levels 0-2, 4 + 7 at level 3 with the middle
    blocks) in the conv tier of the level's height, at levels 0-2 its 7
    self-attentions (64 wide) in the wrapper of their token count, and the
    UNet's 3 upsamples (:data:`EPS_PASS` at 64²)."""
    from edtr_torch.ops.gn_conv import tier

    counts = {"upsample_conv": 3}
    for level in range(4):
        h, w = lh >> level, lw >> level
        _add(counts, tier(h), 2 * (11 if level == 3 else 7))
        if level < 3:
            _add(counts, attention_wrapper(h * w, 64), 7)
    return counts


def encode_launches(h: int, w: int) -> dict:
    """The VAE encoder on an (h, w) image: 2 ResBlocks at each of its four
    levels and 2 in the middle, their halves in the tier of their height,
    and the middle attention (one head, 512 wide) over (h/8)(w/8) tokens
    (:data:`ENCODE_PASS` at 512²)."""
    from edtr_torch.ops.gn_conv import tier

    counts = {}
    for level in range(4):
        _add(counts, tier(h >> level), 4)
    _add(counts, tier(h >> 3), 4)
    _add(counts, attention_wrapper((h >> 3) * (w >> 3), 512))
    return counts


def decode_launches(lh: int, lw: int) -> dict:
    """The VAE decoder on an (lh, lw) latent: the middle attention and 2
    ResBlocks there, 3 ResBlocks at each of four levels (each twice the
    last), their halves in the tier of their height, and 3 upsamples
    (:data:`DECODE_PASS` at 64²)."""
    from edtr_torch.ops.gn_conv import tier

    counts = {"upsample_conv": 3}
    _add(counts, attention_wrapper(lh * lw, 512))
    _add(counts, tier(lh), 4)
    for level in range(4):
        _add(counts, tier(lh << level), 6)
    return counts


def swinir_launches(h: int, w: int) -> dict:
    """SwinIR on an (h, w) image: each of its 48 blocks' three Swin kernels
    where the fused block takes the (h/8, w/8) token grid (window 8), and
    the tail's 3 upsamples (:data:`SWINIR_PASS` at 512²)."""
    from edtr_torch.ops.swin_block import supported

    counts = {"upsample_conv": 3}
    if supported(h // 8, w // 8, 8):
        counts.update(window_attention=48, swin_pre=48, swin_post=48)
    return counts


def demo_tiles(h: int, w: int) -> dict:
    """The all-tiled demo's tile plans on an (h, w) image (multiples of 64,
    at least 512), each (tiles, tile side) as ``edtr_torch.utils.tiling``
    lays them out: SwinIR's, the encoder's two passes (at stride side, then
    3/4 side), the walk's (each of 4 steps), the decoder's two passes (its
    tile shrunk to the latent), and the detector's."""
    from edtr_torch.demo import DEFAULTS as D
    from edtr_torch.utils.tiling import sliding_windows, tile_plan

    def plan(hh, ww, size, stride=None):
        first = tile_plan(hh, ww, size, stride or size)
        side = first[0][1] - first[0][0]
        return ((len(first), len(tile_plan(hh, ww, side, side * 3 // 4))) if stride is None
                else len(first)), side

    return dict(swinir=plan(h, w, D["pre_res_tile_size"], D["pre_res_tile_stride"]),
                vae_encoder=plan(h, w, D["vae_encoder_tile_size"]),
                latent=plan(h // 8, w // 8, D["cldm_tile_size"] // 8, D["cldm_tile_stride"] // 8),
                vae_decoder=plan(h // 8, w // 8, D["vae_decoder_tile_size"]),
                detect=(len(sliding_windows(h, w, D["detection_tile_size"],
                                            D["detection_tile_stride"])),
                        D["detection_tile_size"]))


def tile_counts(h: int, w: int) -> dict:
    """The tiles of each plan of :func:`demo_tiles`."""
    return {name: n for name, (n, _) in demo_tiles(h, w).items()}


def demo_launches(h: int, w: int, tiled: bool) -> dict:
    """The exact launches of ``restore_and_detect`` on an (h, w) image
    (multiples of 64, at least 512) with the demo's default tiles
    (``tiled``: the tile plans of :func:`demo_tiles`) or none; 4 walk
    steps; the detector and the text tower launch none of the port's
    kernels."""
    if not tiled:
        return launch_sum(swinir_launches(h, w), encode_launches(h, w),
                          (4, eps_launches(h // 8, w // 8)), decode_launches(h // 8, w // 8))
    t = demo_tiles(h, w)
    (n_sw, sw), (n_enc, enc), (n_lat, lat), (n_dec, dec) = (
        t[k] for k in ("swinir", "vae_encoder", "latent", "vae_decoder"))
    return launch_sum((n_sw, swinir_launches(sw, sw)), (sum(n_enc), encode_launches(enc, enc)),
                      (4 * n_lat, eps_launches(lat, lat)), (sum(n_dec), decode_launches(dec, dec)))


def recipe_run(name: str, call, want: dict) -> dict:
    """One step of a recipe as a caller makes it (``call()`` -> metrics):
    one warm-up; one counted (every count 0 just before, read just after,
    held to ``want``; the peak memory); :data:`RECIPE_TIMED` timed on the
    host clock (their median); one traced under a ``step`` range, its
    phases the recipes' ranges (``profile_restore.RECIPE_STAGES``), no
    host-to-device copy inside it. The metrics must be finite."""
    from torch.profiler import record_function

    from edtr_torch.profile_restore import RECIPE_STAGES, trace_restores

    call()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    out = {}
    first_ms = host_ms(lambda: out.update(call()))
    launches, shapes, _ = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    metrics = {k: v.item() for k, v in out.items()}
    print(f"{name} step counted: {first_ms:.1f} ms, metrics {metrics}, launches {launches}, "
          f"peak memory {peak:.2f} GiB (max_memory_allocated)", flush=True)
    check(launches == want, f"{name} launches {launches}, want {want}")
    check(all(math.isfinite(v) for v in metrics.values()), f"{name} step losses {metrics}")
    steps = [host_ms(call) for _ in range(RECIPE_TIMED)]

    def traced():
        with record_function("step"):
            call()

    stages = ("step",) + RECIPE_STAGES
    trace = trace_restores(traced, 1, stages)
    st = trace["stages"]
    check(st["step"]["htod_memcpy"] == 0,
          f"{name}: {st['step']['htod_memcpy']} host-to-device copies in a step")
    used = [s_ for s_ in RECIPE_STAGES if st[s_]["host_ms"]]
    timing = dict(step_ms=statistics.median(steps), step_runs_ms=steps,
                  phase_host_ms_traced={s_: st[s_]["host_ms"] for s_ in used},
                  phase_device_busy_ms_traced={s_: st[s_]["device_busy_ms"] for s_ in used},
                  device_busy_ms=st["step"]["device_busy_ms"], kernels=st["step"]["kernels"],
                  idle_share=st["step"]["idle_share"], htod_memcpy=st["step"]["htod_memcpy"],
                  peak_memory_gib=peak, image=IMAGE)
    print(f"{name} step: {timing['step_ms']:.2f} ms (median of {RECIPE_TIMED} after a warm-up "
          f"and the counted step, {IMAGE}², host clock around synchronised steps; phases from a "
          f"traced step):", json.dumps(timing), flush=True)
    print(f"trace of one {name} step:", json.dumps(trace), flush=True)
    return dict(launches=launches, shapes=shapes, metrics=metrics, timing=timing, trace=trace)


def gate_rule(kernel_vs_plain: float, plain_vs_fp32: float, kernel_vs_fp32: float) -> tuple:
    """(passes, the rule): kernel vs plain within :data:`TOL_GRAD_REL`;
    where the control shows the plain bf16 path itself farther than that
    from fp32, the kernel path no farther from fp32 than
    :data:`TOL_CONTROL_RATIO` times the plain path (fixed before the first
    run, PERF.md §6)."""
    if plain_vs_fp32 <= TOL_GRAD_REL:
        return kernel_vs_plain <= TOL_GRAD_REL, f"kernel vs plain <= {TOL_GRAD_REL}"
    return (kernel_vs_fp32 <= TOL_CONTROL_RATIO * plain_vs_fp32,
            f"kernel vs fp32 <= {TOL_CONTROL_RATIO} x plain vs fp32 (plain bf16 vs fp32 "
            f"> {TOL_GRAD_REL})")


def path_grads(name: str, grads_fn, params: dict, parts: dict, modules,
               gate: str = None) -> dict:
    """Gradients of ``params`` on the kernel path against the plain path:
    ``grads_fn(kernel)`` runs one backward into ``.grad`` (cleared before
    each), on the plain path (``kernel`` False) twice, then computing in
    fp32 (:func:`computing_in` over ``modules``: the control), then on the
    kernel path. Per part (names of ``params``): relative L2 kernel vs
    plain, plain vs plain again, plain vs fp32, kernel vs fp32; part
    ``gate`` is held by :func:`gate_rule`, the others printed (all of them
    when ``gate`` is None)."""
    def run(kernel: bool, fp32: bool = False) -> dict:
        for p in params.values():
            p.grad = None
        with computing_in(torch.float32, *modules) if fp32 else contextlib.nullcontext():
            grads_fn(kernel)
        out = {n: p.grad.detach().float().clone() for n, p in params.items()}
        check(all(bool(torch.isfinite(v).all()) for v in out.values()),
              f"{name} gradients finite (kernel {kernel}, fp32 {fp32})")
        return out

    plain, again = run(False), run(False)
    fp32 = run(False, True)
    kern = run(True)

    res = {part: dict(kernel_vs_plain=rel_l2_over(kern, plain, names),
                      plain_vs_plain_again=rel_l2_over(again, plain, names),
                      plain_vs_fp32=rel_l2_over(plain, fp32, names),
                      kernel_vs_fp32=rel_l2_over(kern, fp32, names))
           for part, names in parts.items() if names}
    del plain, again, fp32, kern
    out = dict(gated_part=gate, tol_rel_l2=TOL_GRAD_REL, tol_control_ratio=TOL_CONTROL_RATIO,
               parts=res)
    if gate is not None:
        g = res[gate]
        out["passed"], out["rule"] = gate_rule(g["kernel_vs_plain"], g["plain_vs_fp32"],
                                               g["kernel_vs_fp32"])
    print(f"{name} gradients, kernel path vs plain path (control: plain again, plain in fp32; "
          f"gated: {gate}):", json.dumps(out), flush=True)
    check(gate is None or out["passed"], f"{name} gradients: {out.get('rule')} fails: "
                                         f"{res.get(gate)}")
    return out


def swinir_parts(swinir) -> dict:
    """SwinIR's parameter names by part: ``all``, ``conv_first``, each RSTB
    (``layers.i``) and the rest (``tail``: norm, conv_after_body,
    upsampling)."""
    names = [n for n, _ in swinir.named_parameters()]
    parts = {"all": names, "conv_first": [n for n in names if n.startswith("conv_first.")]}
    for i in range(len(swinir.layers)):
        parts[f"layers.{i}"] = [n for n in names if n.startswith(f"layers.{i}.")]
    taken = {n for key, ns in parts.items() if key != "all" for n in ns}
    parts["tail"] = [n for n in names if n not in taken]
    return parts


def recipe_swinir(cfg, weights: dict, device):
    """The config's SwinIR (bf16 compute, fp32 weights) on the seeded
    flagship's SwinIR weights."""
    from edtr_torch.pipeline import swinir_from_config

    sw = swinir_from_config(cfg.model.swinir, dtype=torch.bfloat16, device=device)
    sw.load_state_dict({n[len("swinir."):]: v for n, v in weights.items()
                        if n.startswith("swinir.")}, strict=True)
    return sw


def image_batch(g: torch.Generator, batch: int, device) -> dict:
    """Seeded NHWC lq and gt in [0, 1] at 512²."""
    return dict(lq=torch.rand((batch, IMAGE, IMAGE, 3), generator=g, device=device),
                gt=torch.rand((batch, IMAGE, IMAGE, 3), generator=g, device=device))


def moved_tensors(module, before: dict) -> list:
    return [n for n, p in module.named_parameters() if not torch.equal(p.detach(), before[n])]


def train_swinir_pre_phase(weights: dict, device) -> dict:
    """SwinIR pre-training from ``configs/seg/voc2012/train/002_swinir-pre.yaml``
    (module docstring, phase 16)."""
    from edtr_torch.config import load_config
    from edtr_torch.train import recipes as R

    t0 = time.perf_counter()
    cfg = load_config(SWINIR_PRE_CONFIG)
    tc = cfg.train
    sw = recipe_swinir(cfg, weights, device)
    # AdamW without weight decay, as JAX's runner (main/*/train_swinir-pre.py)
    state = R.SimpleTrainState.create(sw, R.cosine_tx("adamw", float(tc.learning_rate),
                                                      int(tc.train_steps), weight_decay=0.0))
    step = R.make_swinir_pre_train_step(sw)
    g = torch.Generator(device=device).manual_seed(20)
    batch = image_batch(g, SWINIR_PRE_BATCH, device)
    lq, gt = (batch[k].permute(0, 3, 1, 2) for k in ("lq", "gt"))
    torch.cuda.synchronize()
    print(f"train swinir-pre: {SWINIR_PRE_CONFIG}, SwinIR {sum(p.numel() for p in sw.parameters())}"
          f" params, bs {SWINIR_PRE_BATCH} (the config's {tc.batch_size}), lr {tc.learning_rate};"
          f" set up in {time.perf_counter() - t0:.1f} s", flush=True)

    def grads(kernel: bool):
        with R.swinir_configuration(kernel):
            R.swinir_pre_loss(sw, lq, gt).backward()

    cmp = path_grads("swinir-pre", grads, dict(sw.named_parameters()), swinir_parts(sw), [sw],
                     "all")
    before = {n: p.detach().clone() for n, p in sw.named_parameters()}
    run = recipe_run("swinir-pre", lambda: step(state, batch), recipe_launches("swinir_pre"))
    held = hold_shapes(device, run["shapes"])
    print(f"swinir-pre: kernels held at the step's bs-{SWINIR_PRE_BATCH} shapes:",
          json.dumps(held), flush=True)
    check(set(held) == {k for k, n in run["launches"].items() if n}, f"held {sorted(held)}")
    moved = moved_tensors(sw, before)
    n_params = len(before)
    check(len(moved) == n_params, f"swinir-pre: {len(moved)} of {n_params} tensors moved")
    run.update(config=SWINIR_PRE_CONFIG, batch=SWINIR_PRE_BATCH, kernel_vs_plain=cmp,
               held=held, moved=len(moved), steps=state.step)
    return run


def train_sr4ir_phase(weights: dict, device) -> dict:
    """SR4IR from ``configs/seg/voc2012/train/004_swinir-sr4ir.yaml``
    (module docstring, phase 17)."""
    from edtr_torch.config import load_config
    from edtr_torch.train import recipes as R
    from edtr_torch.train.common import no_param_grads
    from edtr_torch.train.tasks import task_apply_for

    t0 = time.perf_counter()
    cfg = load_config(SR4IR_CONFIG)
    tc = cfg.train
    sw = recipe_swinir(cfg, weights, device)
    g = torch.Generator(device=device).manual_seed(21)
    target = task_target("seg", RECIPE_BATCH, g, device)
    batch = dict(image_batch(g, RECIPE_BATCH, device), target=target)
    lq, gt = (batch[k].permute(0, 3, 1, 2) for k in ("lq", "gt"))
    net = task_net(cfg, "seg", device, gt)[0]
    steps = int(tc.train_steps)
    sw_state = R.SimpleTrainState.create(sw, R.cosine_tx(
        "adamw", float(tc.learning_rate_swinir), steps, weight_decay=0.0))
    # JAX's runner reads learning_rate_task (default 5e-3) for the task net;
    # the configs name it learning_rate_segnet, 5e-3 in each; SGD decay 1e-6
    # for seg (main/seg/train_seg.py)
    task_state = R.SimpleTrainState.create(net, R.cosine_tx(
        "sgd", float(tc.learning_rate_segnet), steps, weight_decay=1e-6))
    loss_fn, feats_fn = task_apply_for("seg")
    pix = float(tc.pix_weight)
    step = R.make_sr4ir_train_step(sw, feats_fn, loss_fn, pix_weight=pix)
    cells = torch.bernoulli(torch.full((RECIPE_BATCH, 8, 8, 1), 0.5, device=device),
                            generator=g)
    torch.cuda.synchronize()
    print(f"train sr4ir: {SR4IR_CONFIG}, SwinIR + {type(net).__name__} (21 classes, "
          f"{sum(p.numel() for p in net.parameters())} params, calibrated on gt), bs "
          f"{RECIPE_BATCH} (the config's {tc.batch_size}; the task half on "
          f"{3 * RECIPE_BATCH} images), pix_weight {pix}; set up in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def sw_grads(kernel: bool):
        with no_param_grads(net), R.swinir_configuration(kernel):
            R.sr4ir_swinir_loss(sw, net, feats_fn, lq, gt, pix)[0].backward()

    cmp = path_grads("sr4ir SwinIR half", sw_grads, dict(sw.named_parameters()),
                     swinir_parts(sw), [sw, net], "all")
    stats0 = {n: b.clone() for n, b in net.named_buffers()}
    target3 = torch.cat([target] * 3)

    def task_grads(kernel: bool):
        with torch.no_grad(), R.swinir_configuration(kernel):
            res = sw(lq)
        loss_fn(net, R.sr4ir_task_images(res, gt, cells), target3)[0].backward()
        with torch.no_grad():
            for n, b in net.named_buffers():
                b.copy_(stats0[n])

    names = [n for n, _ in net.named_parameters()]
    task_cmp = path_grads("sr4ir task half (reported)", task_grads,
                          dict(net.named_parameters()), {"tasknet": names}, [sw, net])
    sw_before = {n: p.detach().clone() for n, p in sw.named_parameters()}
    net_before = {n: v.clone() for n, v in net.state_dict().items()}
    run = recipe_run("sr4ir", lambda: step((sw_state, task_state), batch, cells),
                     recipe_launches("sr4ir"))
    check(set(run["metrics"]) == {"swinir_pix", "swinir_tdp", "task_loss"},
          f"sr4ir metrics {sorted(run['metrics'])}")
    now = net.state_dict()
    stats = [n for n in now if n.endswith(("running_mean", "running_var"))]
    res = dict(swinir_moved=len(moved_tensors(sw, sw_before)), swinir_params=len(sw_before),
               tasknet_moved=len(moved_tensors(net, net_before)),
               tasknet_params=len(names),
               stats_moved=sum(not torch.equal(now[n], net_before[n]) for n in stats),
               stats=len(stats))
    print("train sr4ir, after the steps:", json.dumps(res), flush=True)
    check(res["swinir_moved"] == res["swinir_params"], "every SwinIR tensor moved")
    check(res["tasknet_moved"] == res["tasknet_params"], "every task-net tensor moved")
    check(stats and res["stats_moved"] == len(stats), "the running statistics moved")
    run.update(config=SR4IR_CONFIG, batch=RECIPE_BATCH, kernel_vs_plain=cmp,
               tasknet_grads_reported=task_cmp, checks=res)
    run.pop("shapes")
    return run


def train_task_swinir_phase(weights: dict, device) -> dict:
    """The task net trained on the frozen SwinIR's restorations, from
    ``configs/seg/voc2012/train/003_swinir.yaml`` (module docstring, phase
    18)."""
    from edtr_torch.config import load_config
    from edtr_torch.train import recipes as R
    from edtr_torch.train.tasks import task_apply_for

    t0 = time.perf_counter()
    cfg = load_config(TASK_SWINIR_CONFIG)
    tc = cfg.train
    sw = recipe_swinir(cfg, weights, device).requires_grad_(False)
    g = torch.Generator(device=device).manual_seed(22)
    batch = dict(image_batch(g, RECIPE_BATCH, device),
                 target=task_target("seg", RECIPE_BATCH, g, device))
    net = task_net(cfg, "seg", device, batch["gt"].permute(0, 3, 1, 2))[0]
    # the config's learning_rate is the task net's; SGD decay 1e-6 for seg
    state = R.SimpleTrainState.create(net, R.cosine_tx(
        "sgd", float(tc.learning_rate), int(tc.train_steps), weight_decay=1e-6))
    loss_fn, _ = task_apply_for("seg")
    step = R.make_task_train_step(loss_fn, pre_restore=sw)
    torch.cuda.synchronize()
    print(f"train task on the frozen SwinIR: {TASK_SWINIR_CONFIG}, {type(net).__name__}, bs "
          f"{RECIPE_BATCH} (the config's {tc.batch_size}); set up in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    sw_before = {n: v.clone() for n, v in sw.state_dict().items()}
    net_before = {n: v.clone() for n, v in net.state_dict().items()}
    # the Swin kernels and the tail's upsample launch as in a bs-2
    # restore's swinir stage, under no grad; the task net launches none
    run = recipe_run("task on the frozen SwinIR", lambda: step(state, batch),
                     recipe_launches("task_swinir"))
    check(set(run["metrics"]) == {"loss"}, f"task step metrics {sorted(run['metrics'])}")
    moved = moved_tensors(net, net_before)
    n_params = len(list(net.parameters()))
    changed = [n for n, v in sw.state_dict().items() if not torch.equal(v, sw_before[n])]
    res = dict(tasknet_moved=len(moved), tasknet_params=n_params, swinir_changed=len(changed))
    print("train task on the frozen SwinIR, after the steps:", json.dumps(res), flush=True)
    check(len(moved) == n_params, "every task-net tensor moved")
    check(not changed, f"frozen SwinIR tensors changed: {changed[:5]}")
    run.update(config=TASK_SWINIR_CONFIG, batch=RECIPE_BATCH, checks=res)
    run.pop("shapes")
    return run


def train_diffbir_phase(weights: dict, device) -> tuple:
    """DiffBIR from ``configs/seg/voc2012/train/005_diffbir.yaml`` (module
    docstring, phase 19): (the phase's results, its pipeline)."""
    from edtr_torch.train import recipes as R
    from edtr_torch.train.edtr_step import cast_frozen_bf16
    from edtr_torch.train.tasks import task_apply_for

    t0 = time.perf_counter()
    cfg, pipe = config_pipeline(DIFFBIR_CONFIG, weights, device)
    tc = cfg.train
    g = torch.Generator(device=device).manual_seed(23)
    lat = IMAGE // 8
    batch = dict(image_batch(g, RECIPE_BATCH, device), c_txt=pipe.text(RECIPE_BATCH),
                 target=task_target("seg", RECIPE_BATCH, g, device))
    lq, gt = (batch[k].permute(0, 3, 1, 2) for k in ("lq", "gt"))
    c_txt = batch["c_txt"]
    # the teacher's weights drawn apart from the student's, as in the
    # generic steps (PERF.md §6)
    student = task_net(cfg, "seg", device, gt)[0]
    teacher = task_net(cfg, "seg", device, gt, "teacher_segnet", seed=10)[0]
    teacher.requires_grad_(False)
    cast_frozen_bf16(pipe, pipe.cldm.vae.train_decoder, teacher)
    steps = int(tc.train_steps)
    cldm_state = R.diffbir_state(pipe, R.cosine_tx(
        "adamw", float(tc.learning_rate_diffbir), steps, weight_decay=1e-2))
    # JAX's runner reads learning_rate_task (default 5e-3); the configs name
    # it learning_rate_segnet, 5e-3
    task_state = R.SimpleTrainState.create(student, R.cosine_tx(
        "sgd", float(tc.learning_rate_segnet), steps, weight_decay=1e-6))
    loss_fn, feats_fn = task_apply_for("seg")
    weights_ = dict(weight_ce=float(tc.weight_ce), weight_fm=float(tc.weight_fm))
    step = R.make_diffbir_train_step(pipe, loss_fn, feats_fn, steps=DIFFBIR_STEPS, **weights_)
    bs2 = max(RECIPE_BATCH // 2, 1)
    draws = dict(t=torch.randint(0, pipe.diffusion.num_timesteps, (RECIPE_BATCH,), generator=g,
                                 device=device),
                 noise=torch.randn((RECIPE_BATCH, 4, lat, lat), generator=g, device=device),
                 posterior_noise=torch.randn((RECIPE_BATCH, 4, lat, lat), generator=g,
                                             device=device),
                 x_T=torch.randn((bs2, 4, lat, lat), generator=g, device=device),
                 step_noise=torch.randn((DIFFBIR_STEPS, bs2, 4, lat, lat), generator=g,
                                        device=device))
    params = dict(pipe.named_parameters())
    trainable = {n: p for n, p in params.items() if p.requires_grad}
    frozen = {n: p for n, p in params.items() if not p.requires_grad}
    check(trainable and all(n.startswith("cldm.controlnet.") for n in trainable),
          "DiffBIR trains the ControlNet alone")
    torch.cuda.synchronize()
    print(f"train diffbir: {DIFFBIR_CONFIG}, {len(trainable)} ControlNet tensors "
          f"({sum(p.numel() for p in trainable.values())} params) train, {weights_}, bs "
          f"{RECIPE_BATCH} (the config's {tc.batch_size}), the {DIFFBIR_STEPS}-step walk on "
          f"{bs2} image, t {draws['t'].tolist()}, cast_frozen_bf16; set up in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def shared(kernel: bool):
        with pipe_path(pipe, kernel):
            pre = pipe.pre_restore(lq)
            return pre, pipe.encode(pre)

    def eps_grads(kernel: bool):
        _, z_pre = shared(kernel)
        with pipe_path(pipe, kernel):
            loss = R.diffbir_eps_loss(pipe, z_pre, gt, c_txt, draws["t"], draws["noise"],
                                      draws["posterior_noise"])
            with pipe.configuration():
                loss.backward()

    cmp = path_grads("diffbir ControlNet (p_losses)", eps_grads, trainable,
                     {"controlnet": list(trainable)}, [pipe], "controlnet")

    def walk(kernel: bool) -> torch.Tensor:
        pre, z_pre = shared(kernel)
        with pipe_path(pipe, kernel):
            return R.diffbir_sample(pipe, DIFFBIR_STEPS, z_pre[:bs2], pre[:bs2], c_txt[:bs2],
                                    draws["x_T"], draws["step_noise"])

    img_p = walk(False)
    with computing_in(torch.float32, pipe):
        img_f = walk(False)
    img_k = walk(True)
    walk_cmp = dict(kernel_vs_plain=rel_l2(img_k, img_p), plain_vs_fp32=rel_l2(img_p, img_f),
                    kernel_vs_fp32=rel_l2(img_k, img_f), steps=DIFFBIR_STEPS)
    print(f"diffbir: the {DIFFBIR_STEPS}-step restored image from pure noise, kernel path vs "
          f"plain path and the fp32 control (reported):", json.dumps(walk_cmp), flush=True)
    check(all(math.isfinite(v) for v in walk_cmp.values()), "walk images finite")
    del img_p, img_f, img_k

    before = {n: p.detach().clone() for n, p in params.items()}
    task_before = {n: v.clone() for n, v in student.state_dict().items()}
    teacher_before = {n: v.clone() for n, v in teacher.state_dict().items()}
    run = recipe_run("diffbir", lambda: step((cldm_state, task_state, teacher), batch,
                                             **draws), recipe_launches("diffbir"))
    check(set(run["metrics"]) == {"loss_eps", "loss_ce", "loss_fm"},
          f"diffbir metrics {sorted(run['metrics'])}")
    now = student.state_dict()
    stats = [n for n in now if n.endswith(("running_mean", "running_var"))]
    res = dict(moved=sum(not torch.equal(params[n], before[n]) for n in trainable),
               trainable=len(trainable),
               frozen_changed=sum(not torch.equal(params[n], before[n]) for n in frozen),
               tasknet_moved=len(moved_tensors(student, task_before)),
               tasknet_params=len(list(student.parameters())),
               stats_moved=sum(not torch.equal(now[n], task_before[n]) for n in stats),
               stats=len(stats),
               teacher_changed=sum(not torch.equal(v, teacher_before[n])
                                   for n, v in teacher.state_dict().items()),
               steps=cldm_state.step)
    print("train diffbir, after the steps:", json.dumps(res), flush=True)
    check(res["moved"] == res["trainable"], "every ControlNet tensor moved")
    check(not res["frozen_changed"], "frozen pipeline tensors unchanged")
    check(res["tasknet_moved"] == res["tasknet_params"], "every task-net tensor moved")
    check(stats and res["stats_moved"] == len(stats), "the running statistics moved")
    check(not res["teacher_changed"], "the teacher unchanged")
    run.update(config=DIFFBIR_CONFIG, batch=RECIPE_BATCH, kernel_vs_plain=cmp,
               walk_image_reported=walk_cmp, checks=res)
    run.pop("shapes")
    return run, pipe


def sample_fn_phase(pipe, device) -> dict:
    """``make_edtr_sample_fn(pipe)`` at 512², bs 1: its run counted, its
    image against ``pipe.restore``'s on the same draws (module docstring,
    phase 20)."""
    from edtr_torch.train.edtr_step import make_edtr_sample_fn

    g = torch.Generator(device=device).manual_seed(24)
    lat = IMAGE // 8
    lq = torch.rand((1, IMAGE, IMAGE, 3), generator=g, device=device)
    noise = torch.randn((1, lat, lat, 4), generator=g, device=device)
    step_noise = torch.randn((pipe.num_timesteps, 1, lat, lat, 4), generator=g, device=device)
    sample = make_edtr_sample_fn(pipe)
    want = pipe.restore(lq, None, noise, step_noise)["restored"]
    zero_counts()
    out = {}
    ms = host_ms(lambda: out.update(restored=sample(lq, None, noise, step_noise)))
    launches, _, _ = read_counts()
    flags = (pipe.fused_conv, pipe.fused_proj, pipe.fused_swin)
    res = dict(equal=torch.equal(out["restored"], want),
               max_abs_diff=(out["restored"] - want).abs().max().item(), host_ms=ms,
               launches=launches)
    print(f"sample fn vs restore ({IMAGE}², bs 1, the same draws):", json.dumps(res), flush=True)
    check(launches == expected_launches(flags), f"sample fn launches {launches}")
    check(tuple(out["restored"].shape) == (1, IMAGE, IMAGE, 3)
          and bool(torch.isfinite(out["restored"]).all()), "sample fn image shape, finite")
    check(res["equal"], f"sample fn differs from restore by {res['max_abs_diff']}")
    return res


def train_shape_phase(device, shapes: dict, proj_shapes: dict) -> dict:
    """Every kernel of the training step held against its plain version at
    each shape the counted step launched it with (bs 2; the phases before
    hold the forward kernels at the restore's bs-1 shapes): the flash
    forward, conv and Swin kernels here, and the projection kernels at the
    shapes of the fused_proj step (``proj_shapes``); the backward kernels
    in :func:`bwd_kernel_phase`, whose shapes must be the step's. Per
    kernel: shapes held, the largest error over its largest output, and the
    launch-weighted device ms per step (kernel, plain, library, bound)."""
    bwd = {key: n for key, n in shapes["flash"].items() if key[0] in BWD_KERNELS}
    want = {(name, *shape): n for name, (shape, _, n) in BWD_KERNELS.items()}
    check(bwd == want, f"the step's backward shapes {bwd}, held at {want}")
    k5 = {key for key in shapes["conv"] if key[0] != "upsample_conv"}
    pinned = {(key[0], 2, *key[2:]) for key in proj_bench.GN_SHAPES}
    check(k5 == pinned, f"the step's K5 shapes {sorted(k5)}, pinned (proj_bench.py, B = 2) "
                        f"{sorted(pinned)}")
    gen = torch.Generator(device=device).manual_seed(17)
    held = {}
    for key, count in sorted(shapes["flash"].items()):
        if key[0] in KERNELS:
            r = flash_case(device, key[0], key[1:], gen)
            agg = held.setdefault(key[0], dict(shapes=0, max_err_share=0.0, ms=0.0,
                                               plain_ms=0.0, library_ms=0.0, bound_ms=0.0))
            agg["shapes"] += 1
            agg["max_err_share"] = max(agg["max_err_share"], r["err_o"] / r["o_max"])
            for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
                agg[k] += count * r[k]
    for key, count in sorted(proj_shapes.items(), key=str):
        r = proj_case(device, key, gen)
        agg = held.setdefault(key[0], dict(shapes=0, max_err_share=0.0, ms=0.0, plain_ms=0.0,
                                           library_ms=0.0, bound_ms=0.0))
        agg["shapes"] += 1
        agg["max_err_share"] = max(agg["max_err_share"], r["max_abs_err"] / r["out_max"])
        for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
            agg[k] += count * r[k]
    for rows in (conv_kernel_phase(device, shapes["conv"], "training step"),
                 swin_kernel_phase(device, shapes["swin"], "training step")):
        for name, r in rows.items():
            held[name] = {k: r[k] for k in ("shapes", "max_err_share", "ms", "plain_ms",
                                            "library_ms", "bound_ms")}
    print("train shapes held (bs 2, per step):", json.dumps(held), flush=True)
    launched = {name for name, n in TRAIN_LAUNCHES_PROJ.items()
                if n and name not in BWD_KERNELS}
    check(set(held) == launched, f"train-shape holds {sorted(held)}, launched {sorted(launched)}")
    return held


PHASE_S: dict = {}


def phase_end(name: str, t0: float) -> float:
    """Records and prints the seconds since ``t0`` under ``name`` (the
    output's ``phase_s``); returns the time now."""
    now = time.perf_counter()
    PHASE_S[name] = now - t0
    print(f"phase {name}: {PHASE_S[name]:.1f} s", flush=True)
    return now


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    # the plain versions are compared in fp32 where they compute in fp32:
    # TF32 (cuDNN's default for convolutions) would add ~1e-3 relative error
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = card_line()
    print(card, flush=True)  # as nvidia-smi prints it: name, power limit
    print("torch", torch.__version__, "cuda", torch.version.cuda, flush=True)

    t = time.perf_counter()
    build()
    t = phase_end("build", t)
    rows = kernel_phase(device)
    bwd_rows = bwd_kernel_phase(device)
    t = phase_end("flash kernels", t)
    pipe, counted, timing = restore_phase(device)
    t = phase_end("restore", t)
    k5 = {k: n for k, n in counted["fused"]["shapes"]["conv"].items() if k[0] != "upsample_conv"}
    check(k5 == proj_bench.GN_SHAPES, f"the restore's K5 shapes {k5}, pinned "
                                      f"{proj_bench.GN_SHAPES} (proj_bench.py)")
    conv_rows = conv_kernel_phase(device, counted["fused"]["shapes"]["conv"])
    proj_rows = proj_kernel_phase(device, counted["fused+proj"]["shapes"]["proj"])
    pre = {k: n for k, n in counted["fused+swin"]["shapes"]["swin"].items() if k[0] == "swin_pre"}
    check(pre == proj_bench.SWIN_SHAPES, f"the restore's swin_pre shapes {pre}, pinned "
                                         f"{proj_bench.SWIN_SHAPES} (proj_bench.py)")
    swin_rows = swin_kernel_phase(device, counted["fused+swin"]["shapes"]["swin"])
    t = phase_end("conv, proj, swin kernels", t)
    norms = norm_phase(pipe, device)
    text = text_phase(pipe, device)
    cldm = cldm_phase(pipe, device)
    t = phase_end("norms, text, cldm", t)
    detect, counted["restore+detect"] = detect_phase(pipe, device)
    t = phase_end("restore+detect", t)
    weights = host_weights(pipe)
    del pipe  # the config-built pipelines and the training one take its place
    gc.collect()
    torch.cuda.empty_cache()
    tasks = {}
    for task, path, what in (("seg", SEG_TEST_CONFIG, "restore+segment"),
                             ("cls", CLS_TEST_CONFIG, "restore+classify")):
        tasks[what], counted[what] = restore_task_phase(task, path, weights, device)
        gc.collect()
        torch.cuda.empty_cache()
        t = phase_end(what, t)
    data = {"eval": data_eval_phase(weights, device)}
    counted["data eval"] = dict(launches=data["eval"]["launches"],
                                copies=data["eval"].pop("layout_copies"),
                                shapes=data["eval"].pop("shapes"))
    gc.collect()
    torch.cuda.empty_cache()
    t = phase_end("data eval", t)
    demo = demo_phases(weights, device, counted)
    t = phase_end("demo", t)
    train = train_phase(device)
    t = phase_end("train step", t)
    gc.collect()
    torch.cuda.empty_cache()
    train_pipe = train.pop("pipe")
    train_det = train_det_phase(train_pipe, device)
    t = phase_end("train step detnet", t)
    del train_pipe
    gc.collect()
    torch.cuda.empty_cache()
    # the generic steps start from the seeded weights, as the
    # restoration-only step does: after the earlier steps' AdamW updates,
    # bf16 alone moves the gradients they compare past the gate (the fp32
    # control, PERF.md §6)
    weights = train.pop("seeded_weights")
    for task, path in (("seg", SEG_TRAIN_CONFIG), ("cls", CLS_TRAIN_CONFIG)):
        tasks[f"train_{task}"] = train_task_phase(task, path, weights, device)
        gc.collect()
        torch.cuda.empty_cache()
        t = phase_end(f"train step {task}", t)
    train_det_v2 = train_det_v2_phase(weights, device)
    gc.collect()
    torch.cuda.empty_cache()
    t = phase_end("train step detnet v2", t)
    # the recipes, on the same seeded weights
    recipes = {}
    for name, phase in (("swinir_pre", train_swinir_pre_phase), ("sr4ir", train_sr4ir_phase),
                        ("task_swinir", train_task_swinir_phase)):
        recipes[name] = phase(weights, device)
        gc.collect()
        torch.cuda.empty_cache()
        t = phase_end(f"recipe {name}", t)
    data["train"] = data_train_phase(weights, device)
    gc.collect()
    torch.cuda.empty_cache()
    t = phase_end("data train", t)
    runner = runner_phase(device)
    gc.collect()
    torch.cuda.empty_cache()
    t = phase_end("runner", t)
    recipes["diffbir"], diffbir_pipe = train_diffbir_phase(weights, device)
    t = phase_end("recipe diffbir", t)
    recipes["sample_fn"] = sample_fn_phase(diffbir_pipe, device)
    swinir_pre_shapes = recipes["swinir_pre"].pop("shapes")
    del diffbir_pipe
    gc.collect()
    torch.cuda.empty_cache()
    train["held_at_step_shapes"] = train_shape_phase(device, train.pop("shapes"),
                                                     train.pop("shapes_fused_proj"))
    t = phase_end("sample fn, step shapes", t)

    all_rows = {**rows, **bwd_rows, **conv_rows, **proj_rows, **swin_rows}
    for name, row in all_rows.items():  # from the path that runs it most
        row["launches"] = max([c["launches"][name] for c in counted.values()]
                              + [train["launches"][name], train_det["launches"][name]])
        row["launches_train_step"] = train["launches"][name]
        row["launches_train_step_detnet"] = train_det["launches"][name]
        row["launches_train_step_fused_proj"] = train["launches_fused_proj"][name]
        row["launches_restore_classify_bs8"] = counted["restore+classify"]["launches"][name]
        for task in ("seg", "cls"):
            row[f"launches_train_step_{task}"] = tasks[f"train_{task}"]["launches"][name]
        for recipe in ("swinir_pre", "sr4ir", "task_swinir", "diffbir"):
            row[f"launches_recipe_{recipe}"] = recipes[recipe]["launches"][name]
        row["launches_demo"] = counted["demo"]["launches"][name]
        row["launches_demo_tiled"] = counted["demo tiled"]["launches"][name]
        row["launches_train_step_detnet_v2"] = train_det_v2["launches"][name]
        row["launches_data_train"] = data["train"]["launches"][name]
        row["launches_data_eval"] = data["eval"]["launches"][name]
        for run in ("train", "resume", "test", "seg_swinir"):
            row[f"launches_runner_{run}"] = runner[run]["launches"][name]
        row["launches"] = max([row["launches"], train_det_v2["launches"][name],
                               data["train"]["launches"][name]]
                              + [runner[r]["launches"][name] for r in runner if r != "data_s"]
                              + [recipes[r]["launches"][name] for r in
                                 ("swinir_pre", "sr4ir", "task_swinir", "diffbir")])
        row["on_path"] = row["launches"] > 0  # K4: the demo's path
    check(set(conv_rows) == set(CONV_KERNELS), f"conv kernels timed: {sorted(conv_rows)}")
    check(set(proj_rows) == set(PROJ_KERNELS), f"proj kernels timed: {sorted(proj_rows)}")
    check(set(swin_rows) == set(SWIN_KERNELS), f"swin kernels timed: {sorted(swin_rows)}")
    check(set(bwd_rows) == set(BWD_KERNELS), f"backward kernels timed: {sorted(bwd_rows)}")
    check(len(all_rows) == 17, f"kernels line: {sorted(all_rows)}")
    train_det.pop("shapes")
    print(json.dumps({"card": card, "restore": timing, "text": text, "detect": detect,
                      "cldm_eps": cldm, "gn_stats": norms,
                      "train": train, "train_detnet": train_det, "task_nets": tasks,
                      "demo": demo, "train_detnet_v2": train_det_v2,
                      "data": {k: {kk: vv for kk, vv in v.items() if kk != "held"}
                               for k, v in data.items()},
                      "runner": {k: {kk: vv for kk, vv in v.items() if kk != "launches"}
                                 if isinstance(v, dict) else v for k, v in runner.items()},
                      "recipes": {k: {kk: vv for kk, vv in v.items() if kk != "trace"}
                                  for k, v in recipes.items()},
                      "swinir_pre_shapes": [dict(key=list(k), launches=n) for k, n in
                                            sorted(swinir_pre_shapes["swin"].items(), key=str)],
                      "device_ms_traces": TRACE_STATS, "phase_s": PHASE_S,
                      "launches": {cfg: c["launches"] for cfg, c in counted.items()},
                      "layout_copies": {cfg: c["copies"] for cfg, c in counted.items()},
                      "conv_shapes": [dict(key=list(k), launches=n) for k, n in
                                      sorted(counted["fused"]["shapes"]["conv"].items(),
                                             key=str)],
                      "proj_shapes": [dict(key=list(k), launches=n) for k, n in
                                      sorted(counted["fused+proj"]["shapes"]["proj"].items(),
                                             key=str)],
                      "swin_shapes": [dict(key=list(k), launches=n) for k, n in
                                      sorted(counted["fused+swin"]["shapes"]["swin"].items(),
                                             key=str)]}),
          flush=True)
    print(json.dumps({"kernels": list(all_rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
