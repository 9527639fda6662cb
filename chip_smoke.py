#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (erd_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failed check exits non-zero before the last line:
  1. card       the nvidia-smi name and power-limit line, and torch's default
                float32 precision settings, which the script leaves as they
                are;
  2. build      nvcc builds every kernel of erd_tpu_torch/csrc/, in parallel;
     tf32       in those defaults, the port's float32 conv_offset on a GFL
                R101-DCN layer3 input (256 x 50 x 84) card vs CPU within
                1e-5 * max|out|; the same conv forced into TF32 must miss it;
  3. kernels    each serving kernel against its plain PyTorch version on the
                card at serving shapes (NMS keep masks exactly equal; the
                decode within 1e-4 * stride + 1e-5 * |box| px on the flat
                float32 form and on five level maps: float32 and bf16 NHWC
                views of NCHW maps, bf16 channels-last), then timed;
  4. reference  the full-width float32 network on the card against the same
                network on the CPU, on a small input;
  5. serve      4 requests through init_detector / inference_detector of the
                ERD stage-2 GFL-R50 detector (80 classes, bf16, seeded
                random weights, gfl_cls bias 0) on both canvases; every
                kernel of the path must have launched; the same head outputs
                post-processed on the CPU must give the same detections;
                the decode must get the head's five distribution maps
                themselves (no cast or concatenation before it), and the
                800x1333 request's call is held to plain and graph-timed;
  6. train kernels  the training kernels against their plain versions at
                B = 2 and at the train step's B = 16, N = 22400 (ATSS and
                the ERS lists exactly, ERS masks exactly away from the
                threshold, the fused losses within stated tolerances,
                forward and backward; the decode without clip and the NMS on
                the ERS teacher rows at K = 1024 and 4481), then timed at
                B = 16 (the decode's two calls by graph replays);
  7. train reference  the full-width float32 ERD loss dict and student
                gradients on the card (kernels) and on the CPU (plain
                versions), on a small input; the same gradients in float64
                on the card (with the loss's kernels, and with their plain
                versions), against which the worst tensors of each float32
                side are logged (no gate); then two controls, a 1 % error
                planted in the GFL or the distillation kernel's backward,
                each of which must fail the same limits;
  8. train      build_trainer + fit of the ERD stage-2 GFL-R50 step (bf16,
                fp32 master weights) at batch 16, 800x1344: 2 warm-up and 5
                timed steps; every kernel of the path must have launched,
                losses finite, frozen stages and the teacher unchanged;
                stage times and the device idle share of one step;
  9. frcnn kernels  one 800x1333 request of Faster R-CNN R50-FPN (80
                classes, bf16) with its kernel calls captured: RoIAlign on
                the 1000 real proposals plus edge-case boxes, full-width
                P2-P5 (within 1e-6 * max|feat|, levels equal on card and
                CPU); soft-NMS at K = 2000, 100 steps (linear bit-exact,
                gaussian within 1e-6 relative; timed by graph replays,
                and by the profiler under SOFT_NMS_KERNELS, which must
                match; beside its latency floor: the steps emptied, from
                an edited copy of csrc/soft_nms.cu built at the start);
                the NMS on the RPN call
                (K = 4819, IoU 0.7) and the R-CNN call (K = 2000, IoU 0.5),
                masks exactly; then each timed;
 10. frcnn serve  for the hard-NMS and the soft-NMS config: init_detector /
                inference_detector on the same 4 requests (seeded fc_cls
                weights so that at least 2000 candidates reach the final
                NMS), every kernel of the path launched, stage times, the
                idle share of one request; the float32 network card vs CPU
                and the same head outputs post-processed on card and CPU;
 11. detr kernels  one 800x1333 request each of DINO-4scale R50 and
                Deformable DETR R50 (80 classes, bf16, sampling weights
                arranged by arrange_sampling) with their 12 multi-scale
                deformable-attention calls captured (6 encoder calls at Q =
                22323 tokens; 6 decoder calls at Q = 900, or at Q = 300 with
                decoder_0's bf16 attention weights): the kernel bit-equal
                to its plain version on each; at least 50 % of the
                samples with a fractional bilinear weight and 1 % with a
                corner outside its map; then timed by CUDA-graph
                replays at the three call shapes, each bound from the
                distinct value rows its corners touch;
 12. detr reference  both float32 DETR networks card vs CPU on a small
                input: the encoder memory, then the decoder from the card's
                query selection, within 1e-3 * max|out|;
 13. detr serve  DINO-4scale R50 (900 queries, 300 detections) and
                Deformable DETR R50 (300 queries, 100 detections):
                init_detector / inference_detector on the same 4 requests,
                12 kernel launches per request, every detection finite and
                inside its image, stage times, the idle share of one
                request, card-vs-CPU post-processing;
 14. dcn kernels  one 800x1333 request each of GFL R101-DCN (DCNv1 in
                C3-C5, 30 deformable im2col calls) and VFNet R50-mdconv (13
                DCNv2 calls in the backbone, 10 star-DCN calls in the head),
                80 classes, bf16, conv_offset arranged by arrange_offsets:
                the kernel within 1e-6 * max|x| of its plain version on
                every call; at least 50 % of the samples of each part with a
                fractional bilinear weight, 1 % with a corner outside its
                map, the DCNv2 masks not all equal; then each distinct call
                shape timed, with the float32 GEMM that follows it, the
                float32 conv_offset convolution that precedes it, and
                F.grid_sample computing the same columns (library_ms,
                within 1e-3 * max|x| of the kernel's);
 15. dcn reference  both float32 networks card vs CPU on a small input,
                within 1e-3 * max|out|;
 16. dcn serve  init_detector / inference_detector of both configs on the
                same 4 requests: 30 / 23 im2col launches per request, plus
                the NMS (and GFL's decode) kernels; every detection finite
                and inside its image; stage times (backbone, neck, head,
                post-processing), peak memory, the idle share of one
                request; card-vs-CPU post-processing; GFL R101-DCN's
                800x1333 decode call as in 5;
 17. carafe kernels  one 800x1333 request of FPN-CARAFE Faster R-CNN R50 (80
                classes, bf16, content encoders arranged by arrange_carafe)
                with its 3 CARAFE calls captured (25x42, 50x84 and 100x168,
                256 channels): the mean largest tap weight >= 0.2 and the
                four sub-pixel kernels of a source pixel different; the
                kernel within one bf16 ulp of its plain version, and within
                1e-5 * max|x| on the float32 map; each call shape timed;
 18. set-NMS kernels  the set-NMS call of one CrowdDet R50 request (1 class,
                K = 2000, all valid): the keep mask exactly the plain
                version's and not the row-1 NMS's on the same boxes; timed;
 19. soft-NMS large K  K = 12000 candidates, above one block's shared memory
                (a cluster of 4 blocks an image), 100 steps: linear
                bit-exact, gaussian within 1e-6 relative; timed;
 20. carafe/crowddet reference  both float32 networks card vs CPU on a small
                input, within 1e-3 * max|out|;
 21. carafe serve, crowddet serve  init_detector / inference_detector on the
                same 4 requests: per request 3 CARAFE, 2 NMS and 1 RoIAlign
                launches (FPN-CARAFE, fc_cls seeded), or 1 NMS, 1 set-NMS and
                1 RoIAlign (CrowdDet); every detection finite and inside its
                image, 2000 candidates into the final NMS, stage times (the
                neck apart), peak memory, the idle share of one request,
                card-vs-CPU post-processing;
 22. frcnn train kernels  one bs-16, 800x1344 bf16 training step each of
                Faster R-CNN R50 and FPN-CARAFE Faster R-CNN with their
                kernel calls captured: the RoIAlign forward kernel on the
                step's box call (the last 15 slots of each image edge
                cases), bit-equal to plain, timed by graph replays beside
                its bound over the batch (the row's train_shapes); the
                RoIAlign backward kernel on the
                step's output gradient (512 RoIs an image, full-width
                P2-P5, the last 15 slots of each image edge cases; RoIs on
                all four levels, >= 1 % of the samples off their map),
                float32 gradients within 1e-5 * max|plain| (atomics
                reorder the sums), rounded to bf16 within one bf16 ulp,
                timed (the kernel a launch; the call: memset, kernel,
                rounding pass); the NMS
                on the RPN call at K = 8819 exactly; the CARAFE forward
                kernel on the 3 calls of the FPN-CARAFE step, within one
                bf16 ulp of plain and differing from it in no element (the
                parent design's count there), timed by graph replays (the
                carafe row's train_shapes); the CARAFE
                backward kernel on the 3 calls of the FPN-CARAFE step (dx
                and dlogits; float32 within 1e-5 * max|plain|, bf16 within
                one ulp), its dlogits and dx launches apart; each timed
                beside its bound (RoIAlign's bytes count the gradients it
                writes in the maps' dtype, CARAFE's dw products count at
                the bf16 tensor-core rate);
 23. frcnn train reference  for Faster R-CNN, FPN-CARAFE and CrowdDet,
                full width in float32 on a small input, with the same
                sampler draws and the CPU's proposals: the card's own
                proposals equal the CPU's but for adjacent swaps of boxes
                whose scores are within 1e-4, in at most 0.5 % of the
                slots; the loss dict and the parameter gradients on the
                card (kernels) against the CPU (plain versions): losses
                rtol 1e-3, ||diff|| / ||g|| <= 1e-3 over all tensors and
                over each of (RPN loss, R-CNN loss) x (backbone + neck,
                heads), 1e-2 per tensor; then a 1 % error planted in the
                RoIAlign backward and one in the CARAFE backward, on
                FPN-CARAFE, must each fail those limits;
 24. frcnn train  build_trainer + fit of each of the three configs at
                batch 16, 800x1344, bf16: 2 warm-up and 5 timed steps, per
                step 1 RoIAlign, 1 RoIAlign backward and 1 NMS launch (and
                3 CARAFE and 3 CARAFE backward for FPN-CARAFE), finite
                losses, frozen stages unchanged and every trainable weight
                moved; img/s, peak memory, the stage times of one
                train_step (a synchronize after each stage) and the idle
                share of one profiled step;
 25. detr train kernels  one bs-16, 800x1344 bf16 training step each of
                DINO-4scale R50 and Deformable DETR R50 (sampling weights
                arranged) with the 12 calls of the sampling backward kernel
                captured: each held against its plain version (values,
                locations and weights within 1e-5 * max|plain|; atomics
                reorder the value sums), >= 50 % of the samples fractional
                and >= 1 % off their map; the encoder call and both decoder
                call shapes timed by CUDA events less the value gradient's
                zeroing, beside their byte bounds; the step's 12 sampling
                forward calls captured too, each bit-equal to its plain
                version (and within 1e-6 * max|value|), each call shape
                (Q, the weights' dtype) timed by CUDA-graph replays beside
                its plain version and bound, and summed over the step by
                call time (row 9's shapes and per_step_ms);
 26. detr train reference  both DETR configs in float32 at full width on a
                small input, card (kernels) vs CPU (plain), the card taking
                the CPU's Hungarian matches and denoising draws (how many
                of its own matches differ is logged): losses rtol 1e-3,
                ||diff|| / ||g|| <= 1e-3 overall and over backbone + neck,
                transformer and heads, 3e-3 over the sampling offsets, 1e-2
                per tensor; a 1 % error planted in the backward kernel's
                value gradient, and one in its location gradient, must each
                fail those limits;
 27. detr train  build_trainer + fit of both DETR configs at batch 16,
                800x1344, bf16: 2 warm-up and 5 timed steps, exactly 12
                sampling and 12 sampling-backward launches per step, finite
                losses, frozen stages unchanged, every trainable weight
                moved; img/s, peak memory, the stage times of one
                train_step (the host's Hungarian matching apart) and the
                idle share of one profiled step;
 28. dcn train kernels  one bs-16, 800x1344 bf16 training step each of
                GFL R101-DCN and VFNet R50-mdconv (conv_offset arranged by
                arrange_offsets, seed 13) with the 30 / 23 calls of the
                deformable im2col backward kernel captured: each held
                against its plain version (map, offset and mask gradients
                within 1e-5 * max|plain|, atomics reorder the map sums; the
                map gradient rounded to the bf16 map within one bf16 ulp
                where it differs by more than that),
                >= 50 % of the samples of each part fractional and >= 1 %
                off their map; each distinct call shape timed by CUDA
                events less the map gradient's zeroing, beside its byte
                bound and the autograd backward of F.grid_sample (with the
                mask's product for DCNv2), whose gradients are held against
                the plain ones first (1e-3 * max|plain|; the offsets' away
                from integer positions); the forward kernel (row 8) at
                each call shape by graph replays beside its byte bound and
                F.grid_sample on the same columns (row 8's train_shapes);
 29. dcn train reference  both DCN configs in float32 at full width on a
                small input, card (kernels) vs CPU (plain): losses rtol
                1e-3, ||diff|| / ||g|| <= 1e-3 overall and over the DCN
                blocks' conv_offset, the rest of backbone + neck, the head
                and (VFNet) the offsets of the head's star convs, 1e-2 per
                tensor; a 1 % error planted in the backward kernel's map
                gradient, and one in its offset gradient, on every call
                and (VFNet) on the head's calls alone, must each fail those
                limits;
 30. dcn train  build_trainer + fit of both DCN configs at batch 16,
                800x1344, bf16: 2 warm-up and 5 timed steps, per step
                exactly 30 / 23 im2col and 30 / 23 im2col-backward
                launches, one ATSS launch and (GFL) the fused loss's two,
                finite losses, the stem and layer1 unchanged, every
                trainable weight moved (each conv_offset included); img/s,
                peak memory, the stage times of one train_step and the idle
                share of one profiled step;
 31. mask kernels  one 800x1333 request each of Mask R-CNN R50 and
                PointRend R50 (80 classes, bf16, fc_cls seeded so that the
                100 detection slots are real) with their kernel calls
                captured: RoIAlign at out 14 on the 100 detections (the
                last 10 edge cases) within 1e-6 * max|feat| of its plain
                version; every point_sample call (2 coarse calls on the
                (100, 80, 14, 14) float32 logits, 2 fine calls on the bf16
                P2 map at 19600 points) equal to plain (torch.equal),
                >= 50 % of the samples with a fractional weight and >= 1 %
                with a corner off the map over the request; each call
                shape timed beside its byte bound and F.grid_sample on the
                widened map (held to plain within 1e-5 * max|map| first);
 32. corner kernels  one 768x1024 request of CornerNet HG-104 (80 classes,
                float32, heads arranged by arrange_corner_heads) with its 4
                corner_pool calls (the last stack's) captured, each
                bit-equal to its plain version in float32 and bf16, and
                with NaNs planted equal NaN for NaN (fault 3.11), each
                direction timed on the request's channels-last map (read
                where it lies) beside its byte bound and torch.cummax on
                that map, the NCHW kernel on the map made NCHW equal to
                plain and timed too; its
                soft-NMS call at K = 10000 (a cluster of 4 blocks),
                gaussian within 1e-6 relative, timed;
 33. mask/cornernet reference  Mask R-CNN's and PointRend's float32
                networks (RPN outputs, the bbox head, the mask heads on
                seeded RoI and point features) and CornerNet HG-104's
                outputs of both stacks on a 128x256 input, card vs CPU,
                within 1e-3 * max|out|;
 34. mask serve, pointrend serve  init_detector / inference_detector on
                the 4 requests: per request 2 NMS and 2 RoIAlign launches
                (+ 4 point_sample for PointRend); every detection finite and
                inside its image, stage times (PointRend's coarse head and
                its two subdivision steps apart), peak memory, the idle
                share of one request, card-vs-CPU post-processing; the mask
                branch on the CPU from the card's features and detections:
                masks within 1e-3, PointRend's refined cells equal but at
                near-ties (the first step's within 1e-5 * max|logit| of the
                k-th uncertainty, at most 1 % of the selections a step) and
                its masks within 1e-3 but at the cells those move;
 35. cornernet serve  init_detector / inference_detector of CornerNet
                HG-104 at scale=(1024, 768) on the 4 requests: per request
                4 corner_pool launches and 1 soft-NMS (K = 10000); every
                detection finite, not inverted and inside the canvas grown
                by the corner offsets' reach (erd_tpu does not clip), stage
                times, peak memory, the idle share of one request,
                card-vs-CPU decode and soft-NMS of the same outputs;
 36. mask/corner train kernels  the slice's training kernels on the real
                calls of one step: the mask targets of a bs-16, 800x1344
                bf16 Mask R-CNN step (28x28, 512 RoIs an image, 56x56
                synthetic gt crops) and of a PointRend step (14x14), equal
                to the plain version (torch.equal); the point-sample
                forward on the PointRend step's four calls (uncertainty,
                coarse, fine, targets), each equal to plain and timed as
                the serving calls are (the point_sample row's shapes); the
                point-sample backward on the PointRend step's two calls
                (the coarse float32 logits, the
                bf16 channels-last P2; float32 sums within 1e-5 *
                max|plain|, the bf16 map's gradient within one ulp; two
                calls equal; its launches apart by the profiler); the
                corner-pool backward on the 8 calls of a CornerNet HG-104
                step (bs 6, 768x1024, float32), bit-equal to the plain
                version (erd_tpu's scan-tree split of ties), and with NaNs
                planted the forward and backward kernels equal to plain
                (fault 3.11); the corner_pool forward timed on that step's
                x of each direction (joins the corner_pool row); the corner
                targets of that step (heat within 1e-6, the exact-1 peaks,
                offsets, weights and corner pixels equal); each timed by
                CUDA-graph
                replays beside its byte bound, its plain version and the
                library call where one computes the function
                (F.grid_sample with border padding for the targets,
                F.grid_sample's backward for the point-sample backward);
                the RoIAlign forward and backward on both calls of the
                Mask R-CNN and PointRend steps (out 7 on 512 RoIs an image,
                and the mask branch's out 14, whose gradient is zero on the
                negative RoIs): the forward with the 15 edge RoIs planted,
                bit-equal to plain (row 7's train_shapes); the backward
                float32 within 1e-5 * max|plain|, bf16 within one ulp; each
                call timed (row 7b's shapes and per_step_ms);
 37. mask/corner train reference  Mask R-CNN and PointRend R50 (2 images
                128x192, gt crops, 64 sampled RoIs an image) and CornerNet
                at HG-104's width and 5 levels, one stack of one block a
                level (2 images 256x256), in float32, card
                (kernels) vs CPU (plain), on the CPU's proposals and
                PointRend importance picks (those of the card that differ
                must be near-ties, at most 0.1 % of them): losses rtol
                1e-3, ||diff|| / ||g|| <= 1e-3 overall and over each loss
                part's backbone (+ neck) and heads gradients, 1e-2 per
                tensor; but 3e-3 for the mask losses over backbone + neck,
                where the card's float32 is 1.9e-3 off a float64 CPU run
                (logged; ROADMAP.md 3.10, whose bisect is
                erd_tpu_torch/tools/bisect_fp32_conv.py; CornerNet's pools
                and heads parts against float64 are logged too), and for
                CornerNet: its backbone
                parts at 3x the CPU's own float32 error against float64 on
                the step (train-mode BN magnifies float32 noise), its
                heads parts at 3e-3, the convs before its pools at 7e-3,
                its whole-gradient and per-tensor limits over the pools and
                heads; CornerNet's BN running statistics after the step
                within 1e-3 of each tensor's largest value; a 1 % error
                planted in the point-sample backward (PointRend) and in the
                corner-pool backward (CornerNet) must each fail those
                limits;
 38. mask_rcnn train, pointrend train, cornernet train  build_trainer + fit
                of Mask R-CNN and PointRend R50 (bs 16, 800x1344, bf16,
                gt crops) and CornerNet HG-104 (bs 6, 768x1024, float32,
                Adam): 2 warm-up and 5 timed steps, exact launches of every
                kernel of the path a step (2 RoIAlign, 2 RoIAlign backward,
                1 NMS, 1 mask target (+ 4 point_sample, 2 point-sample
                backward) / 8 corner_pool, 8 corner-pool backward, 1 corner
                target), finite losses, frozen stages unchanged (ResNet's
                stem and layer1; the hourglass's stem_conv, as erd_tpu's
                frozen_stages prefix has it), every trainable weight and
                every CornerNet BN running statistic moved; img/s, peak
                memory, the stage times of one train_step and the idle
                share of one profiled step;
 39. solo kernels  rows 12b-d and 13b: the fused mask-IoU decay on the
                real call of one 800x1333 SOLOv2 R50 request (bf16, heads
                arranged by arrange_solo_heads: ~300 of 3872 cells over
                score_thr, the other nms_pre slots scored 0; the (1, 500,
                500) mask overlaps and areas) within 1e-6 relative of its
                plain version, zeros equal; the two-launch decay on that
                call's mask IoU, and its box form at K = 2000 (80
                classes, tied scores and IoUs), gaussian and linear; fast
                NMS and nms_match at IoU 0.5, K = 2000 over 80 classes
                and K = 10000, fast NMS also at K = 2000 of one class
                (nms_match reads no labels), equal to plain, fast NMS one
                launch from its unsorted inputs, nms_match row 1's
                launches + 1 (graph nodes and counters); the masked
                conv (3x3, 256 -> 256, float32, 100 x 168, 5 / 25 / 49.4
                / 50 / 99.4 / 100 % of positions: each side of two tile
                choices) with its masked-out positions exactly 0, the rest
                within 1e-5 * max|plain| and bit-repeatable, the tile
                masked_conv_tile picks recorded; each timed by CUDA-graph
                replays beside its bound, its plain version and, for the
                masked conv, the call and the dense cuDNN IEEE conv times
                the mask;
 40. solo reference  SOLOv2 R50 in float32, heads arranged, one 800x1333
                request: the network card vs CPU within 1e-3 * max|out|,
                then the card's decode (kernels) against the CPU's (plain):
                detections matched by label and box, at most 2 % unmatched
                (near-tie flips), matched scores within 1e-3 relative,
                their binarised crops at IoU >= 0.99, flips logged; a 1 %
                error planted in the matrix decay must fail that gate;
 41. solo serve  init_detector / inference_detector of SOLOv2 R50 (bf16,
                heads arranged) on the 4 requests: one mask_matrix_decay
                launch per request, detections finite and inside
                the canvas in their image's frame, stage times (backbone +
                neck, heads, dynamic conv, decode), peak memory, the idle
                share of one request, each request's card decode against
                the CPU's (the gate of 40);
 42. the {"kernels": [...]} line, then the {"ok": true, ...} line.

The script sets no global precision flag: the port convolves float32 in
full float32 itself (erd_tpu_torch.utils.conv_fp32_precision), torch's
float32 matmuls default to full float32, and the served and trained models
compute in bf16 (CornerNet in float32, as erd_tpu runs and trains it).
The script imports neither JAX nor erd_tpu.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
ERD_CONFIG = os.path.join(
    ROOT, 'configs', 'gfl_increment',
    'gfl_r50_fpn_1x_coco_first_40_incre_last_40_cats.py')
FRCNN_CONFIGS = {
    'nms': os.path.join(ROOT, 'configs', 'faster_rcnn',
                        'faster_rcnn_r50_fpn_1x_coco.py'),
    'soft_nms': os.path.join(ROOT, 'configs', 'faster_rcnn',
                             'faster_rcnn_r50_fpn_soft_nms_1x_coco.py')}
DETR_CONFIGS = {
    'dino': os.path.join(ROOT, 'configs', 'dino',
                         'dino-4scale_r50_12e_coco.py'),
    'deformable_detr': os.path.join(ROOT, 'configs', 'deformable_detr',
                                    'deformable_detr_r50_50e_coco.py')}
# seed of the DETR cells' sampling weights (arrange_sampling): erd_tpu's
# zero init would leave every sample on a cell centre
DETR_ARRANGE_SEED = 11
DCN_CONFIGS = {
    'gfl_r101_dcn': os.path.join(ROOT, 'configs', 'gfl',
                                 'gfl_r101_dconv_c3-c5_fpn_ms2x_coco.py'),
    'vfnet_r50_mdconv': os.path.join(
        ROOT, 'configs', 'vfnet', 'vfnet_r50_mdconv_c3_c5_fpn_ms2x_coco.py')}
# deformable im2col calls of one request: R101's 4 + 23 + 3 DCNv1 blocks;
# R50's 4 + 6 + 3 DCNv2 blocks and VFNet's 2 star convs on each of 5 levels
DCN_CALLS = {'gfl_r101_dcn': 30, 'vfnet_r50_mdconv': 23}
# seed of the DCN cells' conv_offset weights (arrange_offsets): erd_tpu's
# zero init would sample integer pixels only, with mask 0.5
DCN_ARRANGE_SEED = 13
CARAFE_CONFIGS = {
    'carafe': os.path.join(ROOT, 'configs', 'carafe',
                           'faster_rcnn_r50_fpn_carafe_1x_coco.py'),
    'crowddet': os.path.join(ROOT, 'configs', 'crowddet',
                             'crowddet-rcnn_r50_fpn_8xb2-30e_crowdhuman.py')}
# seed of the FPN_CARAFE cell's content encoders (arrange_carafe): erd_tpu's
# N(0, 0.001) init weights every tap ~1/25
CARAFE_ARRANGE_SEED = 17
MASK_CONFIGS = {
    'mask_rcnn': os.path.join(ROOT, 'configs', 'mask_rcnn',
                              'mask_rcnn_r50_fpn_1x_coco.py'),
    'point_rend': os.path.join(ROOT, 'configs', 'point_rend',
                               'point-rend_r50-caffe_fpn_ms-1x_coco.py')}
CORNERNET_CONFIG = os.path.join(
    ROOT, 'configs', 'cornernet',
    'cornernet_hourglass104_8xb6-210e-mstest_coco.py')
# HG-104 needs canvas sides that are multiples of 128: 768x1024 / 1024x768
CORNERNET_SCALE = (1024, 768)
# the CornerNet cell's arranged heads (arrange_corner_heads): one seeded
# class with heatmap logits mostly in [-0.5, 0.5], the other classes at -4;
# embeddings mostly in [-0.3, 0.3]
CORNER_ARRANGE_SEED, CORNER_CLASSES, CORNER_HEAT_SPAN = 19, 1, 1.0
CORNER_HEAT_LOW, CORNER_HEAT_REST, CORNER_EMB_SPAN = -0.5, -4.0, 0.6
# seeded fc_cls of the Faster R-CNN serve cell (see arrange_fc_cls): about
# five classes of each RoI pass score_thr, so that the NMS sees 2000
FC_CLS_SEED, FC_CLS_STD, FC_CLS_BOOSTED, FC_CLS_BOOST = 7, 0.5, 8, 2.5
ROI_STRIDES = (4, 8, 16, 32)
# published H100 SXM peaks (NVIDIA data sheet), used for the bounds
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
PEAK_BF16_PER_S = 989e12  # dense, on the tensor cores
# the four requests: (H, W) of seeded random RGB images
REQUESTS = [(480, 640), (640, 480), (427, 640), (800, 1333)]
NUM_CLASSES = 80
OLD_CLASSES = 40
# the training step: batch, canvas, warm-up and timed steps
TRAIN_BATCH = 16
TRAIN_CANVAS = (800, 1344)
TRAIN_IMAGE = (800, 1333)  # (H, W) of each image inside the canvas
TRAIN_WARMUP, TRAIN_TIMED = 2, 5
MAX_GT = 16
# the card the new phases run on (a rehearsal on the CPU sets 'cpu')
DEV = 'cuda'


class CheckFailed(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    check(out, 'nvidia-smi printed no card')
    return out[0].strip()


def events_ms(torch, fn, n):
    """Per-call ms on the card's timeline (CUDA events around n calls)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def kernel_ms(torch, fn, names, n):
    """Per-call device time of the named kernels (torch.profiler), or None
    when the profiler reports no device time for them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for ev in prof.key_averages():
        if any(name in ev.key for name in names):
            total_us += getattr(ev, 'device_time_total', None) or \
                getattr(ev, 'cuda_time_total', 0.0)
    return total_us / n / 1e3 if total_us > 0 else None


def launch_ms(torch, fn, name, n):
    """(ms, records): the mean device time of one launch of the named
    kernel over n calls of ``fn`` (torch.profiler: the time of the records
    it kept over their count, which dropped records do not lower; None
    when it shows none), and the count of those records."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for ev in prof.key_averages():
        if name in ev.key:
            total_us += getattr(ev, 'device_time_total', None) or \
                getattr(ev, 'cuda_time_total', 0.0)
            count += ev.count
    return (total_us / count / 1e3 if total_us > 0 else None), count


def profile_request(torch, fn, tag='profile'):
    """Device busy share and the top kernels of one warm request."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, 'self_device_time_total', None)
        if dev is None:
            dev = getattr(ev, 'self_cuda_time_total', 0.0)
        if dev > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev / 1e3, ev.count, ev.key))
    busy = sum(r[0] for r in rows)
    log(f'{tag}: one 800x1333 request, wall {wall_ms:.2f} ms (profiled), '
        f'device kernels {busy:.2f} ms in {sum(r[1] for r in rows)} '
        f'launches, device idle share {max(0.0, 1 - busy / wall_ms):.3f}')
    for dev, count, key in sorted(rows, reverse=True)[:10]:
        log(f'{tag}:   {dev:8.3f} ms  x{count:<4d} {key[:90]}')


def step_timer(torch):
    """A trainer hook recording the host time, after a synchronize, before
    training and after every step (``t``), and each step's losses."""
    from erd_tpu_torch.engine import Hook

    class StepTimer(Hook):
        def __init__(self):
            self.t, self.losses = [], []

        def before_train(self, trainer):
            torch.cuda.synchronize()
            self.t.append(time.perf_counter())

        def after_iter(self, trainer, step, losses):
            torch.cuda.synchronize()
            self.t.append(time.perf_counter())
            self.losses.append(losses)
    return StepTimer()


def profile_train_step(torch, fn, tag, top=12):
    """The device idle share and the top kernels of one profiled training
    step ``fn``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = []
    for ev in prof.key_averages():
        dev = getattr(ev, 'self_device_time_total', None)
        if dev is None:
            dev = getattr(ev, 'self_cuda_time_total', 0.0)
        if dev > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((dev / 1e3, ev.count, ev.key))
    busy = sum(x[0] for x in rows)
    log(f'{tag} profile: one step, wall {wall_ms:.1f} ms (profiled), '
        f'device kernels {busy:.1f} ms, device idle share '
        f'{max(0.0, 1 - busy / wall_ms):.3f}')
    for dev, count, key in sorted(rows, reverse=True)[:top]:
        log(f'{tag} profile:   {dev:9.3f} ms  x{count:<5d} {key[:90]}')


def request_images(np):
    """The seeded RGB images of REQUESTS, uint8 (H, W, 3)."""
    rs = np.random.RandomState(3)
    return [rs.randint(0, 256, (h, w, 3), np.uint8) for h, w in REQUESTS]


def serve_requests(np, torch, det, net, images, counters, want, tag, card,
                   num_ok=lambda n: 0 < n <= 100, scale=(1333, 800),
                   inside=True):
    """The serving path as a user drives it: a warm-up over all the images
    (cuDNN, kernel loads), every launch count of ``counters`` set to 0, the
    images one request at a time through inference_detector (at ``scale``),
    the counts read. Checks each kernel's launches against ``want`` and
    every detection: finite, inside its image (unless not ``inside``: the
    caller checks the boxes' extent), its label in range, its count
    accepted by ``num_ok``. Then profiles one 800x1333 request and logs the
    latencies, img/s and peak memory. Returns (results, launch counts)."""
    from erd_tpu_torch.apis import inference_detector
    inference_detector(det, net, images, scale=scale)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    results, latency = [], []
    for img in images:
        t0 = time.perf_counter()
        results.append(inference_detector(det, net, img, scale=scale))
        torch.cuda.synchronize()
        latency.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    counts = {k: fn.launches for k, fn in counters.items()}
    log(f'{tag}: launches on the main path {counts}')
    for name, count in counts.items():
        check(count == want[name], f'{tag}: kernel {name} launched {count} '
              f'times, expected {want[name]}')
    for i, (img, res) in enumerate(zip(images, results)):
        h, w = img.shape[:2]
        n = len(res.scores)
        check(num_ok(n), f'{tag} request {i}: {n} detections')
        check(np.isfinite(res.bboxes).all() and np.isfinite(res.scores).all(),
              f'{tag} request {i}: non-finite output')
        slack = 1e-3 * max(h, w)
        check(not inside or ((res.bboxes >= -slack).all() and
                             (res.bboxes[:, [0, 2]] <= w + slack).all() and
                             (res.bboxes[:, [1, 3]] <= h + slack).all()),
              f'{tag} request {i}: boxes outside the image')
        check(((res.labels >= 0) & (res.labels < NUM_CLASSES)).all(),
              f'{tag} request {i}: labels out of range')
    profile_request(torch, lambda: inference_detector(
        det, net, images[-1], scale=scale), tag)
    log(f'{tag}: warm per-request latency ms ' +
        ' '.join(f'{1e3 * t:.2f}' for t in latency) +
        f'; {len(latency) / sum(latency):.2f} img/s; peak memory '
        f'{peak / 2**20:.1f} MiB; card {card}')
    return results, counts


class ServedRequest:
    """One served request taken apart by stage, each stage ended by a
    synchronize. The first stage, the host pipeline and the upload, runs on
    construction; the caller runs the others on ``images`` / ``meta_dev``
    and calls ``mark()`` after each."""

    def __init__(self, np, torch, pipe, i, img):
        from erd_tpu_torch.data import ImageRecord
        from erd_tpu_torch.structures import stack_to
        self.torch, self.i = torch, i
        self.h, self.w = img.shape[:2]
        self.marks = [time.perf_counter()]
        rec = ImageRecord(i, '', self.w, self.h, np.zeros((0, 4), np.float32),
                          np.zeros((0,), np.int32), np.zeros((0,), bool))
        self.canvas, _, meta = pipe(rec, image=img)
        self.images = torch.from_numpy(self.canvas[None]).to(DEV)
        self.meta_dev = stack_to([meta], DEV)
        self.meta_cpu = stack_to([meta], 'cpu')
        self.mark()

    def mark(self):
        self.torch.cuda.synchronize()
        self.marks.append(time.perf_counter())

    def log_stages(self, tag, names):
        names = ('host pipeline + upload',) + tuple(names)
        log(f'{tag}: request {self.i} stages ms: ' + ', '.join(
            f'{name} {1e3 * (t1 - t0):.2f}' for name, t0, t1 in
            zip(names, self.marks, self.marks[1:])))

    def compare(self, tag, gpu, cpu, n, extra='', min_candidates=None):
        """The same head outputs through the card's post-processing
        (kernels) and the CPU's (plain versions): equal keep masks and
        labels, boxes within 1e-2 px, scores within 1e-6, as many kept on
        the card as inference_detector returned (``n``); with
        ``min_candidates``, at least that many candidates into the NMS, as
        many on the CPU."""
        torch = self.torch
        box_err = float((gpu.bboxes.cpu() - cpu.bboxes).abs().max())
        score_err = float((gpu.scores.cpu() - cpu.scores).abs().max())
        at = f'{tag} request {self.i}'
        if min_candidates is not None:
            cand = int(gpu.num_candidates[0])
            extra += f'candidates_into_nms={cand} '
            check(cand >= min_candidates and
                  cand == int(cpu.num_candidates[0]),
                  f'{at}: {cand} candidates reached the NMS (at least '
                  f'{min_candidates} expected), or another count on the CPU')
        log(f'{at} image {self.h}x{self.w} canvas {self.canvas.shape[0]}x'
            f'{self.canvas.shape[1]} {extra}detections={n} card_vs_cpu '
            f'max_box_err={box_err:.2e}px max_score_err={score_err:.2e}')
        check(torch.equal(gpu.mask.cpu(), cpu.mask) and
              torch.equal(gpu.labels.cpu(), cpu.labels) and
              box_err <= 1e-2 and score_err <= 1e-6,
              f'{at}: card and CPU post-processing differ')
        check(int(gpu.mask.sum()) == n,
              f'{at}: predict and inference_detector disagree')


def nms_case(np, torch, rs, b, k, num_labels=NUM_CLASSES):
    """Clustered overlapping boxes over many labels, 10% invalid entries,
    tied scores; sorted and class-shifted as ``nms_mask`` hands them to the
    kernel."""
    boxes, valid, order = [], [], []
    for _ in range(b):
        centres = rs.uniform(50, 1300, (6, 2))
        c = centres[rs.randint(6, size=k)] + rs.normal(0, 10, (k, 2))
        wh = rs.uniform(16, 120, (k, 2))
        bx = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
        labels = rs.randint(0, num_labels, k)
        scores = (rs.randint(0, 50, k) / 50).astype(np.float32)
        v = rs.rand(k) > 0.1
        bx = bx + (labels * (bx.max() + 1)).astype(np.float32)[:, None]
        s = np.where(v, scores, -np.inf)
        o = np.argsort(-s, kind='stable')
        boxes.append(bx[o])
        valid.append(s[o] > -np.inf)
        order.append(o)
    return [torch.from_numpy(np.stack(a)).cuda()
            for a in (boxes, valid, order)]


DECODE_DESIGN = (
    'one launch a batch; the rows read where they lie (the head\'s five '
    'level maps with their element strides, float32 or bf16 widened in '
    'registers, or one flat map); a block 32 candidates staged in shared '
    'memory by 16- or 8-byte loads where unit-stride and aligned, else '
    'element by element; a thread a side, 17 exponentials in registers, '
    'one division')


def decode_call(np, torch, tag, args, levels=None):
    """Row 2 at one call shape of a main path, ``args`` as the path handed
    them to ``integral_decode``: held to plain within 1e-4 * stride +
    1e-5 * |box| px; with ``levels``, the head's distribution maps, checked
    to be the very tensors the decode got (no cast and no concatenation
    before it); timed by graph replays and events beside plain and the
    bound (each image's distinct rows' logits, centre and stride, the rows
    and img_shape read once, the boxes written; 121 operations a side)."""
    from erd_tpu_torch.ops import integral_decode, integral_decode_plain
    reg, rows, centers, strides, img_shape = args[:5]
    if levels is not None:
        check(isinstance(reg, (list, tuple)) and len(reg) == len(levels) and
              all(a is b for a, b in zip(reg, levels)),
              f'{tag}: the decode did not get the head\'s maps themselves '
              f'(a cast or concatenation ran before it)')
    maps = reg if isinstance(reg, (list, tuple)) else [reg]

    def call():
        return integral_decode(*args)

    def plain():
        return integral_decode_plain(*args)
    got = call()
    torch.cuda.synchronize()
    want = plain()
    err = (got - want).abs()
    stride = strides[rows].unsqueeze(-1)
    ratio = float((err / (1e-4 * stride + 1e-5 * want.abs())).max())
    check(ratio <= 1.0, f'{tag}: decode kernel disagrees with plain')
    b, k = rows.shape
    uniq = sum(int(torch.unique(rows[i]).numel()) for i in range(b))
    nbytes = uniq * (68 * maps[0].element_size() + 8 + 4) + \
        b * k * (8 + 16) + b * 8
    bms, by = bound_of(nbytes, b * k * 4 * 121.0)
    out = dict(call=tag, rows=[b, k], ms=graph_ms(torch, call, 20),
               ms_from='graph', call_ms=events_ms(torch, call, 20),
               plain_ms=events_ms(torch, plain, 3), bound_ms=bms,
               bound_by=by, bytes=nbytes, max_abs_err=float(err.max()),
               err_over_gate=ratio,
               maps=[dict(shape=list(m.shape), dtype=str(m.dtype),
                          strides=list(m.stride())) for m in maps])
    log(f'{tag}: integral_decode {b}x{k} rows of ' + ', '.join(
        f'{tuple(m.shape)} {m.dtype} {m.stride()}' for m in maps) +
        f': {out["ms"]:.4f} ms (graph), {out["call_ms"]:.4f} eager (events), '
        f'plain {out["plain_ms"]:.3f}, bound {bms:.5f} ({by}); max_abs_err '
        f'{out["max_abs_err"]:.3e} px ({ratio:.3f} of the gate)')
    return out


def phase_kernels(np, torch):
    from erd_tpu_torch.models.heads.gfl_head import AnchorContext
    from erd_tpu_torch.ops import (integral_decode, integral_decode_plain,
                                   nms_sorted_keep, nms_sorted_keep_plain)
    rs = np.random.RandomState(0)
    rows_out = []

    # -- A: NMS, exact keep masks at predict (K=2000, IoU 0.6) and at the
    # training slice's distillation size (K=4481, IoU 0.005)
    for b, k, thr in [(2, 2000, 0.6), (2, 4481, 0.005)]:
        args = nms_case(np, torch, rs, b, k)
        got = nms_sorted_keep(*args, thr)
        torch.cuda.synchronize()
        want = nms_sorted_keep_plain(*args, thr)
        diff = int((got != want).sum())
        log(f'kernels: nms B={b} K={k} iou={thr} kept={int(got.sum())} '
            f'mismatches={diff}')
        check(diff == 0, f'NMS kernel disagrees with plain at K={k}')
        check(0 < int(got.sum()) < int(args[1].sum()),
              'NMS check suppressed nothing or everything')
    # timing at the serving path's shapes: one image, K = 2000
    args = nms_case(np, torch, rs, 1, 2000)
    nms_call_ms = events_ms(torch, lambda: nms_sorted_keep(*args, 0.6), 20)
    nms_ms = kernel_ms(torch, lambda: nms_sorted_keep(*args, 0.6),
                       ['nms_mask_kernel', 'nms_reduce_kernel'], 20)
    nms_plain_ms = events_ms(
        torch, lambda: nms_sorted_keep_plain(*args, 0.6), 5)
    sboxes, svalid = args[0], args[1]
    k = sboxes.shape[1]
    valid_idx = torch.nonzero(svalid[0]).flatten().double()
    pairs = float((k - 1 - valid_idx).sum())
    nms_ops = 14.0 * pairs + 3.0 * k  # per pair: min/max x4, sub x3, max0
    # x2, mul, add, max, div, compare; per box: its area
    nms_bytes = k * (16 + 1 + 8) + k * 1
    rows_out.append(dict(
        name='nms_keep', route='cuda',
        source='erd_tpu_torch/csrc/nms.cu',
        replaces='erd_tpu/ops/nms.py:50',
        max_abs_err=0.0, ms=nms_ms or nms_call_ms, call_ms=nms_call_ms,
        ms_from='profiler' if nms_ms else 'events',
        plain_ms=nms_plain_ms,
        bound_ms=1e3 * max(nms_bytes / PEAK_BYTES_PER_S,
                           nms_ops / PEAK_FP32_PER_S),
        bound_by='operations' if nms_ops / PEAK_FP32_PER_S >
        nms_bytes / PEAK_BYTES_PER_S else 'bytes',
        library_ms=None))

    # -- B: decode, (2, 22400, 68) logits, 1000 candidate rows per level:
    # the flat float32 form, and the five level maps as a head leaves them
    # (NHWC views of NCHW maps, float32 and bf16; vector loads on
    # channels-last bf16)
    ctx = AnchorContext.build((800, 1344))
    centers, strides = ctx.device_tensors('cuda')
    n = ctx.num_anchors
    starts = np.concatenate([[0], np.cumsum(ctx.num_level_anchors)])

    def candidate_rows(b):
        return torch.from_numpy(np.stack([np.concatenate([
            rs.randint(starts[i], starts[i + 1], 1000) for i in range(5)])
            for _ in range(b)])).cuda()

    reg = torch.from_numpy(
        (rs.randn(2, n, 68) * 3).astype(np.float32)).cuda()
    rows = candidate_rows(2)
    img_shape = torch.tensor([[800.0, 1333.0], [800.0, 1200.0]]).cuda()
    dec_err = 0.0
    nchw = [reg[:, a:b].reshape(2, h, w, 68).permute(0, 3, 1, 2).contiguous()
            for (a, b), (h, w) in zip(zip(starts[:-1], starts[1:]),
                                      ctx.featmap_sizes)]
    forms = {'flat float32': reg,
             'levels float32 (NHWC views of NCHW)': [
                 m.permute(0, 2, 3, 1) for m in nchw],
             'levels bf16 (NHWC views of NCHW)': [
                 m.bfloat16().permute(0, 2, 3, 1) for m in nchw],
             'levels bf16 channels-last': [
                 m.bfloat16().contiguous(memory_format=torch.channels_last)
                 .permute(0, 2, 3, 1) for m in nchw]}
    for form, logits in forms.items():
        got = integral_decode(logits, rows, centers, strides, img_shape)
        torch.cuda.synchronize()
        want = integral_decode_plain(logits, rows, centers, strides,
                                     img_shape)
        err = (got - want).abs()
        tol = 1e-4 * strides[rows].unsqueeze(-1) + 1e-5 * want.abs()
        dec_err = max(dec_err, float(err.max()))
        log(f'kernels: integral_decode B=2 N={n} K={rows.shape[1]} {form}: '
            f'max_abs_err={float(err.max()):.3e} px (tolerance '
            f'1e-4*stride+1e-5*|box|)')
        check(bool((err <= tol).all()),
              f'decode kernel disagrees with plain ({form})')
    del nchw, forms
    rows_out.append(dict(
        name='integral_decode', route='cuda',
        source='erd_tpu_torch/csrc/integral_decode.cu',
        replaces='erd_tpu/ops/integral.py:14', max_abs_err=dec_err,
        library_ms=None, redesigned=True, design=DECODE_DESIGN))
    log('kernels: library_ms is null for both: no single PyTorch call '
        'computes greedy NMS (no torchvision) or the fused decode')
    return rows_out


def phase_reference(np, torch):
    """Full-width float32 network, card vs CPU, on one small input."""
    import copy

    from erd_tpu_torch.apis import build_detector
    from erd_tpu_torch.config import Config
    cfg = Config.fromfile(ERD_CONFIG)
    cfg.model.compute_dtype = 'float32'
    det = build_detector(cfg.model)
    net_cpu = det.init(seed=1, device='cpu')
    net_gpu = copy.deepcopy(net_cpu).cuda()
    img = np.random.RandomState(2).randint(0, 256, (1, 128, 192, 3),
                                           np.uint8)
    want = det.forward_raw(net_cpu, torch.from_numpy(img))
    got = det.forward_raw(net_gpu, torch.from_numpy(img).cuda())
    worst = 0.0
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        check(tuple(g.shape) == tuple(w.shape), 'reference shape mismatch')
        rel = float((g.cpu() - w).abs().max() / w.abs().max())
        worst = max(worst, rel)
    log(f'reference: float32 network card vs CPU, max |diff| / max |out| '
        f'= {worst:.2e} (tolerance 1e-3)')
    check(worst <= 1e-3, 'float32 network on the card disagrees with CPU')


def phase_serve(np, torch, card):
    from erd_tpu_torch.apis import init_detector
    from erd_tpu_torch.data import DetPipeline
    from erd_tpu_torch.ops import integral_decode, nms_sorted_keep

    det, net, cfg = init_detector(ERD_CONFIG, device='cuda')
    check(type(det).__name__ == 'ERDDetector', 'not the ERD detector')
    check(det.num_classes == NUM_CLASSES and det.depth == 50 and
          det.compute_dtype == torch.bfloat16, 'not the GFL-R50 bf16 model')
    with torch.no_grad():
        net.bbox_head.gfl_cls.bias.zero_()  # scores near 0.5: full NMS
    images = request_images(np)
    counters = {'nms_keep': nms_sorted_keep,
                'integral_decode': integral_decode}
    results, launches = serve_requests(
        np, torch, det, net, images, counters,
        {k: len(images) for k in counters}, 'serve', card)

    head_module = importlib.import_module(
        'erd_tpu_torch.models.heads.gfl_head')
    pipe = DetPipeline()
    for i, (img, res) in enumerate(zip(images, results)):
        req = ServedRequest(np, torch, pipe, i, img)
        ctx = det.anchor_context(req.images.shape[1:3])
        cls, reg = det.forward_raw(net, req.images)
        req.mark()
        calls = []
        restore = capture(head_module, 'integral_decode', calls)
        try:
            gpu = det.postprocess(ctx, cls, reg, req.meta_dev)
        finally:
            restore()
        req.mark()
        req.log_stages('serve', ('network', 'post-processing'))
        cpu = det.postprocess(ctx, [c.cpu() for c in cls],
                              [r.cpu() for r in reg], req.meta_cpu)
        req.compare('serve', gpu, cpu, len(res.scores), min_candidates=1)
        check(len(calls) == 1, f'serve request {i}: {len(calls)} decodes')
        if i == len(images) - 1:  # the 800x1333 request's call shape
            decode = decode_call(np, torch, 'serve', calls[0], reg)
    return launches, decode


def bound_of(nbytes, ops, bf16_ops=0.0):
    """(bound ms, 'bytes' or 'operations') at the H100 peaks above: the
    larger of the bytes' time, the float32 operations' time and the time of
    the bf16 x bf16 products (``bf16_ops``) at the tensor-core rate."""
    tb = nbytes / PEAK_BYTES_PER_S
    to = max(ops / PEAK_FP32_PER_S, bf16_ops / PEAK_BF16_PER_S)
    return 1e3 * max(tb, to), 'bytes' if tb >= to else 'operations'


def time_pair(torch, fn, plain_fn, names, n=10):
    """(kernel ms, call ms, source, plain ms): device time of the named
    kernels per call (profiler, or events when it shows none), the call's
    event time, and the plain version's event time."""
    call_ms = events_ms(torch, fn, n)
    dev_ms = kernel_ms(torch, fn, names, n)
    plain_ms = events_ms(torch, plain_fn, max(2, n // 3))
    return (dev_ms or call_ms, call_ms,
            'profiler' if dev_ms else 'events', plain_ms)


def graph_ms(torch, fn, n=20):
    """Per-call device time of ``fn`` (CUDA events around replays of a
    CUDA graph of n calls): no host launch overhead, and no profiler
    records that can go missing, for kernels shorter than a launch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up (lazy loads, allocator) off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (3 * n)


def time_graph(torch, fn, plain_fn, n=20):
    """(kernel ms, call ms, source, plain ms) as time_pair's, the kernel's
    device time from graph_ms."""
    call_ms = events_ms(torch, fn, n)
    plain_ms = events_ms(torch, plain_fn, max(2, n // 3))
    return graph_ms(torch, fn, n), call_ms, 'graph', plain_ms


# the soft-NMS kernel by the profiler's name (its instantiations by the
# candidates a thread holds: soft_nms_kernel<2>, ...)
SOFT_NMS_KERNELS = ['soft_nms_kernel<']


def profiled_ms(torch, fn, names, n, what):
    """kernel_ms of the named kernels, failing the phase where the
    profiler matches no record of them (a renamed kernel must not report
    0 or fall back to another clock)."""
    ms = kernel_ms(torch, fn, names, n)
    check(ms is not None, f'{what}: the profiler shows no record of '
          f'{names}')
    return ms


# the soft-NMS latency floor: csrc/soft_nms.cu with its pass's decay and
# its early exit taken out, so that each step is its warp reduction, its
# atomics, its barrier (in a cluster the exchange of the blocks' words) and
# the winner's reads (built in the build directory, on no path)
SOFT_NMS_FLOOR_EDITS = {
    'if (step > 0 && c > -CUDART_INF_F) {': 'if (false) {',
    'if (win == 0ull) {  // nothing live':
    'if (false) {  // nothing live'}


def start_soft_nms_floor_build(edits=None, variant='floor'):
    """Start nvcc on a copy of csrc/soft_nms.cu with ``edits`` (default
    SOFT_NMS_FLOOR_EDITS) applied, built in the build directory as
    ``soft_nms_<variant>``; returns a handle for soft_nms_floor_lib, or
    None where the edits do not fit the source (another design's)."""
    from erd_tpu_torch.ops import cuda_build
    src = (cuda_build.CSRC / 'soft_nms.cu').read_text()
    edits = SOFT_NMS_FLOOR_EDITS if edits is None else edits
    if not all(old in src for old in edits):
        return None
    for old, new in edits.items():
        src = src.replace(old, new)
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    copy = cuda_build.BUILD_DIR / f'soft_nms_{variant}.cu'
    copy.write_text(src)
    path = copy.with_suffix('.so')
    proc = subprocess.Popen([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                             '-o', str(path), str(copy)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, path


def soft_nms_floor_lib(handle):
    """The loaded floor library of start_soft_nms_floor_build's handle."""
    import ctypes
    proc, path = handle
    out, _ = proc.communicate()
    check(proc.returncode == 0, f'soft-NMS floor build failed:\n{out}')
    lib = ctypes.CDLL(str(path))
    lib.erd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.erd_cuda_error_string.restype = ctypes.c_char_p
    return lib


def soft_nms_forced_plan(lib, args, cs):
    """The soft-NMS plan of ``args`` in library ``lib`` with each image a
    cluster of ``cs`` blocks (the wrapper's plan with that size alone), or
    None where a block of that cluster cannot hold its slice."""
    from erd_tpu_torch.ops.nms import soft_nms_limits, soft_nms_plan
    k = args[1].shape[1]
    threads, capacity = soft_nms_limits(lib, args[1].device)
    if -(-k // cs) > capacity[cs]:
        return None
    return soft_nms_plan(k, capacity, threads, clusters=(cs,))


def soft_nms_floor_ms(torch, lib, args, cs):
    """Graph ms of ``args``' soft-NMS steps in library ``lib`` (the floor
    library: the steps emptied), each image a cluster of ``cs`` blocks, or
    None where a block of that cluster cannot hold its slice."""
    from erd_tpu_torch.ops.nms import soft_nms_launch
    plan = soft_nms_forced_plan(lib, args, cs)
    if plan is None:
        return None
    return graph_ms(torch, lambda: soft_nms_launch(lib, *args, plan=plan),
                    10)


def soft_nms_stats(torch, args, sel_scores):
    """(live candidates an image, the first step whose selection is -inf,
    i.e. every candidate consumed or dropped, or None) of a soft-NMS call
    and its selected scores."""
    live = [int(v) for v in (args[1] > float('-inf')).sum(-1)]
    dead = (sel_scores == float('-inf')).all(0)
    return live, (int(dead.int().argmax()) if bool(dead.any()) else None)


def soft_nms_cost(args, live, exhausted):
    """(bytes, operations) that the soft-NMS call must do on this data: the
    scores read, the live candidates' boxes, the selections written; ~21
    operations a live candidate and step (argmax compare; IoU: 2 min, 2
    max, 2 sub, 2 max0, mul, add, sub, max, div; decay compare, sub, mul;
    min-score compare) over the steps taken before nothing is live."""
    k, steps = args[1].shape[1], args[2]
    run = steps if exhausted is None else exhausted
    return (sum(4 * k + 16 * n for n in live) + steps * 12 * len(live),
            sum(n for n in live) * run * 21.0)


def soft_nms_large_k_case(np, torch):
    """(sboxes, scores) of the large-K case: one image, K = 12000
    class-shifted boxes in 40 clusters over 80 classes, 10 % -inf."""
    rs = np.random.RandomState(21)
    k = 12000
    centres = rs.uniform(50, 1300, (40, 2))
    c = centres[rs.randint(40, size=k)] + rs.normal(0, 15, (k, 2))
    wh = rs.uniform(16, 120, (k, 2))
    bx = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    bx = bx + (rs.randint(0, 80, k) * (bx.max() + 1)).astype(
        np.float32)[:, None]
    sc = rs.uniform(0.05, 1, k).astype(np.float32)
    sc[rs.rand(k) < 0.1] = -np.inf
    return (torch.from_numpy(bx)[None].to(DEV),
            torch.from_numpy(sc)[None].to(DEV))


SOFT_NMS_DESIGN = ('an image a block of 512 threads, or a thread-block '
                   'cluster of 2-8 past 3072 candidates a block; live '
                   'candidates compacted at load into shared-memory '
                   'planes, their scores in registers; one pass and one '
                   'barrier a step: a warp REDUX of an order key, its best '
                   'folded by a shared 64-bit atomicMax; in a cluster the '
                   'blocks\' words sent as step-tagged DSMEM stores and '
                   'polled; early exit once nothing is live')


def synthetic_gt(np, torch, rs, b, img_hw, device=None,
                 num_labels=NUM_CLASSES - OLD_CLASSES):
    """1-12 random gt boxes per image in MAX_GT padded slots, inside the
    (H, W) image, labels in 0..num_labels-1 (default: the 40 new classes
    of the ERD step)."""
    h, w = img_hw
    boxes = np.zeros((b, MAX_GT, 4), np.float32)
    labels = np.zeros((b, MAX_GT), np.int64)
    mask = np.zeros((b, MAX_GT), bool)
    for i in range(b):
        g = rs.randint(1, 13)
        wh = rs.uniform(16, min(h, w) / 2, (g, 2))
        x1 = rs.uniform(0, w - wh[:, 0])
        y1 = rs.uniform(0, h - wh[:, 1])
        boxes[i, :g] = np.stack([x1, y1, x1 + wh[:, 0], y1 + wh[:, 1]], -1)
        labels[i, :g] = rs.randint(0, num_labels, g)
        mask[i, :g] = True
    from erd_tpu_torch.structures import GTInstances
    device = device or DEV
    return GTInstances(bboxes=torch.from_numpy(boxes).to(device),
                       labels=torch.from_numpy(labels).to(device),
                       mask=torch.from_numpy(mask).to(device))


def atss_cost(n, b, g, n_gt):
    """(bytes, float32 operations) of one ATSS call over N anchors, B
    images and G gt slots of which ``n_gt`` are real: the anchors, the
    padded gts and the valid flags read, the four (B, N) outputs and the
    64-bit scratch word written once; per (real gt, anchor) the centre
    distance (2 subtracts, 2 multiplies, an add, a sqrt) and the compare
    of the per-level selection."""
    nbytes = n * 16 + b * g * 25 + b * n * (1 + 1 + 8 + 4 + 8)
    return nbytes, n_gt * n * 7.0


def gfl_loss_cost(b, n, c, reg_width, positives):
    """(bytes, float32 operations) of one fused GFL loss forward and
    backward over B x N rows of C classes, ``positives`` of them positive:
    the forward reads the class logits, label (int64), label weight and
    positive flag of every row, and the distribution logits, box target
    and anchor geometry (12 bytes) of positive rows only (a row that is not
    positive has quality 0 and weight 0: its terms do not depend on them);
    the backward reads the same again and writes both gradients of every
    row. ~3300 operations a row (forward ~1300, backward ~2000: softmaxes,
    sigmoids, logs, GIoU and its gradient)."""
    m = b * n
    row = c * 4 + 8 + 4 + 1
    pos_row = reg_width * 4 + 16 + 12
    return (m * (2 * row + c * 4 + reg_width * 4) + positives * 2 * pos_row,
            m * 3300.0)


def erd_distill_cost(b, n, c, width, reg_width, n_cm, n_kp, n_s):
    """(bytes, float32 operations) of one fused distillation forward and
    backward over B x N rows, ``n_cm`` of them ERS-cls selected, ``n_kp``
    NMS-kept and ``n_s`` either: each pass reads the two mask bytes of
    every row, the C student class logits of selected rows, the teacher's
    of ERS-cls rows and both distribution logits of kept rows; the
    backward writes the class gradient ``width`` columns wide (the whole
    student map: the columns past C are zeros; C where the gradient was
    the slice's) and the distribution gradient of every row. Operations:
    the two softmaxes and the KL of a kept row's 4 sides, the squared
    differences and the sigmoids, each pass."""
    m = b * n
    reads = m * 2 + n_s * c * 4 + n_cm * c * 4 + n_kp * reg_width * 4 * 2
    nbytes = 2 * reads + m * (width + reg_width) * 4 + b * 8
    ops = 2 * (n_kp * reg_width * 16.0 + n_cm * c * 3.0 + n_s * c * 4.0)
    return nbytes, ops


def ers_cost(b, n, c_cls, c_reg, cap):
    """(bytes, float32 operations) of one ERS selection: the teacher's
    class and distribution logits of every row read once, the cls mask (a
    byte a row) and the list's index (8 bytes) and mask (1 byte) a slot
    and the count written; a sigmoid, a compare and the moments a row."""
    nbytes = b * n * (c_cls + c_reg) * 4 + b * n + b * cap * 9 + b * 4
    return nbytes, b * n * (c_cls * 4.0 + c_reg + 6)


def capture_kw(module, name, calls):
    """``capture`` for wrappers called with keywords: records (args,
    kwargs), tensors detached. Returns the restore function."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        calls.append((tuple(a.detach() if hasattr(a, 'detach') else a
                            for a in args), dict(kwargs)))
        return fn(*args, **kwargs)
    wrapper.launches = 0
    setattr(module, name, wrapper)
    return lambda: setattr(module, name, fn)


# row 3's kernels, by the profiler's names
GFL_LOSS_KERNELS = ['gfl_loss_rows_kernel', 'gfl_loss_reduce_kernel',
                    'gfl_loss_backward_kernel']
GFL_LOSS_DESIGN = ('CUDA: a warp 8 rows, a lane a (row, side); 16-byte '
                   'class chunks s, s + 4, ... read in place through the '
                   'map\'s row stride; '
                   'distribution logits and targets read for positive rows '
                   'only (a warp with one softmaxes each side in its lane, '
                   'corners by quad shuffles); per-block partials reduced '
                   'in a fixed order; deterministic')
# row 5's and row 4's kernels, by the profiler's names
ERS_KERNELS = ['ers_criteria_kernel', 'ers_select_kernel', 'ers_rank_kernel']
DISTILL_KERNELS = ['erd_distill_rows_kernel', 'erd_distill_reduce_kernel',
                   'erd_distill_backward_kernel']
ERS_DESIGN = ('three launches, no memset: a warp 32 rows read as 16-byte '
              'loads (criteria, Chan partials, key range per block); a '
              'block an image: statistics in a fixed order, radix select '
              'on unique 64-bit (criterion, ~row) keys staged in shared '
              'memory (the rows in play listed once they fit), exactly '
              'cap rows, grouped by digit; ranks within a digit\'s bin; '
              'lists exact')
DISTILL_DESIGN = ('CUDA: a warp 8 rows, a lane a (row, side); warps with no '
                  'selected row skip every load and write 16-byte zeros; '
                  'classes read in place as 16-byte chunks; a kept row\'s '
                  'distribution by the whole warp (8 lanes a side, '
                  'shuffle reductions); per-block partials reduced in a '
                  'fixed order; the backward writes the whole 80-wide '
                  'class gradient (no autograd copies); deterministic')
ATSS_DESIGN = ('one scan of each level: a block an (image, gt, 2048-anchor '
               'chunk), per-thread sorted lists of 64-bit (distance, '
               'anchor) keys, warp merges, ranks; a warp an (image, gt) '
               'ranks the chunks\' lists into candidates, lane IoUs, the '
               'serial statistics on one lane; bit-equal')


def gfl_loss_call(torch, fn, leaves, lo, c, rest, kwargs):
    """(losses, (gradient of the class map, of reg)) of one fused GFL loss
    call on the columns lo:lo + c of the leaf class map, the gradients by
    ``torch.autograd.grad`` of the losses' sum."""
    cls, reg = leaves
    losses = fn(cls[..., lo:lo + c], reg, *rest[1:], **kwargs)
    return (torch.stack(losses).detach(),
            torch.autograd.grad(sum(losses), (cls, reg)))


def hold_loss_kernels(torch, tag, atss_call, gfl_call=None):
    """Rows 6 and 3 at one training step's calls against their plain
    versions, then graph-timed: ATSS's four outputs exactly equal; the GFL
    losses within rtol 1e-4 (float32 sums in another order), the gradients
    within 1e-4*|g| + 1e-5*max|g|, the class map's other columns' gradient
    exactly 0 and two kernel calls bit-equal. ``atss_call`` is (args,
    kwargs), ``gfl_call`` (wide class map, first column, C, the loss's
    other arguments, kwargs) or None. Returns {'atss': ..., 'gfl_loss':
    ...}, each a dict of the call's errors and times."""
    from erd_tpu_torch.ops.gfl_loss import fused_gfl_loss, gfl_loss_plain
    from erd_tpu_torch.task import atss_assign, atss_assign_plain
    args, kw = atss_call
    got = atss_assign(*args, **kw)
    want = atss_assign_plain(*args, **kw)
    diff = sum(int((getattr(got, f) != getattr(want, f)).sum())
               for f in ('pos_mask', 'gt_idx', 'labels', 'max_overlaps'))
    n_pos = int(got.pos_mask.sum())
    del got, want
    b, g = args[4].shape
    n_gt = int(args[4].sum())
    check(diff == 0, f'{tag}: ATSS kernel disagrees with plain')
    check(n_pos > 0, f'{tag}: ATSS check found no positive')
    ms = graph_ms(torch, lambda: atss_assign(*args, **kw), 20)
    call_ms = events_ms(torch, lambda: atss_assign(*args, **kw), 20)
    plain_ms = events_ms(torch, lambda: atss_assign_plain(*args, **kw), 2)
    bms, by = bound_of(*atss_cost(args[0].shape[0], b, g, n_gt))
    out = {'atss': dict(config=tag, batch=b, anchors=args[0].shape[0],
                        real_gts=n_gt, gt_slots=b * g, positives=n_pos,
                        mismatches=diff, ms=ms, call_ms=call_ms,
                        ms_from='graph', plain_ms=plain_ms, bound_ms=bms,
                        bound_by=by)}
    log(f'train kernels: {tag} atss B={b} N={args[0].shape[0]} G={g} '
        f'({n_gt} real gts): positives={n_pos} mismatches={diff} (exact); '
        f'{ms:.4f} ms (graph), {call_ms:.4f} (events), plain '
        f'{plain_ms:.3f}, bound {bms:.4f} ({by})')
    if gfl_call is None:
        return out
    wide, lo, c, rest, kw = gfl_call
    leaves = (wide.detach().clone().requires_grad_(True),
              rest[0].detach().clone().requires_grad_(True))

    def run(fn):
        return gfl_loss_call(torch, fn, leaves, lo, c, rest, kw)

    def forward():
        with torch.no_grad():
            return fused_gfl_loss(leaves[0][..., lo:lo + c], leaves[1],
                                  *rest[1:], **kw)
    (l1, g1), (l2, g2), (lp, gp) = run(fused_gfl_loss), \
        run(fused_gfl_loss), run(gfl_loss_plain)
    err = float((l1 - lp).abs().max())
    ratio = max(float(((a - w).abs() / (1e-4 * w.abs() + 1e-5 * float(
        w.abs().max()))).max()) for a, w in zip(g1, gp))
    other = torch.ones(wide.shape[-1], dtype=torch.bool, device=wide.device)
    other[lo:lo + c] = False
    other_max = float(g1[0][..., other].abs().max()) if bool(other.any()) \
        else 0.0
    same = bool(torch.equal(l1, l2)) and all(
        torch.equal(a, a2) for a, a2 in zip(g1, g2))
    log(f'train kernels: {tag} gfl_loss B={b} C={c} of a '
        f'{wide.shape[-1]}-wide map: losses {l1.tolist()} vs plain '
        f'{lp.tolist()}; max_abs_err={err:.3e} (tolerance rtol 1e-4); '
        f'gradient error / tolerance (1e-4*|g|+1e-5*max|g|) = {ratio:.3f}; '
        f'other columns\' gradient largest {other_max}; two calls '
        f'bit-equal {same}')
    check(bool(((l1 - lp).abs() <= 1e-4 * lp.abs()).all()),
          f'{tag}: GFL loss kernel disagrees with plain')
    check(ratio <= 1.0, f'{tag}: GFL loss backward disagrees with plain')
    check(other_max == 0.0, f'{tag}: GFL loss gradient outside its columns')
    check(same, f'{tag}: two GFL loss calls differ')
    del l1, l2, lp, g1, g2, gp
    call_ms = graph_ms(torch, lambda: run(fused_gfl_loss), 10)
    fwd_ms = graph_ms(torch, forward, 10)
    ms = kernel_ms(torch, lambda: run(fused_gfl_loss), GFL_LOSS_KERNELS, 10)
    plain_ms = events_ms(torch, lambda: run(gfl_loss_plain), 2)
    n_pos = int(rest[4].sum())
    nbytes, ops = gfl_loss_cost(b, wide.shape[1], c, rest[0].shape[-1],
                                n_pos)
    bms, by = bound_of(nbytes, ops)
    out['gfl_loss'] = dict(
        config=tag, batch=b, classes=c, map_width=wide.shape[-1],
        positives=n_pos, max_abs_err=err, grad_err_over_tolerance=ratio,
        repeat_equal=same, ms=ms or call_ms,
        ms_from='profiler' if ms else 'graph', call_ms=call_ms,
        call_ms_from='graph, through autograd (its zero-fill and slice '
        'copy of a class slice\'s gradient included)', forward_ms=fwd_ms,
        plain_ms=plain_ms, bound_ms=bms, bound_by=by, bound_bytes=nbytes)
    log(f'train kernels: {tag} gfl_loss forward + backward kernels '
        f'{ms or call_ms:.4f} ms ({"profiler" if ms else "graph"}); call '
        f'through autograd {call_ms:.4f} (graph), forward {fwd_ms:.4f} '
        f'(graph); plain {plain_ms:.3f}; bound {bms:.4f} ({by}; {nbytes} '
        f'bytes, {n_pos} positive rows)')
    return out


def train_case(np, torch, rs, ctx, b):
    """Head outputs and targets of one batch, as the train step hands them
    to the kernels: teacher logits are bf16 values in float32, with a few
    confident rows per image."""
    from erd_tpu_torch.models.heads.gfl_head import gfl_targets
    n = ctx.num_anchors

    def randn(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy((rs.randn(*shape) * scale + shift).astype(
            np.float32)).to(DEV)
    t_cls = randn(b, n, OLD_CLASSES, scale=1.5, shift=-4.0)
    t_reg = randn(b, n, 68, scale=2.0)
    hot = torch.from_numpy(rs.rand(b, n) < 0.01).to(DEV)
    t_cls = torch.where(hot[..., None], t_cls + 6.0, t_cls).bfloat16().float()
    t_reg = torch.where(hot[..., None], t_reg + 3.0, t_reg).bfloat16().float()
    gt = synthetic_gt(np, torch, rs, b, TRAIN_IMAGE)
    img_shape = torch.tensor([list(map(float, TRAIN_IMAGE))] * b, device=DEV)
    targets = gfl_targets(ctx, gt, img_shape, NUM_CLASSES - OLD_CLASSES)
    return dict(gt=gt, img_shape=img_shape, targets=targets, t_cls=t_cls,
                t_reg=t_reg, s_cls=randn(b, n, NUM_CLASSES, scale=2.0,
                                         shift=-3.0),
                s_reg=randn(b, n, 68, scale=2.0))


def phase_train_kernels(np, torch):
    """The training kernels against their plain versions at B = 2 and at
    the train step's B = 16, then timed at B = 16."""
    import erd_tpu_torch.ops.nms as nms_module
    from erd_tpu_torch.models.detectors.gfl_erd import _kept_dense
    from erd_tpu_torch.models.heads.gfl_head import AnchorContext
    from erd_tpu_torch.ops import (integral_decode, integral_decode_plain,
                                   nms_sorted_keep, nms_sorted_keep_plain)
    from erd_tpu_torch.ops.erd_distill import (erd_distill_plain,
                                               fused_erd_distill)
    from erd_tpu_torch.ops.ers_select import (ers_select, ers_select_plain,
                                              ers_threshold)
    from erd_tpu_torch.task import valid_flags

    rs = np.random.RandomState(5)
    ctx = AnchorContext.build(TRAIN_CANVAS)
    n = ctx.num_anchors
    cap = n // 5 + 1
    fast_k = 1024  # the config's ERDConfig.ers_nms_fast_k
    anchors = ctx.device_anchors(DEV)
    centers, strides = ctx.device_tensors(DEV)
    unit = torch.ones(n, device=DEV)
    nla = ctx.num_level_anchors
    rows = []

    def atss_args(case):
        pad = torch.ceil(case['img_shape'] / 32) * 32
        vf = valid_flags(ctx.featmap_sizes, ctx.strides, pad)
        gt = case['gt']
        return (anchors, nla, gt.bboxes, gt.labels, gt.mask, vf)

    def gfl_args(case):
        t = case['targets']
        return (t.labels, t.label_weights, t.bbox_targets, t.pos_mask,
                t.num_pos, centers, strides)

    def ers_nms(case, k):
        """The ERS masks, the first k reg candidates, the rows the NMS kept
        as erd_distill_losses makes them, and the arguments the NMS kernel
        was handed there (the teacher's decoded rows, sorted and shifted
        by class)."""
        cm, ri, rm, count = ers_select(case['t_cls'], case['t_reg'], cap)
        ri, rm = ri[:, :k].contiguous(), rm[:, :k].contiguous()
        seen = []
        restore = capture(nms_module, 'nms_sorted_keep', seen)
        try:
            kept = _kept_dense(centers, unit, case['t_cls'], case['t_reg'],
                               ri, rm, 0.005, 16)
        finally:
            restore()
        check(len(seen) == 1, 'the distillation NMS ran other than once')
        return cm, ri, kept, count, seen[0]

    def distill_step(fn, case, s_cls, s_reg, cm, kept):
        l_cls, l_reg = fn(s_cls, s_reg, case['t_cls'], case['t_reg'], cm,
                          kept)
        (l_cls.sum() + l_reg.sum()).backward()
        return l_cls, l_reg

    def with_grad(case):
        return (case['s_cls'].clone().requires_grad_(True),
                case['s_reg'].clone().requires_grad_(True))

    def grad_ratio(grads):
        """Largest |kernel - plain| / (1e-4*|plain| + 1e-5*max|plain|)."""
        return max(float(((g - w).abs() / (1e-4 * w.abs() + 1e-5 * float(
            w.abs().max()))).max()) for g, w in zip(*grads))

    def check_case(case):
        """Every training kernel against its plain version on one batch;
        returns the largest errors of the decode and the fused losses."""
        b = case['t_cls'].shape[0]
        held = hold_loss_kernels(
            torch, f'ERD B={b}', (atss_args(case), {}),
            (case['s_cls'], OLD_CLASSES, NUM_CLASSES - OLD_CLASSES,
             (case['s_reg'],) + gfl_args(case), {}))

        got = ers_select(case['t_cls'], case['t_reg'], cap)
        want = ers_select_plain(case['t_cls'], case['t_reg'], cap)
        check(torch.equal(got[1], want[1]),
              f'ERS reg list differs from plain at B={b}')
        flips = 0
        crit_cls = torch.sigmoid(case['t_cls']).amax(-1)
        crit_reg = case['t_reg'].amax(-1)
        for g, w, crit, full in (
                (got[0], want[0], crit_cls, crit_cls),
                (got[2], want[2], torch.gather(crit_reg, 1, want[1]),
                 crit_reg)):
            thr = ers_threshold(full)[:, None]
            near = (crit - thr).abs() <= 1e-6 * thr.abs()
            check(torch.equal(g & ~near, w & ~near),
                  f'ERS mask differs from plain away from the threshold at '
                  f'B={b}')
            flips += int((g != w).sum())
        log(f'train kernels: ers_select B={b} N={n} cap={cap} cls rows '
            f'{int(got[0].sum())}, largest reg count {int(got[3].max())}; '
            f'lists exact, mask flips within 1e-6*|thr| of the threshold: '
            f'{flips}')
        check(bool((got[3] > 0).all()), 'ERS check selected nothing')
        check(torch.equal(got[3].long(), got[2].sum(-1)),
              f'ERS count differs from its mask\'s sum at B={b}')

        dec_err = 0.0
        for k in (fast_k, cap):
            _, ri, kept, _, nargs = ers_nms(case, k)
            dec = integral_decode(case['t_reg'], ri, centers, unit, None)
            dec_want = integral_decode_plain(case['t_reg'], ri, centers,
                                             unit, None)
            err = (dec - dec_want).abs()
            dec_err = max(dec_err, float(err.max()))
            check(bool((err <= 1e-4 + 1e-5 * dec_want.abs()).all()),
                  f'no-clip decode disagrees with plain at B={b} K={k}')
            check(k == fast_k or bool((dec_want < 0).any()),
                  'no-clip decode check clipped nothing')
            mism = int((nms_sorted_keep(*nargs) !=
                        nms_sorted_keep_plain(*nargs)).sum())
            log(f'train kernels: ERS teacher rows B={b} K={k}: no-clip '
                f'unit-stride decode max_abs_err={float(err.max()):.3e} '
                f'(tolerance 1e-4 + 1e-5*|box|); NMS iou=0.005 kept '
                f'{int(kept.sum())}, mismatches={mism} (exact)')
            check(mism == 0, f'NMS kernel disagrees with plain at B={b} '
                  f'K={k}')

        # the masks of the fast branch, which the path takes while every
        # image's reg count fits in fast_k (it does on this data)
        cm, _, kept, _, _ = ers_nms(case, fast_k)
        outs, grads = [], []
        for fn in (fused_erd_distill, fused_erd_distill, erd_distill_plain):
            sc, sr = with_grad(case)
            outs.append(torch.stack(distill_step(fn, case, sc, sr, cm,
                                                 kept)).detach())
            grads.append((sc.grad, sr.grad))
        del sc, sr
        dis_err = float((outs[0] - outs[2]).abs().max())
        dis_gerr = grad_ratio((grads[0], grads[2]))
        same = bool(torch.equal(outs[0], outs[1])) and all(
            torch.equal(x, y) for x, y in zip(grads[0], grads[1]))
        past_c = float(grads[0][0][..., OLD_CLASSES:].abs().max())
        log(f'train kernels: erd_distill B={b} rows cls {int(cm.sum())} '
            f'kept {int(kept.sum())}; summed losses '
            f'{outs[0].sum(-1).tolist()}; max_abs_err={dis_err:.3e} '
            f'(tolerance rtol 1e-4); gradient error / tolerance = '
            f'{dis_gerr:.3f}; gradient past column C largest {past_c}; two '
            f'calls bit-equal {same}')
        check(bool(((outs[0] - outs[2]).abs() <=
                    1e-4 * outs[2].abs()).all()),
              f'distillation kernel disagrees with plain at B={b}')
        check(dis_gerr <= 1.0, f'distillation backward disagrees with plain '
              f'at B={b}')
        check(bool((outs[0] > 0).all()), 'distillation check is zero')
        check(past_c == 0.0, f'distillation gradient past column C at B={b}')
        check(same, f'two distillation calls differ at B={b}')
        return dict(decode=dec_err, distill=dis_err), held

    # ---- checks at B = 2 and at the train step's B = 16
    errs = {}
    for b in (2, TRAIN_BATCH):
        case = train_case(np, torch, rs, ctx, b)
        got, held = check_case(case)
        for key, err in got.items():
            errs[key] = max(errs.get(key, 0.0), err)
    big = case

    # ---- timing at B = 16 (rows 6 and 3 timed by hold_loss_kernels; the
    # DCN train phase adds its steps' calls)
    b = TRAIN_BATCH
    at = held['atss']
    rows.append(dict(name='atss', route='cuda',
                     source='erd_tpu_torch/csrc/atss.cu',
                     replaces='erd_tpu/task/atss.py:46', max_abs_err=0.0,
                     ms=at['ms'], call_ms=at['call_ms'], ms_from='graph',
                     plain_ms=at['plain_ms'], bound_ms=at['bound_ms'],
                     bound_by=at['bound_by'], library_ms=None,
                     redesigned=True, design=ATSS_DESIGN,
                     train_calls=[at], per_step_ms={'erd': at['ms']}))

    def ers_call():
        return ers_select(big['t_cls'], big['t_reg'], cap)
    ms, call_ms, src, plain_ms = time_graph(
        torch, ers_call,
        lambda: ers_select_plain(big['t_cls'], big['t_reg'], cap))
    ers_kernels = kernel_ms(torch, ers_call, ERS_KERNELS, 10)
    bms, by = bound_of(*ers_cost(b, n, OLD_CLASSES, 68, cap))
    rows.append(dict(name='ers_select', route='cuda',
                     source='erd_tpu_torch/csrc/ers_select.cu',
                     replaces='erd_tpu/models/detectors/gfl_erd.py:96',
                     max_abs_err=0.0, ms=ms, call_ms=call_ms, ms_from=src,
                     kernels_ms=ers_kernels, plain_ms=plain_ms, bound_ms=bms,
                     bound_by=by, library_ms=None, redesigned=True,
                     design=ERS_DESIGN, per_step_ms={'erd': ms}))
    log(f'train kernels: B={b} ers_select {ms:.4f} ms (graph; its three '
        f'launches ' + ('not measured' if ers_kernels is None else
                        f'{ers_kernels:.4f}') + f' by the profiler), '
        f'{call_ms:.4f} (events); plain {plain_ms:.3f}; bound {bms:.4f} '
        f'({by})')

    gl = held['gfl_loss']
    rows.append(dict(name='gfl_loss', route='cuda',
                     source='erd_tpu_torch/csrc/gfl_loss.cu',
                     replaces='erd_tpu/models/heads/gfl_head.py:211',
                     max_abs_err=gl['max_abs_err'], ms=gl['ms'],
                     call_ms=gl['call_ms'], ms_from=gl['ms_from'],
                     ms_per='forward + backward', plain_ms=gl['plain_ms'],
                     bound_ms=gl['bound_ms'], bound_by=gl['bound_by'],
                     library_ms=None, deterministic=True, redesigned=True,
                     design=GFL_LOSS_DESIGN, train_calls=[gl],
                     per_step_ms={'erd': gl['ms']}))

    cm, _, kept, count, _ = ers_nms(big, fast_k)
    sc, sr = with_grad(big)

    def distill_call(fn=fused_erd_distill):
        losses = fn(sc, sr, big['t_cls'], big['t_reg'], cm, kept)
        return losses, torch.autograd.grad(
            losses[0].sum() + losses[1].sum(), (sc, sr))

    def distill_forward():
        with torch.no_grad():
            return fused_erd_distill(sc, sr, big['t_cls'], big['t_reg'], cm,
                                     kept)
    call_ms = graph_ms(torch, distill_call, 10)
    fwd_ms = graph_ms(torch, distill_forward, 10)
    ms = kernel_ms(torch, distill_call, DISTILL_KERNELS, 10)
    plain_ms = events_ms(torch, lambda: distill_call(erd_distill_plain), 2)
    n_cm, n_kp = int(cm.sum()), int(kept.sum())
    n_s = int((cm | kept).sum())
    counts = (n_cm, n_kp, n_s)
    bms, by = bound_of(*erd_distill_cost(b, n, OLD_CLASSES, NUM_CLASSES, 68,
                                         *counts))
    slice_bms, _ = bound_of(*erd_distill_cost(b, n, OLD_CLASSES, OLD_CLASSES,
                                              68, *counts))
    rows.append(dict(name='erd_distill', route='cuda',
                     source='erd_tpu_torch/csrc/erd_distill.cu',
                     replaces='erd_tpu/models/detectors/gfl_erd.py:178',
                     max_abs_err=errs['distill'], ms=ms or call_ms,
                     ms_from='profiler' if ms else 'graph',
                     ms_per='forward + backward', call_ms=call_ms,
                     call_ms_from='graph, through autograd (the gradient of '
                     'the whole 80-wide map)', forward_ms=fwd_ms,
                     plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                     bound_40_wide_ms=slice_bms, library_ms=None,
                     deterministic=True, redesigned=True,
                     design=DISTILL_DESIGN,
                     per_step_ms={'erd': ms or call_ms}))
    log(f'train kernels: B={b} erd_distill forward + backward kernels '
        f'{ms or call_ms:.4f} ms ({"profiler" if ms else "graph"}); call '
        f'through autograd {call_ms:.4f} (graph), forward {fwd_ms:.4f} '
        f'(graph); plain {plain_ms:.3f}; bound {bms:.4f} ({by}; the '
        f'80-wide class gradient; {slice_bms:.4f} for a 40-wide one)')
    log(f'train kernels: B={b} ERS rows cls {n_cm}, kept {n_kp}, largest '
        f'reg count {int(count.max())}')
    del sc, sr

    # the decode and NMS on the ERS teacher rows at both branches' sizes
    # (their rows of the JSON line come from the serving phase; these are
    # the same kernels on the train path)
    extra, decode_shapes = {}, []
    for k in (fast_k, cap):
        _, ri, _, _, nargs = ers_nms(big, k)
        shape = decode_call(np, torch, f'train kernels: B={b} K={k}',
                            (big['t_reg'], ri, centers, unit, None))
        decode_shapes.append(shape)
        nms_ms = events_ms(torch, lambda: nms_sorted_keep(*nargs), 5)
        extra[k] = (shape['ms'], nms_ms)
        log(f'train kernels: B={b} K={k}: decode {shape["ms"]:.4f} ms '
            f'(graph), NMS {nms_ms:.4f} ms per call (events)')
    del big, case
    torch.cuda.empty_cache()
    log('train kernels: library_ms is null for all four: no single PyTorch '
        'call computes ATSS, the ERS selection, the fused GFL loss or the '
        'fused distillation')
    return rows, extra, dict(no_clip_err=errs['decode'],
                             shapes=decode_shapes)


def phase_train_reference(np, torch):
    """Full-width float32 ERD loss and student gradients, card (kernels)
    vs CPU (plain versions), on a small input; then two controls, each with
    a 1 % error planted in one kernel's backward, which must fail."""
    import copy

    import erd_tpu_torch.models.detectors.gfl_erd as gfl_erd_module
    import erd_tpu_torch.models.heads.gfl_head as gfl_head_module
    from erd_tpu_torch.apis import build_detector
    from erd_tpu_torch.config import Config
    from erd_tpu_torch.structures import ImageMeta, stack_to
    cfg = Config.fromfile(ERD_CONFIG)
    cfg.model.compute_dtype = 'float32'
    det = build_detector(cfg.model)
    teacher = det.init_teacher(seed=11, device='cpu')
    student = det.init_student_from_teacher(12, teacher, device='cpu')
    gen = torch.Generator().manual_seed(14)
    with torch.no_grad():  # diverge the student's head from the teacher
        for conv in (student.bbox_head.gfl_cls, student.bbox_head.gfl_reg):
            conv.weight.add_(0.01 * torch.randn(conv.weight.shape,
                                                generator=gen))
    rs = np.random.RandomState(13)
    h, w = 128, 192
    images = torch.from_numpy(rs.randint(0, 256, (2, h, w, 3), np.uint8))
    gt = synthetic_gt(np, torch, rs, 2, (h, w), device='cpu')
    names = [k for k, p in student.named_parameters() if p.requires_grad]
    parts = {'supervised': ('loss_cls', 'loss_bbox', 'loss_dfl'),
             'distillation': ('loss_dist_cls', 'loss_dist_bbox')}

    def run(dev, d=det, dtype=torch.float32):
        """Loss dict and, per part of the loss, the student's gradients."""
        s = copy.deepcopy(student).to(dev, dtype)
        t = copy.deepcopy(teacher).to(dev, dtype)
        batch = dict(images=images.to(dev), meta=stack_to(
            [ImageMeta.make((h, w), (h, w), (1.0, 1.0))] * 2, dev),
            gt=type(gt)(**{k: None if v is None else v.to(dev)
                           for k, v in vars(gt).items()}))
        losses = d.loss(s, batch, teacher=t)
        params = dict(s.named_parameters())
        grads = {}
        for i, (part, keys) in enumerate(parts.items()):
            gs = torch.autograd.grad(
                sum(losses[k] for k in keys), [params[k] for k in names],
                retain_graph=i + 1 < len(parts), allow_unused=True)
            grads[part] = {k: (torch.zeros_like(params[k]) if g is None
                               else g).double().cpu()
                           for k, g in zip(names, gs)}
        return ({k: float(v.detach()) for k, v in losses.items()}, grads)

    def ratio(a, b, keys):
        """||a - b|| / ||b|| over the named tensors together."""
        diff = torch.cat([(a[k] - b[k]).flatten() for k in keys])
        ref = torch.cat([b[k].flatten() for k in keys])
        return float(diff.norm() / ref.norm().clamp(min=1e-30))

    l_cpu, g_cpu = run('cpu')
    total_cpu = {k: sum(g_cpu[p][k] for p in parts) for k in names}

    def errors(l_dev, g_dev):
        """Every metric of the gate beside its limit."""
        total = {k: sum(g_dev[p][k] for p in parts) for k in names}
        per_tensor = sorted(((ratio(total, total_cpu, [k]),
                              float(total_cpu[k].norm()), k)
                             for k in names), reverse=True)
        return per_tensor, [
            ('loss', max(abs(l_dev[k] - l_cpu[k]) / max(abs(l_cpu[k]), 1e-12)
                         for k in l_cpu), 1e-3),
            ('whole gradient', ratio(total, total_cpu, names), 1e-3),
            *((f'{p} gradient', ratio(g_dev[p], g_cpu[p], names), 1e-3)
              for p in parts),
            ('per tensor', per_tensor[0][0], 1e-2)]

    def describe(metrics):
        return ', '.join(f'{name} {v:.2e} (limit {lim:g})'
                         for name, v, lim in metrics)

    l_gpu, g_gpu = run(DEV)
    per_tensor, metrics = errors(l_gpu, g_gpu)
    log(f'train reference: float32 ERD loss card {l_gpu}')
    log(f'train reference: float32 ERD loss CPU  {l_cpu}')
    log(f'train reference: card vs CPU, ||diff|| / ||g|| over all '
        f'{len(names)} trainable tensors: {describe(metrics)}; median ||g|| '
        f'of a tensor {sorted(e[1] for e in per_tensor)[len(names) // 2]:.3e}'
        f'; worst tensors:')
    for rel, norm, k in per_tensor[:5]:
        log(f'train reference:   {k}: ||diff||/||g|| {rel:.2e}, ||g|| '
            f'{norm:.3e}')
    check(all(np.isfinite(v) for v in l_gpu.values()), 'non-finite loss')
    check(l_cpu['loss_dist_cls'] > 0 and l_cpu['loss_dist_bbox'] > 0,
          'train reference: distillation is zero')
    check(all(np.isfinite(v) and v <= lim for _, v, lim in metrics),
          'the ERD loss or the student gradients on the card disagree with '
          'the CPU')
    grad_bisect(torch, det, run, ratio, names, parts, per_tensor, g_gpu,
                total_cpu)

    class PlantedError(torch.autograd.Function):
        """Identity forward; the backward scales the gradient by 1.01."""

        @staticmethod
        def forward(ctx, x):
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            return g * 1.01

    def planted(fn):
        return lambda *a, **kw: tuple(PlantedError.apply(o)
                                      for o in fn(*a, **kw))

    for module, name in ((gfl_head_module, 'fused_gfl_loss'),
                         (gfl_erd_module, 'fused_erd_distill')):
        kernel = getattr(module, name)
        setattr(module, name, planted(kernel))
        try:
            _, metrics = errors(*run(DEV))
        finally:
            setattr(module, name, kernel)
        tripped = [m for m, v, lim in metrics if not v <= lim]
        log(f'train reference: control, {name} backward x 1.01: '
            f'{describe(metrics)}; over the limit: {tripped}')
        check(tripped, f'the gate passes a 1 % error in the {name} backward')


def plain_stand_ins(torch):
    """Context: the ERD loss's kernel wrappers replaced by their plain
    versions where the loss looks them up (on CUDA tensors too)."""
    import contextlib
    import importlib
    swaps = [('erd_tpu_torch.models.heads.gfl_head', 'atss_assign',
              'erd_tpu_torch.task.atss', 'atss_assign_plain'),
             ('erd_tpu_torch.models.heads.gfl_head', 'fused_gfl_loss',
              'erd_tpu_torch.ops.gfl_loss', 'gfl_loss_plain'),
             ('erd_tpu_torch.models.detectors.gfl_erd', 'integral_decode',
              'erd_tpu_torch.ops.integral', 'integral_decode_plain'),
             ('erd_tpu_torch.models.detectors.gfl_erd', 'ers_select',
              'erd_tpu_torch.ops.ers_select', 'ers_select_plain'),
             ('erd_tpu_torch.models.detectors.gfl_erd', 'fused_erd_distill',
              'erd_tpu_torch.ops.erd_distill', 'erd_distill_plain'),
             ('erd_tpu_torch.ops.nms', 'nms_sorted_keep',
              'erd_tpu_torch.ops.nms', 'nms_sorted_keep_plain')]

    @contextlib.contextmanager
    def ctx():
        saved = []
        try:
            for mod, name, pmod, pname in swaps:
                m = importlib.import_module(mod)
                saved.append((m, name, getattr(m, name)))
                setattr(m, name, getattr(importlib.import_module(pmod),
                                         pname))
            yield
        finally:
            for m, name, fn in saved:
                setattr(m, name, fn)
    return ctx()


def grad_bisect(torch, det, run, ratio, names, parts, per_tensor, g_gpu,
                total_cpu):
    """ROADMAP section 3.2: the student gradients of the train reference in
    float64 on the card (network, FPN and head in float64; the ERD loss on
    their outputs rounded to float32, as the port casts them), once with
    the loss's kernels and once with their plain versions. For the tensors
    where card and CPU float32 differ most, and for backbone.layer3.1, which
    float32 side is nearer float64. Informational: no gate."""
    import dataclasses
    det64 = dataclasses.replace(det, compute_dtype=torch.float64)
    l64, g64 = run(DEV, det64, torch.float64)
    with plain_stand_ins(torch):
        l64p, g64p = run(DEV, det64, torch.float64)
    log(f'train bisect: float64 ERD loss card, kernels {l64}')
    log(f'train bisect: float64 ERD loss card, plain   {l64p}')

    def total(g):
        return {k: sum(g[p][k] for p in parts) for k in names}
    t_gpu, t64, t64p = total(g_gpu), total(g64), total(g64p)
    keys = [k for _, _, k in per_tensor[:6]]
    keys += [k for k in names if k.startswith('backbone.layer3.1.') and
             k not in keys]
    log(f'train bisect: whole gradient ||x - f64|| / ||f64||: card f32 '
        f'{ratio(t_gpu, t64, names):.2e}, CPU f32 '
        f'{ratio(total_cpu, t64, names):.2e}; f64 kernels vs f64 plain '
        f'{ratio(t64p, t64, names):.2e}; card f32 vs CPU f32 '
        f'{ratio(t_gpu, total_cpu, names):.2e}')
    rows = []
    for k in keys:
        card, cpu = ratio(t_gpu, t64, [k]), ratio(total_cpu, t64, [k])
        rows.append(dict(tensor=k, card_f32_vs_f64=card, cpu_f32_vs_f64=cpu,
                         card_vs_cpu=ratio(t_gpu, total_cpu, [k]),
                         f64_kernels_vs_plain=ratio(t64p, t64, [k])))
        log(f'train bisect:   {k}: card f32 vs f64 {card:.2e}, CPU f32 vs '
            f'f64 {cpu:.2e}, card vs CPU {rows[-1]["card_vs_cpu"]:.2e}, '
            f'f64 kernels vs plain {rows[-1]["f64_kernels_vs_plain"]:.2e}; '
            f'nearer: {"card" if card < cpu else "CPU"} by '
            f'{max(card, cpu) / max(min(card, cpu), 1e-30):.1f}x')
    return rows


class SyntheticLoader:
    """erd_tpu's loader protocol over seeded random batches made on the
    card: uint8 images 800x1344 (the image 800x1333 inside the canvas), or
    ``batch`` images of ``canvas`` with ``image`` inside, 1-12 gt boxes in
    MAX_GT padded slots with labels below ``num_labels``, distinct img_ids;
    with ``masks`` also 56x56 box-normalised gt crops (``gt_crops``)."""

    def __init__(self, np, torch, steps, seed=21,
                 num_labels=NUM_CLASSES - OLD_CLASSES, batch=TRAIN_BATCH,
                 canvas=TRAIN_CANVAS, image=TRAIN_IMAGE, masks=False):
        self.np, self.torch, self.steps, self.seed = np, torch, steps, seed
        self.num_labels, self.masks = num_labels, masks
        self.canvas, self.image = canvas, image
        self.cfg = type('LoaderConfig', (), {'batch_size': batch})()

    def steps_per_epoch(self, epoch):
        return self.steps

    def epoch(self, epoch):
        import dataclasses

        from erd_tpu_torch.structures import ImageMeta, stack_to
        np, torch = self.np, self.torch
        b = self.cfg.batch_size
        rs = np.random.RandomState(self.seed + epoch)
        gen = torch.Generator(device=DEV).manual_seed(self.seed + epoch)
        for step in range(self.steps):
            meta = stack_to([ImageMeta.make(
                self.image, self.image, (1.0, 1.0),
                img_id=(epoch * self.steps + step) * b + i)
                for i in range(b)], DEV)
            images = torch.randint(0, 256, (b,) + tuple(self.canvas) + (3,),
                                   dtype=torch.uint8, device=DEV,
                                   generator=gen)
            gt = synthetic_gt(np, torch, rs, b, self.image,
                              num_labels=self.num_labels)
            if self.masks:
                gt = dataclasses.replace(gt, masks=gt_crops(torch, gen, b))
            yield dict(images=images, meta=meta, gt=gt)


def gt_crops(torch, gen, b, res=56, device=None):
    """(b, MAX_GT, res, res) uint8 box-normalised gt crops made on the
    card (or ``device``, the generator's): a seeded ellipse in each slot,
    3 % of its cells flipped, as rasterised polygons look."""
    device = device or DEV

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand((b, MAX_GT, 1, 1), device=device,
                                           generator=gen)
    yy = torch.arange(res, device=device, dtype=torch.float32)[:, None] + 0.5
    xx = torch.arange(res, device=device, dtype=torch.float32)[None, :] + 0.5
    inside = ((yy - uniform(18, 38)) / uniform(10, 28)) ** 2 + \
        ((xx - uniform(18, 38)) / uniform(10, 28)) ** 2 <= 1.0
    noise = torch.rand((b, MAX_GT, res, res), device=device,
                       generator=gen) < 0.03
    return (inside ^ noise).to(torch.uint8)


def phase_train(np, torch, card):
    """build_trainer + fit of the ERD stage-2 GFL-R50 step at bs 16."""
    from erd_tpu_torch.apis import build_detector, build_trainer
    from erd_tpu_torch.config import Config
    from erd_tpu_torch.engine import batch_to, resnet_frozen_paths
    from erd_tpu_torch.models.detectors.gfl_erd import erd_distill_losses
    from erd_tpu_torch.models.heads.gfl_head import (flatten_levels,
                                                     gfl_loss, gfl_targets)
    from erd_tpu_torch.ops import integral_decode, nms_sorted_keep
    from erd_tpu_torch.ops.erd_distill import fused_erd_distill
    from erd_tpu_torch.ops.ers_select import ers_select
    from erd_tpu_torch.ops.gfl_loss import fused_gfl_loss
    from erd_tpu_torch.task import atss_assign

    cfg = Config.fromfile(ERD_CONFIG)
    det = build_detector(cfg.model)
    check(type(det).__name__ == 'ERDDetector' and det.depth == 50 and
          det.num_classes == NUM_CLASSES and
          det.erd.ori_num_classes == OLD_CLASSES and
          det.compute_dtype == torch.bfloat16 and det.reg_max == 16,
          'not the ERD stage-2 GFL-R50 bf16 model')
    teacher = det.init_teacher(seed=1, device=DEV)
    student = det.init_student_from_teacher(2, teacher, device=DEV)
    frozen = resnet_frozen_paths(cfg.model.get('frozen_stages', 1))
    start = {k: v.clone() for k, v in student.state_dict().items()}
    teacher_start = {k: v.clone() for k, v in teacher.state_dict().items()}

    timer = step_timer(torch)
    cfg.train_cfg.epochs = 1
    loader = SyntheticLoader(np, torch, TRAIN_WARMUP + TRAIN_TIMED)
    trainer = build_trainer(cfg, det, loader, teacher=teacher, device=DEV)
    trainer.hooks.append(timer)
    counters = {'atss': atss_assign, 'gfl_loss': fused_gfl_loss,
                'ers_select': ers_select, 'erd_distill': fused_erd_distill,
                'nms_keep': nms_sorted_keep,
                'integral_decode': integral_decode}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    trainer.fit(student)
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f'train: launches on the train path {launches}')
    for name, count in launches.items():
        check(count > 0, f'kernel {name} was not launched by the train path')

    steps = [t1 - t0 for t0, t1 in zip(timer.t, timer.t[1:])]
    timed = steps[TRAIN_WARMUP:]
    ips = TRAIN_BATCH * len(timed) / sum(timed)
    for i, (dt, losses) in enumerate(zip(steps, timer.losses)):
        log(f'train: step {i} {1e3 * dt:.1f} ms lr '
            f'{trainer.current_lr(i):.3e} ' +
            ' '.join(f'{k} {v:.5f}' for k, v in losses.items()))
        check(all(np.isfinite(v) for v in losses.values()),
              f'train: non-finite loss at step {i}')
        # step 0: the student widened from its teacher computes the
        # teacher's outputs on the old classes, so both terms are 0; from
        # the first update on they must not be
        check(i == 0 or (losses['loss_dist_cls'] > 0 and
                         losses['loss_dist_bbox'] > 0),
              f'train: distillation is zero at step {i}')

    state = student.state_dict()
    trainable = {n for n, p in student.named_parameters() if p.requires_grad}
    moved = {k for k, v in state.items() if not torch.equal(v, start[k])}
    check(not any(k.startswith(frozen) for k in moved),
          'train: a frozen-stage parameter changed')
    check(not any(k.startswith(frozen) for k in trainable),
          'train: a frozen-stage parameter is trainable')
    check(all(torch.equal(v, teacher_start[k])
              for k, v in teacher.state_dict().items()),
          'train: the teacher changed')
    weights = {k for k in trainable if state[k].dim() > 1}
    check(weights <= moved, 'train: a trainable weight did not move: ' +
          ', '.join(sorted(weights - moved)[:5]))
    log(f'train: {len(moved & trainable)}/{len(trainable)} trainable '
        f'tensors moved (every one of 2+ dims must; a norm scale may move '
        f'less than one float32 ulp at warm-up lr), 0 frozen or teacher '
        f'tensors changed')
    log(f'train: bs {TRAIN_BATCH} {TRAIN_CANVAS[0]}x{TRAIN_CANVAS[1]} bf16, '
        f'{len(timed)} timed steps ' +
        ' '.join(f'{1e3 * t:.1f}' for t in timed) +
        f' ms; {ips:.2f} img/s; peak memory {peak / 2**20:.0f} MiB; '
        f'card {card}')

    # stage times of one step, each ended by a synchronize
    batch = batch_to(next(iter(loader.epoch(1))), DEV)
    erd = det.erd
    stages = []

    def mark(name):
        torch.cuda.synchronize()
        stages.append((name, time.perf_counter()))

    opt = trainer.optimizer
    opt.zero_grad(set_to_none=True)
    mark('start')
    images = batch['images']
    ctx = det.anchor_context(images.shape[1:3])
    t_cls_lvl, t_reg_lvl = det.teacher.forward_raw(teacher, images)
    t_cls = flatten_levels(t_cls_lvl).float()
    t_reg = flatten_levels(t_reg_lvl).float()
    mark('teacher forward')
    s_cls_lvl, s_reg_lvl = det.forward_train(student, images)
    s_cls = flatten_levels(s_cls_lvl).float()
    s_reg = flatten_levels(s_reg_lvl).float()
    mark('student forward')
    targets = gfl_targets(ctx, batch['gt'], batch['meta'].img_shape,
                          NUM_CLASSES - OLD_CLASSES)
    mark('targets (ATSS)')
    losses = gfl_loss(ctx, s_cls[..., OLD_CLASSES:], s_reg, targets,
                      det.train_cfg)
    mark('GFL loss')
    l_cls, l_reg = erd_distill_losses(ctx.device_anchors(DEV), s_cls,
                                      s_reg, t_cls, t_reg, erd)
    total = sum(losses.values()) + l_cls.sum() + l_reg.sum()
    mark('distillation (ERS, decode, NMS, L2 + KD)')
    total.backward()
    mark('backward')
    opt.step()
    mark('optimizer')
    branch = erd_distill_losses.last_branch
    log(f'train: largest ERS reg selection of the step '
        f'{branch["selected"]}: the NMS ran on K = {branch["nms_k"]} '
        f'candidates per image')
    log('train: stage ms of one step: ' + ', '.join(
        f'{name} {1e3 * (t - stages[i][1]):.2f}'
        for i, (name, t) in enumerate(stages[1:])) +
        f'; total {1e3 * (stages[-1][1] - stages[0][1]):.2f}')
    del t_cls, t_reg, s_cls, s_reg, losses, total, l_cls, l_reg

    profile_train_step(torch, lambda: trainer.train_step(student, batch, 100),
                       'train', top=15)
    return launches


def request_batch(np, torch, hw, scale=(1333, 800)):
    """One seeded RGB image of (H, W) through the test pipeline at
    ``scale``: (batch on the card, the image)."""
    from erd_tpu_torch.data import DetPipeline, ImageRecord
    from erd_tpu_torch.structures import stack_to
    img = request_images(np)[REQUESTS.index(hw)]
    rec = ImageRecord(0, '', hw[1], hw[0], np.zeros((0, 4), np.float32),
                      np.zeros((0,), np.int32), np.zeros((0,), bool))
    canvas, _, meta = DetPipeline(scale=scale)(rec, image=img)
    return dict(images=torch.from_numpy(canvas[None]).to(DEV),
                meta=stack_to([meta], DEV)), img


def arrange_fc_cls(torch, det, net, batch):
    """Seeded fc_cls weights: N(0, 1) scaled so that the class logits of
    one request's RoIs have std FC_CLS_STD, and a bias of FC_CLS_BOOST on
    FC_CLS_BOOSTED seeded classes (0 elsewhere and on the background).
    Each RoI then has several classes above score_thr, with distinct
    scores; with the init's N(0, 0.01) every class scores ~1/81 <
    score_thr and no candidate would reach the NMS."""
    fc = net.roi_head.bbox_head.fc_cls
    seen = []
    hook = fc.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    det.predict(net, batch)
    hook.remove()
    gen = torch.Generator().manual_seed(FC_CLS_SEED)
    w = torch.randn(fc.weight.shape, generator=gen).to(fc.weight.device)
    boosted = torch.randperm(NUM_CLASSES, generator=gen)[:FC_CLS_BOOSTED]
    std = float((seen[0].float() @ w.T).std())
    with torch.no_grad():
        fc.weight.copy_(w * (FC_CLS_STD / std))
        fc.bias.zero_()
        fc.bias[boosted.to(fc.bias.device)] = FC_CLS_BOOST


def capture(module, name, calls):
    """Replace ``module.name`` by a wrapper that records its arguments and
    calls the function. The function counts its launch on the module
    attribute it is bound to, now the wrapper, so captured calls are kept
    out of the main path's counts. Returns the restore function."""
    fn = getattr(module, name)

    def wrapper(*args):
        calls.append(args)
        return fn(*args)
    wrapper.launches = 0
    setattr(module, name, wrapper)
    return lambda: setattr(module, name, fn)


def roi_align_bytes(torch, feats, rois, levels, out_size=7):
    """Bytes RoIAlign must read from the maps for these RoIs, over the
    batch: the distinct pixels the in-range samples of an image's RoIs
    touch, image by image, times the channels and the element size."""
    from erd_tpu_torch.ops.roi_align import _sample_axis
    total = 0
    c, esize = feats[0].shape[1], feats[0].element_size()
    for img in range(rois.shape[0]):
        for lvl, (f, stride) in enumerate(zip(feats, ROI_STRIDES)):
            r = rois[img][levels[img] == lvl]
            h, w = f.shape[2:]
            lo = r * (1.0 / stride) - 0.5
            size = (lo[:, 2:] - lo[:, :2]).clamp(min=1e-6) / \
                torch.full_like(lo[:, :2], out_size)
            in_y, y0, y1, _ = _sample_axis(lo[:, 1], size[:, 1], h,
                                           out_size, 2)
            in_x, x0, x1, _ = _sample_axis(lo[:, 0], size[:, 0], w,
                                           out_size, 2)
            hit = torch.zeros(h * w, dtype=torch.bool, device=f.device)
            ok = in_y[:, :, None] & in_x[:, None, :]
            for ya in (y0, y1):
                for xa in (x0, x1):
                    hit[(ya[:, :, None] * w + xa[:, None, :])[ok]] = True
            total += int(hit.sum()) * c * esize
    return total


def roi_align_cost(torch, feats, rois, levels, out_size=7, ratio=2):
    """(bytes, float32 operations) of one RoIAlign call: the map pixels
    its samples touch (``roi_align_bytes``), the RoIs and levels read, the
    float32 output written; per output ratio^2 samples of 8 multiplies and
    3 adds, ratio^2 - 1 adds of them and one divide (the sample
    coordinates are per RoI and bin)."""
    b, r = levels.shape
    outs = b * r * feats[0].shape[1] * out_size * out_size
    nbytes = roi_align_bytes(torch, feats, rois, levels, out_size) + \
        b * r * (16 + 4) + outs * 4
    return nbytes, outs * 12.0 * ratio * ratio


def serve_edge_rois(torch, w, h):
    """The 10 edge-case boxes that replace the last RoI slots of a serving
    call's check on a (h, w) canvas: off the image, degenerate, zero, on
    the last row or column, and boxes sized for levels 2 and 3, which
    random weights' proposals hardly reach."""
    return torch.tensor([
        [-60, -40, -2, -1], [w + 5, 0, w + 90, 40], [10, 10, 10, 10],
        [0, 0, 0, 0], [30, 5, 29, 60], [w - 8, h - 8, w + 4, h + 4],
        [w - 4, 0, w, h], [0, h - 4, w, h], [-9, -9, 600, 500],
        [100, 100, 400, 400]], dtype=torch.float32, device=DEV)


def phase_frcnn_kernels(np, torch, floor=None):
    """RoIAlign, soft-NMS and the NMS at Faster R-CNN's sizes, on the
    arguments one 800x1333 request hands them, against their plain
    versions; then timed (soft-NMS beside its latency floor, built from
    ``floor``, a start_soft_nms_floor_build handle, started here if
    None)."""
    import importlib

    from erd_tpu_torch.apis import build_detector, init_detector
    from erd_tpu_torch.config import Config
    from erd_tpu_torch.ops import (map_roi_levels, nms_sorted_keep,
                                   nms_sorted_keep_plain, roi_align,
                                   roi_align_plain, soft_nms,
                                   soft_nms_plain)
    nms_module = importlib.import_module('erd_tpu_torch.ops.nms')
    roi_module = importlib.import_module('erd_tpu_torch.ops.roi_align')

    det, net, _ = init_detector(FRCNN_CONFIGS['nms'], device=DEV)
    check(type(det).__name__ == 'FasterRCNNDetector' and det.depth == 50 and
          det.num_classes == NUM_CLASSES and
          det.compute_dtype == torch.bfloat16,
          'not the Faster R-CNN R50 bf16 model')
    batch, _ = request_batch(np, torch, REQUESTS[-1])
    arrange_fc_cls(torch, det, net, batch)
    roi_calls, nms_calls, soft_calls = [], [], []
    restore = [capture(roi_module, 'roi_align', roi_calls),
               capture(nms_module, 'nms_sorted_keep', nms_calls)]
    try:
        det.predict(net, batch)
        det.test_cfg = build_detector(Config.fromfile(
            FRCNN_CONFIGS['soft_nms']).model).test_cfg
        restore.append(capture(nms_module, 'soft_nms', soft_calls))
        det.predict(net, batch)
    finally:
        for undo in restore:
            undo()
    torch.cuda.synchronize()
    check(len(roi_calls) == 2 and len(nms_calls) == 3 and
          len(soft_calls) == 1, 'unexpected kernel calls of one request')
    rows, nms_by_k = [], {}

    # -- RoIAlign: the 1000 proposals, the last 10 slots replaced by edge
    # cases (off-image, degenerate, zero, last row / column) and boxes of
    # levels 2 and 3, which random weights' proposals hardly reach
    feats, rois, _, strides = roi_calls[0][:4]
    rois = rois.clone()
    h, w = batch['images'].shape[1:3]
    rois[0, -10:] = serve_edge_rois(torch, w, h)
    levels = map_roi_levels(rois, 4).contiguous()
    cpu_levels = map_roi_levels(rois.cpu(), 4)
    check(torch.equal(levels.cpu(), cpu_levels),
          'RoI levels differ between card and CPU')
    got = roi_align(feats, rois, levels, strides)
    torch.cuda.synchronize()
    want = roi_align_plain(feats, rois, levels, strides)
    feat_max = max(float(f.float().abs().max()) for f in feats)
    roi_err = float((got - want).abs().max())
    per_level = torch.bincount(levels.flatten().long(), minlength=4)
    log(f'frcnn kernels: roi_align R={rois.shape[1]} C={feats[0].shape[1]} '
        f'{feats[0].dtype} levels {per_level.tolist()} sizes '
        f'{[tuple(f.shape[2:]) for f in feats]}: max_abs_err={roi_err:.3e} '
        f'(limit 1e-6*max|feat| = {1e-6 * feat_max:.3e})')
    check(roi_err <= 1e-6 * feat_max, 'RoIAlign kernel disagrees with plain')
    check(bool((per_level > 0).all()), 'RoIAlign check missed a level')
    args = (feats, rois, levels, strides)
    ms, call_ms, src, plain_ms = time_graph(
        torch, lambda: roi_align(*args), lambda: roi_align_plain(*args))
    bms, by = bound_of(*roi_align_cost(torch, feats, rois, levels))
    rows.append(dict(name='roi_align', route='cuda',
                     source='erd_tpu_torch/csrc/roi_align.cu',
                     replaces='erd_tpu/ops/roi_align.py:92',
                     max_abs_err=roi_err, ms=ms, call_ms=call_ms,
                     ms_from=src, plain_ms=plain_ms, bound_ms=bms,
                     bound_by=by, library_ms=None))

    # -- soft-NMS on the captured call, linear (the config) and gaussian
    sboxes, scores, steps = soft_calls[0][:3]
    k = sboxes.shape[1]
    check(k == 2000 and steps == 100, f'soft-NMS call at K={k}, '
          f'{steps} steps, expected 2000 and 100')
    for method in ('linear', 'gaussian'):
        gi, gs = soft_nms(sboxes, scores, steps, 0.5, 0.5, 1e-3, method)
        torch.cuda.synchronize()
        wi, ws = soft_nms_plain(sboxes, scores, steps, 0.5, 0.5, 1e-3,
                                method)
        # compared up to the first step whose selection differs (none, or
        # a tie of two decayed scores to 1e-6, for the gaussian decay)
        same = (gi == wi)[0]
        first = steps if bool(same.all()) else int((~same).int().argmax())
        upto = slice(0, min(first + 1, steps))
        live = ws[0, upto] > float('-inf')
        rel = float(((gs[0, upto] - ws[0, upto]).abs() /
                     ws[0, upto].abs())[live].max())
        log(f'frcnn kernels: soft_nms {method} K={k} steps={steps} kept '
            f'{int((ws >= 1e-3).sum())}: selections equal over '
            f'{first} of {steps} steps, scores bit-equal '
            f'{torch.equal(gs, ws)}, max rel err {rel:.2e}')
        if method == 'linear':
            check(first == steps and torch.equal(gs, ws),
                  'linear soft-NMS kernel is not bit-exact with plain')
        else:
            check(rel <= 1e-6, 'gaussian soft-NMS scores differ > 1e-6 '
                  'relative, or selections differ without a tie')
    sargs = (sboxes, scores, steps, 0.5, 0.5, 1e-3, 'linear')
    ms, call_ms, src, plain_ms = time_graph(
        torch, lambda: soft_nms(*sargs), lambda: soft_nms_plain(*sargs),
        n=20)
    prof_ms = profiled_ms(torch, lambda: soft_nms(*sargs),
                          SOFT_NMS_KERNELS, 20, 'frcnn kernels: soft_nms')
    live, exhausted = soft_nms_stats(torch, sargs, soft_nms(*sargs)[1])
    bms, by = bound_of(*soft_nms_cost(sargs, live, exhausted))
    floor_ms = soft_nms_floor_ms(torch, soft_nms_floor_lib(
        floor or start_soft_nms_floor_build()), sargs, 1)
    log(f'frcnn kernels: soft_nms K={k} ({live} live, nothing live from '
        f'step {exhausted}): {ms:.4f} ms device ({src}; profiler '
        f'{prof_ms:.4f}), {call_ms:.4f} ms per call, plain {plain_ms:.3f} '
        f'ms, bound {bms:.6f} ms ({by}); latency floor ({steps} empty '
        f'steps, one block) {floor_ms:.4f} ms')
    rows.append(dict(name='soft_nms', route='cuda',
                     source='erd_tpu_torch/csrc/soft_nms.cu',
                     replaces='erd_tpu/ops/nms.py:170', max_abs_err=0.0,
                     ms=ms, call_ms=call_ms, ms_from=src, plain_ms=plain_ms,
                     profiler_ms=prof_ms, bound_ms=bms, bound_by=by,
                     latency_floor_ms=floor_ms, live=live,
                     library_ms=None, redesigned=True,
                     design=SOFT_NMS_DESIGN))

    # -- the NMS kernel on the RPN call and the R-CNN call
    for nargs, want_k, want_thr in ((nms_calls[0], 4819, 0.7),
                                    (nms_calls[1], 2000, 0.5)):
        kk, thr = nargs[0].shape[1], nargs[3]
        check(kk == want_k and abs(thr - want_thr) < 1e-9,
              f'NMS call at K={kk}, IoU {thr}; expected {want_k}, {want_thr}')
        got = nms_sorted_keep(*nargs)
        torch.cuda.synchronize()
        mism = int((got != nms_sorted_keep_plain(*nargs)).sum())
        call_ms = events_ms(torch, lambda: nms_sorted_keep(*nargs), 20)
        dev_ms = kernel_ms(torch, lambda: nms_sorted_keep(*nargs),
                           ['nms_mask_kernel', 'nms_reduce_kernel'], 20)
        nms_by_k[kk] = dict(iou=thr, ms=dev_ms or call_ms, call_ms=call_ms,
                            valid=int(nargs[1].sum()), kept=int(got.sum()))
        log(f'frcnn kernels: nms K={kk} iou={thr} valid '
            f'{int(nargs[1].sum())} kept {int(got.sum())} mismatches={mism} '
            f'(exact); {nms_by_k[kk]["ms"]:.4f} ms device, {call_ms:.4f} ms '
            f'per call')
        check(mism == 0, f'NMS kernel disagrees with plain at K={kk}')
    log('frcnn kernels: library_ms is null for both: no single PyTorch call '
        'computes multi-level RoIAlign or soft-NMS (no torchvision)')
    del roi_calls, nms_calls, soft_calls, feats, got, want, net
    torch.cuda.empty_cache()
    return rows, nms_by_k


def phase_frcnn_reference(np, torch):
    """Full-width float32 Faster R-CNN network (backbone, FPN, RPN, the
    head on zero RoIs), card vs CPU, on one small input."""
    import copy

    from erd_tpu_torch.apis import build_detector
    from erd_tpu_torch.config import Config
    cfg = Config.fromfile(FRCNN_CONFIGS['nms'])
    cfg.model.compute_dtype = 'float32'
    det = build_detector(cfg.model)
    net_cpu = det.init(seed=1, device='cpu')
    net_gpu = copy.deepcopy(net_cpu).to(DEV)
    img = np.random.RandomState(2).randint(0, 256, (1, 128, 192, 3),
                                           np.uint8)
    (w_cls, w_reg), w_head = det.forward_raw(net_cpu, torch.from_numpy(img))
    (g_cls, g_reg), g_head = det.forward_raw(net_gpu,
                                             torch.from_numpy(img).to(DEV))
    worst = 0.0
    for g, w in zip(g_cls + g_reg + list(g_head), w_cls + w_reg +
                    list(w_head)):
        check(tuple(g.shape) == tuple(w.shape), 'reference shape mismatch')
        worst = max(worst, float((g.cpu() - w).abs().max() / w.abs().max()))
    log(f'frcnn reference: float32 network card vs CPU, max |diff| / max '
        f'|out| = {worst:.2e} (tolerance 1e-3)')
    check(worst <= 1e-3, 'float32 Faster R-CNN on the card disagrees with '
          'the CPU')


def phase_frcnn_serve(np, torch, card):
    """init_detector / inference_detector of both Faster R-CNN configs on
    the 4 requests; stage times, idle share, card-vs-CPU post-processing."""
    from erd_tpu_torch.apis import init_detector
    from erd_tpu_torch.data import DetPipeline
    from erd_tpu_torch.ops import nms_sorted_keep, roi_align, soft_nms

    phase_frcnn_reference(np, torch)
    images = request_images(np)
    counters = {'roi_align': roi_align, 'nms_keep': nms_sorted_keep,
                'soft_nms': soft_nms}
    launches = {k: 0 for k in counters}
    for kind, path in FRCNN_CONFIGS.items():
        tag = f'frcnn serve {kind}'
        det, net, _ = init_detector(path, device=DEV)
        check(type(det).__name__ == 'FasterRCNNDetector' and
              det.test_cfg.nms_type == kind and
              det.compute_dtype == torch.bfloat16,
              f'{path} is not the Faster R-CNN bf16 model with {kind}')
        batch, _ = request_batch(np, torch, REQUESTS[-1])
        arrange_fc_cls(torch, det, net, batch)
        hard = kind == 'nms'  # the RPN's NMS, and the final one if hard
        want = {'roi_align': len(images),
                'nms_keep': len(images) * (2 if hard else 1),
                'soft_nms': 0 if hard else len(images)}
        results, counts = serve_requests(np, torch, det, net, images,
                                         counters, want, tag, card)
        for name, count in counts.items():
            launches[name] += count

        pipe = DetPipeline()
        for i, (img, res) in enumerate(zip(images, results)):
            req = ServedRequest(np, torch, pipe, i, img)
            feats, rpn_cls, rpn_reg = det.feats_and_rpn(net, req.images)
            req.mark()
            ctx = det.anchor_context(req.images.shape[1:3])
            rois, _, roi_mask = det.proposals(ctx, rpn_cls, rpn_reg,
                                              req.meta_dev)
            req.mark()
            roi_feats = det.roi_feats(feats, rois)
            req.mark()
            cls, reg = det.roi_forward(net, roi_feats)
            req.mark()
            gpu = det.postprocess(cls, reg, rois, roi_mask, req.meta_dev)
            req.mark()
            req.log_stages(tag, ('network', 'RPN proposals', 'RoIAlign',
                                 'head', 'post-processing'))
            cpu = det.postprocess(cls.cpu(), reg.cpu(), rois.cpu(),
                                  roi_mask.cpu(), req.meta_cpu)
            req.compare(tag, gpu, cpu, len(res.scores),
                        f'proposals {int(roi_mask.sum())} ',
                        min_candidates=2000)
            del feats, roi_feats
        del det, net
        torch.cuda.empty_cache()
    return launches


def check_detr_model(torch, det, kind):
    want = {'dino': ('DINODetector', 900, 300),
            'deformable_detr': ('DeformableDETRDetector', 300, 100)}[kind]
    check(type(det).__name__ == want[0] and det.depth == 50 and
          det.num_classes == NUM_CLASSES and
          (det.num_queries, det.max_per_img) == want[1:] and
          det.compute_dtype == torch.bfloat16,
          f'not the {kind} R50 bf16 model with {want[1]} queries and '
          f'{want[2]} detections')


def sample_stats(torch, shapes, locs):
    """(samples, with a fractional bilinear weight, with a corner outside
    its map) of one sampling call, in the kernel's coordinates."""
    total = frac = out = 0
    for lvl, (h, w) in enumerate(shapes):
        loc = locs[:, :, :, lvl]
        xs = loc[..., 0] * w - 0.5
        ys = loc[..., 1] * h - 0.5
        x0, y0 = torch.floor(xs), torch.floor(ys)
        total += xs.numel()
        frac += int(((xs != x0) | (ys != y0)).sum())
        out += int(((x0 < 0) | (x0 + 1 > w - 1) | (y0 < 0) |
                    (y0 + 1 > h - 1)).sum())
    return total, frac, out


def deform_attn_cost(torch, shapes, values, locs, weights):
    """(bytes, operations) of one sampling call. Bytes: the distinct
    (batch, token, head) value rows that its in-range corners touch, hd
    floats each (at most the whole value tensor; a decoder call touches
    fewer), the locations and weights read once, the output written once.
    Operations: per sample 4 corner terms (2 multiplies each), 3 adds, the
    weight's multiply and add per channel, and ~10 operations of
    coordinates."""
    from erd_tpu_torch.ops.ms_deform_attn import make_level_start_index
    b, q, heads, levels, points, _ = locs.shape
    n_tok, hd = values.shape[1], values.shape[3]
    starts = make_level_start_index(shapes)
    dev = locs.device
    hit = torch.zeros(b * n_tok * heads, dtype=torch.bool, device=dev)
    bidx = torch.arange(b, device=dev)[:, None, None, None]
    hidx = torch.arange(heads, device=dev)[None, None, :, None]
    for lvl, (h, w) in enumerate(shapes):
        loc = locs[:, :, :, lvl]  # (B, Q, heads, K, 2)
        x0 = torch.floor(loc[..., 0] * w - 0.5).long()
        y0 = torch.floor(loc[..., 1] * h - 0.5).long()
        for yy in (y0, y0 + 1):
            for xx in (x0, x0 + 1):
                ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                row = (bidx * n_tok + int(starts[lvl]) + yy * w + xx) * \
                    heads + hidx
                hit[row[ok]] = True
    samples = b * q * heads * levels * points
    nbytes = (int(hit.sum()) * hd * values.element_size() +
              locs.numel() * locs.element_size() +
              weights.numel() * weights.element_size() + b * q * heads * hd * 4)
    return nbytes, samples * (13.0 * hd + 10)


def phase_detr_kernels(np, torch):
    """The sampling kernel on every call of one 800x1333 request of each
    DETR config (6 encoder calls at Q = 22323 tokens; 6 decoder calls at
    Q = 900 for DINO, at Q = 300 with point references and decoder_0's bf16
    weights for Deformable DETR), with arranged sampling weights, against
    its plain version; then timed at the three call shapes."""
    import importlib

    from erd_tpu_torch.apis import init_detector
    from erd_tpu_torch.models.heads import arrange_sampling
    from erd_tpu_torch.ops import ms_deform_attn, ms_deform_attn_plain
    head_module = importlib.import_module(
        'erd_tpu_torch.models.heads.deformable_detr_head')

    batch, _ = request_batch(np, torch, REQUESTS[-1])
    worst, stats, timed_calls = 0.0, {}, {}
    for kind, path in DETR_CONFIGS.items():
        det, net, _ = init_detector(path, device=DEV)
        check_detr_model(torch, det, kind)
        arrange_sampling(net, DETR_ARRANGE_SEED)
        calls = []
        restore = capture(head_module, 'ms_deform_attn', calls)
        try:
            det.predict(net, batch)
        finally:
            restore()
        torch.cuda.synchronize()
        n_tok = calls[0][0].shape[1]
        qs = [c[2].shape[1] for c in calls]
        check(qs == [n_tok] * 6 + [min(det.num_queries, n_tok)] * 6,
              f'{kind}: sampling calls of one request at Q = {qs}')
        bf16 = [i for i, c in enumerate(calls)
                if c[3].dtype == torch.bfloat16]
        log(f'detr kernels: {kind}: calls with bf16 attention weights '
            f'{bf16}')
        if kind == 'deformable_detr':
            check(bf16 == [6], 'deformable_detr: decoder_0 should carry bf16 '
                  'attention weights, the other calls float32')
        for i, args in enumerate(calls):
            got = ms_deform_attn(*args)
            torch.cuda.synchronize()
            want = ms_deform_attn_plain(*args)
            err = float((got - want).abs().max())
            limit = 1e-6 * float(args[0].abs().max())
            part = 'encoder' if i < 6 else 'decoder'
            counts = stats.setdefault(f'{kind} {part}', [0, 0, 0])
            for j, v in enumerate(sample_stats(torch, args[1], args[2])):
                counts[j] += v
            log(f'detr kernels: {kind} ms_deform_attn {part} call {i % 6} '
                f'Q={qs[i]} levels {args[1]} weights {args[3].dtype}: '
                f'max_abs_err={err:.3e} (limit 1e-6*max|v| = {limit:.3e})')
            check(err <= limit and torch.equal(got, want), f'{kind}: '
                  f'sampling kernel not bit-equal to plain on call {i}')
            worst = max(worst, err)
        if kind == 'dino':
            timed_calls['encoder'] = calls[0]
        timed_calls[f'{kind} decoder'] = calls[6]
        del det, net, calls
        torch.cuda.empty_cache()
    total = [sum(v[j] for v in stats.values()) for j in range(3)]
    for part, (n, frac, out) in list(stats.items()) + [('all', total)]:
        log(f'detr kernels: {part} samples {n}: fractional bilinear weight '
            f'{frac / n:.4f}, a corner outside its map {out / n:.4f}')
    check(total[1] >= 0.5 * total[0], 'fewer than 50 % of the samples have '
          'a fractional bilinear weight: the interpolation goes unchecked')
    check(total[2] >= 0.01 * total[0], 'fewer than 1 % of the samples reach '
          'outside their map: the zero padding goes unchecked')

    timed = {}
    for name, args in timed_calls.items():
        # device ms by graph replays: the profiler drops this kernel's
        # records (it read 0.127 ms for a 0.158 ms encoder call)
        ms, call_ms, src, plain_ms = time_graph(
            torch, lambda: ms_deform_attn(*args),
            lambda: ms_deform_attn_plain(*args), n=20)
        values, shapes, locs, weights = args
        nbytes, ops = deform_attn_cost(torch, shapes, values, locs, weights)
        bms, by = bound_of(nbytes, ops)
        timed[name] = dict(q=args[2].shape[1], ms=ms, call_ms=call_ms,
                           ms_from=src, plain_ms=plain_ms, bound_ms=bms,
                           bound_by=by, bound_bytes=nbytes)
        log(f'detr kernels: ms_deform_attn {name} Q={args[2].shape[1]}: '
            f'{ms:.4f} ms device ({src}), {call_ms:.4f} ms per call, plain '
            f'{plain_ms:.3f} ms, bound {bms:.4f} ms ({by}; {nbytes} bytes '
            f'of distinct value rows, locations, weights and output)')
    log('detr kernels: library_ms is null: no single PyTorch call computes '
        'multi-scale deformable attention (F.grid_sample interpolates one '
        'level and does not weight and sum the points)')
    enc = timed.pop('encoder')
    row = dict(name='ms_deform_attn', route='cuda',
               source='erd_tpu_torch/csrc/ms_deform_attn.cu',
               replaces='erd_tpu/ops/ms_deform_attn.py:18',
               max_abs_err=worst, ms=enc['ms'], call_ms=enc['call_ms'],
               ms_from=enc['ms_from'], ms_at=f'encoder call Q={enc["q"]}',
               plain_ms=enc['plain_ms'], bound_ms=enc['bound_ms'],
               bound_by=enc['bound_by'], library_ms=None,
               decoder_calls=timed,
               sample_share={'fractional': total[1] / total[0],
                             'outside': total[2] / total[0]})
    del timed_calls
    torch.cuda.empty_cache()
    return [row]


def phase_detr_reference(np, torch):
    """Both float32 DETR networks (the sampling weights arranged), card vs
    CPU, on one small input: the encoder memory, then the decoder outputs
    with the card's query selection fed to both sides."""
    import copy

    from erd_tpu_torch.apis import build_detector
    from erd_tpu_torch.config import Config
    from erd_tpu_torch.models.heads import arrange_sampling
    from erd_tpu_torch.ops.misc import take_rows
    img = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (1, 128, 192, 3), np.uint8))
    for kind, path in DETR_CONFIGS.items():
        cfg = Config.fromfile(path)
        cfg.model.compute_dtype = 'float32'
        det = build_detector(cfg.model)
        net_cpu = det.init(seed=1, device='cpu')
        arrange_sampling(net_cpu, DETR_ARRANGE_SEED)
        net_dev = copy.deepcopy(net_cpu).to(DEV)
        out = {}
        for name, net in (('card', net_dev), ('cpu', net_cpu)):
            head = net.bbox_head
            with torch.no_grad():
                feats = det.extract_feat(net, img.to(next(
                    net.parameters()).device))
                memory, shapes = head.encode(feats)
                if kind == 'dino':
                    enc_cls, enc_boxes = head.proposals(memory, shapes)
                    if name == 'card':
                        idx = head.select(enc_cls)
                    idx = idx.to(memory.device)
                    dec = head.decode(memory, shapes, idx,
                                      take_rows(enc_boxes, idx))
                else:
                    dec = head.decode(memory, shapes)
            out[name] = [memory] + list(dec)
        rel = [float((g.cpu() - w).abs().max() / w.abs().max())
               for g, w in zip(out['card'], out['cpu'])]
        log(f'detr reference: {kind} float32 card vs CPU, max |diff| / max '
            f'|out|: encoder memory {rel[0]:.2e}, decoder classes '
            f'{rel[1]:.2e}, boxes {rel[2]:.2e} (tolerance 1e-3; tokens '
            f'{memory.shape[1]})')
        check(max(rel) <= 1e-3, f'float32 {kind} on the card disagrees with '
              f'the CPU')


def phase_detr_serve(np, torch, card):
    """init_detector / inference_detector of DINO and Deformable DETR on the
    4 requests, with arranged sampling weights: 12 kernel launches per
    request, every detection finite and inside its image, stage times, the
    idle share of one request, card-vs-CPU post-processing."""
    from erd_tpu_torch.apis import init_detector
    from erd_tpu_torch.data import DetPipeline
    from erd_tpu_torch.models.heads import arrange_sampling
    from erd_tpu_torch.ops import ms_deform_attn
    from erd_tpu_torch.ops.misc import take_rows

    images = request_images(np)
    launches = 0
    for kind, path in DETR_CONFIGS.items():
        tag = f'detr serve {kind}'
        det, net, _ = init_detector(path, device=DEV)
        check_detr_model(torch, det, kind)
        arrange_sampling(net, DETR_ARRANGE_SEED)
        results, counts = serve_requests(
            np, torch, det, net, images, {'ms_deform_attn': ms_deform_attn},
            {'ms_deform_attn': 12 * len(images)}, tag, card,
            num_ok=lambda n: n == det.max_per_img)
        launches += counts['ms_deform_attn']

        head = net.bbox_head
        pipe = DetPipeline()
        for i, (img, res) in enumerate(zip(images, results)):
            with torch.no_grad():
                req = ServedRequest(np, torch, pipe, i, img)
                feats = det.extract_feat(net, req.images)
                req.mark()
                memory, shapes = head.encode(feats)
                req.mark()
                if kind == 'dino':
                    enc_cls, enc_boxes = head.proposals(memory, shapes)
                    idx = head.select(enc_cls)
                    init_ref = take_rows(enc_boxes, idx)
                    req.mark()
                    all_cls, all_boxes = head.decode(memory, shapes, idx,
                                                     init_ref)
                else:
                    req.mark()  # no query selection: learned queries
                    all_cls, all_boxes = head.decode(memory, shapes)
                req.mark()
                gpu = det.postprocess(all_cls, all_boxes,
                                      req.canvas.shape[:2], req.meta_dev)
                req.mark()
            req.log_stages(tag, ('backbone + neck', 'encoder',
                                 'query selection', 'decoder',
                                 'post-processing'))
            cpu = det.postprocess(all_cls.cpu(), all_boxes.cpu(),
                                  req.canvas.shape[:2], req.meta_cpu)
            req.compare(tag, gpu, cpu, len(res.scores),
                        f'tokens {memory.shape[1]} ')
            del feats, memory
        del det, net, head
        torch.cuda.empty_cache()
    return {'ms_deform_attn': launches}


def check_dcn_model(torch, det, kind):
    want = {'gfl_r101_dcn': ('GFLDetector', 101, False),
            'vfnet_r50_mdconv': ('VFNetDetector', 50, True)}[kind]
    check(type(det).__name__ == want[0] and det.depth == want[1] and
          det.dcn_modulated == want[2] and
          tuple(det.dcn_stages) == (False, True, True, True) and
          det.num_classes == NUM_CLASSES and
          det.compute_dtype == torch.bfloat16,
          f'not the {kind} bf16 model with DCN in C3-C5')


def dcn_net(torch, path, kind):
    """init_detector of a DCN config on the card, conv_offset arranged and
    the class bias zeroed (scores near 0.5: the NMS sees its 2000)."""
    from erd_tpu_torch.apis import init_detector
    from erd_tpu_torch.ops import arrange_offsets
    det, net, _ = init_detector(path, device=DEV)
    check_dcn_model(torch, det, kind)
    arrange_offsets(net, DCN_ARRANGE_SEED)
    cls = net.bbox_head.gfl_cls if kind == 'gfl_r101_dcn' else \
        net.bbox_head.vfnet_cls
    with torch.no_grad():
        cls.bias.zero_()
    return det, net


def dcn_sample_stats(torch, args):
    """(samples, with a fractional bilinear weight, with a corner outside
    its map) of one deformable im2col call, in the kernel's coordinates."""
    from erd_tpu_torch.ops.deform_conv import _base_grid
    x, offset, _, k, stride, pad, dil, dg = args
    b, _, h, w = x.shape
    ho, wo = offset.shape[2:]
    by, bx = _base_grid(ho, wo, k, stride, pad, dil, x.device)
    off = offset.reshape(b, dg, k * k, 2, ho, wo)
    ys, xs = by + off[:, :, :, 0], bx + off[:, :, :, 1]
    y0, x0 = torch.floor(ys), torch.floor(xs)
    frac = int(((ys != y0) | (xs != x0)).sum())
    out = int(((y0 < 0) | (y0 + 1 > h - 1) | (x0 < 0) |
               (x0 + 1 > w - 1)).sum())
    return ys.numel(), frac, out


def dcn_cost(args):
    """(bytes, operations) of one deformable im2col call. Bytes: the map,
    the offsets and masks read once, the float32 columns written once.
    Operations: per column element 4 corner terms (2 multiplies each) and
    3 adds, and the mask's multiply; per sample ~12 of coordinates."""
    x, offset, mask, k, _, _, _, _ = args
    b, cin = x.shape[:2]
    hw = offset.shape[2] * offset.shape[3]
    cols = b * cin * k * k * hw
    nbytes = (x.numel() * x.element_size() + offset.numel() * 4 +
              (0 if mask is None else mask.numel() * 4) + cols * 4)
    samples = offset.numel() // 2
    return nbytes, cols * (11.0 + (mask is not None)) + samples * 12.0


def grid_sample_inputs(torch, args):
    """One deformable im2col call's operands as F.grid_sample takes them:
    (the map widened to float32, (B*dg, Cin/dg, H, W); the grid, (B*dg,
    K*K*Ho, Wo, 2); the DCNv2 mask, (B*dg, 1, K*K*Ho, Wo), or None).
    Bilinear sampling with padding_mode 'zeros' drops each corner outside
    the map on its own, erd_tpu's rule. The grid holds the sample positions
    normalised for align_corners=False, one row per (kernel point, output
    row), the deform groups folded into the batch. The map is widened
    because grid_sample samples in the grid's dtype."""
    from erd_tpu_torch.ops.deform_conv import _base_grid
    x, offset, mask, k, stride, pad, dil, dg = args
    b, cin, h, w = x.shape
    ho, wo = offset.shape[2:]
    kk = k * k
    by, bx = _base_grid(ho, wo, k, stride, pad, dil, x.device)
    off = offset.reshape(b * dg, kk, 2, ho, wo)
    ys, xs = by + off[:, :, 0], bx + off[:, :, 1]  # (B*dg, K*K, Ho, Wo)
    grid = torch.stack([(2 * xs + 1) / w - 1, (2 * ys + 1) / h - 1],
                       -1).reshape(b * dg, kk * ho, wo, 2)
    xf = x.float().reshape(b * dg, cin // dg, h, w)
    m = None if mask is None else mask.reshape(b * dg, 1, kk * ho, wo)
    return xf, grid, m


def grid_sample_im2col(torch, args):
    """One deformable im2col call as F.grid_sample computes it, for
    library_ms (operands of grid_sample_inputs, prepared beforehand; a
    DCNv2 mask multiplies the samples); returns the call, which gives the
    kernel's columns."""
    import torch.nn.functional as F
    x, offset, _, k = args[:4]
    b, cin = x.shape[:2]
    kk, hw = k * k, offset.shape[2] * offset.shape[3]
    xf, grid, m = grid_sample_inputs(torch, args)

    def call():
        out = F.grid_sample(xf, grid, mode='bilinear', padding_mode='zeros',
                            align_corners=False)
        return (out if m is None else out * m).reshape(b, cin * kk, hw)
    return call


def grid_sample_im2col_backward(torch, args):
    """The backward of grid_sample_im2col's call, for row 8b's library_ms:
    autograd of F.grid_sample (one aten.grid_sampler_2d_backward, which
    gives the map and the grid gradients together) and, for DCNv2, of the
    mask's product, on the forward's saved tensors. ``args`` are the backward
    kernel's (x, offset, mask, grad, geometry). Returns (call, port):
    call() runs the backward; port(its result) gives the kernel's (d x
    float32, d offset, d mask or None), the grid gradient scaled back to
    pixels (d offset = d grid * 2 / size, (dy, dx) from the grid's (x, y))."""
    import torch.nn.functional as F
    x, offset, mask, grad = args[:4]
    geo = args[4:9]
    b, _, h, w = x.shape
    ho, wo = offset.shape[2:]
    kk, dg = geo[0] * geo[0], geo[4]
    xf, grid, m = grid_sample_inputs(torch, (x, offset, mask) + geo)
    leaves = [t.detach().requires_grad_() for t in (xf, grid, m)
              if t is not None]
    out = F.grid_sample(leaves[0], leaves[1], mode='bilinear',
                        padding_mode='zeros', align_corners=False)
    if m is not None:
        out = out * leaves[2]
    g = grad.reshape(out.shape)

    def call():
        return torch.autograd.grad(out, leaves, g, retain_graph=True)

    def port(res):
        dgrid = res[1].reshape(b * dg, kk, ho, wo, 2)
        doff = torch.stack([dgrid[..., 1] * (2.0 / h),
                            dgrid[..., 0] * (2.0 / w)], 2)
        return (res[0].reshape(x.shape), doff.reshape(offset.shape),
                None if m is None else res[2].reshape(mask.shape))
    return call, port


def near_integer(torch, args, eps=1e-3):
    """Per offset channel of one deformable im2col call: whether its sample
    coordinate (y for dy, x for dx) lies within ``eps`` pixels of an
    integer, where one rounding of the position can move floor and with it
    the one-sided derivative of the bilinear weights."""
    from erd_tpu_torch.ops.deform_conv import _base_grid
    x, offset, _, k, stride, pad, dil, dg = args
    b = x.shape[0]
    ho, wo = offset.shape[2:]
    by, bx = _base_grid(ho, wo, k, stride, pad, dil, x.device)
    off = offset.reshape(b, dg, k * k, 2, ho, wo)
    pos = torch.stack([by + off[:, :, :, 0], bx + off[:, :, :, 1]], 3)
    return ((pos - pos.round()).abs() < eps).reshape(offset.shape)


def phase_dcn_kernels(np, torch):
    """The deformable im2col kernel on every call of one 800x1333 request of
    each DCN config, with arranged conv_offset weights, against its plain
    version; then every distinct call shape timed with its GEMM."""
    import importlib

    from erd_tpu_torch.ops import (ModulatedDeformConv, deform_im2col,
                                   deform_im2col_plain)
    dcn_module = importlib.import_module('erd_tpu_torch.ops.deform_conv')
    batch, _ = request_batch(np, torch, REQUESTS[-1])
    worst, stats, shapes = 0.0, {}, {}
    for kind, path in DCN_CONFIGS.items():
        det, net = dcn_net(torch, path, kind)
        calls = []
        restore = capture(dcn_module, 'deform_im2col', calls)
        try:
            det.predict(net, batch)
        finally:
            restore()
        torch.cuda.synchronize()
        check(len(calls) == DCN_CALLS[kind], f'{kind}: {len(calls)} '
              f'deformable im2col calls in one request, expected '
              f'{DCN_CALLS[kind]}')
        n_backbone = 30 if kind == 'gfl_r101_dcn' else 13
        # the backbone's deformable convs, in call order
        mods = [m for m in net.modules() if isinstance(m, ModulatedDeformConv)]
        check(len(mods) == n_backbone, f'{kind}: {len(mods)} deformable '
              f'convs in the backbone')
        for i, args in enumerate(calls):
            x, offset, mask = args[:3]
            part = f'{kind} {"backbone" if i < n_backbone else "head"}'
            check((mask is not None) == (kind == 'vfnet_r50_mdconv' and
                                         i < n_backbone),
                  f'{part} call {i}: a mask where none belongs, or none')
            if mask is not None:
                check(float(mask.std()) > 0, f'{part} call {i}: the DCNv2 '
                      f'masks are all equal: the modulation goes unchecked')
            got = deform_im2col(*args)
            torch.cuda.synchronize()
            want = deform_im2col_plain(*args)
            err = float((got - want).abs().max())
            limit = 1e-6 * float(x.float().abs().max())
            counts = stats.setdefault(part, [0, 0, 0])
            for j, v in enumerate(dcn_sample_stats(torch, args)):
                counts[j] += v
            log(f'dcn kernels: {kind} call {i} x {tuple(x.shape)} {x.dtype} '
                f'stride {args[4]} mask {mask is not None}: max_abs_err='
                f'{err:.3e} (limit 1e-6*max|x| = {limit:.3e})')
            check(err <= limit, f'{kind}: deformable im2col kernel disagrees '
                  f'with plain on call {i}')
            worst = max(worst, err)
            key = (kind, tuple(x.shape), args[4], mask is not None)
            if key in shapes:
                shapes[key][1] += 1
            else:
                shapes[key] = [args, 1, mods[i] if i < n_backbone else None]
            del got, want
        del det, net, calls
        torch.cuda.empty_cache()
    for part, (n, frac, out) in stats.items():
        log(f'dcn kernels: {part} samples {n}: fractional bilinear weight '
            f'{frac / n:.4f}, a corner outside its map {out / n:.4f}')
        check(frac >= 0.5 * n, f'{part}: fewer than 50 % of the samples have '
              f'a fractional bilinear weight')
        check(out >= 0.01 * n, f'{part}: fewer than 1 % of the samples reach '
              f'outside their map')

    timed, totals = [], {}
    for (kind, xshape, stride, has_mask), (args, count, mod) in \
            shapes.items():
        ms, call_ms, src, plain_ms = time_pair(
            torch, lambda: deform_im2col(*args),
            lambda: deform_im2col_plain(*args), ['deform_im2col_kernel'],
            n=10)
        cols = deform_im2col(*args)
        library = grid_sample_im2col(torch, args)
        # grid_sample's normalised grid rounds the positions: ~1e-4 relative
        library_err = float((library() - cols).abs().max())
        library_limit = 1e-3 * float(args[0].float().abs().max())
        check(library_err <= library_limit, f'{kind} x {xshape}: '
              f'F.grid_sample gives other columns ({library_err:.3e} > '
              f'{library_limit:.3e}): not the same function')
        library_ms = events_ms(torch, library, 10)
        cin = xshape[1]  # conv2 and the head's dconvs keep their width
        weight = torch.randn(cin, cols.shape[1], device=DEV)
        gemm_ms = events_ms(torch, lambda: torch.matmul(weight, cols), 10)
        # the float32 conv_offset convolution (cuDNN, TF32 off) that made
        # the backbone calls' offsets and masks
        with torch.no_grad():
            offset_ms = events_ms(torch, lambda: mod.offsets(args[0]), 10) \
                if mod is not None else 0.0
        gemm_flop = 2.0 * cin * cols.numel()
        nbytes, ops = dcn_cost(args)
        bms, by = bound_of(nbytes, ops)
        out_hw = tuple(args[1].shape[2:])
        timed.append(dict(config=kind, x=list(xshape), out_hw=list(out_hw),
                          stride=stride, mask=has_mask, calls=count, ms=ms,
                          call_ms=call_ms, ms_from=src, plain_ms=plain_ms,
                          bound_ms=bms, bound_by=by, bound_bytes=nbytes,
                          library_ms=library_ms,
                          library_max_abs_err=library_err, gemm_ms=gemm_ms,
                          gemm_tflops=gemm_flop / gemm_ms / 1e9,
                          conv_offset_ms=offset_ms))
        tot = totals.setdefault(kind, [0.0, 0.0, 0.0, 0.0])
        tot[0] += count * ms
        tot[1] += count * gemm_ms
        tot[2] += count * gemm_flop
        tot[3] += count * offset_ms
        log(f'dcn kernels: {kind} x {xshape} -> {out_hw} stride {stride} '
            f'mask {has_mask} (x{count} a request): {ms:.4f} ms device '
            f'({src}), {call_ms:.4f} ms per call, plain {plain_ms:.3f} ms, '
            f'bound {bms:.4f} ms ({by}; {nbytes} bytes); F.grid_sample '
            f'{library_ms:.4f} ms (max_abs_err {library_err:.3e}); GEMM '
            f'{gemm_ms:.4f} ms ({gemm_flop / gemm_ms / 1e9:.1f} TFLOP/s '
            f'float32); conv_offset {offset_ms:.4f} ms')
        del cols, weight, library
    for kind, (k_ms, g_ms, flop, o_ms) in totals.items():
        log(f'dcn kernels: {kind} per request: im2col {k_ms:.3f} ms, GEMMs '
            f'{g_ms:.3f} ms ({flop / 1e9:.1f} GFLOP), float32 conv_offset '
            f'{o_ms:.3f} ms (events, call time)')
    log('dcn kernels: library_ms is F.grid_sample (bilinear, zeros padding, '
        'align_corners=False) on the float32 map and a grid prepared '
        'beforehand, times the mask for DCNv2')
    big = max(timed, key=lambda t: t['bound_bytes'])
    row = dict(name='deform_im2col', route='cuda',
               source='erd_tpu_torch/csrc/deform_conv.cu',
               replaces='erd_tpu/ops/deform_conv.py:55',
               max_abs_err=worst, ms=big['ms'], call_ms=big['call_ms'],
               ms_from=big['ms_from'],
               ms_at=f'{big["config"]} x {big["x"]} stride {big["stride"]}',
               plain_ms=big['plain_ms'], bound_ms=big['bound_ms'],
               bound_by=big['bound_by'], library_ms=big['library_ms'],
               gemm_ms=big['gemm_ms'], shapes=timed,
               per_request={k: {'im2col_ms': v[0], 'gemm_ms': v[1],
                                'gemm_gflop': v[2] / 1e9,
                                'conv_offset_ms': v[3]}
                            for k, v in totals.items()},
               sample_share={p: {'fractional': v[1] / v[0],
                                 'outside': v[2] / v[0]}
                             for p, v in stats.items()})
    torch.cuda.empty_cache()
    return [row]


def phase_dcn_reference(np, torch):
    """Both float32 DCN networks (conv_offset arranged), card vs CPU, on one
    small input: every head output within 1e-3 * max|out|."""
    import copy

    from erd_tpu_torch.apis import build_detector
    from erd_tpu_torch.config import Config
    from erd_tpu_torch.ops import arrange_offsets
    img = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (1, 128, 192, 3), np.uint8))
    for kind, path in DCN_CONFIGS.items():
        cfg = Config.fromfile(path)
        cfg.model.compute_dtype = 'float32'
        det = build_detector(cfg.model)
        net_cpu = det.init(seed=1, device='cpu')
        arrange_offsets(net_cpu, DCN_ARRANGE_SEED)
        net_dev = copy.deepcopy(net_cpu).to(DEV)
        want = det.forward_raw(net_cpu, img)
        got = det.forward_raw(net_dev, img.to(DEV))
        worst = 0.0
        for g_l, w_l in zip(got, want):
            for g, w in zip(g_l, w_l):
                check(tuple(g.shape) == tuple(w.shape),
                      'reference shape mismatch')
                worst = max(worst, float((g.cpu() - w).abs().max() /
                                         w.abs().max()))
        log(f'dcn reference: {kind} float32 card vs CPU, max |diff| / max '
            f'|out| = {worst:.2e} (tolerance 1e-3)')
        check(worst <= 1e-3, f'float32 {kind} on the card disagrees with the '
              f'CPU')


def phase_dcn_serve(np, torch, card):
    """init_detector / inference_detector of both DCN configs on the 4
    requests: the im2col launches per request, every detection finite and
    inside its image, stage times, peak memory, the idle share of one
    request, card-vs-CPU post-processing."""
    from erd_tpu_torch.data import DetPipeline
    from erd_tpu_torch.ops import deform_im2col, integral_decode, \
        nms_sorted_keep

    phase_dcn_reference(np, torch)
    images = request_images(np)
    counters = {'deform_im2col': deform_im2col, 'nms_keep': nms_sorted_keep,
                'integral_decode': integral_decode}
    launches = {k: 0 for k in counters}
    by_config = {}
    head_module = importlib.import_module(
        'erd_tpu_torch.models.heads.gfl_head')
    decode = None
    for kind, path in DCN_CONFIGS.items():
        tag = f'dcn serve {kind}'
        det, net = dcn_net(torch, path, kind)
        gfl = kind == 'gfl_r101_dcn'
        want = {'deform_im2col': DCN_CALLS[kind] * len(images),
                'nms_keep': len(images),
                'integral_decode': len(images) if gfl else 0}
        results, counts = serve_requests(np, torch, det, net, images,
                                         counters, want, tag, card)
        for name, count in counts.items():
            launches[name] += count
        by_config[kind] = counts['deform_im2col']

        pipe = DetPipeline()
        for i, (img, res) in enumerate(zip(images, results)):
            with torch.no_grad():
                req = ServedRequest(np, torch, pipe, i, img)
                feats = net.backbone(det.preprocessor(req.images))
                req.mark()
                feats = net.neck(feats)
                req.mark()
                outs = net.bbox_head(feats)
                req.mark()
                if gfl:
                    ctx = det.anchor_context(req.images.shape[1:3])
                    heads = outs
                else:
                    ctx = det.context(req.images.shape[1:3])
                    heads = (outs[0], outs[2])  # classes, refined boxes
                calls = []
                restore = capture(head_module, 'integral_decode', calls)
                try:
                    gpu = det.postprocess(ctx, *heads, req.meta_dev)
                finally:
                    restore()
                req.mark()
                check(len(calls) == want['integral_decode'] // len(images),
                      f'{tag} request {i}: {len(calls)} decodes')
                if gfl and i == len(images) - 1:
                    decode = decode_call(np, torch, tag, calls[0], outs[1])
            req.log_stages(tag, ('normalise + backbone', 'neck', 'head',
                                 'post-processing'))
            cpu = det.postprocess(ctx, *[[t.cpu() for t in lvl]
                                         for lvl in heads], req.meta_cpu)
            req.compare(tag, gpu, cpu, len(res.scores), min_candidates=1)
            del feats, outs, heads
        del det, net
        torch.cuda.empty_cache()
    launches['deform_im2col_by_config'] = by_config
    return launches, decode


def tf32_settings(torch):
    """torch's float32 precision settings that reach cuDNN and cuBLAS."""
    cudnn = torch.backends.cudnn
    conv = getattr(cudnn, 'conv', None)
    return dict(cudnn_allow_tf32=cudnn.allow_tf32,
                cudnn_conv_fp32_precision=getattr(conv, 'fp32_precision',
                                                  'absent'),
                matmul_precision=torch.get_float32_matmul_precision(),
                matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)


def phase_tf32(np, torch):
    """In torch's default settings (cuDNN may convolve float32 in TF32),
    the port's ModulatedDeformConv.offsets on a GFL R101-DCN layer3 input
    (256 x 50 x 84) agrees with the CPU within 1e-5 * max|out|, and a
    float32 Conv2d's input and weight gradients on it within 1e-5 and
    1e-4 * max|grad| (the weight gradient sums 4200 pixels, in another
    order on each side); the same convolution forced into TF32 (the
    controls) must miss each of those limits; the settings are the same
    before and after."""
    import copy

    import torch.nn.functional as F

    from erd_tpu_torch.ops import ModulatedDeformConv
    from erd_tpu_torch.utils import conv_fp32_precision
    gen = torch.Generator().manual_seed(0)
    m = ModulatedDeformConv(256, 256, modulated=False)
    with torch.no_grad():  # lecun-normal offsets: the conv, not its bias
        m.conv_offset.weight.copy_(torch.randn(
            m.conv_offset.weight.shape, generator=gen) / 48.0)
        m.conv_offset.bias.zero_()
    x = torch.randn(1, 256, 50, 84, generator=gen)
    before = tf32_settings(torch)
    with torch.no_grad():
        want, _ = m.offsets(x)
        m = m.to(DEV)
        got, _ = m.offsets(x.to(DEV))
        c = m.conv_offset
        with conv_fp32_precision('tf32'):
            tf32 = F.conv2d(x.to(DEV), c.weight, c.bias, 1, 1)
    torch.cuda.synchronize()
    limit = 1e-5 * float(want.abs().max())
    err = float((got.cpu() - want).abs().max())
    tf32_err = float((tf32.cpu() - want).abs().max())
    log(f'tf32: offsets card vs CPU in torch defaults max_abs_err={err:.3e}, '
        f'the raw conv in TF32 (control) {tf32_err:.3e}; limit 1e-5*max|out| '
        f'= {limit:.3e}; settings after {tf32_settings(torch)}')
    check(err <= limit, 'the float32 conv_offset on the card misses 1e-5 * '
          'max|out|: TF32 reaches the port')
    check(tf32_err > limit, 'TF32 control passed the limit: the check cannot '
          'see TF32')
    check(tf32_settings(torch) == before, 'the precision settings changed')

    # the backward: a float32 layers.Conv2d's input and weight gradients
    from erd_tpu_torch.models.layers import Conv2d
    conv = Conv2d(256, 256, 3)
    with torch.no_grad():
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen) / 48)
    r = torch.randn(1, 256, 50, 84, generator=gen)

    def grads(dev, tf32=False):
        """The port's Conv2d in torch's defaults, or the raw conv, forward
        and backward, in TF32."""
        c = copy.deepcopy(conv).to(dev)
        xd = x.to(dev).detach().requires_grad_(True)
        if tf32:
            with conv_fp32_precision('tf32'):
                out = F.conv2d(xd, c.weight, c.bias, 1, 1)
                (out * r.to(dev)).sum().backward()
        else:
            (c(xd) * r.to(dev)).sum().backward()
        return [xd.grad.cpu(), c.weight.grad.cpu()]
    want_g = grads('cpu')
    rel = [float((g - w).abs().max() / w.abs().max())
           for g, w in zip(grads(DEV), want_g)]
    rel_tf32 = [float((g - w).abs().max() / w.abs().max())
                for g, w in zip(grads(DEV, tf32=True), want_g)]
    torch.cuda.synchronize()
    limits = (1e-5, 1e-4)
    log(f'tf32: a float32 Conv2d backward card vs CPU, max|diff| / max|grad| '
        f'of the input and weight gradients {rel[0]:.2e} {rel[1]:.2e}; in '
        f'TF32 (control) {rel_tf32[0]:.2e} {rel_tf32[1]:.2e}; limits '
        f'{limits[0]:.0e} {limits[1]:.0e}')
    check(all(e <= lim for e, lim in zip(rel, limits)), 'the float32 conv '
          'backward on the card misses its limits: TF32 reaches the port\'s '
          'gradients')
    check(all(e > lim for e, lim in zip(rel_tf32, limits)),
          'TF32 backward control passed a limit')
    return dict(max_abs_err=err, tf32_control_err=tf32_err, limit=limit,
                backward_rel_err=max(rel), backward_tf32_rel_err=max(rel_tf32))


def bf16_ulps(torch, a, b):
    """Elementwise distance of two bf16 tensors in bf16 ulps."""
    def key(t):
        i = t.contiguous().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7fff), i)
    return (key(a) - key(b)).abs()


def carafe_net(np, torch, kind):
    """init_detector of the CARAFE or CrowdDet config on the card; the
    CARAFE net with arranged content encoders and seeded fc_cls weights
    (at least 2000 candidates into the final NMS)."""
    from erd_tpu_torch.apis import init_detector
    from erd_tpu_torch.ops import arrange_carafe
    det, net, _ = init_detector(CARAFE_CONFIGS[kind], device=DEV)
    want = {'carafe': ('FasterRCNNDetector', 'FPNCARAFE', NUM_CLASSES),
            'crowddet': ('CrowdDetDetector', 'FPN', 1)}[kind]
    check(type(det).__name__ == want[0] and det.depth == 50 and
          det.num_classes == want[2] and det.compute_dtype == torch.bfloat16
          and type(net.neck).__name__ == want[1],
          f'not the {kind} R50 bf16 model with the {want[1]} neck')
    if kind == 'carafe':
        arrange_carafe(net, CARAFE_ARRANGE_SEED)
        batch, _ = request_batch(np, torch, REQUESTS[-1])
        arrange_fc_cls(torch, det, net, batch)
    return det, net


def carafe_cost(x, logits):
    """(bytes, float32 operations) of one CARAFE call: x and the logits
    read and the x2 output written in x's dtype; per output element 25
    multiplies and 24 adds, per output pixel the softmax (25 each of max,
    subtract, exp, add, divide)."""
    b, c, h, w = x.shape
    outs = b * c * 4 * h * w
    nbytes = x.element_size() * (x.numel() + logits.numel() + outs)
    return nbytes, outs * 49.0 + b * 4 * h * w * 125.0


def carafe_backward_cost(x, logits, g):
    """(bytes, float32 operations, bf16 tensor-core operations) of one
    CARAFE backward call: x, the logits and the output gradient read, dx
    and dlogits written, in x's dtype; dx: 100 multiply-adds per channel
    and source pixel, float32 softmax weights times the gradient; per
    output pixel the softmax (125) and its backward (100), float32; dw: 25
    multiply-adds of x times the gradient per channel and output pixel,
    summed in float32 (a bf16 tensor-core product where both are bf16)."""
    b, c, h, w = x.shape
    nbytes = x.element_size() * (2 * x.numel() + 2 * logits.numel() +
                                 g.numel())
    ops = b * c * h * w * 200.0 + b * 4 * h * w * 225.0
    dw = b * c * 4 * h * w * 50.0
    if x.dtype == g.dtype and x.element_size() == 2:
        return nbytes, ops, dw
    return nbytes, ops + dw, 0.0


def phase_carafe_kernels(np, torch):
    """The CARAFE kernel on the 3 calls of one 800x1333 request of the
    FPN_CARAFE config (content encoders arranged), against its plain
    version in bf16 (one bf16 ulp) and on the float32 map (1e-5 *
    max|x|); then each call shape timed."""
    import importlib

    from erd_tpu_torch.ops import carafe, carafe_plain, carafe_weights
    carafe_module = importlib.import_module('erd_tpu_torch.ops.carafe')
    det, net = carafe_net(np, torch, 'carafe')
    batch, _ = request_batch(np, torch, REQUESTS[-1])
    calls = []
    restore = capture(carafe_module, 'carafe', calls)
    try:
        det.predict(net, batch)
    finally:
        restore()
    torch.cuda.synchronize()
    sizes = [tuple(a[0].shape[2:]) for a in calls]
    check(sizes == [(25, 42), (50, 84), (100, 168)],
          f'CARAFE calls of one request at {sizes}')
    worst, worst32, shapes = 0, 0.0, []
    for i, (x, logits) in enumerate(a[:2] for a in calls):
        check(x.dtype == torch.bfloat16 and x.shape[1] == 256 and
              logits.dtype == torch.bfloat16, f'CARAFE call {i}: not bf16 '
              f'256 channels')
        w = carafe_weights(logits)
        peak = float(w.amax(1).mean())
        sub = w.view(w.shape[0], 25, x.shape[2], 2, x.shape[3], 2)
        differ = min(float((sub[:, :, :, a0, :, b0] != sub[:, :, :, a1, :, b1])
                           .any(1).float().mean())
                     for a0, b0, a1, b1 in ((0, 0, 0, 1), (0, 0, 1, 0),
                                            (0, 0, 1, 1), (0, 1, 1, 0),
                                            (0, 1, 1, 1), (1, 0, 1, 1)))
        got = carafe(x, logits)
        torch.cuda.synchronize()
        plain = carafe_plain(x, logits)
        ulps = int(bf16_ulps(torch, got, plain).max())
        exact = torch.equal(got, plain)
        x32, l32 = x.float(), logits.float()
        err32 = float((carafe(x32, l32) - carafe_plain(x32, l32)).abs().max())
        limit = 1e-5 * float(x32.abs().max())
        log(f'carafe kernels: call {i} {tuple(x.shape)} -> {tuple(got.shape)}'
            f': mean largest tap weight {peak:.3f} (>= 0.2), sub-pixel '
            f'kernels differ at {differ:.4f} of the source pixels; bf16 '
            f'{ulps} ulp (limit 1; bit-equal {exact}); float32 max_abs_err='
            f'{err32:.3e} (limit 1e-5*max|x| = {limit:.3e})')
        check(peak >= 0.2, f'CARAFE call {i}: near-uniform taps')
        check(differ >= 0.99, f'CARAFE call {i}: sub-pixel kernels equal')
        check(ulps <= 1, f'CARAFE call {i}: bf16 kernel off by {ulps} ulp')
        check(err32 <= limit, f'CARAFE call {i}: float32 kernel disagrees')
        worst, worst32 = max(worst, ulps), max(worst32, err32)
        ms, call_ms, src, plain_ms = time_pair(
            torch, lambda: carafe(x, logits), lambda: carafe_plain(x, logits),
            ['carafe_kernel'], n=20)
        nbytes, ops = carafe_cost(x, logits)
        bms, by = bound_of(nbytes, ops)
        shapes.append(dict(x=list(x.shape), ms=ms, call_ms=call_ms,
                           ms_from=src, plain_ms=plain_ms, bound_ms=bms,
                           bound_by=by, bound_bytes=nbytes))
        log(f'carafe kernels: {tuple(x.shape)}: {ms:.4f} ms device ({src}), '
            f'{call_ms:.4f} ms per call, plain {plain_ms:.3f} ms, bound '
            f'{bms:.4f} ms ({by}; {nbytes} bytes, {ops / 1e9:.3f} GOP)')
    log('carafe kernels: library_ms is null: no single PyTorch call computes '
        'the shuffle, the softmax and the 5x5 reassembly')
    big = shapes[-1]
    del calls, net
    torch.cuda.empty_cache()
    return dict(name='carafe', route='cuda',
                source='erd_tpu_torch/csrc/carafe.cu',
                replaces='erd_tpu/ops/carafe.py:23', max_abs_err=worst32,
                max_bf16_ulps=worst, ms=big['ms'], call_ms=big['call_ms'],
                ms_from=big['ms_from'], ms_at=f'x {big["x"]}',
                plain_ms=big['plain_ms'], bound_ms=big['bound_ms'],
                bound_by=big['bound_by'], library_ms=None, shapes=shapes,
                per_request_ms=sum(t['ms'] for t in shapes),
                redesigned=True, design='a block a 5 x 42 tile of source '
                'pixels (channel groups for small calls), a thread a source '
                'pixel with its 100 softmax weights in registers; x and its '
                'halo staged by cp.async rings; 25 shared reads a channel '
                'serve 4 outputs; paired stores; bit-equal to plain')


def phase_set_nms_kernels(np, torch):
    """Set-NMS on the call of one 800x1333 CrowdDet request (K = 2000, all
    valid): the keep mask exactly the plain version's and not the plain
    NMS's; then timed."""
    import importlib

    from erd_tpu_torch.ops import (nms_sorted_keep, set_nms_sorted_keep,
                                   set_nms_sorted_keep_plain)
    nms_module = importlib.import_module('erd_tpu_torch.ops.nms')
    det, net = carafe_net(np, torch, 'crowddet')
    batch, _ = request_batch(np, torch, REQUESTS[-1])
    calls = []
    restore = capture(nms_module, 'set_nms_sorted_keep', calls)
    try:
        det.predict(net, batch)
    finally:
        restore()
    torch.cuda.synchronize()
    check(len(calls) == 1, f'{len(calls)} set-NMS calls in one request')
    args = calls[0]
    sboxes, svalid, sgroup, order, thr = args
    k = sboxes.shape[1]
    check(k == 2000 and bool(svalid.all()) and abs(thr - 0.5) < 1e-9,
          f'set-NMS call at K={k}, {int(svalid.sum())} valid, IoU {thr}')
    got = set_nms_sorted_keep(*args)
    torch.cuda.synchronize()
    mism = int((got != set_nms_sorted_keep_plain(*args)).sum())
    plain_nms = nms_sorted_keep(sboxes, svalid, order, thr)
    groups = int(sgroup.unique().numel())
    log(f'set-NMS kernels: K={k} iou={thr} groups {groups}'
        f' kept {int(got.sum())} mismatches={mism} (exact); the row-1 NMS on '
        f'the same boxes keeps {int(plain_nms.sum())}')
    check(mism == 0, 'set-NMS kernel disagrees with plain')
    check(not torch.equal(got, plain_nms), 'set-NMS keeps what NMS keeps: '
          'the group test did not act')
    ms, call_ms, src, plain_ms = time_pair(
        torch, lambda: set_nms_sorted_keep(*args),
        lambda: set_nms_sorted_keep_plain(*args),
        ['nms_mask_kernel', 'nms_reduce_kernel'], n=20)
    pairs = k * (k - 1) / 2.0
    ops = 15.0 * pairs + 3.0 * k  # per pair the NMS's 14 and the group
    # compare; per box its area
    nbytes = k * (16 + 1 + 8 + 8) + k * 1
    bms, by = bound_of(nbytes, ops)
    log(f'set-NMS kernels: {ms:.4f} ms device ({src}), {call_ms:.4f} ms per '
        f'call, plain {plain_ms:.3f} ms, bound {bms:.5f} ms ({by}); '
        f'library_ms is null: no PyTorch call computes set-NMS')
    del calls, net
    torch.cuda.empty_cache()
    return dict(name='set_nms_keep', route='cuda',
                source='erd_tpu_torch/csrc/nms.cu',
                replaces='erd_tpu/ops/nms.py:107', max_abs_err=0.0, ms=ms,
                call_ms=call_ms, ms_from=src, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=None,
                kept=int(got.sum()), nms_kept=int(plain_nms.sum()))


def phase_soft_nms_large_k(np, torch):
    """Soft-NMS at K = 12000 (soft_nms_large_k_case), above one block's
    shared memory (a cluster of blocks an image), 100 steps: linear
    bit-exact, gaussian within 1e-6 relative; then timed."""
    from erd_tpu_torch.ops import cuda_build, soft_nms, soft_nms_plain
    from erd_tpu_torch.ops.nms import soft_nms_limits, soft_nms_plan
    steps = 100
    sboxes, scores = soft_nms_large_k_case(np, torch)
    k = scores.shape[1]
    threads, capacity = soft_nms_limits(cuda_build.load('soft_nms'),
                                        sboxes.device)
    plan = soft_nms_plan(k, capacity, threads)
    check(plan[0] > 1, f'soft-NMS large K: K={k} planned as {plan}, not a '
          f'cluster')
    for method in ('linear', 'gaussian'):
        gi, gs = soft_nms(sboxes, scores, steps, 0.5, 0.5, 1e-3, method)
        torch.cuda.synchronize()
        wi, ws = soft_nms_plain(sboxes, scores, steps, 0.5, 0.5, 1e-3,
                                method)
        live = ws[0] > float('-inf')
        rel = float(((gs[0] - ws[0]).abs() / ws[0].abs())[live].max())
        log(f'soft-NMS large K: {method} K={k} steps={steps}: selections '
            f'equal {torch.equal(gi, wi)}, scores bit-equal '
            f'{torch.equal(gs, ws)}, max rel err {rel:.2e}')
        if method == 'linear':
            check(torch.equal(gi, wi) and torch.equal(gs, ws),
                  'large-K linear soft-NMS is not bit-exact with plain')
        else:
            check(torch.equal(gi, wi) and rel <= 1e-6,
                  'large-K gaussian soft-NMS differs from plain')
    args = (sboxes, scores, steps, 0.5, 0.5, 1e-3, 'linear')
    ms, call_ms, src, plain_ms = time_graph(
        torch, lambda: soft_nms(*args), lambda: soft_nms_plain(*args), n=10)
    prof_ms = profiled_ms(torch, lambda: soft_nms(*args), SOFT_NMS_KERNELS,
                          10, 'soft-NMS large K')
    live, exhausted = soft_nms_stats(torch, args, soft_nms(*args)[1])
    bms, by = bound_of(*soft_nms_cost(args, live, exhausted))
    log(f'soft-NMS large K: a cluster of {plan[0]} blocks of {plan[1]} '
        f'slots ({plan[2]} a thread), {live} live: {ms:.4f} ms device '
        f'({src}; profiler {prof_ms:.4f}), {call_ms:.4f} ms per call, plain '
        f'{plain_ms:.3f} ms, bound {bms:.6f} ms ({by})')
    return dict(k=k, steps=steps, live=live, cluster=plan[0], ms=ms,
                call_ms=call_ms, ms_from=src, profiler_ms=prof_ms,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by)


def phase_carafe_crowddet_reference(np, torch):
    """Both float32 networks (FPN_CARAFE Faster R-CNN with arranged
    content encoders, CrowdDet), card vs CPU, on one small input: RPN
    outputs and the head on zero RoIs within 1e-3 * max|out|."""
    import copy

    from erd_tpu_torch.apis import build_detector
    from erd_tpu_torch.config import Config
    from erd_tpu_torch.ops import arrange_carafe
    img = torch.from_numpy(np.random.RandomState(2).randint(
        0, 256, (1, 128, 192, 3), np.uint8))
    for kind, path in CARAFE_CONFIGS.items():
        cfg = Config.fromfile(path)
        cfg.model.compute_dtype = 'float32'
        det = build_detector(cfg.model)
        net_cpu = det.init(seed=1, device='cpu')
        arrange_carafe(net_cpu, CARAFE_ARRANGE_SEED)
        net_dev = copy.deepcopy(net_cpu).to(DEV)
        (w_cls, w_reg), w_head = det.forward_raw(net_cpu, img)
        (g_cls, g_reg), g_head = det.forward_raw(net_dev, img.to(DEV))
        worst = 0.0
        for g, w in zip(g_cls + g_reg + list(g_head),
                        w_cls + w_reg + list(w_head)):
            check(tuple(g.shape) == tuple(w.shape), 'reference shape mismatch')
            worst = max(worst, float((g.cpu() - w).abs().max() /
                                     w.abs().max()))
        log(f'carafe/crowddet reference: {kind} float32 card vs CPU, max '
            f'|diff| / max |out| = {worst:.2e} (tolerance 1e-3)')
        check(worst <= 1e-3, f'float32 {kind} on the card disagrees with the '
              f'CPU')


def phase_carafe_crowddet_serve(np, torch, card):
    """init_detector / inference_detector of the FPN_CARAFE and the CrowdDet
    config on the 4 requests: exact launches per request, every detection
    finite and inside its image, stage times (the neck apart), peak memory,
    the idle share of one request, card-vs-CPU post-processing."""
    from erd_tpu_torch.data import DetPipeline
    from erd_tpu_torch.ops import (carafe, nms_sorted_keep, roi_align,
                                   set_nms_sorted_keep)

    phase_carafe_crowddet_reference(np, torch)
    images = request_images(np)
    counters = {'carafe': carafe, 'nms_keep': nms_sorted_keep,
                'set_nms_keep': set_nms_sorted_keep, 'roi_align': roi_align}
    per_request = {'carafe': dict(carafe=3, nms_keep=2, set_nms_keep=0,
                                  roi_align=1),
                   'crowddet': dict(carafe=0, nms_keep=1, set_nms_keep=1,
                                    roi_align=1)}
    launches = {}
    for kind in CARAFE_CONFIGS:
        tag = f'{kind} serve'
        det, net = carafe_net(np, torch, kind)
        want = {k: v * len(images) for k, v in per_request[kind].items()}
        results, counts = serve_requests(np, torch, det, net, images,
                                         counters, want, tag, card)
        launches[tag] = counts
        pipe = DetPipeline()
        for i, (img, res) in enumerate(zip(images, results)):
            with torch.no_grad():
                req = ServedRequest(np, torch, pipe, i, img)
                feats = net.backbone(det.preprocessor(req.images))
                req.mark()
                feats = net.neck(feats)
                req.mark()
                rpn_cls, rpn_reg = net.rpn_head(feats)
                ctx = det.anchor_context(req.images.shape[1:3])
                rois, _, roi_mask = det.proposals(ctx, rpn_cls, rpn_reg,
                                                  req.meta_dev)
                req.mark()
                roi_feats = det.roi_feats(feats, rois)
                req.mark()
                cls, reg = det.roi_forward(net, roi_feats)
                req.mark()
                gpu = det.postprocess(cls, reg, rois, roi_mask, req.meta_dev)
                req.mark()
            req.log_stages(tag, ('normalise + backbone', 'neck',
                                 'RPN + proposals', 'RoIAlign', 'head',
                                 'post-processing'))
            cpu = det.postprocess(cls.cpu(), reg.cpu(), rois.cpu(),
                                  roi_mask.cpu(), req.meta_cpu)
            req.compare(tag, gpu, cpu, len(res.scores),
                        f'proposals {int(roi_mask.sum())} ',
                        min_candidates=2000)
            del feats, roi_feats
        del det, net
        torch.cuda.empty_cache()
    return launches


TWO_STAGE_TRAIN = {'frcnn': FRCNN_CONFIGS['nms'],
                   'carafe': CARAFE_CONFIGS['carafe'],
                   'crowddet': CARAFE_CONFIGS['crowddet']}
# the RPN NMS of a training step at 800x1344: nms_pre 2000 on each of
# P2-P5, and P6's 13 x 21 x 3 = 819 anchors
TRAIN_RPN_K = 8819
# card vs CPU training proposals in float32 (frcnn train reference): the
# share of slots that may differ, each only as an adjacent swap of boxes
# whose card scores are this close (the network tolerance of the CPU tests)
PROPOSAL_MOVED_SHARE, PROPOSAL_SCORE_RTOL = 0.005, 1e-4


def proposal_swaps(got, want):
    """(slots that differ, slots that are no adjacent near-tie swap) of the
    proposals ``got`` = (boxes, scores, mask) against ``want``'s: a slot
    differs where its box is more than 1e-2 px off; it is a swap where the
    box sits in a neighbouring slot of ``got`` whose score is within
    PROPOSAL_SCORE_RTOL. Slots whose masks differ count as no swap."""
    boxes, scores, mask = got
    off = ((boxes - want[0]).abs().amax(-1) > 1e-2).nonzero().tolist()
    bad = int((mask != want[2]).sum())
    for i, k in off:
        j = int((boxes[i] - want[0][i, k]).abs().amax(-1).argmin())
        bad += not (abs(j - k) == 1 and float(
            (boxes[i, j] - want[0][i, k]).abs().max()) <= 1e-2 and
            abs(float(scores[i, j] - scores[i, k])) <=
            PROPOSAL_SCORE_RTOL * float(scores[i, k]))
    return len(off), bad


def level_sizes(strides, canvas=None):
    """(H, W) of the levels of ``strides`` on the train canvas."""
    h, w = canvas or TRAIN_CANVAS
    return [(-(-h // s), -(-w // s)) for s in strides]
# kernel launches of one training step, per config
TRAIN_STEP_LAUNCHES = {
    'frcnn': dict(roi_align=1, roi_align_backward=1, nms_keep=1, carafe=0,
                  carafe_backward=0),
    'carafe': dict(roi_align=1, roi_align_backward=1, nms_keep=1, carafe=3,
                   carafe_backward=3),
    'crowddet': dict(roi_align=1, roi_align_backward=1, nms_keep=1,
                     carafe=0, carafe_backward=0)}


def train_net(torch, kind, device=None, dtype=None, seed=31):
    """The config, its detector and a seeded network (content encoders
    arranged for FPN-CARAFE), on ``device`` (the card by default)."""
    from erd_tpu_torch.apis import build_detector
    from erd_tpu_torch.config import Config
    from erd_tpu_torch.ops import arrange_carafe
    cfg = Config.fromfile(TWO_STAGE_TRAIN[kind])
    if dtype:
        cfg.model.compute_dtype = dtype
    det = build_detector(cfg.model)
    want = {'frcnn': ('FasterRCNNDetector', None, NUM_CLASSES),
            'carafe': ('FasterRCNNDetector', 'FPN_CARAFE', NUM_CLASSES),
            'crowddet': ('CrowdDetDetector', None, 1)}[kind]
    check(type(det).__name__ == want[0] and det.depth == 50 and
          (det.neck or {}).get('type') == want[1] and
          det.num_classes == want[2] and det.frozen_stages == 1,
          f'not the {kind} R50 model')
    net = det.init(seed=seed, device=device or DEV)
    if kind == 'carafe':
        arrange_carafe(net, CARAFE_ARRANGE_SEED)
    return cfg, det, net


def roi_sample_stats(torch, rois, levels, shapes, strides=ROI_STRIDES,
                     out_size=7, ratio=2):
    """(samples, samples off their map) of RoIAlign's bins, over every RoI
    on its level."""
    from erd_tpu_torch.ops.roi_align import _sample_axis
    total = inside = 0
    for lvl, ((h, w), stride) in enumerate(zip(shapes, strides)):
        r = rois[levels == lvl]
        lo = r * (1.0 / stride) - 0.5
        size = (lo[:, 2:] - lo[:, :2]).clamp(min=1e-6) / torch.full_like(
            lo[:, :2], out_size)
        in_y = _sample_axis(lo[:, 1], size[:, 1], h, out_size, ratio)[0]
        in_x = _sample_axis(lo[:, 0], size[:, 0], w, out_size, ratio)[0]
        total += r.shape[0] * (out_size * ratio) ** 2
        inside += int((in_y[:, :, None] & in_x[:, None, :]).sum())
    return total, total - inside


def train_edge_rois(torch):
    """The 15 edge-case boxes planted in the last RoI slots of every image
    of a training call's check (800x1344 canvas): 6 off the image, 6 on
    its edges or degenerate, one sized for each of levels 1-3."""
    h, w = TRAIN_CANVAS
    return torch.tensor([
        [-60, -40, -2, -1], [w + 5, 0, w + 90, 40], [-300, -200, -10, -5],
        [w + 10, h + 10, w + 400, h + 300], [-900, -900, -100, -100],
        [w + 100, -50, w + 900, h], [10, 10, 10, 10], [0, 0, 0, 0],
        [w - 8, h - 8, w + 4, h + 4], [w - 4, 0, w, h], [0, h - 4, w, h],
        [-9, -9, 600, 500], [100, 100, 250, 260], [200, 100, 560, 500],
        [-100, -100, 900, 800]], dtype=torch.float32, device=DEV)


def roi_forward_call(torch, args, tag):
    """Row 7 on one training call ``args`` (feats, rois, levels, strides,
    out_size, sampling_ratio) with ``train_edge_rois`` planted in the last
    slots of every image: bit-equal to plain (and so within the gate of
    1e-6 * max|feat|) at every RoI level; then timed by CUDA-graph
    replays (``ms``) and events (``call_ms``) beside its bound over the
    batch and the plain version. Returns a dict for the row's
    ``train_shapes``."""
    from erd_tpu_torch.ops import map_roi_levels, roi_align, roi_align_plain
    feats, rois, _, strides, out_size, ratio = args[:6]
    feats = [f.detach() for f in feats]
    rois = rois.clone()
    rois[:, -15:] = train_edge_rois(torch)
    levels = map_roi_levels(rois, 4).contiguous()
    check(torch.equal(levels.cpu(), map_roi_levels(rois.cpu(), 4)),
          f'{tag}: RoI levels differ between card and CPU')
    args = (feats, rois, levels, strides, out_size, ratio)
    b, r = levels.shape
    got = roi_align(*args)
    torch.cuda.synchronize()
    want = roi_align_plain(*args)
    feat_max = max(float(f.float().abs().max()) for f in feats)
    err = float((got - want).abs().max())
    differ = int((got != want).sum())
    del got, want
    per_level = torch.bincount(levels.flatten().long(), minlength=4)
    n_samples, n_off = roi_sample_stats(
        torch, rois, levels, [tuple(f.shape[2:]) for f in feats],
        out_size=out_size, ratio=ratio)
    check(bool((per_level > 0).all()), f'{tag}: RoIAlign missed a level')
    check(err <= 1e-6 * feat_max and differ == 0, f'{tag}: RoIAlign kernel '
          f'differs from plain at {differ} elements (max {err:.3e})')
    ms = graph_ms(torch, lambda: roi_align(*args), 5)
    call_ms = events_ms(torch, lambda: roi_align(*args), 5)
    plain_ms = events_ms(torch, lambda: roi_align_plain(*args), 1)
    nbytes, ops = roi_align_cost(torch, feats, rois, levels, out_size, ratio)
    bms, by = bound_of(nbytes, ops)
    log(f'{tag}: roi_align out {out_size} R={r} x {b} C={feats[0].shape[1]} '
        f'{feats[0].dtype} levels {per_level.tolist()}, {n_off}/{n_samples} '
        f'samples off their map: max_abs_err={err:.3e} (limit '
        f'1e-6*max|feat| = {1e-6 * feat_max:.3e}), {differ} elements '
        f'differ from plain; {ms:.4f} ms (graph replays), {call_ms:.4f} ms '
        f'per call (events), plain {plain_ms:.2f} ms, bound {bms:.4f} ms '
        f'({by}; {nbytes} bytes)')
    return dict(out=out_size, rois=[b, r], maps=str(feats[0].dtype),
                ms=ms, call_ms=call_ms, ms_from='graph', plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, bound_bytes=nbytes, ops=ops,
                max_abs_err=err, mismatches=differ,
                samples_off_map=n_off / max(n_samples, 1),
                per_level=per_level.tolist())


def roi_backward_call(torch, args, tag):
    """Kernel 7b on one call ``args`` (grad, rois, levels, shapes, strides,
    the maps' dtype, out_size, sampling_ratio) against its plain version:
    float32 within 1e-5 * max|plain| on every level, rounded to bf16 within
    one ulp of plain's rounding (or 1e-5 * max|plain|); then timed (the
    kernel alone, a launch by the profiler, as ``ms``; the call, memset,
    kernel and rounding pass, by CUDA events, as ``call_ms``) with its
    bound: the output gradient, RoIs and levels read, the level gradients
    written in the maps' dtype, 12 float32 operations a channel of each
    in-range sample of a RoI that has a gradient. Returns a dict for the
    row's ``shapes``."""
    from erd_tpu_torch.ops import roi_align_backward, roi_align_backward_plain
    grad, rois, levels, shapes, strides, dtype, out_size, ratio = args
    b, r, c = grad.shape[:3]
    want = roi_align_backward_plain(grad, rois, levels, shapes, strides,
                                    out_size, ratio)
    err, err_bf16 = 0.0, 0
    for dt in (torch.float32, torch.bfloat16):
        got = roi_align_backward(grad, rois, levels, shapes, strides, dt,
                                 out_size, ratio)
        torch.cuda.synchronize()
        for lvl, (g, wt) in enumerate(zip(got, want)):
            limit = 1e-5 * float(wt.abs().max())
            diff = (g.float() - wt).abs()
            if dt == torch.float32:
                err = max(err, float(diff.max()))
                check(float(diff.max()) <= limit, f'{tag}: RoIAlign '
                      f'backward kernel disagrees with plain on level {lvl}')
            else:
                ulps = bf16_ulps(torch, g, wt.to(dt))
                err_bf16 = max(err_bf16, int(ulps[diff > limit].max())
                               if bool((diff > limit).any()) else 0)
                check(bool(((ulps <= 1) | (diff <= limit)).all()),
                      f'{tag}: RoIAlign backward kernel, bf16 maps, level '
                      f'{lvl}: more than one bf16 ulp from plain')
    del want, got
    live = grad.flatten(2).abs().amax(2) > 0  # (B, R): RoIs with a gradient
    n_samples, n_off = roi_sample_stats(torch, rois[live], levels[live],
                                        shapes, out_size=out_size,
                                        ratio=ratio)
    call_ms = events_ms(torch, lambda: roi_align_backward(*args), 10)
    # the kernel alone, a launch a call, by the mean of the profiler's
    # records: over n calls its time read 0.33 ms for the mask call's
    # kernel, which the call's events less memset and rounding put at 0.85
    ms, records = launch_ms(torch, lambda: roi_align_backward(*args),
                            'roi_align_backward_kernel', 10)
    src = 'profiler, a launch' if ms else 'events'
    ms = ms or call_ms
    plain_ms = events_ms(
        torch, lambda: roi_align_backward_plain(*args[:5], out_size, ratio),
        3)
    out_bytes = torch.empty((), dtype=dtype).element_size()
    nbytes = grad.numel() * 4 + rois.numel() * 4 + levels.numel() * 4 + \
        sum(b * c * hh * ww * out_bytes for hh, ww in shapes)
    ops = (n_samples - n_off) * c * 12.0  # per in-range sample and
    # channel: 4 weights, 4 products with g and 4 adds
    bms, by = bound_of(nbytes, ops)
    log(f'{tag}: roi_align_backward out {out_size} R={r} x {b} C={c} '
        f'{dtype}, {int(live.sum())} RoIs with a gradient: float32 '
        f'max_abs_err={err:.3e} (limit 1e-5*max|plain|; atomics reorder '
        f'the float32 sums), bf16 maps within one ulp (worst beyond '
        f'1e-5*max: {err_bf16} ulp); {ms:.4f} ms device ({src}, '
        f'{records} records of 10 calls; the kernel alone), '
        f'{call_ms:.4f} ms per call (events: memset, kernel, rounding '
        f'pass), plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}; '
        f'{nbytes} bytes, {ops / 1e9:.3f} GOP)')
    return dict(out=out_size, grad=list(grad.shape), maps=str(dtype),
                live_rois=int(live.sum()), ms=ms, call_ms=call_ms,
                ms_from=src, profiler_records=records, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, bound_bytes=nbytes, ops=ops,
                max_abs_err=err, max_bf16_ulps=err_bf16,
                samples_off_map=n_off / max(n_samples, 1))


def train_step_calls(np, torch, kind, names):
    """One bs-16, 800x1344 loss + backward of ``kind`` (bf16) with the
    calls of the named kernel wrappers captured: {name: [args, ...]}."""
    import importlib

    from erd_tpu_torch.engine import batch_to
    modules = {'roi_align': 'roi_align', 'roi_align_backward': 'roi_align',
               'nms_sorted_keep': 'nms', 'carafe': 'carafe',
               'carafe_backward': 'carafe'}
    _, det, net = train_net(torch, kind)
    batch = batch_to(next(iter(SyntheticLoader(
        np, torch, 1, seed=41, num_labels=det.num_classes).epoch(0))), DEV)
    calls = {n: [] for n in names}
    restore = [capture(importlib.import_module(
        f'erd_tpu_torch.ops.{modules[n]}'), n, calls[n]) for n in names]
    try:
        losses = det.loss(net, batch)
        sum(losses.values()).backward()
    finally:
        for undo in restore:
            undo()
    torch.cuda.synchronize()
    log(f'frcnn train kernels: one {kind} step captured: ' + ', '.join(
        f'{n} x{len(c)}' for n, c in calls.items()) + '; losses ' + ' '.join(
        f'{k} {float(v):.4f}' for k, v in losses.items()))
    del net, losses
    return calls


def phase_frcnn_train_kernels(np, torch):
    """RoIAlign's forward and backward kernels and the NMS on one bs-16,
    800x1344 Faster R-CNN step's calls, CARAFE's forward and backward
    kernels on one FPN-CARAFE step's, each against its plain version; then
    timed. Returns (rows, the RPN NMS call, the RoIAlign forward's box
    call, the CARAFE forward's calls)."""
    from erd_tpu_torch.ops import (carafe, carafe_backward,
                                   carafe_backward_plain, carafe_plain,
                                   map_roi_levels, nms_sorted_keep,
                                   nms_sorted_keep_plain)
    rows = []
    calls = train_step_calls(np, torch, 'frcnn', (
        'roi_align', 'roi_align_backward', 'nms_sorted_keep'))
    check([len(calls[n]) for n in calls] == [1, 1, 1],
          'unexpected kernel calls of one Faster R-CNN step')

    # -- row 7, the forward, on the box call with the edge RoIs planted
    feats, rois = calls['roi_align'][0][:2]
    check(tuple(rois.shape[:2]) == (TRAIN_BATCH, 512) and
          feats[0].shape[1] == 256 and feats[0].dtype == torch.bfloat16 and
          calls['roi_align'][0][4] == 7,
          f'RoIAlign box call at {tuple(rois.shape)}, {feats[0].dtype}')
    roi_forward = dict(config='frcnn', **roi_forward_call(
        torch, calls['roi_align'][0], 'frcnn train kernels'))
    del feats, rois

    # -- kernel A on the captured output gradient, the last 15 RoI slots of
    # every image replaced by edge cases: 6 off the image, 6 on its edges
    # or degenerate, one sized for each of levels 1-3
    grad, rois, levels, shapes, strides, dtype = calls['roi_align_backward'][
        0][:6]
    b, r, c = grad.shape[:3]
    check((b, r, c) == (TRAIN_BATCH, 512, 256) and dtype == torch.bfloat16
          and [tuple(s) for s in shapes] == level_sizes(ROI_STRIDES),
          f'RoIAlign backward call at {tuple(grad.shape)}, {dtype}, '
          f'{shapes}')
    edge = train_edge_rois(torch)
    rois = rois.clone()
    rois[:, -len(edge):] = edge
    grad = grad.clone()
    grad[:, -len(edge):] = torch.randn(
        (b, len(edge), c, 7, 7), device=DEV,
        generator=torch.Generator(device=DEV).manual_seed(3)) * grad.std()
    levels = map_roi_levels(rois, 4).contiguous()
    check(torch.equal(levels.cpu(), map_roi_levels(rois.cpu(), 4)),
          'RoI levels differ between card and CPU')
    per_level = torch.bincount(levels.flatten().long(), minlength=4)
    n_samples, n_off = roi_sample_stats(torch, rois, levels, shapes)
    log(f'frcnn train kernels: roi_align_backward R={r} x {b} C={c} levels '
        f'{per_level.tolist()}, {n_off}/{n_samples} samples off their map '
        f'({n_off / n_samples:.2%})')
    check(bool((per_level > 0).all()), 'RoIAlign backward missed a level')
    check(n_off >= 0.01 * n_samples, 'fewer than 1 % of the samples off '
          'their map')
    box = roi_backward_call(torch, (grad, rois, levels, shapes, strides,
                                    dtype, 7, 2), 'frcnn train kernels')
    box['config'] = 'frcnn'
    log('frcnn train kernels: roi_align_backward library_ms null: no '
        'single PyTorch call computes it')
    rows.append(dict(name='roi_align_backward', route='cuda',
                     source='erd_tpu_torch/csrc/roi_align.cu',
                     replaces='erd_tpu/ops/roi_align.py:92',
                     max_abs_err=box['max_abs_err'], ms=box['ms'],
                     call_ms=box['call_ms'], ms_from=box['ms_from'],
                     ms_at=f'box call {box["grad"]}',
                     plain_ms=box['plain_ms'], bound_ms=box['bound_ms'],
                     bound_by=box['bound_by'], library_ms=None,
                     deterministic=False, redesigned=True,
                     design='a block an (image, RoI); the gradient staged '
                     'a bin row at a time; sums along the bin row in '
                     'registers; float4 atomics into a channels-last '
                     'scratch; one rounding pass', shapes=[box],
                     samples_off_map=n_off / n_samples))

    # -- the NMS on the RPN call, K = 8819
    nargs = calls['nms_sorted_keep'][0]
    k, thr = nargs[0].shape[1], nargs[3]
    check(k == TRAIN_RPN_K and abs(thr - 0.7) < 1e-9,
          f'RPN NMS call at K={k}, IoU {thr}')
    got = nms_sorted_keep(*nargs)
    torch.cuda.synchronize()
    mism = int((got != nms_sorted_keep_plain(*nargs)).sum())
    call_ms = events_ms(torch, lambda: nms_sorted_keep(*nargs), 10)
    dev_ms = kernel_ms(torch, lambda: nms_sorted_keep(*nargs),
                       ['nms_mask_kernel', 'nms_reduce_kernel'], 10)
    parts = {part: kernel_ms(torch, lambda: nms_sorted_keep(*nargs),
                             [f'nms_{part}_kernel'], 10)
             for part in ('mask', 'reduce')}
    # the bound: per valid row the IoUs with every later box (14
    # operations each), per box its area; each box, flag and index read
    rows_valid = torch.nonzero(nargs[1])[:, 1].double()
    ops = 14.0 * float((k - 1 - rows_valid).sum()) + 3.0 * b * k
    bms, by = bound_of(b * k * (16 + 1 + 8) + b * k, ops)
    rpn_nms = dict(k=k, iou=thr, batch=b, ms=dev_ms or call_ms,
                   call_ms=call_ms, bound_ms=bms, bound_by=by,
                   graph_ms=graph_ms(torch, lambda: nms_sorted_keep(*nargs),
                                     10),
                   mask_ms=parts['mask'], reduce_ms=parts['reduce'],
                   valid=int(nargs[1].sum()), kept=int(got.sum()),
                   mismatches=mism)
    log(f'frcnn train kernels: nms K={k} x {b} iou={thr} valid '
        f'{rpn_nms["valid"]} kept {rpn_nms["kept"]} mismatches={mism} '
        f'(exact); {rpn_nms["ms"]:.4f} ms device (bitmask '
        f'{parts["mask"] or 0:.4f}, reduce {parts["reduce"] or 0:.4f}; '
        f'profiler), {rpn_nms["graph_ms"]:.4f} ms a call by graph replays, '
        f'{call_ms:.4f} ms per call (events); bound {bms:.4f} ms ({by})')
    check(mism == 0, f'NMS kernel disagrees with plain at K={k}')
    del calls, grad, rois

    # -- kernel B on the 3 backward calls of one FPN-CARAFE step
    calls = train_step_calls(np, torch, 'carafe',
                             ('carafe', 'carafe_backward'))
    sizes = [tuple(a[0].shape[2:]) for a in calls['carafe_backward']]
    check(sorted(sizes) == level_sizes((32, 16, 8)) and
          len(calls['carafe']) == 3,
          f'CARAFE backward calls of one step at {sizes}')
    carafe_train = []
    for x, logits in sorted((a[:2] for a in calls['carafe']),
                            key=lambda a: a[0].shape[2]):
        check(x.dtype == torch.bfloat16 and x.shape[0] == TRAIN_BATCH and
              x.shape[1] == 256, f'CARAFE call {tuple(x.shape)}: not bs 16 '
              f'bf16')
        x, logits = x.detach(), logits.detach()
        got = carafe(x, logits)
        torch.cuda.synchronize()
        want = carafe_plain(x, logits)
        ulps = int(bf16_ulps(torch, got, want).max())
        differ = int((got != want).sum())
        del got, want
        # the parent design differed from plain in no element at these
        # calls (atomic_backward_probe.py part 10)
        check(ulps <= 1 and differ == 0, f'CARAFE forward kernel at '
              f'{tuple(x.shape)}: {differ} elements differ from plain, up '
              f'to {ulps} bf16 ulp')
        ms, call_ms, src, plain_ms = time_graph(
            torch, lambda: carafe(x, logits), lambda: carafe_plain(x, logits),
            n=10)
        nbytes, ops = carafe_cost(x, logits)
        bms, by = bound_of(nbytes, ops)
        carafe_train.append(dict(x=list(x.shape), ms=ms, call_ms=call_ms,
                                 ms_from=src, plain_ms=plain_ms,
                                 bound_ms=bms, bound_by=by,
                                 bound_bytes=nbytes, max_bf16_ulps=ulps,
                                 elements_differ=differ))
        log(f'frcnn train kernels: carafe {tuple(x.shape)}: {ulps} bf16 ulp '
            f'at most, {differ} elements differ from plain; {ms:.4f} ms '
            f'device ({src}), {call_ms:.4f} ms per call, plain '
            f'{plain_ms:.3f} ms, bound {bms:.4f} ms ({by}; {nbytes} bytes)')
    shapes_out, worst, worst_ulps = [], 0.0, 0
    for x, logits, g in sorted((a[:3] for a in calls['carafe_backward']),
                               key=lambda a: a[0].shape[2]):
        check(x.dtype == torch.bfloat16 and g.dtype == torch.bfloat16 and
              x.shape[0] == TRAIN_BATCH and x.shape[1] == 256,
              f'CARAFE backward call {tuple(x.shape)}: not bs 16 bf16')
        got = carafe_backward(x, logits, g)
        torch.cuda.synchronize()
        want = carafe_backward_plain(x, logits, g)
        x32, l32, g32 = x.float(), logits.float(), g.float()
        got32 = carafe_backward(x32, l32, g32)
        want32 = carafe_backward_plain(x32, l32, g32)
        for part, gb, wb, g32_, w32 in zip(('dx', 'dlogits'), got, want,
                                          got32, want32):
            limit = 1e-5 * float(w32.abs().max())
            e32 = float((g32_ - w32).abs().max())
            diff = (gb.float() - wb.float()).abs()
            ulps = bf16_ulps(torch, gb, wb)
            far = diff > 1e-5 * float(wb.float().abs().max())
            worst_ulps = max(worst_ulps, int(ulps[far].max()) if
                             bool(far.any()) else 0)
            worst = max(worst, e32)
            log(f'frcnn train kernels: carafe_backward {tuple(x.shape)} '
                f'{part}: float32 max_abs_err={e32:.3e} (limit 1e-5*max'
                f'|plain| = {limit:.3e}), bf16 worst {int(ulps.max())} ulp '
                f'({int(far.sum())} elements beyond 1e-5*max|plain|, at most '
                f'{worst_ulps} ulp)')
            check(e32 <= limit, f'CARAFE backward kernel disagrees with '
                  f'plain ({part}, float32)')
            check(bool(((ulps <= 1) | ~far).all()), f'CARAFE backward '
                  f'kernel, bf16 {part}: more than one ulp from plain')
        ms, call_ms, src, plain_ms = time_graph(
            torch, lambda: carafe_backward(x, logits, g),
            lambda: carafe_backward_plain(x, logits, g), n=10)
        # its two launches apart: a launch by the mean of the profiler's
        # records
        passes = {part: launch_ms(torch, lambda: carafe_backward(
            x, logits, g), f'carafe_backward_{part}_kernel', 10)[0]
            for part in ('logits', 'x')}
        nbytes, ops, bf16_ops = carafe_backward_cost(x, logits, g)
        bms, by = bound_of(nbytes, ops, bf16_ops)
        shapes_out.append(dict(x=list(x.shape), ms=ms, call_ms=call_ms,
                               ms_from=src, plain_ms=plain_ms, bound_ms=bms,
                               bound_by=by, bound_bytes=nbytes, ops=ops,
                               bf16_ops=bf16_ops, logits_pass_ms=passes[
                                   'logits'], x_pass_ms=passes['x']))
        log(f'frcnn train kernels: carafe_backward {tuple(x.shape)}: '
            f'{ms:.4f} ms device ({src}; dlogits launch '
            f'{passes["logits"] or 0:.4f}, dx launch {passes["x"] or 0:.4f}, '
            f'profiler), {call_ms:.4f} ms per call, plain '
            f'{plain_ms:.3f} ms, bound {bms:.4f} ms ({by}; {nbytes} bytes, '
            f'{ops / 1e9:.3f} GOP float32, {bf16_ops / 1e9:.3f} GOP bf16)')
    log('frcnn train kernels: library_ms is null for both backward kernels: '
        'no single PyTorch call computes them')
    big = shapes_out[-1]
    rows.append(dict(name='carafe_backward', route='cuda',
                     source='erd_tpu_torch/csrc/carafe.cu',
                     replaces='erd_tpu/ops/carafe.py:23', max_abs_err=worst,
                     max_bf16_ulps=worst_ulps, ms=big['ms'],
                     call_ms=big['call_ms'], ms_from=big['ms_from'],
                     ms_at=f'x {big["x"]}', plain_ms=big['plain_ms'],
                     bound_ms=big['bound_ms'], bound_by=big['bound_by'],
                     library_ms=None, deterministic=True,
                     redesigned=True, design='tiles of source pixels, '
                     'inputs staged by cp.async a channel chunk ahead; '
                     'dlogits: 100 float32 dw sums a pixel in registers; '
                     'dx: 100 gather weights a pixel in registers; no '
                     'scratch', shapes=shapes_out,
                     per_step_ms=sum(t['ms'] for t in shapes_out)))
    del calls
    torch.cuda.empty_cache()
    return rows, rpn_nms, roi_forward, carafe_train


@contextlib.contextmanager
def patched(owner, attr, make):
    """Within the block ``owner.attr`` (a module's function or an
    instance's method) is ``make(the original)``."""
    had = attr in vars(owner)
    fn = getattr(owner, attr)
    setattr(owner, attr, make(fn))
    try:
        yield
    finally:
        if had:
            setattr(owner, attr, fn)
        else:
            delattr(owner, attr)


def planted(index=None, when=None):
    """A control for reference_gate: makes, from a backward kernel's
    wrapper, one whose gradient at ``index`` (every one for None) is scaled
    by 1.01 on the calls whose arguments ``when`` accepts (all for None).
    The new wrapper takes the launch count the kernel adds to its name."""
    def make(fn):
        def wrapper(*args):
            out = fn(*args)
            if when is not None and not when(args):
                return out
            if hasattr(out, 'dim'):  # a backward that gives one tensor
                return out * 1.01
            return type(out)(g if g is None or index not in (None, i)
                             else g * 1.01 for i, g in enumerate(out))
        wrapper.launches = 0
        return wrapper
    return make


def reference_gate(np, torch, tag, run, names, parts, controls=(),
                   floor=1e-6):
    """The gate of a train reference. ``run(dev)`` gives (losses {name:
    float}, gradients {group: {key: float64 CPU tensor}}) of one float32
    loss and backward; the CPU run (plain versions) comes first, then the
    card's (kernels). Limits: each loss within rtol 1e-3; ||diff|| / ||g||
    <= 1e-3 over the parameters ``names`` (their gradients summed over the
    groups), and within its limit over each part (label, group or None for
    the sum, keys, limit) whose CPU gradient is not 0; per parameter
    ||diff|| / (||g|| + ``floor`` * the largest ||g||) <= 1e-2, the second
    term for a tensor whose gradient is 0 but for rounding. Then each
    control (label, module, attribute, planted(...)) replaces that kernel
    wrapper for one more card run, which must fail these limits."""
    def total(grads):
        return {k: sum(g[k] for g in grads.values())
                for k in next(iter(grads.values()))}

    def ratio(a, b, keys):
        diff = torch.cat([(a[k] - b[k]).flatten() for k in keys])
        ref = torch.cat([b[k].flatten() for k in keys])
        return float(diff.norm() / ref.norm().clamp(min=1e-30))

    l_cpu, g_cpu = run('cpu')
    t_cpu = total(g_cpu)
    scale = floor * max(float(t_cpu[k].norm()) for k in names)
    live = [(label, group, keys, lim) for label, group, keys, lim in parts
            if any(float((t_cpu if group is None else g_cpu[group])[k]
                         .norm()) > 0 for k in keys)]

    def errors(l_dev, g_dev):
        t_dev = total(g_dev)
        per_tensor = sorted(((float((t_dev[k] - t_cpu[k]).norm()) / max(
            float(t_cpu[k].norm()) + scale, 1e-30), k) for k in names),
            reverse=True)
        metrics = [('loss', max(abs(l_dev[k] - l_cpu[k]) /
                                max(abs(l_cpu[k]), 1e-12) for k in l_cpu),
                    1e-3),
                   ('whole gradient', ratio(t_dev, t_cpu, names), 1e-3)]
        metrics += [(label, ratio(t_dev, t_cpu, keys) if group is None else
                     ratio(g_dev[group], g_cpu[group], keys), lim)
                    for label, group, keys, lim in live]
        metrics.append(('per tensor', per_tensor[0][0], 1e-2))
        return per_tensor, metrics

    def describe(metrics):
        return ', '.join(f'{name} {v:.2e} (limit {lim:g})'
                         for name, v, lim in metrics)

    l_gpu, g_gpu = run(DEV)
    per_tensor, metrics = errors(l_gpu, g_gpu)
    log(f'{tag} loss card vs CPU: ' + ', '.join(
        f'{k} {l_gpu[k]:.5f}/{l_cpu[k]:.5f}' for k in l_cpu))
    log(f'{tag} card vs CPU over {len(names)} trainable tensors: '
        f'{describe(metrics)}; worst tensors: ' +
        ', '.join(f'{k} {v:.2e}' for v, k in per_tensor[:3]))
    check(all(np.isfinite(v) for v in l_gpu.values()),
          f'{tag}: non-finite loss')
    check(all(np.isfinite(v) and v <= lim for _, v, lim in metrics),
          f'{tag}: the loss or gradients on the card disagree with the CPU')
    for label, module, attr, make in controls:
        with patched(module, attr, make):
            _, metrics = errors(*run(DEV))
        tripped = [m for m, v, lim in metrics if not v <= lim]
        log(f'{tag} control, {label}: {describe(metrics)}; over the limit: '
            f'{tripped}')
        check(tripped, f'{tag}: the gate passes the control {label}')


@contextlib.contextmanager
def stage_marks(torch, optimizer, hooks=(), wrapped=()):
    """Within the block, every stage of a training step that
    ``Trainer.train_step`` runs ends with a synchronize and appends (name,
    time) to the list it yields, after a ('start', time) mark: a forward
    hook on each (module, name) of ``hooks``, each (owner, attribute, name)
    of ``wrapped`` marked when its call returns, and the optimizer's step
    hooks ('backward', 'optimizer')."""
    marks = []

    def mark(name):
        torch.cuda.synchronize()
        marks.append((name, time.perf_counter()))

    def marked(name):
        def make(fn):
            def wrapper(*args, **kw):
                out = fn(*args, **kw)
                mark(name)
                return out
            return wrapper
        return make

    handles = [m.register_forward_hook(lambda *_, name=name: mark(name))
               for m, name in hooks]
    handles += [optimizer.register_step_pre_hook(lambda *_: mark('backward')),
                optimizer.register_step_post_hook(
                    lambda *_: mark('optimizer'))]
    try:
        with contextlib.ExitStack() as stack:
            for owner, attr, name in wrapped:
                stack.enter_context(patched(owner, attr, marked(name)))
            mark('start')
            yield marks
    finally:
        for h in handles:
            h.remove()


def fit_and_check(np, torch, card, tag, cfg, det, net, counters, per_step,
                  seed, unmoved=None, must_move=None, loader=None,
                  dtype=None, frozen=None):
    """build_trainer + fit of ``net`` on TRAIN_WARMUP + TRAIN_TIMED
    synthetic batches (``loader``, by default bs-16, 800x1344 with
    ``seed``), every launch count of ``counters`` set to 0 just before fit
    and read just after. Checks: the compute dtype (bf16 unless ``dtype``);
    each count ``per_step`` times the steps; every loss finite; the
    parameters of the frozen stages (``frozen`` prefixes, by default the
    ResNet's of ``det.frozen_stages``) unchanged and not trainable; every
    trainable weight moved, or excused by ``unmoved(trainer, net, name,
    steps)``; some of them named with ``must_move``; every BN running
    statistic moved where the network has train-mode BN. Logs the steps,
    img/s and peak memory. Returns (trainer, loader, the launch counts)."""
    from erd_tpu_torch.apis import build_trainer
    from erd_tpu_torch.engine import resnet_frozen_paths
    dtype = dtype or torch.bfloat16
    check(getattr(det, 'compute_dtype', torch.float32) == dtype,
          f'{tag}: not {dtype}')
    if frozen is None:
        frozen = resnet_frozen_paths(det.frozen_stages)
    start = {k: v.clone() for k, v in net.state_dict().items()}
    timer = step_timer(torch)
    cfg.train_cfg.epochs = 1
    steps = TRAIN_WARMUP + TRAIN_TIMED
    loader = loader or SyntheticLoader(np, torch, steps, seed=seed,
                                       num_labels=det.num_classes)
    batch = loader.cfg.batch_size
    trainer = build_trainer(cfg, det, loader, device=DEV)
    trainer.hooks.append(timer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    trainer.fit(net)
    counts = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    log(f'{tag}: launches on the train path {counts}')
    want = {k: v * steps for k, v in per_step.items()}
    check(counts == want, f'{tag}: launches {counts}, expected {want}')
    step_s = [t1 - t0 for t0, t1 in zip(timer.t, timer.t[1:])]
    timed = step_s[TRAIN_WARMUP:]
    for i, (dt, losses) in enumerate(zip(step_s, timer.losses)):
        log(f'{tag}: step {i} {1e3 * dt:.1f} ms lr '
            f'{trainer.current_lr(i):.3e} total {sum(losses.values()):.5f} '
            + ' '.join(f'{k} {v:.5f}' for k, v in losses.items()
                       if '_aux' not in k))
        check(all(np.isfinite(v) for v in losses.values()),
              f'{tag}: non-finite loss at step {i}')
    state = net.state_dict()
    trainable = {n for n, p in net.named_parameters() if p.requires_grad}
    moved = {k for k, v in state.items() if not torch.equal(v, start[k])}
    # train-mode BN (CornerNet) moves the frozen stem's running statistics
    stats = [k for k in state if k.endswith(('running_mean', 'running_var'))
             and det.__class__.__name__ == 'CornerNetDetector']
    changed = moved - set(stats)
    check(not any(k.startswith(frozen) for k in changed | trainable),
          f'{tag}: a frozen-stage parameter changed or is trainable')
    weights = {k for k in trainable if state[k].dim() > 1}
    still = sorted(k for k in weights - moved
                   if unmoved is None or not unmoved(trainer, net, k, steps))
    check(not still, f'{tag}: a trainable weight did not move: ' +
          ', '.join(still[:5]))
    named = ''
    if must_move:
        n = sum(must_move in k for k in weights & moved)
        check(n, f'{tag}: no {must_move} weight among the trainable ones')
        named = f' ({n} {must_move.strip(".")} weights)'
    if stats:
        check(set(stats) <= moved, f'{tag}: a BN running statistic did not '
              f'move')
        named += f', {len(stats)} BN running statistics moved'
    canvas = 'x'.join(map(str, loader.canvas))
    dname = {torch.bfloat16: 'bf16', torch.float32: 'float32'}[dtype]
    log(f'{tag}: bs {batch} {canvas} {dname}, {len(timed)} timed steps ' +
        ' '.join(f'{1e3 * t:.1f}' for t in timed) +
        f' ms; {batch * len(timed) / sum(timed):.2f} img/s; peak '
        f'memory {peak / 2**20:.0f} MiB; {len(moved & trainable)}/'
        f'{len(trainable)} trainable tensors moved{named}, 0 frozen '
        f'changed; card {card}')
    return trainer, loader, counts


def step_breakdown(torch, tag, trainer, net, loader, hooks=(), wrapped=(),
                   host=None):
    """The stage ms of one step of the trainer's own train_step, each stage
    ended by a synchronize (stage_marks), then the device idle share of one
    profiled step. ``host`` (owner, attribute, label, stage): the host time
    of that function's calls, logged as ``label`` and taken out of
    ``stage``, which holds them."""
    from erd_tpu_torch.engine import batch_to
    batch = batch_to(next(iter(loader.epoch(1))), DEV)
    spent = []

    def timed(fn):
        def wrapper(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            spent.append(time.perf_counter() - t0)
            return out
        return wrapper

    with contextlib.ExitStack() as stack:
        if host:
            stack.enter_context(patched(host[0], host[1], timed))
        marks = stack.enter_context(stage_marks(torch, trainer.optimizer,
                                                hooks, wrapped))
        trainer.train_step(net, batch, 100)
    stages = [(name, 1e3 * (t - marks[i][1]))
              for i, (name, t) in enumerate(marks[1:])]
    if host:
        at = [name for name, _ in stages].index(host[3])
        stages[at] = (host[3], stages[at][1] - 1e3 * sum(spent))
        stages.insert(at, (f'{host[2]} (host, {len(spent)} calls)',
                           1e3 * sum(spent)))
    log(f'{tag}: stage ms of one step: ' + ', '.join(
        f'{name} {ms:.2f}' for name, ms in stages) +
        f'; total {1e3 * (marks[-1][1] - marks[0][1]):.2f}')
    profile_train_step(torch, lambda: trainer.train_step(net, batch, 100),
                       tag)


def phase_frcnn_train_reference(np, torch):
    """For each two-stage config, full width in float32 on a small input:
    the loss dict and the parameter gradients on the card (kernels) against
    the CPU (plain versions), with the same sampler draws (reference_gate,
    per tensor without a floor; the RPN's and the R-CNN's gradients apart
    over backbone + neck and over the heads); then two controls on
    FPN-CARAFE, a 1 % error planted in the RoIAlign or the CARAFE backward
    kernel, which must each fail the same limits."""
    import copy
    import importlib

    from erd_tpu_torch.structures import ImageMeta, stack_to
    roi_module = importlib.import_module('erd_tpu_torch.ops.roi_align')
    carafe_module = importlib.import_module('erd_tpu_torch.ops.carafe')
    frcnn_module = importlib.import_module(
        'erd_tpu_torch.models.detectors.faster_rcnn')
    proposals_fn = frcnn_module.rpn_proposals
    h, w = 128, 192

    for kind in TWO_STAGE_TRAIN:
        _, det, net_cpu = train_net(torch, kind, device='cpu',
                                    dtype='float32', seed=7)
        rs = np.random.RandomState(17)
        images = torch.from_numpy(rs.randint(0, 256, (2, h, w, 3),
                                             np.uint8))
        gt = synthetic_gt(np, torch, rs, 2, (h, w), device='cpu',
                          num_labels=det.num_classes)
        metas = [ImageMeta.make((h, w), (h, w), (1.0, 1.0), img_id=i)
                 for i in (1, 2)]
        ctx = det.anchor_context((h, w))
        draws = det.train_draws(torch.tensor([1, 2]), 2, ctx.num_anchors,
                                det.proposal_cfg_train.max_per_img + MAX_GT,
                                'cpu')
        names = [k for k, p in net_cpu.named_parameters() if p.requires_grad]
        low = [k for k in names if k.startswith(('backbone.', 'neck.'))]
        high = [k for k in names if k not in low]

        cpu_proposals, moved = [], []

        def proposals(*args):
            """The CPU run's proposals, recorded; the card runs compute
            their own, hold them against the CPU's and go on with the CPU's,
            so that both sample the same RoIs. Masks must be equal and boxes
            within 1e-2 px, but for adjacent slots whose boxes are swapped
            where the card's scores are within PROPOSAL_SCORE_RTOL: a
            near-tie whose order float noise decides, which would otherwise
            change single samples. Records (slots that differ, slots that
            are no such swap)."""
            out = proposals_fn(*args)
            if not cpu_proposals:
                cpu_proposals.append(out)
                return out
            want = [t.to(out[0].device) for t in cpu_proposals[0]]
            moved.append(proposal_swaps(out, want))
            return tuple(want)

        def run(dev):
            net = copy.deepcopy(net_cpu).to(dev)
            batch = dict(images=images.to(dev), meta=stack_to(metas, dev),
                         gt=type(gt)(**{k: None if v is None else v.to(dev)
                                        for k, v in vars(gt).items()}))
            with patched(frcnn_module, 'rpn_proposals', lambda _: proposals):
                losses = det.loss(net, batch,
                                  draws=[d.to(dev) for d in draws])
            params = dict(net.named_parameters())
            parts = {'rpn': [k for k in losses if k.startswith('loss_rpn')]}
            parts['rcnn'] = [k for k in losses if k not in parts['rpn']]
            grads = {}
            for i, (part, keys) in enumerate(parts.items()):
                gs = torch.autograd.grad(
                    sum(losses[k] for k in keys), [params[k] for k in names],
                    retain_graph=i == 0, allow_unused=True)
                grads[part] = {k: (torch.zeros_like(params[k]) if g is None
                                   else g).double().cpu()
                               for k, g in zip(names, gs)}
            return {k: float(v.detach()) for k, v in losses.items()}, grads

        parts = [(f'{group} gradient, {scope}', group, keys, 1e-3)
                 for group in ('rpn', 'rcnn')
                 for scope, keys in (('backbone+neck', low), ('heads', high))]
        controls = [(f'{name} x 1.01', module, name, planted())
                    for module, name in ((roi_module, 'roi_align_backward'),
                                         (carafe_module, 'carafe_backward'))
                    ] if kind == 'carafe' else []
        reference_gate(np, torch, f'frcnn train reference: {kind} float32 '
                       f'{h}x{w} x 2', run, names, parts, controls, floor=0)
        slots = cpu_proposals[0][2].numel()
        log(f'frcnn train reference: {kind} card on the CPU\'s proposals: '
            f'{moved[0][0]} of {slots} proposal slots differ on the card, '
            f'{moved[0][1]} of them not an adjacent near-tie swap')
        check(moved[0][1] == 0 and
              moved[0][0] <= PROPOSAL_MOVED_SHARE * slots,
              f'{kind}: the card\'s training proposals differ from the '
              f'CPU\'s beyond adjacent near-tie swaps in '
              f'{PROPOSAL_MOVED_SHARE:.1%} of the slots')


def phase_frcnn_train(np, torch, card):
    """build_trainer + fit of each two-stage config at bs 16, 800x1344,
    bf16 (fit_and_check): 2 warm-up and 5 timed steps, the launches of
    every kernel of the path, finite losses, frozen stages unchanged; stage
    times and the idle share of one profiled step."""
    import importlib

    from erd_tpu_torch.ops import (carafe, carafe_backward, nms_sorted_keep,
                                   roi_align, roi_align_backward)
    frcnn = importlib.import_module(
        'erd_tpu_torch.models.detectors.faster_rcnn')
    counters = {'roi_align': roi_align,
                'roi_align_backward': roi_align_backward,
                'nms_keep': nms_sorted_keep, 'carafe': carafe,
                'carafe_backward': carafe_backward}
    launches = {}
    for kind in TWO_STAGE_TRAIN:
        tag = f'{kind} train'
        cfg, det, net = train_net(torch, kind)
        trainer, loader, launches[tag] = fit_and_check(
            np, torch, card, tag, cfg, det, net, counters,
            TRAIN_STEP_LAUNCHES[kind], seed=51)
        step_breakdown(
            torch, tag, trainer, net, loader,
            hooks=[(net.neck, 'backbone + neck'), (net.rpn_head, 'RPN head')],
            wrapped=[(frcnn, 'rpn_loss', 'RPN loss'),
                     (frcnn, 'rpn_proposals',
                      f'proposals (NMS K={TRAIN_RPN_K})'),
                     (frcnn, 'rcnn_sample', 'assign + sample'),
                     (det, 'rcnn_losses', 'RoIAlign + R-CNN head + loss')])
        del net, trainer
        torch.cuda.empty_cache()
    return launches


# the sampling calls of one DETR training step: 6 encoder + 6 decoder
DETR_STEP_CALLS = 12


def detr_train_net(torch, kind, device=None, dtype=None, seed=37):
    """A DETR config's detector and a seeded network (sampling weights
    arranged), on ``device`` (the card by default)."""
    from erd_tpu_torch.apis import build_detector
    from erd_tpu_torch.config import Config
    from erd_tpu_torch.models.heads import arrange_sampling
    cfg = Config.fromfile(DETR_CONFIGS[kind])
    if dtype:
        cfg.model.compute_dtype = dtype
    det = build_detector(cfg.model)
    want = {'dino': ('DINODetector', 900), 'deformable_detr': (
        'DeformableDETRDetector', 300)}[kind]
    check(type(det).__name__ == want[0] and det.depth == 50 and
          det.num_classes == NUM_CLASSES and det.num_queries == want[1] and
          det.frozen_stages == 1, f'not the {kind} R50 model')
    net = det.init(seed=seed, device=device or DEV)
    arrange_sampling(net, DETR_ARRANGE_SEED)
    return cfg, det, net


def deform_attn_backward_cost(torch, shapes, values, locs, weights):
    """(bytes, operations) of one sampling backward call. Bytes: the
    distinct value rows its in-range corners read (as the forward's), the
    output gradient, the locations and the weights read once; the value
    gradient (the whole tensor), the location and the weight gradients
    written once. Operations: per sample ~26 per channel (4 coefficient
    products, 4 corner terms, 2 differences and the 3 channel products of
    the gradients, the 3 reductions, 4 scaled scatter adds) and ~20 of
    coordinates."""
    nbytes, _ = deform_attn_cost(torch, shapes, values, locs, weights)
    b, q, heads = locs.shape[:3]
    # deform_attn_cost counted the forward's output write; the backward
    # reads the output gradient of the same size instead
    nbytes += values.numel() * 4 + locs.numel() * 4 + weights.numel() * \
        weights.element_size()
    samples = locs.numel() // 2
    return nbytes, samples * (26.0 * values.shape[3] + 20)


def phase_detr_train_kernels(np, torch):
    """The sampling backward kernel on the 12 calls of one bs-16, 800x1344
    bf16 training step of each DETR config (sampling weights arranged),
    against its plain version; then timed at the encoder's and the
    decoders' call shapes. The step's 12 forward calls too
    (``detr_train_forward``), returned apart for row 9."""
    import importlib

    from erd_tpu_torch.engine import batch_to
    from erd_tpu_torch.ops import (ms_deform_attn_backward,
                                   ms_deform_attn_backward_plain)
    from erd_tpu_torch.ops.ms_deform_attn import ms_deform_attn_backward_run
    ops_module = importlib.import_module('erd_tpu_torch.ops.ms_deform_attn')
    head_module = importlib.import_module(
        'erd_tpu_torch.models.heads.deformable_detr_head')
    stats, timed_calls = {}, {}
    worst_abs, worst = [0.0, 0.0, 0.0], [0.0, 0.0, 0.0]
    forward = dict(shapes=[], per_step_ms={}, max_abs_err=0.0)
    for kind in DETR_CONFIGS:
        _, det, net = detr_train_net(torch, kind)
        batch = batch_to(next(iter(SyntheticLoader(
            np, torch, 1, seed=41, num_labels=NUM_CLASSES).epoch(0))), DEV)
        calls, fcalls = [], []
        restore = capture(ops_module, 'ms_deform_attn_backward', calls)
        restore_f = capture(head_module, 'ms_deform_attn', fcalls)
        try:
            losses = det.loss(net, batch)
            sum(losses.values()).backward()
        finally:
            restore()
            restore_f()
        torch.cuda.synchronize()
        del net, losses
        calls, fcalls = ([tuple(a.detach() if torch.is_tensor(a) else a
                                for a in c) for c in cs]
                         for cs in (calls, fcalls))
        torch.cuda.empty_cache()
        detr_train_forward(torch, kind, fcalls, forward)
        del fcalls
        n_tok = calls[0][0].shape[1]
        t = min(det.num_queries, n_tok) if kind == 'dino' else \
            det.num_queries
        if kind == 'dino':  # the denoising queries ahead of the matching
            t += 2 * MAX_GT * det.train_cfg.dn_groups
        qs = sorted(c[2].shape[1] for c in calls)
        check(len(calls) == DETR_STEP_CALLS and
              qs == sorted([t] * 6 + [n_tok] * 6) and
              [c[2].shape[1] for c in calls[6:]] == [n_tok] * 6 and
              all(c[0].shape[0] == TRAIN_BATCH for c in calls),
              f'{kind}: sampling backward calls of one step at Q = {qs}')
        for i, args in enumerate(calls):
            values, shapes, locs, weights, grad = args
            part = 'encoder' if i >= 6 else 'decoder'
            counts = stats.setdefault(f'{kind} {part}', [0, 0, 0])
            for j, v in enumerate(sample_stats(torch, shapes, locs)):
                counts[j] += v
            got = ms_deform_attn_backward(values, shapes, locs,
                                          weights.float(), grad)
            torch.cuda.synchronize()
            want = ms_deform_attn_backward_plain(values, shapes, locs,
                                                 weights.float(), grad)
            errs = []
            for j, (name, g, w) in enumerate(zip(
                    ('values', 'locations', 'weights'), got, want)):
                err = float((g - w).abs().max())
                limit = 1e-5 * float(w.abs().max())
                errs.append(f'{name} {err:.3e} (limit {limit:.3e})')
                check(err <= limit, f'{kind}: sampling backward kernel '
                      f'disagrees with plain on call {i} ({name})')
                worst_abs[j] = max(worst_abs[j], err)
                worst[j] = max(worst[j], err / float(w.abs().max()))
            if weights.dtype == torch.bfloat16:  # rounded once, exactly
                gw = ms_deform_attn_backward(*args)[2]
                check(gw.dtype == torch.bfloat16 and
                      torch.equal(gw, got[2].bfloat16()), f'{kind}: the '
                      f'bf16 weight gradient is not the float32 one rounded')
            log(f'detr train kernels: {kind} ms_deform_attn_backward call '
                f'{i} ({part}) Q={locs.shape[1]} x {locs.shape[0]} weights '
                f'{weights.dtype}: max_abs_err ' + ', '.join(errs) +
                ' (limits 1e-5*max|plain|; atomics reorder the value sums)')
            del got, want
        # backward order: the decoder's 6 calls, then the encoder's
        timed_calls.setdefault('encoder', calls[6])
        timed_calls[f'{kind} decoder'] = calls[0]
        del calls, batch
        torch.cuda.empty_cache()
    total = [sum(v[j] for v in stats.values()) for j in range(3)]
    for part, (n, frac, out) in list(stats.items()) + [('all', total)]:
        log(f'detr train kernels: {part} samples {n}: fractional bilinear '
            f'weight {frac / n:.4f}, a corner outside its map {out / n:.4f}')
    check(total[1] >= 0.5 * total[0], 'fewer than 50 % of the samples have '
          'a fractional bilinear weight: the interpolation goes unchecked')
    check(total[2] >= 0.01 * total[0], 'fewer than 1 % of the samples reach '
          'outside their map: the zero padding goes unchecked')

    # the kernel's ms: CUDA events around the call less the zeroing of its
    # value gradient, timed alone; the profiler's per-kernel sum read
    # 5.2 ms for a 13 ms encoder call in one run (records dropped), so it
    # is logged beside, not used
    timed = {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, args in timed_calls.items():
        prof_ms, call_ms, _, plain_ms = time_pair(
            torch, lambda: ms_deform_attn_backward(*args),
            lambda: ms_deform_attn_backward_plain(*args),
            ['ms_deform_attn_backward_kernel'], n=10)
        values, shapes, locs, weights, _ = args
        run = ms_deform_attn_backward_run(locs.shape[0], locs.shape[1],
                                          locs.shape[2], sms)
        blocks = locs.shape[0] * locs.shape[2] * -(-locs.shape[1] // run)
        zero_ms = events_ms(torch, lambda: torch.zeros(
            values.shape, dtype=torch.float32, device=DEV), 10)
        ms = call_ms - zero_ms
        nbytes, ops = deform_attn_backward_cost(torch, shapes, values, locs,
                                                weights)
        bms, by = bound_of(nbytes, ops)
        timed[name] = dict(q=locs.shape[1], ms=ms, call_ms=call_ms,
                           zero_ms=zero_ms, profiler_ms=prof_ms,
                           ms_from='events less zeroing', plain_ms=plain_ms,
                           bound_ms=bms, bound_by=by, bound_bytes=nbytes,
                           ops=ops, ratio=ms / bms,
                           plan=dict(run=run, blocks=blocks))
        log(f'detr train kernels: ms_deform_attn_backward {name} '
            f'Q={locs.shape[1]} x {locs.shape[0]}, blocks of {run} queries '
            f'of one (image, head), {blocks} blocks: {ms:.4f} ms '
            f'({call_ms:.4f} ms per call by events, less {zero_ms:.4f} ms of the value '
            f'gradient\'s zeroing; the profiler read {prof_ms:.4f}), plain '
            f'{plain_ms:.3f} ms, bound {bms:.4f} ms ({by}; {nbytes} bytes, '
            f'{ops / 1e9:.3f} GOP), {ms / bms:.1f}x the bound')
    log('detr train kernels: library_ms is null: no single PyTorch call '
        'forms these gradients (F.grid_sample\'s backward interpolates one '
        'level per call and neither weights nor sums the points)')
    per_step, per_step_kernel = ({
        kind: 6 * timed['encoder'][key] + 6 * timed[f'{kind} decoder'][key]
        for kind in DETR_CONFIGS} for key in ('call_ms', 'ms'))
    for kind, step_ms in per_step.items():
        log(f'detr train kernels: {kind} sampling backward calls of one '
            f'step (6 encoder, 6 decoder) {step_ms:.2f} ms (events, call '
            f'time; {per_step_kernel[kind]:.2f} ms less the zeroing)')
    enc = timed.pop('encoder')
    row = dict(name='ms_deform_attn_backward', route='cuda',
               source='erd_tpu_torch/csrc/ms_deform_attn.cu',
               replaces='erd_tpu/ops/ms_deform_attn.py:18',
               max_abs_err=max(worst_abs),
               max_abs_err_by_part=dict(zip(
                   ('values', 'locations', 'weights'), worst_abs)),
               max_err_over_max_plain_by_part=dict(zip(
                   ('values', 'locations', 'weights'), worst)),
               ms=enc['ms'], call_ms=enc['call_ms'], ms_from=enc['ms_from'],
               ms_at=f'encoder call Q={enc["q"]} x {TRAIN_BATCH}',
               plain_ms=enc['plain_ms'], bound_ms=enc['bound_ms'],
               bound_by=enc['bound_by'], library_ms=None,
               deterministic=False, decoder_calls=timed,
               encoder_plan=enc['plan'], per_step_ms=per_step,
               per_step_less_zeroing_ms=per_step_kernel, redesigned=True,
               design='float4 lanes, 4 samples a warp, one reduce-scatter; '
               'a block a run of one head\'s queries',
               sample_share={'fractional': total[1] / total[0],
                             'outside': total[2] / total[0]})
    del timed_calls
    torch.cuda.empty_cache()
    return row, forward


def detr_train_forward(torch, kind, calls, out):
    """The sampling forward (row 9) on the 12 captured calls of one bs-16
    training step of ``kind``: each bit-equal to its plain version (and
    within 1e-6 * max|value|, the serving gate); then each distinct call
    shape (Q, the weights' dtype) timed (CUDA-graph replays, and events
    around the call) beside its plain version and its bound, and the
    step's calls summed by call time into ``out``."""
    from erd_tpu_torch.ops import ms_deform_attn, ms_deform_attn_plain
    n_tok = calls[0][0].shape[1]
    check(len(calls) == DETR_STEP_CALLS and
          [c[2].shape[1] for c in calls[:6]] == [n_tok] * 6 and
          all(c[0].shape[0] == TRAIN_BATCH for c in calls),
          f'{kind}: sampling forward calls of one step at Q = '
          f'{[c[2].shape[1] for c in calls]}')
    shapes = {}
    for i, args in enumerate(calls):
        got = ms_deform_attn(*args)
        torch.cuda.synchronize()
        want = ms_deform_attn_plain(*args[:3], args[3].float())
        err = float((got - want).abs().max())
        limit = 1e-6 * float(args[0].abs().max())
        check(err <= limit and torch.equal(got, want), f'{kind}: sampling '
              f'kernel not bit-equal to plain on training call {i} '
              f'(max_abs_err {err:.3e})')
        out['max_abs_err'] = max(out['max_abs_err'], err)
        key = (args[2].shape[1], str(args[3].dtype))
        shapes.setdefault(key, [args, 0])[1] += 1
        del got, want
    log(f'detr train kernels: {kind} ms_deform_attn forward: all '
        f'{len(calls)} calls of the step bit-equal to plain')
    step = 0.0
    for (q, wdtype), (args, count) in shapes.items():
        # device ms by graph replays: the profiler dropped records of
        # this kernel (0.73 ms read for a 2.45 ms encoder call)
        ms, call_ms, src, plain_ms = time_graph(
            torch, lambda: ms_deform_attn(*args),
            lambda: ms_deform_attn_plain(*args[:3], args[3].float()), n=10)
        values, lvl_shapes, locs, weights = args
        nbytes, ops = deform_attn_cost(torch, lvl_shapes, values, locs,
                                       weights)
        bms, by = bound_of(nbytes, ops)
        part = 'encoder' if q == n_tok else 'decoder'
        out['shapes'].append(dict(
            config=kind, part=part, q=q, batch=values.shape[0],
            weights=wdtype, calls=count, ms=ms, call_ms=call_ms,
            ms_from=src, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            bound_bytes=nbytes))
        step += count * call_ms
        log(f'detr train kernels: ms_deform_attn {kind} {part} Q={q} x '
            f'{values.shape[0]} weights {wdtype} (x{count} a step): '
            f'{ms:.4f} ms device ({src}), {call_ms:.4f} ms per call, plain '
            f'{plain_ms:.3f} ms, bound {bms:.4f} ms ({by}; {nbytes} bytes)')
    out['per_step_ms'][kind] = step
    log(f'detr train kernels: {kind} sampling forward calls of one step '
        f'{step:.2f} ms (events, call time)')


def phase_detr_train_reference(np, torch):
    """Both DETR configs in float32 at full width on a small input: the
    loss dict and the parameter gradients on the card (kernels) against
    the CPU (plain versions), the card taking the CPU's matches and
    denoising draws (reference_gate): losses rtol 1e-3, ||diff|| / ||g|| <=
    1e-3 over all tensors and over each of backbone + neck, transformer and
    heads, 3e-3 over the sampling offsets, 1e-2 per tensor; then a 1 % error
    planted in the sampling backward kernel's value gradient, and one in its
    location gradient, must each fail the same limits."""
    import copy
    import importlib

    from erd_tpu_torch.structures import ImageMeta, stack_to
    ops_module = importlib.import_module('erd_tpu_torch.ops.ms_deform_attn')
    head_module = importlib.import_module(
        'erd_tpu_torch.models.heads.deformable_detr_head')
    match_fn = head_module.hungarian_match
    import scipy
    log(f'detr train reference: scipy {scipy.__version__} solves the '
        f'Hungarian matching on the host')
    h, w = 128, 192

    for kind in DETR_CONFIGS:
        _, det, net_cpu = detr_train_net(torch, kind, device='cpu',
                                         dtype='float32', seed=7)
        rs = np.random.RandomState(19)
        images = torch.from_numpy(rs.randint(0, 256, (2, h, w, 3),
                                             np.uint8))
        gt = synthetic_gt(np, torch, rs, 2, (h, w), device='cpu',
                          num_labels=det.num_classes)
        metas = [ImageMeta.make((h, w), (h, w), (1.0, 1.0), img_id=i)
                 for i in (1, 2)]
        kw = {}
        if kind == 'dino':
            kw['draws'] = det.dn_draws(torch.tensor([1, 2]), 2,
                                       2 * MAX_GT * det.train_cfg.dn_groups,
                                       'cpu')
        names = [k for k, p in net_cpu.named_parameters() if p.requires_grad]
        parts = {'backbone + neck': [k for k in names if k.startswith(
            ('backbone.', 'neck.'))],
            'transformer': [k for k in names if k.startswith((
                'bbox_head.encoder_', 'bbox_head.decoder_',
                'bbox_head.level_embed_'))]}
        parts['heads'] = [k for k in names if not any(
            k in v for v in parts.values())]
        # the tensors the location gradient alone feeds: a 1 % error there
        # reads 1e-2 on them, but only ~3e-4 on the whole transformer; the
        # card's float32 reads up to 8.5e-4 on one of them (limit 3e-3)
        parts['sampling offsets'] = [k for k in names
                                     if '.sampling_offsets.' in k]

        def run(dev, matches=None, record=None):
            net = copy.deepcopy(net_cpu).to(dev)
            batch = dict(images=images.to(dev), meta=stack_to(metas, dev),
                         gt=type(gt)(**{k: None if v is None else v.to(dev)
                                        for k, v in vars(gt).items()}))
            args = {k: [d.to(dev) for d in v] for k, v in kw.items()}
            if record is not None:
                def recording(*a):
                    record.append(match_fn(*a))
                    return record[-1]
                head_module.hungarian_match = recording
            try:
                losses = det.loss(net, batch, matches=matches, **args)
            finally:
                head_module.hungarian_match = match_fn
            if record is not None:
                return None
            params = dict(net.named_parameters())
            gs = torch.autograd.grad(sum(losses.values()),
                                     [params[k] for k in names],
                                     allow_unused=True)
            grads = {k: (torch.zeros_like(params[k]) if g is None else g)
                     .double().cpu() for k, g in zip(names, gs)}
            return ({k: float(v.detach()) for k, v in losses.items()},
                    {'all': grads})

        cpu_matches, card_matches = [], []
        with torch.no_grad():
            run('cpu', record=cpu_matches)
            run(DEV, record=card_matches)
        moved = sum(int((a.cpu() != b).sum())
                    for a, b in zip(card_matches, cpu_matches))
        slots = sum(int(m.numel()) for m in cpu_matches)

        parts = [(f'{part} gradient', None, keys,
                  3e-3 if part == 'sampling offsets' else 1e-3)
                 for part, keys in parts.items()]
        controls = [(f'd {name} x 1.01', ops_module,
                     'ms_deform_attn_backward', planted(index))
                    for index, name in enumerate(('values', 'locations'))]
        log(f'detr train reference: {kind} float32 {h}x{w} x 2, '
            f'{len(cpu_matches)} Hungarian calls: the card\'s own matches '
            f'differ from the CPU\'s in {moved} of {slots} query slots; the '
            f'card then takes the CPU\'s')
        # per tensor, the floor covers the attention key biases, whose
        # gradient is 0 but for rounding (the softmax ignores a shift common
        # to all keys)
        reference_gate(np, torch, f'detr train reference: {kind}',
                       lambda dev: run(dev, matches=[
                           m.to(dev) for m in cpu_matches]),
                       names, parts, controls)
        del net_cpu


def phase_detr_train(np, torch, card):
    """build_trainer + fit of each DETR config at bs 16, 800x1344, bf16
    (fit_and_check): 2 warm-up and 5 timed steps, 12 sampling and 12
    sampling-backward launches per step, finite losses, frozen stages
    unchanged, every trainable weight moved or its updates below its
    float32 resolution; img/s, peak memory, the stage times of one
    train_step (DINO's query selection in 'decoder', the host's Hungarian
    matching apart) and the idle share of one profiled step."""
    import importlib

    from erd_tpu_torch.ops import ms_deform_attn, ms_deform_attn_backward
    head_module = importlib.import_module(
        'erd_tpu_torch.models.heads.deformable_detr_head')
    counters = {'ms_deform_attn': ms_deform_attn,
                'ms_deform_attn_backward': ms_deform_attn_backward}
    launches = {}
    for kind in DETR_CONFIGS:
        tag = f'detr train {kind}'
        cfg, det, net = detr_train_net(torch, kind)

        def unmoved(trainer, net, k, steps, tag=tag):
            """A weight that did not move must have taken a gradient whose
            updates lie below its float32 resolution: DINO's regression MLP
            under its zero-initialised fc_reg at the warmup's lr ~1e-7."""
            param = dict(net.named_parameters())[k]
            buf = trainer.optimizer.state[param].get('momentum_buffer')
            step = 0.0 if buf is None else \
                trainer.current_lr(steps - 1) * float(buf.abs().max())
            ulp = float(param.detach().abs().max()) * 2.0 ** -24
            log(f'{tag}: {k} did not move: largest last update {step:.2e}, '
                f'half an ulp of its largest entry {ulp:.2e}')
            return 0 < step < ulp

        trainer, loader, launches[tag] = fit_and_check(
            np, torch, card, tag, cfg, det, net, counters,
            dict.fromkeys(counters, DETR_STEP_CALLS), seed=53,
            unmoved=unmoved)
        head = net.bbox_head
        step_breakdown(
            torch, tag, trainer, net, loader,
            hooks=[(net.neck, 'backbone + neck')],
            wrapped=[(head, 'encode', 'encoder'), (head, 'decode', 'decoder'),
                     (det, 'loss', 'losses')],
            host=(head_module, 'hungarian_match', 'matching', 'losses'))
        del net, trainer, head
        torch.cuda.empty_cache()
    return launches


def dcn_train_net(torch, kind, device=None, dtype=None, seed=43):
    """A DCN config's detector and a seeded network (conv_offset arranged
    by arrange_offsets, as in dcn kernels), on ``device`` (the card by
    default); the config's bf16 unless ``dtype`` names another."""
    from erd_tpu_torch.apis import build_detector
    from erd_tpu_torch.config import Config
    from erd_tpu_torch.ops import arrange_offsets
    cfg = Config.fromfile(DCN_CONFIGS[kind])
    if dtype:
        cfg.model.compute_dtype = dtype
    det = build_detector(cfg.model)
    if not dtype:
        check_dcn_model(torch, det, kind)
    check(det.frozen_stages == 1, f'{kind}: the stem and layer1 are not '
          f'frozen')
    net = det.init(seed=seed, device=device or DEV)
    arrange_offsets(net, DCN_ARRANGE_SEED)
    return cfg, det, net


def deform_backward_cost(args):
    """(bytes, operations) of one deformable im2col backward call. Bytes:
    the column gradient, the map, the offsets and masks read once; the map
    gradient (in the map's dtype), the offset and mask gradients written
    once. Operations: per column element 7 for the map gradient's 4 corner
    products, 14 for the offset sums and 13 for the mask's (DCNv2); per
    sample ~16 of coordinates and the final scaling."""
    x, offset, mask, grad = args[:4]
    cols, samples = grad.numel(), offset.numel() // 2
    maps = x.numel() * x.element_size()
    nbytes = grad.numel() * 4 + 2 * maps + 2 * offset.numel() * 4 + \
        (0 if mask is None else 2 * mask.numel() * 4)
    return nbytes, cols * (21.0 + 13.0 * (mask is not None)) + samples * 16.0


def phase_dcn_train_kernels(np, torch):
    """The deformable im2col backward kernel on every call of one bs-16,
    800x1344 bf16 training step of each DCN config (conv_offset arranged),
    against its plain version; then each distinct call shape timed."""
    import importlib

    from erd_tpu_torch.engine import batch_to
    from erd_tpu_torch.models.heads import gfl_head, vfnet_head
    from erd_tpu_torch.ops import (deform_im2col, deform_im2col_backward,
                                   deform_im2col_backward_plain)
    from erd_tpu_torch.ops.deform_conv import deform_backward_chunk
    dcn_module = importlib.import_module('erd_tpu_torch.ops.deform_conv')
    stats, shapes, loss_calls = {}, {}, {}
    names = ('x', 'offset', 'mask')
    worst_abs, worst_rel = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0.0)
    worst_ulps = 0
    for kind in DCN_CONFIGS:
        _, det, net = dcn_train_net(torch, kind)
        batch = batch_to(next(iter(SyntheticLoader(
            np, torch, 1, seed=41, num_labels=NUM_CLASSES).epoch(0))), DEV)
        calls, atss_calls, gfl_calls = [], [], []
        head = vfnet_head if kind.startswith('vfnet') else gfl_head
        restore = [capture(dcn_module, 'deform_im2col_backward', calls),
                   capture_kw(head, 'atss_assign', atss_calls),
                   capture_kw(gfl_head, 'fused_gfl_loss', gfl_calls)]
        try:
            losses = det.loss(net, batch)
            sum(losses.values()).backward()
        finally:
            for undo in restore:
                undo()
        torch.cuda.synchronize()
        check(len(atss_calls) == 1 and len(gfl_calls) == (
            0 if head is vfnet_head else 1), f'{kind}: {len(atss_calls)} '
            f'ATSS and {len(gfl_calls)} GFL loss calls in one step')
        # rows 6 and 3 at the step's own calls (the full class map)
        gfl = None
        if gfl_calls:
            args, kw = gfl_calls[0]
            gfl = (args[0].contiguous(), 0, args[0].shape[-1], args[1:], kw)
        loss_calls[kind] = hold_loss_kernels(torch, kind, atss_calls[0], gfl)
        del atss_calls, gfl_calls, gfl
        log(f'dcn train kernels: one {kind} step captured: '
            f'{len(calls)} backward calls; losses ' + ' '.join(
                f'{k} {float(v.detach()):.4f}' for k, v in losses.items()))
        del net, losses, batch
        calls = [tuple(a.detach() if torch.is_tensor(a) else a for a in c)
                 for c in calls]
        torch.cuda.empty_cache()
        check(len(calls) == DCN_CALLS[kind] and
              all(c[0].shape[0] == TRAIN_BATCH and c[9] and c[10]
                  for c in calls), f'{kind}: {len(calls)} backward calls of '
              f'one step, expected {DCN_CALLS[kind]} at bs {TRAIN_BATCH} '
              f'asking for every gradient')
        for i, args in enumerate(calls):
            x, offset, mask, grad = args[:4]
            geo = args[4:9]
            # VFNet's backbone convs are DCNv2, its head's star convs DCNv1
            part = f'{kind} ' + ('head' if kind == 'vfnet_r50_mdconv' and
                                 mask is None else 'backbone')
            counts = stats.setdefault(part, [0, 0, 0])
            for j, v in enumerate(dcn_sample_stats(
                    torch, (x, offset, mask) + geo)):
                counts[j] += v
            # the map gradient does not depend on the map's values: with a
            # float32 copy of the map the kernel returns its float32 sums
            got32 = deform_im2col_backward(x.float(), offset, mask, grad,
                                           *geo)
            got = deform_im2col_backward(x, offset, mask, grad, *geo)
            torch.cuda.synchronize()
            want = deform_im2col_backward_plain(x, offset, mask, grad, *geo)
            errs = []
            for name, g, w in zip(names, (got32[0],) + got[1:], want):
                if w is None:
                    check(g is None, f'{part} call {i}: a {name} gradient '
                          f'where none belongs')
                    continue
                err = float((g - w).abs().max())
                limit = 1e-5 * float(w.abs().max())
                errs.append(f'{name} {err:.3e} (limit {limit:.3e})')
                check(err <= limit, f'{part}: deformable im2col backward '
                      f'kernel disagrees with plain on call {i} ({name})')
                worst_abs[name] = max(worst_abs[name], err)
                worst_rel[name] = max(worst_rel[name], err / max(
                    float(w.abs().max()), 1e-30))
            check(got[0].dtype == x.dtype, f'{part} call {i}: the map '
                  f'gradient is not in the map\'s dtype')
            if x.dtype == torch.bfloat16:
                # one ulp, where the sums differ by more than the float32
                # limit: below it a sum that cancels to near 0 can round to
                # bf16 values many of their tiny ulps apart
                ulps = bf16_ulps(torch, got[0], want[0].bfloat16())
                far = (got[0].float() - want[0]).abs() > \
                    1e-5 * float(want[0].abs().max())
                n_ulps = int(ulps[far].max()) if bool(far.any()) else 0
                errs.append(f'bf16 map gradient {n_ulps} ulp beyond '
                            f'1e-5*max|plain| (limit 1)')
                check(n_ulps <= 1, f'{part}: the bf16 map gradient of call '
                      f'{i} is more than one ulp from the plain one rounded')
                worst_ulps = max(worst_ulps, n_ulps)
            log(f'dcn train kernels: {part} call {i} x {tuple(x.shape)} '
                f'{x.dtype} stride {geo[1]} mask {mask is not None}: '
                f'max_abs_err ' + ', '.join(errs) + ' (atomics reorder the '
                f'map sums)')
            key = (kind, tuple(x.shape), geo[1], mask is not None)
            if key in shapes:
                shapes[key][1] += 1
            else:
                shapes[key] = [args[:9], 1]
            del got32, got, want
        del calls
        torch.cuda.empty_cache()
    for part, (n, frac, out) in stats.items():
        log(f'dcn train kernels: {part} samples {n}: fractional bilinear '
            f'weight {frac / n:.4f}, a corner outside its map {out / n:.4f}')
        check(frac >= 0.5 * n, f'{part}: fewer than 50 % of the samples have '
              f'a fractional bilinear weight')
        check(out >= 0.01 * n, f'{part}: fewer than 1 % of the samples reach '
              f'outside their map')

    # the kernel's ms: CUDA events around the call less the zeroing of its
    # float32 map gradient, timed alone
    timed, per_step, per_step_kernel, forward = [], {}, {}, []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (kind, xshape, stride, has_mask), (args, count) in shapes.items():
        call_ms = events_ms(torch, lambda: deform_im2col_backward(*args), 5)
        zero_ms = events_ms(torch, lambda: torch.zeros(
            xshape, dtype=torch.float32, device=DEV), 5)
        plain_ms = events_ms(torch, lambda: deform_im2col_backward_plain(
            *args), 1)
        ms = call_ms - zero_ms
        want = deform_im2col_backward_plain(*args)
        library, port = grid_sample_im2col_backward(torch, args)
        library_ms = events_ms(torch, library, 5)
        # the library computes the same function: its gradients against
        # the plain ones. grid_sample's normalised grid rounds the
        # positions (~1e-4 relative, as in dcn kernels); the offsets'
        # gradients are held where the sample is not within 1e-3 px of an
        # integer in that coordinate, where the rounding can move floor
        near = near_integer(torch, (args[0], args[1], args[2]) + args[4:9])
        library_errs = {}
        for name, g, w in zip(names, port(library()), want):
            if w is None:
                continue
            if name == 'offset':
                g, w = g[~near], w[~near]
            err = float((g - w).abs().max())
            limit = 1e-3 * float(w.abs().max())
            library_errs[name] = err
            check(err <= limit, f'{kind} x {xshape}: the grid_sample '
                  f'backward gives another {name} gradient ({err:.3e} > '
                  f'{limit:.3e}): not the same function')
        del want, library, port
        nbytes, ops = deform_backward_cost(args)
        bms, by = bound_of(nbytes, ops)
        out_hw = list(args[1].shape[2:])
        chunk = deform_backward_chunk(xshape[0], xshape[1], args[8],
                                      args[4], *out_hw, sms)
        timed.append(dict(config=kind, x=list(xshape), out_hw=out_hw,
                          stride=stride, mask=has_mask, calls=count,
                          chunk=chunk, ms=ms,
                          call_ms=call_ms, zero_ms=zero_ms,
                          ms_from='events less zeroing', plain_ms=plain_ms,
                          bound_ms=bms, bound_by=by, bound_bytes=nbytes,
                          ops=ops, ratio=ms / bms, library_ms=library_ms,
                          library_max_abs_err=library_errs,
                          library_offsets_skipped=float(near.float().mean())))
        per_step[kind] = per_step.get(kind, 0.0) + count * call_ms
        per_step_kernel[kind] = per_step_kernel.get(kind, 0.0) + count * ms
        log(f'dcn train kernels: deform_im2col_backward {kind} x {xshape} '
            f'-> {tuple(out_hw)} stride {stride} mask {has_mask} (x{count} '
            f'a step), map-gradient chunks of {chunk} channels: '
            f'{ms:.4f} ms ({call_ms:.4f} ms per call by events, '
            f'less {zero_ms:.4f} ms of the map gradient\'s zeroing), plain '
            f'{plain_ms:.2f} ms, bound {bms:.4f} ms ({by}; {nbytes} bytes, '
            f'{ops / 1e9:.3f} GOP), {ms / bms:.1f}x the bound; grid_sample '
            f'backward {library_ms:.4f} ms (max_abs_err ' + ', '.join(
                f'{k} {v:.3e}' for k, v in library_errs.items()) +
            f'; offsets within 1e-3 px of an integer left out: '
            f'{float(near.float().mean()):.4f})')
        # row 8, the forward, at this training call: graph replays beside
        # its bytes bound and F.grid_sample on the same columns
        fargs = tuple(args[:3]) + tuple(args[4:9])
        fwd_ms = graph_ms(torch, lambda: deform_im2col(*fargs), 10)
        fbms, fby = bound_of(*dcn_cost(fargs))
        fwd_library_ms = graph_ms(torch, grid_sample_im2col(torch, fargs), 5)
        forward.append(dict(config=kind, x=list(xshape), out_hw=out_hw,
                            stride=stride, mask=has_mask, calls=count,
                            ms=fwd_ms, ms_from='graph', bound_ms=fbms,
                            bound_by=fby, ratio=fwd_ms / fbms,
                            library_ms=fwd_library_ms,
                            library_ms_from='graph'))
        log(f'dcn train kernels: deform_im2col (row 8) {kind} x {xshape} '
            f'-> {tuple(out_hw)} stride {stride} mask {has_mask} (x{count} '
            f'a step): {fwd_ms:.4f} ms (graph), bound {fbms:.4f} ms '
            f'({fby}), {fwd_ms / fbms:.2f}x the bound; F.grid_sample '
            f'{fwd_library_ms:.4f} ms (graph)')
    for kind, total in per_step.items():
        log(f'dcn train kernels: {kind} backward calls of one step '
            f'{total:.2f} ms (events, call time; {per_step_kernel[kind]:.2f} '
            f'ms less the zeroing)')
    log('dcn train kernels: library_ms is the autograd backward of '
        'F.grid_sample (bilinear, zeros padding, align_corners=False) on the '
        'float32 map and a grid prepared beforehand, times the mask for '
        'DCNv2: aten.grid_sampler_2d_backward gives the map and grid '
        'gradients, the mask product\'s backward the mask\'s; call time by '
        'events, its own zeroing included')
    big = max(timed, key=lambda t: t['bound_bytes'])
    total = [sum(v[j] for v in stats.values()) for j in range(3)]
    row = dict(name='deform_im2col_backward', route='cuda',
               source='erd_tpu_torch/csrc/deform_conv.cu',
               replaces='erd_tpu/ops/deform_conv.py:28',
               max_abs_err=max(worst_abs.values()),
               max_abs_err_by_part=worst_abs,
               max_err_over_max_plain_by_part=worst_rel,
               max_bf16_ulps=worst_ulps,
               ms=big['ms'], call_ms=big['call_ms'], ms_from=big['ms_from'],
               ms_at=f'{big["config"]} x {big["x"]} stride {big["stride"]}',
               plain_ms=big['plain_ms'], bound_ms=big['bound_ms'],
               bound_by=big['bound_by'], library_ms=big['library_ms'],
               deterministic=False, shapes=timed, per_step_ms=per_step,
               per_step_less_zeroing_ms=per_step_kernel, redesigned=True,
               design='the map gradient\'s atomics combined in each warp; '
               'channel chunks planned from the shape',
               forward_train_shapes=forward,
               sample_share={'fractional': total[1] / total[0],
                             'outside': total[2] / total[0]})
    torch.cuda.empty_cache()
    return row, loss_calls


def phase_dcn_train_reference(np, torch):
    """Both DCN configs in float32 at full width on a small input: the loss
    dict and the parameter gradients on the card (kernels) against the CPU
    (plain versions), reference_gate: losses rtol 1e-3, ||diff|| / ||g|| <=
    1e-3 over all tensors and over each of the DCN blocks' conv_offset, the
    rest of backbone + neck, and the head, and for VFNet over the gradient
    of the offsets its head's star convs take (the path into vfnet_reg,
    scaled by 0.1, where an error reads ~1e-2 but only ~3e-4 on the head's
    parameters); 1e-2 per tensor. Then a 1 % error planted in the backward
    kernel's map gradient, and one in its offset gradient, on every call
    and, for VFNet, on the head's calls alone, must each fail those
    limits."""
    import copy
    import importlib

    from erd_tpu_torch.models.heads.vfnet_head import \
        STRIDES as VFNET_STRIDES
    from erd_tpu_torch.structures import ImageMeta, stack_to
    dcn_module = importlib.import_module('erd_tpu_torch.ops.deform_conv')
    h, w = 128, 192

    for kind in DCN_CONFIGS:
        _, det, net_cpu = dcn_train_net(torch, kind, device='cpu',
                                        dtype='float32', seed=7)
        rs = np.random.RandomState(23)
        images = torch.from_numpy(rs.randint(0, 256, (2, h, w, 3),
                                             np.uint8))
        gt = synthetic_gt(np, torch, rs, 2, (h, w), device='cpu',
                          num_labels=det.num_classes)
        metas = [ImageMeta.make((h, w), (h, w), (1.0, 1.0), img_id=i)
                 for i in (1, 2)]
        names = [k for k, p in net_cpu.named_parameters() if p.requires_grad]
        parts = {'conv_offset': [k for k in names if '.conv_offset.' in k],
                 'backbone + neck': [k for k in names if k.startswith(
                     ('backbone.', 'neck.')) and '.conv_offset.' not in k],
                 'head': [k for k in names if k.startswith('bbox_head.')]}
        check(sum(map(len, parts.values())) == len(names) and
              len(parts['conv_offset']) == 2 * (30 if kind == 'gfl_r101_dcn'
                                                else 13),
              f'{kind}: the gradient parts do not cover the parameters')
        # VFNet's head calls are its DCNv1 ones (the backbone's are DCNv2),
        # two on each level
        star = kind == 'vfnet_r50_mdconv'
        head_calls = 2 * len(VFNET_STRIDES) if star else 0
        parts = [(f'{part} gradient', None, keys, 1e-3)
                 for part, keys in parts.items()]
        if star:
            parts.append(('head star-offset gradient', None,
                          [f'star offsets {i}' for i in range(head_calls)],
                          1e-3))

        def run(dev):
            """Losses and gradients: the parameters', and the gradient of
            each head call's offsets (through a view of its own, as the
            two star convs of a level share one offset tensor)."""
            net = copy.deepcopy(net_cpu).to(dev)
            batch = dict(images=images.to(dev), meta=stack_to(metas, dev),
                         gt=type(gt)(**{k: None if v is None else v.to(dev)
                                        for k, v in vars(gt).items()}))
            grads = {}

            def hooked(fn):
                def im2col(x, offset, mask, *geo):
                    if star and mask is None:
                        offset = offset.view_as(offset)
                        key = f'star offsets {len(grads)}'
                        grads[key] = None
                        offset.register_hook(lambda g, key=key: grads.update(
                            {key: g.double().cpu()}))
                    return fn(x, offset, mask, *geo)
                im2col.launches = 0  # the kernel counts on its name
                return im2col
            with patched(dcn_module, 'deform_im2col', hooked):
                losses = det.loss(net, batch)
            params = dict(net.named_parameters())
            gs = torch.autograd.grad(sum(losses.values()),
                                     [params[k] for k in names],
                                     allow_unused=True)
            check(len(grads) == head_calls and all(
                g is not None for g in grads.values()),
                f'{kind}: {len(grads)} head calls with an offset gradient, '
                f'expected {head_calls}')
            grads.update({k: (torch.zeros_like(params[k]) if g is None
                              else g).double().cpu()
                          for k, g in zip(names, gs)})
            return ({k: float(v.detach()) for k, v in losses.items()},
                    {'all': grads})

        def head(args):
            return args[2] is None

        controls = [(f'd {name} x 1.01{where}', dcn_module,
                     'deform_im2col_backward', planted(index, when))
                    for where, when in [('', None)] + (
                        [(' in the head\'s calls', head)] if star else [])
                    for index, name in enumerate(('map', 'offset'))]
        reference_gate(np, torch, f'dcn train reference: {kind} float32 '
                       f'{h}x{w} x 2', run, names, parts, controls)
        del net_cpu


# kernel launches of one DCN training step: the im2col and its backward on
# every deformable conv, one ATSS call, and GFL's fused loss (forward and
# backward)
DCN_TRAIN_STEP_LAUNCHES = {
    'gfl_r101_dcn': dict(deform_im2col=30, deform_im2col_backward=30,
                         atss=1, gfl_loss=2),
    'vfnet_r50_mdconv': dict(deform_im2col=23, deform_im2col_backward=23,
                             atss=1, gfl_loss=0)}


def phase_dcn_train(np, torch, card):
    """build_trainer + fit of each DCN config at bs 16, 800x1344, bf16
    (fit_and_check): 2 warm-up and 5 timed steps, exactly the launches of
    DCN_TRAIN_STEP_LAUNCHES per step, finite losses, the stem and layer1
    unchanged, every trainable weight moved (each conv_offset included);
    img/s, peak memory, the stage times of one train_step and the idle
    share of one profiled step."""
    from erd_tpu_torch.ops import deform_im2col, deform_im2col_backward
    from erd_tpu_torch.ops.gfl_loss import fused_gfl_loss
    from erd_tpu_torch.task import atss_assign

    counters = {'deform_im2col': deform_im2col,
                'deform_im2col_backward': deform_im2col_backward,
                'atss': atss_assign, 'gfl_loss': fused_gfl_loss}
    launches = {}
    for kind in DCN_CONFIGS:
        tag = f'dcn train {kind}'
        cfg, det, net = dcn_train_net(torch, kind)
        trainer, loader, launches[tag] = fit_and_check(
            np, torch, card, tag, cfg, det, net, counters,
            DCN_TRAIN_STEP_LAUNCHES[kind], seed=57, must_move='.conv_offset.')
        step_breakdown(
            torch, tag, trainer, net, loader,
            hooks=[(net.backbone, 'backbone'), (net.neck, 'neck'),
                   (net.bbox_head, 'head')],
            wrapped=[(det, 'loss', 'targets + losses')])
        del net, trainer
        torch.cuda.empty_cache()
    return launches


# ------------------------------- Mask R-CNN, PointRend, CornerNet (serving)
def mask_net(np, torch, kind):
    """init_detector of the Mask R-CNN or PointRend config on the card,
    with seeded fc_cls weights (arrange_fc_cls, so that the 100 detection
    slots of a request are real); (detector, network, the 800x1333
    request's batch)."""
    from erd_tpu_torch.apis import init_detector
    det, net, _ = init_detector(MASK_CONFIGS[kind], device=DEV)
    want = {'mask_rcnn': 'MaskRCNNDetector',
            'point_rend': 'PointRendDetector'}[kind]
    check(type(det).__name__ == want and det.depth == 50 and
          det.num_classes == NUM_CLASSES and
          det.compute_dtype == torch.bfloat16,
          f'{MASK_CONFIGS[kind]} is not the {want} R50 bf16 model')
    batch, _ = request_batch(np, torch, REQUESTS[-1])
    arrange_fc_cls(torch, det, net, batch)
    return det, net, batch


def point_sample_stats(torch, maps, pts):
    """(samples, with a fractional weight, with a corner off the map,
    distinct map pixels the in-range corners touch) of one call."""
    n, _, h, w = maps.shape
    xs = pts[..., 0] * w - 0.5
    ys = pts[..., 1] * h - 0.5
    x0, y0 = torch.floor(xs), torch.floor(ys)
    frac = (xs != x0) | (ys != y0)
    off = (x0 < 0) | (x0 > w - 2) | (y0 < 0) | (y0 > h - 2)
    hit = torch.zeros(n * h * w, dtype=torch.bool, device=maps.device)
    img = torch.arange(n, device=maps.device)[:, None]
    for yy in (y0, y0 + 1):
        for xx in (x0, x0 + 1):
            ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            hit[((img * h + yy.long()) * w + xx.long())[ok]] = True
    return pts.shape[0] * pts.shape[1], int(frac.sum()), int(off.sum()), \
        int(hit.sum())


def grid_sample_points(torch, maps, pts):
    """mmcv's point_sample: F.grid_sample of the maps at 2 * p - 1,
    align_corners=False, zero padding -> (N, K, C)."""
    import torch.nn.functional as F
    out = F.grid_sample(maps, (pts * 2 - 1)[:, :, None, :], mode='bilinear',
                        padding_mode='zeros', align_corners=False)
    return out[..., 0].transpose(1, 2)


def point_layout(maps, pts):
    """The forward kernel's layout for this call
    (``point_sample_plan``)."""
    from erd_tpu_torch.ops.sampling import point_sample_plan
    return point_sample_plan(tuple(maps.shape), maps.stride(), maps.dtype,
                             pts.shape[1], maps.data_ptr()).layout


def point_sample_bound(maps, pts, touched):
    """(bound ms, 'bytes' or 'operations', bytes) of a point_sample call:
    the map pixels its in-range corners touch (``touched``, from
    point_sample_stats) read once, the (N, K, C) float32 output written
    once, the points read once; 11 float32 operations a sample (8
    products, 3 sums)."""
    n, k = pts.shape[:2]
    c = maps.shape[1]
    nbytes = touched * c * maps.element_size() + n * k * c * 4 + n * k * 8
    return (*bound_of(nbytes, n * k * c * 11.0), nbytes)


def phase_mask_kernels(np, torch):
    """One 800x1333 request each of Mask R-CNN and PointRend R50 (bf16,
    fc_cls seeded) with their kernel calls captured: RoIAlign at out 14 on
    the 100 detections (the last 10 replaced by edge cases) against its
    plain version (1e-6 * max|feat|); every point_sample call (2 coarse and
    2 fine) equal to its plain version (torch.equal), >= 50 % of the
    samples with a fractional weight and >= 1 % with a corner off the map
    over the request's calls; then each call shape timed beside its bound
    and F.grid_sample (held to plain within 1e-5 * max|map| first)."""
    import importlib

    from erd_tpu_torch.ops import (map_roi_levels, point_sample,
                                   point_sample_plain, roi_align,
                                   roi_align_plain)
    roi_module = importlib.import_module('erd_tpu_torch.ops.roi_align')
    pr_module = importlib.import_module(
        'erd_tpu_torch.models.detectors.point_rend')
    roi14, ps_calls = None, []
    for kind in MASK_CONFIGS:
        det, net, batch = mask_net(np, torch, kind)
        roi_calls, calls = [], []
        restore = [capture(roi_module, 'roi_align', roi_calls),
                   capture(pr_module, 'point_sample', calls)]
        try:
            res, masks = det.predict(net, batch)
        finally:
            for undo in restore:
                undo()
        torch.cuda.synchronize()
        n_ps = 2 * det.subdivision_steps if kind == 'point_rend' else 0
        check(len(roi_calls) == 2 and len(calls) == n_ps,
              f'{kind}: {len(roi_calls)} RoIAlign and {len(calls)} '
              f'point_sample calls in one request, expected 2 and {n_ps}')
        check(int(res.mask.sum()) == 100, f'{kind}: '
              f'{int(res.mask.sum())} of the 100 detection slots filled')
        ps_calls += calls
        if kind != 'mask_rcnn':
            continue
        # -- RoIAlign at out 14 on the detections, 10 edge cases
        feats, rois, _, strides, out_size = roi_calls[1][:5]
        check(out_size == 14 and rois.shape[1] == 100 and
              feats[0].dtype == torch.bfloat16,
              f'mask RoIAlign call out {out_size}, R={rois.shape[1]}')
        rois = rois.clone()
        h, w = batch['images'].shape[1:3]
        rois[0, -10:] = serve_edge_rois(torch, w, h)
        levels = map_roi_levels(rois, 4).contiguous()
        check(torch.equal(levels.cpu(), map_roi_levels(rois.cpu(), 4)),
              'RoI levels differ between card and CPU')
        args = (feats, rois, levels, strides, 14)
        got = roi_align(*args)
        torch.cuda.synchronize()
        want = roi_align_plain(*args)
        feat_max = max(float(f.float().abs().max()) for f in feats)
        err = float((got - want).abs().max())
        per_level = torch.bincount(levels.flatten().long(), minlength=4)
        log(f'mask kernels: roi_align out 14, R={rois.shape[1]} C='
            f'{feats[0].shape[1]} {feats[0].dtype} levels '
            f'{per_level.tolist()}: max_abs_err={err:.3e} (limit '
            f'1e-6*max|feat| = {1e-6 * feat_max:.3e})')
        check(err <= 1e-6 * feat_max, 'RoIAlign (out 14) kernel disagrees '
              'with plain')
        ms, call_ms, src, plain_ms = time_graph(
            torch, lambda: roi_align(*args), lambda: roi_align_plain(*args))
        r = rois.shape[1]
        bms, by = bound_of(*roi_align_cost(torch, feats, rois, levels, 14))
        roi14 = dict(r=r, out_size=14, max_abs_err=err, ms=ms,
                     call_ms=call_ms, ms_from=src, plain_ms=plain_ms,
                     bound_ms=bms, bound_by=by, library_ms=None)
        log(f'mask kernels: roi_align out 14 {ms:.4f} ms device ({src}), '
            f'{call_ms:.4f} ms per call, plain {plain_ms:.3f} ms, bound '
            f'{bms:.5f} ms ({by})')
        del feats, roi_calls, got, want
        del det, net
        torch.cuda.empty_cache()

    # -- point_sample: every call of the PointRend request
    tot = frac = off = 0
    shapes = {}
    for i, (maps, pts) in enumerate(ps_calls):
        got = point_sample(maps, pts)
        torch.cuda.synchronize()
        want = point_sample_plain(maps, pts)
        err = float((got - want).abs().max())
        n, f, o, touched = point_sample_stats(torch, maps, pts)
        tot, frac, off = tot + n, frac + f, off + o
        form = 'coarse' if maps.dtype == torch.float32 else 'fine'
        log(f'mask kernels: point_sample call {i} ({form}) maps '
            f'{tuple(maps.shape)} {maps.dtype} strides {maps.stride()}, '
            f'points {tuple(pts.shape)}, layout {point_layout(maps, pts)}: '
            f'max_abs_err={err:.3e} (every element equal to plain '
            f'required: the plain version\'s arithmetic in its order); '
            f'{f / n:.3f} fractional, {o / n:.4f} off the map')
        check(torch.equal(got, want), f'point_sample kernel differs from '
              f'plain on call {i}')
        shapes.setdefault((form, tuple(maps.shape), tuple(pts.shape)),
                          (maps, pts, touched, err))
    log(f'mask kernels: point_sample over the request: {tot} samples, '
        f'{frac / tot:.3f} fractional, {off / tot:.4f} with a corner off '
        f'the map (limits 0.5, 0.01)')
    check(frac >= 0.5 * tot and off >= 0.01 * tot,
          'point_sample check: too few fractional or off-map samples')
    timed = []
    for (form, _, _), (maps, pts, touched, err) in shapes.items():
        n, k = pts.shape[:2]
        c = maps.shape[1]
        maps32 = maps.float()
        lib = grid_sample_points(torch, maps32, pts)
        want = point_sample_plain(maps, pts)
        lib_err = float((lib - want).abs().max())
        check(lib_err <= 1e-5 * float(maps32.abs().max()),
              f'F.grid_sample disagrees with plain ({form}: {lib_err:.2e})')
        ms, call_ms, src, plain_ms = time_graph(
            torch, lambda: point_sample(maps, pts),
            lambda: point_sample_plain(maps, pts))
        library_ms = graph_ms(torch, lambda: grid_sample_points(
            torch, maps32, pts))
        bms, by, nbytes = point_sample_bound(maps, pts, touched)
        timed.append(dict(call=f'serve {form}', form=form,
                          maps=list(maps.shape), dtype=str(maps.dtype),
                          strides=list(maps.stride()),
                          layout=point_layout(maps, pts),
                          points=list(pts.shape), ms=ms, call_ms=call_ms,
                          ms_from=src, plain_ms=plain_ms, bound_ms=bms,
                          bound_by=by, bytes=nbytes, library_ms=library_ms,
                          library_err=lib_err, max_abs_err=err))
        log(f'mask kernels: point_sample {form} {tuple(maps.shape)} x '
            f'{tuple(pts.shape)}: {ms:.4f} ms device ({src}), {call_ms:.4f} '
            f'ms per call, plain {plain_ms:.3f} ms, F.grid_sample (float32 '
            f'map) {library_ms:.4f} ms (err vs plain {lib_err:.1e}), bound '
            f'{bms:.5f} ms ({by}, {nbytes / 1e6:.1f} MB)')
    fine = next(t for t in timed if t['form'] == 'fine')
    row = dict(name='point_sample', route='cuda',
               source='erd_tpu_torch/csrc/point_sample.cu',
               replaces='erd_tpu/ops/sampling.py:41',
               max_abs_err=max(t['max_abs_err'] for t in timed),
               ms=fine['ms'], call_ms=fine['call_ms'],
               ms_from=fine['ms_from'], plain_ms=fine['plain_ms'],
               bound_ms=fine['bound_ms'], bound_by=fine['bound_by'],
               library_ms=fine['library_ms'], shapes=timed,
               fractional_share=frac / tot, off_map_share=off / tot)
    del ps_calls, shapes
    torch.cuda.empty_cache()
    return row, roi14


def arrange_corner_heads(torch, det, net, batches):
    """Seeded weights for the last stack's heatmap and embedding 1x1 convs
    (``out`` of ``{tl,br}_{heat,emb}_1``). CORNER_CLASSES seeded classes,
    the same for both corner types (one: with more, each corner type's
    top corners fall in one class of its own on some requests), get N(0,
    1) weights scaled and shifted
    so that, between the 1 % and 99 % quantiles of the maps of ``batches``
    (the requests), their logits span CORNER_HEAT_SPAN (seeded within +-10
    %, so that their peaks do not tie) from CORNER_HEAT_LOW; the other
    classes get weight 0 and the bias CORNER_HEAT_REST (scores below
    score_thr). The embeddings get N(0, 1) weights spanning CORNER_EMB_SPAN
    around 0 the same way. erd_tpu's init (N(0, 0.01) on the ReLU'd
    features, heat bias at prior 0.1) puts one or two classes on top of
    each corner type and the two embeddings ~0.5 apart, so that no pair
    passes the class and embedding tests; a feature-driven class logit
    shifts between the requests by more than any fixed boost over the
    other classes."""
    import torch.nn.functional as F
    i = net.num_stacks - 1
    convs = {name: getattr(net, f'{name}_{i}').out
             for name in ('tl_heat', 'br_heat', 'tl_emb', 'br_emb')}
    seen = {name: [] for name in convs}
    hooks = [conv.register_forward_pre_hook(
        lambda m, a, name=name: seen[name].append(a[0]))
        for name, conv in convs.items()]
    for batch in batches:
        det.predict(net, batch)
    for hook in hooks:
        hook.remove()
    gen = torch.Generator().manual_seed(CORNER_ARRANGE_SEED)
    live = torch.zeros(det.num_classes, dtype=torch.bool)
    live[torch.randperm(det.num_classes, generator=gen)[
        :CORNER_CLASSES]] = True
    for name, conv in convs.items():
        w = torch.randn(conv.weight.shape, generator=gen).to(
            conv.weight.device)
        y = torch.cat([F.conv2d(x, w).transpose(0, 1).flatten(1)
                       for x in seen[name]], 1)
        # the 1 % and 99 % quantiles: the extremes sit on the borders
        lo, hi = torch.quantile(y[:, ::7], torch.tensor(
            [0.01, 0.99], device=y.device), dim=1)
        if name.endswith('heat'):
            span = CORNER_HEAT_SPAN * (0.9 + 0.2 * torch.rand(
                y.shape[0], generator=gen)).to(y.device)
            scale = torch.where(live.to(y.device), span / (hi - lo), 0.0)
            bias = torch.where(live.to(y.device), CORNER_HEAT_LOW -
                               lo * scale, CORNER_HEAT_REST)
        else:
            scale = CORNER_EMB_SPAN / (hi - lo)
            bias = -CORNER_EMB_SPAN / 2 - lo * scale
        with torch.no_grad():
            conv.weight.copy_(w * scale[:, None, None, None])
            conv.bias.copy_(bias)


def corner_pair_stats(torch, det, out):
    """How many of the top-k corner pairs of one image pass each of the
    decode's tests: (same class, geometry, embedding, all three)."""
    from erd_tpu_torch.models.detectors.cornernet import topk_corners
    from erd_tpu_torch.ops import local_maximum
    tl, br = ([t[0] for t in topk_corners(
        local_maximum(torch.sigmoid(out[f'{c}_heat'][:1].float())),
        out[f'{c}_emb'][:1].float(), out[f'{c}_off'][:1].float(),
        det.corner_topk)] for c in ('tl', 'br'))
    same = tl[1][:, None] == br[1][None]
    geom = (br[2][None] > tl[2][:, None]) & (br[3][None] > tl[3][:, None])
    emb = (tl[4][:, None] - br[4][None]).abs() <= det.distance_threshold
    return tuple(int(m.sum()) for m in (same, geom, emb, same & geom & emb))


def cornernet_net(np, torch):
    """init_detector of the CornerNet config on the card, the last stack's
    heatmap and embedding heads arranged on the 4 requests
    (arrange_corner_heads); (detector, network, the 800x1333 request's
    batch at 768x1024)."""
    from erd_tpu_torch.apis import init_detector
    det, net, _ = init_detector(CORNERNET_CONFIG, device=DEV)
    check(type(det).__name__ == 'CornerNetDetector' and
          det.num_classes == NUM_CLASSES and det.num_stacks == 2 and
          tuple(det.stage_channels) == (256, 256, 384, 384, 384, 512) and
          det.preprocessor.compute_dtype == torch.float32,
          f'{CORNERNET_CONFIG} is not the float32 HG-104 CornerNet')
    batches = [request_batch(np, torch, hw, CORNERNET_SCALE)[0]
               for hw in REQUESTS]
    arrange_corner_heads(torch, det, net, batches)
    stats = []
    for batch in batches:
        with torch.no_grad():
            out = net.last_stack(det.preprocessor(batch['images']))
        stats.append(corner_pair_stats(torch, det, out))
    log(f'cornernet: arranged heads; each request\'s top-{det.corner_topk} '
        f'corner pairs passing (same class, geometry, embedding, all): '
        f'{stats}')
    batch = batches[-1]
    check(tuple(batch['images'].shape[1:3]) == (768, 1024),
          f'CornerNet canvas {tuple(batch["images"].shape[1:3])}')
    return det, net, batch


def phase_cornernet_kernels(np, torch):
    """One 768x1024 request of CornerNet HG-104 (float32, seeded, heads
    arranged) with its kernel calls captured: every corner_pool call (the
    last stack's 4) bit-equal to its plain version in float32 and bf16,
    and with NaNs planted (fault 3.11) equal NaN for NaN, each direction
    timed by time_corner_pool (the train step's calls are timed by
    phase_mask_train_kernels, which holds them, and join this row); the
    soft-NMS call at K = 10000 (a cluster of 4 blocks), gaussian within
    1e-6 relative, timed."""
    import importlib

    from erd_tpu_torch.ops import (corner_pool, corner_pool_plain, soft_nms,
                                   soft_nms_plain)
    from erd_tpu_torch.ops.extra_nms import DIRECTIONS
    cn_module = importlib.import_module(
        'erd_tpu_torch.models.detectors.cornernet')
    nms_module = importlib.import_module('erd_tpu_torch.ops.nms')
    det, net, batch = cornernet_net(np, torch)
    pool_calls, soft_calls = [], []
    restore = [capture(cn_module, 'corner_pool', pool_calls),
               capture(nms_module, 'soft_nms', soft_calls)]
    try:
        res = det.predict(net, batch)
    finally:
        for undo in restore:
            undo()
    torch.cuda.synchronize()
    check(len(pool_calls) == 4 and len(soft_calls) == 1,
          f'{len(pool_calls)} corner_pool and {len(soft_calls)} soft-NMS '
          f'calls in one request, expected 4 and 1')
    check(sorted(d for _, d in pool_calls) == sorted(DIRECTIONS),
          'the corner_pool calls do not cover the four directions')
    for x, direction in pool_calls:
        for dtype in (torch.float32, torch.bfloat16):
            xx = x.to(dtype)
            got = corner_pool(xx, direction)
            torch.cuda.synchronize()
            same = torch.equal(got, corner_pool_plain(xx, direction))
            log(f'corner kernels: corner_pool {direction} '
                f'{tuple(xx.shape)} {dtype}: bit-equal {same}')
            check(same, f'corner_pool {direction} {dtype} differs from '
                  f'plain')
    nan_rays_check(torch, pool_calls, 'corner kernels')
    timed = [time_corner_pool(torch, x, direction, 'corner kernels')
             for x, direction in pool_calls]
    worst = max(timed, key=lambda t: t['ms'])
    row = dict(name='corner_pool', route='cuda',
               source='erd_tpu_torch/csrc/corner_pool.cu',
               replaces='erd_tpu/ops/extra_nms.py:63', max_abs_err=0.0,
               ms=worst['ms'], call_ms=worst['call_ms'],
               ms_from=worst['ms_from'], plain_ms=worst['plain_ms'],
               bound_ms=worst['bound_ms'], bound_by=worst['bound_by'],
               library_ms=worst['library_ms'], slowest=worst['direction'],
               by_direction=timed)

    # -- soft-NMS at K = 10000 (a cluster of 4 blocks), gaussian
    sboxes, scores, steps, thr, sigma, min_score, method = soft_calls[0][:7]
    k = sboxes.shape[1]
    valid = int((scores > float('-inf')).sum())
    check(k == 10000 and steps == 100 and method == 'gaussian' and
          valid > 0, f'CornerNet soft-NMS call K={k} ({valid} valid), '
          f'{steps} steps, {method}')
    gi, gs = soft_nms(*soft_calls[0][:7])
    torch.cuda.synchronize()
    wi, ws = soft_nms_plain(*soft_calls[0][:7])
    same = (gi == wi)[0]
    first = steps if bool(same.all()) else int((~same).int().argmax())
    upto = slice(0, min(first + 1, steps))
    live = ws[0, upto] > float('-inf')
    rel = float(((gs[0, upto] - ws[0, upto]).abs() /
                 ws[0, upto].abs())[live].max()) if bool(live.any()) else 0.0
    log(f'corner kernels: soft_nms gaussian K={k} ({valid} valid) '
        f'steps={steps} kept {int((ws >= min_score).sum())}: selections '
        f'equal over {first} of {steps} steps, max rel err {rel:.2e} '
        f'(limit 1e-6)')
    check(rel <= 1e-6, 'gaussian soft-NMS at K = 10000 differs from plain '
          'beyond 1e-6 relative, or selections differ without a tie')
    sargs = soft_calls[0][:7]
    ms, call_ms, src, plain_ms = time_graph(
        torch, lambda: soft_nms(*sargs), lambda: soft_nms_plain(*sargs),
        n=10)
    live, exhausted = soft_nms_stats(torch, sargs, gs)
    bms, by = bound_of(*soft_nms_cost(sargs, live, exhausted))
    soft = dict(k=k, valid=valid, steps=steps, method=method, ms=ms,
                call_ms=call_ms, ms_from=src, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, max_rel_err=rel,
                nothing_live_from=exhausted)
    log(f'corner kernels: soft_nms K={k} {ms:.4f} ms device ({src}), '
        f'{call_ms:.4f} ms per call, plain {plain_ms:.3f} ms, bound '
        f'{bms:.5f} ms ({by}); {int(res.mask.sum())} detections')
    del pool_calls, soft_calls, net
    torch.cuda.empty_cache()
    return row, soft


def time_corner_pool(torch, x, direction, tag):
    """One corner_pool call timed by graph replays on x as the path gives
    it (channels-last on the card: the kernel reads it where it lies)
    beside its byte bound, the plain version and torch.cummax on that same
    x (with erd_tpu's flips for top and left: the plain version's own
    calls, their device time the library yardstick); and the NCHW kernel
    on x made NCHW beforehand, equal to plain and timed (nchw_ms)."""
    from erd_tpu_torch.ops import corner_pool, corner_pool_plain
    ms = graph_ms(torch, lambda: corner_pool(x, direction))
    call_ms = events_ms(torch, lambda: corner_pool(x, direction), 20)
    plain_ms = events_ms(torch, lambda: corner_pool_plain(x, direction), 6)
    library_ms = graph_ms(torch, lambda: corner_pool_plain(x, direction))
    xc = x.contiguous()
    check(torch.equal(corner_pool(xc, direction),
                      corner_pool_plain(xc, direction)),
          f'corner_pool {direction} on the NCHW map differs from plain')
    nchw_ms = graph_ms(torch, lambda: corner_pool(xc, direction))
    layout = 'NCHW' if x.is_contiguous() else 'channels-last' \
        if x.is_contiguous(memory_format=torch.channels_last) else 'strided'
    bms, by = bound_of(2 * x.numel() * x.element_size(), float(x.numel()))
    log(f'{tag}: corner_pool {direction} {tuple(x.shape)} {x.dtype} '
        f'{layout}: {ms:.4f} ms device (graph), {call_ms:.4f} ms per call, '
        f'plain {plain_ms:.4f} ms, torch.cummax {library_ms:.4f} ms, bound '
        f'{bms:.5f} ms ({by}); the NCHW kernel on the map made NCHW '
        f'{nchw_ms:.4f} ms')
    return dict(direction=direction, shape=list(x.shape), layout=layout,
                ms=ms, call_ms=call_ms, ms_from='graph', plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=library_ms,
                nchw_ms=nchw_ms)


def with_nans(torch, x, seed):
    """x with 1 % of its values NaN (seeded), a whole first column and a
    whole last row of the first plane NaN, and the ray [1, nan, 0.5, 2, 2,
    0] at the start of the first plane's last column and last row: fault
    3.11's cases, on a real call's values."""
    gen = torch.Generator(device=x.device).manual_seed(seed)
    x = x.clone()
    x[torch.rand(x.shape, generator=gen, device=x.device) < 0.01] = \
        float('nan')
    x[0, 0, :, 0] = float('nan')
    ray = torch.tensor([1, float('nan'), 0.5, 2, 2, 0], device=x.device)
    x[0, 0, :6, -1] = ray
    x[0, 0, -1, :6] = ray
    return x


def same_with_nan(a, b):
    """Equal values, NaN where the other has NaN."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def nan_rays_check(torch, calls, tag, grads=None):
    """Fault 3.11 on the card: on each call's x with NaNs planted
    (``with_nans``), the forward kernel equal to its plain version NaN for
    NaN, in float32 and bf16; with ``grads``, the backward kernel bit-equal
    to its plain version (JAX's _balanced_eq rule: no gradient through a
    NaN output)."""
    from erd_tpu_torch.ops import corner_pool, corner_pool_plain
    from erd_tpu_torch.ops.extra_nms import (corner_pool_backward,
                                             corner_pool_backward_plain)
    for i, (x, direction) in enumerate(calls):
        xn = with_nans(torch, x, 61 + i)
        for dtype in (torch.float32, torch.bfloat16):
            xx = xn.to(dtype)
            got = corner_pool(xx, direction)
            torch.cuda.synchronize()
            want = corner_pool_plain(xx, direction)
            check(same_with_nan(got, want) and bool(want.isnan().any()),
                  f'corner_pool {direction} {dtype} with NaNs differs from '
                  f'plain')
            if grads is None:
                continue
            g = grads[i].to(dtype)
            gk = corner_pool_backward(xx, g, direction)
            torch.cuda.synchronize()
            gp = corner_pool_backward_plain(xx, g, direction)
            check(torch.equal(gk, gp) and bool(gp.isfinite().all()),
                  f'corner_pool_backward {direction} {dtype} with NaNs '
                  f'differs from plain')
        log(f'{tag}: corner_pool {direction} {tuple(x.shape)} with '
            f'{float(xn.isnan().float().mean()):.2%} NaN: '
            f'{"forward and backward" if grads is not None else "forward"} '
            f'equal to plain in float32 and bf16 (NaN carried as '
            f'lax.cummax carries it)')


def phase_mask_cornernet_reference(np, torch):
    """The three float32 networks card vs CPU on small inputs, within
    1e-3 * max|out|: Mask R-CNN's and PointRend's RPN outputs, bbox head
    and mask heads (on seeded RoI and point features); CornerNet HG-104's
    outputs of both stacks on a 128x256 input (sides multiples of 128)."""
    import copy

    from erd_tpu_torch.apis import build_detector
    from erd_tpu_torch.config import Config
    rs = np.random.RandomState(5)
    roi_feats = torch.from_numpy(rs.randn(8, 256, 14, 14).astype(np.float32))
    fine = torch.from_numpy(rs.randn(8, 196, 256).astype(np.float32))
    coarse_pts = torch.from_numpy(rs.randn(8, 196, NUM_CLASSES).astype(
        np.float32))
    for kind, path in list(MASK_CONFIGS.items()) + [
            ('cornernet', CORNERNET_CONFIG)]:
        cfg = Config.fromfile(path)
        cfg.model.compute_dtype = 'float32'
        det = build_detector(cfg.model)
        net_cpu = det.init(seed=1, device='cpu')
        net_gpu = copy.deepcopy(net_cpu).to(DEV)
        hw = (128, 256) if kind == 'cornernet' else (128, 192)
        img = torch.from_numpy(np.random.RandomState(2).randint(
            0, 256, (1, *hw, 3), np.uint8))

        def outputs(net):
            dev = next(net.parameters()).device
            raw = det.forward_raw(net, img.to(dev))
            if kind == 'cornernet':
                return [o[key] for o in raw for key in sorted(o)]
            (rpn_cls, rpn_reg), head = raw
            with torch.no_grad():
                if kind == 'mask_rcnn':
                    extra = [net.roi_head.mask_head(roi_feats.to(dev))]
                else:
                    extra = [net.roi_head.mask_head(roi_feats.to(dev)),
                             net.roi_head.point_head(fine.to(dev),
                                                     coarse_pts.to(dev))]
            return list(rpn_cls) + list(rpn_reg) + list(head) + extra
        worst = 0.0
        for g, w in zip(outputs(net_gpu), outputs(net_cpu)):
            check(tuple(g.shape) == tuple(w.shape), 'reference shape '
                  'mismatch')
            worst = max(worst, float((g.cpu() - w).abs().max() /
                                     w.abs().max()))
        log(f'{kind} reference: float32 network card vs CPU, max |diff| / '
            f'max |out| = {worst:.2e} (tolerance 1e-3)')
        check(worst <= 1e-3, f'float32 {kind} on the card disagrees with '
              f'the CPU')
        del net_cpu, net_gpu
    torch.cuda.empty_cache()


def refined_diff(torch, idx_a, idx_b, cells):
    """Cells of a step refined on one side only, counted once per pair."""
    def mask(idx):
        return torch.zeros(idx.shape[0], cells, dtype=torch.bool).scatter(
            1, idx, True)
    return int((mask(idx_a) ^ mask(idx_b)).sum()) // 2


def selection_gap(torch, logits, idx_a, idx_b):
    """The largest distance, relative to max|logit|, from the k-th
    uncertainty of ``logits``' x2 upsample of the cells that only one of
    two selections of k cells refines (0 where they agree)."""
    from erd_tpu_torch.models.detectors.point_rend import upsample2x
    unc = -upsample2x(logits).abs().reshape(logits.shape[0], -1)
    kk = idx_a.shape[1]
    kth = torch.sort(unc, -1, descending=True).values[:, kk - 1:kk]
    a = torch.zeros_like(unc, dtype=torch.bool).scatter(1, idx_a, True)
    b = torch.zeros_like(unc, dtype=torch.bool).scatter(1, idx_b, True)
    diff = a ^ b
    if not bool(diff.any()):
        return 0.0
    return float(((unc - kth).abs())[diff].max() / logits.abs().max())


def phase_mask_serve(np, torch, card):
    """init_detector / inference_detector of Mask R-CNN and PointRend on
    the 4 requests: per request 2 NMS and 2 RoIAlign launches (+ 4
    point_sample for PointRend); every detection finite and inside its
    image, stage times (PointRend's subdivision steps apart), peak memory,
    the idle share of one request; card-vs-CPU post-processing of the same
    head outputs, and the mask branch on the CPU from the card's features
    and detections: masks within 1e-3; PointRend's refined cells equal but
    at near-ties (the first step's within 1e-5 * max|logit| of the k-th
    uncertainty; at most 1 % of the selections per step), its masks within
    1e-3 but at the cells those near-ties move."""
    import copy

    from erd_tpu_torch.data import DetPipeline
    from erd_tpu_torch.models.detectors.mask_rcnn import pick_class
    from erd_tpu_torch.ops import nms_sorted_keep, point_sample, roi_align
    from erd_tpu_torch.structures import DetResults

    images = request_images(np)
    counters = {'nms_keep': nms_sorted_keep, 'roi_align': roi_align,
                'point_sample': point_sample}
    launches = {}
    for kind in MASK_CONFIGS:
        tag = {'mask_rcnn': 'mask serve', 'point_rend': 'pointrend serve'}[
            kind]
        det, net, _ = mask_net(np, torch, kind)
        net_cpu = copy.deepcopy(net).cpu()
        steps = getattr(det, 'subdivision_steps', 0)
        per = dict(nms_keep=2, roi_align=2, point_sample=2 * steps)
        want = {k: v * len(images) for k, v in per.items()}
        results, counts = serve_requests(np, torch, det, net, images,
                                         counters, want, tag, card)
        launches[tag] = counts
        pipe = DetPipeline()
        for i, (img, res) in enumerate(zip(images, results)):
            with torch.no_grad():
                req = ServedRequest(np, torch, pipe, i, img)
                feats, rpn_cls, rpn_reg = det.feats_and_rpn(net, req.images)
                req.mark()
                ctx = det.anchor_context(req.images.shape[1:3])
                rois, _, roi_mask = det.proposals(ctx, rpn_cls, rpn_reg,
                                                  req.meta_dev)
                req.mark()
                roi_feats = det.roi_feats(feats, rois)
                req.mark()
                cls, reg = det.roi_forward(net, roi_feats)
                req.mark()
                gpu = det.postprocess(cls, reg, rois, roi_mask, req.meta_dev)
                req.mark()
                stages = ('network', 'RPN proposals', 'RoIAlign', 'head',
                          'post-processing')
                if kind == 'mask_rcnn':
                    masks = det.mask_predict(net, feats, gpu, req.meta_dev)
                    req.mark()
                    stages += ('mask branch (RoIAlign 14 + head)',)
                else:
                    mrois = det.mask_rois(gpu, req.meta_dev)
                    coarse = det.coarse_logits(net, feats, mrois)
                    labels = gpu.labels.reshape(-1)
                    logits = coarse_cls = pick_class(coarse, labels)
                    req.mark()
                    stages += ('coarse mask (RoIAlign 14 + head)',)
                    idxs = []
                    for step in range(steps):
                        logits, idx = det.subdivide(net, feats[0], mrois,
                                                    coarse, logits, labels)
                        idxs.append(idx)
                        req.mark()
                        stages += (f'subdivision step {step + 1}',)
                    masks = torch.sigmoid(logits).reshape(
                        *mrois.shape[:2], *logits.shape[1:])
            req.log_stages(tag, stages)
            cpu = det.postprocess(cls.cpu(), reg.cpu(), rois.cpu(),
                                  roi_mask.cpu(), req.meta_cpu)
            req.compare(tag, gpu, cpu, len(res.scores),
                        f'proposals {int(roi_mask.sum())} ',
                        min_candidates=2000)
            size = 14 << steps if steps else det.mask_size
            check(tuple(masks.shape) == (1, 100, size, size) and
                  bool(torch.isfinite(masks).all()) and
                  bool(((masks >= 0) & (masks <= 1)).all()),
                  f'{tag} request {i}: masks not finite (1, 100, {size}, '
                  f'{size}) probabilities')
            # the mask branch on the CPU from the card's features and boxes
            res_cpu = DetResults(*(t.cpu() for t in (
                gpu.bboxes, gpu.scores, gpu.labels, gpu.mask)))
            feats_cpu = [f.cpu() for f in feats]
            note = ''
            if kind == 'mask_rcnn':
                masks_cpu = det.mask_predict(net_cpu, feats_cpu, res_cpu,
                                             req.meta_cpu)
                allowed, note = 0, ''
            else:
                rois_cpu = det.mask_rois(res_cpu, req.meta_cpu)
                logits_cpu, idxs_cpu = det.refine(net_cpu, feats_cpu,
                                                  rois_cpu, res_cpu.labels)
                masks_cpu = torch.sigmoid(logits_cpu).reshape(masks.shape)
                gap = selection_gap(torch, coarse_cls.cpu(), idxs[0].cpu(),
                                    idxs_cpu[0])
                differ = [refined_diff(torch, a.cpu(), b, (28 << s) ** 2)
                          for s, (a, b) in enumerate(zip(idxs, idxs_cpu))]
                total = idxs[0].numel()
                # a cell refined on one side only moves its own final cell,
                # or (an earlier step's) the 4x4 cells its upsample feeds
                allowed = sum(2 * d * 16 ** (steps - 1 - s)
                              for s, d in enumerate(differ))
                note = (f'refined cells differing per step {differ} of '
                        f'{total} (step 1\'s within {gap:.1e} * max|logit| '
                        f'of the k-th uncertainty), ')
                check(gap <= 1e-5 and max(differ) <= 0.01 * total,
                      f'{tag} request {i}: refined cells differ card vs '
                      f'CPU beyond near-ties')
            diff = (masks.cpu() - masks_cpu).abs()
            beyond = int((diff > 1e-3).sum())
            log(f'{tag} request {i}: masks {tuple(masks.shape[2:])} card vs '
                f'CPU: {note}max |diff| {float(diff.max()):.2e}, cells '
                f'beyond 1e-3: {beyond} (allowed {allowed})')
            check(beyond <= allowed, f'{tag} request {i}: masks differ card '
                  f'vs CPU beyond 1e-3 at {beyond} cells')
            del feats, roi_feats, feats_cpu
        del det, net, net_cpu
        torch.cuda.empty_cache()
    return launches


def phase_cornernet_serve(np, torch, card):
    """init_detector / inference_detector of CornerNet HG-104 on the 4
    requests at scale (1024, 768): per request 4 corner_pool launches (the
    last stack's) and 1 soft-NMS (K = 10000); every detection finite, not
    inverted and inside the canvas's extent in its image grown by the
    reach of the corner offsets (erd_tpu decodes corners over the whole
    canvas, adds the offsets and does not clip), stage times, peak memory,
    the idle share of one request; card-vs-CPU decode and soft-NMS of the
    same network outputs."""
    from erd_tpu_torch.data import DetPipeline
    from erd_tpu_torch.ops import corner_pool, soft_nms

    images = request_images(np)
    det, net, _ = cornernet_net(np, torch)
    counters = {'corner_pool': corner_pool, 'soft_nms': soft_nms}
    want = {'corner_pool': 4 * len(images), 'soft_nms': len(images)}
    tag = 'cornernet serve'
    results, counts = serve_requests(
        np, torch, det, net, images, counters, want, tag, card,
        scale=CORNERNET_SCALE, inside=False)
    pipe = DetPipeline(scale=CORNERNET_SCALE)
    for i, (img, res) in enumerate(zip(images, results)):
        with torch.no_grad():
            req = ServedRequest(np, torch, pipe, i, img)
            for feat in net.backbone.stacks(det.preprocessor(req.images)):
                pass
            req.mark()
            out = net.heads(net.num_stacks - 1, feat)
            req.mark()
            dec = det.decode(out, req.images.shape[1:3], req.meta_dev)
            req.mark()
            gpu = det.nms(*dec)
            req.mark()
        req.log_stages(tag, ('hourglass (2 stacks)', 'last stack corner '
                             'pools + heads', 'decode (top-k, pairs)',
                             'soft-NMS'))
        cpu = det.nms(*det.decode({k: v.cpu() for k, v in out.items()},
                                  req.images.shape[1:3], req.meta_cpu))
        req.compare(tag, gpu, cpu, len(res.scores),
                    f'pairs over score_thr {int(gpu.num_candidates[0])} ')
        # the canvas in the image's frame, grown by the offsets' reach
        sx, sy = (float(v) for v in req.meta_cpu.scale_factor[0])
        reach = 4 * float(torch.cat([out['tl_off'], out['br_off']]).abs()
                          .max()) + 1e-3
        ch, cw = req.images.shape[1:3]
        box = gpu.bboxes[0][gpu.mask[0]].cpu()
        check(bool((box[:, 2] > box[:, 0]).all() and
                   (box[:, 3] > box[:, 1]).all() and
                   (box[:, 0::2] >= -reach / sx).all() and
                   (box[:, 1::2] >= -reach / sy).all() and
                   (box[:, 0::2] <= (cw + reach) / sx).all() and
                   (box[:, 1::2] <= (ch + reach) / sy).all()),
              f'{tag} request {i}: boxes inverted or outside the canvas')
        del feat, out
    del det, net
    torch.cuda.empty_cache()
    return {tag: counts}


# --------------------- Mask R-CNN, PointRend, CornerNet (training)
MASK_TRAIN_STEP_LAUNCHES = {
    'mask_rcnn': dict(roi_align=2, roi_align_backward=2, nms_keep=1,
                      crop_resize_mask=1, point_sample=0,
                      point_sample_backward=0),
    'point_rend': dict(roi_align=2, roi_align_backward=2, nms_keep=1,
                       crop_resize_mask=1, point_sample=4,
                       point_sample_backward=2)}
CORNERNET_STEP_LAUNCHES = dict(corner_pool=8, corner_pool_backward=8,
                               render_corner_targets=1)
# the CornerNet cell: the config's per-card batch of 6 at 768x1024 (HG-104
# needs sides that are multiples of 128); float32 as erd_tpu trains it
CORNERNET_TRAIN_BATCH, CORNERNET_TRAIN_CANVAS = 6, (768, 1024)
# PointRend's importance picks of a card run that may differ from the
# CPU's at near-ties of the uncertainty (1e-5 of the largest)
PICK_TIE_RTOL, PICK_MOVED_SHARE = 1e-5, 1e-3


def mask_train_net(torch, kind, device=None, dtype=None, seed=53):
    """The config, its detector and a seeded network of Mask R-CNN,
    PointRend or CornerNet HG-104 (full width and depth) for training."""
    from erd_tpu_torch.apis import build_detector
    from erd_tpu_torch.config import Config
    path = CORNERNET_CONFIG if kind == 'cornernet' else MASK_CONFIGS[kind]
    cfg = Config.fromfile(path)
    if dtype and kind != 'cornernet':
        cfg.model.compute_dtype = dtype
    det = build_detector(cfg.model)
    want = {'mask_rcnn': 'MaskRCNNDetector',
            'point_rend': 'PointRendDetector',
            'cornernet': 'CornerNetDetector'}[kind]
    check(type(det).__name__ == want and det.num_classes == NUM_CLASSES and
          (kind == 'cornernet' or (det.depth == 50 and
                                   det.frozen_stages == 1 and
                                   det.rcnn_train_cfg.num_samples == 512)),
          f'{path} is not the {want} training model')
    return cfg, det, det.init(seed=seed, device=device or DEV)


def mask_train_loader(np, torch, kind, steps, seed):
    """The train cells' batches: bs 16 800x1344 with gt crops, or
    CornerNet's bs 6 at 768x1024 (80 classes)."""
    if kind == 'cornernet':
        return SyntheticLoader(np, torch, steps, seed=seed,
                               num_labels=NUM_CLASSES,
                               batch=CORNERNET_TRAIN_BATCH,
                               canvas=CORNERNET_TRAIN_CANVAS,
                               image=CORNERNET_TRAIN_CANVAS)
    return SyntheticLoader(np, torch, steps, seed=seed,
                           num_labels=NUM_CLASSES, masks=True)


def mask_train_step_calls(np, torch, kind, names):
    """One training step (loss + backward) of ``kind`` on its train batch
    with the calls of the named kernel wrappers captured: {name: [args,
    ...]}."""
    import importlib
    modules = {'crop_resize_mask': 'models.detectors.mask_rcnn',
               'roi_align': 'ops.roi_align',
               'roi_align_backward': 'ops.roi_align',
               'point_sample': 'models.detectors.point_rend',
               'point_sample_backward': 'ops.sampling',
               'corner_pool_backward': 'ops.extra_nms',
               'render_corner_targets': 'models.detectors.cornernet'}
    _, det, net = mask_train_net(torch, kind)
    batch = next(iter(mask_train_loader(np, torch, kind, 1, 61).epoch(0)))
    calls = {n: [] for n in names}
    restore = [capture(importlib.import_module(
        f'erd_tpu_torch.{modules[n]}'), n, calls[n]) for n in names]
    try:
        losses = det.loss(net, batch)
        sum(losses.values()).backward()
    finally:
        for undo in restore:
            undo()
    torch.cuda.synchronize()
    log(f'mask/corner train kernels: one {kind} step captured: ' +
        ', '.join(f'{n} x{len(c)}' for n, c in calls.items()) +
        '; losses ' + ' '.join(f'{k} {float(v.detach()):.4f}'
                               for k, v in losses.items()))
    del net, losses
    return calls


CORNER_TARGETS_DESIGN = ('one launch, no zero-fill and no torch op before '
                         'it: a block an (image, corner, band of 1024 '
                         'pixels) computes the gts\' scalars in shared '
                         'memory and lists those whose squares meet the '
                         'band; a thread 4 pixels, one 16-byte store a '
                         'class channel; every output byte written once')


def corner_targets_cost(torch, args):
    """(bytes, operations, gaussian cells) of a render_corner_targets call
    on this data: the outputs written once (both heatmaps, offsets,
    weights, corner pixels) and the gts read; ~20 operations a gaussian
    cell of each valid gt's two squares."""
    from erd_tpu_torch.ops.gaussian import corner_scalars
    boxes, labels, mask, (fh, fw), num_classes = args[:5]
    b, g = mask.shape
    nbytes = 2 * b * (num_classes + 3) * fh * fw * 4 + 2 * b * g * 2 * 8 + \
        boxes.numel() * 4 + labels.numel() * labels.element_size() + \
        mask.numel()
    sc = corner_scalars(*args)
    inside = float(((2 * sc['radius'] + 1) ** 2 * sc['valid']).sum()) * 2
    return nbytes, inside * 20.0, inside


def crop_resize_library(torch, masks, boxes, idx, rois, out_size):
    """The targets as one F.grid_sample computes them (border padding),
    times the in-box mask: for row 14's library_ms. It is erd_tpu's
    function but in the first half cell of each axis, where erd_tpu clips
    the lower corner index to 0 before adding 1 and so blends rows 0 and 1
    instead of taking row 0. Returns (the call, the (B * S, out, out)
    cells in that band)."""
    import torch.nn.functional as F
    b, s = idx.shape
    r = masks.shape[-1]
    crop = torch.gather(masks, 1, idx[..., None, None].expand(
        b, s, r, r)).float().reshape(b * s, 1, r, r)
    box = torch.gather(boxes, 1, idx[..., None].expand(b, s, 4))
    t = (torch.arange(out_size, device=DEV, dtype=torch.float32) + 0.5) / \
        out_size

    def norm(lo, hi, glo, ghi):  # the cell centres in the crop's [-1, 1]
        pos = lo[..., None] + t * (hi - lo)[..., None]
        ext = (ghi - glo).clamp(min=1e-3)[..., None]
        return (pos - glo[..., None]) / ext * 2 - 1
    gy = norm(rois[..., 1], rois[..., 3], box[..., 1], box[..., 3])
    gx = norm(rois[..., 0], rois[..., 2], box[..., 0], box[..., 2])
    grid = torch.stack(torch.broadcast_tensors(
        gx[..., None, :], gy[..., :, None]), -1).reshape(
        b * s, out_size, out_size, 2)
    inside = ((gy.abs() <= 1)[..., :, None] &
              (gx.abs() <= 1)[..., None, :]).reshape(b * s, 1, out_size,
                                                      out_size)
    edge = 1.0 / r

    def first_half(g):
        return (g > -1) & (g < -1 + edge)
    band = (first_half(gy)[..., :, None] | first_half(gx)[..., None, :])

    def call():
        return F.grid_sample(crop, grid, mode='bilinear',
                             padding_mode='border',
                             align_corners=False) * inside
    return call, band.reshape(b * s, out_size, out_size)


# PointRend's four point-sample calls of a training step, in the order of
# its loss (erd_tpu_torch/models/detectors/point_rend.py)
POINT_TRAIN_CALLS = ('uncertainty', 'coarse', 'fine', 'targets')


def point_train_calls(torch, calls):
    """Row 13a at the four point-sample calls of one bs-16 PointRend step
    (``POINT_TRAIN_CALLS``): each equal to plain (torch.equal), then timed
    as the serving calls are (graph replays, the eager call by events,
    plain, F.grid_sample on the widened float32 map, the bytes bound).
    Returns the calls' rows."""
    from erd_tpu_torch.ops.sampling import point_sample, point_sample_plain
    check(len(calls) == len(POINT_TRAIN_CALLS), f'PointRend step: '
          f'{len(calls)} point_sample calls')
    rows = []
    for name, (maps, pts) in zip(POINT_TRAIN_CALLS, calls):
        got = point_sample(maps, pts)
        torch.cuda.synchronize()
        want = point_sample_plain(maps, pts)
        err = float((got - want).abs().max())
        same = bool(torch.equal(got, want))
        del got, want
        torch.cuda.empty_cache()
        n, f, o, touched = point_sample_stats(torch, maps, pts)
        layout = point_layout(maps, pts)
        log(f'mask/corner train kernels: point_sample {name} maps '
            f'{tuple(maps.shape)} {maps.dtype} strides {maps.stride()}, '
            f'points {tuple(pts.shape)}, layout {layout}: max_abs_err='
            f'{err:.3e} (every element equal to plain required); '
            f'{f / n:.3f} fractional, {o / n:.4f} off the map')
        check(same, f'point_sample kernel differs from plain at the '
              f'{name} training call')
        big = n * pts.shape[1] * maps.shape[1] * 4 > 256 << 20
        reps = 3 if big else 20
        ms, call_ms, src, plain_ms = time_graph(
            torch, lambda: point_sample(maps, pts),
            lambda: point_sample_plain(maps, pts), n=reps)
        torch.cuda.empty_cache()
        maps32 = maps.float()
        library_ms = graph_ms(torch, lambda: grid_sample_points(
            torch, maps32, pts), reps)
        del maps32
        torch.cuda.empty_cache()
        bms, by, nbytes = point_sample_bound(maps, pts, touched)
        rows.append(dict(call=f'train {name}', form=name,
                         maps=list(maps.shape), dtype=str(maps.dtype),
                         strides=list(maps.stride()), layout=layout,
                         points=list(pts.shape), ms=ms, call_ms=call_ms,
                         ms_from=src, plain_ms=plain_ms, bound_ms=bms,
                         bound_by=by, bytes=nbytes, library_ms=library_ms,
                         max_abs_err=err))
        log(f'mask/corner train kernels: point_sample {name} '
            f'{tuple(maps.shape)} x {tuple(pts.shape)}: {ms:.4f} ms device '
            f'({src}), {call_ms:.4f} ms per call, plain {plain_ms:.3f} ms, '
            f'F.grid_sample (float32 map) {library_ms:.4f} ms, bound '
            f'{bms:.5f} ms ({by}, {nbytes / 1e6:.1f} MB)')
    log(f'mask/corner train kernels: point_sample over a step\'s 4 calls: '
        f'{sum(r["ms"] for r in rows):.4f} ms device, bound '
        f'{sum(r["bound_ms"] for r in rows):.4f}')
    return rows


def phase_mask_train_kernels(np, torch):
    """The new training kernels on the real calls of one step: the mask
    targets of a bs-16, 800x1344 Mask R-CNN step (28x28) and of a
    PointRend step (14x14), equal to the plain version (torch.equal); the
    point-sample backward on both of the PointRend step's calls (coarse
    float32 logits, bf16 P2; float32 sums within 1e-5 * max|plain|, the
    bf16 map's gradient within one ulp), and the point-sample forward on
    the step's four calls (``point_train_calls``: equal to plain, timed;
    returned on the backward's row as ``forward_train_shapes`` for the
    point_sample row); the corner-pool backward on the 8 calls of a
    CornerNet HG-104 step (bs 6, 768x1024, float32) bit-equal to the plain
    version, and with NaNs planted (fault 3.11) the forward and backward
    kernels equal to their plain versions; the corner targets of that step
    (heat within 1e-6, the exact-1 peaks, offsets, weights equal). Each
    then timed by CUDA-graph replays beside its byte bound, its plain
    version and, where one PyTorch call computes the function, that call;
    the corner_pool forward too, on that step's x of each direction (for
    the corner_pool row). And row 7b at both RoIAlign backward calls of
    the Mask R-CNN and PointRend steps (the out-7 box call and the out-14
    mask call; ``roi_backward_call``), returned apart for that row."""
    from erd_tpu_torch.data.masks import (crop_resize_mask,
                                          crop_resize_mask_plain)
    from erd_tpu_torch.ops.extra_nms import (corner_pool_backward,
                                             corner_pool_backward_plain)
    from erd_tpu_torch.ops.gaussian import (corner_scalars,
                                            render_corner_targets,
                                            render_corner_targets_plain)
    from erd_tpu_torch.ops.sampling import (point_sample_backward,
                                            point_sample_backward_plain)
    rows = []
    # -- row 14: the mask targets of both mask models' steps
    shapes = []
    roi_backward = []  # row 7b at both calls of each step
    roi_forward = []  # row 7 at both calls of each step
    for kind, out_size in (('mask_rcnn', 28), ('point_rend', 14)):
        names = ('crop_resize_mask', 'roi_align', 'roi_align_backward') + ((
            'point_sample', 'point_sample_backward')
            if kind == 'point_rend' else ())
        calls = mask_train_step_calls(np, torch, kind, names)
        check(sorted(a[4] for a in calls['roi_align']) == [7, 14],
              f'{kind}: RoIAlign calls at out_size '
              f'{[a[4] for a in calls["roi_align"]]}')
        for args in sorted(calls.pop('roi_align'), key=lambda a: a[4]):
            check(tuple(args[1].shape[:2]) == (TRAIN_BATCH, 512) and
                  args[0][0].dtype == torch.bfloat16, f'{kind}: RoIAlign '
                  f'call at {tuple(args[1].shape)} {args[0][0].dtype}')
            roi_forward.append(dict(config=kind, **roi_forward_call(
                torch, args, f'mask/corner train kernels: {kind}')))
            del args
        check(sorted(a[6] for a in calls['roi_align_backward']) == [7, 14],
              f'{kind}: RoIAlign backward calls at out_size '
              f'{[a[6] for a in calls["roi_align_backward"]]}')
        for args in sorted(calls.pop('roi_align_backward'),
                           key=lambda a: a[6]):
            check(tuple(args[0].shape[:3]) == (TRAIN_BATCH, 512, 256) and
                  args[5] == torch.bfloat16, f'{kind}: RoIAlign backward '
                  f'call at {tuple(args[0].shape)} {args[5]}')
            roi_backward.append(dict(config=kind, **roi_backward_call(
                torch, args, f'mask/corner train kernels: {kind}')))
            del args
        check(len(calls['crop_resize_mask']) == 1,
              f'{kind}: {len(calls["crop_resize_mask"])} mask-target calls')
        args = calls['crop_resize_mask'][0]
        masks, boxes, idx, rois, size = args
        check(size == out_size and tuple(idx.shape) == (TRAIN_BATCH, 512)
              and masks.dtype == torch.uint8 and masks.shape[-1] == 56,
              f'{kind} mask targets at {size}, {tuple(idx.shape)}')
        got = crop_resize_mask(*args)
        torch.cuda.synchronize()
        want = crop_resize_mask_plain(*args)
        err = float((got - want).abs().max())
        lib, band = crop_resize_library(torch, *args)
        lib_diff = (lib()[:, 0] - want.flatten(0, 1)).abs()
        lib_err = float(lib_diff[~band].max())
        fg = float((want > 0).float().mean())
        log(f'mask/corner train kernels: crop_resize_mask {kind} '
            f'{tuple(want.shape)}: max_abs_err={err:.3e} (every cell equal '
            f'to plain required), '
            f'{fg:.1%} of the cells > 0; F.grid_sample (border) x in-box '
            f'mask within {lib_err:.3e} of plain outside the first half '
            f'cell of each axis ({float(band.float().mean()):.1%} of the '
            f'cells, where erd_tpu blends rows 0 and 1: up to '
            f'{float(lib_diff[band].max()):.3f} there)')
        # grid_sample maps [-1, 1] back to crop pixels in its own rounding,
        # which moves a cell's weights by up to ~1e-4 (1.35e-4 measured)
        check(lib_err <= 1e-3, f'{kind}: F.grid_sample does not give the '
              f'targets outside the edge band')
        check(torch.equal(got, want), f'mask-target kernel differs from '
              f'plain ({kind})')
        check(0.02 < fg < 0.98, f'{kind}: degenerate mask targets')
        ms, call_ms, src, plain_ms = time_graph(
            torch, lambda: crop_resize_mask(*args),
            lambda: crop_resize_mask_plain(*args))
        library_ms = graph_ms(torch, lib)
        nbytes = masks.numel() + boxes.numel() * 4 + idx.numel() * 8 + \
            rois.numel() * 4 + want.numel() * 4
        bms, by = bound_of(nbytes, want.numel() * 30.0)
        log(f'mask/corner train kernels: crop_resize_mask {kind}: {ms:.4f} '
            f'ms device ({src}), {call_ms:.4f} ms per call, plain '
            f'{plain_ms:.3f} ms, bound {bms:.4f} ms ({by}; {nbytes} bytes), '
            f'F.grid_sample {library_ms:.4f} ms')
        shapes.append(dict(kind=kind, out=list(want.shape), ms=ms,
                           call_ms=call_ms, ms_from=src, plain_ms=plain_ms,
                           bound_ms=bms, bound_by=by, library_ms=library_ms,
                           max_abs_err=err))
        if kind == 'point_rend':
            ps_calls = calls
    big = shapes[0]
    rows.append(dict(name='crop_resize_mask', route='cuda',
                     source='erd_tpu_torch/csrc/mask_target.cu',
                     replaces='erd_tpu/data/masks.py:46',
                     max_abs_err=max(t['max_abs_err'] for t in shapes),
                     ms=big['ms'], call_ms=big['call_ms'],
                     ms_from=big['ms_from'], ms_at=f'out {big["out"]}',
                     plain_ms=big['plain_ms'], bound_ms=big['bound_ms'],
                     bound_by=big['bound_by'],
                     library_ms=big['library_ms'], deterministic=True,
                     shapes=shapes))

    # -- row 13a-b: the point-sample backward on PointRend's two calls
    check(len(ps_calls['point_sample']) == 4 and
          len(ps_calls['point_sample_backward']) == 2,
          'PointRend step: not 4 point_sample and 2 backward calls')
    shapes, worst, worst_ulps = [], 0.0, 0
    for args in ps_calls['point_sample_backward']:
        grad, pts, shape, strides, dtype = args[:5]
        got = point_sample_backward(*args)
        torch.cuda.synchronize()
        want = point_sample_backward_plain(grad, pts, shape)
        diff = (got.float() - want).abs()
        limit = 1e-5 * float(want.abs().max())
        if dtype == torch.float32:
            err = float(diff.max())
            check(err <= limit, f'point-sample backward kernel disagrees '
                  f'with plain at {shape}')
            worst = max(worst, err)
        else:
            got32 = point_sample_backward(grad, pts, shape, strides,
                                          torch.float32)
            err = float((got32 - want).abs().max())
            check(err <= limit, f'point-sample backward kernel (float32 '
                  f'buffer) disagrees with plain at {shape}')
            worst = max(worst, err)
            ulps = bf16_ulps(torch, got, want.to(dtype))
            far = diff > limit
            worst_ulps = max(worst_ulps, int(ulps[far].max()) if
                             bool(far.any()) else 0)
            check(bool(((ulps <= 1) | ~far).all()), 'point-sample backward '
                  'kernel, bf16 P2: more than one ulp from plain')
        n, k, c = grad.shape
        h, w = shape[2:]
        xs, ys = pts[..., 0] * w - 0.5, pts[..., 1] * h - 0.5
        off = float(((xs < 0) | (xs > w - 1) | (ys < 0) |
                     (ys > h - 1)).float().mean())
        again = torch.equal(point_sample_backward(*args), got)
        log(f'mask/corner train kernels: point_sample_backward {shape} '
            f'{dtype}, {n * k} points: max_abs_err={err:.3e} (limit '
            f'{limit:.3e}, 1e-5*max|plain|; the kernel sums each pixel in '
            f'its tile list\'s order), {off:.2%} of the points with a '
            f'corner off the map, strides {tuple(got.stride())}; two calls '
            f'equal {again}')
        check(again, f'point-sample backward kernel at {shape}: two calls '
              f'differ')
        ms, call_ms, src, plain_ms = time_graph(
            torch, lambda: point_sample_backward(*args),
            lambda: point_sample_backward_plain(grad, pts, shape), n=10)
        # its device operations apart: a launch by the mean of the
        # profiler's records (binning only where the map is cut into tiles)
        ops_ms = {op: launch_ms(torch, lambda: point_sample_backward(*args),
                                f'point_sample_{op}_kernel', 5)[0]
                  for op in ('rank', 'scan', 'scan_sums', 'scatter',
                             'gather')}
        maps = torch.zeros(shape, device=DEV, dtype=torch.float32)
        leaf = maps.requires_grad_()
        gs_out = grid_sample_points(torch, leaf, pts)

        def library():
            return torch.autograd.grad(gs_out, leaf, grad,
                                       retain_graph=True)[0]
        lib_err = float((library() - want).abs().max())
        library_ms = events_ms(torch, library, 5)
        out_bytes = torch.empty((), dtype=dtype).element_size()
        nbytes = grad.numel() * 4 + pts.numel() * 4 + \
            n * c * h * w * out_bytes
        bms, by = bound_of(nbytes, n * k * c * 12.0)
        log(f'mask/corner train kernels: point_sample_backward {shape}: '
            f'{ms:.4f} ms device ({src}; every launch of the call), '
            f'{call_ms:.4f} ms per call; launches (profiler): ' + ', '.join(
                f'{op} {v:.4f}' if v else f'{op} no record'
                for op, v in ops_ms.items()) +
            f'; plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}; {nbytes} '
            f'bytes); F.grid_sample\'s backward on the widened float32 map '
            f'{library_ms:.4f} ms (events; within {lib_err:.3e} of plain)')
        shapes.append(dict(maps=list(shape), dtype=str(dtype), points=n * k,
                           ms=ms, call_ms=call_ms, ms_from=src,
                           plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                           library_ms=library_ms, max_abs_err=err,
                           ops_ms=ops_ms, repeat_equal=again))
        del maps, leaf, gs_out
    fine = max(shapes, key=lambda t: t['maps'][2])
    rows.append(dict(name='point_sample_backward', route='cuda',
                     source='erd_tpu_torch/csrc/point_sample.cu',
                     replaces='erd_tpu/ops/sampling.py:41', max_abs_err=worst,
                     max_bf16_ulps=worst_ulps, ms=fine['ms'],
                     call_ms=fine['call_ms'], ms_from=fine['ms_from'],
                     ms_at=f'maps {fine["maps"]}', plain_ms=fine['plain_ms'],
                     bound_ms=fine['bound_ms'], bound_by=fine['bound_by'],
                     library_ms=fine['library_ms'], deterministic=True,
                     redesigned=True, design='a block a tile of pixels '
                     '(a 14 x 14 map, or 8 x 8 of P2 after a stable '
                     'counting sort of the points by tile), float32 sums in '
                     'shared memory, a warp 32 channels; each point\'s '
                     'gradient read once a tile; written once; no float '
                     'atomics, no float32 buffer', shapes=shapes,
                     forward_train_shapes=point_train_calls(
                         torch, ps_calls['point_sample'])))
    del ps_calls
    torch.cuda.empty_cache()

    # -- rows 12a-b and 15: one CornerNet step
    calls = mask_train_step_calls(np, torch, 'cornernet',
                                  ('corner_pool_backward',
                                   'render_corner_targets'))
    check(len(calls['corner_pool_backward']) == 8 and
          len(calls['render_corner_targets']) == 1,
          'CornerNet step: not 8 corner-pool backward and 1 target call')
    shapes, ties = {}, []
    for x, g, direction in calls['corner_pool_backward']:
        check(tuple(x.shape) == (CORNERNET_TRAIN_BATCH, 128, 192, 256) and
              x.dtype == torch.float32, f'corner pool backward at '
              f'{tuple(x.shape)} {x.dtype}')
        check(x.is_contiguous(memory_format=torch.channels_last),
              f'corner pool backward ({direction}): x {x.stride()} is not '
              f'the step\'s channels-last map')
        got = corner_pool_backward(x, g, direction)
        torch.cuda.synchronize()
        check(torch.equal(got, corner_pool_backward_plain(x, g, direction)),
              f'corner-pool backward kernel differs from plain ({direction})')
        check(got.stride() == x.stride(), f'corner-pool backward '
              f'({direction}): the result\'s strides {got.stride()} are not '
              f'x\'s {x.stride()}')
        ties.append(float((x == 0).float().mean()))
        if direction in shapes:
            continue
        ms, call_ms, src, plain_ms = time_graph(
            torch, lambda: corner_pool_backward(x, g, direction),
            lambda: corner_pool_backward_plain(x, g, direction), n=10)
        dim = 2 if direction in ('top', 'bottom') else 3
        leaf = x.detach().requires_grad_()
        flip = direction in ('top', 'left')
        cm = torch.cummax(leaf.flip(dim) if flip else leaf, dim).values
        cummax_ms = events_ms(torch, lambda: torch.autograd.grad(
            cm, leaf, g.flip(dim) if flip else g, retain_graph=True)[0], 5)
        nbytes = 3 * x.numel() * 4
        bms, by = bound_of(nbytes, x.numel() * 8.0)
        shapes[direction] = dict(ms=ms, call_ms=call_ms, ms_from=src,
                                 plain_ms=plain_ms, bound_ms=bms,
                                 bound_by=by, cummax_backward_ms=cummax_ms,
                                 x_stride=list(x.stride()),
                                 grad_stride=list(g.stride()))
        log(f'mask/corner train kernels: corner_pool_backward {direction} '
            f'{tuple(x.shape)} (x strides {x.stride()}, grad {g.stride()}, '
            f'read where they lie): equal to plain, in x\'s layout; '
            f'{ms:.4f} ms device ({src}), '
            f'{call_ms:.4f} ms per call, plain {plain_ms:.3f} ms, bound '
            f'{bms:.4f} ms ({by}; {nbytes} bytes); torch.cummax\'s backward '
            f'{cummax_ms:.4f} ms (another function on ties: not the '
            f'library time)')
        del leaf, cm
    log(f'mask/corner train kernels: corner_pool_backward: all 8 calls '
        f'bit-equal to plain; {min(ties):.1%}-{max(ties):.1%} of the '
        f'pools\' inputs are exact zeros (ReLU), where ties share the '
        f'gradient by the scan tree')
    # fault 3.11 and the forward at the train shape, one call a direction
    firsts = {}
    for x, g, direction in calls['corner_pool_backward']:
        firsts.setdefault(direction, (x, g))
    nan_rays_check(torch, [(x, d) for d, (x, _) in firsts.items()],
                   'mask/corner train kernels',
                   grads=[g for x, g in firsts.values()])
    train_forward = [time_corner_pool(torch, x, d,
                                      'mask/corner train kernels')
                     for d, (x, _) in firsts.items()]
    top = shapes['top']
    rows.append(dict(name='corner_pool_backward', route='cuda',
                     source='erd_tpu_torch/csrc/corner_pool.cu',
                     replaces='erd_tpu/ops/extra_nms.py:63', max_abs_err=0.0,
                     ms=top['ms'], call_ms=top['call_ms'],
                     ms_from=top['ms_from'],
                     ms_at=f'top (B, 128, 192, 256) B={CORNERNET_TRAIN_BATCH}',
                     plain_ms=top['plain_ms'], bound_ms=top['bound_ms'],
                     bound_by=top['bound_by'], library_ms=None,
                     deterministic=True, directions=shapes,
                     forward_by_direction=train_forward))

    args = calls['render_corner_targets'][0]
    boxes, labels, mask, feat_hw, num_classes, ratio = args
    got = render_corner_targets(*args)
    torch.cuda.synchronize()
    sc = corner_scalars(*args)
    want = render_corner_targets_plain(sc, feat_hw, num_classes)
    err, peaks = 0.0, []
    for c in ('tl', 'br'):
        err = max(err, float((got[f'{c}_heat'] - want[f'{c}_heat']).abs()
                             .max()))
        peaks.append((int((got[f'{c}_heat'] == 1).sum()),
                      int((want[f'{c}_heat'] == 1).sum())))
        for k in ('off', 'w'):
            check(torch.equal(got[f'{c}_{k}'], want[f'{c}_{k}']),
                  f'corner-target kernel: {c}_{k} differs from plain')
        check(torch.equal(got[f'{c}_xy'], torch.stack(
            [sc[f'{c}_x'], sc[f'{c}_y']], -1)),
            f'corner-target kernel: {c}_xy differs from corner_scalars')
    log(f'mask/corner train kernels: render_corner_targets B={boxes.shape[0]}'
        f' G={boxes.shape[1]} ({int(mask.sum())} valid) {num_classes} '
        f'classes {tuple(feat_hw)}: heat max_abs_err={err:.3e} (limit '
        f'1e-6), exact-1 peaks card/plain {peaks}, offsets, weights and '
        f'corner pixels equal')
    check(err <= 1e-6 and all(a == b > 0 for a, b in peaks),
          'corner-target kernel disagrees with plain')
    ms, call_ms, src, plain_ms = time_graph(
        torch, lambda: render_corner_targets(*args),
        lambda: render_corner_targets_plain(corner_scalars(*args), feat_hw,
                                            num_classes), n=10)
    b, (fh, fw) = boxes.shape[0], feat_hw
    nbytes, ops, inside = corner_targets_cost(torch, args)
    bms, by = bound_of(nbytes, ops)
    log(f'mask/corner train kernels: render_corner_targets: {ms:.4f} ms '
        f'device ({src}), {call_ms:.4f} ms per call, plain {plain_ms:.3f} '
        f'ms, bound {bms:.4f} ms ({by}; {nbytes} bytes, {inside:.0f} '
        f'gaussian cells); library_ms null: no single PyTorch call renders '
        f'the targets')
    rows.append(dict(name='render_corner_targets', route='cuda',
                     source='erd_tpu_torch/csrc/corner_targets.cu',
                     replaces='erd_tpu/ops/gaussian.py:107', max_abs_err=err,
                     ms=ms, call_ms=call_ms, ms_from=src,
                     ms_at=f'B={b} {num_classes}x{fh}x{fw}',
                     plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                     library_ms=None, deterministic=True, peaks=peaks,
                     redesigned=True, design=CORNER_TARGETS_DESIGN))
    del calls
    torch.cuda.empty_cache()
    return rows, roi_backward, roi_forward


def picks_held(torch, module, recorded, moved):
    """For a reference run: PointRend's importance picks (the top-k of
    ``module.topk_stable`` at the 147 of 588) of the first run are
    recorded; later runs compute their own, count those that differ (each
    must be a near-tie within PICK_TIE_RTOL of the largest uncertainty) and
    go on with the first run's, so that every run trains on the same
    points. Returns the patch's ``make``."""
    def make(topk):
        def wrapper(values, k):
            top, idx = topk(values, k)
            if values.shape[-1] != 588:
                return top, idx
            if not recorded:
                recorded.append(idx)
                return top, idx
            want = recorded[0].to(idx.device)
            off = idx != want
            theirs = torch.gather(values, 1, want)
            scale = values.abs().amax(-1, keepdim=True)
            near = ((top - theirs).abs() <= PICK_TIE_RTOL * scale)
            moved.append((int(off.sum()), int((off & ~near).sum()),
                          want.numel()))
            return theirs, want
        return wrapper
    return make


def phase_mask_train_reference(np, torch,
                               kinds=('mask_rcnn', 'point_rend', 'cornernet')):
    """Mask R-CNN and PointRend R50 (float32, 2 images 128x192 with gt
    crops, 64 sampled RoIs an image to keep the CPU's mask heads short) and
    CornerNet at HG-104's width and 5 levels but one stack of one block a
    level (float32, 2 images 256x256): the loss dict and the parameter
    gradients on the card (kernels) against the CPU (plain versions), with
    the same sampler and point draws, the CPU's proposals and PointRend
    importance picks (reference_gate; the gradients apart per loss part
    over backbone + neck and the heads; CornerNet's backbone parts at 3x
    the CPU's own float32 error against float64); CornerNet's updated BN
    running statistics card vs CPU within 1e-3 of each tensor's largest
    value; then a 1 % error planted in the point-sample backward
    (PointRend) and in the corner-pool backward (CornerNet) must each fail
    the limits. Returns Mask R-CNN's mask gradient over backbone + neck
    against a float64 CPU run, {'card': ||diff|| / ||ref||, 'cpu': ...}
    (ROADMAP.md 3.10), when ``kinds`` holds it."""
    import copy
    import dataclasses
    import importlib

    from erd_tpu_torch.structures import ImageMeta, stack_to
    sampling = importlib.import_module('erd_tpu_torch.ops.sampling')
    pools = importlib.import_module('erd_tpu_torch.ops.extra_nms')
    frcnn_module = importlib.import_module(
        'erd_tpu_torch.models.detectors.faster_rcnn')
    pr_module = importlib.import_module(
        'erd_tpu_torch.models.detectors.point_rend')
    proposals_fn = frcnn_module.rpn_proposals
    mask_off64 = {}
    for kind in kinds:
        _, det, net_cpu = mask_train_net(torch, kind, device='cpu',
                                         dtype='float32', seed=9)
        if kind == 'cornernet':
            # full width and all 5 levels, one stack of one block a level:
            # the 2-stack HG-104's train-mode BN backward leaves float32
            # ~10 % off float64 in the backbone (on either device)
            det = dataclasses.replace(det, num_stacks=1,
                                      stage_blocks=(1,) * 6)
            net_cpu = det.init(seed=9, device='cpu')
        h, w = (256, 256) if kind == 'cornernet' else (128, 192)
        rs = np.random.RandomState(19)
        gen = torch.Generator(device='cpu').manual_seed(19)
        images = torch.from_numpy(rs.randint(0, 256, (2, h, w, 3),
                                             np.uint8))
        gt = synthetic_gt(np, torch, rs, 2, (h, w), device='cpu',
                          num_labels=NUM_CLASSES)
        gt = dataclasses.replace(gt, masks=gt_crops(torch, gen, 2,
                                                    device='cpu'))
        metas = [ImageMeta.make((h, w), (h, w), (1.0, 1.0), img_id=i)
                 for i in (1, 2)]
        names = [k for k, p in net_cpu.named_parameters() if p.requires_grad]
        if kind == 'cornernet':
            low = [k for k in names if k.startswith('backbone.')]
            groups = {'heatmap': ['loss_heatmap'],
                      'embedding': ['loss_pull', 'loss_push'],
                      'offset': ['loss_offset']}
            draws = None
        else:
            det.rcnn_train_cfg = dataclasses.replace(det.rcnn_train_cfg,
                                                     num_samples=64)
            low = [k for k in names if k.startswith(('backbone.', 'neck.'))]
            groups = {'rpn': ['loss_rpn_cls', 'loss_rpn_bbox'],
                      'rcnn': ['loss_cls', 'loss_bbox'],
                      'mask': ['loss_mask'] + (
                          ['loss_point'] if kind == 'point_rend' else [])}
            ctx = det.anchor_context((h, w))
            draws = det.train_draws(torch.tensor([1, 2]), 2,
                                    ctx.num_anchors,
                                    det.proposal_cfg_train.max_per_img +
                                    MAX_GT, 'cpu')
        high = [k for k in names if k not in low]
        cpu_proposals, moved, picks, pick_moved, stats = [], [], [], [], []

        def proposals(*args):
            out = proposals_fn(*args)
            if not cpu_proposals:
                cpu_proposals.append(out)
                return out
            want = [t.to(out[0].device) for t in cpu_proposals[0]]
            moved.append(proposal_swaps(out, want))
            return tuple(want)

        seen = {}

        def run(dev, dtype=torch.float32):
            net = copy.deepcopy(net_cpu).to(dev, dtype)
            batch = dict(images=images.to(dev), meta=stack_to(metas, dev),
                         gt=type(gt)(**{k: None if v is None else v.to(dev)
                                        for k, v in vars(gt).items()}))
            with contextlib.ExitStack() as stack:
                if dtype != torch.float32:  # the float64 CPU run
                    pre = det.preprocessor
                    stack.enter_context(patched(
                        det, 'preprocessor',
                        lambda _: lambda im: pre(im).to(dtype)))
                if kind == 'cornernet':
                    losses = det.loss(net, batch)
                else:
                    stack.enter_context(patched(
                        frcnn_module, 'rpn_proposals', lambda _: proposals))
                    stack.enter_context(patched(
                        pr_module, 'topk_stable',
                        picks_held(torch, pr_module, picks, pick_moved)))
                    losses = det.loss(net, batch,
                                      draws=[d.to(dev) for d in draws])
            stats.append({k: v.double().cpu() for k, v in
                          net.state_dict().items() if 'running_' in k})
            params = dict(net.named_parameters())
            grads = {}
            for i, (part, keys) in enumerate(groups.items()):
                gs = torch.autograd.grad(
                    sum(losses[k] for k in keys), [params[k] for k in names],
                    retain_graph=i < len(groups) - 1, allow_unused=True)
                grads[part] = {k: (torch.zeros_like(params[k]) if g is None
                                   else g).double().cpu()
                               for k, g in zip(names, gs)}
            seen.setdefault((dev, dtype), grads)
            return {k: float(v.detach()) for k, v in losses.items()}, grads

        # the mask losses' gradient over backbone + neck: 3e-3; the float64
        # CPU run below puts the card's float32 1.9e-3 from it and the
        # CPU's 1.3e-4 (ROADMAP.md section 3, 3.10)
        limits = {('mask', 'low'): 3e-3}
        if kind == 'cornernet':
            # the backbone parts at 3x the CPU's own float32 error against
            # float64 on this step (at least 1e-3): train-mode BN stacked
            # ~30 deep magnifies float32 noise
            floor32 = run('cpu')[1]
            floor64 = run('cpu', torch.float64)[1]
            seen.clear()
            stats.clear()
            for group in groups:
                diff = torch.cat([(floor32[group][k] - floor64[group][k])
                                  .flatten() for k in low])
                ref = torch.cat([floor64[group][k].flatten() for k in low])
                limits[(group, 'low')] = max(
                    1e-3, 3 * float(diff.norm() / ref.norm()))
            log(f'mask/corner train reference: cornernet CPU float32 '
                f'against float64, backbone gradients x 3: ' + ', '.join(
                    f'{g} {limits[(g, "low")]:.2e}' for g in groups))
            # the card's float32 pools and heads sit 1-2e-3 off the CPU
            # (ROADMAP 3.10); the convs in front of the pools, whose whole
            # gradient is the pool backward's output, 4.8e-3 (a 1 % error
            # there reads 1.1e-2), at 7e-3
            limits.update({(g, 'high'): 3e-3 for g in groups})
        parts = [(f'{group} gradient, {scope}', group, keys,
                  limits.get((group, tag), 1e-3))
                 for group in groups
                 for scope, keys, tag in (('backbone' + (
                     '' if kind == 'cornernet' else '+neck'), low, 'low'),
                                          ('heads', high, 'high'))]
        if kind == 'cornernet':
            parts.append(('gradient of the convs before the pools', None,
                          [k for k in high if 'direction' in k], 7e-3))
        controls = {
            'point_rend': [('point_sample_backward x 1.01', sampling,
                            'point_sample_backward', planted())],
            'cornernet': [('corner_pool_backward x 1.01', pools,
                           'corner_pool_backward', planted())]}.get(kind, [])
        # CornerNet: the whole-gradient and per-tensor limits over the
        # pools and heads; its backbone enters through the parts
        reference_gate(np, torch, f'mask/corner train reference: {kind} '
                       f'float32 {h}x{w} x 2', run,
                       high if kind == 'cornernet' else names, parts,
                       controls, floor=0)
        if kind == 'mask_rcnn':
            run('cpu', torch.float64)

            def part_ratio(dev, dtype):
                got, want = seen[(dev, dtype)]['mask'], \
                    seen[('cpu', torch.float64)]['mask']
                diff = torch.cat([(got[k] - want[k]).flatten() for k in low])
                ref = torch.cat([want[k].flatten() for k in low])
                return float(diff.norm() / ref.norm())
            mask_off64 = {'card': part_ratio(DEV, torch.float32),
                          'cpu': part_ratio('cpu', torch.float32)}
            log(f'mask/corner train reference: mask_rcnn mask gradient over '
                f'backbone + neck against a float64 CPU run (plain): card '
                f'{mask_off64["card"]:.2e}, CPU float32 '
                f'{mask_off64["cpu"]:.2e} (no gate)')
        if kind == 'cornernet':
            # the pools and heads parts against float64, as Mask R-CNN's
            # mask part above (ROADMAP.md section 3, 3.10)
            def off64(dev, group):
                got = seen[(dev, torch.float32)][group]
                diff = torch.cat([(got[k] - floor64[group][k]).flatten()
                                  for k in high])
                ref = torch.cat([floor64[group][k].flatten() for k in high])
                return float(diff.norm() / ref.norm())
            log('mask/corner train reference: cornernet pools + heads '
                'gradients against a float64 CPU run (plain): ' + ', '.join(
                    f'{g} card {off64(DEV, g):.2e} CPU {off64("cpu", g):.2e}'
                    for g in groups) + ' (no gate)')
            worst = max(float((stats[1][k] - stats[0][k]).abs().max() /
                              stats[0][k].abs().max()) for k in stats[0])
            log(f'mask/corner train reference: cornernet BN running '
                f'statistics card vs CPU after the step: {len(stats[0])} '
                f'tensors, worst max|diff| / max|value| {worst:.2e} (limit '
                f'1e-3)')
            check(worst <= 1e-3, 'CornerNet BN running statistics differ '
                  'between card and CPU')
        else:
            slots = cpu_proposals[0][2].numel()
            log(f'mask/corner train reference: {kind} card on the CPU\'s '
                f'proposals: {moved[0][0]} of {slots} proposal slots differ '
                f'on the card, {moved[0][1]} of them not an adjacent '
                f'near-tie swap')
            check(moved[0][1] == 0 and
                  moved[0][0] <= PROPOSAL_MOVED_SHARE * slots,
                  f'{kind}: the card\'s training proposals differ from the '
                  f'CPU\'s')
            if kind == 'point_rend':
                n_off, n_far, total = pick_moved[0]
                log(f'mask/corner train reference: point_rend card on the '
                    f'CPU\'s importance picks: {n_off} of {total} picks '
                    f'differ on the card, {n_far} of them beyond a near-tie '
                    f'({PICK_TIE_RTOL:g} of the largest uncertainty)')
                check(n_far == 0 and n_off <= PICK_MOVED_SHARE * total,
                      'point_rend: the card\'s importance picks differ from '
                      'the CPU\'s')
        del net_cpu
    torch.cuda.empty_cache()
    return mask_off64


def phase_mask_train(np, torch, card):
    """build_trainer + fit of Mask R-CNN and PointRend R50 (bs 16,
    800x1344, bf16, gt crops) and CornerNet HG-104 (bs 6, 768x1024,
    float32, Adam) (fit_and_check): 2 warm-up and 5 timed steps, the
    launches of every kernel of each path, finite losses, the frozen stages
    unchanged (ResNet's stem and layer1; the hourglass's stem_conv), every
    trainable weight and (CornerNet) every BN running statistic moved; the
    stage times and the idle share of one profiled step."""
    import importlib

    from erd_tpu_torch.data.masks import crop_resize_mask
    from erd_tpu_torch.ops import (corner_pool, nms_sorted_keep,
                                   point_sample, roi_align,
                                   roi_align_backward)
    from erd_tpu_torch.ops.extra_nms import corner_pool_backward
    from erd_tpu_torch.ops.gaussian import render_corner_targets
    from erd_tpu_torch.ops.sampling import point_sample_backward
    frcnn = importlib.import_module(
        'erd_tpu_torch.models.detectors.faster_rcnn')
    launches = {}
    for kind in ('mask_rcnn', 'point_rend', 'cornernet'):
        tag = {'mask_rcnn': 'mask_rcnn train', 'point_rend': 'pointrend '
               'train', 'cornernet': 'cornernet train'}[kind]
        cfg, det, net = mask_train_net(torch, kind)
        loader = mask_train_loader(np, torch, kind,
                                   TRAIN_WARMUP + TRAIN_TIMED, 71)
        if kind == 'cornernet':
            counters = {'corner_pool': corner_pool,
                        'corner_pool_backward': corner_pool_backward,
                        'render_corner_targets': render_corner_targets}
            check(cfg.optim_wrapper.optimizer.type == 'Adam',
                  'CornerNet config does not train with Adam')
            trainer, loader, launches[tag] = fit_and_check(
                np, torch, card, tag, cfg, det, net, counters,
                CORNERNET_STEP_LAUNCHES, seed=71, loader=loader,
                dtype=torch.float32, frozen=('backbone.stem_conv.',))
            check(type(trainer.optimizer).__name__ == 'Adam',
                  'CornerNet trained without Adam')
            step_breakdown(torch, tag, trainer, net, loader,
                           hooks=[(net.backbone, 'hourglass (2 stacks)'),
                                  (net, 'corner pools + heads')],
                           wrapped=[(det, 'targets', 'corner targets')])
        else:
            counters = {'roi_align': roi_align,
                        'roi_align_backward': roi_align_backward,
                        'nms_keep': nms_sorted_keep,
                        'crop_resize_mask': crop_resize_mask,
                        'point_sample': point_sample,
                        'point_sample_backward': point_sample_backward}
            trainer, loader, launches[tag] = fit_and_check(
                np, torch, card, tag, cfg, det, net, counters,
                MASK_TRAIN_STEP_LAUNCHES[kind], seed=71, loader=loader)
            step_breakdown(
                torch, tag, trainer, net, loader,
                hooks=[(net.neck, 'backbone + neck'),
                       (net.rpn_head, 'RPN head')],
                wrapped=[(frcnn, 'rpn_loss', 'RPN loss'),
                         (frcnn, 'rpn_proposals',
                          f'proposals (NMS K={TRAIN_RPN_K})'),
                         (frcnn, 'rcnn_sample', 'assign + sample'),
                         (det, 'rcnn_losses', 'RoIAlign 7 + 14, R-CNN and '
                          'mask heads, targets, losses')])
        del net, trainer
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------- SOLOv2 R50
SOLO_CONFIG = os.path.join(ROOT, 'configs', 'solov2',
                           'solov2_r50_fpn_1x_coco.py')
# the SOLOv2 cell's arranged heads (arrange_solo_heads): about SOLO_PASSING
# cells of a request over score_thr (the other nms_pre slots score 0), the
# dynamic masks' logits at std SOLO_LOGIT_STD
SOLO_SEED, SOLO_PASSING, SOLO_LOGIT_STD = 23, 300, 3.0
SOLO_REFERENCE_HW = (800, 1333)
# card vs CPU decode of one request: matched detections (label and box)
# within SOLO_SCORE_RTOL, their binarised crops at IoU >= SOLO_MASK_IOU;
# at most SOLO_UNMATCHED of the detections unmatched (near-tie flips)
SOLO_SCORE_RTOL, SOLO_MASK_IOU, SOLO_UNMATCHED = 1e-3, 0.99, 0.02


def solo_cls_logits(torch, cls_lvl):
    return torch.cat([c.reshape(c.shape[0], -1, c.shape[-1])
                      for c in cls_lvl], 1)


def arrange_solo_heads(torch, det, net, batch):
    """Shift conv_cls's bias so that about SOLO_PASSING cells of the
    request score over score_thr, and scale conv_kernel so that the top
    cells' mask logits have std SOLO_LOGIT_STD. erd_tpu's init scores
    every cell near its 0.01 prior (none passes score_thr = 0.1) and its
    mask logits sit near 0, so neither the decay nor the masks would see
    real work."""
    import math

    from erd_tpu_torch.ops.misc import take_rows
    head = net.mask_head
    with torch.no_grad():
        k, c, m = det.forward_raw(net, batch['images'])
        top = solo_cls_logits(torch, c).amax(-1).flatten().sort(
            descending=True).values
        thr = math.log(det.score_thr / (1 - det.score_thr))
        head.conv_cls.bias.add_(thr + 0.01 - float(top[SOLO_PASSING - 1]))
        score, _, idx, _ = det.dynamic_masks(k, c, m)
        kernels = torch.cat([x.reshape(x.shape[0], -1, x.shape[-1])
                             for x in k], 1)
        logits = torch.matmul(take_rows(kernels, idx[:, :64]),
                              m.flatten(2))
        head.conv_kernel.weight.mul_(SOLO_LOGIT_STD / float(logits.std()))
        head.conv_kernel.bias.mul_(SOLO_LOGIT_STD / float(logits.std()))
        _, c, _ = det.forward_raw(net, batch['images'])
        passing = int((torch.sigmoid(solo_cls_logits(torch, c)).amax(-1) >
                       det.score_thr).sum())
    return passing


def solo_net(np, torch, dtype=None, hw=(800, 1333)):
    """init_detector of the SOLOv2 config on the card (its bf16, or
    ``dtype``), heads arranged on the (H, W) request: (detector, network,
    the request's batch, cells passing score_thr)."""
    from erd_tpu_torch.apis import init_detector
    from erd_tpu_torch.config import Config
    cfg = Config.fromfile(SOLO_CONFIG)
    if dtype is not None:
        cfg.model.compute_dtype = dtype
    det, net, _ = init_detector(cfg, seed=SOLO_SEED, device=DEV)
    check(type(det).__name__ == 'SOLOV2Detector' and det.depth == 50 and
          det.num_classes == NUM_CLASSES and det.nms_pre == 500,
          f'{SOLO_CONFIG} is not SOLOv2 R50 with nms_pre 500')
    batch, _ = request_batch(np, torch, hw)
    passing = arrange_solo_heads(torch, det, net, batch)
    return det, net, batch, passing


def solo_compare(torch, tag, a, b, gate=True):
    """Card (``a``) vs CPU (``b``) SOLOv2 results, each (DetResults,
    crops): detections matched by label and box (within 1e-3 px) per
    image. Returns (stats, passed): unmatched detections on either side,
    the matched scores' worst relative difference, their binarised crops'
    smallest IoU and the crop pixels that flip; with ``gate``, checks
    them against SOLO_UNMATCHED, SOLO_SCORE_RTOL and SOLO_MASK_IOU."""
    (ra, ca), (rb, cb) = a, b
    ra = {f: getattr(ra, f).cpu() for f in ('bboxes', 'scores', 'labels',
                                            'mask')}
    ca = ca.cpu()
    n = unmatched = flipped = 0
    worst_rel, worst_iou = 0.0, 1.0
    for i in range(rb.mask.shape[0]):
        ib = torch.nonzero(rb.mask[i]).flatten().tolist()
        ia = torch.nonzero(ra['mask'][i]).flatten().tolist()
        n += max(len(ia), len(ib))
        free = set(ia)
        for j in ib:
            hit = next((k for k in ia if k in free and
                        int(ra['labels'][i, k]) == int(rb.labels[i, j]) and
                        float((ra['bboxes'][i, k] - rb.bboxes[i, j]).abs()
                              .max()) <= 1e-3), None)
            if hit is None:
                unmatched += 1
                continue
            free.discard(hit)
            worst_rel = max(worst_rel, abs(float(ra['scores'][i, hit]) /
                                           float(rb.scores[i, j]) - 1))
            ma, mb = ca[i, hit] > 0.5, cb[i, j] > 0.5
            union = int((ma | mb).sum())
            worst_iou = min(worst_iou, int((ma & mb).sum()) / union
                            if union else 1.0)
            flipped += int((ma ^ mb).sum())
        unmatched += len(free)
    stats = dict(detections=n, unmatched=unmatched,
                 max_score_rel=worst_rel, min_mask_iou=worst_iou,
                 crop_pixels_flipped=flipped)
    passed = (n > 0 and unmatched <= SOLO_UNMATCHED * n and
              worst_rel <= SOLO_SCORE_RTOL and worst_iou >= SOLO_MASK_IOU)
    log(f'{tag}: card vs CPU {stats} (limits: unmatched <= '
        f'{SOLO_UNMATCHED:g} of the detections, scores rtol '
        f'{SOLO_SCORE_RTOL:g}, mask IoU >= {SOLO_MASK_IOU:g})')
    if gate:
        check(passed, f'{tag}: card and CPU SOLOv2 results differ')
    return stats, passed


def random_nms_inputs(np, torch, rs, k, num_labels):
    """Clustered boxes on a 1/4-pixel grid over ``num_labels`` classes,
    10 % exact duplicates (tied IoUs), scores on a 1/16 grid (ties), 10 %
    invalid: (boxes (1, K, 4), scores, labels, valid) on the card."""
    centres = rs.uniform(50, 1300, (8, 2))
    c = centres[rs.randint(8, size=k)] + rs.normal(0, 12, (k, 2))
    wh = rs.uniform(16, 120, (k, 2))
    boxes = np.round(np.concatenate([c - wh / 2, c + wh / 2], -1) * 4) / 4
    dup = rs.rand(k) < 0.1
    boxes[dup] = boxes[rs.randint(k, size=int(dup.sum()))]
    out = (boxes.astype(np.float32), (rs.randint(0, 16, k) / 16).astype(
        np.float32), rs.randint(0, num_labels, k), rs.rand(k) > 0.1)
    return [torch.from_numpy(a[None]).to(DEV) for a in out]


def kernel_row(name, source, replaces, ms, call_ms, src, plain_ms, bms, by,
               library_ms, err, **extra):
    return dict(name=name, route='cuda', source=source, replaces=replaces,
                max_abs_err=err, ms=ms, call_ms=call_ms, ms_from=src,
                plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=library_ms, **extra)


def solo_nms_ops(np, torch, boxes, sc, labels, valid):
    """Rows 12c and 12d (ops no model calls): fast NMS and nms_match at IoU
    0.5 on ``random_nms_inputs`` at K = 2000 over 80 classes (boxes, sc,
    labels, valid) and K = 10000 over 80 classes, fast NMS also on the
    same K = 2000 boxes of one class (nms_match reads no labels: for it
    that call is the first one): the whole op from the unsorted inputs,
    keep masks and leaders equal to plain, fast NMS one launch (counted,
    and the nodes of a CUDA graph of the call), nms_match row 1's launches
    + 1; each kernel graph-timed beside its plain version and the
    function's bound. Returns (fast NMS's row, the leader's row)."""
    from erd_tpu_torch.ops import (fast_nms, fast_nms_plain, nms_mask,
                                   nms_match, nms_match_leader_plain,
                                   nms_sorted_keep)
    from erd_tpu_torch.ops.extra_nms import _nms_match_leader
    from erd_tpu_torch.ops.nms import nms_mask_words
    from erd_tpu_torch.tools.atomic_backward_probe import graph_launches
    thr = 0.5
    nms_calls = [('K=2000 80 classes', boxes, sc, labels, valid),
                 ('K=2000 one class', boxes, sc, torch.zeros_like(labels),
                  valid),
                 ('K=10000 80 classes', *random_nms_inputs(
                     np, torch, np.random.RandomState(31), 10000,
                     NUM_CLASSES))]
    fast_calls, match_calls = [], []
    for name, bx, s_, lab, val in nms_calls:
        kk = bx.shape[1]
        before = fast_nms.launches
        got = fast_nms(bx, s_, lab, thr, val)
        torch.cuda.synchronize()
        count = fast_nms.launches - before
        want = fast_nms_plain(bx, s_, lab, thr, val)
        same = bool(torch.equal(got, want))
        nodes = graph_launches(lambda: fast_nms(bx, s_, lab, thr, val))
        log(f'solo kernels: fast_nms {name} IoU {thr}: keep masks equal '
            f'{same} ({int(want.sum())} kept), {count} counted launch, '
            f'{nodes} launches in a graph of the call')
        check(same and 0 < int(want.sum()) < kk and count == 1 and
              nodes == 1, f'fast NMS ({name}) differs from plain, or is not '
              f'one launch from its unsorted inputs')
        ms, call_ms, src, plain_ms = time_graph(
            torch, lambda: fast_nms(bx, s_, lab, thr, val),
            lambda: fast_nms_plain(bx, s_, lab, thr, val))
        live = val[0] & (s_[0] == s_[0]) & (s_[0] > float('-inf'))
        counts = torch.bincount(lab[0][live]).double()
        pairs = float((counts * (counts - 1) / 2).sum())
        # the unsorted boxes, scores, labels and valid flags read, the keep
        # mask written; a same-class pair of live boxes ~15 operations
        bms, by = bound_of(kk * (16 + 4 + 8 + 1 + 1), pairs * 15.0)
        fast_calls.append(dict(call=name, k=kk, kept=int(want.sum()),
                               same_class_pairs=pairs, ms=ms,
                               call_ms=call_ms, ms_from=src,
                               plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                               graph_launches=nodes))
        log(f'solo kernels: fast_nms {name}: {ms:.4f} ms device ({src}), '
            f'{call_ms:.4f} ms per call, plain {plain_ms:.4f} ms, bound '
            f'{bms:.6f} ms ({by})')

        if name.endswith('one class'):
            continue  # nms_match reads no labels: the first call again
        # 12d: nms_match's leader from row 1's words (class-agnostic)
        keep, *words = nms_mask_words(bx, s_, thr, val)
        got = _nms_match_leader(bx, s_, val, thr, keep, *words)
        torch.cuda.synchronize()
        want = nms_match_leader_plain(bx, s_, keep, val, thr)
        before = (nms_sorted_keep.launches, nms_match.launches)
        mkeep, mleader = nms_match(bx, s_, thr, val)
        torch.cuda.synchronize()
        count = (nms_sorted_keep.launches - before[0],
                 nms_match.launches - before[1])
        same = bool(torch.equal(got, want) and torch.equal(mleader, want) and
                    torch.equal(mkeep, keep))
        nodes = graph_launches(lambda: nms_match(bx, s_, thr, val))
        row1 = graph_launches(lambda: nms_mask(bx, s_, thr, valid_mask=val))
        log(f'solo kernels: nms_match {name} IoU {thr}: leaders equal {same} '
            f'({int(keep.sum())} kept, {int((want < 0).sum())} without a '
            f'leader); counted: row 1 {count[0]}, leader {count[1]}; a '
            f'graph of the call {nodes} launches, of nms_mask {row1}')
        check(same and int((want >= 0).sum()) > 0 and count == (1, 1) and
              nodes == row1 + 1, f'nms_match ({name}) leaders differ from '
              f'plain, or it is not row 1\'s launches + 1')
        ms, call_ms, src, plain_ms = time_graph(
            torch, lambda: _nms_match_leader(bx, s_, val, thr, keep, *words),
            lambda: nms_match_leader_plain(bx, s_, keep, val, thr))
        kept = int(keep.sum())
        bms, by = bound_of(kk * (16 + 4 + 1 + 1 + 8), kk * kept * 15.0)
        match_calls.append(dict(
            call=name, k=kk, kept=kept, ms=ms, call_ms=call_ms, ms_from=src,
            plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            op_ms=graph_ms(torch, lambda: nms_match(bx, s_, thr, val)),
            nms_mask_ms=graph_ms(torch, lambda: nms_mask(
                bx, s_, thr, valid_mask=val)),
            graph_launches=nodes, nms_mask_graph_launches=row1,
            groups=int(torch.unique(want[want >= 0]).numel())))
        log(f'solo kernels: nms_match {name}: leader {ms:.4f} ms device '
            f'({src}), {call_ms:.4f} ms per call, plain {plain_ms:.4f} ms, '
            f'bound {bms:.6f} ms ({by}); nms_match '
            f'{match_calls[-1]["op_ms"]:.4f} ms (graph), nms_mask '
            f'{match_calls[-1]["nms_mask_ms"]:.4f}')
    head = fast_calls[0]
    fast_row = kernel_row(
        'fast_nms', 'erd_tpu_torch/csrc/extra_nms.cu',
        'erd_tpu/ops/extra_nms.py:44', head['ms'], head['call_ms'],
        head['ms_from'], head['plain_ms'], head['bound_ms'],
        head['bound_by'], None, 0.0, k=head['k'], kept=head['kept'],
        same_class_pairs=head['same_class_pairs'], calls=fast_calls,
        redesigned=True, design=(
            'one launch from the unsorted inputs: an image on ~K/16 '
            'blocks (at most two an SM), each bucketing the live boxes '
            'by label in shared memory; a warp a column walks its bucket '
            'to the first earlier box of its class that overlaps it'))
    head = match_calls[0]
    match_row = kernel_row(
        'nms_match_leader', 'erd_tpu_torch/csrc/nms.cu',
        'erd_tpu/ops/extra_nms.py:84', head['ms'], head['call_ms'],
        head['ms_from'], head['plain_ms'], head['bound_ms'],
        head['bound_by'], None, 0.0, k=head['k'], kept=head['kept'],
        groups=head['groups'], calls=match_calls, redesigned=True, design=(
            'one launch after row 1\'s two that reads their suppression '
            'words: a removed box\'s leader is the first kept row whose '
            'word has its bit; a block a column tile'))
    return fast_row, match_row


def phase_solo_kernels(np, torch):
    """Rows 12b-d and 13b: the fused mask-IoU decay on the real call of one
    800x1333 SOLOv2 R50 request (bf16, heads arranged: (1, 500) scores, most
    of them 0, the (1, 500, 500) mask overlaps and (1, 500) areas) within
    1e-6 relative of its plain version, zeros equal with their signs; the
    two-launch decay on that call's mask IoU, the same; the box form at K
    = 2000 (80 classes, tied scores and IoUs), gaussian and linear, within
    1e-6 relative; fast NMS and nms_match at IoU 0.5 at K = 2000 over 80
    classes and K = 10000 over 80 classes, fast NMS also on the same K =
    2000 boxes of one class, keep masks and leaders equal to plain, fast
    NMS one launch a call from its unsorted inputs (counted, and the nodes
    of a CUDA graph of the call), nms_match row 1's launches + 1 (the
    leader read from row 1's words); the masked conv (3x3, 256 -> 256, float32, 1 x 100 x
    168, masks of 840, 4200, 8300, 8400, 16700 and 16800 positions) with
    its masked-out positions exactly 0 and the rest within 1e-5 *
    max|plain|, a second call bit-equal; each timed by CUDA
    graph replays beside its bound, its plain version and the library call
    where one computes the function (13b: the dense cuDNN IEEE conv times
    the mask)."""
    import importlib

    import torch.nn.functional as F

    from erd_tpu_torch.ops import (mask_matrix_decay,
                                   mask_matrix_decay_plain, masked_conv2d,
                                   masked_conv2d_plain, matrix_decay,
                                   matrix_decay_plain, matrix_nms,
                                   matrix_nms_plain)
    from erd_tpu_torch.ops.sampling import (MASKED_CONV_TILES,
                                            masked_conv_positions,
                                            masked_conv_tile)
    from erd_tpu_torch.utils import conv_fp32_precision
    solo_module = importlib.import_module(
        'erd_tpu_torch.models.detectors.solov2')
    det, net, batch, passing = solo_net(np, torch)
    calls = []
    restore = capture(solo_module, 'mask_matrix_decay', calls)
    try:
        res, crops = det.predict(net, batch)
    finally:
        restore()
    torch.cuda.synchronize()
    check(len(calls) == 1, f'{len(calls)} mask_matrix_decay calls in one '
          f'SOLOv2 request, expected 1')
    args = calls[0]
    scores, inter, area, labels = args[:4]
    n = scores.shape[-1]
    zero = int((scores == 0).sum())

    def held(got, want):
        """(max relative error, zeros equal with their signs)."""
        live = want != 0
        rel = float(((got - want).abs() / want.abs())[live].max()) \
            if bool(live.any()) else 0.0
        return rel, bool(torch.equal(got == 0, ~live) and torch.equal(
            torch.signbit(got[~live]), torch.signbit(want[~live])))
    got = mask_matrix_decay(*args)
    torch.cuda.synchronize()
    want = mask_matrix_decay_plain(*args)
    rel, exact_zero = held(got, want)
    decayed = int((want < scores).sum())
    log(f'solo kernels: mask_matrix_decay on the request\'s call: N={n}, '
        f'{passing} cells over score_thr, {zero} slots scored 0, {decayed} '
        f'decayed; max rel err {rel:.2e} (limit 1e-6), zeros equal '
        f'{exact_zero}; {int(res.mask.sum())} detections')
    check(rel <= 1e-6 and exact_zero and decayed > 0,
          'mask_matrix_decay differs from plain on the SOLOv2 call')
    ms, call_ms, src, plain_ms = time_graph(
        torch, lambda: mask_matrix_decay(*args),
        lambda: mask_matrix_decay_plain(*args))
    # the live rows' IoU inputs as the data needs them (a zero score's row
    # is never read), the scores, areas, labels and output; a live pair:
    # the mask IoU (an add, a difference, a max, a division), the comp
    # pass (2 compares, a max) and the decay (3 products, a difference, an
    # exp, a min)
    live = n - zero
    bms, by = bound_of(live * n * 4 + n * (4 + 4 + 8 + 4), live * n * 13.0)
    fused_row = kernel_row(
        'mask_matrix_decay', 'erd_tpu_torch/csrc/extra_nms.cu',
        'erd_tpu/models/detectors/solov2.py:400', ms, call_ms, src, plain_ms,
        bms, by, None, float((got - want).abs().max()), max_rel_err=rel,
        inline_in='erd_tpu/models/detectors/solov2.py:400-410', n=n,
        zero_slots=zero, redesigned=True, design=(
            'one cooperative launch from inter and area, the mask IoU '
            'computed where it is used; an image on ~N/8 blocks, a warp a '
            'row; the comps across one grid-wide barrier, a row\'s '
            'decay_iou held in registers over it; one exp a row; rows '
            'scored 0 and terms whose condition fails skipped (exact)'))
    log(f'solo kernels: mask_matrix_decay N={n} {ms:.4f} ms device ({src}), '
        f'{call_ms:.4f} ms per call, plain {plain_ms:.4f} ms, bound '
        f'{bms:.6f} ms ({by})')

    # 12b's two-launch kernel on the same call's mask IoU (the op form)
    union = area[:, :, None] + area[:, None, :] - inter
    miou = inter / union.clamp(min=1.0)
    dargs = (scores, miou) + tuple(args[3:])
    got = matrix_decay(*dargs)
    torch.cuda.synchronize()
    want = matrix_decay_plain(*dargs)
    rel, exact_zero = held(got, want)
    check(rel <= 1e-6 and exact_zero,
          'matrix_decay differs from plain on the SOLOv2 call\'s IoU')
    ms, call_ms, src, plain_ms = time_graph(
        torch, lambda: matrix_decay(*dargs),
        lambda: matrix_decay_plain(*dargs))
    bms, by = bound_of(miou.numel() * 4 + n * 16, n * n * 9.0)
    decay_row = kernel_row(
        'matrix_decay', 'erd_tpu_torch/csrc/extra_nms.cu',
        'erd_tpu/ops/extra_nms.py:17', ms, call_ms, src, plain_ms, bms, by,
        None, float((got - want).abs().max()), max_rel_err=rel, n=n,
        zero_slots=zero)
    log(f'solo kernels: matrix_decay on the call\'s mask IoU N={n}: max rel '
        f'err {rel:.2e}; {ms:.4f} ms device ({src}), {call_ms:.4f} ms per '
        f'call, plain {plain_ms:.4f} ms, bound {bms:.6f} ms ({by})')

    rs = np.random.RandomState(31)
    k = 2000
    boxes, sc, labels, valid = random_nms_inputs(np, torch, rs, k,
                                                 NUM_CLASSES)
    box_form = {}
    for kernel in ('gaussian', 'linear'):
        got = matrix_nms(boxes, sc, labels, valid, kernel=kernel)
        torch.cuda.synchronize()
        want = matrix_nms_plain(boxes, sc, labels, valid, kernel=kernel)
        live = want != 0
        rel = float(((got - want).abs() / want.abs())[live].max())
        check(rel <= 1e-6 and torch.equal(got == 0, want == 0),
              f'matrix_nms {kernel} at K = {k} differs from plain')
        ms, call_ms, src, plain_ms = time_graph(
            torch, lambda: matrix_nms(boxes, sc, labels, valid,
                                      kernel=kernel),
            lambda: matrix_nms_plain(boxes, sc, labels, valid,
                                     kernel=kernel))
        # a pair: an IoU (~14 operations) in each pass, plus the decay
        bms, by = bound_of(k * 32, k * k * (2 * 14 + 9.0))
        box_form[kernel] = dict(k=k, max_rel_err=rel, ms=ms, call_ms=call_ms,
                                ms_from=src, plain_ms=plain_ms, bound_ms=bms,
                                bound_by=by)
        log(f'solo kernels: matrix_nms box form K={k} {kernel}: max rel err '
            f'{rel:.2e}, {int((want < sc).sum())} decayed; {ms:.4f} ms '
            f'device ({src}), {call_ms:.4f} ms per call, plain '
            f'{plain_ms:.4f} ms, bound {bms:.6f} ms ({by})')
    decay_row['box_form'] = box_form

    fast_row, match_row = solo_nms_ops(np, torch, boxes, sc, labels, valid)

    # -- 13b masked conv, 3x3 256 -> 256 on a P3 map
    gen = torch.Generator().manual_seed(37)
    x = torch.randn(1, 256, 100, 168, generator=gen).to(DEV)
    w = (torch.randn(256, 256, 3, 3, generator=gen) / 48).to(DEV)
    b = torch.randn(256, generator=gen).to(DEV)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    by_density = []
    # 5, 25, 50 and 100 % of the map, and just under the tile choices at 50
    # and 100 % (masked_conv_tile's cost model; 132 SMs)
    for p in (840, 4200, 8300, 8400, 16700, 16800):
        flat = torch.zeros(100 * 168, dtype=torch.bool)
        flat[torch.randperm(100 * 168, generator=gen)[:p]] = True
        mask = flat.reshape(1, 100, 168).to(DEV)
        density = p / (100 * 168)
        got = masked_conv2d(x, mask, w, b)
        again = masked_conv2d(x, mask, w, b)
        torch.cuda.synchronize()
        want = masked_conv2d_plain(x, mask, w, b)
        off = ~mask[:, None].expand_as(got)
        zeros = bool((got[off] == 0).all())
        err = float((got - want).abs().max())
        lim = 1e-5 * float(want.abs().max())
        tile = masked_conv_tile(p, 256, sms)
        log(f'solo kernels: masked_conv2d density {density:.4g} ({p} '
            f'positions, tile {tile} {MASKED_CONV_TILES[tile]}): masked-out '
            f'positions 0 {zeros}, max abs err {err:.3e} (limit {lim:.3e}), '
            f'a second call bit-equal {torch.equal(got, again)}')
        check(zeros and err <= lim and torch.equal(got, again),
              'masked_conv2d differs from plain, or from itself')
        pos = torch.nonzero(mask.reshape(-1)).reshape(-1)
        maskv = mask.reshape(-1)[pos].float()
        ms = graph_ms(torch, lambda: masked_conv_positions(
            x, w, b, maskv, pos, 1, (100, 168)))
        call_ms = events_ms(torch, lambda: masked_conv2d(x, mask, w, b), 10)
        plain_ms = events_ms(torch, lambda: masked_conv2d_plain(
            x, mask, w, b), 5)

        def library():
            with conv_fp32_precision('ieee'):
                return F.conv2d(x, w, b, 1, 1) * mask[:, None]
        library_ms = graph_ms(torch, library)
        bms, by = bound_of(x.numel() * 4 + w.numel() * 4 + b.numel() * 4 +
                           mask.numel() + 256 * mask.numel() * 4,
                           2.0 * p * 256 * 256 * 9)
        by_density.append(dict(density=density, positions=p, tile=tile,
                               tile_shape=MASKED_CONV_TILES[tile], ms=ms,
                               call_ms=call_ms, plain_ms=plain_ms,
                               library_ms=library_ms, bound_ms=bms,
                               bound_by=by, max_abs_err=err))
        log(f'solo kernels: masked_conv2d density {density:.4g} ({p} '
            f'positions): {ms:.4f} ms device (graph; tile {tile}, with the '
            f'weight copy and zeroing), {call_ms:.4f} ms per call, plain '
            f'{plain_ms:.4f} ms, dense cuDNN IEEE conv x mask '
            f'{library_ms:.4f} ms, bound {bms:.5f} ms ({by})')
    head = by_density[1]
    conv_row = kernel_row(
        'masked_conv2d', 'erd_tpu_torch/csrc/masked_conv.cu',
        'erd_tpu/ops/sampling.py:57', head['ms'], head['call_ms'], 'graph',
        head['plain_ms'], head['bound_ms'], head['bound_by'],
        head['library_ms'], max(d['max_abs_err'] for d in by_density),
        by_density=by_density)
    del net, calls, args
    torch.cuda.empty_cache()
    return [fused_row, decay_row, fast_row, match_row, conv_row]


def phase_solo_reference(np, torch):
    """SOLOv2 R50 in float32 at full width, heads arranged, on one
    SOLO_REFERENCE_HW request: the network's outputs card vs CPU within
    1e-3 * max|out|, then each side's decode (the card's kernels, the
    CPU's plain versions) through solo_compare's gate; a 1 % error planted
    in the card's matrix decay must fail that gate."""
    import copy
    import importlib

    solo_module = importlib.import_module(
        'erd_tpu_torch.models.detectors.solov2')
    det, net_gpu, batch, passing = solo_net(np, torch, dtype='float32',
                                            hw=SOLO_REFERENCE_HW)
    net_cpu = copy.deepcopy(net_gpu).cpu()
    meta_gpu = batch['meta']
    meta_cpu = type(meta_gpu)(**{f: t.cpu()
                                 for f, t in vars(meta_gpu).items()})
    t0 = time.perf_counter()
    out_cpu = det.forward_raw(net_cpu, batch['images'].cpu())
    cpu_s = time.perf_counter() - t0
    out_gpu = det.forward_raw(net_gpu, batch['images'])
    worst = 0.0
    for g, w in zip(list(out_gpu[0]) + list(out_gpu[1]) + [out_gpu[2]],
                    list(out_cpu[0]) + list(out_cpu[1]) + [out_cpu[2]]):
        check(tuple(g.shape) == tuple(w.shape), 'solo reference shapes')
        worst = max(worst, float((g.cpu() - w).abs().max() / w.abs().max()))
    h = batch['images'].shape[1]
    log(f'solo reference: float32 network {tuple(batch["images"].shape)} '
        f'card vs CPU max |diff| / max |out| = {worst:.2e} (tolerance '
        f'1e-3); {passing} cells over score_thr; CPU forward {cpu_s:.1f} s')
    check(worst <= 1e-3, 'float32 SOLOv2 on the card disagrees with the CPU')
    res_cpu = det.decode(*out_cpu, h, meta_cpu)
    res_gpu = det.decode(*out_gpu, h, meta_gpu)
    stats, _ = solo_compare(torch, 'solo reference', res_gpu, res_cpu)
    with patched(solo_module, 'mask_matrix_decay',
                 lambda fn: lambda *a: fn(*a) * 1.01):
        res_bad = det.decode(*out_gpu, h, meta_gpu)
    _, passed = solo_compare(torch, 'solo reference control, decay x 1.01',
                             res_bad, res_cpu, gate=False)
    check(not passed, 'solo reference: the gate passes a 1 % error in the '
          'matrix decay')
    del net_cpu, net_gpu, out_gpu
    torch.cuda.empty_cache()
    return stats


def phase_solo_serve(np, torch, card):
    """init_detector / inference_detector of SOLOv2 R50 (bf16, heads
    arranged) on the 4 requests: one mask_matrix_decay launch per request
    (the decode's only kernel, the mask IoU made in it; the two-launch
    matrix_decay not called; the rest is cuDNN, cuBLAS and torch ops);
    every
    detection finite, its label in range and its box inside the canvas in
    the image's frame (erd_tpu takes boxes from the masks' extents over
    the whole canvas and does not clip); stage times (backbone + neck,
    heads, dynamic conv, decode), peak memory, the idle share of one
    request; the card's decode of each request's outputs against the
    CPU's (solo_compare)."""
    from erd_tpu_torch.data import DetPipeline
    from erd_tpu_torch.ops import mask_matrix_decay, matrix_decay
    images = request_images(np)
    det, net, _, passing = solo_net(np, torch)
    tag = 'solo serve'
    results, counts = serve_requests(
        np, torch, det, net, images, {'mask_matrix_decay': mask_matrix_decay,
                                      'matrix_decay': matrix_decay},
        {'mask_matrix_decay': len(images), 'matrix_decay': 0}, tag, card,
        inside=False)
    pipe = DetPipeline(scale=(1333, 800))
    for i, (img, res) in enumerate(zip(images, results)):
        with torch.no_grad():
            req = ServedRequest(np, torch, pipe, i, img)
            x = det.preprocessor(req.images)
            feats = net.neck(net.backbone(x))
            req.mark()
            mfeat = net.mask_feature_head(feats[:4]).float()
            k, c = net.mask_head(feats)
            req.mark()
            cand = det.dynamic_masks(k, c, mfeat)
            req.mark()
            h = req.images.shape[1]
            gpu = det.select(*cand, mfeat.shape[-2:], h / mfeat.shape[-2],
                             req.meta_dev)
            req.mark()
        req.log_stages(tag, ('backbone + neck', 'mask feature head + head',
                             'dynamic conv (top-k, 500 masks)',
                             'decode (maskness, mask IoU, matrix NMS, '
                             'boxes, crops)'))
        cpu = det.decode([t.cpu() for t in k], [t.cpu() for t in c],
                         mfeat.cpu(), h, req.meta_cpu)
        solo_compare(torch, f'{tag} request {i}', gpu, cpu)
        ch, cw = req.images.shape[1:3]
        sx, sy = (float(v) for v in req.meta_cpu.scale_factor[0])
        box = res.bboxes
        check(len(res.scores) == int(gpu[0].mask.sum()) and
              (box[:, 2] > box[:, 0]).all() and (box[:, 3] > box[:, 1]).all()
              and (box[:, 0::2] >= -1e-3).all() and
              (box[:, 1::2] >= -1e-3).all() and
              (box[:, 0::2] <= cw / sx + 1e-3).all() and
              (box[:, 1::2] <= ch / sy + 1e-3).all(),
              f'{tag} request {i}: boxes inverted or outside the canvas, or '
              f'predict and inference_detector disagree')
        del feats, mfeat, cand
    log(f'{tag}: {passing} cells over score_thr on the 800x1333 request')
    del det, net
    torch.cuda.empty_cache()
    return {tag: counts}


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError as e:
        print(f'chip_smoke: {e}', file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(ROOT, 'erd_tpu_torch')):
        print('chip_smoke: erd_tpu_torch/ not found beside chip_smoke.py',
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from erd_tpu_torch.ops import cuda_build
        card = card_line()
        print(card, flush=True)
        log(f'card: {torch.cuda.get_device_name(0)}; torch '
            f'{torch.__version__}, CUDA {torch.version.cuda}; torch\'s '
            f'default precision settings, left as they are: '
            f'{tf32_settings(torch)}')

        t0 = time.perf_counter()
        floor = start_soft_nms_floor_build()
        check(floor is not None, 'SOFT_NMS_FLOOR_EDITS do not fit '
              'csrc/soft_nms.cu')
        cuda_build.build()
        log(f'build: {len(cuda_build.SOURCES)} kernels in '
            f'{time.perf_counter() - t0:.1f}s')
        for name, text in cuda_build.BUILD_LOGS.items():
            for line in text.splitlines():
                if 'registers' in line or 'spill' in line:
                    log(f'build: {name}: {line.strip()}')

        tf32 = phase_tf32(np, torch)
        kernels = phase_kernels(np, torch)
        phase_reference(np, torch)
        serve_launches, serve_decode = phase_serve(np, torch, card)
        train_rows, train_extra, train_decode = phase_train_kernels(np,
                                                                    torch)
        phase_train_reference(np, torch)
        train_launches = phase_train(np, torch, card)
        frcnn_rows, frcnn_nms = phase_frcnn_kernels(np, torch, floor)
        frcnn_launches = phase_frcnn_serve(np, torch, card)
        detr_rows = phase_detr_kernels(np, torch)
        phase_detr_reference(np, torch)
        detr_launches = phase_detr_serve(np, torch, card)
        dcn_rows = phase_dcn_kernels(np, torch)
        dcn_launches, dcn_decode = phase_dcn_serve(np, torch, card)
        carafe_row = phase_carafe_kernels(np, torch)
        set_nms_row = phase_set_nms_kernels(np, torch)
        soft_large_k = phase_soft_nms_large_k(np, torch)
        cc_launches = phase_carafe_crowddet_serve(np, torch, card)
        train2_rows, rpn_nms, roi_train, carafe_train = \
            phase_frcnn_train_kernels(np, torch)
        phase_frcnn_train_reference(np, torch)
        train2_launches = phase_frcnn_train(np, torch, card)
        detr_train_row, detr_train_fwd = phase_detr_train_kernels(np,
                                                                  torch)
        phase_detr_train_reference(np, torch)
        detr_train_launches = phase_detr_train(np, torch, card)
        dcn_train_row, dcn_loss_calls = phase_dcn_train_kernels(np, torch)
        phase_dcn_train_reference(np, torch)
        dcn_train_launches = phase_dcn_train(np, torch, card)
        point_sample_row, roi14 = phase_mask_kernels(np, torch)
        corner_pool_row, soft_k10000 = phase_cornernet_kernels(np, torch)
        phase_mask_cornernet_reference(np, torch)
        mask_launches = phase_mask_serve(np, torch, card)
        cn_launches = phase_cornernet_serve(np, torch, card)
        mask_train_rows, mask_roi_backward, mask_roi_forward = \
            phase_mask_train_kernels(np, torch)
        phase_mask_train_reference(np, torch)
        mask_train_launches = phase_mask_train(np, torch, card)
        solo_rows = phase_solo_kernels(np, torch)
        solo_reference = phase_solo_reference(np, torch)
        solo_launches = phase_solo_serve(np, torch, card)
        for row in kernels:  # nms_keep and integral_decode: both paths
            by_path = {'serve': serve_launches[row['name']],
                       'train': train_launches[row['name']]}
            by_path['dcn serve'] = dcn_launches[row['name']]
            if row['name'] == 'nms_keep':
                by_path['frcnn serve'] = frcnn_launches['nms_keep']
                row['frcnn_ms_by_k'] = frcnn_nms
                row['frcnn_train_rpn'] = rpn_nms
                for path, counts in list(cc_launches.items()) + \
                        list(train2_launches.items()) + \
                        list(mask_launches.items()) + \
                        list(mask_train_launches.items()):
                    if 'nms_keep' in counts:
                        by_path[path] = counts['nms_keep']
            row['launches'] = sum(by_path.values())
            row['launches_by_path'] = by_path
            idx = 1 if row['name'] == 'nms_keep' else 0
            row['train_ms_by_k'] = {k: v[idx] for k, v in train_extra.items()}
            if row['name'] == 'integral_decode':
                # every call shape of the paths, graph-timed; the row's
                # own numbers are the GFL serving call's
                shapes = [serve_decode, dcn_decode] + train_decode['shapes']
                row['shapes'] = shapes
                row.update({key: serve_decode[key] for key in (
                    'ms', 'ms_from', 'call_ms', 'plain_ms', 'bound_ms',
                    'bound_by')})
                row['max_abs_err'] = max([row['max_abs_err']] + [
                    t['max_abs_err'] for t in shapes])
                row['train_no_clip_max_abs_err'] = train_decode[
                    'no_clip_err']
        for row in train_rows:  # ATSS and the GFL loss: the DCN steps too
            for kind, held in dcn_loss_calls.items():
                if held.get(row['name']):
                    row['train_calls'].append(held[row['name']])
                    row['per_step_ms'][kind] = held[row['name']]['ms']
            by_path = {'train': train_launches[row['name']]}
            for path, counts in dcn_train_launches.items():
                if counts.get(row['name']):
                    by_path[path] = counts[row['name']]
            row['launches'] = sum(by_path.values())
            row['launches_by_path'] = by_path
        for row in frcnn_rows:
            by_path = {'frcnn serve': frcnn_launches[row['name']]}
            if row['name'] == 'roi_align':
                for path, counts in list(cc_launches.items()) + \
                        list(train2_launches.items()) + \
                        list(mask_launches.items()) + \
                        list(mask_train_launches.items()):
                    if 'roi_align' in counts:
                        by_path[path] = counts['roi_align']
                row['mask_out14'] = roi14
                # every training call's shape: the step's box call of each
                # config, the mask configs' out-14 calls
                row['train_shapes'] = [roi_train] + mask_roi_forward
                row['redesigned'] = True
                row['design'] = ('a block an (image, RoI), image-major; '
                                 'the sample tables once a RoI; a lane a '
                                 'sample column, walking down the sample '
                                 'rows of four channels and reading each '
                                 'pixel row once; bit-equal')
            if row['name'] == 'soft_nms':
                row['large_k'] = soft_large_k
                row['cornernet_k10000'] = soft_k10000
                by_path['cornernet serve'] = \
                    cn_launches['cornernet serve']['soft_nms']
            row['launches'] = sum(by_path.values())
            row['launches_by_path'] = by_path
        # row 10 at an FPN-CARAFE step's 3 calls, and the step's sum
        carafe_row['train_shapes'] = carafe_train
        carafe_row['per_step_ms'] = sum(t['ms'] for t in carafe_train)
        for row, name in ((carafe_row, 'carafe'),
                          (set_nms_row, 'set_nms_keep')):
            row['launches_by_path'] = {
                path: counts[name] for path, counts in
                list(cc_launches.items()) + list(train2_launches.items())
                if counts.get(name)}
            row['launches'] = sum(row['launches_by_path'].values())
        for row in train2_rows:  # the backward kernels: the train paths
            row['launches_by_path'] = {
                path: counts[row['name']] for path, counts in
                list(train2_launches.items()) +
                list(mask_train_launches.items())
                if counts.get(row['name'])}
            row['launches'] = sum(row['launches_by_path'].values())
        # rows 9 and 7b: every call shape of a training step, and the
        # step's calls summed
        detr_rows[0].update(
            shapes=detr_train_fwd['shapes'],
            per_step_ms=detr_train_fwd['per_step_ms'],
            train_max_abs_err=detr_train_fwd['max_abs_err'])
        roi_row = next(row for row in train2_rows
                       if row['name'] == 'roi_align_backward')
        roi_row['shapes'] += mask_roi_backward
        roi_row['per_step_ms'] = {}
        for shape in roi_row['shapes']:
            roi_row['per_step_ms'][shape['config']] = roi_row[
                'per_step_ms'].get(shape['config'], 0.0) + shape['call_ms']
        for row in detr_rows + [detr_train_row]:
            by_path = {path: counts[row['name']] for path, counts in
                       detr_train_launches.items()}
            if row['name'] in detr_launches:
                by_path['detr serve'] = detr_launches[row['name']]
            row['launches'] = sum(by_path.values())
            row['launches_by_path'] = by_path
        for row in dcn_rows:  # conv_offset's float32 precision check too
            row['tf32_check'] = tf32
            by_config = dcn_launches['deform_im2col_by_config']
            row['launches_by_path'] = {f'{k} serve': v
                                       for k, v in by_config.items()}
            for path, counts in dcn_train_launches.items():
                row['launches_by_path'][path] = counts['deform_im2col']
            row['launches'] = sum(row['launches_by_path'].values())
        # row 8 at every call shape of the DCN training steps
        dcn_rows[0]['train_shapes'] = dcn_train_row.pop(
            'forward_train_shapes')
        dcn_train_row['launches_by_path'] = {
            path: counts['deform_im2col_backward']
            for path, counts in dcn_train_launches.items()}
        dcn_train_row['launches'] = sum(
            dcn_train_row['launches_by_path'].values())
        point_sample_row['shapes'] += next(
            row for row in mask_train_rows
            if row['name'] == 'point_sample_backward').pop(
                'forward_train_shapes')
        point_sample_row['launches_by_path'] = {
            'pointrend serve': mask_launches['pointrend serve'][
                'point_sample'],
            'pointrend train': mask_train_launches['pointrend train'][
                'point_sample']}
        corner_pool_row['train_by_direction'] = next(
            row for row in mask_train_rows
            if row['name'] == 'corner_pool_backward').pop(
                'forward_by_direction')
        corner_pool_row['launches_by_path'] = {
            'cornernet serve': cn_launches['cornernet serve']['corner_pool'],
            'cornernet train': mask_train_launches['cornernet train'][
                'corner_pool']}
        for row in mask_train_rows:  # the slice-11 kernels: train paths
            row['launches_by_path'] = {
                path: counts[row['name']] for path, counts in
                mask_train_launches.items() if counts.get(row['name'])}
        for row in [point_sample_row, corner_pool_row] + mask_train_rows:
            row['launches'] = sum(row['launches_by_path'].values())
        # 12b on SOLOv2's path; 12c, 12d and 13b have no model caller (ops)
        solo_rows[0]['launches_by_path'] = {
            'solo serve': solo_launches['solo serve']['mask_matrix_decay']}
        solo_rows[0]['reference'] = solo_reference
        for row in solo_rows[1:]:
            row['launches_by_path'] = {}
        for row in solo_rows:
            row['launches'] = sum(row['launches_by_path'].values())
        kernels += train_rows + frcnn_rows + detr_rows + dcn_rows + \
            [carafe_row, set_nms_row] + train2_rows + [
                detr_train_row, dcn_train_row, point_sample_row,
                corner_pool_row] + mask_train_rows + solo_rows
        for row in kernels:
            row['card'] = card
    except Exception:  # report any failure, exit non-zero, no result line
        traceback.print_exc()
        print('chip_smoke: FAILED', file=sys.stderr)
        return 1
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
