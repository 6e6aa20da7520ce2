#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``stroke_derenderer_tpu_torch``)
on one CUDA card.

    python3 chip_smoke.py [--out FILE]

Phases, each printing one line with its seconds; any failure exits
non-zero and prints no result (``main``'s ``phases`` runs a subset, with
the phases it needs: the rehearsal's tests split the phases so):

1. device: the card's name and power limit (``nvidia-smi``), the torch and
   CUDA versions. Without a card the script exits 1.
2. build: the three kernels, K1 (``csrc/fused_decode.cu``), K2
   (``csrc/fused_beam.cu``) and K3 (``csrc/decode_attention.cu``), one
   ``nvcc`` call each, all started together, each with its ``-Xptxas -v``
   summary (registers, static shared memory and spills of each kernel) and
   its build seconds; the tensor-core instructions (HMMA) of each kernel
   by ``cuobjdump -sass``: K1's and K2's bfloat16 instantiations (the
   tensor-core path of phases A and D) must have them and spill nothing,
   their float32 ones (CUDA cores, float64) none.
3. k1: K1 against its plain PyTorch version on the card, with the shipped
   decoder weights (``models_demo``), on encoder sequences of glyph crops
   drawn from a numpy seed at B = 1, 13 and 80, and on the golden image's
   own glyphs. float32 (TF32 off): every row's tokens identical, or the
   plain version's top-2 logit gap at the first differing step below
   ``F32_GAP``. bfloat16: token agreement at least ``BF16_AGREE`` of the
   positions. Both are timed with CUDA events. Then K1's phase clock on
   the golden glyphs in bfloat16 (``step_breakdown``: microseconds per
   step of each phase, the elements the tensor-core path recomputed in
   float64 and the largest error of its sums as a share of their bound,
   which must stay below 1, and ``torch.matmul``'s time for the same
   rows' LSTM and head products as yardsticks).
4. main: the port's ``cli.run`` with ``models_demo`` on
   ``tests/golden/golden_input.png`` and the inputs of ``data_pseudo_real``,
   writing to a temporary directory. ``run`` must return one result per
   input, every output file must exist, the golden mask must agree with
   ``tests/golden/expected_BINARIZED.png`` on at least ``MASK_AGREE`` of the
   pixels, and K1 must have launched once per image that has glyphs.
5. k2: K2 against its plain version at K = ``BEAM`` on the golden glyphs
   and the synthetic B = 13 sequences, in float32 and bfloat16. float32:
   every beam's tokens and length identical, or the plain version's
   smallest gap between neighbouring candidates among the K + 1 best, at or
   after the first differing position, below ``F32_GAP``; scores of
   identical images within ``SCORE_RTOL``. bfloat16: at least
   ``BF16_AGREE`` of the decoded token positions agree. And K2 at K = 1
   gives K1's float32 tokens (K1's bar), and K2 at K = ``BIG_BEAM`` (above
   the old kernel's limit of 16) meets the same bars on the golden glyphs.
   Timed with CUDA events.
6. k3: K3 against its plain version with bfloat16 streams at B = 1, 13 and
   80 (synthetic) and on the golden glyphs, P = 196, and at a ragged shape
   (B = 3, P = 13), the shipped attention weights packed once
   (``attention_weights``): ``out`` and ``alpha`` within ``K3_ATOL`` +
   ``K3_RTOL`` * |plain|. Each case records the kernel's own time (a CUDA
   graph of 20 launches of the C entry on prepared inputs, replayed, timed
   with CUDA events) at every cluster size of ``K3_CLUSTERS``, the wrapper
   call's time, the launch shape (clusters G, CTAs per cluster C, row tile,
   stages, shared memory), the bytes the busiest CTA reads and the phase
   clock (CTA 0's microseconds per phase of its first row tile). Then the
   cost of one cluster barrier, alone and with a read of a neighbour CTA's
   shared memory, at each cluster size (``cluster_barrier_cost``). Then
   ``greedy_decode(fused=True)`` on the golden glyphs: K3 launches once per
   decoded step, and its tokens meet K1's bars against the same entry run
   on the plain version.
7. main-beam: ``cli.run`` as in phase 4 with ``--decode beam --beam-size
   5``: one result per input, every output file, the golden mask, and K2
   launched once per image that has glyphs (K1 not at all). The golden
   beam strokes' chamfer distance to ``tests/golden/expected_STROKES.json``
   is recorded, not held to a bound.
8. onnx: the upstream project's ONNX model directory. (a) ``--export-onnx``
   of ``models_demo`` (its seconds and bytes); the port's
   ``import_reference_models`` of it must give ``models_demo``'s trees leaf
   for leaf, bit for bit; ``cli.run`` with ``-models`` on that directory on
   the 45 inputs of phase 4: one result per input, every output file, the
   golden mask, the masks as phase 4's on at least ``BATCH_MASK_AGREE`` of
   the pixels, the golden strokes within ``STROKES_CHAMFER_PX``, K1 once per
   image that has glyphs (the images whose strokes files are phase 4's are
   counted); ``--decode beam --beam-size 5`` on the golden input: K2 once,
   K1 not at all. (b) A random model of the shape upstream ships
   (``ONNX_VARIANT_BIN``, ``ONNX_VARIANT_SE``: a batch-norm attention-UNet
   at the JAX default widths, a batch-norm ResNet-50 and a 2048 -> 512
   projection head, the rest at ``models_demo``'s widths; running
   statistics drawn from ``ONNX_SEED`` with means off 0 and variances in
   [0.5, 2]), exported by the port and imported back leaf for leaf;
   ``binarize_image`` of the golden input in float32 on the card against
   the CPU (``MASK_AGREE``); ``process_image`` of the golden expected mask
   (K1 once); K1 against its plain version on this model's projected
   (E = 512) and unprojected (E = 2048, read by a random decoder of that
   width) sequences of synthetic glyphs at B = ``ONNX_K1_BATCHES``, phase
   3's bars, and K2 at K = ``BEAM`` on the projected sequence at B =
   ``ONNX_K2_BATCH``, phase 5's bars; each with its ms, grid and bound.
9. batch: ``cli.run_batched`` (``--batch``) on the same images, greedy: K1
   launches once (and K2, K3 not at all) for all their glyphs, the golden
   mask as in phase 4, the golden strokes within ``STROKES_CHAMFER_PX``
   (chamfer) of ``tests/golden/expected_STROKES.json``, the masks as phase
   4's on at least ``BATCH_MASK_AGREE`` of the pixels (the differing pixels
   and the images whose strokes files are identical are recorded). Then K1
   against its plain version on the batched encoder sequence (every glyph
   row, phase 3's bars), its phase clock, and the same rows as one K1
   launch per image, back to back. The amortized s/image print beside
   phase 4's.
10. batch-beam: as phase 9 with ``--decode beam --beam-size 5``: K2 launches
   once (K1 not at all); K2 at the batched shape against its plain version
   (phase 5's bars; the plain version, which steps every beam in Python,
   timed once), its phase clock, and one K2 launch per image.
11. fused-binarize: ``binarize_images`` with ``fused=True`` (every width
   group through the device cut, stitch and bit-pack program) against the
   default mode and against phase 4's masks, each on at least
   ``BATCH_MASK_AGREE`` of the pixels; both timed.
12. serve: the HTTP server in this process on 127.0.0.1: /healthz,
   ``SERVE_CONCURRENT`` concurrent /derender requests (the golden input
   among them), /binarize, /derender?svg=1, a body that is not a PNG (400)
   and an unknown path (404). Every reply has its expected status, some
   batch holds more than one request, K1 launches fewer times than there
   were /derender requests, the golden strokes are within
   ``STROKES_CHAMFER_PX``; the stage latencies of /metrics are printed.
13. real: ``--preset real`` (residual re-decode at coverage 0.9, up to
   ``redecode_passes`` passes). ``cli.run`` on the 45 images: K1 launches
   between one per image with glyphs plus one and one per image and pass;
   ``cli.run_batched``: one K1 launch per pass (2 to 1 + passes); ``--decode
   beam --preset real`` on the golden image: K2 at least twice. In the
   per-image runs the golden mask as in phase 4 and the golden strokes
   cover at least as much of the mask's ink (as ``_residual_for`` measures
   it) as phase 4's (greedy) or phase 7's (beam). Then K1 against its plain
   version on the glyph rows of the first residual pass of the batched run
   (phase 3's bars). Prints ms/image per run, the host seconds spent in
   ``residual_ink``, ``merge_stroke_fragments`` and ``refine_strokes``
   (wrapped here, not in the package) and one ``--refine 3`` run's time.
14. train: the trainer (``train/``) on the card. First, 3 update steps of
   each model from ``models_demo`` on the batches of
   ``tests/golden/jax_train_steps.json`` (made again here from the port's
   generators and held to the file's batch sums), in float32 and bfloat16,
   against the JAX package's losses there (``scripts/jax_train_golden.py``):
   float32 step 1 within ``TRAIN_F32_STEP1_RTOL``, later steps within
   ``TRAIN_F32_RTOL``, bfloat16 within ``TRAIN_BF16_RTOL``. Then the shipped
   recipe (``--init-from models_demo --ema 0.999``, binarizer ``--line-style
   letters --ruled 0.5 --narrow 0.5``, captioner ``--glyph-style hand
   --coord-smoothing 1.0 --scheduled-sampling 0.25 --ss-ramp-frac 0.2``) for
   ``TRAIN_STEPS`` steps at batch ``TRAIN_BATCH`` with a checkpoint every
   half, and again to ``TRAIN_RESUME_STEPS``: the rerun must resume at
   ``TRAIN_STEPS``. Then a ``TRAIN_CACHE_N``-sample glyph cache and
   ``TRAIN_STEPS`` captioner steps from it, and from-scratch runs of both
   models at ``models_demo``'s widths, each of which must end (mean of its
   last ``TRAIN_WINDOW`` losses) below where it began. Every loss finite;
   steps/s with the loader's wait and the step's seconds for each run, and
   the ms of one step of each model alone (one fixed batch, no loader
   thread). Last, the recipe's exported dir through ``cli.run`` on the
   golden image: both files, one K1 launch.
15. eval: the port's evaluator (``eval/run.py``) on the card in bfloat16:
   ``evaluate_real`` on the 44 pairs of ``examples/real_data``, greedy and
   with ``redecode_coverage`` 0.9, and ``evaluate_full(style="mixed",
   n=50, seed=0)``, greedy, each against the JAX package's CPU run in
   ``tests/golden/jax_cpu_eval.json`` (``scripts/jax_cpu_eval.py``): DTW
   within the JAX run's ``stroke_dtw_ci95``, F1 (and the 1 px F1) within
   ``EVAL_F1_TOL``, coverage within ``EVAL_COVERAGE_TOL``. Then the same
   three sets through the batched path (``scripts/eval_batched.py``: one
   ``binarize_images`` and one ``process_images`` per set, so K1 runs at
   large B, once more per residual pass) against the JAX package's batched
   CPU runs in ``tests/golden/jax_cpu_eval_batched.json``
   (``scripts/jax_cpu_eval.py --batched``), with the same bars.
16. int8: ``--quant int8`` (``ops/quant.py``: im2col and
   ``torch._int_mm``, no kernel of the repo). ``int8_conv2d`` through
   ``layers.conv`` on the card against the same call on the CPU at each
   ``INT8_CONVS`` shape, float32 and bf16: the int32 sums equal and the
   outputs bit for bit; each one's ms beside cuDNN's float conv. The JAX
   package's demo-weight bars, the port's int8 against its bf16 on the
   card (``line_tile``): UNet mask agreement >= ``INT8_AGREE``, ink IoU >=
   ``INT8_IOU``, encoder feature cosine > ``INT8_COSINE``. ``cli.run`` with
   int8 on the 45 images: K1 once per image with glyphs, the golden mask
   and the masks against phase 4's on at least ``INT8_AGREE``; one
   ``--batch`` run (one K1 launch) and ``--decode beam`` on the golden
   image (one K2 launch); K1 and K2 at ``BEAM`` against their plain
   versions on the int8 encoder's sequences of that batch's glyphs
   (phase 3's bf16 bar). Then ``evaluate_real`` greedy and
   ``evaluate_full`` mixed with int8, against the JAX package's int8 runs
   in ``tests/golden/jax_cpu_eval_int8.json``: each run must meet every
   bar of phase 15 against one of them, the default run or a variant with
   flax's normalization statistics summed in another float32 order
   (``scripts/jax_eval_blocked_stats.py``; under int8 such a rounding
   alone moves the JAX package's real-ink coverage by 0.04).
17. two_stage: ``cli.run_two_stage`` (``--two-stage 8``) on the 45 images,
   bf16 and int8: one K1 launch per chunk, and the masks and strokes files
   those of ``cli.run_batched`` over the same chunks in turn; each stage's
   busy seconds (host clock around ``binarize_images`` and
   ``process_images``, each ending in a download), the wall seconds of
   ``process_batched``, the overlap (A + B - wall) / min(A, B), and s/image
   against the sequential chunks and against phase 9's ``--batch``, and
   the calls of the native resize and CC (which release the GIL) in the
   two-stage run. Then ``TwoStagePipeline.process`` (image by image):
   phase 4's files.
18. profile: ``utils/profiling``, ``utils/flops`` and the native host ops
   on phase 4's inputs (the first ``PROFILE_INPUTS``; all by default), the
   card's name and power limit beside every line. (a) Native resize (to
   the line height) and CC (with boxes and areas) against numpy and scipy
   on every image: identical, one native call of each per image, ms per
   image of each. (b) ``LEDGER`` bytes and events, up and down, per stage
   and image: per image (``binarize_image``, ``process_image``) and
   batched (``binarize_images``, ``process_images``), each with the
   group-id image packed (``gid_rle``, the default) and dense; the packed
   runs' strokes up bytes must be below the dense runs'. (c)
   ``StageTimer``'s summary of those runs. (d) Each stage of the per-image
   and the batched run again under ``device_trace``: ``chip_busy_ms`` and
   busy / wall; on the card a trace without a CUDA kernel event fails the
   run. (e) ``bench_flops_per_image`` on these images at the models'
   widths and the share of the bf16 peak that (c)'s seconds imply. (f) K1
   launched once per image with glyphs in every per-image run and once per
   batched run (K2, K3 never), and K1 on these images' glyph rows in one
   batch against its plain version (phase 3's bf16 bar).
19. mesh: the port's ``parallel/`` in ``MESH_DEVICES`` ranks, one process
   each (``multihost.spawn``; two ranks share the card over gloo, as NCCL
   refuses two ranks on one device), on the 45 inputs at ``models_demo``'s
   widths: over a (2, 1) mesh greedy bf16, greedy float32, beam
   (``BEAM``), int8, and ``--two-stage`` (``TWO_STAGE_CHUNK``); the
   binarizer over a (1, 2) mesh (each rank 192 of a tile's 384 columns).
   Bars: K1 (K2 for beam) launched once per rank per batch, and once per
   chunk on stage B's rank; float32 tokens and masks those of one rank's
   run; the bf16 and tp masks against phase 9's ``--batch`` masks and the
   int8 masks against one rank's int8 run over the same padded batch, each
   on at least ``BATCH_MASK_AGREE`` of the pixels; the golden strokes
   within ``STROKES_CHAMFER_PX``; the two-stage outputs those of the same
   chunks run in turn (each stage a sub-mesh of one rank); K1 and K2
   sharded over dp (one launch a rank) against their plain versions on
   all the glyph rows in bfloat16 (``BF16_AGREE``). With two cards
   or more, greedy bf16 again over ``cuda:0`` and ``cuda:1`` with NCCL.
   Then the trainer in the same ranks: ``MESH_TRAIN_STEPS`` float32 steps
   of each model at ``models_demo``'s widths over the (2, 1) mesh and over
   a (1, 2) mesh (``--tp 2``: the conv kernels and ``enc_att``
   column-parallel) against one rank's run over the same global batches
   (losses within
   ``MESH_TRAIN_LOSS_TOL``, parameters within 2 x ``MESH_TRAIN_LR``), and
   rank 0's checkpoints resumed by one device; and ``train.loop`` with
   ``--mesh 2`` and with ``--distributed`` in the same ranks (the same
   losses on both). Last, the CLI's ``--mesh
   2`` on the golden image (with one card: the JAX CLI's warning and one
   device). img/s at dp = 2 against dp = 1 is printed with the card's
   name and power limit; on one card it is no scaling figure.

K1 and K2 are one cooperative launch each per decode call; phases 3 and 5
record each launch's grid, its grid barriers per step, the time of one
grid-wide step and the tensor-core path's shared-memory plan, and one line
per kernel prints them with the registers, spills and HMMA counts (K3: its
clusters, CTAs per cluster and cluster barriers). Every ``drive_cli`` run
checks that each K1 and K2 launch took the path of its stream type
(``engine_launches``: bfloat16 on the tensor cores). Then one JSON line
with each kernel's launches on each path, one with K1's and K2's launches
by engine, one with the kernel table (K1, K2, K3; launches summed over the
paths; printed when phases k1, k2 and k3 ran) and, last, one JSON line
``{"ok": true, "device": {...}}``. ``--out`` also writes everything to a
JSON file.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MODELS = ROOT / "models_demo"
GOLDEN = ROOT / "tests" / "golden"
PSEUDO = ROOT / "data_pseudo_real"

F32_GAP = 1e-3      # top-2 logit gap allowed where float32 tokens differ
BF16_AGREE = 0.95   # share of bfloat16 token positions that must agree
MASK_AGREE = 0.999  # share of golden mask pixels that must agree
MAX_LENGTH = 384
K1_BATCHES = (1, 13, 80)  # synthetic-glyph batch sizes for phase 3
BEAM = 5            # the beam size of phases 5 and 7
BIG_BEAM = 17       # a beam size above 16 (the old kernel's limit), phase 5
K2_BATCH = 13       # synthetic-glyph batch size for phase 5
SCORE_RTOL = 1e-5   # float32 beam scores, K2 against its plain version
K3_BATCHES = (1, 13, 80)  # synthetic-glyph batch sizes for phase 6
K3_RAGGED = (3, 13)       # (B, P) of phase 6's ragged case
K3_CLUSTERS = (8, 16)     # cluster sizes K3 is timed at (the wrapper picks)
# K3 and its plain version both sum in float32, in other orders.
K3_ATOL, K3_RTOL = 1e-5, 1e-4
LIBS = ("fused_decode", "fused_beam", "decode_attention")
STROKES_CHAMFER_PX = 6.0  # golden strokes, batched and served (as the tests)
BATCH_MASK_AGREE = 0.9999  # batched or fused masks against per-image ones
SERVE_CONCURRENT = 8       # concurrent /derender requests of phase 12
SERVE_WINDOW_S = 0.1       # the server's batching window in phase 12
REAL_DATA = ROOT / "examples" / "real_data"  # phase 15's real-ink pairs
JAX_EVAL = GOLDEN / "jax_cpu_eval.json"      # phase 15's reference
# ... and its batched runs' (scripts/jax_cpu_eval.py --batched).
JAX_EVAL_BATCHED = GOLDEN / "jax_cpu_eval_batched.json"
EVAL_MIXED_N = 50          # synthetic samples of phase 15's mixed run
EVAL_F1_TOL = 0.002        # |F1 - JAX| allowed in phase 15
EVAL_COVERAGE_TOL = 0.03   # |coverage - JAX| allowed in phase 15
REFINE_PX = 3.0            # the --refine run of phase 13
# Phase 8 (onnx): the random model of the shape the upstream project ships
# (BinarizerConfig and StrokesConfig fields over the defaults and over
# models_demo's strokes config), its seed, and the batches of its K1 and K2
# comparisons.
ONNX_VARIANT_BIN = {"norm": "batch"}  # features (32, 64, 128, 256), 512
ONNX_VARIANT_SE = {"encoder_arch": "resnet50", "encoder_norm": "batch",
                   "projection_dim": 512}
ONNX_SEED = 0
ONNX_K1_BATCHES = (4, 13)
ONNX_K2_BATCH = 4
# Phase 14 (train). The golden file fixes the reference steps' batch, seq
# len, learning rate and step count; the bars are relative to its losses.
JAX_TRAIN = GOLDEN / "jax_train_steps.json"
TRAIN_F32_STEP1_RTOL = 1e-5   # float32, the first step's loss
TRAIN_F32_RTOL = 1e-3         # float32, the later steps' losses
TRAIN_BF16_RTOL = 2e-2        # bfloat16, every step's loss
TRAIN_MODELS = MODELS         # the recipe's --init-from
TRAIN_STEPS = 40              # the recipe, the cache run, from scratch
TRAIN_RESUME_STEPS = 60       # the recipe again, resumed at TRAIN_STEPS
TRAIN_BATCH = 16
TRAIN_SEQ_LEN = 96
TRAIN_CACHE_N = 256           # samples in the phase's glyph cache
TRAIN_WINDOW = 10             # steps in each mean of the from-scratch check
TRAIN_SCRATCH = ("--bin-features", "16,32,64", "--encoder-arch", "resnet18",
                 "--lr", "1e-3")  # the from-scratch runs: models_demo widths
TRAIN_WORKERS = 2             # loader threads (the trainer's default)
# Phase 16 (int8): int8_conv2d card against CPU at the models' geometries,
# (label, batch, in, height, width, out, kernel, stride, pad, bias): the
# UNet's 3x3 convs at its widths and the gates' 1x1 convs on 8 tiles of
# 128 x 384, the encoder's stem, a stride-2 3x3 and a stride-2 1x1 proj on
# 16 crops of 224 x 224.
INT8_CONVS = (
    ("unet 3x3 16", 8, 16, 128, 384, 16, 3, 1, 1, False),
    ("unet 3x3 32", 8, 32, 64, 192, 32, 3, 1, 1, False),
    ("unet 3x3 64", 8, 64, 32, 96, 64, 3, 1, 1, False),
    ("unet 3x3 128", 8, 128, 16, 48, 128, 3, 1, 1, False),
    ("gate 1x1 16->8", 8, 16, 128, 384, 8, 1, 1, 0, True),
    ("gate 1x1 32->16", 8, 32, 64, 192, 16, 1, 1, 0, True),
    ("gate 1x1 64->32", 8, 64, 32, 96, 32, 1, 1, 0, True),
    ("stem 7x7 s2 p3", 16, 3, 224, 224, 64, 7, 2, 3, False),
    ("3x3 s2", 16, 64, 56, 56, 128, 3, 2, 1, False),
    ("proj 1x1 s2", 16, 64, 56, 56, 128, 1, 2, 0, False),
)
INT8_AGREE = 0.98    # int8 masks against bf16 ones (the JAX package's bar)
INT8_IOU = 0.85      # ink IoU, int8 against bf16, demo weights
INT8_COSINE = 0.98   # encoder features, int8 against bf16, demo weights
JAX_EVAL_INT8 = GOLDEN / "jax_cpu_eval_int8.json"  # phase 16's reference
# Phase 17 (two_stage): the chunk size of --two-stage.
TWO_STAGE_CHUNK = 8
# Phase 18's inputs: the first PROFILE_INPUTS of phase 4's (None: all).
PROFILE_INPUTS = None
# Phases 16 and 17 drive the CLI on the first this many inputs (all 45:
# None).
SLICE_INPUTS = None

# Phase 19 (mesh): two ranks, one process each, sharing the card over gloo
# (NCCL refuses two ranks on one device); with two cards or more, also a
# run over two cards with NCCL.
MESH_DEVICES = ("cuda:0", "cuda:0")
# (module, function) that each rank calls first (None: nothing).
MESH_RANK_SETUP = None
# The mesh phase drives the first this many inputs (all 45: None).
MESH_INPUTS = None
MESH_TIMEOUT_S = 600.0
# Its trainer: models_demo's widths in float32, two steps at batch 4.
MESH_TRAIN_BIN = {"features": (16, 32, 64), "bottleneck": 128,
                  "compute_dtype": "float32"}
MESH_TRAIN_SE = {"encoder_arch": "resnet18", "compute_dtype": "float32"}
MESH_TRAIN_STEPS = 2
MESH_TRAIN_BATCH = 4
MESH_TRAIN_SEQ = 96
MESH_TRAIN_LR = 3e-4
MESH_TRAIN_LOSS_TOL = 1e-5   # float32 loss against the single rank's
F32 = {"compute_dtype": "float32"}

# Phases 3 to 19 by name (1 and 2, device and build, always run), and the
# phases whose results each uses.
PHASE_NAMES = ("k1", "main", "k2", "k3", "main-beam", "onnx", "batch",
               "batch-beam", "fused-binarize", "serve", "real", "train",
               "eval", "int8", "two_stage", "profile", "mesh")
NEEDS = {"onnx": ("main",), "batch": ("main",),
         "batch-beam": ("main", "batch"), "fused-binarize": ("main",),
         "real": ("main", "main-beam"), "int8": ("main",),
         "two_stage": ("main", "batch"), "profile": ("main",),
         "mesh": ("batch",)}

# H100 SXM published peaks (NVIDIA data sheet), used for bound_ms.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def load_script(name: str):
    """``scripts/<name>.py`` of this checkout as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _phase(name: str, t0: float, text: str) -> None:
    print(f"[{name}] {time.monotonic() - t0:.2f} s  {text}", flush=True)


def synthetic_crops(rng, n: int, size: int = 224):
    """n glyph-like uint8 crops: one to three thick cubic Bezier strokes
    each, drawn from ``rng``."""
    import numpy as np
    from scipy import ndimage
    t = np.linspace(0.0, 1.0, 400)[:, None]
    out = np.zeros((n, size, size), np.uint8)
    for i in range(n):
        pts = np.zeros((size, size), bool)
        for _ in range(rng.integers(1, 4)):
            c = rng.uniform(24, size - 24, size=(4, 2))
            curve = ((1 - t) ** 3 * c[0] + 3 * (1 - t) ** 2 * t * c[1]
                     + 3 * (1 - t) * t ** 2 * c[2] + t ** 3 * c[3])
            xy = np.rint(curve).astype(int)
            pts[xy[:, 1], xy[:, 0]] = True
        radius = rng.uniform(2.0, 5.0)
        out[i] = (ndimage.distance_transform_edt(~pts) <= radius) * 255
    return out


def decode_lengths(preds):
    """Steps each row decoded: up to and including its first EOS."""
    import torch
    is_eos = preds == 2
    first = torch.where(is_eos.any(1), is_eos.int().argmax(1) + 1,
                        torch.full_like(preds[:, 0], preds.shape[1]))
    return first.long()


def k1_cost(enc, enc_proj, w: dict, lengths) -> dict:
    """Bytes, operations and bounds of one fused decode on these inputs."""
    b, p, e = enc.shape
    a = enc_proj.shape[-1]
    hdim = w["wh"].shape[0]
    v, d = w["emb"].shape
    wbytes = sum(t.numel() * t.element_size() for t in w.values())
    io_bytes = (enc.numel() * enc.element_size() * 2  # enc, enc_proj
                + 2 * b * hdim * enc.element_size() + b * MAX_LENGTH * 4)
    step_flops = (2 * hdim * a + 2 * hdim * e + 2 * (d + e) * 4 * hdim
                  + 2 * hdim * 4 * hdim + 2 * hdim * v + 3 * p * a
                  + 2 * p * e)
    flops = int(lengths.sum()) * step_flops
    dtype = "bfloat16" if enc.element_size() == 2 else "float32"
    bound_s = max((wbytes + io_bytes) / HBM_BYTES_PER_S,
                  flops / PEAK_FLOPS[dtype])
    # The grid streams the weights once per step (each block its slice) and
    # every active row's encoder data once per step.
    row_bytes = p * (e + a) * enc.element_size()
    stream_s = (int(lengths.max()) * wbytes
                + int(lengths.sum()) * row_bytes) / HBM_BYTES_PER_S
    return {"bytes_once": wbytes + io_bytes, "flops": flops,
            "bound_ms": bound_s * 1e3, "bound_by": (
                "bytes" if (wbytes + io_bytes) / HBM_BYTES_PER_S
                >= flops / PEAK_FLOPS[dtype] else "operations"),
            "stream_bound_ms": stream_s * 1e3,
            "steps_max": int(lengths.max()), "steps_sum": int(lengths.sum())}


def ptxas_summary(text: str) -> list[dict]:
    """Registers and spills of each kernel (entry function) in an ``nvcc
    -Xptxas -v`` report."""
    out, props = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            out[m.group(1)] = {"function": m.group(1)}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and props in out:
            out[props].update(spill_stores=int(m.group(1)),
                              spill_loads=int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            last = list(out.values())[-1]
            last.setdefault("registers", int(m.group(1)))
            m = re.search(r"(\d+) bytes smem", line)
            last.setdefault("static_smem", int(m.group(1)) if m else 0)
    return list(out.values())


def sass_mma_counts(build, name: str) -> dict:
    """Tensor-core instructions (HMMA) in each kernel of the built library
    ``name``, from ``cuobjdump -sass`` (beside ``nvcc``)."""
    tool = Path(build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(build.BUILD /
                                                    f"lib{name}.so")],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.search(r"\bHMMA\b", line):
            counts[fn] += 1
    return counts


def check_engine_build(record: dict) -> None:
    """The bfloat16 instantiations of K1 and K2 (the tensor-core path) issue
    HMMA and spill nothing; the float32 ones (CUDA cores) issue none."""
    for lib in ("fused_decode", "fused_beam"):
        mma = record["sass_mma"][lib]
        bf16 = [f for f in mma if "I13__nv_bfloat16E" in f]
        f32 = [f for f in mma if "IfEEv" in f]
        if not bf16 or not f32 or any(mma[f] == 0 for f in bf16) or any(
                mma[f] for f in f32):
            raise SystemExit(f"{lib}: HMMA per kernel {mma}")
        for k in record["build"][lib]["kernels"]:
            if "I13__nv_bfloat16E" in k["function"] and (
                    k.get("spill_stores") or k.get("spill_loads")):
                raise SystemExit(f"{lib}: the tensor-core kernel spills: {k}")


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def compare_k1(fd, decoder, seq, dtype, label: str) -> dict:
    """K1 against the plain version on one encoder sequence batch."""
    import torch
    enc = seq.to(dtype).contiguous()
    enc_proj = decoder.project_encoding(enc).contiguous()
    h0, c0 = (t.contiguous() for t in decoder.init_state(enc))
    w = decoder.weights(dtype)
    packed = fd.pack_step_weights(w)
    got = fd.fused_greedy_decode_packed(enc, enc_proj, h0, c0, w, MAX_LENGTH,
                                        packed)
    ref, gaps = fd.fused_greedy_decode_plain(enc, enc_proj, h0, c0, w,
                                             MAX_LENGTH, return_gaps=True)
    torch.cuda.synchronize()
    same = got == ref
    rec = {"case": label, "dtype": str(dtype).split(".")[-1],
           "B": int(enc.shape[0]), "agree": float(same.float().mean()),
           "rows_identical": int(same.all(1).sum())}
    if dtype == torch.float32:
        worst = 0.0
        for r in torch.nonzero(~same.all(1)).flatten().tolist():
            t = int(torch.nonzero(~same[r])[0])
            worst = max(worst, float(gaps[r, t]))
        rec["max_gap_at_first_difference"] = worst
        rec["ok"] = worst < F32_GAP
    else:
        rec["ok"] = rec["agree"] >= BF16_AGREE
    rec["ms"] = cuda_ms(lambda: fd.fused_greedy_decode_packed(
        enc, enc_proj, h0, c0, w, MAX_LENGTH, packed), reps=5)
    rec["plain_ms"] = cuda_ms(lambda: fd.fused_greedy_decode_plain(
        enc, enc_proj, h0, c0, w, MAX_LENGTH), reps=1)
    rec.update(k1_cost(enc, enc_proj, w, decode_lengths(got)))
    rec.update(launch_shape(fd, "fused_decode", enc, enc_proj, w, 1,
                            rec["ms"], rec["steps_max"]))
    return rec


def launch_shape(mod, name, enc, enc_proj, w, k, ms, steps) -> dict:
    """Grid of the cooperative launch, barriers per step and the time of one
    grid-wide step (the call's time over the steps it took)."""
    b, p, e = enc.shape
    hdim = w["wh"].shape[0]
    v, d = w["emb"].shape
    dims = {"B": b, "P": p, "E": e, "A": enc_proj.shape[-1], "H": hdim,
            "D": d, "V": v, "K": k, "max_length": MAX_LENGTH}
    from stroke_derenderer_tpu_torch.kernels import fused_decode
    grid, plan = fused_decode.launch_grid(name, enc.dtype, dims, enc.device)
    return {"grid": grid, "barriers_per_step": mod.BARRIERS_PER_STEP,
            "step_ms": ms / max(steps, 1),
            "engine": fused_decode.ENGINES[enc.dtype],
            "mma_plan": {k: plan[k] for k in ("NT", "KC", "R3", "RH")
                         if k in (plan or {})}}


def weight_bytes(w: dict) -> int:
    return sum(t.numel() * t.element_size() for t in w.values())


def k2_cost(enc, enc_proj, w: dict, lens, k: int) -> dict:
    """Bytes, operations and bounds of one fused beam decode on these
    inputs: rows = B * K beams, each image stepping until its beams have
    finished (its longest beam)."""
    b, p, e = enc.shape
    a = enc_proj.shape[-1]
    hdim = w["wh"].shape[0]
    v, d = w["emb"].shape
    wbytes = weight_bytes(w)
    io_bytes = (enc.numel() * enc.element_size() * 2  # enc, enc_proj
                + 2 * b * hdim * enc.element_size()
                + b * k * (MAX_LENGTH * 4 + 8))  # preds, score, lens
    step_flops = (2 * hdim * a + 2 * hdim * e + 2 * (d + e) * 4 * hdim
                  + 2 * hdim * 4 * hdim + 2 * hdim * v + 3 * p * a
                  + 2 * p * e + 5 * v)
    steps = lens.max(dim=1).values
    flops = int(steps.sum()) * k * step_flops
    dtype = "bfloat16" if enc.element_size() == 2 else "float32"
    by_bytes = (wbytes + io_bytes) / HBM_BYTES_PER_S
    by_ops = flops / PEAK_FLOPS[dtype]
    # The grid streams the weights once per step (each block its slice) and
    # every searching beam's encoder data once per step.
    stream_s = (int(steps.max()) * wbytes + int(steps.sum()) * k
                * p * (e + a) * enc.element_size()) / HBM_BYTES_PER_S
    return {"bytes_once": wbytes + io_bytes, "flops": flops,
            "bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "stream_bound_ms": stream_s * 1e3,
            "steps_max": int(steps.max()), "steps_sum": int(steps.sum())}


def k3_cost(enc, enc_proj, h, att_w) -> dict:
    """Bytes, operations and bound of one fused attention + gate: every
    input read once as bfloat16, out and alpha written once as float32."""
    b, p, e = enc.shape
    a = enc_proj.shape[-1]
    d = h.shape[-1]
    in_bytes = 2 * (enc.numel() + enc_proj.numel() + h.numel()
                    + sum(t.numel() for t in att_w))
    out_bytes = 4 * (b * e + b * p)
    flops = b * (2 * d * (a + e) + 3 * p * a + 2 * p * e + 3 * p + 2 * e)
    by_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S
    by_ops = flops / PEAK_FLOPS["bfloat16"]
    return {"bytes_once": in_bytes + out_bytes, "flops": flops,
            "bound_ms": max(by_bytes, by_ops) * 1e3,
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def first_difference_gaps(same, gaps) -> float:
    """The largest, over rows that differ, of the smallest gap at or after
    the row's first differing position (0.0 when no row differs)."""
    import torch
    worst = 0.0
    for r in torch.nonzero(~same.all(1)).flatten().tolist():
        t = int(torch.nonzero(~same[r])[0])
        worst = max(worst, float(gaps[r, t:].min()))
    return worst


def event_ms(fn):
    """(result, milliseconds) of one call of ``fn``, CUDA events around it."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def compare_k2(fb, decoder, seq, dtype, label: str, k: int = BEAM,
               plain_once: bool = False) -> dict:
    """K2 at beam size k against its plain version on one encoder sequence
    batch. ``plain_once``: the plain version's time is that of the one call
    the comparison makes (with its gaps), not of a further warm call (the
    plain version steps B * K rows in Python)."""
    import torch
    enc = seq.to(dtype).contiguous()
    enc_proj = decoder.project_encoding(enc).contiguous()
    h0, c0 = (t.contiguous() for t in decoder.init_state(enc))
    w = decoder.weights(dtype)
    packed = fb.pack_step_weights(w)
    preds, score, lens = fb.fused_beam_decode_packed(
        enc, enc_proj, h0, c0, w, MAX_LENGTH, k, packed)
    (r_preds, r_score, r_lens, gaps), plain_ms = event_ms(
        lambda: fb.fused_beam_decode_plain(enc, enc_proj, h0, c0, w,
                                           MAX_LENGTH, k, return_gaps=True))
    same = preds == r_preds                          # (B, K, T)
    decoded = (preds != 0) | (r_preds != 0)
    image_same = same.flatten(1).all(1) & (lens == r_lens).all(1)
    rec = {"case": label, "dtype": str(dtype).split(".")[-1],
           "B": int(enc.shape[0]), "K": k,
           "agree": float(same[decoded].double().mean()),
           "images_identical": int(image_same.sum())}
    if dtype == torch.float32:
        img_same = (same.all(1)) & (lens == r_lens).all(1)[:, None]
        rec["max_gap_at_first_difference"] = first_difference_gaps(
            img_same, gaps)
        rel = ((score - r_score).abs() / r_score.abs().clamp(min=1e-30))
        rec["score_max_rel_err"] = float(rel[image_same].max()) if bool(
            image_same.any()) else 0.0
        rec["ok"] = (rec["max_gap_at_first_difference"] < F32_GAP
                     and rec["score_max_rel_err"] <= SCORE_RTOL)
    else:
        rec["ok"] = rec["agree"] >= BF16_AGREE
    rec["ms"] = cuda_ms(lambda: fb.fused_beam_decode_packed(
        enc, enc_proj, h0, c0, w, MAX_LENGTH, k, packed), reps=3)
    rec["plain_ms"] = plain_ms if plain_once else cuda_ms(
        lambda: fb.fused_beam_decode_plain(enc, enc_proj, h0, c0, w,
                                           MAX_LENGTH, k), reps=1)
    rec.update(k2_cost(enc, enc_proj, w, lens, k))
    rec.update(launch_shape(fb, "fused_beam", enc, enc_proj, w, k, rec["ms"],
                            rec["steps_max"]))
    return rec


def per_image_launches_ms(fd, fb, decoder, seq, inv, counts,
                          k: int) -> float:
    """The rows of the batched sequence ``seq`` (ink order; ``inv`` gives
    image order) as one K1 (k = 1) or K2 launch per image with glyphs, back
    to back, bfloat16: what the per-image path spends in the kernel for
    the same rows, timed as one call with CUDA events after a warm-up."""
    import torch
    w = decoder.weights(torch.bfloat16)
    packed = fd.pack_step_weights(w)
    args = []
    for enc in torch.split(seq[torch.from_numpy(inv).to(seq.device)],
                           [n for n in counts if n]):
        enc = enc.to(torch.bfloat16).contiguous()
        h0, c0 = (t.contiguous() for t in decoder.init_state(enc))
        args.append((enc, decoder.project_encoding(enc).contiguous(), h0,
                     c0))
    if k == 1:
        return cuda_ms(lambda: [fd.fused_greedy_decode_packed(
            *a, w, MAX_LENGTH, packed) for a in args], reps=1)
    return cuda_ms(lambda: [fb.fused_beam_decode_packed(
        *a, w, MAX_LENGTH, k, packed) for a in args], reps=1)


def batch_vs_per_image(fd, estimator, masks, crops, seq, inv) -> dict:
    """Where the batched path's strokes part from the per-image path's on
    the same masks: each image's crops built alone (``gather_crops``) and
    encoded alone, against the rows of the batched crops and encoder
    output; then K1 (one launch each, rows are independent in K1) on both
    encoder outputs, bfloat16 as on the path."""
    import torch
    from stroke_derenderer_tpu_torch.models.encoder import encode_postprocess
    from stroke_derenderer_tpu_torch.ops.device_partition import (
        PartitionPlan, gather_crops, plan_partitions,
    )
    cfg = estimator.config
    dev = crops.device
    alone_crops, alone_seq = [], []
    for m in masks:
        plan = plan_partitions(m, cfg.margin, cfg.image_size)
        if plan is None:
            continue
        c = gather_crops(torch.from_numpy(plan.gid_img).to(dev), tuple(
            torch.from_numpy(getattr(plan, k).copy()).to(dev)
            for k in PartitionPlan.COORD_KEYS))
        alone_crops.append(c)
        alone_seq.append(encode_postprocess(
            estimator.encoder(estimator._normalize_raw(c)),
            cfg.encode_image_size))
    order = torch.from_numpy(inv).to(dev)
    a_crops, b_crops = torch.cat(alone_crops), crops[order]
    a_seq, b_seq = torch.cat(alone_seq), seq[order]
    a_tok = fd.fused_greedy_decode(estimator.decoder, a_seq.to(
        estimator.compute_dtype), MAX_LENGTH)
    b_tok = fd.fused_greedy_decode(estimator.decoder, b_seq.to(
        estimator.compute_dtype), MAX_LENGTH)
    crops_same = (a_crops == b_crops).flatten(1).all(1)
    seq_same = (a_seq == b_seq).flatten(1).all(1)
    tok_same = (a_tok == b_tok).all(1)
    return {"rows": int(a_crops.shape[0]),
            "crops_identical_rows": int(crops_same.sum()),
            "crops_differing_texels": int((a_crops != b_crops).sum()),
            "encoder_identical_rows": int(seq_same.sum()),
            "encoder_max_abs_diff": float((a_seq.float()
                                           - b_seq.float()).abs().max()),
            "tokens_identical_rows": int(tok_same.sum()),
            "tokens_identical_rows_where_encoder_identical": int(
                (tok_same & seq_same).sum())}


PHASES = ("scores", "attend", "lstm", "head", "select")


def step_breakdown(fd, name: str, decoder, seq, dtype, k: int) -> dict:
    """Where one decode call's time goes: the kernel's phase clock (block 0
    reads the global timer after every grid barrier), as microseconds per
    step of each phase, its barrier included, averaged over the steps. On
    the tensor-core path (bfloat16) also the elements it recomputed in
    float64 and the largest error of its tensor-core sums among them as a
    share of their bound (below 1, or the bound does not hold), and, as
    yardsticks (no part of the port), ``torch.matmul``'s microseconds on
    the card (``kernel_ms``: a CUDA graph of 20 calls) for the LSTM's and
    the head's products of all B x K rows at once: (rows x LDX) (LDX x 4H)
    and (rows x H) (H x (A + E + V)) in bfloat16."""
    import torch
    enc = seq.to(dtype).contiguous()
    enc_proj = decoder.project_encoding(enc).contiguous()
    h0, c0 = (t.contiguous() for t in decoder.init_state(enc))
    w = decoder.weights(dtype)
    b, dev = enc.shape[0], enc.device
    nph = 4 if k == 1 and name == "fused_decode" else 5
    stamps = torch.zeros(3 + MAX_LENGTH * nph, dtype=torch.int64,
                         device=dev)
    fixstat = torch.zeros((1024, 2), dtype=torch.int32, device=dev)
    outputs = {"preds": torch.zeros((b, k, MAX_LENGTH), dtype=torch.int32,
                                    device=dev),
               "score_out": torch.zeros((b, k), device=dev),
               "lens_out": torch.zeros((b, k), dtype=torch.int32,
                                       device=dev),
               "stamps": stamps}
    if fd.ENGINES[dtype] == "mma":
        outputs["fixstat"] = fixstat
    fd.launch_step_kernel(name, enc, enc_proj, h0, c0,
                          fd.pack_step_weights(w), k, MAX_LENGTH, outputs)
    torch.cuda.synchronize()
    t = stamps.cpu().numpy().astype("float64")
    steps = int((t[3:] > 0).sum()) // nph
    per = (t[3:3 + steps * nph] - t[2:2 + steps * nph]).reshape(steps, nph)
    rows = b * k
    hdim, (v, d) = w["wh"].shape[0], w["emb"].shape
    ldx = -(-(d + enc.shape[-1]) // 16) * 16 + -(-hdim // 16) * 16
    x = torch.ones((rows, ldx), dtype=torch.bfloat16, device=dev)
    wx = torch.ones((ldx, 4 * hdim), dtype=torch.bfloat16, device=dev)
    hx = torch.ones((rows, hdim), dtype=torch.bfloat16, device=dev)
    wh = torch.ones((hdim, w["watt"].shape[1] + w["wf"].shape[1] + v),
                    dtype=torch.bfloat16, device=dev)
    fs = fixstat.cpu()
    return {"kernel": name, "dtype": str(dtype).split(".")[-1], "B": b,
            "K": k, "engine": fd.ENGINES[dtype], "steps": steps,
            "setup_us": (t[1] - t[0]) / 1e3,
            "prologue_us": (t[2] - t[1]) / 1e3,
            "step_us": float(per.sum(1).mean()) / 1e3,
            "phase_us": {PHASES[i]: float(per[:, i].mean()) / 1e3
                         for i in range(nph)},
            "rechecked": int(fs[:, 0].sum()),
            "max_err_over_bound": float(fs[:, 1].view(torch.float32).max()),
            "lstm_matmul_us": 1e3 * kernel_ms(lambda: x @ wx),
            "head_matmul_us": 1e3 * kernel_ms(lambda: hx @ wh)}


def check_breakdown(rec: dict) -> None:
    """The tensor-core path's error bound held wherever it was checked."""
    if rec["max_err_over_bound"] >= 1.0:
        raise SystemExit(f"{rec['kernel']}: a tensor-core sum missed its "
                         f"bound: {rec}")


def barrier_cost(fd, grid: int, dev) -> dict:
    """One grid barrier of ``grid`` blocks when every block arrives at
    once: a launch crossing 2000 barriers less one crossing none."""
    many = cuda_ms(lambda: fd.barrier_probe(2000, grid, dev), reps=5)
    none = cuda_ms(lambda: fd.barrier_probe(0, grid, dev), reps=5)
    return {"grid": grid, "barrier_us": (many - none) / 2000 * 1e3,
            "empty_launch_us": none * 1e3}


def compare_beam_of_one(fb, fd, decoder, seq, label: str) -> dict:
    """K2 at K = 1 against K1, float32: K1's bar (identical, or the plain
    K1's top-2 logit gap at the first differing step below F32_GAP)."""
    import torch
    enc = seq.float().contiguous()
    enc_proj = decoder.project_encoding(enc).contiguous()
    h0, c0 = (t.contiguous() for t in decoder.init_state(enc))
    w = decoder.weights(torch.float32)
    beam = fb.fused_beam_decode_packed(enc, enc_proj, h0, c0, w, MAX_LENGTH,
                                       1)[0][:, 0]
    greedy = fd.fused_greedy_decode_packed(enc, enc_proj, h0, c0, w,
                                           MAX_LENGTH)
    _, gaps = fd.fused_greedy_decode_plain(enc, enc_proj, h0, c0, w,
                                           MAX_LENGTH, return_gaps=True)
    same = beam == greedy
    worst = first_difference_gaps(same, gaps)
    return {"case": f"K=1 vs K1, {label}", "B": int(enc.shape[0]),
            "rows_identical": int(same.all(1).sum()),
            "max_gap_at_first_difference": worst, "ok": worst < F32_GAP}


def kernel_ms(fn, reps: int = 20) -> float:
    """The time of one call of ``fn`` on the card alone: ``reps`` calls
    captured in a CUDA graph, the graph replayed and timed with CUDA
    events, so that the host's launch overhead does not count."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(graph.replay, reps=5) / reps


def k3_bytes_per_cta(plan: dict, config: dict, p: int, e: int, a: int,
                     d: int) -> int:
    """Bytes the busiest CTA of one K3 launch reads from L2: its weight
    slice once per row tile, and its positions' enc and enc_proj rows."""
    rows = max(int(x) for x in plan["rows"][1:] - plan["rows"][:-1])
    tiles = -(-rows // config["row_tile"])
    cols = int((plan["columns"][1:] - plan["columns"][:-1]).max())
    pos = int((plan["positions"][1:] - plan["positions"][:-1]).max())
    return 2 * (tiles * cols * (d + 7) // 8 * 8 + rows * pos * (e + a))


def compare_k3(da, decoder, seq, label: str) -> dict:
    """K3 against its plain version (bfloat16 streams) on one step's
    inputs: the decoder's initial h over this encoder sequence; the
    kernel's own time at each cluster size and the wrapper's time."""
    import torch
    from stroke_derenderer_tpu_torch.models.decoder import ATTENTION_WEIGHTS
    enc = seq.to(torch.bfloat16).contiguous()
    enc_proj = decoder.project_encoding(enc).contiguous()
    h = decoder.init_state(enc)[0].contiguous()
    att_w = [getattr(decoder, k) for k in ATTENTION_WEIGHTS]
    packed = da.attention_weights(decoder)
    got = da.fused_attention_gate(enc, enc_proj, h, *att_w, packed=packed)
    ref = da.fused_attention_gate_plain(enc, enc_proj, h, *att_w,
                                        stream_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    ok = all(bool(((g - r).abs() <= K3_ATOL + K3_RTOL * r.abs()).all())
             for g, r in zip(got, ref))
    b, p, e = enc.shape
    a, d = enc_proj.shape[-1], h.shape[-1]
    rec = {"case": label, "B": b, "P": p, "max_abs_err": err, "ok": ok,
           "alpha_sum_err": float((ref[1].sum(1) - 1).abs().max())}
    out, alpha = (torch.empty_like(t) for t in got)
    rec["ms_by_cluster"] = {}
    for c in K3_CLUSTERS:
        config = da.kernel_config(enc.device, c, p, e, a, d)
        plan = da.attention_plan(b, p, a, e, c, config["clusters"])
        cfg = {"G": len(plan["rows"]) - 1, "C": c,
               "clusters_on_card": config["clusters"],
               "row_tile": config["row_tile"], "stages": config["stages"],
               "smem_bytes": config["smem"],
               "bytes_per_cta": k3_bytes_per_cta(plan, config, p, e, a, d)}
        got_c = da.fused_attention_gate(enc, enc_proj, h, *att_w,
                                        packed=packed, cluster=c)
        torch.cuda.synchronize()
        rec["ok"] = rec["ok"] and all(
            bool(((g - r).abs() <= K3_ATOL + K3_RTOL * r.abs()).all())
            for g, r in zip(got_c, ref))
        cfg["ms"] = kernel_ms(lambda: da.launch_attention(
            enc, enc_proj, h, packed, out, alpha, c))
        rec["ms_by_cluster"][str(c)] = cfg
    chosen = da.choose_cluster(enc.device, b, p, e, a, d)
    rec.update(rec["ms_by_cluster"][str(chosen)])
    stamps = torch.zeros(len(da.STAMPS), dtype=torch.int64, device=enc.device)
    da.launch_attention(enc, enc_proj, h, packed, out, alpha, chosen, stamps)
    torch.cuda.synchronize()
    rec["phase_us"] = da.phase_us(stamps.cpu())
    rec["wrapper_ms"] = cuda_ms(lambda: da.fused_attention_gate(
        enc, enc_proj, h, *att_w, packed=packed), reps=20)
    rec["plain_ms"] = cuda_ms(lambda: da.fused_attention_gate_plain(
        enc, enc_proj, h, *att_w, stream_dtype=torch.bfloat16), reps=20)
    rec.update(k3_cost(enc, enc_proj, h, [t.to(torch.bfloat16)
                                          for t in att_w]))
    return rec


def cluster_barrier_cost(da, cluster: int, clusters: int, dev) -> dict:
    """One cluster barrier of ``clusters`` clusters of ``cluster`` CTAs when
    every CTA arrives at once: a launch crossing 2000 barriers less one
    crossing none, each timed alone (``kernel_ms``); and the same with a
    read of the neighbour CTA's shared memory before each barrier."""
    none = kernel_ms(lambda: da.cluster_probe(0, cluster, clusters, False,
                                              dev), reps=5)
    many = kernel_ms(lambda: da.cluster_probe(2000, cluster, clusters, False,
                                              dev), reps=5)
    swap = kernel_ms(lambda: da.cluster_probe(2000, cluster, clusters, True,
                                              dev), reps=5)
    return {"cluster": cluster, "clusters": clusters,
            "cluster_barrier_us": (many - none) / 2000 * 1e3,
            "barrier_and_dsmem_read_us": (swap - none) / 2000 * 1e3,
            "empty_launch_us": none * 1e3}


def compare_fused_greedy(da, decoder, seq, dtype) -> dict:
    """greedy_decode(fused=True) with K3 against the same entry with the
    attention from K3's plain version (bfloat16 streams), K1's bars. The
    launches are counted from 0 over the K3 run alone."""
    import torch
    from stroke_derenderer_tpu_torch.models.decoder import greedy_decode
    enc = seq.to(dtype).contiguous()
    kernel = da.fused_attention_gate
    da.launch_count = 0
    t0 = time.monotonic()
    got = greedy_decode(decoder, enc, MAX_LENGTH, fused=True)
    torch.cuda.synchronize()
    entry_s = time.monotonic() - t0
    launches = da.launch_count
    da.fused_attention_gate = lambda *a, **k: da.fused_attention_gate_plain(
        *a, stream_dtype=torch.bfloat16)
    try:
        t0 = time.monotonic()
        ref, gaps = greedy_decode(decoder, enc, MAX_LENGTH, fused=True,
                                  return_gaps=True)
        torch.cuda.synchronize()
        plain_s = time.monotonic() - t0
    finally:
        da.fused_attention_gate = kernel
    same = got == ref
    steps = int(decode_lengths(got).max())
    rec = {"case": "golden, greedy_decode(fused=True)",
           "dtype": str(dtype).split(".")[-1], "B": int(enc.shape[0]),
           "agree": float(same.float().mean()),
           "rows_identical": int(same.all(1).sum()), "steps": steps,
           "k3_launches": launches, "entry_s": entry_s,
           "plain_entry_s": plain_s}
    if dtype == torch.float32:
        rec["max_gap_at_first_difference"] = first_difference_gaps(same, gaps)
        rec["ok"] = rec["max_gap_at_first_difference"] < F32_GAP
    else:
        rec["ok"] = rec["agree"] >= BF16_AGREE
    rec["ok"] = rec["ok"] and launches == steps
    return rec


def tree_mismatches(got: dict, want: dict, path: str = "") -> list[str]:
    """The paths at which two trees of arrays differ: in keys, dtype, shape
    or any bit."""
    import numpy as np
    if set(got) != set(want):
        return [f"{path}: keys {sorted(set(got) ^ set(want))}"]
    out = []
    for k in sorted(want):
        if isinstance(want[k], dict):
            out += tree_mismatches(got[k], want[k], f"{path}/{k}")
            continue
        a, b = np.asarray(got[k]), np.asarray(want[k])
        if a.dtype != b.dtype or a.shape != b.shape or not np.array_equal(
                a, b):
            out.append(f"{path}/{k}")
    return out


def random_stats(tree: dict, rng) -> dict:
    """``tree`` with every batch norm's running ``mean`` drawn from N(0.2,
    0.3) and ``var`` from U(0.5, 2), so that no batch norm is the
    identity."""
    import numpy as np
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = random_stats(v, rng)
        elif k == "mean":
            out[k] = rng.normal(0.2, 0.3, v.shape).astype(np.float32)
        elif k == "var":
            out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        else:
            out[k] = v
    return out


def onnx_phase(cli, read_png, load_image, imgs, main_out, counters,
               dev) -> dict:
    """Phase 8 (see the module docstring). Returns its record, with the
    launches of its paths under ``launches``."""
    import dataclasses

    import numpy as np
    import torch

    from stroke_derenderer_tpu_torch import weights as tw
    from stroke_derenderer_tpu_torch.config import (
        BinarizerConfig, StrokesConfig,
    )
    from stroke_derenderer_tpu_torch.kernels import fused_beam as fb
    from stroke_derenderer_tpu_torch.kernels import fused_decode as fd
    from stroke_derenderer_tpu_torch.models.encoder import encode_postprocess
    from stroke_derenderer_tpu_torch.models.layers import linear
    from stroke_derenderer_tpu_torch.pipeline.binarize import Binarizer
    from stroke_derenderer_tpu_torch.pipeline.strokes import StrokeEstimator
    from stroke_derenderer_tpu_torch.weights.graph_export import (
        export_reference_models,
    )
    from stroke_derenderer_tpu_torch.weights.graph_import import (
        import_reference_models,
    )
    rec: dict = {}
    names = ("binarizer", "strokes_encoder", "strokes_decoder",
             "strokes_projection")

    def same_trees(imported, model_dir: Path) -> list[str]:
        _, bin_v, _, enc_v, dec_v, proj_v = imported
        out = []
        for name, got in zip(names, (bin_v, enc_v, dec_v, proj_v)):
            f = model_dir / f"{name}.msgpack"
            if got is None and not f.exists():
                continue
            if got is None or not f.exists():
                out.append(f"{name}: only one side has it")
            else:
                out += [name + m for m in tree_mismatches(
                    got, tw.read_msgpack(f))]
        return out

    with tempfile.TemporaryDirectory() as tmp:
        # (a) models_demo exported and run through the CLI.
        demo = Path(tmp) / "demo_onnx"
        t = time.monotonic()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.entrypoint(["-models", str(MODELS), "--export-onnx",
                                 str(demo)])
        rec["export_s"] = time.monotonic() - t
        if rc != 0:
            raise SystemExit(f"--export-onnx exited {rc}")
        rec["export_bytes"] = {f.name: f.stat().st_size
                               for f in sorted(demo.iterdir())}
        t = time.monotonic()
        imported = import_reference_models(demo)
        rec["import_s"] = time.monotonic() - t
        bad = same_trees(imported, MODELS)
        if bad:
            raise SystemExit(f"models_demo through ONNX and back: {bad}")
        with contextlib.redirect_stdout(io.StringIO()):
            binarizer, estimator = cli.initialize_sessions(
                demo, device=dev, se_overrides={"max_length": MAX_LENGTH})
        run_rec, run_out = drive_cli(cli, read_png, imgs, binarizer,
                                     estimator, counters)
        run_rec["per_image"] = against_per_image(run_out, main_out)
        rec["cli"] = run_rec
        if (run_rec["launches"] != {"K1": run_rec["images_with_glyphs"],
                                    "K2": 0, "K3": 0}
                or run_rec["images_with_glyphs"] == 0):
            raise SystemExit(f"onnx: launches {run_rec['launches']}; "
                             f"{run_rec['images_with_glyphs']} images have "
                             f"glyphs")
        if run_rec["per_image"]["agree"] < BATCH_MASK_AGREE:
            raise SystemExit(f"onnx: masks against phase 4's "
                             f"{run_rec['per_image']}")
        if run_rec["golden_strokes_chamfer_px"] > STROKES_CHAMFER_PX:
            raise SystemExit(f"onnx: golden strokes chamfer "
                             f"{run_rec['golden_strokes_chamfer_px']}")
        with contextlib.redirect_stdout(io.StringIO()):
            _, beam_est = cli.initialize_sessions(
                demo, device=dev, se_overrides={
                    "decode": "beam", "beam_size": BEAM,
                    "max_length": MAX_LENGTH})
        beam_rec, _ = drive_cli(cli, read_png, imgs[:1], binarizer, beam_est,
                                counters)
        rec["beam"] = beam_rec
        if beam_rec["launches"] != {"K1": 0, "K2": 1, "K3": 0}:
            raise SystemExit(f"onnx beam: launches {beam_rec['launches']}")
        del binarizer, estimator, beam_est

        # (b) a random model of the upstream shape, at full width.
        var, var_onnx = Path(tmp) / "variant", Path(tmp) / "variant_onnx"
        bin_cfg = BinarizerConfig(**ONNX_VARIANT_BIN)
        se_cfg = dataclasses.replace(
            StrokesConfig.from_json(MODELS / "configs_strokes.json"),
            **ONNX_VARIANT_SE)
        t = time.monotonic()
        tw.materialize_model_dir(var, bin_cfg, se_cfg, seed=ONNX_SEED)
        rng = np.random.default_rng(ONNX_SEED)
        for name in names[:2]:
            f = var / f"{name}.msgpack"
            tw.write_msgpack(random_stats(tw.read_msgpack(f), rng), f)
        export_reference_models(var, var_onnx)
        imported = import_reference_models(var_onnx)
        rec["variant_round_trip_s"] = time.monotonic() - t
        bad = same_trees(imported, var)
        if bad:
            raise SystemExit(f"the variant through ONNX and back: {bad}")
        i_bin_cfg, bin_v, i_se_cfg, enc_v, dec_v, proj_v = imported
        if (i_bin_cfg.export_dict() != bin_cfg.export_dict()
                or i_se_cfg.export_dict() != se_cfg.export_dict()):
            raise SystemExit("the variant's configs through ONNX differ")
        img = load_image(GOLDEN / "golden_input.png")
        f32 = dataclasses.replace(i_bin_cfg, compute_dtype="float32")
        masks = [Binarizer(f32, device=d, variables=bin_v).binarize_image(
            img)[:, :, 0] > 127 for d in (dev, "cpu")]
        rec["variant_binarize"] = {
            "card_vs_cpu_agree": float((masks[0] == masks[1]).mean()),
            "ink_share": float(masks[0].mean())}
        if rec["variant_binarize"]["card_vs_cpu_agree"] < MASK_AGREE:
            raise SystemExit(f"variant binarize: {rec['variant_binarize']}")
        estimator = StrokeEstimator(
            dataclasses.replace(i_se_cfg, max_length=MAX_LENGTH), device=dev,
            variables=(enc_v, dec_v, proj_v))
        expected = read_png(GOLDEN / "expected_BINARIZED.png")[:, :, 0] > 127
        for mod in counters.values():
            mod.launch_count = 0
        t = time.monotonic()
        strokes = estimator.process_image(expected)
        torch.cuda.synchronize()
        rec["variant_process_image"] = {
            "s": time.monotonic() - t, "strokes": len(strokes),
            "launches": {n: m.launch_count for n, m in counters.items()}}
        if rec["variant_process_image"]["launches"] != {"K1": 1, "K2": 0,
                                                        "K3": 0}:
            raise SystemExit(f"variant process_image: "
                             f"{rec['variant_process_image']}")

        # K1 and K2 at the variant's widths against their plain versions.
        wide = tw.init_strokes(dataclasses.replace(i_se_cfg,
                                                   projection_dim=0),
                               ONNX_SEED)[1].to(dev).eval()
        checks = []
        with torch.inference_mode():
            rng = np.random.default_rng(ONNX_SEED)
            for b in ONNX_K1_BATCHES:
                crops = torch.from_numpy(synthetic_crops(rng, b)).to(
                    dev).float()
                raw = encode_postprocess(
                    estimator.encoder(estimator._normalize_raw(crops)),
                    i_se_cfg.encode_image_size)
                projected = linear(raw.to(estimator.compute_dtype),
                                   estimator.projection)
                for label, dec, seq in (
                        (f"projected E={projected.shape[-1]} B={b}",
                         estimator.decoder, projected),
                        (f"unprojected E={raw.shape[-1]} B={b}", wide,
                         raw)):
                    for dtype in (torch.float32, torch.bfloat16):
                        c = compare_k1(fd, dec, seq, dtype, label)
                        c["kernel"] = "K1"
                        checks.append(c)
                if b == ONNX_K2_BATCH:
                    for dtype in (torch.float32, torch.bfloat16):
                        c = compare_k2(fb, estimator.decoder, projected,
                                       dtype, f"projected E="
                                       f"{projected.shape[-1]} B={b}")
                        c["kernel"] = "K2"
                        checks.append(c)
        for c in checks:
            print(json.dumps({k: c[k] for k in (
                "kernel", "case", "dtype", "B", "K", "agree", "ok", "ms",
                "plain_ms", "bound_ms", "bound_by", "steps_max", "grid",
                "step_ms", "max_gap_at_first_difference") if k in c}),
                flush=True)
        rec["checks"] = checks
        bad = [c for c in checks if not c["ok"]]
        if bad:
            raise SystemExit(f"K1/K2 at the variant's widths disagree with "
                             f"their plain versions: {bad}")
    rec["launches"] = {
        "K1": {"onnx": run_rec["launches"]["K1"], "onnx-variant": 1},
        "K2": {"onnx-beam": beam_rec["launches"]["K2"]}}
    return rec


def drive_cli(cli, read_png, imgs, binarizer, estimator, counters,
              runner=None, mask_agree: float = MASK_AGREE
              ) -> tuple[dict, dict]:
    """``runner`` (``cli.run``, ``cli.run_batched``, ``cli.run_two_stage``
    or a runner of the same signature) on the images with every module's
    ``launch_count`` in ``counters`` set to 0 just before and read just
    after; the checks of phases 4, 7, 8, 9 and 10 (the golden mask against
    the expected one on at least ``mask_agree`` of its pixels), and that
    every K1 and K2 launch took the path of the estimator's stream type
    (``check_engines``). Returns the record and, per image, its mask (bool)
    and strokes as written."""
    import numpy as np
    import torch
    runner = runner or cli.run
    outputs = {}
    with tempfile.TemporaryDirectory() as out:
        for mod in counters.values():
            mod.launch_count = 0
        before = engine_counts(counters)
        captured = io.StringIO()
        t_run = time.monotonic()
        with contextlib.redirect_stdout(captured):
            done = runner(imgs, binarizer, estimator, out)
        torch.cuda.synchronize()
        t_run = time.monotonic() - t_run
        launches = {name: mod.launch_count for name, mod in counters.items()}
        engines = check_engines(runner.__name__, counters, before, launches,
                                estimator.compute_dtype)
        text = captured.getvalue()
        if done != len(imgs):
            print(text)
            raise SystemExit(f"{runner.__name__} processed {done} of "
                             f"{len(imgs)} images")
        with_glyphs = 0
        for _, name in imgs:
            for suffix in ("_BINARIZED.png", "_STROKES.json"):
                if not (Path(out) / f"{name}{suffix}").exists():
                    raise SystemExit(f"missing output {name}{suffix}")
            mask = read_png(Path(out) / f"{name}_BINARIZED.png")[:, :, 0] > 0
            outputs[name] = (mask, json.loads(
                (Path(out) / f"{name}_STROKES.json").read_text()))
            with_glyphs += bool(mask.any())
        got = read_png(Path(out) / "golden_input_BINARIZED.png")
        want = read_png(GOLDEN / "expected_BINARIZED.png")
        if got.shape != want.shape:
            raise SystemExit(f"golden mask shape {got.shape} != {want.shape}")
        golden_agree = float((got == want).mean())
        strokes = json.loads((Path(out) / "golden_input_STROKES.json")
                             .read_text())
        expected = json.loads((GOLDEN / "expected_STROKES.json").read_text())
    t_bin = [float(x) for x in re.findall(r"took ([0-9.]+) seconds to "
                                           r"binarize", text)]
    t_se = [float(x) for x in re.findall(r"took ([0-9.]+) seconds to "
                                          r"estimate", text)]
    t_e2e = [float(x) for x in re.findall(r"took ([0-9.]+) seconds e2e",
                                           text)]
    rec = {
        "images": len(imgs), "images_with_glyphs": with_glyphs,
        "launches": launches, "engines": engines,
        "golden_mask_agree": golden_agree,
        "golden_mask_differing_px": int((got != want).sum()),
        "golden_strokes_chamfer_px": chamfer(strokes, expected),
        "run_s": t_run}
    for key, ts in (("binarize", t_bin), ("strokes", t_se), ("e2e", t_e2e)):
        if ts:
            rec[f"{key}_s_per_image"] = float(np.mean(ts))
            rec[f"{key}_s_first"] = ts[0]
    print(json.dumps(rec), flush=True)
    if golden_agree < mask_agree:
        raise SystemExit(f"golden mask agreement {golden_agree} < "
                         f"{mask_agree}")
    return rec, outputs


def engine_counts(counters: dict) -> dict:
    """K1's and K2's launches by path so far (``engine_launches``)."""
    return {name: dict(counters[name].engine_launches)
            for name in ("K1", "K2")}


def check_engines(label: str, counters: dict, before: dict, launches: dict,
                  dtype) -> dict:
    """The K1 and K2 launches since ``before`` by path; every one of them
    must have taken the path of the stream type ``dtype``
    (``fused_decode.ENGINES``: bfloat16 on the tensor cores, float32 on CUDA
    cores in float64), as many as ``launches`` counted."""
    want = counters["K1"].ENGINES[dtype]
    now = engine_counts(counters)
    got = {name: {e: now[name][e] - before[name][e] for e in now[name]}
           for name in now}
    for name, by_path in got.items():
        if by_path[want] != launches[name] or sum(by_path.values()) != \
                launches[name]:
            raise SystemExit(f"{label}: {name} launches by path {by_path}, "
                             f"expected all {launches[name]} on {want}")
    return got


def mask_diff(masks: dict, ref: dict) -> dict:
    """Pixels of ``masks`` (name -> bool mask) that differ from the masks
    of the same images in ``ref``, over all of them."""
    differ = total = 0
    for name, mask in masks.items():
        if mask.shape != ref[name].shape:
            raise SystemExit(f"{name}: mask shape {mask.shape} != "
                             f"{ref[name].shape}")
        differ += int((mask != ref[name]).sum())
        total += mask.size
    return {"differing_px": differ, "px": total,
            "agree": 1.0 - differ / total, "images": len(masks)}


def against_per_image(outputs: dict, per_image: dict) -> dict:
    """A batched run's outputs (name -> (mask, strokes)) against the
    per-image run's: :func:`mask_diff` of the masks, and how many images'
    strokes files are identical."""
    rec = mask_diff({n: m for n, (m, _) in outputs.items()},
                    {n: m for n, (m, _) in per_image.items()})
    rec["strokes_identical"] = sum(
        strokes == per_image[n][1] for n, (_, strokes) in outputs.items())
    return rec


def http_call(port: int, method: str, path: str, body=None):
    """One request to the server on 127.0.0.1 with ``http.client`` (no
    proxy is consulted) -> (status, body)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path, body=body)
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def drive_server(serve, encode_png, imgs, binarizer, estimator,
                 counters) -> dict:
    """The port's server in this process (``BatchWorker`` and a
    ``ThreadingHTTPServer`` on 127.0.0.1, any free port): /healthz,
    ``SERVE_CONCURRENT`` concurrent /derender requests (the golden input
    first), one /binarize, one /derender?svg=1, one body that is not a PNG,
    one unknown path, then /metrics. Counts are set to 0 just before the
    requests and read just after. The server and its worker are stopped on
    the way out."""
    import threading
    from http.server import ThreadingHTTPServer
    import torch
    worker = serve.BatchWorker(binarizer, estimator,
                               window_s=SERVE_WINDOW_S)
    worker.start()
    srv = ThreadingHTTPServer(("127.0.0.1", 0),
                              serve.make_handler(worker, timeout_s=600))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    port = srv.server_port
    bodies = [encode_png(img) for img, _ in imgs[:SERVE_CONCURRENT]]
    try:
        for mod in counters.values():
            mod.launch_count = 0
        t_run = time.monotonic()
        status = {"healthz": http_call(port, "GET", "/healthz")[0]}
        with ThreadPoolExecutor(len(bodies)) as pool:
            replies = list(pool.map(lambda b: http_call(
                port, "POST", "/derender", b), bodies))
        status["derender"] = [r[0] for r in replies]
        status["binarize"] = http_call(port, "POST", "/binarize",
                                       bodies[1])[0]
        svg_status, svg_body = http_call(port, "POST", "/derender?svg=1",
                                         bodies[0])
        status["derender_svg"] = svg_status
        status["bad_body"] = http_call(port, "POST", "/binarize",
                                       b"not a png")[0]
        status["unknown_path"] = http_call(port, "POST", "/nope", b"x")[0]
        torch.cuda.synchronize()
        t_run = time.monotonic() - t_run
        launches = {name: mod.launch_count for name, mod in counters.items()}
        metrics = json.loads(http_call(port, "GET", "/metrics")[1])
    finally:
        srv.shutdown()
        srv.server_close()
        worker.close()
        worker.join(60)
        thread.join(60)
    if worker.is_alive() or thread.is_alive():
        raise SystemExit("the server's threads did not stop")
    want = {"healthz": 200, "derender": [200] * len(bodies), "binarize": 200,
            "derender_svg": 200, "bad_body": 400, "unknown_path": 404}
    if status != want:
        raise SystemExit(f"server replies {status}, expected {want}")
    golden = json.loads(replies[0][1])
    svg = json.loads(svg_body)
    expected = json.loads((GOLDEN / "expected_STROKES.json").read_text())
    return {"requests": 5 + len(bodies), "derender_requests": len(bodies) + 1,
            "launches": launches, "run_s": t_run,
            "batch_size_hist": metrics["batch_size_hist"],
            "batches": metrics["batches"], "latency_s": metrics["latency_s"],
            "golden_strokes_chamfer_px": chamfer(golden["strokes"], expected),
            "svg_ok": svg["svg"].startswith("<svg") and bool(svg["strokes"]),
            # The golden input alone, against it in the concurrent batch.
            "svg_strokes_as_in_batch": svg["strokes"] == golden["strokes"]}


def check_batched(phase: str, rec: dict, launches: dict) -> None:
    """The bars of phases 8 and 9: one launch of the path's kernel and none
    of the others, the golden strokes near the expected ones, the masks
    as the per-image run's."""
    if rec["launches"] != launches:
        raise SystemExit(f"{phase}: launches {rec['launches']}, expected "
                         f"{launches}")
    if rec["golden_strokes_chamfer_px"] > STROKES_CHAMFER_PX:
        raise SystemExit(f"{phase}: golden strokes chamfer "
                         f"{rec['golden_strokes_chamfer_px']} px > "
                         f"{STROKES_CHAMFER_PX}")
    if rec["per_image"]["agree"] < BATCH_MASK_AGREE:
        raise SystemExit(f"{phase}: masks against the per-image run "
                         f"{rec['per_image']}")


def chamfer(a, b) -> float:
    import numpy as np
    pa = np.concatenate([np.stack([x, y], -1) for x, y in a]) if a else None
    pb = np.concatenate([np.stack([x, y], -1) for x, y in b]) if b else None
    if pa is None or pb is None:
        return 0.0 if pa is None and pb is None else float("inf")
    d = np.linalg.norm(pa[:, None, :] - pb[None, :, :], axis=-1)
    return float(d.min(axis=1).mean() + d.min(axis=0).mean()) / 2


def pick(recs, case, dtype=None):
    """The record of a case (at K = BEAM for K2)."""
    return next(c for c in recs if c["case"] == case
                and (dtype is None or c.get("dtype") == dtype)
                and c.get("K", BEAM) == BEAM)


@contextlib.contextmanager
def host_timers(mod, names):
    """Wrap the functions ``names`` of module ``mod`` to sum their host
    seconds and calls into the yielded dict, with the largest number of
    strokes one call was given; restored on the way out."""
    spent = {n: {"s": 0.0, "calls": 0, "max_strokes": 0} for n in names}
    real = {n: getattr(mod, n) for n in names}

    def timed(name):
        def call(*args, **kwargs):
            t = time.perf_counter()
            try:
                return real[name](*args, **kwargs)
            finally:
                spent[name]["s"] += time.perf_counter() - t
                spent[name]["calls"] += 1
                given = args[1] if name == "residual_ink" else args[0]
                spent[name]["max_strokes"] = max(
                    spent[name]["max_strokes"], len(given))
        return call

    for n in names:
        setattr(mod, n, timed(n))
    try:
        yield spent
    finally:
        for n in names:
            setattr(mod, n, real[n])


def golden_coverage(outputs: dict, img, tol: int) -> float:
    """Share of the golden mask's ink that its strokes (as written, rescaled
    back to the mask's frame) cover, as ``_residual_for`` measures it."""
    import numpy as np
    from stroke_derenderer_tpu_torch.pipeline.strokes import residual_ink
    mask, strokes = outputs["golden_input"]
    ratio = img.shape[0] / mask.shape[0]
    strokes = [(np.asarray(x) / ratio, np.asarray(y) / ratio)
               for x, y in strokes]
    resid = residual_ink(mask, strokes, tol=tol)
    return 1.0 - (0 if resid is None else int(resid.sum())) / int(mask.sum())


def against_jax(name: str, got: dict, ref: dict) -> list[str]:
    """The bars of phase 15 for one run: the misses, as text."""
    misses = []
    if abs(got["stroke_dtw"] - ref["stroke_dtw"]) > ref["stroke_dtw_ci95"]:
        misses.append(f"{name}: stroke_dtw {got['stroke_dtw']} against JAX "
                      f"{ref['stroke_dtw']} +- {ref['stroke_dtw_ci95']}")
    for key in ("binarization_f1", "binarization_f1_tol1"):
        if key in ref and abs(got[key] - ref[key]) > EVAL_F1_TOL:
            misses.append(f"{name}: {key} {got[key]} against JAX {ref[key]}")
    if abs(got["stroke_coverage"] - ref["stroke_coverage"]) > (
            EVAL_COVERAGE_TOL):
        misses.append(f"{name}: stroke_coverage {got['stroke_coverage']} "
                      f"against JAX {ref['stroke_coverage']}")
    return misses


def eval_against(name: str, fn, references: dict) -> dict:
    """One evaluator run, ``fn()``, held to the run ``name`` of each
    reference (label -> a golden file's runs): its record, with each
    reference's misses and, in "within", the labels of those whose every
    bar it meets."""
    import torch
    t_run = time.monotonic()
    got = fn()
    torch.cuda.synchronize()
    refs = {r: runs[name]["result"] for r, runs in references.items()}
    rec = {"seconds": time.monotonic() - t_run, "result": got,
           "jax_cpu": refs, "misses": {r: against_jax(name, got, ref)
                                       for r, ref in refs.items()}}
    rec["within"] = [r for r, m in rec["misses"].items() if not m]
    print(json.dumps({"eval": name, "seconds": rec["seconds"],
                      "within": rec["within"],
                      "port_vs_jax_cpu": {k: [got[k]] + [
                          ref.get(k) for ref in refs.values()]
                          for k in got}}), flush=True)
    return rec


def train_golden_batches(golden: dict) -> dict:
    """The reference steps' batches, from the port's generators at the
    golden file's seed, sizes and styles."""
    from stroke_derenderer_tpu_torch.data.synthetic import (
        partitioned_glyph_batches, tile_batches,
    )
    import numpy as np
    g = golden["config"]
    rng = np.random.default_rng
    return {
        "binarizer": list(tile_batches(
            rng(g["seed"]), g["batch"], 128, 384, n_batches=g["steps"],
            style=g["line_style"], ruled=g["ruled"], narrow=g["narrow"])),
        "captioner": list(partitioned_glyph_batches(
            rng(g["seed"]), g["batch"], g["seq_len"], n_batches=g["steps"],
            style=g["glyph_style"]))}


def batch_sums(batches: dict) -> dict:
    """Float64 sums of every array of every batch: a fingerprint the golden
    file records, so that a drift in the generators shows as such."""
    return {name: [[float(a.astype("float64").sum()) for a in batch]
                   for batch in bs] for name, bs in batches.items()}


def train_updates(models, dtype: str, device, schedule, **cap_kw) -> dict:
    """One update function per model, warm-started from ``models`` with
    ``dtype`` compute and AdamW on ``schedule``; ``cap_kw`` goes to the
    captioner's step. Each takes numpy arrays of one batch and returns the
    loss as a float (the step's device work done)."""
    import dataclasses

    import torch

    from stroke_derenderer_tpu_torch.config import (
        BinarizerConfig, StrokesConfig,
    )
    from stroke_derenderer_tpu_torch.train import loop, steps
    from stroke_derenderer_tpu_torch.weights import (
        init_binarizer, init_strokes, read_msgpack,
    )
    up = lambda a: torch.from_numpy(a).to(device)
    cfg = dataclasses.replace(BinarizerConfig.from_json(
        models / "configs_binarizer.json"), compute_dtype=dtype)
    model = init_binarizer(cfg)
    model.load_state_dict(loop._unet_layout(cfg).from_tree(read_msgpack(
        models / "binarizer.msgpack")["params"]))
    model.to(device)
    bin_step = steps.make_binarizer_train_step(
        model, steps.make_optimizer(model), schedule)
    cfg = dataclasses.replace(StrokesConfig.from_json(
        models / "configs_strokes.json"), compute_dtype=dtype)
    cap = steps.Captioner(*init_strokes(cfg))
    cap.load_state_dict(loop._captioner_layout(cfg).from_tree({
        k: read_msgpack(models / f"strokes_{k}.msgpack")["params"]
        for k in ("encoder", "decoder")}))
    cap.decoder.requires_grad_(True)
    cap.to(device)
    cap_step = steps.make_captioner_train_step(
        cap, steps.make_optimizer(cap), schedule, **cap_kw)
    return {"binarizer": lambda x, y, i=0: float(bin_step(up(x), up(y))),
            "captioner": lambda c, t, o, i=0: float(cap_step(
                up(c), up(t).long(), up(o).long(), step_idx=i))}


def golden_train_losses(models, dtype: str, device, batches: dict,
                        golden: dict) -> dict:
    """Each model's per-step losses over ``batches``: warm-started from
    ``models``, ``dtype`` compute, AdamW with the schedule of
    ``golden["config"]["steps"]`` steps at its learning rate, the captioner
    with its ``coord_sigma`` and no scheduled sampling."""
    from stroke_derenderer_tpu_torch.train import steps
    g = golden["config"]
    updates = train_updates(models, dtype, device,
                            lambda c: steps.lr_at(c, g["lr"], g["steps"]),
                            coord_sigma=g["coord_sigma"])
    return {name: [updates[name](*batch) for batch in batches[name]]
            for name in ("binarizer", "captioner")}


def step_alone_ms(device, reps: int = 8) -> dict:
    """ms per update of each model of ``TRAIN_MODELS`` with the recipe's
    settings (bf16, the captioner with coordinate smoothing and scheduled
    sampling at its full rate) on one fixed batch of ``TRAIN_BATCH``, no
    loader thread alive: the step's own cost, beside the loop's."""
    import numpy as np

    from stroke_derenderer_tpu_torch.data.synthetic import (
        partitioned_glyph_batches, tile_batches,
    )
    updates = train_updates(TRAIN_MODELS, "bfloat16", device, lambda c: 1e-5,
                            coord_sigma=1.0, sample_prob=0.25,
                            total_steps=TRAIN_STEPS, ss_ramp_frac=0.2)
    batches = {
        "binarizer": next(tile_batches(
            np.random.default_rng(1), TRAIN_BATCH, style="letters",
            ruled=0.5, narrow=0.5)),
        "captioner": next(partitioned_glyph_batches(
            np.random.default_rng(1), TRAIN_BATCH, TRAIN_SEQ_LEN,
            style="hand"))}
    out = {}
    for name, fn in updates.items():
        fn(*batches[name], TRAIN_STEPS)  # warm-up
        t = time.perf_counter()
        for _ in range(reps):
            fn(*batches[name], TRAIN_STEPS)
        out[name] = (time.perf_counter() - t) / reps * 1e3
    return out


def against_train_golden(got: dict, want: dict) -> list[str]:
    """The bars of the train phase: float32 step 1 within
    ``TRAIN_F32_STEP1_RTOL`` and later steps within ``TRAIN_F32_RTOL`` of
    the JAX loss, bfloat16 within ``TRAIN_BF16_RTOL``."""
    misses = []
    for dtype, by_model in got.items():
        for name, losses in by_model.items():
            for i, (a, b) in enumerate(zip(losses, want[dtype][name])):
                tol = (TRAIN_BF16_RTOL if dtype == "bfloat16" else
                       TRAIN_F32_STEP1_RTOL if i == 0 else TRAIN_F32_RTOL)
                if not abs(a - b) <= tol * abs(b):
                    misses.append(f"{name} {dtype} step {i + 1}: {a} vs "
                                  f"JAX {b} (rtol {tol})")
    return misses


def train_rates(res) -> dict:
    """steps/s of a run and where its seconds went (loader wait against
    the step, the step's device time included)."""
    n = len(res.losses)
    total = res.wait_s + res.step_s
    return {"steps": n, "start_step": res.start_step,
            "steps_per_s": n / total if total else None,
            "wait_s": res.wait_s, "step_s": res.step_s,
            "wait_share": res.wait_s / total if total else None,
            "first_loss": res.losses[0] if n else None,
            "last_loss": res.losses[-1] if n else None}


def train_phase(cli, counters: dict, dev) -> dict:
    """Phase 14: the trainer on the card (see the module docstring)."""
    import numpy as np
    import torch

    from stroke_derenderer_tpu_torch.data.cache import build_glyph_cache
    from stroke_derenderer_tpu_torch.io import load_image
    from stroke_derenderer_tpu_torch.train import loop

    rec: dict = {}
    golden = json.loads(JAX_TRAIN.read_text())
    batches = train_golden_batches(golden)
    flat = lambda sums: [v for k in sorted(sums) for b in sums[k] for v in b]
    if not np.allclose(flat(batch_sums(batches)),
                       flat(golden["batch_sums"]), rtol=1e-9, atol=0):
        raise SystemExit("train: the generators' batches differ from those "
                         "the golden file was made from")
    got = {dtype: golden_train_losses(MODELS, dtype, dev, batches, golden)
           for dtype in ("float32", "bfloat16")}
    rec["golden"] = {"port": got, "jax_cpu": golden["losses"],
                     "misses": against_train_golden(got, golden["losses"])}
    print(json.dumps({"train_golden": got}), flush=True)
    if rec["golden"]["misses"]:
        raise SystemExit("train against the JAX reference: "
                         + "; ".join(rec["golden"]["misses"]))

    work = Path(tempfile.mkdtemp(prefix="train_", dir=tempfile.gettempdir()))
    recipe = ["--init-from", str(TRAIN_MODELS), "--ema", "0.999",
              "--batch", str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ_LEN),
              "--ckpt-every", str(TRAIN_STEPS // 2), "--line-style",
              "letters", "--ruled", "0.5", "--narrow", "0.5",
              "--glyph-style", "hand", "--coord-smoothing", "1.0",
              "--scheduled-sampling", "0.25", "--ss-ramp-frac", "0.2",
              "--device", str(dev), "--out", str(work / "recipe")]
    first = loop.train(recipe + ["--steps", str(TRAIN_STEPS)],
                       TRAIN_WORKERS)
    again = loop.train(recipe + ["--steps", str(TRAIN_RESUME_STEPS)],
                       TRAIN_WORKERS)
    rec["resume_start_steps"] = {k: r.start_step for k, r in again.items()}
    if set(rec["resume_start_steps"].values()) != {TRAIN_STEPS} or any(
            len(r.losses) != TRAIN_RESUME_STEPS - TRAIN_STEPS
            for r in again.values()):
        raise SystemExit(f"train: the rerun resumed at "
                         f"{rec['resume_start_steps']}, not {TRAIN_STEPS}")
    t_cache = time.monotonic()
    build_glyph_cache(work / "cache", TRAIN_CACHE_N, seq_len=TRAIN_SEQ_LEN,
                      style="hand", seed=0)
    rec["cache_build_s"] = time.monotonic() - t_cache
    cached = loop.train(recipe[:-1] + [
        str(work / "cached"), "--model", "captioner", "--cache",
        str(work / "cache"), "--steps", str(TRAIN_STEPS)], TRAIN_WORKERS)
    scratch = loop.train(list(TRAIN_SCRATCH) + [
        "--batch", str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ_LEN),
        "--line-style", "letters", "--cache", str(work / "cache"),
        "--steps", str(TRAIN_STEPS), "--ckpt-every", str(TRAIN_STEPS),
        "--device", str(dev), "--out", str(work / "scratch")],
        TRAIN_WORKERS)
    rec["rates"] = {"binarizer": train_rates(first["binarizer"]),
                    "captioner": train_rates(first["captioner"]),
                    "captioner-cache": train_rates(cached["captioner"]),
                    "binarizer-resumed": train_rates(again["binarizer"]),
                    "captioner-resumed": train_rates(again["captioner"]),
                    "binarizer-scratch": train_rates(scratch["binarizer"]),
                    "captioner-scratch": train_rates(scratch["captioner"])}
    runs = {"first": first, "again": again, "cached": cached,
            "scratch": scratch}
    bad = [f"{name} {k}" for name, rs in runs.items()
           for k, r in rs.items() if not np.all(np.isfinite(r.losses))]
    if bad:
        raise SystemExit(f"train: losses not finite in {bad}")
    rec["scratch_means"] = {}
    for k, r in scratch.items():
        head = float(np.mean(r.losses[:TRAIN_WINDOW]))
        tail = float(np.mean(r.losses[-TRAIN_WINDOW:]))
        rec["scratch_means"][k] = [head, tail]
        if not tail < head:
            raise SystemExit(f"train: from scratch the {k}'s loss did not "
                             f"fall ({head} -> {tail})")
    for name, r in rec["rates"].items():
        print(json.dumps({"train_rate": name} | r), flush=True)
    rec["step_alone_ms"] = step_alone_ms(dev)
    print(json.dumps({"train_step_alone_ms": rec["step_alone_ms"]}),
          flush=True)

    # The exported model dir through the CLI on the golden image.
    for mod in counters.values():
        mod.launch_count = 0
    binarizer, estimator = cli.initialize_sessions(work / "recipe",
                                                   device=dev)
    img = load_image(GOLDEN / "golden_input.png")
    done = cli.run([(img, "golden_input")], binarizer, estimator,
                   work / "cli")
    torch.cuda.synchronize()
    launches = {n: m.launch_count for n, m in counters.items()}
    outputs = [work / "cli" / f"golden_input_{s}"
               for s in ("BINARIZED.png", "STROKES.json")]
    rec["cli"] = {"done": done, "launches": launches,
                  "files": [p.exists() for p in outputs]}
    if done != 1 or not all(rec["cli"]["files"]) or launches != {
            "K1": 1, "K2": 0, "K3": 0}:
        raise SystemExit(f"train: the exported dir through cli.run: "
                         f"{rec['cli']}")
    import shutil
    shutil.rmtree(work, ignore_errors=True)
    return rec


def line_tile(h: int = 128, w: int = 384):
    """A handwriting-like tile, dark curls on white (the JAX package's
    ``tests/test_quant.py:_line_tile``)."""
    import numpy as np
    img = np.full((h, w, 3), 255, np.uint8)
    t = np.linspace(0, 4 * np.pi, 900)
    for k in range(3):
        xs = (60 + 120 * k + 45 * np.cos(t * (1 + k))).astype(int)
        ys = (h // 2 + 40 * np.sin(t + k)).astype(int)
        img[np.clip(ys, 0, h - 1), np.clip(xs, 0, w - 1)] = 0
        img[np.clip(ys + 1, 0, h - 1), np.clip(xs, 0, w - 1)] = 0
    return img


def int8_conv_checks(dev) -> list[dict]:
    """``int8_conv2d`` (through ``layers.conv``) on the card against the
    same call on the CPU at each ``INT8_CONVS`` shape, float32 and bf16:
    the int32 sums equal and the outputs bit for bit the same; each
    one's ms beside cuDNN's float conv of the same shape and dtype."""
    import numpy as np
    import torch
    from stroke_derenderer_tpu_torch.models.layers import conv
    from stroke_derenderer_tpu_torch.ops import quant
    rng = np.random.default_rng(0)
    out = []
    for label, b, cin, h, w, cout, k, st, pad, bias in INT8_CONVS:
        layer = torch.nn.Conv2d(cin, cout, k, st, pad, bias=bias)
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(
                rng.normal(size=layer.weight.shape) * 0.1))
            if bias:
                layer.bias.copy_(torch.from_numpy(rng.normal(size=cout)))
        card = torch.nn.Conv2d(cin, cout, k, st, pad, bias=bias).to(dev)
        card.load_state_dict(layer.state_dict())
        x32 = rng.normal(size=(b, cin, h, w)).astype(np.float32)
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.from_numpy(x32).to(dtype)
            xd = x.to(dev)
            with torch.inference_mode():
                xq, _ = quant._quantize(x)
                wq, _ = quant._quantize(layer.weight.to(dtype), (1, 2, 3))
                acc_same = torch.equal(
                    quant.conv2d_int32(xq.to(dev), wq.to(dev), st,
                                       pad).cpu(),
                    quant.conv2d_int32(xq, wq, st, pad))
                got = conv(xd, card, st, pad, quant="int8").cpu()
                want = conv(x, layer, st, pad, quant="int8")
                ms = cuda_ms(lambda: conv(xd, card, st, pad, quant="int8"),
                             5)
                cudnn_ms = cuda_ms(lambda: conv(xd, card, st, pad), 5)
            out.append({"case": label, "dtype": str(dtype)[6:],
                        "shape": [b, cin, h, w], "out": cout, "k": k,
                        "stride": st, "int32_equal": acc_same,
                        "bit_equal": torch.equal(got, want),
                        "ms": ms, "cudnn_ms": cudnn_ms})
            print(json.dumps(out[-1]), flush=True)
    return out


def int8_phase(cli, read_png, imgs, main_out, counters, dev, binarizer,
               estimator, sessions: dict) -> dict:
    """Phase 16: ``--quant int8`` (see the module docstring). ``sessions``
    holds the int8 pipelines: "bin", "greedy" and "beam"."""
    import numpy as np
    import torch
    from stroke_derenderer_tpu_torch.eval import run as eval_run
    from stroke_derenderer_tpu_torch.ops import quant
    rec: dict = {"convs": int8_conv_checks(dev)}
    bad = [c for c in rec["convs"] if not (c["int32_equal"]
                                           and c["bit_equal"])]
    if bad:
        raise SystemExit(f"int8 conv on the card differs from the CPU: {bad}")
    q_bin, q_est, q_beam = (sessions[k] for k in ("bin", "greedy", "beam"))
    # The demo-weight bars of the JAX package's tests/test_quant.py, the
    # port's int8 against its bf16 on the card.
    with torch.inference_mode():
        x = torch.from_numpy(line_tile()[None].astype(np.float32)
                             / 255.0).to(dev)
        thr = binarizer.config.bin_thr
        m_f = (binarizer.model(x)[..., 0] > thr).cpu().numpy()
        m_q = (q_bin.model(x)[..., 0] > thr).cpu().numpy()
        cfg = estimator.config
        glyph = line_tile(224, 224).astype(np.float32) / 255.0
        g = torch.from_numpy(((glyph - np.asarray(cfg.mean, np.float32))
                              / np.asarray(cfg.std, np.float32))[None])
        f_f = estimator.encoder(g.to(dev)).flatten().double().cpu().numpy()
        f_q = q_est.encoder(g.to(dev)).flatten().double().cpu().numpy()
    union = float((m_f | m_q).sum())
    rec["demo"] = {
        "mask_agree": float((m_f == m_q).mean()),
        "ink_iou": float((m_f & m_q).sum()) / union if union else 1.0,
        "encoder_cosine": float(f_f @ f_q / (np.linalg.norm(f_f)
                                             * np.linalg.norm(f_q)))}
    print(json.dumps({"int8_demo": rec["demo"]}), flush=True)
    demo = rec["demo"]
    if (demo["mask_agree"] < INT8_AGREE or demo["ink_iou"] < INT8_IOU
            or not demo["encoder_cosine"] > INT8_COSINE):
        raise SystemExit(f"int8 against bf16 on the demo weights: {demo}")
    # The CLI per image, batched, and beam on the golden image.
    calls = quant.call_count
    rec["cli"], q_out = drive_cli(cli, read_png, imgs, q_bin, q_est,
                                  counters, mask_agree=INT8_AGREE)
    rec["conv_calls"] = quant.call_count - calls
    rec["cli"]["against_bf16"] = against_per_image(q_out, main_out)
    k1 = rec["cli"]["launches"]["K1"]
    if (k1 != rec["cli"]["images_with_glyphs"] or rec["conv_calls"] == 0
            or rec["cli"]["against_bf16"]["agree"] < INT8_AGREE):
        raise SystemExit(f"int8 per image: {rec['cli']}")
    rec["batch"], qb_out = drive_cli(cli, read_png, imgs, q_bin, q_est,
                                     counters, cli.run_batched,
                                     mask_agree=INT8_AGREE)
    rec["batch"]["against_per_image"] = against_per_image(qb_out, q_out)
    rec["beam"], _ = drive_cli(cli, read_png, imgs[:1], q_bin, q_beam,
                               counters, mask_agree=INT8_AGREE)
    if (rec["batch"]["launches"] != {"K1": 1, "K2": 0, "K3": 0}
            or rec["beam"]["launches"] != {"K1": 0, "K2": 1, "K3": 0}):
        raise SystemExit(f"int8 launches: batch {rec['batch']['launches']},"
                         f" beam {rec['beam']['launches']}")
    # K1 and K2 against their plain versions on the int8 encoder's
    # sequences of the batched run's glyphs (bfloat16 streams).
    from stroke_derenderer_tpu_torch.kernels import fused_beam as fb
    from stroke_derenderer_tpu_torch.kernels import fused_decode as fd
    from stroke_derenderer_tpu_torch.models.encoder import encode_postprocess
    with torch.inference_mode():
        crops = q_est._gather_batch([qb_out[name][0]
                                     for _, name in imgs])[0]
        seq = encode_postprocess(q_est.encoder(q_est._normalize_raw(crops)),
                                 q_est.config.encode_image_size)
        rec["kernels"] = [
            compare_k1(fd, q_est.decoder, seq, torch.bfloat16,
                       "int8 batched"),
            compare_k2(fb, q_est.decoder, seq, torch.bfloat16,
                       "int8 batched", plain_once=True)]
    for c in rec["kernels"]:
        print(json.dumps({k: c[k] for k in ("case", "B", "agree", "ok",
                                            "ms") if k in c}), flush=True)
    if not all(c["ok"] for c in rec["kernels"]):
        raise SystemExit(f"int8: K1 or K2 disagrees with its plain version: "
                         f"{rec['kernels']}")
    # The evaluator against the JAX package's int8 runs on the CPU: its
    # default run and its runs with the normalization statistics summed in
    # another float32 order (``variants``), each as valid a reference.
    golden = json.loads(JAX_EVAL_INT8.read_text())
    references = {"default": golden["runs"]} | {
        v: d["runs"] for v, d in golden.get("variants", {}).items()}
    q_ov = {"max_length": MAX_LENGTH, "quant": "int8"}
    runs = {
        "real_greedy": lambda: eval_run.evaluate_real(
            MODELS, REAL_DATA, se_overrides=q_ov,
            bin_overrides={"quant": "int8"}, device=dev),
        "mixed_greedy": lambda: eval_run.evaluate_full(
            MODELS, n=EVAL_MIXED_N, seed=0, style="mixed", se_overrides=q_ov,
            bin_overrides={"quant": "int8"}, device=dev)}
    for mod in counters.values():
        mod.launch_count = 0
    rec["eval"] = {name: eval_against(name, fn, references)
                   for name, fn in runs.items()}
    misses = [m for r in rec["eval"].values() if not r["within"]
              for ms in r["misses"].values() for m in ms]
    rec["eval"]["launches"] = {name: mod.launch_count
                               for name, mod in counters.items()}
    if misses:
        raise SystemExit("int8 eval against the JAX CPU reference: "
                         + "; ".join(misses))
    return rec


def two_stage_phase(cli, read_png, imgs, main_out, counters, runs: dict,
                    batch_rec: dict) -> dict:
    """Phase 17: ``--two-stage`` (see the module docstring). ``runs`` maps
    "none" and "int8" to their (binarizer, estimator) pair."""
    from stroke_derenderer_tpu_torch.native import cc_native, resize_native
    from stroke_derenderer_tpu_torch.parallel import TwoStagePipeline
    from stroke_derenderer_tpu_torch.parallel import two_stage

    chunk = TWO_STAGE_CHUNK
    n_chunks = -(-len(imgs) // chunk)

    def two_stage_runner(imgs_, b, e, out):
        return cli.run_two_stage(imgs_, b, e, out, chunk_size=chunk)

    def chunks_runner(imgs_, b, e, out):
        return sum(cli.run_batched(imgs_[c:c + chunk], b, e, out)
                   for c in range(0, len(imgs_), chunk))

    def per_image_runner(imgs_, b, e, out):
        out_dir = Path(out)
        masks, strokes = TwoStagePipeline(b, e).process(
            [img for img, _ in imgs_])
        for (img, name), mask, s in zip(imgs_, masks, strokes):
            cli._save_mask(out_dir, name, mask)
            cli._save_strokes(out_dir, name, img, s,
                              img.shape[0] / mask.shape[0], False)
        return len(imgs_)

    @contextlib.contextmanager
    def stage_clock(b, e):
        """Host seconds inside each stage's calls (each ends in a
        download, so on the card it waits for its kernels) and the wall
        seconds of ``process_batched``."""
        spent = {"a": 0.0, "b": 0.0, "wall": 0.0}
        real = (b.binarize_images, e.process_images,
                two_stage.TwoStagePipeline.process_batched)

        def timed(key, fn):
            def call(*args, **kwargs):
                t = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    spent[key] += time.perf_counter() - t
            return call

        b.binarize_images = timed("a", real[0])
        e.process_images = timed("b", real[1])
        two_stage.TwoStagePipeline.process_batched = timed("wall", real[2])
        try:
            yield spent
        finally:
            del b.binarize_images, e.process_images
            two_stage.TwoStagePipeline.process_batched = real[2]

    rec: dict = {"chunk": chunk, "chunks": n_chunks}
    for quant, (b, e) in runs.items():
        bar = MASK_AGREE if quant == "none" else INT8_AGREE
        calls = (resize_native.call_count, cc_native.call_count)
        with stage_clock(b, e) as two:
            r, two_out = drive_cli(cli, read_png, imgs, b, e, counters,
                                   two_stage_runner, mask_agree=bar)
        # Resize and CC through the native libraries (no GIL held).
        r["native_calls"] = {
            "resize": resize_native.call_count - calls[0],
            "cc": cc_native.call_count - calls[1]}
        with stage_clock(b, e) as seq:
            r_seq, seq_out = drive_cli(cli, read_png, imgs, b, e, counters,
                                       chunks_runner, mask_agree=bar)
        r["against_sequential_chunks"] = against_per_image(two_out, seq_out)
        r["stage_s"] = {"a": two["a"], "b": two["b"], "wall": two["wall"]}
        r["overlap"] = ((two["a"] + two["b"] - two["wall"])
                        / min(two["a"], two["b"]))
        r["s_per_image"] = {
            "two_stage": two["wall"] / len(imgs),
            "sequential_chunks": (seq["a"] + seq["b"]) / len(imgs),
            "batch": batch_rec["binarize_s_per_image"]
            + batch_rec["strokes_s_per_image"]}
        r["sequential_launches"] = r_seq["launches"]
        rec[quant] = r
        print(json.dumps({"two_stage": quant} | {k: r[k] for k in (
            "launches", "against_sequential_chunks", "stage_s", "overlap",
            "s_per_image", "native_calls")}), flush=True)
        same = r["against_sequential_chunks"]
        if (r["launches"] != {"K1": n_chunks, "K2": 0, "K3": 0}
                or same["differing_px"] or same["strokes_identical"]
                != len(imgs) or not all(r["native_calls"].values())):
            raise SystemExit(f"two-stage ({quant}): {r}")
    b, e = runs["none"]
    rec["per_image"], pi_out = drive_cli(cli, read_png, imgs, b, e, counters,
                                         per_image_runner)
    rec["per_image"]["against_per_image"] = against_per_image(pi_out,
                                                              main_out)
    same = rec["per_image"]["against_per_image"]
    if same["differing_px"] or same["strokes_identical"] != len(imgs):
        raise SystemExit(f"two-stage per image: {rec['per_image']}")
    return rec


def profile_phase(imgs, binarizer, estimator, counters, dev, smi: str,
                  main_out: dict) -> dict:
    """Phase 18: the port's ``utils/profiling`` and ``utils/flops`` and its
    native host ops on the main path (see the module docstring)."""
    import dataclasses

    import numpy as np
    import torch

    from stroke_derenderer_tpu_torch.kernels import fused_decode as fd
    from stroke_derenderer_tpu_torch.models.encoder import encode_postprocess
    from stroke_derenderer_tpu_torch.native import cc_native, resize_native
    from stroke_derenderer_tpu_torch.ops import connected, resize
    from stroke_derenderer_tpu_torch.utils import profiling
    from stroke_derenderer_tpu_torch.utils.flops import bench_flops_per_image

    images = [img for img, _ in imgs]
    main_masks = [main_out[name][0] for _, name in imgs]
    n = len(images)
    with_glyphs = sum(bool(m.any()) for m in main_masks)
    thr = 255 * binarizer.config.bin_thr
    rec: dict = {"images": n, "card": smi}

    # (a) native against the plain versions on every image.
    def clock(fn):
        t = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t

    height = binarizer.config.height
    spent = {"resize": {"native": 0.0, "numpy": 0.0},
             "cc": {"native": 0.0, "scipy": 0.0}}
    calls = (resize_native.call_count, cc_native.call_count)
    for img, mask, (_, name) in zip(images, main_masks, imgs):
        a, ta = clock(lambda: resize.resize_to_height_np(img, height))
        b, tb = clock(lambda: resize.resize_to_height_np(img, height,
                                                         backend="numpy"))
        if a.shape != b.shape or not np.array_equal(a, b):
            raise SystemExit(f"native resize differs from numpy on {name}")
        a, tc = clock(lambda: connected.connected_components_with_boxes(
            mask, with_area=True))
        b, td = clock(lambda: connected.connected_components_with_boxes(
            mask, with_area=True, backend="scipy"))
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            raise SystemExit(f"native CC differs from scipy on {name}")
        spent["resize"]["native"] += ta
        spent["resize"]["numpy"] += tb
        spent["cc"]["native"] += tc
        spent["cc"]["scipy"] += td
    if (resize_native.call_count - calls[0],
            cc_native.call_count - calls[1]) != (n, n):
        raise SystemExit("the native libraries were not called once per "
                         "image")
    rec["native_ms_per_image"] = {
        op: {backend: 1e3 * t / n for backend, t in d.items()}
        for op, d in spent.items()}
    print(json.dumps({"profile_native_ms_per_image":
                      rec["native_ms_per_image"], "card": smi}), flush=True)

    # (b), (c): the ledger per stage and image, per image and batched, the
    # group-id image packed and dense, each stage's host seconds.
    timer = profiling.StageTimer()
    ledger = profiling.LEDGER
    launches: dict = {}

    def counted(key, fn):
        for mod in counters.values():
            mod.launch_count = 0
        out = fn()
        launches[key] = {k: m.launch_count for k, m in counters.items()}
        return out

    def binarize(path, tag=""):
        with timer(f"binarize{tag}"):
            if path == "per_image":
                return [binarizer.binarize_image(img)[:, :, 0] > thr
                        for img in images]
            return [b[:, :, 0] > thr for b in binarizer.binarize_images(
                images)]

    def strokes(path, masks, tag=""):
        with timer(f"strokes{tag}"):
            if path == "per_image":
                return [estimator.process_image(m) for m in masks]
            return estimator.process_images(masks)

    def per_stage(path, tag, key):
        s0 = ledger.snapshot()
        masks = binarize(path, tag)
        s1 = ledger.snapshot()
        out = counted(key, lambda: strokes(path, masks, tag))
        return {"binarize": tuple(a - b for a, b in zip(s1, s0)),
                "strokes": ledger.delta(s1)}, out

    config = estimator.config
    ledgers, outputs = {}, {}
    for gid in ("packed", "dense"):
        estimator.config = dataclasses.replace(config,
                                               gid_rle=gid == "packed")
        try:
            for path in ("per_image", "batch"):
                tag = ("" if path == "per_image" else "_batch") + (
                    "" if gid == "packed" else "_dense")
                led, outputs[path, gid] = per_stage(path, tag,
                                                    f"{path}_{gid}")
                ledgers[f"{path}_{gid}"] = {
                    stage: {"up_bytes": v[0] / n, "down_bytes": v[1] / n,
                            "up_events": v[2] / n, "down_events": v[3] / n}
                    for stage, v in led.items()}
        finally:
            estimator.config = config
    for path in ("per_image", "batch"):
        packed = ledgers[f"{path}_packed"]["strokes"]["up_bytes"]
        dense = ledgers[f"{path}_dense"]["strokes"]["up_bytes"]
        if not packed < dense:
            raise SystemExit(f"profile {path}: the packed group-id upload "
                             f"({packed} B/image) is not below the dense "
                             f"one ({dense})")
    rec["ledger_per_image"] = ledgers
    # Packing is lossless: the images whose strokes are the dense run's.
    rec["packed_strokes_as_dense"] = {
        path: sum(_same_strokes(a, b) for a, b in zip(
            outputs[path, "packed"], outputs[path, "dense"]))
        for path in ("per_image", "batch")}
    print(json.dumps({"profile_ledger_per_image": ledgers, "card": smi}),
          flush=True)
    print(timer.summary(), flush=True)
    rec["timer"] = timer.as_dict()

    # (d) the card's busy time under device_trace: one trace per stage,
    # per image and batched.
    busy = {}
    with tempfile.TemporaryDirectory() as traces:
        for path in ("per_image", "batch"):
            tag = ("" if path == "per_image" else "_batch") + "_traced"
            masks = None
            for stage in ("binarize", "strokes"):
                d = Path(traces) / f"{path}_{stage}"
                with profiling.device_trace(d, dev):
                    t = time.perf_counter()
                    if stage == "binarize":
                        masks = binarize(path, tag)
                    else:
                        counted(f"{path}_traced",
                                lambda: strokes(path, masks, tag))
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t
                ms = profiling.chip_busy_ms(d)
                if dev.type == "cuda" and ms is None:
                    raise SystemExit(f"profile: the {path} {stage} trace "
                                     "holds no CUDA kernel event")
                busy[f"{path}_{stage}"] = {
                    "busy_ms": ms, "wall_ms": 1e3 * wall,
                    "busy_share": None if ms is None else ms / (1e3 * wall),
                    "trace_bytes": sum(f.stat().st_size
                                       for f in d.iterdir())}
    rec["busy"] = busy
    print(json.dumps({"profile_busy": busy, "card": smi}), flush=True)

    # K1: once per image with glyphs per image, once per batch.
    for key, got in launches.items():
        want = with_glyphs if key.startswith("per_image") else 1
        if got != {"K1": want, "K2": 0, "K3": 0}:
            raise SystemExit(f"profile {key}: launches {got}, K1 should "
                             f"launch {want} times")
    rec["launches"] = launches

    # (e) FLOPs per image at these models' widths (decode_steps = the
    # length limit, the most a row can decode), and the share of the bf16
    # peak that each stage's untraced host seconds per image imply.
    fl = bench_flops_per_image(images, MAX_LENGTH, binarizer.config,
                               estimator.config)
    fl["bf16_peak_share"] = {
        f"{stage}{tag}": fl[f"{stage}_flops_per_image"]
        / (timer.totals[f"{stage}{tag}"] / n) / PEAK_FLOPS["bfloat16"]
        for stage in ("binarize", "strokes") for tag in ("", "_batch")}
    rec["flops"] = fl
    print(json.dumps({"profile_flops": fl, "card": smi}), flush=True)

    # (f) K1 on these images' glyph rows in one batch against its plain
    # version (these launches are not counted above).
    with torch.inference_mode():
        crops, _, _, _ = estimator._gather_batch(main_masks)
        seq = encode_postprocess(
            estimator.encoder(estimator._normalize_raw(crops)),
            estimator.config.encode_image_size)
        rec["k1"] = compare_k1(fd, estimator.decoder, seq, torch.bfloat16,
                               "profile batch")
    print(json.dumps({k: rec["k1"][k] for k in (
        "case", "dtype", "B", "agree", "rows_identical", "ok", "ms",
        "plain_ms")}), flush=True)
    if not rec["k1"]["ok"]:
        raise SystemExit(f"profile: K1 disagrees with its plain version: "
                         f"{rec['k1']}")
    return rec


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _mesh_run(cli, mesh, imgs, bin_ov=None, se_ov=None, masks=None,
              strokes: bool = True) -> dict:
    """One run of ``binarize_images`` (unless ``masks`` are given) and
    ``process_images`` over ``mesh`` (None: one device), with K1's and
    K2's ``launch_count`` set to 0 just before and read just after, each
    stage's host seconds (each ends in a download) and the tokens every
    ``process_tokens`` call saw."""
    import numpy as np

    from stroke_derenderer_tpu_torch.kernels import fused_beam as fb
    from stroke_derenderer_tpu_torch.kernels import fused_decode as fd
    b, e = cli.initialize_sessions(
        MODELS, device="cuda" if mesh is None else None, mesh=mesh,
        bin_overrides=bin_ov, se_overrides={"max_length": MAX_LENGTH}
        | (se_ov or {}))
    tokens = []
    real = e.process_tokens
    e.process_tokens = lambda t, p: (
        tokens.append(np.asarray(t)[:len(p)].copy()), real(t, p))[1]
    rec = {}
    fd.launch_count = fb.launch_count = 0
    t0 = time.perf_counter()
    if masks is None:
        masks = [x[:, :, 0] > 127 for x in b.binarize_images(imgs)]
        _sync(b.device)
        rec["binarize_s"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    rec["strokes"] = e.process_images(masks) if strokes else None
    _sync(e.device)
    rec["strokes_s"] = time.perf_counter() - t1
    rec["launches"] = {"K1": fd.launch_count, "K2": fb.launch_count}
    rec["masks"], rec["tokens"] = masks, tokens
    return rec


def _mesh_train(dev, out_dir, mesh=None,
                steps: int = MESH_TRAIN_STEPS) -> dict:
    """``steps`` steps of train_binarizer and train_captioner into
    ``out_dir`` over ``mesh`` (None: one device), one loader worker so
    that the global batches are the same -> {model: (start step,
    losses)}."""
    from stroke_derenderer_tpu_torch.config import (
        BinarizerConfig, StrokesConfig,
    )
    from stroke_derenderer_tpu_torch.train import loop
    kw = dict(steps=steps, batch_size=MESH_TRAIN_BATCH, out_dir=out_dir,
              lr=MESH_TRAIN_LR, seed=0, mesh=mesh, device=dev,
              num_workers=1, ckpt_every=MESH_TRAIN_STEPS)
    res = {"binarizer": loop.train_binarizer(
               BinarizerConfig(**MESH_TRAIN_BIN), **kw),
           "captioner": loop.train_captioner(
               StrokesConfig(**MESH_TRAIN_SE), seq_len=MESH_TRAIN_SEQ,
               **kw)}
    return {k: (r.start_step, r.losses) for k, r in res.items()}


# The settings a rank of phase 19 takes from the script that spawned it.
MESH_SETTINGS = ("MAX_LENGTH", "BEAM", "TWO_STAGE_CHUNK", "MODELS",
                 "MESH_TRAIN_BIN", "MESH_TRAIN_SE", "MESH_TRAIN_STEPS",
                 "MESH_TRAIN_BATCH", "MESH_TRAIN_SEQ", "MESH_TRAIN_LR")


def _train_argv(out_dir) -> list:
    """``train.loop``'s flags for MESH_TRAIN_STEPS steps of both models at
    MESH_TRAIN_BIN's and MESH_TRAIN_SE's widths, in the compute dtype of
    the shipped configs, on this rank's card or the CPU."""
    from stroke_derenderer_tpu_torch.parallel import multihost
    argv = ["--model", "both", "--steps", str(MESH_TRAIN_STEPS), "--batch",
            str(MESH_TRAIN_BATCH), "--seq-len", str(MESH_TRAIN_SEQ),
            "--bin-features", ",".join(map(str, MESH_TRAIN_BIN["features"])),
            "--encoder-arch", MESH_TRAIN_SE["encoder_arch"], "--device",
            multihost.device().type, "--out", str(out_dir)]
    if "embed_dim" in MESH_TRAIN_SE:
        argv += ["--se-dims", ",".join(str(MESH_TRAIN_SE[k]) for k in (
            "embed_dim", "attention_dim", "decoder_dim"))]
    return argv


def mesh_rank(paths, setup, train_dir, full: bool, settings: dict) -> dict:
    """One rank of phase 19 (run by ``multihost.spawn``): the runs over a
    (2, 1) mesh (greedy bf16 and float32, beam, int8, two-stage), the
    binarizer over a (1, 2) mesh and, with ``full``, the trainer. Rank 0
    returns the outputs; every rank its launches and seconds.
    ``settings``: the spawning script's values of ``MESH_SETTINGS``;
    ``setup``: (module, function) to call first, or None."""
    import importlib

    import torch.distributed as dist

    globals().update(settings)
    if setup:
        getattr(importlib.import_module(setup[0]), setup[1])()
    from stroke_derenderer_tpu_torch import cli
    from stroke_derenderer_tpu_torch.kernels import fused_decode as fd
    from stroke_derenderer_tpu_torch.parallel import TwoStagePipeline
    from stroke_derenderer_tpu_torch.parallel.mesh import make_mesh
    imgs = [img for img, _ in cli.load_images(paths)]
    dp2, tp2 = make_mesh(2), make_mesh(2, dp=1, tp=2)
    out = {"rank": dp2.rank, "device": str(dp2.device),
           "backend": dist.get_backend(), "runs": {}}
    runs = out["runs"]
    # On a card a first run loads the rank's kernels and cuDNN's; the
    # second is kept.
    if dp2.device.type == "cuda":
        _mesh_run(cli, dp2, imgs)
    runs["greedy"] = _mesh_run(cli, dp2, imgs)
    if full:
        runs["greedy_f32"] = _mesh_run(cli, dp2, imgs, F32, F32)
        runs["beam"] = _mesh_run(cli, dp2, imgs, se_ov={
            "decode": "beam", "beam_size": BEAM},
            masks=runs["greedy"]["masks"])
        runs["tp"] = _mesh_run(cli, tp2, imgs, strokes=False)
        out["decode_check"] = _mesh_decode_check(cli, dp2, imgs)
        runs["int8"] = _mesh_run(cli, dp2, imgs, {"quant": "int8"},
                                 {"quant": "int8"})
        b, e = cli.initialize_sessions(MODELS, mesh=dp2, se_overrides={
            "max_length": MAX_LENGTH})
        pipe = TwoStagePipeline(b, e)
        fd.launch_count = 0
        t0 = time.perf_counter()
        masks, strokes = pipe.process_batched(imgs,
                                              chunk_size=TWO_STAGE_CHUNK)
        runs["two_stage"] = {"masks": masks, "strokes": strokes,
                             "wall_s": time.perf_counter() - t0,
                             "launches": {"K1": fd.launch_count, "K2": 0},
                             "stage": "a" if pipe._in_a else "b"}
        out["train"] = _mesh_train(None, train_dir, make_mesh(2))
        out["train_tp"] = _mesh_train(None, train_dir + "_tp",
                                      make_mesh(2, dp=1, tp=2))
        # The trainer's flags in this group: --mesh 2 (the ranks spawned
        # here stand for the ones the flag spawns) and --distributed; the
        # losses and a digest of each model the run exported.
        from stroke_derenderer_tpu_torch.train import loop
        out["train_flags"] = {}
        for flag in ("--mesh", "--distributed"):
            res = loop.train(_train_argv(train_dir + "_" + flag.strip("-"))
                             + [flag] + (["2"] if flag == "--mesh" else []),
                             1)
            out["train_flags"][flag] = {
                k: {"losses": r.losses, "params": _digest(r.exported)}
                for k, r in res.items()}
    if dp2.rank != 0:  # the outputs are rank 0's; every rank has them
        for rec in runs.values():
            for key in ("masks", "strokes", "tokens"):
                rec.pop(key, None)
    return out


def _mesh_decode_check(cli, mesh, imgs) -> dict:
    """K1 and K2 through the dp mesh in bfloat16 against their plain
    versions: every rank builds the same glyph rows of ``imgs``, decodes its
    dp share in one launch of each (``fused_greedy_decode_sharded``,
    ``fused_beam_decode_sharded`` at ``BEAM``), and the gathered tokens of
    all the rows are held to the plain versions' on all of them."""
    import torch
    from stroke_derenderer_tpu_torch.config import PAD
    from stroke_derenderer_tpu_torch.kernels import fused_beam as fb
    from stroke_derenderer_tpu_torch.kernels import fused_decode as fd
    from stroke_derenderer_tpu_torch.models.encoder import encode_postprocess
    b, e = cli.initialize_sessions(MODELS, device=mesh.device,
                                   se_overrides={"max_length": MAX_LENGTH})
    dec = e.decoder
    with torch.inference_mode():
        masks = [m[:, :, 0] > 127 for m in b.binarize_images(imgs)]
        seq = encode_postprocess(
            e.encoder(e._normalize_raw(e._gather_batch(masks)[0])),
            e.config.encode_image_size).to(torch.bfloat16).contiguous()
        n, dp = seq.shape[0], mesh.shape["dp"]
        batch = -(-n // dp) * dp
        local = seq[mesh.rows(batch)]
        k1 = fd.fused_greedy_decode_sharded(dec, local, MAX_LENGTH, mesh,
                                            batch)[:n]
        k2 = fb.fused_beam_decode_sharded(dec, local, MAX_LENGTH, mesh,
                                          batch, BEAM)[:n]
        ep = dec.project_encoding(seq).contiguous()
        h0, c0 = (t.contiguous() for t in dec.init_state(seq))
        w = dec.weights(torch.bfloat16)
        ref1 = fd.fused_greedy_decode_plain(seq, ep, h0, c0, w, MAX_LENGTH)
        ref2 = fb.select_beam(*fb.fused_beam_decode_plain(
            seq, ep, h0, c0, w, MAX_LENGTH, BEAM))
    decoded = (k2 != PAD) | (ref2 != PAD)
    return {"rows": n, "k1_agree": float((k1 == ref1).float().mean()),
            "k1_rows_identical": int((k1 == ref1).all(1).sum()),
            "k2_agree": float((k2 == ref2)[decoded].double().mean()),
            "k2_rows_identical": int((k2 == ref2).all(1).sum())}


def _digest(tensors: dict) -> str:
    """sha256 of a dict of tensors, in name order."""
    h = hashlib.sha256()
    for n in sorted(tensors):
        h.update(n.encode())
        h.update(tensors[n].detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def _all_reduce_one() -> float:
    """A rank's all-reduce of a one on its card (phase 19's NCCL probe)."""
    import torch
    import torch.distributed as dist
    t = torch.ones(1, device="cuda")
    dist.all_reduce(t)
    return float(t)


def _golden_chamfer(imgs, names, masks, strokes) -> float:
    from stroke_derenderer_tpu_torch.ops.strokes import strokes_to_json
    i = names.index("golden_input")
    got = strokes_to_json(strokes[i], scale=imgs[i].shape[0]
                          / masks[i].shape[0])
    return chamfer(got, json.loads(
        (GOLDEN / "expected_STROKES.json").read_text()))


def _same_strokes(a, b) -> bool:
    import numpy as np
    return len(a) == len(b) and all(
        np.array_equal(xa, xb) and np.array_equal(ya, yb)
        for (xa, ya), (xb, yb) in zip(a, b))


def mesh_phase(cli, paths, imgs, batch_out, q_binarizer, binarizer,
               estimator, dev) -> dict:
    """Phase 19: the port's mesh (``parallel/``; see the module
    docstring). ``paths`` are the files of ``imgs``."""
    import numpy as np
    import torch

    from stroke_derenderer_tpu_torch.parallel import multihost
    from stroke_derenderer_tpu_torch.weights import read_msgpack
    if str(ROOT) not in sys.path:  # the ranks import this script
        sys.path.insert(0, str(ROOT))
    imgs, paths = imgs[:MESH_INPUTS], [str(p) for p in paths[:MESH_INPUTS]]
    names = [n for _, n in imgs]
    raw = [img for img, _ in imgs]
    work = Path(tempfile.mkdtemp(prefix="mesh_", dir=tempfile.gettempdir()))
    rec = {"devices": list(MESH_DEVICES), "images": len(imgs)}
    # Why two ranks share a card over gloo: NCCL's answer to two ranks on
    # one device.
    if MESH_DEVICES[0].startswith("cuda"):
        try:
            multihost.spawn(_all_reduce_one, 2, ["cuda:0", "cuda:0"],
                            backend="nccl", timeout_s=120.0, threads=None)
            rec["nccl_two_ranks_one_card"] = "accepted"
        except (RuntimeError, TimeoutError) as exc:
            lines = [x for x in str(exc).splitlines() if x.strip()]
            rec["nccl_two_ranks_one_card"] = lines[-1][:300]
        print(json.dumps({"nccl_two_ranks_one_card": rec[
            "nccl_two_ranks_one_card"]}), flush=True)
    # The single-rank references on this card, each beside its mesh run
    # (the greedy one timed on a second run, as the ranks' are).
    if dev.type == "cuda":
        _mesh_run(cli, None, raw)
    single = {"greedy": _mesh_run(cli, None, raw),
              "greedy_f32": _mesh_run(cli, None, raw, F32, F32)}
    t0 = time.monotonic()
    settings = {k: globals()[k] for k in MESH_SETTINGS}
    # CPU ranks (a rehearsal) take two threads each; a card's keep torch's.
    threads = None if MESH_DEVICES[0].startswith("cuda") else 2
    ranks = multihost.spawn(mesh_rank, 2, list(MESH_DEVICES), args=(
        paths, MESH_RANK_SETUP, str(work / "train_mesh"), True, settings),
        timeout_s=MESH_TIMEOUT_S, threads=threads)
    rec["spawn_s"] = time.monotonic() - t0
    # The group's backend, as multihost.initialize chose it from every
    # rank's host and device.
    rec["backend"] = sorted({r["backend"] for r in ranks})
    if rec["backend"] != [multihost.backend_for(MESH_DEVICES)]:
        raise SystemExit(f"mesh: the ranks' backend {rec['backend']} on "
                         f"{MESH_DEVICES}")
    rec["backend"] = rec["backend"][0]
    got = ranks[0]["runs"]
    # K1 and K2 sharded over dp against their plain versions (bf16).
    rec["decode_check"] = [r["decode_check"] for r in ranks]
    if not all(c["k1_agree"] >= BF16_AGREE and c["k2_agree"] >= BF16_AGREE
               for c in rec["decode_check"]):
        raise SystemExit(f"mesh: K1 or K2 sharded over dp disagrees with "
                         f"its plain version: {rec['decode_check']}")
    by_name = lambda masks: dict(zip(names, masks))
    batched = {n: batch_out[n][0] for n in names}
    # Launches: one K1 (K2 for beam) per rank per batch; the two-stage run
    # decodes on stage B's rank, one K1 per chunk.
    rec["launches"] = {run: [r["runs"][run]["launches"] for r in ranks]
                       for run in got}
    chunks = -(-len(imgs) // TWO_STAGE_CHUNK)
    want_launch = {"greedy": {"K1": 1, "K2": 0},
                   "greedy_f32": {"K1": 1, "K2": 0},
                   "beam": {"K1": 0, "K2": 1}, "int8": {"K1": 1, "K2": 0},
                   "tp": {"K1": 0, "K2": 0}}
    for run, want in want_launch.items():
        if rec["launches"][run] != [want, want]:
            raise SystemExit(f"mesh {run}: launches {rec['launches'][run]}"
                             f", expected {want} on each rank")
    stage_b = [r["runs"]["two_stage"]["launches"]["K1"] for r in ranks
               if r["runs"]["two_stage"]["stage"] == "b"]
    if stage_b != [chunks]:
        raise SystemExit(f"mesh two-stage: stage B launched K1 {stage_b} "
                         f"times for {chunks} chunks")
    # float32: the single rank's tokens and masks.
    f32_tok = [np.array_equal(a, b) for a, b in zip(
        got["greedy_f32"]["tokens"], single["greedy_f32"]["tokens"])]
    rec["float32"] = {
        "token_rows": int(sum(len(t) for t in got["greedy_f32"]["tokens"])),
        "images_tokens_identical": int(sum(f32_tok)),
        "masks": mask_diff(by_name(got["greedy_f32"]["masks"]),
                           by_name(single["greedy_f32"]["masks"]))}
    # bf16: the batched path's bars against the single-rank batched run.
    for run in ("greedy", "tp", "int8"):
        ref = (batched if run != "int8" else by_name(
            [m[:, :, 0] > 127 for m in q_binarizer.binarize_images(raw)]))
        rec[run] = {"masks": mask_diff(by_name(got[run]["masks"]), ref)}
    for run in ("greedy", "beam"):
        rec.setdefault(run, {})["golden_strokes_chamfer_px"] = (
            _golden_chamfer(raw, names, got[run]["masks"],
                            got[run]["strokes"]))
    # Two-stage: the sequential chunks on the same sub-meshes (one rank
    # each, so one device).
    seq_m, seq_s = [], []
    for c in range(0, len(raw), TWO_STAGE_CHUNK):
        ms = [m[:, :, 0] > 127 for m in binarizer.binarize_images(
            raw[c:c + TWO_STAGE_CHUNK])]
        seq_m += ms
        seq_s += estimator.process_images(ms)
    two = got["two_stage"]
    rec["two_stage"] = {
        "masks": mask_diff(by_name(two["masks"]), by_name(seq_m)),
        "strokes_identical": sum(_same_strokes(a, b) for a, b in zip(
            two["strokes"], seq_s)), "wall_s": two["wall_s"]}
    bad = [f"{run} masks {rec[run]['masks']}" for run in (
        "greedy", "tp", "int8") if rec[run]["masks"]["agree"]
        < BATCH_MASK_AGREE]
    bad += [f"{run} golden strokes {rec[run]['golden_strokes_chamfer_px']}"
            " px" for run in ("greedy", "beam")
            if rec[run]["golden_strokes_chamfer_px"] > STROKES_CHAMFER_PX]
    if (rec["float32"]["images_tokens_identical"] != len(f32_tok)
            or rec["float32"]["masks"]["differing_px"]):
        bad.append(f"float32 against one rank: {rec['float32']}")
    if (rec["two_stage"]["masks"]["differing_px"]
            or rec["two_stage"]["strokes_identical"] != len(imgs)):
        bad.append(f"two-stage against the chunks: {rec['two_stage']}")
    if bad:
        raise SystemExit("mesh: " + "; ".join(bad))
    # Throughput: dp = 2 on one card against dp = 1 (no scaling figure).
    t_mesh = max(r["runs"]["greedy"]["binarize_s"]
                 + r["runs"]["greedy"]["strokes_s"] for r in ranks)
    t_one = single["greedy"]["binarize_s"] + single["greedy"]["strokes_s"]
    rec["img_per_s"] = {"dp2": len(imgs) / t_mesh, "dp1": len(imgs) / t_one,
                        "note": "two ranks on one card: no scaling figure"
                        if len(set(MESH_DEVICES)) == 1 else "two cards"}
    stages = ("binarize_s", "strokes_s")
    rec["stage_s"] = {
        "dp1": {k: single["greedy"][k] for k in stages},
        "dp2": [{k: r["runs"]["greedy"][k] for k in stages} for r in ranks]}
    if torch.cuda.device_count() >= 2 and all(
            d.startswith("cuda") for d in MESH_DEVICES):
        t0 = time.monotonic()
        nccl = multihost.spawn(mesh_rank, 2, ["cuda:0", "cuda:1"], args=(
            paths, MESH_RANK_SETUP, None, False, settings),
            timeout_s=MESH_TIMEOUT_S, threads=None)
        run = nccl[0]["runs"]["greedy"]
        rec["nccl"] = {
            "devices": ["cuda:0", "cuda:1"], "spawn_s": time.monotonic() - t0,
            "backend": sorted({r["backend"] for r in nccl}),
            "launches": [r["runs"]["greedy"]["launches"] for r in nccl],
            "masks": mask_diff(by_name(run["masks"]), batched),
            "img_per_s": len(imgs) / max(
                r["runs"]["greedy"]["binarize_s"]
                + r["runs"]["greedy"]["strokes_s"] for r in nccl)}
        if rec["nccl"]["masks"]["agree"] < BATCH_MASK_AGREE or rec[
                "nccl"]["launches"] != [{"K1": 1, "K2": 0}] * 2 or rec[
                "nccl"]["backend"] != ["nccl"]:
            raise SystemExit(f"mesh over two cards: {rec['nccl']}")
    # The trainer: float32 losses and parameters against one rank's run
    # over the same global batches; rank 0's checkpoint resumes on one
    # device.
    one = _mesh_train(dev, str(work / "train_one"))
    rec["train"] = {"single_losses": {k: v[1] for k, v in one.items()}}
    for run, sub in (("train", "train_mesh"), ("train_tp", "train_mesh_tp")):
        losses = {k: v[1] for k, v in ranks[0][run].items()}
        rec["train"][f"{run}_losses"] = losses
        for part, (_, want) in one.items():
            if len(want) != MESH_TRAIN_STEPS or any(
                    abs(a - b) > MESH_TRAIN_LOSS_TOL
                    for a, b in zip(losses[part], want)):
                raise SystemExit(f"mesh {run} {part}: losses "
                                 f"{losses[part]} against one rank's {want}")
        worst = 0.0
        for f in ("binarizer.msgpack", "strokes_encoder.msgpack",
                  "strokes_decoder.msgpack"):
            a = dict(_leaves(read_msgpack(work / sub / f)))
            b = dict(_leaves(read_msgpack(work / "train_one" / f)))
            for k in b:
                worst = max(worst, float(np.abs(
                    np.asarray(a[k], np.float64) - np.asarray(b[k])).max()))
        rec["train"][f"{run}_param_max_abs_diff"] = worst
        if worst > 2 * MESH_TRAIN_LR:
            raise SystemExit(f"mesh {run}: parameters {worst} apart, more "
                             f"than 2 lr")
    # Both ranks of each flag's run report the same losses and hold the
    # same model afterwards (the same start and the same updates).
    flags = [r["train_flags"] for r in ranks]
    rec["train"]["flags"] = flags[0]
    if flags[0] != flags[1] or not all(
            len(v["losses"]) == MESH_TRAIN_STEPS
            and all(np.isfinite(v["losses"]))
            for f in flags[0].values() for v in f.values()):
        raise SystemExit(f"mesh: the trainer's --mesh 2 and --distributed "
                         f"runs: {flags}")
    resumed = _mesh_train(dev, str(work / "train_mesh"),
                          steps=MESH_TRAIN_STEPS + 1)
    rec["train"]["resumed_from"] = {k: v[0] for k, v in resumed.items()}
    if set(rec["train"]["resumed_from"].values()) != {MESH_TRAIN_STEPS}:
        raise SystemExit(f"mesh train: rank 0's checkpoints resumed at "
                         f"{rec['train']['resumed_from']}")
    # The CLI's --mesh 2 on the golden image.
    cli_in = work / "cli_in"
    cli_in.mkdir()
    (cli_in / "golden_input.png").write_bytes(
        (GOLDEN / "golden_input.png").read_bytes())
    captured = io.StringIO()
    with contextlib.redirect_stdout(captured):
        code = cli.entrypoint(["-models", str(MODELS), "-input", str(cli_in),
                               "--output", str(work / "cli"), "--mesh", "2",
                               "--device", str(dev.type)])
    rec["cli"] = {"exit": code,
                  "warned": "[warn] --mesh 2" in captured.getvalue(),
                  "files": len(list((work / "cli").glob("*_STROKES.json"))),
                  "cards": torch.cuda.device_count()}
    if code != 0 or rec["cli"]["files"] != 1:
        raise SystemExit(f"mesh: the CLI's --mesh 2 {rec['cli']}")
    return rec


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path, tree


def phase_closure(phases) -> set:
    """The phases a run takes: ``phases`` (all of ``PHASE_NAMES`` when None)
    and, recursively, the phases whose results they use (``NEEDS``)."""
    todo = set(PHASE_NAMES if phases is None else phases)
    unknown = todo - set(PHASE_NAMES)
    if unknown:
        raise ValueError(f"unknown phases {sorted(unknown)}")
    grown = True
    while grown:
        more = {n for p in todo for n in NEEDS.get(p, ())} - todo
        todo |= more
        grown = bool(more)
    return todo


def main(argv=None, phases=None) -> int:
    """The smoke run. ``phases`` (for the rehearsal's tests, which split the
    phases over two test files; the command line runs all): the phases 3
    to 19 to run, by name, and with them the phases whose results they use;
    the kernel table is printed when phases k1, k2 and k3 ran."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=None,
                        help="also write the full record to this JSON file")
    args = parser.parse_args(argv)
    record: dict = {}

    # 1. device ------------------------------------------------------------
    t0 = time.monotonic()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    import numpy as np

    from stroke_derenderer_tpu_torch import cli, serve
    from stroke_derenderer_tpu_torch.device import resolve_device
    from stroke_derenderer_tpu_torch.io import encode_png, load_image, read_png
    from stroke_derenderer_tpu_torch.kernels import build
    from stroke_derenderer_tpu_torch.kernels import decode_attention as da
    from stroke_derenderer_tpu_torch.kernels import fused_beam as fb
    from stroke_derenderer_tpu_torch.kernels import fused_decode as fd
    from stroke_derenderer_tpu_torch.models.encoder import encode_postprocess
    from stroke_derenderer_tpu_torch.ops.device_partition import (
        PartitionPlan, gather_crops, plan_partitions,
    )
    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    record["device"] = {"nvidia_smi": smi,
                        "name": torch.cuda.get_device_name(0),
                        "torch": torch.__version__,
                        "cuda": torch.version.cuda}
    _phase("device", t0, f"{record['device']['name']} | {smi} | torch "
           f"{torch.__version__} | CUDA {torch.version.cuda}")

    # 2. build -------------------------------------------------------------
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(LIBS)) as pool:
        list(pool.map(lambda name: build.load_library(name, force=True),
                      LIBS))
    record["build"] = {name: dict(build.BUILD_LOG[name], kernels=ptxas_summary(
        build.BUILD_LOG[name]["ptxas"])) for name in LIBS}
    for name in LIBS:
        print(build.BUILD_LOG[name]["ptxas"])
        for k in record["build"][name]["kernels"]:
            print(json.dumps({"lib": name} | k))
    record["sass_mma"] = {name: sass_mma_counts(build, name)
                          for name in ("fused_decode", "fused_beam")}
    print(json.dumps({"hmma_per_kernel": record["sass_mma"]}))
    check_engine_build(record)
    _phase("build", t0, ", ".join(
        f"{name} {build.BUILD_LOG[name]['seconds']:.2f} s" for name in LIBS)
        + f" with {build.find_nvcc()}")

    # Set-up the phases share: the sessions, the glyph sequences of phases
    # 3, 5 and 6, the inputs of phase 4 on.
    todo = phase_closure(phases)
    binarizer, estimator = cli.initialize_sessions(
        MODELS, device=dev, se_overrides={"max_length": MAX_LENGTH})
    _, beam_estimator = cli.initialize_sessions(
        MODELS, device=dev, se_overrides={"decode": "beam",
                                          "beam_size": BEAM,
                                          "max_length": MAX_LENGTH})
    if todo & {"int8", "two_stage", "mesh"}:
        q_bin = {"quant": "int8"}
        q_se = {"max_length": MAX_LENGTH, "quant": "int8"}
        q_binarizer, q_estimator = cli.initialize_sessions(
            MODELS, device=dev, se_overrides=q_se, bin_overrides=q_bin)
        _, q_beam = cli.initialize_sessions(
            MODELS, device=dev, bin_overrides=q_bin,
            se_overrides=q_se | {"decode": "beam", "beam_size": BEAM})
    decoder = estimator.decoder
    counters = {"K1": fd, "K2": fb, "K3": da}
    inputs = [GOLDEN / "golden_input.png"] + sorted(
        p for p in PSEUDO.glob("*.png") if not p.stem.endswith("_BINARIZED"))
    imgs = cli.load_images(inputs)
    if len(imgs) != len(inputs):
        raise SystemExit(f"loaded {len(imgs)} of {len(inputs)} inputs")
    slice_imgs = imgs[:SLICE_INPUTS]
    seqs = {}
    with torch.inference_mode():
        rng = np.random.default_rng(0)
        cases = []
        for b in sorted(set(K1_BATCHES) | set(K3_BATCHES) | {K2_BATCH}):
            crops = torch.from_numpy(synthetic_crops(rng, b)).to(dev).float()
            cases.append((f"synthetic B={b}", crops))
        mask = binarizer.binarize_image(
            load_image(GOLDEN / "golden_input.png"))[:, :, 0] > 127
        plan = plan_partitions(mask, estimator.config.margin,
                               estimator.config.image_size)
        coords = tuple(torch.from_numpy(np.ascontiguousarray(getattr(
            plan, k))).to(dev) for k in PartitionPlan.COORD_KEYS)
        cases.append(("golden", gather_crops(
            torch.from_numpy(plan.gid_img).to(dev), coords)))
        for label, crops in cases:
            seqs[label] = encode_postprocess(
                estimator.encoder(estimator._normalize_raw(crops)),
                estimator.config.encode_image_size)

    # 3. K1 against its plain version ---------------------------------------
    if "k1" in todo:
        t0 = time.monotonic()
        checks = []
        with torch.inference_mode():
            for label in [f"synthetic B={b}" for b in K1_BATCHES] + ["golden"]:
                for dtype in (torch.float32, torch.bfloat16):
                    rec = compare_k1(fd, decoder, seqs[label], dtype, label)
                    checks.append(rec)
                    print(json.dumps({k: rec[k] for k in (
                        "case", "dtype", "B", "agree", "rows_identical", "ok",
                        "ms", "plain_ms", "bound_ms", "stream_bound_ms",
                        "steps_max", "grid", "barriers_per_step", "step_ms")
                        if k in rec}
                        | ({"max_gap": rec["max_gap_at_first_difference"]}
                           if "max_gap_at_first_difference" in rec else {})),
                        flush=True)
        record["k1"] = checks
        bad = [c for c in checks if not c["ok"]]
        if bad:
            raise SystemExit(f"K1 disagrees with its plain version: {bad}")
        with torch.inference_mode():
            golden = pick(checks, "golden", "bfloat16")
            record["barrier"] = barrier_cost(fd, golden["grid"], dev)
            record["k1_breakdown"] = step_breakdown(
                fd, "fused_decode", decoder, seqs["golden"], torch.bfloat16, 1)
        print(json.dumps(record["barrier"]), flush=True)
        print(json.dumps(record["k1_breakdown"]), flush=True)
        check_breakdown(record["k1_breakdown"])
        _phase("k1", t0, f"{len(checks)} comparisons passed (f32 gap < "
               f"{F32_GAP}, bf16 agreement >= {BF16_AGREE})")

    # 4. main path ---------------------------------------------------------
    if "main" in todo:
        t0 = time.monotonic()
        main_rec, main_out = drive_cli(cli, read_png, imgs, binarizer,
                                       estimator,
                                       counters)
        record["main"] = main_rec
        launches = main_rec["launches"]["K1"]
        if launches == 0 or launches != main_rec["images_with_glyphs"]:
            raise SystemExit(f"K1 launched {launches} times on the main path; "
                             f"{main_rec['images_with_glyphs']} images have "
                             f"glyphs")
        _phase("main", t0, f"{len(imgs)} images, {launches} K1 launches, "
               f"golden "
               f"mask agreement {main_rec['golden_mask_agree']:.6f}")

    # 5. K2 against its plain version ---------------------------------------
    if "k2" in todo:
        t0 = time.monotonic()
        k2_checks = []
        with torch.inference_mode():
            for label in ("golden", f"synthetic B={K2_BATCH}"):
                for dtype in (torch.float32, torch.bfloat16):
                    rec = compare_k2(fb, decoder, seqs[label], dtype, label)
                    k2_checks.append(rec)
                    print(json.dumps({k: rec[k] for k in (
                        "case", "dtype", "B", "K", "agree", "images_identical",
                        "ok", "ms", "plain_ms", "bound_ms", "stream_bound_ms",
                        "steps_max", "max_gap_at_first_difference",
                        "score_max_rel_err", "grid", "barriers_per_step",
                        "step_ms") if k in rec}), flush=True)
                rec = compare_beam_of_one(fb, fd, decoder, seqs[label], label)
                k2_checks.append(rec)
                print(json.dumps(rec), flush=True)
            # A beam above the old kernel's limit of 16, on the golden glyphs.
            for dtype in (torch.float32, torch.bfloat16):
                rec = compare_k2(fb, decoder, seqs["golden"], dtype, "golden",
                                 BIG_BEAM)
                k2_checks.append(rec)
                print(json.dumps({k: rec[k] for k in (
                    "case", "dtype", "B", "K", "agree", "images_identical",
                    "ok",
                    "ms", "plain_ms", "max_gap_at_first_difference",
                    "score_max_rel_err", "grid", "step_ms") if k in rec}),
                    flush=True)
        record["k2"] = k2_checks
        bad = [c for c in k2_checks if not c["ok"]]
        if bad:
            raise SystemExit(f"K2 disagrees with its plain version or K1: "
                             f"{bad}")
        with torch.inference_mode():
            record["k2_breakdown"] = step_breakdown(
                fd, "fused_beam", decoder, seqs["golden"], torch.bfloat16,
                BEAM)
        print(json.dumps(record["k2_breakdown"]), flush=True)
        check_breakdown(record["k2_breakdown"])
        _phase("k2", t0, f"{len(k2_checks)} comparisons passed (f32 gap < "
               f"{F32_GAP}, score rtol {SCORE_RTOL}, bf16 agreement >= "
               f"{BF16_AGREE})")

    # 6. K3 against its plain version, and the fused-attention entry -------
    if "k3" in todo:
        t0 = time.monotonic()
        k3_checks = []
        with torch.inference_mode():
            rb, rp = K3_RAGGED
            seqs[f"ragged B={rb} P={rp}"] = seqs[
                f"synthetic B={max(K3_BATCHES)}"][:rb, :rp]
            for label in ([f"synthetic B={b}" for b in K3_BATCHES]
                          + ["golden", f"ragged B={rb} P={rp}"]):
                rec = compare_k3(da, decoder, seqs[label], label)
                k3_checks.append(rec)
                print(json.dumps(rec), flush=True)
            golden = pick(k3_checks, "golden")
            record["cluster_barrier"] = [
                cluster_barrier_cost(
                    da, c, golden["ms_by_cluster"][str(c)]["clusters_on_card"],
                    dev)
                for c in K3_CLUSTERS]
            for rec in record["cluster_barrier"]:
                print(json.dumps(rec), flush=True)
            for dtype in (torch.float32, torch.bfloat16):
                rec = compare_fused_greedy(da, decoder, seqs["golden"], dtype)
                k3_checks.append(rec)
                print(json.dumps(rec), flush=True)
        record["k3"] = k3_checks
        bad = [c for c in k3_checks if not c["ok"]]
        if bad:
            raise SystemExit(f"K3 disagrees with its plain version: {bad}")
        _phase("k3", t0, f"{len(k3_checks)} comparisons passed (atol "
               f"{K3_ATOL} "
               f"+ rtol {K3_RTOL}; entry: K1's bars, one launch per step)")

    # 7. main path with --decode beam ---------------------------------------
    if "main-beam" in todo:
        t0 = time.monotonic()
        beam_rec, beam_out = drive_cli(cli, read_png, imgs, binarizer,
                                       beam_estimator, counters)
        record["main_beam"] = beam_rec
        beam_launches = beam_rec["launches"]["K2"]
        if (beam_launches == 0
                or beam_launches != beam_rec["images_with_glyphs"]
                or beam_rec["launches"]["K1"] != 0):
            raise SystemExit(f"launches on the beam path: "
                             f"{beam_rec['launches']}; "
                             f"{beam_rec['images_with_glyphs']} images have "
                             f"glyphs")
        _phase("main-beam", t0, f"{len(imgs)} images, {beam_launches} K2 "
               f"launches, golden beam strokes chamfer "
               f"{beam_rec['golden_strokes_chamfer_px']:.3f} px")

    # 8. the upstream project's ONNX model directory -------------------------
    if "onnx" in todo:
        t0 = time.monotonic()
        onnx_rec = onnx_phase(cli, read_png, load_image, imgs, main_out,
                              counters, dev)
        record["onnx"] = onnx_rec
        print(json.dumps({k: onnx_rec[k] for k in (
            "export_s", "export_bytes", "import_s", "variant_round_trip_s",
            "variant_binarize", "variant_process_image")}
            | {"per_image": onnx_rec["cli"]["per_image"],
               "golden_strokes_chamfer_px": onnx_rec["cli"][
                   "golden_strokes_chamfer_px"]}), flush=True)
        _phase("onnx", t0, f"models_demo exported in "
               f"{onnx_rec['export_s']:.2f} "
               f"s ({sum(onnx_rec['export_bytes'].values())} bytes) and "
               f"imported "
               f"bit for bit; {onnx_rec['cli']['launches']['K1']} K1 launches "
               f"over {len(imgs)} images, "
               f"{onnx_rec['cli']['per_image']['strokes_identical']} strokes "
               f"files as phase 4's; the variant round trip, binarize and "
               f"{len(onnx_rec['checks'])} K1/K2 comparisons passed")

    # 9. cross-image batch, greedy ------------------------------------------
    if "batch" in todo:
        t0 = time.monotonic()
        batch_rec, batch_out = drive_cli(cli, read_png, imgs, binarizer,
                                         estimator, counters, cli.run_batched)
        batch_rec["per_image"] = against_per_image(batch_out, main_out)
        record["batch"] = batch_rec
        check_batched("batch", batch_rec, {"K1": 1, "K2": 0, "K3": 0})
        print(json.dumps({"batched_s_per_image": {
            k: batch_rec[k] for k in ("binarize_s_per_image",
                                      "strokes_s_per_image")},
            "per_image_s_per_image": {
            k: main_rec[k] for k in ("binarize_s_per_image",
                                     "strokes_s_per_image")}}), flush=True)
        batch_k1 = []
        with torch.inference_mode():
            batch_masks = [batch_out[name][0] for _, name in imgs]
            crops, batch_inv, _, batch_counts = estimator._gather_batch(
                batch_masks)
            seqs["batched"] = encode_postprocess(
                estimator.encoder(estimator._normalize_raw(crops)),
                estimator.config.encode_image_size)
            batch_rec["rows_against_alone"] = batch_vs_per_image(
                fd, estimator, batch_masks, crops, seqs["batched"], batch_inv)
            del crops
            print(json.dumps({"rows_against_alone": batch_rec[
                "rows_against_alone"]}), flush=True)
            for dtype in (torch.float32, torch.bfloat16):
                rec = compare_k1(fd, decoder, seqs["batched"], dtype,
                                 "batched")
                rec["step_us"] = rec["step_ms"] * 1e3
                batch_k1.append(rec)
                print(json.dumps({k: rec[k] for k in (
                    "case", "dtype", "B", "agree", "rows_identical", "ok",
                    "ms",
                    "plain_ms", "bound_ms", "bound_by", "stream_bound_ms",
                    "steps_max", "steps_sum", "step_us", "grid")}
                    | ({"max_gap": rec["max_gap_at_first_difference"]}
                       if "max_gap_at_first_difference" in rec else {})),
                    flush=True)
            record["k1_batched_breakdown"] = step_breakdown(
                fd, "fused_decode", decoder, seqs["batched"],
                torch.bfloat16, 1)
            batch_rec["k1_ms"] = {"one_launch": batch_k1[1]["ms"],
                                  "per_image_launches": per_image_launches_ms(
                                      fd, fb, decoder, seqs["batched"],
                                      batch_inv, batch_counts, 1)}
        print(json.dumps(record["k1_batched_breakdown"]), flush=True)
        check_breakdown(record["k1_batched_breakdown"])
        print(json.dumps({"k1_ms_bfloat16": batch_rec["k1_ms"]}), flush=True)
        record["k1_batched"] = batch_k1
        bad = [c for c in batch_k1 if not c["ok"]]
        if bad:
            raise SystemExit(f"K1 at the batched shape disagrees with its "
                             f"plain "
                             f"version: {bad}")
        _phase("batch", t0, f"{len(imgs)} images, one K1 launch over "
               f"{seqs['batched'].shape[0]} glyphs, masks against per-image "
               f"{batch_rec['per_image']['agree']:.6f} "
               f"({batch_rec['per_image']['differing_px']} px differ), golden "
               f"strokes chamfer {batch_rec['golden_strokes_chamfer_px']:.3f} "
               f"px")

    # 10. cross-image batch, beam --------------------------------------------
    if "batch-beam" in todo:
        t0 = time.monotonic()
        bbeam_rec, bbeam_out = drive_cli(cli, read_png, imgs, binarizer,
                                         beam_estimator, counters,
                                         cli.run_batched)
        bbeam_rec["per_image"] = against_per_image(bbeam_out, main_out)
        record["batch_beam"] = bbeam_rec
        check_batched("batch-beam", bbeam_rec, {"K1": 0, "K2": 1, "K3": 0})
        batch_k2 = []
        with torch.inference_mode():
            for dtype in (torch.float32, torch.bfloat16):
                rec = compare_k2(fb, decoder, seqs["batched"], dtype,
                                 "batched",
                                 plain_once=True)
                rec["step_us"] = rec["step_ms"] * 1e3
                batch_k2.append(rec)
                print(json.dumps({k: rec[k] for k in (
                    "case", "dtype", "B", "K", "agree", "images_identical",
                    "ok",
                    "ms", "plain_ms", "bound_ms", "bound_by",
                    "stream_bound_ms",
                    "steps_max", "steps_sum", "step_us", "grid",
                    "max_gap_at_first_difference", "score_max_rel_err")
                    if k in rec}), flush=True)
            record["k2_batched_breakdown"] = step_breakdown(
                fd, "fused_beam", decoder, seqs["batched"], torch.bfloat16,
                BEAM)
            bbeam_rec["k2_ms"] = {"one_launch": batch_k2[1]["ms"],
                                  "per_image_launches": per_image_launches_ms(
                                      fd, fb, decoder, seqs["batched"],
                                      batch_inv, batch_counts, BEAM)}
        print(json.dumps(record["k2_batched_breakdown"]), flush=True)
        check_breakdown(record["k2_batched_breakdown"])
        print(json.dumps({"k2_ms_bfloat16": bbeam_rec["k2_ms"]}), flush=True)
        record["k2_batched"] = batch_k2
        bad = [c for c in batch_k2 if not c["ok"]]
        if bad:
            raise SystemExit(f"K2 at the batched shape disagrees with its "
                             f"plain "
                             f"version: {bad}")
        _phase("batch-beam", t0, f"{len(imgs)} images, one K2 launch over "
               f"{seqs['batched'].shape[0] * BEAM} beams, golden strokes "
               f"chamfer "
               f"{bbeam_rec['golden_strokes_chamfer_px']:.3f} px")

    # 11. fused binarize ------------------------------------------------------
    if "fused-binarize" in todo:
        t0 = time.monotonic()
        raw = [img for img, _ in imgs]
        fused_calls = []
        fused_batch = binarizer._fused_batch
        binarizer._fused_batch = lambda b, plan: (
            fused_calls.append(len(b)) or fused_batch(b, plan))
        try:
            default, default_ms = event_ms(
                lambda: binarizer.binarize_images(raw))
            calls_default = list(fused_calls)
            binarizer.fused = True
            fused, fused_ms = event_ms(lambda: binarizer.binarize_images(raw))
        finally:
            binarizer.fused = False
            del binarizer._fused_batch
        as_masks = lambda bins: {name: b[:, :, 0] > 0
                                 for b, (_, name) in zip(bins, imgs)}
        per_image = {n: m for n, (m, _) in main_out.items()}
        fused_rec = {
            "images": len(imgs), "default_ms": default_ms,
            "fused_ms": fused_ms,
            "fused_program_calls": {"default": len(calls_default),
                                    "fused": len(fused_calls) - len(
                                        calls_default)},
            "fused_program_images": {"default": sum(calls_default),
                                     "fused": sum(fused_calls)
                                     - sum(calls_default)},
            "fused_vs_default": mask_diff(as_masks(fused), as_masks(default)),
            "fused_vs_per_image": mask_diff(as_masks(fused), per_image),
            "default_vs_per_image": mask_diff(as_masks(default), per_image)}
        record["fused_binarize"] = fused_rec
        print(json.dumps(fused_rec), flush=True)
        worst = min(fused_rec[k]["agree"] for k in (
            "fused_vs_default", "fused_vs_per_image", "default_vs_per_image"))
        if worst < BATCH_MASK_AGREE or fused_rec["fused_program_images"][
                "fused"] != len(imgs):
            raise SystemExit(f"fused binarize: {fused_rec}")
        _phase("fused-binarize", t0, f"{len(imgs)} images through the device "
               f"cut and stitch, agreement >= {worst:.6f}")

    # 12. the HTTP server ----------------------------------------------------
    if "serve" in todo:
        t0 = time.monotonic()
        serve_rec = drive_server(serve, encode_png, imgs, binarizer, estimator,
                                 counters)
        record["serve"] = serve_rec
        print(json.dumps(serve_rec), flush=True)
        biggest = max(int(k) for k in serve_rec["batch_size_hist"])
        k1_served = serve_rec["launches"]["K1"]
        if (biggest < 2 or not 0 < k1_served < serve_rec["derender_requests"]
                or not serve_rec["svg_ok"] or serve_rec[
                    "golden_strokes_chamfer_px"] > STROKES_CHAMFER_PX):
            raise SystemExit(f"server: {serve_rec}")
        lat = serve_rec["latency_s"]
        _phase("serve", t0, f"{serve_rec['requests']} requests answered, "
               f"batches {serve_rec['batch_size_hist']}, {k1_served} K1 "
               f"launches for {serve_rec['derender_requests']} /derender; "
               f"binarize p50/p90 {lat['binarize']['p50']}/"
               f"{lat['binarize']['p90']} s, strokes "
               f"{lat['strokes']['p50']}/{lat['strokes']['p90']} s")

    # 13. --preset real: residual re-decode ----------------------------------
    if "real" in todo:
        t0 = time.monotonic()
        from stroke_derenderer_tpu_torch.pipeline import strokes as pipe
        real_args = ["-models", str(MODELS), "--preset", "real"]
        real_ov = cli.strokes_overrides(cli.parse_args(real_args))
        real_ov["max_length"] = MAX_LENGTH
        _, real_est = cli.initialize_sessions(MODELS, device=dev,
                                              se_overrides=real_ov)
        passes = real_est.config.redecode_passes
        tol = real_est.config.redecode_tol
        host_names = ("residual_ink", "merge_stroke_fragments",
                      "refine_strokes")
        real_rec = {"passes": passes, "redecode_coverage":
                    real_est.config.redecode_coverage}
        with host_timers(pipe, host_names) as spent:
            rec, real_out = drive_cli(cli, read_png, imgs, binarizer, real_est,
                                      counters)
        rec["host_s"] = spent
        real_rec["per_image"] = rec
        with host_timers(pipe, host_names) as spent:
            rec, breal_out = drive_cli(cli, read_png, imgs, binarizer,
                                       real_est,
                                       counters, cli.run_batched)
        rec["host_s"] = spent
        rec["per_image_run"] = against_per_image(breal_out, real_out)
        real_rec["batched"] = rec
        _, real_beam_est = cli.initialize_sessions(
            MODELS, device=dev, se_overrides=cli.strokes_overrides(
                cli.parse_args(real_args + ["--decode", "beam", "--beam-size",
                                            str(BEAM)])) | {
                "max_length": MAX_LENGTH})
        with host_timers(pipe, host_names) as spent:
            rec, rbeam_out = drive_cli(cli, read_png, imgs[:1], binarizer,
                                       real_beam_est, counters)
        rec["host_s"] = spent
        real_rec["beam"] = rec
        refine_ov = cli.strokes_overrides(cli.parse_args(
            ["-models", str(MODELS), "--refine", str(REFINE_PX)]))
        _, refine_est = cli.initialize_sessions(
            MODELS, device=dev, se_overrides=refine_ov | {
                "max_length": MAX_LENGTH})
        with host_timers(pipe, host_names) as spent:
            rec, _ = drive_cli(cli, read_png, imgs, binarizer, refine_est,
                               counters)
        rec["host_s"] = spent
        real_rec["refine"] = rec
        golden_img = imgs[0][0]
        real_rec["golden_coverage"] = {
            "main": golden_coverage(main_out, golden_img, tol),
            "real": golden_coverage(real_out, golden_img, tol),
            "main-beam": golden_coverage(beam_out, golden_img, tol),
            "real-beam": golden_coverage(rbeam_out, golden_img, tol),
            "batch-real": golden_coverage(breal_out, golden_img, tol)}
        # K1 against its plain version on the rows of the first residual pass
        # of the batched run (the residuals of its masks after one pass).
        with torch.inference_mode():
            breal_masks = [breal_out[name][0] for _, name in imgs]
            first = real_est._process_images_once(breal_masks, MAX_LENGTH)
            resids = [r for r in (real_est._residual_for(m, s)
                                  for m, s in zip(breal_masks, first))
                      if r is not None]
            crops = real_est._gather_batch(resids)[0]
            seqs["residual"] = encode_postprocess(
                real_est.encoder(real_est._normalize_raw(crops)),
                real_est.config.encode_image_size)
            del crops
            residual_k1 = [compare_k1(fd, decoder, seqs["residual"], dtype,
                                      "residual")
                           for dtype in (torch.float32, torch.bfloat16)]
        real_rec["residual_images"] = len(resids)
        real_rec["k1_residual"] = [{k: c[k] for k in (
            "case", "dtype", "B", "agree", "rows_identical", "ok", "ms",
            "plain_ms", "bound_ms", "steps_max") if k in c} | (
            {"max_gap": c["max_gap_at_first_difference"]}
            if "max_gap_at_first_difference" in c else {})
            for c in residual_k1]
        record["real"] = real_rec
        summary = {run: {
            "ms_per_image_binarize": 1e3 * real_rec[run][
                "binarize_s_per_image"],
            "ms_per_image_strokes": 1e3 * real_rec[run]["strokes_s_per_image"],
            "launches": real_rec[run]["launches"],
            "host_s": {n: v["s"] for n, v in real_rec[run]["host_s"].items()},
            "run_s": real_rec[run]["run_s"]}
            for run in ("per_image", "batched", "beam", "refine")}
        print(json.dumps({"real": summary, "golden_coverage": real_rec[
            "golden_coverage"], "batched_against_per_image": real_rec[
            "batched"]["per_image_run"], "residual_images": len(resids)}),
            flush=True)
        for c in real_rec["k1_residual"]:
            print(json.dumps(c), flush=True)
        with_glyphs = real_rec["per_image"]["images_with_glyphs"]
        k1_real = real_rec["per_image"]["launches"]["K1"]
        k1_breal = real_rec["batched"]["launches"]["K1"]
        k2_rbeam = real_rec["beam"]["launches"]["K2"]
        cover = real_rec["golden_coverage"]
        if not with_glyphs + 1 <= k1_real <= with_glyphs * (1 + passes):
            raise SystemExit(f"real: {k1_real} K1 launches for {with_glyphs} "
                             f"images with glyphs and {passes} passes")
        if not 2 <= k1_breal <= 1 + passes:
            raise SystemExit(f"batch-real: {k1_breal} K1 launches, expected "
                             f"one "
                             f"per pass (2 to {1 + passes})")
        if k2_rbeam < 2 or real_rec["beam"]["launches"]["K1"] != 0:
            raise SystemExit(f"real-beam: launches "
                             f"{real_rec['beam']['launches']}")
        if cover["real"] < cover["main"] or cover["real-beam"] < cover[
                "main-beam"]:
            raise SystemExit(f"real: the golden strokes cover less ink with "
                             f"the "
                             f"residual passes: {cover}")
        if real_rec["refine"]["launches"]["K1"] != with_glyphs:
            raise SystemExit(f"refine: launches "
                             f"{real_rec['refine']['launches']}")
        bad = [c for c in residual_k1 if not c["ok"]]
        if bad:
            raise SystemExit(f"K1 on the residual rows disagrees with its "
                             f"plain "
                             f"version: {real_rec['k1_residual']}")
        _phase("real", t0, f"K1 launches {k1_real} per image ({with_glyphs} "
               f"images with glyphs), {k1_breal} batched, K2 {k2_rbeam} on "
               f"the "
               f"golden image; golden coverage {cover['main']:.4f} -> "
               f"{cover['real']:.4f} (beam {cover['main-beam']:.4f} -> "
               f"{cover['real-beam']:.4f}); K1 on {seqs['residual'].shape[0]} "
               f"residual rows passed")

    # 14. the trainer ---------------------------------------------------------
    if "train" in todo:
        t0 = time.monotonic()
        train_rec = train_phase(cli, counters, dev)
        k1_train = train_rec["cli"]["launches"]["K1"]
        _phase("train", t0, "losses within the JAX reference's bars; steps/s "
               + ", ".join(f"{k} {train_rec['rates'][k]['steps_per_s']:.2f} "
                           f"(loader wait "
                           f"{train_rec['rates'][k]['wait_share']:.0%})"
                           for k in ("binarizer", "captioner",
                                     "captioner-cache"))
               + f"; resumed at {train_rec['resume_start_steps']}; the "
                 f"exported "
               f"dir served with {k1_train} K1 launch")
        record["train"] = train_rec

    # 15. the evaluator against the JAX package's CPU run ---------------------
    if "eval" in todo:
        t0 = time.monotonic()
        from stroke_derenderer_tpu_torch.eval import run as eval_run
        reference = json.loads(JAX_EVAL.read_text())["runs"]
        eval_runs = {
            "real_greedy": lambda: eval_run.evaluate_real(
                MODELS, REAL_DATA, se_overrides={"max_length": MAX_LENGTH},
                device=dev),
            "real_redecode": lambda: eval_run.evaluate_real(
                MODELS, REAL_DATA, se_overrides={"max_length": MAX_LENGTH,
                                                 "redecode_coverage": 0.9},
                device=dev),
            "mixed_greedy": lambda: eval_run.evaluate_full(
                MODELS, n=EVAL_MIXED_N, seed=0, style="mixed",
                se_overrides={"max_length": MAX_LENGTH}, device=dev)}
        for mod in counters.values():
            mod.launch_count = 0
        eval_rec = {name: eval_against(name, fn, {"default": reference})
                    for name, fn in eval_runs.items()}
        misses = [m for r in eval_rec.values() for m in r["misses"]["default"]]
        eval_launches = {name: mod.launch_count
                         for name, mod in counters.items()}
        record["eval"] = eval_rec | {"launches": eval_launches}
        if misses:
            raise SystemExit("eval against the JAX CPU reference: "
                             + "; ".join(misses))
        if eval_launches["K1"] == 0:
            raise SystemExit(f"eval: launches {eval_launches}")
        # The same sets through the batched path: one binarize_images and one
        # process_images per set (scripts/eval_batched.py), so K1 runs once per
        # set at large B (redecode: once more per residual pass), against the
        # JAX package's batched CPU runs.
        eb = load_script("eval_batched")
        pkg = "stroke_derenderer_tpu_torch"
        batched_runs = {
            "real_greedy": lambda: eb.evaluate_real_batched(
                pkg, MODELS, REAL_DATA, {"max_length": MAX_LENGTH}, dev),
            "real_redecode": lambda: eb.evaluate_real_batched(
                pkg, MODELS, REAL_DATA, {"max_length": MAX_LENGTH,
                                         "redecode_coverage": 0.9}, dev),
            "mixed_greedy": lambda: eb.evaluate_full_batched(
                pkg, MODELS, n=EVAL_MIXED_N, seed=0, style="mixed",
                se_overrides={"max_length": MAX_LENGTH}, device=dev)}
        batched_ref = json.loads(JAX_EVAL_BATCHED.read_text())["runs"]
        for mod in counters.values():
            mod.launch_count = 0
        batched_rec = {name: eval_against(name, fn, {"default": batched_ref})
                       for name, fn in batched_runs.items()}
        misses = [m for r in batched_rec.values()
                  for m in r["misses"]["default"]]
        batched_launches = {name: mod.launch_count
                            for name, mod in counters.items()}
        record["eval_batched"] = batched_rec | {"launches": batched_launches}
        if misses:
            raise SystemExit("batched eval against the JAX CPU reference: "
                             + "; ".join(misses))
        if not len(batched_runs) <= batched_launches["K1"] <= len(
                batched_runs) + 3 or batched_launches["K2"]:
            raise SystemExit(f"batched eval: launches {batched_launches}")
        _phase("eval", t0, f"{len(eval_runs)} runs within the JAX CPU "
               f"reference's bars (DTW ci95, F1 {EVAL_F1_TOL}, coverage "
               f"{EVAL_COVERAGE_TOL}), {eval_launches['K1']} K1 launches; "
               f"batched, {len(batched_runs)} runs within the JAX batched CPU "
               f"reference's bars, {batched_launches['K1']} K1 launches")

    # 16. --quant int8 --------------------------------------------------------
    if "int8" in todo:
        t0 = time.monotonic()
        int8_rec = int8_phase(cli, read_png, slice_imgs, main_out, counters,
                              dev,
                              binarizer, estimator, {
                                  "bin": q_binarizer, "greedy": q_estimator,
                                  "beam": q_beam})
        record["int8"] = int8_rec
        slowest = max(int8_rec["convs"], key=lambda c: c["ms"] / c["cudnn_ms"])
        _phase("int8", t0, f"{len(int8_rec['convs'])} int8 convs card == CPU "
               f"bit for bit (slowest against cuDNN: {slowest['case']} "
               f"{slowest['dtype']} {slowest['ms']:.3f} vs "
               f"{slowest['cudnn_ms']:.3f} ms); demo bars {int8_rec['demo']}; "
               f"per image binarize "
               f"{int8_rec['cli']['binarize_s_per_image']:.4f}"
               f" s (bf16 {main_rec['binarize_s_per_image']:.4f}), strokes "
               f"{int8_rec['cli']['strokes_s_per_image']:.4f} s (bf16 "
               f"{main_rec['strokes_s_per_image']:.4f}); masks against bf16 "
               f"{int8_rec['cli']['against_bf16']['agree']:.6f}; eval within "
               f"the JAX int8 CPU reference's bars")

    # 17. --two-stage ---------------------------------------------------------
    if "two_stage" in todo:
        t0 = time.monotonic()
        two_rec = two_stage_phase(cli, read_png, slice_imgs, main_out,
                                  counters, {
            "none": (binarizer, estimator),
            "int8": (q_binarizer, q_estimator)}, batch_rec)
        record["two_stage"] = two_rec
        per = {q: two_rec[q]["s_per_image"] for q in ("none", "int8")}
        _phase("two_stage", t0, f"--two-stage {two_rec['chunk']}: "
               + "; ".join(
            f"{q}: {two_rec['chunks']} K1 launches, outputs as the sequential "
            f"chunks', {per[q]['two_stage']:.4f} s/image (chunks "
            f"{per[q]['sequential_chunks']:.4f}, --batch "
            f"{per[q]['batch']:.4f}),"
            f" overlap {two_rec[q]['overlap']:.3f}" for q in per)
            + "; per-image mode as the per-image run")

    # 18. profile -----------------------------------------------------------
    if "profile" in todo:
        t0 = time.monotonic()
        prof_imgs = imgs[:PROFILE_INPUTS] if PROFILE_INPUTS else imgs
        prof_rec = profile_phase(prof_imgs, binarizer, estimator, counters,
                                 dev,
                                 smi, main_out)
        record["profile"] = prof_rec
        up = {gid: prof_rec["ledger_per_image"][f"per_image_{gid}"]["strokes"][
            "up_bytes"] for gid in ("packed", "dense")}
        shares = ", ".join(
            f"{k} {v['busy_share']:.3f}" if v["busy_share"] is not None
            else f"{k} no device track" for k, v in prof_rec["busy"].items())
        natives = ", ".join(f"{op} {d['native']:.3f} ms/image" for op, d in
                            prof_rec["native_ms_per_image"].items())
        _phase("profile", t0, f"{len(prof_imgs)} images: native resize and CC "
               f"as numpy's and scipy's ({natives}); strokes up bytes/image "
               f"packed {up['packed']:.0f} < dense {up['dense']:.0f}; busy "
               f"share {shares}; K1 agreement with its plain version "
               f"{prof_rec['k1']['agree']:.4f}; {smi}")

    # 19. the mesh ------------------------------------------------------------
    if "mesh" in todo:
        t0 = time.monotonic()
        mesh_rec = mesh_phase(cli, inputs, imgs, batch_out, q_binarizer,
                              binarizer, estimator, dev)
        record["mesh"] = mesh_rec
        print(json.dumps({"mesh": {k: v for k, v in mesh_rec.items()
                                   if k != "launches"}}), flush=True)
        print(json.dumps({"mesh_img_per_s": mesh_rec["img_per_s"],
                          "stage_s": mesh_rec["stage_s"], "card": smi}),
              flush=True)
        mesh_k = {run: sum(r[k] for r in mesh_rec["launches"][run])
                  for run, k in (("greedy", "K1"), ("greedy_f32", "K1"),
                                 ("int8", "K1"), ("two_stage", "K1"),
                                 ("beam", "K2"))}
        _phase("mesh", t0, f"{len(mesh_rec['devices'])} ranks on "
               f"{', '.join(mesh_rec['devices'])} over {mesh_rec['backend']}"
               + (", and on cuda:0, cuda:1 over nccl" if "nccl" in mesh_rec
                  else "") + f": K1 once per rank per batch, float32 "
               f"tokens as "
               f"one rank's, masks against --batch "
               f"{mesh_rec['greedy']['masks']['agree']:.6f} (tp=2 "
               f"{mesh_rec['tp']['masks']['agree']:.6f}, int8 "
               f"{mesh_rec['int8']['masks']['agree']:.6f}), two-stage as the "
               f"chunks; trainer losses as one rank's (dp=2 and tp=2), "
               f"parameters within "
               f"{mesh_rec['train']['train_param_max_abs_diff']:.2e} and "
               f"{mesh_rec['train']['train_tp_param_max_abs_diff']:.2e}; CLI "
               f"--mesh 2 "
               + ("warned and ran on one device" if mesh_rec["cli"]["warned"]
                  else "ran over the cards")
               + f"; {mesh_rec['img_per_s']['dp2']:.2f} img/s at dp=2 against "
               f"{mesh_rec['img_per_s']['dp1']:.2f} at dp=1 "
               f"({mesh_rec['img_per_s']['note']}), {smi}")

    # kernel table and result ---------------------------------------------
    # Each kernel's launches on each path that ran.
    by_k1, by_k2, by_k3 = {}, {}, {}
    if "main" in todo:
        by_k1["main"] = launches
    if "batch" in todo:
        by_k1["batch"] = batch_rec["launches"]["K1"]
    if "serve" in todo:
        by_k1["serve"] = k1_served
    if "real" in todo:
        by_k1 |= {"real": k1_real, "batch-real": k1_breal,
                  "refine": real_rec["refine"]["launches"]["K1"]}
        by_k2["real-beam"] = k2_rbeam
    if "train" in todo:
        by_k1["train"] = k1_train
    if "eval" in todo:
        by_k1 |= {"eval": eval_launches["K1"],
                  "eval-batched": batched_launches["K1"]}
    if "int8" in todo:
        by_k1 |= {"int8": int8_rec["cli"]["launches"]["K1"],
                  "int8-batch": int8_rec["batch"]["launches"]["K1"],
                  "int8-eval": int8_rec["eval"]["launches"]["K1"]}
        by_k2["int8-beam"] = int8_rec["beam"]["launches"]["K2"]
    if "two_stage" in todo:
        by_k1 |= {"two-stage": two_rec["none"]["launches"]["K1"],
                  "two-stage-int8": two_rec["int8"]["launches"]["K1"],
                  "two-stage-per-image": two_rec["per_image"]["launches"][
                      "K1"]}
    if "profile" in todo:
        by_k1 |= {"profile": sum(v["K1"] for k, v in
                                 prof_rec["launches"].items()
                                 if k.startswith("per_image")),
                  "profile-batch": sum(v["K1"] for k, v in
                                       prof_rec["launches"].items()
                                       if k.startswith("batch"))}
    if "mesh" in todo:
        by_k1 |= {"mesh": mesh_k["greedy"], "mesh-f32": mesh_k["greedy_f32"],
                  "mesh-int8": mesh_k["int8"],
                  "mesh-two-stage": mesh_k["two_stage"]}
        by_k2["mesh-beam"] = mesh_k["beam"]
    if "onnx" in todo:
        by_k1 |= onnx_rec["launches"]["K1"]
        by_k2 |= onnx_rec["launches"]["K2"]
    if "main-beam" in todo:
        by_k2["main-beam"] = beam_launches
    if "batch-beam" in todo:
        by_k2["batch-beam"] = bbeam_rec["launches"]["K2"]
    launches_by_path = {"K1": by_k1, "K2": by_k2, "K3": by_k3}

    def row(name, src, replaces, launches_, rec, err):
        return {"name": name, "route": "cuda",
                "source": f"stroke_derenderer_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": launches_,
                "max_abs_err": err, "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": None}

    for name, lib, phase in (("K1", "fused_decode", "k1"),
                             ("K2", "fused_beam", "k2")):
        if phase not in todo:
            continue
        rec = pick(checks if name == "K1" else k2_checks, "golden",
                   "bfloat16")
        print(json.dumps({"launch": name, "grid": rec["grid"],
                          "threads": 512,
                          "barriers_per_step": rec["barriers_per_step"],
                          "step_ms": rec["step_ms"],
                          "engine_bf16": rec["engine"],
                          "mma_plan": rec["mma_plan"],
                          "hmma": record["sass_mma"][lib],
                          "ptxas": record["build"][lib]["kernels"]}))
    if "k3" in todo:
        golden_k3 = pick(k3_checks, "golden")
        print(json.dumps({"launch": "K3", "clusters": golden_k3["G"],
                          "cluster": golden_k3["C"],
                          "grid": golden_k3["G"] * golden_k3["C"],
                          "threads": 256, "cluster_barriers_per_row_tile": 2,
                          "row_tile": golden_k3["row_tile"],
                          "smem_bytes": golden_k3["smem_bytes"],
                          "bytes_per_cta": golden_k3["bytes_per_cta"],
                          "ptxas": record["build"]["decode_attention"][
                              "kernels"]}))
        fused_entry = pick(k3_checks, "golden, greedy_decode(fused=True)",
                           "bfloat16")
        by_k3["greedy_decode(fused=True)"] = fused_entry["k3_launches"]
    print(json.dumps({"launches_by_path": launches_by_path}))
    print(json.dumps({"launches_by_engine": {
        "K1": fd.engine_launches, "K2": fb.engine_launches}}))
    # Tokens are integers: for K1 and K2 max_abs_err is the largest share of
    # float32 token positions that differ from the plain version.
    kernels = []
    if todo >= {"k1", "k2", "k3"}:
        onnx_checks = onnx_rec["checks"] if "onnx" in todo else []
        kernels = [
            row("K1 fused greedy decode", "fused_decode.cu",
                "stroke_derenderer_tpu/kernels/fused_decode.py:251",
                sum(by_k1.values()), pick(checks, "golden", "bfloat16"),
                max(1.0 - c["agree"] for c in checks
                    + (batch_k1 if "batch" in todo else [])
                    + [c for c in onnx_checks if c["kernel"] == "K1"]
                    if c["dtype"] == "float32")),
            row("K2 fused beam decode", "fused_beam.cu",
                "stroke_derenderer_tpu/kernels/fused_beam.py:218",
                sum(by_k2.values()), pick(k2_checks, "golden", "bfloat16"),
                max(1.0 - c["agree"] for c in k2_checks
                    + (batch_k2 if "batch-beam" in todo else [])
                    + [c for c in onnx_checks if c["kernel"] == "K2"]
                    if c.get("dtype") == "float32")),
            row("K3 fused attention + gate", "decode_attention.cu",
                "stroke_derenderer_tpu/kernels/decode_attention.py:109",
                fused_entry["k3_launches"], pick(k3_checks, "golden"),
                max(c["max_abs_err"] for c in k3_checks
                    if "max_abs_err" in c)),
        ]
    if args.out:
        record["kernels"] = kernels
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(record, indent=1))
    if kernels:
        print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
