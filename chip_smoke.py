"""On-card smoke run of gslm_tpu_torch, the PyTorch/CUDA port (one H100).

    python3 chip_smoke.py

Drives the port's paths at full width and checks them, in phases; any
failed phase exits non-zero:

1. card and build: the card's name and power limit; nvcc builds every
   kernel of ``gslm_tpu_torch/csrc`` (one process per source, in
   parallel); kernels A's, C's, D's, E's, F's and G's registers, static
   shared memory and resident blocks per SM.
2. each kernel against its plain PyTorch version on the card: kernel A
   (tile compositor) on one 1920x1080 view of the headline scene, kernel B
   (SSIM blur) on (15, 1080, 1920) planes, bit for bit. TF32 is off for
   matmul and cuDNN.
3. serving: ``batch_render`` of the 131,072-Gaussian SH-3 scene (spread
   1.5, log-scales in [-5.5, -3.5], seed 0) in a 4-view 1920x1080 batch,
   then ``pair_metrics`` of every view against its ground truth, under
   ``torch.no_grad()``. Checks: no overflow, finite images, kernel A
   launched once, kernel B once per pair and kernel C never, every batched
   view equal bit for bit to its single-view render, kernel A against its
   plain version on the path's own 4-view stack (tile rows wrapping per
   view), and the kernel path against the dense golden rasterizer on a
   small scene.
4. serving timings (CUDA events, median after warm-up), stage breakdown,
   records walked, each kernel's bound. Kernel A, here and in phases 6-8:
   its pairs by gate outcome, those in patches its mask keeps, (record,
   warp) steps by the furthest outcome any lane reaches under 16x2 strips,
   8x4 patches and 8x4 patches with the mask; the lane bound, the culled
   lane bound, the mask's own instructions and the three warp-issue
   estimates.
5. training: ``train_step`` (one Adam iteration, bench.py's setting: the
   same scene with 50 exposure images, one 1920x1080 view, step 100,
   default options, depth weight 0, no sparse Adam, statistics on) against
   a reachable target, the port's own render of the scene with
   ``features_dc`` shifted by a seeded offset. Checks: per step kernel A
   once, kernel B twice (forward and VJP) and kernel C (backward
   compositor) once; kernel C against its plain version on the step's own
   records and cotangents (knife-edge bound per field), bit for bit
   against itself and against the guard C<MASK=false>'s (every patch bit
   set: it holds the patch bits C computes to the records that contribute;
   ``c_vs_plain``); the blur VJP equal bit for bit to the plain
   reversed-tap blur; every group's gradient through the kernels against
   the gradient through the plain compositor (the plain versions patched
   in here); finite
   gradients, parameters and statistics; ``denom`` rising by exactly the
   visible count; the loss falling over 10 steps.
6. training timings: the step, its stages, the device-busy share, kernel
   A on the training view; kernel C here and in phases 7 and 8
   (``c_report``): its pairs by gate outcome and those in patches its mask
   keeps, (record, warp) steps under the earlier 16x2 strips and under its
   8x4 patches with the mask and per-warp starts, the lane and culled lane
   bounds and the mask's overhead.
7. one Levenberg–Marquardt outer step (cell lm-1080p-w5): the same scene
   with 50 exposure images, ``ring_camera_batch(50, 1080, 1920)`` as the
   training views, each view's target the port's render of the scene with
   ``features_dc`` shifted by a seeded offset, ``LMParams()`` defaults (a
   5-view window, 50 validation views in chunks of 5, 7 line-search
   alphas, CG 2 iterations with restart 1 and the divergence check),
   bench.py's 5-view capacities. Checks: per ``lm_outer_step`` kernel A 71
   times, B never, C 4 times (Jᵀ·u) and E 6 times (J·v); kernel E's primal
   equal bit for bit to kernel A's on the window's own records, and both
   to the guard E<MASK=false>'s (every record through pair_alpha, no
   patch mask: it holds A's and E's mask and A's written-out gates to the
   pair-by-pair walk; ``guard_check``), E's tangent within 1e-6 of the
   guard's and against its plain version (knife-edge bound per row), E bit
   for bit against itself; the adjoint ⟨J·v, u⟩ = ⟨v, Jᵀ·u⟩ at full width
   to 1e-4; kernel C on the window's own Jᵀ·u inputs against its plain
   version, itself and its guard; neither guard launched by the step; J·v through the kernels against J·v through the
   plain compositor; the best validation loss below the starting one, xyz
   unchanged, finite parameters and step norms; ``lm_phase`` once through
   its entry point with no capacity growth. Then timings: the step, its
   stages, the device-busy share, kernels E, A and C on the window beside
   their bounds (kernel E's lane and culled bounds: ``e_report``).
8. bucket binning (cell train-m1-bucket4-1080p): bench.py's million-
   Gaussian scene (1,048,576 Gaussians, seed 2, one 1920x1080 view,
   ``bucket=4``, its capacities). Checks: ``overflow_probe`` gives the
   render's counts, no overflow; ``render`` launches kernel A once and
   equals the bucket-1 render (1e-6; bit for bit expected); kernel A with
   the rect gate against its plain version, kernel E<RECT>'s primal equal
   to it bit for bit and both to the guard E<RECT, MASK=false>'s; ``train_step`` launches A once, B twice, C
   never and kernel D (bucket backward) once, its results finite,
   ``denom`` rising by the visible count, the loss falling over 10 steps;
   kernel D against its plain version per field, bit for bit against
   itself and against its guard D<MASK=false> (every patch bit set inside
   the rect gate); every group's gradient within 1e-5·max of bucket 1's;
   J·v
   through kernel E within 1e-6·max of bucket 1's; the adjoint at bucket 4
   (E forward, D backward) to 1e-4. Then timings at bucket 4 and 1
   (render, front end, gather, kernel, backward, ``train_step`` in turns),
   the device-busy share, kernels A's and D's pairs and bounds (D's lane
   and culled lane bounds, its walk and sum timed apart), kernel C at
   bucket 1, the peak device memory, and every kernel's instruction totals
   from its SASS.
9. scene I/O, initialisation, density control and checkpoints (cell
   scene-densify-131k-1080p): the headline scene rendered through kernel
   A from 8 ring views at 1920x1080 and written with the port's writers
   as a COLMAP scene (PINHOLE cameras, 8-bit RGB PNGs, points3D.bin of
   the 131,072 centres with their DC colours) in a temporary directory,
   then loaded by ``Scene(resolution=1, shuffle=False, capacity=262,144)``
   on the card. Checks: 8 cameras; every image bitwise equal to the uint8
   written / 255; R, T and FoV to 1e-6; 131,072 alive slots; the 3-NN on
   4,096 sampled rows within 1e-5 relative of a float64 numpy brute force,
   the model's log-scales made from it, and ``create_from_pcd`` given it
   equal to the Scene's model; points3D.bin and a Paeth-filtered 1080p
   RGB and 800x800 RGBA PNG read back exactly (timed). Then 60 ``train_step``s
   cycling the views (statistics on, capacities from ``overflow_probe`` +
   5 %, again after each density event), each launching A once, B twice
   and C once; ``densify_and_prune`` after steps 30 and 60 (the
   ``OptimizationParams`` defaults, extent ``cameras_extent``, no
   screen-size pruning, noise from a seeded ``torch.Generator``), each
   event's counts and ``alive`` equal to the same call on CPU copies but
   for rows within 1e-6 relative of a threshold (counted), parameters
   within 1e-6 of max and moments bitwise where the allocations agree,
   nothing dropped, Gaussians added; ``reset_opacity`` and 10 more steps,
   finite and without overflow. On step 21 (before densification) and
   step 66 (after the reset), on the step's own inputs after the launch
   counts are read: A against ``composite_tiles_plain`` (knife-edge bound,
   its exit state equal to the step's), B ``torch.equal`` to
   ``blur_plain`` on the SSIM planes and their cotangents, C against its
   plain backward per field (``c_vs_plain``). Then ``save_checkpoint`` /
   ``load_checkpoint`` bitwise, a forward loss from the loaded state
   bitwise equal to the live one, and ``Scene.save`` reloaded with
   ``load_iteration=-1`` giving the live rows back bitwise. Prints the
   write, load, PNG, 3-NN, ``create_from_pcd``, density-event and
   checkpoint times, the median step before and after densification and
   two profiled steps' device-busy shares. Phase 9's scene stays on disk
   for phase 10. Kernel F (the 3-NN grid search): the Scene load's
   ``create_from_pcd`` launches it exactly once, and nothing else in
   phase 9 launches it; F bit for bit (``torch.equal``) against its plain
   version on (a) the scene's 131,072 points, (b) the million-Gaussian
   scene's means (bench.py:338-378) on ``KNN_SAMPLE`` rows (``rows=``),
   also within 1e-5 relative of float64 there, and (c) a seeded
   131,072-point clustered cloud with 1 % outliers at 100x the clusters'
   spread; its pair-counting instantiation equal to it, two runs equal.
   Prints per cloud F's search alone and with its grid, the plain
   version's time (not at (b)), the candidate pairs per point (mean, max)
   and the byte bound, and the points3D.bin parse time. Over phases
   10-14's process, kernel F's launches must equal the ``Scene`` loads
   that make a model from a point cloud on the card.
10. the command lines end to end (cell train-cli-131k-1080p), each
   through its ``main(argv)`` in this process, ``sys.stdout`` put back
   after each (``safe_state`` wraps it): ``train.main`` on phase 9's
   scene (``-r 1 --eval --capacity 262144``, 300 iterations, density
   events after 200 and 300, test and checkpoint iterations 100 and 300,
   a profiler window at 250-251, the default capacities, the viewer on a
   free port answering one client's pose); ``train_lm.main`` resumed from
   ``chkpnt300.npz`` for two LM iterations; ``train_sgd.main`` for five
   5-view windows from the same checkpoint; ``render_sets.main`` and
   ``metrics.main`` on the LM run's output. Checks: iteration 1 retries at
   4,194,304 and 8,388,608 and ``opt_state.step`` equals the iteration
   count after every Adam iteration; every Adam and SGD attempt launches A
   once, B twice and C once, every LM iteration A 71, C 4 and E 6 times,
   ``render_sets`` A once per chunk, ``metrics`` B once per pair, and the
   runs' totals add up (evaluate and the viewer one A each); the density
   events add Gaussians and drop nothing; the files (``cfg_args``, which
   ``get_combined_args`` reads back, the PLY, the checkpoints, the
   profiler trace, the rendered sets, ``results.json``); the checkpoint
   and the PLY load bit for bit; the LM run starts at iteration 300's
   state bitwise, its best validation losses are finite and xyz stays;
   PSNR of ``chkpnt100`` and ``chkpnt300`` on the train views climbs;
   the viewer's frame equals clip(render)·255 of the parameters it was
   rendered from, byte for byte; ``results.json``'s PSNR equals that of
   the same (degraded) render within the PNG rounding, and
   ``metrics.evaluate_dir`` of an undegraded render of the test view,
   written with ``render_sets.save_png``, equals ``evaluate``'s PSNR of
   it within the same rounding; kernels A, B and C against
   their plain versions on iteration 250's inputs, E and C on the first
   LM iteration's window, A on an SGD iteration's 5-view stack. Prints
   start-up, the loop's iteration against ``train_step`` alone, the
   retried iteration, LM and SGD iterations, evaluate, density events,
   saves, the frame round trip, ``render_sets`` per view, ``metrics`` per
   pair, the profiled iterations' device-busy share, the LM run's peak
   memory and the phase's wall time.
11. depth-supervised training (cell scene-depth-131k-1080p) on phase 9's
   scene: each view's observations of the points (those whose inverse
   depth is within 1 % of the render's normalised inverse depth at the
   four pixels a bilinear sample of them reads: at 5 % the blend with
   what lies behind compresses the sampled depths and the fitted scale
   of the four axis-aligned views comes out 1.28/a) written into
   images.bin,
   and a ``depths/`` folder of 16-bit 960x540 inverse-depth PNGs, each a
   per-view affine a·d + b of the port's render (d its inverse depth over
   its alpha), one train view's a 10x the others'. Then
   ``tools.make_depth_scale.main``, ``train.main -d depths -r 1 --eval
   --capacity 262144`` for 100 iterations (test and checkpoint at 100)
   and ``train_sgd.main -d depths`` for 3 windows of 5 views from that
   checkpoint, the odd view inside the first. Checks: the fitted scale·a
   within 10 % of 1 for every reliable view and the odd view's scale
   under 0.2x the median; ``Scene`` with depths marks the odd view
   unreliable with a zero mask and loads every other map at 1080p; every
   Adam and SGD attempt launches A once, B twice and C once, every C
   with ``depth_grad`` True; the odd view's iterations have depth weight
   0 and depth L1 0, its mask is 0 inside its SGD window and the others'
   are not; depth L1 falls over the loop (median of the first and last
   10 reliable iterations); kernel C against its plain version
   (``c_vs_plain``, ``depth_grad`` True) on a loop iteration's inputs
   whose invdepth cotangent is nonzero. Prints the 16-bit PNG write and
   read, ``make_depth_scale``, ``Scene`` load with and without depths,
   the loop's iteration against phase 10's and kernel C with and without
   ``depth_grad`` in turns.
12. LPIPS and the parity matrix: a seeded random-weight LPIPS file (the
   real file's shapes) named by ``GSLM_LPIPS_WEIGHTS``;
   ``render_sets.main --skip_train`` and ``metrics.main`` on phase 11's
   model (LPIPS not null, B once per pair); each pair's LPIPS on the card
   within 1e-4 relative of the same pair on CPU tensors (timed, peak
   memory); the test view rendered at the probe's capacities, written
   with ``render_sets.save_png`` and scored by ``metrics.evaluate_dir``
   (LPIPS on) within 0.05 dB of ``train.evaluate``; then
   ``utils.paritycheck.run_parity_matrix()`` at full size (2,048
   Gaussians, 160x192: the kernels against their plain versions on the
   CPU), its table printed, every variant ok.
13. data-parallel training over ranks (cell train-dp2-131k-1080p). (a) A
   one-rank NCCL group in this process: ``make_dp_train_step`` on one view
   and ``make_dp_lm_step`` on phase 7's window equal ``train_step`` and
   ``lm_outer_step`` bit for bit. (b) Two gloo ranks spawned on the one
   card (NCCL refuses two ranks on one device), the collectives on CUDA
   tensors (which ones gloo takes is printed; every rank must take
   them): the data-parallel Adam step on 2 views (1 per rank) against
   ``train_step`` on the same 2 views (loss within 1e-6, parameters
   within 1e-5 where the gradient exceeds 1e-3 of its group's largest,
   ``xyz_gradient_accum`` within 1e-5 of its largest); the LM step on the
   window padded to 6 (3 views and 25 val views per rank) against
   ``lm_outer_step`` (best alpha equal, val loss and groups within rtol
   1e-4, xyz unmoved); ``train.main --mesh_data 2`` on phase 9's scene
   (50 iterations, density events at 25 and 50, test and checkpoint at
   50) and ``train_lm.main --mesh_data 2`` from that checkpoint for one
   LM iteration; every rank's state bit for bit equal to rank 0's after
   each; each rank launched A, B, C and E. Prints the steps' times per
   rank against the single process, the gradient all-reduce's time and
   bytes, each rank's busy share and launches.
14. the model axis over ranks (cell train-mp2-m1-1080p): two gloo ranks
   spawned on the one card as a (1 data, 2 model) mesh, each holding
   524,288 of the million-Gaussian scene's rows (phase 8's scene, bucket
   1), the model axis's collectives on CUDA tensors (which ones gloo
   takes is printed; every rank must take them). Each rank's band of the
   1080p view, with the all_gather exchange and routed at R = 2·Pl/M,
   against the single process's ``render`` (within 1e-6, bit for bit
   reported; the 8 rows past H zero; no overflow); ``make_mp_train_step``
   with both exchanges against ``train_step`` (phase 13's tolerances);
   ``make_mp_lm_step`` on phase 7's window (50 val views in one pass per
   alpha, capacities from ``band_probe``) against ``lm_outer_step`` (best
   alpha equal, val loss and groups within rtol 1e-4); ``train.main
   --mesh_model 2`` on phase 9's scene (50 iterations, events at 25 and
   50, test, save, checkpoint), the sharded checkpoint round trip and its
   gather against the npz bit for bit, ``train_lm.main --mesh_model 2``
   for one LM iteration (5 val views). On each rank kernels A, B and C on
   the Adam step's band inputs and E on the LM step's first J·v against
   their plain versions, launches {A 1, B 2, C 1} per Adam step and {A 8,
   C 4, E 6} per LM step. Prints per rank each step against the single
   process, the exchanges' and the reduce-scatter's times and bytes, the
   busy share, the peak memory and the launches.
15. the quality harness (cell quality-small-64, ``tools/quality.py``):
   Adam with densification from a sparse noisy start to a plateau, then
   200 more Adam steps against the LM steps that cost as many renders
   (windows of 3 views, 3 validation views, CG 2, 7 alphas, xyz free),
   at the JAX package's slow-test size (400 rich Gaussians, 60 to start
   in 1,024 slots, 6 views of 64x64, 1,400 Adam iterations, density
   events to 900), for seed 0 alone: one seed takes 209-359 s on the
   card, three would take the script past its time limit, and the tool
   runs the three. It runs in a process of its own, started before phase
   11 and joined after phase 14 (all host-bound, the card mostly idle),
   so its walls and those of phases 11-14 include the sharing. Checks:
   no Adam step overflowed; the plateau more than 8 dB above the start
   and above 24 dB with more than 300 Gaussians alive; LM gain > 0.1 dB
   and > Adam gain − 0.05 dB; launches
   {A 1, B 2, C 1} per Adam step and ``lm_launch_rule``'s per LM step;
   kernels A, B and C on an Adam step's inputs at seed 0's plateau and E
   on its first LM step's against their plain versions. Prints the
   plateau, gains, phase times, launches and largest tile loads.
16. a ``{"kernels": [...]}`` line (A-E, then F, G and H), then the last
   line ``{"ok": true, "device": {...}}``.

Kernel G (the front end's cull masks) runs once per front end: once per
render (kernel A) and per J·v (kernel E), and once per ``overflow_probe``
with culling on. Every phase's launch checks count it: 1 per
``batch_render``, ``train_step`` and Adam or SGD attempt, 77 per
``lm_outer_step`` (71 renders, 6 J·v), 14 per model-axis LM step, one
per chunk of ``render_sets``, none in ``metrics``, and per command-line
LM iteration 77 and one per probe of its window and validation views.
Phase 4 holds it bit for bit (``torch.equal``, all five outputs) to
``_cell_masks_plain`` on the 4-view stack and times both against its byte
bound; its entry in the kernels line gives its launches by path.

Kernel H (the per-Gaussian preprocess) runs once per view of every
preprocess that needs no autograd: 1 per ``render`` and per view of a
``batch_render`` or ``overflow_probe`` under ``no_grad``, none in
``train_step`` and Adam or SGD attempts (their preprocess records
autograd), none in J·v (forward-AD duals) or the LM linearization, 350
per ``lm_outer_step`` (7 alphas x 50 validation views). Every phase's
launch checks count it. Phase 4 holds it bit for bit to
``preprocess_plain`` on each view of the 4-view stack (every field of
``Splats2D``) and times both against its byte bound; its entry in the
kernels line gives its launches by path.

Imports nothing of JAX or of gslm_tpu. It finds the package beside itself
however it is started; without the package beside it, or without CUDA, it
exits non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

import numpy as np

# the package beside this script, however the script is started
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

N_GAUSS, H, W, VIEWS = 131_072, 1080, 1920, 4
# bench.py's single-view capacities (bench.py:196-199): the training view
TRAIN_CAPS = dict(dup_capacity=1_638_400, live_capacity=1_280_000, cull=True)
# ... scaled to the 4-view serving stack
CAPS = dict(dup_capacity=VIEWS * 1_638_400, live_capacity=VIEWS * 1_280_000,
            cull=True)
# bench.py's 5-view LM window capacities (bench.py:272-334)
LM_CAPS = dict(dup_capacity=6_654_208, live_capacity=5_469_696, cull=True)
# per lm_outer_step: A = 1 linearization + 7 alphas x 10 val chunks; C = 2
# restarts + 2 iterations (Jᵀ·u); E = 2 restarts + 2 iterations + 2
# divergence checks (J·v); G = one per front end, A + E; H = one per view
# of the no-grad validation renders, 7 alphas x 50 views
LM_LAUNCHES = {"A": 71, "B": 0, "C": 4, "E": 6, "G": 77, "H": 350}
EXPOSURES = 50         # bench.py's exposure images
TRAIN_STEPS = 10       # steps over which the loss must fall
PEAK_FP32 = 67e12      # H100 SXM fp32 outside the tensor cores, FLOP/s
PEAK_BYTES = 3.35e12   # H100 SXM HBM3, bytes/s
G_BYTES = 64           # kernel G's bytes per Gaussian: 44 read, 20 written
# kernel G's launches by path, filled as each phase checks them
G_LAUNCHES: dict[str, int] = {}
# kernel H's bytes per Gaussian at SH degree 3: 237 read (xyz, scaling,
# rotation, opacity, 48 SH floats, alive), 69 written (Splats2D)
H_BYTES = 306
# kernel H's launches by path, likewise
H_LAUNCHES: dict[str, int] = {}
# Issue rates behind PEAK_FP32 (an FMA counts two FLOPs): 128 fp32 lanes
# per SM per clock, each taking one FFMA, FADD or FMUL; the SFU (MUFU) has
# 16 lanes per SM per clock.
FP32_RATE = PEAK_FP32 / 2      # fp32 lane instructions/s
MUFU_RATE = FP32_RATE / 8      # MUFU lane instructions/s
# Kernel A's lane instructions per (record, pixel) pair, by how far the pair
# gets, as (FFMA+FADD+FMUL, MUFU), counted in the SASS of its patch-mapped
# pair loop (csrc/composite_fwd.cu; nvcc 12.9, sm_90a, the per-block counts
# `compare_fwd.py --sass-dir` writes; the earlier strip-mapped loop has the
# same counts):
A_EVAL = (9, 0)       # dx, dy, power, then the power > 0 gate
A_EXP = (7, 1)        # past it: expf (one MUFU.EX2), opacity, the 0.99 clip
A_CONTRIB = (24, 1)   # past the 1/255 gate: log1pf (16 and a predicated
#                       FFMA of its special case), lsum, expf
A_ACC = (5, 0)        # T_after >= 1e-4: weight and four accumulators
# ... and per staged record, its patch mask (1/c0, 1/c2, s2, then 8
# patches' quad_min_rect, unrolled by 2), on one lane: the design's own
# overhead, work the function does not need, so no bound counts it
A_MASK = (361, 2)
# Kernel C's, counted the same way in the patch-mapped loop of
# csrc/composite_bwd.cu (its 8x4 patches and patch mask, per-warp starts),
# for pairs before the pixel's exit (pairs at or past it cost an integer
# compare); kernel D's walk is the same code (composite_bwd_tile.cuh), and
# its SASS gives the same counts for pairs inside the rect gate (a gated
# record costs its rect test and the ballot, no fp32):
C_EVAL = (9, 0)       # dx, dy, power, then the power > 0 gate
C_EXP = (7, 1)        # past it: expf (MUFU.EX2), opacity, the 0.99 clip
C_CONTRIB = {True: (56, 2), False: (54, 2)}   # contributing, with and
#                       without depth_grad: log1pf (16), T = expf
#                       (MUFU.EX2), S / (1 - a) (MUFU.RCP), dw, da, S, the
#                       terms
C_SUM = (10, 0)       # the least reduction: one add per nonzero term (the
#                       kernel's reduce-scatter issues 12 FADD per lane for a
#                       contributing (record, warp) step of 2 or more lanes)
# ... and per staged record, its patch mask: 8 threads, one per patch,
# each (71, 2) (1/c0, 1/c2, s2 and one patch's quad_min_rect): the design's
# overhead, in no bound, as A_MASK
C_MASK = (8 * 71, 8 * 2)
# Kernel E's, counted the same way in the patch-mapped loop of
# csrc/composite_jvp.cu (kernel A's walk, gates and mask), by how far the
# pair gets:
E_EVAL = (9, 0)       # dx, dy, power, then the power > 0 gate
E_EXP = (7, 1)        # past it: expf (MUFU.EX2), opacity, the 0.99 clip
E_CONTRIB = (24, 1)   # past the 1/255 gate: log1pf (16), lsum, expf
E_ACC = (41, 1)       # T_after >= 1e-4: weight and accumulators, pow_dot,
#                       a_dot, T_dot, w_dot, 8 tangent accumulators and
#                       a_dot / (1 - a) (MUFU.RCP and its Newton step)
A_PER_PAIR = (A_EVAL, A_EXP, A_CONTRIB, A_ACC)
E_PER_PAIR = (E_EVAL, E_EXP, E_CONTRIB, E_ACC)
# bench.py's million-Gaussian configuration (bench.py:338-378): seed 2,
# 1,048,576 Gaussians, one 1080p view, bucket 4, capacities from its
# bucket-record probe + 5 % (its TPU run counted 2,207,812 AABB and
# 2,075,156 live bucket records, bench.py:351-352)
M1_N = 1_048_576
M1_CAPS = dict(dup_capacity=2_318_336, live_capacity=2_179_072, cull=True,
               bucket=4)
M1_BENCH_COUNTS = (2_207_812, 2_075_156)


def check(cond, what: str):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_times(fn, reps: int, warmup: int = 1) -> list[float]:
    """Milliseconds of each of ``reps`` calls of ``fn`` between CUDA events,
    after ``warmup`` untimed calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of ``fn`` between CUDA events."""
    return statistics.median(cuda_times(fn, reps, warmup))


def cuda_timed(fn):
    """``(fn(), its milliseconds between CUDA events)``: one call, timed
    where a check makes it anyway (the plain versions take seconds)."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def cuda_kernels(fn, cpu: bool = True) -> tuple[list, float]:
    """One profiled call of ``fn``: (its CUDA kernel events in start order,
    host wall time in ms, profiler overhead included). ``cpu=False``
    traces the device only (fewer events for a long call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return sorted(kernels, key=lambda e: e.time_range.start), wall


def kernels_ms(kernels: list) -> float:
    """Summed device time in ms of the CUDA kernel events ``kernels``."""
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3


def device_busy(fn, cpu: bool = True) -> tuple[int, float, float]:
    """One profiled call of ``fn`` (``cuda_kernels``): (CUDA kernels
    launched, their summed device time in ms, host wall time in ms)."""
    kernels, wall = cuda_kernels(fn, cpu)
    return len(kernels), kernels_ms(kernels), wall


def host_top_ops(fn, n: int = 6) -> list:
    """One profiled call of ``fn``: its ``n`` operators with the most host
    self time, as [name, ms, calls]."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    ops = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return [[e.key, round(e.self_cpu_time_total / 1e3, 3), e.count]
            for e in ops[:n]]


@contextlib.contextmanager
def backward_inputs():
    """Collects, for every ``Composite.backward`` run inside the block, the
    arguments of the kernel it launches: kernel C's (records, starts,
    counts, ntx, view_rows, gtiles, exit state, depth_grad) or, in bucket
    mode, kernel D's (records, buckets, ntx, view_rows, gtiles, exit state,
    depth_grad)."""
    from gslm_tpu_torch.ops import rasterize_cuda as rc
    real = rc.Composite.backward
    got = []

    def backward(ctx, gtiles, gwalked):
        records, starts, counts, tiles = ctx.saved_tensors
        ntx, view_rows, depth_grad = ctx.geometry
        rows = (gtiles[:, :rc.IMG_ROWS].clone(), tiles[:, rc.IMG_ROWS:],
                depth_grad)
        got.append((records, starts, counts, ntx, view_rows, *rows)
                   if ctx.buckets is None else
                   (records, ctx.buckets, ntx, view_rows, *rows))
        return real(ctx, gtiles, gwalked)

    rc.Composite.backward = staticmethod(backward)
    try:
        yield got
    finally:
        rc.Composite.backward = staticmethod(real)


@contextlib.contextmanager
def blur_inputs():
    """Collects, for every ``Blur`` forward and backward run inside the
    block, the arguments of the kernel-B launch it makes: (planes, taps),
    the backward's taps reversed."""
    from gslm_tpu_torch.ops import blur_cuda as bc
    real_fwd, real_bwd = bc.Blur.forward, bc.Blur.backward
    got = []

    def forward(ctx, img, taps):
        out = real_fwd(ctx, img, taps)
        got.append((img, ctx.taps))
        return out

    def backward(ctx, grad):
        got.append((grad.clone(), ctx.taps[::-1]))
        return real_bwd(ctx, grad)

    bc.Blur.forward = staticmethod(forward)
    bc.Blur.backward = staticmethod(backward)
    try:
        yield got
    finally:
        bc.Blur.forward = staticmethod(real_fwd)
        bc.Blur.backward = staticmethod(real_bwd)


def _counted_wrappers() -> dict:
    from gslm_tpu_torch.ops import rasterize_cuda as rc
    from gslm_tpu_torch.ops.blur_cuda import blur_same
    from gslm_tpu_torch.ops.projection import preprocess_cuda
    from gslm_tpu_torch.ops.rasterize_tiled import _cell_masks
    return {"A": rc.composite_tiles, "B": blur_same,
            "C": rc.composite_tiles_bwd, "D": rc.composite_tiles_bucket_bwd,
            "E": rc.composite_tiles_jvp, "G": _cell_masks,
            "H": preprocess_cuda}


def launches() -> dict:
    """Each kernel's launch count since the last ``zero_launches``."""
    return {k: f.launches for k, f in _counted_wrappers().items()}


def zero_launches() -> None:
    for f in _counted_wrappers().values():
        f.launches = 0


def caps_from_counts(n_aabb: int, n_live: int, bucket: int = 1):
    """Culled record capacities of ``overflow_probe``'s counts + 5 %."""
    import math

    from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
    return RasterConfig(dup_capacity=256 * math.ceil(1.05 * n_aabb / 256),
                        live_capacity=256 * math.ceil(1.05 * n_live / 256),
                        cull=True, bucket=bucket)


def knife_edge_ok(got, want, scale: float = 1.0) -> tuple[bool, float]:
    """The random-scene bound of the parity tests, relative to ``scale``:
    mean |Δ| < 2e-4·scale and at most 1% of values with |Δ| > 1e-3·scale.
    Returns (ok, max |Δ|)."""
    d = (got - want).abs()
    ok = (float(d.mean()) < 2e-4 * scale
          and float((d > 1e-3 * scale).float().mean()) <= 0.01)
    return ok, float(d.max())


def _pair_geometry(records, starts, tiles, S, ntx, view_rows, rects=None):
    """Records of G tiles over S slots, their power at every pixel and, with
    ``rects``, the rect gate: (rec (G, S, 10), power (G, S, 256), gate
    (G, S, 1) bool, all True without ``rects``, the records' rows (G, S))."""
    import torch

    from gslm_tpu_torch.ops.rasterize_cuda import _tile_pixels, rect_gate
    slot = torch.arange(S, device=records.device)
    idx = torch.clamp(starts[tiles, None].long() + slot[None], 0,
                      records.shape[0] - 1)
    rec = records[idx]
    px, py = _tile_pixels(tiles, ntx, view_rows)
    dx = rec[..., 0, None] - px[:, None]                      # (G, S, 256)
    dy = rec[..., 1, None] - py[:, None]
    power = (-0.5 * (rec[..., 2, None] * dx * dx
                     + rec[..., 4, None] * dy * dy)
             - rec[..., 3, None] * dx * dy)
    gate = (torch.ones_like(idx, dtype=torch.bool) if rects is None
            else rect_gate(rects[idx], tiles, ntx, view_rows))
    return rec, power, gate[..., None], idx


def fwd_work(records, starts, counts, ntx: int, view_rows: int,
             rects=None, max_elems: int = 1 << 25) -> dict:
    """A forward walker's work on these inputs from the plain arithmetic,
    each as [evaluated (the pixel has not exited), past the power gate, past
    the 1/255 gate, accumulated (T_after >= 1e-4)]:

    - "lane": (record, pixel) pairs, then, with ``rects``, the pairs the
      rect gate skips before the pixel's exit (kernels A's and E's work
      before the patch mask);
    - "lane culled": the pairs in patches whose ``patch_masks`` bit is set;
    - "warp strip", "warp patch", "warp patch mask": (record, warp) steps
      by the furthest outcome any live lane of the warp reaches, warps
      owning 16x2 strips (the earlier kernels A and E), 8x4 patches
      (``PATCH_PIXELS``), and 8x4 patches that skip records whose bit is
      clear (kernels A and E).

    Checks that no pair past the 1/255 gate has its patch bit clear."""
    import torch

    from gslm_tpu_torch.ops.composite import ALPHA_MAX, ALPHA_MIN, T_EPS
    from gslm_tpu_torch.ops.rasterize_cuda import (PATCH_PIXELS, PIX,
                                                   patch_masks)
    dev = records.device
    ntiles = counts.shape[0]
    S = max(int(counts.max()), 1)
    G = max(1, max_elems // (S * PIX))
    slot = torch.arange(S, device=dev)
    perm = torch.as_tensor(PATCH_PIXELS, device=dev)
    patch_of = torch.empty(PIX, dtype=torch.long, device=dev)
    patch_of[perm] = torch.arange(PIX, device=dev) // 32
    shift = torch.arange(PIX // 32, device=dev, dtype=torch.int32)
    n = {k: torch.zeros(4, dtype=torch.long, device=dev)
         for k in ("lane", "lane culled", "warp strip", "warp patch",
                   "warp patch mask")}
    gated, unsound = 0, 0
    for t0 in range(0, ntiles, G):
        tiles = torch.arange(t0, min(t0 + G, ntiles), device=dev)
        rec, power, gate, idx = _pair_geometry(records, starts, tiles, S,
                                               ntx, view_rows, rects)
        listed = (slot[None] < counts[tiles, None])[..., None]   # (G, S, 1)
        valid = listed & gate
        past_exp = valid & (power <= 0.0)
        alpha = torch.clamp(
            rec[..., 5, None] * torch.exp(torch.where(past_exp, power, -100.0)),
            max=ALPHA_MAX)
        past_con = past_exp & (alpha >= ALPHA_MIN)
        t_after = torch.exp(torch.cumsum(
            torch.log1p(-torch.where(past_con, alpha, 0.0)), dim=1))
        fail = (past_con & (t_after < T_EPS)).int()
        live = (torch.cumsum(fail, dim=1) - fail) == 0
        del power, alpha, t_after
        outcome = [valid & live, past_exp & live, past_con & live,
                   past_con & live & (fail == 0)]
        gated += int((listed & ~gate & live).sum())
        bits = ((patch_masks(rec, tiles, ntx, view_rows,
                             None if rects is None else rects[idx])[..., None]
                 >> shift) & 1).bool()                           # (G, S, 8)
        on = bits[..., patch_of]                                 # (G, S, 256)
        unsound += int((outcome[2] & ~on).sum())
        level = sum(o.to(torch.int8) for o in outcome)           # 0..4
        warp = {"warp strip": level.view(*level.shape[:2], 8, 32),
                "warp patch": level[..., perm].view(*level.shape[:2], 8, 32)}
        warp = {k: v.amax(dim=-1) for k, v in warp.items()}     # (G, S, 8)
        warp["warp patch mask"] = warp["warp patch"] * bits
        for k in range(4):
            n["lane"][k] += outcome[k].sum()
            n["lane culled"][k] += (outcome[k] & on).sum()
            for name, lv in warp.items():
                n[name][k] += (lv > k).sum()
    check(unsound == 0, f"patch_masks cleared the bit of {unsound} pairs "
          f"past the 1/255 gate")
    out = {k: [int(x) for x in v.tolist()] for k, v in n.items()}
    if rects is not None:
        out["lane"].append(gated)
    return out


def fwd_ops(work, per_pair) -> tuple[int, int]:
    """(fp32, MUFU) lane instructions of a forward walker (kernel A, E)
    over counts of ``fwd_work``, ``per_pair`` its (EVAL, EXP, CONTRIB, ACC)
    counts."""
    return tuple(sum(n * c[i] for n, c in zip(work, per_pair))
                 for i in (0, 1))


def bwd_ops(work, per_pair) -> tuple[int, int]:
    """(fp32, MUFU) lane instructions of the reverse walk (kernels C, D)
    over counts of ``c_work``, ``per_pair`` its (EVAL, EXP, CONTRIB, SUM)
    counts."""
    _, evaluated, past_power, contrib = work[:4]
    ev, ex, con, sm = per_pair
    return tuple(evaluated * ev[i] + past_power * ex[i]
                 + contrib * (con[i] + sm[i]) for i in (0, 1))


def a_report(tag: str, label: str, records, starts, counts, ntx: int,
             view_rows: int, walked, ms: float, rects=None) -> dict:
    """Kernel A's work on these inputs (``fwd_work``), its two bounds and
    the warp-issue estimates, printed; returns them with the bound the
    table takes (the lower) and what sets it. Bytes: records (and rects)
    walked, starts + counts in, 7 output rows + walked out. The culled lane
    bound counts only the pairs in patches whose mask bit is set. The
    mask's own instructions per staged record (``A_MASK``) are the design's
    overhead: printed apart, and counted only in the warp-issue estimate of
    the masked walk. A warp-issue estimate counts 32 lanes for every
    (record, warp) step at its furthest outcome."""
    w = fwd_work(records, starts, counts, ntx, view_rows, rects)
    n_walked = int(walked.long().sum())
    nbytes = (n_walked * (40 if rects is None else 56)
              + counts.shape[0] * (7 * 256 * 4 + 12))
    mask_ops = (n_walked * A_MASK[0], n_walked * A_MASK[1])
    mask_t = bound_times(*mask_ops, 0)[1]

    def plus_mask(ops):
        return [a + b for a, b in zip(ops, mask_ops)]

    lane_t, lane, lane_by = bound_times(*fwd_ops(w["lane"], A_PER_PAIR),
                                        nbytes)
    culled_t, culled, culled_by = bound_times(
        *fwd_ops(w["lane culled"], A_PER_PAIR), nbytes)
    est = {"16x2 strips (earlier design)": bound_times(*fwd_ops(
               [32 * c for c in w["warp strip"]], A_PER_PAIR), nbytes)[1],
           "8x4 patches": bound_times(*fwd_ops(
               [32 * c for c in w["warp patch"]], A_PER_PAIR), nbytes)[1],
           "8x4 patches with mask": bound_times(*plus_mask(fwd_ops(
               [32 * c for c in w["warp patch mask"]], A_PER_PAIR)),
               nbytes)[1]}
    print(f"{tag} kernel A {label}: pairs [evaluated, past power gate, past "
          f"1/255 gate, accumulated{', rect-gated' if rects is not None else ''}] "
          f"{w['lane']}, in masked-in patches {w['lane culled']}; (record, "
          f"warp) steps by furthest outcome: 16x2 strips {w['warp strip']}, "
          f"8x4 patches {w['warp patch']}, with the mask "
          f"{w['warp patch mask']}; {n_walked} records staged", flush=True)
    print(f"{tag} kernel A {label}: {ms:.3f} ms; lane bound {lane:.4f} ms ("
          + ", ".join(f"{k} {v:.4f}" for k, v in lane_t.items())
          + f"), culled lane bound {culled:.4f} ms ("
          + ", ".join(f"{k} {v:.4f}" for k, v in culled_t.items())
          + f"); the mask's overhead {mask_t:.4f} ms ({mask_ops[0]} fp32 + "
          f"{mask_ops[1]} MUFU lane instructions, in no bound)"
          + "; warp-issue estimate (ms) "
          + ", ".join(f"{k} {v:.4f}" for k, v in est.items()), flush=True)
    bound, by = min((lane, lane_by), (culled, culled_by))
    return {"work": w, "bound": bound, "by": by, "lane bound": lane,
            "culled bound": culled, "mask overhead": mask_t,
            "warp issue": est}


def c_work(records, starts, counts, ntx: int, view_rows: int, state,
           rects=None, max_elems: int = 1 << 25) -> dict:
    """Kernel C's work on these inputs from the plain arithmetic and kernel
    A's exit state ``state`` (ntiles, 2, 256), each as [walked, evaluated
    (before the pixel's exit), past the power gate, contributing]; with
    ``rects`` kernel D's (``starts``/``counts`` each tile's bucket
    segment), whose evaluated pairs are those inside the rect gate:

    - "lane": (record, pixel) pairs, walked = the records below the tile's
      largest exit position times 256;
    - "lane culled": the same in patches whose ``patch_masks`` bit is set,
      walked = records below the warp's own largest exit with the bit set,
      times 32 (what the kernel walks);
    - "warp strip", "warp patch mask": (record, warp) steps by the furthest
      outcome any lane reaches, the earlier design's 16x2 strips over every
      record below the block's largest exit, and the kernel's 8x4 patches
      over the records below the warp's largest exit whose bit it has;
    - "staged": records staged (the tiles' largest exit positions);
    - with ``rects``, "staged in rect": those inside the rect gate (the
      ones whose patch bits the kernel tests), and "rect-gated": the pairs
      before their pixel's exit that the gate skips.

    Checks that no contributing pair has its patch bit clear."""
    import torch

    from gslm_tpu_torch.ops.composite import ALPHA_MAX, ALPHA_MIN
    from gslm_tpu_torch.ops.rasterize_cuda import (PATCH_PIXELS, PIX,
                                                   patch_masks)
    dev = records.device
    ntiles = counts.shape[0]
    exit_pos = state[:, 1].long()                               # (T, 256)
    n_eff = exit_pos.amax(dim=1)
    S = max(int(n_eff.max()), 1)
    G = max(1, max_elems // (S * PIX))
    slot = torch.arange(S, device=dev)
    perm = torch.as_tensor(PATCH_PIXELS, device=dev)
    patch_of = torch.empty(PIX, dtype=torch.long, device=dev)
    patch_of[perm] = torch.arange(PIX, device=dev) // 32
    shift = torch.arange(PIX // 32, device=dev, dtype=torch.int32)
    n = {k: torch.zeros(4, dtype=torch.long, device=dev)
         for k in ("lane", "lane culled", "warp strip", "warp patch mask")}
    unsound, gated, staged_in = 0, 0, 0
    for t0 in range(0, ntiles, G):
        tiles = torch.arange(t0, min(t0 + G, ntiles), device=dev)
        rec, power, gate, idx = _pair_geometry(records, starts, tiles, S, ntx,
                                               view_rows, rects)
        xp = exit_pos[tiles]                                     # (G, 256)
        walked = slot[None] < n_eff[tiles, None]                 # (G, S)
        before = slot[None, :, None] < xp[:, None, :]            # (G, S, 256)
        gated += int((before & ~gate).sum())
        staged_in += int((walked & gate[..., 0]).sum())
        before &= gate
        past = before & (power <= 0.0)
        alpha = torch.clamp(
            rec[..., 5, None] * torch.exp(torch.where(past, power, -100.0)),
            max=ALPHA_MAX)
        con = past & (alpha >= ALPHA_MIN)
        del power, alpha
        bits = ((patch_masks(rec, tiles, ntx, view_rows,
                             None if rects is None else rects[idx])[..., None]
                 >> shift) & 1).bool()                           # (G, S, 8)
        warp_eff = xp[:, perm].view(-1, 8, 32).amax(dim=-1)      # (G, 8)
        walk = bits & (slot[None, :, None] < warp_eff[:, None])  # (G, S, 8)
        on = walk[..., patch_of]                                 # (G, S, 256)
        unsound += int((con & ~bits[..., patch_of]).sum())
        level = (before.to(torch.int8) + past.to(torch.int8)
                 + con.to(torch.int8))                           # 0..3
        strip = level.view(*level.shape[:2], 8, 32).amax(dim=-1)
        patch = level[..., perm].view(*level.shape[:2], 8, 32).amax(dim=-1)
        n["lane"][0] += walked.sum() * PIX
        n["lane culled"][0] += walk.sum() * 32
        n["warp strip"][0] += walked.sum() * 8
        n["warp patch mask"][0] += walk.sum()
        for k, o in enumerate((before, past, con)):
            n["lane"][k + 1] += o.sum()
            n["lane culled"][k + 1] += (o & on).sum()
            n["warp strip"][k + 1] += (strip > k).sum()
            n["warp patch mask"][k + 1] += ((patch > k) & walk).sum()
    check(unsound == 0, f"patch_masks cleared the bit of {unsound} "
          f"contributing pairs")
    out = {k: [int(x) for x in v.tolist()] for k, v in n.items()}
    out["staged"] = int(n_eff.sum())
    if rects is not None:
        out["staged in rect"], out["rect-gated"] = staged_in, gated
    return out


def c_report(tag: str, label: str, records, starts, counts, ntx: int,
             view_rows: int, state, depth_grad: bool, ms: float,
             rects=None) -> dict:
    """Kernel C's work on these inputs (``c_work``), or with ``rects``
    kernel D's (``starts``/``counts`` each tile's bucket segment): the lane
    bound (every pair before its pixel's exit, inside the rect gate) and
    the culled lane bound (only those in patches whose mask bit is set: the
    table takes the lower), and the mask's overhead (``C_MASK`` per staged
    record, inside the rect gate for D; in no bound), printed. D's walk is
    C's code: the same ``C_*`` counts per pair. Bytes: records (and rects)
    read and drec written once, gtiles + exit state per tile, the segment
    table; D's scratch, which the function does not need, in no bound."""
    kernel = "C" if rects is None else "D"
    w = c_work(records, starts, counts, ntx, view_rows, state, rects)
    per_pair = (C_EVAL, C_EXP, C_CONTRIB[depth_grad], C_SUM)
    n = records.shape[0]
    nbytes = (min(w["staged"], n) * 40 + n * 40
              + (0 if rects is None else n * 16)
              + counts.shape[0] * (7 * 256 * 4 + 8))
    masked = w.get("staged in rect", w["staged"])
    mask_ops = (masked * C_MASK[0], masked * C_MASK[1])
    mask_t = bound_times(*mask_ops, 0)[1]
    lane_t, lane, lane_by = bound_times(*bwd_ops(w["lane"], per_pair),
                                        nbytes)
    culled_t, culled, culled_by = bound_times(
        *bwd_ops(w["lane culled"], per_pair), nbytes)
    gate = ("" if rects is None else
            f", rect-gated {w['rect-gated']}; {masked} of them inside the "
            f"rect gate ({n} in segments)")
    print(f"{tag} kernel {kernel} {label}: pairs [walked, evaluated, past "
          f"power gate, contributing] {w['lane']}, in masked-in patches "
          f"{w['lane culled']}; (record, warp) steps by furthest outcome: "
          f"16x2 strips from the block's largest exit (earlier design) "
          f"{w['warp strip']}, 8x4 patches with the mask from the warp's "
          f"own {w['warp patch mask']}; {w['staged']} records staged{gate}",
          flush=True)
    print(f"{tag} kernel {kernel} {label}: {ms:.3f} ms; lane bound "
          f"{lane:.4f} ms ("
          + ", ".join(f"{k} {v:.4f}" for k, v in lane_t.items())
          + f"), culled lane bound {culled:.4f} ms ("
          + ", ".join(f"{k} {v:.4f}" for k, v in culled_t.items())
          + f"); the mask's overhead {mask_t:.4f} ms ({mask_ops[0]} fp32 + "
          f"{mask_ops[1]} MUFU lane instructions, in no bound)", flush=True)
    bound, by = min((lane, lane_by), (culled, culled_by))
    return {"work": w, "bound": bound, "by": by, "lane bound": lane,
            "culled bound": culled, "mask overhead": mask_t}


def e_report(tag: str, label: str, work: dict, n_walked: int, ntiles: int,
             ms: float) -> dict:
    """Kernel E's two bounds on inputs whose ``fwd_work`` is ``work`` (E
    walks kernel A's pairs, patches and mask: ``E_*`` per pair), and the
    mask's overhead (``A_MASK`` per staged record, kernel A's code, in no
    bound), printed. Bytes: records and tangents walked, starts + counts
    in, 7 + 5 rows out."""
    nbytes = n_walked * 80 + ntiles * ((7 + 5) * 256 * 4 + 8)
    mask_t = bound_times(n_walked * A_MASK[0], n_walked * A_MASK[1], 0)[1]
    lane_t, lane, lane_by = bound_times(*fwd_ops(work["lane"], E_PER_PAIR),
                                        nbytes)
    culled_t, culled, culled_by = bound_times(
        *fwd_ops(work["lane culled"], E_PER_PAIR), nbytes)
    print(f"{tag} kernel E {label}: pairs [evaluated, past power gate, past "
          f"1/255 gate, accumulated] {work['lane'][:4]}, in masked-in "
          f"patches {work['lane culled']}; (record, warp) steps by furthest "
          f"outcome, 16x2 strips (earlier design) {work['warp strip']}, 8x4 "
          f"patches with the mask {work['warp patch mask']}; {n_walked} "
          f"records staged; {ms:.3f} ms; lane bound {lane:.4f} ms ("
          + ", ".join(f"{k} {v:.4f}" for k, v in lane_t.items())
          + f"), culled lane bound {culled:.4f} ms ("
          + ", ".join(f"{k} {v:.4f}" for k, v in culled_t.items())
          + f"); the mask's overhead {mask_t:.4f} ms (in no bound)",
          flush=True)
    bound, by = min((lane, lane_by), (culled, culled_by))
    return {"bound": bound, "by": by, "lane bound": lane,
            "culled bound": culled, "mask overhead": mask_t}


def d_split(kernels: list, calls: int) -> dict:
    """Kernel D's two CUDA kernels apart in the CUDA kernel events
    ``kernels`` of a trace that ran D ``calls`` times: the median device ms
    per call of ``bucket_walk_kernel``, of ``bucket_sum_kernel`` and of the
    two together. Fails unless each ran ``calls`` times."""
    ms = {k: [e.time_range.elapsed_us() / 1e3 for e in kernels
              if name in e.name]
          for k, name in (("walk", "bucket_walk_kernel"),
                          ("sum", "bucket_sum_kernel"))}
    counts = {k: len(t) for k, t in ms.items()}
    check(all(n == calls for n in counts.values()),
          f"a trace of {calls} launches of kernel D holds {counts} launches "
          f"of its kernels among {len(kernels)} CUDA kernels")
    out = {k: statistics.median(t) for k, t in ms.items()}
    out["walk + sum"] = statistics.median(
        w + x for w, x in zip(ms["walk"], ms["sum"]))
    return out


def d_kernels_ms(args, reps: int = 5) -> dict:
    """``d_split`` of ``reps`` calls of ``composite_tiles_bucket_bwd(*args)``
    profiled together (``cuda_kernels``), after one untimed call."""
    from gslm_tpu_torch.ops import rasterize_cuda as rc
    rc.composite_tiles_bucket_bwd(*args)
    kernels, _ = cuda_kernels(lambda: [rc.composite_tiles_bucket_bwd(*args)
                                       for _ in range(reps)])
    return d_split(kernels, reps)


def c_vs_plain(label: str, records, starts, counts, ntx: int,
               view_rows: int, gtiles, state, depth_grad) -> float:
    """Kernel C on a path's own inputs against its plain version per field
    (knife-edge bound relative to max |plain|), and bit for bit against
    itself and against the guard C<MASK=false> (every patch bit set, so a
    patch bit that C clears for a contributing pair shows); printed.
    Returns max |Δ|."""
    import torch

    from gslm_tpu_torch.ops import rasterize_cuda as rc
    args = (records, starts, counts, ntx, view_rows, gtiles, state,
            depth_grad)
    got = rc.composite_tiles_bwd(*args)
    again = rc.composite_tiles_bwd(*args)
    guard = rc.composite_tiles_bwd_unmasked(*args)
    want = rc.composite_tiles_bwd_plain(*args[:6], depth_grad)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"kernel C is not bitwise repeatable on "
          f"{label}")
    check(torch.equal(got.view(torch.int32), guard.view(torch.int32)),
          f"kernel C differs from the guard C<MASK=false>'s on {label}")
    del again, guard
    check(bool(torch.isfinite(got).all()), f"kernel C gave non-finite values "
          f"on {label}")
    err, rel = 0.0, []
    for f in range(rc.NF):
        scale = float(want[:, f].abs().max()) + 1e-30
        ok, e = knife_edge_ok(got[:, f], want[:, f], scale)
        check(ok, f"kernel C disagrees with its plain version on {label}, "
                  f"field {f}")
        err = max(err, e)
        rel.append(e / scale)
    print(f"kernel C vs plain ({label}, {records.shape[0]} records, "
          f"{counts.shape[0]} tiles, depth_grad {depth_grad}): max|d| "
          f"{err:.3g}; max|d|/max|plain| per field "
          f"{[float(f'{r:.3g}') for r in rel]}; two runs bitwise equal, "
          f"and bitwise equal to the guard C<MASK=false>'s", flush=True)
    return err


def guard_check(label: str, e_tiles, e_dot, a_tiles, records, tangents,
                starts, counts, ntx: int, view_rows: int,
                rects=None) -> None:
    """Kernel E's primal ``e_tiles`` and kernel A's rows ``a_tiles`` on the
    same inputs, each ``torch.equal`` to the guard E<MASK=false>'s (every
    record through pair_alpha, no patch mask), and E's tangent ``e_dot``
    within 1e-6 of max |guard| per row; printed."""
    import torch

    from gslm_tpu_torch.ops import rasterize_cuda as rc
    guard, guard_dot = rc.composite_tiles_jvp_unmasked(
        records, tangents, starts, counts, ntx, view_rows, rects)
    torch.cuda.synchronize()
    check(torch.equal(e_tiles, guard), f"kernel E's primal differs from the "
          f"guard E<MASK=false>'s on {label}")
    check(torch.equal(a_tiles, guard), f"kernel A's rows differ from the "
          f"guard E<MASK=false>'s on {label}")
    rel = [float((e_dot[:, r] - guard_dot[:, r]).abs().max())
           / (float(guard_dot[:, r].abs().max()) + 1e-30)
           for r in range(rc.IMG_ROWS)]
    check(max(rel) <= 1e-6, f"kernel E's tangent differs from the guard's "
          f"on {label}: {rel}")
    print(f"guard E<MASK=false> on {label}: kernel A's rows and kernel E's "
          f"primal rows 0-6 bitwise equal to it; E's tangent "
          + ("bitwise equal" if torch.equal(e_dot, guard_dot) else
             f"max|d|/max|guard| per row {[float(f'{r:.3g}') for r in rel]}"),
          flush=True)


def e_vs_plain(label: str, rec, tng, st, cn, ntx: int, nty: int) -> dict:
    """Kernel E on a path's records ``rec`` and tangents ``tng``: its primal
    bitwise equal to kernel A's, both to the guard E<MASK=false>'s
    (``guard_check``), bit for bit repeatable, and against its plain
    version (knife-edge bound; the tangent per row relative to max
    |plain|); printed. Returns dict(err, vs_a, plain_ms, walked)."""
    import torch

    from gslm_tpu_torch.ops import rasterize_cuda as rc
    got, got_dot = rc.composite_tiles_jvp(rec, tng, st, cn, ntx, nty)
    again, again_dot = rc.composite_tiles_jvp(rec, tng, st, cn, ntx, nty)
    fwd, walked = rc.composite_tiles(rec, st, cn, ntx, nty)
    (want, want_dot), plain_ms = cuda_timed(
        lambda: rc.composite_tiles_jvp_plain(rec, tng, st, cn, ntx, nty))
    e_vs_a = float((got - fwd).abs().max())
    print(f"kernel E vs kernel A ({label}), primal rows 0-6 ({rec.shape[0]} "
          f"records, {cn.shape[0]} tiles): max|d| {e_vs_a:.3g}"
          f"{' (bitwise equal)' if torch.equal(got, fwd) else ''}",
          flush=True)
    check(torch.equal(got, fwd), f"kernel E's primal differs from kernel A's "
          f"on {label}")
    guard_check(label, got, got_dot, fwd, rec, tng, st, cn, ntx, nty)
    check(torch.equal(got, again) and torch.equal(got_dot, again_dot),
          f"kernel E is not bitwise repeatable on {label}")
    check(bool(torch.isfinite(got_dot).all()), f"kernel E: non-finite "
          f"tangent on {label}")
    ok, err = knife_edge_ok(got[:, :rc.IMG_ROWS], want[:, :rc.IMG_ROWS])
    check(ok, f"kernel E's primal disagrees with its plain version on "
          f"{label}")
    rel = []
    for row in range(rc.IMG_ROWS):
        scale = float(want_dot[:, row].abs().max()) + 1e-30
        ok, e = knife_edge_ok(got_dot[:, row], want_dot[:, row], scale)
        check(ok, f"kernel E's tangent disagrees with plain on {label}, row "
              f"{row}")
        err = max(err, e)
        rel.append(e / scale)
    print(f"kernel E vs plain ({label}): max|d| {err:.3g}; tangent "
          f"max|d|/max|plain| per row {[float(f'{r:.3g}') for r in rel]}; "
          f"two runs bitwise equal", flush=True)
    return {"err": err, "vs_a": e_vs_a, "plain_ms": plain_ms,
            "walked": walked}


def bound_times(fp32: int, mufu: int, nbytes: int) -> tuple[dict, float,
                                                             str]:
    """The least times (ms) of ``fp32`` and ``mufu`` lane instructions and
    ``nbytes`` moved on this card, the bound (the largest) and what sets it
    ("operations" or "bytes")."""
    times = {"fp32 issue": fp32 / FP32_RATE * 1e3,
             "MUFU issue": mufu / MUFU_RATE * 1e3,
             "bytes": nbytes / PEAK_BYTES * 1e3}
    ms = max(times.values())
    return times, ms, "bytes" if ms == times["bytes"] else "operations"


def kernel_attrs(lib, fn: str, instances: tuple) -> dict:
    """Registers per thread, static shared memory per block and resident
    256-thread blocks per SM of each instantiation (``instances``, in the
    order the library's ``fn`` reports them)."""
    import ctypes

    from gslm_tpu_torch import _build
    out = (ctypes.c_int * (3 * len(instances)))()
    _build.check(getattr(lib, fn)(ctypes.addressof(out)), fn)
    return {inst: {"registers": out[3 * k], "shared_bytes": out[3 * k + 1],
                   "blocks_per_sm": out[3 * k + 2]}
            for k, inst in enumerate(instances)}


def fwd_attrs(lib) -> dict:
    """``kernel_attrs`` of a kernel A library's two instantiations."""
    return kernel_attrs(lib, "composite_fwd_attrs", ("bucket 1", "rects"))


def bwd_attrs(lib) -> dict:
    """``kernel_attrs`` of kernel C's two instantiations."""
    return kernel_attrs(lib, "composite_bwd_attrs",
                        ("depth_grad", "no depth_grad"))


def bucket_bwd_attrs(lib) -> dict:
    """``kernel_attrs`` of kernel D's walk (depth_grad) and sum."""
    return kernel_attrs(lib, "composite_bucket_bwd_attrs",
                        ("walk, depth_grad", "sum"))


def jvp_attrs(lib) -> dict:
    """``kernel_attrs`` of kernel E's four instantiations."""
    return kernel_attrs(lib, "composite_jvp_attrs",
                        ("bucket 1", "rects", "guard (MASK=false)",
                         "guard (MASK=false), rects"))


def main() -> int:
    import importlib.util
    if importlib.util.find_spec("gslm_tpu_torch") is None:
        print(f"chip_smoke: the package gslm_tpu_torch is not beside "
              f"{os.path.abspath(__file__)}: run the script from a checkout "
              f"of the repository", file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    run(torch.device("cuda"), N_GAUSS, H, W)
    return 0


def run(dev, n_gauss: int, height: int, width: int) -> None:
    """All phases on ``dev`` for an n_gauss scene at height x width."""
    import tempfile

    import torch

    from gslm_tpu_torch import _build
    from gslm_tpu_torch.ops.knn import mean_sq_dist_3nn
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("tf32: off for matmul and cuDNN (the library yardstick conv runs "
          "in full fp32)", flush=True)
    t0 = time.perf_counter()
    _build.build_all(verbose=True)
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a, "
          f"{len(_build.SIGNATURES)} kernels in parallel)", flush=True)
    attrs = {"A": fwd_attrs(_build.load("composite_fwd")),
             "C": bwd_attrs(_build.load("composite_bwd")),
             "D": bucket_bwd_attrs(_build.load("composite_bucket_bwd")),
             "E": jvp_attrs(_build.load("composite_jvp")),
             "F": kernel_attrs(_build.load("knn"), "knn_attrs",
                               F_INSTANCES),
             "G": kernel_attrs(_build.load("cell_masks"), "cell_masks_attrs",
                               ("thread per Gaussian",)),
             "H": kernel_attrs(_build.load("preprocess"), "preprocess_attrs",
                               ("degree 3, 128-thread blocks",))}
    for k, v in attrs.items():
        print(f"kernel {k} registers, static shared bytes, resident "
              f"{128 if k == 'H' else 256}-thread blocks per SM: {v}",
              flush=True)

    tag = f"[{card}]"
    kernels, g_entry, h_entry = serve_phase(dev, n_gauss, height, width, tag)
    kernels.append(train_phase(dev, n_gauss, height, width, tag, kernels))
    e_entry, lm_ref = lm_phase(dev, n_gauss, height, width, tag, kernels)
    kernels.append(e_entry)
    kernels.insert(3, bucket_phase(dev, M1_N, height, width, tag, kernels))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scene_") as root:
        src = scene_phase(dev, n_gauss, height, width, tag, kernels, root)
        f = kernels[5]
        with pcd_calls() as pcd:   # kernel F in phases 10-14's process
            mean_sq_dist_3nn.launches = 0
            adam_ms = cli_phase(dev, n_gauss, height, width, tag, kernels,
                                src, root)
            quality = quality_start(dev, tag, root)   # phase 15, beside 11-14
            try:
                model = depth_phase(dev, n_gauss, height, width, tag,
                                    kernels, src, root, adam_ms)
                lpips_parity_phase(dev, tag, kernels, model, root)
                dp_phase(dev, n_gauss, height, width, tag, kernels, src,
                         root, lm_ref)
                mp_phase(dev, n_gauss, M1_N, height, width, tag, kernels,
                         src, root, lm_ref)
                n_f = mean_sq_dist_3nn.launches
                check(n_f == len(pcd), f"kernel F launched {n_f} times in "
                      f"phases 10-14's process, by {len(pcd)} create_from_pcd "
                      f"calls: F runs only under create_from_pcd, once each")
                print(f"{tag} kernel F in phases 10-14's process: {n_f} "
                      f"launches, one per Scene load from a point cloud "
                      f"({len(pcd)}); none elsewhere", flush=True)
                f["launches_by_path"]["command_lines"] = n_f
                f["launches"] += n_f
                quality_finish(quality, tag, kernels)
            finally:
                for p in quality[0].processes:
                    if p.is_alive():
                        p.kill()
                        p.join()
    for entry, k in zip(kernels, "ABCDE"):
        if k in attrs:
            entry["attrs"] = attrs[k]
    g_entry.update(attrs=attrs["G"], launches=sum(G_LAUNCHES.values()),
                   launches_by_path=dict(G_LAUNCHES))
    h_entry.update(attrs=attrs["H"], launches=sum(H_LAUNCHES.values()),
                   launches_by_path=dict(H_LAUNCHES))
    kernels += [g_entry, h_entry]
    sass_totals()
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


def serve_phase(dev, n_gauss: int, height: int, width: int,
                tag: str) -> tuple[list[dict], dict, dict]:
    """Phases 2-4. Returns the kernel entries of A and B, and kernels G's
    and H's (their launches by path filled in at the end of the run)."""
    import torch

    from gslm_tpu_torch.eval.metrics import pair_metrics
    from gslm_tpu_torch.ops.blur_cuda import blur_plain, blur_same
    from gslm_tpu_torch.ops.projection import (Splats2D, preprocess,
                                               preprocess_cuda,
                                               preprocess_plain)
    from gslm_tpu_torch.ops.rasterize_cuda import (IMG_ROWS,
                                                   composite_tiles,
                                                   composite_tiles_bwd,
                                                   composite_tiles_plain,
                                                   tile_records)
    from gslm_tpu_torch.ops.rasterize_tiled import (RasterConfig, _cdiv,
                                                    _cell_masks,
                                                    _cell_masks_plain,
                                                    duplicate_sort_ranges)
    from gslm_tpu_torch.ops.ssim import gaussian_taps
    from gslm_tpu_torch.renderer import batch_render, render, stack_views
    from gslm_tpu_torch.utils.synthetic import (random_gaussians,
                                                ring_camera_batch)

    params = random_gaussians(np.random.default_rng(0), n=n_gauss,
                              capacity=n_gauss, sh_degree=3, spread=1.5,
                              scale_range=(-5.5, -3.5), device=dev)
    cams = ring_camera_batch(VIEWS, height, width, device=dev)
    cfg = RasterConfig(**CAPS)
    bg = torch.zeros(3, device=dev)
    ntx, nty = _cdiv(width, 16), _cdiv(height, 16)
    taps = gaussian_taps()
    err = {}

    with torch.no_grad():
        # ---- 2. kernels against their plain versions ---------------------
        sp0 = preprocess(params, cams.view(0), active_sh_degree=3,
                         alive=params.alive)
        rec0, st0, cn0, *_ = tile_records(sp0, ntx, nty, cfg)
        got, walked0 = composite_tiles(rec0, st0, cn0, ntx, nty)
        want, _ = composite_tiles_plain(rec0, st0, cn0, ntx, nty)
        torch.cuda.synchronize()
        ok, e = knife_edge_ok(got[:, :IMG_ROWS], want[:, :IMG_ROWS])
        flips = float((got[:, 6] != want[:, 6]).float().mean())
        print(f"kernel A vs plain (1 view, {rec0.shape[0]} records): "
              f"max|d| {e:.3g}; exit positions differ at {flips:.2e} of "
              f"pixels", flush=True)
        check(ok, "kernel A disagrees with composite_tiles_plain")
        check(flips <= 0.01, "kernel A's exit state disagrees with plain")
        check(bool((walked0 <= cn0).all()), "kernel A walked past a segment")

        planes = torch.rand(15, height, width, device=dev,
                            generator=torch.Generator(dev).manual_seed(0))
        got = blur_same(planes, taps)
        want = blur_plain(planes, taps)
        torch.cuda.synchronize()
        err["B"] = float((got - want).abs().max())
        b_bits = torch.equal(got, want)
        print(f"kernel B vs plain {tuple(planes.shape)}: max|d| {err['B']:.3g}"
              f" ({'bitwise equal' if b_bits else 'not bitwise'})", flush=True)
        check(b_bits, "kernel B differs from blur_plain")

        # ---- 3. serving path at full width -------------------------------
        composite_tiles.launches = 0
        blur_same.launches = 0
        composite_tiles_bwd.launches = 0
        _cell_masks.launches = 0
        preprocess_cuda.launches = 0
        out = batch_render(params, cams, bg, config=cfg)
        metrics = [pair_metrics(out.render[v], cams.gt_image[v])
                   for v in range(VIEWS)]
        torch.cuda.synchronize()
        launches = {"A": composite_tiles.launches, "B": blur_same.launches,
                    "C": composite_tiles_bwd.launches,
                    "G": _cell_masks.launches,
                    "H": preprocess_cuda.launches}
        print(f"serving path launches: {launches}", flush=True)
        check(launches == {"A": 1, "B": VIEWS, "C": 0, "G": 1, "H": VIEWS},
              f"serving path launches {launches}: expected A and G once per "
              f"batch_render, B once per pair, H once per view, C never")
        G_LAUNCHES["serve"] = launches["G"]
        H_LAUNCHES["serve"] = launches["H"]
        check(int(out.overflow) == 0, f"overflow (n_duplicates "
              f"{int(out.n_duplicates)})")
        check(out.render.shape == (VIEWS, 3, height, width), "render shape")
        check(bool(torch.isfinite(out.render).all())
              and bool(torch.isfinite(out.invdepth).all()), "finite images")
        ssims = [float(s) for s, _ in metrics]
        psnrs = [float(p) for _, p in metrics]
        check(all(np.isfinite(ssims + psnrs)) and all(-1 <= s <= 1
                                                      for s in ssims),
              "metrics finite")
        print(f"serving path: n_duplicates {int(out.n_duplicates)}, "
              f"max_tile_load {int(out.max_tile_load)}, visible/view "
              f"{[int(v.sum()) for v in out.visibility]}, mean "
              f"{float(out.render.mean()):.5f}, SSIM {ssims}, PSNR {psnrs}",
              flush=True)
        for v in range(VIEWS):
            one = render(params, cams.view(v), bg, config=cfg)
            check(torch.equal(one.render, out.render[v])
                  and torch.equal(one.invdepth, out.invdepth[v]),
                  f"batched view {v} differs from the single-view render")
        print(f"batched views 0-{VIEWS - 1} == single-view renders: bitwise",
              flush=True)

        # kernel A against its plain version on the path's own inputs: the
        # 4-view stack, where tile rows wrap modulo view_rows
        splats, _, _ = stack_views(params, cams, config=cfg)
        rec, st, cn, *_ = tile_records(splats, ntx, VIEWS * nty, cfg, nty)
        got, walked = composite_tiles(rec, st, cn, ntx, nty)
        want, _ = composite_tiles_plain(rec, st, cn, ntx, nty)
        torch.cuda.synchronize()
        ok, err["A"] = knife_edge_ok(got[:, :IMG_ROWS], want[:, :IMG_ROWS])
        print(f"kernel A vs plain ({VIEWS}-view stack, {cn.shape[0]} tiles, "
              f"{rec.shape[0]} records): max|d| {err['A']:.3g}", flush=True)
        check(ok, "kernel A disagrees with composite_tiles_plain on the stack")
        check(bool((walked <= cn).all()), "kernel A walked past a segment")

        # kernel G against its plain version on the same stack
        cwb = max(_cdiv(ntx, 8).bit_length(), 1)
        g_got = _cell_masks(splats, nty, cwb)
        g_want = _cell_masks_plain(splats, nty, cwb)
        torch.cuda.synchronize()
        g_equal = [torch.equal(a, b) for a, b in zip(g_got, g_want)]
        print(f"kernel G vs plain ({VIEWS}-view stack, "
              f"{splats.mean2d.shape[0]} rows): outputs bitwise equal "
              f"{g_equal} (3 words, cell size, nlive); nlive sum "
              f"{int(g_got[4].sum())}", flush=True)
        check(all(g_equal), "kernel G differs from _cell_masks_plain on the "
              "stack")
        del g_got, g_want

        # kernel H against the plain graph on each view of the same stack
        h_equal = {}
        for v in range(VIEWS):
            kw = dict(active_sh_degree=3, alive=params.alive)
            h_got = preprocess(params, cams.view(v), **kw)
            h_want = preprocess_plain(params, cams.view(v), **kw)
            for f in dataclasses.fields(Splats2D):
                a, b = getattr(h_got, f.name), getattr(h_want, f.name)
                if a.dtype.is_floating_point:
                    a, b = a.view(torch.int32), b.view(torch.int32)
                h_equal[f.name] = h_equal.get(f.name, True) and torch.equal(
                    a, b)
        print(f"kernel H vs plain ({VIEWS}-view stack, {VIEWS} x "
              f"{params.capacity} rows): fields bitwise equal {h_equal}",
              flush=True)
        check(all(h_equal.values()), "kernel H differs from preprocess_plain "
              "on the stack's views")
        del h_got, h_want

        small = random_gaussians(np.random.default_rng(1), n=2048,
                                 spread=1.5, device=dev)
        scams = ring_camera_batch(1, 72, 96, device=dev)
        ok, e = knife_edge_ok(
            batch_render(small, scams, bg, config=cfg).render,
            batch_render(small, scams, bg, config=cfg, impl="ref").render)
        print(f"small scene vs dense golden rasterizer: max|d| {e:.3g}",
              flush=True)
        check(ok, "kernel path disagrees with rasterize_ref")

        # ---- 4. serving timings ------------------------------------------
        br_times = cuda_times(
            lambda: batch_render(params, cams, bg, config=cfg), 5)
        br_ms = statistics.median(br_times)
        n_kern, busy_ms, wall_ms = device_busy(
            lambda: batch_render(params, cams, bg, config=cfg))
        pm_ms = cuda_ms(lambda: pair_metrics(out.render[0], cams.gt_image[0]),
                        10)
        stage = {
            "preprocess+stack": cuda_ms(
                lambda: stack_views(params, cams, config=cfg), 3),
            "cell masks": cuda_ms(lambda: _cell_masks(splats, nty, cwb), 3),
            "duplicate+sort+ranges (incl. cell masks)": cuda_ms(
                lambda: duplicate_sort_ranges(
                    splats, ntx, VIEWS * nty, cfg.dup_capacity,
                    view_rows=nty, cull=True,
                    live_capacity=cfg.live_capacity), 3),
            "tile_records (incl. the above + record gather)": cuda_ms(
                lambda: tile_records(splats, ntx, VIEWS * nty, cfg, nty), 3),
            "kernel A": cuda_ms(
                lambda: composite_tiles(rec, st, cn, ntx, nty), 10),
        }
        a_plain_ms = cuda_ms(
            lambda: composite_tiles_plain(rec, st, cn, ntx, nty), 2)
        g_plain_ms = cuda_ms(lambda: _cell_masks_plain(splats, nty, cwb), 2)
        g_bound = G_BYTES * splats.mean2d.shape[0] / PEAK_BYTES * 1e3
        view0 = cams.view(0)
        h_ms = cuda_ms(lambda: preprocess(params, view0, active_sh_degree=3,
                                          alive=params.alive), 20)
        h_plain_ms = cuda_ms(lambda: preprocess_plain(
            params, view0, active_sh_degree=3, alive=params.alive), 3)
        h_bound = H_BYTES * params.capacity / PEAK_BYTES * 1e3
        n_walked = int(walked.long().sum())
        ra = a_report(tag, f"({VIEWS}-view stack)", rec, st, cn, ntx, nty,
                      walked, stage["kernel A"])
        print(f"{tag} batch_render {VIEWS}x{width}x{height}: {br_ms:.3f} ms median "
              f"of 5 (runs {[round(t, 3) for t in br_times]}); pair_metrics "
              f"1 pair: {pm_ms:.3f} ms median of 10", flush=True)
        print(f"{tag} batch_render profiled once: {n_kern} CUDA kernels, "
              f"device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
              f"({busy_ms / wall_ms:.3f}; the profiler adds host time)",
              flush=True)
        print(f"{tag} batch_render stages (ms): "
              + ", ".join(f"{k} {v:.3f}" for k, v in stage.items()),
              flush=True)
        print(f"{tag} kernel A: {rec.shape[0]} records in segments, "
              f"{n_walked} walked ({n_walked / max(rec.shape[0], 1):.3f}), "
              f"{n_walked * 256} (record, pixel) pairs; {stage['kernel A']:.3f}"
              f" ms vs bound {ra['bound']:.4f} ms; plain {a_plain_ms:.3f} ms",
              flush=True)
        print(f"{tag} kernel G ({VIEWS}-view stack, {splats.mean2d.shape[0]} "
              f"rows): {stage['cell masks']:.4f} ms vs bound {g_bound:.5f} ms"
              f" (bytes: P x {G_BYTES} B at 3.35 TB/s); plain "
              f"{g_plain_ms:.3f} ms", flush=True)
        print(f"{tag} kernel H (one view, {params.capacity} rows): "
              f"{h_ms:.4f} ms vs bound {h_bound:.5f} ms (bytes: P x "
              f"{H_BYTES} B at 3.35 TB/s); plain {h_plain_ms:.3f} ms",
              flush=True)

        b_ms = cuda_ms(lambda: blur_same(planes, taps), 20)
        b_plain_ms = cuda_ms(lambda: blur_plain(planes, taps), 5)
        kh = torch.tensor(taps, device=dev).reshape(1, 1, -1, 1).repeat(
            15, 1, 1, 1)
        kw = kh.reshape(15, 1, 1, -1)
        lib = planes[None]

        def conv_blur():
            x = torch.nn.functional.conv2d(lib, kh, padding=(5, 0), groups=15)
            return torch.nn.functional.conv2d(x, kw, padding=(0, 5), groups=15)

        b_lib_err = float((conv_blur()[0] - blur_same(planes, taps)).abs().max())
        b_lib_ms = cuda_ms(conv_blur, 20)
        b_bytes = 2 * planes.numel() * 4
        # one FMUL and one FADD per tap per pass (no FMA: tap-order sums)
        b_ops = 2 * 2 * len(taps) * planes.numel()
        b_bound = max(b_bytes / PEAK_BYTES, b_ops / FP32_RATE) * 1e3
        print(f"{tag} kernel B {tuple(planes.shape)}: {b_ms:.4f} ms vs bound "
              f"{b_bound:.4f} ms; plain {b_plain_ms:.4f} ms; conv2d "
              f"depthwise (TF32 off) {b_lib_ms:.4f} ms, max|d| {b_lib_err:.3g}",
              flush=True)

    return [
        {"name": "composite_fwd", "route": "cuda",
         "source": "gslm_tpu_torch/csrc/composite_fwd.cu",
         "replaces": "gslm_tpu/ops/rasterize_pallas.py:440",
         "launches": launches["A"],
         "launches_by_path": {"serve": launches["A"]},
         "max_abs_err": err["A"],
         "ms": stage["kernel A"], "plain_ms": a_plain_ms,
         "bound_ms": ra["bound"], "bound_by": ra["by"], "library_ms": None,
         "lane_bound_ms": ra["lane bound"],
         "culled_bound_ms": ra["culled bound"],
         "mask_overhead_ms": ra["mask overhead"],
         "warp_issue_ms": ra["warp issue"]},
        {"name": "blur_same", "route": "cuda",
         "source": "gslm_tpu_torch/csrc/blur.cu",
         "replaces": "gslm_tpu/ops/blur_pallas.py:87",
         "launches": launches["B"],
         "launches_by_path": {"serve": launches["B"]},
         "max_abs_err": err["B"],
         "ms": b_ms, "plain_ms": b_plain_ms, "bound_ms": b_bound,
         "bound_by": "bytes" if b_bytes / PEAK_BYTES >= b_ops / FP32_RATE
         else "operations", "library_ms": b_lib_ms},
    ], {"name": "cell_masks", "route": "cuda",
        "source": "gslm_tpu_torch/csrc/cell_masks.cu",
        "replaces": "gslm_tpu/ops/rasterize_tiled.py:203 (array code XLA "
                    "fuses; no Pallas kernel)",
        "launches": 0, "launches_by_path": {}, "max_abs_err": 0.0,
        "ms": stage["cell masks"], "plain_ms": g_plain_ms,
        "bound_ms": g_bound, "bound_by": "bytes", "library_ms": None}, {
        "name": "preprocess", "route": "cuda",
        "source": "gslm_tpu_torch/csrc/preprocess.cu",
        "replaces": "gslm_tpu/ops/projection.py:111 and ops/sh.py (array "
                    "code XLA fuses; no Pallas kernel)",
        "launches": 0, "launches_by_path": {}, "max_abs_err": 0.0,
        "ms": h_ms, "plain_ms": h_plain_ms, "bound_ms": h_bound,
        "bound_by": "bytes", "library_ms": None}


def train_phase(dev, n_gauss: int, height: int, width: int, tag: str,
                kernels: list[dict]) -> dict:
    """Phases 5-6. Adds the training launches to the entries of A and B in
    ``kernels`` and returns kernel C's entry."""
    import torch

    from gslm_tpu_torch.config import OptimizationParams
    from gslm_tpu_torch.models.gaussians import PARAM_GROUPS, GaussianAux
    from gslm_tpu_torch.ops import rasterize_cuda as rc
    from gslm_tpu_torch.ops.blur_cuda import blur, blur_plain, blur_same
    from gslm_tpu_torch.ops.projection import preprocess_cuda
    from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig, _cell_masks
    from gslm_tpu_torch.ops.ssim import gaussian_taps
    from gslm_tpu_torch.optim import (adam_step, group_learning_rates,
                                      init_adam)
    from gslm_tpu_torch.renderer import batch_render, stack_views
    from gslm_tpu_torch.solver.residuals import scalar_training_loss
    from gslm_tpu_torch.train import loss_and_grads, train_step
    from gslm_tpu_torch.utils.synthetic import (random_gaussians,
                                                ring_camera_batch)

    params = random_gaussians(np.random.default_rng(0), n=n_gauss,
                              capacity=n_gauss, sh_degree=3,
                              num_images=EXPOSURES, spread=1.5,
                              scale_range=(-5.5, -3.5), device=dev)
    cam = ring_camera_batch(1, height, width, device=dev)
    rcfg = RasterConfig(**TRAIN_CAPS)
    opt = OptimizationParams()
    bg = torch.zeros(3, device=dev)
    lg_kw = dict(rcfg=rcfg, opt=opt, active_sh_degree=3, use_exp=False)
    ts_kw = dict(lg_kw, sparse_adam=False, update_stats=True)
    taps = gaussian_taps()

    # reachable target: the scene with features_dc shifted by a seeded offset
    shift = torch.tensor(np.random.default_rng(1).normal(
        0, 0.2, (n_gauss, 1, 3)).astype(np.float32), device=dev)
    with torch.no_grad():
        dc = params.features_dc.detach().clone()
        params.features_dc.add_(shift)
        target = batch_render(params, cam, bg, config=rcfg)
        params.features_dc.copy_(dc)
        radii = batch_render(params, cam, bg, config=rcfg).radii.amax(dim=0)
    check(int(target.overflow) == 0, "target render overflows")
    cam = cam.replace(gt_image=target.render)
    n_visible = int((radii > 0).sum())
    aux = GaussianAux.zeros(n_gauss, device=dev)
    state = init_adam(params)

    # ---- one train_step on the main path, kernel C's inputs captured ----
    real_bwd = rc.composite_tiles_bwd
    with backward_inputs() as captured:
        rc.composite_tiles.launches = 0
        blur_same.launches = 0
        blur_same.vjp_launches = 0
        real_bwd.launches = 0
        _cell_masks.launches = 0
        preprocess_cuda.launches = 0
        params, aux, state, m = train_step(params, aux, state, cam, bg, 100,
                                           1.0, 0.0, **ts_kw)
        torch.cuda.synchronize()
        launches = {"A": rc.composite_tiles.launches, "B": blur_same.launches,
                    "C": real_bwd.launches, "G": _cell_masks.launches,
                    "H": preprocess_cuda.launches}
        b_vjp = blur_same.vjp_launches
    print(f"train_step launches: {launches} (B's VJP {b_vjp})", flush=True)
    check(launches == {"A": 1, "B": 2, "C": 1, "G": 1, "H": 0} and b_vjp == 1,
          f"train_step launches {launches}, B's VJP {b_vjp}: expected A "
          f"once, B twice (one VJP), C once, G once, H never")
    G_LAUNCHES["train_step"] = launches["G"]
    check(len(captured) == 1, "kernel C's inputs not captured once")
    losses = [float(m["loss"])]
    check(int(m["overflow"]) == 0, "train_step overflows")
    denom_sum = float(aux.denom.sum())
    print(f"train_step 1: loss {losses[0]:.6f}, psnr {float(m['psnr']):.4f}, "
          f"max_tile_load {int(m['max_tile_load'])}; denom sum {denom_sum:.0f}"
          f", visible Gaussians {n_visible}", flush=True)
    check(denom_sum == n_visible, "denom did not rise by the visible count")
    check(all(bool(torch.isfinite(getattr(params, g)).all())
              for g in PARAM_GROUPS), "non-finite parameters after the step")
    check(all(bool(torch.isfinite(getattr(aux, f)).all())
              for f in ("max_radii2d", "xyz_gradient_accum", "denom")),
          "non-finite densification statistics")
    check(float(aux.xyz_gradient_accum.max()) > 0, "no screen gradient")

    # ---- kernel C against its plain version, and against itself ---------
    args = captured[0]
    rec, st, cn, ntx, vrows, gtiles, xstate, depth_grad = args
    c_err = c_vs_plain("training view", *args)

    gen = torch.Generator(dev).manual_seed(3)
    x = torch.rand(1, 15, height, width, device=dev, generator=gen,
                   requires_grad=True)
    g = torch.randn(1, 15, height, width, device=dev, generator=gen)
    (gx,) = torch.autograd.grad(blur(x, taps), x, g)
    want = blur_plain(g, taps[::-1])
    vjp_err = float((gx - want).abs().max())
    vjp_bits = torch.equal(gx, want)
    print(f"blur VJP vs plain reversed-tap blur {tuple(g.shape)}: max|d| "
          f"{vjp_err:.3g} ({'bitwise equal' if vjp_bits else 'not bitwise'})",
          flush=True)
    check(vjp_bits, "the blur VJP differs from blur_plain")
    del want

    # ---- gradients through the kernels against the plain compositor -----
    _, _, _, gk, mk = loss_and_grads(params, cam, bg, 0.0, **lg_kw)
    real_fwd = rc.composite_tiles
    rc.composite_tiles = (lambda r, s, c, nx, vr, rects=None:
                          rc.composite_tiles_plain(r, s, c, nx, vr, rects))
    rc.composite_tiles_bwd = (lambda r, s, c, nx, vr, gt, _, dg:
                              rc.composite_tiles_bwd_plain(r, s, c, nx, vr,
                                                           gt, dg))
    try:
        _, _, _, gp, mp = loss_and_grads(params, cam, bg, 0.0, **lg_kw)
    finally:
        rc.composite_tiles, rc.composite_tiles_bwd = real_fwd, real_bwd
    grad_rel = {}
    for name, a, b in [(k, gk[k], gp[k]) for k in PARAM_GROUPS] + [
            ("mean2d_offset", mk, mp)]:
        check(bool(torch.isfinite(a).all()), f"non-finite gradient {name}")
        scale = float(b.abs().max()) + 1e-30
        ok, e = knife_edge_ok(a, b, scale)
        check(ok, f"kernel-path gradient of {name} disagrees with the plain "
                  f"path")
        grad_rel[name] = float(f"{e / scale:.3g}")
    print(f"gradients, kernel path vs plain compositor: max|d|/max|plain| "
          f"{grad_rel}", flush=True)

    # ---- the loss over 10 steps ------------------------------------------
    for step in range(101, 100 + TRAIN_STEPS):
        params, aux, state, m = train_step(params, aux, state, cam, bg, step,
                                           1.0, 0.0, **ts_kw)
        losses.append(float(m["loss"]))
    print(f"loss over {TRAIN_STEPS} steps: {[round(v, 6) for v in losses]}",
          flush=True)
    check(losses[-1] < losses[0], "the loss did not fall over 10 steps")

    # ---- 6. training timings ---------------------------------------------
    step_times = cuda_times(lambda: train_step(
        params, aux, state, cam, bg, 200, 1.0, 0.0, **ts_kw), 5)
    step_ms = statistics.median(step_times)

    def forward():
        m2d = torch.zeros(n_gauss, 2, device=dev, requires_grad=True)
        return scalar_training_loss(params, cam, bg, config=rcfg,
                                    lambda_dssim=opt.lambda_dssim,
                                    active_sh_degree=3,
                                    mean2d_offset=m2d)[0]

    g_planes = torch.randn(1, 15, height, width, device=dev, generator=gen)
    lrs = group_learning_rates(opt, 200, 1.0)
    m2d = torch.zeros(n_gauss, 2, device=dev, requires_grad=True)
    splats = stack_views(params, cam, config=rcfg, mean2d_offset=m2d)[0]
    t = {"preprocess (autograd on)": cuda_ms(lambda: stack_views(
             params, cam, config=rcfg, mean2d_offset=m2d), 5),
         "front end + record gather (autograd on)": cuda_ms(
             lambda: rc.tile_records(splats, ntx, vrows, rcfg, vrows), 5),
         "forward+loss": cuda_ms(forward, 5),
         "forward+loss+backward": cuda_ms(
             lambda: loss_and_grads(params, cam, bg, 0.0, **lg_kw), 5),
         "kernel C": cuda_ms(lambda: real_bwd(*args), 10),
         "blur VJP (kernel B, reversed taps)": cuda_ms(
             lambda: blur_same(g_planes, taps[::-1]), 10),
         "kernel A (training view)": cuda_ms(
             lambda: real_fwd(rec, st, cn, ntx, vrows), 10),
         "Adam": cuda_ms(lambda: adam_step(params, gk, state, lrs), 5)}
    t["backward"] = t["forward+loss+backward"] - t["forward+loss"]
    n_kern, busy_ms, wall_ms = device_busy(lambda: train_step(
        params, aux, state, cam, bg, 201, 1.0, 0.0, **ts_kw))
    c_plain_ms = cuda_ms(lambda: rc.composite_tiles_bwd_plain(
        rec, st, cn, ntx, vrows, gtiles, depth_grad), 2)

    rcc = c_report(tag, "(training view)", rec, st, cn, ntx, vrows, xstate,
                   depth_grad, t["kernel C"])
    ra = a_report(tag, "(training view)", rec, st, cn, ntx, vrows,
                  real_fwd(rec, st, cn, ntx, vrows)[1],
                  t["kernel A (training view)"])
    print(f"{tag} train_step 1x{width}x{height}: {step_ms:.3f} ms median of "
          f"5 (runs {[round(v, 3) for v in step_times]})", flush=True)
    print(f"{tag} train_step stages (ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in t.items()), flush=True)
    print(f"{tag} train_step profiled once: {n_kern} CUDA kernels, device "
          f"busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
          f"({busy_ms / wall_ms:.3f}; the profiler adds host time)",
          flush=True)
    print(f"{tag} kernel C (training view): {rcc['work']['staged']} of "
          f"{rec.shape[0]} records staged; kernel C {t['kernel C']:.3f} ms "
          f"vs bound {rcc['bound']:.4f} ms, plain {c_plain_ms:.3f} ms",
          flush=True)
    print(f"{tag} kernel A on the training view: "
          f"{t['kernel A (training view)']:.3f} ms vs bound "
          f"{ra['bound']:.4f} ms", flush=True)

    for entry, key in zip(kernels, ("A", "B")):
        entry["launches_by_path"]["train_step"] = launches[key]
        entry["launches"] += launches[key]
    kernels[0]["ms_train_view"] = t["kernel A (training view)"]
    kernels[0]["bound_ms_train_view"] = ra["bound"]
    kernels[1]["vjp_launches"] = b_vjp
    kernels[1]["vjp_ms"] = t["blur VJP (kernel B, reversed taps)"]
    kernels[1]["vjp_max_abs_err"] = vjp_err
    return {"name": "composite_bwd", "route": "cuda",
            "source": "gslm_tpu_torch/csrc/composite_bwd.cu",
            "replaces": "gslm_tpu/ops/rasterize_pallas.py:665",
            "launches": launches["C"],
            "launches_by_path": {"serve": 0, "train_step": launches["C"]},
            "max_abs_err": c_err, "ms": t["kernel C"],
            "plain_ms": c_plain_ms, "bound_ms": rcc["bound"],
            "bound_by": rcc["by"], "library_ms": None,
            "lane_bound_ms": rcc["lane bound"],
            "culled_bound_ms": rcc["culled bound"],
            "mask_overhead_ms": rcc["mask overhead"]}


def lm_scene(dev, n_gauss: int, height: int, width: int):
    """Cell lm-1080p-w5's inputs: the headline scene, ``EXPOSURES`` ring
    views whose ground truth is the scene rendered with ``features_dc``
    shifted (reachable targets), the window ``LMParams()`` draws from
    ``default_rng(0)`` and the val views. Returns ``(params, all_train,
    win, vidx)``."""
    import torch

    from gslm_tpu_torch.config import LMParams
    from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
    from gslm_tpu_torch.renderer import batch_render
    from gslm_tpu_torch.train_lm import select_window, val_indices
    from gslm_tpu_torch.utils.synthetic import (random_gaussians,
                                                ring_camera_batch)

    params = random_gaussians(np.random.default_rng(0), n=n_gauss,
                              capacity=n_gauss, sh_degree=3,
                              num_images=EXPOSURES, spread=1.5,
                              scale_range=(-5.5, -3.5), device=dev)
    all_train = ring_camera_batch(EXPOSURES, height, width, gt_seed=None,
                                  device=dev)
    rcfg = RasterConfig(**LM_CAPS)
    lm = LMParams()
    mb = lm.micro_batch
    bg = torch.zeros(3, device=dev)
    shift = torch.tensor(np.random.default_rng(1).normal(
        0, 0.2, (n_gauss, 1, 3)).astype(np.float32), device=dev)
    with torch.no_grad():
        dc = params.features_dc.detach().clone()
        params.features_dc.add_(shift)
        targets = [batch_render(params, all_train.take(slice(i, i + mb)), bg,
                                config=rcfg) for i in range(0, EXPOSURES, mb)]
        params.features_dc.copy_(dc)
    check(all(int(t.overflow.max()) == 0 for t in targets),
          "target render overflows")
    all_train = all_train.replace(
        gt_image=torch.cat([t.render for t in targets]))
    del targets
    win = select_window(EXPOSURES, lm.num_images, np.random.default_rng(0))
    return params, all_train, win, val_indices(EXPOSURES, lm)


def lm_phase(dev, n_gauss: int, height: int, width: int, tag: str,
             kernels: list[dict]) -> tuple[dict, dict]:
    """Phase 7. Adds the LM step's launches to the entries of A, B and C in
    ``kernels``; returns kernel E's entry and the step's result, which
    phase 13 holds its data-parallel steps to: dict(state, info, ms) (the
    new parameters and the info as tensors, the step's median ms)."""
    import torch

    from gslm_tpu_torch.config import LMParams
    from gslm_tpu_torch.models import gaussians as G
    from gslm_tpu_torch.models.gaussians import PARAM_GROUPS
    from gslm_tpu_torch.ops import rasterize_cuda as rc
    from gslm_tpu_torch.ops.blur_cuda import blur_same
    from gslm_tpu_torch.ops.projection import preprocess_cuda
    from gslm_tpu_torch.ops.rasterize_tiled import (RasterConfig, _cdiv,
                                                    _cell_masks)
    from gslm_tpu_torch.renderer import stack_views
    from gslm_tpu_torch.solver.cg import cgls_damped_unrolled
    from gslm_tpu_torch.solver.operators import LMOperators
    from gslm_tpu_torch.solver.residuals import (ResidualState,
                                                 batch_residuals, res_dot)
    from gslm_tpu_torch.train_lm import lm_outer_step
    from gslm_tpu_torch.train_lm import lm_phase as lm_phase_entry

    params, all_train, win, vidx = lm_scene(dev, n_gauss, height, width)
    rcfg = RasterConfig(**LM_CAPS)
    lm = LMParams()
    mb = lm.micro_batch
    bg = torch.zeros(3, device=dev)
    kw = dict(rcfg=rcfg, lm=lm, active_sh_degree=3, use_exp=False)
    window, val = all_train.take(win), all_train.take(vidx)
    lcfg = rcfg.replace(depth_grad=False)

    def residual_fn(p):
        return batch_residuals(p, window, bg, config=lcfg,
                               disable_ssim=lm.disable_ssim,
                               active_sh_degree=3, alive=params.alive)

    @torch.no_grad()
    def val_loss(p):
        return sum(batch_residuals(
            p, val.take(slice(c, c + mb)), bg, config=lcfg,
            disable_ssim=lm.disable_ssim, active_sh_degree=3,
            alive=params.alive).loss_scalar
            for c in range(0, len(vidx), mb))

    start_val = float(val_loss(params))

    # ---- one lm_outer_step on the main path, launches counted -----------
    rc.composite_tiles.launches = 0
    blur_same.launches = 0
    rc.composite_tiles_bwd.launches = 0
    rc.composite_tiles_jvp.launches = 0
    _cell_masks.launches = 0
    preprocess_cuda.launches = 0
    guards = (rc.composite_tiles_bwd_unmasked, rc.composite_tiles_jvp_unmasked)
    for f in guards:
        f.launches = 0
    t0 = time.perf_counter()
    new, info = lm_outer_step(params, params.alive, window, val, bg, **kw)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"A": rc.composite_tiles.launches, "B": blur_same.launches,
                "C": rc.composite_tiles_bwd.launches,
                "E": rc.composite_tiles_jvp.launches,
                "G": _cell_masks.launches, "H": preprocess_cuda.launches}
    print(f"lm_outer_step launches: {launches}", flush=True)
    check(launches == LM_LAUNCHES,
          f"lm_outer_step launches {launches}: expected {LM_LAUNCHES}")
    G_LAUNCHES["lm_outer_step"] = launches["G"]
    H_LAUNCHES["lm_outer_step"] = launches["H"]
    check(all(f.launches == 0 for f in guards),
          "lm_outer_step launched a guard kernel")
    norms = {g: float(v) for g, v in info["step_norms"].items()}
    best = float(info["best_val_loss"])
    print(f"lm_outer_step (window {win}, {len(vidx)} val views): start loss "
          f"{float(info['start_loss']):.6f}, val loss at the start "
          f"{start_val:.6f}, val losses "
          f"{[round(float(v), 6) for v in info['val_losses']]}, best alpha "
          f"{float(info['best_alpha'])}, best val loss {best:.6f}; step "
          f"norms {norms}; first call {first_s:.2f} s", flush=True)
    check(best < start_val, "the LM step did not lower the validation loss")
    check(torch.equal(new.xyz, params.xyz), "xyz moved with mask_xyz")
    check(all(bool(torch.isfinite(getattr(new, g)).all())
              for g in PARAM_GROUPS)
          and all(np.isfinite(v) for v in norms.values()),
          "non-finite parameters or step norms")

    # ---- kernel E against kernel A and its plain version ----------------
    ntx = _cdiv(width, 16)
    with torch.no_grad():
        splats, _, nty = stack_views(params, window, config=lcfg)
        rec, st, cn, *_ = rc.tile_records(splats, ntx, len(win) * nty, lcfg,
                                         nty)
    gen = torch.Generator(dev).manual_seed(2)
    # a seeded tangent, each field at its own spread over the records
    tng = (torch.randn(rec.shape, device=dev, generator=gen)
           * rec.std(dim=0, keepdim=True))
    real_jvp = rc.composite_tiles_jvp
    ev = e_vs_plain("LM window", rec, tng, st, cn, ntx, nty)
    e_err, e_vs_a, e_plain_ms, walked = (ev["err"], ev["vs_a"],
                                         ev["plain_ms"], ev["walked"])

    # ---- the adjoint at full width, through kernels E and C --------------
    group_mask = G.param_group_mask(mask_xyz=lm.mask_xyz)
    ops = LMOperators(residual_fn, params, group_mask=group_mask,
                      alive=params.alive)
    gen = torch.Generator(dev).manual_seed(3)
    v = {g: torch.randn(x.shape, device=dev, generator=gen)
         for g, x in params.groups().items()}
    shape = ops.residual.l1.shape
    u = ResidualState(*(torch.randn(shape, device=dev, generator=gen)
                        for _ in range(2)))
    jv = ops.matvec(v)
    with backward_inputs() as captured:   # kernel C's inputs on the window
        jtu = ops.matvec_T(u)
    c_args = captured[0]
    lhs, rhs = float(res_dot(jv, u)), float(G.vdot(v, jtu))
    adj = abs(lhs - rhs) / max(abs(lhs), abs(rhs))
    print(f"adjoint <Jv,u> {lhs:.8g} vs <v,J^T u> {rhs:.8g}: relative "
          f"{adj:.3g}", flush=True)
    check(adj <= 1e-4, "J·v and Jᵀ·u are not adjoint")
    c_window_err = c_vs_plain("LM window", *c_args)

    # ---- J·v through the kernels against J·v through the plain compositor
    rc.composite_tiles_jvp = rc.composite_tiles_jvp_plain
    try:
        jv_plain = ops.matvec(v)
    finally:
        rc.composite_tiles_jvp = real_jvp
    jv_rel = {}
    for f in ("l1", "ssim"):
        a, b = getattr(jv, f), getattr(jv_plain, f)
        scale = float(b.abs().max()) + 1e-30
        ok, e = knife_edge_ok(a, b, scale)
        check(ok, f"J·v ({f}) through the kernels disagrees with the plain "
                  f"compositor's")
        jv_rel[f] = float(f"{e / scale:.3g}")
    dots = float(res_dot(jv, u)), float(res_dot(jv_plain, u))
    print(f"J·v, kernel E vs plain compositor: max|d|/max|plain| {jv_rel}; "
          f"<Jv,u> {dots[0]:.8g} vs {dots[1]:.8g}", flush=True)

    # ---- lm_phase once through its entry point ---------------------------
    _, info2, rcfg2 = lm_phase_entry(None, params, None, all_train, rcfg, bg,
                                     lm, 0, np.random.default_rng(0), False,
                                     0.2, 3)
    torch.cuda.synchronize()
    check(rcfg2 == rcfg, f"lm_phase grew the capacities to {rcfg2}")
    check(np.isfinite(float(info2["best_val_loss"])), "lm_phase loss")
    print(f"lm_phase: capacities unchanged (dup {rcfg2.dup_capacity}, live "
          f"{rcfg2.live_capacity})", flush=True)

    # ---- timings ----------------------------------------------------------
    step_times = cuda_times(lambda: lm_outer_step(
        params, params.alive, window, val, bg, **kw), 2, warmup=0)
    step_ms = statistics.median(step_times)
    b = ResidualState(-ops.residual.l1, -ops.residual.ssim)
    damp = lm.damp_dict()
    groups = params.groups()
    s_dir = G.saxpy(-1.0, groups, new.groups())     # the step taken

    def line_search():
        return [val_loss(G.with_groups(params, G.saxpy(a, s_dir, groups)))
                for a in (lm.line_search_alpha0 * 0.5 ** i
                          for i in range(lm.line_search_steps + 1))]

    t = {"linearization forward (LMOperators)": cuda_ms(
             lambda: LMOperators(residual_fn, params, group_mask=group_mask,
                                 alive=params.alive), 2),
         "J·v": cuda_ms(lambda: ops.matvec(v), 2),
         "Jᵀ·u": cuda_ms(lambda: ops.matvec_T(u), 3),
         "CGLS (6 J·v, 4 Jᵀ·u)": cuda_ms(lambda: cgls_damped_unrolled(
             ops.matvec, ops.matvec_T, ops.dot, ops.saxpy,
             LMOperators.dampmul_for(damp), b, ops.get_initial_solution(),
             damp, max_iter=lm.cg_max_iter, restart_iter=lm.cg_restart_iter,
             check_divergence=lm.check_divergence), 1, warmup=0),
         "line search (7 alphas x 10 val chunks)": cuda_ms(line_search, 1,
                                                           warmup=0),
         "kernel E (window)": cuda_ms(
             lambda: real_jvp(rec, tng, st, cn, ntx, nty), 10),
         "kernel A (window)": cuda_ms(
             lambda: rc.composite_tiles(rec, st, cn, ntx, nty), 10),
         "kernel C (window)": cuda_ms(
             lambda: rc.composite_tiles_bwd(*c_args), 10)}
    n_walked = int(walked.long().sum())
    ra = a_report(tag, "(LM window)", rec, st, cn, ntx, nty, walked,
                  t["kernel A (window)"])
    re_ = e_report(tag, "(LM window)", ra["work"], n_walked, cn.shape[0],
                   t["kernel E (window)"])
    rcw = c_report(tag, "(LM window, one Jᵀ·u)", *c_args[:5], c_args[6],
                   c_args[7], t["kernel C (window)"])
    print(f"{tag} lm_outer_step 5x{width}x{height} window, {len(vidx)} val "
          f"views: {step_ms:.1f} ms median of 2 (runs "
          f"{[round(x, 1) for x in step_times]})", flush=True)
    print(f"{tag} lm_outer_step stages (ms): "
          + ", ".join(f"{k} {x:.3f}" for k, x in t.items()), flush=True)
    print(f"{tag} on the window: kernel E {t['kernel E (window)']:.3f} ms vs "
          f"bound {re_['bound']:.4f} ms, plain {e_plain_ms:.3f} ms; kernel A "
          f"{t['kernel A (window)']:.3f} ms vs bound {ra['bound']:.4f} ms; "
          f"kernel C {t['kernel C (window)']:.3f} ms vs bound "
          f"{rcw['bound']:.4f} ms", flush=True)
    del ops
    n_kern, busy_ms, wall_ms = device_busy(lambda: lm_outer_step(
        params, params.alive, window, val, bg, **kw), cpu=False)
    print(f"{tag} lm_outer_step profiled once: {n_kern} CUDA kernels, device "
          f"busy {busy_ms:.1f} ms of {wall_ms:.1f} ms wall "
          f"({busy_ms / wall_ms:.3f}; device-only trace)", flush=True)

    for entry, key in zip(kernels, ("A", "B", "C")):
        entry["launches_by_path"]["lm_outer_step"] = launches[key]
        entry["launches"] += launches[key]
    kernels[0]["ms_lm_window"] = t["kernel A (window)"]
    kernels[0]["bound_ms_lm_window"] = ra["bound"]
    kernels[2]["ms_lm_window"] = t["kernel C (window)"]
    kernels[2]["bound_ms_lm_window"] = rcw["bound"]
    kernels[2]["lane_bound_ms_lm_window"] = rcw["lane bound"]
    kernels[2]["mask_overhead_ms_lm_window"] = rcw["mask overhead"]
    kernels[2]["max_abs_err_lm_window"] = c_window_err
    ref = {"state": {k: v.clone() for k, v in state_tensors(new).items()},
           "info": info_tensors(info), "ms": step_ms}
    return ({"name": "composite_jvp", "route": "cuda",
             "source": "gslm_tpu_torch/csrc/composite_jvp.cu",
             "replaces": "gslm_tpu/ops/rasterize_pallas_jvp.py:172",
             "launches": launches["E"],
             "launches_by_path": {"serve": 0, "train_step": 0,
                                  "lm_outer_step": launches["E"]},
             "max_abs_err": e_err, "primal_vs_A_max_abs_err": e_vs_a,
             "ms": t["kernel E (window)"], "plain_ms": e_plain_ms,
             "bound_ms": re_["bound"], "bound_by": re_["by"],
             "library_ms": None, "lane_bound_ms": re_["lane bound"],
             "culled_bound_ms": re_["culled bound"],
             "mask_overhead_ms": re_["mask overhead"]}), ref


# the bool template parameters of each kernel, in order, for SASS labels
TEMPLATE_PARAMS = {"composite_fwd_kernel": ("RECT",),
                   "composite_bwd_kernel": ("DEPTH", "MASK"),
                   "bucket_walk_kernel": ("DEPTH", "MASK"),
                   "composite_jvp_kernel": ("RECT", "MASK")}


def sass_totals(paths: dict | None = None,
                blocks_dir: str | None = None) -> None:
    """Per kernel function of the libraries ``paths`` ({name: path}; every
    built one by default), its instruction count and FFMA, FADD, FMUL and
    MUFU totals in the sm_90a SASS (``cuobjdump -sass``): a change to a
    shared header must leave the bucket-1 kernels' totals as they were.
    With ``blocks_dir``, each library's SASS is also written there
    (``sass_<name>.txt``), every function cut into basic blocks (at labels
    and after branches) with each block's instruction count by opcode: the
    per-pair counts above are read from it."""
    import collections
    import re
    import shutil

    from gslm_tpu_torch import _build
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if paths is None:
        paths = {name: _build._lib_path(name) for name in _build.SIGNATURES}
    for name, path in paths.items():
        sass = subprocess.run([tool, "-sass", str(path)],
                              capture_output=True, text=True,
                              check=True).stdout
        lines = []
        for fn, body in re.findall(
                r"Function : (\S+)\n(.*?)(?=\n\s+Function : |\Z)", sass,
                re.S):
            blocks = [("entry", [])]   # (label, [(address, opcode, text)])
            for ln in body.splitlines():
                lab = re.match(r"\s*(\.L_x_\d+):", ln)
                if lab:
                    blocks.append((lab.group(1), []))
                    continue
                ins = re.search(r"/\*([0-9a-f]{4})\*/\s+((?:@!?U?P\w+\s+)?"
                                r"([A-Z0-9]+)[^;]*);", ln)
                if ins:
                    blocks[-1][1].append(
                        (ins.group(1), ins.group(3), ins.group(2).strip()))
                    if ins.group(3) in ("BRA", "EXIT", "RET", "BRX", "CALL"):
                        blocks.append((f"after {ins.group(1)}", []))
            ops = collections.Counter(op for _, b in blocks for _, op, _ in b)
            m = re.search(r"(\w+?_kernel)((?:ILb[01]E|Lb[01]E)*)", fn)
            taps = re.search(r"_kernelILi(\d+)EE", fn)
            kernel = m.group(1).split("_cu_")[-1] if m else fn
            kernel = re.sub(r"^[0-9a-f]+\d+", "", kernel)
            flags = re.findall(r"Lb([01])E", m.group(2)) if m else []
            if flags:
                names = TEMPLATE_PARAMS.get(kernel, ())
                if len(names) != len(flags):
                    names = [f"#{k}" for k in range(len(flags))]
                kernel += "<" + ", ".join(
                    f"{nm}={'true' if b == '1' else 'false'}"
                    for nm, b in zip(names, flags)) + ">"
            elif taps:
                kernel += f"<K={taps.group(1)}>"
            print(f"SASS {name}: {kernel} {sum(ops.values())} instructions; "
                  + ", ".join(f"{k} {ops[k]}" for k in ("FFMA", "FADD",
                                                        "FMUL", "MUFU")),
                  flush=True)
            lines.append(f"== {fn}")
            for label, b in blocks:
                if b:
                    n = collections.Counter(op for _, op, _ in b)
                    lines.append(f"-- block {label} [{b[0][0]}-{b[-1][0]}] "
                                 f"{len(b)} instructions: "
                                 + ", ".join(f"{k} {v}" for k, v in
                                             sorted(n.items())))
                    lines.extend(f"   {a} {t}" for a, _, t in b)
        if blocks_dir:
            os.makedirs(blocks_dir, exist_ok=True)
            with open(os.path.join(blocks_dir, f"sass_{name}.txt"), "w") as f:
                f.write("\n".join(lines) + "\n")


def bucket_phase(dev, n_gauss: int, height: int, width: int, tag: str,
                 kernels: list[dict]) -> dict:
    """Phase 8 (cell train-m1-bucket4-1080p). Adds the bucket path's
    launches to the entries of A, B, C and E in ``kernels`` and returns
    kernel D's entry."""
    import torch
    import torch.autograd.forward_ad as fwAD

    from gslm_tpu_torch.config import LMParams, OptimizationParams
    from gslm_tpu_torch.models import gaussians as G
    from gslm_tpu_torch.models.gaussians import PARAM_GROUPS, GaussianAux
    from gslm_tpu_torch.ops import rasterize_cuda as rc
    from gslm_tpu_torch.ops.rasterize_tiled import (RasterConfig, _cdiv,
                                                    bucket_splats,
                                                    duplicate_sort_ranges)
    from gslm_tpu_torch.optim import init_adam
    from gslm_tpu_torch.renderer import overflow_probe, render, stack_views
    from gslm_tpu_torch.solver.operators import LMOperators
    from gslm_tpu_torch.solver.residuals import (ResidualState,
                                                 batch_residuals, res_dot,
                                                 scalar_training_loss)
    from gslm_tpu_torch.train import loss_and_grads, train_step
    from gslm_tpu_torch.utils.synthetic import (random_gaussians,
                                                ring_camera_batch)

    torch.cuda.reset_peak_memory_stats(dev)
    params = random_gaussians(np.random.default_rng(2), n=n_gauss,
                              capacity=n_gauss, sh_degree=3, num_images=1,
                              spread=1.5, scale_range=(-5.5, -3.5),
                              device=dev)
    cams = ring_camera_batch(1, height, width, device=dev)
    cam = cams.view(0)
    bg = torch.zeros(3, device=dev)
    ntx, nty = _cdiv(width, 16), _cdiv(height, 16)
    opt = OptimizationParams()

    def from_probe(pr, bucket):
        return caps_from_counts(int(pr["n_aabb"]), int(pr["n_live"]), bucket)

    # ---- 1. the probe at bucket 4, and bucket 1's capacities ------------
    cfg4 = RasterConfig(**M1_CAPS)
    pr4 = overflow_probe(params, cams, config=cfg4)
    counts4 = (int(pr4["n_aabb"]), int(pr4["n_live"]))
    print(f"m1 overflow_probe at bucket 4: n_aabb {counts4[0]}, n_live "
          f"{counts4[1]} (bench.py's TPU probe: {M1_BENCH_COUNTS[0]} / "
          f"{M1_BENCH_COUNTS[1]}); overflow {int(pr4['overflow'])} at dup "
          f"{cfg4.dup_capacity} / live {cfg4.live_capacity}", flush=True)
    if int(pr4["overflow"]):
        cfg4 = from_probe(pr4, 4)
        print(f"m1 capacities sized from the port's probe + 5 %: dup "
              f"{cfg4.dup_capacity} / live {cfg4.live_capacity}", flush=True)
    cfg1 = from_probe(overflow_probe(params, cams, config=RasterConfig(
        cull=True)), 1)
    print(f"m1 bucket-1 capacities (probe + 5 %): dup {cfg1.dup_capacity} / "
          f"live {cfg1.live_capacity}", flush=True)

    with torch.no_grad():
        # ---- 2. render at bucket 4 on the main path ----------------------
        zero_launches()
        out4 = render(params, cam, bg, config=cfg4)
        torch.cuda.synchronize()
        render_launches = got = launches()
        print(f"m1 render launches: {got}", flush=True)
        check(got == {"A": 1, "B": 0, "C": 0, "D": 0, "E": 0, "G": 1,
                      "H": 1},
              f"m1 render launches {got}: expected A, G and H once")
        G_LAUNCHES["render_m1_bucket4"] = got["G"]
        H_LAUNCHES["render_m1_bucket4"] = got["H"]
        sp = stack_views(params, cams, config=cfg4)[0]
        tr = rc.tile_records(sp, ntx, nty, cfg4)
        check(tuple(int(t) for t in reversed(tr.totals)) == counts4
              and int(out4.n_duplicates) == counts4[1]
              and int(out4.overflow) == 0,
              f"the probe's counts {counts4} differ from the render's "
              f"{[int(t) for t in reversed(tr.totals)]} or it overflows")
        out1 = render(params, cam, bg, config=cfg1)
        check(int(out1.overflow) == 0, "m1 bucket-1 render overflows")
        check(bool(torch.isfinite(out4.render).all()), "m1 finite image")
        bitwise = (torch.equal(out4.render, out1.render)
                   and torch.equal(out4.invdepth, out1.invdepth))
        d_img = max(float((out4.render - out1.render).abs().max()),
                    float((out4.invdepth - out1.invdepth).abs().max()))
        print(f"m1 render, bucket 4 vs bucket 1: max|d| {d_img:.3g} "
              f"({'bitwise equal' if bitwise else 'not bitwise'}); records "
              f"{int(out1.n_duplicates)} -> {int(out4.n_duplicates)}, "
              f"shrink {int(out1.n_duplicates) / int(out4.n_duplicates):.3f}"
              f"x; max bucket load {int(out4.max_tile_load)}; peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
              flush=True)
        check(d_img <= 1e-6, "m1 bucket-4 render differs from bucket 1")

        # ---- 3. kernel A with the rect gate against its plain version ----
        rects = tr.buckets.rects
        got, walked = rc.composite_tiles(tr.records, tr.starts, tr.counts,
                                         ntx, nty, rects)
        (want, _), a_plain_ms = cuda_timed(lambda: rc.composite_tiles_plain(
            tr.records, tr.starts, tr.counts, ntx, nty, rects))
        ok, a_err = knife_edge_ok(got[:, :rc.IMG_ROWS],
                                  want[:, :rc.IMG_ROWS])
        print(f"kernel A (rect gate) vs plain ({tr.records.shape[0]} bucket "
              f"records, {tr.counts.shape[0]} tiles): max|d| {a_err:.3g}",
              flush=True)
        check(ok, "kernel A with rects disagrees with its plain version")
        del want
        # E<RECT> and A<RECT> against each other and the guard
        tng = (torch.randn(tr.records.shape, device=dev,
                           generator=torch.Generator(dev).manual_seed(2))
               * tr.records.std(dim=0, keepdim=True))
        got_e, dot_e = rc.composite_tiles_jvp(tr.records, tng, tr.starts,
                                              tr.counts, ntx, nty, rects)
        check(torch.equal(got_e, got),
              "kernel E's primal differs from kernel A's at bucket 4")
        print(f"kernel E vs kernel A (rect gate), primal rows 0-6: bitwise "
              f"equal", flush=True)
        guard_check("m1 bucket 4", got_e, dot_e, got, tr.records, tng,
                    tr.starts, tr.counts, ntx, nty, rects)
        del got_e, dot_e, tng

    # ---- 4. train_step at bucket 4, kernel D's inputs captured ----------
    shift = torch.tensor(np.random.default_rng(1).normal(
        0, 0.2, (n_gauss, 1, 3)).astype(np.float32), device=dev)
    with torch.no_grad():
        dc = params.features_dc.detach().clone()
        params.features_dc.add_(shift)
        target = render(params, cam, bg, config=cfg4)
        params.features_dc.copy_(dc)
    cams = cams.replace(gt_image=target.render[None])
    n_visible = int((out4.radii > 0).sum())
    aux = GaussianAux.zeros(n_gauss, device=dev)
    state = init_adam(params)
    lg_kw = dict(opt=opt, active_sh_degree=3, use_exp=False)
    ts_kw = dict(lg_kw, rcfg=cfg4, sparse_adam=False, update_stats=True)
    with backward_inputs() as captured:
        zero_launches()
        params, aux, state, m = train_step(params, aux, state, cams, bg, 100,
                                           1.0, 0.0, **ts_kw)
        torch.cuda.synchronize()
        got = launches()
    print(f"m1 train_step launches: {got}", flush=True)
    check(got == {"A": 1, "B": 2, "C": 0, "D": 1, "E": 0, "G": 1, "H": 0},
          f"m1 train_step launches {got}: expected A once, B twice, D once, "
          f"G once, H never")
    G_LAUNCHES["train_m1_bucket4"] = got["G"]
    step_launches = got
    check(len(captured) == 1, "kernel D's inputs not captured once")
    losses = [float(m["loss"])]
    denom_sum = float(aux.denom.sum())
    print(f"m1 train_step 1: loss {losses[0]:.6f}, psnr "
          f"{float(m['psnr']):.4f}; denom sum {denom_sum:.0f}, visible "
          f"Gaussians {n_visible}", flush=True)
    check(int(m["overflow"]) == 0, "m1 train_step overflows")
    check(denom_sum == n_visible, "denom did not rise by the visible count")
    check(all(bool(torch.isfinite(getattr(params, g)).all())
              for g in PARAM_GROUPS), "non-finite parameters after the step")
    check(all(bool(torch.isfinite(getattr(aux, f)).all())
              for f in ("max_radii2d", "xyz_gradient_accum", "denom")),
          "non-finite densification statistics")

    # ---- 5. kernel D against its plain version, and against itself -----
    args = captured[0]
    del captured
    rec, buckets, _, _, gtiles, xstate, depth_grad = args
    got = rc.composite_tiles_bucket_bwd(*args)
    again = rc.composite_tiles_bucket_bwd(*args)
    guard = rc.composite_tiles_bucket_bwd_unmasked(*args)
    want, d_plain_ms = cuda_timed(lambda: rc.composite_tiles_bucket_bwd_plain(
        *args[:5], depth_grad))
    check(torch.equal(got, again), "kernel D is not bitwise repeatable")
    check(torch.equal(got.view(torch.int32), guard.view(torch.int32)),
          "kernel D differs from the guard D<MASK=false>'s")
    del guard
    check(bool(torch.isfinite(got).all()), "kernel D gave non-finite values")
    d_err, d_rel = 0.0, []
    for f in range(rc.NF):
        scale = float(want[:, f].abs().max()) + 1e-30
        ok, e = knife_edge_ok(got[:, f], want[:, f], scale)
        check(ok, f"kernel D disagrees with its plain version, field {f}")
        d_err = max(d_err, e)
        d_rel.append(e / scale)
    print(f"kernel D vs plain ({rec.shape[0]} records, "
          f"{buckets.bcounts.shape[0]} buckets): max|d| {d_err:.3g}; "
          f"max|d|/max|plain| per field "
          f"{[float(f'{r:.3g}') for r in d_rel]}; two runs bitwise equal, "
          f"and bitwise equal to the guard D<MASK=false>'s", flush=True)
    del got, again, want

    # ---- 6. every group's gradient, bucket 4 (A + D) vs bucket 1 (A + C)
    g4 = loss_and_grads(params, cams, bg, 0.0, rcfg=cfg4, **lg_kw)[3]
    with backward_inputs() as captured:   # kernel C's inputs at bucket 1
        g1 = loss_and_grads(params, cams, bg, 0.0, rcfg=cfg1, **lg_kw)[3]
    c_args = captured[0]
    grad_rel = {}
    for k in PARAM_GROUPS:
        scale = float(g1[k].abs().max())
        e = float((g4[k] - g1[k]).abs().max())
        check(bool(torch.isfinite(g4[k]).all()) and e <= 1e-5 * scale,
              f"gradient of {k}, bucket 4 vs bucket 1: max|d| {e:.3g} of "
              f"max {scale:.3g}")
        grad_rel[k] = float(f"{e / (scale + 1e-30):.3g}")
    print(f"m1 gradients, bucket 4 (A + D) vs bucket 1 (A + C): "
          f"max|d|/max|bucket 1| {grad_rel}", flush=True)
    del g4, g1

    # ---- 7. J·v through kernel E, bucket 4 vs bucket 1 ------------------
    gen = torch.Generator(dev).manual_seed(3)
    v = {g: torch.randn(x.shape, device=dev, generator=gen) * 1e-2
         for g, x in params.groups().items()}

    def jv_image(cfg):
        with torch.no_grad(), fwAD.dual_level():
            duals = {g: fwAD.make_dual(x, v[g])
                     for g, x in params.groups().items()}
            out = render(G.with_groups(params, duals), cam, bg, config=cfg)
            return fwAD.unpack_dual(out.render).tangent

    e_before = rc.composite_tiles_jvp.launches
    jv4, jv1 = jv_image(cfg4), jv_image(cfg1)
    check(rc.composite_tiles_jvp.launches == e_before + 2, "J·v missed E")
    scale = float(jv1.abs().max())
    e = float((jv4 - jv1).abs().max())
    print(f"m1 J·v through kernel E, bucket 4 vs bucket 1: max|d| {e:.3g} of "
          f"max {scale:.3g} ({'bitwise equal' if torch.equal(jv4, jv1) else 'not bitwise'})",
          flush=True)
    check(e <= 1e-6 * scale, "J·v at bucket 4 differs from bucket 1")
    del jv4, jv1

    # ---- 8. the adjoint at bucket 4: E forward, D backward --------------
    lm = LMParams()
    lcfg = cfg4.replace(depth_grad=False)
    ops = LMOperators(
        lambda p: batch_residuals(p, cams, bg, config=lcfg,
                                  disable_ssim=lm.disable_ssim,
                                  active_sh_degree=3, alive=params.alive),
        params, group_mask=G.param_group_mask(mask_xyz=lm.mask_xyz),
        alive=params.alive)
    u = ResidualState(*(torch.randn(ops.residual.l1.shape, device=dev,
                                    generator=gen) for _ in range(2)))
    d_before = rc.composite_tiles_bucket_bwd.launches
    lhs = float(res_dot(ops.matvec(v), u))
    rhs = float(G.vdot(v, ops.matvec_T(u)))
    adj = abs(lhs - rhs) / max(abs(lhs), abs(rhs))
    print(f"m1 adjoint at bucket 4 <Jv,u> {lhs:.8g} vs <v,J^T u> {rhs:.8g}: "
          f"relative {adj:.3g} (D launched "
          f"{rc.composite_tiles_bucket_bwd.launches - d_before})", flush=True)
    check(rc.composite_tiles_bucket_bwd.launches > d_before,
          "J^T u at bucket 4 missed kernel D")
    check(adj <= 1e-4, "J·v (E) and J^T·u (D) are not adjoint at bucket 4")
    del ops, u

    # ---- the loss over 10 steps -----------------------------------------
    for step in range(101, 100 + TRAIN_STEPS):
        params, aux, state, m = train_step(params, aux, state, cams, bg,
                                           step, 1.0, 0.0, **ts_kw)
        losses.append(float(m["loss"]))
    print(f"m1 loss over {TRAIN_STEPS} steps: "
          f"{[round(x, 6) for x in losses]}", flush=True)
    check(losses[-1] < losses[0], "the m1 loss did not fall over 10 steps")

    # ---- timings ----------------------------------------------------------
    def no_grad(fn):
        def call():
            with torch.no_grad():
                return fn()
        return call

    def stages(cfg):
        bk = cfg.bucket
        with torch.no_grad():
            spl = stack_views(params, cams, config=cfg)[0]
            bsp = bucket_splats(spl, bk) if bk > 1 else spl
            trc = rc.tile_records(spl, ntx, nty, cfg)
        rects_c = None if trc.buckets is None else trc.buckets.rects

        def forward():
            m2d = torch.zeros(n_gauss, 2, device=dev, requires_grad=True)
            return scalar_training_loss(params, cams, bg, config=cfg,
                                        lambda_dssim=opt.lambda_dssim,
                                        active_sh_degree=3,
                                        mean2d_offset=m2d)[0]

        t = {"render (no_grad)": cuda_ms(no_grad(
                 lambda: render(params, cam, bg, config=cfg)), 3),
             "front end": cuda_ms(no_grad(lambda: duplicate_sort_ranges(
                 bsp, _cdiv(ntx, bk), nty // bk, cfg.dup_capacity,
                 view_rows=nty // bk, cull=True,
                 live_capacity=cfg.live_capacity, tile_px=16 * bk)), 3),
             "front end + gather": cuda_ms(no_grad(
                 lambda: rc.tile_records(spl, ntx, nty, cfg)), 3),
             "kernel A": cuda_ms(lambda: rc.composite_tiles(
                 trc.records, trc.starts, trc.counts, ntx, nty, rects_c), 5),
             "forward+loss": cuda_ms(forward, 3),
             "forward+loss+backward": cuda_ms(lambda: loss_and_grads(
                 params, cams, bg, 0.0, rcfg=cfg, **lg_kw), 3)}
        t["backward"] = t["forward+loss+backward"] - t["forward+loss"]
        return t

    def step_at(cfg):
        return lambda: train_step(params, aux, state, cams, bg, 200, 1.0,
                                  0.0, **dict(ts_kw, rcfg=cfg))

    t4 = stages(cfg4)
    t1 = stages(cfg1)
    # the two steps in turns, so the host's drift falls on both alike
    step_runs = {4: [], 1: []}
    for rep in range(6):   # the first round warms up
        for bk, cfg in ((4, cfg4), (1, cfg1)):
            ms = cuda_times(step_at(cfg), 1, warmup=0)
            step_runs[bk] += ms if rep else []
    t4["train_step"] = statistics.median(step_runs[4])
    t1["train_step"] = statistics.median(step_runs[1])
    t4["kernel D"] = cuda_ms(lambda: rc.composite_tiles_bucket_bwd(*args), 5)
    t1["kernel C"] = cuda_ms(lambda: rc.composite_tiles_bwd(*c_args), 5)
    # kernel D's walk and sum apart, read from the bucket-4 step's trace
    step4, wall4 = cuda_kernels(step_at(cfg4))
    busy = {4: (len(step4), kernels_ms(step4), wall4),
            1: device_busy(step_at(cfg1))}
    d_kern = d_split(step4, 1)
    del step4
    top_ops = {bk: host_top_ops(step_at(cfg)) for bk, cfg in ((4, cfg4),
                                                              (1, cfg1))}

    n_walked = int(walked.long().sum())
    ra = a_report(tag, "(m1 bucket 4)", tr.records, tr.starts, tr.counts,
                  ntx, nty, walked, t4["kernel A"], rects)
    a_work, a_bound = ra["work"]["lane"], ra["bound"]
    bid = rc.bucket_of_tile(ntx, nty, nty, buckets.bucket, dev)
    rd = c_report(tag, "(m1 bucket 4)", rec, buckets.bstarts[bid],
                  buckets.bcounts[bid], ntx, nty, xstate, depth_grad,
                  t4["kernel D"], buckets.rects)
    rc1 = c_report(tag, "(m1 bucket 1)", *c_args[:5], c_args[6], c_args[7],
                   t1["kernel C"])
    for name, t in (("bucket 4", t4), ("bucket 1", t1)):
        print(f"{tag} m1 {name} (ms, medians): "
              + ", ".join(f"{k} {x:.3f}" for k, x in t.items()), flush=True)
    print(f"{tag} m1 train_step runs in turns (ms): bucket 4 "
          f"{[round(x, 3) for x in step_runs[4]]}, bucket 1 "
          f"{[round(x, 3) for x in step_runs[1]]}", flush=True)
    for bk, (n_kern, busy_ms, wall_ms) in busy.items():
        print(f"{tag} m1 train_step at bucket {bk} profiled once: {n_kern} "
              f"CUDA kernels, device busy {busy_ms:.3f} ms of {wall_ms:.3f} "
              f"ms wall ({busy_ms / wall_ms:.3f}; the profiler adds host "
              f"time); top ops by host self time (ms, calls): "
              f"{top_ops[bk]}", flush=True)
    print(f"{tag} m1 kernel A (bucket 4): {tr.records.shape[0]} records in "
          f"segments, {n_walked} walked by the tiles; pairs [evaluated, past "
          f"power gate, past 1/255 gate, accumulated, rect-gated] {a_work}; "
          f"{t4['kernel A']:.3f} ms vs bound {a_bound:.4f} ms; plain "
          f"{a_plain_ms:.3f} ms", flush=True)
    print(f"{tag} m1 kernel D {t4['kernel D']:.3f} ms (CUDA events, median "
          f"of 5); its kernels in the profiled bucket-4 train_step (ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in d_kern.items())
          + f"; bound {rd['bound']:.4f} ms; plain {d_plain_ms:.3f} ms",
          flush=True)
    print(f"m1 peak device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
          f" GiB", flush=True)

    for entry, key in zip(kernels, ("A", "B", "C", "E")):
        entry["launches_by_path"]["train_m1_bucket4"] = step_launches[key]
        entry["launches"] += step_launches[key]
    kernels[0]["launches_by_path"]["render_m1_bucket4"] = \
        render_launches["A"]
    kernels[0]["launches"] += render_launches["A"]
    kernels[0]["ms_m1_bucket4"] = t4["kernel A"]
    kernels[0]["bound_ms_m1_bucket4"] = a_bound
    kernels[0]["max_abs_err_m1_bucket4"] = a_err
    kernels[2]["ms_m1_bucket1"] = t1["kernel C"]
    kernels[2]["bound_ms_m1_bucket1"] = rc1["bound"]
    return {"name": "composite_bucket_bwd", "route": "cuda",
            "source": "gslm_tpu_torch/csrc/composite_bucket_bwd.cu",
            "replaces": "gslm_tpu/ops/rasterize_pallas.py:928",
            "launches": step_launches["D"],
            "launches_by_path": {"serve": 0, "train_step": 0,
                                 "lm_outer_step": 0,
                                 "train_m1_bucket4": step_launches["D"]},
            "max_abs_err": d_err, "ms": t4["kernel D"],
            "walk_ms": d_kern["walk"], "sum_ms": d_kern["sum"],
            "plain_ms": d_plain_ms, "bound_ms": rd["bound"],
            "bound_by": rd["by"], "library_ms": None,
            "lane_bound_ms": rd["lane bound"],
            "culled_bound_ms": rd["culled bound"],
            "mask_overhead_ms": rd["mask overhead"]}


# cell scene-densify-131k-1080p: the headline scene written to disk as a
# COLMAP scene of 8 ring views, loaded back and trained with density control
SCENE_VIEWS = 8
SCENE_STEPS = 60               # steps before the opacity reset
DENSIFY_AT = (30, 60)          # densify_and_prune after these steps
SCENE_AFTER_RESET = 10         # steps after reset_opacity and a fresh probe
KNN_SAMPLE = 4096              # rows of the 3-NN held to float64 numpy
KNIFE_REL = 1e-6               # rows this close to a threshold may flip
PROFILED_STEPS = (20, 65)      # one before densification, one after
CHECKED_STEPS = (21, 66)       # A, B, C held to plain on these steps' inputs


def knn_float64(points: np.ndarray, rows: np.ndarray, dev=None
                ) -> np.ndarray:
    """Mean squared distance of ``points[rows]`` to their 3 nearest other
    points, brute force in float64 on ``dev`` (the card, or the CPU)."""
    import torch
    p = torch.tensor(points, dtype=torch.float64, device=dev)
    r = torch.as_tensor(rows, device=dev)
    out = torch.empty(len(rows), dtype=torch.float64, device=dev)
    for lo in range(0, len(rows), 256):
        q = p[r[lo:lo + 256]]
        d2 = torch.zeros((len(q), len(p)), dtype=torch.float64, device=dev)
        for i in range(3):
            d2 += (q[:, i:i + 1] - p[None, :, i]) ** 2
        out[lo:lo + 256] = torch.topk(d2, 4, dim=1, largest=False,
                                      sorted=True).values[:, 1:].mean(dim=1)
    return out.cpu().numpy()


F_REPS = 5            # kernel F's and its plain version's timed calls
F_INSTANCES = ("pass 1", "pass 2", "pass 1 counting", "pass 2 counting")
F_CLUSTER_SEED = 5    # cloud (c): clusters with 1 % far outliers
F_OPS = 9             # fp32 operations per candidate pair: 3 sub, 3 mul,
#                       2 add, the compare with the third best


@contextlib.contextmanager
def pcd_calls():
    """Counts the ``create_from_pcd`` calls of ``Scene`` inside the block
    that compute the 3-NN on the card (no ``mean_sq_dist`` given, a CUDA
    device): a list that grows by one per call."""
    from gslm_tpu_torch.device import resolve_device
    from gslm_tpu_torch.models import scene as scene_mod
    real = scene_mod.create_from_pcd
    got = []

    def counted(*a, **k):
        if (k.get("mean_sq_dist") is None
                and resolve_device(k.get("device")).type == "cuda"):
            got.append(1)
        return real(*a, **k)

    scene_mod.create_from_pcd = counted
    try:
        yield got
    finally:
        scene_mod.create_from_pcd = real


@contextlib.contextmanager
def probe_calls():
    """Records ``train_lm``'s ``overflow_probe`` calls on the card inside
    the block: a list that grows by one ``(G, H)`` per call, its kernel G
    launches (1 with culling, else 0) and kernel H's (one per view)."""
    from gslm_tpu_torch import train_lm as TL
    real = TL.overflow_probe
    got = []

    def counted(params, cameras, *, config, **k):
        if params.xyz.device.type == "cuda":
            got.append((int(config.cull), cameras.batch_size))
        return real(params, cameras, config=config, **k)

    TL.overflow_probe = counted
    try:
        yield got
    finally:
        TL.overflow_probe = real


def probe_launches(probes: list) -> dict:
    """Kernels G's and H's launches by ``probe_calls``' records."""
    return {"G": sum(g for g, _ in probes), "H": sum(h for _, h in probes)}


def knn_checks(dev, tag: str, scene_pts: np.ndarray, n_gauss: int) -> dict:
    """Kernel F against its plain version on (a) phase 9's scene points,
    (b) the million-Gaussian scene's means (bench.py:338-378) on
    ``KNN_SAMPLE`` rows, also against float64, and (c) a seeded clustered
    cloud of ``n_gauss`` points with 1 % outliers at 100x the clusters'
    spread; F's times (its search alone on a built grid, and the whole
    wrapper with the grid), the plain version's (not at (b)), candidate
    pairs per point and the byte bound. F's launch count is left as it
    was: these are comparisons. Returns F's kernel entry."""
    import torch

    from gslm_tpu_torch import _build
    from gslm_tpu_torch.ops import knn
    from gslm_tpu_torch.utils.synthetic import clustered_cloud

    f = knn.mean_sq_dist_3nn
    saved = f.launches
    attrs = kernel_attrs(_build.load("knn"), "knn_attrs", F_INSTANCES)
    clouds = {
        "a: phase 9's scene points": scene_pts.astype(np.float32),
        "b: m1 means": np.random.default_rng(2).uniform(
            -1.5, 1.5, (M1_N, 3)).astype(np.float32),
        "c: clustered, 1 % outliers": clustered_cloud(
            np.random.default_rng(F_CLUSTER_SEED), n_gauss),
    }
    res = {}
    for label, pts in clouds.items():
        x = torch.tensor(pts, device=dev)
        n = len(pts)
        got = f(x)
        g = knn.build_grid(x)
        counted, pairs, handed = knn.search(g, count_pairs=True)
        check(torch.equal(counted, got), f"kernel F ({label}): the pair-"
              f"counting instantiation differs")
        check(torch.equal(f(x), got), f"kernel F ({label}): two runs differ")
        search_ms = cuda_ms(lambda: knn.search(g), F_REPS)
        wrapper_ms = cuda_ms(lambda: f(x), F_REPS)
        dims = g.dims
        del g
        r = {"n": n, "dims": dims, "search_ms": search_ms,
             "wrapper_ms": wrapper_ms, "second_pass": int(handed),
             "pairs_mean": float(pairs.double().mean()),
             "pairs_max": int(pairs.max()),
             "bound_ms": n * 16 / PEAK_BYTES * 1e3,
             "pairs_ms": float(pairs.double().sum()) * F_OPS / FP32_RATE
             * 1e3}
        if label.startswith("b"):
            rows = np.sort(np.random.default_rng(4).choice(
                n, min(KNN_SAMPLE, n), replace=False))
            want = knn.mean_sq_dist_3nn_plain(x, chunk=256, rows=rows)
            sub = got[torch.as_tensor(rows, device=dev)]
            r["equal"] = torch.equal(sub, want)
            r["max_abs_err"] = float((sub - want).abs().max())
            ref = knn_float64(pts, rows, dev)
            r["rel64"] = float(np.max(np.abs(sub.cpu().numpy() - ref) / ref))
            check(r["rel64"] <= 1e-5, f"kernel F ({label}) off float64 by "
                  f"{r['rel64']:.3g} relative")
            r["plain_ms"] = None
            what = f"on {len(rows)} rows"
        else:
            want, first = cuda_timed(lambda: knn.mean_sq_dist_3nn_plain(x))
            r["plain_ms"] = statistics.median(
                [first] + cuda_times(lambda: knn.mean_sq_dist_3nn_plain(x),
                                     F_REPS - 1, warmup=0))
            r["equal"] = torch.equal(got, want)
            r["max_abs_err"] = float((got - want).abs().max())
            what = "on every row"
        check(r["equal"], f"kernel F ({label}) differs from its plain version "
              f"{what}: max|d| {r['max_abs_err']:.3g}")
        plain = ("" if r["plain_ms"] is None
                 else f", plain {r['plain_ms']:.1f} ms")
        print(f"{tag} kernel F ({label}, {n} points, grid {dims}): "
              f"bitwise equal to its plain version {what}, repeatable"
              + (f", within {r['rel64']:.3g} relative of float64"
                 if "rel64" in r else "")
              + f"; search {search_ms:.4f} ms, with the grid "
              f"{wrapper_ms:.4f} ms (CUDA events, median of {F_REPS})"
              f"{plain}; candidate pairs per point mean "
              f"{r['pairs_mean']:.1f}, max {r['pairs_max']}; "
              f"{r['second_pass']} points to the second pass; bound "
              f"{r['bound_ms']:.5f} ms (bytes: P x 16 B at 3.35 TB/s); "
              f"the pairs at the fp32 rate {r['pairs_ms']:.4f} ms "
              f"({F_OPS} operations each: F's own work, in no bound)",
              flush=True)
        res[label] = r
        del x, got, want
        torch.cuda.empty_cache()
    f.launches = saved
    a = res["a: phase 9's scene points"]
    return {"name": "knn_mean_sq_dist", "route": "cuda",
            "source": "gslm_tpu_torch/csrc/knn.cu",
            "replaces": "native/gslm_native.cpp:30 (gslm_tpu/native.py:73; "
                        "no Pallas kernel)",
            "launches": 0, "launches_by_path": {},
            "max_abs_err": max(r["max_abs_err"] for r in res.values()),
            "ms": a["search_ms"], "plain_ms": a["plain_ms"],
            "bound_ms": a["bound_ms"], "bound_by": "bytes",
            "library_ms": None, "wrapper_ms": a["wrapper_ms"],
            "attrs": attrs, "clouds": res}


def knife_rows(params, aux, max_grad, min_opacity, extent, max_screen_size,
               percent_dense):
    """(C,) bool: live rows whose thresholded quantities in
    ``densify_and_prune`` (without screen-size pruning) lie within
    ``KNIFE_REL`` relative of their thresholds, computed in float64: there
    the card's and the CPU's float32 exp and sigmoid may disagree."""
    import torch
    d = aux.denom.double()
    grads = torch.where(d > 0, aux.xyz_gradient_accum.double()
                        / torch.clamp(d, min=1.0), 0.0)
    max_scale = torch.exp(params.scaling.detach().double()).amax(dim=1)
    opacity = torch.sigmoid(params.opacity.detach().double()[:, 0])

    def near(q, t):
        return (q - t).abs() <= KNIFE_REL * abs(t)

    check(max_screen_size == 0, "knife_rows: screen-size pruning is on")
    return params.alive & (near(grads, max_grad)
                           | near(max_scale, percent_dense * extent)
                           | near(opacity, min_opacity))


def write_paeth_png(path: str, img: np.ndarray) -> None:
    """Write uint8 (H, W, C) as an 8-bit PNG with every row Paeth-filtered,
    as photos saved by Pillow or Blender mostly are; the port's own writer
    uses Up, whose rows decode one at a time."""
    import struct
    import zlib

    from gslm_tpu_torch.data import png
    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int16)
    b = np.vstack([np.zeros((1, w * c), np.int16), x[:-1]])
    a = np.hstack([np.zeros((h, c), np.int16), x[:, :-c]])
    u = np.hstack([np.zeros((h, c), np.int16), b[:, :-c]])
    pa, pb, pc = np.abs(b - u), np.abs(a - u), np.abs(a + b - 2 * u)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, u))
    raw = np.hstack([np.full((h, 1), 4), (x - pred) & 0xFF]).astype(np.uint8)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, png._COLOUR_TYPES[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(png._SIGNATURE + png._chunk(b"IHDR", ihdr)
                + png._chunk(b"IDAT", zlib.compress(raw.tobytes()))
                + png._chunk(b"IEND", b""))


def a_vs_plain(label: str, c_args) -> float:
    """Kernel A on one step's own records (kernel C's captured inputs)
    against ``composite_tiles_plain`` by the knife-edge bound, its exit
    state equal to the step's; printed. Returns max |Δ|."""
    import torch

    from gslm_tpu_torch.ops import rasterize_cuda as rc
    rec, st, cn, ntx, vrows, _, xstate, _ = c_args
    with torch.no_grad():
        got, walked = rc.composite_tiles(rec, st, cn, ntx, vrows)
        want, _ = rc.composite_tiles_plain(rec, st, cn, ntx, vrows)
        torch.cuda.synchronize()
        ok, a_err = knife_edge_ok(got[:, :rc.IMG_ROWS], want[:, :rc.IMG_ROWS])
        flips = float((got[:, 6] != want[:, 6]).float().mean())
        same_exit = torch.equal(got[:, rc.IMG_ROWS:], xstate)
        del got, want
    print(f"kernel A vs plain ({label}, {int(cn.sum())} records in "
          f"{cn.shape[0]} tiles, at most {int(cn.max())} per tile): max|d| "
          f"{a_err:.3g}; exit positions differ at {flips:.2e} of pixels; "
          f"exit state {'equal' if same_exit else 'NOT equal'} to the "
          f"step's", flush=True)
    check(ok, f"kernel A disagrees with composite_tiles_plain on {label}")
    check(flips <= 0.01, f"kernel A's exit state disagrees with plain on "
          f"{label}")
    check(bool((walked <= cn).all()), f"kernel A walked past a segment on "
          f"{label}")
    check(same_exit, f"kernel A's exit state on {label} differs from the "
          f"step's own")
    return a_err


def step_vs_plain(label: str, c_args, b_args) -> dict:
    """Kernels A, B and C on one ``train_step``'s own inputs (captured by
    ``backward_inputs`` and ``blur_inputs``) against their plain versions:
    A by ``a_vs_plain``; B ``torch.equal`` on the step's SSIM planes and
    their cotangents; C by ``c_vs_plain``. Printed; returns max |Δ| per
    kernel."""
    import torch

    from gslm_tpu_torch.ops.blur_cuda import blur_plain, blur_same
    a_err = a_vs_plain(label, c_args)
    b_err, b_shapes = 0.0, []
    with torch.no_grad():
        for planes, taps in b_args:
            got, want = blur_same(planes, taps), blur_plain(planes, taps)
            torch.cuda.synchronize()
            b_err = max(b_err, float((got - want).abs().max()))
            b_shapes.append(tuple(planes.shape))
            check(torch.equal(got, want), f"kernel B differs from blur_plain "
                  f"on {label}'s planes {tuple(planes.shape)}")
            del got, want
    print(f"kernel B vs plain ({label}) on the step's {len(b_shapes)} plane "
          f"stacks {b_shapes}: max|d| {b_err:.3g}", flush=True)
    return {"A": a_err, "B": b_err, "C": c_vs_plain(label, *c_args)}


def scene_phase(dev, n_gauss: int, height: int, width: int, tag: str,
                kernels: list[dict], root: str) -> str:
    """Phase 9 (cell scene-densify-131k-1080p), in the directory ``root``.
    Adds the phase's launches to the kernel entries A-E in ``kernels``;
    returns the COLMAP scene's directory (``root``/scene), which phase 10
    trains on."""
    import math

    import torch

    from gslm_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from gslm_tpu_torch.config import OptimizationParams
    from gslm_tpu_torch.data import colmap
    from gslm_tpu_torch.data.png import read_png, write_png
    from gslm_tpu_torch.densify import densify_and_prune, reset_opacity
    from gslm_tpu_torch.models.cameras import batch_from_metas
    from gslm_tpu_torch.models.gaussians import (PARAM_GROUPS, GaussianAux,
                                                 GaussianParams,
                                                 create_from_pcd)
    from gslm_tpu_torch.models.scene import Scene
    from gslm_tpu_torch.ops.knn import mean_sq_dist_3nn
    from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
    from gslm_tpu_torch.ops.sh import sh2rgb
    from gslm_tpu_torch.optim import AdamState, init_adam
    from gslm_tpu_torch.renderer import batch_render, overflow_probe
    from gslm_tpu_torch.solver.residuals import scalar_training_loss
    from gslm_tpu_torch.train import train_step
    from gslm_tpu_torch.utils.graphics import fov2focal, rotmat2qvec
    from gslm_tpu_torch.utils.synthetic import make_camera, random_gaussians

    bg = torch.zeros(3, device=dev)
    opt = OptimizationParams()

    def probe_caps(params, batch):
        pr = overflow_probe(params, batch, config=RasterConfig(cull=True),
                            active_sh_degree=3, per_view=True)
        n_aabb, n_live = int(pr["n_aabb"].max()), int(pr["n_live"].max())
        return n_aabb, n_live, caps_from_counts(n_aabb, n_live)

    src = os.path.join(root, "scene")
    model = os.path.join(root, "model")
    sparse = os.path.join(src, "sparse", "0")
    os.makedirs(sparse)
    os.makedirs(os.path.join(src, "images"))

    # ---- 1. the headline scene written as a COLMAP scene ------------
    t0 = time.perf_counter()
    scene_params = random_gaussians(
        np.random.default_rng(0), n=n_gauss, capacity=n_gauss,
        sh_degree=3, num_images=1, spread=1.5, scale_range=(-5.5, -3.5),
        device=dev)
    metas = [make_camera(height=height, width=width,
                         angle=2 * math.pi * i / SCENE_VIEWS,
                         exposure_idx=i) for i in range(SCENE_VIEWS)]
    view_caps = probe_caps(scene_params,
                           batch_from_metas(metas, device=dev))[2]
    written, cams, images, png_ms, render_ms = {}, {}, {}, [], []
    for i, m in enumerate(metas):
        name = f"view_{i:03d}.png"
        with torch.no_grad():
            out, ms = cuda_timed(lambda: batch_render(
                scene_params, batch_from_metas([m], device=dev), bg,
                config=view_caps))
        check(int(out.overflow) == 0, f"view {i} render overflows")
        render_ms.append(ms)
        img = (np.clip(out.render[0].cpu().numpy(), 0, 1) * 255).astype(
            np.uint8).transpose(1, 2, 0)
        t1 = time.perf_counter()
        write_png(os.path.join(src, "images", name), img)
        png_ms.append((time.perf_counter() - t1) * 1e3)
        written[name] = img
        cams[i + 1] = colmap.ColmapCamera(
            i + 1, "PINHOLE", width, height,
            np.array([fov2focal(m.fovx, width), fov2focal(m.fovy, height),
                      width / 2, height / 2]))
        images[i + 1] = colmap.ColmapImage(
            i + 1, rotmat2qvec(m.R.T), m.T.astype(np.float64), i + 1,
            name, np.zeros((0, 2)), np.zeros(0, np.int64))
    colmap.write_cameras_binary(cams, os.path.join(sparse, "cameras.bin"))
    colmap.write_images_binary(images, os.path.join(sparse, "images.bin"))
    xyz = scene_params.xyz.detach().cpu().numpy()
    rgb = (np.clip(sh2rgb(scene_params.features_dc.detach()[:, 0])
                   .cpu().numpy(), 0, 1) * 255).astype(np.uint8)
    colmap.write_points3d_binary(xyz.astype(np.float64), rgb,
                                 np.zeros(n_gauss),
                                 os.path.join(sparse, "points3D.bin"))
    write_s = time.perf_counter() - t0
    del scene_params
    decode_ms = []
    for name in list(written)[:2]:
        t1 = time.perf_counter()
        read_png(os.path.join(src, "images", name))
        decode_ms.append((time.perf_counter() - t1) * 1e3)
    png_bytes = os.path.getsize(os.path.join(src, "images", name))
    t1 = time.perf_counter()
    back = colmap.read_points3d_binary(os.path.join(sparse,
                                                    "points3D.bin"))
    points_ms = (time.perf_counter() - t1) * 1e3
    check(np.array_equal(back[0], xyz.astype(np.float64))
          and np.array_equal(back[1], rgb),
          "points3D.bin not read back exactly")
    # files as other tools write them: every row Paeth, a 1080p view
    # and an 800x800 RGBA crop (a Blender scene's size)
    paeth_ms = {}
    rgba = np.concatenate([img[:800, :800], img[:800, :800, 1:2]], 2)
    for label, pix in (("1080p RGB", img), ("800x800 RGBA", rgba)):
        path = os.path.join(root, "paeth.png")
        write_paeth_png(path, pix)
        t1 = time.perf_counter()
        back = read_png(path)
        paeth_ms[label] = (time.perf_counter() - t1) * 1e3
        check(np.array_equal(back, pix), f"Paeth-filtered {label} PNG "
              f"not read back exactly")
    print(f"{tag} scene written: {SCENE_VIEWS} views {width}x{height} "
          f"(batch_render through kernel A "
          f"{statistics.median(render_ms):.3f} ms median), {n_gauss} "
          f"points in {write_s:.3f} s; PNG encode "
          f"{statistics.median(png_ms):.1f} ms per image (median of "
          f"{len(png_ms)}), decode {statistics.median(decode_ms):.1f} ms "
          f"(median of {len(decode_ms)}), {png_bytes} bytes per PNG; "
          f"points3D.bin ({n_gauss} points) parsed in {points_ms:.1f} ms; "
          f"decode of a Paeth-filtered PNG (ms, one each): "
          + ", ".join(f"{k} {v:.1f}" for k, v in paeth_ms.items()),
          flush=True)

    # ---- 2. the scene loaded on the card ----------------------------
    mean_sq_dist_3nn.launches = 0
    t0 = time.perf_counter()
    with pcd_calls() as pcd:
        scene = Scene(src, model, resolution=1, shuffle=False,
                      capacity=2 * n_gauss, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    f_load = mean_sq_dist_3nn.launches
    check(f_load == 1 and len(pcd) == 1, f"Scene load: kernel F launched "
          f"{f_load} times by {len(pcd)} create_from_pcd calls, expected "
          f"once by one")
    train_cams = scene.get_train_cameras()
    check(len(train_cams) == SCENE_VIEWS,
          f"{len(train_cams)} train cameras, expected {SCENE_VIEWS}")
    for c, m in zip(train_cams, metas):
        want = written[c.image_name].transpose(2, 0, 1).astype(
            np.float32) / 255.0
        check(np.array_equal(c.image, want),
              f"{c.image_name}: loaded pixels differ from those written")
        check(np.allclose(c.R, m.R, rtol=0, atol=1e-6)
              and np.allclose(c.T, m.T, rtol=0, atol=1e-6)
              and abs(c.fovx - m.fovx) <= 1e-6
              and abs(c.fovy - m.fovy) <= 1e-6,
              f"{c.image_name}: R, T or FoV not round-tripped")
    params, aux = scene.params, scene.aux
    n_alive = int(params.alive.sum())
    check(n_alive == n_gauss, f"{n_alive} alive slots, expected {n_gauss}")
    pts = torch.tensor(scene.scene_info.points, dtype=torch.float32,
                       device=dev)
    msd, knn_ms = cuda_timed(lambda: mean_sq_dist_3nn(pts))
    (fresh, _), pcd_ms = cuda_timed(lambda: create_from_pcd(
        scene.scene_info.points, scene.scene_info.colors,
        num_images=SCENE_VIEWS, capacity=2 * n_gauss, mean_sq_dist=msd,
        device=dev))
    check(all(torch.equal(getattr(fresh, g), getattr(params, g))
              for g in PARAM_GROUPS)
          and torch.equal(fresh.alive, params.alive),
          "create_from_pcd given the 3-NN differs from the Scene's model")
    del fresh
    rows = np.sort(np.random.default_rng(4).choice(
        n_gauss, min(KNN_SAMPLE, n_gauss), replace=False))
    want = knn_float64(scene.scene_info.points.astype(np.float32), rows, dev)
    knn_rel = float(np.max(np.abs(msd.cpu().numpy()[rows] - want) / want))
    check(knn_rel <= 1e-5, f"3-NN off float64 by {knn_rel:.3g} relative")
    scale_want = torch.log(torch.sqrt(torch.clamp(msd, min=1e-7)))
    check(torch.equal(params.scaling[:n_gauss, 0], scale_want),
          "the model's log-scales are not the 3-NN's")
    print(f"{tag} Scene loaded in {load_s:.3f} s: {len(train_cams)} "
          f"cameras, pixels bitwise equal to those written, R/T/FoV "
          f"round-tripped to 1e-6, {n_alive} alive of "
          f"{params.capacity}; 3-NN {knn_ms:.3f} ms, create_from_pcd "
          f"given the 3-NN {pcd_ms:.3f} ms (its model equal to the "
          f"Scene's); 3-NN vs float64 on {len(rows)} rows: "
          f"max rel {knn_rel:.3g}; log-scales in "
          f"[{float(params.scaling.detach()[:n_gauss].min()):.3f}, "
          f"{float(params.scaling.detach()[:n_gauss].max()):.3f}]; "
          f"cameras extent "
          f"{scene.cameras_extent:.4f}; kernel F launched once by "
          f"create_from_pcd", flush=True)
    f_entry = knn_checks(dev, tag, scene.scene_info.points, n_gauss)
    f_entry["launches"] = f_load
    f_entry["launches_by_path"]["scene_load"] = f_load
    mean_sq_dist_3nn.launches = 0   # the rest of phase 9 must not launch F

    # ---- 3. training with density control -------------------------
    batches = [batch_from_metas([c], device=dev) for c in train_cams]
    all_views = batch_from_metas(train_cams, device=dev)
    n_aabb, n_live, rcfg = probe_caps(params, all_views)
    print(f"scene overflow_probe (max over {SCENE_VIEWS} views): n_aabb "
          f"{n_aabb}, n_live {n_live} (the headline scene's TRAIN_CAPS: "
          f"dup {TRAIN_CAPS['dup_capacity']}, live "
          f"{TRAIN_CAPS['live_capacity']}); capacities + 5 %: dup "
          f"{rcfg.dup_capacity}, live {rcfg.live_capacity}", flush=True)
    state = init_adam(params)
    extent = scene.cameras_extent
    thresholds = (opt.densify_grad_threshold, 0.005, extent, 0.0,
                  opt.percent_dense)
    ts_kw = dict(opt=opt, active_sh_degree=3, use_exp=False,
                 sparse_adam=False, update_stats=True)
    gen = torch.Generator(dev).manual_seed(9)
    step_ms, losses, events, busy, checked = {}, [], [], {}, {}

    def step(it):
        nonlocal params, aux, state
        cam = batches[(it - 1) % SCENE_VIEWS]

        def fn():
            return train_step(params, aux, state, cam, bg, it, extent,
                              0.0, rcfg=rcfg, **ts_kw)

        if it in PROFILED_STEPS:
            res = []
            busy[it] = device_busy(lambda: res.append(fn()))
            out = res[0]
        elif it in CHECKED_STEPS:
            with backward_inputs() as c_in, blur_inputs() as b_in:
                out = fn()
            check(len(c_in) == 1 and len(b_in) == 2, f"train_step {it}: "
                  f"{len(c_in)} kernel C and {len(b_in)} kernel B "
                  f"launches captured, expected 1 and 2")
            checked[it] = (c_in[0], b_in)
        else:
            out, step_ms[it] = cuda_timed(fn)
        params, aux, state, m = out
        losses.append(float(m["loss"]))
        check(int(m["overflow"]) == 0, f"train_step {it} overflows")
        check(math.isfinite(losses[-1]), f"train_step {it} loss")

    def densify(it):
        nonlocal params, aux, state, rcfg
        c = params.capacity
        noise = tuple(torch.randn((c, 3), generator=gen, device=dev)
                      for _ in range(2))

        def copy(x):
            return x.detach().to("cpu", copy=True)

        host = GaussianParams(**{g: copy(getattr(params, g))
                                 for g in PARAM_GROUPS},
                              sh_degree=params.sh_degree,
                              alive=copy(params.alive))
        host_aux = GaussianAux(*(copy(getattr(aux, f)) for f in (
            "max_radii2d", "xyz_gradient_accum", "denom")))
        host_state = AdamState(
            mu={g: copy(v) for g, v in state.mu.items()},
            nu={g: copy(v) for g, v in state.nu.items()},
            step=state.step)
        edge = knife_rows(host, host_aux, *thresholds)
        n_edge = int(edge.sum())
        (params, aux, state, info), ms = cuda_timed(
            lambda: densify_and_prune(params, aux, state, noise,
                                      *thresholds))
        host_info = densify_and_prune(
            host, host_aux, host_state, tuple(x.cpu() for x in noise),
            *thresholds)[3]
        got = {k: int(v) for k, v in info.items()}
        want = {k: int(v) for k, v in host_info.items()}
        alive_diff = int((params.alive.cpu() != host.alive).sum())
        check(all(abs(got[k] - want[k]) <= n_edge for k in got)
              and alive_diff <= 2 * n_edge,
              f"densify at {it}: card {got}, CPU {want}, {alive_diff} "
              f"alive slots differ, {n_edge} rows at a threshold")
        rel = {}
        if got == want and alive_diff == 0:
            # the same allocation: the rows written must agree
            for g in PARAM_GROUPS:
                w = getattr(host, g).detach()
                d = (getattr(params, g).detach().cpu() - w).abs().max()
                rel[g] = float(d) / (float(w.abs().max()) + 1e-30)
                check(rel[g] <= 1e-6, f"densify at {it}: {g} off the "
                      f"CPU run by {rel[g]:.3g} of max")
                check(all(torch.equal(getattr(state, mm)[g].cpu(),
                                      getattr(host_state, mm)[g])
                          for mm in ("mu", "nu")),
                      f"densify at {it}: {g} moments differ")
        check(got["n_dropped"] == 0, f"densify at {it} dropped "
              f"{got['n_dropped']} requests")
        check(got["n_cloned"] + got["n_split"] > 0,
              f"densify at {it} added no Gaussian")
        events.append((it, got, ms, n_edge))
        # the model changed: capacities from a fresh probe (before the
        # opacity reset, which only shrinks the counts)
        n_aabb, n_live, rcfg = probe_caps(params, all_views)
        print(f"{tag} densify_and_prune after step {it}: {got} "
              f"({ms:.3f} ms); the CPU run on copies: "
              f"{'equal' if got == want else want}, alive slots "
              f"differing {alive_diff}, rows within {KNIFE_REL:g} "
              f"relative of a threshold {n_edge}; parameters vs CPU, "
              f"max|d|/max: "
              f"{ {g: float(f'{v:.3g}') for g, v in rel.items()} }; "
              f"overflow_probe after it: n_aabb {n_aabb}, n_live "
              f"{n_live}, capacities + 5 %: dup {rcfg.dup_capacity}, "
              f"live {rcfg.live_capacity}", flush=True)

    zero_launches()
    for it in range(1, SCENE_STEPS + 1):
        step(it)
        if it in DENSIFY_AT:
            densify(it)
    torch.cuda.synchronize()
    got = launches()
    per_step = {"A": 1, "B": 2, "C": 1, "D": 0, "E": 0, "G": 1, "H": 0}
    want = {k: SCENE_STEPS * v for k, v in per_step.items()}
    want["G"] += len(DENSIFY_AT)     # each event's overflow_probe
    want["H"] += len(DENSIFY_AT) * SCENE_VIEWS     # ... one per view
    print(f"scene train_step launches over {SCENE_STEPS} steps: {got}",
          flush=True)
    check(got == want, f"scene train_step launches {got}, expected "
          f"{want} (per step A 1, B 2, C 1, G 1; G once and H once a view "
          f"per event's probe)")
    counted = dict(got)
    # the launches that hold the kernels to plain come after the count
    errs = [step_vs_plain(f"scene step {CHECKED_STEPS[0]}",
                          *checked.pop(CHECKED_STEPS[0]))]
    params, state = reset_opacity(params, state)
    check(float(torch.sigmoid(params.opacity.detach()[params.alive]).max())
          <= 0.01 + 1e-7, "reset_opacity left an opacity above 0.01")
    zero_launches()
    for it in range(SCENE_STEPS + 1, SCENE_STEPS + SCENE_AFTER_RESET + 1):
        step(it)
    torch.cuda.synchronize()
    got = launches()
    want = {k: SCENE_AFTER_RESET * v for k, v in per_step.items()}
    check(got == want, f"launches after the reset {got}, expected "
          f"{want}")
    counted = {k: counted[k] + got[k] for k in counted}
    errs.append(step_vs_plain(
        f"scene step {CHECKED_STEPS[1]}, after the reset",
        *checked.pop(CHECKED_STEPS[1])))
    print(f"scene loss over {len(losses)} steps: first "
          f"{[round(v, 5) for v in losses[:3]]}, before the first "
          f"densify {losses[DENSIFY_AT[0] - 1]:.5f}, before the reset "
          f"{losses[SCENE_STEPS - 1]:.5f}, last "
          f"{[round(v, 5) for v in losses[SCENE_STEPS:]]}", flush=True)
    iteration = SCENE_STEPS + SCENE_AFTER_RESET

    # ---- 4. checkpoint and PLY round trips ---------------------------
    ck = os.path.join(root, "chkpnt.npz")
    t0 = time.perf_counter()
    save_checkpoint(ck, params, aux, state, iteration, extent)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lp, laux, lstate, lit, lscale = load_checkpoint(ck, device=dev)
    torch.cuda.synchronize()
    load_ck_s = time.perf_counter() - t0
    same = [torch.equal(getattr(lp, g), getattr(params, g))
            for g in PARAM_GROUPS]
    same += [torch.equal(lp.alive, params.alive)]
    same += [torch.equal(getattr(laux, f), getattr(aux, f)) for f in (
        "max_radii2d", "xyz_gradient_accum", "denom")]
    same += [torch.equal(getattr(lstate, mm)[g], getattr(state, mm)[g])
             for mm in ("mu", "nu") for g in PARAM_GROUPS]
    check(all(same) and (lstate.step, lit, lscale) == (
        state.step, iteration, extent),
        "the checkpoint did not round-trip bit for bit")

    def forward(p):
        with torch.no_grad():
            return scalar_training_loss(
                p, batches[0], bg, config=rcfg,
                lambda_dssim=opt.lambda_dssim, active_sh_degree=3)[0]

    loss_live, loss_loaded = forward(params), forward(lp)
    check(torch.equal(loss_live, loss_loaded),
          f"loss from the loaded state {float(loss_loaded)!r} vs the live "
          f"state's {float(loss_live)!r}")
    del lp, laux, lstate
    scene.save(iteration, params)
    back = Scene(src, model, resolution=1, shuffle=False,
                 load_iteration=-1, capacity=params.capacity, device=dev)
    n = int(params.alive.sum())
    check(back.loaded_iter == iteration
          and int(back.params.alive.sum()) == n
          and all(torch.equal(getattr(back.params, g)[:n],
                              getattr(params, g)[params.alive])
                  for g in PARAM_GROUPS[:-1]),
          "Scene.save and reload did not give the live rows back")
    print(f"{tag} checkpoint {os.path.getsize(ck)} bytes: save "
          f"{save_s:.3f} s, load {load_ck_s:.3f} s, every array bitwise "
          f"equal, forward loss from the loaded state bitwise equal "
          f"({float(loss_live):.6f}); Scene.save({iteration}) and reload: "
          f"{n} live rows bitwise equal", flush=True)

    before = [step_ms[i] for i in range(2, DENSIFY_AT[0] + 1) if i in step_ms]
    after = [step_ms[i] for i in range(DENSIFY_AT[-1] + 1, iteration + 1)
             if i in step_ms]
    print(f"{tag} scene train_step (ms, CUDA events): median "
          f"{statistics.median(before):.3f} over steps 2-{DENSIFY_AT[0]} "
          f"({n_alive} alive), {statistics.median(after):.3f} after the "
          f"reset ({n} alive); densify_and_prune "
          + ", ".join(f"{ms:.3f} ms after step {it}" for it, _, ms, _ in events),
          flush=True)
    for it, (n_k, busy_ms, wall_ms) in busy.items():
        print(f"{tag} scene train_step {it} profiled: {n_k} CUDA kernels, "
              f"device busy {busy_ms:.3f} ms of {wall_ms:.3f} ms wall "
              f"({busy_ms / wall_ms:.3f}; the profiler adds host time)",
              flush=True)
    for entry, key in zip(kernels, "ABCDE"):
        entry["launches_by_path"]["scene_densify"] = counted[key]
        entry["launches"] += counted[key]
        if key in errs[0]:
            entry["max_abs_err_scene_densify"] = max(e[key] for e in errs)
    G_LAUNCHES["scene_densify"] = counted["G"]
    H_LAUNCHES["scene_densify"] = counted["H"]
    check(mean_sq_dist_3nn.launches == 0, f"kernel F launched "
          f"{mean_sq_dist_3nn.launches} times by phase 9's steps, density "
          f"events, checkpoint and Scene reload")
    kernels.append(f_entry)
    return src


# ---- phase 10: the trainer's command lines end to end ----------------------

CLI_ITERS = 300                # train.main's Adam iterations
CLI_DENSIFY = (100, 100)       # --densify_from_iter, --densification_interval
CLI_TESTS = (100, 300)         # --test_iterations (and checkpoints)
CLI_PROFILE = (250, 2)         # --profile_from, --profile_steps
CLI_CHECKED = 250              # A, B, C held to plain on this iteration
CLI_LM_ITERS = 2               # train_lm.main: LM iterations after 300
CLI_SGD = (5, 5)               # train_sgd.main: iterations, --num_images
CLI_SGD_CHECKED = 3            # its iteration whose kernel A is held to plain
CLI_VIEWER = (540, 960)        # the viewer client's frame (height, width)
CLI_PSNR_ROUNDING = 0.05       # dB: results.json against evaluate


class _Tee:
    """A stdout that also keeps what is written: the phase reads the lines
    the entry points print."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, x):
        self.parts.append(x)
        return self.out.write(x)

    def flush(self):
        self.out.flush()

    def isatty(self):
        return False

    def text(self) -> str:
        return "".join(self.parts)


@contextlib.contextmanager
def entry_point():
    """An in-process entry point's stdout: a ``_Tee``, and the original
    ``sys.stdout`` back afterwards (``safe_state`` wraps stdout until the
    caller puts its own back, which would stamp this script's last line)."""
    saved = sys.stdout
    tee = _Tee(saved)
    sys.stdout = tee
    try:
        yield tee
    finally:
        sys.stdout = saved


@contextlib.contextmanager
def jvp_inputs():
    """Collects the arguments of the first ``composite_tiles_jvp`` call in
    the block: kernel E's (records, tangents, starts, counts, ntx,
    view_rows, rects)."""
    from gslm_tpu_torch.ops import rasterize_cuda as rc
    real = rc.composite_tiles_jvp
    got = []

    def first(*args):
        if not got:
            got.append(args)
        return real(*args)

    # the wrapper counts its launches on the module's name, which is
    # ``first`` inside the block
    first.launches = real.launches
    rc.composite_tiles_jvp = first
    try:
        yield got
    finally:
        rc.composite_tiles_jvp = real
        real.launches = first.launches


def _delta(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


class LoopProbe:
    """Instruments one in-process run of ``train.training``: per Adam
    attempt its kernel launches and host time (and with ``watch_depth``
    its depth weight, depth L1 and views' depth masks), per iteration the
    loop's own ``IterTimer`` reading and ``opt_state.step``, each density
    event, evaluate and save timed, and chosen iterations' kernel inputs
    captured (``capture``: iteration → what to capture)."""

    def __init__(self, first_iter: int, capture=None,
                 watch_depth: bool = False):
        import torch

        from gslm_tpu_torch import train as T
        self.T, self.torch = T, torch
        self.it = first_iter + 1        # the iteration in progress
        self.last = first_iter          # the last one the loop timed
        self.capture = capture or {}
        # per attempt with ``watch_depth``: (iteration, depth weight, depth
        # L1, the views' exposure indices, each view's depth-mask sum)
        self.watch_depth, self.depth = watch_depth, []
        self.attempts, self.ticks, self.steps = [], {}, {}
        self.events, self.evals, self.saves, self.captured = [], [], [], {}
        self.first_call = None
        self._real = {k: getattr(T, k) for k in (
            "loss_and_grads", "apply_update", "densify_and_prune",
            "evaluate", "save_checkpoint", "IterTimer")}
        self._real_save = None

    def __enter__(self):
        T, probe = self.T, self
        real = self._real

        def loss_and_grads(*a, **k):
            if probe.first_call is None:
                probe.first_call = time.perf_counter()
            before = launches()
            t0 = time.perf_counter()
            what = probe.capture.get(probe.it)
            if what is not None and probe.it not in probe.captured:
                with backward_inputs() as c_in, blur_inputs() as b_in:
                    out = real["loss_and_grads"](*a, **k)
                probe.captured[probe.it] = (c_in[0], b_in)
            else:
                out = real["loss_and_grads"](*a, **k)
            probe.torch.cuda.synchronize()
            probe.attempts.append((probe.it, _delta(before, launches()),
                                   (time.perf_counter() - t0) * 1e3))
            if probe.watch_depth:
                cam = a[1]
                probe.depth.append((
                    probe.it, float(a[3]), float(out[2]),
                    cam.exposure_idx.tolist(),
                    cam.depth_mask.flatten(1).sum(1).tolist()))
            return out

        def apply_update(*a, **k):
            out = real["apply_update"](*a, **k)
            probe.steps[probe.it] = out[2].step
            return out

        def densify(*a, **k):
            out, ms = cuda_timed(lambda: real["densify_and_prune"](*a, **k))
            probe.events.append((probe.last, {n: int(v) for n, v in
                                              out[3].items()}, ms))
            return out

        def evaluate(*a, **k):
            out, ms = cuda_timed(lambda: real["evaluate"](*a, **k))
            probe.evals.append((probe.last, a[2].batch_size, out, ms))
            return out

        def save_checkpoint(*a, **k):
            t0 = time.perf_counter()
            out = real["save_checkpoint"](*a, **k)
            probe.saves.append(("checkpoint", probe.last,
                                (time.perf_counter() - t0) * 1e3))
            return out

        class Timer(real["IterTimer"]):
            def tick(self):
                dt = super().tick()
                probe.ticks[probe.it] = dt
                probe.last = probe.it
                probe.it += 1
                return dt

        from gslm_tpu_torch.models.scene import Scene
        self._real_save = Scene.save

        def scene_save(scene, iteration, params=None):
            t0 = time.perf_counter()
            out = probe._real_save(scene, iteration, params)
            probe.saves.append(("ply", iteration,
                                (time.perf_counter() - t0) * 1e3))
            return out

        Scene.save = scene_save
        for name, fn in (("loss_and_grads", loss_and_grads),
                         ("apply_update", apply_update),
                         ("densify_and_prune", densify),
                         ("evaluate", evaluate),
                         ("save_checkpoint", save_checkpoint),
                         ("IterTimer", Timer)):
            setattr(T, name, fn)
        return self

    def __exit__(self, *exc):
        from gslm_tpu_torch.models.scene import Scene
        for name, fn in self._real.items():
            setattr(self.T, name, fn)
        Scene.save = self._real_save
        return False

    def per_iteration(self) -> dict:
        """iteration → list of the launches of each of its attempts."""
        out = {}
        for it, d, _ in self.attempts:
            out.setdefault(it, []).append(d)
        return out


def viewer_client(port: int, meta, got: dict, timeout: float = 120.0):
    """A SIBR viewer client (a thread): connects to the training loop's
    viewer, asks for one pose with train=1, reads the frame and the verify
    string, times the round trip and hangs up."""
    import socket
    wv_t = meta.world_view.T.astype(np.float32).copy()
    wv_t[:, 1] = -wv_t[:, 1]
    wv_t[:, 2] = -wv_t[:, 2]
    fp_t = meta.full_proj.T.astype(np.float32).copy()
    fp_t[:, 1] = -fp_t[:, 1]
    msg = json.dumps({
        "resolution_x": meta.width, "resolution_y": meta.height,
        "train": True, "fov_y": meta.fovy, "fov_x": meta.fovx,
        "z_near": 0.01, "z_far": 100.0, "shs_python": False,
        "rot_scale_python": False, "keep_alive": False,
        "scaling_modifier": 1.0, "view_matrix": wv_t.flatten().tolist(),
        "view_projection_matrix": fp_t.flatten().tolist()}).encode()
    deadline = time.perf_counter() + timeout

    def recv(s, n):
        buf = b""
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("the viewer server hung up")
            buf += chunk
        return buf

    try:
        while True:
            try:
                s = socket.create_connection(("127.0.0.1", port), timeout=5)
                break
            except OSError:
                if time.perf_counter() > deadline:
                    raise
                time.sleep(0.05)
        with s:
            s.settimeout(timeout)
            t0 = time.perf_counter()
            s.sendall(len(msg).to_bytes(4, "little") + msg)
            got["frame"] = recv(s, meta.height * meta.width * 3)
            n = int.from_bytes(recv(s, 4), "little")
            got["verify"] = recv(s, n).decode("ascii")
            got["ms"] = (time.perf_counter() - t0) * 1e3
    except Exception as e:          # reported by the phase's check
        got["error"] = repr(e)


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def trace_busy(profile_dir: str) -> tuple[int, float, float]:
    """(CUDA kernels, their summed device ms, the traced host span in ms)
    of the Chrome trace the loop's ``--profile_dir`` window wrote."""
    files = [os.path.join(profile_dir, f) for f in os.listdir(profile_dir)
             if f.endswith(".json")]
    check(len(files) == 1, f"{len(files)} profiler traces in {profile_dir}")
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    span = [e for e in events if e.get("ph") == "X" and "dur" in e]
    t0 = min(e["ts"] for e in span)
    t1 = max(e["ts"] + e["dur"] for e in span)
    return len(kern), sum(e["dur"] for e in kern) / 1e3, (t1 - t0) / 1e3


def chunk_caps(params, metas, dev, batch: int = 4):
    """``render_sets``' chunks of ``batch`` views (the last padded with its
    own last view): the most AABB and live records any chunk holds."""
    import torch

    from gslm_tpu_torch.models.cameras import batch_from_metas
    from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
    from gslm_tpu_torch.renderer import overflow_probe
    worst = [0, 0]
    for i0 in range(0, len(metas), batch):
        chunk = metas[i0:i0 + batch]
        chunk = chunk + [chunk[-1]] * (batch - len(chunk))
        with torch.no_grad():
            pr = overflow_probe(params, batch_from_metas(chunk, device=dev),
                                config=RasterConfig(cull=True),
                                active_sh_degree=params.sh_degree)
        worst = [max(worst[0], int(pr["n_aabb"])),
                 max(worst[1], int(pr["n_live"]))]
    return worst


def cli_phase(dev, n_gauss: int, height: int, width: int, tag: str,
              kernels: list[dict], src: str, root: str) -> float:
    """Phase 10 (cell train-cli-131k-1080p): ``train.main``,
    ``train_lm.main``, ``train_sgd.main``, ``render_sets.main`` and
    ``metrics.main`` in-process on phase 9's COLMAP scene ``src``, output
    under ``root``. Adds the phase's launches to the kernel entries A-E in
    ``kernels``; returns the loop's Adam iteration median in ms."""
    import math
    import threading

    import torch

    from gslm_tpu_torch import config as cfg_mod
    from gslm_tpu_torch import renderer
    from gslm_tpu_torch import train as T
    from gslm_tpu_torch import train_lm as TL
    from gslm_tpu_torch import train_sgd as TS
    from gslm_tpu_torch.checkpoint import load_checkpoint
    from gslm_tpu_torch.eval import metrics as M
    from gslm_tpu_torch.eval import render_sets as R
    from gslm_tpu_torch.models.cameras import batch_from_metas
    from gslm_tpu_torch.models.gaussians import PARAM_GROUPS, GaussianTensors
    from gslm_tpu_torch.models.scene import Scene
    from gslm_tpu_torch.renderer import overflow_probe
    from gslm_tpu_torch.utils.synthetic import make_camera

    t_phase = time.perf_counter()
    out = os.path.join(root, "cli")
    out_sgd = os.path.join(root, "cli_sgd")
    prof = os.path.join(root, "cli_profile")
    adam = {"A": 1, "B": 2, "C": 1, "D": 0, "E": 0, "G": 1, "H": 0}
    # the entry points run on the card unless told otherwise
    plat = [] if dev.type == "cuda" else ["--platform", dev.type]
    totals = {k: 0 for k in "ABCDEGH"}
    errs = {}

    # ---- 1. train.main: 300 Adam iterations, the viewer on ---------------
    port = free_port()
    meta = make_camera(height=CLI_VIEWER[0], width=CLI_VIEWER[1],
                       angle=0.3)
    frame = {}
    stash = []
    real_render = renderer.render

    def render(params, camera, bg, **kw):
        # copies: densification later updates the parameters and the
        # alive mask the viewer passes in place
        args = ({g: getattr(params, g).detach().clone()
                 for g in PARAM_GROUPS}, params.alive.clone(),
                params.sh_degree, camera, bg.clone(),
                {k: v.clone() if torch.is_tensor(v) else v
                 for k, v in kw.items()})
        out, ms = cuda_timed(lambda: real_render(params, camera, bg, **kw))
        stash.append(args + (ms,))
        return out

    argv = ["-s", src, "-m", out, "-r", "1", "--eval", "--capacity",
            str(2 * n_gauss), "--iterations", str(CLI_ITERS),
            "--densify_from_iter", str(CLI_DENSIFY[0]),
            "--densification_interval", str(CLI_DENSIFY[1]),
            "--test_iterations", *map(str, CLI_TESTS),
            "--save_iterations", str(CLI_ITERS),
            "--checkpoint_iterations", *map(str, CLI_TESTS),
            "--profile_dir", prof, "--profile_from", str(CLI_PROFILE[0]),
            "--profile_steps", str(CLI_PROFILE[1]), "--port", str(port),
            *plat]
    client = threading.Thread(target=viewer_client, args=(port, meta, frame))
    zero_launches()
    t0 = time.perf_counter()
    renderer.render = render
    try:
        with entry_point() as tee, LoopProbe(0, {CLI_CHECKED: True}) as lp:
            client.start()
            scene, params, aux, state = T.main(argv)
    finally:
        renderer.render = real_render
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    client.join(timeout=30)
    loop_launches = launches()
    text = tee.text()
    startup_s = lp.first_call - t0

    # train_step alone, right after the loop (the allocator as the loop
    # left it), on a copy of iteration 300's state and one train view, at
    # the loop's grown capacities: the loop's own overhead is the
    # difference
    ck = os.path.join(out, f"chkpnt{CLI_ITERS}.npz")
    p, a, st, _, extent = load_checkpoint(ck, device=dev)
    cam1 = batch_from_metas(scene.get_train_cameras()[:1], device=dev)
    rcfg = T.make_raster_config(cfg_mod.TpuParams(), cfg_mod.PipelineParams(),
                                height, width, p.capacity).grow(4)
    opt = cfg_mod.OptimizationParams()

    def step_alone():
        T.train_step(p, a, st, cam1, torch.zeros(3, device=dev), CLI_ITERS,
                     extent, 0.0, rcfg=rcfg.replace(depth_grad=False),
                     opt=opt, active_sh_degree=0, use_exp=False,
                     sparse_adam=False, update_stats=True)

    alone = cuda_times(step_alone, 5)
    alone_host = []
    for _ in range(10):
        t0 = time.perf_counter()
        step_alone()
        torch.cuda.synchronize()
        alone_host.append((time.perf_counter() - t0) * 1e3)
    del p, a, st, cam1

    # the overflow retry of iteration 1
    retries = [int(x) for x in re.findall(
        r"\[ITER 1\] duplicate-buffer overflow: retrying at "
        r"dup_capacity=(\d+)", text)]
    per_it = lp.per_iteration()
    print(f"{tag} train.main: {CLI_ITERS} iterations in {train_s:.1f} s "
          f"(start-up to the first iteration {startup_s:.2f} s); iteration "
          f"1: {len(per_it[1])} attempts, retry lines at dup_capacity "
          f"{retries}, launches per attempt {per_it[1]}", flush=True)
    check(len(retries) == 2 and retries == [4_194_304, 8_388_608],
          f"iteration 1's retries {retries}, expected 4194304 and 8388608")
    check("WARNING" not in text, "an overflow persisted after retries")
    check(all(lp.steps[it] == it for it in range(1, CLI_ITERS + 1)),
          "opt_state.step differs from the iteration count")
    bad = {it: a for it, a in per_it.items() if any(d != adam for d in a)}
    check(not bad, f"Adam attempts launching other than {adam}: "
          f"{dict(list(bad.items())[:3])}")
    check(all(len(a) == 1 for it, a in per_it.items() if it > 1),
          "an Adam iteration after the first was retried")
    n_att = len(lp.attempts)
    # evaluate: one A per call (train and test views at each test
    # iteration); the viewer: one A per frame
    want = {k: n_att * v for k, v in adam.items()}
    extras = 0 if "Tensorboard not available" in text else len(CLI_TESTS)
    for k in "AG":        # each render runs the front end once
        want[k] += len(lp.evals) + len(stash) + extras
    # H once per view of each no-grad render: evaluate's batches, the
    # viewer's frames, the report's first 5 train views
    want["H"] += (sum(n for _, n, _, _ in lp.evals) + len(stash)
                  + extras * min(5, len(scene.get_train_cameras())))
    check(loop_launches == want, f"train.main launches {loop_launches}, "
          f"expected {want}")
    totals = {k: totals[k] + loop_launches[k] for k in totals}

    # PSNR at the test iterations, as the loop printed it
    psnr = {int(it): (float(tr), float(te)) for it, tr, te in re.findall(
        r"\[ITER (\d+)\] train: L1 [\d.]+ PSNR ([\d.]+)  test: L1 [\d.]+ "
        r"PSNR ([\d.]+)", text)}
    print(f"{tag} loop's PSNR (train 5 views / test view): {psnr}; "
          f"evaluate calls (ms): "
          f"{[(it, n, round(ms, 3)) for it, n, _, ms in lp.evals]}",
          flush=True)
    # the held-out view's PSNR is printed, not held to a climb: on this
    # 8-view ring the loop fits the 7 train views while the held-out one
    # falls (23.04 → 21.47 dB, NVIDIA H100 80GB HBM3, PERF.md §6)
    check(sorted(psnr) == list(CLI_TESTS)
          and all(math.isfinite(v) for pair in psnr.values() for v in pair),
          f"test iterations printed {sorted(psnr)}")
    # density events at 200 and 300: Gaussians added, nothing dropped
    ev_its = [it for it, _, _ in lp.events]
    print(f"{tag} density events: "
          + "; ".join(f"after {it}: {c} ({ms:.3f} ms)"
                      for it, c, ms in lp.events), flush=True)
    check(ev_its == list(range(CLI_DENSIFY[0] + CLI_DENSIFY[1], CLI_ITERS + 1,
                               CLI_DENSIFY[1])),
          f"density events after {ev_its}")
    check(all(c["n_dropped"] == 0 and c["n_cloned"] + c["n_split"] > 0
              for _, c, _ in lp.events), "a density event dropped requests "
          "or added nothing")
    # files
    files = ["cfg_args", "cameras.json", "input.ply", "exposure.json",
             os.path.join("point_cloud", f"iteration_{CLI_ITERS}",
                          "point_cloud.ply")] + [
        f"chkpnt{it}.npz" for it in CLI_TESTS]
    missing = [f for f in files if not os.path.exists(os.path.join(out, f))]
    check(not missing, f"train.main did not write {missing}")
    with open(os.path.join(out, "cfg_args")) as f:
        saved = json.load(f)
    back = cfg_mod.get_combined_args(R.build_parser(), ["-m", out])
    check(saved["iterations"] == CLI_ITERS and back.source_path == src
          and back.eval is True, "cfg_args does not read back")
    n_kern, busy_ms, span_ms = trace_busy(prof)
    prof_wall = sum(lp.ticks[it] for it in range(
        CLI_PROFILE[0], CLI_PROFILE[0] + CLI_PROFILE[1]))
    # round trips: the checkpoint and the PLY of iteration 300
    lp_, laux, lstate, lit, _ = load_checkpoint(ck, device=dev)
    same = all(torch.equal(getattr(lp_, g), getattr(params, g))
               for g in PARAM_GROUPS) and torch.equal(lp_.alive,
                                                      params.alive)
    same &= all(torch.equal(getattr(laux, f), getattr(aux, f)) for f in (
        "max_radii2d", "xyz_gradient_accum", "denom"))
    same &= all(torch.equal(getattr(lstate, m)[g], getattr(state, m)[g])
                for m in ("mu", "nu") for g in PARAM_GROUPS)
    check(same and lstate.step == state.step == CLI_ITERS == lit,
          f"chkpnt{CLI_ITERS}.npz does not load bit for bit")
    del lp_, laux, lstate
    ply = Scene(src, out, resolution=1, eval_split=True, shuffle=False,
                load_iteration=CLI_ITERS, capacity=params.capacity,
                device=dev)
    n_live = int(params.alive.sum())
    check(int(ply.params.alive.sum()) == n_live
          and all(torch.equal(getattr(ply.params, g)[:n_live],
                              getattr(params, g)[params.alive])
                  for g in PARAM_GROUPS[:-1]),
          "the iteration's PLY does not load bit for bit")
    del ply

    # the viewer's frame
    check("ms" in frame and frame.get("verify") == src,
          f"viewer client: {frame.get('error', frame.get('verify'))}")
    check(len(stash) == 1, f"{len(stash)} viewer frames rendered")
    groups, alive, sh, cam, bg, kw, frame_ms = stash[0]
    with torch.no_grad():
        again = real_render(GaussianTensors(**groups, sh_degree=sh,
                                            alive=alive), cam, bg, **kw)
        want_frame = (torch.clamp(again.render, 0, 1) * 255).cpu().numpy(
            ).astype(np.uint8).transpose(1, 2, 0)
    check(np.array_equal(np.frombuffer(frame["frame"], np.uint8).reshape(
        want_frame.shape), want_frame), "the viewer's frame differs from "
        "clip(render)·255 of the parameters it was rendered from")
    check(np.allclose(cam.world_view.cpu().numpy(), meta.world_view,
                      atol=1e-6), "the viewer decoded another pose")
    print(f"{tag} viewer: one {meta.width}x{meta.height} frame, round trip "
          f"{frame['ms']:.1f} ms (client's clock, from its request to the "
          f"last byte, the loop's next poll included), its render "
          f"{frame_ms:.3f} ms (CUDA events), bytes equal to "
          f"clip(render)·255 of the parameters it was rendered from, "
          f"overflow {int(again.overflow)}", flush=True)
    del stash, again

    # A, B and C on Adam iteration 250's own inputs
    errs["adam"] = step_vs_plain(f"loop iteration {CLI_CHECKED}",
                                 *lp.captured.pop(CLI_CHECKED))

    # PSNR of chkpnt100 and chkpnt300 on the 7 train views, at the probe's
    # capacities
    train_metas = scene.get_train_cameras()
    views = batch_from_metas(train_metas, device=dev)
    own = {}
    for it in CLI_TESTS:
        p, *_ = load_checkpoint(os.path.join(out, f"chkpnt{it}.npz"),
                                device=dev)
        pr = overflow_probe(p, views, config=T.RasterConfig(cull=True),
                            active_sh_degree=p.sh_degree)
        cfg = caps_from_counts(int(pr["n_aabb"]), int(pr["n_live"]))
        own[it] = T.evaluate(p, None, views, torch.zeros(3, device=dev), cfg,
                             0, False)["psnr"]
        del p
    print(f"{tag} evaluate of chkpnt{CLI_TESTS[0]} / chkpnt{CLI_TESTS[1]} on "
          f"the {len(train_metas)} train views at the probe's capacities: "
          f"PSNR {own[CLI_TESTS[0]]:.3f} / {own[CLI_TESTS[1]]:.3f}",
          flush=True)
    check(own[CLI_TESTS[1]] > own[CLI_TESTS[0]],
          "PSNR on the train views did not climb")
    plain_its = [it for it in range(2, CLI_ITERS + 1)
                 if it not in ev_its and it not in CLI_TESTS
                 and not CLI_PROFILE[0] <= it < sum(CLI_PROFILE)
                 and it != CLI_CHECKED]
    adam_ticks = [lp.ticks[it] for it in plain_its]
    tick_runs = [t for t in ([lp.ticks[it] for it in plain_its
                              if lo < it <= lo + 100]
                             for lo in range(0, CLI_ITERS, 100)) if t]
    del scene, params, aux, state

    del views

    # ---- 2. train_lm.main: resume at 300, two LM iterations --------------
    lm_calls = []
    real_phase = TL.lm_phase
    ck_state = load_checkpoint(ck, device=dev)[0]

    def lm_phase(scene, params, *a, **k):
        first = not lm_calls
        if first:
            check(all(torch.equal(getattr(params, g), getattr(ck_state, g))
                      for g in PARAM_GROUPS)
                  and torch.equal(params.alive, ck_state.alive),
                  f"the LM run does not start at iteration {CLI_ITERS}'s "
                  f"state")
        xyz = params.xyz.detach().clone()
        before, n_probe = launches(), len(probes)
        t0 = time.perf_counter()
        if first:
            with jvp_inputs() as e_in, backward_inputs() as c_in:
                res = real_phase(scene, params, *a, **k)
        else:
            res = real_phase(scene, params, *a, **k)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        lm_calls.append((_delta(before, launches()), ms,
                         float(res[1]["best_val_loss"]),
                         torch.equal(res[0].xyz, xyz),
                         (e_in[0], c_in[0]) if first else None,
                         probe_launches(probes[n_probe:])))
        return res

    TL.lm_phase = lm_phase
    torch.cuda.reset_peak_memory_stats(dev)
    lm_argv = ["-s", src, "-m", out, "-r", "1", "--eval", "--capacity",
               str(2 * n_gauss), "--start_checkpoint", ck, "--iterations",
               str(CLI_ITERS + CLI_LM_ITERS), "--jvp_start",
               str(CLI_ITERS + 1), "--disable_viewer", *plat]
    zero_launches()
    t0 = time.perf_counter()
    try:
        with entry_point() as tee, probe_calls() as probes:
            TL.main(lm_argv)
    finally:
        TL.lm_phase = real_phase
    torch.cuda.synchronize()
    lm_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    del ck_state
    lm_total = launches()
    text = tee.text()
    grow = [int(x) for x in re.findall(r"LM window exceeds record capacity: "
                                       r"growing to dup_capacity=(\d+)", text)]
    # G: one per front end, 71 renders and 6 J·v, and one per probe; H:
    # one per view of the 70 no-grad validation renders and of each probe
    lm_want = {"A": 71, "B": 0, "C": 4, "D": 0, "E": 6, "G": 77, "H": 350}
    print(f"{tag} train_lm.main: {CLI_LM_ITERS} LM iterations in {lm_s:.1f} s"
          f"; probe growth lines at dup_capacity {grow}"
          f"{' and the persists WARNING' if 'WARNING' in text else ''}; per "
          f"iteration: "
          + "; ".join(f"launches {d} (its probes' {n_p}), {ms:.1f} ms, best "
                      f"val loss {v:.6f}, xyz "
                      f"{'unchanged' if same else 'MOVED'}"
                      for d, ms, v, same, _, n_p in lm_calls)
          + f"; peak device memory {peak / 2**30:.2f} GiB", flush=True)
    check(len(lm_calls) == CLI_LM_ITERS, f"{len(lm_calls)} LM iterations")
    check(all(d == lm_want | {k: lm_want[k] + n_p[k] for k in "GH"}
              for d, *_, n_p in lm_calls),
          f"LM iteration launches, expected {lm_want} each, G one more per "
          f"probe and H one more per probed view")
    check(all(math.isfinite(v) and same for _, _, v, same, *_ in lm_calls),
          "an LM iteration's best validation loss is not finite, or xyz "
          "moved under mask_xyz")
    check(grow and all(b == 2 * a for a, b in zip([2_097_152] + grow, grow)),
          f"LM probe growth {grow}: expected doublings from 2097152")
    n_p = probe_launches(probes)
    check(lm_total == {k: CLI_LM_ITERS * v for k, v in lm_want.items()}
          | {k: CLI_LM_ITERS * lm_want[k] + n_p[k] for k in "GH"},
          f"train_lm.main launches {lm_total}, {len(probes)} probes ({n_p})")
    totals = {k: totals[k] + lm_total[k] for k in totals}
    e_args, c_args = lm_calls[0][4]
    rec, tng, st, cn, ntx, nty = e_args[:6]
    label = f"LM iteration {CLI_ITERS + 1}'s window"
    errs["lm_E"] = e_vs_plain(label, rec, tng, st, cn, ntx, nty)["err"]
    errs["lm_C"] = c_vs_plain(label + ", one Jᵀ·u", *c_args)
    del lm_calls, e_args, c_args, rec, tng
    render_dirs = [os.path.join(s_, f"ours_{CLI_ITERS + CLI_LM_ITERS}")
                   for s_ in ("train", "test")]

    # ---- 3. train_sgd.main: 5 iterations of 5-view windows ---------------
    sgd_argv = ["-s", src, "-m", out_sgd, "-r", "1", "--eval",
                "--capacity", str(2 * n_gauss), "--start_checkpoint", ck,
                "--iterations", str(CLI_ITERS + CLI_SGD[0]), "--num_images",
                str(CLI_SGD[1]), "--disable_viewer", *plat]
    zero_launches()
    with entry_point() as tee, LoopProbe(
            CLI_ITERS, {CLI_ITERS + CLI_SGD_CHECKED: True}) as sp:
        TS.main(sgd_argv)
    torch.cuda.synchronize()
    sgd_total = launches()
    sgd_per_it = sp.per_iteration()
    kinds = sorted({str(d) for a in sgd_per_it.values() for d in a})
    print(f"{tag} train_sgd.main: {CLI_SGD[0]} iterations of {CLI_SGD[1]}-"
          f"view windows; attempts per iteration "
          f"{ {it: len(a) for it, a in sgd_per_it.items()} }, launches per "
          f"attempt {kinds}"
          f"; iteration ms (loop's clock) "
          f"{[round(v, 1) for v in sp.ticks.values()]}"
          f"{'; degraded-render WARNING' if 'WARNING' in tee.text() else ''}",
          flush=True)
    check(all(d == adam for a in sgd_per_it.values() for d in a),
          f"SGD attempts launching other than {adam}")
    check(sgd_total == {k: len(sp.attempts) * v for k, v in adam.items()},
          f"train_sgd.main launches {sgd_total}")
    check(len(sgd_per_it) == CLI_SGD[0], "SGD iterations")
    totals = {k: totals[k] + sgd_total[k] for k in totals}
    c_sgd, _ = sp.captured.pop(CLI_ITERS + CLI_SGD_CHECKED)
    errs["sgd_A"] = a_vs_plain(f"SGD iteration "
                               f"{CLI_ITERS + CLI_SGD_CHECKED}'s "
                               f"{CLI_SGD[1]}-view stack", c_sgd)
    del c_sgd

    # ---- 4. render_sets.main, then metrics.main, on the LM run's output --
    model = Scene(src, out, resolution=1, eval_split=True, shuffle=False,
                  load_iteration=-1, device=dev)
    metas = model.get_train_cameras() + model.get_test_cameras()
    n_aabb, n_live = chunk_caps(model.params, model.get_train_cameras(), dev)
    t_aabb, t_live = chunk_caps(model.params, model.get_test_cameras(), dev)
    caps = caps_from_counts(max(n_aabb, t_aabb), max(n_live, t_live))
    rcfg = T.make_raster_config(
        cfg_mod.TpuParams(dup_capacity=caps.dup_capacity,
                          live_capacity=caps.live_capacity),
        cfg_mod.PipelineParams(), height, width, model.params.capacity)
    zero_launches()
    t0 = time.perf_counter()
    with entry_point():
        R.main(["-m", out, "--iteration", "-1", "--dup_capacity",
                str(caps.dup_capacity), "--live_capacity",
                str(caps.live_capacity), *plat])
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    r_launch = launches()
    n_chunks = sum(-(-len(m) // 4) for m in (model.get_train_cameras(),
                                             model.get_test_cameras()))
    check(r_launch == {"A": n_chunks, "B": 0, "C": 0, "D": 0, "E": 0,
                       "G": n_chunks, "H": 4 * n_chunks},
          f"render_sets launches {r_launch}, expected A and G {n_chunks}, H "
          f"once per view of the chunks of 4")
    for d in render_dirs:
        for sub in ("renders", "gt"):
            n = len(os.listdir(os.path.join(out, d, sub)))
            check(n == len(model.get_train_cameras() if d.startswith("train")
                           else model.get_test_cameras()),
                  f"{d}/{sub} holds {n} files")
    zero_launches()
    t0 = time.perf_counter()
    with entry_point():
        M.main(["-m", out, *plat])
    torch.cuda.synchronize()
    metrics_s = time.perf_counter() - t0
    m_launch = launches()
    n_pairs = len(model.get_test_cameras())
    check(m_launch == {"A": 0, "B": n_pairs, "C": 0, "D": 0, "E": 0, "G": 0,
                       "H": 0},
          f"metrics launches {m_launch}, expected B {n_pairs}")
    for k in totals:
        totals[k] += r_launch[k] + m_launch[k]
    with open(os.path.join(out, "results.json")) as f:
        results = json.load(f)[f"ours_{CLI_ITERS + CLI_LM_ITERS}"]
    # the same render as render_sets made (the test view padded to its
    # chunk of 4, render_sets' capacities), and at the probe's capacities
    test = model.get_test_cameras()
    chunk = batch_from_metas(test + [test[-1]] * (4 - len(test)), device=dev)
    with torch.no_grad():
        same_r = renderer.batch_render(model.params, chunk,
                                       torch.zeros(3, device=dev),
                                       config=rcfg)
    psnr_same = float(torch.mean(T.psnr(same_r.render[:len(test)],
                                        chunk.gt_image[:len(test)])))
    tcam = batch_from_metas(test, device=dev)
    pr = overflow_probe(model.params, tcam, config=T.RasterConfig(cull=True),
                        active_sh_degree=model.params.sh_degree)
    full_cfg = caps_from_counts(int(pr["n_aabb"]), int(pr["n_live"]))
    full = T.evaluate(model.params, None, tcam, torch.zeros(3, device=dev),
                      full_cfg, model.params.sh_degree, False)["psnr"]
    # metrics on an undegraded render: that test view at the probe's
    # capacities, written as render_sets writes it (save_png), scored by
    # metrics.evaluate_dir and held to evaluate's PSNR
    und = out + "_undegraded"
    with torch.no_grad():
        full_r = renderer.batch_render(
            model.params, tcam, torch.zeros(3, device=dev), config=full_cfg,
            active_sh_degree=model.params.sh_degree, alive=model.params.alive)
    check(int(full_r.overflow) == 0, "the probe-capacity render overflowed")
    for sub, imgs in (("renders", full_r.render), ("gt", tcam.gt_image)):
        os.makedirs(os.path.join(und, sub))
        for i, img in enumerate(imgs.cpu().numpy()):
            R.save_png(os.path.join(und, sub, f"{i:05d}.png"), img)
    psnr_und = M.evaluate_dir(und, use_lpips=False, device=dev)[0]["PSNR"]
    print(f"{tag} render_sets: {len(metas)} views in {n_chunks} chunks of 4 "
          f"in {render_s:.2f} s ({render_s / len(metas) * 1e3:.1f} ms per "
          f"view); chunk records (AABB, live) {max(n_aabb, t_aabb)}, "
          f"{max(n_live, t_live)} against make_raster_config's dup "
          f"{rcfg.dup_capacity}, live {rcfg.live_capacity} (overflow "
          f"{int(same_r.overflow)}); metrics {metrics_s:.2f} s for {n_pairs} "
          f"pair(s); results.json PSNR {results['PSNR']:.4f}, SSIM "
          f"{results['SSIM']:.4f}, LPIPS {results['LPIPS']}; the same render "
          f"{psnr_same:.4f} dB; evaluate at the probe's capacities "
          f"{full:.4f} dB, metrics.evaluate_dir of that render's PNGs "
          f"{psnr_und:.4f} dB", flush=True)
    check(abs(results["PSNR"] - psnr_same) <= CLI_PSNR_ROUNDING,
          f"results.json PSNR {results['PSNR']} vs the render's {psnr_same}")
    check(abs(psnr_und - full) <= CLI_PSNR_ROUNDING,
          f"metrics.evaluate_dir PSNR {psnr_und} of the undegraded render "
          f"vs evaluate's {full}")
    del model, same_r, full_r

    phase_s = time.perf_counter() - t_phase
    prof_busy = busy_ms / prof_wall
    print(f"{tag} train-cli timings: start-up {startup_s:.2f} s; Adam "
          f"iteration in the loop {statistics.median(adam_ticks):.3f} ms "
          f"median of {len(adam_ticks)} (loop's clock; by hundreds "
          f"{[round(statistics.median(t), 3) for t in tick_runs]}) vs "
          f"train_step alone on iteration {CLI_ITERS}'s state "
          f"{statistics.median(alone):.3f} ms (CUDA events, median of 5), "
          f"{statistics.median(alone_host):.3f} ms (host clock, median of "
          f"10); "
          f"the retried iteration 1 {lp.ticks[1]:.1f} ms; density events "
          f"{[round(ms, 3) for _, _, ms in lp.events]} ms; evaluate "
          f"{[round(ms, 3) for *_, ms in lp.evals]} ms; saves "
          f"{[(k, it, round(ms, 1)) for k, it, ms in lp.saves]}; profiled "
          f"iterations {CLI_PROFILE[0]}-{sum(CLI_PROFILE) - 1}: {n_kern} CUDA "
          f"kernels, device busy {busy_ms:.3f} ms of {prof_wall:.3f} ms "
          f"(loop's clock; {prof_busy:.3f}; traced span {span_ms:.1f} ms); "
          f"phase wall {phase_s:.1f} s", flush=True)
    for entry, key in zip(kernels, "ABCDE"):
        entry["launches_by_path"]["train_cli"] = totals[key]
        entry["launches"] += totals[key]
    G_LAUNCHES["train_cli"] = totals["G"]
    H_LAUNCHES["train_cli"] = totals["H"]
    kernels[0]["max_abs_err_train_cli"] = max(errs["adam"]["A"],
                                              errs["sgd_A"])
    kernels[1]["max_abs_err_train_cli"] = errs["adam"]["B"]
    kernels[2]["max_abs_err_train_cli"] = max(errs["adam"]["C"],
                                              errs["lm_C"])
    kernels[4]["max_abs_err_train_cli"] = errs["lm_E"]
    return statistics.median(adam_ticks)


DEPTH_MAP = (540, 960)         # the monocular maps' (height, width)
DEPTH_ITERS = 100              # train.main -d: Adam iterations
DEPTH_CHECKED = (50, 51, 52)   # C held to plain on the first reliable one
DEPTH_SGD = (3, 5)             # train_sgd.main -d: windows, --num_images
DEPTH_SEEN_REL = 0.01          # a point is seen where the surface is
DEPTH_SCALE_TOL = 0.10         # fitted scale·a within 10 % of 1
DEPTH_ODD = 10.0               # the unreliable view's a, times the others'
LPIPS_REL = 1e-4               # LPIPS on the card against the CPU


def depth_maps(params, metas, dev, caps):
    """Each view's (``metas``) normalised inverse depth (the kernel-A
    render's inverse depth over its alpha, 0 where the alpha is at most
    0.5) and its alpha, as float64 numpy: two composites of the same
    records, over black and over white, give T."""
    import torch

    from gslm_tpu_torch.models.cameras import camera_from_meta
    from gslm_tpu_torch.ops.projection import preprocess
    from gslm_tpu_torch.ops.rasterize_cuda import rasterize_cuda
    out = []
    for m in metas:
        h, w = m.height, m.width
        cam = camera_from_meta(m, device=dev)
        with torch.no_grad():
            splats = preprocess(params, cam, active_sh_degree=3,
                                alive=params.alive)
            black = rasterize_cuda(splats, h, w, torch.zeros(3, device=dev),
                                   caps)
            white = rasterize_cuda(splats, h, w, torch.ones(3, device=dev),
                                   caps)
        check(int(black["overflow"]) == 0, "a depth-map render overflows")
        alpha = (1.0 - (white["render"][0] - black["render"][0])).double()
        inv = black["invdepth"][0].double()
        norm = torch.where(alpha > 0.5, inv / alpha.clamp(min=1e-6), 0.0)
        out.append((norm.cpu().numpy(), alpha.cpu().numpy()))
    return out


def observations(xyz, meta, norm, alpha):
    """The points a view sees: those in front whose inverse depth is within
    ``DEPTH_SEEN_REL`` of the surface's (the normalised inverse depth of
    the small map) at all four pixels ``make_depth_scale``'s bilinear
    sample of them reads, so that the sample is the point's own depth:
    (xys at the view's resolution in COLMAP's convention, point ids)."""
    from gslm_tpu_torch.utils.graphics import fov2focal
    cam = xyz @ meta.R + meta.T               # w2c = meta.R.T
    z = cam[:, 2]
    fx = fov2focal(meta.fovx, meta.width)
    fy = fov2focal(meta.fovy, meta.height)
    with np.errstate(divide="ignore", invalid="ignore"):
        x = fx * cam[:, 0] / z + meta.width / 2
        y = fy * cam[:, 1] / z + meta.height / 2
    h, w = norm.shape
    # make_depth_scale samples the map at xys·s, integers at pixel centres
    sx, sy = x * h / meta.height, y * h / meta.height
    inside = ((z > 0.2) & (sx >= 0) & (sx < w - 1) & (sy >= 0)
              & (sy < h - 1))
    ids = np.nonzero(inside)[0]
    x0 = np.floor(sx[ids]).astype(np.int64)
    y0 = np.floor(sy[ids]).astype(np.int64)
    inv = 1.0 / z[ids]
    seen = np.ones(len(ids), bool)
    for dy in (0, 1):
        for dx in (0, 1):
            n, a = norm[y0 + dy, x0 + dx], alpha[y0 + dy, x0 + dx]
            seen &= (a > 0.5) & (np.abs(n - inv) <= DEPTH_SEEN_REL * inv)
    ids = ids[seen]
    return np.stack([x[ids], y[ids]], 1), ids.astype(np.int64)


@contextlib.contextmanager
def bwd_flags():
    """Collects the ``depth_grad`` flag of every ``Composite.backward``
    (kernel C's, or D's, launch) inside the block."""
    from gslm_tpu_torch.ops import rasterize_cuda as rc
    real = rc.Composite.backward
    got = []

    def backward(ctx, gtiles, gwalked):
        got.append(bool(ctx.geometry[2]))
        return real(ctx, gtiles, gwalked)

    rc.Composite.backward = staticmethod(backward)
    try:
        yield got
    finally:
        rc.Composite.backward = staticmethod(real)


def depth_phase(dev, n_gauss: int, height: int, width: int, tag: str,
                kernels: list[dict], src: str, root: str,
                cli_adam_ms: float) -> str:
    """Phase 11 (cell scene-depth-131k-1080p): depth-supervised training on
    phase 9's scene ``src``. Writes each view's observations of the points
    and a folder of 16-bit inverse-depth maps (a per-view affine of the
    port's render, one view's scale 10x), runs ``make_depth_scale``, then
    ``train.main -d depths`` and ``train_sgd.main -d depths`` in-process.
    Adds the phase's launches to ``kernels``; returns the training run's
    model directory (phase 12 scores it)."""
    import math
    import random

    import torch

    from gslm_tpu_torch import train as T
    from gslm_tpu_torch import train_sgd as TS
    from gslm_tpu_torch.data import colmap
    from gslm_tpu_torch.data.png import read_png, write_png
    from gslm_tpu_torch.data.readers import load_scene_info
    from gslm_tpu_torch.models.cameras import batch_from_metas
    from gslm_tpu_torch.models.scene import Scene
    from gslm_tpu_torch.ops import rasterize_cuda as rc
    from gslm_tpu_torch.renderer import overflow_probe
    from gslm_tpu_torch.tools import make_depth_scale as MDS
    from gslm_tpu_torch.train_sgd import select_window
    from gslm_tpu_torch.utils.synthetic import make_camera, random_gaussians

    t_phase = time.perf_counter()
    plat = [] if dev.type == "cuda" else ["--platform", dev.type]
    sparse = os.path.join(src, "sparse", "0")
    depths = os.path.join(src, "depths")
    os.makedirs(depths)
    out = os.path.join(root, "depth")
    out_sgd = os.path.join(root, "depth_sgd")
    adam = {"A": 1, "B": 2, "C": 1, "D": 0, "E": 0, "G": 1, "H": 0}

    # the view that comes out unreliable: one the SGD windows take, in the
    # train order the loop's Scene makes (random.Random(0) over the
    # readers' order) and the windows' own draws (default_rng(0))
    info = load_scene_info(src, eval_split=True)
    names = [c.image_name for c in info.train_cameras]
    random.Random(0).shuffle(names)
    wrng = np.random.default_rng(0)
    windows = [select_window(len(names), DEPTH_SGD[1], wrng)
               for _ in range(DEPTH_SGD[0])]
    odd = names[windows[0][1]]

    # ---- 1. observations and 16-bit inverse-depth maps ------------------
    t0 = time.perf_counter()
    scene_params = random_gaussians(
        np.random.default_rng(0), n=n_gauss, capacity=n_gauss,
        sh_degree=3, num_images=1, spread=1.5, scale_range=(-5.5, -3.5),
        device=dev)
    xyz = scene_params.xyz.detach().cpu().numpy().astype(np.float64)
    metas = [make_camera(height=height, width=width,
                         angle=2 * math.pi * i / SCENE_VIEWS,
                         exposure_idx=i) for i in range(SCENE_VIEWS)]
    small = [make_camera(height=DEPTH_MAP[0], width=DEPTH_MAP[1],
                         angle=2 * math.pi * i / SCENE_VIEWS)
             for i in range(SCENE_VIEWS)]
    caps = caps_from_counts(*(int(v.max()) for v in overflow_probe(
        scene_params, batch_from_metas(small, device=dev),
        config=T.RasterConfig(cull=True), active_sh_degree=3,
        per_view=True).values()))
    maps = depth_maps(scene_params, small, dev, caps)
    del scene_params
    images = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
    affine, n_obs, png_w, png_r = {}, [], [], []
    for (iid, im), m, (norm, alpha) in zip(sorted(images.items()), metas,
                                           maps):
        xys, ids = observations(xyz, m, norm, alpha)
        images[iid] = colmap.ColmapImage(im.id, im.qvec, im.tvec,
                                         im.camera_id, im.name, xys, ids)
        n_obs.append(len(ids))
        i = m.exposure_idx
        a = (0.1 + 0.01 * i) * (DEPTH_ODD if im.name == odd else 1.0)
        b = 0.02 + 0.004 * i
        affine[im.name] = a
        mono = np.where(alpha > 0.5, a * norm + b, b)
        u16 = np.clip(np.round(mono * 2 ** 16), 0, 2 ** 16 - 1).astype(
            np.uint16)
        path = os.path.join(depths, os.path.splitext(im.name)[0] + ".png")
        t1 = time.perf_counter()
        write_png(path, u16)
        png_w.append((time.perf_counter() - t1) * 1e3)
        t1 = time.perf_counter()
        back = read_png(path)
        png_r.append((time.perf_counter() - t1) * 1e3)
        check(np.array_equal(back[..., 0], u16), f"{path} not read back "
              f"exactly")
    colmap.write_images_binary(images, os.path.join(sparse, "images.bin"))
    write_s = time.perf_counter() - t0
    check(min(n_obs) > 100, f"observations per view {n_obs}")

    # ---- 2. make_depth_scale ---------------------------------------------
    t0 = time.perf_counter()
    with entry_point():
        MDS.main(["--base_dir", src, "--depths_dir", depths])
    mds_s = time.perf_counter() - t0
    with open(os.path.join(sparse, "depth_params.json")) as f:
        fitted = json.load(f)
    check(len(fitted) == SCENE_VIEWS, f"{len(fitted)} depth params")
    med = float(np.median([v["scale"] for v in fitted.values()]))
    fit = {n: fitted[os.path.splitext(n)[0]]["scale"] * a
           for n, a in affine.items()}
    print(f"{tag} depth inputs: {SCENE_VIEWS} maps {DEPTH_MAP[1]}x"
          f"{DEPTH_MAP[0]} 16-bit (write {statistics.median(png_w):.1f} ms, "
          f"read {statistics.median(png_r):.1f} ms, median of "
          f"{len(png_w)}), observations per view {n_obs}, written in "
          f"{write_s:.2f} s; make_depth_scale {mds_s:.3f} s; fitted scale·a "
          f"per view {[round(v, 4) for v in fit.values()]}; the odd view "
          f"{odd}: scale {fitted[os.path.splitext(odd)[0]]['scale']:.4f} "
          f"vs median {med:.4f}", flush=True)
    bad = {n: v for n, v in fit.items()
           if n != odd and abs(v - 1) > DEPTH_SCALE_TOL}
    check(not bad, f"fitted scale·a off 1 by more than {DEPTH_SCALE_TOL}: "
          f"{bad}")
    check(fitted[os.path.splitext(odd)[0]]["scale"] < 0.2 * med,
          f"the odd view {odd}'s scale is not under 0.2 x the median")

    # ---- 3. Scene load with and without the maps, in turns ---------------
    load_s = {"without": [], "with": []}
    for turn in ("without", "with"):
        t0 = time.perf_counter()
        sc = Scene(src, os.path.join(root, f"depth_load_{turn}"),
                   depths="depths" if turn == "with" else "", resolution=1,
                   eval_split=True, shuffle=False, capacity=2 * n_gauss,
                   device=dev)
        torch.cuda.synchronize()
        load_s[turn].append(time.perf_counter() - t0)
        if turn == "with":
            cams = {c.image_name: c for c in sc.get_train_cameras()}
    check(not cams[odd].depth_reliable
          and float(cams[odd].depth_mask.sum()) == 0,
          f"the odd view {odd} is not unreliable with a zero mask")
    check(all(c.depth_reliable and c.invdepthmap.shape == (1, height, width)
              for n, c in cams.items() if n != odd),
          "a view other than the odd one is unreliable")
    del sc, cams

    # ---- 4. train.main -d depths -----------------------------------------
    argv = ["-s", src, "-m", out, "-d", "depths", "-r", "1", "--eval",
            "--capacity", str(2 * n_gauss), "--iterations", str(DEPTH_ITERS),
            "--test_iterations", str(DEPTH_ITERS), "--save_iterations",
            str(DEPTH_ITERS), "--checkpoint_iterations", str(DEPTH_ITERS),
            "--disable_viewer", *plat]
    zero_launches()
    t0 = time.perf_counter()
    with entry_point() as tee, bwd_flags() as flags, LoopProbe(
            0, {it: True for it in DEPTH_CHECKED}, watch_depth=True) as lp:
        T.main(argv)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    loop_launches = launches()
    text = tee.text()
    per_it = lp.per_iteration()
    n_att = len(lp.attempts)
    want = {k: n_att * v for k, v in adam.items()}
    extras = 0 if "Tensorboard not available" in text else 1
    for k in "AG":        # each render runs the front end once
        want[k] += len(lp.evals) + extras
    # H once per view of evaluate's batches and the report's 5 train views
    want["H"] += (sum(n for _, n, _, _ in lp.evals)
                  + extras * min(5, len(names)))
    check(loop_launches == want, f"train.main -d launches {loop_launches}, "
          f"expected {want}")
    check(len(flags) == n_att == loop_launches["C"] and all(flags),
          f"kernel C's depth_grad over {n_att} attempts: {len(flags)} "
          f"backward(s), {sum(flags)} with depth_grad")
    check(all(lp.steps[it] == it for it in range(1, DEPTH_ITERS + 1)),
          "opt_state.step differs from the iteration count")
    # the exposure indices follow the train order, ``names``
    rows = [(it, dw, d, [names[v] for v in views], m)
            for it, dw, d, views, m in lp.depth]
    odd_rows = [r for r in rows if r[3] == [odd]]
    check(odd_rows and all(dw == 0 and d == 0 and m == [0]
                           for _, dw, d, _, m in odd_rows),
          f"the odd view's iterations carry a depth term: {odd_rows[:3]}")
    rel = [(it, d) for it, dw, d, v, _ in rows if v != [odd] and dw > 0]
    first = statistics.median(d for _, d in rel[:10])
    last = statistics.median(d for _, d in rel[-10:])
    check(last < first, f"depth_l1 did not fall: {first} → {last}")
    # kernel C on the first checked iteration with an invdepth cotangent
    c_err, c_ms = None, {}
    for it in DEPTH_CHECKED:
        c_args, _ = lp.captured.pop(it)
        if c_err is None and float(c_args[5][:, 3].abs().max()) > 0:
            check(c_args[7] is True, "a captured backward ran without "
                  "depth_grad")
            c_err = c_vs_plain(f"depth loop iteration {it}, invdepth "
                               f"cotangent max "
                               f"{float(c_args[5][:, 3].abs().max()):.3g}",
                               *c_args)
            for turn in (True, False, False, True):
                c_ms.setdefault(turn, []).append(cuda_ms(
                    lambda: rc.composite_tiles_bwd(*c_args[:7], turn), 5))
        del c_args
    check(c_err is not None, f"no checked iteration {DEPTH_CHECKED} had an "
          f"invdepth cotangent")
    plain_its = [it for it in range(2, DEPTH_ITERS)
                 if it not in DEPTH_CHECKED]
    loop_ms = statistics.median(lp.ticks[it] for it in plain_its)
    psnr = re.findall(r"\[ITER %d\] train: L1 [\d.]+ PSNR ([\d.]+)  test: "
                      r"L1 [\d.]+ PSNR ([\d.]+)" % DEPTH_ITERS, text)
    check(len(psnr) == 1, "the test iteration's PSNR line is missing")
    print(f"{tag} train.main -d depths: {DEPTH_ITERS} iterations in "
          f"{train_s:.1f} s; iteration 1: {len(per_it[1])} attempts; kernel "
          f"C launched {loop_launches['C']} times, every one with depth_grad "
          f"True; depth_l1 (reliable views, median of 10) {first:.5f} → "
          f"{last:.5f}; the odd view {len(odd_rows)} iterations with weight "
          f"0 and depth_l1 0; PSNR at {DEPTH_ITERS} train / test {psnr[0]}",
          flush=True)
    totals = dict(loop_launches)

    # ---- 5. train_sgd.main -d depths: the odd view inside a window -------
    ck = os.path.join(out, f"chkpnt{DEPTH_ITERS}.npz")
    sgd_argv = ["-s", src, "-m", out_sgd, "-d", "depths", "-r", "1",
                "--eval", "--capacity", str(2 * n_gauss),
                "--start_checkpoint", ck, "--iterations",
                str(DEPTH_ITERS + DEPTH_SGD[0]), "--num_images",
                str(DEPTH_SGD[1]), "--disable_viewer", *plat]
    zero_launches()
    with entry_point(), bwd_flags() as sflags, LoopProbe(
            DEPTH_ITERS, watch_depth=True) as sp:
        TS.main(sgd_argv)
    torch.cuda.synchronize()
    sgd_total = launches()
    check(sgd_total == {k: len(sp.attempts) * v for k, v in adam.items()},
          f"train_sgd.main -d launches {sgd_total}")
    check(all(sflags) and len(sflags) == len(sp.attempts),
          "an SGD attempt's kernel C ran without depth_grad")
    sgd_rows = [([names[v] for v in views], dw, d, m)
                for _, dw, d, views, m in sp.depth]
    check(sgd_rows[0][0] == [names[v] for v in windows[0]],
          "the first SGD window is not the one drawn ahead")
    with_odd = [r for r in sgd_rows if odd in r[0]]
    check(with_odd and all(
        m[v.index(odd)] == 0 and all(x > 0 for n, x in zip(v, m) if n != odd)
        and dw > 0 and d > 0 for v, dw, d, m in with_odd),
        f"the odd view's depth mask in its window: {with_odd[:1]}")
    for k in totals:
        totals[k] += sgd_total[k]
    print(f"{tag} train_sgd.main -d depths: {DEPTH_SGD[0]} windows of "
          f"{DEPTH_SGD[1]}, {len(sp.attempts)} attempts, C with depth_grad "
          f"each; the odd view in {len(with_odd)} window attempt(s), its "
          f"depth mask 0 there (the others' sums {with_odd[0][3]}), depth_l1 "
          f"{[round(d, 5) for _, _, d, _ in sgd_rows]}", flush=True)

    phase_s = time.perf_counter() - t_phase
    c_true, c_false = (statistics.median(c_ms[k]) for k in (True, False))
    print(f"{tag} scene-depth timings: 16-bit {DEPTH_MAP[1]}x{DEPTH_MAP[0]} "
          f"PNG write {statistics.median(png_w):.2f} ms, read "
          f"{statistics.median(png_r):.2f} ms; make_depth_scale "
          f"{mds_s:.3f} s; Scene load with depths "
          f"{statistics.median(load_s['with']):.3f} s vs without "
          f"{statistics.median(load_s['without']):.3f} s; the loop's Adam iteration {loop_ms:.3f} ms median of "
          f"{len(plain_its)} vs phase 10's {cli_adam_ms:.3f} ms on the same "
          f"scene; kernel C on iteration's inputs (CUDA events, in turns, "
          f"median of 2 x 5) depth_grad {c_true:.4f} ms, without "
          f"{c_false:.4f} ms; phase wall {phase_s:.1f} s", flush=True)
    for entry, key in zip(kernels, "ABCDE"):
        entry["launches_by_path"]["scene_depth"] = totals[key]
        entry["launches"] += totals[key]
    G_LAUNCHES["scene_depth"] = totals["G"]
    H_LAUNCHES["scene_depth"] = totals["H"]
    kernels[2]["max_abs_err_scene_depth"] = c_err
    kernels[2]["depth_grad_launches"] = loop_launches["C"] + sgd_total["C"]
    kernels[2]["ms_depth_grad"] = c_true
    kernels[2]["ms_no_depth_grad"] = c_false
    return out


def write_lpips_weights(path: str, seed: int = 0) -> str:
    """An LPIPS npz with the real file's shapes and seeded random weights:
    N(0, 0.05) convolutions, zero biases, |N(0, 1)| heads."""
    from gslm_tpu_torch.eval import lpips
    rng = np.random.default_rng(seed)
    payload, cin, taps, ci = {}, 3, [], 0
    for c in lpips.VGG16_CFG:
        if c == "M":
            continue
        payload[f"conv{ci}_W"] = rng.normal(0, 0.05, (3, 3, cin, c)).astype(
            np.float32)
        payload[f"conv{ci}_b"] = np.zeros(c, np.float32)
        if ci in lpips.TAP_AFTER_CONV:
            taps.append(c)
        cin, ci = c, ci + 1
    for j, c in enumerate(taps):
        payload[f"lin{j}_W"] = np.abs(rng.normal(0, 1, c)).astype(np.float32)
    np.savez(path, **payload)
    return path


def lpips_pairs(label: str, method_dir: str, dev) -> list:
    """LPIPS of every pair of ``method_dir`` on the card against the same
    pair on CPU tensors (within ``LPIPS_REL``), the card's call timed
    (CUDA events, median of 3) and its peak memory; printed. Returns
    [(name, card value, cpu value, ms, peak bytes)]."""
    import torch

    from gslm_tpu_torch.eval import lpips
    from gslm_tpu_torch.eval import metrics as M
    names, renders, gts = M.read_images(os.path.join(method_dir, "renders"),
                                        os.path.join(method_dir, "gt"))
    out = []
    for name, r, g in zip(names, renders, gts):
        r, g = torch.tensor(r)[None], torch.tensor(g)[None]
        rc, gc = r.to(dev), g.to(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        with torch.no_grad():
            card = float(lpips.lpips(rc, gc)[0])
            ms = cuda_ms(lambda: lpips.lpips(rc, gc), 3)
            peak = torch.cuda.max_memory_allocated(dev)
            cpu = float(lpips.lpips(r, g)[0])
        out.append((name, card, cpu, ms, peak))
        check(abs(card - cpu) <= LPIPS_REL * abs(cpu), f"LPIPS of {label} "
              f"{name}: card {card} vs CPU {cpu}")
    print(f"LPIPS card vs CPU ({label}, {renders[0].shape[2]}x"
          f"{renders[0].shape[1]}): "
          + "; ".join(f"{n} {c:.6f} vs {p:.6f} (rel {abs(c - p) / abs(p):.2g}"
                      f"), {ms:.2f} ms, peak {pk / 2**30:.2f} GiB"
                      for n, c, p, ms, pk in out), flush=True)
    return out


def lpips_parity_phase(dev, tag: str, kernels: list[dict], model: str,
                       root: str) -> None:
    """Phase 12: LPIPS on phase 11's model ``model`` (``render_sets``,
    ``metrics`` with a seeded random-weight file, each pair on the card
    against the CPU, an undegraded render of the test view scored by
    ``metrics.evaluate_dir`` against ``train.evaluate``), then the parity
    matrix at full size. Adds the metrics path's launches to ``kernels``
    and the matrix's readings beside them."""
    import torch

    from gslm_tpu_torch import renderer
    from gslm_tpu_torch import train as T
    from gslm_tpu_torch.eval import metrics as M
    from gslm_tpu_torch.eval import render_sets as R
    from gslm_tpu_torch.models.cameras import batch_from_metas
    from gslm_tpu_torch.models.scene import Scene
    from gslm_tpu_torch.renderer import overflow_probe
    from gslm_tpu_torch.utils.paritycheck import run_parity_matrix

    t_phase = time.perf_counter()
    plat = [] if dev.type == "cuda" else ["--platform", dev.type]
    weights = write_lpips_weights(os.path.join(root, "lpips_random.npz"))
    saved_env = os.environ.get("GSLM_LPIPS_WEIGHTS")
    os.environ["GSLM_LPIPS_WEIGHTS"] = weights
    try:
        zero_launches()
        with entry_point():
            R.main(["-m", model, "--iteration", "-1", "--skip_train", *plat])
        r_launch = launches()
        zero_launches()
        t0 = time.perf_counter()
        with entry_point() as tee:
            M.main(["-m", model, *plat])
        torch.cuda.synchronize()
        metrics_s = time.perf_counter() - t0
        m_launch = launches()
        with open(os.path.join(model, "results.json")) as f:
            (method, results), = json.load(f).items()
        check(results["LPIPS"] is not None and "not found" not in tee.text(),
              f"metrics reported LPIPS {results['LPIPS']}")
        n_pairs = len(os.listdir(os.path.join(model, "test", method,
                                              "renders")))
        check(m_launch == {"A": 0, "B": n_pairs, "C": 0, "D": 0, "E": 0,
                           "G": 0, "H": 0},
              f"metrics launches {m_launch}, expected B {n_pairs}")
        check(r_launch["A"] >= 1 and r_launch["B"] == r_launch["C"] == 0
              and r_launch["G"] == r_launch["A"]
              and r_launch["H"] == 4 * r_launch["A"],
              f"render_sets launches {r_launch}: expected G once and H 4 "
              f"times (a chunk's views) per A")
        pairs = lpips_pairs(f"render_sets' {method}",
                            os.path.join(model, "test", method), dev)

        # an undegraded render of the test view, written as render_sets
        # writes it, scored by evaluate_dir against train.evaluate
        with open(os.path.join(model, "cfg_args")) as f:
            src = json.load(f)["source_path"]
        scene = Scene(src, model, resolution=1, eval_split=True,
                      shuffle=False, load_iteration=-1, device=dev)
        test = batch_from_metas(scene.get_test_cameras(), device=dev)
        p = scene.params
        pr = overflow_probe(p, test, config=T.RasterConfig(cull=True),
                            active_sh_degree=p.sh_degree)
        cfg = caps_from_counts(int(pr["n_aabb"]), int(pr["n_live"]))
        full = T.evaluate(p, None, test, torch.zeros(3, device=dev), cfg,
                          p.sh_degree, False)["psnr"]
        with torch.no_grad():
            img = renderer.batch_render(p, test, torch.zeros(3, device=dev),
                                        config=cfg,
                                        active_sh_degree=p.sh_degree)
        check(int(img.overflow) == 0, "the probe-capacity render overflowed")
        und = os.path.join(root, "undegraded")
        for sub, imgs in (("renders", img.render), ("gt", test.gt_image)):
            os.makedirs(os.path.join(und, sub))
            for i, x in enumerate(imgs.cpu().numpy()):
                R.save_png(os.path.join(und, sub, f"{i:05d}.png"), x)
        summary, _ = M.evaluate_dir(und, True, device=dev)
        check(summary["LPIPS"] is not None
              and abs(summary["PSNR"] - full) <= CLI_PSNR_ROUNDING,
              f"evaluate_dir of the undegraded render {summary} vs "
              f"evaluate's PSNR {full}")
        und_pairs = lpips_pairs("the undegraded test view", und, dev)
        del scene, test, p, img
    finally:
        if saved_env is None:
            os.environ.pop("GSLM_LPIPS_WEIGHTS", None)
        else:
            os.environ["GSLM_LPIPS_WEIGHTS"] = saved_env
    print(f"{tag} metrics with LPIPS: {n_pairs} pair(s) in {metrics_s:.2f} s; "
          f"results.json {results}; the undegraded test view: evaluate_dir "
          f"PSNR {summary['PSNR']:.4f} vs evaluate {full:.4f}, SSIM "
          f"{summary['SSIM']:.4f}, LPIPS {summary['LPIPS']:.6f}; LPIPS per "
          f"1080p pair {statistics.median(x[3] for x in pairs + und_pairs):.2f}"
          f" ms, peak {max(x[4] for x in pairs + und_pairs) / 2**30:.2f} GiB",
          flush=True)
    for entry, key in zip(kernels, "ABCDE"):
        n = r_launch[key] + m_launch[key]
        entry["launches_by_path"]["lpips_metrics"] = n
        entry["launches"] += n
    G_LAUNCHES["lpips_metrics"] = r_launch["G"]
    H_LAUNCHES["lpips_metrics"] = r_launch["H"]

    # ---- the parity matrix at full size ------------------------------------
    zero_launches()
    t0 = time.perf_counter()
    res = run_parity_matrix()
    matrix_s = time.perf_counter() - t0
    matrix_launches = launches()
    for name, v in res["variants"].items():
        print(f"parity {name:18s} {'PASS' if v['ok'] else 'FAIL'}  "
              f"max_err={v['max_err']:.3e}"
              + (f"  per group {v['per_group']}" if "per_group" in v else ""),
              flush=True)
    print(f"{tag} parity matrix (2,048 Gaussians, 160x192; kernels on the "
          f"card vs plain versions on the CPU): ok {res['ok']} in "
          f"{matrix_s:.1f} s, kernel launches {matrix_launches} (comparison "
          f"launches, not counted on any path); phase wall "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    check(res["ok"], "a parity matrix variant failed: "
          + str({k: v for k, v in res["variants"].items() if not v["ok"]}))
    v = res["variants"]
    for entry, key, names in zip(kernels, "ABCDE", (
            ("fwd_image", "fwd_bucket2", "fwd_bucket4"), (),
            ("grads_scatter", "grads_nocull", "grads_batch2"),
            ("grads_bucket2", "grads_bucket4"),
            ("jvp_image", "jvp_lm_operator"))):
        if names:
            entry["parity_matrix_max_err"] = max(v[n]["max_err"]
                                                 for n in names)
        entry["parity_matrix_launches"] = matrix_launches[key]

# ---- phase 13: data-parallel training over ranks ---------------------------

DP_WORLD = 2            # part (b): gloo ranks sharing the one card
DP_STEPS = 5            # timed data-parallel Adam steps per rank
DP_ITERS = 50           # train.main --mesh_data 2: Adam iterations
DP_DENSIFY = (20, 25)   # its --densify_from_iter, --densification_interval
DP_TIMEOUT = 600.0      # join timeout of part (b)'s ranks (s)
DP_LM_RTOL = 1e-4       # LM step across rank counts (tests' tolerance)


def clone_state(params, aux, opt_state):
    """Independent copies of a training state."""
    from gslm_tpu_torch.models.gaussians import (PARAM_GROUPS, GaussianAux,
                                                 GaussianParams)
    from gslm_tpu_torch.optim import AdamState
    p = GaussianParams(**{g: getattr(params, g).detach().clone()
                          for g in PARAM_GROUPS},
                       sh_degree=params.sh_degree, alive=params.alive.clone())
    a = GaussianAux(*(getattr(aux, f).clone() for f in (
        "max_radii2d", "xyz_gradient_accum", "denom")))
    o = AdamState(mu={g: t.clone() for g, t in opt_state.mu.items()},
                  nu={g: t.clone() for g, t in opt_state.nu.items()},
                  step=opt_state.step)
    return p, a, o


def state_tensors(params, aux=None, opt_state=None) -> dict:
    """Every tensor of a training state by name (no copies)."""
    from gslm_tpu_torch.models.gaussians import PARAM_GROUPS
    out = {g: getattr(params, g).detach() for g in PARAM_GROUPS}
    out["alive"] = params.alive
    if aux is not None:
        out.update(max_radii2d=aux.max_radii2d, denom=aux.denom,
                   xyz_gradient_accum=aux.xyz_gradient_accum)
    if opt_state is not None:
        out.update({f"mu/{g}": t for g, t in opt_state.mu.items()})
        out.update({f"nu/{g}": t for g, t in opt_state.nu.items()})
    return out


def info_tensors(info: dict) -> dict:
    out = {k: v for k, v in info.items() if k != "step_norms"}
    out.update({f"norm/{g}": v for g, v in info["step_norms"].items()})
    return out


def bitwise_diff(a: dict, b: dict) -> list:
    """The names whose tensors are not bit for bit equal."""
    import torch
    return [k for k in a if not torch.equal(a[k], b[k])]


def ranks_bitwise_equal(mesh, tensors: dict) -> bool:
    """Whether every rank holds rank 0's ``tensors`` bit for bit (rank 0's
    broadcast, compared on each rank, then the ranks' flags' min)."""
    import torch

    from gslm_tpu_torch.parallel.mesh import all_reduce, broadcast_
    mine = [t.detach().reshape(-1).view(torch.uint8) if t.dtype != torch.bool
            else t.to(torch.uint8) for t in tensors.values()]
    theirs = [t.clone() for t in mine]
    broadcast_(theirs, mesh.group)
    differs = torch.tensor([int(not all(
        torch.equal(a, b) for a, b in zip(mine, theirs)))],
        device=mine[0].device)
    return not bool(all_reduce([differs], "max", mesh.group)[0])


def adam_held(got: dict, want: dict, got_m: dict, want_m: dict) -> dict:
    """A data-parallel Adam step against the single process's, to the
    tests' tolerances: the loss within 1e-6; each parameter group within
    1e-5 where the single step's |gradient| exceeds 1e-3 of its group's
    largest (Adam's first step moves the others by ±lr whatever their
    gradient's size); xyz_gradient_accum within 1e-5 of its largest;
    alive, denom and max_radii2d equal. Returns the errors."""
    from gslm_tpu_torch.models.gaussians import PARAM_GROUPS
    err = {"loss": abs(float(got_m["loss"]) - float(want_m["loss"]))}
    for g in PARAM_GROUPS:
        mu = want[f"mu/{g}"].abs()
        sure = mu > 1e-3 * float(mu.max())
        d = (got[g] - want[g]).abs()
        err[g] = float(d[sure].max()) if bool(sure.any()) else 0.0
    ref = want["xyz_gradient_accum"]
    err["xyz_gradient_accum_rel"] = float(
        (got["xyz_gradient_accum"] - ref).abs().max()) / max(
        float(ref.abs().max()), 1e-30)
    check(err["loss"] <= 1e-6, f"data-parallel loss: {err}")
    check(all(err[g] <= 1e-5 for g in PARAM_GROUPS),
          f"data-parallel parameters: {err}")
    check(err["xyz_gradient_accum_rel"] <= 1e-5,
          f"data-parallel xyz_gradient_accum: {err}")
    check(not bitwise_diff({k: got[k] for k in ("alive", "max_radii2d",
                                                "denom")}, want),
          "data-parallel alive, max_radii2d or denom")
    return {k: float(f"{v:.3g}") for k, v in err.items()}


def lm_held(got: dict, want: dict, got_i: dict, want_i: dict) -> dict:
    """A data-parallel LM step against the single process's: best_alpha
    equal, best_val_loss within rtol 1e-4, xyz bit for bit (masked), each
    other group within rtol 1e-4 (atol 1e-4 of its largest)."""
    from gslm_tpu_torch.models.gaussians import PARAM_GROUPS
    err = {"best_val_loss_rel": abs(float(got_i["best_val_loss"])
                                    - float(want_i["best_val_loss"]))
           / abs(float(want_i["best_val_loss"]))}
    check(float(got_i["best_alpha"]) == float(want_i["best_alpha"]),
          "data-parallel LM step: another best alpha")
    check(err["best_val_loss_rel"] <= DP_LM_RTOL, f"LM val loss: {err}")
    check(not bitwise_diff({"xyz": got["xyz"]}, want), "LM xyz moved")
    for g in PARAM_GROUPS:
        scale = max(float(want[g].abs().max()), 1e-30)
        excess = ((got[g] - want[g]).abs()
                  - DP_LM_RTOL * (want[g].abs() + scale))
        err[g] = float((got[g] - want[g]).abs().max()) / scale
        check(float(excess.max()) <= 0, f"LM group {g}: {err}")
    return {k: float(f"{v:.3g}") for k, v in err.items()}


def dp_one_rank(dev, n_gauss: int, height: int, width: int, tag: str,
                lm_ref: dict) -> None:
    """Phase 13 (a): a one-rank NCCL group in this process. The
    data-parallel Adam step on one view and LM step on cell lm-1080p-w5's
    window equal ``train_step`` and ``lm_outer_step`` (phase 7's,
    ``lm_ref``) bit for bit."""
    import torch
    import torch.distributed as dist

    from gslm_tpu_torch.config import LMParams, OptimizationParams
    from gslm_tpu_torch.models.gaussians import GaussianAux
    from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
    from gslm_tpu_torch.optim import init_adam
    from gslm_tpu_torch.parallel import (make_dp_lm_step, make_dp_train_step,
                                         make_mesh)
    from gslm_tpu_torch.train import train_step

    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method="tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_mesh()
        check(mesh.shape == {"data": 1, "model": 1}
              and dist.get_backend(mesh.group) == backend,
              f"one-rank {backend} mesh {mesh}")
        params, all_train, win, vidx = lm_scene(dev, n_gauss, height, width)
        bg = torch.zeros(3, device=dev)
        cam = all_train.take(slice(0, 1))
        kw = dict(rcfg=RasterConfig(**TRAIN_CAPS), opt=OptimizationParams(),
                  active_sh_degree=3, use_exp=False, sparse_adam=False,
                  update_stats=True)
        start = (params, GaussianAux.zeros(n_gauss, dev), init_adam(params))
        runs = []
        for step in (lambda *a: train_step(*a, **kw),
                     lambda *a: train_step(*a, **kw),
                     make_dp_train_step(mesh, **kw)):
            p, a, o = clone_state(*start)
            _, _, _, m = step(p, a, o, cam, bg, 1, 1.0, 0.0)
            runs.append((state_tensors(p, a, o), m))
        repeat = bitwise_diff(runs[1][0], runs[0][0])
        adam_diff = bitwise_diff(runs[2][0], runs[0][0]) + bitwise_diff(
            runs[2][1], runs[0][1])
        print(f"{tag} 13a one-rank NCCL group: train_step twice bitwise "
              f"{'equal' if not repeat else 'differs in ' + str(repeat)}; "
              f"make_dp_train_step vs train_step on one view: "
              f"{'bit for bit equal' if not adam_diff else adam_diff}",
              flush=True)
        check(not adam_diff, f"one-rank data-parallel Adam step: {adam_diff}")
        del runs
        lkw = dict(rcfg=RasterConfig(**LM_CAPS), lm=LMParams(),
                   active_sh_degree=3, use_exp=False)
        t0 = time.perf_counter()
        got, got_i = make_dp_lm_step(mesh, **lkw)(
            params, params.alive, all_train.take(win), all_train.take(vidx),
            bg)
        sync_device(dev)
        dp_s = time.perf_counter() - t0
        lm_diff = bitwise_diff(state_tensors(got), lm_ref["state"]) + \
            bitwise_diff(info_tensors(got_i), lm_ref["info"])
        print(f"{tag} 13a make_dp_lm_step vs phase 7's lm_outer_step (window "
              f"{win}, {len(vidx)} val views): "
              f"{'bit for bit equal' if not lm_diff else lm_diff}; "
              f"{dp_s:.2f} s vs {lm_ref['ms'] / 1e3:.2f} s (phase 7's "
              f"median)", flush=True)
        check(not lm_diff, f"one-rank data-parallel LM step: {lm_diff}")
    finally:
        dist.destroy_process_group()


def sync_device(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dp_rank(rank: int, world: int, port: int, out_dir: str, dev_type: str,
            src: str, root: str, n_gauss: int, height: int,
            width: int) -> None:
    """Phase 13 (b)'s rank ``rank`` of ``world``, spawned: a gloo group on
    127.0.0.1:``port``, every rank on cuda:0 (or the CPU, to rehearse);
    reads phase 7's LM step from ``out_dir``/lm_ref.pt, writes its results
    to ``out_dir``/rank<r>.json (its traceback to rank<r>.err)."""
    import traceback

    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", 0) if dev_type == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        res = dp_rank_body(rank, world, dev, src, root, n_gauss, height,
                           width, os.path.join(out_dir, "lm_ref.pt"))
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def gloo_cuda_collectives(dev, rank: int, world: int) -> dict:
    """Which collectives the port calls on CUDA tensors gloo takes: each
    on float32, int32 and uint8 tensors, the result checked. Returns
    {collective dtype: True or the error}."""
    import torch
    import torch.distributed as dist
    took = {}
    calls = {"all_reduce_sum": (dist.ReduceOp.SUM, sum(range(1, world + 1))),
             "all_reduce_max": (dist.ReduceOp.MAX, world), "broadcast": 1}
    for name, spec in calls.items():
        for dtype in (torch.float32, torch.int32, torch.uint8):
            t = torch.full((1 << 10,), rank + 1, dtype=dtype, device=dev)
            try:
                if name == "broadcast":
                    dist.broadcast(t, 0)
                    want = spec
                else:
                    dist.all_reduce(t, op=spec[0])
                    want = spec[1]
                took[f"{name} {str(dtype)[6:]}"] = (
                    t.device == dev and bool((t == want).all()))
            except RuntimeError as e:
                took[f"{name} {str(dtype)[6:]}"] = str(e).splitlines()[0]
    return took


def dp_rank_body(rank: int, world: int, dev, src: str, root: str,
                 n_gauss: int, height: int, width: int, lm_ref: str) -> dict:
    """Phase 13 (b) on one rank: its checks, times and launch counts as a
    dict that ``json`` writes."""
    import torch

    from gslm_tpu_torch import train as T
    from gslm_tpu_torch import train_lm as TL
    from gslm_tpu_torch.config import LMParams, OptimizationParams
    from gslm_tpu_torch.models.gaussians import PARAM_GROUPS, GaussianAux
    from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
    from gslm_tpu_torch.optim import init_adam
    from gslm_tpu_torch.parallel import (make_dp_lm_step, make_dp_train_step,
                                         make_mesh)
    from gslm_tpu_torch.parallel.mesh import all_reduce, barrier

    mesh = make_mesh(world, 1)
    out = {"rank": rank, "mesh": mesh.shape}
    out["gloo_cuda"] = gloo_cuda_collectives(dev, rank, world)
    check(all(v is True for v in out["gloo_cuda"].values()),
          f"gloo on CUDA tensors: {out['gloo_cuda']}")

    def sync():
        sync_device(dev)
        barrier(mesh)

    def wall_ms(fn):
        sync_device(dev)
        t0 = time.perf_counter()
        res = fn()
        sync_device(dev)
        return res, (time.perf_counter() - t0) * 1e3

    # ---- the headline scene and its 2-view Adam batch ---------------------
    params, all_train, win, vidx = lm_scene(dev, n_gauss, height, width)
    bg = torch.zeros(3, device=dev)
    cam2 = all_train.take(slice(0, world))
    kw = dict(rcfg=RasterConfig(**CAPS), opt=OptimizationParams(),
              active_sh_degree=3, use_exp=False, sparse_adam=False,
              update_stats=True)
    start = (params, GaussianAux.zeros(n_gauss, dev), init_adam(params))
    totals = {k: 0 for k in "ABCDEGH"}

    def count(before):
        after = launches()
        for k in totals:
            totals[k] += after[k] - before[k]
        return _delta(before, after)

    # ---- Adam: the single process on the 2 views (rank 0, the others wait)
    sync()
    if rank == 0:
        p, a, o = clone_state(*start)
        _, _, _, want_m = T.train_step(p, a, o, cam2, bg, 1, 1.0, 0.0, **kw)
        want = {k: v.clone() for k, v in state_tensors(p, a, o).items()}
        single = [wall_ms(lambda: T.train_step(p, a, o, cam2, bg, 2, 1.0,
                                               0.0, **kw))[1]
                  for _ in range(DP_STEPS)]
        out["single_adam_ms"] = single
        del p, a, o
    sync()
    # ---- Adam: one view per rank -----------------------------------------
    step = make_dp_train_step(mesh, **kw)
    p, a, o = clone_state(*start)
    before = launches()
    _, _, _, got_m = step(p, a, o, cam2, bg, 1, 1.0, 0.0)
    sync_device(dev)
    out["adam_launches"] = count(before)
    got = state_tensors(p, a, o)
    out["adam_ranks_equal"] = ranks_bitwise_equal(mesh, got)
    if rank == 0:
        out["adam_err"] = adam_held(got, want, got_m, want_m)
        del want
    before = launches()
    out["dp_adam_ms"] = [wall_ms(lambda: step(p, a, o, cam2, bg, 2, 1.0,
                                              0.0))[1]
                         for _ in range(DP_STEPS)]
    if dev.type == "cuda":
        n_k, busy, wall = device_busy(lambda: step(p, a, o, cam2, bg, 3,
                                                   1.0, 0.0))
    else:
        n_k, busy, wall = 0, 0.0, wall_ms(lambda: step(p, a, o, cam2, bg,
                                                       3, 1.0, 0.0))[1]
    count(before)
    out["dp_adam_busy"] = [n_k, busy, wall]
    # the gradient all-reduce (reduce_summary's float sums) at this scene's
    # capacity and at the command lines' (2 n_gauss)
    out["allreduce"] = []
    for cap in (n_gauss, 2 * n_gauss):
        bufs = [torch.randn((cap,) + getattr(params, g).shape[1:],
                            device=dev) for g in PARAM_GROUPS
                if g != "exposure"] + [params.exposure.detach().clone(),
                                       torch.randn(cap, 2, device=dev)] + [
            torch.zeros((), device=dev) for _ in range(4)]
        sync()
        out["allreduce"].append(
            (sum(4 * t.numel() for t in bufs),
             [wall_ms(lambda: all_reduce(bufs, "sum", mesh.group))[1]
              for _ in range(DP_STEPS)]))
    del p, a, o, bufs

    # ---- LM: the ranks' step against phase 7's single process ------------
    lkw = dict(rcfg=RasterConfig(**LM_CAPS), lm=LMParams(),
               active_sh_degree=3, use_exp=False)
    sync()
    # lm_phase's padding: the window to 6 (a zero-weight copy of its first
    # view), 3 views per rank; the 50 val views 25 per rank, chunks of 5
    pad = win + [win[0]] * ((-len(win)) % world)
    w = torch.tensor([1.0] * len(win) + [0.0] * (len(pad) - len(win)),
                     device=dev)
    before = launches()
    (got, got_i), ms = wall_ms(lambda: make_dp_lm_step(mesh, **lkw)(
        params, params.alive, all_train.take(pad), all_train.take(vidx), bg,
        w, torch.ones(len(vidx), device=dev)))
    out["lm_launches"] = count(before)
    out["dp_lm_ms"] = ms
    out["lm_ranks_equal"] = ranks_bitwise_equal(
        mesh, state_tensors(got) | info_tensors(got_i))
    if rank == 0:
        want = torch.load(lm_ref, map_location=dev)
        out["lm_err"] = lm_held(state_tensors(got), want["state"],
                                info_tensors(got_i), want["info"])
        out["lm_best"] = [float(got_i["best_val_loss"]),
                          float(want["info"]["best_val_loss"])]
    del got, got_i, params, all_train, start

    # ---- the command lines over the ranks ----------------------------------
    model = os.path.join(root, "dp")
    ck = os.path.join(model, f"chkpnt{DP_ITERS}.npz")
    common = ["-s", src, "-m", model, "-r", "1", "--eval", "--capacity",
              str(2 * n_gauss), "--mesh_data", str(world),
              "--disable_viewer"] + (["--platform", "cpu"]
                                     if dev.type == "cpu" else [])
    argv = common + ["--iterations", str(DP_ITERS),
                     "--densify_from_iter", str(DP_DENSIFY[0]),
                     "--densification_interval", str(DP_DENSIFY[1]),
                     "--test_iterations", str(DP_ITERS),
                     "--save_iterations", str(DP_ITERS),
                     "--checkpoint_iterations", str(DP_ITERS)]
    sync()
    before = launches()
    t0 = time.perf_counter()
    with entry_point():
        _, p, a, o = T.main(argv)
    out["train_s"] = time.perf_counter() - t0
    out["train_launches"] = count(before)
    out["train_ranks_equal"] = ranks_bitwise_equal(mesh,
                                                   state_tensors(p, a, o))
    out["train_alive"] = int(p.alive.sum())
    out["train_step"] = o.step
    del p, a, o
    # the most make_raster_config takes (16 records per slot): 50
    # iterations leave ~4.9 M records per view, so the 5-view val chunks
    # need three doublings of it, inside lm_phase's four tries
    lm_argv = common + ["--start_checkpoint", ck, "--iterations",
                        str(DP_ITERS + 1), "--jvp_start", str(DP_ITERS + 1),
                        "--dup_capacity", str(16 * 2 * n_gauss)]
    sync()
    before = launches()
    t0 = time.perf_counter()
    with entry_point() as tee:
        _, p, a, o = TL.main(lm_argv)
    out["lm_cli_s"] = time.perf_counter() - t0
    out["lm_cli_launches"] = count(before)
    out["lm_cli_ranks_equal"] = ranks_bitwise_equal(mesh, state_tensors(p))
    out["lm_cli_lines"] = [ln for ln in tee.text().splitlines()
                           if "LM window" in ln or "growing" in ln
                           or "re-running" in ln or "WARNING" in ln]
    out["files"] = sorted(os.listdir(model)) if rank == 0 else []
    out["totals"] = totals
    return out


def dp_phase(dev, n_gauss: int, height: int, width: int, tag: str,
             kernels: list[dict], src: str, root: str, lm_ref: dict) -> None:
    """Phase 13 (cell train-dp2-131k-1080p): (a) a one-rank NCCL group in
    this process, (b) ``DP_WORLD`` spawned gloo ranks sharing the card,
    phase 9's scene ``src`` for their command lines; both hold their LM
    step to phase 7's (``lm_ref``). Adds each rank's launches to the
    kernel entries in ``kernels``."""
    import torch
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    t_phase = time.perf_counter()
    dp_one_rank(dev, n_gauss, height, width, tag, lm_ref)
    torch.cuda.empty_cache()
    out_dir = os.path.join(root, "dp_ranks")
    os.makedirs(out_dir)
    torch.save({part: {k: v.cpu() for k, v in lm_ref[part].items()}
                for part in ("state", "info")},
               os.path.join(out_dir, "lm_ref.pt"))
    ctx = mp.start_processes(
        dp_rank, args=(DP_WORLD, free_port(), out_dir, dev.type, src, root,
                       n_gauss, height, width),
        nprocs=DP_WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + DP_TIMEOUT
    try:
        while not ctx.join(timeout=1.0):
            check(time.monotonic() < deadline,
                  f"phase 13 ranks still running after {DP_TIMEOUT} s")
    except ProcessException as e:
        errs = [pathlib.Path(out_dir, f).read_text()
                for f in sorted(os.listdir(out_dir)) if f.endswith(".err")]
        raise RuntimeError("a phase 13 rank failed:\n"
                           + "\n".join(errs)) from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    ranks = []
    for r in range(DP_WORLD):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    print(f"{tag} 13b gloo on CUDA tensors: {r0['gloo_cuda']}", flush=True)
    for key in ("adam_ranks_equal", "lm_ranks_equal", "train_ranks_equal",
                "lm_cli_ranks_equal"):
        check(all(r[key] for r in ranks), f"phase 13 ranks differ: {key}")
    print(f"{tag} 13b ranks bit for bit equal after the Adam step, the LM "
          f"step, train.main and train_lm.main: True", flush=True)
    print(f"{tag} 13b data-parallel Adam step (1 view per rank) vs "
          f"train_step on the same {DP_WORLD} views: {r0['adam_err']}",
          flush=True)
    print(f"{tag} 13b data-parallel LM step (window padded to "
          f"{DP_WORLD * -(-5 // DP_WORLD)}, {5 // DP_WORLD + 1} views and 25 "
          f"val views per rank) vs lm_outer_step: best val loss "
          f"{r0['lm_best'][0]:.6f} vs {r0['lm_best'][1]:.6f}; "
          f"{r0['lm_err']}", flush=True)
    for r in ranks:
        med = statistics.median(r["dp_adam_ms"])
        n_k, busy, wall = r["dp_adam_busy"]
        reduce = ", ".join(f"{statistics.median(ms):.3f} ms for {b} bytes"
                           for b, ms in r["allreduce"])
        print(f"{tag} 13b rank {r['rank']}: Adam step median {med:.3f} ms "
              f"(runs {[round(x, 3) for x in r['dp_adam_ms']]}); LM step "
              f"{r['dp_lm_ms']:.1f} ms; gradient all-reduce {reduce} "
              f"(median of {DP_STEPS}); one profiled Adam step: {n_k} CUDA "
              f"kernels, device busy {busy:.3f} ms of {wall:.3f} ms wall "
              f"({busy / wall:.3f})", flush=True)
        print(f"{tag} 13b rank {r['rank']} launches: Adam step "
              f"{r['adam_launches']}, LM step {r['lm_launches']}, "
              f"train.main {r['train_launches']}, train_lm.main "
              f"{r['lm_cli_launches']}; phase total {r['totals']}",
              flush=True)
    single = r0["single_adam_ms"]
    print(f"{tag} 13b single process on the same card: train_step on "
          f"{DP_WORLD} views median {statistics.median(single):.3f} ms (runs "
          f"{[round(x, 3) for x in single]}); "
          f"lm_outer_step {lm_ref['ms']:.1f} ms (phase 7's median)",
          flush=True)
    print(f"{tag} 13b train.main --mesh_data {DP_WORLD}: {DP_ITERS} "
          f"iterations in {r0['train_s']:.1f} s, {r0['train_alive']} alive, "
          f"step {r0['train_step']}; train_lm.main --mesh_data {DP_WORLD}: "
          f"1 LM iteration in {r0['lm_cli_s']:.1f} s, lines "
          f"{r0['lm_cli_lines']}; rank 0 wrote {r0['files']}", flush=True)
    check(r0["train_step"] == DP_ITERS, "train.main's Adam step count")
    check(f"chkpnt{DP_ITERS}.npz" in r0["files"] and "cfg_args" in r0["files"],
          "train.main --mesh_data: rank 0's files")
    check(any("LM window [" in ln for ln in r0["lm_cli_lines"]),
          "train_lm.main --mesh_data: no LM step")
    check(not any("WARNING" in ln for ln in r0["lm_cli_lines"]),
          "train_lm.main --mesh_data: a degraded LM step")
    for r in ranks:
        for k in "ABCE":
            check(r["totals"][k] > 0, f"rank {r['rank']} never launched "
                                      f"kernel {k} on the data-parallel path")
        adam, lm = r["adam_launches"], r["lm_launches"]
        # H: the LM step's no-grad validation renders, 5 views a chunk
        check(adam["A"] == 1 and adam["C"] == 1 and adam["G"] == 1
              and adam["H"] == 0 and lm["E"] > 0
              and lm["G"] == lm["A"] + lm["E"] and lm["H"] == 5 * (lm["A"] - 1),
              f"rank {r['rank']} data-parallel launches: Adam {adam}, LM "
              f"{lm}")
    for entry, k in zip(kernels, "ABCDE"):
        for r in ranks:
            n = r["totals"][k]
            entry["launches_by_path"][f"data_parallel_rank{r['rank']}"] = n
            entry["launches"] += n
    for r in ranks:
        G_LAUNCHES[f"data_parallel_rank{r['rank']}"] = r["totals"]["G"]
        H_LAUNCHES[f"data_parallel_rank{r['rank']}"] = r["totals"]["H"]
    print(f"{tag} phase 13 wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)



# ---- phase 14: the model axis over ranks -----------------------------------

MP_WORLD = 2            # gloo ranks sharing the one card: a (1, 2) mesh
MP_STEPS = 3            # timed model-parallel Adam steps per rank
MP_ITERS = 50           # train.main --mesh_model 2: Adam iterations
MP_DENSIFY = (20, 25)   # its --densify_from_iter, --densification_interval
MP_VAL_VIEWS = 5        # train_lm.main --mesh_model 2: --num_val_views
MP_TIMEOUT = 900.0      # join timeout of the ranks (s)
# per rank: the Adam step (band render, SSIM blur forward and VJP, band
# backward); the LM step (1 linearization + 7 one-pass val renders, Jᵀ·u
# and J·v as in lm_outer_step); G once per band render and J·v; H once per
# view of the no-grad val renders, on the rank's own rows (7 x 50 views)
MP_ADAM_LAUNCHES = {"A": 1, "B": 2, "C": 1, "D": 0, "E": 0, "G": 1, "H": 0}
MP_LM_LAUNCHES = {"A": 8, "B": 0, "C": 4, "D": 0, "E": 6, "G": 14, "H": 350}


def mp_collectives(dev, mesh) -> dict:
    """Which of the model axis's collectives gloo takes on ``dev``'s
    tensors (all_gather, all_to_all_single, all_reduce SUM and MAX,
    broadcast, gather; float32, int32, uint8; the reduce-scatter of the
    all_gather's backward on float32), each result checked, over the model
    group. Returns {collective dtype: True or the error}."""
    import torch
    import torch.distributed as dist
    g, n, r = mesh.model_group, mesh.n_model, mesh.model_rank
    took = {}
    for dtype in (torch.float32, torch.int32, torch.uint8):
        name = str(dtype)[6:]

        def full(v, size=1 << 10):
            return torch.full((size,), v, dtype=dtype, device=dev)

        def ag():
            parts = [full(0) for _ in range(n)]
            dist.all_gather(parts, full(r + 1), group=g)
            return all(bool((p == i + 1).all()) for i, p in enumerate(parts))

        def a2a():
            out = full(0, n * 16)
            dist.all_to_all_single(out, full(r + 1, n * 16), group=g)
            return bool((out.reshape(n, 16) == torch.arange(
                1, n + 1, device=dev).to(dtype)[:, None]).all())

        def ar(op, want):
            t = full(r + 1)
            dist.all_reduce(t, op=op, group=g)
            return bool((t == want).all())

        def bc():
            t = full(r + 1)
            dist.broadcast(t, dist.get_global_rank(g, 0), group=g)
            return bool((t == 1).all())

        def ga():
            parts = [full(0) for _ in range(n)] if r == 0 else None
            dist.gather(full(r + 1), parts, dst=dist.get_global_rank(g, 0),
                        group=g)
            return r != 0 or all(bool((p == i + 1).all())
                                 for i, p in enumerate(parts))

        def rs():
            from gslm_tpu_torch.parallel.comm import _REDUCE_SCATTER
            out = full(0)
            _REDUCE_SCATTER(out, torch.arange(
                n, device=dev).to(dtype).repeat_interleave(1 << 10) + r,
                group=g)
            return bool((out == r * n + n * (n - 1) // 2).all())

        probes = [("all_gather", ag), ("all_to_all_single", a2a),
                  ("all_reduce_sum", lambda: ar(dist.ReduceOp.SUM,
                                                n * (n + 1) // 2)),
                  ("all_reduce_max", lambda: ar(dist.ReduceOp.MAX, n)),
                  ("broadcast", bc), ("gather", ga)]
        if dtype == torch.float32:
            probes.append(("reduce_scatter", rs))
        for label, fn in probes:
            try:
                took[f"{label} {name}"] = fn()
            except RuntimeError as e:
                took[f"{label} {name}"] = str(e).splitlines()[0]
    return took


def mp_rank(rank: int, world: int, port: int, out_dir: str, dev_type: str,
            src: str, root: str, n_gauss: int, m1_n: int, height: int,
            width: int, tag: str) -> None:
    """Phase 14's rank ``rank`` of ``world``, spawned: a gloo group on
    127.0.0.1:``port``, every rank on cuda:0 (or the CPU, to rehearse);
    reads phase 7's LM step from ``out_dir``/lm_ref.pt, writes its results
    to ``out_dir``/rank<r>.json (its traceback to rank<r>.err)."""
    import traceback

    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", 0) if dev_type == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        res = mp_rank_body(rank, world, dev, src, root, n_gauss, m1_n,
                           height, width,
                           os.path.join(out_dir, "lm_ref.pt"), tag)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def mp_adam_held(got: dict, want: dict, rows: slice, got_m: dict,
                 want_m: dict) -> dict:
    """A model-parallel Adam step's shard against the single process's
    rows ``rows`` (``adam_held``'s tolerances: the loss within 1e-6; each
    group within 1e-5 where the single step's |first moment| exceeds 1e-3
    of its group's largest; xyz_gradient_accum within 1e-5 of its largest;
    alive, denom and max_radii2d equal). Returns the errors."""
    from gslm_tpu_torch.models.gaussians import PARAM_GROUPS
    err = {"loss": abs(float(got_m["loss"]) - float(want_m["loss"]))}
    for g in PARAM_GROUPS:
        sel = slice(None) if g == "exposure" else rows
        mu = want[f"mu/{g}"].abs()
        sure = (mu > 1e-3 * float(mu.max()))[sel]
        d = (got[g] - want[g][sel]).abs()
        err[g] = float(d[sure].max()) if bool(sure.any()) else 0.0
    ref = want["xyz_gradient_accum"]
    err["xyz_gradient_accum_rel"] = float(
        (got["xyz_gradient_accum"] - ref[rows]).abs().max()) / max(
        float(ref.abs().max()), 1e-30)
    check(err["loss"] <= 1e-6, f"model-parallel loss: {err}")
    check(all(err[g] <= 1e-5 for g in PARAM_GROUPS),
          f"model-parallel parameters: {err}")
    check(err["xyz_gradient_accum_rel"] <= 1e-5,
          f"model-parallel xyz_gradient_accum: {err}")
    check(not [k for k in ("alive", "max_radii2d", "denom")
               if not bool((got[k] == want[k][rows]).all())],
          "model-parallel alive, max_radii2d or denom")
    return {k: float(f"{v:.3g}") for k, v in err.items()}


def mp_lm_held(got: dict, want: dict, rows: slice, got_i: dict,
               want_i: dict) -> dict:
    """A model-parallel LM step's shard against the single process's rows
    ``rows``: best_alpha equal, best_val_loss within rtol 1e-4, every group
    within rtol 1e-4 (atol 1e-4 of its largest). Returns the errors."""
    from gslm_tpu_torch.models.gaussians import PARAM_GROUPS
    err = {"best_val_loss_rel": abs(float(got_i["best_val_loss"])
                                    - float(want_i["best_val_loss"]))
           / abs(float(want_i["best_val_loss"]))}
    check(float(got_i["best_alpha"]) == float(want_i["best_alpha"]),
          "model-parallel LM step: another best alpha")
    check(err["best_val_loss_rel"] <= DP_LM_RTOL, f"mp LM val loss: {err}")
    for g in PARAM_GROUPS:
        ref = want[g] if g == "exposure" else want[g][rows]
        scale = max(float(want[g].abs().max()), 1e-30)
        excess = (got[g] - ref).abs() - DP_LM_RTOL * (ref.abs() + scale)
        err[g] = float((got[g] - ref).abs().max()) / scale
        check(float(excess.max()) <= 0, f"mp LM group {g}: {err}")
    return {k: float(f"{v:.3g}") for k, v in err.items()}


def mp_rank_body(rank: int, world: int, dev, src: str, root: str,
                 n_gauss: int, m1_n: int, height: int, width: int,
                 lm_ref: str, tag: str) -> dict:
    """Phase 14 on one rank: its checks, times and launch counts as a dict
    that ``json`` writes. On the card it also times kernels A, B and C on
    the Adam step's band inputs and E on the LM step's, and prints their
    work and bounds (``a_report``, ``c_report``, ``e_report``)."""
    import torch

    from gslm_tpu_torch.ops import rasterize_cuda as rc
    from gslm_tpu_torch.ops.blur_cuda import blur_same

    from gslm_tpu_torch import train as T
    from gslm_tpu_torch import train_lm as TL
    from gslm_tpu_torch.checkpoint import (load_checkpoint,
                                           load_checkpoint_sharded,
                                           save_checkpoint_sharded)
    from gslm_tpu_torch.config import LMParams, OptimizationParams
    from gslm_tpu_torch.models.gaussians import GaussianAux
    from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
    from gslm_tpu_torch.optim import init_adam
    from gslm_tpu_torch.parallel import (make_mesh, make_mp_lm_step,
                                         make_mp_train_step, shard_state)
    from gslm_tpu_torch.parallel.comm import (_reduce_scatter, all_gather,
                                              all_to_all)
    from gslm_tpu_torch.parallel.mesh import all_reduce, barrier
    from gslm_tpu_torch.parallel.model_raster import (
        _pack, band_probe, band_rows, exchange_bytes, mp_render_views,
        mp_scalar_training_loss)
    from gslm_tpu_torch.renderer import _pre, overflow_probe, render
    from gslm_tpu_torch.utils.synthetic import (random_gaussians,
                                                ring_camera_batch)

    mesh = make_mesh(1, world)
    out = {"rank": rank, "mesh": mesh.shape}
    cuda = dev.type == "cuda"
    out["gloo_cuda"] = mp_collectives(dev, mesh)
    check(all(v is True for v in out["gloo_cuda"].values()),
          f"gloo on {dev.type} tensors: {out['gloo_cuda']}")
    totals = {k: 0 for k in "ABCDEGH"}

    def sync():
        sync_device(dev)
        barrier(mesh)

    def wall_ms(fn):
        sync_device(dev)
        t0 = time.perf_counter()
        res = fn()
        sync_device(dev)
        return res, (time.perf_counter() - t0) * 1e3

    def count(before):
        after = launches()
        for k in totals:
            totals[k] += after[k] - before[k]
        return _delta(before, after)

    def in_turns(fn):
        """``fn()`` on one rank at a time, the others waiting: the ranks
        share the card, so a kernel timed while the other rank runs
        measures both."""
        got = None
        for turn in range(world):
            sync()
            if turn == rank:
                with torch.no_grad():
                    got = fn()
        sync()
        return got

    def world_max(x) -> int:
        return int(all_reduce([torch.as_tensor(x, device=dev).reshape(1)],
                              "max", mesh.world_group)[0])

    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    # ---- 1. the m1 view's bands, both exchanges --------------------------
    params = random_gaussians(np.random.default_rng(2), n=m1_n,
                              capacity=m1_n, sh_degree=3, num_images=1,
                              spread=1.5, scale_range=(-5.5, -3.5),
                              device=dev)
    cams = ring_camera_batch(1, height, width, device=dev)
    bg = torch.zeros(3, device=dev)
    pr = overflow_probe(params, cams, config=RasterConfig(cull=True))
    cfg = caps_from_counts(int(pr["n_aabb"]), int(pr["n_live"]))
    rows = mesh.rows(m1_n)
    Pl = rows.stop - rows.start
    R = 2 * Pl // mesh.n_model
    bh_px = band_rows(height, mesh.n_model) * 16
    lo = mesh.model_rank * bh_px
    in_h = max(0, min(bh_px, height - lo))
    start = (params, GaussianAux.zeros(m1_n, dev), init_adam(params))
    p_l, a_l, o_l = shard_state(mesh, *clone_state(*start))
    with torch.no_grad():
        single = render(params, cams.view(0), bg, config=cfg)
        out["render"] = {}
        for name, c in (("gather", cfg),
                        ("route", cfg.replace(mp_route_capacity=R))):
            before = launches()
            img, invd, _, diags = mp_render_views(p_l, cams, bg, config=c,
                                                  mesh=mesh)
            sync_device(dev)
            got = count(before)
            want_img = single.render[:, lo:lo + in_h]
            want_inv = single.invdepth[:, lo:lo + in_h]
            d = max(float((img[0, :, :in_h] - want_img).abs().max()),
                    float((invd[0, :, :in_h] - want_inv).abs().max()))
            # the loss's band: rows past H zeroed (the raw render has the
            # last tile row's splats there)
            _, info = mp_scalar_training_loss(p_l, cams, bg, config=c,
                                              mesh=mesh)
            out["render"][name] = {
                "launches": got, "max_abs": d,
                "bitwise": bool(torch.equal(img[0, :, :in_h], want_img)
                                and torch.equal(invd[0, :, :in_h],
                                                want_inv)),
                "pad_rows": bh_px - in_h,
                "pad_zero": bool(
                    (info["band_render"][0, :, in_h:] == 0).all()
                    and (info["band_render_raw"][0, :, in_h:] == 0).all()),
                "overflow": world_max(diags["overflow"]),
                "bytes": exchange_bytes(1, Pl, mesh.n_model, c.mp_route_capacity)}
            check(d <= 1e-6, f"rank {rank}'s {name} band differs from the "
                  f"single process's render: {d}")
            check(out["render"][name]["pad_zero"], f"rank {rank}'s loss band "
                  f"has nonzero rows past H ({name})")
            check(out["render"][name]["overflow"] == 0, f"{name} overflows")
            check(got == {"A": 1, "B": 0, "C": 0, "D": 0, "E": 0, "G": 1,
                          "H": cams.batch_size},
                  f"band render launches {got}: expected A and G once, H "
                  f"once per view")
            del img, invd, info
        del single
        # the exchange's and the reduce-scatter's times at this view
        views = [_pre(p_l, cams.view(0), cfg, 3, 1.0, None, None)]
        fl, it = _pack(views)
        sync()
        out["gather_ms"] = [wall_ms(lambda: (
            all_gather(fl, mesh.model_group, 1),
            all_gather(it, mesh.model_group, 1)))[1] for _ in range(5)]
        sf = torch.zeros(mesh.n_model * R, 11, device=dev)
        si = torch.zeros(mesh.n_model * R, 6, dtype=torch.int32, device=dev)
        sync()
        out["route_ms"] = [wall_ms(lambda: (
            all_to_all(sf, mesh.model_group),
            all_to_all(si, mesh.model_group)))[1] for _ in range(5)]
        g = torch.zeros(1, m1_n, 11, device=dev)
        per = m1_n // mesh.n_model

        def all_reduce_slice():
            # the transpose's other form, timed in turns with the port's
            y = g.clone()
            torch.distributed.all_reduce(y, group=mesh.model_group)
            return y.narrow(1, mesh.model_rank * per, per)
        sync()
        turns = [(wall_ms(lambda: _reduce_scatter(g, mesh.model_group, 1))[1],
                  wall_ms(all_reduce_slice)[1]) for _ in range(5)]
        out["reduce_scatter_ms"] = [a for a, _ in turns]
        out["all_reduce_slice_ms"] = [b for _, b in turns]
        out["reduce_scatter_bytes"] = g.numel() * 4
        del views, fl, it, sf, si, g

    # ---- 2. the model-parallel Adam step against train_step ---------------
    kw = dict(opt=OptimizationParams(), active_sh_degree=3, use_exp=False,
              sparse_adam=False, update_stats=True)
    p, a, o = clone_state(*start)
    _, _, _, want_m = T.train_step(p, a, o, cams, bg, 1, 1.0, 0.0, rcfg=cfg,
                                   **kw)
    want = {k: v.clone() for k, v in state_tensors(p, a, o).items()}
    del p, a, o
    out["adam"] = {}
    for name, c in (("gather", cfg),
                    ("route", cfg.replace(mp_route_capacity=R))):
        step = make_mp_train_step(mesh, rcfg=c, **kw)
        p_l, a_l, o_l = shard_state(mesh, *clone_state(*start))
        sync()
        before = launches()
        with backward_inputs() as c_in, blur_inputs() as b_in:
            _, _, _, got_m = step(p_l, a_l, o_l, cams, bg, 1, 1.0, 0.0)
            sync_device(dev)
        res = {"launches": count(before),
               "err": mp_adam_held(state_tensors(p_l, a_l, o_l), want, rows,
                                   got_m, want_m),
               "loss": [float(got_m["loss"]), float(want_m["loss"])]}
        check(res["launches"] == MP_ADAM_LAUNCHES,
              f"rank {rank} mp Adam launches {res['launches']}")
        if name == "gather" and cuda:
            res["kernels"] = step_vs_plain(
                f"mp Adam band, rank {rank}", c_in[0], b_in)
            rec, st, cn, ntx, vrows, gtiles, xstate, dg = c_in[0]
            planes, taps = b_in[0]
            kms = in_turns(lambda: {
                "A": cuda_ms(lambda: rc.composite_tiles(
                    rec, st, cn, ntx, vrows), 10),
                "B": cuda_ms(lambda: blur_same(planes, taps), 10),
                "C": cuda_ms(lambda: rc.composite_tiles_bwd(*c_in[0]), 10)})
            label = f"(m1 band {mesh.model_rank} of {mesh.n_model})"
            ra = a_report(tag, label, rec, st, cn, ntx, vrows,
                          rc.composite_tiles(rec, st, cn, ntx, vrows)[1],
                          kms["A"])
            rcc = c_report(tag, label, rec, st, cn, ntx, vrows, xstate, dg,
                           kms["C"])
            b_bound = 2 * planes.numel() * 4 / PEAK_BYTES * 1e3
            res["kernel_ms"] = kms
            res["bounds"] = {"A": [ra["bound"], ra["by"]], "C": [
                rcc["bound"], rcc["by"]], "B": [b_bound, "bytes"]}
            res["band_shape"] = {"records": int(rec.shape[0]),
                                 "tiles": int(cn.shape[0]),
                                 "planes": list(planes.shape)}
            print(f"{tag} 14 rank {rank} kernels on the m1 band (ms, CUDA "
                  f"events, median of 10, one rank at a time): {kms}; B's "
                  f"byte bound "
                  f"{b_bound:.4f} ms on planes {tuple(planes.shape)}",
                  flush=True)
            before = launches()
            res["ms"] = [wall_ms(lambda: step(p_l, a_l, o_l, cams, bg, 2,
                                              1.0, 0.0))[1]
                         for _ in range(MP_STEPS)]
            n_k, busy, wall = device_busy(lambda: step(p_l, a_l, o_l, cams,
                                                       bg, 3, 1.0, 0.0))
            count(before)
            res["busy"] = [n_k, busy, wall]
        del c_in, b_in
        out["adam"][name] = res
        del p_l, a_l, o_l
    del want
    # the single process's step on the same card, the other rank waiting
    sync()
    if rank == 0:
        p, a, o = clone_state(*start)
        out["single_adam_ms"] = [wall_ms(lambda: T.train_step(
            p, a, o, cams, bg, 1, 1.0, 0.0, rcfg=cfg, **kw))[1]
            for _ in range(MP_STEPS)]
        del p, a, o
    sync()
    del start, params

    # ---- 3. the model-parallel LM step against phase 7's lm_outer_step ----
    params, all_train, win, vidx = lm_scene(dev, n_gauss, height, width)
    p_l = shard_state(mesh, params)
    window, val = all_train.take(win), all_train.take(vidx)
    need = 0
    for cams_ in (window, val):
        band = band_probe(p_l, cams_, config=RasterConfig(cull=True),
                          mesh=mesh)["band_aabb"]
        need = max(need, int(band.sum(0).max()))
    lcfg = caps_from_counts(need, need)
    out["lm_caps"] = [lcfg.dup_capacity, lcfg.live_capacity]
    lm_step = make_mp_lm_step(mesh, rcfg=lcfg, lm=LMParams(),
                              active_sh_degree=3, use_exp=False)
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    before = launches()
    with jvp_inputs() as e_in:
        (got, got_i), ms = wall_ms(lambda: lm_step(p_l, p_l.alive, window,
                                                   val, bg))
    out["lm_launches"] = count(before)
    out["lm_ms"] = ms
    out["lm_peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                          if cuda else 0.0)
    check(out["lm_launches"] == MP_LM_LAUNCHES,
          f"rank {rank} mp LM launches {out['lm_launches']}")
    ref = torch.load(lm_ref, map_location=dev)
    out["lm_err"] = mp_lm_held(state_tensors(got), ref["state"],
                               mesh.rows(n_gauss), got_i, ref["info"])
    out["lm_best"] = [float(got_i["best_val_loss"]),
                      float(ref["info"]["best_val_loss"])]
    if cuda:
        e_args = e_in[0][:6]
        e = e_vs_plain(f"mp LM window band, rank {rank}", *e_args)
        rec, _, st, cn, ntx, vrows = e_args
        e_ms, a_ms = in_turns(lambda: (
            cuda_ms(lambda: rc.composite_tiles_jvp(*e_args), 10),
            cuda_ms(lambda: rc.composite_tiles(rec, st, cn, ntx, vrows), 10)))
        label = f"(LM window band {mesh.model_rank} of {mesh.n_model})"
        ra = a_report(tag, label, rec, st, cn, ntx, vrows, e["walked"], a_ms)
        re_ = e_report(tag, label, ra["work"], int(e["walked"].long().sum()),
                       cn.shape[0], e_ms)
        out["lm_kernels"] = {"E": e["err"], "E_vs_A": e["vs_a"],
                             "E_ms": e_ms, "E_plain_ms": e["plain_ms"],
                             "E_bound": [re_["bound"], re_["by"]],
                             "records": int(rec.shape[0]),
                             "tiles": int(cn.shape[0])}
        del e, e_args, rec, st, cn
    del got, got_i, params, all_train, p_l, e_in, ref, window, val

    # ---- 4. the command lines with a model axis ---------------------------
    model = os.path.join(root, "mp")
    ck = os.path.join(model, f"chkpnt{MP_ITERS}.npz")
    common = ["-s", src, "-m", model, "-r", "1", "--eval", "--capacity",
              str(2 * n_gauss), "--mesh_model", str(world),
              "--disable_viewer"] + ([] if cuda else ["--platform", "cpu"])
    argv = common + ["--iterations", str(MP_ITERS),
                     "--densify_from_iter", str(MP_DENSIFY[0]),
                     "--densification_interval", str(MP_DENSIFY[1]),
                     "--test_iterations", str(MP_ITERS),
                     "--save_iterations", str(MP_ITERS),
                     "--checkpoint_iterations", str(MP_ITERS)]
    sync()
    before = launches()
    t0 = time.perf_counter()
    with entry_point() as tee:
        _, p, a, o = T.main(argv)
    out["train_s"] = time.perf_counter() - t0
    out["train_launches"] = count(before)
    out["train_lines"] = [ln for ln in tee.text().splitlines()
                          if "PSNR" in ln or "Model-parallel" in ln
                          or "overflow" in ln]
    out["train_step"] = o.step
    out["train_alive"] = int(all_reduce([p.alive.sum()], "sum",
                                        mesh.model_group)[0])
    # the sharded checkpoint: its own rows back bit for bit, its gather
    # bit for bit the npz train.main wrote
    shard_dir = os.path.join(root, "mp_sharded")
    save_checkpoint_sharded(shard_dir, p, a, o, MP_ITERS, 1.0, mesh=mesh)
    mine = load_checkpoint_sharded(shard_dir, mesh=mesh, device=dev)
    whole = load_checkpoint_sharded(shard_dir, device=dev)
    npz = load_checkpoint(ck, device=dev)
    out["ckpt_mine_diff"] = bitwise_diff(state_tensors(p, a, o),
                                         state_tensors(*mine[:3]))
    out["ckpt_whole_diff"] = bitwise_diff(state_tensors(*npz[:3]),
                                          state_tensors(*whole[:3]))
    check(not out["ckpt_mine_diff"] and not out["ckpt_whole_diff"],
          f"sharded checkpoint round trip: {out['ckpt_mine_diff']}, "
          f"{out['ckpt_whole_diff']}")
    del p, a, o, mine, whole, npz
    lm_argv = common + ["--start_checkpoint", ck, "--iterations",
                        str(MP_ITERS + 1), "--jvp_start", str(MP_ITERS + 1),
                        "--dup_capacity", str(16 * 2 * n_gauss),
                        "--num_val_views", str(MP_VAL_VIEWS)]
    sync()
    before = launches()
    t0 = time.perf_counter()
    with entry_point() as tee:
        TL.main(lm_argv)
    out["lm_cli_s"] = time.perf_counter() - t0
    out["lm_cli_launches"] = count(before)
    out["lm_cli_lines"] = [ln for ln in tee.text().splitlines()
                           if "LM window" in ln or "growing" in ln
                           or "re-running" in ln or "WARNING" in ln]
    out["files"] = sorted(os.listdir(model)) if rank == 0 else []
    out["peak_gib"] = (torch.cuda.max_memory_allocated(dev) / 2**30
                       if cuda else 0.0)
    out["totals"] = totals
    return out


def mp_phase(dev, n_gauss: int, m1_n: int, height: int, width: int,
             tag: str, kernels: list[dict], src: str, root: str,
             lm_ref: dict) -> None:
    """Phase 14 (cell train-mp2-m1-1080p): ``MP_WORLD`` spawned gloo ranks
    sharing the card as a (1, ``MP_WORLD``) mesh: the million-Gaussian
    view's bands with both exchanges, the model-parallel Adam step on it,
    the LM step on cell lm-1080p-w5's window (held to phase 7's,
    ``lm_ref``), then ``train.main`` and ``train_lm.main --mesh_model`` on
    phase 9's scene ``src``. Adds each rank's launches to the kernel
    entries in ``kernels``."""
    import torch
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    t_phase = time.perf_counter()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out_dir = os.path.join(root, "mp_ranks")
    os.makedirs(out_dir)
    torch.save({part: {k: v.cpu() for k, v in lm_ref[part].items()}
                for part in ("state", "info")},
               os.path.join(out_dir, "lm_ref.pt"))
    ctx = mp.start_processes(
        mp_rank, args=(MP_WORLD, free_port(), out_dir, dev.type, src, root,
                       n_gauss, m1_n, height, width, tag),
        nprocs=MP_WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + MP_TIMEOUT
    try:
        while not ctx.join(timeout=1.0):
            check(time.monotonic() < deadline,
                  f"phase 14 ranks still running after {MP_TIMEOUT} s")
    except ProcessException as e:
        errs = [pathlib.Path(out_dir, f).read_text()
                for f in sorted(os.listdir(out_dir)) if f.endswith(".err")]
        raise RuntimeError("a phase 14 rank failed:\n"
                           + "\n".join(errs)) from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    ranks = []
    for r in range(MP_WORLD):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    r0 = ranks[0]
    print(f"{tag} 14 gloo on CUDA tensors, the model axis's collectives "
          f"(no host staging where every entry is True): {r0['gloo_cuda']}",
          flush=True)
    for r in ranks:
        for name, res in r["render"].items():
            print(f"{tag} 14 rank {r['rank']} m1 band ({name}): max|d| "
                  f"{res['max_abs']:.3g} vs the single process's render "
                  f"({'bit for bit' if res['bitwise'] else 'not bitwise'}); "
                  f"{res['pad_rows']} rows past H zero in the loss's band "
                  f"{res['pad_zero']}; "
                  f"overflow {res['overflow']}; launches {res['launches']}; "
                  f"exchange {res['bytes']} B per rank", flush=True)
        for name, res in r["adam"].items():
            print(f"{tag} 14 rank {r['rank']} mp Adam step ({name}) vs "
                  f"train_step on the m1 view: {res['err']}; launches "
                  f"{res['launches']}", flush=True)
        print(f"{tag} 14 rank {r['rank']} mp LM step (window of 5 views, "
              f"50 val views in one pass per alpha, bucket 1) vs phase 7's "
              f"lm_outer_step: best "
              f"val loss {r['lm_best'][0]:.6f} vs {r['lm_best'][1]:.6f}; "
              f"{r['lm_err']}; caps {r['lm_caps']}; launches "
              f"{r['lm_launches']}", flush=True)
    for r in ranks:
        ad = r["adam"]["gather"]
        n_k, busy, wall = ad.get("busy", (0, 0.0, 1.0))
        med = statistics.median(ad["ms"]) if "ms" in ad else 0.0
        print(f"{tag} 14 rank {r['rank']}: mp Adam step median {med:.3f} ms "
              f"(runs {[round(x, 3) for x in ad.get('ms', [])]}); all_gather "
              f"exchange {statistics.median(r['gather_ms']):.3f} ms for "
              f"{r['render']['gather']['bytes']} B; routed all_to_all "
              f"{statistics.median(r['route_ms']):.3f} ms for "
              f"{r['render']['route']['bytes']} B; reduce-scatter "
              f"{statistics.median(r['reduce_scatter_ms']):.3f} ms "
              f"(all_reduce + slice in turns "
              f"{statistics.median(r['all_reduce_slice_ms']):.3f} ms) "
              f"for {r['reduce_scatter_bytes']} B (medians of 5); one "
              f"profiled Adam step: {n_k} CUDA kernels, device busy "
              f"{busy:.3f} ms of {wall:.3f} ms wall ({busy / wall:.3f}); mp "
              f"LM step {r['lm_ms']:.1f} ms, peak {r['lm_peak_gib']:.2f} GiB;"
              f" phase peak {r['peak_gib']:.2f} GiB", flush=True)
        if "lm_kernels" in r:
            print(f"{tag} 14 rank {r['rank']} kernel tables: Adam band "
                  f"{r['adam']['gather']['band_shape']}, ms "
                  f"{r['adam']['gather']['kernel_ms']}, bounds "
                  f"{r['adam']['gather']['bounds']}; LM window band "
                  f"{r['lm_kernels']}", flush=True)
        print(f"{tag} 14 rank {r['rank']} launches: Adam "
              f"{r['adam']['gather']['launches']}, LM {r['lm_launches']}, "
              f"train.main {r['train_launches']}, train_lm.main "
              f"{r['lm_cli_launches']}; phase total {r['totals']}",
              flush=True)
    if "single_adam_ms" in r0:
        single = r0["single_adam_ms"]
        print(f"{tag} 14 single process on the same card: train_step on the "
              f"m1 view median {statistics.median(single):.3f} ms (runs "
              f"{[round(x, 3) for x in single]}); lm_outer_step "
              f"{lm_ref['ms']:.1f} ms (phase 7's median)", flush=True)
    print(f"{tag} 14 train.main --mesh_model {MP_WORLD}: {MP_ITERS} "
          f"iterations in {r0['train_s']:.1f} s, {r0['train_alive']} alive, "
          f"step {r0['train_step']}, lines {r0['train_lines']}; the sharded "
          f"checkpoint round trip and its gather vs chkpnt{MP_ITERS}.npz: "
          f"bit for bit; train_lm.main --mesh_model {MP_WORLD} "
          f"--num_val_views {MP_VAL_VIEWS}: 1 LM iteration in "
          f"{r0['lm_cli_s']:.1f} s, lines {r0['lm_cli_lines']}; rank 0 "
          f"wrote {r0['files']}", flush=True)
    check(r0["train_step"] == MP_ITERS, "train.main's Adam step count")
    check(f"chkpnt{MP_ITERS}.npz" in r0["files"] and "cfg_args" in r0["files"],
          "train.main --mesh_model: rank 0's files")
    check(any("LM window [" in ln for ln in r0["lm_cli_lines"]),
          "train_lm.main --mesh_model: no LM step")
    check(not any("WARNING" in ln for ln in r0["lm_cli_lines"]),
          "train_lm.main --mesh_model: a degraded LM step")
    for r in ranks:
        for k in "ABCE":
            check(r["totals"][k] > 0, f"rank {r['rank']} never launched "
                                      f"kernel {k} on the model-parallel path")
    for entry, k in zip(kernels, "ABCDE"):
        for r in ranks:
            n = r["totals"][k]
            entry["launches_by_path"][f"model_parallel_rank{r['rank']}"] = n
            entry["launches"] += n
    for r in ranks:
        G_LAUNCHES[f"model_parallel_rank{r['rank']}"] = r["totals"]["G"]
        H_LAUNCHES[f"model_parallel_rank{r['rank']}"] = r["totals"]["H"]
    print(f"{tag} phase 14 wall {time.perf_counter() - t_phase:.1f} s",
          flush=True)


QUALITY_SEED = 0               # the first of the JAX slow test's seeds
QUALITY_TIMEOUT = 600.0        # phase 15's join timeout after phase 14 (s)
# the JAX slow test's LM (tests/test_quality.py:56-59)
QUALITY_LM = dict(num_images=3, num_val_views=3, val_view_stride=1,
                  cg_max_iter=2, cg_restart_iter=1, line_search_steps=6,
                  mask_xyz=False)
QUALITY_ADAM_LAUNCHES = {"A": 1, "B": 2, "C": 1, "E": 0}


def lm_launch_rule(lm, nwin: int, nval: int) -> dict:
    """Kernel launches of one ``lm_outer_step`` over ``nwin`` window and
    ``nval`` validation views, read off the code: the window renders in
    ``micro_batches`` chunks, each J·v (kernel E) and Jᵀ·u (kernel C) once
    per chunk; ``cgls_damped_unrolled`` runs ceil(max_iter / restart_iter)
    restart blocks, each one J·v and one Jᵀ·u, and per iteration one of
    each plus a J·v for the divergence check; the linearization renders
    the window once (A per chunk) and the line search renders the
    validation chunks once per alpha (A per chunk); B never, the residual
    having no SSIM term. Counted for the plain line search and
    ``disable_ssim`` only (checked)."""
    from gslm_tpu_torch.train_lm import micro_batches
    check(lm.ls_subset_views == 0 and lm.ls_val_scale == 1
          and lm.disable_ssim, "lm_launch_rule counts the plain line "
          "search without the SSIM residual only")
    mb, val_mb = micro_batches(lm, nwin, nval)
    chunks, val_chunks = nwin // mb, nval // val_mb
    blocks = -(-lm.cg_max_iter // lm.cg_restart_iter)
    jvps = blocks + lm.cg_max_iter * (2 if lm.check_divergence else 1)
    return {"A": chunks + (lm.line_search_steps + 1) * val_chunks, "B": 0,
            "C": chunks * (blocks + lm.cg_max_iter), "E": chunks * jvps}


def quality_body(dev, tag: str) -> dict:
    """Phase 15: the quality harness at its small size for seed 0, driven
    through ``tools.quality.run_one`` (cell quality-small-64), with its
    checks; prints its lines. Returns the launches of the run (``totals``)
    and the kernels' max |Δ| from plain on the plateau (``errs``)."""
    from gslm_tpu_torch import train as T
    from gslm_tpu_torch.config import LMParams
    from gslm_tpu_torch.tools import quality as Q

    size = Q.SIZES["small"]
    lm = LMParams(**QUALITY_LM)
    n_lm = max(1, round(size["extra"] / Q.lm_cost_in_adam_steps(lm)))
    lm_want = lm_launch_rule(lm, lm.num_images, lm.num_val_views)
    want = {"adam": {k: size["iters"] * v
                     for k, v in QUALITY_ADAM_LAUNCHES.items()},
            "adam_extra": {k: size["extra"] * v
                           for k, v in QUALITY_ADAM_LAUNCHES.items()},
            "lm": {k: n_lm * v for k, v in lm_want.items()}}
    print(f"{tag} 15 quality harness at {size['kw']}: {size['iters']} Adam "
          f"iterations (events to {size['dens_until']}), then +"
          f"{size['extra']} Adam vs {n_lm} LM steps (one costs "
          f"{Q.lm_cost_in_adam_steps(lm):.2f} Adam steps); launches per LM "
          f"step by the code {lm_want}", flush=True)
    zero_launches()
    t0 = time.perf_counter()
    with jvp_inputs() as e_in:        # the first LM step's first J·v
        r = Q.run_one(QUALITY_SEED, size["kw"], size["iters"],
                      size["dens_until"], size["extra"], lm=lm, device=dev,
                      profile=False)
    wall = time.perf_counter() - t0
    totals = launches()
    sec = {k: round(v, 2) for k, v in r["seconds"].items()}
    d_adam, d_lm = r["adam"] - r["plateau"], r["lm"] - r["plateau"]
    s = f"seed {QUALITY_SEED}"
    print(f"{tag} 15 {s}: init {r['init']:.3f} dB, plateau "
          f"{r['plateau']:.3f} dB ({r['alive']} alive), Adam +"
          f"{size['extra']} {d_adam:+.3f} dB, LM +{r['n_lm']} {d_lm:+.3f} "
          f"dB, LM − Adam {d_lm - d_adam:+.3f} dB; overflowed Adam steps "
          f"{r['overflowed']}; wall {wall:.1f} s, by phase (s) {sec}, per "
          f"Adam step {1e3 * r['seconds']['adam'] / size['iters']:.2f} ms, "
          f"per LM step {1e3 * r['seconds']['lm'] / r['n_lm']:.1f} ms; "
          f"launches {r['launches']}, in all {totals}; records per tile at "
          f"most {r['max_tile_load']} (ground truth, plateau)", flush=True)
    check(r["overflowed"] == 0, f"15 {s}: {r['overflowed']} Adam steps "
          f"overflowed")
    check(r["plateau"] > r["init"] + 8.0, f"15 {s}: plateau "
          f"{r['plateau']:.3f} not 8 dB above the start {r['init']:.3f}")
    check(r["plateau"] > 24.0, f"15 {s}: plateau {r['plateau']:.3f} dB")
    check(r["alive"] > 300, f"15 {s}: {r['alive']} alive")
    check(r["n_lm"] == n_lm, f"15 {s}: {r['n_lm']} LM steps")
    for ph, w in want.items():
        got = {k: r["launches"][ph][k] for k in w}
        check(got == w, f"15 {s}: launches of {ph} {got}, expected {w}")
    check(totals["G"] == totals["A"] + totals["E"], f"15 {s}: kernel G "
          f"launched {totals['G']} times, expected once per render and J·v")
    # H: the no-grad renders' views (targets, PSNRs, the LM's validation)
    check(totals["H"] > 0, f"15 {s}: kernel H never launched by the no-grad "
          f"renders")
    check(d_lm > 0.1, f"15 {s}: LM gain {d_lm:.3f} dB")
    check(d_lm > d_adam - 0.05, f"15 {s}: LM gain {d_lm:.3f} dB against "
          f"Adam's {d_adam:.3f}")

    # A, B and C on an Adam step's own inputs at the plateau (a densified
    # scene), E on its first LM step's; the counts are read above
    params, _, cams, rcfg, bg = r["state"]
    with backward_inputs() as c_in, blur_inputs() as b_in:
        T.loss_and_grads(params, cams.take(slice(0, 1)), bg, 0.0, rcfg=rcfg,
                         opt=T.OptimizationParams(), active_sh_degree=0,
                         use_exp=False)
    errs = step_vs_plain(f"quality plateau, {s}, view 0", c_in[0], b_in)
    rec, tng, st, cn, ntx, nty = e_in[0][:6]
    errs["E"] = e_vs_plain(f"quality plateau, {s}, the first LM step's "
                           f"window", rec, tng, st, cn, ntx, nty)["err"]
    return {"totals": totals, "errs": {k: float(v) for k, v in errs.items()}}


def quality_worker(_: int, out_dir: str, dev_type: str, tag: str) -> None:
    """Phase 15's process, spawned: ``quality_body`` on cuda:0 (or the CPU,
    to rehearse) with its lines in ``out_dir``/quality.log and its result
    in quality.json (its traceback in quality.err)."""
    import traceback

    import torch
    dev = torch.device("cuda", 0) if dev_type == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    saved = sys.stdout
    try:
        with open(os.path.join(out_dir, "quality.log"), "w") as log:
            sys.stdout = log
            res = quality_body(dev, tag)
        with open(os.path.join(out_dir, "quality.json"), "w") as f:
            json.dump(res, f)
    except BaseException:
        with open(os.path.join(out_dir, "quality.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        sys.stdout = saved


def quality_start(dev, tag: str, root: str):
    """Starts phase 15 in a process of its own, to run beside phases 11-14:
    all of them are host-bound with the card mostly idle, and one seed of
    the harness takes 209-359 s alone. Returns what ``quality_finish``
    takes."""
    import torch.multiprocessing as mp
    out_dir = os.path.join(root, "quality")
    os.makedirs(out_dir)
    ctx = mp.start_processes(quality_worker, args=(out_dir, dev.type, tag),
                             nprocs=1, join=False, start_method="spawn")
    return ctx, out_dir, time.perf_counter()


def quality_finish(started, tag: str, kernels: list[dict]) -> None:
    """Waits for phase 15's process (``quality_start``), prints its lines,
    raises on its failure and adds its launches and errors to the kernel
    entries in ``kernels``."""
    from torch.multiprocessing.spawn import ProcessException

    ctx, out_dir, t_phase = started
    deadline = time.monotonic() + QUALITY_TIMEOUT
    try:
        while not ctx.join(timeout=1.0):
            check(time.monotonic() < deadline,
                  f"phase 15 still running {QUALITY_TIMEOUT} s after "
                  f"phase 14")
    except ProcessException as e:
        err = pathlib.Path(out_dir, "quality.err")
        raise RuntimeError("phase 15 failed:\n" + (
            err.read_text() if err.exists() else "")) from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
        log = pathlib.Path(out_dir, "quality.log")
        if log.exists():
            print(log.read_text(), end="", flush=True)
    with open(os.path.join(out_dir, "quality.json")) as f:
        res = json.load(f)
    for entry, k in zip(kernels, "ABCDE"):
        entry["launches_by_path"]["quality_small_64"] = res["totals"][k]
        entry["launches"] += res["totals"][k]
        if k in res["errs"]:
            entry["max_abs_err_quality"] = res["errs"][k]
    G_LAUNCHES["quality_small_64"] = res["totals"]["G"]
    H_LAUNCHES["quality_small_64"] = res["totals"]["H"]
    print(f"{tag} phase 15 wall {time.perf_counter() - t_phase:.1f} s, "
          f"started before phase 11", flush=True)


if __name__ == "__main__":
    sys.exit(main())
