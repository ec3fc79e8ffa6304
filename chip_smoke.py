#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA GPU (H100).

Drives wavelet_monodepth_tpu_torch's paths at full width (KITTI
ResNet18, 640x192, random weights from seeded torch.Generators): serving
(dense and sparse inference on every sparse backend: the tile-sparse 3x3
conv kernel, the block IO kernels of the compact backend), training
(stereo + depth hints at batch 12 with the banded warp kernel), the
eigen-split evaluation (ResNet18 640x192 and ResNet50 1024x320), the
NYUv2 serving and evaluation path (DenseNet161 + the wavelet decoder at
640x480) and its training (the same model at batch 8), the 1024x320 B=6
training of the published HR rows, the training visuals, a soak with a
kill and a resume, the self-golden train -> eval check on the soak's
checkpoint, the sparsity-curve tools, the native decoder,
data-parallel training over two ranks, height-banded (spatial) inference
over two ranks and the decoders' polyphase upconv, plus the fused wave
stage kernel on the serving slice's own stage inputs, in phases; any
failure raises and exits non-zero:

  1. device: needs CUDA (raises otherwise), turns TF32 off, prints the
     card's name and power limit;
  2. build: the four csrc/*.cu sources, one nvcc each, started together;
     prints each one's ptxas registers and spills;
  3. conv kernel vs plain: both wrappers (stripe flags, K1; 2-D tile
     flags, K4) against the plain PyTorch version at every decoder conv
     shape of the path at B=1 and B=16 (ResNet18 at 640x192 and ResNet50
     at 1024x320, whose skips widen upconv_3_1 / upconv_2_1 to Cin 640 /
     320), plus all pad modes / epilogues and
     all-zero, all-one and ragged masks; max |err| <= 1e-4;
  4. serving: a reference-layout checkpoint folder and 4 scene PNGs are
     written to a temp dir, and servers built by tools/infer.load_model
     answer each image with --use_sparse --threshold 0.1 on the kernel
     backends (12 conv launches per request each) and the compacted ones
     ("compact": 18 band_gather + 6 block_scatter launches per request;
     "sites", "capacity"; compact_cap 0.5), all counted; answers are
     checked against the masked-dense cuDNN backend where the backend is
     exact and nothing overflowed; then tools/infer.main runs once;
  5. serving contracts: thresh=-1 sparse == dense (bitwise on the xla
     backend, 1e-4 on the kernel backends) and, at bench.py's operating
     point (B=16, 10% edge masks via mask_override), kernel backends ==
     xla within 1e-4 with equal op counts; the compacted backends at
     compact_cap 1.0 overflow nowhere, keep xla's op counts and equal xla
     within 1e-4 (sites, capacity: whole tensors; compact: away from its
     image-border ring, COMPACT_RING); at 0.5 their overflow is printed;
     one ResNet50 1024x320 B=1 request on pallas, pallas2d and compact
     (compact_cap 1.0) under the same contracts, its launches counted;
  5a. bf16 serving: servers from tools/infer.load_model(--bfloat16) on
     xla, compact, sites and capacity (compact_cap 1.0) answer B=16 and
     B=1 requests at the 10% maskgen point (the bf16 path: K5/K6's bf16
     instances, 18 + 6 launches per request on compact, counted from 0):
     disp within max 0.05 / mean 0.01 of the float32 server's of the
     same backend, op counts equal to xla bf16's, no overflow, within the
     same bounds of xla bf16 (compact: away from its ring); pallas and
     pallas2d raise in bf16 (JAX cannot lower them);
  5b. block IO vs plain, float32 and bf16: the 18 gathers and 6 scatters
     of a compact forward at B=16 and B=1, every tile of a stack
     (window_h == th, the last row block) and odd C=1 / C=3 row widths;
     bitwise equal; then the synchronising calls of one B=16 compact
     forward (float32, compact_cap 1.0) under
     torch.cuda.set_sync_debug_mode("warn"), none of them block_scatter's;
     after every phase that scatters, the scatter kernel's fault counter
     (block IO's scatter_faults) must read 0;
  5c. fused wave stage (K2) vs plain (<= 1e-4) and vs the masked-dense
     oracle's interior (2 px for yh and x1, 4 px for yl_new; <= 1e-4) on
     the decoder's stage inputs at scales 3, 2, 1, B=16 and B=1, under
     the 10% maskgen, all-zero and all-one masks;
  5d. polyphase: use_polyphase on against off on the same weights. KITTI
     R18 640x192, B=12, float32: dense disparities within 5e-5 (JAX's
     bound, tests/test_decoders_kitti.py:165-167), sparse at threshold
     0.05 on xla within 5e-5 with op counts at rtol 1e-6 (a mask flip
     only at a near tie, the off decoder then rerun under the on run's
     masks), thresh -1 sparse == dense bit for bit with the fold on (cuDNN
     deterministic); NYU DenseNet161 + NyuDecoderWave 640x480, B=1,
     seeded: dense disparities within 2e-5 (tests/test_decoders_nyu.py:
     125-135). Information only: the decoder's forward and forward +
     backward ms on against off at B=12, and the cuDNN kernels the
     profiler names for the fold's 2x2 low-res convs and for the costliest
     convs of each;
  6. serving times (CUDA events, warm-up, median of 3 interleaved windows
     with min and max): per-conv kernel vs plain vs cuDNN's F.conv2d with
     each conv's bound at float32 accuracy (3xTF32 tensor rate or bytes)
     and at the f32 CUDA-core rate, the share of active stripe and (8, 64)
     tile granules, the FLOPs over them and each wrapper's rate on them;
     whole forward dense vs sparse xla / pallas /
     pallas2d / compact / sites / capacity (compact_cap 0.5, and 1.0 for
     compact and capacity) at B=16 and B=1; K5 and K6 (each with its
     output's allocation) summed over one B=16 compact forward's
     launches, float32 and bf16;
     K2 per scale at B=16 and B=1, its bound at the 3xTF32 and the f32
     CUDA-core rates; a torch.profiler trace of the compacted backends'
     B=16 forwards and of dense and sparse xla in float32 and bf16
     (device idle share, costliest kernels and ATen ops);
  6b. the bench twin: tools/bench.py's cells (bench.py's keys: dense and
     sparse x float32 and bf16 at B=16, the threshold cell, B=1 bf16,
     density, FLOPs; extra rows for the kernel and compacted backends),
     re-emitted as {"phase": "bench", ...};
  7. warp kernel vs plain: the banded warp (K3) forward and its gradients
     for src, x and yr, with and without the source-row pass, on the
     path's (12, 192, 640, 3) stereo grids (a random net's depth and
     maskgen scenes, stereo_T[0, 3] = +-0.1), a border clamp and ragged
     small shapes; forward <= 1e-5, gradients <= 1e-4 of their largest
     value; the path's grids must be row-banded (|y - row| <= 1);
  8. training: a KITTI-layout mount (36 stereo pairs at 1242x375 JPEG
     from maskgen scenes, depth hints, a split) in a temp dir, then
     tools/train_kitti.main for one epoch at B=12 with
     --stereo_warp_kernel on: 3 steps, one validation batch, 5 forward
     and 4 backward K3 launches per step (5 more forward for the
     validation batch), finite losses, the checkpoint folder, which
     tools/infer then serves; then the same with --bfloat16 (mixed
     precision), whose checkpoint holds only float32 tensors;
  9. training contracts: "on" vs "off" on one batch and one set of
     weights: without hints and automasking (no argmin) losses within
     1e-5 and every gradient within 1e-3 of its norm; with them (the
     flagship, whose argmins flip where the two warps differ by ~1e-5)
     <= 0.5% of the mask pixels flipped and losses within 1e-4
     relative; one step launches K3 exactly 5 + 4 times; and the hint
     loss of a 640x192 B=4 batch falls by >= 15% in 30 steps, in float32
     and in bf16 mixed precision (parameters, BN buffers and Adam moments
     float32 after the steps);
 10. training times: ms per train step at B=12, "on" vs "auto" vs "on"
     in bf16 mixed precision, data on the card; a torch.profiler trace
     of each (device idle share) and one of an "on" step with input
     shapes (device time by ATen op); its costliest op, a decoder conv,
     alone (B=12 and B=16, cuDNN's heuristic vs benchmark); K3
     forward (alone and after its torch coordinate chain) and backward
     per launch against the plain version, F.grid_sample and their
     bound;
 11. eval: a synthetic eigen mount (data/synth.py, 16 test frames at
     1242x375 JPEG with exact GT) and tools/evaluate_depth.main with
     --eval_stereo: ResNet18 640x192 on phase 8's checkpoint, (a) dense
     --post_process (also on the CPU), (b) --use_sparse --threshold 0.1
     --post_process, (c) --bfloat16 --post_process, (d)
     --ext_disp_to_eval of (a)'s saved disparities, and (a) once more with
     TF32 on (the CLIs pin float32; a record of how far TF32 would move
     the row, `eval_tf32`); ResNet50 1024x320 on
     seeded weights, dense and sparse. Finite rows, (d) == (a), card vs
     CPU within 1e-4 (disparities and row), (b)'s ops == the decoder's
     own, (c) within the bf16 bounds of (a); per run the row, density,
     GFLOPs per image, seconds, and predict_disps' frames/s and host-feed
     share, the B=12 forward alone (CUDA events and a profile). The eval
     runs the masked-dense
     decoder, as in the JAX package: no kernel of the repo is on it;
 12. nyu: 16 synthetic labeled frames (data/synth.render_scene's view
     resized to 640x480, its true depth x0.25, GT edges from
     nyu_eval.canny) and a seeded DenseNet161 + NyuDecoderWave written as
     a reference model.pth, read by tools/evaluate_nyu.load_forward;
     nyu_eval.evaluate (batches of 8, edges) (a) dense, (b) dense on the
     CPU over 2 frames, (c) sparse at threshold 0.05 on xla (JAX's eval
     backend), (d) bf16 dense: one {"phase": "nyu_eval"} line each (the
     eight-metric row, frames/s, the predict and host-edge shares, the
     B=8 forward alone, density and GFLOPs when sparse). Checks: card vs
     CPU depths and six-metric row within 1e-4 (the edge metrics within
     1e-3 px), bf16 finite with a mean gap under 1% of the mean f32
     depth, thresh -1 sparse == dense bitwise; one B=8 and one B=1 sparse
     request on pallas, pallas2d and capacity (capacity_ratio 1.0) equal
     to xla within 1e-4 of each tensor's scale, with xla's masks and op
     counts and JAX's launches per forward (pallas: K1 x4; pallas2d: K4
     x2 + K1 x2; capacity: K1 x2), counted from 0 around each request;
     K1/K4 vs plain at the four NYU conv shapes (up2.convA 744->276 and
     up3.convA 372->138, reflect + LeakyReLU 0.2; the wave heads
     276->3 and 138->3, zero pad) on the requests' masks and on 5%
     maskgen base masks, B=8 and B=1, <= 1e-4. Times: those convs per
     kernel vs plain vs cuDNN with their bounds, the B=8 and B=1 forward
     dense and sparse on every backend at the 5% masks, MobileNetV2 +
     NyuDecoderWave at B=8, profiles of the B=8 and B=1 dense and the B=8
     pallas2d forwards (costliest kernels, ATen ops and convs), and the
     B=8 dense forward under cudnn.benchmark for comparison;
 13. nyu_train: data/synth.fabricate_nyu writes a 24-frame nyu_data.zip
     (640x480 PNGs), and tools/train_nyu.main trains DenseNet161 +
     NyuDecoderWave at 640x480, B=8, lr 1e-4, for one epoch (3 steps, a
     validation batch at each) in float32 and again with --bfloat16:
     finite losses, the port's NYU checkpoint (model.pth, adam.pth,
     opt.json; float32 only) and no launch of the six kernels (the
     training decoder is dense); tools/evaluate_nyu.main
     --load_weights_folder scores the float32 checkpoint on 4 of phase
     12's synthetic labeled frames (edges on), its row finite. Checks: a
     train-mode forward and the losses at B=1 on the card and on the
     host within 1e-4 relative; the bf16 mixed-precision first step's
     loss within 1% of the float32 step's on the same weights and batch,
     its masters, BN statistics and Adam moments float32; the learning
     twin (mobilenet_light, 64x96, B=2, 30 steps on one batch) falls by
     >= 10% in float32 and bf16. Times: ms per B=8 step in float32 and
     bf16, peak memory of each first step, a profile of each (idle share,
     device time by ATen op, the costliest convs forward and backward
     with their shapes and cuDNN kernels).

 14. kitti_pose: the remaining KITTI models on phase 8's mount. (a)
     tools/train_kitti.main trains M+S + depth hints (ResNet18 + the
     wavelet decoder, frame_ids 0 -1 1 + stereo, the separate_resnet pose
     net in "pairs" mode, --stereo_warp_kernel on) at 640x192, B=12, for
     3 steps and one validation batch on a split of the mount's interior
     frames; its K3 launches equal phase 8's stereo-only run's (the pose
     warps take F.grid_sample, as JAX's take its gather) and no other
     kernel of the repo launches; its checkpoint holds pose_encoder.pth
     and pose.pth, float32 only; ms per step (float32 and bf16 mixed
     precision), each first step's peak memory and a profile (idle
     share); the losses of a train-mode forward at B=1 on the card and
     on the host within 1e-4 relative. (b) tools/evaluate_pose.main
     scores that checkpoint on a fabricated odometry sequence 09 (8
     PNGs, poses/09.txt), on the card and on the host: finite ATE, equal
     within 1e-4. (c) monocular PoseCNN in "all" mode (the
     velocity-scaled warp), (d) the baseline DepthDecoder (stereo +
     hints): one B=12 train step each, its losses within 1e-4 relative
     of the host's forward on the same weights and batch; the baseline's
     B=12 eval forward, card vs host disparities within 1e-4. (e)
     tools/train_kitti.main trains MobileNetV2 from scratch (stereo +
     hints, 3 steps at B=12). (f) tools/precompute_depth_hints.
     fuse_depths at 1024x320 on 12 seeded candidate maps (SGBM-like:
     the scene's depth times smooth factors, with holes), card vs host:
     equal chosen depths except where the two choices' losses lie within
     1e-5 or within the two sides' own disagreement on them; its time on
     the card. One {"phase": "kitti_pose"} line per check.
 15. kitti_hr_train: the published HR rows' training, stereo + hints at
     1024x320, B=6, on split "chip_hr" of phase 8's mount (18 lines):
     tools/train_kitti.main for 3 steps and one validation batch with
     ResNet18 in float32 and in bf16 mixed precision and with ResNet50
     in float32, every kernel count from 0 just before each run: 5 + 4 K3
     launches per step (5 more for the validation batch), no other
     kernel, float32 checkpoints; "on" vs "off" on one batch (phase 9's
     contract, the argmin-free variant as there; with hints <= 0.5% of
     the pixels' argmins flipped and every flip a near-tie, where phase 9
     holds the losses within 1e-4); K3 vs
     plain on the path's grids (the hints' and a seeded ResNet18's scale
     0 and 3 disparities, both baselines; forward <= 1e-5, gradients
     <= 1e-4 of their peak); ms per step of the three, the first step's
     peak memory, a profile of the two R18 runs (idle share, ATen ops;
     f32: the costliest convs with their cuDNN kernels), K3 per launch
     at (6, 320, 1024, 3)
     against plain, F.grid_sample and the bound; card vs host losses of
     a train-mode forward at B=1 within 1e-4 relative;
 16. visuals: tools/train_kitti.main (640x192, B=12, 3 steps, a log step
     at each) and tools/train_nyu.main (DenseNet161 640x480, B=8, bf16,
     3 steps) each with a recording writer in place of tensorboardX and
     without a writer, at learning rate 0 with cuDNN deterministic (the
     card's backward is not bitwise reproducible, so only frozen weights
     make every logged loss comparable): every image finite in [0, 1],
     the tags tests/test_torch_port_visuals.py pins, and the two runs'
     logged losses and model checkpoints bitwise equal;
 17. soak: tools/soak_kitti.py (the trainer as a subprocess: stereo +
     hints, bf16, B=12, 640x192, --log_frequency 10) on 240 lines of phase
     8's mount (20 steps an epoch), 4 epochs, SIGKILL once epoch 2's
     checkpoint is complete and a relaunch with --auto_resume, memory
     sampled every 0.5 s: every check passes but anon_rss_stable, which
     is printed with the RSS and anonymous-memory peaks and the slope
     after warm-up, not gated;
17b. self_golden: tools/self_golden.py on the soak's newest checkpoint
     (weights_3) and phase 11's 16-frame mount: (a) the eigen eval with
     --eval_stereo --use_wavelets --post_process dense and sparse at 0.02,
     0.05 and 0.1, the operating point nearest 10% density, and the
     checkpoint's forward on the card against the CPU's on the first test
     frame; gated: finite rows, densities in (0, 1] not rising with the
     threshold, the forward within TOL at every scale; JAX's five checks
     and "ok" printed, not gated. (b) servers of that checkpoint
     (tools/infer.load_model) on pallas, pallas2d and compact (compact_cap
     1.0, under xla's masks) answer the 16 frames as one B=16 batch at the
     operating point's threshold, each held to xla under phase 5's
     contract (within TOL, compact away from COMPACT_RING; masks but for
     near ties; xla's total_ops; no overflow), with 12 K1 / 12 K4 / 18 K5
     + 6 K6 launches counted from 0 and no scatter fault; the trained
     masks' density per scale and K1/K4's active granules per conv are
     printed. (c) information only: the B=16 forward dense, xla, pallas,
     pallas2d and compact on those masks;
 18. sparsity: tools/sparsity_sweep.py with random and synthetic weights
     (100 training steps) for KITTI ResNet18 640x192 B=8 in float32 and
     bf16, and NYU DenseNet161 480x640 B=4 in bf16 (10 training steps,
     cut to fit the time), windows of 2 calls: the dense row and thresh
     -1 at density 1.0 with equal GFLOPs, densities falling as the
     threshold rises; the
     same sweep at 64x96 on seeded weights (--weights torch) on the card
     and on the host, densities within 1e-3 and GFLOPs within 1e-6
     relative; tools/profile_model.py once (FLOP counter, analytic
     sweep, a Chrome trace);
 19. native: with g++ and OpenCV's headers and libraries on the machine,
     the native decoder's build, its uint8 feed against the float feed
     (f32 == u8 * float32(1/255) exactly) and tools/evaluate_depth.py
     --native_decode on phase 11's mount and checkpoint on the card and
     on the host (rows within 1e-4), with the two feeds' times; without
     them, --native_decode must raise the port's NativeUnavailable, and
     {"phase": "native", "available": false, "missing": [...]} says what
     was absent;
 20. serving_tools: on phase 11's eigen mount, R18 training checkpoint
     and seeded R50 1024x320 folder, with the six kernels' launch
     counters read before and after (the path is the masked-dense decode
     JAX exports too: none may move). (a) tools/export_serving.main on
     the card, the .pt2 loaded by tools/serve_artifact.load_program and
     held to the direct forward of the same program on the same input:
     KITTI R18 640x192 B=1 dense, sparse 0.1 (total_ops equal) and
     --uint8_input within 1e-4, --bfloat16 within the bf16 bounds of the
     float32 forward; NYU DenseNet161 640x480 B=1 sparse 0.05 within
     1e-4, total_ops equal. (b) an artifact exported from the training
     checkpoint serves a bundle of seeded weights: equal to their direct
     forward within 1e-4. (c) tools/serve_artifact.main over the mount's
     16 test frames (a B=16 artifact of the checkpoint, --bundle_params):
     16 _disp.npy files, each within 1e-4 of the direct forward on the
     same decoded batch; the feed and ms/img. (d) artifact vs direct
     forward, R18 B=1 and B=16 f32 (tools/bench.measure; reported, not
     gated). (e) tools/bench_grid.main, all five configs at B=2 (JAX's
     default 16) and 2 calls per window (9), cut for the time limit, 3
     windows: no row may carry an
     _error key, KITTI densities in 0.09-0.11. (f) tools/profile_device.
     main, R18 640x192 B=16 dense and --threshold 0.2: the printed rows
     sum to the total within 1%, UNATTRIBUTED under 5% of it, the total
     within [0.5, 1.05] of the same forward's CUDA-event time. (g)
     tools/golden_check with no mount (11 absent, exit 0; 1 with
     --require_all) and with WMD_KITTI_DATA / WMD_KITTI_WEIGHTS /
     WMD_KITTI_WEIGHTS_R50_1024 on the mount and folders (each [ OK ] or
     a [FAIL] with its reason, printed); tools/fetch_pretrained --check
     on both folders names resnet18 and resnet50.
 21. ddp: data-parallel training, two ranks on the one card over gloo
     (NCCL refuses two ranks on one device), each a process of its own
     (rank_jobs) running tools/train_kitti.main, then train_nyu.main,
     each with the multi-host flags of its rank and a process group of
     its own, its steps recorded through wrappers (ddp_rank), then phase
     22's forwards: one launch for the three, so the ranks' start-up is
     paid once. KITTI: phase 8's flags (ResNet18 + the wavelet decoder,
     640x192, stereo + hints, --stereo_warp_kernel on) at the global B=12
     (6 rows per rank), 3 steps and one validation batch; K3 launches 5
     forward + 4 backward per rank per step (5 more forward for the
     validation batch), counted from 0 in each rank just before main.
     NYU: DenseNet161 + NyuDecoderWave at 640x480, global B=4 (2 per
     rank), 2 steps, on an 8-frame zip. Against one rank fed the same
     global batches (the ranks' rows in rank order, the same init, the
     KITTI wavelet heads' 3x3 scaled by 0.1 in both as in the CPU parity
     tests, and the same noise generator): each step's losses (and KITTI's validation losses)
     within 1e-4 relative, step 1's averaged gradients within 1e-4 of
     each module's gradient norm, the BN running statistics after step 1
     within 1e-5 of each tensor's norm; the two ranks' parameters after
     the run bitwise equal. Times: ms per step of each rank and of the
     one rank (median after the first step), the gradient all-reduce's
     ms and its share of the step, with the card's name and power limit.
     Then tools/train_kitti.main --data_axis 2 starts its own two ranks
     for one step on a 12-line split. A rank that fails or the launch
     outlasting 300 s fails the phase.
 22. spatial: height-banded inference, the same two rank processes on
     the one card (gloo) after phase 21's training (spatial_rank), KITTI
     R18 at the published HR size, 1024x320, B=1 (seeded weights, a
     seeded image) through parallel/mesh.spatial_forward on each rank's
     160-row band: dense,
     and sparse at threshold 0.05 on xla, pallas (K1), pallas2d (K4) and
     compact (K5/K6, compact_cap 1.0), each with the kernels' counts from
     0 around it, then 3 timed forwards. Against the one-card forward of
     the same weights, image and backend (computed while the ranks run):
     the ranks' full-height outputs bitwise equal; disparities within 1e-5
     (tests/test_spatial.py), or, where float32 under cuDNN's algorithm
     choices for the band shapes cannot hold that, within 3x the floor
     that the same image at B=2 shows against B=1 (both printed); wavelet
     masks equal except at near ties (the one-card forward then rerun
     under the ranks' masks) and total_ops equal. Each kernel case also
     against the one-card xla answer under phase 5's contract: within
     TOL (compact away from COMPACT_RING), masks but for near ties, xla's
     total_ops, no overflow. K1, K4, K5 and K6 launched in each rank as
     often as on one card; no scatter fault in either rank. ms per
     forward of each rank and of one card, information only. Then the
     same ranks run SPATIAL_MODEL_CASES at B=1, one model on the card at
     a time, each case counted once and timed once: NYU at 640x480 on
     240-row bands, in metres (nyu_modules' heads), DenseNet161 +
     NyuDecoderWave (phase 12's seeded model) dense and sparse at 0.05
     on False, True (K1 x4), pallas2d (K4 x2 + K1 x2) and capacity (K1
     x2, capacity_ratio 1.0), MobileNetV2 + NyuDecoderWave dense, sparse
     on False and pallas2d, and its use_polyphase twin dense; the KITTI
     R18 1024x320 weights through polyphase_twin, dense and sparse xla,
     and a seeded baseline DepthDecoder on that encoder, dense. Each held
     to the one-card forward of its model as above (each model's own B=2
     floor; computed after the ranks end: beside phase 21's NYU training
     DenseNet161's left the ranks short of card memory), each kernel
     case also to the one-card masked-dense answer under phase 12's NYU
     contract (masks but for near ties, op counts, every output within
     TOL relative to max(1, max |ref|)), with phase 12's K1 / K4
     launches in each rank and on one card, and none in the other cases.

stdout: one JSON object per line (the card's nvidia-smi line and the
CLIs' progress lines aside); the line before the last is the kernels
summary (K1/K4 with the NYU path's `launches_nyu` and `*_nyu` B=8 sums,
K3 with the M+S run's `launches_kitti_pose` and the 1024x320 B=6 run's
`launches_kitti_hr` and `*_kitti_hr` per-launch times, one rank's
`launches_ddp` of phase 21's two-rank run, K1, K4, K5 and K6 with
one rank's `launches_spatial` of a phase 22 forward, and K1 and K4 with
one rank's `launches_spatial_nyu` over phase 22's NYU DenseNet161 cases and
`launches_spatial_nyu_mbv2` over its MobileNetV2 cases, and K1, K4, K5
and K6 with `launches_self_golden`, phase 17b's B=16 forward on the
soaked checkpoint's own masks) and the last is {"ok": true, "device":
{...}}.

Usage: python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()
H, W = 192, 640
TOL = 1e-4
# (H, W, Cin, Cout, epilogue, mask key, conv) of the 12 kernel launches
# of one sparse forward at 640x192: per scale upconv_i_0, upconv_i_1 and
# the pos and neg heads' 3x3 (same shape)
PATH_CONVS = [
    (12, 40, 256, 128, "elu", (3, "upconv0"), "upconv_3_0"),
    (24, 80, 256, 128, "elu", (3, "upconv1"), "upconv_3_1"),
    (24, 80, 128, 3, "sigmoid", (3, "wavelet"), "waveconv_3_pos/neg"),
    (24, 80, 128, 64, "elu", (2, "upconv0"), "upconv_2_0"),
    (48, 160, 128, 64, "elu", (2, "upconv1"), "upconv_2_1"),
    (48, 160, 64, 3, "sigmoid", (2, "wavelet"), "waveconv_2_pos/neg"),
    (48, 160, 64, 32, "elu", (1, "upconv0"), "upconv_1_0"),
    (96, 320, 96, 32, "elu", (1, "upconv1"), "upconv_1_1"),
    (96, 320, 32, 3, "sigmoid", (1, "wavelet"), "waveconv_1_pos/neg"),
]
# the same 12 launches for KITTI ResNet50 at 1024x320, the largest
# published row: upconv_3_1 and upconv_2_1 take ResNet50's wider skips
# (512 and 256 channels: Cin 128 + 512, 64 + 256)
R50_H, R50_W = 320, 1024
PATH_CONVS_R50 = [
    (20, 64, 256, 128, "elu", (3, "upconv0"), "upconv_3_0"),
    (40, 128, 640, 128, "elu", (3, "upconv1"), "upconv_3_1"),
    (40, 128, 128, 3, "sigmoid", (3, "wavelet"), "waveconv_3_pos/neg"),
    (40, 128, 128, 64, "elu", (2, "upconv0"), "upconv_2_0"),
    (80, 256, 320, 64, "elu", (2, "upconv1"), "upconv_2_1"),
    (80, 256, 64, 3, "sigmoid", (2, "wavelet"), "waveconv_2_pos/neg"),
    (80, 256, 64, 32, "elu", (1, "upconv0"), "upconv_1_0"),
    (160, 512, 96, 32, "elu", (1, "upconv1"), "upconv_1_1"),
    (160, 512, 32, 3, "sigmoid", (1, "wavelet"), "waveconv_1_pos/neg"),
]
KERNELS = {
    "conv3x3_tile_sparse": "wavelet_monodepth_tpu/ops/pallas_conv.py:124",
    "conv3x3_tile_sparse_2d": "wavelet_monodepth_tpu/ops/pallas_conv.py:274",
}
SOURCES = {name: f"wavelet_monodepth_tpu_torch/csrc/{name}.cu"
           for name in ("tile_sparse_conv", "banded_warp", "blockio",
                        "fused_wave_stage")}
WARP_REPLACES = "wavelet_monodepth_tpu/ops/warp.py:205"
BLOCKIO_REPLACES = {"band_gather": "wavelet_monodepth_tpu/ops/blockio.py:82",
                    "block_scatter":
                        "wavelet_monodepth_tpu/ops/blockio.py:129"}
FUSED_REPLACES = "wavelet_monodepth_tpu/ops/pallas_fused.py:182"
COMPACTED = ("compact", "sites", "capacity")
# high-res px at the image border, per disp scale, where "compact" may
# differ from xla: each compacted stage's <= 2 px ring (tiles pad their
# inputs, xla its features), widened by the next stages' convs and
# upsampling and doubled by each IDWT; scale 3 comes from the dense stage
COMPACT_RING = {3: 0, 2: 4, 1: 16, 0: 36}
# the H100 SXM's published peaks (NVIDIA's data sheet): HBM bytes/s,
# float32 FLOP/s outside the tensor cores, and the dense TF32 tensor rate
# over 3: float32 accuracy on the tensor cores in 3xTF32 (three products
# per multiply-add), the tile conv's route
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
TF32X3_FLOPS = 495e12 / 3

_card = {}


def require(ok, what) -> None:
    """A check that holds under `python -O` too."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def emit(obj: dict) -> None:
    """One JSON line; a phase's line also carries "t", the seconds since
    the script started (where the time limit goes)."""
    if "phase" in obj:
        obj = {**obj, "t": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip()


# --- phase 1: device -------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check runs on a CUDA card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    line = card_line()
    print(line, flush=True)
    name, limit = [s.strip() for s in line.split(",")]
    _card.update(card=name, power_limit=limit)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, **_card})
    return torch.device("cuda", 0)


# --- phase 2: build --------------------------------------------------------

def phase_build():
    """Every source, one nvcc each, started together."""
    from wavelet_monodepth_tpu_torch.kernels import build
    from wavelet_monodepth_tpu_torch.ops import blockio as bio
    from wavelet_monodepth_tpu_torch.ops import fused_stage as fs
    from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
    from wavelet_monodepth_tpu_torch.ops import warp
    t0 = time.perf_counter()
    build.load_all(list(SOURCES))
    for module in (tsc, warp, bio, fs):
        module._kernel_lib()
    for name in SOURCES:
        info = build.build_info[name]
        usage = [ln.split("info    :")[-1].strip()
                 for ln in info["ptxas"].splitlines()
                 if "registers" in ln or "spill" in ln]
        emit({"phase": "build", "source": SOURCES[name],
              "nvcc_seconds": info["seconds"], "ptxas": usage})
    emit({"phase": "build", "seconds": time.perf_counter() - t0})


# --- phase 3: kernel vs plain ----------------------------------------------

def edge_stage_masks(batch, seed=0, h=H, w=W):
    """{scale i: stage_masks(...)} of the 10% maskgen operating point, and
    the raw masks, on the CPU."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import sparse as sp
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg
    disp = mg.synthetic_depth_scene(batch, h, w, seed=seed)
    raw, ratio, dens = mg.masks_at_density(disp, 0.10)
    raw = {i: torch.from_numpy(m) for i, m in raw.items()}
    return disp, raw, ratio, dens, {i: sp.stage_masks(m)
                                    for i, m in raw.items()}


def phase_kernel_vs_plain(dev, errs):
    import torch
    from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
    nl = {"none": None, "elu": tsc.elu, "sigmoid": tsc.sigmoid,
          "leaky01": tsc.leaky_relu_01, "leaky02": tsc.leaky_relu_02}
    g = torch.Generator().manual_seed(1)

    def check(case, x, w, b, m, pad, epi):
        ref = tsc.conv3x3_masked_plain(x, w, b, m, pad, nl[epi])
        for key in KERNELS:
            out = getattr(tsc, key)(x, w, b, m, pad, nl[epi])
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            errs[key] = max(errs[key], err)
            emit({"phase": "kernel_vs_plain", "kernel": key, **case,
                  "pad": pad, "nonlin": epi, "max_abs_err": err})
            require(out.dtype == torch.float32 and out.shape == ref.shape,
                    (key, case, out.dtype, tuple(out.shape)))
            require(err <= TOL, (key, case, err))

    def data(n, h, w, cin, cout):
        x = torch.randn(n, h, w, cin, generator=g).to(dev)
        wt = (torch.randn(3, 3, cin, cout, generator=g)
              * (2.0 / (9 * cin)) ** 0.5).to(dev)
        b = (torch.randn(cout, generator=g) * 0.1).to(dev)
        return x, wt, b

    for model, size, convs in (("resnet18", (H, W), PATH_CONVS),
                               ("resnet50", (R50_H, R50_W), PATH_CONVS_R50)):
        for batch in (1, 16):
            _, _, _, _, stage = edge_stage_masks(batch, 0, *size)
            for h, w, cin, cout, epi, (i, mk), conv in convs:
                m = stage[i][mk].to(dev)
                require(m.shape == (batch, h, w, 1), (conv, m.shape))
                check({"model": model, "conv": conv,
                       "shape": [batch, h, w, cin, cout],
                       "mask_density": float(m.mean())},
                      *data(batch, h, w, cin, cout), m, "reflect", epi)
    for cin, cout in ((6, 5), (40, 24)):
        x, w, b = data(2, 20, 72, cin, cout)
        m = (torch.rand(2, 20, 72, 1, generator=g) > 0.9).float().to(dev)
        for pad in ("reflect", "zero", "replicate"):
            for epi in nl:
                check({"case": "modes", "shape": [2, 20, 72, cin, cout]},
                      x, w, b, m, pad, epi)
    for name, h, w in (("all_zero", 16, 128), ("all_one", 16, 128),
                       ("ragged", 13, 70), ("ragged_small", 3, 5)):
        x, wt, b = data(2, h, w, 33, 17)
        if name == "all_zero":
            m = torch.zeros(2, h, w, 1, device=dev)
        elif name == "all_one":
            m = torch.ones(2, h, w, 1, device=dev)
        else:
            m = (torch.rand(2, h, w, 1, generator=g) > 0.5).float().to(dev)
        check({"case": name, "shape": [2, h, w, 33, 17]}, x, wt, b, m,
              "reflect", "elu")
        if name == "all_zero":
            out = tsc.conv3x3_tile_sparse(x, wt, b, m, "reflect", tsc.elu)
            require(not out.any(), "skipped granules must be zero")


# --- phase 4: the serving slice --------------------------------------------

def build_models(dev, seed=0, depth=18):
    import torch
    from wavelet_monodepth_tpu_torch.models.decoders_kitti import \
        KittiWaveletDecoder
    from wavelet_monodepth_tpu_torch.models.layers import init_params
    from wavelet_monodepth_tpu_torch.models.resnet import ResnetEncoder
    gen = torch.Generator().manual_seed(seed)
    enc = init_params(ResnetEncoder(depth), gen)
    dec = init_params(KittiWaveletDecoder(enc.num_ch_enc), gen)
    return enc.to(dev).eval(), dec.to(dev).eval()


def raw_masks_of(out):
    """{scale i: raw (N, h, w, 1) mask} recovered from a sparse output."""
    return {s + 1: out[("wavelet_mask", s)][:, ::2, ::2].contiguous()
            for s in (0, 1, 2)}


def near_tie_reference(ours, ref, thresh, rerun):
    """(the reference to hold `ours` to, mask flips per scale). Where a
    threshold mask of `ours` differs from `ref`'s, the reference reruns
    under ours' masks (`rerun(masks)`), so every scale sees the same
    history, and each of ours' mask pixels must equal that rerun's own
    threshold decision or lie where max |yh| is within 1e-5 of the
    threshold."""
    import torch
    flips = {s: int((ours[("wavelet_mask", s)]
                     != ref[("wavelet_mask", s)]).sum()) for s in range(3)}
    if any(flips.values()):
        raw = raw_masks_of(ours)
        ref = rerun(raw)
        for i in (1, 2, 3):     # scale i thresholds scale i+1's yh
            yl = ref[("wavelets", i - 1, "LL")]
            yh = torch.cat([ref[("wavelets", i, b)]
                            for b in ("LH", "HL", "HH")], -1)
            t = (yl.amax(dim=(1, 2, 3)) - yl.amin(dim=(1, 2, 3))) * thresh
            peak = yh.abs().amax(-1)
            decided = (peak > t[:, None, None]).float()
            margin = (peak - t[:, None, None]).abs()
            require(bool(((raw[i][..., 0] == decided) | (margin < 1e-5))
                         .all()),
                    f"mask differs away from the threshold at scale {i}")
    return ref, flips


def same_answer(ours, ref, thresh, rerun):
    """disp within TOL of the xla answer, masks held to it by
    near_tie_reference."""
    import torch
    ref, flips = near_tie_reference(ours, ref, thresh, rerun)
    err = max(float((ours[("disp", s)] - ref[("disp", s)]).abs().max())
              for s in range(4))
    require(all(bool(torch.isfinite(ours[("disp", s)]).all())
                for s in range(4)), "finite disparity")
    require(err <= TOL, ("disp vs xla", err))
    return err, flips


# each kernel backend's launches for one sparse forward of the KITTI
# wavelet decoder, whatever the batch
BACKEND_LAUNCHES = {"pallas": {"conv3x3_tile_sparse": 12},
                    "pallas2d": {"conv3x3_tile_sparse_2d": 12},
                    "compact": {"band_gather": 18, "block_scatter": 6}}


def backend_vs_xla(out, ref, backend) -> dict:
    """Phase 5's contract for a backend's answer `out` against xla's `ref`
    under the same masks: disp within TOL (compact away from its
    COMPACT_RING), xla's op counts, no overflow ("ok")."""
    import torch
    ring = COMPACT_RING if backend == "compact" else dict.fromkeys(
        range(4), 0)
    gap = max(float(interior(out[("disp", s)] - ref[("disp", s)], ring[s])
                    .abs().max()) for s in range(4))
    overflow = {s: int(out[("overflow", s)]) for s in range(3)
                if ("overflow", s) in out}
    ops_equal = all(torch.equal(out[k], ref[k]) for k in ref
                    if k[0] == "total_ops")
    return {"disp_max_abs_err_vs_xla": gap, "border_ring_px": ring,
            "total_ops_equal": ops_equal, "overflow": overflow,
            "ok": gap <= TOL and ops_equal and not any(overflow.values())}


def phase_slice(dev):
    enc, dec = build_models(dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        launches = serve(dev, enc, dec, tmp)
    return launches, enc, dec


def serve(dev, enc, dec, tmp):
    """The server, its requests and the CLI run, with files under tmp."""
    import numpy as np
    import torch
    from PIL import Image
    from wavelet_monodepth_tpu_torch.ops.sparse import compute_density
    from wavelet_monodepth_tpu_torch.ops import blockio as bio
    from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
    from wavelet_monodepth_tpu_torch.tools import infer
    from wavelet_monodepth_tpu_torch.tools import torch_import as ti
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg

    ckpt = os.path.join(tmp, "weights")
    ti.save_reference_checkpoint(ckpt, enc, dec, H, W)
    imgdir = os.path.join(tmp, "images")
    os.makedirs(imgdir)
    disp = mg.synthetic_depth_scene(4, 375, 1242, seed=7)   # KITTI size
    imgs = (mg.scene_image(disp, seed=7) * 255).astype(np.uint8)
    paths = []
    for k in range(4):
        paths.append(os.path.join(imgdir, f"scene_{k}.png"))
        Image.fromarray(imgs[k]).save(paths[-1])

    argv = ["--image_path", imgdir, "--torch_model_path", ckpt,
            "--use_sparse", "--threshold", "0.1"]
    args = infer.parse_args(argv)
    servers = {}
    for backend in ("pallas", "pallas2d", "xla") + COMPACTED:
        servers[backend], feed = infer.load_model(args, dev, backend)
        require(feed == (H, W), feed)
    # each backend's kernel launches per request
    per_request = {**BACKEND_LAUNCHES, "sites": {}, "capacity": {}}

    def counts():
        return {**tsc.launches, **bio.launches}

    def rerun(x):
        def f(masks):
            with torch.inference_mode():
                return dec(enc(x), thresh_ratio=args.threshold,
                           mask_override=masks)
        return f

    # the main path: every count starts at 0 here and is read right after
    requests = [torch.from_numpy(infer.preprocess_image(p, W, H)[0]).to(dev)
                for p in paths]
    torch.cuda.synchronize()
    tsc.reset_launches()
    bio.reset_launches()
    answers = []
    for x in requests:
        per = {}
        for backend in per_request:
            before = counts()
            per[backend] = servers[backend](x, args.threshold)
            per[backend + "_launches"] = {
                k: v - before[k] for k, v in counts().items()
                if v != before[k]}
        answers.append(per)
    torch.cuda.synchronize()
    launches = counts()

    for k, (x, per) in enumerate(zip(requests, answers)):
        ref = servers["xla"](x, args.threshold)
        for backend, want in per_request.items():
            out = per[backend]
            require(per[backend + "_launches"] == want,
                    ("launches per request", backend,
                     per[backend + "_launches"]))
            require(all(bool(torch.isfinite(out[("disp", s)]).all())
                        for s in range(4)), (backend, "finite disparity"))
            row = {"phase": "slice", "request": k, "backend": backend,
                   "launches": per[backend + "_launches"],
                   "density": float(compute_density(out))}
            overflow = {s: int(out[("overflow", s)]) for s in range(3)
                        if ("overflow", s) in out}
            # an exact backend that dropped nothing must give xla's answer
            if backend != "compact" and not any(overflow.values()):
                err, flips = same_answer(out, ref, args.threshold,
                                         rerun(x))
                row.update(disp_max_abs_err_vs_xla=err, mask_flips=flips)
            emit({**row, "overflow_at_cap_0.5": overflow})
    require(launches == {"conv3x3_tile_sparse": 48,
                         "conv3x3_tile_sparse_2d": 48,
                         "band_gather": 72, "block_scatter": 24}, launches)

    infer.main(argv, device=dev)
    for p in paths:
        stem = os.path.splitext(p)[0]
        need = [stem + "_disp.npy", stem + "_disp.jpeg"] + [
            f"{stem}_scale_{s}_wavelets.npy" for s in range(4)]
        require(all(os.path.isfile(f) for f in need), need)
        d = np.load(stem + "_disp.npy")
        require(d.shape == (1, 1, H, W) and np.isfinite(d).all(),
                ("disp.npy", d.shape))
    emit({"phase": "infer_main", "images": len(paths), "files": "ok"})
    return launches


# --- phase 5: contracts ----------------------------------------------------

def phase_contracts(dev, enc, dec):
    import torch
    from wavelet_monodepth_tpu_torch.ops.sparse import compute_density
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg

    torch.backends.cudnn.deterministic = True
    g = torch.Generator().manual_seed(3)
    x = torch.rand(2, H, W, 3, generator=g).to(dev)
    with torch.inference_mode():
        feats = enc(x)
        dense = dec(feats)
        for backend in (False, "pallas", "pallas2d"):
            sp = dec(feats, thresh_ratio=-1.0, use_pallas=backend)
            err = max(float((sp[("disp", s)] - dense[("disp", s)]).abs()
                            .max()) for s in range(4))
            if backend is False:
                require(all(torch.equal(sp[("disp", s)], dense[("disp", s)])
                            for s in range(4)), "thresh=-1 not bitwise dense")
            require(err <= TOL, (backend, err))
            emit({"phase": "contract_thresh_minus1",
                  "backend": backend or "xla", "max_abs_err": err})
    torch.backends.cudnn.deterministic = False

    disp, raw, ratio, dens, _ = edge_stage_masks(16, seed=0)
    img = torch.from_numpy(mg.scene_image(disp, seed=0)).to(dev)
    mo = {i: m.to(dev) for i, m in raw.items()}
    with torch.inference_mode():
        feats = enc(img)
        ref = dec(feats, thresh_ratio=ratio, mask_override=mo)
        for backend in ("pallas", "pallas2d"):
            out = dec(feats, thresh_ratio=ratio, mask_override=mo,
                      use_pallas=backend)
            err = max(float((out[("disp", s)] - ref[("disp", s)]).abs()
                            .max()) for s in range(4))
            ops_equal = all(torch.equal(out[k], ref[k]) for k in ref
                            if k[0] == "total_ops")
            require(err <= TOL and ops_equal, (backend, err, ops_equal))
            emit({"phase": "contract_operating_point", "batch": 16,
                  "backend": backend, "disp_max_abs_err_vs_xla": err,
                  "total_ops_equal": ops_equal,
                  "density": float(compute_density(out)),
                  "maskgen_density": dens,
                  "mean_total_ops": float(out[("total_ops", -1)].mean())})
        # the compacted backends: exact at compact_cap 1.0 (compact away
        # from its border ring), and what 0.5 drops
        for backend in COMPACTED:
            row = {"phase": "contract_operating_point", "batch": 16,
                   "backend": backend, "maskgen_density": dens}
            for cap in (1.0, 0.5):
                out = dec(feats, thresh_ratio=ratio, mask_override=mo,
                          use_pallas=backend, compact_cap=cap)
                held = backend_vs_xla(out, ref, backend)
                row["border_ring_px"] = held.pop("border_ring_px")
                row[f"cap_{cap}"] = held
                if cap == 1.0:
                    require(held["ok"], (backend, row))
            emit(row)


def phase_contracts_r50(dev):
    """One KITTI ResNet50 1024x320 B=1 request (seeded weights, the 10%
    maskgen masks) on pallas, pallas2d and compact (compact_cap 1.0),
    each held to xla under phase 5's contracts: within TOL (compact away
    from its ring), xla's op counts, no overflow; the conv kernels at
    ResNet50's skip widths, 12 launches each."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import blockio as bio
    from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
    from wavelet_monodepth_tpu_torch.ops.sparse import compute_density
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg

    enc, dec = build_models(dev, seed=5, depth=50)
    disp, raw, ratio, dens, _ = edge_stage_masks(1, 0, R50_H, R50_W)
    img = torch.from_numpy(mg.scene_image(disp, seed=0)).to(dev)
    mo = {i: m.to(dev) for i, m in raw.items()}
    with torch.inference_mode():
        feats = enc(img)
        require([f.shape[-1] for f in feats] == [64, 256, 512, 1024, 2048],
                [tuple(f.shape) for f in feats])
        ref = dec(feats, thresh_ratio=ratio, mask_override=mo)
        for backend, launches in BACKEND_LAUNCHES.items():
            before = {**tsc.launches, **bio.launches}
            out = dec(feats, thresh_ratio=ratio, mask_override=mo,
                      use_pallas=backend, compact_cap=1.0)
            torch.cuda.synchronize()
            got = {k: v - before[k] for k, v in {**tsc.launches,
                                                 **bio.launches}.items()
                   if v != before[k]}
            row = {"phase": "contract_resnet50", "res": [R50_H, R50_W],
                   "batch": 1, "backend": backend, "compact_cap": 1.0,
                   **backend_vs_xla(out, ref, backend), "launches": got,
                   "maskgen_density": dens,
                   "density": float(compute_density(out))}
            require(row["ok"] and got == launches, row)
            emit(row)


# --- phase 5d: polyphase ---------------------------------------------------

POLY_B = 12                    # the published KITTI batch
POLY_THRESH = 0.05
POLY_TOL = 5e-5                # JAX's bound, tests/test_decoders_kitti.py:165
POLY_OPS_RTOL = 1e-6           # tests/test_decoders_kitti.py:176
POLY_NYU_TOL = 2e-5            # JAX's bound, tests/test_decoders_nyu.py:125


def polyphase_twin(dec):
    """`dec` with use_polyphase, on its weights and device."""
    twin = type(dec)(dec.num_ch_enc, use_polyphase=True)
    twin.load_state_dict(dec.state_dict(), strict=True)
    return twin.to(next(dec.parameters()).device).eval()


def disp_max_gap(a: dict, b: dict) -> float:
    return max(float((a[("disp", s)] - b[("disp", s)]).abs().max())
               for s in range(4))


def low_res_convs(prof) -> list:
    """conv_breakdown's rows of the fold's per-phase 2x2 convs, forward
    and backward, with the cuDNN kernels that ran them."""
    return [r for r in conv_breakdown(prof, top=64)
            if any(len(sh) == 4 and sh[-2:] == [2, 2]
                   for sh in r["input_shapes"])]


def phase_polyphase(dev, enc, dec) -> None:
    """use_polyphase on against off (module docstring, phase 5d)."""
    import torch
    from wavelet_monodepth_tpu_torch.models.decoders_nyu import \
        NyuDecoderWave
    from wavelet_monodepth_tpu_torch.models.densenet import \
        DenseNet161Encoder
    from wavelet_monodepth_tpu_torch.models.layers import init_params
    on = polyphase_twin(dec)
    g = torch.Generator().manual_seed(11)
    x = torch.rand(POLY_B, H, W, 3, generator=g).to(dev)
    torch.backends.cudnn.deterministic = True
    with torch.no_grad():       # feats also feed the backward timed below
        feats = enc(x)
        dense_on = on(feats)
        dense_gap = disp_max_gap(dense_on, dec(feats))
        sp_on = on(feats, thresh_ratio=POLY_THRESH)
        ref, flips = near_tie_reference(
            sp_on, dec(feats, thresh_ratio=POLY_THRESH), POLY_THRESH,
            lambda raw: dec(feats, thresh_ratio=POLY_THRESH,
                            mask_override=raw))
        sparse_gap = disp_max_gap(sp_on, ref)
        ops = ref[("total_ops", -1)]
        ops_gap = float(((sp_on[("total_ops", -1)] - ops).abs() / ops).max())
        minus1 = on(feats, thresh_ratio=-1.0)
        identity = all(torch.equal(minus1[k], dense_on[k]) for k in dense_on)
    torch.backends.cudnn.deterministic = False
    emit({"phase": "polyphase", "check": "kitti_r18", "batch": POLY_B,
          "res": [H, W], "dense_disp_gap": dense_gap,
          "sparse_disp_gap": sparse_gap, "thresh": POLY_THRESH,
          "mask_flips": flips, "total_ops_rel_gap": ops_gap,
          "thresh_minus1_sparse_equals_dense_bitwise": identity,
          "tol": POLY_TOL, "ops_rtol": POLY_OPS_RTOL, **_card})
    require(dense_gap <= POLY_TOL, ("polyphase dense", dense_gap))
    require(sparse_gap <= POLY_TOL, ("polyphase sparse", sparse_gap))
    require(ops_gap <= POLY_OPS_RTOL, ("polyphase total_ops", ops_gap))
    require(identity, "polyphase: thresh -1 sparse is not dense bitwise")

    # the decoder alone at B=12, forward and forward + backward (a sum of
    # the disparities), and the cuDNN kernels of the fold's 2x2 convs
    def fwd(m):
        def run():
            with torch.no_grad():
                m(feats)
        return run

    def fwd_bwd(m):
        def run():
            out = m(feats)
            sum(out[("disp", s)].sum() for s in range(4)).backward()
        return run
    timed = time_variants({"forward_off": fwd(dec), "forward_on": fwd(on),
                           "fwd_bwd_off": fwd_bwd(dec),
                           "fwd_bwd_on": fwd_bwd(on)}, iters=10)
    # the plain composition's pick is in phase 10's trace of the train
    # step (upconv_3_1's forward at B=12 as cuDNN's FFT conv)
    prof_on = trace_calls(fwd_bwd(on), 1, shapes=True)[-1]
    for m in (dec, on):
        m.zero_grad(set_to_none=True)
    emit({"phase": "polyphase", "run": "time_decoder", "batch": POLY_B,
          "res": [H, W], "dtype": "float32", "ms": timed,
          "forward_on_over_off": timed["forward_on"]["ms_median"]
          / timed["forward_off"]["ms_median"],
          "fwd_bwd_on_over_off": timed["fwd_bwd_on"]["ms_median"]
          / timed["fwd_bwd_off"]["ms_median"],
          "low_res_convs_on": low_res_convs(prof_on),
          "costliest_convs_on": conv_breakdown(prof_on, top=2), **_card})
    del prof_on, feats

    # NYU: DenseNet161 + NyuDecoderWave at 640x480, B=1, seeded (unscaled
    # heads: JAX's bound is absolute)
    gn = torch.Generator().manual_seed(12)
    nenc = init_params(DenseNet161Encoder(), gn).to(dev).eval()
    ndec = init_params(NyuDecoderWave(nenc.num_ch_enc), gn).to(dev).eval()
    xn = torch.rand(1, NYU_H, NYU_W, 3, generator=gn).to(dev)
    with torch.inference_mode():
        nf = nenc(xn)
        off = ndec(nf)
        nyu_gap = disp_max_gap(polyphase_twin(ndec)(nf), off)
    emit({"phase": "polyphase", "check": "nyu_densenet161", "batch": 1,
          "res": [NYU_H, NYU_W], "dense_disp_gap": nyu_gap,
          "disp_abs_max": max(float(off[("disp", s)].abs().max())
                              for s in range(4)),
          "tol": POLY_NYU_TOL, **_card})
    require(nyu_gap <= POLY_NYU_TOL, ("polyphase NYU dense", nyu_gap))


def interior(t, r: int):
    """t (N, H, W, C) without an r-pixel border."""
    return t[:, r:t.shape[1] - r, r:t.shape[2] - r]


# --- phase 5a: bf16 serving --------------------------------------------------

# tests/test_bf16.py's bounds for bf16 disparity against float32
BF16_DISP_MAX, BF16_DISP_MEAN = 0.05, 0.01
BF16_SERVED = ("xla",) + COMPACTED


def bf16_copies(enc, dec):
    """The full bf16 cast of tools/infer.py --bfloat16, on copies."""
    import copy
    import torch
    from wavelet_monodepth_tpu_torch.utils.precision import cast_floats
    return (cast_floats(copy.deepcopy(enc), torch.bfloat16),
            cast_floats(copy.deepcopy(dec), torch.bfloat16))


def disp_gap(ours, ref, ring=None) -> dict:
    """max and mean |disp| difference per scale (away from ring[s] px)."""
    out = {}
    for s in range(4):
        d = (ours[("disp", s)].float() - ref[("disp", s)].float()).abs()
        d = interior(d, ring[s]) if ring else d
        out[s] = {"max": float(d.max()), "mean": float(d.mean())}
    return out


def phase_bf16_serving(dev, enc, dec):
    """bf16 servers from tools/infer.load_model(--bfloat16) on xla and the
    compacted backends (compact_cap 1.0) answer B=16 and B=1 requests at
    the 10% maskgen operating point: every count starts at 0 just before
    and is read just after. Disparity within BF16_DISP_MAX / _MEAN of the
    float32 server of the same backend on the same weights; op counts
    equal to xla bf16's and no overflow; each compacted backend within
    the same bounds of xla bf16 (compact away from its ring); the
    tile-conv backends raise in bf16, as JAX cannot lower them. Returns
    the bf16 launches."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import blockio as bio
    from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
    from wavelet_monodepth_tpu_torch.tools import infer
    from wavelet_monodepth_tpu_torch.tools import torch_import as ti
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg

    with tempfile.TemporaryDirectory(prefix="chip_smoke_bf16_") as tmp:
        ckpt = os.path.join(tmp, "weights")
        ti.save_reference_checkpoint(ckpt, enc, dec, H, W)
        base = ["--image_path", tmp, "--torch_model_path", ckpt]
        args32 = infer.parse_args(base)
        args16 = infer.parse_args(base + ["--bfloat16"])
        f32 = {b: infer.load_model(args32, dev, b, compact_cap=1.0)[0]
               for b in BF16_SERVED}
        servers = {b: infer.load_model(args16, dev, b, compact_cap=1.0)[0]
                   for b in BF16_SERVED}
        for b in ("pallas", "pallas2d"):
            try:
                infer.load_model(args16, dev, b)
            except NotImplementedError as e:
                emit({"phase": "bf16_serving", "backend": b,
                      "raises": str(e)})
            else:
                require(False, (b, "served bf16"))

    requests = []
    for batch in (16, 1):
        disp, raw, ratio, dens, _ = edge_stage_masks(batch)
        img = torch.from_numpy(mg.scene_image(disp, seed=0)).to(dev)
        requests.append((batch, img, {i: m.to(dev) for i, m in raw.items()},
                         ratio, dens))
    # the bf16 serving path: counts from 0, read right after
    torch.cuda.synchronize()
    tsc.reset_launches()
    bio.reset_launches()
    answers = [{b: servers[b](img, ratio, mask_override=mo)
                for b in BF16_SERVED} for _, img, mo, ratio, _ in requests]
    torch.cuda.synchronize()
    launches = {k + "_bf16": v for k, v in bio.launches_bf16.items()}
    require(launches == {"band_gather_bf16": 18 * len(requests),
                         "block_scatter_bf16": 6 * len(requests)}, launches)
    require(bio.launches == {"band_gather": 18 * len(requests),
                             "block_scatter": 6 * len(requests)}
            and not any(tsc.launches.values()),
            ("other launches in bf16", bio.launches, tsc.launches))

    for (batch, img, mo, ratio, dens), per in zip(requests, answers):
        for b, out in per.items():
            ref32 = f32[b](img, ratio, mask_override=mo)
            require(all(v.dtype != torch.bfloat16 for v in out.values()),
                    (b, "outputs come back float32"))
            require(all(bool(torch.isfinite(out[("disp", s)]).all())
                        for s in range(4)), (b, "finite disparity"))
            vs32 = disp_gap(out, ref32)
            overflow = {s: int(out[("overflow", s)]) for s in range(3)
                        if ("overflow", s) in out}
            ops_equal = all(torch.equal(out[k], per["xla"][k])
                            for k in per["xla"] if k[0] == "total_ops")
            row = {"phase": "bf16_serving", "backend": b, "batch": batch,
                   "compact_cap": 1.0, "maskgen_density": dens,
                   "disp_vs_f32": vs32, "total_ops_equal_xla_bf16":
                   ops_equal, "overflow": overflow}
            require(ops_equal and not any(overflow.values()), row)
            require(all(v["max"] <= BF16_DISP_MAX
                        and v["mean"] <= BF16_DISP_MEAN
                        for v in vs32.values()), row)
            if b != "xla":
                ring = COMPACT_RING if b == "compact" else None
                row["disp_vs_xla_bf16"] = gap = disp_gap(out, per["xla"],
                                                         ring)
                row["border_ring_px"] = ring
                require(all(v["max"] <= BF16_DISP_MAX
                            and v["mean"] <= BF16_DISP_MEAN
                            for v in gap.values()), row)
            emit(row)
    return launches


# --- phase 5b: the block IO kernels (K5, K6) vs plain -----------------------

def record_block_io(run):
    """run() with band_gather / block_scatter recorded: [(name, args,
    out)] in call order, args as the wrapper got them."""
    from wavelet_monodepth_tpu_torch.ops import blockio as bio
    calls = []
    orig = {"band_gather": bio.band_gather,
            "block_scatter": bio.block_scatter}

    def recorder(name):
        def f(*args):
            out = orig[name](*args)
            calls.append((name, args, out))
            return out
        return f

    bio.band_gather = recorder("band_gather")
    bio.block_scatter = recorder("block_scatter")
    try:
        run()
    finally:
        bio.band_gather = orig["band_gather"]
        bio.block_scatter = orig["block_scatter"]
    return calls


def compact_forward(enc, dec, img, raw, ratio, cap=0.5):
    def run():
        import torch
        with torch.inference_mode():
            dec(enc(img), thresh_ratio=ratio, mask_override=raw,
                use_pallas="compact", compact_cap=cap)
    return run


def phase_block_io_vs_plain(dev, enc, dec, errs, dtype):
    """Every gather and scatter of a compact forward at B=16 and B=1 (the
    kernel's own output, recorded on the path, against the plain version
    on the same inputs), then every tile of stacks with odd row widths;
    in `dtype` (enc and dec cast to it), whose errors go to errs[name] for
    float32 and errs[name + "_bf16"] for bfloat16."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import blockio as bio
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg
    plain = {"band_gather": bio.band_gather_plain,
             "block_scatter": bio.block_scatter_plain}
    suffix = "_bf16" if dtype == torch.bfloat16 else ""

    def check(case, name, args, out):
        ref = plain[name](*args)
        torch.cuda.synchronize()
        same = out.shape == ref.shape and torch.equal(out, ref)
        err = float((out - ref).abs().max()) if out.shape == ref.shape \
            else float("inf")
        errs[name + suffix] = max(errs[name + suffix], err)
        require(same and out.dtype == dtype, (name, case, str(dtype), err))
        return err

    for batch in (16, 1):
        disp, raw, ratio, _, _ = edge_stage_masks(batch)
        img = torch.from_numpy(mg.scene_image(disp, seed=0)).to(dev, dtype)
        raw = {i: m.to(dev) for i, m in raw.items()}
        calls = record_block_io(compact_forward(enc, dec, img, raw, ratio))
        names = [c[0] for c in calls]
        require(names.count("band_gather") == 18
                and names.count("block_scatter") == 6, names)
        for k, (name, args, out) in enumerate(calls):
            err = check({"batch": batch, "call": k}, name, args, out)
            emit({"phase": "block_io_vs_plain", "kernel": name,
                  "dtype": str(dtype), "batch": batch, "call": k,
                  "in": list(args[0].shape), "out": list(out.shape),
                  "equal": True, "max_abs_err": err})
        del calls

    # every tile, the last row block included, at windows th, th + 2*halo
    # and 2*th; C = 1 / 3 rows of odd widths take the scalar copies
    g = torch.Generator().manual_seed(5)
    for c, tw, halo in ((64, 16, 2), (1, 16, 1), (1, 17, 1), (3, 7, 0),
                        (1, 9, 2)):
        n, h, w, th = 2, 21, 70, 8
        x = torch.randn(n, h, w, c, generator=g).to(dev, dtype)
        stack = bio.wtile_stack(x, th, tw, halo)
        nh, nw = -(-h // th), -(-w // tw)
        idx = torch.stack(torch.meshgrid(
            torch.arange(n), torch.arange(nh), torch.arange(nw),
            indexing="ij"), -1).reshape(-1, 3)
        idx = idx[torch.randperm(len(idx), generator=g)].to(torch.int32)
        idx = idx.to(dev)
        for window_h in sorted({th, th + 2 * halo, 2 * th}):
            out = bio.band_gather(stack, idx, th, window_h)
            check({"c": c, "tw": tw, "window_h": window_h}, "band_gather",
                  (stack, idx, th, window_h), out)
        vals = torch.randn(len(idx) - 1, th, tw, c, generator=g).to(
            dev, dtype)
        out = bio.block_scatter(vals, idx[1:], n, nh, nw)
        check({"c": c, "tw": tw}, "block_scatter", (vals, idx[1:], n, nh, nw),
              out)
        emit({"phase": "block_io_vs_plain", "case": "every tile",
              "dtype": str(dtype), "c": c, "tw": tw, "halo": halo,
              "equal": True})


def no_scatter_faults(dev, after: str) -> None:
    """The scatter kernel counts idx rows outside the grid or naming a tile
    twice on the card; none may have come since the run began."""
    from wavelet_monodepth_tpu_torch.ops import blockio as bio
    faults = bio.scatter_faults(dev)
    emit({"phase": "scatter_faults", "after": after, "faults": faults})
    require(faults == 0, ("block_scatter faults", after, faults))


def count_syncs(run) -> dict:
    """run() under torch.cuda.set_sync_debug_mode("warn"): its
    synchronising calls, each at the innermost line of this repo on the
    stack, and how many of them came from inside block IO's
    block_scatter."""
    import collections
    import traceback
    import warnings
    import torch
    from wavelet_monodepth_tpu_torch.ops import blockio as bio
    orig, found, in_scatter = bio.block_scatter, [], []

    def on_warning(message, *rest):
        if "synchroniz" in str(message):
            where = [f for f in traceback.extract_stack()[:-1]
                     if f.filename.startswith(REPO + os.sep)][-1]
            found.append(f"{os.path.relpath(where.filename, REPO)}:"
                         f"{where.lineno}")

    def counted(*args):
        before = len(found)
        out = orig(*args)
        in_scatter.append(len(found) - before)
        return out

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = on_warning
        bio.block_scatter = counted
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            bio.block_scatter = orig
    return {"syncs": len(found), "block_scatter_calls": len(in_scatter),
            "syncs_in_block_scatter": sum(in_scatter),
            "where": collections.Counter(found)}


def phase_sync_count(dev, enc, dec) -> None:
    """The synchronising calls of one B=16 compact forward (float32, 10%
    maskgen masks, compact_cap 1.0), after one warm-up forward;
    block_scatter's calls may make none."""
    import torch
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg
    disp, raw, ratio, _, _ = edge_stage_masks(16)
    img = torch.from_numpy(mg.scene_image(disp, seed=0)).to(dev)
    raw = {i: m.to(dev) for i, m in raw.items()}
    run = compact_forward(enc, dec, img, raw, ratio, cap=1.0)
    run()
    torch.cuda.synchronize()
    # the debug mode's own first use, with no forward inside
    idle = count_syncs(lambda: None)
    counts = count_syncs(run)
    emit({"phase": "sync_count", "forward": "compact, B=16, float32, "
          "compact_cap 1.0", **counts, "syncs_with_no_forward": idle})
    require(counts["block_scatter_calls"] == 6
            and counts["syncs_in_block_scatter"] == 0, counts)


# --- phase 5c: the fused wave stage (K2) vs plain and the oracle ------------

FUSED_SCALES = (3, 2, 1)


def stage_inputs(enc, dec, img, raw, ratio):
    """{scale i: (x, skip, yl, mask)} entering scales 3, 2 and 1 of the
    masked-dense (xla) sparse forward under the raw masks: the decoder's
    own stage inputs."""
    import torch
    seen = {}
    hooks = [dec.blocks[f"upconv_{i}_0"].register_forward_pre_hook(
        lambda mod, args, i=i: seen.__setitem__(i, args[0]))
        for i in FUSED_SCALES]
    try:
        with torch.inference_mode():
            feats = enc(img)
            out = dec(feats, thresh_ratio=ratio, mask_override=raw)
    finally:
        for hook in hooks:
            hook.remove()
    return {i: (seen[i], feats[i - 1], out[("wavelets", i - 1, "LL")],
                raw[i]) for i in FUSED_SCALES}


def oracle_stage(dec, i, x, skip, yl, mask):
    """Scale i by masked dense cuDNN convs (ops/sparse.py), as
    tests/test_pallas_fused.py's oracle: (yh, yl_new, x1)."""
    import torch.nn.functional as F
    from wavelet_monodepth_tpu_torch.ops import sparse as sp
    from wavelet_monodepth_tpu_torch.ops.wavelets import haar_idwt
    m = sp.stage_masks(mask)
    c0 = dec.blocks[f"upconv_{i}_0"].conv.conv
    c1 = dec.blocks[f"upconv_{i}_1"].conv.conv
    x0 = sp.masked_conv3x3(x, c0.weight, c0.bias, m["lowres"], m["upconv0"],
                           "reflect", F.elu)
    u = sp.masked_upsample_concat(x0, skip, m["upsample"])
    x1 = sp.masked_conv3x3(u, c1.weight, c1.bias, None, m["upconv1"],
                           "reflect", F.elu)
    heads = []
    for head in ("pos", "neg"):
        wv = dec.blocks[f"waveconv_{i}_{head}"]
        heads.append(sp.masked_waveconv(
            x1, wv[0].conv.weight, wv[0].conv.bias, wv[2].conv.weight,
            wv[2].conv.bias, m["upconv1"], m["wavelet"]))
    yh = (2.0 ** (i - 1)) * (heads[0] - heads[1])
    return yh, haar_idwt(yl, yh[..., 0:1], yh[..., 1:2], yh[..., 2:3]), x1


def fused_plain(x, skip, yl, mask, params, i, ht=8, tw=64):
    from wavelet_monodepth_tpu_torch.ops import fused_stage as fs
    inp = fs._stage_inputs(x, skip, yl, mask, ht, tw)
    return fs.assemble(*fs.fused_wave_stage_plain(inp, params, i, ht, tw),
                       2 * x.shape[1], 2 * x.shape[2])


def fused_inputs(enc, dec, dev, batch):
    """stage_inputs of `batch` maskgen scenes under their 10% masks."""
    import torch
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg
    disp, raw, ratio, _, _ = edge_stage_masks(batch)
    img = torch.from_numpy(mg.scene_image(disp, seed=0)).to(dev)
    raw = {i: m.to(dev) for i, m in raw.items()}
    return stage_inputs(enc, dec, img, raw, ratio)


def phase_fused_stage(dev, enc, dec, errs):
    """K2 driven on the decoder's stage inputs at scales 3, 2, 1, B=16 and
    B=1 (the 10% maskgen masks; counted), then checked against its plain
    version and the oracle's interior, also under all-zero and all-one
    masks (not counted). Returns the counted launches and the stage
    inputs {batch: {scale: (x, skip, yl, mask)}}."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import fused_stage as fs
    ring = {"yh": 2, "yl_new": 4, "x1": 2}
    inputs = {batch: fused_inputs(enc, dec, dev, batch) for batch in (16, 1)}
    runs = []
    torch.cuda.synchronize()
    fs.reset_launches()
    with torch.inference_mode():
        for batch in (16, 1):
            for i, (x, skip, yl, mask) in inputs[batch].items():
                runs.append((batch, i, "maskgen", mask, fs.fused_wave_stage(
                    x, skip, yl, mask, *dec.stage_params(i), i_scale=i)))
    torch.cuda.synchronize()
    launches = fs.launches["fused_wave_stage"]
    require(launches == 2 * len(FUSED_SCALES), launches)
    with torch.inference_mode():
        for batch in (16, 1):
            for i, (x, skip, yl, mask) in inputs[batch].items():
                for kind, m in (("zeros", torch.zeros_like(mask)),
                                ("ones", torch.ones_like(mask))):
                    runs.append((batch, i, kind, m, fs.fused_wave_stage(
                        x, skip, yl, m, *dec.stage_params(i), i_scale=i)))
        for batch, i, kind, mask, ours in runs:
            x, skip, yl, _ = inputs[batch][i]
            params = dec.stage_params(i)
            plain = fused_plain(x, skip, yl, mask, params, i)
            oracle = oracle_stage(dec, i, x, skip, yl, mask)
            row = {"phase": "fused_vs_plain", "batch": batch, "scale": i,
                   "mask": kind, "mask_density": float(mask.mean())}
            for name, o, p, r in zip(ring, ours, plain, oracle):
                require(o.shape == p.shape == r.shape
                        and bool(torch.isfinite(o).all()), (row, name))
                err = float((o - p).abs().max())
                err_oracle = float(interior(o - r, ring[name]).abs().max())
                errs["fused_wave_stage"] = max(errs["fused_wave_stage"], err)
                row[name] = {"max_abs_err": err,
                             "oracle_interior_max_abs_err": err_oracle}
                require(err <= TOL and err_oracle <= TOL, (row, name))
            if kind == "zeros":
                require(not ours[0].any() and not ours[2].any(), row)
            emit(row)
    return launches, inputs


# --- phase 6: times ----------------------------------------------------------

# the host time a timing window of one variant may take: a slow call
# (a train step, an FFT-picked conv) gets fewer calls per window than
# asked, at least one (the script's 1200 s limit)
WINDOW_MS = 150.0


def time_variants(variants: dict, iters: int, windows: int = 3,
                  queue_ahead: bool = False) -> dict:
    """ms per call of each variant: two warm-up calls (the second timed on
    the host), then `windows` windows of up to `iters` calls (as many as
    fit in WINDOW_MS, at least one) timed with CUDA events, interleaved
    (a, b, b, a, ...); "calls_per_window" says how many. queue_ahead:
    each window starts behind a ~10 ms device-side sleep, so the host
    queues all its calls before the card reaches them and the events time
    the device, not the launch overhead (for kernels of tens of
    microseconds)."""
    import torch
    calls = {}
    for k, fn in variants.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        call_ms = (time.perf_counter() - t0) * 1e3
        calls[k] = max(1, min(iters, int(WINDOW_MS / max(call_ms, 1e-3))))
    ms = {k: [] for k in variants}
    order = list(variants)
    for wi in range(windows):
        for k in (order if wi % 2 == 0 else order[::-1]):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if queue_ahead:
                torch.cuda._sleep(20_000_000)
            start.record()
            for _ in range(calls[k]):
                variants[k]()
            end.record()
            end.synchronize()
            ms[k].append(start.elapsed_time(end) / calls[k])
    return {k: {"ms_median": statistics.median(v), "ms_min": min(v),
                "ms_max": max(v), "calls_per_window": calls[k]}
            for k, v in ms.items()}


def conv_bound_ms(m, cin: int, cout: int):
    """(bound ms, bound by, the bound at the f32 CUDA-core rate) of one
    masked 3x3 conv: the least time at float32 accuracy, the FLOPs of its
    active outputs at the 3xTF32 tensor rate or the bytes it must move
    (the input pixels those outputs read, weights, mask, the whole
    output) at HBM rate, whichever takes longer; the third value puts the
    FLOPs at the CUDA cores' f32 peak instead (the bound PRs 1-3 used)."""
    import torch.nn.functional as F
    n, h, w, _ = m.shape
    active = float(m.sum())
    needed = float(F.max_pool2d(m.permute(0, 3, 1, 2), 3, 1, 1).sum())
    flops = 2.0 * 9 * cin * cout * active
    nbytes = 4.0 * (needed * cin + 9 * cin * cout + cout + n * h * w
                    + n * h * w * cout)
    t_ops, t_bytes = flops / TF32X3_FLOPS * 1e3, nbytes / HBM_BPS * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops > t_bytes
            else "bytes", max(flops / F32_FLOPS * 1e3, t_bytes))


def granule_work(m, cin: int, cout: int) -> dict:
    """Per flag mode (K1's 8-row stripes, K4's (8, 64) tiles): the share of
    granules with an active pixel, and the dense conv FLOPs over the
    pixels of those granules (what the kernel computes)."""
    from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
    n, h, w, _ = m.shape
    hp, wp = -(-h // 8) * 8, -(-w // 64) * 64
    out = {}
    for key, flags, shape in (
            ("conv3x3_tile_sparse", tsc.stripe_flags(m, 8), (n, hp // 8, 1)),
            ("conv3x3_tile_sparse_2d", tsc.tile_flags_2d(m, 8, 64),
             (n, hp // 8, wp // 64))):
        f = flags.reshape(shape).float()
        px = f.repeat_interleave(8, 1)[:, :h]
        px = (px.repeat_interleave(64, 2)[:, :, :w] if shape[2] > 1
              else px.expand(n, h, w))
        out[key] = {"active_share": float(f.mean()),
                    "active_flops": 2.0 * 9 * cin * cout * float(px.sum())}
    return out


def phase_times(dev, enc, dec, kernel_ms):
    """Adds to kernel_ms the B=16 per-forward sums (12 launches): kernel,
    plain version, bound and cuDNN's dense F.conv2d at the same shape."""
    import torch
    import torch.nn.functional as F
    from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
    g = torch.Generator().manual_seed(2)
    nl = {"elu": tsc.elu, "sigmoid": tsc.sigmoid}
    bound_by = {"operations": 0.0, "bytes": 0.0}
    for batch in (16, 1):
        disp, raw, ratio, _, stage = edge_stage_masks(batch)
        for h, w, cin, cout, epi, (i, mk), conv in PATH_CONVS:
            x = torch.randn(batch, h, w, cin, generator=g).to(dev)
            wt = (torch.randn(3, 3, cin, cout, generator=g) * 0.05).to(dev)
            b = torch.zeros(cout, device=dev)
            m = stage[i][mk].to(dev)
            x_nchw = x.permute(0, 3, 1, 2).contiguous()
            w_oihw = wt.permute(3, 2, 0, 1).contiguous()
            with torch.inference_mode():
                t = time_variants({
                    "plain": lambda: tsc.conv3x3_masked_plain(
                        x, wt, b, m, "reflect", nl[epi]),
                    "conv3x3_tile_sparse": lambda: tsc.conv3x3_tile_sparse(
                        x, wt, b, m, "reflect", nl[epi]),
                    "conv3x3_tile_sparse_2d":
                        lambda: tsc.conv3x3_tile_sparse_2d(
                            x, wt, b, m, "reflect", nl[epi]),
                    "library_conv2d": lambda: F.conv2d(x_nchw, w_oihw, b,
                                                       padding=1),
                }, iters=20)
            bound, by, bound_f32 = conv_bound_ms(m, cin, cout)
            work = granule_work(m, cin, cout)
            for k in KERNELS:
                work[k]["achieved_tflops"] = (work[k]["active_flops"]
                                              / t[k]["ms_median"] / 1e9)
            reps = 2 if "pos/neg" in conv else 1
            if batch == 16:
                bound_by[by] += reps * bound
                for k in kernel_ms:
                    kernel_ms[k]["ms"] += reps * t[k]["ms_median"]
                    kernel_ms[k]["plain_ms"] += reps * t["plain"]["ms_median"]
                    kernel_ms[k]["bound_ms"] += reps * bound
                    kernel_ms[k]["bound_ms_f32_cuda_cores"] += reps * bound_f32
                    kernel_ms[k]["library_ms"] += (
                        reps * t["library_conv2d"]["ms_median"])
            emit({"phase": "time_conv", "conv": conv, "batch": batch,
                  "shape": [h, w, cin, cout],
                  "mask_density": float(m.mean()),
                  "masked_flops": 2.0 * 9 * cin * cout * float(m.sum()),
                  "bound_ms": bound, "bound_by": by,
                  "bound_ms_f32_cuda_cores": bound_f32, "granules": work,
                  **t, **_card})

        img = torch.rand(batch, H, W, 3, generator=g).to(dev)
        mo = {i: m.to(dev) for i, m in raw.items()}

        def fwd(backend, cap=0.5):
            def f():
                feats = enc(img)
                if backend is None:
                    return dec(feats)
                return dec(feats, thresh_ratio=ratio, mask_override=mo,
                           use_pallas=backend, compact_cap=cap)
            return f

        with torch.inference_mode():
            t = time_variants({"dense": fwd(None), "sparse_xla": fwd(False),
                               "sparse_pallas": fwd("pallas"),
                               "sparse_pallas2d": fwd("pallas2d"),
                               **{f"sparse_{b}": fwd(b) for b in COMPACTED},
                               # at cap 1.0 nothing overflows: xla's answer
                               **{f"sparse_{b}_cap1.0": fwd(b, 1.0)
                                  for b in ("compact", "capacity")}},
                              iters=10 if batch == 16 else 30)
        emit({"phase": "time_forward", "batch": batch, "dtype": "float32",
              "res": [H, W], "mask": "maskgen 10% edge masks",
              "compact_cap": "0.5 unless the name says 1.0",
              **{k: v for k, v in t.items()},
              "fps_median": {k: batch * 1e3 / v["ms_median"]
                             for k, v in t.items()}, **_card})
    for k in kernel_ms:
        kernel_ms[k]["bound_by"] = max(bound_by, key=bound_by.get)


def library_gather(stack, idx, th: int, window_h: int):
    """K5's yardstick: one advanced-indexing gather over an unfold view of
    the stack (windows of window_h rows every th rows)."""
    n, nw, nhp, _, twp, c = stack.shape
    view = stack.reshape(n, nw, nhp * th, twp, c).unfold(
        2, window_h, th).permute(0, 1, 2, 5, 3, 4)
    b, ty, tx = (idx[:, j].long() for j in range(3))
    return lambda: view[b, tx, ty]


def library_scatter(vals, idx, n: int, nh: int, nw: int):
    """K6's yardstick: a zeros canvas and one index_put_ into it, viewed
    as (N, nh, th, nw, tw, C)."""
    k, th, tw, c = vals.shape
    b, ty, tx = (idx[:, j].long() for j in range(3))

    def f():
        canvas = vals.new_zeros((n, nh * th, nw * tw, c))
        canvas.view(n, nh, th, nw, tw, c)[b, ty, :, tx] = vals
        return canvas
    return f


def phase_block_io_times(dev, enc, dec, dtype):
    """K5 and K6 per launch at the 18 + 6 calls of one B=16 compact
    forward (10% maskgen masks, compact_cap 0.5) in `dtype` (enc and dec
    cast to it): the kernel with its output's allocation (K6 writes all of
    its canvas), the plain version and the library call, each call's
    bytes bound; sums per forward."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import blockio as bio
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg
    disp, raw, ratio, _, _ = edge_stage_masks(16)
    img = torch.from_numpy(mg.scene_image(disp, seed=0)).to(dev, dtype)
    size = torch.empty((), dtype=dtype).element_size()
    raw = {i: m.to(dev) for i, m in raw.items()}
    calls = record_block_io(compact_forward(enc, dec, img, raw, ratio))
    sums = {name: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                   "bound_by": "bytes", "library_ms": 0.0}
            for name in ("band_gather", "block_scatter")}
    with torch.inference_mode():
        for k, (name, args, out) in enumerate(calls):
            if name == "band_gather":
                stack, idx, th, window_h = args
                variants = {
                    "kernel": lambda: bio._launch_gather(stack, idx,
                                                         window_h),
                    "plain": lambda: bio.band_gather_plain(*args),
                    "library": library_gather(*args)}
                # the windows read once and written once
                nbytes = size * 2.0 * out.numel() + 4.0 * idx.numel()
            else:
                vals, idx = args[:2]
                variants = {
                    "kernel": lambda: bio._launch_scatter(*args),
                    "plain": lambda: bio.block_scatter_plain(*args),
                    "library": library_scatter(*args)}
                # the tiles read once, the whole canvas written once
                nbytes = (size * (vals.numel() + out.numel())
                          + 4.0 * idx.numel())
            require(torch.equal(variants["library"](), out), (name, k))
            t = time_variants(variants, iters=20, queue_ahead=True)
            bound = nbytes / HBM_BPS * 1e3
            for key, v in (("ms", "kernel"), ("plain_ms", "plain"),
                           ("library_ms", "library")):
                sums[name][key] += t[v]["ms_median"]
            sums[name]["bound_ms"] += bound
            emit({"phase": "time_block_io", "kernel": name, "call": k,
                  "dtype": str(dtype), "batch": 16, "out": list(out.shape),
                  "bytes": nbytes, "bound_ms": bound, **t, **_card})
    emit({"phase": "time_block_io", "dtype": str(dtype),
          "per_forward_sums": sums, **_card})
    return sums


def fused_bound_ms(x, skip, yl, mask, params, flags, ht=8, tw=64):
    """(bound ms, bound by, the bound at the f32 CUDA-core rate) of one
    fused_wave_stage call: the FLOPs of its active tiles' own pixels (no
    halo) at the 3xTF32 tensor rate, or its inputs, parameters and
    outputs (yh, yl_new, x1) once at HBM rate, whichever takes longer; the
    third value puts the FLOPs at the CUDA cores' f32 peak instead."""
    cx, cs, cd = x.shape[-1], skip.shape[-1], params[0].shape[-1]
    active = float(flags.sum())
    hl, wl = ht // 2, tw // 2
    macs = (hl * wl * 9 * cx * cd
            + ht * tw * (9 * (cd + cs) * cd + 2 * cd * cd + 2 * 9 * cd * 3))
    flops = 2.0 * macs * active
    n, hh, wh = skip.shape[:3]
    nbytes = 4.0 * (x.numel() + skip.numel() + yl.numel() + mask.numel()
                    + sum(p.numel() for p in params)
                    + n * hh * wh * (3 + 4 + cd))
    t_ops, t_bytes = flops / TF32X3_FLOPS * 1e3, nbytes / HBM_BPS * 1e3
    return (max(t_ops, t_bytes), "operations" if t_ops > t_bytes
            else "bytes", max(flops / F32_FLOPS * 1e3, t_bytes))


def phase_fused_times(dec, inputs):
    """K2 per scale at B=16 and B=1 on the decoder's stage inputs (10%
    maskgen masks): the bare kernel on the padded inputs, its plain
    version on the same, the whole wrapper; the B=16 sums over the three
    scales (the kernels line) and the B=1 sums."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import fused_stage as fs
    sums = {b: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "bound_ms_f32_cuda_cores": 0.0} for b in inputs}
    by = {"operations": 0.0, "bytes": 0.0}
    with torch.inference_mode():
        for batch, scales in inputs.items():
            for i, (x, skip, yl, mask) in scales.items():
                params = dec.stage_params(i)
                inp = fs._stage_inputs(x, skip, yl, mask, 8, 64)
                t = time_variants({
                    "kernel": lambda: fs._launch(inp, params, i, 8, 64),
                    "plain": lambda: fs.fused_wave_stage_plain(
                        inp, params, i, 8, 64),
                    "wrapper": lambda: fs.fused_wave_stage(
                        x, skip, yl, mask, *params, i_scale=i)},
                    iters=5 if batch == 16 else 20)
                bound, bound_by, bound_f32 = fused_bound_ms(
                    x, skip, yl, mask, params, inp["flags"])
                if batch == 16:
                    by[bound_by] += bound
                for key, v in (("ms", t["kernel"]["ms_median"]),
                               ("plain_ms", t["plain"]["ms_median"]),
                               ("bound_ms", bound),
                               ("bound_ms_f32_cuda_cores", bound_f32)):
                    sums[batch][key] += v
                emit({"phase": "time_fused", "scale": i, "batch": batch,
                      "x": list(x.shape), "skip": list(skip.shape),
                      "tiles": list(inp["flags"].shape),
                      "active_tiles": int(inp["flags"].sum()),
                      "bound_ms": bound, "bound_by": bound_by,
                      "bound_ms_f32_cuda_cores": bound_f32,
                      "bound_share": bound / t["kernel"]["ms_median"],
                      **t, **_card})
    emit({"phase": "time_fused", "sums_by_batch": sums, **_card})
    return {**sums[16], "bound_by": max(by, key=by.get), "library_ms": None}


# --- phase 6b: the bench twin ----------------------------------------------

BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
BENCH_ITERS = 5        # calls per window (the CLI's 10; the time limit)


def phase_bench(dev) -> None:
    """tools/bench.py's cells on the card (its one JSON line, re-emitted
    as {"phase": "bench", ...}): a cell whose windows spread past 10%
    after two re-measurements reports null, which is printed, not
    failed."""
    import contextlib
    import io
    from wavelet_monodepth_tpu_torch.tools import bench
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        result = bench.main(["--iters", str(BENCH_ITERS)], device=dev)
    lines = buf.getvalue().strip().splitlines()
    require(len(lines) == 1 and json.loads(lines[0])
            == json.loads(json.dumps(result)), ("bench output", lines))
    require(set(result) == BENCH_KEYS
            and abs(result["extra"]["density"] - 0.10) < 0.01,
            ("bench result", result))
    emit({"phase": "bench", "seconds": time.perf_counter() - t0, **result})


# --- phase 7: the banded warp (K3), kernel vs plain -------------------------

TRAIN_B = 12
KITTI_FULL = (375, 1242)          # raw KITTI frame (h, w)


def stereo_grid(depth, t_x: float):
    """Normalised (N, H, W, 2) stereo grid of depth (N, H, W, 1) with the
    dataset's intrinsics at depth's size and stereo_T[0, 3] = t_x."""
    import torch
    from wavelet_monodepth_tpu_torch.ops.geometry import (backproject_depth,
                                                         project_3d)
    n, h, w, _ = depth.shape
    k = torch.eye(4, device=depth.device)
    k[0, 0], k[1, 1], k[0, 2], k[1, 2] = 0.58 * w, 1.92 * h, 0.5 * w, 0.5 * h
    k = k.expand(n, 4, 4)
    t = torch.eye(4, device=depth.device).repeat(n, 1, 1)
    t[:, 0, 3] = t_x
    return project_3d(backproject_depth(depth, torch.linalg.inv(k)), k, t,
                      h, w)


def band_offset(grid, valid=None) -> float:
    """max |y(pixel) - row| in pixels (before the border clip), over the
    valid pixels."""
    import torch
    h = grid.shape[1]
    y = ((grid[..., 1] + 1.0) * h - 1.0) * 0.5
    off = (y - torch.arange(h, device=grid.device)[None, :, None]).abs()
    if valid is not None:
        off = off * valid
    return float(off.max())


def warp_cases(dev, models):
    """(name, img, grid) at the shapes the train step gives K3, plus a
    border clamp and ragged small shapes."""
    import torch
    from wavelet_monodepth_tpu_torch.ops.geometry import disp_to_depth
    from wavelet_monodepth_tpu_torch.ops.image import resize_bilinear
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg
    g = torch.Generator().manual_seed(11)
    enc, dec = models
    img = torch.rand(TRAIN_B, H, W, 3, generator=g).to(dev)
    with torch.no_grad():
        out = dec(enc(img))
    cases = []
    for s in (0, 3):                 # a loss scale, upsampled as the step does
        disp = resize_bilinear(out[("disp", s)], H, W)
        depth = disp_to_depth(disp, 0.1, 100.0)[1]
        for t_x in (0.1, -0.1):
            cases.append((f"net_disp{s}_tx{t_x:+}", img,
                          stereo_grid(depth, t_x)))
    scene = torch.from_numpy(mg.synthetic_depth_scene(
        TRAIN_B, H, W, seed=3)).to(dev)
    depth = 0.58 * W * 0.1 / (1.0 + scene * 0.03 * W)
    for t_x in (0.1, -0.1):
        cases.append((f"maskgen_scene_tx{t_x:+}", img,
                      stereo_grid(depth, t_x)))
    rows = ((torch.arange(H, device=dev) + 0.5) / H * 2.0 - 1.0)
    u = torch.full((TRAIN_B, H, W), 3.0, device=dev)
    u[::2, :, : W // 2] = -2.5
    cases.append(("border_clamp", img, torch.stack(
        [u, rows[None, :, None].expand(TRAIN_B, H, W)], -1)))
    for h, w in ((2, 70), (3, 96), (3, 70), (2, 96)):
        d = (torch.rand(2, h, w, 1, generator=g) * 30 + 1).to(dev)
        cases.append((f"ragged_{h}x{w}", torch.rand(2, h, w, 3, generator=g)
                      .to(dev), stereo_grid(d, 0.1)))
    return cases


def phase_warp_vs_plain(dev, models, errs):
    """Forward within 1e-5 and the three gradients within 1e-4 of their
    largest value (shared-memory atomics sum in a varying order), with and
    without the source-row pass; the path's grids must be row-banded."""
    import torch
    g = torch.Generator().manual_seed(12)
    for name, img, grid in warp_cases(dev, models):
        check_warp_case(name, img, grid, errs, g,
                        banded=not name.startswith(("border", "ragged")))


def check_warp_case(name, img, grid, errs, g, banded=True, valid=None,
                    phase="warp_vs_plain") -> None:
    """K3 against its plain version on one (img, grid): forward within
    1e-5, the gradients for src, x and yr within 1e-4 of their largest
    value, with and without the source-row pass; banded grids must stay
    within one row of their own (over the `valid` pixels)."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import warp
    dev = img.device
    n, h, w, c = img.shape
    if banded:
        off = band_offset(grid, valid)
        require(off <= 1.0, (name, "not row-banded", off))
    x, yr = warp.banded_coords(grid, h, w)
    gout = torch.randn(img.shape, generator=g).to(dev)
    for with_src in (True, False):
        res = {}
        for kind, fn in (("kernel", warp.BandedWarp.apply),
                         ("plain", warp.banded_warp_plain)):
            src = img.clone().requires_grad_(with_src)
            xa = x.clone().requires_grad_()
            ya = yr.clone().requires_grad_()
            out = fn(src, xa, ya)
            out.backward(gout)
            res[kind] = {"out": out.detach(), "gx": xa.grad,
                         "gyr": ya.grad}
            if with_src:
                res[kind]["gsrc"] = src.grad
        torch.cuda.synchronize()
        fwd_err = float((res["kernel"]["out"] - res["plain"]["out"])
                        .abs().max())
        grad_abs, grad_rel = {}, {}
        for k in res["plain"]:
            if k == "out":
                continue
            d = (res["kernel"][k] - res["plain"][k]).abs().max()
            grad_abs[k] = float(d)
            grad_rel[k] = float(d / res["plain"][k].abs().max()
                                .clamp_min(1e-30))
        require(fwd_err <= 1e-5, (name, "forward", fwd_err))
        require(all(v <= 1e-4 for v in grad_rel.values()),
                (name, "gradients", grad_rel))
        errs["banded_warp_fwd"] = max(errs["banded_warp_fwd"], fwd_err)
        errs["banded_warp_bwd"] = max(errs["banded_warp_bwd"],
                                      *grad_abs.values())
        emit({"phase": phase, "case": name,
              "shape": [n, h, w, c], "with_src_grad": with_src,
              "fwd_max_abs_err": fwd_err, "grad_max_abs_err": grad_abs,
              "grad_max_rel_err": grad_rel})


# --- phase 8: the training slice ---------------------------------------------

FOLDER = "2011_09_26/2011_09_26_drive_0001_sync"


def write_kitti_mount(root: str, n: int, n_val: int, seed: int = 0) -> None:
    """A raw-KITTI-layout mount: n stereo pairs at 1242x375 JPEG made from
    maskgen scenes, the right view shifted by the scene's disparity
    (right(x) = left(x + d)), depth hints (.npy, (1, H, W)) in the same
    units as stereo_T's 0.1 baseline, invalid at the top rows and the
    right border columns, and a split "chip" (val = the first n_val
    lines)."""
    import numpy as np
    from PIL import Image
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg
    h, w = KITTI_FULL
    disp = mg.synthetic_depth_scene(n, h, w, seed=seed)[..., 0]
    left = (mg.scene_image(disp[..., None], seed=seed) * 255).astype(
        np.uint8)
    d_px = 1.0 + disp * 0.03 * w
    for side in ("02", "03"):
        os.makedirs(os.path.join(root, FOLDER, f"image_{side}", "data"))
        os.makedirs(os.path.join(root, "depth_hints", FOLDER,
                                 f"image_{side}"))
    lines = []
    for k in range(n):
        side = "l" if k % 2 == 0 else "r"
        src_x = np.clip(np.round(np.arange(w)[None] + d_px[k]).astype(int),
                        0, w - 1)
        right = np.take_along_axis(left[k], src_x[..., None].repeat(3, -1),
                                   axis=1)
        for sd, im in (("02", left[k]), ("03", right)):
            Image.fromarray(im).save(os.path.join(
                root, FOLDER, f"image_{sd}", "data", f"{k:010d}.jpg"),
                quality=92)
        depth = (0.58 * w * 0.1 / d_px[k]).astype(np.float32)
        depth[: h // 10] = 0.0
        depth[:, -(w // 25):] = 0.0
        np.save(os.path.join(root, "depth_hints", FOLDER,
                             "image_02" if side == "l" else "image_03",
                             f"{k:010d}.npy"), depth[None])
        lines.append(f"{FOLDER} {k} {side}")
    split = os.path.join(root, "splits", "chip")
    os.makedirs(split)
    with open(os.path.join(split, "train_files.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(split, "val_files.txt"), "w") as f:
        f.write("\n".join(lines[:n_val]) + "\n")


def train_argv(root: str, log: str, kern: str = "on", batch=TRAIN_B,
               hints: bool = True):
    """The flagship's flags (stereo + depth hints); hints=False gives the
    argmin-free variant: stereo without hints or automasking."""
    return ["--data_path", root, "--split", "chip", "--log_dir", log,
            "--batch_size", str(batch), "--height", str(H), "--width",
            str(W), "--use_stereo", "--frame_ids", "0", "--use_wavelets",
            "--weights_init", "scratch", "--stereo_warp_kernel", kern,
            "--num_epochs", "1", "--log_frequency", "250",
            "--num_workers", "4"] + (
                ["--use_depth_hints"] if hints else ["--disable_automasking"])


def no_writer():
    """A SummaryLogger without writers (tensorboardX's or any)."""
    from wavelet_monodepth_tpu_torch.utils.logging import SummaryLogger
    return SummaryLogger("unused", writers={})


def float_dtypes_of(*paths) -> list:
    """The float dtypes of the tensors saved in checkpoint files (a state
    dict, or an optimizer's, whose moments sit under "state")."""
    import torch
    dtypes = set()
    for f in paths:
        sd = torch.load(f, map_location="cpu", weights_only=True)
        flat = list(sd["state"].values()) if "state" in sd else [sd]
        dtypes |= {str(v.dtype) for d in flat for v in d.values()
                   if torch.is_tensor(v) and v.is_floating_point()}
    return sorted(dtypes)


def phase_train_slice(dev, root: str, log: str, bf16: bool = False):
    """tools/train_kitti.main for one epoch (3 steps at B=12, one
    validation batch on the first log step), then tools/infer serves the
    checkpoint it wrote. Every K3 count starts at 0 just before main.
    bf16: with --bfloat16 (mixed precision), whose checkpoint must hold
    float32 parameters, BN statistics and Adam moments."""
    import numpy as np
    import torch
    from wavelet_monodepth_tpu_torch.ops import warp
    from wavelet_monodepth_tpu_torch.tools import infer, train_kitti

    torch.cuda.synchronize()
    warp.reset_launches()
    t0 = time.perf_counter()
    # without a TensorBoard writer: the visuals phase runs the writer's
    # extra forward (5 more forward warps per log step)
    summary = train_kitti.main(train_argv(root, log)
                               + (["--bfloat16"] if bf16 else []), device=dev,
                               logger=no_writer())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(warp.launches)
    steps, vals = summary["steps"], summary["val_batches"]
    require(steps == 3 and vals == 1, summary)
    require(all(np.isfinite(v) for d in summary["losses"] for v in d.values()),
            ("finite losses", summary["losses"]))
    # each step: 4 loss scales + the hint warp forward, the 4 scale warps
    # backward (the hint warp's inputs need no gradient); validation runs
    # the forward warps once more
    require(launches == {"banded_warp_fwd": 5 * (steps + vals),
                         "banded_warp_bwd": 4 * steps}, launches)
    folder = summary["checkpoints"][-1]
    need = [os.path.join(folder, f) for f in ("encoder.pth", "depth.pth",
                                              "adam.pth")]
    require(all(os.path.isfile(f) for f in need), need)
    dtypes = float_dtypes_of(*need)
    require(dtypes == ["torch.float32"], ("checkpoint dtypes", dtypes))
    grid_cols_off = None
    if bf16:
        # JAX's fault, reproduced: the backprojection grid in depth's dtype
        from wavelet_monodepth_tpu_torch.ops.geometry import \
            backproject_depth
        pts = backproject_depth(torch.ones(1, 1, W, 1, device=dev,
                                           dtype=torch.bfloat16),
                                torch.eye(4, device=dev)[None])
        off = (pts[0, 0] - torch.arange(W, device=dev)).abs()
        grid_cols_off = {"columns": int((off > 0).sum()),
                         "max_px": float(off.max())}
    emit({"phase": "train_main", "steps": steps, "val_batches": vals,
          "batch": TRAIN_B, "res": [H, W], "stereo_warp_kernel": "on",
          "bfloat16": bf16, "checkpoint_float_dtypes": dtypes,
          "bf16_backprojection_grid_off": grid_cols_off,
          "launches": launches, "seconds_incl_load_and_init": seconds,
          "losses": summary["losses"], "checkpoint": folder})

    args = infer.parse_args(["--image_path", root, "--torch_model_path",
                             folder, "--use_sparse", "--threshold", "0.1"])
    forward, feed = infer.load_model(args, dev, "pallas2d")
    require(feed == (H, W), feed)
    x, _ = infer.preprocess_image(os.path.join(
        root, FOLDER, "image_02", "data", f"{0:010d}.jpg"), W, H)
    out = forward(torch.from_numpy(x).to(dev), args.threshold)
    d = out[("disp", 0)]
    require(d.shape == (1, H, W, 1) and bool(torch.isfinite(d).all()),
            ("served disp", tuple(d.shape)))
    emit({"phase": "serve_trained_checkpoint", "disp_mean": float(d.mean())})
    return launches, folder


# --- phase 9: train contracts ------------------------------------------------

def loader_batch(root: str, dev, batch: int = TRAIN_B, seed: int = 0,
                 is_train: bool = True, size=(H, W), split: str = "chip"):
    """One batch of the mount through the port's dataset and loader, on
    the card."""
    from wavelet_monodepth_tpu_torch.data import kitti as kd
    from wavelet_monodepth_tpu_torch.data.loader import (parallel_batches,
                                                        to_device)
    from wavelet_monodepth_tpu_torch.data.splits import read_split
    lines = read_split(split, "train_files.txt", root)
    ds = kd.KittiRawDataset(root, lines, *size, [0, "s"], [0, 1, 2, 3],
                            is_train=is_train, use_depth_hints=True,
                            aug_scales=(0,), other_frame_scales=(0,),
                            device_augment=True)
    stream = parallel_batches(ds, batch, num_workers=4, seed=seed)
    try:
        return next(to_device(stream, dev))
    finally:
        stream.close()


def conditioned_state(setup, seed: int = 0):
    """Fresh seeded weights with the wavelet heads' 3x3 convs scaled by
    0.1, so no disparity reaches the clamp at 0, where
    depth = 1 / (0.01 + 9.99 disp) turns float32 rounding into 1e5-fold
    larger gradients (the CPU parity tests use the same conditioning)."""
    import torch
    state = setup.init_state(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, block in state.decoder.blocks.items():
            if "_pos" in name or "_neg" in name:
                block[2].conv.weight.mul_(0.1)
                block[2].conv.bias.mul_(0.1)
    return state


def grads_of(setup, state, batch, noise):
    """(losses, {param name: grad}, outputs) of one forward/backward, no
    update; outputs keeps the warped images and the argmin masks."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import augment
    state.optimizer.zero_grad(set_to_none=True)
    outputs, losses = setup.forward(state, augment.expand_batch(batch),
                                    noise, train=True)
    losses["loss"].backward()
    torch.cuda.synchronize()
    keep = {k: v.detach() for k, v in outputs.items()
            if k[0] in ("color", "color_depth_hint", "depth_hint_pixels",
                        "identity_selection")}
    return ({k: float(v) for k, v in losses.items()},
            {f"{p}.{n}": prm.grad.clone() for p, m in
             (("encoder", state.encoder), ("depth", state.decoder))
             for n, prm in m.named_parameters()}, keep)


def rel_norms(a: dict, b: dict) -> dict:
    return {k: float((a[k] - b[k]).norm() / b[k].norm().clamp_min(1e-30))
            for k in b}


def on_vs_off(dev, root: str, batch, hints: bool, argv_of=None,
              reruns: bool = True) -> dict:
    """Losses, gradients and outputs of "on" and "off" (and, with reruns,
    a rerun of each, for the run-to-run noise) on one batch and one set of
    weights. argv_of(kern, hints): the training flags (the flagship's by
    default)."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import warp
    from wavelet_monodepth_tpu_torch.train.kitti import KittiTrainSetup
    from wavelet_monodepth_tpu_torch.utils.config import parse_kitti_args
    if argv_of is None:
        def argv_of(kern, hints):
            return train_argv(root, "unused", kern, hints=hints)
    runs = {}
    torch.backends.cudnn.deterministic = True
    for run in ("on", "off") + (("on2", "off2") if reruns else ()):
        kern = "on" if run.startswith("on") else "off"
        opts = parse_kitti_args(argv_of(kern, hints))
        setup = KittiTrainSetup(opts, steps_per_epoch=3, device=dev)
        state = conditioned_state(setup)
        noise = torch.Generator(device=dev).manual_seed(5)
        warp.reset_launches()
        runs[run] = grads_of(setup, state, batch, noise)
        runs[run + "_launches"] = dict(warp.launches)
    torch.backends.cudnn.deterministic = False
    return runs


def phase_train_contracts(dev, root: str):
    """"on" vs "off" on one batch and one set of weights, and the
    learning twin.

    The flagship loss (hints + automasking) takes elementwise argmins
    between warped images; "on" and "off" warp differently by the per-row
    vs per-pixel y (~1e-5), so ~0.1% of the argmin decisions flip and the
    two are held to that: flips <= 0.5% of pixels, losses within 1e-4
    relative; one step launches K3 exactly 5 times forward and 4 backward.
    Without hints and automasking (no argmin) the two are the same smooth
    function: losses within 1e-5, every gradient within 1e-3 of its norm
    (reruns of one variant agree to ~1e-5)."""
    # No flips and a positive baseline for every item: each warp then
    # clamps at the right border, where the hints are invalid. Where the
    # predicted-depth warp and the hint warp clamp to the same border
    # pixel, reproj and hint-reproj tie exactly and the argmin follows
    # rounding; and a hint invalid at column 0 would give its whole row
    # K3's per-row y of an invalid pixel (the JAX kernel's semantics,
    # ROADMAP.md Queue 3), which the gather does not share.
    batch = loader_batch(root, dev, is_train=False)
    batch[("stereo_T",)][:, 0, 3] = 0.1
    for hints in (True, False):
        check_on_vs_off(on_vs_off(dev, root, batch, hints), batch, hints)

    for bf16 in (False, True):
        hints, dtypes = learning_contract(dev, bf16=bf16)
        emit({"phase": "contract_learns", "batch": 4, "steps": 30,
              "bfloat16": bf16, "hint_loss_first": hints[0],
              "hint_loss_last": hints[-1], "state_float_dtypes": dtypes})
        require(all(v == v for v in hints) and hints[-1] <= 0.85 * hints[0],
                ("hint loss did not fall 15%", bf16, hints[0], hints[-1]))
        require(dtypes == ["torch.float32"], ("state dtypes", dtypes))
    return batch


def flip_ties(batch, runs: dict, seed: int = 5) -> dict:
    """Per loss scale, the pixels whose argmin over [reproj, identity +
    noise, hint reproj] differs between on_vs_off's "on" and "off" runs
    (stereo + hints; the noise redrawn from the runs' seed), and how many
    of them are not near-ties: in each run the other run's choice must lie
    within 1e-5 of its own, or within the two runs' own disagreement on
    those two candidates there. `mask_mismatch` counts pixels where the
    recomputed choice differs from the run's recorded masks (0 when the
    recomputation is the loss's)."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import augment
    from wavelet_monodepth_tpu_torch.train import losses_kitti as lk
    inputs = augment.expand_batch(batch)
    target = inputs[("color", "0", 0)]
    hint_valid = 1000.0 * (1.0 - inputs[("depth_hint_mask",)])
    gen = torch.Generator(device=target.device).manual_seed(seed)
    ident = lk.compute_reprojection_loss(inputs[("color", "s", 0)], target)

    def take(c, a):
        return c.gather(-1, a)[..., 0]
    out = {}
    for scale in range(4):
        ident_s = ident + lk._automask_noise(gen, scale, ident)
        cand, mismatch = {}, 0
        for run in ("on", "off"):
            o = runs[run][2]
            c = torch.cat([
                lk.compute_reprojection_loss(o[("color", "s", scale)],
                                             target),
                ident_s,
                lk.compute_reprojection_loss(
                    o[("color_depth_hint", "s", 0)], target) + hint_valid],
                dim=-1)
            choice = c.argmin(dim=-1, keepdim=True)
            mismatch += int(((choice == 2).float()
                             != o[("depth_hint_pixels", scale)]).sum())
            cand[run] = (c, choice)
        (c_on, a_on), (c_off, a_off) = cand["on"], cand["off"]
        flipped = (a_on != a_off)[..., 0]
        # the two runs' disagreement on the two candidates chosen
        noise = ((take(c_on, a_on) - take(c_off, a_on)).abs()
                 + (take(c_on, a_off) - take(c_off, a_off)).abs())
        gap = torch.maximum(take(c_on, a_off) - take(c_on, a_on),
                            take(c_off, a_on) - take(c_off, a_off))
        tie = (gap <= 1e-5) | (gap <= noise)
        out[scale] = {"flips": int(flipped.sum()),
                      "not_tie": int((flipped & ~tie).sum()),
                      "mask_mismatch": mismatch,
                      "gap_max_at_flips": float(gap[flipped].max())
                      if flipped.any() else 0.0,
                      "noise_max_at_flips": float(noise[flipped].max())
                      if flipped.any() else 0.0}
    return out


def check_on_vs_off(runs: dict, batch, hints: bool,
                    phase: str = "contract_on_vs_off",
                    hint_losses_within: bool = True, **extra) -> None:
    """The on/off contract on on_vs_off's runs (phase_train_contracts).
    With hints, hint_losses_within=False replaces "losses within 1e-4
    relative" by "every argmin flip a near-tie" (flip_ties): the hint
    term of each flipped pixel moves the loss by its whole log-depth
    error, so the losses' gap measures how the flips fall, not the warps
    (1024x320: 3.4e-4 from 0.08% of the pixels)."""
    valid = batch[("depth_hint",)] > 0
    want = {"banded_warp_fwd": 5 if hints else 4, "banded_warp_bwd": 4}
    require(runs["on_launches"] == want, runs["on_launches"])
    require(not any(runs["off_launches"].values()),
            runs["off_launches"])
    (l_on, g_on, o_on), (l_off, g_off, o_off) = runs["on"], runs["off"]
    img_err = {str(k): float(((o_on[k] - o_off[k]).abs()
                              * (valid if k[0] == "color_depth_hint"
                                 else 1.0)).max())
               for k in o_off if k[0].startswith("color")}
    flips = {str(k): int((o_on[k] != o_off[k]).sum()) for k in o_off
             if not k[0].startswith("color")}
    loss_rel = {k: abs(l_on[k] - l_off[k]) / max(abs(l_off[k]), 1e-30)
                for k in l_on}
    loss_abs = max(abs(l_on[k] - l_off[k]) for k in l_on)
    rel = rel_norms(g_on, g_off)
    worst = max(rel, key=rel.get)
    ties = flip_ties(batch, runs) if hints else None
    emit({"phase": phase, "flip_ties": ties,
          "config": "stereo+hints" if hints
                    else "stereo, no hints, no automasking",
          "batch": int(valid.shape[0]), "res": list(valid.shape[1:3]),
          "warped_max_abs_diff": img_err,
          "mask_flips": flips, "pixels": int(valid.numel()),
          "loss_max_abs_diff": loss_abs,
          "loss_max_rel_diff": max(loss_rel.values()),
          "grad_max_rel_norm_diff": rel[worst], "worst_tensor": worst,
          "grad_rel_norm_on_rerun": max(rel_norms(runs["on2"][1],
                                                  g_on).values())
          if "on2" in runs else None,
          "grad_rel_norm_off_rerun": max(rel_norms(runs["off2"][1],
                                                   g_off).values())
          if "off2" in runs else None,
          "launches_per_step_on": runs["on_launches"],
          "losses_on": l_on, **extra, **_card})
    if hints:
        require(max(flips.values()) <= 0.005 * valid.numel(), flips)
        if hint_losses_within:
            require(max(loss_rel.values()) <= 1e-4, ("losses", loss_rel))
        else:
            require(all(t["not_tie"] == 0 and t["mask_mismatch"] == 0
                        for t in ties.values()), ("flips not ties", ties))
    else:
        require(loss_abs <= 1e-5, ("on vs off losses", loss_abs))
        require(rel[worst] <= 1e-3, ("on vs off gradients", worst,
                                     rel[worst]))


def twin_batch(dev, n: int = 4, shift: int = round(4 * W / 96)):
    """tests/test_training_learns.py's scene at full size: n smoothed
    random textures, the right view shifted by the test's 4 px at 96 wide
    scaled to this width (so the depth, fx * 0.1 / shift, is the test's),
    stereo_T[0, 3] = -0.1, that depth as the hint, every scale from
    area-resizing."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(0)
    tex = torch.rand(n, 3, H, 2 * W, generator=g)
    for _ in range(2):
        tex = (tex + tex.roll(1, 2) + tex.roll(1, 3)) / 3.0
    views = {"0": tex[..., :W], "s": tex[..., shift:shift + W]}
    batch = {}
    for s in range(4):
        h, w = H // 2 ** s, W // 2 ** s
        for fid, v in views.items():
            im = F.interpolate(v, size=(h, w), mode="area") if s else v
            batch[("color", fid, s)] = im.permute(0, 2, 3, 1).contiguous()
            batch[("color_aug", fid, s)] = batch[("color", fid, s)]
        k = torch.eye(4)
        k[0, 0], k[1, 1], k[0, 2], k[1, 2] = 0.58 * w, 1.92 * h, w / 2, h / 2
        batch[("K", s)] = k.expand(n, 4, 4).contiguous()
        batch[("inv_K", s)] = torch.linalg.inv(batch[("K", s)])
    t = torch.eye(4).repeat(n, 1, 1)
    t[:, 0, 3] = -0.1
    batch[("stereo_T",)] = t
    batch[("depth_hint",)] = torch.full((n, H, W, 1), 0.58 * W * 0.1 / shift)
    batch[("depth_hint_mask",)] = torch.ones(n, H, W, 1)
    return {k: v.to(dev) for k, v in batch.items()}


def learning_contract(dev, steps: int = 30, bf16: bool = False):
    """Hint loss per step of the learning twin (B=4, "on", lr 1e-4;
    bf16: mixed precision), and the float dtypes of the parameters, BN
    buffers and Adam moments after the steps."""
    import torch
    from wavelet_monodepth_tpu_torch.train.kitti import KittiTrainSetup
    from wavelet_monodepth_tpu_torch.utils.config import parse_kitti_args
    opts = parse_kitti_args(train_argv("unused", "unused", "on", batch=4)
                            + (["--bfloat16"] if bf16 else []))
    setup = KittiTrainSetup(opts, steps_per_epoch=1000, device=dev)
    state = setup.init_state(torch.Generator().manual_seed(0))
    noise = torch.Generator(device=dev).manual_seed(0)
    batch = twin_batch(dev)
    hints = [float(setup.train_step(state, batch, noise)
                   ["depth_hint_loss/0"]) for _ in range(steps)]
    return hints, state_float_dtypes(state)


def state_float_dtypes(state) -> list:
    """The float dtypes of a train state's parameters, buffers (BN
    statistics) and Adam moments."""
    import torch
    tensors = [t for m in (state.encoder, state.decoder)
               for t in list(m.parameters()) + list(m.buffers())]
    tensors += [v for d in state.optimizer.state.values()
                for v in d.values() if torch.is_tensor(v)]
    return sorted({str(t.dtype) for t in tensors if t.is_floating_point()})


# --- phase 10: training times ------------------------------------------------

def warp_bound_ms(n, h, w, c, backward: bool, with_src: bool) -> float:
    """Bytes the warp must move (each input read once, each output written
    once) at HBM rate; its ~10 flops per output value are negligible."""
    img, pix, rows = n * h * w * c, n * h * w, n * h
    if not backward:
        nbytes = 4 * (img + pix + rows + img)          # src, x, yr -> out
    else:                                  # g, src, x, yr -> gx, gyr (gsrc)
        nbytes = 4 * (img + img + pix + rows + pix + rows
                      + (img if with_src else 0))
    return nbytes / HBM_BPS * 1e3


def time_backward(out, inputs, g):
    """A call that runs only the backward of `out` (graph kept)."""
    import torch
    return lambda: torch.autograd.grad(out, inputs, g, retain_graph=True)


def trace_calls(fn, calls: int, shapes: bool = False):
    """fn() `calls` times in one torch.profiler trace (its own overhead
    lengthens the wall; shapes: input shapes recorded too, for
    costliest_convs / conv_breakdown of the same trace, which lengthens it
    more): (device spans sorted, {kernel: [launches, us]}, {innermost ATen
    op: [us, kernels]}, busy us, wall ms, the profile)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=shapes) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans, by_kernel, by_op = [], {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            k = by_kernel.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.end - e.time_range.start
        elif e.kernels:
            row = by_op.setdefault(e.name, [0.0, 0])
            row[0] += sum(k.duration for k in e.kernels)
            row[1] += len(e.kernels)
    spans.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return spans, by_kernel, by_op, busy, wall_ms, prof


def profile_forwards(enc, dec, dev, encb, decb) -> None:
    """Device busy time, idle share, costliest kernels and ATen ops per
    B=16 forward of each compacted backend (10% maskgen masks,
    compact_cap 0.5) and of the bench's dense and sparse (xla) cells in
    float32 and bf16 (encb, decb: the bf16 cast), one forward in a trace
    each."""
    import torch
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg
    disp, raw, ratio, _, _ = edge_stage_masks(16)
    img = torch.from_numpy(mg.scene_image(disp, seed=0)).to(dev)
    raw = {i: m.to(dev) for i, m in raw.items()}
    runs = [(b, enc, dec, img, b) for b in COMPACTED]
    for name, e, d, x in (("f32", enc, dec, img),
                          ("bf16", encb, decb, img.bfloat16())):
        runs += [(f"dense_{name}", e, d, x, None),
                 (f"sparse_xla_{name}", e, d, x, "xla")]
    for backend, e, d, x, use in runs:
        def fwd():
            with torch.inference_mode():
                if use is None:
                    d(e(x))
                else:
                    d(e(x), thresh_ratio=ratio, mask_override=raw,
                      use_pallas=use)
        fwd()
        spans, by_kernel, by_op, busy, wall_ms, _ = trace_calls(fwd, 1)
        top_k = sorted(((v[1], n[:100], v[0]) for n, v in by_kernel.items()),
                       reverse=True)[:10]
        top_op = sorted(((v[0], n, v[1]) for n, v in by_op.items()),
                        reverse=True)[:10]
        # no device spans means the tracer saw nothing: "not measured"
        emit({"phase": "profile_forward", "backend": backend, "batch": 16,
              "forwards": 1, "kernels_per_forward": len(spans),
              "device_busy_ms_per_forward": busy / 1e3 if spans else None,
              "wall_ms_per_forward": wall_ms,
              "idle_share_of_wall":
                  1.0 - busy / 1e3 / wall_ms if spans else None,
              "top_kernels_ms_per_forward": [[k, v / 1e3, c]
                                             for v, k, c in top_k],
              "top_ops_ms_per_forward": [[k, v / 1e3, c]
                                         for v, k, c in top_op], **_card})


def profile_step(setup, state, noise, batch, kern: str) -> None:
    """Device busy time, idle share and kernels of one train step in a
    torch.profiler trace (the trace's own overhead lengthens the wall)."""
    spans, by_kernel, _, busy, wall_ms, _ = trace_calls(
        lambda: setup.train_step(state, batch, noise), 1)
    top = sorted(((v[1], name[:120], v[0]) for name, v in by_kernel.items()),
                 reverse=True)[:12]
    warp_kernels = {name[:120]: {"launches": v[0],
                                 "us_per_launch": v[1] / v[0]}
                    for name, v in by_kernel.items()
                    if "banded_warp" in name or "grid_sampler" in name}
    # no device spans means the tracer saw nothing: "not measured" (null)
    emit({"phase": "profile_train_step", "steps": 1,
          "stereo_warp_kernel": kern, "kernels": len(spans),
          "device_busy_ms_per_step": busy / 1e3 if spans else None,
          "kernel_window_ms_per_step":
              (spans[-1][1] - spans[0][0]) / 1e3 if spans else None,
          "wall_ms_per_step": wall_ms,
          "idle_share_of_wall":
              1.0 - busy / 1e3 / wall_ms if spans else None,
          "top_kernels_ms_per_step": [[k, v / 1e3, c] for v, k, c in top],
          "warp_kernels": warp_kernels, **_card})


def attribute_step(setup, state, noise, batch) -> None:
    """Which ATen ops, at which input shapes, one train step's device time
    belongs to: one trace with shapes recorded, each kernel charged to the
    innermost op that launched it (and named with that op's outermost
    caller, e.g. the autograd node of a backward op)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        setup.train_step(state, batch, noise)
        torch.cuda.synchronize()
    by_op = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU or not e.kernels:
            continue
        root = e
        while root.cpu_parent is not None:
            root = root.cpu_parent
        row = by_op.setdefault((e.name, str(e.input_shapes)[:160],
                                root.name[:80]), [0.0, 0, {}])
        for k in e.kernels:
            row[0] += k.duration
            row[1] += 1
            row[2][k.name[:80]] = row[2].get(k.name[:80], 0.0) + k.duration
    top = sorted(by_op.items(), key=lambda kv: kv[1][0], reverse=True)[:15]
    emit({"phase": "profile_train_step_ops", "steps": 1,
          "device_ms": sum(v[0] for v in by_op.values()) / 1e3,
          "top_ops": [{"op": op, "input_shapes": shapes, "caller": caller,
                       "ms": v[0] / 1e3, "kernels": v[1],
                       "top_kernel": max(v[2], key=v[2].get)}
                      for (op, shapes, caller), v in top], **_card})


def time_costliest_conv(dev) -> None:
    """The train step's costliest op in the traces, the decoder's
    upconv_3_1 forward conv (reflect-padded input, valid 3x3 conv, cuDNN),
    alone by CUDA events: at the step's batch and at the serving cell's
    B=16, under cuDNN's heuristic choice and under cudnn.benchmark."""
    import torch
    import torch.nn.functional as F
    g = torch.Generator().manual_seed(31)
    w = (torch.randn(128, 256, 3, 3, generator=g) * 0.05).to(dev)
    xs = {b: torch.randn(b, 256, H // 8 + 2, W // 8 + 2, generator=g).to(dev)
          for b in (TRAIN_B, 16)}

    def benchmarked(x):
        torch.backends.cudnn.benchmark = True
        try:
            return F.conv2d(x, w)
        finally:
            torch.backends.cudnn.benchmark = False

    variants = {}
    for b, x in xs.items():
        variants[f"b{b}_heuristic"] = lambda x=x: F.conv2d(x, w)
        variants[f"b{b}_benchmark"] = lambda x=x: benchmarked(x)
    with torch.no_grad():
        t = time_variants(variants, iters=5)
    emit({"phase": "time_train_conv", "conv": "upconv_3_1 forward",
          "input": [None, 256, H // 8 + 2, W // 8 + 2],
          "weight": list(w.shape), **t, **_card})


def phase_train_times(dev, root: str, batch):
    """ms per train step (B=12, "on" vs "auto", data on the card; "on"
    again with cudnn.benchmark), a profiler trace of each for the device's
    idle share, and K3 and F.grid_sample per launch at (12, 192, 640, 3)."""
    import torch
    from wavelet_monodepth_tpu_torch.train.kitti import KittiTrainSetup
    from wavelet_monodepth_tpu_torch.utils.config import parse_kitti_args

    steps = {}
    for kern in ("on", "auto", "on_bf16"):
        opts = parse_kitti_args(
            train_argv(root, "unused", kern.split("_")[0])
            + (["--bfloat16"] if kern.endswith("bf16") else []))
        setup = KittiTrainSetup(opts, steps_per_epoch=1000, device=dev)
        state = setup.init_state(torch.Generator().manual_seed(0))
        noise = torch.Generator(device=dev).manual_seed(0)
        steps[kern] = (setup, state, noise)
    t = time_variants({k: (lambda k=k: steps[k][0].train_step(
        steps[k][1], batch, steps[k][2])) for k in steps}, iters=10)
    emit({"phase": "time_train_step", "batch": TRAIN_B, "res": [H, W],
          "dtype": "float32 (on_bf16: bf16 mixed precision)", "tf32": False,
          "variants": {"on": "K3 banded warp kernel",
                       "auto": "F.grid_sample",
                       "on_bf16": "K3, --bfloat16"}, **t, **_card})

    for kern in steps:
        profile_step(*steps[kern], batch, kern)
    attribute_step(*steps["on"], batch)
    del steps
    time_costliest_conv(dev)

    # cuDNN's algorithm choice: the same "on" step with cudnn.benchmark
    torch.backends.cudnn.benchmark = True
    opts = parse_kitti_args(train_argv(root, "unused", "on"))
    setup = KittiTrainSetup(opts, steps_per_epoch=1000, device=dev)
    state = setup.init_state(torch.Generator().manual_seed(0))
    noise = torch.Generator(device=dev).manual_seed(0)
    t = time_variants({"on_cudnn_benchmark": lambda: setup.train_step(
        state, batch, noise)}, iters=10)
    torch.backends.cudnn.benchmark = False
    emit({"phase": "time_train_step", "batch": TRAIN_B, "res": [H, W],
          "dtype": "float32", "tf32": False, **t, **_card})
    del setup, state

    # K3 and its yardsticks at the path's shape, from the path's grid
    img = batch[("color_u8", "s", 0)].float() / 255.0
    depth = batch[("depth_hint",)].clamp_min(1.0)
    return time_warp(img, stereo_grid(depth, 0.1))


def time_warp(img, grid, phase: str = "time_warp", **extra) -> dict:
    """K3 forward and backward per launch on (img, grid) against the plain
    version, F.grid_sample and their bound; emits one line and returns the
    kernels line's numbers. The backward kernels are launched directly
    (the autograd engine's host time per call would otherwise outrun the
    queued-ahead window)."""
    import torch
    import torch.nn.functional as F
    from wavelet_monodepth_tpu_torch.ops import warp
    n, h, w, c = img.shape
    g = torch.Generator().manual_seed(21)
    x, yr = warp.banded_coords(grid, h, w)
    xg, yg = x.clone().requires_grad_(), yr.clone().requires_grad_()
    gout = torch.randn(n, h, w, c, generator=g).to(img.device)
    out_p = warp.banded_warp_plain(img, xg, yg)
    img_nchw = img.permute(0, 3, 1, 2)
    gout_nchw = gout.permute(0, 3, 1, 2)

    def library_bwd():          # grid gradient only, as on the path
        return torch.ops.aten.grid_sampler_2d_backward(
            gout_nchw, img_nchw, grid, 0, 1, False, [False, True])

    def library_fwd_bwd():
        F.grid_sample(img_nchw, grid, padding_mode="border",
                      align_corners=False)
        return library_bwd()

    before = dict(warp.launches)
    with torch.no_grad():
        fwd = time_variants({
            "kernel": lambda: warp._launch_fwd(img, x, yr),
            # the coordinate chain in torch and the kernel: what one
            # forward warp of the step costs, against grid_sample's one
            # call on the grid
            "kernel_with_coords": lambda: warp._launch_fwd(
                img, *warp.banded_coords(grid, h, w)),
            "plain": lambda: warp.banded_warp_plain(img, x, yr),
            "library_grid_sample": lambda: F.grid_sample(
                img_nchw, grid, padding_mode="border", align_corners=False),
        }, iters=50, queue_ahead=True)
        bwd = time_variants({
            "kernel": lambda: warp._launch_bwd(img, x, yr, gout, False),
            "kernel_with_src": lambda: warp._launch_bwd(img, x, yr, gout,
                                                        True),
            "library_grid_sample": library_bwd,
        }, iters=50, queue_ahead=True)
        fwd_bwd_lib = time_variants({
            "library_grid_sample_fwd_bwd": library_fwd_bwd},
            iters=50, queue_ahead=True)
    bwd.update(time_variants({"plain": time_backward(out_p, (xg, yg), gout)},
                             iters=10))
    timed = {k: warp.launches[k] - before[k] for k in before}
    bounds = {"fwd": warp_bound_ms(n, h, w, c, False, False),
              "bwd": warp_bound_ms(n, h, w, c, True, False),
              "bwd_with_src": warp_bound_ms(n, h, w, c, True, True)}
    emit({"phase": phase, "shape": [n, h, w, c],
          "fwd_band_rows": warp.band_rows(img), "fwd": fwd,
          "bwd": bwd, **fwd_bwd_lib, "bound_ms": bounds,
          "kernel_launches_while_timing": timed, **extra, **_card})
    return {"banded_warp_fwd": {
                "ms": fwd["kernel"]["ms_median"],
                "plain_ms": fwd["plain"]["ms_median"],
                "bound_ms": bounds["fwd"], "bound_by": "bytes",
                "library_ms": fwd["library_grid_sample"]["ms_median"]},
            "banded_warp_bwd": {
                "ms": bwd["kernel"]["ms_median"],
                "plain_ms": bwd["plain"]["ms_median"],
                "bound_ms": bounds["bwd"], "bound_by": "bytes",
                "library_ms": bwd["library_grid_sample"]["ms_median"]}}


# --- phase 11: the eigen-split evaluation -----------------------------------

EVAL_TEST_FRAMES = 16
# one eval configuration: (name, encoder depth, feed (h, w), weights)
EVAL_CONFIGS = (("resnet18", 18, (H, W), "trained"),
                ("resnet50", 50, (R50_H, R50_W), "seeded"))


def eval_argv(root, dev, depth, size):
    return ["--data_path", root, "--eval_stereo", "--use_wavelets",
            "--num_layers", str(depth), "--height", str(size[0]),
            "--width", str(size[1]), "--device", str(dev)]


def time_predict(argv, weights, dev, sparse: bool, profiled: bool) -> dict:
    """frames/s of kitti_eval.predict_disps over the test split (one
    pass, after main's own pass over it) and the share of its wall time
    spent in the host feed (JPEG decode, Lanczos resize, batching: the
    time the batches' generator takes to yield); the forward alone at
    B=12 on the card, CUDA events (median of 3 windows of up to 2).
    profiled: also one profiled call (kernels, device busy time, costliest
    kernels, ATen ops and convs with their shapes)."""
    t_start = time.perf_counter()
    import torch
    from wavelet_monodepth_tpu_torch.data.splits import readlines, \
        resolve_split_dir
    from wavelet_monodepth_tpu_torch.eval import kitti_eval
    from wavelet_monodepth_tpu_torch.tools import evaluate_depth as ed

    # batches of --batch_size (12): without --save_pred_disps, whose
    # coefficient stacks take one image per batch
    opts, _ = ed.parse_args([a for a in argv if a != "--save_pred_disps"])
    files = readlines(os.path.join(resolve_split_dir(
        opts.eval_split, opts.data_path), "test_files.txt"))
    forward = ed.load_forward(opts, dev, weights)
    ds = ed.eval_dataset(opts, files)
    thresh = opts.threshold if sparse else None
    feed = [0.0]

    def batches():
        it = ed.eval_batches(opts, ds)
        while True:
            t0 = time.perf_counter()
            b = next(it, None)
            feed[0] += time.perf_counter() - t0
            if b is None:
                return
            yield b
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    disps, _ = kitti_eval.predict_disps(
        forward, batches(), device=dev, post_process=opts.post_process,
        sparse_threshold=thresh)
    wall = time.perf_counter() - t0
    x = torch.from_numpy(next(ed.eval_batches(opts, ds))).to(dev)
    fwd = time_variants({"forward": lambda: forward(x, thresh)}, iters=2)
    out = {"frames": int(disps.shape[0]),
           "frames_per_s": disps.shape[0] / wall, "seconds": wall,
           "host_feed_share": feed[0] / wall, "forward_batch": x.shape[0],
           "forward_ms": fwd["forward"]}
    if profiled:
        _, by_kernel, by_op, busy, wall_ms, prof = trace_calls(
            lambda: forward(x, thresh), 1, shapes=True)
        out["forward_profile"] = {
            "kernels": sum(v[0] for v in by_kernel.values()),
            "device_busy_ms": busy / 1e3, "wall_ms": wall_ms,
            "top_kernels_us": {k[:80]: v[1] for k, v in sorted(
                by_kernel.items(), key=lambda kv: -kv[1][1])[:3]},
            "top_ops_us": {k: v[0] for k, v in sorted(
                by_op.items(), key=lambda kv: -kv[1][0])[:3]}}
        out["costliest_convs"] = costliest_convs(prof)
    out["time_predict_seconds"] = time.perf_counter() - t_start
    return out


def costliest_convs(prof, top: int = 3) -> list:
    """The `top` cuDNN convolutions of a trace with shapes recorded
    (trace_calls(..., shapes=True)) by device time, with their input
    shapes."""
    rows = [e for e in prof.key_averages(group_by_input_shape=True)
            if e.key == "aten::cudnn_convolution"]
    rows.sort(key=lambda e: -e.device_time_total)
    return [{"input_shapes": [list(map(int, s)) for s in e.input_shapes[:2]],
             "calls": e.count, "device_ms": e.device_time_total / 1e3}
            for e in rows[:top]]


def run_eval(argv, weights, dev, name, mode, sparse=False, timed=True):
    """evaluate_depth.main on argv (+ --torch_model_path weights), its
    row checked finite, one {"phase": "eval"} line (with time_predict's
    numbers when timed); returns main's dict."""
    import numpy as np
    from wavelet_monodepth_tpu_torch.tools import evaluate_depth as ed
    full = argv + (["--torch_model_path", weights] if weights else [])
    t0 = time.perf_counter()
    res = ed.main(full)
    seconds = time.perf_counter() - t0
    row = list(res["metrics"].values())
    require(all(np.isfinite(v) for v in row), (name, mode, res["metrics"]))
    if sparse:
        require(res["density_mean"] is not None
                and 0 < res["density_mean"] <= 1
                and res["total_ops_mean"] > 0, (name, mode, res))
    line = {"phase": "eval", "config": name, "mode": mode,
            "device": str(dev), "metrics": res["metrics"],
            "density": res["density_mean"],
            "gflops_per_image": (None if res["total_ops_mean"] is None
                                 else res["total_ops_mean"] / 1e9),
            "seconds": seconds}
    if timed:
        line.update(time_predict(full, weights or argv[
            argv.index("--load_weights_folder") + 1], dev, sparse,
            profiled=mode == "dense"))
    emit({**line, **_card})
    return res


def decoder_ops_mean(argv, weights, dev, thresh) -> float:
    """Mean ("total_ops", -1) over the test frames and their flips, read
    from the decoder's own outputs (not through predict_disps)."""
    import numpy as np
    import torch
    from wavelet_monodepth_tpu_torch.data.splits import readlines, \
        resolve_split_dir
    from wavelet_monodepth_tpu_torch.tools import evaluate_depth as ed
    opts, _ = ed.parse_args(argv)
    files = readlines(os.path.join(resolve_split_dir(
        opts.eval_split, opts.data_path), "test_files.txt"))
    forward = ed.load_forward(opts, dev, weights)
    ops = []
    for b in ed.eval_batches(opts, ed.eval_dataset(opts, files)):
        x = torch.from_numpy(b).to(dev)
        for xi in (x, torch.flip(x, dims=(2,))):
            ops += forward(xi, thresh)[("total_ops", -1)].cpu().tolist()
    return float(np.mean(ops))


@contextlib.contextmanager
def tf32_on(on: bool):
    """With on: the CLIs' pin_float32 turns TF32 on in place of off, for
    one measurement of what TF32 would change; float32 again after."""
    import torch
    from wavelet_monodepth_tpu_torch.utils import device as device_rule
    pin = device_rule.pin_float32

    def allow(device):
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    if on:
        device_rule.pin_float32 = allow
    try:
        yield
    finally:
        device_rule.pin_float32 = pin
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def phase_eval(dev, ckpt18: str, tmp: str):
    """tools/evaluate_depth.main on a synthetic eigen mount (16 test
    frames at 1242x375, data/synth.py): KITTI ResNet18 640x192 on the
    checkpoint the training phase wrote, (a) dense --post_process, the
    same on the CPU, (b) --use_sparse --threshold 0.1 --post_process,
    (c) --bfloat16 --post_process, (d) --ext_disp_to_eval of (a)'s saved
    disparities; KITTI ResNet50 1024x320 on seeded weights, dense and
    sparse. Checks: finite rows; (d) == (a) exactly; card vs CPU
    disparities and rows within TOL; (b)'s ops are the decoder's own; (c)
    within the bf16 bounds of (a) in sigmoid disparity. Returns (the
    mount, the ResNet18 checkpoint folder)."""
    import shutil
    import numpy as np
    from wavelet_monodepth_tpu_torch.data import synth
    from wavelet_monodepth_tpu_torch.tools import torch_import as ti

    t_phase = time.perf_counter()
    probe = subprocess.run([sys.executable, "-c", "import cv2"],
                           capture_output=True, timeout=120)
    root = os.path.join(tmp, "kitti_eigen")
    t0 = time.perf_counter()
    synth.fabricate(root, n_train=2, n_val=0, n_test=EVAL_TEST_FRAMES,
                    progress=False)
    emit({"phase": "eval_mount", "test_frames": EVAL_TEST_FRAMES,
          "size": KITTI_FULL, "seconds": time.perf_counter() - t0,
          "cv2_importable": probe.returncode == 0})
    split_disps = "disps_eigen_split.npy"
    for name, depth, size, weights in EVAL_CONFIGS:
        argv = eval_argv(root, dev, depth, size)
        sparse = ["--use_sparse", "--threshold", "0.1", "--post_process"]
        if weights == "seeded":
            enc, dec = build_models("cpu", seed=9, depth=depth)
            weights = os.path.join(tmp, name)
            ti.save_reference_checkpoint(weights, enc, dec, *size)
            del enc, dec
            run_eval(argv + ["--post_process"], weights, dev, name, "dense")
            run_eval(argv + sparse, weights, dev, name, "sparse", True)
            continue
        folder = os.path.join(tmp, name)
        shutil.copytree(ckpt18, folder)
        saved = os.path.join(folder, split_disps)
        disps = {}
        res = {}
        for mode, extra, run_dev in (
                ("dense", ["--post_process"], dev),
                ("dense_tf32", ["--post_process"], dev),
                ("dense_cpu", ["--post_process", "--device", "cpu"], "cpu"),
                ("bf16", ["--post_process", "--bfloat16"], dev)):
            with tf32_on(mode == "dense_tf32"):
                res[mode] = run_eval(
                    argv + extra + ["--load_weights_folder", folder,
                                    "--save_pred_disps"],
                    None, run_dev, name, mode,
                    timed=mode not in ("dense_cpu", "dense_tf32"))
            disps[mode] = np.load(saved)
            os.replace(saved, os.path.join(folder, f"{mode}.npy"))
        # the record of what TF32 would move (the CLI pins float32)
        emit({"phase": "eval_tf32", "config": name,
              "metric_change_tf32_on": {
                  k: abs(res["dense_tf32"]["metrics"][k] - v)
                  for k, v in res["dense"]["metrics"].items()},
              "disp_change_max": float(np.abs(disps["dense_tf32"]
                                              - disps["dense"]).max()),
              **_card})
        del res["dense_tf32"]
        res["sparse"] = run_eval(argv + sparse + ["--load_weights_folder",
                                                  folder],
                                 None, dev, name, "sparse", True)
        res["ext"] = run_eval(argv + ["--ext_disp_to_eval", os.path.join(
            folder, "dense.npy")], None, dev, name, "ext_disp", timed=False)
        row = {k: list(r["metrics"].values()) for k, r in res.items()}
        cpu_gap = float(np.abs(disps["dense"] - disps["dense_cpu"]).max())
        row_gap = float(np.abs(np.subtract(row["dense"],
                                           row["dense_cpu"])).max())
        # the bf16 bounds hold the sigmoid disparity: predict_disps scales
        # it to [1 / max_depth, 1 / min_depth] = [0.01, 10]
        bf16 = np.abs(disps["bf16"] - disps["dense"]) / 9.99
        ops = decoder_ops_mean(argv + sparse, folder, dev, 0.1)
        check = {"phase": "eval_checks", "config": name,
                 "ext_row_equal": row["ext"] == row["dense"],
                 "card_vs_cpu_disp_max": cpu_gap,
                 "card_vs_cpu_row_max": row_gap,
                 "bf16_vs_f32_disp": {"max": float(bf16.max()),
                                      "mean": float(bf16.mean())},
                 "sparse_total_ops_mean": res["sparse"]["total_ops_mean"],
                 "decoder_total_ops_mean": ops}
        emit(check)
        require(check["ext_row_equal"] and cpu_gap <= TOL
                and row_gap <= TOL and bf16.max() <= BF16_DISP_MAX
                and bf16.mean() <= BF16_DISP_MEAN
                and res["sparse"]["total_ops_mean"] == ops, check)
        trained = folder
    emit({"phase": "eval_done", "seconds": time.perf_counter() - t_phase})
    return root, trained


# --- phase 12: NYUv2 serving and evaluation ----------------------------------

NYU_H, NYU_W = 480, 640
NYU_FRAMES = 16
NYU_B = 8
NYU_THRESH = 0.05
NYU_DENSITY = 0.05           # the published NYU operating point
# (H, W, Cin, Cout, epilogue, pad, (sparse scale, mask), conv) of the
# tile-sparse convs of one NYU sparse forward (DenseNet161, 640x480): each
# sparse scale's UpBlock convA and wave head
NYU_CONVS = [
    (60, 80, 744, 276, "leaky02", "reflect", (1, "wave"), "up2.convA"),
    (60, 80, 276, 3, "none", "zero", (1, "wavelet"), "wave2"),
    (120, 160, 372, 138, "leaky02", "reflect", (0, "wave"), "up3.convA"),
    (120, 160, 138, 3, "none", "zero", (0, "wavelet"), "wave3"),
]
# K1 / K4 launches per NYU sparse forward, JAX's routing: the convAs take
# the backend asked for, the wave heads K1 on every one of them
NYU_LAUNCHES = {
    "pallas": {"conv3x3_tile_sparse": 4, "conv3x3_tile_sparse_2d": 0},
    "pallas2d": {"conv3x3_tile_sparse": 2, "conv3x3_tile_sparse_2d": 2},
    "capacity": {"conv3x3_tile_sparse": 2, "conv3x3_tile_sparse_2d": 0},
}
# the convs each kernel runs per sparse forward on its own backend
NYU_KERNEL_CONVS = {"conv3x3_tile_sparse": ("up2.convA", "wave2",
                                            "up3.convA", "wave3"),
                    "conv3x3_tile_sparse_2d": ("up2.convA", "up3.convA")}
# the edge metrics threshold Canny maps: predictions ~1e-6 m apart flip a
# few of ~10k edge pixels and move eps by up to ~1e-3 px
NYU_EDGE_TOL = 1e-3
NYU_ROW = ("abs_rel", "rmse", "log10", "a1", "a2", "a3", "eps_acc",
           "eps_comp")


def nyu_frames(n: int, seed: int = 0):
    """n synthetic labeled frames with exact GT: the left view and true
    depth of data/synth.render_scene (KITTI's 1242x375), the view resized
    to 640x480 (bilinear, ops/resize.py), the depth x0.25 into NYU's
    range by nearest index, as the JAX package's fabricate_nyu does; GT
    edges from nyu_eval.canny on the normalised GT depth."""
    import numpy as np
    from wavelet_monodepth_tpu_torch.data import synth
    from wavelet_monodepth_tpu_torch.eval import nyu_eval
    from wavelet_monodepth_tpu_torch.ops.resize import resize_linear
    rng = np.random.RandomState(seed)
    rgb = np.empty((n, NYU_H, NYU_W, 3), np.uint8)
    depth = np.empty((n, NYU_H, NYU_W), np.float32)
    for i in range(n):
        left, _, d, _ = synth.render_scene(rng)
        img = resize_linear(left.astype(np.float32), NYU_W, NYU_H)
        rgb[i] = np.clip(np.rint(img), 0, 255).astype(np.uint8)
        yi = np.arange(NYU_H) * d.shape[0] // NYU_H
        xi = np.arange(NYU_W) * d.shape[1] // NYU_W
        depth[i] = 0.25 * d[yi][:, xi]
    edges = np.stack([nyu_eval.canny((d - d.min()) / (d.max() - d.min()))
                      for d in depth])
    return rgb, depth, edges


def nyu_modules(seed: int = 10, cm_per_unit: float = 1.0,
                encoder: str = "densenet"):
    """A seeded DenseNet161 (or, with encoder="mobilenet", MobileNetV2) +
    NyuDecoderWave (on the CPU, train mode), its heads rescaled so the
    raw output looks like depth in cm (in metres with cm_per_unit=100):
    the LL head's weights x3000 and bias +300 give ~1-3.5 m with a metre
    of structure from the image, the wave heads' weights x250 give
    partial masks at threshold 0.05 (a random init gives ~0.01 cm of
    structure, all-active masks and, in bf16, a constant depth). The unit
    divides the LL and wave heads' scales alike, so the masks stay close
    to the cm model's."""
    import torch
    from wavelet_monodepth_tpu_torch.models.decoders_nyu import \
        NyuDecoderWave
    from wavelet_monodepth_tpu_torch.models.densenet import \
        DenseNet161Encoder
    from wavelet_monodepth_tpu_torch.models.layers import init_params
    from wavelet_monodepth_tpu_torch.models.mobilenetv2 import \
        MobileNetV2Encoder
    g = torch.Generator().manual_seed(seed)
    enc = init_params({"densenet": DenseNet161Encoder,
                       "mobilenet": MobileNetV2Encoder}[encoder](), g)
    dec = init_params(NyuDecoderWave(enc.num_ch_enc), g)
    with torch.no_grad():
        dec.wave1_ll.conv.weight.mul_(3000.0 / cm_per_unit)
        dec.wave1_ll.conv.bias.add_(300.0 / cm_per_unit)
        for head in (dec.wave1, dec.wave2, dec.wave3):
            head.conv.weight.mul_(250.0 / cm_per_unit)
    return enc, dec


def nyu_model(path: str, seed: int = 10) -> None:
    """nyu_modules(seed) written as a reference NYU model.pth."""
    from wavelet_monodepth_tpu_torch.tools import torch_import as ti
    ti.save_nyu_model_pth(path, *nyu_modules(seed))


def nyu_forward(model: str, dev, backend=False, bf16: bool = False,
                capacity_ratio: float = 0.5):
    """tools/evaluate_nyu.load_forward on the model.pth, --use_wavelets
    --use_sparse (dense without a threshold)."""
    from wavelet_monodepth_tpu_torch.tools import evaluate_nyu as ev
    argv = ["--data_path", "-", "--splits_path", "-", "--use_wavelets",
            "--use_sparse", "--device", str(dev)] + (
                ["--bfloat16"] if bf16 else [])
    return ev.load_forward(ev.nyu_options(ev.parse_args(argv)), dev, model,
                           use_pallas=backend,
                           capacity_ratio=capacity_ratio)


def nyu_input(rgb, dev):
    """predict_depth_batch's network input of uint8 frames: border-crop 16,
    /255 on the card, 640x480 align_corners resize."""
    import torch
    from wavelet_monodepth_tpu_torch.ops.image import resize_bilinear
    x = torch.from_numpy(rgb[:, 16:-16, 16:-16].copy()).to(dev)
    return resize_bilinear(x.float() / 255.0, NYU_H, NYU_W,
                           align_corners=True)


def nyu_stage_masks(raw: dict) -> dict:
    """{scale s: {"wave": convA's out mask, "wavelet": the head's}} from
    the raw masks {s: (N, h, w, 1)}, through the decoder's dilations."""
    from wavelet_monodepth_tpu_torch.ops import sparse as sp
    from wavelet_monodepth_tpu_torch.ops.image import upsample_nearest2x
    out = {}
    for s, m in raw.items():
        um = upsample_nearest2x(m)
        out[s] = {"wave": sp.dilate_mask(um, 3), "wavelet": um}
    return out


def nyu_raw_masks(batch: int, seed: int = 0):
    """Raw masks {s: (N, h, w, 1)} at the NYU decoder's sparse scales
    (s=1 at 30x40, s=0 at 60x80) from maskgen scenes at 240x320 (the
    decoder's output size), their threshold bisected so the base masks'
    density over both sparse scales (area-weighted as their wavelet
    masks, 60x80 and 120x160) is 5%; and that density."""
    import torch
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg
    disp = mg.synthetic_depth_scene(batch, NYU_H // 2, NYU_W // 2, seed)

    def masks(r):     # maskgen's stage i masks are H / 2^(i+1)
        m = mg.dwt_stage_masks(disp, r, scales=(1, 2))
        return {1: torch.from_numpy(m[2]), 0: torch.from_numpy(m[1])}

    def density(m):
        return (4800.0 * float(m[1].mean())
                + 19200.0 * float(m[0].mean())) / 24000.0
    lo, hi = 1e-4, 1.0
    for _ in range(40):
        mid = (lo * hi) ** 0.5
        m = masks(mid)
        d = density(m)
        if abs(d - NYU_DENSITY) < 0.002:
            break
        lo, hi = (mid, hi) if d > NYU_DENSITY else (lo, mid)
    return m, d


def nyu_gap(ours: dict, ref: dict) -> float:
    """Largest |ours - ref| over the float outputs, each relative to
    max(1, max |ref|) of its tensor (the raw outputs are in cm, ~300)."""
    gap = 0.0
    for k, r in ref.items():
        if k[0] in ("wavelet_mask", "total_ops"):
            continue
        scale = max(1.0, float(r.abs().max()))
        gap = max(gap, float((ours[k] - r).abs().max()) / scale)
    return gap


def run_nyu_eval(forward, frames, dev, mode: str, thresh=None,
                 n=None, timed: bool = True) -> dict:
    """nyu_eval.evaluate at batch_size 8 with edges over the first n
    frames (all by default); one {"phase": "nyu_eval"} line with the row,
    frames/s, the host's shares of the wall time and, timed, the B=8
    forward alone (CUDA events). Returns the row."""
    import numpy as np
    import torch
    from wavelet_monodepth_tpu_torch.eval import nyu_eval
    from wavelet_monodepth_tpu_torch.ops.sparse import compute_density
    rgb, depth, edges = (a[:n] for a in frames)
    stats = {"density": [], "total_ops": []}

    def recorded(x, t=None):
        out = forward(x, t)
        if t is not None:
            stats["density"] += compute_density(
                out, per_image=True).cpu().tolist()
            stats["total_ops"] += out[("total_ops", -1)].cpu().tolist()
        return out
    forward(nyu_input(rgb[:1], dev), thresh)          # warm-up
    timings = {}
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    row = nyu_eval.evaluate(recorded, rgb, depth, edges_gt=edges,
                            sparse_threshold=thresh, batch_size=NYU_B,
                            device=dev, timings=timings)
    wall = time.perf_counter() - t0
    require(all(np.isfinite(row[k]) for k in NYU_ROW), (mode, row))
    line = {"phase": "nyu_eval", "mode": mode, "device": str(dev),
            "frames": int(rgb.shape[0]), "threshold": thresh,
            "row": {k: float(row[k]) for k in NYU_ROW},
            "frames_per_s": rgb.shape[0] / wall, "seconds": wall,
            "predict_share": timings["predict_s"] / wall,
            "host_edges_share": timings["edges_s"] / wall}
    if thresh is not None:
        line.update(density_mean=float(np.mean(stats["density"])),
                    gflops_per_image=float(np.mean(stats["total_ops"]))
                    / 1e9)
    if timed:
        x = nyu_input(rgb[:NYU_B], dev)
        line["forward_b8"] = time_variants(
            {"forward": lambda: forward(x, thresh)}, iters=2)["forward"]
    emit({**line, **_card})
    return row


def nyu_kernel_checks(dev, errs, raw_by_batch: dict, masks: str) -> None:
    """K1 and K4 against the plain version at the four NYU conv shapes,
    on the stage masks of raw_by_batch {batch: raw masks}; <= TOL."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
    nl = {"none": None, "leaky02": tsc.leaky_relu_02}
    g = torch.Generator().manual_seed(3)
    for batch, raw in raw_by_batch.items():
        stage = nyu_stage_masks({s: m.to(dev) for s, m in raw.items()})
        for h, w, cin, cout, epi, pad, (s, mk), conv in NYU_CONVS:
            m = stage[s][mk].float().contiguous()
            require(m.shape == (batch, h, w, 1), (conv, tuple(m.shape)))
            x = torch.randn(batch, h, w, cin, generator=g).to(dev)
            wt = (torch.randn(3, 3, cin, cout, generator=g)
                  * (2.0 / (9 * cin)) ** 0.5).to(dev)
            b = (torch.randn(cout, generator=g) * 0.1).to(dev)
            ref = tsc.conv3x3_masked_plain(x, wt, b, m, pad, nl[epi])
            for key in KERNELS:
                out = getattr(tsc, key)(x, wt, b, m, pad, nl[epi])
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                errs[key] = max(errs[key], err)
                emit({"phase": "kernel_vs_plain", "kernel": key,
                      "model": "nyu_densenet161", "conv": conv,
                      "masks": masks, "shape": [batch, h, w, cin, cout],
                      "pad": pad, "nonlin": epi,
                      "mask_density": float(m.mean()), "max_abs_err": err})
                require(err <= TOL, (key, conv, batch, masks, err))


def nyu_conv_times(dev, raw_by_batch: dict) -> dict:
    """Per NYU conv shape at B=8 and B=1 on the 5% masks: K1, K4, the
    plain version and cuDNN's dense F.conv2d (CUDA events, median of 3
    interleaved windows), with the conv's bound. Returns, per kernel, the
    B=8 sums over the convs it runs per sparse forward."""
    import torch
    import torch.nn.functional as F
    from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
    nl = {"none": None, "leaky02": tsc.leaky_relu_02}
    g = torch.Generator().manual_seed(4)
    sums = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                "library_ms": 0.0, "bound_ms_f32_cuda_cores": 0.0,
                "bound_by": {"operations": 0.0, "bytes": 0.0}}
            for k in KERNELS}
    for batch, raw in raw_by_batch.items():
        stage = nyu_stage_masks({s: m.to(dev) for s, m in raw.items()})
        for h, w, cin, cout, epi, pad, (s, mk), conv in NYU_CONVS:
            m = stage[s][mk].float().contiguous()
            x = torch.randn(batch, h, w, cin, generator=g).to(dev)
            wt = (torch.randn(3, 3, cin, cout, generator=g) * 0.05).to(dev)
            b = torch.zeros(cout, device=dev)
            x_nchw = x.permute(0, 3, 1, 2).contiguous()
            w_oihw = wt.permute(3, 2, 0, 1).contiguous()
            with torch.inference_mode():
                t = time_variants({
                    "plain": lambda: tsc.conv3x3_masked_plain(
                        x, wt, b, m, pad, nl[epi]),
                    **{k: (lambda k=k: getattr(tsc, k)(x, wt, b, m, pad,
                                                       nl[epi]))
                       for k in KERNELS},
                    "library_conv2d": lambda: F.conv2d(x_nchw, w_oihw, b,
                                                       padding=1),
                }, iters=20)
            bound, by, bound_f32 = conv_bound_ms(m, cin, cout)
            work = granule_work(m, cin, cout)
            for k in KERNELS:
                work[k]["achieved_tflops"] = (work[k]["active_flops"]
                                              / t[k]["ms_median"] / 1e9)
                if batch == NYU_B and conv in NYU_KERNEL_CONVS[k]:
                    sums[k]["ms"] += t[k]["ms_median"]
                    sums[k]["plain_ms"] += t["plain"]["ms_median"]
                    sums[k]["bound_ms"] += bound
                    sums[k]["bound_ms_f32_cuda_cores"] += bound_f32
                    sums[k]["library_ms"] += t["library_conv2d"]["ms_median"]
                    sums[k]["bound_by"][by] += bound
            emit({"phase": "time_conv", "model": "nyu_densenet161",
                  "conv": conv, "batch": batch, "shape": [h, w, cin, cout],
                  "mask_density": float(m.mean()),
                  "masked_flops": 2.0 * 9 * cin * cout * float(m.sum()),
                  "bound_ms": bound, "bound_by": by,
                  "bound_ms_f32_cuda_cores": bound_f32, "granules": work,
                  **t, **_card})
    for k in KERNELS:
        sums[k]["bound_by"] = max(sums[k]["bound_by"],
                                  key=sums[k]["bound_by"].get)
    return sums


def nyu_requests(dev, model: str, x8, errs) -> dict:
    """One B=8 and one B=1 sparse request (threshold 0.05, the decoder's
    own masks) on pallas, pallas2d and capacity (capacity_ratio 1.0:
    nothing dropped; its overflow at JAX's 0.5 is printed), each against
    xla: the masks and op counts equal, the outputs within TOL relative
    to max(1, max |xla|) of each tensor, and JAX's K1 / K4 launches per
    forward, counted from 0 around the request. Returns the launches of
    these requests (the NYU serving path's) and the requests' raw masks
    by batch for the kernel checks."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
    from wavelet_monodepth_tpu_torch.ops.capacity import \
        conv_capacity_overflow
    xla = nyu_forward(model, dev)
    fwds = {b: nyu_forward(model, dev, b, capacity_ratio=1.0
                           if b == "capacity" else 0.5)
            for b in NYU_LAUNCHES}
    launches = {k: 0 for k in KERNELS}
    raws = {}
    for batch in (NYU_B, 1):
        x = x8[:batch]
        ref = xla(x, NYU_THRESH)
        raws[batch] = {s: ref[("wavelet_mask", s)][:, ::2, ::2].cpu()
                       for s in (1, 0)}
        stage = nyu_stage_masks({s: m.to(dev) for s, m in
                                 raws[batch].items()})
        for backend, fwd in fwds.items():
            tsc.reset_launches()
            out = fwd(x, NYU_THRESH)
            torch.cuda.synchronize()
            got = dict(tsc.launches)
            for k in KERNELS:
                launches[k] += got[k]
            gap = nyu_gap(out, ref)
            masks_equal = all(torch.equal(out[k], ref[k]) for k in ref
                              if k[0] == "wavelet_mask")
            ops_equal = torch.equal(out[("total_ops", -1)],
                                    ref[("total_ops", -1)])
            row = {"phase": "nyu_request", "backend": backend,
                   "batch": batch, "launches": got,
                   "expected_launches": NYU_LAUNCHES[backend],
                   "gap_vs_xla_rel": gap, "masks_equal": masks_equal,
                   "total_ops_equal": ops_equal,
                   "density": [float(ref[("wavelet_mask", s)].mean())
                               for s in (1, 0)]}
            if backend == "capacity":
                row["overflow_at_0.5"] = {
                    s: int(conv_capacity_overflow(stage[s]["wave"]))
                    for s in (1, 0)}
            emit(row)
            require(got == NYU_LAUNCHES[backend] and masks_equal
                    and ops_equal and gap <= TOL, row)
        del ref
    return launches, raws


def nyu_forward_times(dev, model: str, x8, raw5: dict) -> None:
    """ms per B=8 and B=1 forward, dense and sparse on xla / pallas /
    pallas2d / capacity, the sparse scales' masks replaced by the 5%
    maskgen masks (CUDA events, median of 3 interleaved windows); then
    MobileNetV2 + NyuDecoderWave's B=8 dense and sparse (xla) forward."""
    import torch
    from wavelet_monodepth_tpu_torch.models.decoders_nyu import \
        NyuDecoderWave
    from wavelet_monodepth_tpu_torch.models.layers import init_params
    from wavelet_monodepth_tpu_torch.models.mobilenetv2 import \
        MobileNetV2Encoder
    fwds = {b: nyu_forward(model, dev, b) for b in
            (False, "pallas", "pallas2d", "capacity")}
    for batch in (NYU_B, 1):
        x = x8[:batch]
        mo = {s: raw5[batch][s].to(dev) for s in (1, 0)}
        variants = {"dense": lambda: fwds[False](x, None)}
        for b, f in fwds.items():
            variants[f"sparse_{b or 'xla'}"] = (
                lambda f=f: f(x, NYU_THRESH, mask_override=mo))
        t = time_variants(variants, iters=3 if batch == NYU_B else 10)
        emit({"phase": "nyu_time_forward", "model": "densenet161",
              "batch": batch, "res": [NYU_H, NYU_W], "dtype": "float32",
              "mask": f"maskgen {NYU_DENSITY:.0%} density", **t,
              "fps_median": {k: batch * 1e3 / v["ms_median"]
                             for k, v in t.items()}, **_card})
    del fwds
    g = torch.Generator().manual_seed(12)
    enc = init_params(MobileNetV2Encoder(True), g).to(dev).eval()
    dec = init_params(NyuDecoderWave(enc.num_ch_enc), g).to(dev).eval()
    mo = {s: raw5[NYU_B][s].to(dev) for s in (1, 0)}
    with torch.inference_mode():
        t = time_variants({
            "dense": lambda: dec(enc(x8)),
            "sparse_xla": lambda: dec(enc(x8), thresh_ratio=NYU_THRESH,
                                      mask_override=mo)}, iters=5)
    emit({"phase": "nyu_time_forward", "model": "mobilenetv2",
          "batch": NYU_B, "res": [NYU_H, NYU_W], "dtype": "float32",
          "mask": f"maskgen {NYU_DENSITY:.0%} density", **t, **_card})


def nyu_profile(fn, label: str) -> None:
    """One fn() under torch.profiler: kernels, device busy time and idle
    share, the costliest kernels and ATen ops, and the costliest convs
    with their shapes."""
    import torch
    with torch.inference_mode():
        _, by_kernel, by_op, busy, wall_ms, prof = trace_calls(
            fn, 1, shapes=True)
        convs = costliest_convs(prof, 5)
    emit({"phase": "nyu_profile_forward", "forward": label,
          "kernels": sum(v[0] for v in by_kernel.values()),
          "device_busy_ms": busy / 1e3, "wall_ms": wall_ms,
          "idle_share": 1.0 - busy / 1e3 / wall_ms,
          "top_kernels_us": {k[:80]: v[1] for k, v in sorted(
              by_kernel.items(), key=lambda kv: -kv[1][1])[:5]},
          "top_aten_ops_us": {k: v[0] for k, v in sorted(
              ((k, v) for k, v in by_op.items() if k.startswith("aten::")),
              key=lambda kv: -kv[1][0])[:5]},
          "costliest_convs": convs, **_card})


def phase_nyu(dev, errs, tmp: str) -> dict:
    """The NYUv2 slice on the card (module docstring, phase 12). Returns
    {kernel: {"launches_nyu": ..., "*_nyu": B=8 sums}} for the kernels
    line."""
    import numpy as np
    import torch
    from wavelet_monodepth_tpu_torch.eval import nyu_eval

    t_phase = time.perf_counter()
    frames = nyu_frames(NYU_FRAMES)
    model = os.path.join(tmp, "nyu", "model.pth")
    nyu_model(model)
    emit({"phase": "nyu_mount", "frames": NYU_FRAMES, "size": [NYU_H, NYU_W],
          "gt_depth_range_m": [float(frames[1].min()),
                               float(frames[1].max())],
          "seconds": time.perf_counter() - t_phase})
    f32 = nyu_forward(model, dev)
    rows = {"dense": run_nyu_eval(f32, frames, dev, "dense")}
    cpu = nyu_forward(model, torch.device("cpu"))
    two = [a[:2] for a in frames]
    rows["dense_cpu"] = run_nyu_eval(cpu, two, torch.device("cpu"),
                                     "dense_cpu", timed=False)
    rows["dense_card_2"] = run_nyu_eval(f32, two, dev, "dense_2_frames",
                                        timed=False)
    rows["sparse"] = run_nyu_eval(f32, frames, dev, "sparse_xla",
                                  thresh=NYU_THRESH)
    bf16 = nyu_forward(model, dev, bf16=True)
    rows["bf16"] = run_nyu_eval(bf16, frames, dev, "bf16")

    # card vs CPU, bf16 vs f32, thresh -1 == dense
    d_card = nyu_eval.predict_depth_batch(f32, two[0], device=dev)
    d_cpu = nyu_eval.predict_depth_batch(cpu, two[0],
                                         device=torch.device("cpu"))
    del cpu
    c = nyu_eval.EIGEN_CROP
    crop = (slice(None), slice(c[0], c[1] + 1), slice(c[2], c[3] + 1))
    pf, pb = (np.concatenate([nyu_eval.predict_depth_batch(
        f, frames[0][i:i + NYU_B], device=dev)[crop]
        for i in range(0, NYU_FRAMES, NYU_B)]) for f in (f32, bf16))
    x8 = nyu_input(frames[0][:NYU_B], dev)
    dense = f32(x8, None)
    minus1 = f32(x8, -1.0)
    gap = np.abs(pb - pf)
    check = {
        "phase": "nyu_checks",
        "card_vs_cpu_depth_max": float(np.abs(d_card - d_cpu).max()),
        "card_vs_cpu_row_max": max(float(abs(rows["dense_card_2"][k]
                                             - rows["dense_cpu"][k]))
                                   for k in NYU_ROW[:6]),
        "card_vs_cpu_eps_max": max(float(abs(rows["dense_card_2"][k]
                                             - rows["dense_cpu"][k]))
                                   for k in NYU_ROW[6:]),
        "bf16_vs_f32_depth_m": {"max": float(gap.max()),
                                "mean": float(gap.mean()),
                                "f32_mean_depth": float(pf.mean())},
        "rows": {k: {n: float(r[n]) for n in NYU_ROW}
                 for k, r in rows.items() if k in ("dense", "bf16")},
        "thresh_minus1_equals_dense": all(
            torch.equal(minus1[k], v) for k, v in dense.items()),
    }
    emit(check)
    require(check["card_vs_cpu_depth_max"] <= TOL
            and check["card_vs_cpu_row_max"] <= TOL
            and check["card_vs_cpu_eps_max"] <= NYU_EDGE_TOL
            and np.isfinite(pb).all()
            and gap.mean() <= 0.01 * pf.mean()
            and check["thresh_minus1_equals_dense"], check)
    del bf16, dense, minus1

    # the serving path's sparse requests on the kernel backends
    launches, raws = nyu_requests(dev, model, x8, errs)
    raw5 = {}
    for batch in (NYU_B, 1):
        raw5[batch], dens = nyu_raw_masks(batch)
        emit({"phase": "nyu_masks", "batch": batch,
              "aggregate_density": dens,
              "density_by_scale": {s: float(m.mean())
                                   for s, m in raw5[batch].items()}})
    nyu_kernel_checks(dev, errs, raws, "decoder threshold 0.05")
    nyu_kernel_checks(dev, errs, raw5, "maskgen 5%")
    sums = nyu_conv_times(dev, raw5)
    nyu_forward_times(dev, model, x8, raw5)
    mo = {s: m.to(dev) for s, m in raw5[NYU_B].items()}
    p2d = nyu_forward(model, dev, "pallas2d")
    for label, fn in (
            ("dense B=8", lambda: f32(x8, None)),
            ("dense B=1", lambda: f32(x8[:1], None)),
            ("sparse pallas2d B=8, 5% masks",
             lambda: p2d(x8, NYU_THRESH, mask_override=mo))):
        nyu_profile(fn, label)
    # cuDNN's own algorithm search, for comparison only (the path keeps
    # cuDNN's heuristic choice)
    torch.backends.cudnn.benchmark = True
    try:
        bench = time_variants({"dense": lambda: f32(x8, None)}, iters=2)
    finally:
        torch.backends.cudnn.benchmark = False
    emit({"phase": "nyu_time_forward", "model": "densenet161",
          "batch": NYU_B, "cudnn_benchmark": True, **bench, **_card})
    del f32, p2d
    torch.cuda.empty_cache()
    emit({"phase": "nyu_done", "seconds": time.perf_counter() - t_phase})
    return {k: {"launches_nyu": launches[k],
                **{f"{n}_nyu": v for n, v in sums[k].items()}}
            for k in KERNELS}


# --- phase 13: NYUv2 training -----------------------------------------------

NYU_TRAIN_FRAMES = 24        # 3 steps at the reference's batch 8
NYU_TRAIN_B = 8
NYU_EVAL_FRAMES = 4
# a twin of the learning contract: mobilenet_light at 64x96, B=2
NYU_TWIN = (2, 64, 96)


def nyu_train_argv(zip_path: str, log: str, dev, bf16: bool = False):
    """train_nyu's flags for the published row: DenseNet161 +
    NyuDecoderWave at 640x480, B=8, lr 1e-4, one epoch, a validation batch
    at every step, scratch weights."""
    return ["--data_path", zip_path, "--log_dir", log, "--model_name",
            "densenet161_wave", "--encoder_type", "densenet",
            "--use_wavelets", "--batch_size", str(NYU_TRAIN_B), "--epochs",
            "1", "--log_frequency", "1", "--no-pretrained_encoder",
            "--device", str(dev)] + (["--bfloat16"] if bf16 else [])


def kernel_launch_total() -> int:
    """Launches of the six kernels counted so far, every dtype."""
    from wavelet_monodepth_tpu_torch.ops import blockio as bio
    from wavelet_monodepth_tpu_torch.ops import fused_stage as fs
    from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
    from wavelet_monodepth_tpu_torch.ops import warp
    return sum(sum(d.values()) for d in (tsc.launches, warp.launches,
                                         bio.launches, bio.launches_bf16,
                                         fs.launches))


def run_train_nyu(dev, zip_path: str, log: str, bf16: bool) -> str:
    """tools/train_nyu.main for one epoch (3 steps, 3 validation batches);
    checks its losses, its checkpoint and that it launched none of the
    six kernels (the training decoder is dense). Returns the folder."""
    import numpy as np
    import torch
    from wavelet_monodepth_tpu_torch.tools import train_nyu
    before = kernel_launch_total()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = train_nyu.main(nyu_train_argv(zip_path, log, dev, bf16),
                             device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    require(summary["steps"] == 3 and summary["val_batches"] == 3, summary)
    require(all(np.isfinite(v) for d in summary["losses"]
                + summary["val_losses"] for v in d.values()),
            ("finite NYU losses", summary))
    folder = summary["checkpoints"][-1]
    need = [os.path.join(folder, f) for f in ("model.pth", "adam.pth")]
    opt_json = os.path.join(os.path.dirname(folder), "opt.json")
    require(all(os.path.isfile(f) for f in need + [opt_json]), need)
    dtypes = float_dtypes_of(*need)
    require(dtypes == ["torch.float32"], ("NYU checkpoint dtypes", dtypes))
    launched = kernel_launch_total() - before
    require(launched == 0, ("kernel launches on the NYU train path",
                            launched))
    emit({"phase": "nyu_train", "run": "train_main", "bfloat16": bf16,
          "batch": NYU_TRAIN_B, "res": [NYU_H, NYU_W],
          "steps": summary["steps"], "val_batches": summary["val_batches"],
          "kernel_launches": launched, "main_seconds": seconds,
          "checkpoint_float_dtypes": dtypes, "losses": summary["losses"],
          "val_losses": summary["val_losses"], "checkpoint": folder,
          **_card})
    return folder


def score_nyu_checkpoint(dev, folder: str, tmp: str) -> None:
    """tools/evaluate_nyu.main --load_weights_folder on the checkpoint, over
    NYU_EVAL_FRAMES of the nyu phase's synthetic labeled frames (handed to
    main in place of the .mat reader: the card's machine may lack h5py)
    with their Canny edges as GT edge PNGs."""
    import numpy as np
    from PIL import Image
    from wavelet_monodepth_tpu_torch.eval import nyu_eval
    from wavelet_monodepth_tpu_torch.tools import evaluate_nyu
    rgb, depth, edges = nyu_frames(NYU_EVAL_FRAMES, seed=1)
    edges_dir = os.path.join(tmp, "nyu_train_edges")
    os.makedirs(edges_dir, exist_ok=True)
    for i, e in enumerate(edges):
        Image.fromarray(e.astype(np.uint8) * 255).save(
            os.path.join(edges_dir, f"{i + 1:04d}.png"))
    reader = nyu_eval.load_nyu_labeled
    nyu_eval.load_nyu_labeled = lambda *a: (rgb, depth)
    try:
        t0 = time.perf_counter()
        row = evaluate_nyu.main([
            "--data_path", "synthetic", "--splits_path", "synthetic",
            "--load_weights_folder", folder, "--use_wavelets",
            "--edges_dir", edges_dir, "--device", str(dev)])
        seconds = time.perf_counter() - t0
    finally:
        nyu_eval.load_nyu_labeled = reader
    require(all(np.isfinite(row[k]) for k in NYU_ROW), ("NYU row", row))
    emit({"phase": "nyu_train", "run": "evaluate_checkpoint",
          "frames": NYU_EVAL_FRAMES, "row": {k: float(row[k])
                                              for k in NYU_ROW},
          "seconds": seconds, "checkpoint": folder})


def nyu_setup(dev, bf16: bool = False, twin: bool = False):
    """(NyuTrainSetup, its state from seed 0) of the published row, or of
    the learning twin (mobilenet_light)."""
    import torch
    from wavelet_monodepth_tpu_torch.train.nyu import NyuTrainSetup
    from wavelet_monodepth_tpu_torch.utils.config import parse_nyu_args
    argv = nyu_train_argv("unused", "unused", dev, bf16)
    if twin:
        argv += ["--encoder_type", "mobilenet_light", "--batch_size",
                 str(NYU_TWIN[0])]
    setup = NyuTrainSetup(parse_nyu_args(argv), device=dev)
    return setup, setup.init_state(torch.Generator().manual_seed(0))


def nyu_twin_contract(dev, bf16: bool, steps: int = 30) -> dict:
    """The learning contract: mobilenet_light at 64x96, B=2, lr 1e-4, one
    fixed seeded batch (depth a vertical ramp of 100-500 cm plus 0-20 cm
    of noise), 30 steps: the loss falls by >= 10%; masters, BN
    statistics and Adam moments float32 after."""
    import numpy as np
    import torch
    n, h, w = NYU_TWIN
    rs = np.random.RandomState(0)
    image = torch.from_numpy(rs.rand(n, h, w, 3).astype(np.float32)).to(dev)
    ramp = np.linspace(100.0, 500.0, h // 2)[None, :, None, None]
    depth = torch.from_numpy((ramp + 20.0 * rs.rand(n, h // 2, w // 2, 1))
                             .astype(np.float32)).to(dev)
    setup, state = nyu_setup(dev, bf16, twin=True)
    losses = [float(setup.train_step(state, image, depth)["loss"])
              for _ in range(steps)]
    dtypes = state_float_dtypes(state)
    out = {"bfloat16": bf16, "first": losses[0], "last": losses[-1],
           "fall": 1.0 - losses[-1] / losses[0], "dtypes": dtypes}
    require(np.isfinite(losses).all() and out["fall"] >= 0.10
            and dtypes == ["torch.float32"], ("NYU learning twin", out))
    return out


# up3.convA's reflect-padded input at B=8: the conv cuDNN runs as an FFT
UP3_CONVA_INPUT = [NYU_TRAIN_B, 372, NYU_H // 4 + 2, NYU_W // 4 + 2]


def conv_breakdown(prof, top: int = 6) -> list:
    """The `top` convolutions of a trace with shapes recorded
    (trace_calls(..., shapes=True)) by device time, forward
    (aten::cudnn_convolution) and backward (aten::convolution_backward),
    and up3.convA's forward and backward whatever their rank, with their
    input shapes and their costliest kernels."""
    rows = {}
    for e in prof.events():
        if e.name not in ("aten::cudnn_convolution",
                          "aten::convolution_backward"):
            continue
        kern = {}
        stack = [e]
        while stack:                  # the kernels of e and its children
            c = stack.pop()
            for k in c.kernels:
                kern[k.name] = kern.get(k.name, 0.0) + k.duration
            stack.extend(c.cpu_children)
        if not kern:
            continue
        shapes = [list(map(int, s)) for s in e.input_shapes[:3] if s]
        key = (e.name, json.dumps(shapes))
        row = rows.setdefault(key, {"op": e.name, "input_shapes": shapes,
                                    "calls": 0, "device_ms": 0.0,
                                    "kernels_us": {}})
        row["calls"] += 1
        row["device_ms"] += sum(kern.values()) / 1e3
        for k, us in kern.items():
            row["kernels_us"][k] = row["kernels_us"].get(k, 0.0) + us
    ranked = sorted(rows.values(), key=lambda r: -r["device_ms"])
    out = ranked[:top] + [r for r in ranked[top:]
                          if UP3_CONVA_INPUT in r["input_shapes"]]
    for r in out:
        names = sorted(r["kernels_us"].items(), key=lambda kv: -kv[1])
        r["kernels_us"] = {k[:90]: v for k, v in names[:4]}
        r["up3_convA"] = UP3_CONVA_INPUT in r["input_shapes"]
        r["fft"] = any("fft" in k.lower() or "cf32" in k.lower()
                       or "cgemm" in k.lower() for k, _ in names)
    return out


def phase_nyu_train(dev, tmp: str) -> str:
    """The NYUv2 training slice on the card (module docstring, phase 13).
    Returns the fabricated zip."""
    import numpy as np
    import torch
    from wavelet_monodepth_tpu_torch.data import nyu as nyu_data
    from wavelet_monodepth_tpu_torch.data import synth
    from wavelet_monodepth_tpu_torch.data.loader import (parallel_batches,
                                                        to_device)
    from wavelet_monodepth_tpu_torch.ops.augment import expand_nyu

    t_phase = time.perf_counter()
    zip_path = os.path.join(tmp, "nyu_data.zip")
    synth.fabricate_nyu(zip_path, n_train=NYU_TRAIN_FRAMES)
    emit({"phase": "nyu_train", "run": "fabricate_nyu",
          "frames": NYU_TRAIN_FRAMES,
          "seconds": time.perf_counter() - t_phase})
    folder = run_train_nyu(dev, zip_path, os.path.join(tmp, "nyu_log"),
                           bf16=False)
    run_train_nyu(dev, zip_path, os.path.join(tmp, "nyu_log_bf16"),
                  bf16=True)
    score_nyu_checkpoint(dev, folder, tmp)

    # one B=8 batch of the zip through the port's dataset and loader
    train_ds, _ = nyu_data.get_training_testing_data(zip_path,
                                                     uint8_feed=True)
    src = parallel_batches(train_ds, NYU_TRAIN_B, num_workers=4)
    batch = next(to_device(src, dev))
    src.close()
    image, depth = batch["image"], batch["depth"]

    # card vs CPU: a train-mode forward and the losses at B=1, seed 0
    checks = {}
    with torch.no_grad():
        losses = {}
        for side, d in (("card", dev), ("host", torch.device("cpu"))):
            setup, state = nyu_setup(d)
            img, dep = expand_nyu(image[:1].to(d), depth[:1].to(d))
            losses[side] = {k: float(v) for k, v in setup.compute_losses(
                setup.forward(state, img, train=True), dep).items()}
            del setup, state
    checks["card_vs_cpu_loss_rel"] = max(
        abs(losses["card"][k] - v) / abs(v) for k, v in losses["host"].items())
    torch.cuda.empty_cache()

    # the first step of the same weights and batch in f32 and bf16, each
    # with its peak memory
    runs = {}
    for name, bf16 in (("f32", False), ("bf16", True)):
        runs[name] = nyu_setup(dev, bf16)
    first, peak = {}, {}
    for name, (setup, state) in runs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        first[name] = float(setup.train_step(state, image, depth)["loss"])
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    dtypes = state_float_dtypes(runs["bf16"][1])
    checks.update(card_vs_cpu_losses=losses, first_step_loss=first,
                  bf16_vs_f32_first_loss_rel=abs(first["bf16"] - first["f32"])
                  / abs(first["f32"]), bf16_state_dtypes=dtypes,
                  twin=[nyu_twin_contract(dev, bf16) for bf16 in (False,
                                                                   True)])
    emit({"phase": "nyu_train", "run": "checks", **checks, **_card})
    require(checks["card_vs_cpu_loss_rel"] <= 1e-4
            and checks["bf16_vs_f32_first_loss_rel"] <= 0.01
            and dtypes == ["torch.float32"], checks)

    # ms per B=8 step, idle share, device time by ATen op, convs
    steps = {name: (lambda s=s, st=st: s.train_step(st, image, depth))
             for name, (s, st) in runs.items()}
    t = time_variants(steps, iters=2)
    emit({"phase": "nyu_train", "run": "time_train_step",
          "batch": NYU_TRAIN_B, "res": [NYU_H, NYU_W], "tf32": False,
          "peak_memory_gib_first_step": peak, **t, **_card})
    for name, fn in steps.items():
        _, by_kernel, by_op, busy, wall_ms, prof = trace_calls(
            fn, 1, shapes=True)
        emit({"phase": "nyu_train", "run": "profile_train_step",
              "dtype": name, "kernels": sum(v[0] for v in by_kernel.values()),
              "device_busy_ms": busy / 1e3, "wall_ms": wall_ms,
              "idle_share": 1.0 - busy / 1e3 / wall_ms,
              "top_aten_ops_ms": {k: v[0] / 1e3 for k, v in sorted(
                  ((k, v) for k, v in by_op.items()
                   if k.startswith("aten::")),
                  key=lambda kv: -kv[1][0])[:8]},
              "costliest_convs": conv_breakdown(prof), **_card})
    del runs, steps
    torch.cuda.empty_cache()
    emit({"phase": "nyu_train_done",
          "seconds": time.perf_counter() - t_phase})
    return zip_path


# --- phase 14: the remaining KITTI models ------------------------------------

POSE_SPLIT = "chip_pose"
ODOM_FRAMES = 8
HINT_H, HINT_W = 320, 1024


def write_pose_split(root: str) -> None:
    """Split "chip_pose" of phase 8's mount: its interior frames 1..34 (each
    line has frames k - 1 and k + 1, and its own side's hints), then the
    first two again: 36 lines, 3 steps at B=12; val: the first 12."""
    lines = [f"{FOLDER} {k} {'l' if k % 2 == 0 else 'r'}"
             for k in range(1, 35)]
    lines += lines[:2]
    split = os.path.join(root, "splits", POSE_SPLIT)
    os.makedirs(split, exist_ok=True)
    for name, part in (("train_files.txt", lines),
                       ("val_files.txt", lines[:TRAIN_B])):
        with open(os.path.join(split, name), "w") as f:
            f.write("\n".join(part) + "\n")


def pose_argv(root: str, log: str, mono: bool = False,
              extra=()) -> list:
    """M+S + depth hints (or monocular) with the pose nets, at the
    flagship's size and batch, on the interior split."""
    argv = ["--data_path", root, "--split", POSE_SPLIT, "--log_dir", log,
            "--batch_size", str(TRAIN_B), "--height", str(H), "--width",
            str(W), "--frame_ids", "0", "-1", "1", "--use_wavelets",
            "--weights_init", "scratch", "--num_epochs", "1",
            "--log_frequency", "250", "--num_workers", "4"]
    if not mono:
        argv += ["--use_stereo", "--use_depth_hints", "--stereo_warp_kernel",
                 "on"]
    return argv + list(extra)


def pose_batch(root: str, dev):
    """One B=12 M+S batch (frames 0, -1, 1 and s, hints) of the interior
    split, without augmentation, on the card."""
    from wavelet_monodepth_tpu_torch.data import kitti as kd
    from wavelet_monodepth_tpu_torch.data.loader import (parallel_batches,
                                                        to_device)
    from wavelet_monodepth_tpu_torch.data.splits import read_split
    lines = read_split(POSE_SPLIT, "train_files.txt", root)
    ds = kd.KittiRawDataset(root, lines, H, W, [0, -1, 1, "s"], [0, 1, 2, 3],
                            is_train=False, use_depth_hints=True,
                            aug_scales=(0,), other_frame_scales=(0,),
                            device_augment=True)
    stream = parallel_batches(ds, TRAIN_B, num_workers=4)
    try:
        return next(to_device(stream, dev))
    finally:
        stream.close()


def pose_setup(argv, device, gen_seed: int = 0):
    """(setup, state, noise) of the training CLI's flags on `device`."""
    import torch
    from wavelet_monodepth_tpu_torch.train.kitti import KittiTrainSetup
    from wavelet_monodepth_tpu_torch.utils.config import parse_kitti_args
    setup = KittiTrainSetup(parse_kitti_args(argv), steps_per_epoch=1000,
                            device=device)
    state = setup.init_state(torch.Generator().manual_seed(gen_seed))
    noise = torch.Generator(device=device).manual_seed(0)
    return setup, state, noise


def host_forward_losses(argv, batch) -> dict:
    """The losses of a train-mode forward on the host, on the seed-0
    weights and `batch` (moved to the host)."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import augment
    cpu = torch.device("cpu")
    setup, state, noise = pose_setup(argv, cpu)
    with torch.no_grad():
        _, losses = setup.forward(
            state, augment.expand_batch({k: v.cpu() for k, v in
                                         batch.items()}), noise, train=True)
    return {k: float(v) for k, v in losses.items()}


def max_rel(a: dict, b: dict) -> float:
    return max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30) for k in b)


def pose_state_dtypes(state) -> list:
    import torch
    tensors = [t for m in state.modules().values()
               for t in list(m.parameters()) + list(m.buffers())]
    tensors += [v for d in state.optimizer.state.values()
                for v in d.values() if torch.is_tensor(v)]
    return sorted({str(t.dtype) for t in tensors if t.is_floating_point()})


def write_odom_tree(root: str) -> None:
    """A KITTI odometry layout: sequence 09 as ODOM_FRAMES 1241x376 PNGs
    (maskgen scenes), poses/09.txt (forward motion with a slow yaw) and
    the split splits/odom/test_files_09.txt."""
    import numpy as np
    from PIL import Image
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg
    h, w = 376, 1241
    disp = mg.synthetic_depth_scene(ODOM_FRAMES, h, w, seed=3)
    imgs = (mg.scene_image(disp, seed=3) * 255).astype(np.uint8)
    seq = os.path.join(root, "sequences", "09", "image_2")
    os.makedirs(seq)
    for f in range(ODOM_FRAMES):
        Image.fromarray(imgs[f]).save(os.path.join(seq, f"{f:06d}.png"))
    os.makedirs(os.path.join(root, "poses"))
    rows = []
    for i in range(ODOM_FRAMES):
        th = 0.02 * i
        t = np.array([[np.cos(th), 0, np.sin(th), 0.1 * i],
                      [0, 1, 0, 0.01 * i],
                      [-np.sin(th), 0, np.cos(th), 0.5 * i]])
        rows.append(" ".join(f"{v:.9e}" for v in t.reshape(-1)))
    with open(os.path.join(root, "poses", "09.txt"), "w") as f:
        f.write("\n".join(rows) + "\n")
    split = os.path.join(root, "splits", "odom")
    os.makedirs(split)
    with open(os.path.join(split, "test_files_09.txt"), "w") as f:
        f.write("".join(f"9 {k} l\n" for k in range(ODOM_FRAMES - 1)))


def hint_fusion_inputs(seed: int = 0):
    """A stereo pair of a maskgen scene at 1024x320 (the right view shifted
    by the scene's disparity, uint8) and 12 seeded candidate depth maps
    shaped as SGBM's are: the scene's depth times a smooth factor in
    0.7-1.3 per candidate, with holes (0) where a second smooth field
    falls below 0.1."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from wavelet_monodepth_tpu_torch.utils import maskgen as mg
    disp = mg.synthetic_depth_scene(1, HINT_H, HINT_W, seed=seed)[0, ..., 0]
    base = (mg.scene_image(disp[None, ..., None], seed=seed)[0]
            * 255).astype(np.uint8)
    d_px = 1.0 + disp * 0.03 * HINT_W
    src_x = np.clip(np.round(np.arange(HINT_W)[None] + d_px).astype(int),
                    0, HINT_W - 1)
    lookup = np.take_along_axis(base, src_x[..., None].repeat(3, -1), axis=1)
    depth = 0.58 * HINT_W * 0.1 / d_px

    def smooth(n):
        g = torch.Generator().manual_seed(seed + n)
        low = torch.rand(12, 1, HINT_H // 32, HINT_W // 32, generator=g)
        return F.interpolate(low, size=(HINT_H, HINT_W), mode="bilinear",
                             align_corners=False)[:, 0].numpy()
    depths = depth[None] * (0.7 + 0.6 * smooth(1))
    depths[smooth(2) < 0.1] = 0.0
    return depths.astype(np.float32), base, lookup


def phase_kitti_pose(dev, root: str, tmp: str, stereo_launches: dict):
    """The remaining KITTI models on the card (module docstring, phase
    14). Returns the K3 launches of the M+S run."""
    import numpy as np
    import torch
    from wavelet_monodepth_tpu_torch.ops import augment, warp
    from wavelet_monodepth_tpu_torch.tools import evaluate_pose, train_kitti
    from wavelet_monodepth_tpu_torch.tools import precompute_depth_hints \
        as hints_tool

    t_phase = time.perf_counter()

    def note(obj: dict) -> None:
        emit({**obj, "phase_seconds": time.perf_counter() - t_phase})
    write_pose_split(root)

    # (a) M+S + depth hints through the training CLI
    log = os.path.join(tmp, "log_pose")
    torch.cuda.synchronize()
    warp.reset_launches()
    before = kernel_launch_total()
    t0 = time.perf_counter()
    summary = train_kitti.main(pose_argv(root, log), device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(warp.launches)
    others = kernel_launch_total() - before - sum(launches.values())
    folder = summary["checkpoints"][-1]
    files = sorted(os.listdir(folder))
    dtypes = float_dtypes_of(*[os.path.join(folder, f) for f in files])
    note({"phase": "kitti_pose", "check": "ms_train_main",
          "steps": summary["steps"], "val_batches": summary["val_batches"],
          "batch": TRAIN_B, "res": [H, W], "k3_launches": launches,
          "k3_launches_stereo_only": stereo_launches,
          "other_kernel_launches": others, "main_seconds": seconds,
          "checkpoint_files": files, "checkpoint_float_dtypes": dtypes,
          "losses": summary["losses"], **_card})
    require(summary["steps"] == 3 and summary["val_batches"] == 1, summary)
    require(all(np.isfinite(v) for d in summary["losses"] for v in d.values()),
            ("finite M+S losses", summary["losses"]))
    require(launches == stereo_launches and others == 0,
            ("M+S kernel launches", launches, stereo_launches, others))
    require({"pose_encoder.pth", "pose.pth", "adam.pth"} <= set(files)
            and dtypes == ["torch.float32"], (files, dtypes))

    # M+S times: f32 and bf16 steps on one batch, peak memory, profiles
    t0 = time.perf_counter()
    batch = pose_batch(root, dev)
    load_seconds = time.perf_counter() - t0
    runs, peak, first = {}, {}, {}
    for name, extra in (("f32", ()), ("bf16", ("--bfloat16",))):
        runs[name] = pose_setup(pose_argv(root, log, extra=extra), dev)
        setup, state, noise = runs[name]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        first[name] = float(setup.train_step(state, batch, noise)["loss"])
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    steps = {name: (lambda r=r: r[0].train_step(r[1], batch, r[2]))
             for name, r in runs.items()}
    t = time_variants(steps, iters=2)
    idle = {}
    for name, fn in steps.items():
        spans, _, by_op, busy, wall_ms, _ = trace_calls(fn, 1)
        top = sorted(((v[0], k) for k, v in by_op.items()
                      if k.startswith("aten::")), reverse=True)[:8]
        idle[name] = {"device_busy_ms_per_step": busy / 1e3 if spans
                      else None, "wall_ms_per_step": wall_ms,
                      "idle_share": 1.0 - busy / 1e3 / wall_ms if spans
                      else None, "kernels_per_step": len(spans),
                      "top_aten_ops_ms_per_step": [[k, v / 1e3]
                                                   for v, k in top]}
    bf16_dtypes = pose_state_dtypes(runs["bf16"][1])
    note({"phase": "kitti_pose", "check": "ms_time_train_step",
          "batch": TRAIN_B, "res": [H, W], "tf32": False,
          "stereo_warp_kernel": "on", "first_step_loss": first,
          "peak_memory_gib_first_step": peak,
          "peak_memory_note": "the f32 state stays resident for bf16's",
          "batch_load_seconds": load_seconds,
          "profile": idle, "bf16_state_float_dtypes": bf16_dtypes, **t,
          **_card})
    require(bf16_dtypes == ["torch.float32"], bf16_dtypes)
    del runs, steps
    torch.cuda.empty_cache()

    # card vs host: a train-mode forward at B=1
    b1 = {k: v[:1] for k, v in batch.items()}
    setup, state, noise = pose_setup(pose_argv(root, log), dev)
    with torch.no_grad():
        _, card = setup.forward(state, augment.expand_batch(b1), noise,
                                train=True)
    card = {k: float(v) for k, v in card.items()}
    host = host_forward_losses(pose_argv(root, log), b1)
    rel = max_rel(card, host)
    note({"phase": "kitti_pose", "check": "ms_card_vs_cpu_b1",
          "loss_max_rel_diff": rel, "losses_card": card, "losses_host": host,
          **_card})
    require(rel <= 1e-4, ("M+S card vs host", rel))
    del setup, state

    # (b) odometry eval of the M+S checkpoint, card and host
    odom = os.path.join(tmp, "kitti_odom")
    write_odom_tree(odom)
    ates, secs = {}, {}
    before = kernel_launch_total()
    for side, d in (("card", str(dev)), ("host", "cpu")):
        t0 = time.perf_counter()
        out = evaluate_pose.main(["--data_path", odom, "--eval_split",
                                  "odom_9", "--load_weights_folder", folder,
                                  "--device", d])
        secs[side] = time.perf_counter() - t0
        ates[side] = (out["ate_mean"], out["ate_std"])
    launched = kernel_launch_total() - before
    note({"phase": "kitti_pose", "check": "evaluate_pose",
          "frames": ODOM_FRAMES, "ate": ates, "seconds": secs,
          "kernel_launches": launched, **_card})
    require(all(np.isfinite(v) for v in ates["card"]) and launched == 0,
            ates)
    require(abs(ates["card"][0] - ates["host"][0])
            <= 1e-4 * max(1.0, ates["host"][0]), ("card vs host ATE", ates))

    # (c) PoseCNN "all" and (d) the baseline: one B=12 step, card vs host,
    # on the M+S batch without the frames and inputs each does not read
    mono = {k: v for k, v in batch.items()
            if not (k[0] == "color_u8" and k[1] == "s")
            and k[0] not in ("stereo_T", "depth_hint", "depth_hint_mask",
                             "disp_hint")}
    stereo = {k: v for k, v in batch.items()
              if not (k[0] == "color_u8" and k[1] in ("-1", "1"))}
    for name, argv, b in (
            ("posecnn_all", pose_argv(root, log, mono=True, extra=(
                "--pose_model_type", "posecnn", "--pose_model_input",
                "all")), mono),
            ("baseline", train_argv(root, log, "on") + ["--no-use_wavelets"],
             stereo)):
        setup, state, noise = pose_setup(argv, dev)
        before = kernel_launch_total()
        card = {k: float(v) for k, v in
                setup.train_step(state, b, noise).items()}
        torch.cuda.synchronize()
        k3 = kernel_launch_total() - before
        host = host_forward_losses(argv, b)
        rel = max_rel(card, host)
        entry = {"phase": "kitti_pose", "check": f"{name}_step",
                 "batch": TRAIN_B, "res": [H, W], "loss_max_rel_diff": rel,
                 "kernel_launches": k3, "losses_card": card,
                 "losses_host": host}
        if name == "baseline":
            # the B=12 eval forward of the seed-0 weights, card vs host
            _, state_c, _ = pose_setup(argv, dev)
            _, state_h, _ = pose_setup(argv, torch.device("cpu"))
            x = augment.expand_batch(b)[("color_aug", "0", 0)]
            with torch.no_grad():
                dc = state_c.decoder(state_c.encoder.eval()(x))
                dh = state_h.decoder(state_h.encoder.eval()(x.cpu()))
            entry["eval_disp_max_abs_diff"] = max(
                float((dc[k].cpu() - dh[k]).abs().max()) for k in dh)
            require(entry["eval_disp_max_abs_diff"] <= 1e-4, entry)
            del state_c, state_h
        note({**entry, **_card})
        require(rel <= 1e-4 and all(np.isfinite(v) for v in card.values()),
                entry)
        del setup, state

    # (e) MobileNetV2 from scratch through the training CLI
    t0 = time.perf_counter()
    mb = train_kitti.main(train_argv(root, os.path.join(tmp, "log_mbv2"),
                                     "auto") + ["--encoder_type",
                                                "mobilenet"], device=dev)
    note({"phase": "kitti_pose", "check": "mobilenet_train_main",
          "steps": mb["steps"], "batch": TRAIN_B, "res": [H, W],
          "main_seconds": time.perf_counter() - t0, "losses": mb["losses"],
          **_card})
    require(mb["steps"] == 36 // TRAIN_B and mb["val_batches"] == 1
            and all(np.isfinite(v) for d in mb["losses"]
                    for v in d.values()), mb)

    # (f) hint fusion at 1024x320, card vs host
    depths, base, lookup = hint_fusion_inputs()
    card = hints_tool.fuse_depths(depths, base, lookup, -1, dev)
    host = hints_tool.fuse_depths(depths, base, lookup, -1, "cpu")
    # a pixel may choose differently only where its two choices' losses
    # lie within 1e-5, or within the two sides' own disagreement on them
    # (float32 rounding of the projection at 1024 wide moves a sample by
    # ~1e-4 px, and a loss by up to ~1e-4 at a sharp edge)
    with torch.no_grad():
        losses = {side: hints_tool.fusion_losses(
            torch.from_numpy(depths).to(d), torch.from_numpy(base).to(d),
            torch.from_numpy(lookup).to(d), -1).cpu().numpy()
            for side, d in (("card", dev), ("host", "cpu"))}
    pick = {side: losses[side].argmin(axis=0) for side in losses}

    def at(side, idx):
        return np.take_along_axis(losses[side], idx[None], axis=0)[0]
    gap = np.abs(at("host", pick["card"]) - at("host", pick["host"]))
    noise = (np.abs(at("card", pick["card"]) - at("host", pick["card"]))
             + np.abs(at("card", pick["host"]) - at("host", pick["host"])))
    tie = (gap <= 1e-5) | (gap <= noise)
    loss_gap = float(np.abs(losses["card"] - losses["host"]).max())
    differ = card != host
    t = time_variants({"fuse_depths": lambda: hints_tool.fuse_depths(
        depths, base, lookup, -1, dev)}, iters=3)
    note({"phase": "kitti_pose", "check": "hint_fusion",
          "res": [HINT_H, HINT_W], "candidates": 12,
          "pixels_differ": int(differ.sum()),
          "pixels_differ_not_tie": int((differ & ~tie).sum()),
          "pixels_differ_gap_over_1e-5": int((differ & (gap > 1e-5)).sum()),
          "loss_max_abs_diff_card_vs_host": loss_gap,
          "valid_share": float((card > 0).mean()), **t, **_card})
    require(not (differ & ~tie).any(), ("hint fusion card vs host",
                                        int((differ & ~tie).sum())))
    emit({"phase": "kitti_pose_done",
          "seconds": time.perf_counter() - t_phase, **_card})
    return launches


# --- phase 15: KITTI 1024x320 B=6 training ----------------------------------

HR_B = 6                            # the published HR rows' batch
HR_SPLIT = "chip_hr"
HR_STEPS = 3


def write_hr_split(root: str) -> None:
    """Split "chip_hr" of phase 8's mount: its first 18 lines (3 steps at
    B=6); val: the first 6."""
    from wavelet_monodepth_tpu_torch.data.splits import read_split
    lines = read_split("chip", "train_files.txt", root)[:HR_STEPS * HR_B]
    split = os.path.join(root, "splits", HR_SPLIT)
    os.makedirs(split, exist_ok=True)
    for name, part in (("train_files.txt", lines),
                       ("val_files.txt", lines[:HR_B])):
        with open(os.path.join(split, name), "w") as f:
            f.write("\n".join(part) + "\n")


def hr_argv(root: str, log: str, kern: str = "on", depth: int = 18,
            extra=(), hints: bool = True) -> list:
    """Stereo + depth hints at 1024x320, B=6 (the HR rows' training);
    hints=False gives phase 9's argmin-free variant."""
    return ["--data_path", root, "--split", HR_SPLIT, "--log_dir", log,
            "--batch_size", str(HR_B), "--height", str(R50_H), "--width",
            str(R50_W), "--num_layers", str(depth), "--use_stereo",
            "--frame_ids", "0", "--use_wavelets",
            "--weights_init", "scratch", "--stereo_warp_kernel", kern,
            "--num_epochs", "1", "--log_frequency", "250",
            "--num_workers", "4"] + (
                ["--use_depth_hints"] if hints else ["--disable_automasking"]
            ) + list(extra)


def run_hr_main(dev, root: str, log: str, name: str, depth: int = 18,
                extra=()) -> dict:
    """tools/train_kitti.main at 1024x320 B=6 for one epoch (3 steps, one
    validation batch), every kernel count from 0 just before it; checks
    its losses, its K3 launches (5 + 4 per step, 5 more for the
    validation batch), no other kernel and a float32 checkpoint. Returns
    the K3 launches."""
    import numpy as np
    import torch
    from wavelet_monodepth_tpu_torch.ops import warp
    from wavelet_monodepth_tpu_torch.tools import train_kitti
    torch.cuda.synchronize()
    warp.reset_launches()
    before = kernel_launch_total()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    summary = train_kitti.main(hr_argv(root, log, depth=depth, extra=extra),
                               device=dev, logger=no_writer())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(warp.launches)
    others = kernel_launch_total() - before - sum(launches.values())
    folder = summary["checkpoints"][-1]
    dtypes = float_dtypes_of(*[os.path.join(folder, f)
                               for f in sorted(os.listdir(folder))])
    emit({"phase": "kitti_hr_train", "check": "train_main", "run": name,
          "encoder": f"resnet{depth}", "batch": HR_B, "res": [R50_H, R50_W],
          "steps": summary["steps"], "val_batches": summary["val_batches"],
          "k3_launches": launches, "other_kernel_launches": others,
          "main_seconds_incl_load_and_init": seconds,
          "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
          "checkpoint_float_dtypes": dtypes, "losses": summary["losses"],
          **_card})
    require(summary["steps"] == HR_STEPS and summary["val_batches"] == 1,
            summary)
    require(all(np.isfinite(v) for d in summary["losses"] for v in d.values()),
            ("finite HR losses", name, summary["losses"]))
    require(launches == {"banded_warp_fwd": 5 * (HR_STEPS + 1),
                         "banded_warp_bwd": 4 * HR_STEPS} and others == 0,
            ("HR kernel launches", name, launches, others))
    require(dtypes == ["torch.float32"], ("HR checkpoint dtypes", dtypes))
    return launches


def phase_kitti_hr_train(dev, root: str, tmp: str, errs: dict) -> dict:
    """KITTI 1024x320 B=6 stereo + hints training on the card (module
    docstring, phase 15). Returns the kernels line's K3 numbers at this
    shape, with the R18 f32 run's launches."""
    import torch
    from wavelet_monodepth_tpu_torch.ops import augment
    from wavelet_monodepth_tpu_torch.ops.geometry import disp_to_depth
    from wavelet_monodepth_tpu_torch.ops.image import resize_bilinear

    t_phase = time.perf_counter()
    write_hr_split(root)
    launches = run_hr_main(dev, root, os.path.join(tmp, "log_hr18"),
                           "r18_f32")
    run_hr_main(dev, root, os.path.join(tmp, "log_hr18_bf16"), "r18_bf16",
                extra=["--bfloat16"])
    run_hr_main(dev, root, os.path.join(tmp, "log_hr50"), "r50_f32",
                depth=50)

    # one unflipped B=6 batch with a positive baseline (phase 9's reasons)
    batch = loader_batch(root, dev, HR_B, is_train=False,
                         size=(R50_H, R50_W), split=HR_SPLIT)
    batch[("stereo_T",)][:, 0, 3] = 0.1
    for hints in (True, False):
        check_on_vs_off(on_vs_off(
            dev, root, batch, hints,
            lambda kern, hints: hr_argv(root, "unused", kern, hints=hints),
            reruns=False), batch, hints, phase="kitti_hr_on_vs_off",
            hint_losses_within=False)
    torch.cuda.empty_cache()

    # K3 against plain on the path's grids: the hints' and a seeded
    # ResNet18's disparities at scales 0 and 3, both baselines
    g = torch.Generator().manual_seed(14)
    img = batch[("color_u8", "s", 0)].float() / 255.0
    hint = batch[("depth_hint",)]
    valid = (hint > 0)[..., 0]
    cases = [(f"hints_tx{t:+}", stereo_grid(hint.clamp_min(1.0), t), valid)
             for t in (0.1, -0.1)]
    enc, dec = build_models(dev, seed=3)
    with torch.no_grad():
        out = dec(enc(img))
    for s in (0, 3):
        disp = resize_bilinear(out[("disp", s)], R50_H, R50_W)
        depth = disp_to_depth(disp, 0.1, 100.0)[1]
        cases += [(f"net_disp{s}_tx{t:+}", stereo_grid(depth, t), None)
                  for t in (0.1, -0.1)]
    del enc, dec, out
    for name, grid, ok in cases:
        check_warp_case(name, img, grid, errs, g, valid=ok,
                        phase="kitti_hr_warp_vs_plain")
    k3 = time_warp(img, cases[0][1], phase="kitti_hr_time_warp",
                   grid_source="the hints' stereo grid, tx +0.1")

    # ms per step, idle share, peak memory, costliest convs
    runs = {name: pose_setup(hr_argv(root, "unused", depth=d, extra=x), dev)
            for name, d, x in (("r18_f32", 18, ()),
                               ("r18_bf16", 18, ("--bfloat16",)),
                               ("r50_f32", 50, ()))}
    peak = {}
    for name, (setup, state, noise) in runs.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        setup.train_step(state, batch, noise)
        torch.cuda.synchronize()
        peak[name] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    steps = {name: (lambda r=r: r[0].train_step(r[1], batch, r[2]))
             for name, r in runs.items()}
    t = time_variants(steps, iters=2)
    emit({"phase": "kitti_hr_train", "check": "time_train_step",
          "batch": HR_B, "res": [R50_H, R50_W], "tf32": False,
          "stereo_warp_kernel": "on",
          "variants": {"r18_f32": "ResNet18, float32",
                       "r18_bf16": "ResNet18, bf16 mixed precision",
                       "r50_f32": "ResNet50, float32"},
          "peak_memory_gib_first_step": peak,
          "peak_memory_note": "earlier variants' states stay resident",
          **t, **_card})
    for name in ("r18_f32", "r18_bf16"):
        spans, _, by_op, busy, wall_ms, prof = trace_calls(
            steps[name], 1, shapes=name == "r18_f32")
        top = sorted(((v[0], k) for k, v in by_op.items()
                      if k.startswith("aten::")), reverse=True)[:8]
        emit({"phase": "kitti_hr_train", "check": "profile_train_step",
              "run": name, "kernels_per_step": len(spans),
              "device_busy_ms_per_step": busy / 1e3 if spans else None,
              "wall_ms_per_step": wall_ms,
              "idle_share": 1.0 - busy / 1e3 / wall_ms if spans else None,
              "top_aten_ops_ms_per_step": [[k, v / 1e3] for v, k in top],
              "costliest_convs": conv_breakdown(prof) if name == "r18_f32"
              else None, **_card})
    del runs, steps
    torch.cuda.empty_cache()

    # card vs host: a train-mode forward at B=1
    b1 = {k: v[:1] for k, v in batch.items()}
    setup, state, noise = pose_setup(hr_argv(root, "unused"), dev)
    with torch.no_grad():
        _, card = setup.forward(state, augment.expand_batch(b1), noise,
                                train=True)
    card = {k: float(v) for k, v in card.items()}
    host = host_forward_losses(hr_argv(root, "unused"), b1)
    rel = max_rel(card, host)
    emit({"phase": "kitti_hr_train", "check": "card_vs_cpu_b1",
          "loss_max_rel_diff": rel, "losses_card": card, "losses_host": host,
          **_card})
    require(rel <= 1e-4, ("HR card vs host losses", rel))
    del setup, state
    torch.cuda.empty_cache()
    emit({"phase": "kitti_hr_train_done",
          "seconds": time.perf_counter() - t_phase, **_card})
    return {name: {"launches_kitti_hr": launches[name],
                   "shape_kitti_hr": [HR_B, R50_H, R50_W, 3],
                   **{f"{key}_kitti_hr": val for key, val in k3[name].items()
                      if key != "bound_by"}}
            for name in ("banded_warp_fwd", "banded_warp_bwd")}


# --- phase 16: the training visuals -------------------------------------------

# the tags of one image of the stereo + hints wavelet visuals (image j's
# end in "/j"), as tests/test_torch_port_visuals.py pins them
KITTI_VISUAL_TAGS = {
    "color_0_0", "color_s_0", "color_pred_s_0", "depth_hints_mask0",
    "disp_hints", "color_depth_hint0",
    *(f"{kind}_{s}" for s in range(4) for kind in ("automask", "disp")),
    *(f"{pre}{c}_{s}" for s in range(4) for c in ("LL", "LH", "HL", "HH")
      for pre in ("", "hist_", "min/", "max/"))}
# NyuDecoderWave (640x480): disparities at scales 0-3, coefficients at
# scales 0-2 (its LL sits at scale 2, which the reference's image set
# does not log)
NYU_VISUAL_TAGS = {
    "color", "disp_0_gt",
    *(f"disp_{s}_pred" for s in range(4)),
    *(f"{pre}{c}_{s}_{side}" for s in range(3) for c in ("LH", "HL", "HH")
      for pre in ("", "hist_") for side in ("pred", "gt"))}


class Recorder:
    """A writer with tensorboardX's add_* calls that keeps what it is
    given: (kind, tag, finite, min, max, shape)."""

    def __init__(self):
        self.calls = []

    def _keep(self, kind, tag, value):
        import numpy as np
        a = np.asarray(value, np.float64)
        self.calls.append((kind, tag, bool(np.isfinite(a).all()),
                           float(a.min()), float(a.max()), a.shape))

    def add_scalar(self, tag, value, step):
        self._keep("scalar", tag, value)

    def add_image(self, tag, img, step):
        self._keep("image", tag, img)

    def add_histogram(self, tag, values, step):
        self._keep("histogram", tag, values)

    def close(self):
        pass


def visual_tags(calls, kinds=("image", "histogram")) -> set:
    return {c[1].rsplit("/", 1)[0] for c in calls if c[0] in kinds}


def checkpoint_diff(a: str, b: str, files) -> float:
    """Largest |difference| between two checkpoint folders' tensors in
    `files`."""
    import torch
    worst = 0.0
    for f in files:
        sa = torch.load(os.path.join(a, f), weights_only=True)
        sb = torch.load(os.path.join(b, f), weights_only=True)
        fa = list(sa["state"].values()) if "state" in sa else [sa]
        fb = list(sb["state"].values()) if "state" in sb else [sb]
        for da, db in zip(fa, fb):
            for k, v in da.items():
                if torch.is_tensor(v) and v.is_floating_point():
                    worst = max(worst, float((v - db[k]).abs().max()))
    return worst


def visuals_runs(run, tags: set, label: str) -> None:
    """run(logger) -> summary, with a recording writer and without one, at
    learning rate 0 with cuDNN deterministic: the card's backward is not
    bitwise reproducible (atomic adds in the upsample and padding
    backwards), so the weights stay put and every logged loss of the two
    runs is deterministic. Checks: each recorded image finite in [0, 1],
    the pinned tags, and the two runs' logged losses and model
    checkpoints bitwise equal (Adam's moments hold the gradients, so they
    are reported, not compared)."""
    import torch
    from wavelet_monodepth_tpu_torch.utils.logging import SummaryLogger
    writers = {"train": Recorder(), "val": Recorder()}
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        with_w = run(SummaryLogger("unused", writers=writers))
        seconds = time.perf_counter() - t0
        t0 = time.perf_counter()
        without = run(no_writer())
        seconds_without = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = False
    losses = ("losses", "val_losses")
    same = all(with_w.get(k) == without.get(k) for k in losses)
    folders = with_w["checkpoints"][-1], without["checkpoints"][-1]
    models = [f for f in sorted(os.listdir(folders[0])) if f != "adam.pth"]
    ck_diff = checkpoint_diff(*folders, models)
    images = [c for w in writers.values() for c in w.calls
              if c[0] == "image"]
    bad = [c[1] for c in images if not (c[2] and c[3] >= 0 and c[4] <= 1)]
    want = {t for t in tags if not t.startswith(("min/", "max/"))}
    got = {m: visual_tags(w.calls) for m, w in writers.items()}
    scalars = {m: visual_tags(w.calls, ("scalar",))
               for m, w in writers.items()}
    tags_ok = {m: got[m] == want and tags - want <= scalars[m]
               for m in writers}
    emit({"phase": "visuals", "run": label, "steps": with_w["steps"],
          "log_steps": len(with_w["losses"]),
          "records": {m: len(w.calls) for m, w in writers.items()},
          "images": len(images), "images_not_finite_in_0_1": bad,
          "tags_match": tags_ok, "losses_bitwise_equal": same,
          "model_checkpoint_max_abs_diff": ck_diff,
          "adam_max_abs_diff": checkpoint_diff(*folders, ["adam.pth"]),
          "main_seconds_with_writer": seconds,
          "main_seconds_without": seconds_without, **_card})
    require(not bad and all(tags_ok.values()),
            (label, "visual records", bad, got, scalars))
    require(same and ck_diff == 0.0,
            (label, "the writer moved training", same, ck_diff))


def phase_visuals(dev, root: str, tmp: str, nyu_zip: str) -> None:
    """The training visuals on the card (module docstring, phase 16)."""
    from wavelet_monodepth_tpu_torch.tools import train_kitti, train_nyu
    t_phase = time.perf_counter()
    count = [0]

    def kitti(logger):
        count[0] += 1
        return train_kitti.main(
            train_argv(root, os.path.join(tmp, f"log_vis{count[0]}"))
            + ["--log_frequency", "1", "--learning_rate", "0"], device=dev,
            logger=logger)

    def nyu(logger):
        count[0] += 1
        return train_nyu.main(
            nyu_train_argv(nyu_zip, os.path.join(tmp, f"log_vis{count[0]}"),
                           dev, bf16=True) + ["--lr", "0"], device=dev,
            logger=logger)

    visuals_runs(kitti, KITTI_VISUAL_TAGS, "train_kitti")
    visuals_runs(nyu, NYU_VISUAL_TAGS, "train_nyu_bf16")
    emit({"phase": "visuals_done", "seconds": time.perf_counter() - t_phase})


# --- phase 17: the soak -------------------------------------------------------

SOAK_SPLIT = "chip_soak"
SOAK_STEPS_PER_EPOCH = 20
SOAK_EPOCHS = 4


def phase_soak(dev, root: str, tmp: str) -> None:
    """tools/soak_kitti.py on phase 8's mount (module docstring, phase 17)."""
    from wavelet_monodepth_tpu_torch.data.splits import read_split
    from wavelet_monodepth_tpu_torch.tools import soak_kitti
    t_phase = time.perf_counter()
    lines = read_split("chip", "train_files.txt", root)
    n = SOAK_STEPS_PER_EPOCH * TRAIN_B
    lines = (lines * (n // len(lines) + 1))[:n]
    split = os.path.join(root, "splits", SOAK_SPLIT)
    os.makedirs(split, exist_ok=True)
    for name, part in (("train_files.txt", lines),
                       ("val_files.txt", lines[:TRAIN_B])):
        with open(os.path.join(split, name), "w") as f:
            f.write("\n".join(part) + "\n")
    import torch
    torch.cuda.empty_cache()        # the trainer is another process
    with contextlib.redirect_stdout(sys.stderr):
        s = soak_kitti.main([
            "--data_path", root, "--split", SOAK_SPLIT,
            "--out", os.path.join(tmp, "soak", "soak.json"),
            "--num_epochs", str(SOAK_EPOCHS), "--kill_after_epoch", "2",
            "--interval", "0.5", "--poll", "0.2", "--kill_delay", "0.5",
            "--log_frequency", "10", "--device", str(dev)])
    keep = ("config", "steps_per_epoch", "total_steps", "wall_s",
            "resumed_at_epoch", "n_logged_lines", "first_losses",
            "last_losses", "epoch_mean_loss", "examples_s_early",
            "examples_s_late", "phase_b_wall_s", "phase_b_ms_per_step",
            "rss_mb_first", "rss_mb_max", "rss_mb_last", "anon_mb_max",
            "anon_mb_last", "anon_mb_per_min_after_warmup", "checks", "ok")
    emit({"phase": "soak", **{k: s[k] for k in keep},
          "rss_samples": len(s["rss_timeline"]),
          "seconds": time.perf_counter() - t_phase, **_card})
    failed = [k for k, v in s["checks"].items()
              if not v and k != "anon_rss_stable"]
    require(not failed, ("soak checks", failed))


# --- phase 17b: the self-golden check on the soak's checkpoint --------------

def self_golden_gates(s: dict) -> dict:
    """What the port owns in tools/self_golden.py's summary: finite rows,
    densities in (0, 1] that do not rise with the threshold, and the
    card's forward within TOL of the CPU's at every scale."""
    import numpy as np
    rows = [s["dense"]] + [r["metrics"] for r in s["sparse_rows"]]
    ladder = sorted(s["sparse_rows"], key=lambda r: r["threshold"])
    dens = [r["density"] for r in ladder]
    in_range = all(d is not None and 0 < d <= 1 for d in dens)
    return {"rows_finite": all(bool(np.isfinite(v)) for r in rows
                               for v in r.values()),
            "densities_in_0_1": in_range,
            "densities_not_rising": in_range and all(
                b <= a for a, b in zip(dens, dens[1:])),
            "oracle_within_tol": all(
                s["torch_oracle"][f"disp{k}_maxerr"] <= TOL
                for k in range(4))}


def phase_self_golden(dev, eval_root: str, tmp: str) -> dict:
    """tools/self_golden.py on the soak's checkpoint and phase 11's mount,
    then the kernel backends on the masks that checkpoint makes (module
    docstring, phase 17b). Returns each kernel's launches."""
    import numpy as np
    import torch
    from wavelet_monodepth_tpu_torch.data.splits import readlines
    from wavelet_monodepth_tpu_torch.ops import sparse as sp
    from wavelet_monodepth_tpu_torch.ops.sparse import compute_density
    from wavelet_monodepth_tpu_torch.tools import evaluate_depth as ed
    from wavelet_monodepth_tpu_torch.tools import infer
    from wavelet_monodepth_tpu_torch.tools import self_golden as sg
    from wavelet_monodepth_tpu_torch.utils.config import parse_kitti_args
    t_phase = time.perf_counter()

    # (a) the tool on the card
    argv = ["--data_path", eval_root, "--log_dir",
            os.path.join(tmp, "soak", "soak_logs"), "--model_name", "soak",
            "--out", os.path.join(tmp, "self_golden.json"),
            "--height", str(H), "--width", str(W), "--device", str(dev)]
    with contextlib.redirect_stdout(sys.stderr):
        s = sg.main(argv)
    gates = self_golden_gates(s)
    emit({"phase": "self_golden",
          "checkpoint": os.path.relpath(s["checkpoint"], tmp),
          "frames": EVAL_TEST_FRAMES, "dense": s["dense"],
          "sparse_rows": s["sparse_rows"],
          "operating_point": s["operating_point"],
          "sparse_vs_dense_absrel_rel_delta":
              s["sparse_vs_dense_absrel_rel_delta"],
          "torch_oracle": s["torch_oracle"], "oracle_tol": TOL,
          "gates": gates, "jax_checks": s["checks"], "jax_ok": s["ok"],
          "seconds": time.perf_counter() - t_phase, **_card})
    require(s["checkpoint"].endswith(f"weights_{SOAK_EPOCHS - 1}"),
            s["checkpoint"])
    require(all(gates.values()), ("self_golden", gates))

    # (b) the kernel backends on the 16 test frames as one batch, at the
    # operating point's threshold, under the checkpoint's own masks
    th = s["operating_point"]["threshold"]
    opts = parse_kitti_args(sg.eval_argv(sg.parse_args(argv),
                                         s["checkpoint"], dev))
    files = readlines(os.path.join(eval_root, "splits", "eigen",
                                   "test_files.txt"))
    ds = ed.eval_dataset(opts, files)
    x = torch.from_numpy(np.stack([ds[i][("color_u8", "0", 0)]
                                   for i in range(len(ds))])).to(dev)
    x = x.float() / 255.0
    require(x.shape == (EVAL_TEST_FRAMES, H, W, 3), tuple(x.shape))
    args = infer.parse_args(["--image_path", eval_root, "--torch_model_path",
                             s["checkpoint"], "--use_sparse", "--threshold",
                             str(th)])
    servers = {}
    with contextlib.redirect_stdout(sys.stderr):
        for backend in ("xla",) + tuple(BACKEND_LAUNCHES):
            servers[backend], feed = infer.load_model(args, dev, backend,
                                                      1.0)
            require(feed == (H, W), feed)
    ref = servers["xla"](x, th)
    # compact runs under xla's masks: its border ring moves its own
    # threshold (phase 22's SPATIAL_MASKS_FROM)
    raw = raw_masks_of(ref)
    kwargs = {"pallas": {}, "pallas2d": {}, "compact": {"mask_override": raw}}
    torch.cuda.synchronize()
    kernel_launches(reset=True)
    outs, got = {}, {}
    for backend in BACKEND_LAUNCHES:
        before = kernel_launches()
        outs[backend] = servers[backend](x, th, **kwargs[backend])
        torch.cuda.synchronize()
        got[backend] = {k: v - before[k] for k, v in
                        kernel_launches().items() if v != before[k]}
    launches = kernel_launches()

    def rerun(masks):
        return servers["xla"](x, th, mask_override=masks)

    for backend, out in outs.items():
        with torch.inference_mode():
            r, flips = near_tie_reference(out, ref, th, rerun)
        finite = all(bool(torch.isfinite(out[("disp", k)]).all())
                     for k in range(4))
        row = {"phase": "self_golden_backend", "backend": backend,
               "batch": EVAL_TEST_FRAMES, "threshold": th,
               "compact_cap": 1.0, "launches": got[backend],
               **backend_vs_xla(out, r, backend), "tol": TOL,
               "mask_flips": flips,
               "density": float(compute_density(out))}
        emit({**row, **_card})
        require(finite and row["ok"]
                and got[backend] == BACKEND_LAUNCHES[backend], row)
    want = {k: n for per in BACKEND_LAUNCHES.values()
            for k, n in per.items()}
    require({k: v for k, v in launches.items() if v} == want, launches)
    no_scatter_faults(dev, "self_golden")

    # the trained masks per sparse scale, and K1/K4's active granules on
    # each conv's mask
    convs = []
    for h, w, cin, cout, _, (i, mk), conv in PATH_CONVS:
        m = sp.stage_masks(raw[i])[mk]
        work = granule_work(m, cin, cout)
        convs.append({"conv": conv, "scale": i, "mask": mk,
                      "mask_density": float(m.mean()),
                      "k1_active_share":
                          work["conv3x3_tile_sparse"]["active_share"],
                      "k4_active_share":
                          work["conv3x3_tile_sparse_2d"]["active_share"]})
    emit({"phase": "self_golden_masks", "batch": EVAL_TEST_FRAMES,
          "threshold": th, "density": float(compute_density(ref)),
          "raw_mask_density": {i: float(m.mean()) for i, m in raw.items()},
          "convs": convs, **_card})

    # (c) information only: the B=16 forward on each backend
    mo = kwargs["compact"]
    t = time_variants({"dense": lambda: servers["xla"](x, None),
                       "sparse_xla": lambda: servers["xla"](x, th),
                       "sparse_pallas": lambda: servers["pallas"](x, th),
                       "sparse_pallas2d": lambda: servers["pallas2d"](x, th),
                       "sparse_compact_cap1.0":
                           lambda: servers["compact"](x, th, **mo)},
                      iters=10)
    no_scatter_faults(dev, "self_golden_time")
    emit({"phase": "self_golden_time", "batch": EVAL_TEST_FRAMES,
          "res": [H, W], "threshold": th, **t,
          "fps_median": {k: EVAL_TEST_FRAMES * 1e3 / v["ms_median"]
                         for k, v in t.items()},
          "seconds": time.perf_counter() - t_phase, **_card})
    del servers, outs, ref, x
    torch.cuda.empty_cache()
    return launches


# --- phase 18: the sparsity curve ---------------------------------------------

SWEEP_NYU_TRAIN_STEPS = 10          # cut from 300 to fit the time limit
SWEEP_KITTI_TRAIN_STEPS = 100       # cut from 300 to fit the time limit


def run_sweep(argv, dev) -> dict:
    """tools/sparsity_sweep.main (its progress lines on stderr) and its
    checks: per weight source the dense row at density 1.0, thresh -1 at
    density 1.0 with the dense row's GFLOPs, densities falling as the
    threshold rises."""
    from wavelet_monodepth_tpu_torch.tools import sparsity_sweep
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        res = sparsity_sweep.main(argv, device=dev)
    seconds = time.perf_counter() - t0
    for src in dict.fromkeys(r["weights"] for r in res["rows"]):
        rows = [r for r in res["rows"] if r["weights"] == src]
        dense = rows[0]
        th = sorted((r for r in rows if r["mask_family"] == "threshold"),
                    key=lambda r: r["threshold"])
        require(dense["mask_family"] == "dense" and dense["density"] == 1.0
                and th[0]["threshold"] == -1 and th[0]["density"] == 1.0
                and th[0]["gflops"] == dense["gflops"],
                ("sweep dense / thresh -1", src, dense, th[0]))
        dens = [r["density"] for r in th]
        require(all(a >= b for a, b in zip(dens, dens[1:])),
                ("sweep densities rise with the threshold", src, dens))
    return {**res, "seconds": seconds}


def phase_sparsity(dev, tmp: str) -> None:
    """tools/sparsity_sweep.py and tools/profile_model.py on the card
    (module docstring, phase 18)."""
    from wavelet_monodepth_tpu_torch.tools import profile_model
    from wavelet_monodepth_tpu_torch.tools import torch_import as ti
    t_phase = time.perf_counter()
    kitti = ["--batch", "8", "--train_steps", str(SWEEP_KITTI_TRAIN_STEPS)]
    cells = (("kitti_r18_f32", kitti),
             ("kitti_r18_bf16", kitti + ["--bfloat16"]),
             ("nyu_densenet161_bf16",
              ["--dataset", "nyu", "--batch", "4", "--bfloat16",
               "--train_steps", str(SWEEP_NYU_TRAIN_STEPS)]))
    for name, extra in cells:
        res = run_sweep(["--weights", "random", "synthetic", "--k", "1",
                         "2", "--out", os.path.join(tmp, "sweep",
                                                    f"{name}.json")]
                        + extra, dev)
        emit({"phase": "sparsity", "cell": name, "meta": res["meta"],
              "rows": [{k: r.get(k) for k in (
                  "weights", "mask_family", "threshold", "density",
                  "gflops", "ms_per_image", "disp_mae_vs_dense",
                  "abs_rel_vs_gt", "latency_unreliable")}
                  for r in res["rows"]],
              "seconds": res["seconds"], **_card})

    # the card's sweep against the host's, at 64x96 on seeded weights
    folder = os.path.join(tmp, "sweep_weights")
    enc, dec = build_models("cpu", seed=13)
    ti.save_reference_checkpoint(folder, enc, dec, 64, 96)
    small = ["--weights", "torch", "--torch_model_path", folder,
             "--height", "64", "--width", "96", "--batch", "2",
             "--k", "1", "1"]
    card = run_sweep(small, dev)["rows"]
    host = run_sweep(small + ["--device", "cpu"], "cpu")["rows"]
    gaps = {"density": max(abs(a["density"] - b["density"])
                           for a, b in zip(card, host)),
            "gflops_rel": max(abs(a["gflops"] - b["gflops"]) / b["gflops"]
                              for a, b in zip(card, host)),
            "disp_mae_vs_dense": max(abs(a["disp_mae_vs_dense"]
                                         - b["disp_mae_vs_dense"])
                                     for a, b in zip(card, host))}
    emit({"phase": "sparsity", "check": "card_vs_cpu_64x96", **gaps,
          "rows": len(card), **_card})
    require(len(card) == len(host) and gaps["density"] <= 1e-3
            and gaps["gflops_rel"] <= 1e-6, ("sweep card vs host", gaps))

    with contextlib.redirect_stdout(sys.stderr):
        report = profile_model.main(["--trace_dir",
                                     os.path.join(tmp, "profile_model")],
                                    device=dev)
    emit({"phase": "sparsity", "check": "profile_model",
          "torch_flop_counter": report["torch_flop_counter"],
          "analytic_sweep": report["analytic_sweep"],
          "trace_bytes": os.path.getsize(report["trace"]), **_card})
    require(report["torch_flop_counter"]["flops"] > 0
            and report["analytic_sweep"][0]["density"] == 1.0, report)
    emit({"phase": "sparsity_done",
          "seconds": time.perf_counter() - t_phase})


# --- phase 19: the native decoder --------------------------------------------

def phase_native(dev, eval_root: str, folder18: str) -> None:
    """The native decoder and evaluate_depth --native_decode (module
    docstring, phase 19)."""
    import numpy as np
    from wavelet_monodepth_tpu_torch.data import native_loader as nl
    from wavelet_monodepth_tpu_torch.data.splits import (readlines,
                                                        resolve_split_dir)
    from wavelet_monodepth_tpu_torch.tools import evaluate_depth as ed
    argv = eval_argv(eval_root, dev, 18, (H, W)) + [
        "--load_weights_folder", folder18, "--native_decode",
        "--num_workers", "8"]
    missing = nl.missing_requirements()
    if missing:
        try:
            with contextlib.redirect_stdout(sys.stderr):
                ed.main(argv)
        except nl.NativeUnavailable as err:
            raised = err.missing
        else:
            raised = None
        emit({"phase": "native", "available": False, "missing": missing,
              "native_decode_raised": raised})
        require(raised == missing, ("--native_decode without the library",
                                    raised, missing))
        return
    t0 = time.perf_counter()
    nl.build()
    nl.load_library()
    build_s = time.perf_counter() - t0
    opts, _ = ed.parse_args(argv)
    files = readlines(os.path.join(resolve_split_dir("eigen", eval_root),
                                   "test_files.txt"))
    ds = ed.eval_dataset(opts, files)
    feeds = {}
    for name, fn in (("native", lambda: list(ed.native_batches(opts, ds,
                                                               files))),
                     ("pil", lambda: list(ed.eval_batches(opts, ds)))):
        t0 = time.perf_counter()
        feeds[name] = fn()
        feeds[name + "_s"] = time.perf_counter() - t0
    u8 = np.concatenate(feeds["native"])
    paths = []
    for line in files:
        folder, frame, side = line.split()
        paths.append(ds.get_image_path(folder, int(frame), side))
    f32 = nl.decode_resize_batch(paths, H, W, num_threads=8)
    exact = bool((f32 == u8.astype(np.float32) * np.float32(1 / 255)).all())
    with contextlib.redirect_stdout(sys.stderr):
        rows = {side: ed.main(argv + (["--device", "cpu"] if side == "cpu"
                                      else []))
                for side in ("card", "cpu")}
    gap = float(np.abs(np.subtract(list(rows["card"]["metrics"].values()),
                                   list(rows["cpu"]["metrics"].values())))
                .max())
    pil_gap = float(np.abs(u8.astype(np.float32)
                           - np.concatenate(feeds["pil"])).max())
    emit({"phase": "native", "available": True, "build_seconds": build_s,
          "frames": len(files), "u8_times_1_255_equals_f32": exact,
          "card_vs_cpu_row_max": gap, "row_card": rows["card"]["metrics"],
          "feed_seconds": {"native_8_threads": feeds["native_s"],
                           "pil_serial": feeds["pil_s"]},
          "native_vs_pil_max_abs_u8": pil_gap, **_card})
    require(exact and gap <= TOL, ("native decoder", exact, gap))


# --- phase 20: the serving artifact and the measurement tools ----------------

SERVE_BATCH = 16
GRID_BATCH = 2           # JAX's grid runs B=16; cut for the time limit
GRID_CALLS = 2           # calls per window (the CLI's --k1 default 9)
GRID_DENSITY = (0.09, 0.11)


def export_and_compare(dev, name: str, argv: list, tmp: str) -> dict:
    """tools/export_serving.main(argv) on the card, the artifact loaded
    with the program's own state dict and held to the program's direct
    forward on a seeded input (phase 20 (a))."""
    import torch
    from wavelet_monodepth_tpu_torch.tools import export_serving as es
    from wavelet_monodepth_tpu_torch.tools import serve_artifact as sa
    prefix = os.path.join(tmp, name)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        _, program = es.main(argv + ["--out", prefix, "--device", str(dev)])
    export_s = time.perf_counter() - t0
    served, meta = sa.load_program(prefix, dev, program.state_dict())
    gen = torch.Generator().manual_seed(21)
    shape = (meta["batch"], meta["height"], meta["width"], 3)
    u8 = meta["input_dtype"] == "uint8"
    x = (torch.randint(0, 256, shape, generator=gen, dtype=torch.uint8)
         if u8 else torch.rand(shape, generator=gen)).to(dev)
    with torch.inference_mode():
        via, direct = served(x), program(x)
    sparse = isinstance(via, tuple)
    disp_via, disp_direct = (via[0], direct[0]) if sparse else (via, direct)
    line = {"phase": "serving_export", "case": name,
            "platforms": meta["platforms"], "dtype": meta["dtype"],
            "input_dtype": meta["input_dtype"], "export_seconds": export_s,
            "pt2_bytes": os.path.getsize(prefix + ".pt2"),
            "vs_direct_max_abs": float((disp_via - disp_direct).abs().max()),
            "finite": bool(torch.isfinite(disp_via).all())}
    if sparse:
        line["total_ops_equal"] = bool(torch.equal(via[1], direct[1]))
        line["gflops"] = float(via[1].mean()) / 1e9
    return line, program, served, x


def phase_serving_tools(dev, eval_root: str, folder18: str, folder50: str,
                        tmp: str) -> None:
    """The serving artifact and the pre-flight/measurement tools (module
    docstring, phase 20)."""
    import glob
    import io
    import shutil
    import numpy as np
    import torch
    from wavelet_monodepth_tpu_torch.tools import bench_grid as bg
    from wavelet_monodepth_tpu_torch.tools import export_serving as es
    from wavelet_monodepth_tpu_torch.tools import fetch_pretrained as fp
    from wavelet_monodepth_tpu_torch.tools import golden_check as gc
    from wavelet_monodepth_tpu_torch.tools import profile_device as pd
    from wavelet_monodepth_tpu_torch.tools import serve_artifact as sa
    from wavelet_monodepth_tpu_torch.tools.bench import measure

    t_phase = time.perf_counter()
    launches_before = kernel_launch_total()
    root = os.path.join(tmp, "serving")
    os.makedirs(root)
    kitti = ["--torch_model_path", folder18, "--height", str(H),
             "--width", str(W)]
    # (a) export -> load -> compare, and (b) the checkpoint swap
    lines = {}
    for name, argv in (
            ("kitti_r18_dense_f32", kitti),
            ("kitti_r18_sparse01_f32", kitti + ["--use_sparse",
                                                "--threshold", "0.1"]),
            ("kitti_r18_dense_bf16", kitti + ["--bfloat16"]),
            ("kitti_r18_dense_uint8", kitti + ["--uint8_input"]),
            ("nyu_dense161_sparse005_f32",
             ["--family", "nyu", "--height", str(NYU_H), "--width",
              str(NYU_W), "--use_sparse", "--threshold", str(NYU_THRESH)])):
        line, program, served, x = export_and_compare(dev, name, argv, root)
        if name == "kitti_r18_dense_bf16":
            f32 = es.build(es.parse_args(kitti + ["--out", "-"]), dev)
            with torch.inference_mode():
                gap = (served(x) - f32(x)).abs()
            line["vs_f32_disp"] = {"max": float(gap.max()),
                                   "mean": float(gap.mean())}
            ok = (gap.max() <= BF16_DISP_MAX and gap.mean() <= BF16_DISP_MEAN
                  and line["vs_direct_max_abs"] <= BF16_DISP_MAX)
        elif name == "kitti_r18_dense_uint8":
            f32 = es.build(es.parse_args(kitti + ["--out", "-"]), dev)
            with torch.inference_mode():
                line["vs_f32_of_x_over_255_max_abs"] = float(
                    (served(x) - f32(x.float() / 255.0)).abs().max())
            ok = max(line["vs_direct_max_abs"],
                     line["vs_f32_of_x_over_255_max_abs"]) <= TOL
        else:
            ok = (line["vs_direct_max_abs"] <= TOL
                  and line.get("total_ops_equal", True))
        emit({**line, **_card})
        require(ok and line["finite"], line)
        lines[name] = line
        del program, served, x
    torch.cuda.empty_cache()

    swap = os.path.join(root, "swap")
    with contextlib.redirect_stdout(sys.stderr):
        _, program_a = es.main(kitti + ["--out", swap, "--bundle_params",
                                        "--device", str(dev)])
        program_b = es.build(es.parse_args(["--out", "-"]), dev)  # seeded
    torch.save(program_b.state_dict(), swap + ".params.pt")
    served, _ = sa.load_program(swap, dev)
    x = torch.rand((1, H, W, 3), generator=torch.Generator().manual_seed(22)
                   ).to(dev)
    with torch.inference_mode():
        via, want, was = served(x), program_b(x), program_a(x)
    swap_line = {"phase": "serving_swap",
                 "vs_bundle_direct_max_abs": float((via - want).abs().max()),
                 "vs_export_checkpoint_max_abs": float(
                     (via - was).abs().max())}
    emit(swap_line)
    require(swap_line["vs_bundle_direct_max_abs"] <= TOL
            and swap_line["vs_export_checkpoint_max_abs"] > 1e-3, swap_line)
    del program_a, program_b, served

    # (c) serve the mount's 16 test frames with a B=16 artifact
    images = os.path.join(root, "images")
    os.makedirs(images)
    with open(os.path.join(eval_root, "splits", "eigen",
                           "test_files.txt")) as f:
        tests = [ln.split() for ln in f.read().splitlines() if ln.strip()]
    for i, (folder, frame, _) in enumerate(tests):
        src = glob.glob(os.path.join(eval_root, folder, "image_02", "data",
                                     f"{int(frame):010d}.*"))[0]
        shutil.copy(src, os.path.join(images, f"{i:02d}" +
                                      os.path.splitext(src)[1]))
    b16 = os.path.join(root, "r18_b16")
    with contextlib.redirect_stdout(sys.stderr):
        _, program = es.main(kitti + ["--out", b16, "--batch",
                                      str(SERVE_BATCH), "--bundle_params",
                                      "--device", str(dev)])
        res = sa.main(["--artifact", b16, "--images", images, "--out",
                       os.path.join(root, "preds"), "--device", str(dev)])
    paths = sa._resolve_images(images)
    batch, feed = sa._decode(paths, H, W, 4)
    with torch.inference_mode():
        direct = program(torch.from_numpy(batch).to(dev).float() / 255.0)
    direct = direct.cpu().numpy()
    files = sorted(glob.glob(os.path.join(root, "preds", "*_disp.npy")))
    gap = max(float(np.abs(np.load(p) - direct[i, :, :, 0]).max())
              for i, p in enumerate(files))
    serve_line = {"phase": "serving_serve", "images": len(paths),
                  "npy_files": len(files), "feed": res["feed"],
                  "decode_feed": feed, "ms_per_image": res["ms_per_image"],
                  "seconds": res["seconds"], "vs_direct_max_abs": gap,
                  **_card}
    emit(serve_line)
    require(len(files) == len(paths) == EVAL_TEST_FRAMES and gap <= TOL
            and res["feed"] == feed, serve_line)

    # (d) the artifact against the direct forward, B=1 and B=16 f32
    served16, _ = sa.load_program(b16, dev)
    b1 = os.path.join(root, "kitti_r18_dense_f32")
    served1, _ = sa.load_program(b1, dev, program.state_dict())
    x16 = torch.from_numpy(batch).to(dev).float() / 255.0
    x1 = x16[:1].contiguous()

    def call(fn, x):
        def run():
            with torch.inference_mode():
                return fn(x)
        return run
    cells = {"artifact_b1": call(served1, x1), "direct_b1": call(program, x1),
             "artifact_b16": call(served16, x16),
             "direct_b16": call(program, x16)}
    timed = measure(cells, {"artifact_b1": 30, "direct_b1": 30,
                            "artifact_b16": 10, "direct_b16": 10}, 3, dev)
    emit({"phase": "serving_timing", "model": "kitti_r18_640x192_f32",
          "cells": timed,
          "artifact_over_direct_b1": ratio(timed, "artifact_b1",
                                           "direct_b1"),
          "artifact_over_direct_b16": ratio(timed, "artifact_b16",
                                            "direct_b16"), **_card})
    del served1, served16, program, cells
    torch.cuda.empty_cache()

    # (e) the grid
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sys.stderr):
        rows = bg.main(["--batch", str(GRID_BATCH), "--windows", "3",
                        "--k1", str(GRID_CALLS), "--device", str(dev)])
    emit({"phase": "bench_grid", "batch": GRID_BATCH, "rows": rows,
          "seconds": time.perf_counter() - t0, **_card})
    for row in rows:
        require(not [k for k in row if k.endswith("_error")], row)
        if row["config"].startswith("kitti"):
            require(GRID_DENSITY[0] <= row["density"] <= GRID_DENSITY[1],
                    row)
    torch.cuda.empty_cache()

    # (f) the profiler's attribution
    for thresh in (None, 0.2):
        argv = ["--batch", str(SERVE_BATCH), "--device", str(dev),
                "--trace_dir", os.path.join(root, "trace")]
        argv += [] if thresh is None else ["--threshold", str(thresh)]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            prof = pd.main(argv)
        printed = sum(float(ln.split()[0])
                      for ln in buf.getvalue().splitlines()[1:])
        fwd, _ = pd.build_forward(pd.parse_args(argv), dev)
        event_ms = time_variants({"forward": fwd}, iters=8)["forward"]
        # the same forward in a plain trace (no ranges): the union of its
        # device spans, the busy time the rows should add up to
        _, by_kernel, _, busy, _, _ = trace_calls(fwd, 8)
        total = prof["total_ms"]
        groups = dict(prof["groups"])
        line = {"phase": "profile_device", "threshold": thresh,
                "batch": SERVE_BATCH, "total_ms": total,
                "printed_rows_ms": printed,
                "unattributed_share": groups.get(pd.UNATTRIBUTED, 0.0)
                / total,
                "forward_event_ms": event_ms,
                "total_over_event_ms": total / event_ms["ms_median"],
                "plain_trace_busy_ms": busy / 8e3,
                "plain_trace_kernels": sum(v[0] for v in by_kernel.values())
                / 8,
                "top_rows": prof["groups"][:8], "rows": len(groups),
                **_card}
        emit(line)
        require(abs(printed - total) <= 0.01 * total
                and line["unattributed_share"] < 0.05
                and 0.5 <= line["total_over_event_ms"] <= 1.05, line)

    # (g) golden_check and fetch_pretrained on the mount and folders
    buf = io.StringIO()
    codes = (gc.main([], env={}, out=buf),
             gc.main(["--require_all"], env={}, out=io.StringIO()))
    absent = buf.getvalue().count("[ -- ]")
    env = {"WMD_KITTI_DATA": eval_root, "WMD_KITTI_WEIGHTS": folder18,
           "WMD_KITTI_WEIGHTS_R50_1024": folder50}
    buf = io.StringIO()
    code = gc.main([], env=env, out=buf)
    status = {}
    for ln in buf.getvalue().splitlines():
        if ln.startswith(("[ OK ]", "[FAIL]")):
            var = ln[7:].split(" ")[0]
            status[var] = [ln[:6], []]
        elif ln.startswith("       - "):
            status[var][1].append(ln.strip()[2:])
    reports = {k: fp.check_folder(v) for k, v in (("resnet18", folder18),
                                                  ("resnet50", folder50))}
    golden = {"phase": "golden_check", "no_mounts_exit": codes[0],
              "no_mounts_require_all_exit": codes[1],
              "no_mounts_absent": absent, "mounted_exit": code,
              "mounted": status,
              "fetch_pretrained": {k: r["details"] for k, r in
                                   reports.items()}}
    emit(golden)
    require(codes == (0, 1) and absent == len(gc.MOUNTS) == 11
            and set(status) == set(env)
            and all(s == "[ OK ]" or (s == "[FAIL]" and why and not any(
                "validator error" in w for w in why))
                    for s, why in status.values())
            and code == (1 if any(s == "[FAIL]" for s, _ in
                                  status.values()) else 0), golden)
    for depth, r in reports.items():
        require(r["ok"] and f"imported as {depth} + wavelet decoder"
                in r["details"], (depth, r))

    moved = kernel_launch_total() - launches_before
    emit({"phase": "serving_tools_done", "kernel_launches": moved,
          "seconds": time.perf_counter() - t_phase})
    require(moved == 0, ("serving tools launched a kernel", moved))


# --- phase 21: ddp ----------------------------------------------------------

DDP_RANKS = 2
DDP_NYU_FRAMES = 8            # 2 steps at the global B=4
DDP_NYU_B = 4
DDP_TIMEOUT = 300             # seconds for a two-rank launch
DDP_LOSS_TOL = 1e-4           # relative, each step's losses
DDP_STATS_TOL = 1e-5          # relative norm, each BN statistic
DDP_GRAD_LIMIT = 1e-4         # the direct gradient gap's target, printed


def ddp_nyu_argv(zip_path: str, log: str):
    """train_nyu's flags at the global B=4: DenseNet161 + NyuDecoderWave
    at 640x480, one epoch, a validation batch at the first step."""
    return ["--data_path", zip_path, "--log_dir", log, "--encoder_type",
            "densenet", "--use_wavelets", "--batch_size", str(DDP_NYU_B),
            "--epochs", "1", "--log_frequency", "300", "--num_workers", "2",
            "--no-pretrained_encoder"]


def _to_cpu(obj):
    """A copy of `obj` with every tensor on the CPU (nested dicts, lists)."""
    import torch
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def _named_params(state) -> dict:
    return {f"{prefix}.{n}": p for prefix, m in state.modules().items()
            for n, p in m.named_parameters()}


def _bn_stats(state) -> dict:
    return {f"{prefix}.{k}": v for prefix, m in state.modules().items()
            for k, v in m.state_dict().items()
            if k.endswith(("running_mean", "running_var"))}


def _snapshot(state, gen) -> dict:
    """What a step starts from: every network's state dict, Adam's, the
    step count and the noise generator's state."""
    return {"modules": {n: _to_cpu(m.state_dict())
                        for n, m in state.modules().items()},
            "adam": _to_cpu(state.optimizer.state_dict()),
            "step": state.step,
            "gen": None if gen is None else gen.get_state()}


def _restore(state, snap: dict, gen) -> None:
    for n, m in state.modules().items():
        m.load_state_dict(snap["modules"][n])
    state.optimizer.load_state_dict(snap["adam"])
    state.step = snap["step"]
    if gen is not None:
        gen.set_state(snap["gen"])


def ddp_condition(state) -> None:
    """The wavelet heads' 3x3 convs scaled by 0.1 (KITTI), as the CPU
    parity tests do: no random-init disparity sits at the clamp at 0,
    where depth = 1 / (0.01 + 9.99 disp) turns float32 rounding into
    1e5-fold larger gradients. Applied in the ranks' init."""
    import torch
    blocks = getattr(state.decoder, "blocks", {})
    with torch.no_grad():
        for name, block in blocks.items():
            if "_pos" in name or "_neg" in name:
                block[2].conv.weight.mul_(0.1)
                block[2].conv.bias.mul_(0.1)


def ddp_rank(rank: int, world: int, port: int, family: str, argv: list,
             out: str) -> None:
    """One rank of the ddp phase (a process of its own): tools/
    train_kitti.main or train_nyu.main with the multi-host flags of this
    rank, recording through wrappers of the setup's steps what it fed,
    logged and held: each step's local batch, losses and time
    (synchronised around the step), rank 0's state before each step,
    step 1's averaged gradients, the validation batches with the noise
    generator's state there, the gradient all-reduce's time, the
    parameters and BN statistics after the run and K3's launches
    (counted from 0 just before main), and the wall clock at its marks
    (entered, imported, each step's start, main returned)."""
    clock = {"entered": time.time()}
    import torch
    sys.path.insert(0, REPO)
    from wavelet_monodepth_tpu_torch.ops import warp
    from wavelet_monodepth_tpu_torch.parallel import mesh
    if family == "kitti":
        from wavelet_monodepth_tpu_torch.tools import train_kitti as tool
        from wavelet_monodepth_tpu_torch.train.kitti import \
            KittiTrainSetup as Setup
    else:
        from wavelet_monodepth_tpu_torch.tools import train_nyu as tool
        from wavelet_monodepth_tpu_torch.train.nyu import \
            NyuTrainSetup as Setup
    rec = {"steps": [], "vals": [], "allreduce_ms": [], "clock": clock}
    clock["imported"] = time.time()
    held = {}
    train_step, eval_step = Setup.train_step, Setup.eval_step
    init_state = Setup.init_state
    allreduce = mesh.allreduce_gradients

    def split(inputs):
        gens = [x for x in inputs if isinstance(x, torch.Generator)]
        return ([_to_cpu(x) for x in inputs
                 if not isinstance(x, torch.Generator)],
                gens[0] if gens else None)

    def sync_ms(t0):
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def conditioned_init(self, *args, **kw):
        state = init_state(self, *args, **kw)
        ddp_condition(state)
        return state

    def timed_allreduce(params):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        allreduce(params)
        rec["allreduce_ms"].append(sync_ms(t0))

    def recorded_train_step(self, state, *inputs):
        clock.setdefault("steps", []).append(time.time())
        fed, gen = split(inputs)
        before = _snapshot(state, gen) if rank == 0 else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = train_step(self, state, *inputs)
        ms = sync_ms(t0)
        rec["steps"].append({"inputs": fed, "before": before, "ms": ms,
                             "losses": {k: float(v)
                                        for k, v in losses.items()}})
        if len(rec["steps"]) == 1:
            rec["backend"] = torch.distributed.get_backend()
            rec["grads"] = _to_cpu({k: p.grad for k, p in
                                    _named_params(state).items()
                                    if p.grad is not None})
        held["state"] = state
        return losses

    def recorded_eval_step(self, state, *inputs):
        fed, gen = split(inputs)
        rec["vals"].append({"inputs": fed, "gen": None if gen is None
                            else gen.get_state()})
        return eval_step(self, state, *inputs)

    Setup.train_step, Setup.eval_step = recorded_train_step, \
        recorded_eval_step
    Setup.init_state = conditioned_init
    mesh.allreduce_gradients = timed_allreduce
    warp.reset_launches()
    try:
        summary = tool.main(argv + [
            "--coordinator_address", f"127.0.0.1:{port}", "--num_processes",
            str(world), "--process_id", str(rank), "--device", "cuda"],
            logger=no_writer())
    finally:        # the process runs the next job unpatched
        Setup.train_step, Setup.eval_step = train_step, eval_step
        Setup.init_state = init_state
        mesh.allreduce_gradients = allreduce
    clock["main_returned"] = time.time()
    rec["launches"] = dict(warp.launches)
    rec["summary"] = summary
    rec["params"] = _to_cpu(_named_params(held["state"]))
    rec["stats"] = _to_cpu(_bn_stats(held["state"]))
    torch.save(rec, out)
    held.clear()
    torch.cuda.empty_cache()


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_jobs(rank: int, world: int, jobs: list) -> None:
    """One rank process of phases 21 and 22: each job in turn, ("ddp",
    family, argv, port, out) through ddp_rank, then ("spatial", port, out)
    through spatial_rank, each on a process group of its own (the
    training CLIs build and close theirs); one import for all of them."""
    for job in jobs:
        if job[0] == "ddp":
            ddp_rank(rank, world, job[3], job[1], job[2], job[4])
        else:
            spatial_rank(rank, world, job[1], job[2])


def run_rank_jobs(jobs: list, tmp: str, while_running=None):
    """DDP_RANKS processes of rank_jobs on the one card (gloo: the ranks
    share it), each with its own log; while_running() runs in this
    process meanwhile. A rank that fails or outlasts DDP_TIMEOUT fails
    the phase (the others are killed), and every failed rank's log ends
    the message. Returns ({job's out name: the ranks' records}, what
    while_running returned); each record's "timeline_s" holds its marks
    in seconds from the launch."""
    import torch
    procs, logs = [], []
    started = time.time()
    extra = None
    try:
        for r in range(DDP_RANKS):
            mine = [(*job[:-1], os.path.join(tmp, f"{job[-1]}_rank{r}.pt"))
                    for job in jobs]
            code = (f"import sys; sys.path.insert(0, {REPO!r}); "
                    f"import chip_smoke; chip_smoke.rank_jobs({r}, "
                    f"{DDP_RANKS}, {mine!r})")
            logs.append(open(os.path.join(tmp, f"rank{r}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code], cwd=REPO, stdout=logs[-1],
                stderr=subprocess.STDOUT, stdin=subprocess.DEVNULL))
        if while_running is not None:
            extra = while_running()
        deadline = time.time() + DDP_TIMEOUT
        for p in procs:
            p.wait(timeout=max(deadline - time.time(), 1))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        text = log.read()
        log.close()
        if p.returncode != 0:
            failed.append(f"rank {r} exited with {p.returncode}:\n"
                          f"{text[-2500:]}")
    require(not failed, "rank jobs: " + "\n".join(failed))
    recs = {}
    for job in jobs:
        recs[job[-1]] = [torch.load(os.path.join(tmp, f"{job[-1]}_rank{r}.pt"),
                                    weights_only=False)
                         for r in range(DDP_RANKS)]
        for rec in recs[job[-1]]:    # seconds from the launch to each mark
            c = rec["clock"]
            rec["timeline_s"] = {
                k: ([t - started for t in c[k]] if isinstance(c[k], list)
                    else c[k] - started) for k in c}
    return recs, extra


def _global_inputs(parts: list, dev) -> list:
    """The global batch of one recorded call: the ranks' rows in rank
    order."""
    import torch
    out = []
    for i, first in enumerate(parts[0]):
        if isinstance(first, dict):
            out.append({k: torch.cat([p[i][k] for p in parts]).to(dev)
                        for k in first})
        else:
            out.append(torch.cat([p[i] for p in parts]).to(dev))
    return out


def _rel(a, b) -> float:
    return float((a.double() - b.double()).norm()
                 / max(float(b.double().norm()), 1e-30))


def _stats_gap(a, b) -> float:
    """A BN statistic's gap relative to its norm, or to 1e-3 per element
    where it is near 0 (the running mean of a zero-mean activation)."""
    return float((a.double() - b.double()).norm()
                 / max(float(b.double().norm()), 1e-3 * b.numel() ** 0.5))


def _loss_gap(ours: dict, ref: dict) -> float:
    require(set(ours) == set(ref), (sorted(ours), sorted(ref)))
    return max(abs(ours[k] - ref[k]) / max(abs(ref[k]), 1e-30)
               for k in ref)


def _ddp_setup(family: str, argv: list, dev, steps: int):
    """The setup of `argv` on one rank and its noise generator (KITTI)."""
    import torch
    from wavelet_monodepth_tpu_torch.utils import config
    if family == "kitti":
        from wavelet_monodepth_tpu_torch.train.kitti import KittiTrainSetup
        setup = KittiTrainSetup(config.parse_kitti_args(argv), device=dev,
                                steps_per_epoch=steps)
        return setup, torch.Generator(device=dev)
    from wavelet_monodepth_tpu_torch.train.nyu import NyuTrainSetup
    return NyuTrainSetup(config.parse_nyu_args(argv), device=dev), None


def _reversed(inputs: list, gen, scales, dev) -> list:
    """A global batch with its rows reversed, and (KITTI) the automask
    draws the step would take from `gen`'s state, reversed with them."""
    import torch
    out = [{k: v.flip(0) for k, v in x.items()} if isinstance(x, dict)
           else x.flip(0) for x in inputs]
    if gen is not None:
        shape = out[0][("color_u8", "0", 0)].shape[:3] + (1,)
        out.append({s: torch.randn(shape, generator=gen, device=dev).flip(0)
                    for s in scales})
    return out


def ddp_reference(family: str, argv: list, recs: list, dev) -> dict:
    """One rank on the global batch, step by step: before each step the
    state rank 0 started it from (the networks, Adam, the noise
    generator), then the step on the ranks' rows concatenated in rank
    order; KITTI's validation batch from the state main ran it in, with
    the noise generator's state there. Each step is compared from the
    same state, so float32 differences of one step do not carry into the
    next. Each step and the validation batch also run on the global
    batch's rows reversed (the noise rows with them): the same function,
    its float32 sums in another order, which measures how far float32
    rounding alone moves them (the `*_reversed` entries)."""
    import torch
    steps = recs[0]["steps"]
    setup, gen = _ddp_setup(family, argv, dev, len(steps))
    scales = getattr(setup.opts, "loss_scales", ())
    state = setup.init_state(torch.Generator().manual_seed(0))
    extra = [gen] if gen is not None else []
    ref = {"losses": [], "losses_reversed": [], "stats": [], "ms": [],
           "val_losses": [], "val_losses_reversed": []}

    def host(losses):
        return {k: float(v) for k, v in losses.items()}

    def grads():
        return _to_cpu({k: p.grad for k, p in _named_params(state).items()
                        if p.grad is not None})

    for i, step in enumerate(steps):
        inputs = _global_inputs([r["steps"][i]["inputs"] for r in recs], dev)
        _restore(state, step["before"], gen)
        ref["losses_reversed"].append(host(setup.train_step(
            state, *_reversed(inputs, gen, scales, dev))))
        if i == 0:
            ref["grads_reversed"] = grads()
        _restore(state, step["before"], gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = setup.train_step(state, *inputs, *extra)
        torch.cuda.synchronize()
        ref["ms"].append((time.perf_counter() - t0) * 1e3)
        ref["losses"].append(host(losses))
        ref["stats"].append(_to_cpu(_bn_stats(state)))
        if i == 0:
            ref["grads"] = grads()
    if family == "kitti":
        # main validated after step 1, from the state step 2 started from
        vin = _global_inputs([r["vals"][0]["inputs"] for r in recs], dev)
        for key in ("val_losses", "val_losses_reversed"):
            _restore(state, steps[1]["before"], gen)
            gen.set_state(recs[0]["vals"][0]["gen"])
            batch = (vin + extra if key == "val_losses"
                     else _reversed(vin, gen, scales, dev))
            ref[key].append(host(setup.eval_step(state, *batch)[1]))
    return ref


def _grad_groups(grads: dict) -> dict:
    import torch
    out = {}
    for k, v in grads.items():
        out.setdefault(k.split(".")[0], []).append(v.double().reshape(-1))
    return {m: torch.cat(v) for m, v in out.items()}


def ddp_compare(family: str, recs: list, ref: dict, seconds: float) -> dict:
    """The checks of the ddp phase, and its line."""
    import statistics as st
    import torch
    steps = len(ref["losses"])
    for r, rec in enumerate(recs):
        require(len(rec["steps"]) == steps, (family, r, len(rec["steps"])))
        require(rec["backend"] == "gloo", (family, r, rec["backend"]))
    # the ranks log the same global losses and end with equal state
    for rec in recs[1:]:
        require([s["losses"] for s in rec["steps"]]
                == [s["losses"] for s in recs[0]["steps"]],
                (family, "ranks' losses differ"))
        for key in ("params", "stats"):
            require(set(rec[key]) == set(recs[0][key]), (family, key))
            differ = [k for k in rec[key]
                      if not torch.equal(rec[key][k], recs[0][key][k])]
            require(not differ, (family, f"ranks' {key} differ", differ[:3]))
    loss_gaps = [_loss_gap(recs[0]["steps"][i]["losses"], ref["losses"][i])
                 for i in range(steps)]
    loss_floors = [_loss_gap(ref["losses_reversed"][i], ref["losses"][i])
                   for i in range(steps)]
    val_gap = val_floor = None
    if ref["val_losses"]:
        val_gap = _loss_gap(recs[0]["summary"]["val_losses"][0],
                            ref["val_losses"][0])
        val_floor = _loss_gap(ref["val_losses_reversed"][0],
                              ref["val_losses"][0])
    # the ranks' statistics after step i: what step i + 1 started from
    after = [recs[0]["steps"][i + 1]["before"]["modules"]
             for i in range(steps - 1)]
    stats_gaps = []
    for i in range(steps):
        ours = (recs[0]["stats"] if i == steps - 1 else
                {f"{m}.{k}": v for m, sd in after[i].items()
                 for k, v in sd.items()
                 if k.endswith(("running_mean", "running_var"))})
        require(set(ours) == set(ref["stats"][i]), (family, "BN names"))
        stats_gaps.append(max(_stats_gap(ours[k], ref["stats"][i][k])
                              for k in ours))
    g2, g1, g0 = (_grad_groups(g) for g in (
        recs[0]["grads"], ref["grads"], ref["grads_reversed"]))
    require(set(g2) == set(g1) == set(g0), (family, "gradient modules"))
    grads = {m: {"two_vs_one": _rel(g2[m], g1[m]),
                 "one_vs_reversed_rows": _rel(g0[m], g1[m])}
             for m in sorted(g0)}
    rank_ms = [st.median([s["ms"] for s in rec["steps"][1:]])
               for rec in recs]
    allreduce_ms = [st.median(rec["allreduce_ms"][1:]) for rec in recs]
    line = {"phase": "ddp", "family": family, "ranks": len(recs),
            "backend": "gloo", "steps": steps, "loss_gaps": loss_gaps,
            "loss_tol": DDP_LOSS_TOL, "loss_floors_reversed_rows":
            loss_floors, "val_loss_gap": val_gap,
            "val_loss_floor_reversed_rows": val_floor,
            "bn_stats_gaps": stats_gaps, "bn_stats_tol": DDP_STATS_TOL,
            "grad_gaps": grads, "grad_two_vs_one_limit": DDP_GRAD_LIMIT,
            "params_and_stats_bitwise_equal": True,
            "ms_per_step_two_ranks": rank_ms,
            "ms_per_step_one_rank": st.median(ref["ms"][1:]),
            "ms_steps_one_rank": ref["ms"],
            "allreduce_ms": allreduce_ms,
            "allreduce_share": [a / s for a, s in zip(allreduce_ms, rank_ms)],
            "launch_seconds": seconds,
            "rank_timelines_s": [rec["timeline_s"] for rec in recs], **_card}
    emit(line)
    # the hint term's argmin flips where two warps nearly tie, so float32
    # rounding alone moves a step's losses by up to ~1e-4 (the reversed
    # rows show how far in this step): the limit, plus 3x that floor
    for gap, floor in zip(loss_gaps, loss_floors):
        require(gap <= DDP_LOSS_TOL + 3 * floor,
                (family, "losses", loss_gaps, loss_floors))
    require(val_gap is None or val_gap <= DDP_LOSS_TOL + 3 * val_floor,
            (family, "validation losses", val_gap, val_floor))
    require(max(stats_gaps) <= DDP_STATS_TOL,
            (family, "BN statistics", stats_gaps))
    # float32 rounding alone moves these gradients by ~1% (BN's backward
    # over a one-signed loss gradient cancels): the two ranks' gradient
    # must lie no further from the one rank's than 3x what reversing the
    # one rank's rows moves it
    for m, g in grads.items():
        require(g["two_vs_one"] <= 3 * g["one_vs_reversed_rows"] + 1e-6,
                (family, "gradients", m, g))
    return line


def ddp_launcher(dev, root: str, tmp: str) -> None:
    """--data_axis 2 through tools/train_kitti.main itself: the command
    starts its two ranks (pinned to the one card, so they share it and
    run on gloo), one step on a 12-line split, and returns rank 0's
    summary."""
    import numpy as np
    from wavelet_monodepth_tpu_torch.tools import train_kitti
    split = os.path.join(root, "splits", "chip_ddp1")
    os.makedirs(split, exist_ok=True)
    with open(os.path.join(root, "splits", "chip", "train_files.txt")) as f:
        lines = f.read().splitlines()[:TRAIN_B]
    for name in ("train_files.txt", "val_files.txt"):
        with open(os.path.join(split, name), "w") as f:
            f.write("\n".join(lines) + "\n")
    argv = train_argv(root, os.path.join(tmp, "ddp_launch_log"))
    argv[argv.index("--split") + 1] = "chip_ddp1"
    t0 = time.perf_counter()
    summary = train_kitti.main(argv + ["--data_axis", str(DDP_RANKS)],
                               device=dev)
    seconds = time.perf_counter() - t0
    require(summary["steps"] == 1 and summary["val_batches"] == 1, summary)
    require(all(np.isfinite(v) for v in summary["losses"][0].values()),
            summary["losses"])
    require(os.path.isfile(os.path.join(summary["checkpoints"][0],
                                        "encoder.pth")), summary)
    emit({"phase": "ddp", "family": "kitti", "run": "data_axis_launcher",
          "ranks": DDP_RANKS, "steps": summary["steps"],
          "loss": summary["losses"][0]["loss"], "seconds": seconds})


def ddp_check(family: str, argv: list, recs: list, dev) -> dict:
    """The one-rank reference and the checks of one family's two-rank
    run; returns rank 0's K3 launches."""
    import numpy as np
    import torch
    for rec in recs:
        require(all(np.isfinite(v) for s in rec["steps"]
                    for v in s["losses"].values()), (family, "losses"))
        require(rec["launches"] == recs[0]["launches"],
                (family, "ranks' K3 launches", rec["launches"]))
    ref = ddp_reference(family, argv, recs, dev)
    torch.cuda.empty_cache()
    # the job's wall: its start in rank 0 to main's return there
    t = recs[0]["timeline_s"]
    ddp_compare(family, recs, ref, t["main_returned"] - t["entered"])
    return recs[0]["launches"]


def phase_ddp(dev, root: str, tmp: str):
    """Data-parallel training on the one card (module docstring, phase
    21), and phase 22's spatial forwards in the same two rank processes
    after it. Returns K3's launches per rank of the KITTI run and the
    spatial path's launches per rank."""
    import torch
    from wavelet_monodepth_tpu_torch.data import synth
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()        # the ranks' memory is the card's too
    zip_path = os.path.join(tmp, "ddp_nyu.zip")
    synth.fabricate_nyu(zip_path, n_train=DDP_NYU_FRAMES)
    argv = {"kitti": train_argv(root, os.path.join(tmp, "ddp_log")),
            "nyu": ddp_nyu_argv(zip_path, os.path.join(tmp, "ddp_nyu_log"))}
    jobs = [("ddp", family, argv[family], _free_port(), family)
            for family in ("kitti", "nyu")]
    jobs.append(("spatial", _free_port(), "spatial"))
    recs, refs = run_rank_jobs(jobs, tmp,
                               while_running=lambda: spatial_references(dev))
    launches = ddp_check("kitti", argv["kitti"], recs["kitti"], dev)
    # per rank: 5 forward + 4 backward per step, 5 forward for validation
    require(launches == {"banded_warp_fwd": 5 * 4, "banded_warp_bwd": 4 * 3},
            ("K3 launches per rank", launches))
    ddp_launcher(dev, root, tmp)
    ddp_check("nyu", argv["nyu"], recs["nyu"], dev)
    emit({"phase": "ddp", "seconds": time.perf_counter() - t_phase})
    return launches, spatial_check(dev, refs, recs["spatial"])


# --- phase 22: spatial ------------------------------------------------------

SPATIAL_RANKS = 2
SPATIAL_SEED = 4
SPATIAL_THRESH = 0.05
SPATIAL_DISP_LIMIT = 1e-5      # tests/test_spatial.py's limit
SPATIAL_CALLS = 3              # timed forwards per case in each rank
# KITTI R18 at the published HR size, B=1: dense, and sparse at 0.05 on
# xla, pallas (K1), pallas2d (K4) and compact (K5/K6, compact_cap 1.0 as
# phase 5 holds it to xla)
SPATIAL_CASES = {
    "dense": {},
    "sparse_xla": {"thresh_ratio": SPATIAL_THRESH, "use_pallas": "xla"},
    "sparse_pallas": {"thresh_ratio": SPATIAL_THRESH,
                      "use_pallas": "pallas"},
    "sparse_pallas2d": {"thresh_ratio": SPATIAL_THRESH,
                        "use_pallas": "pallas2d"},
    "sparse_compact": {"thresh_ratio": SPATIAL_THRESH,
                       "use_pallas": "compact", "compact_cap": 1.0},
}
# a case run under another case's own threshold masks (mask_override):
# compact's border ring (COMPACT_RING) feeds its threshold other values
# there, so it takes xla's masks, as phase 5 holds it to xla
SPATIAL_MASKS_FROM = {"sparse_compact": "sparse_xla"}
# the kernels each case launches, counted per rank
SPATIAL_KERNELS = {"sparse_pallas": ("conv3x3_tile_sparse",),
                   "sparse_pallas2d": ("conv3x3_tile_sparse_2d",),
                   "sparse_compact": ("band_gather", "block_scatter")}
# then, after the KITTI cases, over the same ranks at B=1, each counted
# once and timed once: case -> (model, decoder kwargs). NYU at the
# published 640x480, in metres (nyu_modules' heads): phase 12's seeded
# DenseNet161 + NyuDecoderWave dense, and sparse at NYU_THRESH on False
# (masked dense), True (K1 x4), "pallas2d" (K4 x2 + K1 x2) and
# "capacity" (K1 x2; capacity_ratio 1.0 drops no tile, as phase 12
# holds it to the masked-dense answer); MobileNetV2 + NyuDecoderWave on
# the same seed dense, sparse on False and "pallas2d", and its
# use_polyphase twin dense. KITTI at 1024x320: the R18 weights above
# through polyphase_twin, dense and sparse xla, and the same encoder with
# a seeded baseline DepthDecoder, dense
SPATIAL_NYU_SEED = 10
SPATIAL_NYU_CM_PER_UNIT = 100.0
SPATIAL_MODEL_CASES = {
    "nyu_dense": ("nyu_densenet161", {}),
    "nyu_sparse_xla": ("nyu_densenet161", {"thresh_ratio": NYU_THRESH,
                                           "use_pallas": False}),
    "nyu_sparse_pallas": ("nyu_densenet161", {"thresh_ratio": NYU_THRESH,
                                              "use_pallas": True}),
    "nyu_sparse_pallas2d": ("nyu_densenet161",
                            {"thresh_ratio": NYU_THRESH,
                             "use_pallas": "pallas2d"}),
    "nyu_sparse_capacity": ("nyu_densenet161",
                            {"thresh_ratio": NYU_THRESH,
                             "use_pallas": "capacity",
                             "capacity_ratio": 1.0}),
    "nyu_mbv2_dense": ("nyu_mobilenetv2", {}),
    "nyu_mbv2_sparse_xla": ("nyu_mobilenetv2", {"thresh_ratio": NYU_THRESH,
                                                "use_pallas": False}),
    "nyu_mbv2_sparse_pallas2d": ("nyu_mobilenetv2",
                                 {"thresh_ratio": NYU_THRESH,
                                  "use_pallas": "pallas2d"}),
    "nyu_mbv2_polyphase": ("nyu_mobilenetv2_polyphase", {}),
    "kitti_polyphase_dense": ("kitti_r18_polyphase", {}),
    "kitti_polyphase_sparse_xla": ("kitti_r18_polyphase",
                                   {"thresh_ratio": SPATIAL_THRESH,
                                    "use_pallas": "xla"}),
    "kitti_depthdecoder": ("kitti_r18_depthdecoder", {}),
}
# each kernel case's masked-dense case (the one-card answer it is also
# held to) and its K1 / K4 launches per forward (phase 12's); the other
# cases launch none
SPATIAL_MODEL_XLA = {
    **{f"nyu_sparse_{b}": "nyu_sparse_xla" for b in NYU_LAUNCHES},
    "nyu_mbv2_sparse_pallas2d": "nyu_mbv2_sparse_xla"}
SPATIAL_MODEL_LAUNCHES = {
    **{f"nyu_sparse_{b}": n for b, n in NYU_LAUNCHES.items()},
    "nyu_mbv2_sparse_pallas2d": NYU_LAUNCHES["pallas2d"]}


def spatial_image():
    import torch
    g = torch.Generator().manual_seed(SPATIAL_SEED)
    return torch.rand(1, R50_H, R50_W, 3, generator=g)


def spatial_model(model: str, dev):
    """The encoder and decoder of a SPATIAL_MODEL_CASES model, eval, on
    `dev`: nyu_modules' DenseNet161 or MobileNetV2 + NyuDecoderWave, or
    the KITTI cases' seeded R18 with a DepthDecoder seeded after it; a
    "_polyphase" model is the decoder's polyphase_twin."""
    import torch
    from wavelet_monodepth_tpu_torch.models.decoders_kitti import \
        DepthDecoder
    from wavelet_monodepth_tpu_torch.models.layers import init_params
    if model.startswith("nyu"):
        enc, dec = (m.to(dev).eval() for m in nyu_modules(
            SPATIAL_NYU_SEED, SPATIAL_NYU_CM_PER_UNIT,
            "densenet" if model == "nyu_densenet161" else "mobilenet"))
    else:
        enc, dec = build_models(dev, seed=SPATIAL_SEED)
    if model == "kitti_r18_depthdecoder":
        dec = init_params(DepthDecoder(enc.num_ch_enc),
                          torch.Generator().manual_seed(SPATIAL_SEED + 1))
        dec = dec.to(dev).eval()
    if model.endswith("_polyphase"):
        dec = polyphase_twin(dec)
    return enc, dec


def spatial_model_image(model: str, dev):
    """A SPATIAL_MODEL_CASES model's image: phase 12's network input of
    one seeded synthetic NYU frame, or the KITTI cases' image."""
    if model.startswith("nyu"):
        return nyu_input(nyu_frames(1, seed=SPATIAL_NYU_SEED)[0], dev)
    return spatial_image().to(dev)


def spatial_kwargs(name: str, outs: dict) -> dict:
    """The decoder's arguments of case `name`, under the masks of the
    earlier case SPATIAL_MASKS_FROM names (its output in `outs`)."""
    kw = SPATIAL_CASES[name]
    if name in SPATIAL_MASKS_FROM:
        kw = {**kw, "mask_override":
              raw_masks_of(outs[SPATIAL_MASKS_FROM[name]])}
    return kw


def kernel_launches(reset: bool = False) -> dict:
    """K1/K4's and K5/K6's launch counts (set to 0 first with reset)."""
    from wavelet_monodepth_tpu_torch.ops import blockio as bio
    from wavelet_monodepth_tpu_torch.ops import tile_sparse_conv as tsc
    if reset:
        tsc.reset_launches()
        bio.reset_launches()
    return {**tsc.launches, **bio.launches}


def spatial_rank(rank: int, world: int, port: int, out: str) -> None:
    """Phase 22 in one rank (a job of rank_jobs): the seeded KITTI R18 at
    1024x320 in bands through mesh.spatial_forward, each case once with
    the kernels' counts from 0 around it, then SPATIAL_CALLS timed
    forwards after a barrier; then SPATIAL_MODEL_CASES, each once
    counted, once timed, one model on the card at a time; its outputs in
    full height, its launches, ms per forward, scatter faults and wall
    clock marks to `out`."""
    clock = {"entered": time.time()}
    import torch
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from wavelet_monodepth_tpu_torch.ops import blockio as bio
    from wavelet_monodepth_tpu_torch.parallel import mesh
    clock["imported"] = time.time()
    dev = torch.device("cuda", 0)
    mesh.initialize_distributed(f"127.0.0.1:{port}", world, rank, dev)
    m = mesh.make_mesh(1, world)
    enc, dec = build_models(dev, seed=SPATIAL_SEED)
    band = mesh.shard_spatial(m, spatial_image().to(dev))
    rec = {"band_rows": band.shape[1], "backend":
           torch.distributed.get_backend(), "cases": {}, "launches": {},
           "ms": {}}
    clock["ready"] = time.time()
    outs = {}
    for name in SPATIAL_CASES:
        kw = spatial_kwargs(name, outs)
        fwd = mesh.spatial_forward(m, lambda img, kw=kw: dec(enc(img), **kw))
        kernel_launches(reset=True)
        got = outs[name] = fwd(band)
        torch.cuda.synchronize()
        rec["launches"][name] = kernel_launches()
        rec["cases"][name] = _to_cpu(got)
        mesh.barrier()
        t0 = time.perf_counter()
        for _ in range(SPATIAL_CALLS):
            fwd(band)
        torch.cuda.synchronize()
        rec["ms"][name] = (time.perf_counter() - t0) * 1e3 / SPATIAL_CALLS
    rec["scatter_faults"] = bio.scatter_faults(dev)
    clock["kitti_done"] = time.time()
    del enc, dec, outs
    model = None
    rec["model_band_rows"] = {}
    for name, (want, kw) in SPATIAL_MODEL_CASES.items():
        if want != model:
            enc = dec = band = None
            torch.cuda.empty_cache()  # the other rank's memory is the card's
            model = want
            enc, dec = spatial_model(model, dev)
            band = mesh.shard_spatial(m, spatial_model_image(model, dev))
            rec["model_band_rows"][model] = band.shape[1]
        fwd = mesh.spatial_forward(m, lambda img, kw=kw: dec(enc(img), **kw))
        kernel_launches(reset=True)
        got = fwd(band)
        torch.cuda.synchronize()
        rec["launches"][name] = kernel_launches()
        rec["cases"][name] = _to_cpu(got)
        del got
        mesh.barrier()
        t0 = time.perf_counter()
        fwd(band)
        torch.cuda.synchronize()
        rec["ms"][name] = (time.perf_counter() - t0) * 1e3
    clock["done"] = time.time()
    rec["clock"] = clock
    torch.save(rec, out)
    mesh.shutdown()


def spatial_references(dev) -> dict:
    """The one-card forward of every case on the same seeded weights and
    image, its launches, and the B=2 floor: the dense disparity of the
    image in a batch of two (cuDNN may pick other algorithms per shape,
    as it may per band) against B=1."""
    import torch
    enc, dec = build_models(dev, seed=SPATIAL_SEED)
    x = spatial_image().to(dev)
    refs = {"enc": enc, "dec": dec, "x": x, "out": {}, "launches": {}}
    with torch.inference_mode():
        feats = enc(x)
        refs["feats"] = feats
        for name in SPATIAL_CASES:
            kw = spatial_kwargs(name, refs["out"])
            kernel_launches(reset=True)
            refs["out"][name] = dec(feats, **kw)
            torch.cuda.synchronize()
            refs["launches"][name] = kernel_launches()
        two = dec(enc(torch.cat([x, x])))
        refs["floor"] = max(float((two[("disp", s)][:1]
                                   - refs["out"]["dense"][("disp", s)])
                                  .abs().max()) for s in range(4))
    return refs


def spatial_model_references(dev, refs: dict) -> None:
    """spatial_references for SPATIAL_MODEL_CASES, into `refs`: per model
    its encoder, decoder, image, features and B=2 floor (the dense
    disparity of the image in a batch of two against B=1), per case its
    one-card forward and launches. It runs after the ranks have ended:
    beside phase 21's NYU training in the ranks, its f32 DenseNet161
    forwards (cuDNN's FFT workspaces) left the ranks short of card
    memory."""
    import torch
    for model in dict.fromkeys(m for m, _ in SPATIAL_MODEL_CASES.values()):
        enc, dec = spatial_model(model, dev)    # parameters outside inference
        with torch.inference_mode():
            x = spatial_model_image(model, dev)
            n = refs[model] = {"enc": enc, "dec": dec, "x": x,
                               "feats": enc(x)}
            one, two = dec(n["feats"]), dec(enc(torch.cat([x, x])))
            n["floor"] = max(float((two[("disp", s)][:1]
                                    - one[("disp", s)]).abs().max())
                             for s in range(4))
    with torch.inference_mode():
        for name, (model, kw) in SPATIAL_MODEL_CASES.items():
            n = refs[model]
            kernel_launches(reset=True)
            refs["out"][name] = n["dec"](n["feats"], **kw)
            torch.cuda.synchronize()
            refs["launches"][name] = kernel_launches()


def spatial_vs_xla(ours: dict, refs: dict, kw: dict) -> dict:
    """A kernel case's rank output held to the one-card xla answer under
    phase 5's contract: disp within TOL (compact away from its
    COMPACT_RING), masks equal but for near ties (xla rerun under ours'
    masks), xla's op counts, no overflow ("ok")."""
    import torch
    with torch.inference_mode():
        ref, flips = near_tie_reference(
            ours, refs["out"]["sparse_xla"], SPATIAL_THRESH,
            lambda raw: refs["dec"](refs["feats"], mask_override=raw,
                                    **SPATIAL_CASES["sparse_xla"]))
    return {**backend_vs_xla(ours, ref, kw["use_pallas"]),
            "mask_flips": flips, "tol": TOL}


def nyu_near_tie_reference(ours, ref, thresh, rerun):
    """near_tie_reference for NyuDecoderWave: its sparse scale s (1, 0)
    thresholds ll = 2^(s+1) disp_(s+1) against scale s+1's coefficients;
    where a mask of `ours` differs from `ref`'s, the reference reruns
    under ours' masks and each of ours' mask pixels must equal that
    rerun's own decision or lie within 1e-5 of the threshold, relative
    to max(1, max |ll|)."""
    import torch
    flips = {s: int((ours[("wavelet_mask", s)]
                     != ref[("wavelet_mask", s)]).sum()) for s in (1, 0)}
    if any(flips.values()):
        raw = {s: ours[("wavelet_mask", s)][:, ::2, ::2].contiguous()
               for s in (1, 0)}
        ref = rerun(raw)
        for s in (1, 0):
            ll = ref[("disp", s + 1)] * 2.0 ** (s + 1)
            yh = torch.cat([ref[("wavelets", s + 1, b)]
                            for b in ("LH", "HL", "HH")], -1)
            t = (ll.amax(dim=(1, 2, 3)) - ll.amin(dim=(1, 2, 3))) * thresh
            peak = yh.abs().amax(-1)
            decided = (peak > t[:, None, None]).float()
            margin = (peak - t[:, None, None]).abs()
            near = 1e-5 * max(1.0, float(ll.abs().max()))
            require(bool(((raw[s][..., 0] == decided) | (margin < near))
                         .all()),
                    f"NYU mask differs away from the threshold at scale {s}")
    return ref, flips


def spatial_nyu_vs_xla(ours: dict, refs: dict, model: str, xla: str
                       ) -> dict:
    """A NYU kernel case's rank output held to the one-card masked-dense
    answer (case `xla` of refs' `model`) under phase 12's NYU contract:
    masks equal but for near ties (the masked-dense forward rerun under
    ours' masks), its op counts, every float output within TOL relative
    to max(1, max |ref|) (nyu_gap)."""
    import torch
    n = refs[model]
    with torch.inference_mode():
        ref, flips = nyu_near_tie_reference(
            ours, refs["out"][xla], NYU_THRESH,
            lambda raw: n["dec"](n["feats"], mask_override=raw,
                                 thresh_ratio=NYU_THRESH,
                                 use_pallas=False))
    gap = nyu_gap(ours, ref)
    ops_equal = torch.equal(ours[("total_ops", -1)], ref[("total_ops", -1)])
    return {"gap_rel": gap, "mask_flips": flips, "total_ops_equal":
            ops_equal, "tol": TOL, "ok": gap <= TOL and ops_equal}


def spatial_model_check(dev, refs: dict, recs: list) -> dict:
    """Phase 22's lines of SPATIAL_MODEL_CASES: each case of the ranks
    against the one-card forward of its model (the ranks bitwise equal;
    disp within SPATIAL_DISP_LIMIT or 3x the model's B=2 floor; masks
    equal but for near ties, op counts equal), each kernel case also
    against the one-card masked-dense answer (spatial_nyu_vs_xla), every
    kernel launched in each rank as often as on one card
    (SPATIAL_MODEL_LAUNCHES, none in the other cases). Returns {model:
    one rank's K1 / K4 launches over its cases}."""
    import torch
    spatial_model_references(dev, refs)
    one_ms = {}
    with torch.inference_mode():
        for name, (model, kw) in SPATIAL_MODEL_CASES.items():
            n = refs[model]
            for _ in range(2):                       # one untimed call
                t0 = time.perf_counter()
                n["dec"](n["enc"](n["x"]), **kw)
                torch.cuda.synchronize()
            one_ms[name] = (time.perf_counter() - t0) * 1e3
    launches = {}
    for name, (model, kw) in SPATIAL_MODEL_CASES.items():
        n, ref0 = refs[model], refs["out"][name]
        nyu = model.startswith("nyu")
        gate = max(SPATIAL_DISP_LIMIT, 3 * n["floor"])
        row = {"phase": "spatial", "case": name, "model": model,
               "ranks": SPATIAL_RANKS, "backend": "gloo",
               "res": list(n["x"].shape[1:3]), "batch": 1,
               "band_rows": recs[0]["model_band_rows"][model],
               "disp_gaps": [], "mask_flips": [], "total_ops_equal": [],
               "disp_limit": SPATIAL_DISP_LIMIT, "floor_b2": n["floor"],
               "gate": gate, "vs_one_card_masked_dense": [],
               "launches_per_rank": [rec["launches"][name] for rec in recs],
               "launches_one_card": refs["launches"][name],
               "ms_two_ranks": [rec["ms"][name] for rec in recs],
               "ms_one_card": one_ms[name]}
        if "thresh_ratio" in kw:
            row["density"] = [float(ref0[("wavelet_mask", s)].mean())
                              for s in ((1, 0) if nyu else (2, 1, 0))]
        for rec in recs[1:]:
            require(all(torch.equal(rec["cases"][name][k],
                                    recs[0]["cases"][name][k])
                        for k in recs[0]["cases"][name]),
                    ("spatial: the ranks' outputs differ", name))
        for rec in recs:
            require(rec["model_band_rows"][model]
                    == n["x"].shape[1] // SPATIAL_RANKS,
                    ("spatial band rows", name, rec["model_band_rows"]))
            ours = {k: v.to(dev) for k, v in rec["cases"][name].items()}
            require(set(ours) == set(ref0), ("spatial keys", name))
            ref = ref0
            if "thresh_ratio" in kw:
                tie = nyu_near_tie_reference if nyu else near_tie_reference
                with torch.inference_mode():
                    ref, flips = tie(ours, ref0, kw["thresh_ratio"],
                                     lambda raw, kw=kw: n["dec"](
                                         n["feats"], mask_override=raw,
                                         **kw))
                row["mask_flips"].append(flips)
                row["total_ops_equal"].append(torch.equal(
                    ours[("total_ops", -1)], ref[("total_ops", -1)]))
            for s in range(4):
                require(ours[("disp", s)].shape == ref[("disp", s)].shape,
                        ("spatial disp shape", name, s))
                require(bool(torch.isfinite(ours[("disp", s)]).all()),
                        ("spatial finite disp", name, s))
            row["disp_gaps"].append(disp_max_gap(ours, ref))
            if name in SPATIAL_MODEL_XLA:
                row["vs_one_card_masked_dense"].append(spatial_nyu_vs_xla(
                    ours, refs, model, SPATIAL_MODEL_XLA[name]))
        emit({**row, **_card})
        require(max(row["disp_gaps"]) <= gate, ("spatial disp", row))
        require(all(row["total_ops_equal"]), ("spatial total_ops", row))
        require(all(r["ok"] for r in row["vs_one_card_masked_dense"]),
                ("spatial kernel case vs masked dense", row))
        want = SPATIAL_MODEL_LAUNCHES.get(name, {})
        for kern in refs["launches"][name]:
            require(refs["launches"][name][kern] == want.get(kern, 0)
                    and all(rec["launches"][name][kern] == want.get(kern, 0)
                            for rec in recs),
                    ("spatial launches", name, kern, row))
        mine = launches.setdefault(model, dict.fromkeys(KERNELS, 0))
        for kern in mine:
            mine[kern] += recs[0]["launches"][name][kern]
    return launches


def spatial_check(dev, refs: dict, recs: list) -> dict:
    """Phase 22's checks and lines: the ranks' records (spatial_rank)
    against the one-card references (spatial_references), each kernel
    case also against the one-card xla answer (spatial_vs_xla), then the
    cases of SPATIAL_MODEL_CASES (spatial_model_check). Returns one
    rank's launches of K1, K4, K5 and K6 over the KITTI cases, and of K1
    and K4 over the NYU DenseNet161 cases under "<kernel>_nyu" and over
    the NYU MobileNetV2 cases under "<kernel>_nyu_mbv2"."""
    import torch
    enc, dec, feats = refs["enc"], refs["dec"], refs["feats"]

    def one_card(kw):
        def run():
            with torch.inference_mode():
                dec(enc(refs["x"]), **kw)
        return run
    one_ms = time_variants({name: one_card(spatial_kwargs(name, refs["out"]))
                            for name in SPATIAL_CASES}, iters=10)
    gate = max(SPATIAL_DISP_LIMIT, 3 * refs["floor"])
    for rec in recs:
        require(rec["backend"] == "gloo", ("spatial backend", rec["backend"]))
        require(rec["band_rows"] == R50_H // SPATIAL_RANKS, rec["band_rows"])
        require(rec["scatter_faults"] == 0, ("spatial scatter faults",
                                             rec["scatter_faults"]))
    for name, kw in SPATIAL_CASES.items():
        ref0 = refs["out"][name]
        if name in SPATIAL_MASKS_FROM:
            # the one-card forward under the masks the ranks took
            with torch.inference_mode():
                ref0 = dec(feats, **spatial_kwargs(name, {
                    SPATIAL_MASKS_FROM[name]:
                    {k: v.to(dev) for k, v in
                     recs[0]["cases"][SPATIAL_MASKS_FROM[name]].items()}}))
        row = {"phase": "spatial", "case": name, "ranks": SPATIAL_RANKS,
               "backend": "gloo", "res": [R50_H, R50_W], "batch": 1,
               "band_rows": recs[0]["band_rows"], "disp_gaps": [],
               "lh1_gaps": [], "mask_flips": [], "total_ops_equal": [],
               "disp_limit": SPATIAL_DISP_LIMIT, "floor_b2": refs["floor"],
               "gate": gate, "vs_one_card_xla": [], "launches_per_rank":
               [rec["launches"][name] for rec in recs],
               "launches_one_card": refs["launches"][name],
               "ms_two_ranks": [rec["ms"][name] for rec in recs],
               "ms_one_card": one_ms[name]}
        for rec in recs[1:]:
            require(all(torch.equal(rec["cases"][name][k],
                                    recs[0]["cases"][name][k])
                        for k in recs[0]["cases"][name]),
                    ("spatial: the ranks' outputs differ", name))
        for rec in recs:
            ours = {k: v.to(dev) for k, v in rec["cases"][name].items()}
            require(set(ours) == set(ref0), ("spatial keys", name))
            ref = ref0
            if "thresh_ratio" in kw:
                with torch.inference_mode():
                    ref, flips = near_tie_reference(
                        ours, ref0, SPATIAL_THRESH,
                        lambda raw, kw=kw: dec(feats, mask_override=raw,
                                               **kw))
                row["mask_flips"].append(flips)
                row["total_ops_equal"].append(torch.equal(
                    ours[("total_ops", -1)], ref[("total_ops", -1)]))
            for s in range(4):
                require(ours[("disp", s)].shape == ref[("disp", s)].shape,
                        ("spatial disp shape", name, s))
                require(bool(torch.isfinite(ours[("disp", s)]).all()),
                        ("spatial finite disp", name, s))
            row["disp_gaps"].append(disp_max_gap(ours, ref))
            k = ("wavelets", 1, "LH")
            row["lh1_gaps"].append(float((ours[k] - ref[k]).abs().max()))
            if name in SPATIAL_KERNELS:
                row["vs_one_card_xla"].append(spatial_vs_xla(ours, refs, kw))
        emit({**row, **_card})
        require(max(row["disp_gaps"]) <= gate, ("spatial disp", row))
        require(all(row["total_ops_equal"]), ("spatial total_ops", row))
        require(all(r["ok"] for r in row["vs_one_card_xla"]),
                ("spatial kernel case vs xla", row))
        for kern in SPATIAL_KERNELS.get(name, ()):
            n = refs["launches"][name][kern]
            require(n > 0 and all(rec["launches"][name][kern] == n
                                  for rec in recs),
                    ("spatial launches", name, kern, row))
    models = spatial_model_check(dev, refs, recs)
    emit({"phase": "spatial", "rank_timelines_s":
          [rec["timeline_s"] for rec in recs], **_card})
    refs.clear()
    torch.cuda.empty_cache()
    launches = {kern: recs[0]["launches"][name][kern]
                for name, kerns in SPATIAL_KERNELS.items() for kern in kerns}
    for model, fam in (("nyu_densenet161", "nyu"),
                       ("nyu_mobilenetv2", "nyu_mbv2")):
        launches.update({f"{kern}_{fam}": k
                         for kern, k in models[model].items()})
    return launches


def ratio(timed: dict, a: str, b: str):
    """timed[a] / timed[b] of bench.measure's medians, or None."""
    ms_a, ms_b = timed[a]["ms"], timed[b]["ms"]
    return None if ms_a is None or ms_b is None else ms_a / ms_b


def main():
    dev = phase_device()
    sys.path.insert(0, REPO)
    import torch
    phase_build()
    errs = {k: 0.0 for k in KERNELS}
    errs.update(banded_warp_fwd=0.0, banded_warp_bwd=0.0, band_gather=0.0,
                block_scatter=0.0, band_gather_bf16=0.0,
                block_scatter_bf16=0.0, fused_wave_stage=0.0)
    phase_kernel_vs_plain(dev, errs)
    launches, enc, dec = phase_slice(dev)
    no_scatter_faults(dev, "slice")
    phase_contracts(dev, enc, dec)
    phase_contracts_r50(dev)
    no_scatter_faults(dev, "contracts")
    phase_polyphase(dev, enc, dec)
    launches.update(phase_bf16_serving(dev, enc, dec))
    no_scatter_faults(dev, "bf16_serving")
    encb, decb = bf16_copies(enc, dec)
    phase_block_io_vs_plain(dev, enc, dec, errs, torch.float32)
    phase_block_io_vs_plain(dev, encb, decb, errs, torch.bfloat16)
    no_scatter_faults(dev, "block_io_vs_plain")
    phase_sync_count(dev, enc, dec)
    no_scatter_faults(dev, "sync_count")
    fused_launches, stage_ins = phase_fused_stage(dev, enc, dec, errs)
    kernel_ms = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                     "library_ms": 0.0, "bound_ms_f32_cuda_cores": 0.0}
                 for k in KERNELS}
    phase_times(dev, enc, dec, kernel_ms)
    no_scatter_faults(dev, "time_forward")
    block_io_ms = phase_block_io_times(dev, enc, dec, torch.float32)
    block_io_ms_bf16 = phase_block_io_times(dev, encb, decb, torch.bfloat16)
    no_scatter_faults(dev, "time_block_io")
    fused_ms = phase_fused_times(dec, stage_ins)
    del stage_ins
    profile_forwards(enc, dec, dev, encb, decb)
    no_scatter_faults(dev, "profile_forwards")
    del encb, decb
    phase_bench(dev)
    no_scatter_faults(dev, "bench")
    # ms / plain_ms / bound_ms / library_ms: the 12 launches of one B=16
    # sparse forward at the 10% operating point, summed medians
    kernels = [{
        "name": f"tile_sparse_conv3x3 via {k}", "route": "cuda",
        "source": SOURCES["tile_sparse_conv"],
        "replaces": KERNELS[k], "launches": launches[k],
        "max_abs_err": errs[k], **kernel_ms[k]} for k in KERNELS]
    # K5 / K6: the 18 / 6 launches of one B=16 compact forward, summed;
    # launches: the 4 served requests'; the _bf16 keys: the bfloat16
    # instance, its launches those of the bf16 serving path (B=16 and B=1)
    kernels += [{
        "name": k, "route": "cuda", "source": SOURCES["blockio"],
        "replaces": BLOCKIO_REPLACES[k], "launches": launches[k],
        "max_abs_err": errs[k], **block_io_ms[k],
        "launches_bf16": launches[k + "_bf16"],
        "max_abs_err_bf16": errs[k + "_bf16"],
        **{f"{key}_bf16": v for key, v in block_io_ms_bf16[k].items()}}
        for k in BLOCKIO_REPLACES]
    # K2: its 3 scales at B=16, summed; JAX wires K2 into no decoder path,
    # so its launches are this script's own calls on the decoder's stage
    # inputs (scales 3, 2, 1 at B=16 and B=1)
    kernels.append({
        "name": "fused_wave_stage", "route": "cuda",
        "source": SOURCES["fused_wave_stage"], "replaces": FUSED_REPLACES,
        "launches": fused_launches, "max_abs_err": errs["fused_wave_stage"],
        **fused_ms,
        "note": "no JAX decoder path runs K2: launches are chip_smoke's "
                "calls on the decoder's stage inputs; library_ms is null: "
                "no single PyTorch call computes the stage"})

    phase_warp_vs_plain(dev, (enc, dec), errs)
    del enc, dec
    with tempfile.TemporaryDirectory(prefix="chip_smoke_kitti_") as tmp:
        root = os.path.join(tmp, "kitti")
        t0 = time.perf_counter()
        write_kitti_mount(root, 36, TRAIN_B)
        emit({"phase": "kitti_mount", "pairs": 36, "size": KITTI_FULL,
              "seconds": time.perf_counter() - t0})
        warp_launches, ckpt = phase_train_slice(dev, root,
                                                os.path.join(tmp, "log"))
        phase_train_slice(dev, root, os.path.join(tmp, "log_bf16"),
                          bf16=True)
        batch = phase_train_contracts(dev, root)
        warp_ms = phase_train_times(dev, root, batch)
        eval_root, folder18 = phase_eval(dev, ckpt, tmp)
        pose_launches = phase_kitti_pose(dev, root, tmp, warp_launches)
        nyu = phase_nyu(dev, errs, tmp)
        nyu_zip = phase_nyu_train(dev, tmp)
        hr = phase_kitti_hr_train(dev, root, tmp, errs)
        phase_visuals(dev, root, tmp, nyu_zip)
        phase_soak(dev, root, tmp)
        golden_launches = phase_self_golden(dev, eval_root, tmp)
        phase_sparsity(dev, tmp)
        phase_native(dev, eval_root, folder18)
        phase_serving_tools(dev, eval_root, folder18,
                            os.path.join(tmp, EVAL_CONFIGS[1][0]), tmp)
        ddp_launches, spatial_launches = phase_ddp(dev, root, tmp)
    # ms: one K3 launch at (12, 192, 640, 3) (backward: the training
    # path's, no source-row pass); launches: the train main path's;
    # launches_kitti_pose: the M+S train main path's (phase 14);
    # launches_ddp: one rank's of the two-rank KITTI run (phase 21);
    # *_kitti_hr: the 1024x320 B=6 path's launches (phase 15) and one
    # launch at (6, 320, 1024, 3)
    kernels += [{
        "name": k, "route": "cuda", "source": SOURCES["banded_warp"],
        "replaces": WARP_REPLACES, "launches": warp_launches[k],
        "launches_kitti_pose": pose_launches[k],
        "launches_ddp": ddp_launches[k],
        "max_abs_err": errs[k], **warp_ms[k], **hr[k]}
        for k in ("banded_warp_fwd", "banded_warp_bwd")]
    # K1 / K4: the NYU serving path's launches (the sparse requests of
    # phase 12) and, *_nyu, the B=8 sums over the NYU convs each runs per
    # sparse forward on its backend, at the 5% operating point
    for entry, k in zip(kernels, KERNELS):
        entry.update(nyu[k])
    # launches_spatial: one rank's of one spatial forward (phase 22): K1 on
    # pallas, K4 on pallas2d, K5 / K6 on compact; launches_spatial_nyu: one
    # rank's over the NYU sparse forwards (K1: 4 + 2 + 2, K4: 2);
    # launches_spatial_nyu_mbv2: one rank's over the NYU MobileNetV2
    # forwards (the pallas2d case: K1 2, K4 2)
    # launches_self_golden: the self-golden phase's (17b) one B=16 sparse
    # forward per kernel backend on the soaked checkpoint's own masks (K1
    # on pallas, K4 on pallas2d, K5 / K6 on compact)
    for entry in kernels:
        key = entry["name"].split(" via ")[-1]
        if key in golden_launches:
            entry["launches_self_golden"] = golden_launches[key]
        if key in spatial_launches:
            entry["launches_spatial"] = spatial_launches[key]
        for fam in ("nyu", "nyu_mbv2"):
            if f"{key}_{fam}" in spatial_launches:
                entry[f"launches_spatial_{fam}"] = \
                    spatial_launches[f"{key}_{fam}"]
    print(card_line(), flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
