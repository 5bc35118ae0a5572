#!/usr/bin/env python3
"""Drive the PyTorch port (``patchgan_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of the repository. In order:

1. prints the card's name and power limit, the torch / CUDA versions, and
   builds every kernel from ``patchgan_tpu_torch/csrc`` (one nvcc per
   source, all at once), with the build time;
2. kernel phase: each forward kernel (K1 instance norm + act, K2 conv +
   IN + act, K3 convT + IN + act) at every shape the nf=64 generator
   gives it for 8 tiles of 256 px, in bf16 and fp32, against its plain
   PyTorch version on the same inputs with TF32 off. Tolerances: fp32
   inputs, atol 1e-3 (another summation order); bf16 inputs against the
   plain version in fp32 on the same bf16-rounded inputs, atol 3e-2 (one
   bf16 rounding of outputs of magnitude up to ~5). K3 also runs a case
   with H != W and a ragged one (13 + 6 input channels, so K = 76 is no
   multiple of 8 and one K step holds x, skip and the zero-filled tail;
   40 output channels; 12 x 20), and every kernel all four activations at
   one shape. K3's weight pack kernel is held exactly against
   ``pack_convt_weight_plain`` at every K3 case, in both dtypes. K1 also
   runs check-only cases at the edges of its launch classes
   (``norm_edge_cases``: planes of 16, 64, 256, 1024, 4096 and 65536
   elements, a plane count no multiple of a block's planes, 1x1, 1x3 and
   6x10 planes, inputs one element past a 16-byte boundary; all four
   activations at 4x4), and two launches on the same inputs must give
   equal bits. K2 and K3 (their NCHW forms) run all four activations at
   every level: in bf16 on the planner's core (the wgmma core of
   ``csrc/conv_wgmma.cuh`` behind its layout passes at the nf=64 widths;
   the ragged K3 case on the WMMA core of ``csrc/conv_gemm.cuh``) and on
   the WMMA core forced (``_core='wmma'``), in fp32 on the WMMA core,
   each launch counted on the core it must take; ptxas's report of the
   NCHW instantiations of the wgmma core (none may spill). Times (CUDA
   events): the kernel, its plain version, and a
   library yardstick (cuDNN conv + F.instance_norm + activation, which
   the port never calls), beside the bound max(FLOPs / peak, bytes / 3.35
   TB/s); K1's row also carries its device time (a CUDA graph's
   replay, without the wrapper's host work) and launch geometry, K2's and
   K3's their device time, both cores by events and by a graph's replay,
   the layout passes alone and the library call by a replay;
   then K4 (the thin 3x3 conv of the s2d boundary form) and K4-wgrad (its
   weight gradient) at every shape of the s2d paths: enc0 of an 8-tile
   inference chunk (12 -> 64 channels on the 128 x 128 s2d grid), the
   batch-16 step's enc0 / discriminator conv0 image part (12 -> 64) and
   mask part (28 -> 64), the merged 32-sample validation discriminator,
   and four cases checked only: a ragged one (4 -> 28 channels on 40 x
   70, a width that is no multiple of the 64-wide tile or of 8, so both
   kernels stage x and dy element by element and K4 stores its output so),
   an aligned partial one (20 -> 40 on 24 x 72: a width that is a multiple
   of 8 but not of 64, so the 16-byte staging runs with chunks past the
   image; a half-empty 8-channel group; Cout under one block), one with
   fewer tiles than the persistent grid (12 -> 64 on 6 x 8) and the
   widest input (32 -> 64 on 16 x 64). K4 tolerances as K2's; K4-wgrad
   (fp32 output) 1e-3 max(1, max |dw|) in both dtypes; K4's weight pack
   kernel exactly equal to ``pack_thin_weight_plain`` at every case, in
   both dtypes. Each timed row carries the grid (blocks along the tiles)
   and the blocks an SM holds. Library yardsticks F.conv2d and
   torch.nn.grad.conv2d_weight in bf16;
3. the inference path: ``patchgan_infer -d cuda`` (bf16) with a random
   nf=64 3 -> 7-class generator on four images (1280x960, 640x480,
   256x256, 200x150), checking each mask's shape and labels, and that
   K1, K2 and K3 ran 1, 6 and 5 times per forward chunk; then the same
   with ``PATCHGAN_S2D=on`` (the space-to-depth boundary form), where K4
   also runs once per chunk;
4. the full nf=64 forward on one bucket of 8 tiles: the kernel path in
   fp32, plain and s2d form, against the plain path (the same model on
   the CPU), max |dprob| <= 1e-3; the bf16 kernel path against it,
   reported;
5. masks/s for the 1280x960 image, one image at a time, in windows of at
   least 1.5 s (``WINDOW_S``), three per form, plain and s2d in turns (every reading and
   the medians), and tiles/s of the forward at buckets 8 and 32 in both
   forms;
6. K1-bwd (the instance norm + act backward) at the 12 shapes of one
   generator backward at batch 16, 256 px, nf=64, in bf16 and fp32, plus
   all four activations at one shape, an H != W case and planes whose
   middle value normalises to exactly 0, against the plain backward on
   the same inputs (fp32 max |err| <= 1e-3 max(1, max |dx|); bf16
   against the fp32 plain version on the bf16-rounded inputs, <= 3e-2
   max(1, max |dx|)), then K1's edge cases (both dtypes, all four
   activations at 4x4) and the equal-bits check of two launches. Times:
   kernel (CUDA events, host work included), its device time (a CUDA
   graph's replay),
   plain, and ATen's backward of F.instance_norm + relu through
   torch.autograd.grad (never called by the port), beside the bytes
   bound, with each level's launch geometry (class, grid, group);
7. step parity, plain form and s2d form: one G+D loss and the generator's
   and discriminator's gradients at nf=64, 256 px, batch 2, fp32, TF32
   off, dropout off, from the same weights and batch, through the kernel
   path on the card and the plain path on the CPU: losses within rtol
   2e-3 / atol 2e-4, every gradient within 1e-3 of that tensor's max
   |g|; then the fine-tune step's parity: the encoder frozen
   (``('enc',)``), accumulation every 2, two fp32 micro-batches of 2 on
   both devices: losses as above, the card's gradients of each
   micro-step within 1e-4 of each tensor's max |g| of its full step's
   on the same weights and batch, the first's within 1e-3 of the CPU's
   (the second's printed: ``finetune_parity_phase`` says why), the mean
   the second hands Adam the running mean of the two, no parameter
   moved after the first, the encoder bit-equal to its initial weights
   after the second on both devices, every other parameter within Adam's sign-flip bound of the
   CPU's (``assert_update_close``);
8. the training path: ``patchgan_train -d cuda`` (bf16, batch 16, 2
   epochs, nf=64 / ndf=64, 256 px, tversky * 200 + BCE) on a synthetic
   npz folder (64 training and 16 validation images, 7 classes), then a
   resume with ``load_last_checkpoint`` to epoch 3: finite losses, all
   four epoch files, the resume at epoch 3 with the fast-forwarded LR,
   and K1 / K2 / K3 / K1-bwd at 1 / 6 / 5 / 12 launches per train step
   (1 / 6 / 5 / 0 per validation batch) and 11 K2 / K3 recomputes for
   each step the wrappers ran: the Trainer's captured step
   (``train/graph.py``) runs its first step eagerly and launches the
   kernels again into the graph at its capture, and the steps after
   that are replays, which call no wrapper: the Trainer's
   ``graph_counts`` (eager steps, captures, replays) must read (1, 1, 7)
   and (1, 1, 3), and phase 10 holds a replay's kernels against the
   same table; then
   the fine-tune of BASELINE.json config 3 (``FT_STEP``): the epoch-3
   weights as torch .pth files, ``transfer_learn.freeze_encoder``,
   ``accumulate_steps: 2``, one epoch: K1-bwd 5 a step, no K2
   recompute, the encoder bit-equal to the .pth; all of it again under
   ``PATCHGAN_S2D=on``, where a train step also launches K4 6 times and
   K4-wgrad 4 times (3 in the fine-tune: the frozen enc0 takes none) and
   a validation batch K4 5 times;
9. the evaluation path: ``patchgan_eval -d cuda`` (bf16, batch 8) with
   the training config on its 16 validation images, so the newest epoch
   file is evaluated: the JSON line's keys, n_images 16, values in [0,
   1], K1 / K2 / K3 1 / 6 / 5 a batch; ``-d cuda --dtype float32``
   against ``-d cpu --dtype float32``, IoU, Dice and boundary F1 within
   2e-3; then images/s of the bf16 loop on ``EVAL_TIMED`` seeded images
   (batch 8, the first batch left out), in two runs;
10. the captured step (``train/graph.py``) against the eager step, bit
   for bit (bf16, batch 16, dropout on, deterministic cuDNN): the full
   and the frozen step in both forms and the frozen step accumulating two
   micro-batches of 8, 4 steps (4 updates) each way from the same weights
   and batches, then an LR written between two more: every step's
   losses, every parameter, Adam moment, count and LR tensor,
   accumulator and the dropout generator's state equal; a Trainer's
   captured step restored with ``_restore_training_state`` and stepped
   again equal to an eager Trainer's. Then phase 19's checks (below).
   Then training img/s of the bf16 step on a device-resident batch, in
   turns, three windows of at least 1.5 s each (every reading and the
   medians): the full step at batch 16 in the plain and the s2d form,
   the fine-tune step (encoder frozen) in both forms, the fine-tune step
   accumulating two micro-batches of 8, the plain, s2d and accumulating
   steps captured, and the plain step captured in channels_last with the
   generator's shadow (phase 19: img/s against the NCHW step's, cuDNN's
   layout transposes a replay against its 240; ``--layout-only`` times
   it without the shadow too); host ms a step,
   peak device memory, and a profiler breakdown of three steps of each
   (the top kernels, then each of the port's kernels, the device busy
   share and the device kernels launched a step, fewer for a frozen step
   than a full one of its form), where each config's K1 / K2 / K3 /
   K1-bwd / K4 / K4-wgrad kernels a step, counted by the profiler (a
   captured step's in its replays), must equal ``STEP`` or
   ``FT_STEP``; an eager step's wrappers must launch exactly those
   counts over the profiled steps, and its trace may then count fewer,
   never more (the tracer loses a run of records now and then; the run
   prints so); then ``python -m
   patchgan_tpu_torch.cli.aot --shadow -d cuda`` at config 2 (batch 16,
   the Trainer's layout): the JAX CLI's keys, fits, its peak within 10%
   of the captured step's own peak above in the same layout (channels_last
   with the shadow); at batch 4096: does not fit, exit 0;
11. spatial mode (one whole-image forward, the plain form): the fp32
   forward of a 640x480 image (padded to 640x512) through the kernels on
   the card against the same model on the CPU, max |dprob| <= 1e-3 and
   the argmax masks equal on >= 99.9% of pixels, K1 / K2 / K3 1 / 6 / 5
   launches an image; K1-K3 at the shapes of one 1280x960 image (padded
   1280x1024: K1 at 64 planes of 512 x 640, K2 at enc1-enc6, K3 at
   dec1-dec5) against their plain versions in bf16 and fp32 at phase 2's
   tolerances, timed with their library yardsticks and bounds; that a
   mask's ``.result()`` returns while a forward queued after it still
   runs; masks/s of spatial and tiled mode on the 1280x960 image (bf16),
   three windows of at least 1.5 s each, in turns;
12. the serve path, ``patchgan_serve -d cuda`` (bf16) on the four
   inference images as files (1280x960 and 640x480 JPEG, 256x256 and
   200x150 PNG) and a corrupt .jpg: ``--watch --once`` (every mask's
   shape and labels, the corrupt file an ERROR, a second pass serving
   0, launches per forward chunk as in phase 3), again with ``--batch
   4`` (the same masks) and in spatial mode; ``--stdin`` with a missing
   path among the four (output in order, ERROR in its place); ``--http``
   in process at ``--batch 0`` and ``--batch 4`` (/healthz 200, every
   image's PNG equal to the watch mask, bad bytes 400), then 8 clients
   in a process of their own posting the 1280x960 JPEG and then the
   256x256 PNG, three windows of at least 1.5 s per server in turns
   (requests/s, p50 and p95 latency); the stitch's share of the
   1280x960 tiled pipeline (its wall time minus its forward chunks); and
   the SIGTERM drain of ``python -m patchgan_tpu_torch.cli.serve --http
   -d cuda`` signalled with requests in flight (all answered, exit 0);
13. the input pipeline and exact resume, on 256 seeded smooth 640x480
   JPEGs with 7-label PNG masks (COCO-Stuff layout, 16 more for
   validation) and the same pairs as 4 tar shards: whether the native
   decode built (the machine may lack the libjpeg / libpng headers; then
   PIL decodes, as in the JAX package) and host ms per pair at 256 px;
   the loader alone (batch 16, bf16, 'randomcrop+flip', batches landed
   on the card, one synchronize per epoch) in turns: thread x4 with
   PATCHGAN_NATIVE_IO=off, thread x4 native, process x4, thread x4 with
   the RAM cache at epoch 2 and later (the decoder called no time), and
   TarShards thread x4, every reading and the medians; ``patchgan_train
   -d cuda`` at config 2 with the default loader and the fastest one,
   and with the RAM cache twice, the step captured and
   ``PATCHGAN_CUDA_GRAPH=off`` in turns, epoch 2's img/s beside phase
   10's captured step alone, launches per step the wrappers ran as in
   ``STEP['off']``, the Trainer's ``graph_counts`` (1, 1, 31) captured
   and (0, 0, 0) when off; one epoch from
   the shards and one from the folder
   (PIL on both, flips on, ``--deterministic``): bit-equal epoch files;
   exact resume (use_dropout, accumulate_steps 2, 2 epochs of 64
   images), each run ``patchgan_train -d cuda --deterministic`` in a
   process of its own (``train_child``): two uninterrupted runs (the
   control, run beside the first cut run), then one with
   save_every_steps 1 killed (SIGKILL) when its
   rolling metadata shows epoch 2 with 1 batch done, resumed and killed
   at 3, resumed to the end: its epoch files equal the control's bits,
   or differ by no more than the control's two runs do (each process
   that ends prints its Trainer's ``graph_counts``, the controls' (2, 2,
   6)); the ms of one
   rolling save at config 2; and ``--profile_dir``: one trace, of epoch
   1, naming K2's and K3's kernels. Every Trainer here runs the captured
   step, its default on the card;
14. data parallelism (BASELINE.json config 5; ``parallel/``): (a) NCCL
   at world size 1 in this process: three captured DP steps (bf16,
   batch 16, dropout on, deterministic cuDNN) against three captured
   single-process steps from the same state, every loss and every
   tensor the step changes bit-equal, the DP run's launches (the eager
   step and the capture, 2 x ``STEP``); img/s and host ms of both in
   turns, the device kernels of a replay (NCCL's among them), the
   dropout draws' ms for a rank's rows and for the global batch; (b)
   two gloo ranks sharing the card (``dp_gloo_child``), fp32, eager,
   flips and dropout on, tanh, three steps of the loader's global batch
   of 16: the ranks' losses and weights bit-equal after every step; one
   process on the whole batch: losses within rtol 2e-4 / atol 1e-5, the
   first update's gradients within 1e-3 of each tensor's max |g|, at
   most ``DP_WEIGHTS_LOOSE`` weights outside rtol 5e-3 / atol 2e-4 and
   all within 2.5 lr (``dp_gloo_phase`` says why; ReLU's cross-rank
   path is held bit for bit only at world size 1, in (a)); each rank's launches 3 x ``STEP`` at
   batch 8, the gloo all-reduce of the 178.4 MB gradient bucket; (c)
   ``patchgan_train -d cuda --deterministic`` under ``python -m
   torch.distributed.run --nproc_per_node K`` (K = min(cards, 4)) on
   phase 13's first 64 JPEGs, two epochs: one set of epoch files, which
   a single-process Trainer loads, each rank's graph counts (1, 1, 7); a
   run killed (every process of it) at epoch 2's first rolling save and
   resumed ends bit-equal; (d) where there are two or more cards, NCCL
   over 1, 2 (and 4) cards, captured, bf16: img/s per card and the
   captured all-reduce's ms against ``patchgan_aot``'s NVLink bound; on
   one card a line says why it did not run;
15. the inference engine over the cards of one process
   (``parallel.DeviceMesh``), with phase 3's generator and images: (a)
   a mesh of the one card listed twice, always; (b) where there are two
   or more cards, meshes of 2 and of min(cards, 4) cards (on one card a
   line says why not). On each: the fp32 ``predict_tiles`` of one
   32-tile bucket against the one-card engine's, max |dprob| <= 1e-3
   (bit-equality printed); the bf16 masks of the four images, one at a
   time and as one ``predict_images`` group, equal to the one-card
   engine's on >= 99.9% of pixels; K1 / K2 / K3 1 / 6 / 5 launches a
   device a chunk, and K4 1 under ``PATCHGAN_S2D=on``; the host ms to
   issue one device's share of a 32-tile chunk against that share's
   device ms. Then spatial mode split by rows over each mesh
   (``parallel.spatial.BandThreads``, the band kernels): the fp32 band
   forward of phase 11's 640x480 image (padded 640x512) against the
   one-card fp32 forward, max |dprob| <= 1e-3, and its masks; the bf16
   1280x960 mask against the one-card spatial mask, every differing
   pixel's fp32 top-2 margin within twice the two bf16 forwards' errors
   (agreement and bit-equality printed), no warning, each device's
   launches
   ``band_forward_plan``'s (1024 rows over 2 or 4: ``in_stats`` 1,
   ``in_apply`` 12, ``conv_band`` 6, ``convt_band`` 5, no whole-plane
   kernel), every ``conv_band`` and ``convt_band`` launch on the wgmma
   core; the card listed three times (1024 rows do not split into 3)
   warns and equals the one-card mask bit for bit; where there are two or
   more cards, masks/s of spatial mode on the 1280x960 image and on a
   4096x4096 survey tile at 1, 2 and min(cards, 4) cards, three windows
   of at least 1.5 s each in turns, each card's peak memory, each device's
   host ms to issue its band forward against its device ms, and
   ``patchgan_infer -d cuda`` in spatial mode over every card (masks
   equal to the engine's over every card on >= 99.9%). Then masks/s of
   the 1280x960 image one at a time and in groups of 4 at 1, 2 and 4
   cards (on one card: 1 card and the card twice), with the widest
   mesh's groups also pending on the home card's copy, three windows of
   at least 1.5 s each in turns; ``python -m
   patchgan_tpu_torch.cli.infer -d cuda`` over every card (its header
   names the mesh, masks equal to phase 3's on >= 99.9%) and
   ``patchgan_serve -d cuda --watch --once`` (masks equal to phase
   12's on >= 99.9%, launches a device a chunk).
   ``python3 chip_smoke.py --mesh-only`` runs phase 15 alone, after
   phase 3 and a one-card serve run for its references;
16. data x model parallel training (``parallel/sharding.py``, ROADMAP
   item 11c): every kernel at a rank's shard shapes of the step at batch
   16 (the output channels over 2, and over 4 where K2 meets Cout 32),
   bf16 and fp32 against its plain version, with the bf16 ms of K1-K3 at
   tp 2; (a) always: two gloo ranks sharing the card, dp 1 x tp 2, fp32,
   eager, dropout on, three steps of config 2's widths at a global batch
   of 16 from one seeded state, against one process on the card: with
   tanh (as 14b) in the plain and the s2d form losses within rtol 5e-4 /
   atol 2e-5, every gathered tensor >= 99.9% within 2e-4 + 5e-3|b| and
   all within 2.5e-3 (JAX's hybrid limits); with relu in the plain form
   the same read, not held; in every run the replicated parameters
   bit-equal over the model group and each rank's launches 3 x
   ``STEP``; (b) where there are two or more cards, NCCL, captured, bf16
   at config 2 over (dp, tp) = (1, 2) beside (2, 1), and at 4 cards (2,
   2) beside (4, 1): img/s per card, the step's model-group all-gathers
   and all-reduces and its gradient bucket alone, each captured and
   timed, parameter, optimizer and peak bytes a rank, and
   ``patchgan_aot --dp D --tp T -d cuda`` under torchrun (compile_ok,
   fits, its NVLink bounds); on one card a line says why (b) did not
   run. ``python3 chip_smoke.py
   --tp-only`` runs phase 16 alone.
17. spatial parallelism (``parallel/spatial.py``, ROADMAP item 11d, the
   training half): (a) each band entry point of K1, K1-bwd, K2 and K3
   (``in_stats``, ``in_apply``, ``conv_band``, ``convt_band``,
   ``in_bwd_sums``, ``in_bwd_apply``) against its plain stage version at
   the nf=64 levels' bands of a 1024-px image, batch 2 (a top and a bottom
   band at sp 2, a middle one at sp 4), bf16 and fp32, the kernel phase's
   tolerances (a sum's times max(1, max |sum|)); the bands' stats summed,
   applied and concatenated against the whole-plane kernel; two launches
   equal; K2's and K3's band entries on the wgmma core in bf16 (their
   layout pass and then the core; the launches by core counted) and on
   the WMMA core in fp32, their layout pass bit-equal to
   ``nchw_to_nhwc_plain``, the band instantiations' ptxas registers and
   spills (none may spill); ``in_bwd_sums``' and ``in_bwd_apply``'s kernels
   (``csrc/band_norm.cuh``) also at their element paths (planes whose
   bytes are no multiple of 16, x and g one element past 16 bytes) and in
   all four activations, their ptxas registers and spills (none may
   spill); the bf16 ms of each on the top band beside its plain version,
   its bound and the whole-plane kernel at the global shape, K2's and
   K3's on both cores on the same values by events and by a graph's
   replay, and their layout passes' ms on a line of their own; the four
   K1 / K1-bwd band entries by events and by a graph's replay, their sums
   over the top band on lines of their own, ``in_bwd_sums``' and
   ``in_bwd_apply``'s launch geometry in their rows;
   (b) two gloo
   ranks sharing the card at (dp, sp) = (1, 2), fp32, TF32 off, tanh,
   dropout off, one step at 256 px, global batch 2, against one process:
   losses within rtol 2e-3 / atol 2e-4, every gradient within 1e-3 of its
   tensor's max |g|, each rank's launches what ``band_plan`` plans; (c)
   where there are two or more cards, ``patchgan_train`` with
   ``spatial_parallelism: 2`` under ``torch.distributed.run`` (NCCL,
   bf16, 1024 px, the captured step; one set of epoch files), then the
   captured step over 2 cards beside one card's, in turns, in windows of
   at least 1.5 s: img/s and the peak memory a rank, every band launch of
   the step on the wgmma core; on one card a line says why (c) did not
   run. ``python3
   chip_smoke.py --spatial-only`` runs phase 17 alone.
18. the async exact-resume store (``checkpoint_format = 'orbax'``,
   ``utils/orbax_ckpt.py``) and ``UNet(remat=...)``: (a) run inside
   phase 13, beside its exact-resume runs: ``patchgan_train -d cuda
   --deterministic`` at phase 13's resume config in a process whose
   Trainer writes through the store (``dcp_train_child``), SIGKILLed when
   its rolling metadata (naming a ``.dcp`` slot) shows epoch 2 with 1
   batch done and resumed to the end: its epoch files equal phase 13's
   control bits, or differ by no more than the two controls do; then,
   beside phase 13's ``.pt`` rolling save at config 2, the ms
   ``save_async`` holds the host and the ms until ``wait()`` returns;
   (b) at the end: the captured bf16 step at config 2 (batch 16, 256
   px) and at 17a's 1024-px image (batch 2), each with ``remat`` False,
   True and ('enc0', 'dec0', 'dec6'), and at 256 px also False and True
   in the s2d form, from the same seeded state under deterministic
   cuDNN: three steps (an eager one, a capture and its replay, a
   replay), the wrappers' launches twice ``REMAT_STEP``, the updated
   parameters equal to ``remat=False``'s bits in the same form (else the
   first parameter that differs is printed and rtol 2e-3 / atol 2e-4
   held), the device kernels of a replay counted by the profiler as in
   phase 10 (held to ``REMAT_STEP`` at 256 px), the peak memory, and
   img/s in turns, two windows of at least 0.5 s each.
   ``python3 chip_smoke.py --phase-18`` runs phase 13's exact-resume
   runs with 18a, then 18b;
19. channels_last (``train/auto_layout.py``), before phase 10's timing:
   the NHWC forms of K1, K2, K3 and K1-bwd against their plain versions
   at every shape of config 2's step (batch 16, 256 px), bf16 and fp32 at
   phase 2's and phase 6's tolerances, each output channels_last and the
   NHWC form launched, K3's NHWC pack exactly against
   ``pack_convt_weight_nhwc_plain``, and check-only cases of their
   element paths (K2 at Cin 16 and 48, K3 ragged and without a skip, K1
   and K1-bwd at the edge cases and one element past 16 bytes); K1 and
   K1-bwd in both their NHWC kernels at every step shape (the one-pass
   kernel on a thread-block cluster, ``csrc/norm_nhwc_cluster.cuh``,
   which the planner picks there, and the segmented ones), the one-pass
   kernel's two launches on the same inputs bit-equal, and the segmented
   kernels, which the planner picks beyond a cluster's shared memory, at
   batch 2, 64 x 512 x 512; timed in bf16 beside the NCHW form on the
   same values, the plain version, a library call and the bound (K1 and
   K1-bwd: both kernels, the NCHW form, plain and library in turns, each
   by CUDA events around eager calls and by a CUDA graph's replay); the
   fp32 channels_last step (phase 7's
   models and batch) within phase 7's limits of the CPU's and of the NCHW
   card step's, every launch of K1-K3 and K1-bwd in its NHWC form and
   every block's output channels_last; the captured channels_last step
   with the generator's shadow bit-equal to the one without over 3 steps
   (bf16, dropout on, deterministic cuDNN), its shadows equal to the cast
   masters; the cuDNN layout transposes an eager channels_last step
   still launches, each with the operator (and its input shapes) that
   launches it. Phase 8's ``patchgan_train`` runs in the Trainer's
   default layout, channels_last, and counts the NHWC forms' launches
   (the kernels line's), every K1 and K1-bwd one of them on the one-pass
   kernel. ``python3 chip_smoke.py --layout-only`` runs
   phase 7's plain parity, these checks, then phase 10's timing of the
   NCHW and the two channels_last steps alone.

K2's and K3's launches on the wgmma core are counted on every bf16 path
at the nf=64 widths (``wgmma_grew``): they must grow in phases 3, 4
(bf16; none in fp32), 5, 10 (the NCHW configurations' first steps), 11
(six and five a bf16 spatial image; none in fp32), 12 and 15, and be all
of K2's and K3's launches in phases 3, 4, 5, 8 and 10.

It prints a JSON summary of the kernels (launches from the s2d training
run, which drives all six; every path's counts beside them, the
spatial, serve, pipeline, data-parallel, mesh, spatial-mesh (a device's
launches an image), tp, spatial-training and remat paths' too; K1-K3's
totals at the spatial shapes; then the six band entry points, launches from 17b's
rank 0, beside a device's in phase 15's spatial mode; then the four NHWC
forms, launches from phase 8's channels_last training run, K1's and
K1-bwd's on their one-pass kernels with the segmented kernels' times
beside), the card's name and power limit, and as its last line ``{"ok":
true, "device": {...}}``. Any failure exits non-zero before that line; without a CUDA
device it exits 2.
"""

import contextlib
import copy
import gc
import io
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
PEAK_BF16 = 989e12     # dense bf16 tensor-core FLOP/s, H100 SXM
PEAK_FP32 = 67e12      # fp32 FLOP/s outside the tensor cores
HBM_BYTES = 3.35e12    # device memory bytes/s
B = 8                  # tiles per bucket in the kernel phase
NF, SIZE, IN_C, OUT_C = 64, 256, 3, 7
ACTS = (None, 'tanh', 'relu', 'leakyrelu')
TOL = {'float32': 1e-3, 'bfloat16': 3e-2}
WINDOWS, WINDOW_S = 3, 1.5   # masks/s, img/s: timing windows, seconds each
TRAIN_B, NDF = 16, 64        # training batch, discriminator width
TOL_BWD = {'float32': 1e-3, 'bfloat16': 3e-2}   # times max(1, max |dx|)
# fp32 operations per element of K1-bwd: statistics 3, the two sums 6,
# dx 5 (act' counted as one)
BWD_FLOPS = 14
# the mangled name's mark of the wgmma core's NCHW problems (H padded, an
# NCHW acc): ConvNhwcProblem / ConvTNhwcProblem<bf16, true, true, false>
NCHW_MODE = 'Lb1ELb1ELb0EE'
# launches of K1, K2, K3, K1-bwd, K4, K4-wgrad per train step and per
# validation batch. s2d step: K4 6 = enc0 1 + the fake conv0's image and
# mask parts inside G's loss 2 + the paired D step's shared image part
# and two mask parts 3; K4-wgrad 4 = enc0 1 + the D step's three parts
# (D's weights are constants in G's loss, so its conv0 takes no weight
# gradient there; the dec6 head's Cin = 64 convs run in cuDNN). s2d
# validation: K4 5 = enc0 1 + the fake pair in G's loss 2 + the merged
# real and fake pair 2.
STEP = {'off': [1, 6, 5, 12, 0, 0], 'on': [1, 6, 5, 12, 6, 4]}
# the channels_last steps of phase 19 (plain form): the same launches, in
# the NHWC forms
STEP.update({'cl': STEP['off'], 'cl shadow': STEP['off']})
EVAL = {'off': [1, 6, 5, 0, 0, 0], 'on': [1, 6, 5, 0, 5, 0]}
# the same per fine-tune step with the encoder frozen ('enc',): the
# encoder runs forward only, so K1-bwd runs at dec1-dec5 alone, K2 takes
# no recompute, and the s2d enc0's K4 takes no weight gradient (the
# discriminator's three conv0 parts still do)
FREEZE = ('enc',)
FT_STEP = {'off': [1, 6, 5, 5, 0, 0], 'on': [1, 6, 5, 5, 6, 3]}
# K2 + K3 recomputes (recompute_grads) per full and per frozen step
RECOMPUTES = {'full': 6 + 5, 'frozen': 5}
# the device kernel of each of K1, K2, K3, K1-bwd, K4, K4-wgrad, one a
# wrapper's launch, as the profiler names it (every part must appear); K2
# and K3 in bf16 at config 2's shapes: the GEMM of the wgmma core
# (csrc/conv_wgmma.cuh), whose problem structs both forms use; K4-wgrad
# at the s2d step's shapes: its wgmma kernel (csrc/thin_conv.cu)
PROFILE_NAMES = (('pgt::in_act_kernel<',),
                 ('pgt::conv_wgmma_kernel<', 'pgt::ConvNhwcProblem<'),
                 ('pgt::conv_wgmma_kernel<', 'pgt::ConvTNhwcProblem<'),
                 ('pgt::in_act_bwd_kernel<',), ('pgt::thin::thin_fwd<',),
                 ('pgt::thin::thin_wgrad_tma<',))
# the same for the NHWC forms in bf16: K1's and K1-bwd's one-pass kernels
# (csrc/norm_nhwc_cluster.cuh)
PROFILE_NAMES_NHWC = (('pgt::nhwc::one_pass::in_act_one_pass<',),
                      *PROFILE_NAMES[1:3],
                      ('pgt::nhwc::one_pass::in_act_bwd_one_pass<',),
                      *PROFILE_NAMES[4:])
# launches of K1, K2, K3, K1-bwd, K4, K4-wgrad per train step with
# UNet(remat=...), by (remat, s2d form): the checkpointed blocks run
# their core again in the backward (enc0's conv, K4 in the s2d form, and
# K1; enc1-enc6's K2; dec1-dec5's K3; dec0 and the head run cuDNN only);
# K1-bwd and K4-wgrad as without remat
REMAT_FORMS = {'off': False, 'all': True, 'ends': ('enc0', 'dec0', 'dec6')}
REMAT_STEP = {('off', 'off'): STEP['off'],
              ('all', 'off'): [2, 12, 10, 12, 0, 0],
              ('ends', 'off'): [2, 6, 5, 12, 0, 0],
              ('off', 'on'): STEP['on'],
              ('all', 'on'): [2, 12, 10, 12, 7, 4]}
LR = 1e-3
EVAL_TIMED = 384   # images of the folder the eval loop is timed on
# the 1280x960 image of the inference phases as spatial mode runs it:
# (H, W) zero-padded to multiples of 128
SPATIAL_HW, SPATIAL_PAD = (960, 1280), (1024, 1280)
# phase 15b's survey tile for spatial mode over cards: every level of
# the UNet splits over 2 and 4 cards
SPATIAL_BIG = (4096, 4096)
# launches of K1, K2, K3, K1-bwd, K4, K4-wgrad per spatial-mode image:
# one whole-image forward in the plain form
SPATIAL_IMAGE = [1, 6, 5, 0, 0, 0]


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20):
    """Time per call on the card without the host's share: CUDA events
    around the replay of a CUDA graph of ``iters`` calls (captured after
    a warm-up on a side stream); the card's gaps between launches are
    included."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # captured on the current device's side stream: torch.cuda.graph's
    # default capture stream belongs to the device of its first use
    with torch.cuda.graph(graph, stream=side):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * iters)


def norm_geometry(shape, dtype):
    """K1's / K1-bwd's launch geometry at an (N, C, H, W) shape, for a
    timed row."""
    from patchgan_tpu_torch.ops.kernels.norm_act import plane_geometry
    n, c, h, w = shape
    return plane_geometry(n * c, h * w, dtype)._asdict()


def norm_edge_cases(torch, gen):
    """(label, pair) at the instance-norm kernels' edge shapes, where
    pair(dtype) gives (x, g) in that dtype: planes of each launch class's
    edge, a plane count no multiple of the planes a block takes, planes of
    3 and 60 elements (no multiple of 16 bytes in bf16: element by
    element), planes larger than the registers hold (read again from
    memory), and x, g one element past a 16-byte boundary (element by
    element)."""
    def rand(*shape):
        return torch.randn(*shape, generator=gen, device='cuda')

    out = []
    for shape in ((3, 5, 4, 4), (2, 8, 8, 8), (2, 4, 16, 16), (2, 8, 1, 3),
                  (2, 8, 6, 10), (1, 33, 32, 32), (1, 3, 64, 64),
                  (4, 8, 1, 1), (2, 3, 256, 256)):
        x, g = rand(*shape), rand(*shape)
        out.append((f'{shape}', lambda dt, x=x, g=g: (x.to(dt), g.to(dt))))
    shape = (2, 8, 16, 16)
    x, g = rand(2 * 8 * 16 * 16 + 1), rand(2 * 8 * 16 * 16 + 1)
    out.append((f'{shape} one element past 16 bytes',
                lambda dt: (x.to(dt)[1:].view(shape),
                            g.to(dt)[1:].view(shape))))
    return out


@contextlib.contextmanager
def s2d_env(flag):
    """PATCHGAN_S2D set to ``flag`` ('on' or 'off') for the block."""
    old = os.environ.get('PATCHGAN_S2D')
    os.environ['PATCHGAN_S2D'] = flag
    try:
        yield
    finally:
        if old is None:
            os.environ.pop('PATCHGAN_S2D')
        else:
            os.environ['PATCHGAN_S2D'] = old


@contextlib.contextmanager
def in_dir(path):
    cwd = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(cwd)


def bound(flops, nbytes, peak):
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, ('operations' if t_ops > t_bytes
                                       else 'bytes')


class Kernel:
    """One kernel: where it lives, what it replaces, its wrapper and
    plain version, and its timing rows from the kernel phase."""

    def __init__(self, name, source, replaces, wrapper, plain):
        self.name, self.source, self.replaces = name, source, replaces
        self.wrapper, self.plain = wrapper, plain
        self.rows, self.spatial_rows, self.nhwc_rows = [], [], []


def make_cases(torch, F, kernels, n=B, h=SIZE, w=SIZE, tp=1):
    """The kernel phase's cases at the nf=64 generator's shapes for ``n``
    images of ``h`` x ``w`` (by default the 8-tile bucket of 256 px, which
    adds a K3 case with H != W, a ragged one and every activation at one
    level of each kernel); ``tp``: at a rank's shard of every level's
    output channels over a model axis of ``tp`` ranks (phase 16):
    (kernel, label, make(dtype, act) -> wrapper args, library(*args),
    FLOPs, elements read + written, whether to try every activation)."""
    k1, k2, k3 = kernels
    tiles = (n, h, w) == (B, SIZE, SIZE)
    gen = torch.Generator(device='cuda').manual_seed(0)

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device='cuda') * scale

    def plane(c, hh, ww):
        return f'{c}x{hh}^2' if hh == ww else f'{c}x{hh}x{ww}'

    cases = []
    # K1: enc0's epilogue, after the 3 -> 64 conv at half the resolution
    shape = (n, NF // tp, h // 2, w // 2)
    x = rand(*shape)
    numel = x.numel()
    cases.append((k1, f'enc0 {shape}', lambda dt, a=None, x=x: (
        x.to(dt), 1e-5, a or 'relu'),
        lambda x, eps, a: F.relu(F.instance_norm(x, eps=eps)),
        6 * numel, 2 * numel, tiles))
    # K2: enc1-enc6
    filts = [NF, 2 * NF, 4 * NF, 8 * NF, 8 * NF, 8 * NF, 8 * NF]
    hh, ww = h // 2, w // 2
    for lvl in range(1, 7):
        cin, cout = filts[lvl - 1], filts[lvl] // tp
        x = rand(n, cin, hh, ww)
        wt = rand(cout, cin, 4, 4, scale=(2.0 / (32 * (cin + cout))) ** 0.5)
        ho, wo = hh // 2, ww // 2
        macs = n * ho * wo * cout * 16 * cin
        elems = x.numel() + wt.numel() + n * cout * ho * wo
        cases.append((k2, f'enc{lvl} {plane(cin, hh, ww)}->'
                      f'{plane(cout, ho, wo)}',
                      lambda dt, a=None, x=x, wt=wt: (
                          x.to(dt), wt.to(dt), 1e-5, a or 'relu'),
                      lambda x, wt, eps, a: F.relu(F.instance_norm(
                          F.conv2d(x, wt, stride=2, padding=1), eps=eps)),
                      2 * macs, elems, tiles and lvl == 3))
        hh, ww = ho, wo
    # K3: dec1-dec5, (level, H, W, x channels, skip channels, Cout): dec1
    # reads dec0's output and the enc5 skip at 1/64 of the input's size,
    # dec5 reads 1/4 of it
    shapes = [(lvl, h // 2 ** (7 - lvl), w // 2 ** (7 - lvl), cx, cs, cout)
              for lvl, cx, cs, cout in [(1, 8 * NF, 8 * NF, 8 * NF),
                                        (2, 8 * NF, 8 * NF, 8 * NF),
                                        (3, 8 * NF, 8 * NF, 4 * NF),
                                        (4, 4 * NF, 4 * NF, 2 * NF),
                                        (5, 2 * NF, 2 * NF, NF)]]
    if tiles:
        shapes += [('H!=W', 24, 40, 2 * NF, 2 * NF, NF),
                   ('ragged', 12, 20, 13, 6, 40)]
    for lvl, hh, ww, cx, cs, cout in shapes:
        cout //= tp
        x = rand(n, cx, hh, ww)
        s = rand(n, cs, hh, ww)
        wt = rand(cx + cs, cout, 4, 4,
                  scale=(2.0 / (16 * (cx + cs + cout))) ** 0.5)
        macs = n * 4 * hh * ww * cout * 4 * (cx + cs)
        elems = x.numel() + s.numel() + wt.numel() + n * cout * 4 * hh * ww
        label = (f'dec{lvl} ' if isinstance(lvl, int) else f'{lvl} ') + \
            f'({cx}+{cs})x{hh}x{ww}->{cout}x{2 * hh}x{2 * ww}'
        cases.append((k3, label,
                      lambda dt, a=None, x=x, s=s, wt=wt: (
                          x.to(dt), wt.to(dt), 1e-5, a or 'relu', s.to(dt)),
                      lambda x, wt, eps, a, s: F.relu(F.instance_norm(
                          F.conv_transpose2d(torch.cat([x, s], 1), wt,
                                             stride=2, padding=1),
                          eps=eps)),
                      2 * macs, elems, tiles and lvl == 3))
    return cases


def repeat_check(torch, wrapper, args_of, gen):
    """Two launches on the same inputs give the same bits (fixed-order
    reductions, no atomics), in both dtypes, at one plane of each launch
    class: lanes (16 x 16), block (128 x 128), stream (256 x 256)."""
    for shape in ((16, 512, 16, 16), (16, 64, 128, 128), (2, 3, 256, 256)):
        x = torch.randn(*shape, generator=gen, device='cuda')
        g = torch.randn(*shape, generator=gen, device='cuda')
        for dt in (torch.bfloat16, torch.float32):
            args = args_of(x.to(dt), g.to(dt))
            a, b = wrapper(*args), wrapper(*args)
            torch.cuda.synchronize()
            if not torch.equal(a, b):
                raise AssertionError(f'{wrapper.__name__} {shape} {dt}: two '
                                     f'launches differ')
        print(f'  {wrapper.__name__} {shape}: two launches equal in bf16 '
              f'and fp32', flush=True)


def kernel_phase(torch, F, kernels, spatial=False):
    """K1-K3 against their plain versions at ``make_cases``'s shapes, with
    timing rows in ``kernel.rows``; ``spatial``: at the shapes of one
    whole 1280 x 960 image (``SPATIAL_PAD``), rows in
    ``kernel.spatial_rows``, without the K1 edge cases. K2 and K3 (their
    NCHW forms) in every activation at every level: in bf16 on the
    planner's core (the wgmma core wherever the channel runs are multiples
    of 64) and on the WMMA core forced (``_core='wmma'``), in fp32 on the
    WMMA core, each launch counted on the core it must take; their rows
    add both cores by events and by a graph's replay (``device_ms``), the
    layout passes the wgmma core's C call makes, alone, and the library
    call by a replay. Outside ``spatial``, ptxas's report of the NCHW
    instantiations of the wgmma core (none may spill)."""
    from patchgan_tpu_torch.ops.kernels import (_build, nchw_to_nhwc,
                                                pack_convt_weight,
                                                pack_convt_weight_plain)
    from patchgan_tpu_torch.ops.kernels.conv_norm_act import conv_nhwc_plan
    from patchgan_tpu_torch.ops.kernels.convt_norm_act import \
        convt_nhwc_plan
    shapes = (1,) + SPATIAL_PAD if spatial else (B, SIZE, SIZE)
    if not spatial:
        ptxas = {k: v for k, v in wgmma_ptxas(_build.build_log).items()
                 if NCHW_MODE in k[1]}
        for (lib, name), (regs, stores, loads) in sorted(ptxas.items()):
            print(f'  ptxas {lib} {name}: {regs} registers, spill stores '
                  f'{stores} / loads {loads} bytes', flush=True)
        if any(stores or loads for _, stores, loads in ptxas.values()):
            raise AssertionError(f'the NCHW mode of the wgmma core spills: '
                                 f'{ptxas}')

    def plan_of(kernel, args):
        """The planner's core for a K2 / K3 call on ``args`` (NCHW)."""
        x, w = args[:2]
        n, c, h, wd = x.shape
        if kernel.name == 'conv_norm_act':
            return conv_nhwc_plan(n, c, h, wd, w.shape[0], x.dtype)
        return convt_nhwc_plan(n, c, args[4].shape[1], h, wd, w.shape[1],
                               x.dtype)

    def err(kernel, args32, args, kw=None, wgmma=None):
        """The kernel's max abs error against the plain version; where
        ``wgmma`` is True or False, its launch counted on the wgmma core
        or not."""
        before = getattr(kernel.wrapper, 'launches_wgmma', 0)
        got = kernel.wrapper(*args, **(kw or {})).float()
        took = getattr(kernel.wrapper, 'launches_wgmma', 0) - before
        if wgmma is not None and took != int(wgmma):
            raise AssertionError(f'{kernel.name}: {took} launches on the '
                                 f'wgmma core, expected {int(wgmma)}')
        want = kernel.plain(*args32).float()
        torch.cuda.synchronize()
        return (got - want).abs().max().item()

    def as_fp32(args):
        return tuple(a.float() if torch.is_tensor(a) else a for a in args)

    for kernel, label, make, library, flops, elems, all_acts in \
            make_cases(torch, F, kernels, *shapes):
        conv = kernel.name != 'instance_norm_act'
        errs = {}
        for dname, dt in (('bfloat16', torch.bfloat16),
                          ('float32', torch.float32)):
            if kernel.name == 'convt_norm_act':
                w = make(dt)[1]
                if not torch.equal(pack_convt_weight(w),
                                   pack_convt_weight_plain(w)):
                    raise AssertionError(f'K3 pack {label} {dname} differs')
                print(f'  K3 pack {label} {dname}: equal', flush=True)
            for act in (ACTS if all_acts or conv else ('relu',)):
                args = make(dt, act)
                cores = [('', None, None)]
                if conv:
                    wgmma = plan_of(kernel, args).core == 'wgmma'
                    cores = [(' on the wgmma core' if wgmma else
                              ' on the WMMA core', None, wgmma)]
                    if wgmma:
                        cores.append((' on the WMMA core forced',
                                      {'_core': 'wmma'}, False))
                for where, kw, on in cores:
                    e = err(kernel, as_fp32(args), args, kw, on)
                    ok = e <= TOL[dname]
                    print(f'  {kernel.name} {label} {dname} act={act}'
                          f'{where}: max_abs_err {e:.3e} (tol '
                          f'{TOL[dname]:.0e}){"" if ok else "  FAIL"}',
                          flush=True)
                    if not ok:
                        raise AssertionError(f'{kernel.name} {label} '
                                             f'{dname} act={act}{where}: '
                                             f'{e} > {TOL[dname]}')
                    key = dname + ('_wmma' if kw else '')
                    errs[key] = max(errs.get(key, 0.0), e)
        if label.startswith(('H!=W', 'ragged')):
            continue
        args = make(torch.bfloat16)
        k_ms = cuda_ms(lambda: kernel.wrapper(*args))
        p_ms = cuda_ms(lambda: kernel.plain(*args))
        lib_ms = cuda_ms(lambda: library(*args))
        peak = PEAK_FP32 if kernel.name == 'instance_norm_act' else PEAK_BF16
        b_ms, b_by = bound(flops, 2 * elems, peak)
        row = {'kernel': kernel.name, 'case': label, 'dtype': 'bfloat16',
               'kernel_ms': k_ms, 'plain_ms': p_ms, 'library_ms': lib_ms,
               'bound_ms': b_ms, 'bound_by': b_by,
               'max_abs_err_bf16': errs['bfloat16'],
               'max_abs_err_fp32': errs['float32']}
        if kernel.name == 'instance_norm_act':
            row.update(device_ms=device_ms(lambda: kernel.wrapper(*args)),
                       **norm_geometry(args[0].shape, torch.bfloat16))
        else:
            # both cores by events and by a graph's replay; the layout
            # passes of the wgmma core's C call (x and the weight for K2,
            # x and skip for K3) alone
            plan = plan_of(kernel, args)
            moved = args[:2] if kernel.name == 'conv_norm_act' else \
                (args[0], args[4])
            fns = {'kernel': lambda: kernel.wrapper(*args),
                   'wmma': lambda: kernel.wrapper(*args, _core='wmma'),
                   'layout': lambda: [nchw_to_nhwc(t) for t in moved],
                   'library': lambda: library(*args)}
            ev = {k: cuda_ms(fns[k]) for k in ('wmma', 'layout')}
            dev = {k: device_ms(f) for k, f in fns.items()}
            row.update(core=plan.core, bn=plan.bn, stages=plan.stages,
                       splits=plan.splits, samples_a_tile=plan.samples,
                       device_ms=dev['kernel'], wmma_ms=ev['wmma'],
                       wmma_device_ms=dev['wmma'], layout_ms=ev['layout'],
                       layout_device_ms=dev['layout'],
                       layout_bound_ms=bound(
                           0, 4 * sum(t.numel() for t in moved),
                           PEAK_BF16)[0],
                       library_device_ms=dev['library'],
                       max_abs_err_wmma_bf16=errs['bfloat16_wmma'])
        (kernel.spatial_rows if spatial else kernel.rows).append(row)
        print(json.dumps(row), flush=True)
    for k in kernels[1:]:
        rows = k.spatial_rows if spatial else k.rows
        total = {key: sum(r[key] for r in rows) for key in (
            'kernel_ms', 'device_ms', 'wmma_ms', 'wmma_device_ms',
            'layout_ms', 'layout_device_ms', 'library_ms',
            'library_device_ms', 'bound_ms')}
        print(f'  {k.name} over its {len(rows)} levels at '
              f'{"the image" if spatial else "8 tiles"}, bf16: the wgmma '
              f'core {total["kernel_ms"]:.4f} ms by events, '
              f'{total["device_ms"]:.4f} by a graph\'s replay (the layout '
              f'passes {total["layout_ms"]:.4f} / '
              f'{total["layout_device_ms"]:.4f}); the WMMA core '
              f'{total["wmma_ms"]:.4f} / {total["wmma_device_ms"]:.4f}; '
              f'cuDNN {total["library_ms"]:.4f} / '
              f'{total["library_device_ms"]:.4f}; bound '
              f'{total["bound_ms"]:.4f}', flush=True)
    if spatial:
        return
    k1 = kernels[0]
    gen = torch.Generator(device='cuda').manual_seed(11)
    for label, pair in norm_edge_cases(torch, gen):
        for dname, dt in (('bfloat16', torch.bfloat16),
                          ('float32', torch.float32)):
            x = pair(dt)[0]
            for act in (ACTS if label == '(3, 5, 4, 4)' else ('relu',)):
                e = err(k1, (x.float(), 1e-5, act), (x, 1e-5, act))
                print(f'  {k1.name} edge {label} {dname} act={act}: '
                      f'max_abs_err {e:.3e} (tol {TOL[dname]:.0e})',
                      flush=True)
                if not e <= TOL[dname]:
                    raise AssertionError(f'{k1.name} edge {label} {dname} '
                                         f'act={act}: {e} > {TOL[dname]}')
    repeat_check(torch, k1.wrapper, lambda xd, gd: (xd, 1e-5, 'relu'), gen)


# K4-wgrad's kernel on the wgmma path (csrc/thin_conv.cu), as ptxas and
# the profiler name it
WGRAD_WGMMA = 'thin_wgrad_tma'


def thin_conv_phase(torch, F, k4, k4w):
    """K4 and K4-wgrad against their plain versions at the s2d paths'
    shapes, bf16 and fp32, and K4's weight pack against its plain
    layout; two launches of each on the same inputs bit-equal; K4-wgrad's
    launches on ``thin_wgrad_plan``'s kernel (the wgmma kernel wherever
    bf16 W % 8 == 0 and the inputs lie on 16 bytes, which the profiler
    must name at the s2d step's shapes), and ptxas's report of the wgmma
    kernel (none may spill). Timing rows go to ``k4.rows`` /
    ``k4w.rows`` with ``calls``, the number of calls per train step at
    that shape (0: the inference chunk and the merged validation
    discriminator, where K4-wgrad is checked but not timed), by events
    and by a graph's replay beside the library call's."""
    from patchgan_tpu_torch.ops.kernels import (_build, pack_thin_weight,
                                                pack_thin_weight_plain)
    from patchgan_tpu_torch.ops.kernels.thin_conv import (thin_conv_grid,
                                                          thin_wgrad_plan)
    ptxas = wgmma_ptxas(_build.build_log, (WGRAD_WGMMA,))
    for (lib, name), (regs, stores, loads) in sorted(ptxas.items()):
        print(f'  ptxas {lib} {name}: {regs} registers, spill stores '
              f'{stores} / loads {loads} bytes', flush=True)
    if any(stores or loads for _, stores, loads in ptxas.values()):
        raise AssertionError(f'K4-wgrad\'s wgmma kernel spills: {ptxas}')
    gen = torch.Generator(device='cuda').manual_seed(9)
    hw = SIZE // 2
    # (label, N, Cin, H, W, Cout, K4 calls per step, K4-wgrad calls,
    # timed)
    cases = [('enc0 infer chunk', B, 4 * IN_C, hw, hw, NF, 0, 0, True),
             ('enc0 / D conv0 image', TRAIN_B, 4 * IN_C, hw, hw, NF, 3, 2,
              True),
             ('D conv0 mask', TRAIN_B, 4 * OUT_C, hw, hw, NDF, 3, 2, True),
             ('val D image', 2 * TRAIN_B, 4 * IN_C, hw, hw, NDF, 0, 0, True),
             ('val D mask', 2 * TRAIN_B, 4 * OUT_C, hw, hw, NDF, 0, 0, True),
             ('ragged', 3, 4, 40, 70, 28, 0, 0, False),
             ('aligned partial', 2, 20, 24, 72, 40, 0, 0, False),
             ('few tiles', 1, 12, 6, 8, 64, 0, 0, False),
             ('max Cin', 4, 32, 16, 64, 64, 0, 0, False)]
    for label, n, cin, h, wd, cout, fcalls, wcalls, timed in cases:
        label = f'{label} ({n}, {cin}, {h}, {wd}) -> {cout}'
        x = torch.randn(n, cin, h, wd, generator=gen, device='cuda')
        # O(1) outputs, as the layers' xavier weights give
        w = torch.randn(cout, cin, 3, 3, generator=gen, device='cuda') * \
            0.5 / (9 * cin) ** 0.5
        dy = torch.randn(n, cout, h, wd, generator=gen, device='cuda')
        errs = {}
        for dname, dt in (('bfloat16', torch.bfloat16),
                          ('float32', torch.float32)):
            xd, wd_, dyd = x.to(dt), w.to(dt), dy.to(dt)
            if not torch.equal(pack_thin_weight(wd_),
                               pack_thin_weight_plain(wd_, dt)):
                raise AssertionError(f'K4 pack {label} {dname} differs')
            route = thin_wgrad_plan(n, cin, h, wd, cout, dt).route
            got = k4.wrapper(xd, wd_).float()
            want = k4.plain(xd.float(), wd_.float())
            before = k4w.wrapper.launches_wgmma
            got_w = k4w.wrapper(xd, dyd)
            again_w = k4w.wrapper(xd, dyd)
            on = k4w.wrapper.launches_wgmma - before
            same = torch.equal(k4.wrapper(xd, wd_).float(), got) and \
                torch.equal(got_w, again_w)
            want_w = k4w.plain(xd.float(), dyd.float())
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            ew = (got_w - want_w).abs().max().item()
            tol_w = 1e-3 * max(1.0, want_w.abs().max().item())
            print(f'  {k4.name} {label} {dname}: max_abs_err {e:.3e} (tol '
                  f'{TOL[dname]:.0e}); {k4w.name} on {route}: {ew:.3e} (tol '
                  f'{tol_w:.3e}); pack equal; two launches equal {same}',
                  flush=True)
            if not (e <= TOL[dname] and ew <= tol_w and same):
                raise AssertionError(f'thin conv {label} {dname}: {e}, {ew}, '
                                     f'two launches equal {same}')
            if on != 2 * (route == 'wgmma'):
                raise AssertionError(f'{k4w.name} {label} {dname}: {on} of 2 '
                                     f'launches on the wgmma kernel, route '
                                     f'{route}')
            errs[dname] = (e, ew)
        if not timed:
            continue
        xb, wb, dyb = x.bfloat16(), w.bfloat16(), dy.bfloat16()
        if wcalls:
            names = [key for _, _, key in profile_steps(
                torch, lambda: k4w.wrapper(xb, dyb), 1)]
            if not any(WGRAD_WGMMA in k for k in names):
                raise AssertionError(f'{k4w.name} {label}: the profiler saw '
                                     f'{names}, not {WGRAD_WGMMA}')
        flops = 2 * n * h * wd * 9 * cin * cout
        xy = 2 * (x.numel() + dy.numel())
        for k, calls, (fn, plain, lib), nbytes, i in (
                (k4, fcalls, (lambda: k4.wrapper(xb, wb),
                              lambda: k4.plain(xb, wb),
                              lambda: F.conv2d(xb, wb, padding=1)),
                 xy + 2 * w.numel(), 0),
                (k4w, wcalls, (lambda: k4w.wrapper(xb, dyb),
                               lambda: k4w.plain(xb, dyb),
                               lambda: torch.nn.grad.conv2d_weight(
                                   xb, wb.shape, dyb, padding=1)),
                 xy + 4 * w.numel(), 1)):
            if k is k4w and not calls:
                continue   # no backward at this shape on any path
            b_ms, b_by = bound(flops, nbytes, PEAK_BF16)
            grid, per_sm = thin_conv_grid(xb, cout, wgrad=k is k4w)
            row = {'kernel': k.name, 'case': label, 'dtype': 'bfloat16',
                   'calls': calls, 'grid': grid, 'blocks_per_sm': per_sm,
                   'kernel_ms': cuda_ms(fn), 'device_ms': device_ms(fn),
                   'plain_ms': cuda_ms(plain), 'library_ms': cuda_ms(lib),
                   'library_device_ms': device_ms(lib),
                   'bound_ms': b_ms, 'bound_by': b_by,
                   'max_abs_err_bf16': errs['bfloat16'][i],
                   'max_abs_err_fp32': errs['float32'][i]}
            if k is k4w:
                plan = thin_wgrad_plan(n, cin, h, wd, cout, torch.bfloat16)
                row.update(route=plan.route, stages=plan.stages,
                           smem_bytes=plan.smem)
            k.rows.append(row)
            print(json.dumps(row), flush=True)


def write_inputs(tmp, torch, np):
    from patchgan_tpu_torch.models import UNet
    from patchgan_tpu_torch.utils.checkpoint import save_state_dict
    shutil.copy(os.path.join(ROOT, 'examples', 'io_plugin_example.py'),
                os.path.join(tmp, 'io.py'))
    data = os.path.join(tmp, 'images')
    os.makedirs(data)
    rng = np.random.default_rng(0)
    sizes = [(960, 1280), (480, 640), (256, 256), (150, 200)]
    for i, (h, w) in enumerate(sizes):
        np.savez(os.path.join(data, f'{i:03d}.npz'),
                 image=rng.random((h, w, IN_C), dtype=np.float32),
                 labels=np.zeros((h, w), np.int32))
    model = UNet(IN_C, OUT_C, nf=NF, activation='relu', final_act='softmax',
                 generator=torch.Generator().manual_seed(0))
    save_state_dict(os.path.join(tmp, 'generator.npz'), model.state_dict())
    cfg = {
        'dataset': {'type': 'NpzSegmentationDataset', 'size': SIZE,
                    'dataset_path': data, 'in_channels': IN_C,
                    'out_channels': OUT_C},
        'model_params': {'gen_filts': NF, 'activation': 'relu',
                         'final_activation': 'softmax'},
        'checkpoint_paths': {'generator':
                             os.path.join(tmp, 'generator.npz')},
        'infer_params': {'output_path': os.path.join(tmp, 'masks'),
                         'threshold': 0, 'overlap': 0.9},
    }
    import yaml
    path = os.path.join(tmp, 'infer.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    return path, sizes, model


def expected_chunks(sizes, k=1, group=False):
    """Forward chunks of the images of ``sizes`` through an engine over
    ``k`` devices at the default batch_size, times ``k`` (each device
    runs its share of every chunk): one image at a time, or (``group``)
    one ``predict_images`` group, which shares buckets only over several
    devices. ``patchgan_infer`` / ``patchgan_serve -d cuda`` run over
    ``torch.cuda.device_count()`` cards."""
    from patchgan_tpu_torch.inference.engine import _pick_bucket, _round_up
    from patchgan_tpu_torch.inference.tiling import crop_positions
    counts = [len(crop_positions(max(h, SIZE), max(w, SIZE), SIZE, 0.9))
              for h, w in sizes]
    if group and k > 1:
        counts = [sum(counts)]
    cap = _round_up(128, k)
    return k * sum(-(-n // _pick_bucket(n, cap, k)) for n in counts)


def per_chunk(chunks, s2d=False):
    """The six wrappers' launches of ``chunks`` forward chunks (a
    device's share counted as one): K1 / K2 / K3 1 / 6 / 5 each, K4 1 in
    the s2d form."""
    return [chunks, 6 * chunks, 5 * chunks, 0, chunks if s2d else 0, 0]


def bwd_shapes():
    """(level, (N, C, H, W)) of the 12 K1-bwd calls of one generator
    backward at batch 16, 256 px, nf=64: x is each normed level's
    pre-norm tensor."""
    b, f = TRAIN_B, NF
    out = [('enc0', (b, f, 128, 128))]
    for lvl, (c, hw) in enumerate([(2 * f, 64), (4 * f, 32), (8 * f, 16),
                                   (8 * f, 8), (8 * f, 4), (8 * f, 2)], 1):
        out.append((f'enc{lvl}', (b, c, hw, hw)))
    for lvl, (c, hw) in enumerate([(8 * f, 8), (8 * f, 16), (4 * f, 32),
                                   (2 * f, 64), (f, 128)], 1):
        out.append((f'dec{lvl}', (b, c, hw, hw)))
    return out


def backward_phase(torch, F, kernel):
    """K1-bwd against its plain version at the training shapes; timing
    rows go to ``kernel.rows``."""
    gen = torch.Generator(device='cuda').manual_seed(3)

    def rand(shape):
        return torch.randn(*shape, generator=gen, device='cuda')

    def check(label, x, g, act, pair=None):
        errs = {}
        for dname, dt in (('bfloat16', torch.bfloat16),
                          ('float32', torch.float32)):
            xd, gd = pair(dt) if pair else (x.to(dt), g.to(dt))
            got = kernel.wrapper(gd, xd, 1e-5, act).float()
            want = kernel.plain(gd.float(), xd.float(), 1e-5, act)
            torch.cuda.synchronize()
            e = (got - want).abs().max().item()
            tol = TOL_BWD[dname] * max(1.0, want.abs().max().item())
            print(f'  {kernel.name} {label} {dname} act={act}: max_abs_err '
                  f'{e:.3e} (tol {tol:.3e})', flush=True)
            if not e <= tol:
                raise AssertionError(f'{kernel.name} {label} {dname} '
                                     f'act={act}: {e} > {tol}')
            errs[dname] = e
        return errs

    for label, shape in bwd_shapes():
        x, g = rand(shape), rand(shape)
        errs = check(f'{label} {shape}', x, g, 'relu')
        args = (g.bfloat16(), x.bfloat16(), 1e-5, 'relu')
        k_ms = cuda_ms(lambda: kernel.wrapper(*args))
        p_ms = cuda_ms(lambda: kernel.plain(*args))
        xr = args[1].clone().requires_grad_()
        y = F.relu(F.instance_norm(xr, eps=1e-5))
        lib_ms = cuda_ms(lambda: torch.autograd.grad(y, xr, args[0],
                                                     retain_graph=True))
        numel = x.numel()
        b_ms, b_by = bound(BWD_FLOPS * numel, 3 * 2 * numel, PEAK_FP32)
        row = {'kernel': kernel.name, 'case': f'{label} {shape}',
               'dtype': 'bfloat16', 'kernel_ms': k_ms,
               'device_ms': device_ms(lambda: kernel.wrapper(*args)),
               'plain_ms': p_ms, 'library_ms': lib_ms, 'bound_ms': b_ms,
               'bound_by': b_by, 'max_abs_err_bf16': errs['bfloat16'],
               'max_abs_err_fp32': errs['float32'],
               **norm_geometry(shape, torch.bfloat16)}
        kernel.rows.append(row)
        print(json.dumps(row), flush=True)
    total = {k: sum(r[k] for r in kernel.rows)
             for k in ('kernel_ms', 'device_ms', 'bound_ms')}
    print(f'  {kernel.name}, the 12 calls: kernel_ms {total["kernel_ms"]:.4f}'
          f', device_ms {total["device_ms"]:.4f}, bound_ms '
          f'{total["bound_ms"]:.4f}', flush=True)
    x, g = rand((TRAIN_B, 4 * NF, 32, 32)), rand((TRAIN_B, 4 * NF, 32, 32))
    for act in ACTS:
        check('dec3 shape', x, g, act)
    x, g = rand((TRAIN_B, NF, 24, 40)), rand((TRAIN_B, NF, 24, 40))
    check('H!=W (16, 64, 24, 40)', x, g, 'leakyrelu')
    # (-a, 0, a) planes: the middle xhat is exactly 0, where relu' = 0
    # and leakyrelu' = 1
    a = rand((TRAIN_B, NF, 1, 1)).abs() + 0.5
    x = torch.cat([-a, 0 * a, a], dim=3)
    g = rand((TRAIN_B, NF, 1, 3))
    for act in ACTS:
        check('xhat=0 (16, 64, 1, 3)', x, g, act)
    for label, pair in norm_edge_cases(torch, gen):
        for act in (ACTS if label == '(3, 5, 4, 4)' else ('relu',)):
            check(f'edge {label}', None, None, act, pair)
    repeat_check(torch, kernel.wrapper,
                 lambda xd, gd: (gd, xd, 1e-5, 'relu'), gen)


def train_batch(torch, np, n, size, device, seed):
    """A seeded NCHW (image, one-hot mask) batch of OUT_C classes."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.random((n, IN_C, size, size),
                                    dtype=np.float32)).to(device)
    labels = torch.from_numpy(rng.integers(0, OUT_C, (n, size, size)))
    y = torch.nn.functional.one_hot(labels, OUT_C).permute(0, 3, 1, 2)
    return x, y.float().contiguous().to(device)


def step_grads(torch, g, d, x, y, s2d):
    """One G+D loss and the generator's and discriminator's gradients
    (tversky * 200 + BCE, the paired D) in the form ``s2d`` ('on' or
    'off') selects, without an update: (losses, gradients in float64 on
    the host)."""
    from patchgan_tpu_torch.ops.s2d import space_to_depth
    from patchgan_tpu_torch.train.steps import (
        constant_params, disc_loss, disc_real_fake, gan_losses,
        make_seg_loss, resolve_paired_disc)
    form = s2d == 'on'
    if form:
        x, y = space_to_depth(x), space_to_depth(y)
    with constant_params(d.parameters()):
        g_loss, gen_img, gdisc = gan_losses(
            g, d, make_seg_loss('tversky', 200.0), x, y, form)
    g_grads = torch.autograd.grad(g_loss, list(g.parameters()))
    d_loss, real, fake = disc_loss(*disc_real_fake(
        d, x, y, gen_img.detach(), merged=False,
        paired=resolve_paired_disc(d), s2d=form))
    d_grads = torch.autograd.grad(d_loss, list(d.parameters()))
    losses = {'gen': g_loss, 'gdisc': gdisc, 'discr': real,
              'discf': fake, 'disc': d_loss}
    return ({k: v.item() for k, v in losses.items()},
            [t.double().cpu() for t in g_grads + d_grads])


def step_parity_phase(torch, np, wrappers, s2d, refs=None):
    """One G+D loss and the generator's and discriminator's gradients in
    the form ``s2d`` ('on' or 'off') selects, kernel path on the card
    against the plain path on the CPU, fp32, TF32 off, dropout off;
    ``refs`` (a dict) keeps the models, the batch and both results for
    phase 19's channels_last step."""
    from patchgan_tpu_torch.models import Discriminator, UNet
    init = torch.Generator().manual_seed(4)
    gen = UNet(IN_C, OUT_C, nf=NF, activation='relu', final_act='softmax',
               generator=init)
    disc = Discriminator(IN_C + OUT_C, ndf=NDF, n_layers=3, generator=init)
    x, y = train_batch(torch, np, 2, SIZE, 'cpu', 5)
    t0 = time.perf_counter()
    cpu_losses, cpu_grads = step_grads(torch, gen, disc, x, y, s2d)
    cpu_s = time.perf_counter() - t0
    gen_c, disc_c = copy.deepcopy(gen).cuda(), copy.deepcopy(disc).cuda()
    for w in wrappers:
        w.launches = 0
    gpu_losses, gpu_grads = step_grads(torch, gen_c, disc_c, x.cuda(),
                                       y.cuda(), s2d)
    launches = [w.launches for w in wrappers]
    print(f'  s2d {s2d}: plain path on the CPU {cpu_s:.1f} s; launches on '
          f'the card {launches}', flush=True)
    if launches != STEP[s2d]:
        raise AssertionError(f'step parity launches {launches}, expected '
                             f'{STEP[s2d]}')
    for k, want in cpu_losses.items():
        got = gpu_losses[k]
        ok = abs(got - want) <= 2e-4 + 2e-3 * abs(want)
        print(f'  loss {k}: card {got:.7g}, CPU {want:.7g}'
              f'{"" if ok else "  FAIL"}', flush=True)
        if not ok:
            raise AssertionError(f'loss {k}: {got} vs {want}')
    worst = {}
    names = [f'G {n}' for n, _ in gen.named_parameters()] + \
        [f'D {n}' for n, _ in disc.named_parameters()]
    for name, got, want in zip(names, gpu_grads, cpu_grads):
        rel = (got - want).abs().max().item() / max(
            want.abs().max().item(), 1e-30)
        worst[name[0]] = max(worst.get(name[0], 0.0), rel)
        if not rel <= 1e-3:
            raise AssertionError(f'grad {name}: {rel:.3e} of max |g|')
    print(f'  gradients: worst max |dg| / max |g| generator {worst["G"]:.3e}'
          f', discriminator {worst["D"]:.3e} (tol 1e-3) over '
          f'{len(gpu_grads)} tensors', flush=True)
    if refs is not None:
        refs.update(models=(gen, disc, x, y), cpu=(cpu_losses, cpu_grads),
                    card_nchw=(gpu_losses, gpu_grads))
    return worst


class Tee(io.StringIO):
    """Keeps what is printed and passes it on to the real stdout."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, text):
        self.out.write(text)
        return super().write(text)


def write_npz_folder(path, np, rng, n):
    """``n`` seeded (image, labels) files for the npz plugin."""
    os.makedirs(path)
    for i in range(n):
        np.savez(os.path.join(path, f'{i:03d}.npz'),
                 image=rng.random((SIZE, SIZE, IN_C), dtype=np.float32),
                 labels=rng.integers(1, OUT_C + 1, (SIZE, SIZE))
                 .astype(np.int32))


def write_train_inputs(tmp, np):
    shutil.copy(os.path.join(ROOT, 'examples', 'io_plugin_example.py'),
                os.path.join(tmp, 'io.py'))
    rng = np.random.default_rng(6)
    for split, n in (('train', 64), ('val', 16)):
        write_npz_folder(os.path.join(tmp, split), np, rng, n)
    cfg = {
        'dataset': {'type': 'NpzSegmentationDataset', 'size': SIZE,
                    'in_channels': IN_C, 'out_channels': OUT_C,
                    'labels': list(range(1, OUT_C + 1)),
                    'train_data': {'images': 'train', 'masks': 'train'},
                    'validation_data': {'images': 'val', 'masks': 'val'}},
        'model_params': {'generator': {'filters': NF, 'activation': 'relu',
                                       'final_activation': 'softmax'},
                         'discriminator': {'filters': NDF, 'n_layers': 3}},
        'checkpoint_path': os.path.join(tmp, 'ck'),
        'train_params': {'loss_type': 'tversky', 'seg_alpha': 200,
                         'gen_learning_rate': 1e-3,
                         'disc_learning_rate': 1e-3, 'decay_rate': 0.5,
                         'save_freq': 1},
    }
    import yaml
    paths = []
    for name, resume in (('train.yaml', False), ('resume.yaml', True)):
        cfg['load_last_checkpoint'] = resume
        paths.append(os.path.join(tmp, name))
        with open(paths[-1], 'w') as f:
            yaml.safe_dump(cfg, f)
    return paths


@contextlib.contextmanager
def graph_counts():
    """(eager steps, captures, replays) of the captured train steps of
    the Trainers built inside the block, summed; the list is filled when
    the block ends, and holds no Trainer after it."""
    from patchgan_tpu_torch.train import Trainer
    built, counts, init = [], [], Trainer.__init__

    def record(self, *args, **kwargs):
        init(self, *args, **kwargs)
        built.append(self)

    Trainer.__init__ = record
    try:
        yield counts
    finally:
        Trainer.__init__ = init
        counts += [sum(c) for c in zip((0, 0, 0), *(
            t.graph_counts() for t in built))]
        built.clear()


def train_child():
    """``python -c 'import chip_smoke; chip_smoke.train_child()' ARGS``:
    patchgan_train with ARGS in a process of its own, then its Trainers'
    ``graph_counts`` on a line of their own."""
    from patchgan_tpu_torch.cli.train import patchgan_train
    with graph_counts() as counts:
        patchgan_train(sys.argv[1:])
    print(f'graph counts {tuple(counts)}', flush=True)


def dcp_train_child():
    """``train_child`` with the Trainer writing its exact-resume state
    through the async store (``checkpoint_format = 'orbax'``, which the
    CLI does not set)."""
    from patchgan_tpu_torch.train import Trainer
    Trainer.checkpoint_format = 'orbax'
    train_child()


# the NHWC forms' launches by path (K1, K2, K3, K1-bwd), as phase 8 counts
# them, of K1's and K1-bwd's those on the one-pass kernel, and K2's and
# K3's launches on the wgmma core by path, in either form
NHWC_PATHS, ONE_PASS_PATHS, WGMMA_PATHS = {}, {}, {}


def wgmma_grew(path, fn, exact=True):
    """fn(), a bf16 path at the nf=64 widths, and K2's and K3's launches
    on the wgmma core during it (``WGMMA_PATHS[path]``), which must have
    grown; ``exact``: every launch of theirs during it on that core (a
    path whose phase resets the launch counts, or that runs fp32 too,
    checks its own)."""
    from patchgan_tpu_torch.ops.kernels import conv_norm_act, convt_norm_act
    ws = (conv_norm_act, convt_norm_act)
    before = [(w.launches, w.launches_wgmma) for w in ws]
    out = fn()
    took = [w.launches - b[0] for w, b in zip(ws, before)]
    on = [w.launches_wgmma - b[1] for w, b in zip(ws, before)]
    WGMMA_PATHS[path] = on
    print(f'  {path}: K2\'s and K3\'s launches on the wgmma core {on}'
          + (f' of {took}' if exact else ''), flush=True)
    if not all(on) or (exact and on != took):
        raise AssertionError(f'{path}: K2 / K3 on the wgmma core {on}, '
                             f'launched {took}')
    return out


def train_path_phase(torch, np, wrappers, card, s2d, tmp):
    """patchgan_train -d cuda for 2 epochs, then a resume to epoch 3,
    under PATCHGAN_S2D=``s2d``, on a synthetic folder written into
    ``tmp``; returns the launch counts of the first run, the epoch times
    and the training config."""
    from patchgan_tpu_torch.cli.train import patchgan_train
    from patchgan_tpu_torch.ops.kernels.conv_norm_act import recompute_grads
    from patchgan_tpu_torch.train.auto_layout import auto_layout_enabled
    per_step, per_eval = STEP[s2d], EVAL[s2d]
    runs = []
    train_cfg, resume_cfg = write_train_inputs(tmp, np)
    with in_dir(tmp):
        for cfg, epochs in ((train_cfg, 2), (resume_cfg, 3)):
            for w in wrappers + [recompute_grads]:
                w.launches = 0
            for w in wrappers[:4]:
                w.launches_nhwc = 0
            for w in (wrappers[0], wrappers[3]):
                w.launches_one_pass = 0
            for w in (wrappers[1], wrappers[2]):
                w.launches_wgmma = 0
            tee = Tee(sys.stdout)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(tee), s2d_env(s2d), \
                    graph_counts() as counts:
                g_hist, d_hist = patchgan_train(
                    ['-c', cfg, '-n', str(epochs), '-b', str(TRAIN_B),
                     '-d', 'cuda', '--no-summary'])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs.append(([w.launches for w in wrappers], g_hist, d_hist,
                         tee.getvalue(), wall, recompute_grads.launches,
                         tuple(counts)))
            if epochs == 2:
                nhwc = [w.launches_nhwc for w in wrappers[:4]]
                one_pass = [w.launches_one_pass
                            for w in (wrappers[0], wrappers[3])]
                wgmma = [w.launches_wgmma for w in wrappers[1:3]]
    # the Trainer's layout (PATCHGAN_AUTO_LAYOUT): channels_last runs every
    # launch of K1-K3 and K1-bwd in its NHWC form; s2d keeps NCHW
    cl_run = auto_layout_enabled() and s2d == 'off'
    want_nhwc = runs[0][0][:4] if cl_run else [0] * 4
    print(f'  s2d {s2d}: the Trainer\'s layout '
          f'{"channels_last" if cl_run else "NCHW"}; NHWC launches of K1, '
          f'K2, K3, K1-bwd {nhwc} (expected {want_nhwc})', flush=True)
    if nhwc != want_nhwc:
        raise AssertionError(f'NHWC launches {nhwc}, expected {want_nhwc}')
    # config 2's shapes all fit a cluster: every NHWC K1 and K1-bwd call
    # takes the one-pass kernel
    want_one = [want_nhwc[0], want_nhwc[3]]
    print(f'  s2d {s2d}: of them on the one-pass kernel, K1 and K1-bwd '
          f'{one_pass} (expected {want_one})', flush=True)
    if one_pass != want_one:
        raise AssertionError(f'one-pass launches {one_pass}, expected '
                             f'{want_one}')
    # and config 2's K2 and K3 shapes all take the wgmma core in bf16, in
    # either form
    want_wgmma = runs[0][0][1:3]
    print(f'  s2d {s2d}: of them on the wgmma core, K2 and K3 {wgmma} '
          f'(expected {want_wgmma})', flush=True)
    if wgmma != want_wgmma:
        raise AssertionError(f'wgmma launches {wgmma}, expected '
                             f'{want_wgmma}')
    NHWC_PATHS[f'train_s2d_{s2d}'] = nhwc
    ONE_PASS_PATHS[f'train_s2d_{s2d}'] = one_pass
    WGMMA_PATHS[f'train_s2d_{s2d}'] = wgmma
    files = sorted(os.listdir(os.path.join(tmp, 'ck')))
    want_files = [f'{p}_ep_{e:03d}.npz' for p in ('discriminator',
                                                   'generator')
                  for e in (1, 2, 3)]
    if files != want_files:
        raise AssertionError(f'checkpoints {files}, expected {want_files}')
    epoch_s = []
    for (launches, g_hist, d_hist, out, wall, recomputes, counts), epochs \
            in zip(runs, (2, 1)):
        steps, evals = 4 * epochs, epochs     # 64 / 16 and 16 / 16
        # the captured step: one eager step, one capture, then replays;
        # the wrappers launch in the first two only
        want_counts = (1, 1, steps - 1)
        ran = counts[0] + counts[1]
        want = [ran * a + evals * b for a, b in zip(per_step, per_eval)]
        print(f'  run of {epochs} epoch(s): wall {wall:.2f} s, eager steps '
              f'/ captures / replays {counts} (expected {want_counts}), '
              f'launches {launches} (expected {want}), recomputes '
              f'{recomputes} (expected {ran * RECOMPUTES["full"]}), G '
              f'losses {g_hist}, D losses {d_hist}', flush=True)
        if counts != want_counts or launches != want or \
                recomputes != ran * RECOMPUTES['full']:
            raise AssertionError(f'graph counts {counts}, launches '
                                 f'{launches}, expected {want}; recomputes '
                                 f'{recomputes}')
        if not all(np.isfinite(g_hist + d_hist)) or \
                len(g_hist) != epochs:
            raise AssertionError(f'losses {g_hist} {d_hist}')
        for line in out.splitlines():
            if ' images in ' in line:
                epoch_s.append(float(line.split(' images in ')[1]
                                     .split('s')[0]))
    resumed = runs[1][3]
    lr = 1e-3 * 0.5 ** (2 / 5)
    if f'Epoch 3 -- lr: {lr:5.3e}, {lr:5.3e}' not in resumed or \
            'Epoch 1' in resumed or 'Epoch 2' in resumed:
        raise AssertionError('the resume did not start at epoch 3 with the '
                             'fast-forwarded LR')
    print(f'  s2d {s2d}: resumed at epoch 3 with lr {lr:5.3e}; training '
          f'epoch wall times (64 images, loader included) {epoch_s} s on '
          f'{card}', flush=True)
    return runs[0][0], epoch_s, train_cfg


def assert_update_close(name, got, want):
    """Parameters after one Adam update, card against CPU: an element
    whose gradient is at rounding-noise level can flip its update's sign
    (about lr * sign(g)), so 99.9% of the elements within 5e-5 + 5e-3 |w|
    and every one within 2.5 lr (tests/torch_parity.py)."""
    diff = (got - want).abs()
    tight = (diff <= 5e-5 + 5e-3 * want.abs()).float().mean().item()
    worst = diff.max().item()
    if not (tight >= 0.999 and worst <= 2.5 * LR):
        raise AssertionError(f'{name}: {1 - tight:.3%} loose, max diff '
                             f'{worst:.3e}')
    return 1.0 - tight, worst


def record_grads(opt, micro, applied):
    """Make ``opt`` (a ``MultiSteps``) copy to the host the gradients of
    each call, appended to ``micro``, and the mean its k-th call hands its
    inner Adam, appended to ``applied`` (the eager step calls each
    optimizer's ``update``)."""
    outer_update, inner_update = opt.update, opt.inner.update

    def host(grads):
        return [g.detach().float().cpu().clone() for g in grads]

    def update(grads):
        micro.append(host(grads))
        outer_update(grads)

    def inner(grads):
        applied.append(host(grads))
        inner_update(grads)
    opt.update, opt.inner.update = update, inner


def grad_errors(names, got, ref):
    """{name: max |got - ref| / max |ref|} over a list of gradients."""
    return {n: (g - r).abs().max().item() / max(r.abs().max().item(), 1e-30)
            for n, g, r in zip(names, got, ref)}


def worst_error(errors):
    """The largest of ``grad_errors`` as '<share> (<name>)'."""
    name = max(errors, key=errors.get)
    return f'{errors[name]:.3e} ({name})'


def finetune_parity_phase(torch, np, wrappers, s2d):
    """Two micro-steps of the frozen (('enc',)) step with accumulation
    every 2, fp32, TF32 off, dropout off, in the form ``s2d`` selects:
    the kernel path on the card against the plain path on the CPU from
    the same weights and batches. Losses of both micro-steps within rtol
    2e-3 / atol 2e-4. The gradients of the trained tensors: on the card,
    each micro-step's within 1e-4 of each tensor's max |g| of the full
    step's (``step_grads``, every parameter trainable) on the same
    weights and batch, so a frozen step that drops or scales a term
    fails; the first micro-step's, on phase 7's batch, within 1e-3 of
    the CPU's, phase 7's limit. The second's card-vs-CPU distance is
    printed, not held: with ReLU the step's gradient is not continuous
    at rounding scale (``tools/grad_sensitivity.py``), and this batch
    puts a ReLU input at a deep level on the other side of 0 on the two
    devices. On each device
    the mean the second micro-step hands Adam within 1e-6 of its max of
    the running mean of the two; after the first no parameter has moved
    on either device; after the second the encoder is bit-equal to its
    initial weights on both, every other parameter within Adam's
    sign-flip bound of the CPU's (``assert_update_close``); 2 x
    ``FT_STEP`` launches. The card runs deterministic cuDNN, as phases
    14b and 16a do: K3's backward recomputes a cuDNN transposed conv,
    whose default algorithm adds with atomics, and K1-bwd reads its ReLU
    mask from that recompute, so two runs on the card could otherwise
    round a near-zero ReLU input to either side of 0."""
    with cudnn_flags_kept(torch):
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        return _finetune_parity(torch, np, wrappers, s2d)


def _finetune_parity(torch, np, wrappers, s2d):
    from patchgan_tpu_torch.models import Discriminator, UNet
    from patchgan_tpu_torch.train.steps import (make_optimizer,
                                                make_train_step,
                                                trainable_params)
    init = torch.Generator().manual_seed(4)
    gen = UNet(IN_C, OUT_C, nf=NF, activation='relu', final_act='softmax',
               generator=init)
    disc = Discriminator(IN_C + OUT_C, ndf=NDF, n_layers=3, generator=init)
    names = [f'G {n}' for n, _ in gen.named_parameters()] + \
        [f'D {n}' for n, _ in disc.named_parameters()]
    start = [p.detach().clone() for p in list(gen.parameters())
             + list(disc.parameters())]
    batches = [train_batch(torch, np, 2, SIZE, 'cpu', seed)
               for seed in (5, 6)]
    models = {'cpu': ('cpu', gen, disc),
              'card': ('cuda', copy.deepcopy(gen).cuda(),
                       copy.deepcopy(disc).cuda())}
    trained = [n for n in names if not n.startswith('G encoder')]
    kept = [i for i, n in enumerate(names) if n in trained]
    g_card, d_card = models['card'][1:]
    full = []
    for x, y in batches:
        every = step_grads(torch, g_card, d_card, x.cuda(), y.cuda(), s2d)[1]
        full.append([every[j] for j in kept])
    out, grads = {}, {}
    for where, (device, g, d) in models.items():
        opts = (make_optimizer(trainable_params(g, FREEZE), LR, every_k=2),
                make_optimizer(d.parameters(), LR, every_k=2))
        recorded = [([], []), ([], [])]
        for opt, (micro, applied) in zip(opts, recorded):
            record_grads(opt, micro, applied)
        step = make_train_step(g, d, *opts, s2d=s2d == 'on')
        params = list(g.parameters()) + list(d.parameters())
        for w in wrappers:
            w.launches = 0
        t0 = time.perf_counter()
        runs = []
        for x, y in batches:
            losses = step(x.to(device), y.to(device))
            runs.append(({k: v.item() for k, v in losses.items()},
                          [p.detach().cpu().clone() for p in params]))
        (g_micro, g_applied), (d_micro, d_applied) = recorded
        micro = [gm + dm for gm, dm in zip(g_micro, d_micro)]
        for name, g1, g2, mean in zip(trained, *micro,
                                      g_applied[0] + d_applied[0]):
            want = g1 + (g2 - g1) / 2
            if not (mean - want).abs().max() <= \
                    1e-6 * want.abs().max():
                raise AssertionError(f'{where}: {name}: the applied mean '
                                     f'is not the running mean')
        out[where], grads[where] = runs, micro
        print(f'  s2d {s2d}, {where}: two micro-steps in '
              f'{time.perf_counter() - t0:.1f} s', flush=True)
    launches = [w.launches for w in wrappers]
    want = [2 * n for n in FT_STEP[s2d]]
    if launches != want:
        raise AssertionError(f'fine-tune parity launches {launches}, '
                             f'expected {want}')
    for i in range(2):
        for k, want_v in out['cpu'][i][0].items():
            got = out['card'][i][0][k]
            if not abs(got - want_v) <= 2e-4 + 2e-3 * abs(want_v):
                raise AssertionError(f'micro-step {i + 1} loss {k}: card '
                                     f'{got} vs CPU {want_v}')
    for where in ('cpu', 'card'):
        first, second = out[where][0][1], out[where][1][1]
        for name, p0, p1, p2 in zip(names, start, first, second):
            if not torch.equal(p1, p0):
                raise AssertionError(f'{where}: {name} moved at the first '
                                     f'micro-step')
            if torch.equal(p2, p0) != name.startswith('G encoder'):
                raise AssertionError(f'{where}: {name} frozen: '
                                     f'{name.startswith("G encoder")}, '
                                     f'equal after the update: '
                                     f'{torch.equal(p2, p0)}')
    worst = {'loose': 0.0, 'max_diff': 0.0}
    for i in range(2):
        frozen_full = grad_errors(trained, grads['card'][i], full[i])
        card_cpu = grad_errors(trained, grads['card'][i], grads['cpu'][i])
        worst[f'micro-step {i + 1}'] = {
            'card frozen vs full': worst_error(frozen_full),
            'card vs CPU': worst_error(card_cpu)}
        print(f'  s2d {s2d}, micro-step {i + 1}, worst max |dg| / max |g|: '
              f'{worst[f"micro-step {i + 1}"]}', flush=True)
        bad = {n: e for n, e in frozen_full.items() if not e <= 1e-4}
        if i == 0:
            bad.update((f'{n} vs CPU', e) for n, e in card_cpu.items()
                       if not e <= 1e-3)
        if bad:
            raise AssertionError(f'micro-step {i + 1} gradients: {bad}')
    for name, got, want_p in zip(names, out['card'][1][1], out['cpu'][1][1]):
        if not name.startswith('G encoder'):
            loose, diff = assert_update_close(name, got, want_p)
            worst.update(loose=max(worst['loose'], loose),
                         max_diff=max(worst['max_diff'], diff))
    print(f'  s2d {s2d}: launches {launches}; losses of both micro-steps '
          f'{[r[0]["gen"] for r in out["card"]]} (card) vs '
          f'{[r[0]["gen"] for r in out["cpu"]]} (CPU); gradients of '
          f'{len(trained)} tensors as above; the applied mean the running '
          f'mean of the two; nothing moved at the first; encoder bit-equal '
          f'to its initial weights on both devices; decoder and D after '
          f'the update: loose share {worst["loose"]:.2e}, max |diff| '
          f'{worst["max_diff"]:.3e} (bound 2.5 lr)', flush=True)
    return worst


def finetune_path_phase(torch, np, wrappers, s2d, tmp, train_cfg):
    """The fine-tune of BASELINE.json config 3 through ``patchgan_train -d
    cuda`` (bf16, batch 16, 1 epoch): the training run's epoch-3 weights
    saved as torch .pth files, loaded by ``transfer_learn`` with
    ``freeze_encoder``, and ``accumulate_steps: 2``. Checks the launches
    (4 steps of ``FT_STEP``, one validation batch of ``EVAL``, 4 x 5
    recomputes), that the epoch file holds the .pth's encoder bit for
    bit and a moved decoder. Returns the launches by kernel."""
    import yaml
    from patchgan_tpu_torch.cli.train import patchgan_train
    from patchgan_tpu_torch.ops.kernels.conv_norm_act import recompute_grads
    from patchgan_tpu_torch.utils.checkpoint import load_state_dict
    pth = {}
    for net in ('generator', 'discriminator'):
        pth[net] = os.path.join(tmp, f'{net}.pth')
        torch.save(load_state_dict(os.path.join(tmp, 'ck',
                                                f'{net}_ep_003.npz')),
                   pth[net])
    with open(train_cfg) as f:
        cfg = yaml.safe_load(f)
    cfg['checkpoint_path'] = os.path.join(tmp, f'ft_{s2d}')
    cfg['load_last_checkpoint'] = False
    cfg['transfer_learn'] = {'generator_checkpoint': pth['generator'],
                             'discriminator_checkpoint': pth['discriminator'],
                             'freeze_encoder': True}
    cfg['train_params']['accumulate_steps'] = 2
    path = os.path.join(tmp, 'finetune.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    with in_dir(tmp), s2d_env(s2d), graph_counts() as counts:
        for w in wrappers + [recompute_grads]:
            w.launches = 0
        t0 = time.perf_counter()
        g_hist, d_hist = patchgan_train(['-c', path, '-n', '1', '-b',
                                         str(TRAIN_B), '-d', 'cuda',
                                         '--no-summary'])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = [w.launches for w in wrappers]
        recomputes = recompute_grads.launches
    # 4 micro-steps, one captured program per window position: each
    # position's first call eager, its second the capture and a replay
    want = [4 * a + b for a, b in zip(FT_STEP[s2d], EVAL[s2d])]
    print(f'  s2d {s2d}: wall {wall:.2f} s, eager steps / captures / '
          f'replays {tuple(counts)} (expected (2, 2, 2)), launches '
          f'{launches} (expected {want}), recomputes {recomputes} (expected '
          f'{4 * RECOMPUTES["frozen"]}), G losses {g_hist}, D losses '
          f'{d_hist}', flush=True)
    if launches != want or recomputes != 4 * RECOMPUTES['frozen'] or \
            tuple(counts) != (2, 2, 2):
        raise AssertionError(f'fine-tune launches {launches}, recomputes '
                             f'{recomputes}, graph counts {counts}')
    if not all(np.isfinite(g_hist + d_hist)):
        raise AssertionError(f'losses {g_hist} {d_hist}')
    before = torch.load(pth['generator'])
    after = load_state_dict(os.path.join(cfg['checkpoint_path'],
                                         'generator_ep_001.npz'))
    for k, v in before.items():
        if torch.equal(after[k], v) != k.startswith('encoder'):
            raise AssertionError(f'fine-tune: {k} equal to the .pth: '
                                 f'{torch.equal(after[k], v)}')
    print(f'  s2d {s2d}: encoder bit-equal to the .pth, decoder moved',
          flush=True)
    return launches


def eval_path_phase(torch, np, wrappers, card, tmp, train_cfg):
    """``patchgan_eval`` with the training config on its 16 validation
    images, so the newest epoch file (3) is evaluated: ``-d cuda`` (bf16)
    with the launch counts (K1 / K2 / K3 1 / 6 / 5 a batch of 8), the
    JSON line's keys, n_images 16 and values in [0, 1]; then ``-d cuda
    --dtype float32`` against ``-d cpu --dtype float32``, every metric
    within 2e-3. Then the bf16 loop's images/s on ``EVAL_TIMED`` seeded
    images in batches of 8, the first batch left out, in two runs.
    Returns (launches, the two runs' images/s, the three results)."""
    import yaml
    from patchgan_tpu_torch.cli.evaluate import patchgan_eval
    args = ['-b', '8', '--metrics', 'iou,dice,bf1']
    keys = ['metric', 'value', 'n_images', 'checkpoint', 'mean_dice',
            'mean_boundary_f1']
    with in_dir(tmp):
        for w in wrappers:
            w.launches = 0
        bf16 = patchgan_eval(['-c', train_cfg, '-d', 'cuda'] + args)
        torch.cuda.synchronize()
        launches = [w.launches for w in wrappers]
        fp32 = patchgan_eval(['-c', train_cfg, '-d', 'cuda', '--dtype',
                              'float32'] + args)
        cpu = patchgan_eval(['-c', train_cfg, '-d', 'cpu', '--dtype',
                             'float32'] + args)
    want = [2 * n for n in EVAL['off']]
    if launches != want:
        raise AssertionError(f'eval launches {launches}, expected {want}')
    for r in (bf16, fp32, cpu):
        if list(r) != keys or r['n_images'] != 16 or \
                not r['checkpoint'].endswith('generator_ep_003.npz') or \
                not all(0.0 <= r[k] <= 1.0 for k in keys[4:] + ['value']):
            raise AssertionError(f'eval result {r}')
    diffs = {k: abs(fp32[k] - cpu[k])
             for k in ('value', 'mean_dice', 'mean_boundary_f1')}
    if not all(d <= 2e-3 for d in diffs.values()):
        raise AssertionError(f'eval fp32 card vs CPU: {diffs}')
    print(f'  launches {launches}; bf16 {bf16}; fp32 card vs CPU |diff| '
          f'{diffs} (tol 2e-3)', flush=True)

    with open(train_cfg) as f:
        cfg = yaml.safe_load(f)
    t0 = time.perf_counter()
    write_npz_folder(os.path.join(tmp, 'timed'), np,
                     np.random.default_rng(9), EVAL_TIMED)
    cfg['dataset']['validation_data'] = {'images': 'timed',
                                         'masks': 'timed'}
    cfg['checkpoint_paths'] = {'generator': bf16['checkpoint']}
    timed_cfg = os.path.join(tmp, 'eval_timed.yaml')
    with open(timed_cfg, 'w') as f:
        yaml.safe_dump(cfg, f)
    print(f'  wrote {EVAL_TIMED} images in {time.perf_counter() - t0:.2f} s',
          flush=True)
    tee = Tee(sys.stdout)
    with in_dir(tmp), contextlib.redirect_stdout(tee):
        timed = [patchgan_eval(['-c', timed_cfg, '-d', 'cuda'] + args)
                 for _ in range(2)]
    if any(r['n_images'] != EVAL_TIMED for r in timed):
        raise AssertionError(f'timed eval results {timed}')
    img_s = []
    for line in tee.getvalue().splitlines():
        if ' after the first batch ' in line:
            n, secs = line.split(' after the first batch ')[1].split(
                ' images in ')
            img_s.append(int(n) / float(secs.split('s')[0]))
    print(f'  bf16 loop on {EVAL_TIMED} images, batch 8, the first batch '
          f'left out: {img_s} images/s (two runs) on {card}', flush=True)
    return launches, img_s, {'bf16': bf16, 'fp32': fp32, 'cpu': cpu}


# the throughput phase's configurations: (form, frozen, batch, every_k,
# captured); 'off' and 'on' are the full step, the rest the fine-tune of
# config 3; ' graph' the same step captured (train/graph.py); 'cl' the
# plain form in channels_last, 'cl shadow' with the generator's shadow
# (phase 19)
TRAIN_CONFIGS = {'off': ('off', False, TRAIN_B, 1, False),
                 'on': ('on', False, TRAIN_B, 1, False),
                 'frozen off': ('off', True, TRAIN_B, 1, False),
                 'frozen on': ('on', True, TRAIN_B, 1, False),
                 'frozen off k=2 b=8': ('off', True, TRAIN_B // 2, 2, False),
                 'off graph': ('off', False, TRAIN_B, 1, True),
                 'on graph': ('on', False, TRAIN_B, 1, True),
                 'frozen off k=2 b=8 graph': ('off', True, TRAIN_B // 2, 2,
                                              True),
                 'cl shadow graph': ('cl shadow', False, TRAIN_B, 1, True)}
# phase 19's channels_last step without the shadow: timed by
# ``--layout-only`` beside the two above
CL_PLAIN = {'cl graph': ('cl', False, TRAIN_B, 1, True)}
# steps of each case of the graph-parity phase (micro-steps at k=2)
PARITY_STEPS = 4


def train_models(torch, seed=7, remat=False):
    """Config 2's bf16 generator (dropout on; ``remat`` as given) and
    discriminator from a seed, on the card, the dropout generator
    seeded."""
    from patchgan_tpu_torch.models import Discriminator, UNet
    bf16 = torch.bfloat16
    init = torch.Generator().manual_seed(seed)
    gen = UNet(IN_C, OUT_C, nf=NF, use_dropout=True, activation='relu',
               final_act='softmax', dtype=bf16, generator=init,
               remat=remat).cuda()
    disc = Discriminator(IN_C + OUT_C, ndf=NDF, n_layers=3, dtype=bf16,
                         generator=init).cuda()
    gen.dropout_generator = torch.Generator(device='cuda').manual_seed(0)
    return gen, disc


def config_step(torch, gen, disc, form, frozen, every_k, graph, mesh=None):
    """The bf16 train step of one ``TRAIN_CONFIGS`` entry and its two
    optimizers (Adam's first moment in bf16, as patchgan_train keeps
    it); data-parallel over ``mesh`` when one is given."""
    from patchgan_tpu_torch.train.auto_layout import to_layout
    from patchgan_tpu_torch.train.steps import (make_optimizer,
                                                make_train_step,
                                                trainable_params)
    layout = CL if form.startswith('cl') else None
    if layout is not None:
        to_layout((gen, disc))
    opts = (make_optimizer(trainable_params(gen, FREEZE if frozen else ()),
                           LR, mu_dtype=torch.bfloat16, every_k=every_k),
            make_optimizer(disc.parameters(), LR, mu_dtype=torch.bfloat16,
                           every_k=every_k))
    return make_train_step(
        gen, disc, *opts, s2d=form == 'on', graph=graph, mesh=mesh,
        layout=layout,
        shadow_dtype=torch.bfloat16 if 'shadow' in form else None), opts


def step_state(torch, gen, disc, opts):
    """Every tensor a step changes, on the host: parameters, Adam's
    moments, step counts and learning rates, accumulators, the dropout
    generator's state; and the host counters."""
    tensors = [p for p in gen.parameters()] + \
        [p for p in disc.parameters()]
    counters = []
    for opt in opts:
        inner = getattr(opt, 'inner', opt)
        tensors += inner.mu + inner.nu + [inner.count_t, inner.neg_lr_t] + \
            list(getattr(opt, 'acc', []))
        counters += [inner.count, getattr(opt, 'mini_step', 0)]
    tensors.append(gen.dropout_generator.get_state())
    return [t.detach().cpu() for t in tensors], counters


def graph_parity_phase(torch, np, wrappers):
    """The captured step (train/graph.py) against the eager step, bit for
    bit: for the full step in both forms, the frozen step in both forms
    and the frozen step accumulating 2 micro-batches of 8, bf16 at batch
    16, dropout on, deterministic cuDNN, each from the same weights and
    batches, ``PARITY_STEPS`` steps eagerly and as many through the
    captured path (its eager first steps, its capture, its replays; at
    k=2 as many updates, twice the micro-steps), then an LR written
    between two more steps of each: every step's losses, then every
    parameter, Adam moment, count, learning rate, accumulator and the
    dropout generator's state must be equal. Then a Trainer's captured
    step restored (``_restore_training_state``) to an earlier state and
    stepped again must equal an eager Trainer that never left it."""
    rows = {}
    with cudnn_flags_kept(torch):
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        for name, (form, frozen, batch, every_k, _) in TRAIN_CONFIGS.items():
            if name.endswith(' graph'):
                continue
            n = PARITY_STEPS * every_k
            batches = [tuple(t.to(torch.bfloat16) for t in train_batch(
                torch, np, batch, SIZE, 'cuda', 40 + i)) for i in range(n + 2)]
            result = {}
            for graph in (False, True):
                gen, disc = train_models(torch)
                step, opts = config_step(torch, gen, disc, form, frozen,
                                         every_k, graph)
                losses = [step(*b) for b in batches[:n]]
                for opt in opts:
                    opt.lr = LR / 3
                losses += [step(*b) for b in batches[n:]]
                torch.cuda.synchronize()
                result[graph] = ([torch.stack(list(l.values())).cpu()
                                  for l in losses],
                                 step_state(torch, gen, disc, opts))
                if graph:
                    counts = (step.eager_steps, step.captures, step.replays)
                del gen, disc, step, opts
            (l_e, (t_e, c_e)), (l_g, (t_g, c_g)) = result[False], result[True]
            same_losses = all(torch.equal(a, b) for a, b in zip(l_e, l_g))
            same = [torch.equal(a, b) for a, b in zip(t_e, t_g)]
            rows[name] = {'losses_equal': same_losses,
                          'tensors_equal': sum(same), 'tensors': len(same),
                          'counters': c_g, 'eager_capture_replay': counts}
            print(f'  {name}: {n + 2} steps, eager / captures / replays '
                  f'{counts}, losses equal {same_losses}, tensors equal '
                  f'{sum(same)} of {len(same)}, counters {c_g} (eager '
                  f'{c_e}), the dropout generator equal {same[-1]}',
                  flush=True)
            if not (same_losses and all(same) and c_e == c_g) or \
                    counts != (every_k, every_k, n + 2 - every_k):
                raise AssertionError(f'{name}: the captured step differs '
                                     f'from the eager one: {rows[name]}')
        rows['restore'] = restore_parity(torch, np)
    return rows


def restore_parity(torch, np):
    """A Trainer on the captured step: 2 steps, its training state saved,
    2 more, the state restored in place, the same 2 again; against a
    Trainer on the eager step (PATCHGAN_CUDA_GRAPH=off) that ran the 4
    steps once: the repeated steps' losses, then every tensor and the
    counters, equal."""
    from patchgan_tpu_torch.train import Trainer
    batches = [tuple(t.to(torch.bfloat16) for t in train_batch(
        torch, np, TRAIN_B, SIZE, 'cuda', 60 + i)) for i in range(4)]
    with tempfile.TemporaryDirectory() as tmp:
        def trainer(name):
            gen, disc = train_models(torch)
            t = Trainer(gen, disc, os.path.join(tmp, name), device='cuda')
            t.adam_mu_dtype = torch.bfloat16
            t._make_optimizers(LR, LR)
            return t

        def state(t):
            return step_state(torch, t.generator, t.discriminator,
                              (t.gen_opt, t.disc_opt))

        with env_var('PATCHGAN_CUDA_GRAPH', 'off'):
            eager = trainer('eager')
            want = [eager.batch(*b, train=True) for b in batches]
        captured = trainer('captured')
        for b in batches[:2]:
            captured.batch(*b, train=True)
        path = os.path.join(tmp, 'state.pt')
        captured._write_training_state(path)
        for b in batches[2:]:
            captured.batch(*b, train=True)
        captured._restore_training_state(path)
        got = [captured.batch(*b, train=True) for b in batches[2:]]
        counts = captured.graph_counts()
        (t_e, c_e), (t_g, c_g) = state(eager), state(captured)
    same = [torch.equal(a, b) for a, b in zip(t_e, t_g)]
    print(f'  restore: the captured Trainer restored after step 4 to step '
          f'2 and stepped again: losses equal {got == want[2:]}, tensors '
          f'equal {sum(same)} of {len(same)}, counters {c_g} (eager {c_e}), '
          f'eager steps / captures / replays {counts}', flush=True)
    if got != want[2:] or not all(same) or c_e != c_g or \
            counts != (1, 1, 5):
        raise AssertionError(f'the restored captured step differs: losses '
                             f'{got} vs {want[2:]}, tensors {sum(same)}, '
                             f'graph counts {counts}')
    return {'losses_equal': True, 'tensors_equal': sum(same),
            'graph_counts': counts}


def profile_config(torch, profile, activity, fn, name, n_steps):
    """A profile of ``n_steps`` calls of ``fn``: (its device kernels as
    (device us, count, name), largest first; the wall us; K1-K4 a step
    as the device ran them, a captured step's in its replays, which call
    no wrapper; the table's counts for the configuration; K1-K4 a step
    as the wrappers counted their launches over the same steps)."""
    wrappers = kernel_wrappers()
    before = [w.launches for w in wrappers]
    with profile(activities=[activity.CPU, activity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device kernels are the entries with no CPU time of their own (an
    # operator's entry repeats its kernels' device time)
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0
                   and e.self_cpu_time_total == 0), reverse=True)
    form, frozen = TRAIN_CONFIGS[name][:2]
    want = (FT_STEP if frozen else STEP)[form]
    names = PROFILE_NAMES_NHWC if form.startswith('cl') else PROFILE_NAMES
    ported = [sum(n for _, n, key in rows
                  if all(part in key for part in parts)) / n_steps
              for parts in names]
    launched = [(w.launches - n) / n_steps for w, n in zip(wrappers, before)]
    return rows, wall_us, ported, want, launched


def throughput_phase(torch, np, card):
    """img/s of the bf16 train step on a device-resident batch in each of
    ``TRAIN_CONFIGS``: the full step at batch 16, plain and s2d form, the
    frozen (('enc',)) step at batch 16 in both forms, and the frozen step
    accumulating 2 micro-batches of 8 (img/s counts the images of each
    micro-step), then the plain, s2d and accumulating steps captured; all
    in turns, three windows of at least ``WINDOW_S`` each, with the host's ms per
    step (the wall of the call that queues it; for a captured step the
    copy in, the replay and the copy out). Peak memory (absolute, above
    what was allocated before the configuration's first steps, and its
    own: its models, optimizers, batch and steps), and a profiler
    breakdown of three steps of each (four micro-steps at k=2) with the
    device kernels launched a step: a frozen step must launch fewer than
    the full one of its form, a captured step as many as its eager
    counterpart."""
    bf16 = torch.bfloat16
    x, y = train_batch(torch, np, TRAIN_B, SIZE, 'cuda', 8)
    x, y = x.to(bf16), y.to(bf16)
    steps, out = {}, {}
    for name, (form, frozen, batch, every_k, graph) in TRAIN_CONFIGS.items():
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        gen, disc = train_models(torch)
        step, _ = config_step(torch, gen, disc, form, frozen, every_k, graph)
        steps[name] = (lambda step=step, b=batch: step(x[:b], y[:b]), batch,
                       every_k)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()

        def first_steps(fn=steps[name][0], k=every_k):
            # the captured step's eager steps, its capture and a replay
            for _ in range(2 * k + 1):
                out = fn()
            return out
        losses = first_steps() if form.startswith('cl') else wgmma_grew(
            f'step_{name}', first_steps)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        out[name] = {'peak_memory_bytes': peak,
                     'step_memory_bytes': peak - base,
                     'own_peak_memory_bytes': peak - before + (
                         x[:batch].nbytes + y[:batch].nbytes),
                     'batch': batch, 'every_k': every_k, 'captured': graph,
                     'img_per_s_windows': [], 'host_ms_windows': []}
        if graph and not step.replays:
            raise AssertionError(f'{name}: no replay')
        loss = {k: float(v) for k, v in losses.items()}
        if not all(np.isfinite(list(loss.values()))):
            raise AssertionError(f'{name}: losses {loss}')
    names = list(TRAIN_CONFIGS)
    for i in range(WINDOWS):
        for name in (names if i % 2 == 0 else names[::-1]):
            fn, batch, _ = steps[name]
            count, host, t0 = 0, 0.0, time.perf_counter()
            while True:
                for _ in range(5):
                    t1 = time.perf_counter()
                    fn()
                    host += time.perf_counter() - t1
                torch.cuda.synchronize()
                count += 5
                dt = time.perf_counter() - t0
                if dt >= WINDOW_S:
                    break
            out[name]['img_per_s_windows'].append(batch * count / dt)
            out[name]['host_ms_windows'].append(1e3 * host / count)
            print(f'  window {i} {name}: {count} steps in {dt:.3f} s, '
                  f'{batch * count / dt:.3f} img/s, host '
                  f'{1e3 * host / count:.3f} ms a step', flush=True)
    from torch.profiler import ProfilerActivity, profile
    for name, (fn, batch, every_k) in steps.items():
        r = out[name]
        readings = r['img_per_s_windows']
        img_s = statistics.median(readings)
        r.update(img_per_s=img_s, ms_per_step=1e3 * batch / img_s,
                 host_ms_per_step=statistics.median(r['host_ms_windows']))
        print(f'  bf16 step {name}, batch {batch}, every_k {every_k}: median '
              f'{img_s:.3f} img/s (min {min(readings):.3f}, max '
              f'{max(readings):.3f}), {r["ms_per_step"]:.3f} ms/step, host '
              f'{r["host_ms_per_step"]:.3f} ms/step, peak memory '
              f'{r["peak_memory_bytes"] / 2**30:.3f} GiB '
              f'({r["step_memory_bytes"] / 2**30:.3f} GiB above the '
              f'resident models; its own '
              f'{r["own_peak_memory_bytes"] / 2**30:.3f} GiB) on {card}',
              flush=True)
        n_steps = 3 if every_k == 1 else 4
        form, captured = TRAIN_CONFIGS[name][0], TRAIN_CONFIGS[name][4]
        rows, wall_us, ported, want, launched = profile_config(
            torch, profile, ProfilerActivity, fn, name, n_steps)
        if not captured and launched != want:
            raise AssertionError(f'{name}: the wrappers launched {launched} '
                                 f'of the port\'s kernels a step, expected '
                                 f'{want}')
        busy = sum(row[0] for row in rows)
        ours = sum(row[0] for row in rows if 'pgt::' in row[2])
        n_kernels = sum(row[1] for row in rows) / n_steps
        trans = [row for row in rows
                 if any(t in row[2].lower() for t in TRANSPOSE_KEYS)]
        r.update(transposes_per_step=sum(n for _, n, _ in trans) / n_steps,
                 transposes_ms_per_step=sum(d for d, _, _ in trans)
                 / n_steps / 1e3)
        print(f'  {name}: cuDNN layout transposes '
              f'{r["transposes_per_step"]:.1f} a step, '
              f'{r["transposes_ms_per_step"]:.3f} ms: '
              + ', '.join(f'{n / n_steps:.1f} x {key[:60]}'
                          for _, n, key in trans), flush=True)
        print(f'  profile of {n_steps} steps, {name}: wall '
              f'{wall_us / n_steps / 1e3:.3f} ms/step, kernels '
              f'{busy / n_steps / 1e3:.3f} ms/step (device busy '
              f'{100 * busy / wall_us:.1f}%), the port\'s kernels '
              f'{ours / n_steps / 1e3:.3f} ms/step, {n_kernels:.1f} device '
              f'kernels launched a step; top kernels:', flush=True)
        for dev, n, key in rows[:15]:
            print(f'    {dev / n_steps / 1e3:8.3f} ms/step '
                  f'{n / n_steps:7.1f}/step  {key[:90]}')
        print('  the port\'s kernels:')
        for dev, n, key in rows:
            if 'pgt::' in key:
                print(f'    {dev / n_steps / 1e3:8.3f} ms/step '
                      f'{n / n_steps:7.1f}/step  {key[:90]}')
        print(f'  K1 / K2 / K3 / K1-bwd / K4 / K4-wgrad a step on the device: '
              f'{ported} (expected {want}; the wrappers launched '
              f'{"none: replays" if captured else launched})', flush=True)
        ported_ms = [sum(d for d, _, key in rows
                         if all(part in key for part in parts))
                     / n_steps / 1e3 for parts in (
                         PROFILE_NAMES_NHWC if form.startswith('cl')
                         else PROFILE_NAMES)]
        r['profile_ported_ms_per_step'] = ported_ms
        print(f'  {name}: their device ms a step by the profiler '
              f'(K2 and K3: the GEMM kernels alone) '
              f'{[round(v, 4) for v in ported_ms]}', flush=True)
        # the tracer now and then loses a run of records (a step's first
        # few kernels): an eager step's trace may count fewer than the
        # table, never more, where its wrappers launched exactly the
        # table's counts over the same steps. A captured step's replays
        # call no wrapper, so a short trace of one is read again (18b's
        # reader: the largest of up to three readings over two replays),
        # and that reading must count them all
        if captured and ported != want and \
                all(p <= w for p, w in zip(ported, want)):
            again = replay_kernels(torch, fn, names=PROFILE_NAMES_NHWC
                                   if form.startswith('cl') else
                                   PROFILE_NAMES)
            print(f'  {name}: the trace lost records of a replay ({ported});'
                  f' read again over two replays: {again}', flush=True)
            ported = again
        lost = not captured and all(p <= w for p, w in zip(ported, want))
        if ported != want and not lost:
            raise AssertionError(f'{name}: the device ran {ported} of the '
                                 f'port\'s kernels a step, expected {want}')
        if ported != want:
            print(f'  {name}: the trace lost records of kernels the '
                  f'wrappers launched', flush=True)
        # the busy share is the profiled window's; the profiler slows the
        # host's side of a step, so the profiled kernel ms over the
        # unprofiled step's ms is read beside it (two windows: it can
        # pass 1)
        r.update(profile_busy_ms_per_step=busy / n_steps / 1e3,
                 profile_port_kernels_ms_per_step=ours / n_steps / 1e3,
                 profile_wall_ms_per_step=wall_us / n_steps / 1e3,
                 profile_busy_share=busy / wall_us,
                 kernel_ms_over_step=busy / n_steps / 1e3 / r['ms_per_step'],
                 profile_kernels_per_step=n_kernels,
                 profile_ported_kernels_per_step=ported,
                 profile_trace_lost=ported != want)
    for form in ('off', 'on'):
        if form not in out or f'frozen {form}' not in out:
            continue
        full, frozen = (out[form]['profile_kernels_per_step'],
                        out[f'frozen {form}']['profile_kernels_per_step'])
        print(f'  s2d {form}: device kernels a step, full {full:.1f}, frozen '
              f'{frozen:.1f}', flush=True)
        if not frozen < full:
            raise AssertionError(f's2d {form}: the frozen step launched '
                                 f'{frozen} kernels, the full {full}')
    for name in names:
        if name.endswith(' graph') and name[:-len(' graph')] in out:
            eager = out[name[:-len(' graph')]]
            r = out[name]
            ratio = r['img_per_s'] / eager['img_per_s']
            print(f'  {name} / eager: img/s {ratio:.3f}x, host ms '
                  f'{r["host_ms_per_step"]:.3f} / '
                  f'{eager["host_ms_per_step"]:.3f}, busy (profiled) '
                  f'{100 * r["profile_busy_share"]:.1f}% / '
                  f'{100 * eager["profile_busy_share"]:.1f}% (profiled kernel '
                  f'ms over the unprofiled step '
                  f'{100 * r["kernel_ms_over_step"]:.1f}% / '
                  f'{100 * eager["kernel_ms_over_step"]:.1f}%), device kernels '
                  f'a step {r["profile_kernels_per_step"]:.1f} / '
                  f'{eager["profile_kernels_per_step"]:.1f}, own peak '
                  f'{r["own_peak_memory_bytes"] / 2**30:.3f} / '
                  f'{eager["own_peak_memory_bytes"] / 2**30:.3f} GiB',
                  flush=True)
    if 'cl shadow graph' in out:
        base = out['off graph']
        for name in [n for n in ('cl graph', 'cl shadow graph') if n in out]:
            r = out[name]
            r['img_per_s_over_nchw'] = r['img_per_s'] / base['img_per_s']
            print(f'  {name} / off graph (NCHW): img/s '
                  f'{r["img_per_s"]:.3f} / {base["img_per_s"]:.3f} = '
                  f'{r["img_per_s_over_nchw"]:.4f}x, device kernels a '
                  f'replay {r["profile_kernels_per_step"]:.1f} / '
                  f'{base["profile_kernels_per_step"]:.1f}, cuDNN transposes '
                  f'a replay {r["transposes_per_step"]:.1f} / '
                  f'{base["transposes_per_step"]:.1f} '
                  f'({r["transposes_ms_per_step"]:.3f} / '
                  f'{base["transposes_ms_per_step"]:.3f} ms), own peak '
                  f'{r["own_peak_memory_bytes"] / 2**30:.3f} / '
                  f'{base["own_peak_memory_bytes"] / 2**30:.3f} GiB on {card}',
                  flush=True)
    return out


def write_aot_config(tmp):
    """Config 2 at phase 10's widths (nf=64, ndf=64, 7 classes, relu,
    dropout, softmax, tversky * 200, 256 px) as a train YAML."""
    path = os.path.join(tmp, 'aot.yaml')
    with open(path, 'w') as f:
        f.write(f"""dataset: {{type: COCOStuff, size: {SIZE},
          labels: {list(range(1, OUT_C + 1))}}}
model_params:
  generator: {{filters: {NF}, activation: relu, use_dropout: true,
              final_activation: softmax}}
  discriminator: {{filters: {NDF}, n_layers: 3}}
train_params: {{loss_type: tversky, seg_alpha: 200}}
""")
    return path


def aot_phase(torch, card, captured_peak):
    """``python -m patchgan_tpu_torch.cli.aot --shadow -d cuda`` at config
    2 (batch 16, bf16, the plain form in the Trainer's layout, with the
    generator's shadow as the Trainer runs it): fits, its peak within 10%
    of phase 10's captured step's own peak in the same layout
    (``captured_peak``), the JAX CLI's keys; then at batch 4096: does not
    fit, exit 0."""
    path = os.environ.get('PYTHONPATH')
    env = dict(os.environ, PYTHONPATH=ROOT + (os.pathsep + path if path
                                              else ''), PATCHGAN_S2D='off')
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cfg = write_aot_config(tmp)
        for batch in (TRAIN_B, 4096):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, '-m', 'patchgan_tpu_torch.cli.aot', '-c',
                 cfg, '--batch', str(batch), '--shadow', '-d', 'cuda'],
                cwd=tmp, env=env,
                capture_output=True, text=True, timeout=600)
            wall = time.perf_counter() - t0
            print(proc.stdout[-2000:], end='')
            if proc.returncode != 0:
                print(proc.stderr[-3000:])
                raise AssertionError(f'aot at batch {batch} exited '
                                     f'{proc.returncode}')
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            rec['wall_s'] = wall
            out[batch] = rec
    keys = ['metric', 'topology', 'device_kind', 'devices', 'mesh', 'batch',
            'size', 'dtype', 's2d', 'shadow', 'gen_filts', 'disc_filts',
            'compile_ok', 'cost', 'memory_per_device']
    fit, big = out[TRAIN_B], out[4096]
    peak = fit['memory_per_device']['peak_bytes']
    ratio = peak / captured_peak
    print(f'  aot at batch {TRAIN_B}: compile_ok {fit["compile_ok"]}, fits '
          f'{fit["memory_per_device"]["fits"]}, peak {peak} bytes = '
          f'{ratio:.3f} x phase 10\'s captured step ({captured_peak}), '
          f'{fit["cost"]["flops_per_device"] / 1e9:.1f} GFLOP a step, bound '
          f'{fit["cost"]["optimal_seconds"] * 1e3:.3f} ms '
          f'({fit["cost"]["img_per_s_ceiling"]:.1f} img/s); at batch 4096: '
          f'fits {big["memory_per_device"]["fits"]}; walls '
          f'{fit["wall_s"]:.1f} / {big["wall_s"]:.1f} s on {card}',
          flush=True)
    if list(fit) != keys + ['wall_s'] or fit['compile_ok'] is not True or \
            fit['memory_per_device']['fits'] is not True or \
            not 0.9 <= ratio <= 1.1 or \
            big['memory_per_device']['fits'] is not False:
        raise AssertionError(f'aot: {out}')
    return {'batch_16': fit, 'batch_4096': big, 'peak_ratio': ratio}


def infer_path_phase(torch, np, kernels, s2d, device='cuda'):
    """patchgan_infer -d ``device`` (every card, or one) on the four
    images under PATCHGAN_S2D=``s2d``; checks each mask and the launch
    counts per forward chunk. Returns (launches by kernel name, the
    model, masks)."""
    from patchgan_tpu_torch.cli.infer import patchgan_infer
    with tempfile.TemporaryDirectory() as tmp:
        cfg, sizes, model = write_inputs(tmp, torch, np)
        with in_dir(tmp):
            for k in kernels:
                k.wrapper.launches = 0
            t0 = time.perf_counter()
            with s2d_env(s2d):
                patchgan_infer(['-c', cfg, '-d', device])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {k.name: k.wrapper.launches for k in kernels}
        chunks = expected_chunks(sizes, torch.cuda.device_count()
                                 if device == 'cuda' else 1)
        print(f'  s2d {s2d}: wall {wall:.2f} s, {chunks} forward chunks, '
              f'launches {launches}', flush=True)
        want = dict(zip([k.name for k in kernels],
                        [chunks, 6 * chunks, 5 * chunks, 0,
                         chunks if s2d == 'on' else 0, 0]))
        if launches != want:
            raise AssertionError(f'launches {launches}, expected {want}')
        masks = []
        for i, (h, w) in enumerate(sizes):
            mask = np.load(os.path.join(tmp, 'masks', f'{i:03d}.npy'))
            if mask.shape != (h, w) or mask.min() < 0 or \
                    mask.max() >= OUT_C:
                raise AssertionError(f'mask {i}: shape {mask.shape}, '
                                     f'labels {mask.min()}..{mask.max()}')
            print(f'  mask {i}: {mask.shape}, {len(np.unique(mask))} '
                  f'labels', flush=True)
            masks.append(mask)
    return launches, model, masks


def masks_per_s(fns, label):
    """Masks/s of each of ``fns`` ({name: a call that returns one image's
    mask}) after three warm-up calls each: WINDOWS windows of at least
    WINDOW_S each, in turns (the order reversed every other window), every
    reading printed. Returns {name: readings}."""
    names = list(fns)
    for fn in fns.values():
        for _ in range(3):
            fn()
    readings = {name: [] for name in names}
    for i in range(WINDOWS):
        for name in (names if i % 2 == 0 else names[::-1]):
            count, t0 = 0, time.perf_counter()
            while True:
                fns[name]()
                count += 1
                dt = time.perf_counter() - t0
                if dt >= WINDOW_S:
                    break
            readings[name].append(count / dt)
            print(f'  {label} window {i} {name}: {count} masks in '
                  f'{dt:.3f} s, {count / dt:.3f} masks/s', flush=True)
    return readings


def infer_throughput_phase(torch, np, engines, card):
    """masks/s of the 1280x960 image, one image at a time, plain and s2d
    engine in turns; tiles/s of each form's forward at buckets 8 and
    32."""
    big = np.random.default_rng(2).random((960, 1280, IN_C),
                                          dtype=np.float32)
    readings = masks_per_s({f's2d {form}': (lambda e=eng: e.predict_image(
        big)) for form, eng in engines.items()}, '1280x960')
    out = {'card': card}
    for form in engines:
        r = readings[f's2d {form}']
        med = statistics.median(r)
        print(f'  1280x960 s2d {form}: median {med:.3f} masks/s (min '
              f'{min(r):.3f}, max {max(r):.3f}) over {WINDOWS} windows of '
              f'>= {WINDOW_S} s on {card}')
        out[form] = {'masks_per_s_1280x960': med, 'masks_per_s_windows': r,
                     'forward_ms': {}, 'tiles_per_s': {}}
    with torch.inference_mode():
        for bs in (8, 32):
            x = torch.rand(bs, IN_C, SIZE, SIZE, device='cuda')
            for form in ('off', 'on', 'on', 'off'):
                ms = cuda_ms(lambda: engines[form]._forward(x), iters=10,
                             warmup=2)
                out[form]['forward_ms'].setdefault(bs, []).append(ms)
            for form in ('off', 'on'):
                ms = min(out[form]['forward_ms'][bs])
                out[form]['tiles_per_s'][bs] = bs / ms * 1e3
                print(f'  forward bucket {bs}, s2d {form}: '
                      f'{out[form]["forward_ms"][bs]} ms, '
                      f'{out[form]["tiles_per_s"][bs]:.1f} tiles/s on '
                      f'{card}', flush=True)
    return out


def spatial_phase(torch, np, F, kernels, model, card):
    """Whole-image spatial mode with the nf=64 3 -> 7-class generator:
    the fp32 forward of a 640x480 image (padded to 640x512) on the card
    against the same model on the CPU (max |dprob| <= 1e-3, argmax masks
    equal on >= 99.9% of pixels, K1 / K2 / K3 1 / 6 / 5 launches); K1-K3
    at the 1280x960 image's shapes against their plain versions; that a
    mask's copy waits for its own image only; then masks/s of spatial and
    tiled mode (bf16, plain form) on the 1280x960 image, in turns. Returns
    (the bf16 spatial run's launches, the throughput readings)."""
    from patchgan_tpu_torch.inference import InferenceEngine
    wrappers = [k.wrapper for k in kernels]
    img = np.random.default_rng(12).random((480, 640, IN_C),
                                           dtype=np.float32)
    x = np.zeros((512, 640, IN_C), np.float32)
    x[:480] = img
    xt = torch.from_numpy(x).permute(2, 0, 1)[None].contiguous()
    model = model.to(torch.float32).eval()
    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = model(xt)                                  # plain path, CPU
    cpu_s = time.perf_counter() - t0
    with s2d_env('off'):
        eng32 = InferenceEngine(model, dtype=torch.float32)
        eng = InferenceEngine(model, dtype=torch.bfloat16)
    with torch.inference_mode():
        p32 = eng32.model(xt.cuda()).float().cpu()
    d32 = (p32 - ref).abs().max().item()
    for w in wrappers:
        w.launches = 0
    on = [w.launches_wgmma for w in wrappers[1:3]]
    mask = eng32.predict_image(img, mode='spatial')
    launches = [w.launches for w in wrappers]
    if [w.launches_wgmma for w in wrappers[1:3]] != on:
        raise AssertionError('fp32 spatial: the wgmma core launched')
    want = ref[0, :, :480].argmax(0).numpy()
    agree = float(np.mean(mask == want))
    print(f'  fp32 spatial 640x480 (padded 640x512): kernels vs plain on '
          f'the CPU ({cpu_s:.1f} s) max |dprob| {d32:.3e} (tol 1e-3); '
          f'argmax agreement {agree:.5f} (>= 0.999); mask {mask.shape} '
          f'{mask.dtype}; launches {launches}', flush=True)
    if not (d32 <= 1e-3 and agree >= 0.999 and mask.shape == (480, 640)
            and mask.dtype == np.int64 and launches == SPATIAL_IMAGE):
        raise AssertionError(f'spatial parity: {d32}, {agree}, '
                             f'{mask.shape} {mask.dtype}, {launches}')
    del eng32

    print(f'  K1-K3 at the shapes of one {SPATIAL_HW[1]}x{SPATIAL_HW[0]} '
          f'image (padded {SPATIAL_PAD[1]}x{SPATIAL_PAD[0]})', flush=True)
    with torch.inference_mode():
        kernel_phase(torch, F, kernels[:3], spatial=True)

    big = (np.random.default_rng(2).random(SPATIAL_HW + (IN_C,)) * 255) \
        .astype(np.uint8)
    small = big[:SIZE, :SIZE].copy()
    for w in wrappers:
        w.launches = 0
    on = [w.launches_wgmma for w in wrappers[1:3]]
    mask = eng.predict_image(big, mode='spatial')
    torch.cuda.synchronize()
    main_launches = [w.launches for w in wrappers]
    on = [w.launches_wgmma - b for w, b in zip(wrappers[1:3], on)]
    print(f'  bf16 spatial: K2 and K3 on the wgmma core {on} (expected '
          f'{SPATIAL_IMAGE[1:3]})', flush=True)
    if on != SPATIAL_IMAGE[1:3]:
        raise AssertionError(f'bf16 spatial: K2 / K3 on the wgmma core {on}')
    print(f'  bf16 spatial {SPATIAL_HW[1]}x{SPATIAL_HW[0]}: mask {mask.shape}'
          f' {mask.dtype}, labels {mask.min()}..{mask.max()}, launches '
          f'{main_launches}', flush=True)
    if main_launches != SPATIAL_IMAGE or mask.shape != SPATIAL_HW or \
            mask.min() < 0 or mask.max() >= OUT_C:
        raise AssertionError(f'bf16 spatial: {main_launches}, {mask.shape}')
    fetch_check(torch, eng, small, big)

    readings = masks_per_s(
        {mode: (lambda m=mode: eng.predict_image(big, mode=m))
         for mode in ('spatial', 'tiled')},
        f'{SPATIAL_HW[1]}x{SPATIAL_HW[0]}')
    out = {'card': card}
    for mode, r in readings.items():
        med = statistics.median(r)
        print(f'  {SPATIAL_HW[1]}x{SPATIAL_HW[0]} bf16 {mode}: median '
              f'{med:.3f} masks/s (min {min(r):.3f}, max {max(r):.3f}) over '
              f'{WINDOWS} windows of >= {WINDOW_S} s on {card}', flush=True)
        out[mode] = {'masks_per_s': med, 'masks_per_s_windows': r}
    return main_launches, out


def sleep_cycles_per_ms(torch):
    """Clock cycles of ``torch.cuda._sleep`` a millisecond on the card,
    timed by events."""
    cycles = 20_000_000
    torch.cuda._sleep(1000)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    return cycles / start.elapsed_time(end)


def fetch_check(torch, eng, small, big):
    """A mask's ``.result()`` waits for its own image only: image A (one
    small tiled image) is dispatched, then a wait on the card longer than
    twice B's host dispatch (timed in the warm-up) plus 50 ms, then four
    1280x960 tiled images (B), dispatched from a thread of their own
    while A's result is asked for: B's launches fill the card's queue
    behind the wait, so B's dispatch can last as long as the wait, and
    the result must come back while the wait still runs (a result that
    waited for the stream would wait for it). Events recorded after A,
    after the wait and after B show it."""
    for im in (small, big):      # warm the memory pools for both shapes
        eng.predict_image(im)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = eng.predict_images_async([big] * 4)
    dispatch_ms = (time.perf_counter() - t0) * 1e3
    for h in warm:
        h.result()
    wait_ms = 2 * dispatch_ms + 50
    cycles = int(wait_ms * sleep_cycles_per_ms(torch))
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    ev_a = torch.cuda.Event(enable_timing=True)
    ev_w = torch.cuda.Event(enable_timing=True)
    ev_b = torch.cuda.Event(enable_timing=True)
    start.record()
    a = eng.predict_image_async(small)
    ev_a.record()
    torch.cuda._sleep(cycles)
    ev_w.record()
    bs = []
    b_dispatch = threading.Thread(
        target=lambda: bs.extend(eng.predict_images_async([big] * 4)))
    b_dispatch.start()
    t0 = time.perf_counter()
    a.result()
    host_ms = (time.perf_counter() - t0) * 1e3
    a_done, w_done = ev_a.query(), ev_w.query()
    b_dispatch.join()
    ev_b.record()
    for h in bs:
        h.result()
    ev_b.synchronize()
    print(f'  per-image copy: a {wait_ms:.1f}-ms wait queued on the card '
          f'between A and B (B\'s host dispatch {dispatch_ms:.3f} ms in the '
          f'warm-up); A.result() returned after {host_ms:.3f} ms with A\'s '
          f'event done {a_done} and the wait\'s done {w_done}; on the card A '
          f'ended at {start.elapsed_time(ev_a):.3f} ms, the wait at '
          f'{start.elapsed_time(ev_w):.3f} ms, B at '
          f'{start.elapsed_time(ev_b):.3f} ms', flush=True)
    if w_done or len(bs) != 4:
        raise AssertionError('A\'s result waited for the work queued after '
                             'it (the wait, then B\'s forward)')


def write_serve_inputs(tmp, np, model):
    """The four inference images as files (1280x960 and 640x480 JPEG,
    256x256 and 200x150 PNG), smooth like photographs (a seeded coarse
    grid, bicubic-upsampled, plus a little noise), a corrupt .jpg beside
    them, the nf=64 generator's checkpoint, and serve configs for tiled
    and spatial mode. Returns (image dir, {name: (h, w)}, config path by
    mode, paths of the good images)."""
    import yaml
    from PIL import Image

    from patchgan_tpu_torch.utils.checkpoint import save_state_dict
    src = os.path.join(tmp, 'in')
    os.makedirs(src)
    rng = np.random.default_rng(13)
    sizes = {}
    for (h, w), ext in zip([(960, 1280), (480, 640), (256, 256),
                            (150, 200)], ('jpg', 'jpg', 'png', 'png')):
        coarse = (rng.random((h // 32 + 2, w // 32 + 2, IN_C)) * 255)
        im = Image.fromarray(coarse.astype(np.uint8)).resize(
            (w, h), Image.BICUBIC)
        arr = np.asarray(im, np.float32) + rng.normal(0, 4, (h, w, IN_C))
        name = f'{len(sizes):03d}.{ext}'
        Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(
            os.path.join(src, name), quality=90)
        sizes[name] = (h, w)
    with open(os.path.join(src, 'bad.jpg'), 'wb') as f:
        f.write(b'not a jpeg')
    ckpt = os.path.join(tmp, 'serve_generator.npz')
    save_state_dict(ckpt, model.state_dict())
    cfgs = {}
    for mode in ('tiled', 'spatial'):
        cfg = {'dataset': {'type': 'COCOStuff', 'size': SIZE,
                           'in_channels': IN_C, 'out_channels': OUT_C},
               'model_params': {'gen_filts': NF, 'activation': 'relu',
                                'final_activation': 'softmax'},
               'checkpoint_paths': {'generator': ckpt},
               'infer_params': {'output_path': os.path.join(tmp, mode),
                                'threshold': 0, 'overlap': 0.9,
                                'mode': mode}}
        cfgs[mode] = os.path.join(tmp, f'serve_{mode}.yaml')
        with open(cfgs[mode], 'w') as f:
            yaml.safe_dump(cfg, f)
    return src, sizes, cfgs, [os.path.join(src, n) for n in sizes]


def read_masks(np, out_dir, sizes):
    """The served PNG masks by image name; each must have its image's
    shape and labels < OUT_C."""
    from PIL import Image
    masks = {}
    for name, hw in sizes.items():
        path = os.path.join(out_dir, os.path.splitext(name)[0] + '.png')
        mask = np.asarray(Image.open(path))
        if mask.shape != hw or mask.dtype != np.uint8 or \
                mask.max() >= OUT_C:
            raise AssertionError(f'{path}: {mask.shape} {mask.dtype} '
                                 f'max {mask.max()}')
        masks[name] = mask
    return masks


def serve_phase(torch, np, kernels, model, card, tmp):
    """``patchgan_serve`` on the card (bf16) with the nf=64 generator:
    --watch --once (tiled, then --batch 4, then spatial mode), --stdin,
    --http in process (correctness, then load at --batch 0 and --batch 4
    in turns), the stitch's share of a 1280x960 tiled image, and the
    SIGTERM drain of a ``-d cuda`` subprocess under load. Returns
    (launches by path, the load readings, the --watch masks by image
    name)."""
    import yaml
    from PIL import Image

    from patchgan_tpu_torch.cli.serve import (_build_engine, _http_loop,
                                              _warmup, patchgan_serve)
    wrappers = [k.wrapper for k in kernels]
    names = [k.name for k in kernels]
    src, sizes, cfgs, good = write_serve_inputs(tmp, np, model)
    # the warmup forward is one 256 x 256 image of uint8 zeros
    warm = [(SIZE, SIZE)]

    def run(argv, stdin=None):
        for w in wrappers:
            w.launches = 0
        tee = Tee(sys.stdout)
        old = sys.stdin
        if stdin is not None:
            sys.stdin = io.StringIO(stdin)
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(tee):
                n = patchgan_serve(argv + ['-d', 'cuda'])
            torch.cuda.synchronize()
        finally:
            sys.stdin = old
        wall = time.perf_counter() - t0
        return n, [w.launches for w in wrappers], tee.getvalue(), wall

    # -d cuda: every card
    cards = torch.cuda.device_count()
    paths, masks = {}, {}
    for label, mode, extra, out_dir in (
            ('serve_watch', 'tiled', [], 'tiled'),
            ('serve_watch_batch4', 'tiled', ['--batch', '4'], 'tiled_b4'),
            ('serve_watch_spatial', 'spatial', [], 'spatial')):
        cfg = cfgs[mode]
        if out_dir != mode:     # the same config, another output folder
            with open(cfg) as f:
                doc = yaml.safe_load(f)
            doc['infer_params']['output_path'] = os.path.join(tmp, out_dir)
            cfg = os.path.join(tmp, f'serve_{out_dir}.yaml')
            with open(cfg, 'w') as f:
                yaml.safe_dump(doc, f)
        n, launches, out, wall = run(['-c', cfg, '--watch', src, '--once']
                                     + extra)
        if mode == 'tiled':
            want = per_chunk(expected_chunks(list(sizes.values()), cards,
                                             group=bool(extra))
                             + expected_chunks(warm, cards))
        else:
            want = [(len(sizes) + 1) * k for k in SPATIAL_IMAGE]
        print(f'  {label}: served {n} in {wall:.2f} s (warmup included), '
              f'launches {launches} (expected {want})', flush=True)
        if n != len(sizes) or launches != want or 'warmup:' not in out or \
                not any(line.startswith('ERROR') and 'bad.jpg' in line
                        for line in out.splitlines()):
            raise AssertionError(f'{label}: served {n}, launches '
                                 f'{launches}, output:\n{out}')
        if extra and 'batch 4' not in out:
            raise AssertionError(f'{label}: no group of 4 in\n{out}')
        masks[out_dir] = read_masks(np, os.path.join(tmp, out_dir), sizes)
        n, _, out, _ = run(['-c', cfg, '--watch', src, '--once',
                            '--no-warmup'])
        if n != 0:
            raise AssertionError(f'{label}: the second pass served {n}')
        paths[label] = dict(zip(names, launches))
    for name in sizes:
        if not np.array_equal(masks['tiled'][name],
                              masks['tiled_b4'][name]):
            raise AssertionError(f'{name}: --batch 4 mask differs')
    print('  watch: every mask of its image\'s shape, labels < 7; a second '
          'pass served 0; bad.jpg an ERROR; --batch 4 masks equal to '
          'unbatched', flush=True)

    lines = good[:2] + [os.path.join(src, 'missing.jpg')] + good[2:]
    n, launches, out, wall = run(['-c', cfgs['tiled'], '--stdin',
                                  '--no-warmup'],
                                 stdin='\n'.join(lines) + '\n')
    echoed = [line for line in out.splitlines()
              if line.startswith(('ERROR', tmp))]
    want = per_chunk(expected_chunks(list(sizes.values()), cards))
    print(f'  stdin: {echoed}, launches {launches} (expected {want}) in '
          f'{wall:.2f} s', flush=True)
    stems = [os.path.splitext(os.path.basename(p))[0] for p in lines]
    if len(echoed) != 5 or not echoed[2].startswith('ERROR') or \
            launches != want or any(
                not echoed[i].endswith(f'{stems[i]}.png')
                for i in (0, 1, 3, 4)):
        raise AssertionError(f'stdin output {echoed}, launches {launches}')
    paths['serve_stdin'] = dict(zip(names, launches))

    with open(cfgs['tiled']) as f:
        engine, _, _ = _build_engine(yaml.safe_load(f), torch.bfloat16,
                                     torch.device('cuda'))
    _warmup(engine, 'tiled', all_buckets=True)
    servers = {}
    for batch in (0, 4):
        ready = threading.Event()
        holder = {}

        def on_ready(server, holder=holder, ready=ready):
            holder['server'] = server
            ready.set()
        th = threading.Thread(target=_http_loop, args=(
            engine, 'tiled', '127.0.0.1:0'), kwargs={
            'server_ready': on_ready, 'batch': batch}, daemon=True)
        th.start()
        if not ready.wait(timeout=60):
            raise AssertionError(f'HTTP server --batch {batch} not up')
        host, port = holder['server'].server_address
        servers[batch] = (f'http://{host}:{port}', holder['server'], th)
    try:
        for batch, (base, _, _) in servers.items():
            status, _ = http_call(f'{base}/healthz')
            if status != 200:
                raise AssertionError(f'/healthz answered {status}')
            for w in wrappers:
                w.launches = 0
            for name in sizes:
                with open(os.path.join(src, name), 'rb') as f:
                    status, body = http_call(f'{base}/predict', f.read())
                got = np.asarray(Image.open(io.BytesIO(body)))
                if status != 200 or not np.array_equal(
                        got, masks['tiled'][name]):
                    raise AssertionError(f'--http --batch {batch} {name}: '
                                         f'{status}, not the watch mask')
            launches = [w.launches for w in wrappers]
            want = per_chunk(expected_chunks(list(sizes.values())))
            if launches != want:
                raise AssertionError(f'--http --batch {batch}: launches '
                                     f'{launches}, expected {want}')
            paths[f'serve_http_batch{batch}'] = dict(zip(names, launches))
            status, _ = http_call(f'{base}/predict', b'not an image')
            if status != 400:
                raise AssertionError(f'bad bytes answered {status}')
        print('  http: /healthz 200; every image\'s PNG equal to the mask '
              '--watch wrote, at --batch 0 and 4; bad bytes 400',
              flush=True)
        load = http_load(np, servers, src, card)
    finally:
        for _, server, th in servers.values():
            server.shutdown()
            th.join(timeout=30)
    load['stitch'] = stitch_share(torch, np, engine, src, card)
    load['request_split'] = request_split(np, engine, src, card)
    del engine
    load['sigterm'] = sigterm_drain(cfgs['tiled'], src)
    return paths, load, masks['tiled']


def http_call(url, body=None, timeout=120):
    """(status, body) of one GET, or POST when ``body`` is given."""
    import urllib.error
    import urllib.request
    req = urllib.request.Request(url, data=body,
                                 method='POST' if body else 'GET')
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


# the load clients of ``http_load``, in a process of their own so that
# they take none of the server's interpreter lock. argv: url, body file,
# clients, seconds. Each client posts the body in a loop until the
# seconds are up; prints one JSON line: (finish, latency) in seconds from
# the start of each answered request, and the count of failed ones
LOAD_CLIENT = r"""
import json, sys, threading, time, urllib.error, urllib.request
url, path, clients, secs = sys.argv[1], sys.argv[2], int(sys.argv[3]), \
    float(sys.argv[4])
with open(path, 'rb') as f:
    body = f.read()
lat, bad, lock = [], [], threading.Lock()
t0 = time.perf_counter()
def client():
    while time.perf_counter() < t0 + secs:
        s = time.perf_counter()
        try:
            req = urllib.request.Request(url, data=body, method='POST')
            with urllib.request.urlopen(req, timeout=120) as r:
                r.read()
                ok = r.status == 200
        except OSError:
            ok = False
        e = time.perf_counter()
        with lock:
            (lat if ok else bad).append((e - t0, e - s))
threads = [threading.Thread(target=client) for _ in range(clients)]
for t in threads:
    t.start()
for t in threads:
    t.join()
print(json.dumps({'lat': lat, 'bad': len(bad)}))
"""


def http_load(np, servers, src, card, clients=8):
    """requests/s and p50 / p95 latency of ``clients`` threads (in a
    process of their own, ``LOAD_CLIENT``) posting one image in a loop
    for a window of at least WINDOW_S, WINDOWS windows per server
    (--batch 0 and --batch 4 in turns); the 1280x960 JPEG, then the
    256x256 PNG."""
    out = {'card': card, 'clients': clients}
    for name, label in (('000.jpg', '1280x960 jpg'),
                        ('002.png', '256x256 png')):
        res = out[label] = {b: {'req_per_s': [], 'p50_ms': [], 'p95_ms': []}
                            for b in servers}
        order = list(servers)
        for i in range(WINDOWS):
            for batch in (order if i % 2 == 0 else order[::-1]):
                run = subprocess.run(
                    [sys.executable, '-c', LOAD_CLIENT,
                     f'{servers[batch][0]}/predict',
                     os.path.join(src, name), str(clients), str(WINDOW_S)],
                    capture_output=True, text=True, timeout=600)
                if run.returncode != 0:
                    raise AssertionError(f'load clients: {run.stderr}')
                doc = json.loads(run.stdout)
                lat = doc['lat']
                if doc['bad'] or not lat:
                    raise AssertionError(f'load {label} --batch {batch}: '
                                         f'{doc["bad"]} failed requests')
                dt = max(t for t, _ in lat)
                ms = np.array([d for _, d in lat]) * 1e3
                r = res[batch]
                r['req_per_s'].append(len(lat) / dt)
                r['p50_ms'].append(float(np.percentile(ms, 50)))
                r['p95_ms'].append(float(np.percentile(ms, 95)))
                print(f'  load {label} window {i} --batch {batch}: '
                      f'{len(lat)} requests in {dt:.3f} s, '
                      f'{len(lat) / dt:.3f} req/s, p50 {r["p50_ms"][-1]:.3f}'
                      f' ms, p95 {r["p95_ms"][-1]:.3f} ms', flush=True)
        for batch, r in res.items():
            print(f'  load {label} --batch {batch}, {clients} clients: '
                  f'median {statistics.median(r["req_per_s"]):.3f} req/s, '
                  f'p50 {statistics.median(r["p50_ms"]):.3f} ms, p95 '
                  f'{statistics.median(r["p95_ms"]):.3f} ms on {card}',
                  flush=True)
    return out


def stitch_share(torch, np, engine, src, card, runs=20):
    """The 1280x960 tiled image's pipeline (upload, gather, forward
    chunks, stitch, argmax, copy back, crop) by the host's clock, against
    its forward chunks alone (CUDA events around the same chunks on
    resident tiles): the rest is the stitch's share."""
    from PIL import Image

    from patchgan_tpu_torch.inference.engine import _pick_bucket
    from patchgan_tpu_torch.inference.tiling import crop_positions
    with Image.open(os.path.join(src, '000.jpg')) as im:
        big = np.asarray(im.convert('RGB'), np.uint8)
    n = len(crop_positions(*big.shape[:2], SIZE, 0.9))
    bs = _pick_bucket(n, engine.batch_size)
    chunks = -(-n // bs)
    walls = []
    for _ in range(runs + 3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.predict_image(big)
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls[3:])
    x = torch.rand(bs, IN_C, SIZE, SIZE, device='cuda')
    with torch.inference_mode():
        fwd = cuda_ms(lambda: [engine._forward(x) for _ in range(chunks)],
                      iters=10)
    print(f'  stitch share, 1280x960 tiled bf16: {n} tiles in {chunks} '
          f'chunk(s) of {bs}; pipeline {wall:.3f} ms (median of {runs}), '
          f'forward chunks {fwd:.3f} ms, the rest {wall - fwd:.3f} ms = '
          f'{100 * (wall - fwd) / wall:.1f}% on {card}', flush=True)
    return {'tiles': n, 'bucket': bs, 'chunks': chunks, 'pipeline_ms': wall,
            'forward_ms': fwd, 'rest_ms': wall - fwd,
            'rest_share': (wall - fwd) / wall}


def request_split(np, engine, src, card, runs=20):
    """Where one request's host time goes, one request at a time: the
    decode of the posted bytes (PIL), the dispatch (until
    ``predict_image_async`` returns), the wait for the mask (``.result()``)
    and the PNG encode; medians of ``runs`` after two warm-ups, for the
    1280x960 JPEG and the 256x256 PNG. The random weights give a mask of
    near noise, which PNG compresses slowly; ``encode_smooth`` encodes a
    7-label map of the same size cut from the smooth input image, as a
    trained model's mask would be more nearly."""
    from PIL import Image

    from patchgan_tpu_torch.cli.serve import _encode_mask_png
    out = {}
    for name, label in (('000.jpg', '1280x960 jpg'),
                        ('002.png', '256x256 png')):
        with open(os.path.join(src, name), 'rb') as f:
            body = f.read()
        parts = {'decode': [], 'dispatch': [], 'wait': [], 'encode': [],
                 'encode_smooth': []}
        for i in range(runs + 2):
            t0 = time.perf_counter()
            with Image.open(io.BytesIO(body)) as im:
                image = np.asarray(im.convert('RGB'), np.uint8)
            t1 = time.perf_counter()
            handle = engine.predict_image_async(image)
            t2 = time.perf_counter()
            mask = handle.result()
            t3 = time.perf_counter()
            _encode_mask_png(mask)
            t4 = time.perf_counter()
            _encode_mask_png(image.sum(-1, dtype=np.int32) * OUT_C // 766)
            t5 = time.perf_counter()
            if i >= 2:
                for key, a, b in (('decode', t0, t1), ('dispatch', t1, t2),
                                  ('wait', t2, t3), ('encode', t3, t4),
                                  ('encode_smooth', t4, t5)):
                    parts[key].append((b - a) * 1e3)
        out[label] = {k: statistics.median(v) for k, v in parts.items()}
        print(f'  one request at a time, {label} ({len(body)} B): '
              + ', '.join(f'{k} {v:.3f} ms' for k, v in out[label].items())
              + f' (medians of {runs}) on {card}', flush=True)
    return out


def sigterm_drain(cfg, src, clients=4):
    """``python -m patchgan_tpu_torch.cli.serve --http ... -d cuda`` as a
    subprocess: ``clients`` requests of the 1280x960 JPEG are sent, and
    SIGTERM goes out once all are sent and half answered; every request
    must be answered 200 and the process exit 0. ``clients`` stays within
    the server's listen backlog (``ThreadingHTTPServer``'s
    request_queue_size, 5), so every connection is accepted before the
    signal: a connection beyond it whose handshake the kernel has not
    completed is never accepted and is reset when the server closes,
    which is no request in flight."""
    import http.client
    import queue
    import signal
    proc = subprocess.Popen(
        [sys.executable, '-m', 'patchgan_tpu_torch.cli.serve', '-c', cfg,
         '--http', '127.0.0.1:0', '-d', 'cuda'], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        lines = queue.Queue()

        def reader():
            for line in proc.stdout:
                lines.put(line)
            lines.put(None)
        threading.Thread(target=reader, daemon=True).start()
        out, port = [], None
        t0 = time.perf_counter()
        while port is None:
            line = lines.get(timeout=300)
            if line is None:
                raise AssertionError('serve exited:\n' + ''.join(out))
            out.append(line)
            if 'HTTP serving on' in line:
                port = int(line.split()[3].rsplit(':', 1)[1])
        up_s = time.perf_counter() - t0
        with open(os.path.join(src, '000.jpg'), 'rb') as f:
            body = f.read()
        sent, answered = threading.Semaphore(0), threading.Semaphore(0)
        status = {}

        def client(i):
            conn = http.client.HTTPConnection('127.0.0.1', port, timeout=300)
            try:
                try:
                    conn.request('POST', '/predict', body)
                finally:
                    sent.release()
                status[i] = conn.getresponse().status
            except OSError as e:
                status[i] = repr(e)
            finally:
                conn.close()
                answered.release()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(clients)]
        for t in threads:
            t.start()
        # every request is on the wire before any wait for answers
        for sem, n in ((sent, clients), (answered, clients // 2)):
            for _ in range(n):
                if not sem.acquire(timeout=300):
                    raise AssertionError('SIGTERM drain: a request was '
                                         'not sent or answered in 300 s')
        in_flight = clients - len(status)
        proc.send_signal(signal.SIGTERM)
        for t in threads:
            t.join(timeout=300)
        rc = proc.wait(timeout=300)
        while (line := lines.get(timeout=60)) is not None:
            out.append(line)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
    ok = sum(s == 200 for s in status.values())
    print(f'  SIGTERM drain: the server up in {up_s:.1f} s (warmup '
          f'included); signalled with {in_flight} of {clients} requests in '
          f'flight; {ok} answered 200; exit code {rc}', flush=True)
    if ok != clients or rc != 0 or in_flight < 1 or \
            'draining in-flight requests' not in ''.join(out):
        raise AssertionError(f'SIGTERM drain: statuses {status}, rc {rc}, '
                             f'output:\n{"".join(out)}')
    return {'clients': clients, 'in_flight_at_signal': in_flight,
            'answered_200': ok, 'exit_code': rc}


# phase 13: the input pipeline and exact resume. A COCO-Stuff layout of
# PIPE_N smooth PIPE_HW JPEGs with 7-label PNG masks (PIPE_VAL for
# validation), the training pairs also as PIPE_SHARDS tar shards
PIPE_N, PIPE_VAL, PIPE_SHARDS, PIPE_HW = 256, 16, 4, (480, 640)
PIPE_TURNS = 2        # loader-rate readings per configuration, in turns
RESUME_N = 64         # training pairs of the exact-resume runs
# the loader-rate configurations: (DataLoader kwargs, PATCHGAN_NATIVE_IO,
# dataset); each has its patchgan_train form in pipeline_config
LOADERS = {
    'thread x4 PIL': ({'num_workers': 4}, 'off', 'folder'),
    'thread x4 native': ({'num_workers': 4}, 'on', 'folder'),
    'process x4': ({'num_workers': 4, 'worker_type': 'process'}, 'on',
                   'folder'),
    'thread x4 cache': ({'num_workers': 4, 'cache': True}, 'on', 'folder'),
    'TarShards thread x4': ({'num_workers': 4}, 'on', 'shards'),
}


@contextlib.contextmanager
def env_var(name, value):
    """``name`` set to ``value`` for the block."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name)
        else:
            os.environ[name] = old


@contextlib.contextmanager
def cudnn_flags_kept(torch):
    """cuDNN's deterministic and benchmark flags as they were before the
    block (``--deterministic`` sets them in this process)."""
    b = torch.backends.cudnn
    old = b.deterministic, b.benchmark
    try:
        yield
    finally:
        b.deterministic, b.benchmark = old


def write_pipeline_inputs(tmp, np):
    """The pairs in ``tmp``: train/{images,masks}, val/{images,masks},
    resume/{images,masks} (the first RESUME_N training pairs),
    shards/shard-{0..3}.tar (the training pairs in sorted order, an
    equal run each) and val_shards/val.tar (the validation pairs).
    Images are smooth like photographs (a seeded coarse grid,
    bicubic-upsampled, plus a little noise), masks 7 labels on a coarse
    grid, NEAREST-upsampled."""
    import tarfile

    from PIL import Image
    h, w = PIPE_HW
    rng = np.random.default_rng(14)
    noise = rng.normal(0, 4, (h + 32, w + 32, IN_C)).astype(np.float32)
    for split, n in (('train', PIPE_N), ('val', PIPE_VAL)):
        for sub in ('images', 'masks'):
            os.makedirs(os.path.join(tmp, split, sub))
        for i in range(n):
            coarse = rng.random((h // 32 + 2, w // 32 + 2, IN_C)) * 255
            im = Image.fromarray(coarse.astype(np.uint8)).resize(
                (w, h), Image.BICUBIC)
            dy, dx = rng.integers(0, 32, 2)
            arr = np.asarray(im, np.float32) + noise[dy:dy + h, dx:dx + w]
            Image.fromarray(np.clip(arr, 0, 255).astype(np.uint8)).save(
                os.path.join(tmp, split, 'images', f'{i:012d}.jpg'),
                quality=90)
            labels = rng.integers(0, OUT_C, (h // 40, w // 40), np.uint8)
            Image.fromarray(labels, mode='L').resize(
                (w, h), Image.NEAREST).save(
                os.path.join(tmp, split, 'masks', f'{i:012d}.png'))
    for sub in ('images', 'masks'):
        os.makedirs(os.path.join(tmp, 'resume', sub))
        ext = 'jpg' if sub == 'images' else 'png'
        for i in range(RESUME_N):
            os.link(os.path.join(tmp, 'train', sub, f'{i:012d}.{ext}'),
                    os.path.join(tmp, 'resume', sub, f'{i:012d}.{ext}'))
    per = PIPE_N // PIPE_SHARDS
    tars = [('train', f'shards/shard-{si}.tar', range(si * per, (si + 1) * per))
            for si in range(PIPE_SHARDS)]
    tars.append(('val', 'val_shards/val.tar', range(PIPE_VAL)))
    for split, name, ids in tars:
        os.makedirs(os.path.dirname(os.path.join(tmp, name)), exist_ok=True)
        with tarfile.open(os.path.join(tmp, name), 'w') as tf:
            for i in ids:
                for sub, ext in (('images', 'jpg'), ('masks', 'png')):
                    tf.add(os.path.join(tmp, split, sub, f'{i:012d}.{ext}'),
                           arcname=f'{i:012d}.{ext}')


def pipeline_config(tmp, name, data='folder', cache=False, train='train',
                    ck=None, **train_params):
    """A patchgan_train config at BASELINE.json config 2's widths (nf=64,
    ndf=64, 256 px, 7 classes, relu / softmax, tversky * 200 + BCE,
    'randomcrop+flip') on the phase's folder (``train``) or shards;
    returns its path."""
    import yaml
    images = os.path.join(tmp, 'shards', 'shard-*.tar') \
        if data == 'shards' else os.path.join(tmp, train, 'images')
    masks = None if data == 'shards' else os.path.join(tmp, train, 'masks')
    cfg = {
        'dataset': {'type': 'TarShards' if data == 'shards' else 'COCOStuff',
                    'size': SIZE, 'labels': list(range(1, OUT_C + 1)),
                    'augmentation': 'randomcrop+flip', 'cache': cache,
                    'train_data': {'images': images, 'masks': masks},
                    'validation_data': {
                        'images': os.path.join(tmp, 'val', 'images'),
                        'masks': os.path.join(tmp, 'val', 'masks')}},
        'model_params': {'generator': {'filters': NF, 'activation': 'relu',
                                       'final_activation': 'softmax',
                                       'use_dropout': True},
                         'discriminator': {'filters': NDF, 'n_layers': 3}},
        'checkpoint_path': os.path.join(tmp, ck or f'ck_{name}'),
        'train_params': {'loss_type': 'tversky', 'seg_alpha': 200,
                         'gen_learning_rate': 1e-3,
                         'disc_learning_rate': 1e-3, 'decay_rate': 0.5,
                         'save_freq': 1, **train_params},
    }
    if data == 'shards':
        cfg['dataset']['validation_data'] = {
            'images': os.path.join(tmp, 'val_shards', 'val.tar'),
            'masks': None}
    path = os.path.join(tmp, f'{name}.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    return path


def epoch_lines(out):
    """(images, seconds) of each training epoch's " N images in Xs" line."""
    got = []
    for line in out.splitlines():
        if ' images in ' in line:
            n, rest = line.strip().split(' images in ')
            got.append((int(n), float(rest.split('s')[0])))
    return got


def run_train(torch, wrappers, args, env=None):
    """patchgan_train in this process with ``args`` (+ -d cuda, no
    summary), the counts set to 0 before; (output, launches, wall s,
    the Trainers' graph counts)."""
    from patchgan_tpu_torch.cli.train import patchgan_train
    for w in wrappers:
        w.launches = 0
    tee = Tee(sys.stdout)
    with contextlib.ExitStack() as stack:
        for k, v in (env or {}).items():
            stack.enter_context(env_var(k, v))
        stack.enter_context(s2d_env('off'))
        stack.enter_context(contextlib.redirect_stdout(tee))
        counts = stack.enter_context(graph_counts())
        t0 = time.perf_counter()
        patchgan_train(args + ['-d', 'cuda', '--no-summary'])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return tee.getvalue(), [w.launches for w in wrappers], wall, \
        tuple(counts)


def npz_equal(np, a, b):
    """(equal bits, max |a - b|) over the arrays of two npz files."""
    with np.load(a) as fa, np.load(b) as fb:
        if sorted(fa.files) != sorted(fb.files):
            raise AssertionError(f'{a} and {b} hold other keys')
        diffs = [float(np.max(np.abs(fa[k].astype(np.float64)
                                     - fb[k].astype(np.float64))))
                 for k in fa.files]
        same = all(np.array_equal(fa[k], fb[k]) for k in fa.files)
    return same, max(diffs)


def weights_diff(np, ck_a, ck_b, epoch):
    """equal bits and max |diff| over both models' files of ``epoch``."""
    same, diff = True, 0.0
    for prefix in ('generator', 'discriminator'):
        name = f'{prefix}_ep_{epoch:03d}.npz'
        s, d = npz_equal(np, os.path.join(ck_a, name),
                         os.path.join(ck_b, name))
        same, diff = same and s, max(diff, d)
    return same, diff


def decoder_phase(np, tmp, native_built):
    """Host ms per pair of the COCO reader's uint8 decode at 256 px: the
    native library (where it built) and PIL (PATCHGAN_NATIVE_IO=off), 32
    pairs each, two turns."""
    from patchgan_tpu_torch.data import COCOStuffDataset
    ds = COCOStuffDataset(os.path.join(tmp, 'train', 'images'),
                          os.path.join(tmp, 'train', 'masks'),
                          labels=list(range(1, OUT_C + 1)), size=SIZE,
                          augmentation='randomcrop+flip')
    ms = {'native': [], 'PIL': []} if native_built else {'PIL': []}
    for turn in range(2):
        for name in list(ms)[::1 - 2 * turn]:
            with env_var('PATCHGAN_NATIVE_IO',
                         'on' if name == 'native' else 'off'):
                t0 = time.perf_counter()
                for i in range(32):
                    img, mask = ds.load_raw_u8(i)
                ms[name].append((time.perf_counter() - t0) * 1e3 / 32)
            if img.shape != (SIZE, SIZE, IN_C) or mask.max() >= OUT_C:
                raise AssertionError(f'decode {img.shape} {mask.max()}')
    return {k: statistics.median(v) for k, v in ms.items()}, ms


def loader_rate_phase(torch, tmp, card):
    """images/s of each ``LOADERS`` configuration alone: batch 16, bf16,
    'randomcrop+flip', batches landed on the card, one synchronize per
    epoch of PIPE_N images; a warm-up epoch each (it fills the cache and
    starts the process pool), then PIPE_TURNS epochs each in turns. The
    cached configuration counts its decoder's calls after the warm-up:
    none."""
    from patchgan_tpu_torch.data import (COCOStuffDataset, DataLoader,
                                         TarShardDataset)

    class Counting(COCOStuffDataset):
        decodes = 0

        def load_raw_u8(self, index):
            Counting.decodes += 1
            return super().load_raw_u8(index)

    kw = dict(labels=list(range(1, OUT_C + 1)), size=SIZE,
              augmentation='randomcrop+flip')
    folder = (os.path.join(tmp, 'train', 'images'),
              os.path.join(tmp, 'train', 'masks'))
    loaders = {}
    for name, (opts, _, data) in LOADERS.items():
        if data == 'shards':
            ds = TarShardDataset(os.path.join(tmp, 'shards', 'shard-*.tar'),
                                 **kw)
        elif opts.get('cache'):
            ds = Counting(*folder, **kw)
        else:
            ds = COCOStuffDataset(*folder, **kw)
        loaders[name] = DataLoader(ds, batch_size=TRAIN_B, device='cuda',
                                   dtype=torch.bfloat16, seed=0, **opts)

    def epoch(name):
        with env_var('PATCHGAN_NATIVE_IO', LOADERS[name][1]):
            t0 = time.perf_counter()
            n = 0
            for x, y in loaders[name]:
                n += x.shape[0]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        if n != PIPE_N or x.dtype != torch.bfloat16 or \
                x.shape[1:] != (IN_C, SIZE, SIZE) or \
                not bool((y.float().sum(1) == 1).all()):
            raise AssertionError(f'{name}: {n} images, {x.shape} {x.dtype}')
        return n / dt

    try:
        for name in LOADERS:
            epoch(name)
        Counting.decodes = 0
        rates = {name: [] for name in LOADERS}
        names = list(LOADERS)
        for turn in range(PIPE_TURNS):
            for name in (names if turn % 2 == 0 else names[::-1]):
                rates[name].append(epoch(name))
                print(f'  turn {turn} {name}: {rates[name][-1]:.3f} '
                      f'images/s', flush=True)
    finally:
        for loader in loaders.values():
            loader.close()
    if Counting.decodes:
        raise AssertionError(f'the cached loader decoded {Counting.decodes} '
                             f'pairs after its first epoch')
    medians = {k: statistics.median(v) for k, v in rates.items()}
    for name, v in rates.items():
        print(f'  loader {name}: median {medians[name]:.3f} images/s '
              f'(readings {[round(r, 3) for r in v]}) on {card}',
              flush=True)
    return medians, rates


def process_tree(pid):
    """``pid`` and its descendants, from /proc: a launcher's workers may
    sit in sessions of their own, out of reach of its process group."""
    children = {}
    for entry in os.listdir('/proc'):
        if entry.isdigit():
            try:
                with open(f'/proc/{entry}/stat') as f:
                    ppid = int(f.read().rsplit(')', 1)[1].split()[1])
            except (OSError, IndexError, ValueError):
                continue
            children.setdefault(ppid, []).append(int(entry))
    tree, todo = [], [pid]
    while todo:
        p = todo.pop()
        tree.append(p)
        todo += children.get(p, [])
    return tree


def signal_tree(pids, sig):
    for p in pids:
        try:
            os.kill(p, sig)
        except ProcessLookupError:
            pass


def kill_at(cmd, cwd, env, meta_path, target, log, timeout=300):
    """Run ``cmd`` and SIGKILL it and every process it started once
    ``meta_path`` (the rolling metadata) shows (epoch, batches_done) ==
    ``target``: SIGSTOP first, then the metadata read again, then
    SIGKILL. Returns the metadata it was killed at."""
    import signal
    proc = subprocess.Popen(cmd, cwd=cwd, env=env, stdout=log,
                            stderr=subprocess.STDOUT)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < timeout:
            if proc.poll() is not None:
                raise AssertionError(f'{cmd} exited {proc.returncode} before '
                                     f'its metadata showed {target}')
            try:
                with open(meta_path) as f:
                    meta = json.load(f)
            except (OSError, ValueError):
                meta = None
            if meta and (meta['epoch'], meta['batches_done']) == target:
                tree = process_tree(proc.pid)
                signal_tree(tree, signal.SIGSTOP)
                with open(meta_path) as f:
                    meta = json.load(f)
                signal_tree(tree, signal.SIGKILL)
                proc.wait()
                return meta
            time.sleep(0.005)
        raise AssertionError(f'{cmd} did not reach {target} in {timeout} s')
    finally:
        if proc.poll() is None:
            signal_tree(process_tree(proc.pid), signal.SIGKILL)
            proc.wait()


def resume_phase(torch, np, tmp, card):
    """Exact resume on the card (use_dropout, accumulate_steps 2, 2
    epochs of RESUME_N images, ``--deterministic``), every run
    ``patchgan_train -d cuda`` in a process of its own (``train_child``,
    which prints the Trainer's graph counts when the run ends): two
    uninterrupted runs (the control, beside the first cut run on the same
    card), then a run with save_every_steps 1 killed once its rolling
    metadata shows epoch 2 with 1 batch done (inside an accumulation
    window), resumed and killed again at 3 batches done (a resume of a
    resumed run), and resumed to the end. The epoch files must equal the
    control's bits, or differ by no more than the two controls do. Phase
    18a runs beside them (``dcp_resume``). Then the ms of one rolling save
    at config 2, and of the async store's."""
    path = os.environ.get('PYTHONPATH')
    env = dict(os.environ, PYTHONPATH=ROOT + (os.pathsep + path if path
                                              else ''))

    def cmd(cfg, child='train_child'):
        return [sys.executable, '-c',
                f'import chip_smoke; chip_smoke.{child}()', '-c', cfg,
                '-d', 'cuda', '--no-summary', '-n', '2', '-b', str(TRAIN_B),
                '--deterministic']

    cfg = pipeline_config(tmp, 'cut', train='resume', accumulate_steps=2,
                          save_every_steps=1)
    ck = os.path.join(tmp, 'ck_cut')
    meta_path = os.path.join(ck, 'step_state_torch.json')
    cuts, controls = [], {}
    log_path = os.path.join(tmp, 'resume.log')
    t0 = time.perf_counter()
    dcp, dcp_cfg = {}, pipeline_config(tmp, 'dcp', train='resume',
                                       accumulate_steps=2,
                                       save_every_steps=1)
    beside = threading.Thread(target=dcp_resume, args=(
        tmp, env, dcp_cfg, cmd(dcp_cfg, 'dcp_train_child'), dcp))
    beside.start()
    try:
        with open(log_path, 'w') as log:
            for name in ('ctl_a', 'ctl_b'):
                controls[name] = subprocess.Popen(
                    cmd(pipeline_config(tmp, name, train='resume',
                                        accumulate_steps=2)),
                    cwd=tmp, env=env, stdout=log, stderr=subprocess.STDOUT)
            cuts.append(kill_at(cmd(cfg), tmp, env, meta_path, (2, 1), log))
            with open(cfg, 'a') as f:
                f.write('load_last_checkpoint: true\n')
            cuts.append(kill_at(cmd(cfg), tmp, env, meta_path, (2, 3), log))
            rc = subprocess.run(cmd(cfg), cwd=tmp, env=env, stdout=log,
                                stderr=subprocess.STDOUT).returncode
            rcs = [p.wait() for p in controls.values()]
    except AssertionError:
        with open(log_path) as f:
            print(f.read()[-4000:])
        raise
    finally:
        for p in controls.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        beside.join()
    wall = time.perf_counter() - t0
    with open(log_path) as f:
        log_text = f.read()
    # the processes that ended: the two controls (8 micro-steps each: an
    # eager step and a capture per window position, then replays) and
    # the last resumed one, in the order they ended (a progress bar may
    # share the line)
    counts = re.findall(r'graph counts (\(\d+, \d+, \d+\))', log_text)
    if rc != 0 or rcs != [0, 0] or any(
            f'Found mid-epoch checkpoint: epoch 2, {n} batches done'
            not in log_text for n in (1, 3)) or len(counts) != 3 or \
            counts.count('(2, 2, 6)') < 2:
        print(log_text[-3000:])
        raise AssertionError(f'the resumed runs: rc {rc}, controls {rcs}, '
                             f'graph counts {counts}')
    ctl_same, ctl_diff = weights_diff(np, os.path.join(tmp, 'ck_ctl_a'),
                                      os.path.join(tmp, 'ck_ctl_b'), 2)
    results = {epoch: weights_diff(np, os.path.join(tmp, 'ck_ctl_a'), ck,
                                   epoch) for epoch in (1, 2)}
    same, diff = results[2]
    print(f'  control: two uninterrupted runs, epoch-2 weights equal bits '
          f'{ctl_same}, max |diff| {ctl_diff:.3e}; cut at '
          f'{[(m["epoch"], m["batches_done"]) for m in cuts]} (accumulate '
          f'2: the window open), resumed twice; epoch-1 weights equal bits '
          f'{results[1][0]} (max |diff| {results[1][1]:.3e}), epoch-2 equal '
          f'bits {same} (max |diff| {diff:.3e}); eager steps / captures / '
          f'replays of the processes that ended {counts}; the five runs '
          f'took {wall:.3f} s', flush=True)
    if not all(s or d <= ctl_diff for s, d in results.values()):
        raise AssertionError(f'the resumed run differs from the control by '
                             f'{results} (control {ctl_diff})')
    store = dcp_check(np, tmp, dcp, ctl_diff)
    for name in ('ck_cut', 'ck_ctl_a', 'ck_ctl_b', 'ck_dcp'):
        shutil.rmtree(os.path.join(tmp, name))

    # one rolling save at config 2 (bf16 moments, an accumulator)
    from patchgan_tpu_torch.models import Discriminator, UNet
    from patchgan_tpu_torch.train import Trainer
    init = torch.Generator().manual_seed(3)
    gen = UNet(IN_C, OUT_C, nf=NF, use_dropout=True, activation='relu',
               final_act='softmax', dtype=torch.bfloat16, generator=init)
    disc = Discriminator(IN_C + OUT_C, ndf=NDF, n_layers=3,
                         dtype=torch.bfloat16, generator=init)
    trainer = Trainer(gen, disc, os.path.join(tmp, 'ck_save'), device='cuda')
    trainer.adam_mu_dtype, trainer.accumulate_steps = torch.bfloat16, 2
    trainer._make_optimizers(1e-3, 1e-3)
    save_ms = []
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer._save_step_state(1, i + 1)
        save_ms.append((time.perf_counter() - t0) * 1e3)
    nbytes = os.path.getsize(os.path.join(tmp, 'ck_save',
                                          'training_state_step_a.pt'))
    print(f'  one rolling save at config 2: {[round(m, 3) for m in save_ms]} '
          f'ms, {nbytes} bytes, on {card}', flush=True)
    store.update(store_save_ms(torch, trainer, tmp, card, save_ms))
    del trainer, gen, disc
    shutil.rmtree(os.path.join(tmp, 'ck_save'))
    return {'control_equal_bits': ctl_same, 'control_max_abs_diff': ctl_diff,
            'phase_18a': store,
            'resumed_equal_bits': same, 'resumed_max_abs_diff': diff,
            'cuts': [(m['epoch'], m['batches_done']) for m in cuts],
            'graph_counts': counts, 'runs_wall_s': wall,
            'rolling_save_ms': statistics.median(save_ms),
            'rolling_save_ms_readings': save_ms,
            'rolling_save_bytes': nbytes}


def dcp_resume(tmp, env, cfg, cmd, out):
    """Phase 18a's runs, in a thread beside phase 13's: ``cmd`` (a
    ``dcp_train_child`` run of config ``cfg``, save_every_steps 1)
    SIGKILLed when its rolling metadata shows epoch 2 with 1 batch done,
    then resumed to the end. Fills ``out`` (the metadata it was killed
    at, the resumed run's exit code, the wall s, or the error)."""
    meta_path = os.path.join(tmp, 'ck_dcp', 'step_state_torch.json')
    t0 = time.perf_counter()
    try:
        with open(os.path.join(tmp, 'dcp.log'), 'w') as log:
            out['cut'] = kill_at(cmd, tmp, env, meta_path, (2, 1), log)
            with open(cfg, 'a') as f:
                f.write('load_last_checkpoint: true\n')
            out['rc'] = subprocess.run(cmd, cwd=tmp, env=env, stdout=log,
                                       stderr=subprocess.STDOUT,
                                       timeout=300).returncode
    except Exception as e:   # raised in dcp_check
        out['error'] = e
    out['wall_s'] = time.perf_counter() - t0


def dcp_check(np, tmp, out, ctl_diff):
    """Phase 18a's verdict: the cut was at a ``.dcp`` slot, the resumed
    run took it up and ended, and its epoch files equal phase 13's first
    control's bits or differ by no more than the two controls do."""
    with open(os.path.join(tmp, 'dcp.log')) as f:
        text = f.read()
    if 'error' in out:
        print(text[-3000:])
        raise AssertionError(f'18a: {out["error"]!r}')
    ck = os.path.join(tmp, 'ck_dcp')
    counts = re.findall(r'graph counts (\(\d+, \d+, \d+\))', text)
    slots = sorted(f for f in os.listdir(ck) if f.endswith('.dcp'))
    if out['rc'] != 0 or not out['cut']['state'].endswith('.dcp') or \
            'Found mid-epoch checkpoint: epoch 2, 1 batches done' \
            not in text or slots != ['training_state_step_a.dcp',
                                     'training_state_step_b.dcp']:
        print(text[-3000:])
        raise AssertionError(f'18a: rc {out["rc"]}, cut {out["cut"]}, '
                             f'slots {slots}')
    results = {epoch: weights_diff(np, os.path.join(tmp, 'ck_ctl_a'), ck,
                                   epoch) for epoch in (1, 2)}
    print(f'  18a: the async store (.dcp slots), cut at '
          f'{(out["cut"]["epoch"], out["cut"]["batches_done"])} '
          f'({out["cut"]["state"]}) and resumed: epoch-1 weights equal to '
          f'the control bits {results[1][0]} (max |diff| '
          f'{results[1][1]:.3e}), epoch-2 {results[2][0]} (max |diff| '
          f'{results[2][1]:.3e}; the two controls {ctl_diff:.3e}); the '
          f'resumed run\'s graph counts {counts}; both runs took '
          f'{out["wall_s"]:.3f} s beside phase 13\'s', flush=True)
    if not all(s or d <= ctl_diff for s, d in results.values()):
        raise AssertionError(f'18a: the resumed run differs from the '
                             f'control by {results} (control {ctl_diff})')
    return {'cut': (out['cut']['epoch'], out['cut']['batches_done']),
            'equal_bits': results[2][0], 'max_abs_diff': results[2][1],
            'epoch_1_equal_bits': results[1][0], 'graph_counts': counts,
            'runs_wall_s': out['wall_s']}


def store_save_ms(torch, trainer, tmp, card, pt_ms):
    """Three saves of ``trainer``'s state (config 2) through the async
    store into the rolling slots, in turns: the ms ``save_async`` holds
    the host (it queues the copies on the card) and the ms from the call
    until ``wait()`` returns; the first import of
    ``torch.distributed.checkpoint``, which the first save of a process
    pays, timed on its own before them."""
    from patchgan_tpu_torch.utils import orbax_ckpt
    t0 = time.perf_counter()
    import torch.distributed.checkpoint  # noqa: F401
    import_ms = (time.perf_counter() - t0) * 1e3
    hold, commit = [], []
    for i in range(3):
        path = os.path.join(tmp, 'ck_save',
                            f'training_state_step_{"ab"[i % 2]}.dcp')
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        orbax_ckpt.save_async(path, trainer.training_state())
        t1 = time.perf_counter()
        orbax_ckpt.wait()
        hold.append((t1 - t0) * 1e3)
        commit.append((time.perf_counter() - t0) * 1e3)
    nbytes = sum(os.path.getsize(os.path.join(path, f))
                 for f in os.listdir(path))
    print(f'  18a: one save through the async store at config 2: the host '
          f'held {[round(m, 3) for m in hold]} ms, committed after '
          f'{[round(m, 3) for m in commit]} ms, {nbytes} bytes (DCP\'s '
          f'import before them {import_ms:.3f} ms); the .pt rolling save '
          f'{[round(m, 3) for m in pt_ms]} ms, on {card}', flush=True)
    return {'dcp_import_ms': import_ms,
            'save_async_hold_ms': statistics.median(hold),
            'save_async_hold_ms_readings': hold,
            'save_async_commit_ms': statistics.median(commit),
            'save_async_commit_ms_readings': commit,
            'store_bytes': nbytes,
            'pt_rolling_save_ms': statistics.median(pt_ms)}


def pipeline_phase(torch, np, wrappers, card, step_img_s, tmp):
    """Phase 13: the input pipeline and exact resume (see the module
    docstring). Returns (the default loader's training launches, the
    summary)."""
    from patchgan_tpu_torch.data import native
    t0 = time.perf_counter()
    write_pipeline_inputs(tmp, np)
    status = native.native_status()
    print(f'  wrote {PIPE_N} + {PIPE_VAL} pairs of {PIPE_HW[1]}x{PIPE_HW[0]} '
          f'and {PIPE_SHARDS} shards in {time.perf_counter() - t0:.2f} s; '
          f'native decode: {status}', flush=True)
    out = {'native_decode': status, 'card': card}
    out['decode_ms_per_pair'], out['decode_ms_readings'] = decoder_phase(
        np, tmp, status == 'built')
    print(f'  decode + resize to {SIZE} px, host ms per pair: '
          f'{out["decode_ms_per_pair"]}', flush=True)
    if status != 'built':
        print('  the native library is unavailable here: the loader rows '
              'named "native" decode with PIL', flush=True)
    out['loader_img_per_s'], out['loader_readings'] = loader_rate_phase(
        torch, tmp, card)

    # the epoch: patchgan_train at config 2 with the default loader and
    # with the fastest one, 2 epochs; the second epoch's rate is read.
    # The Trainer's step is the captured one; the cached loader's epoch
    # also with PATCHGAN_CUDA_GRAPH=off, in turns
    fastest = max(out['loader_img_per_s'], key=out['loader_img_per_s'].get)
    runs = [('default (thread x4 native)', [], 'on', 'folder', False, 'on')]
    if fastest not in ('thread x4 native', 'thread x4 cache'):
        opts, io_mode, data = LOADERS[fastest]
        extra = ['--dataloader_worker_type', 'process'] \
            if opts.get('worker_type') == 'process' else []
        runs.append((f'fastest ({fastest})', extra, io_mode, data,
                     bool(opts.get('cache')), 'on'))
    runs += [(f'thread x4 cache, graph {graph} {turn}', [], 'on', 'folder',
              True, graph) for turn, graph in enumerate(('on', 'off'))]
    epoch_rate, launches = {}, None
    per_run = 2 * (PIPE_N // TRAIN_B)
    for name, extra, mode, data, cache, graph in runs:
        cfg = pipeline_config(tmp, 'epoch', data=data, cache=cache)
        text, counts, wall, replays = run_train(
            torch, wrappers, ['-c', cfg, '-n', '2', '-b', str(TRAIN_B)]
            + extra, env={'PATCHGAN_NATIVE_IO': mode,
                          'PATCHGAN_CUDA_GRAPH': graph})
        epochs = epoch_lines(text)
        # captured: one eager step, one capture, then replays, which call
        # no wrapper; eager: every step through the wrappers
        want_replays = (1, 1, per_run - 1) if graph == 'on' else (0, 0, 0)
        ran = 2 if graph == 'on' else per_run
        want = [ran * a + 2 * b for a, b in zip(STEP['off'], EVAL['off'])]
        if counts != want or len(epochs) != 2 or replays != want_replays:
            raise AssertionError(f'{name}: launches {counts}, expected '
                                 f'{want}; epochs {epochs}; eager steps / '
                                 f'captures / replays {replays}, expected '
                                 f'{want_replays}')
        launches = launches or counts
        n, secs = epochs[1]
        epoch_rate[name] = {'epoch_s': secs, 'img_per_s': n / secs,
                            'first_epoch_s': epochs[0][1], 'run_wall_s': wall,
                            'graph_replays': replays}
        print(f'  patchgan_train, {name}: epoch 2 {n} images in {secs:.3f} '
              f's, {n / secs:.3f} img/s (epoch 1 {epochs[0][1]:.3f} s); the '
              f'captured step alone (phase 10) {step_img_s:.3f} img/s; '
              f'launches {counts} (expected {want}); eager steps / '
              f'captures / replays {replays} on {card}', flush=True)
        shutil.rmtree(os.path.join(tmp, 'ck_epoch'))
    out['epoch'] = epoch_rate
    out['step_only_img_per_s'] = step_img_s
    for graph in ('on', 'off'):
        rates = [r['img_per_s'] for k, r in epoch_rate.items()
                 if k.startswith(f'thread x4 cache, graph {graph} ')]
        out[f'cache_epoch_graph_{graph}_img_per_s'] = rates
    print(f'  the cached loader\'s epoch 2, img/s: captured step '
          f'{out["cache_epoch_graph_on_img_per_s"]}, eager step '
          f'{out["cache_epoch_graph_off_img_per_s"]} on {card}', flush=True)

    # shards against the folder: one epoch each, PIL decode on both (the
    # shard members decode with PIL, as in the JAX package), flips on,
    # deterministic cuDNN: bit-equal epoch files
    with cudnn_flags_kept(torch):
        for data in ('folder', 'shards'):
            cfg = pipeline_config(tmp, f'eq_{data}', data=data)
            run_train(torch, wrappers, ['-c', cfg, '-n', '1', '-b',
                                        str(TRAIN_B), '--deterministic'],
                      env={'PATCHGAN_NATIVE_IO': 'off'})
    same, diff = weights_diff(np, os.path.join(tmp, 'ck_eq_folder'),
                              os.path.join(tmp, 'ck_eq_shards'), 1)
    print(f'  one epoch from the shards and from the folder: equal bits '
          f'{same} (max |diff| {diff:.3e})', flush=True)
    if not same:
        raise AssertionError(f'shards and folder differ by {diff}')
    out['shards_equal_folder'] = same
    for data in ('folder', 'shards'):
        shutil.rmtree(os.path.join(tmp, f'ck_eq_{data}'))

    out['resume'] = resume_phase(torch, np, tmp, card)

    # --profile_dir: a trace of epoch 1 only, naming K2's and K3's kernels
    cfg = pipeline_config(tmp, 'profile', train='resume')
    trace_dir = os.path.join(tmp, 'trace')
    run_train(torch, wrappers, ['-c', cfg, '-n', '2', '-b', str(TRAIN_B),
                                '--profile_dir', trace_dir])
    traces = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, traces[0])) as f:
        text = f.read()
    # bf16 at config 2's widths: both layouts' forms on the wgmma core
    found = {k: k in text for k in ('pgt::conv_wgmma_kernel',
                                    'pgt::ConvNhwcProblem<',
                                    'pgt::ConvTNhwcProblem<')}
    print(f'  --profile_dir: {len(traces)} trace(s), {len(text)} bytes, '
          f'names {found}', flush=True)
    if len(traces) != 1 or not all(found.values()):
        raise AssertionError(f'profile traces {traces}, names {found}')
    out['profile_trace_bytes'] = len(text)
    return launches, out


# phase 14: data parallelism (BASELINE.json config 5)
DP_STEPS = 3            # steps of each parity run
DP_WINDOWS, DP_WINDOW_S = 3, 1.5   # img/s windows per configuration
DP_JOIN_S = 600         # a spawned rank that has not ended by then hung
# 14b: the most weights that may fall outside rtol 5e-3 / atol 2e-4 of
# one process's after DP_STEPS steps: five times the sound reading on
# the H100 (34 of 44,600,385)
DP_WEIGHTS_LOOSE = 170
DP_SCALE_STEPS = 50     # steps of each of 14d's windows: a count, not a
#                         time, so that every rank runs as many collectives


def free_port():
    import socket
    s = socket.socket()
    s.bind(('127.0.0.1', 0))
    port = s.getsockname()[1]
    s.close()
    return port


def kernel_wrappers():
    """The six kernel wrappers in the order of ``main``'s table."""
    from patchgan_tpu_torch.ops.kernels import (
        conv_norm_act, convt_norm_act, instance_norm_act,
        instance_norm_act_backward, thin_conv3x3, thin_conv3x3_wgrad)
    return [instance_norm_act, conv_norm_act, convt_norm_act,
            instance_norm_act_backward, thin_conv3x3, thin_conv3x3_wgrad]


class FlipPairs:
    """Seeded 256-px uint8 images with 7-label labelmaps and
    'randomcrop+flip': the loader normalises, one-hots and flips them on
    the card (phase 14b)."""
    augmentation = 'randomcrop+flip'
    labels = list(range(1, OUT_C + 1))

    def __init__(self, n, seed=21):
        import numpy as np
        rng = np.random.default_rng(seed)
        self.images = rng.integers(0, 256, (n, SIZE, SIZE, IN_C), np.uint8)
        self.maps = rng.integers(1, OUT_C + 1, (n, SIZE, SIZE)).astype(
            np.int64)

    def __len__(self):
        return len(self.images)

    def load_raw(self, index):
        return self.images[index], self.maps[index]


def params_digest(modules):
    import hashlib
    h = hashlib.sha256()
    for m in modules:
        for p in m.parameters():
            h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def kernel_rows(prof, n_steps):
    """(device ms, launches, name) a step of each device kernel in a
    profile, largest first: the entries with no CPU time of their own."""
    return sorted(((e.self_device_time_total / n_steps / 1e3,
                    e.count / n_steps, e.key)
                   for e in prof.key_averages()
                   if e.self_device_time_total > 0
                   and e.self_cpu_time_total == 0), reverse=True)


def profile_steps(torch, fn, n_steps=3):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            fn()
        torch.cuda.synchronize()
    return kernel_rows(prof, n_steps)


def rates_in_turns(torch, fns, batch, card):
    """img/s of each of ``fns`` (name -> one step on ``batch`` images), in
    turns, ``DP_WINDOWS`` windows of at least ``DP_WINDOW_S`` s; the host
    ms a step beside them; (medians, readings)."""
    readings = {name: [] for name in fns}
    host = {name: [] for name in fns}
    names = list(fns)
    for i in range(DP_WINDOWS):
        for name in (names if i % 2 == 0 else names[::-1]):
            count, spent, t0 = 0, 0.0, time.perf_counter()
            while time.perf_counter() - t0 < DP_WINDOW_S:
                for _ in range(5):
                    t1 = time.perf_counter()
                    fns[name]()
                    spent += time.perf_counter() - t1
                torch.cuda.synchronize()
                count += 5
            dt = time.perf_counter() - t0
            readings[name].append(batch * count / dt)
            host[name].append(1e3 * spent / count)
    med = {name: {'img_per_s': statistics.median(readings[name]),
                  'host_ms_per_step': statistics.median(host[name])}
           for name in fns}
    for name in fns:
        print(f'  {name}: img/s {[round(r, 3) for r in readings[name]]} '
              f'(median {med[name]["img_per_s"]:.3f}), host '
              f'{med[name]["host_ms_per_step"]:.3f} ms a step on {card}',
              flush=True)
    return med, readings


def dropout_draw_ms(torch, gen, world=2):
    """Device ms of one step's dropout draws at batch TRAIN_B / world a
    rank: drawn for the rank's rows alone, and for the global batch
    with the rank keeping its rows (what a rank of ``world`` draws); the
    shapes from one training forward."""
    from patchgan_tpu_torch.models import blocks
    from patchgan_tpu_torch.parallel import DataMesh
    shapes, draw = [], blocks.dropout

    def record(x, generator, mesh=None):
        shapes.append(tuple(x.shape))
        return draw(x, generator, mesh)

    blocks.dropout = record
    try:
        with torch.no_grad():
            gen.train()
            gen(torch.zeros((TRAIN_B // world, IN_C, SIZE, SIZE),
                            device='cuda'))
    finally:
        blocks.dropout = draw
    mesh = object.__new__(DataMesh)   # rank 0 of ``world``: its rows only
    mesh.rank, mesh.size = 0, world
    xs = [torch.zeros(s, device='cuda', dtype=torch.bfloat16) for s in shapes]
    out = {}
    for name, m in (('own rows', None), ('global batch', mesh)):
        # the card's time alone (a graph's replay; the default generator,
        # which a capture takes without registering it)
        out[name] = device_ms(lambda: [draw(x, None, m) for x in xs])
    return out, len(shapes)


def dp_world1_phase(torch, np, wrappers, card):
    """14a: NCCL at world size 1, in this process: DP_STEPS captured DP
    steps (the eager first, the capture, a replay) against as many
    captured single-process steps from the same state, bf16, batch 16,
    dropout on, deterministic cuDNN: every loss and every tensor the
    step changes bit-equal. The DP run's launches (the counts set to 0
    just before it). Then img/s and host ms of both in turns, the device
    kernels of a replay (NCCL's among them), and the dropout draws' ms
    at a rank's batch of 8, for the rank's rows and for the global
    batch."""
    import torch.distributed as dist
    from patchgan_tpu_torch.parallel import DataMesh
    bf16 = torch.bfloat16
    dist.init_process_group('nccl', init_method=f'tcp://127.0.0.1:'
                            f'{free_port()}', rank=0, world_size=1,
                            device_id=torch.device('cuda', 0))
    mesh = None
    try:
        mesh = DataMesh('cuda:0')
        batches = [tuple(t.to(bf16) for t in train_batch(
            torch, np, TRAIN_B, SIZE, 'cuda', 70 + i))
            for i in range(DP_STEPS)]
        runs = {}
        with cudnn_flags_kept(torch):
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
            for name, m in (('single', None), ('dp', mesh)):
                gen, disc = train_models(torch)
                step, opts = config_step(torch, gen, disc, 'off', False, 1,
                                         True, mesh=m)
                for w in wrappers:
                    w.launches = 0
                losses = [step(*b) for b in batches]
                torch.cuda.synchronize()
                launches = [w.launches for w in wrappers]
                runs[name] = dict(
                    step=step, gen=gen, launches=launches,
                    losses=[torch.stack(list(l.values())).cpu()
                            for l in losses],
                    state=step_state(torch, gen, disc, opts),
                    counts=(step.eager_steps, step.captures, step.replays))
        one, dp = runs['single'], runs['dp']
        same_losses = all(torch.equal(a, b)
                          for a, b in zip(one['losses'], dp['losses']))
        same = [torch.equal(a, b)
                for a, b in zip(one['state'][0], dp['state'][0])]
        want = [2 * n for n in STEP['off']]
        print(f'  {mesh}: {DP_STEPS} captured DP steps against the '
              f'single-process captured step: losses equal {same_losses}, '
              f'tensors equal {sum(same)} of {len(same)}, counters '
              f'{dp["state"][1]} ({one["state"][1]}); eager steps / '
              f'captures / replays {dp["counts"]}; launches {dp["launches"]} '
              f'(the eager step and the capture: {want})', flush=True)
        if not (same_losses and all(same)) or \
                dp['state'][1] != one['state'][1] or \
                dp['counts'] != (1, 1, DP_STEPS - 1) or \
                dp['launches'] != want:
            raise AssertionError('14a: the DP step at world size 1 differs '
                                 'from the single-process step')
        x, y = batches[0]
        fns = {name: (lambda r=r: r['step'](x, y))
               for name, r in (('single captured', one),
                               ('dp world 1 captured', dp))}
        med, readings = rates_in_turns(torch, fns, TRAIN_B, card)
        kernels = {}
        for name, fn in fns.items():
            rows = profile_steps(torch, fn)
            nccl = [r for r in rows if 'nccl' in r[2].lower()]
            kernels[name] = {
                'device_kernels_per_step': sum(r[1] for r in rows),
                'busy_ms_per_step': sum(r[0] for r in rows),
                'nccl_kernels_per_step': sum(r[1] for r in nccl),
                'nccl_ms_per_step': sum(r[0] for r in nccl),
                'nccl_names': sorted({r[2][:60] for r in nccl})}
            print(f'  {name}: {kernels[name]}', flush=True)
        draws, n_draws = dropout_draw_ms(torch, one['gen'])
        print(f'  dropout draws of one step ({n_draws} levels) at a rank\'s '
              f'batch of {TRAIN_B // 2}: {draws["own rows"]:.4f} ms for its '
              f'rows, {draws["global batch"]:.4f} ms for the global batch of '
              f'{TRAIN_B} on {card}', flush=True)
        del runs, one, dp, fns
    finally:
        if mesh is not None:
            mesh.release_graphs()
        dist.destroy_process_group()
    return launches, {'bit_equal': True, 'graph_counts': (1, 1, DP_STEPS - 1),
                      'rates': med, 'readings': readings,
                      'kernels': kernels, 'dropout_draw_ms': draws}


def dp_gloo_run(torch, np, mesh, activation='tanh'):
    """DP_STEPS fp32 eager steps at config 2's widths from fixed seeds on
    the batches of a loader with flips (global batch 16: this rank's
    rows with a ``mesh``), dropout on, tanh: the activation of the JAX
    DP test whose limits 14b takes (with relu, rounding alone moves the
    weights past them: ``tools/dp_rounding.py``). Returns (each step's
    losses, each step's parameter digest, generator, discriminator, the
    gradients G's and D's optimizers were handed at the first step, on
    the host)."""
    from patchgan_tpu_torch.data import DataLoader
    from patchgan_tpu_torch.models import Discriminator, UNet
    from patchgan_tpu_torch.train.steps import make_optimizer, \
        make_train_step
    init = torch.Generator().manual_seed(9)
    gen = UNet(IN_C, OUT_C, nf=NF, use_dropout=True, activation=activation,
               final_act='softmax', generator=init).cuda()
    disc = Discriminator(IN_C + OUT_C, ndf=NDF, n_layers=3,
                         generator=init).cuda()
    gen.dropout_generator = torch.Generator(device='cuda').manual_seed(1)
    opts = [make_optimizer(m.parameters(), LR) for m in (gen, disc)]
    grads = []
    for opt in opts:
        def record(gs, update=opt.update):
            if len(grads) < 2:
                grads.append([g.detach().cpu() for g in gs])
            return update(gs)
        opt.update = record
    step = make_train_step(gen, disc, *opts, mesh=mesh)
    slicing = {} if mesh is None else dict(process_index=mesh.rank,
                                           process_count=mesh.size)
    loader = DataLoader(FlipPairs(DP_STEPS * TRAIN_B), batch_size=TRAIN_B,
                        num_workers=0, device='cuda', seed=5, **slicing)
    losses, digests = [], []
    for x, y in loader:
        losses.append({k: float(v) for k, v in step(x, y).items()})
        digests.append(params_digest((gen, disc)))
    return losses, digests, gen, disc, grads


def dp_gloo_child():
    """``python -c 'import chip_smoke; chip_smoke.dp_gloo_child()' RANK
    PORT OUT``: one of 14b's two gloo ranks on card 0; writes
    OUT/rank_RANK.json (losses and digests of each step, its launches,
    the ms of the gloo all-reduce of the gradient bucket) and, rank 0,
    OUT/state.pt (its final weights)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from patchgan_tpu_torch.parallel import DataMesh
    rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                            rank=rank, world_size=2)
    mesh = DataMesh('cuda:0')
    wrappers = kernel_wrappers()
    for w in wrappers:
        w.launches = 0
    losses, digests, gen, disc, grads = dp_gloo_run(torch, np, mesh)
    torch.cuda.synchronize()
    launches = [w.launches for w in wrappers]
    bucket = [torch.ones_like(p) for m in (gen, disc) for p in m.parameters()]
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh.sum_(bucket)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    if rank == 0:
        torch.save({'generator': gen.state_dict(),
                    'discriminator': disc.state_dict(), 'grads': grads},
                   os.path.join(out, 'state.pt'))
    with open(os.path.join(out, f'rank_{rank}.json'), 'w') as f:
        json.dump({'losses': losses, 'digests': digests,
                   'launches': launches, 'allreduce_ms': ms,
                   'bucket_values': sum(b.numel() for b in bucket)}, f)
    dist.destroy_process_group()


def run_ranks(cmds, tmp, name, timeout=DP_JOIN_S):
    """Start the commands at once, wait for each (``timeout`` s), kill
    what is left; raise with the log's tail unless every one exits 0."""
    path = os.environ.get('PYTHONPATH')
    env = dict(os.environ, PYTHONPATH=ROOT + (os.pathsep + path if path
                                              else ''))
    log_path = os.path.join(tmp, f'{name}.log')
    with open(log_path, 'w') as log:
        procs = [subprocess.Popen(c, cwd=tmp, env=env, stdout=log,
                                  stderr=subprocess.STDOUT) for c in cmds]
        try:
            rcs = [p.wait(timeout=timeout) for p in procs]
        except subprocess.TimeoutExpired:
            rcs = None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    with open(log_path) as f:
        text = f.read()
    if rcs is None or any(rcs):
        print(text[-4000:])
        raise AssertionError(f'{name}: exit codes {rcs}')
    return text


def dp_gloo_phase(torch, np, card, tmp):
    """14b: two gloo ranks sharing card 0, fp32, eager, flips and dropout
    on, DP_STEPS steps of config 2's widths (tanh) at a global batch of
    16: the two ranks' losses and weights bit-equal after every step; one
    process on the whole batch on the same card, the same seeds: losses
    within rtol 2e-4 / atol 1e-5 (JAX ``tests/test_distributed.py:53-55``),
    the first update's summed gradients within 1e-3 of each tensor's max
    |g| (phase 7's gradient limit), and the weights within Adam's
    sign-flip bound around the JAX test's limits (``:57-64``): at most
    DP_WEIGHTS_LOOSE of them outside rtol 5e-3 / atol 2e-4 and every one
    within 2.5 lr, as ``tests/test_train_step_parity.py:111-128`` holds an Adam
    update (an element whose gradient is at rounding level can flip the
    sign of an Adam step; one process against itself with only cuDNN's
    algorithms changed flips some too: ``tools/dp_rounding.py``); each
    rank's launches against ``STEP`` at batch 8; the gloo all-reduce of
    the gradient bucket."""
    out_dir = os.path.join(tmp, 'dp_gloo')
    os.makedirs(out_dir)
    port = free_port()
    t0 = time.perf_counter()
    run_ranks([[sys.executable, '-c',
                'import chip_smoke; chip_smoke.dp_gloo_child()', str(rank),
                str(port), out_dir] for rank in range(2)], tmp, 'dp_gloo',
              timeout=300)
    wall = time.perf_counter() - t0
    ranks = []
    for rank in range(2):
        with open(os.path.join(out_dir, f'rank_{rank}.json')) as f:
            ranks.append(json.load(f))
    equal = [a == b for a, b in zip(ranks[0]['digests'], ranks[1]['digests'])]
    equal_losses = ranks[0]['losses'] == ranks[1]['losses']
    with cudnn_flags_kept(torch):
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        losses, _, gen, disc, grads = dp_gloo_run(torch, np, None)
    worst = {}
    for i, (want, got) in enumerate(zip(losses, ranks[0]['losses'])):
        for k in want:
            err = abs(got[k] - want[k]) - 2e-4 * abs(want[k])
            worst[f'{k}@{i + 1}'] = err
    state = torch.load(os.path.join(out_dir, 'state.pt'), weights_only=True)
    grad_err = max(float((a - b).abs().max()) / float(b.abs().max())
                   for got, want in zip(state['grads'], grads)
                   for a, b in zip(got, want))
    loose, total, max_diff = 0, 0, 0.0
    for name, module in (('generator', gen), ('discriminator', disc)):
        for k, want in module.state_dict().items():
            got = state[name][k].cuda()
            diff = (got - want).abs()
            loose += int((diff > 2e-4 + 5e-3 * want.abs()).sum())
            total += want.numel()
            max_diff = max(max_diff, float(diff.max()))
    launches = [r['launches'] for r in ranks]
    want_launches = [DP_STEPS * n for n in STEP['off']]
    ms = statistics.median(ranks[0]['allreduce_ms'])
    mb = 4 * ranks[0]['bucket_values'] / 1e6
    print(f'  two gloo ranks on one card ({wall:.1f} s): weights bit-equal '
          f'after each step {equal}, losses equal {equal_losses}; against '
          f'one process on the whole batch: worst loss excess over rtol '
          f'2e-4 {max(worst.values()):.3e} (atol 1e-5), the first update\'s '
          f'gradients within {grad_err:.3e} of each tensor\'s max |g| (limit '
          f'1e-3), weights outside rtol 5e-3 / atol 2e-4: {loose} of {total} '
          f'(at most {DP_WEIGHTS_LOOSE}; max |diff| {max_diff:.3e}, limit '
          f'2.5 lr); '
          f'launches a rank {launches} (expected '
          f'{want_launches}); the gloo all-reduce of the {mb:.1f} MB '
          f'bucket {[round(m, 3) for m in ranks[0]["allreduce_ms"]]} ms '
          f'on {card}', flush=True)
    if not (all(equal) and equal_losses) or max(worst.values()) > 1e-5 or \
            grad_err > 1e-3 or loose > DP_WEIGHTS_LOOSE or max_diff > 2.5 * LR \
            or any(l != want_launches for l in launches):
        raise AssertionError('14b: the gloo ranks disagree with each other '
                             'or with one process')
    return launches[0], {'ranks_bit_equal': True, 'loss_excess':
                         max(worst.values()), 'grad_err': grad_err,
                         'weights_loose': loose,
                         'weights_max_abs_diff': max_diff,
                         'launches_per_rank': launches,
                         'gloo_allreduce_ms': ms, 'bucket_mb': mb,
                         'wall_s': wall}


def dp_torchrun_phase(torch, np, tmp, card):
    """14c: ``patchgan_train -d cuda --deterministic`` under ``python -m
    torch.distributed.run --nproc_per_node K`` (K = min(cards, 4)) at
    config 2 on the first RESUME_N of phase 13's JPEGs, two epochs: one
    set of epoch files, which a single-process Trainer loads; a run with
    save_every_steps 1 killed (every process of it) once its rolling
    metadata shows epoch 2 with 1 batch done and resumed ends bit-equal
    to the uninterrupted run. Each rank prints its Trainer's graph
    counts."""
    k = min(torch.cuda.device_count(), 4)

    def cmd(cfg):
        return [sys.executable, '-m', 'torch.distributed.run', '--nnodes',
                '1', '--nproc_per_node', str(k), '--master_addr',
                '127.0.0.1', '--master_port', str(free_port()),
                os.path.join(ROOT, 'chip_smoke.py'), '--train-child', '-c',
                cfg, '-d', 'cuda', '--no-summary', '-n', '2', '-b',
                str(TRAIN_B), '--deterministic']

    path = os.environ.get('PYTHONPATH')
    env = dict(os.environ, PYTHONPATH=ROOT + (os.pathsep + path if path
                                              else ''))
    whole = pipeline_config(tmp, 'dp_whole', train='resume')
    cut = pipeline_config(tmp, 'dp_cut', train='resume', save_every_steps=1)
    ck_whole, ck_cut = (os.path.join(tmp, f'ck_{n}')
                        for n in ('dp_whole', 'dp_cut'))
    log_path = os.path.join(tmp, 'dp_torchrun.log')
    t0 = time.perf_counter()
    with open(log_path, 'w') as log:
        control = subprocess.Popen(cmd(whole), cwd=tmp, env=env, stdout=log,
                                   stderr=subprocess.STDOUT)
        try:
            meta = kill_at(cmd(cut), tmp, env, os.path.join(
                ck_cut, 'step_state_torch.json'), (2, 1), log)
            with open(cut, 'a') as f:
                f.write('load_last_checkpoint: true\n')
            rc = subprocess.run(cmd(cut), cwd=tmp, env=env, stdout=log,
                                stderr=subprocess.STDOUT,
                                timeout=DP_JOIN_S).returncode
            rc_control = control.wait(timeout=DP_JOIN_S)
        finally:
            if control.poll() is None:
                control.kill()
                control.wait()
    wall = time.perf_counter() - t0
    with open(log_path) as f:
        text = f.read()
    counts = re.findall(r'graph counts (\(\d+, \d+, \d+\))', text)
    per_run = 2 * (RESUME_N // TRAIN_B)
    files = sorted(os.listdir(ck_whole))
    want_files = [f'{m}_ep_{e:03d}.npz' for m in ('discriminator',
                                                  'generator')
                  for e in (1, 2)]
    same, diff = weights_diff(np, ck_whole, ck_cut, 2)
    from patchgan_tpu_torch.models import Discriminator, UNet
    from patchgan_tpu_torch.train import Trainer
    loaded = Trainer(UNet(IN_C, OUT_C, nf=NF), Discriminator(
        IN_C + OUT_C, ndf=NDF, n_layers=3), ck_whole, device='cpu')
    loaded.load_last_checkpoint()
    print(f'  torchrun --nproc_per_node {k}: files {files}; a '
          f'single-process Trainer loads them at epoch {loaded.start}; cut '
          f'at {(meta["epoch"], meta["batches_done"])}, resumed: epoch-2 '
          f'weights equal bits {same} (max |diff| {diff:.3e}); graph counts '
          f'of the ranks that ended {counts}; the three runs took '
          f'{wall:.1f} s on {card}', flush=True)
    if rc or rc_control or files != want_files or loaded.start != 3 or \
            not same or counts.count(f'(1, 1, {per_run - 1})') != k or \
            'Found mid-epoch checkpoint: epoch 2, 1 batches done' not in text:
        print(text[-4000:])
        raise AssertionError(f'14c: rc {rc} / {rc_control}, files {files}, '
                             f'start {loaded.start}, equal {same}, counts '
                             f'{counts}')
    for ck in (ck_whole, ck_cut):
        shutil.rmtree(ck)
    return {'ranks': k, 'files': files, 'resumed_equal_bits': same,
            'graph_counts': counts, 'wall_s': wall}


def captured_ms(torch, fn):
    """Device ms of ``fn`` captured into a CUDA graph (warmed once on a
    side stream), by CUDA events over 20 replays; the graph is freed."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode='thread_local'):
        fn()
    ms = cuda_ms(graph.replay, iters=20)
    # NCCL's teardown waits for the graphs that hold its work
    graph.reset()
    return ms


def dp_scale_child():
    """``python -c 'import chip_smoke; chip_smoke.dp_scale_child()' RANK
    WORLD PORT OUT``: one NCCL rank on card RANK of 14d: the captured bf16
    DP step at config 2 (global batch 16), its img/s in windows of
    DP_SCALE_STEPS steps, and the captured all-reduce of the gradient
    bucket alone (CUDA events over 20 replays); rank 0 writes
    OUT/world_WORLD.json."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from patchgan_tpu_torch.cli.aot import allreduce_bound
    from patchgan_tpu_torch.parallel import DataMesh, shutdown
    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    device = torch.device('cuda', rank)

    def stage(text):
        # the log shows where a rank that hangs stopped
        print(f'  rank {rank} of {world}: {text}', flush=True)

    torch.cuda.set_device(device)
    dist.init_process_group('nccl', init_method=f'tcp://127.0.0.1:{port}',
                            rank=rank, world_size=world, device_id=device)
    mesh = DataMesh(device)
    stage('the group formed')
    mesh.barrier()
    stage('a barrier passed')
    gen, disc = train_models(torch)
    step, opts = config_step(torch, gen, disc, 'off', False, 1, True,
                             mesh=mesh)
    x, y = (t.to(torch.bfloat16) for t in mesh.local_rows(train_batch(
        torch, np, TRAIN_B, SIZE, 'cuda', 8)))
    for i in range(3):
        step(x, y)
        torch.cuda.synchronize()
        stage(f'step {i + 1} (eager, capture, replay) done')
    rates = []
    for i in range(DP_WINDOWS):
        mesh.barrier()
        t0 = time.perf_counter()
        for _ in range(DP_SCALE_STEPS):
            step(x, y)
        torch.cuda.synchronize()
        rates.append(TRAIN_B * DP_SCALE_STEPS / (time.perf_counter() - t0)
                     / world)
        stage(f'window {i + 1} done')
    bucket = [torch.zeros_like(p) for m in (gen, disc)
              for p in m.parameters()]
    ms = captured_ms(torch, lambda: mesh.sum_(bucket))
    stage('the bucket\'s captured all-reduce timed')
    if rank == 0:
        with open(os.path.join(out, f'world_{world}.json'), 'w') as f:
            json.dump({'img_per_s_per_card': rates, 'allreduce_ms': ms,
                       'bound': allreduce_bound(opts, world),
                       'replays': step.replays}, f)
    shutdown(mesh)
    stage('the group destroyed')


def dp_scale_phase(torch, tmp, card):
    """14d, where the machine has two or more cards: the captured bf16 DP
    step at config 2 over 1, 2 and (where there are 4) 4 cards, world 1
    again after them; img/s per card and the captured all-reduce's ms
    against aot's NVLink bound."""
    n = torch.cuda.device_count()
    if n < 2:
        print(f'  14d not run: this machine has {n} card; NCCL refuses two '
              f'ranks on one device, so scaling over cards needs two or '
              f'more', flush=True)
        return {'run': False, 'cards': n}
    out_dir = os.path.join(tmp, 'dp_scale')
    os.makedirs(out_dir)
    worlds = [1, 2] + ([4] if n >= 4 else []) + [1]
    rows = []
    for world in worlds:
        port = free_port()
        run_ranks([[sys.executable, '-c',
                    'import chip_smoke; chip_smoke.dp_scale_child()',
                    str(rank), str(world), str(port), out_dir]
                   for rank in range(world)], tmp, f'dp_scale_{world}',
                  timeout=120)
        with open(os.path.join(out_dir, f'world_{world}.json')) as f:
            r = json.load(f)
        r['world'] = world
        rows.append(r)
        print(f'  world {world}: img/s per card '
              f'{[round(v, 3) for v in r["img_per_s_per_card"]]}, the '
              f'captured all-reduce of {r["bound"]["bucket_bytes"] / 1e6:.1f}'
              f' MB {r["allreduce_ms"]:.4f} ms (NVLink ring bound '
              f'{r["bound"]["nvlink_bound_ms"]:.4f} ms) on {card}',
              flush=True)
    return {'run': True, 'cards': n, 'worlds': rows}


def dp_phase(torch, np, wrappers, card, tmp):
    """Phase 14: data parallelism (see the module's docstring). Returns
    (14a's launches, 14b's rank-0 launches, the summary)."""
    out = {'card': card}
    t0 = time.perf_counter()
    print('  14a: NCCL at world size 1, in this process', flush=True)
    launches_a, out['nccl_world_1'] = dp_world1_phase(torch, np, wrappers,
                                                      card)
    print('  14b: two gloo ranks sharing the card', flush=True)
    launches_b, out['gloo_two_ranks'] = dp_gloo_phase(torch, np, card, tmp)
    print('  14c: patchgan_train under torch.distributed.run', flush=True)
    out['torchrun'] = dp_torchrun_phase(torch, np, tmp, card)
    print('  14d: NCCL across cards', flush=True)
    out['across_cards'] = dp_scale_phase(torch, tmp, card)
    out['phase_wall_s'] = time.perf_counter() - t0
    return launches_a, launches_b, out


# phase 15: the inference engine over the cards of one process
MESH_WINDOWS = 3       # masks/s windows per configuration, in turns
MESH_GROUP = 4         # images per predict_images group
MESH_AGREE = 0.999     # label agreement with the one-card engine


def mesh_layouts(torch):
    """{label: devices} of phase 15: (a) one card listed twice, always;
    (b) 2 cards and min(cards, 4) where there are two or more."""
    n = torch.cuda.device_count()
    layouts = {'cuda:0 x2': ['cuda:0', 'cuda:0']}
    if n >= 2:
        for k in sorted({2, min(n, 4)}):
            layouts[f'{k} cards'] = [f'cuda:{i}' for i in range(k)]
    return layouts


def split_check(torch, F, kernels):
    """K2 and K3 at the nf=64 generator's shapes for a bucket of 32
    tiles, at the K split of ``SPLIT_BATCH`` tiles (the engine's; another
    split than the bucket's own at the deep levels): against their plain
    versions at phase 2's tolerances, and rows 0-7 bit-equal to the same
    kernel on those 8 rows alone."""
    from patchgan_tpu_torch.inference.engine import SPLIT_BATCH
    worst = {}
    for kernel, label, make, *_ in make_cases(torch, F, kernels, n=32):
        if kernel.name == 'instance_norm_act':
            continue
        for dname, dt in (('bfloat16', torch.bfloat16),
                          ('float32', torch.float32)):
            args = make(dt)
            got = kernel.wrapper(*args, split_batch=SPLIT_BATCH)
            want = kernel.plain(*(a.float() if torch.is_tensor(a) else a
                                  for a in args))
            err = (got.float() - want.float()).abs().max().item()
            rows = kernel.wrapper(*(a[:8] if torch.is_tensor(a) and
                                    a.dim() == 4 and a.shape[0] == 32 else a
                                    for a in args), split_batch=SPLIT_BATCH)
            same = torch.equal(rows, got[:8])
            worst[kernel.name] = max(worst.get(kernel.name, 0.0), err)
            if err > TOL[dname] or not same:
                raise AssertionError(f'{kernel.name} {label} {dname} at '
                                     f'split_batch {SPLIT_BATCH}: err {err} '
                                     f'(tol {TOL[dname]}), rows 0-7 equal '
                                     f'to 8 alone {same}')
    print(f'  K2 / K3 at 32 tiles, split_batch {SPLIT_BATCH}: max_abs_err '
          f'{worst} (tol {TOL}); rows 0-7 bit-equal to the 8 rows alone at '
          f'every level, both dtypes', flush=True)
    return worst


def counted(wrappers, fn):
    """(fn's result, the wrappers' launches during it), the card
    synchronised after it."""
    import torch
    for w in wrappers:
        w.launches = 0
    out = fn()
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)
    return out, [w.launches for w in wrappers]


def wgmma_counted(fn):
    """(fn's result, {band wrapper name: its launches on the wgmma core
    during fn}) for K2's and K3's band entries."""
    from patchgan_tpu_torch.ops.kernels import conv_band, convt_band
    before = [w.launches_wgmma for w in (conv_band, convt_band)]
    out = fn()
    return out, {w.__name__: w.launches_wgmma - b
                 for w, b in zip((conv_band, convt_band), before)}


def mesh_rates(fns, label):
    """Masks/s of each of ``fns`` ({name: a call that returns the masks
    it finished}, with an optional ``flush`` attribute that finishes what
    is still in flight) after two warm-up calls each: MESH_WINDOWS
    windows of at least WINDOW_S each, in turns (the order reversed
    every other window), every reading printed. Returns {name:
    readings}."""
    names = list(fns)
    for fn in fns.values():
        for _ in range(2):
            fn()
        getattr(fn, 'flush', lambda: 0)()
    readings = {name: [] for name in names}
    for i in range(MESH_WINDOWS):
        for name in (names if i % 2 == 0 else names[::-1]):
            fn, count, t0 = fns[name], 0, time.perf_counter()
            while time.perf_counter() - t0 < WINDOW_S:
                count += fn()
            count += getattr(fn, 'flush', lambda: 0)()
            dt = time.perf_counter() - t0
            readings[name].append(count / dt)
            print(f'  {label} window {i} {name}: {count} masks in '
                  f'{dt:.3f} s, {count / dt:.3f} masks/s', flush=True)
    return readings


class PendingGroups:
    """Groups through ``predict_images_async``, group i's handles resolved
    after group i + 1 is dispatched (the serve micro-batcher's pattern:
    handles pending on the home card's copy)."""

    def __init__(self, engine, images):
        self.engine, self.images, self.prev = engine, images, None

    def __call__(self):
        handles = self.engine.predict_images_async(self.images)
        done = self.flush()
        self.prev = handles
        return done

    def flush(self):
        if self.prev is None:
            return 0
        for h in self.prev:
            h.result()
        done, self.prev = len(self.prev), None
        return done


def share_pace(torch, engine, card):
    """Host ms to issue one mesh device's share of a 32-tile chunk (its
    forward queued, nothing waited for), against the device ms of that
    share's forward (a CUDA graph's replay on its card): whether the host
    or the cards set the pace."""
    k = engine.n_devices
    x = torch.rand(32, IN_C, SIZE, SIZE, device=engine.device)
    shares = [s.to(d) for s, d in zip(x.chunk(k), engine._devices)]
    rows = []
    with torch.inference_mode():
        for i, share in enumerate(shares):
            host = []
            for _ in range(13):
                torch.cuda.synchronize(share.device)
                t0 = time.perf_counter()
                engine._forward(share, i)
                host.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize(share.device)
            with torch.cuda.device(share.device):
                dev = device_ms(lambda: engine._forward(share, i), iters=10)
            rows.append({'device': str(share.device), 'tiles': share.shape[0],
                         'host_issue_ms': statistics.median(host[3:]),
                         'device_ms': dev})
    issue = sum(r['host_issue_ms'] for r in rows)
    slowest = max(r['device_ms'] for r in rows)
    bound = 'host' if issue > slowest else 'cards'
    print(f'  pace, {k} devices, a 32-tile chunk: host issue ms a share '
          f'{[round(r["host_issue_ms"], 3) for r in rows]} (sum '
          f'{issue:.3f}), device ms a share '
          f'{[round(r["device_ms"], 3) for r in rows]} (slowest '
          f'{slowest:.3f}): the {bound} set the pace on {card}', flush=True)
    return {'shares': rows, 'host_issue_ms_sum': issue,
            'slowest_device_ms': slowest, 'bound_by': bound}


def mesh_check(torch, np, wrappers, model, images, sizes, devices, refs,
               card):
    """One mesh of phase 15: the fp32 predict_tiles of one 32-tile bucket
    against the one-card engine's (max |dprob| <= 1e-3); the bf16 masks
    of the four images one at a time and as one group against the
    one-card engine's (>= MESH_AGREE of pixels); the launches a device a
    chunk, K4 too under PATCHGAN_S2D=on; the host's pace. Returns (the
    bf16 engine, the launches of each run, the summary)."""
    from patchgan_tpu_torch.inference import InferenceEngine
    from patchgan_tpu_torch.parallel import default_mesh
    mesh = default_mesh(devices)
    k = len(mesh)
    out = {'mesh': mesh.describe()}
    tiles = np.random.default_rng(1).random((32, SIZE, SIZE, IN_C),
                                            dtype=np.float32)
    with s2d_env('off'):
        eng32 = InferenceEngine(model, dtype=torch.float32, mesh=mesh)
        eng = InferenceEngine(model, dtype=torch.bfloat16, mesh=mesh)
    got = eng32.predict_tiles(tiles)
    d32 = float(np.abs(got - refs['tiles32']).max())
    out['fp32_tiles_max_abs'] = d32
    out['fp32_tiles_bit_equal'] = bool(np.array_equal(got,
                                                      refs['tiles32']))
    del eng32
    singles, l_single = counted(wrappers, lambda: [eng.predict_image(im)
                                                   for im in images])
    group, l_group = counted(wrappers, lambda: eng.predict_images(images))
    with s2d_env('on'):
        eng_s2d = InferenceEngine(model, dtype=torch.bfloat16, mesh=mesh)
    _, l_s2d = counted(wrappers, lambda: [eng_s2d.predict_image(im)
                                          for im in images])
    del eng_s2d
    agree = {'single': [float(np.mean(a == b))
                        for a, b in zip(singles, refs['masks16'])],
             'group': [float(np.mean(a == b))
                       for a, b in zip(group, refs['masks16'])]}
    want = {'single': per_chunk(expected_chunks(sizes, k)),
            'group': per_chunk(expected_chunks(sizes, k, group=True)),
            's2d': per_chunk(expected_chunks(sizes, k), s2d=True)}
    got_l = {'single': l_single, 'group': l_group, 's2d': l_s2d}
    equal = {'single': [bool(np.array_equal(a, b))
                        for a, b in zip(singles, refs['masks16'])],
             'group': [bool(np.array_equal(a, b))
                       for a, b in zip(group, refs['masks16'])]}
    out.update({'agreement': agree, 'bit_equal': equal, 'launches': got_l})
    print(f'  {mesh.describe()}: fp32 predict_tiles (32 tiles) vs one card '
          f'max |dprob| {d32:.3e} (tol 1e-3), bit-equal '
          f'{out["fp32_tiles_bit_equal"]}; bf16 label agreement with one '
          f'card, one at a time {agree["single"]}, as a group '
          f'{agree["group"]} (>= {MESH_AGREE}), bit-equal {equal}; '
          f'launches {got_l} (expected {want})', flush=True)
    if not d32 <= 1e-3 or got_l != want or any(
            a < MESH_AGREE for v in agree.values() for a in v) or any(
            m.shape != hw for m, hw in zip(singles + group, sizes * 2)):
        raise AssertionError(f'{mesh}: {d32}, {agree}, launches {got_l} '
                             f'(expected {want})')
    out['pace'] = share_pace(torch, eng, card)
    return eng, got_l, out


def mesh_cli_phase(torch, np, wrappers, model, plain_masks, watch_masks,
                   card):
    """``python -m patchgan_tpu_torch.cli.infer -d cuda`` and
    ``patchgan_serve -d cuda --watch --once`` over every visible card:
    the header names the mesh, the masks agree with phase 3's and phase
    12's on >= MESH_AGREE of pixels, the serve run's launches a device a
    chunk. Returns the serve run's launches."""
    from patchgan_tpu_torch.cli.serve import patchgan_serve
    from patchgan_tpu_torch.parallel import default_mesh
    mesh = default_mesh()
    k = len(mesh)
    path = os.environ.get('PYTHONPATH')
    env = dict(os.environ, PYTHONPATH=ROOT + (os.pathsep + path if path
                                              else ''), PATCHGAN_S2D='off')
    with tempfile.TemporaryDirectory() as tmp:
        cfg, sizes, _ = write_inputs(tmp, torch, np)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-m', 'patchgan_tpu_torch.cli.infer', '-c', cfg,
             '-d', 'cuda'], cwd=tmp, env=env, capture_output=True,
            text=True, timeout=600)
        wall = time.perf_counter() - t0
        header = f'Running on {mesh.describe()}'
        if proc.returncode != 0 or header not in proc.stdout:
            print(proc.stdout[-2000:], proc.stderr[-3000:])
            raise AssertionError(f'patchgan_infer -d cuda exited '
                                 f'{proc.returncode}, header {header!r} '
                                 f'printed: {header in proc.stdout}')
        infer_agree = [float(np.mean(np.load(os.path.join(
            tmp, 'masks', f'{i:03d}.npy')) == want))
            for i, want in enumerate(plain_masks)]
        print(f'  python -m patchgan_tpu_torch.cli.infer -d cuda: "{header}"'
              f', {wall:.2f} s; label agreement with phase 3 {infer_agree}',
              flush=True)
        if any(a < MESH_AGREE for a in infer_agree):
            raise AssertionError(f'infer -d cuda over {k} cards: '
                                 f'{infer_agree}')
    with tempfile.TemporaryDirectory() as tmp:
        src, sizes, cfgs, _ = write_serve_inputs(tmp, np, model)
        tee = Tee(sys.stdout)
        with s2d_env('off'), contextlib.redirect_stdout(tee):
            n, launches = counted(wrappers, lambda: patchgan_serve(
                ['-c', cfgs['tiled'], '--watch', src, '--once', '-d',
                 'cuda']))
        masks = read_masks(np, os.path.join(tmp, 'tiled'), sizes)
    want = per_chunk(expected_chunks(list(sizes.values()) + [(SIZE, SIZE)],
                                     k))
    agree = {name: float(np.mean(masks[name] == watch_masks[name]))
             for name in sizes}
    print(f'  patchgan_serve -d cuda --watch --once on {mesh.describe()}: '
          f'served {n}; label agreement with phase 12 {agree}; launches '
          f'{launches} (expected {want})', flush=True)
    if n != len(sizes) or launches != want or \
            f'Serving on {mesh.describe()}' not in tee.getvalue() or \
            any(a < MESH_AGREE for a in agree.values()):
        raise AssertionError(f'serve -d cuda over {k} cards: {n}, {agree}, '
                             f'{launches}')
    return launches, {'mesh': mesh.describe(), 'infer_agreement': infer_agree,
                      'infer_wall_s': wall, 'serve_agreement': agree}


def band_forward_plan(h, sp):
    """A device's launches of each wrapper (``kernel_wrappers`` and
    ``band_wrappers``, by name) in the engine's spatial forward of an
    image ``h`` padded rows high over ``sp`` devices: ``band_plan``'s
    forward, no backward."""
    plan = band_plan(h, sp)
    del plan['gather_level']
    plan.update(in_bwd_sums=0, in_bwd_apply=0, instance_norm_act_backward=0)
    return plan


def band_probs(torch, engine, x):
    """The fp32 probabilities of the padded NCHW CPU image ``x`` from
    ``engine``'s replicas over its mesh split by rows (its
    ``BandThreads``; the engine's spatial forward without its
    postprocess), on the CPU."""
    rows = x.shape[2] // engine.n_devices

    def band(m):
        r = m.spatial.rank
        with torch.inference_mode():
            xb = x[:, :, r * rows:(r + 1) * rows].to(m.device)
            return engine._models[r](xb, mesh=m).float()

    return torch.cat([p.cpu() for p in engine.band_threads().run(
        engine._devices, band)], dim=2)


def spatial_mesh_check(torch, np, wrappers, model, refs, devices, card):
    """Spatial mode split by rows over one mesh (``devices``): the fp32
    band forward of phase 11's 640x480 image (padded 640x512) against the
    one-card fp32 forward, max |dprob| <= 1e-3, its fp32 mask and the
    1280x960 one against the one-card ones on >= MESH_AGREE of pixels; the
    bf16 1280x960 mask (no warning, equal shape and dtype, each device's
    launches ``band_forward_plan``'s) against the one-card bf16 mask,
    where a bf16 forward's own rounding decides how far they may differ:
    every pixel whose labels differ has an fp32 top-2 margin within twice
    the two bf16 forwards' errors against the fp32 forward, and the split
    mask agrees with the fp32 mask no worse than the one-card one, less
    0.05 points. (Two bf16 forwards that differ only in their sums' order
    differ near ties: phase 3's s2d and plain masks agree on 99.75-99.79%
    of pixels.) Where ``refs`` holds the bf16 mask of the card listed as
    often ('twice'), the mask agrees with it on >= MESH_AGREE. Returns
    (the bf16 engine, a device's launches by wrapper name, the
    summary)."""
    import warnings

    from patchgan_tpu_torch.inference import InferenceEngine
    from patchgan_tpu_torch.parallel import default_mesh
    mesh = default_mesh(devices)
    k = len(mesh)
    with s2d_env('off'):
        eng32 = InferenceEngine(model, dtype=torch.float32, mesh=mesh)
    d32 = (band_probs(torch, eng32, refs['x32']) -
           refs['p32']).abs().max().item()
    agree32 = [float(np.mean(eng32.predict_image(im, mode='spatial') == m))
               for im, m in ((refs['img32'], refs['mask32']),
                             (refs['big'], refs['big_mask32']))]
    del eng32
    with s2d_env('off'):
        eng = InferenceEngine(model, dtype=torch.bfloat16, mesh=mesh)
    names = [w.__name__ for w in wrappers]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        (mask, on_wgmma), launches = counted(wrappers, lambda: wgmma_counted(
            lambda: eng.predict_image(refs['big'], mode='spatial')))
    hh, ww = SPATIAL_HW
    err16 = (band_probs(torch, eng, refs['x_big'])[0, :, :hh, :ww] -
             refs['p_big32']).abs().max().item()
    want = refs['big_mask']
    differ = mask != want
    agree = float(1 - differ.mean())
    equal = bool(not differ.any())
    margin = float(refs['margin32'][differ].max()) if differ.any() else 0.0
    margin_tol = 2 * (err16 + refs['err16_one'])
    truth = float(np.mean(mask == refs['big_mask32']))
    plan = band_forward_plan(SPATIAL_PAD[0], k)
    per_device = {n: c / k for n, c in zip(names, launches)}
    band_launches = {n: c for n, c in zip(names, launches) if n in on_wgmma}
    twin = refs.get(('twice', k))
    twin_agree = None if twin is None else float(np.mean(mask == twin))
    print(f'  spatial mode split by rows over {mesh.describe()}: fp32 '
          f'640x480 (padded 640x512, {512 // k} rows a device) band forward '
          f'vs one card max |dprob| {d32:.3e} (tol 1e-3); fp32 mask '
          f'agreement 640x480 / {hh}x{ww} {agree32} (>= {MESH_AGREE}); bf16 '
          f'{ww}x{hh} mask {mask.shape} {mask.dtype}: agreement with the '
          f'one-card bf16 mask {agree:.6f}, bit-equal {equal}; the bf16 '
          f'band forward vs fp32 max |dprob| {err16:.3e} (one card '
          f'{refs["err16_one"]:.3e}); largest fp32 top-2 margin where the '
          f'labels differ {margin:.3e} (<= {margin_tol:.3e}); agreement '
          f'with the fp32 mask {truth:.5f} (one card '
          f'{refs["truth_one"]:.5f}); agreement with the card listed '
          f'{k} times {twin_agree}; warnings {len(caught)}; a device\'s '
          f'launches {per_device} (plan {plan}); the bf16 band launches '
          f'on the wgmma core {on_wgmma} of {band_launches}', flush=True)
    if not d32 <= 1e-3 or min(agree32) < MESH_AGREE or \
            mask.shape != want.shape or mask.dtype != want.dtype or \
            caught or margin > margin_tol or \
            truth < refs['truth_one'] - 5e-4 or \
            (twin_agree is not None and twin_agree < MESH_AGREE) or \
            launches != [k * plan[n] for n in names] or \
            on_wgmma != band_launches:
        raise AssertionError(f'spatial over {mesh}: {d32}, {agree32}, '
                             f'{mask.shape} {mask.dtype}, '
                             f'{[str(w.message) for w in caught]}, margin '
                             f'{margin} > {margin_tol}, fp32 agreement '
                             f'{truth} (one card {refs["truth_one"]}), '
                             f'twin {twin_agree}, launches {launches} (plan '
                             f'{plan} x {k}), on the wgmma core {on_wgmma}')
    return eng, mask, per_device, {
        'mesh': mesh.describe(), 'fp32_max_abs_dprob': d32,
        'fp32_mask_agreement': agree32, 'bf16_mask_agreement': agree,
        'bf16_mask_bit_equal': equal, 'bf16_max_abs_dprob_vs_fp32': err16,
        'max_margin_where_labels_differ': margin,
        'bf16_agreement_with_fp32_mask': truth,
        'agreement_with_card_listed_k_times': twin_agree,
        'device_launches': per_device,
        'band_launches_wgmma': {n: c / k for n, c in on_wgmma.items()}}


def spatial_fallback_check(torch, np, model, refs):
    """A mesh of the first card listed three times: the padded 1024 rows
    do not split into 3 even bands, so spatial mode warns and runs on the
    home card, its mask bit-equal to the one-card mask."""
    import warnings

    from patchgan_tpu_torch.inference import InferenceEngine
    from patchgan_tpu_torch.parallel import default_mesh
    with s2d_env('off'):
        eng = InferenceEngine(model, dtype=torch.bfloat16,
                              mesh=default_mesh(['cuda:0'] * 3))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        mask = eng.predict_image(refs['big'], mode='spatial')
    warned = any('does not split' in str(w.message) for w in caught)
    equal = bool(np.array_equal(mask, refs['big_mask']))
    print(f'  spatial mode on cuda:0 x3 ({SPATIAL_PAD[0]} rows do not split '
          f'into 3 even bands): warned {warned}, mask bit-equal to one card '
          f'{equal}', flush=True)
    if not warned or not equal:
        raise AssertionError(f'spatial fallback on 3 devices: warned '
                             f'{warned}, bit-equal {equal}')
    return {'warned': warned, 'bit_equal': equal}


def band_pace(torch, engine, image, card, runs=13):
    """Host ms for each device's thread (the engine's ``BandThreads``) to
    issue its band forward of ``image`` (bf16, its band already on its
    card; the waits for the other threads' turns included) against that
    forward's ms on its card (events around it),
    medians of the last ``runs - 3`` runs: whether the host or the cards
    set the pace."""
    k = engine.n_devices
    ph, pw = (-(-n // 128) * 128 for n in image.shape[:2])
    x = torch.rand(1, IN_C, ph, pw, generator=torch.Generator()
                   .manual_seed(5))
    rows = ph // k
    bands = [x[:, :, r * rows:(r + 1) * rows].to(d)
             for r, d in enumerate(engine._devices)]

    def issue(m):
        r = m.spatial.rank
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with torch.inference_mode():
            t0 = time.perf_counter()
            start.record()
            engine._models[r](bands[r], mesh=m)
            end.record()
            return (time.perf_counter() - t0) * 1e3, start, end

    host = [[] for _ in range(k)]
    dev = [[] for _ in range(k)]
    for _ in range(runs):
        for d in set(engine._devices):
            torch.cuda.synchronize(d)
        for r, (ms, start, end) in enumerate(engine.band_threads().run(
                engine._devices, issue)):
            end.synchronize()
            host[r].append(ms)
            dev[r].append(start.elapsed_time(end))
    rows_out = [{'device': str(d), 'rows': rows,
                 'host_issue_ms': statistics.median(host[r][3:]),
                 'device_ms': statistics.median(dev[r][3:])}
                for r, d in enumerate(engine._devices)]
    issue_ms = max(r['host_issue_ms'] for r in rows_out)
    slowest = max(r['device_ms'] for r in rows_out)
    bound = 'host' if issue_ms >= slowest else 'cards'
    print(f'  band pace, {k} devices, {pw}x{ph} padded: host issue ms a '
          f'device {[round(r["host_issue_ms"], 3) for r in rows_out]}, '
          f'device ms {[round(r["device_ms"], 3) for r in rows_out]}: the '
          f'{bound} set the pace on {card}', flush=True)
    return {'bands': rows_out, 'host_issue_ms_max': issue_ms,
            'slowest_device_ms': slowest, 'bound_by': bound}


def spatial_peaks(torch, engine, image):
    """Each distinct card's peak bytes in one spatial call of ``engine``
    on ``image``, and above what it held before the call."""
    devices = sorted(set(engine._devices), key=str)
    before = {}
    for d in devices:
        torch.cuda.synchronize(d)
        torch.cuda.reset_peak_memory_stats(d)
        before[d] = torch.cuda.memory_allocated(d)
    engine.predict_image(image, mode='spatial')
    out = {}
    for d in devices:
        torch.cuda.synchronize(d)
        peak = torch.cuda.max_memory_allocated(d)
        out[str(d)] = {'peak_bytes': peak, 'own_peak_bytes':
                       peak - before[d]}
    return out


def spatial_cli_check(torch, np, refs):
    """``python -m patchgan_tpu_torch.cli.infer -d cuda`` with
    ``infer_params.mode: spatial`` over every card: the header names the
    mesh, each mask equals the engine's spatial mask over every card in
    this process on >= MESH_AGREE of pixels (its agreement with one
    card's is printed: bf16 rounding, ``spatial_mesh_check``)."""
    import yaml

    from patchgan_tpu_torch.parallel import default_mesh
    from patchgan_tpu_torch.parallel.spatial import even_bands
    mesh = default_mesh()
    path = os.environ.get('PYTHONPATH')
    env = dict(os.environ, PYTHONPATH=ROOT + (os.pathsep + path if path
                                              else ''), PATCHGAN_S2D='off')
    with tempfile.TemporaryDirectory() as tmp:
        cfg, sizes, _ = write_inputs(tmp, torch, np)
        with open(cfg) as f:
            conf = yaml.safe_load(f)
        conf['infer_params']['mode'] = 'spatial'
        with open(cfg, 'w') as f:
            yaml.safe_dump(conf, f)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-m', 'patchgan_tpu_torch.cli.infer', '-c', cfg,
             '-d', 'cuda'], cwd=tmp, env=env, capture_output=True,
            text=True, timeout=600)
        wall = time.perf_counter() - t0
        header = f'Running on {mesh.describe()}'
        # every image's padded height splits over 2 and 4 cards
        split = all(even_bands(-(-hh // 128) * 128, len(mesh))
                    for hh, _ in sizes)
        fell_back = 'does not split' in proc.stderr
        if proc.returncode != 0 or header not in proc.stdout or \
                fell_back == split:
            print(proc.stdout[-2000:], proc.stderr[-3000:])
            raise AssertionError(f'patchgan_infer -d cuda, mode spatial, '
                                 f'exited {proc.returncode}, header printed '
                                 f'{header in proc.stdout}, fell back '
                                 f'{fell_back} (split {split})')
        masks = [np.load(os.path.join(tmp, 'masks', f'{i:03d}.npy'))
                 for i in range(len(sizes))]
    agree = [float(np.mean(m == want))
             for m, want in zip(masks, refs['masks_every'])]
    agree_one = [float(np.mean(m == want))
                 for m, want in zip(masks, refs['masks_one'])]
    print(f'  python -m patchgan_tpu_torch.cli.infer -d cuda, mode spatial: '
          f'"{header}", {wall:.2f} s; label agreement with the engine\'s '
          f'spatial masks over every card {agree} (>= {MESH_AGREE}), with '
          f'one card\'s {agree_one}', flush=True)
    if any(a < MESH_AGREE for a in agree):
        raise AssertionError(f'infer -d cuda spatial over {len(mesh)} cards: '
                             f'{agree}')
    return {'mesh': mesh.describe(), 'agreement': agree,
            'agreement_one_card': agree_one, 'wall_s': wall,
            'fell_back': fell_back}


def spatial_mesh_phase(torch, np, wrappers, model, one, images, layouts,
                       card):
    """Phase 15's spatial mode split by rows: ``spatial_mesh_check`` on
    every mesh of ``layouts`` (the card listed twice always) and the
    3-device fallback; where there are two or more cards, masks/s of the
    1280x960 image and of a SPATIAL_BIG one at 1, 2 and min(cards, 4)
    cards in turns with each card's peak, the bands' pace, and
    ``patchgan_infer -d cuda`` in spatial mode. ``one``: the one-card bf16
    engine. Returns ({path: a device's launches by wrapper name}, the
    summary)."""
    from patchgan_tpu_torch.inference import InferenceEngine
    from patchgan_tpu_torch.parallel import default_mesh

    def padded(im, ph):
        x = np.zeros((ph,) + im.shape[1:], np.float32)
        x[:im.shape[0]] = im
        return torch.from_numpy(x).permute(2, 0, 1)[None].contiguous()

    img32 = np.random.default_rng(12).random((480, 640, IN_C),
                                             dtype=np.float32)
    big = images[0]
    x32, x_big = padded(img32, 512), padded(big, SPATIAL_PAD[0])
    hh, ww = SPATIAL_HW
    with s2d_env('off'):
        one32 = InferenceEngine(model, dtype=torch.float32)
    with torch.inference_mode():
        p32 = one32.model(x32.cuda()).float().cpu()
        p_big32 = one32.model(x_big.cuda()).float()[0, :, :hh, :ww].cpu()
        p_big16 = one.model(x_big.cuda()).float()[0, :, :hh, :ww].cpu()
    top2 = p_big32.topk(2, dim=0).values
    refs = {'x32': x32, 'p32': p32, 'img32': img32, 'x_big': x_big,
            'p_big32': p_big32, 'margin32': (top2[0] - top2[1]).numpy(),
            'err16_one': (p_big16 - p_big32).abs().max().item(),
            'mask32': one32.predict_image(img32, mode='spatial'),
            'big': big,
            'big_mask32': one32.predict_image(big, mode='spatial'),
            'big_mask': one.predict_image(big, mode='spatial')}
    refs['truth_one'] = float(np.mean(refs['big_mask'] ==
                                      refs['big_mask32']))
    del one32
    paths, out, engines = {}, {}, {'1 card': one}
    for label, devices in layouts.items():
        k = len(devices)
        if label != 'cuda:0 x2' and ('twice', k) not in refs:
            # the same bands on the first card: a mesh of real cards must
            # agree with its mask
            _, refs[('twice', k)], _, _ = spatial_mesh_check(
                torch, np, wrappers, model, refs, ['cuda:0'] * k, card)
        engines[label], mask, per_device, out[label] = spatial_mesh_check(
            torch, np, wrappers, model, refs, devices, card)
        if label == 'cuda:0 x2':
            refs[('twice', 2)] = mask
        tag = label.replace(' ', '_').replace(':', '')
        paths[f'spatial_mesh_{tag}_device'] = per_device
    out['fallback'] = spatial_fallback_check(torch, np, model, refs)
    if len(layouts) == 1:
        print(f'  15b spatial timing not run: this machine has '
              f'{torch.cuda.device_count()} card', flush=True)
        return paths, out
    del engines['cuda:0 x2']
    survey = (np.random.default_rng(13).random(SPATIAL_BIG + (IN_C,)) *
              255).astype(np.uint8)
    sizes = {f'{SPATIAL_HW[1]}x{SPATIAL_HW[0]}': big,
             f'{SPATIAL_BIG[1]}x{SPATIAL_BIG[0]}': survey}
    out['peaks'], out['pace'] = {}, {}
    fns = {}
    for label, eng in engines.items():
        for size, im in sizes.items():
            out['peaks'][f'{label} {size}'] = spatial_peaks(torch, eng, im)
            if label != '1 card':
                out['pace'][f'{label} {size}'] = band_pace(torch, eng, im,
                                                           card)

            def call(e=eng, im=im):
                e.predict_image(im, mode='spatial')
                return 1
            fns[f'{label} {size}'] = call
    print(f'  peak bytes a card: {out["peaks"]}', flush=True)
    readings = mesh_rates(fns, 'spatial bf16')
    out['masks_per_s'] = {}
    for name, r in readings.items():
        med = statistics.median(r)
        out['masks_per_s'][name] = {'median': med, 'windows': r}
        print(f'  spatial bf16 {name}: median {med:.3f} masks/s (min '
              f'{min(r):.3f}, max {max(r):.3f}) over {MESH_WINDOWS} windows '
              f'of >= {WINDOW_S} s on {card}', flush=True)
    del engines, fns
    with s2d_env('off'):
        every = InferenceEngine(model, dtype=torch.bfloat16,
                                mesh=default_mesh())
    refs['masks_every'] = [every.predict_image(im, mode='spatial')
                           for im in images]
    refs['masks_one'] = [one.predict_image(im, mode='spatial')
                         for im in images]
    del every
    out['cli'] = spatial_cli_check(torch, np, refs)
    return paths, out


def mesh_phase(torch, np, F, kernels, model, plain_masks, watch_masks,
               card):
    """Phase 15: the engine over the cards of one process (see the
    module's docstring). Returns (launches by path, the summary)."""
    from patchgan_tpu_torch.inference import InferenceEngine
    wrappers = [k.wrapper for k in kernels]
    names = [k.name for k in kernels]
    t0 = time.perf_counter()
    with torch.inference_mode():
        out = {'card': card, 'split_check': split_check(torch, F,
                                                        kernels[:3])}
    model = model.to(torch.float32).eval()
    with tempfile.TemporaryDirectory() as tmp:
        _, sizes, _ = write_inputs(tmp, torch, np)
        images = [np.load(os.path.join(tmp, 'images', f'{i:03d}.npz'))
                  ['image'] for i in range(len(sizes))]
    with s2d_env('off'):
        one32 = InferenceEngine(model, dtype=torch.float32)
        one = InferenceEngine(model, dtype=torch.bfloat16)
    refs = {'tiles32': one32.predict_tiles(np.random.default_rng(1).random(
        (32, SIZE, SIZE, IN_C), dtype=np.float32)),
        'masks16': [one.predict_image(im) for im in images]}
    del one32
    paths, engines = {}, {}
    layouts = mesh_layouts(torch)
    if len(layouts) == 1:
        print(f'  15b not run: this machine has {torch.cuda.device_count()} '
              f'card; meshes of 2 and 4 cards need as many', flush=True)
    for label, devices in layouts.items():
        engines[label], launches, out[label] = mesh_check(
            torch, np, wrappers, model, images, sizes, devices, refs, card)
        tag = label.replace(' ', '_').replace(':', '')
        paths.update({f'mesh_{tag}_{run}': dict(zip(names, n))
                      for run, n in launches.items()})

    big = images[0]
    paths_sp, out['spatial'] = spatial_mesh_phase(
        torch, np, wrappers + band_wrappers(), model, one, images, layouts,
        card)
    paths.update(paths_sp)

    timed = {'1 card': one}
    timed.update({label: eng for label, eng in engines.items()
                  if len(layouts) == 1 or label != 'cuda:0 x2'})
    group = [big] * MESH_GROUP

    def single(eng):
        eng.predict_image(big)
        return 1

    fns = {}
    for label, eng in timed.items():
        fns[f'{label} single'] = (lambda e=eng: single(e))
        fns[f'{label} group'] = (lambda e=eng: len(e.predict_images(group)))
    widest = list(timed)[-1]
    fns[f'{widest} group pending'] = PendingGroups(timed[widest], group)
    readings = mesh_rates(fns, f'{SPATIAL_HW[1]}x{SPATIAL_HW[0]}')
    out['masks_per_s'] = {}
    for name, r in readings.items():
        med = statistics.median(r)
        out['masks_per_s'][name] = {'median': med, 'windows': r}
        print(f'  1280x960 bf16 {name}: median {med:.3f} masks/s (min '
              f'{min(r):.3f}, max {max(r):.3f}) over {MESH_WINDOWS} windows '
              f'of >= {WINDOW_S} s on {card}', flush=True)
    del engines, timed, fns
    launches, out['cli'] = mesh_cli_phase(torch, np, wrappers, model,
                                          plain_masks, watch_masks, card)
    paths['mesh_serve_watch'] = dict(zip(names, launches))
    out['phase_wall_s'] = time.perf_counter() - t0
    return paths, out


def mesh_only(torch, np, F, kernels, card):
    """``python3 chip_smoke.py --mesh-only``: phase 15 alone, after the
    references it holds the engine against, both on one card (``-d
    cuda:0``): phase 3's patchgan_infer masks and a patchgan_serve
    --watch run's."""
    from patchgan_tpu_torch.cli.serve import patchgan_serve
    print('== phase 3 (the reference masks): patchgan_infer -d cuda:0',
          flush=True)
    _, model, plain_masks = infer_path_phase(torch, np, kernels, 'off',
                                             'cuda:0')
    with tempfile.TemporaryDirectory() as tmp:
        src, sizes, cfgs, _ = write_serve_inputs(tmp, np, model)
        with s2d_env('off'):
            patchgan_serve(['-c', cfgs['tiled'], '--watch', src, '--once',
                            '-d', 'cuda:0'])
        watch_masks = read_masks(np, os.path.join(tmp, 'tiled'), sizes)
    print('== the engine over the cards of one process', flush=True)
    _, mesh = mesh_phase(torch, np, F, kernels, model, plain_masks,
                         watch_masks, card)
    print(json.dumps({'mesh': mesh}))
    print(card)


# phase 16: data x model parallel training (ROADMAP item 11c)
TP = 2                  # the model axis of 16a and of 16b's grids
TP_STEPS = 3            # steps of each 16a run
# 16a's runs: (form, activation, held to the limits). tanh is held, as in
# 14b; relu (config 2's) is read beside it: a shard's K split follows its
# Cout, as a rank's follows its batch in 14b, and ReLU turns rounding into
# gradient jumps (tools/dp_rounding.py)
TP_RUNS = (('off', 'tanh', True), ('on', 'tanh', True),
           ('off', 'relu', False))
TP_JOIN_S = 300         # a spawned rank that has not ended by then hung


def tp_kernel_phase(torch, F, kernels):
    """16: each kernel at a rank's shard shapes of the step at batch
    TRAIN_B, 256 px (every level's output channels over TP, and over 4,
    where K2 meets Cout 32 and K3 16): K1 (enc0), K2 (enc1-enc6), K3
    (dec1-dec5), K1-bwd (the 12 normed levels), K4 and K4-wgrad (the s2d
    boundary convs), bf16 and fp32, against their plain versions with the
    kernel phase's tolerances; at TP the bf16 ms of K1-K3 (kernel, plain,
    library) beside the bound. Returns the timed rows."""
    k1, k2, k3, k1b, k4, k4w = kernels
    gen = torch.Generator(device='cuda').manual_seed(16)
    rows = []

    def check(kernel, label, args, plain_args, tol):
        got = kernel.wrapper(*args).float()
        want = kernel.plain(*plain_args).float()
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        tol = tol(want)
        print(f'  {kernel.name} {label}: max_abs_err {e:.3e} (tol '
              f'{tol:.3e})', flush=True)
        if not e <= tol:
            raise AssertionError(f'16: {kernel.name} {label}: {e} > {tol}')
        return e

    def fp32(args):
        return tuple(a.float() if torch.is_tensor(a) else a for a in args)

    for tp in (TP, 4):
        for kernel, label, make, library, flops, elems, _ in make_cases(
                torch, F, (k1, k2, k3), TRAIN_B, SIZE, SIZE, tp):
            errs = {dname: check(kernel, f'tp {tp} {label} {dname}',
                                 make(dt), fp32(make(dt)),
                                 lambda want, d=dname: TOL[d])
                    for dname, dt in (('bfloat16', torch.bfloat16),
                                      ('float32', torch.float32))}
            if tp != TP:
                continue
            args = make(torch.bfloat16)
            peak = PEAK_FP32 if kernel is k1 else PEAK_BF16
            b_ms, b_by = bound(flops, 2 * elems, peak)
            row = {'kernel': kernel.name, 'case': f'tp {tp} {label}',
                   'dtype': 'bfloat16',
                   'kernel_ms': cuda_ms(lambda: kernel.wrapper(*args)),
                   'plain_ms': cuda_ms(lambda: kernel.plain(*args)),
                   'library_ms': cuda_ms(lambda: library(*args)),
                   'bound_ms': b_ms, 'bound_by': b_by,
                   'max_abs_err_bf16': errs['bfloat16'],
                   'max_abs_err_fp32': errs['float32']}
            rows.append(row)
            print(json.dumps(row), flush=True)
        for label, (n, c, h, w) in bwd_shapes():
            x = torch.randn(n, c // tp, h, w, generator=gen, device='cuda')
            g = torch.randn(n, c // tp, h, w, generator=gen, device='cuda')
            for dname, dt in (('bfloat16', torch.bfloat16),
                              ('float32', torch.float32)):
                check(k1b, f'tp {tp} {label} {tuple(x.shape)} {dname}',
                      (g.to(dt), x.to(dt), 1e-5, 'relu'),
                      (g.to(dt).float(), x.to(dt).float(), 1e-5, 'relu'),
                      lambda want, d=dname: TOL_BWD[d] * max(
                          1.0, want.abs().max().item()))
        for label, cin in (('enc0 / D conv0 image', 4 * IN_C),
                           ('D conv0 mask', 4 * OUT_C)):
            cout, hw = NF // tp, SIZE // 2
            x = torch.randn(TRAIN_B, cin, hw, hw, generator=gen,
                            device='cuda')
            w = torch.randn(cout, cin, 3, 3, generator=gen, device='cuda') \
                * 0.5 / (9 * cin) ** 0.5
            dy = torch.randn(TRAIN_B, cout, hw, hw, generator=gen,
                             device='cuda')
            for dname, dt in (('bfloat16', torch.bfloat16),
                              ('float32', torch.float32)):
                xd, wd, dyd = x.to(dt), w.to(dt), dy.to(dt)
                check(k4, f'tp {tp} {label} -> {cout} {dname}', (xd, wd),
                      (xd.float(), wd.float()), lambda want, d=dname: TOL[d])
                check(k4w, f'tp {tp} {label} -> {cout} {dname}', (xd, dyd),
                      (xd.float(), dyd.float()),
                      lambda want: 1e-3 * max(1.0, want.abs().max().item()))
    return rows


def tp_run(torch, np, mesh, form, activation):
    """TP_STEPS fp32 eager steps at config 2's widths from fixed seeds on
    seeded global batches of TRAIN_B, dropout on, in the form ``form``
    ('off' or 'on'); over a ``mesh`` (a ``HybridMesh``) the state placed
    on it, this rank's data rows, and the replicated parameters checked
    bit-equal over the model group. Returns (each step's losses, the
    whole G and D state_dicts on the host, the replicated tensors)."""
    from patchgan_tpu_torch.models import Discriminator, UNet
    from patchgan_tpu_torch.parallel import (gather_hybrid_state,
                                             model_parallel_shardings,
                                             place_hybrid_state)
    from patchgan_tpu_torch.train.steps import make_optimizer, \
        make_train_step
    init = torch.Generator().manual_seed(9)
    gen = UNet(IN_C, OUT_C, nf=NF, use_dropout=True, activation=activation,
               final_act='softmax', generator=init).cuda()
    disc = Discriminator(IN_C + OUT_C, ndf=NDF, n_layers=3,
                         generator=init).cuda()
    gen.dropout_generator = torch.Generator(device='cuda').manual_seed(1)
    opts = [make_optimizer(m.parameters(), LR) for m in (gen, disc)]
    if mesh is not None:
        place_hybrid_state(gen, disc, opts, mesh)
    step = make_train_step(gen, disc, *opts, s2d=form == 'on', mesh=mesh)
    losses = []
    for i in range(TP_STEPS):
        x, y = train_batch(torch, np, TRAIN_B, SIZE, 'cuda', 90 + i)
        if mesh is not None:
            x, y = mesh.local_rows((x, y))
        losses.append({k: float(v) for k, v in step(x, y).items()})
    replicated = []
    if mesh is None:
        states = (gen.state_dict(), disc.state_dict())
    else:
        for m in (gen, disc):
            dims = model_parallel_shardings(m, mesh.model.size)
            replicated += [p for n, p in m.named_parameters()
                           if dims[n] is None]
        mesh.model.check_replicated(replicated, 'replicated parameters')
        states = gather_hybrid_state(gen, disc, opts, mesh)[:2]
    return (losses, [{k: v.cpu() for k, v in sd.items()} for sd in states],
            len(replicated))


def tp_gloo_child():
    """``python -c 'import chip_smoke; chip_smoke.tp_gloo_child()' RANK
    PORT OUT``: one of 16a's two gloo ranks (dp 1 x tp 2) on card 0: in
    each run of TP_RUNS the launches of its TP_STEPS steps (the counts
    set to 0 just before, read just after) and their seconds into
    OUT/rank_RANK.json; rank 0 also its losses and the gathered state
    into OUT/tp_FORM_ACTIVATION.pt."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from patchgan_tpu_torch.parallel import hybrid_mesh
    rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                            rank=rank, world_size=TP)
    mesh = hybrid_mesh(1, TP, 'cuda:0')
    wrappers = kernel_wrappers()
    record = {}
    for form, activation, _ in TP_RUNS:
        for w in wrappers:
            w.launches = 0
        t0 = time.perf_counter()
        losses, states, n_repl = tp_run(torch, np, mesh, form, activation)
        torch.cuda.synchronize()
        name = f'{form}_{activation}'
        record[name] = {'losses': losses, 'replicated': n_repl,
                        'launches': [w.launches for w in wrappers],
                        'seconds': time.perf_counter() - t0}
        if rank == 0:
            torch.save({'losses': losses, 'states': states},
                       os.path.join(out, f'tp_{name}.pt'))
    with open(os.path.join(out, f'rank_{rank}.json'), 'w') as f:
        json.dump(record, f)
    dist.destroy_process_group()


def hybrid_limits(want, got):
    """(losses' worst excess over rtol 5e-4 / atol 2e-5, the smallest
    share of a tensor's values within 2e-4 + 5e-3 |b|, the largest |diff|)
    of ``got`` (losses, states) against one process's ``want``: JAX's
    hybrid limits (``tests/test_distributed.py:98-116``) are <= 0, >=
    0.999 and <= 2.5e-3."""
    excess = max(abs(g[k] - w[k]) - 2e-5 - 5e-4 * abs(w[k])
                 for w, g in zip(want[0], got[0]) for k in w)
    tight, worst = 1.0, 0.0
    for w_sd, g_sd in zip(want[1], got[1]):
        for k, b in w_sd.items():
            diff = (g_sd[k] - b).abs()
            tight = min(tight, float((diff <= 2e-4 + 5e-3 * b.abs())
                                     .float().mean()))
            worst = max(worst, float(diff.max()))
    return excess, tight, worst


def tp_gloo_phase(torch, np, card, tmp):
    """16a: two gloo ranks sharing card 0 (dp 1 x tp 2), fp32, eager,
    dropout on, TP_STEPS steps of config 2's widths at a global batch of
    TRAIN_B in each run of TP_RUNS (tanh in the plain and the s2d form,
    relu in the plain), from one seeded state, against one process on
    the same card from the same seeds (deterministic cuDNN): each step's
    losses and the gathered weights within JAX's hybrid limits
    (``hybrid_limits``) in the held runs, read in the other; in every
    run both ranks' losses equal, the replicated parameters bit-equal
    over the model group (in the ranks), each rank's launches TP_STEPS x
    ``STEP`` of the form. Returns ({form: rank 0's launches in its held
    run}, the summary)."""
    out_dir = os.path.join(tmp, 'tp_gloo')
    os.makedirs(out_dir)
    port = free_port()
    t0 = time.perf_counter()
    run_ranks([[sys.executable, '-c',
                'import chip_smoke; chip_smoke.tp_gloo_child()', str(rank),
                str(port), out_dir] for rank in range(TP)], tmp, 'tp_gloo',
              timeout=TP_JOIN_S)
    wall = time.perf_counter() - t0
    ranks = []
    for rank in range(TP):
        with open(os.path.join(out_dir, f'rank_{rank}.json')) as f:
            ranks.append(json.load(f))
    summary, launches, failed = {'wall_s': wall}, {}, []
    with cudnn_flags_kept(torch):
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        for form, activation, held in TP_RUNS:
            name = f'{form}_{activation}'
            t1 = time.perf_counter()
            losses, states, _ = tp_run(torch, np, None, form, activation)
            one_s = time.perf_counter() - t1
            got = torch.load(os.path.join(out_dir, f'tp_{name}.pt'),
                             weights_only=True)
            excess, tight, worst = hybrid_limits(
                (losses, states), (got['losses'], got['states']))
            want_launches = [TP_STEPS * n for n in STEP[form]]
            per_rank = [r[name]['launches'] for r in ranks]
            same = all(r[name]['losses'] == ranks[0][name]['losses']
                       for r in ranks)
            within = excess <= 0 and tight >= 0.999 and worst <= 2.5e-3
            if held:
                launches[form] = per_rank[0]
            summary[name] = {
                'held': held, 'within_limits': within,
                'loss_excess': excess, 'min_tight_share': tight,
                'max_abs_diff': worst, 'ranks_losses_equal': same,
                'launches_per_rank': per_rank,
                'replicated_tensors': ranks[0][name]['replicated'],
                'rank_seconds': [r[name]['seconds'] for r in ranks],
                'one_process_seconds': one_s}
            print(f'  s2d {form}, {activation}'
                  f'{"" if held else " (a reading, not held)"}: tp 2 '
                  f'against one process over {TP_STEPS} steps: worst loss '
                  f'excess over rtol 5e-4 / atol 2e-5 {excess:.3e} (<= 0), '
                  f'the least share of a tensor within 2e-4 + 5e-3|b| '
                  f'{tight:.6f} (>= 0.999), max |diff| {worst:.3e} (<= '
                  f'2.5e-3): within the limits {within}; ranks\' losses '
                  f'equal {same}; {ranks[0][name]["replicated"]} replicated '
                  f'tensors bit-equal over the model group; launches a rank '
                  f'{per_rank} (expected {want_launches}); the ranks took '
                  f'{[round(r[name]["seconds"], 2) for r in ranks]} s, one '
                  f'process {one_s:.2f} s on {card}', flush=True)
            if not same or any(p != want_launches for p in per_rank) or \
                    (held and not within):
                failed.append(name)
    if failed:
        raise AssertionError(f'16a: the tp-2 step disagrees with one '
                             f'process in {failed}')
    return launches, summary


def tp_scale_child():
    """``python -c 'import chip_smoke; chip_smoke.tp_scale_child()' RANK
    DP TP PORT OUT``: one NCCL rank on card RANK of 16b: the captured
    bf16 step at config 2 (global batch 16) over a (DP, TP) grid (a
    DataMesh at TP 1), its img/s a card in windows of DP_SCALE_STEPS
    steps, the peak memory and the parameter and optimizer bytes of a
    rank; then the step's collectives alone, each set captured on its
    graph communicator and timed over 20 replays: the model group's
    all-gathers and all-reduces at the shapes and dtypes the eager first
    step issued, and the data group's gradient bucket; rank 0 writes
    OUT/grid_DPxTP.json."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from patchgan_tpu_torch.parallel import (DataMesh, hybrid_mesh,
                                             place_hybrid_state, shutdown)
    from patchgan_tpu_torch.parallel.sharding import optimizer_state
    rank, dp, tp, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                               int(sys.argv[3]), int(sys.argv[4]),
                               sys.argv[5])
    world = dp * tp
    device = torch.device('cuda', rank)

    def stage(text):
        print(f'  rank {rank} of ({dp}, {tp}): {text}', flush=True)

    torch.cuda.set_device(device)
    dist.init_process_group('nccl', init_method=f'tcp://127.0.0.1:{port}',
                            rank=rank, world_size=world, device_id=device)
    mesh = hybrid_mesh(dp, tp, device) if tp > 1 else DataMesh(device)
    stage('the groups formed')
    gen, disc = train_models(torch)
    step, opts = config_step(torch, gen, disc, 'off', False, 1, True,
                             mesh=mesh)
    if tp > 1:
        place_hybrid_state(gen, disc, opts, mesh)
    x, y = (t.to(torch.bfloat16) for t in mesh.local_rows(train_batch(
        torch, np, TRAIN_B, SIZE, 'cuda', 8)))
    # the model group's collectives of the eager first step: (gather or
    # not, shape, dtype)
    issued, model = [], mesh.model
    if model is not None:
        gather, reduce = model._all_gather, model._all_reduce
        model._all_gather = lambda t, g: (
            issued.append((True, t.shape, t.dtype)), gather(t, g))[1]
        model._all_reduce = lambda t, g: (
            issued.append((False, t.shape, t.dtype)), reduce(t, g))[1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    for i in range(3):
        step(x, y)
        torch.cuda.synchronize()
        if i == 0 and model is not None:
            del model._all_gather, model._all_reduce
            first = list(issued)
        stage(f'step {i + 1} (eager, capture, replay) done')
    peak = torch.cuda.max_memory_allocated(device)
    rates = []
    for i in range(DP_WINDOWS):
        mesh.barrier()
        t0 = time.perf_counter()
        for _ in range(DP_SCALE_STEPS):
            step(x, y)
        torch.cuda.synchronize()
        rates.append(TRAIN_B * DP_SCALE_STEPS / (time.perf_counter() - t0)
                     / world)
    stage('windows done')
    comm = {}
    if model is not None:
        for kind, gathers in (('all_gather', True), ('all_reduce', False)):
            bufs = [torch.zeros(shape, dtype=dtype, device=device)
                    for g, shape, dtype in first if g == gathers]
            op = gather if gathers else reduce
            mesh.barrier()
            comm[kind] = {
                'calls': len(bufs),
                'mb': sum(b.numel() * b.element_size() for b in bufs)
                * (tp if gathers else 1) / 1e6,
                'ms': captured_ms(torch, lambda: [
                    op(b, model.graph_group) for b in bufs])}
    if mesh.data.size > 1:
        bucket = [torch.zeros_like(p) for m in (gen, disc)
                  for p in m.parameters()]
        mesh.barrier()
        comm['gradient_bucket'] = {
            'mb': sum(b.numel() * 4 for b in bucket) / 1e6,
            'ms': captured_ms(torch, lambda: mesh.data.sum_(bucket))}
    stage('the collectives timed')
    if rank == 0:
        params = [p for m in (gen, disc) for p in m.parameters()]
        state = [t for opt in opts for lst in optimizer_state(opt)[1]
                 for t in lst]
        with open(os.path.join(out, f'grid_{dp}x{tp}.json'), 'w') as f:
            json.dump({'img_per_s_per_card': rates, 'peak_bytes': peak,
                       'param_bytes': sum(p.numel() * p.element_size()
                                          for p in params),
                       'moment_bytes': sum(t.numel() * t.element_size()
                                           for t in state),
                       'collectives': comm, 'replays': step.replays}, f)
    shutdown(mesh)
    stage('the groups destroyed')


def tp_aot(tmp, dp, tp, card):
    """``patchgan_aot --dp DP --tp TP -d cuda`` at config 2 under
    ``torch.distributed.run --nproc_per_node DP * TP``: compile_ok and
    fits; its per-rank lines (the activation gathers' and their backward
    sums' bytes and NVLink bounds) parsed."""
    path = os.environ.get('PYTHONPATH')
    env = dict(os.environ, PYTHONPATH=ROOT + (os.pathsep + path if path
                                              else ''), PATCHGAN_S2D='off')
    cfg = write_aot_config(tmp)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'torch.distributed.run', '--nnodes', '1',
         '--nproc_per_node', str(dp * tp), '--master_addr', '127.0.0.1',
         '--master_port', str(free_port()), '-m',
         'patchgan_tpu_torch.cli.aot', '-c', cfg, '--dp', str(dp), '--tp',
         str(tp), '-d', 'cuda'], cwd=tmp, env=env, capture_output=True,
        text=True, timeout=TP_JOIN_S)
    wall = time.perf_counter() - t0
    print(proc.stdout[-2500:], end='')
    if proc.returncode != 0:
        print(proc.stderr[-3000:])
        raise AssertionError(f'aot --dp {dp} --tp {tp} exited '
                             f'{proc.returncode}')
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    gathers = re.search(r'activation gathers .*?: ([\d.]+) MB a step '
                        r'gathered, ring bound ([\d.]+) ms .*?backward sums '
                        r'([\d.]+) MB, ring bound ([\d.]+) ms', proc.stdout)
    allreduce = re.search(r'gradient all-reduce: .*? ring bound is '
                          r'([\d.]+) ms', proc.stdout)
    if rec['compile_ok'] is not True or \
            rec['memory_per_device']['fits'] is not True or \
            rec['mesh'] != {'data': dp, 'model': tp} or gathers is None:
        raise AssertionError(f'aot --dp {dp} --tp {tp}: {rec}')
    out = {'json': rec, 'wall_s': wall,
           'gather_mb': float(gathers[1]), 'gather_bound_ms':
           float(gathers[2]), 'reduce_mb': float(gathers[3]),
           'reduce_bound_ms': float(gathers[4]),
           'grad_allreduce_bound_ms': float(allreduce[1]) if allreduce
           else None}
    print(f'  aot --dp {dp} --tp {tp}: compile_ok, fits, peak '
          f'{rec["memory_per_device"]["peak_bytes"]} bytes a rank; '
          f'{out} on {card}', flush=True)
    return out


def tp_scale_phase(torch, tmp, card):
    """16b, where the machine has two or more cards: the captured bf16
    step at config 2 under NCCL over a (1, TP) grid on 2 cards beside
    data parallelism over 2, and where there are 4 over (2, TP) beside
    data parallelism over 4 (14d's grids, again in this phase); after
    each grid with a model axis ``patchgan_aot`` over it under
    torchrun."""
    n = torch.cuda.device_count()
    if n < 2:
        print(f'  16b not run: this machine has {n} card; NCCL refuses two '
              f'ranks on one device, so a model axis over cards needs two '
              f'or more', flush=True)
        return {'run': False, 'cards': n}
    out_dir = os.path.join(tmp, 'tp_scale')
    os.makedirs(out_dir)
    grids = [(1, TP), (2, 1)] + ([(2, TP), (4, 1)] if n >= 4 else [])
    rows = []
    for dp, tp in grids:
        port = free_port()
        run_ranks([[sys.executable, '-c',
                    'import chip_smoke; chip_smoke.tp_scale_child()',
                    str(rank), str(dp), str(tp), str(port), out_dir]
                   for rank in range(dp * tp)], tmp, f'tp_scale_{dp}x{tp}',
                  timeout=TP_JOIN_S)
        with open(os.path.join(out_dir, f'grid_{dp}x{tp}.json')) as f:
            r = json.load(f)
        r['grid'] = [dp, tp]
        if tp > 1:
            r['aot'] = tp_aot(tmp, dp, tp, card)
        rows.append(r)
        print(f'  ({dp}, {tp}): img/s per card '
              f'{[round(v, 3) for v in r["img_per_s_per_card"]]}; the '
              f'step\'s collectives alone, captured (ms, MB): '
              f'{r["collectives"]}; a rank holds parameters '
              f'{r["param_bytes"] / 1e6:.1f} MB, optimizer state '
              f'{r["moment_bytes"] / 1e6:.1f} MB, peak '
              f'{r["peak_bytes"] / 2 ** 30:.2f} GiB on {card}', flush=True)
    return {'run': True, 'cards': n, 'grids': rows}


def tp_phase(torch, np, F, kernels, card):
    """Phase 16: data x model parallelism (see the module's docstring).
    Returns ({path: rank 0's launches}, the summary)."""
    out = {'card': card}
    t0 = time.perf_counter()
    print('  16: the kernels at the shards\' shapes', flush=True)
    with torch.inference_mode():
        out['shard_kernels'] = tp_kernel_phase(torch, F, kernels)
    with tempfile.TemporaryDirectory() as tmp:
        print('  16a: two gloo ranks sharing the card (dp 1 x tp 2)',
              flush=True)
        launches, out['gloo_tp2'] = tp_gloo_phase(torch, np, card, tmp)
        print('  16b: NCCL across cards', flush=True)
        out['across_cards'] = tp_scale_phase(torch, tmp, card)
    out['phase_wall_s'] = time.perf_counter() - t0
    return {f'tp_gloo_rank_0_s2d_{form}': c
            for form, c in launches.items()}, out


def tp_only(torch, np, F, kernels, card):
    """``python3 chip_smoke.py --tp-only``: phase 16 alone."""
    print('== data x model parallel (ROADMAP item 11c)', flush=True)
    paths, tp = tp_phase(torch, np, F, kernels, card)
    print(json.dumps({'tp': tp, 'launches': paths}))
    print(card)


# phase 17: spatial parallelism (ROADMAP item 11d, the training half)
SP = 2                  # the spatial axis of 17a's timed bands, 17b and 17c
SP_SIZE = 1024          # 17a's and 17c's image height and width
SP_B = 2                # 17a's batch and 17b's and 17c's global batch
SP_JOIN_S = 300         # a spawned rank that has not ended by then hung
# 17a's bands: (label, sp, rank)
SP_BANDS = (('sp 2 top', 2, 0), ('sp 2 bottom', 2, 1), ('sp 4 middle', 4, 1))
# the band entry points: name, source, the TPU kernel whose band form it is
BAND_KERNELS = (
    ('in_stats', 'patchgan_tpu_torch/csrc/norm_act.cu',
     'patchgan_tpu/ops/pallas/norm_act.py:211'),
    ('in_apply', 'patchgan_tpu_torch/csrc/norm_act.cu',
     'patchgan_tpu/ops/pallas/norm_act.py:211'),
    ('conv_band', 'patchgan_tpu_torch/csrc/conv_norm_act.cu',
     'patchgan_tpu/ops/pallas/conv_norm_act.py:176'),
    ('convt_band', 'patchgan_tpu_torch/csrc/convt_norm_act.cu',
     'patchgan_tpu/ops/pallas/convt_norm_act.py:178'),
    ('in_bwd_sums', 'patchgan_tpu_torch/csrc/norm_act_bwd.cu',
     'patchgan_tpu/ops/pallas/norm_act.py:253'),
    ('in_bwd_apply', 'patchgan_tpu_torch/csrc/norm_act_bwd.cu',
     'patchgan_tpu/ops/pallas/norm_act.py:253'))


# the mangled name's mark of the wgmma core's band problems (no row of H
# padded, an NCHW acc): ConvNhwcProblem / ConvTNhwcProblem<bf16, true,
# false, false>
BAND_MODE = 'Lb1ELb0ELb0EE'
# the band forms of K1's stats and K1-bwd's sums and dx
# (csrc/band_norm.cuh): their kernels' names, for ptxas's report; the
# sums' kernels are instantiated for in_stats' StatsTerm and for
# in_bwd_sums' BwdTerm
BAND_NORM_MARKS = ('sums_group', 'sums_cluster', 'bwd_apply_vec')
BAND_NORM_TERMS = {'in_stats': 'StatsTerm', 'in_bwd_sums': 'BwdTerm',
                   'in_bwd_apply': 'bwd_apply_vec'}
# the band entries of K1 and K1-bwd, timed also by a graph's replay
BAND_NORM = ('in_stats', 'in_apply', 'in_bwd_sums', 'in_bwd_apply')
# element-path and activation cases of in_stats, in_bwd_sums and
# in_bwd_apply: planes of 15 and 8643 elements (no multiple of 16 bytes in
# either dtype: element by element, the small plane on a group, the large
# split over a cluster), and a group's and a cluster's plane on the vector
# path
BAND_NORM_EDGES = ((2, 8, 3, 5), (1, 4, 67, 129), (2, 16, 8, 8),
                   (1, 2, 128, 256))
# in_stats' other bands: phase 15's spatial mode (the 1280x960 image
# padded to 1024 x 1280, enc0 over 2 and 4 cards)
STATS_BANDS = ((1, NF, 256, 640), (1, NF, 128, 640))


def band_wrappers():
    """The band entry points' wrappers in ``BAND_KERNELS``'s order."""
    from patchgan_tpu_torch.ops import kernels
    return [getattr(kernels, name) for name, _, _ in BAND_KERNELS]


def band_rows(h, sp, rank):
    n = h // sp
    return rank * n, (rank + 1) * n


def band_plan(h, sp):
    """The launches of each wrapper on a rank in one plain-form spatial
    train step of the UNet at height ``h`` over ``sp`` (the discriminator
    without norm, which launches none): {wrapper name: count}, and
    'gather_level'. Normed levels on bands take the band forms (K1 band at
    enc0, K2 band at enc1-6, K3 band at dec1-5, each ending in
    ``in_apply``; K1-bwd band in their backward), the whole ones the
    whole-plane kernels."""
    from patchgan_tpu_torch.models.unet import N_LEVELS, gather_level
    level = gather_level(h, sp)
    enc = level                               # encoder levels on bands
    dec = 5 - max(0, 6 - level)               # dec1-dec5 on bands
    normed = 7 + 5
    return {'gather_level': level,
            'in_stats': 1, 'in_apply': enc + dec,
            'conv_band': enc - 1, 'convt_band': dec,
            'in_bwd_sums': enc + dec, 'in_bwd_apply': enc + dec,
            'instance_norm_act': 0,
            'conv_norm_act': N_LEVELS - enc,
            'convt_norm_act': 5 - dec,
            'instance_norm_act_backward': normed - enc - dec,
            'thin_conv3x3': 0, 'thin_conv3x3_wgrad': 0}


def sp_levels(torch, n=SP_B, size=SP_SIZE):
    """The nf=64 generator's normed levels at ``size`` px for ``n``
    images: ('enc' or 'dec', level, input shape(s), output shape). K2's
    input is enc(l-1)'s output, K3's x and skip share a shape."""
    filts = [NF, 2 * NF, 4 * NF, 8 * NF, 8 * NF, 8 * NF, 8 * NF]
    out = [('enc', 0, None, (n, NF, size // 2, size // 2))]
    for lvl in range(1, 7):
        hh = size >> lvl
        out.append(('enc', lvl, (n, filts[lvl - 1], hh, hh),
                    (n, filts[lvl], hh // 2, hh // 2)))
    for lvl, cx, cs, cout in ((1, 8 * NF, 8 * NF, 8 * NF),
                              (2, 8 * NF, 8 * NF, 8 * NF),
                              (3, 8 * NF, 8 * NF, 4 * NF),
                              (4, 4 * NF, 4 * NF, 2 * NF),
                              (5, 2 * NF, 2 * NF, NF)):
        hh = size >> (7 - lvl)
        out.append(('dec', lvl, ((n, cx, hh, hh), (n, cs, hh, hh)),
                    (n, cout, 2 * hh, 2 * hh)))
    return out


def band_kernel_phase(torch, F, whole):
    """17a: each band entry point against its plain stage version at the
    nf=64 levels' band shapes at SP_SIZE px, batch SP_B (a top and a bottom
    band at sp 2 and a middle one at sp 4), bf16 and fp32, with the kernel
    phase's tolerances (sums: times max(1, max |sum|)); the recombination
    at sp 2 (both bands' stats summed, each band applied, the bands
    concatenated) against the whole-plane K1 / K2 / K3 / K1-bwd; two
    launches on the same inputs equal; the bf16 ms of each entry on the
    top band beside its plain version's, its bound, and the whole-plane
    kernel's at the global shape. K2's and K3's band entries: the wgmma
    core in bf16 and the WMMA core in fp32 (``on_core``), the WMMA core
    forced in bf16 on the top band within the same tolerance, and their
    rows timed on both cores by events and by a graph's replay beside
    their layout passes alone (``core_row``); the layout pass bit-equal
    to its plain version at every band and at its element paths; ptxas's
    report of the band instantiations. ``in_stats``, ``in_bwd_sums`` and
    ``in_bwd_apply`` (``csrc/band_norm.cuh``) also at ``BAND_NORM_EDGES``
    (K1-bwd's in every activation) and one element past 16 bytes,
    ``in_stats`` also at phase 15's bands (``STATS_BANDS``), with their
    kernels' ptxas report (none may spill); the four K1 / K1-bwd band
    entries' rows also by a graph's replay (``device_ms``), ``in_stats``',
    ``in_bwd_sums``' and ``in_bwd_apply``'s with their geometry,
    ``in_stats``' with ``torch.var_mean``'s time as its library call. Returns {entry: {'rows': [...],
    'max_abs_err': the outputs' worst, 'max_sum_err': the sums' worst over
    max(1, max |sum|), 'max_sum_abs_err': the sums' worst}}, with
    'ptxas' beside the rows of ``in_bwd_sums`` and ``in_bwd_apply``."""
    from patchgan_tpu_torch.ops import kernels as kn
    from patchgan_tpu_torch.ops.kernels import _build
    from patchgan_tpu_torch.ops.kernels import norm_act as na
    from patchgan_tpu_torch.ops.kernels.conv_norm_act import conv_band_plan
    from patchgan_tpu_torch.ops.kernels.convt_norm_act import \
        convt_band_plan
    k1, k2, k3, k1b = whole
    ptxas = {k: v for k, v in wgmma_ptxas(_build.build_log).items()
             if BAND_MODE in k[1]}
    for (lib, name), (regs, stores, loads) in sorted(ptxas.items()):
        print(f'  ptxas {lib} {name}: {regs} registers, spill stores '
              f'{stores} / loads {loads} bytes', flush=True)
    if any(stores or loads for _, stores, loads in ptxas.values()):
        raise AssertionError(f'17a: the band mode of the wgmma core spills: '
                             f'{ptxas}')
    norm_ptxas = wgmma_ptxas(_build.build_log, BAND_NORM_MARKS)
    for mark in BAND_NORM_MARKS:
        got = [v for (_, name), v in norm_ptxas.items() if mark in name]
        if got:
            print(f'  ptxas {mark}: {len(got)} instantiations, '
                  f'{min(v[0] for v in got)}-{max(v[0] for v in got)} '
                  f'registers, spill stores {sum(v[1] for v in got)} / '
                  f'loads {sum(v[2] for v in got)} bytes', flush=True)
    if any(stores or loads for _, stores, loads in norm_ptxas.values()):
        raise AssertionError(f'17a: a band norm kernel spills: '
                             f'{norm_ptxas}')
    gen = torch.Generator(device='cuda').manual_seed(17)
    res = {name: {'rows': [], 'max_abs_err': 0.0, 'max_sum_err': 0.0,
                  'max_sum_abs_err': 0.0} for name, _, _ in BAND_KERNELS}
    for name, mark in BAND_NORM_TERMS.items():
        res[name]['ptxas'] = {k[1]: v for k, v in norm_ptxas.items()
                              if mark in k[1]}
    eps, act = 1e-5, 'relu'

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device='cuda') * scale

    def haloed(t, lo, hi):
        return F.pad(t, (0, 0, 1, 1))[:, :, lo:hi + 2].contiguous()

    def check(name, label, got, want, tol, key='max_abs_err'):
        """``key``: 'max_sum_err' for a sum, whose error is kept over
        max(1, max |sum|)."""
        e = (got.float() - want.float()).abs().max().item()
        print(f'  {name} {label}: max_abs_err {e:.3e} (tol {tol:.3e})',
              flush=True)
        if not e <= tol:
            raise AssertionError(f'17a: {name} {label}: {e} > {tol}')
        if key == 'max_sum_err':
            res[name]['max_sum_abs_err'] = max(
                res[name]['max_sum_abs_err'], e)
            e /= max(1.0, want.abs().max().item())
        res[name][key] = max(res[name][key], e)

    def scaled(want, dname):
        return TOL[dname] * max(1.0, want.abs().max().item())

    def same_bits(name, fn):
        a, b = fn(), fn()
        torch.cuda.synchronize()
        pairs = zip(a, b) if isinstance(a, tuple) else [(a, b)]
        if not all(torch.equal(u, v) for u, v in pairs):
            raise AssertionError(f'17a: {name}: two launches differ')

    def row(name, label, fn, plain, whole_ms, flops, nbytes, peak,
            extra=None, library=None):
        b_ms, b_by = bound(flops, nbytes, peak)
        r = {'kernel': name, 'case': label, 'dtype': 'bfloat16',
             'kernel_ms': cuda_ms(fn, iters=10),
             'plain_ms': cuda_ms(plain, iters=10), 'whole_ms': whole_ms,
             'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None,
             **(extra or {})}
        if name in BAND_NORM:
            r['device_ms'] = device_ms(fn, iters=10)
        if library is not None:
            r.update(library_ms=cuda_ms(library, iters=10),
                     library_device_ms=device_ms(library, iters=10))
        res[name]['rows'].append(r)
        print(json.dumps(r), flush=True)

    def geometry(name, t):
        """The launch geometry of band entry ``name`` on t (aligned)."""
        planes, plane = t.shape[0] * t.shape[1], t.shape[2] * t.shape[3]
        plan = na.band_bwd_apply_plan if name == 'in_bwd_apply' else \
            na.band_sums_plan
        return {'geometry': plan(planes, plane, t.dtype)._asdict()}

    def stats_check(label, xd, dname):
        """in_stats on band xd against its plain version, two launches
        bit-equal."""
        want = kn.in_stats_plain(xd.float())
        check('in_stats', f'{label} {dname}', kn.in_stats(xd), want,
              scaled(want, dname), 'max_sum_err')
        same_bits('in_stats', lambda: kn.in_stats(xd))

    def on_core(w, wgmma, fn):
        """fn(), which must launch band wrapper w once, on the wgmma core
        where ``wgmma``, else on the WMMA core."""
        before = (w.launches, w.launches_wgmma)
        out = fn()
        took = (w.launches - before[0], w.launches_wgmma - before[1])
        if took != (1, int(wgmma)):
            raise AssertionError(f'17a: {w.__name__}: launches {took[0]}, '
                                 f'{took[1]} on the wgmma core; expected '
                                 f'1, {int(wgmma)}')
        return out

    def layout_check(t):
        """The layout pass alone on t, bit-equal to its plain version."""
        if not torch.equal(kn.nchw_to_nhwc(t), kn.nchw_to_nhwc_plain(t)):
            raise AssertionError(f'17a: the layout pass of '
                                 f'{tuple(t.shape)} differs')

    def core_row(name, wrapper, label, args, plain, whole_ms, flops,
                 nbytes, layout, plan):
        """A K2 / K3 band row in bf16: the planner's core (the wgmma core,
        ``kernel_ms``) and the WMMA core forced on the same values, by
        events around 10 calls and by a graph's replay (``device_ms``),
        and the layout passes alone (``layout``: the tensors the entry
        copies, by events and by a graph's replay) with their bound."""
        fns = {'wgmma': lambda: wrapper(*args),
               'wmma': lambda: wrapper(*args, _core='wmma'),
               'layout': lambda: [kn.nchw_to_nhwc(t) for t in layout]}
        ev = {k: cuda_ms(fns[k], iters=10) for k in ('wmma', 'layout')}
        dev = {k: device_ms(f, iters=10) for k, f in fns.items()}
        moved = 4 * sum(t.numel() for t in layout)
        extra = {'core': plan.core, 'bn': plan.bn, 'stages': plan.stages,
                 'splits': plan.splits, 'samples_a_tile': plan.samples,
                 'smem_bytes': plan.smem, 'wmma_ms': ev['wmma'],
                 'device_ms': dev['wgmma'], 'wmma_device_ms': dev['wmma'],
                 'layout_ms': ev['layout'],
                 'layout_device_ms': dev['layout'],
                 'layout_bound_ms': bound(0, moved, PEAK_BF16)[0]}
        row(name, label, fns['wgmma'], plain, whole_ms, flops, nbytes,
            PEAK_BF16, extra)

    dts = (('bfloat16', torch.bfloat16), ('float32', torch.float32))
    for kind, lvl, shape_in, shape_out in sp_levels(torch):
        label = f'{kind}{lvl}'
        n, c, h, w = shape_out
        count = h * w
        if kind == 'enc' and lvl == 0:
            # K1 band: stats and apply on enc0's conv output
            x = rand(*shape_out)
            for dname, dt in dts:
                xd = x.to(dt)
                parts = []
                for blabel, sp, s in SP_BANDS:
                    lo, hi = band_rows(h, sp, s)
                    xb = xd[:, :, lo:hi].contiguous()
                    st = kn.in_stats(xb)
                    want = kn.in_stats_plain(xb.float())
                    check('in_stats', f'{label} {blabel} {dname}', st, want,
                          scaled(want, dname), 'max_sum_err')
                    whole_st = kn.in_stats_plain(xd.float())
                    check('in_apply', f'{label} {blabel} {dname}',
                          kn.in_apply(xb, whole_st, count, eps, act),
                          kn.in_apply_plain(xb.float(), whole_st, count, eps,
                                            act), TOL[dname])
                    if sp == SP:
                        parts.append((xb, st))
                total = sum(st for _, st in parts)
                y = torch.cat([kn.in_apply(xb, total, count, eps, act)
                               for xb, _ in parts], dim=2)
                check('in_apply', f'{label} recombined vs K1 {dname}', y,
                      k1.wrapper(xd, eps, act), TOL[dname])
                xb = parts[0][0]
                same_bits('in_stats', lambda: kn.in_stats(xb))
                same_bits('in_apply', lambda: kn.in_apply(
                    xb, total, count, eps, act))
            xd = x.to(torch.bfloat16)
            lo, hi = band_rows(h, SP, 0)
            xb = xd[:, :, lo:hi].contiguous()
            st = kn.in_stats_plain(xd.float())
            numel = xb.numel()
            k1_ms = cuda_ms(lambda: k1.wrapper(xd, eps, act), iters=10)
            row('in_stats', f'{label} {tuple(xb.shape)}',
                lambda: kn.in_stats(xb), lambda: kn.in_stats_plain(xb),
                k1_ms, 3 * numel, 2 * numel, PEAK_FP32,
                geometry('in_stats', xb), library=lambda: torch.var_mean(
                    xb, dim=(2, 3), correction=0))
            row('in_apply', f'{label} {tuple(xb.shape)} bf16 -> bf16',
                lambda: kn.in_apply(xb, st, count, eps, act),
                lambda: kn.in_apply_plain(xb, st, count, eps, act), k1_ms,
                4 * numel, 4 * numel, PEAK_FP32)
        elif kind == 'enc':
            # K2 band on enc(lvl)'s input band with its halo rows
            cin, cout = shape_in[1], c
            x = rand(*shape_in)
            wt = rand(cout, cin, 4, 4,
                      scale=(2.0 / (32 * (cin + cout))) ** 0.5)
            for dname, dt in dts:
                xd, wd = x.to(dt), wt.to(dt)
                parts = []
                for blabel, sp, s in SP_BANDS:
                    lo, hi = band_rows(shape_in[2], sp, s)
                    xh = haloed(xd, lo, hi)
                    acc, st = on_core(kn.conv_band, dt == torch.bfloat16,
                                      lambda: kn.conv_band(xh, wd))
                    want_acc, want_st = kn.conv_band_plain(xh.float(),
                                                           wd.float())
                    if dt == torch.bfloat16:
                        layout_check(xh)
                    check('conv_band', f'{label} {blabel} {dname}', acc,
                          want_acc, TOL[dname])
                    check('conv_band', f'{label} {blabel} stats {dname}',
                          st, want_st, scaled(want_st, dname), 'max_sum_err')
                    if sp == SP:
                        parts.append((xh, acc, st))
                total = sum(st for _, _, st in parts)
                check('in_apply', f'{label} fp32 -> {dname}',
                      kn.in_apply(parts[0][1], total, count, eps, act, dt),
                      kn.in_apply_plain(parts[0][1], total, count, eps,
                                        act), TOL[dname])
                y = torch.cat([kn.in_apply(acc, total, count, eps, act, dt)
                               for _, acc, _ in parts], dim=2)
                check('conv_band', f'{label} recombined vs K2 {dname}', y,
                      k2.wrapper(xd, wd, eps, act), TOL[dname])
                xh = parts[0][0]
                same_bits('conv_band', lambda: kn.conv_band(xh, wd))
                if dt == torch.bfloat16:
                    layout_check(wd)
                    want_acc = kn.conv_band_plain(xh.float(), wd.float())[0]
                    check('conv_band', f'{label} sp 2 top {dname} on the '
                          f'WMMA core', on_core(kn.conv_band, False, lambda:
                                               kn.conv_band(xh, wd,
                                                            _core='wmma'))[0],
                          want_acc, TOL[dname])
            xd, wd = x.to(torch.bfloat16), wt.to(torch.bfloat16)
            lo, hi = band_rows(shape_in[2], SP, 0)
            xh = haloed(xd, lo, hi)
            acc, st = kn.conv_band(xh, wd)
            k2_ms = cuda_ms(lambda: k2.wrapper(xd, wd, eps, act), iters=10)
            macs = acc.numel() * 16 * cin
            core_row('conv_band', kn.conv_band,
                     f'{label} {tuple(xh.shape)}->{tuple(acc.shape)}',
                     (xh, wd), lambda: kn.conv_band_plain(xh, wd), k2_ms,
                     2 * macs, 2 * (xh.numel() + wd.numel())
                     + 4 * acc.numel(), (xh, wd),
                     conv_band_plan(*xh.shape, cout, xh.dtype))
            row('in_apply', f'{label} {tuple(acc.shape)} fp32 -> bf16',
                lambda: kn.in_apply(acc, st, count, eps, act,
                                    torch.bfloat16),
                lambda: kn.in_apply_plain(acc, st, count, eps, act,
                                          torch.bfloat16), k2_ms,
                4 * acc.numel(), 6 * acc.numel(), PEAK_FP32)
        else:
            # K3 band on dec(lvl)'s x and skip bands with their halo rows
            (_, cx, hh, _), (_, cs, _, _) = shape_in
            x, sk = rand(*shape_in[0]), rand(*shape_in[1])
            wt = rand(cx + cs, c, 4, 4,
                      scale=(2.0 / (16 * (cx + cs + c))) ** 0.5)
            for dname, dt in dts:
                xd, sd, wd = x.to(dt), sk.to(dt), wt.to(dt)
                parts = []
                for blabel, sp, s in SP_BANDS:
                    lo, hi = band_rows(hh, sp, s)
                    xh, sh = haloed(xd, lo, hi), haloed(sd, lo, hi)
                    acc, st = on_core(kn.convt_band, dt == torch.bfloat16,
                                      lambda: kn.convt_band(xh, wd, sh))
                    want_acc, want_st = kn.convt_band_plain(
                        xh.float(), wd.float(), sh.float())
                    if dt == torch.bfloat16:
                        layout_check(xh)
                        layout_check(sh)
                    check('convt_band', f'{label} {blabel} {dname}', acc,
                          want_acc, TOL[dname])
                    check('convt_band', f'{label} {blabel} stats {dname}',
                          st, want_st, scaled(want_st, dname), 'max_sum_err')
                    if sp == SP:
                        parts.append((xh, sh, acc, st))
                total = sum(p[3] for p in parts)
                y = torch.cat([kn.in_apply(acc, total, count, eps, act, dt)
                               for _, _, acc, _ in parts], dim=2)
                check('convt_band', f'{label} recombined vs K3 {dname}', y,
                      k3.wrapper(xd, wd, eps, act, sd), TOL[dname])
                xh, sh = parts[0][:2]
                same_bits('convt_band', lambda: kn.convt_band(xh, wd, sh))
                if dt == torch.bfloat16:
                    want_acc = kn.convt_band_plain(xh.float(), wd.float(),
                                                   sh.float())[0]
                    check('convt_band', f'{label} sp 2 top {dname} on the '
                          f'WMMA core', on_core(
                              kn.convt_band, False, lambda: kn.convt_band(
                                  xh, wd, sh, _core='wmma'))[0],
                          want_acc, TOL[dname])
            xd, sd, wd = (t.to(torch.bfloat16) for t in (x, sk, wt))
            lo, hi = band_rows(hh, SP, 0)
            xh, sh = haloed(xd, lo, hi), haloed(sd, lo, hi)
            acc, st = kn.convt_band(xh, wd, sh)
            k3_ms = cuda_ms(lambda: k3.wrapper(xd, wd, eps, act, sd),
                            iters=10)
            macs = acc.numel() * 4 * (cx + cs)
            core_row('convt_band', kn.convt_band,
                     f'{label} ({cx}+{cs})x{tuple(xh.shape[2:])}->'
                     f'{tuple(acc.shape)}', (xh, wd, sh),
                     lambda: kn.convt_band_plain(xh, wd, sh), k3_ms,
                     2 * macs, 2 * (xh.numel() + sh.numel() + wd.numel())
                     + 4 * acc.numel(), (xh, sh),
                     convt_band_plan(xh.shape[0], cx, cs, *xh.shape[2:], c,
                                     xh.dtype))
            row('in_apply', f'{label} {tuple(acc.shape)} fp32 -> bf16',
                lambda: kn.in_apply(acc, st, count, eps, act,
                                    torch.bfloat16),
                lambda: kn.in_apply_plain(acc, st, count, eps, act,
                                          torch.bfloat16), k3_ms,
                4 * acc.numel(), 6 * acc.numel(), PEAK_FP32)
        # K1-bwd band at this level's output plane
        x, g = rand(*shape_out), rand(*shape_out)
        for dname, dt in dts:
            xd, gd = x.to(dt), g.to(dt)
            st = kn.in_stats_plain(xd.float())
            parts = []
            for blabel, sp, s in SP_BANDS:
                lo, hi = band_rows(h, sp, s)
                xb, gb = xd[:, :, lo:hi].contiguous(), \
                    gd[:, :, lo:hi].contiguous()
                u = kn.in_bwd_sums(gb, xb, st, count, eps, act)
                want = kn.in_bwd_sums_plain(gb.float(), xb.float(), st,
                                            count, eps, act)
                check('in_bwd_sums', f'{label} {blabel} {dname}', u, want,
                      scaled(want, dname), 'max_sum_err')
                if sp == SP:
                    parts.append((xb, gb, u))
            total = sum(p[2] for p in parts)
            xb, gb = parts[0][:2]
            want = kn.in_bwd_apply_plain(gb.float(), xb.float(), st, total,
                                         count, eps, act)
            check('in_bwd_apply', f'{label} {dname}',
                  kn.in_bwd_apply(gb, xb, st, total, count, eps, act), want,
                  TOL_BWD[dname] * max(1.0, want.abs().max().item()))
            dx = torch.cat([kn.in_bwd_apply(gb, xb, st, total, count, eps,
                                            act) for xb, gb, _ in parts],
                           dim=2)
            want = k1b.wrapper(gd, xd, eps, act)
            check('in_bwd_apply', f'{label} recombined vs K1-bwd {dname}',
                  dx, want, TOL_BWD[dname] * max(1.0, want.float().abs()
                                                 .max().item()))
            same_bits('in_bwd_sums', lambda: kn.in_bwd_sums(
                gb, xb, st, count, eps, act))
            same_bits('in_bwd_apply', lambda: kn.in_bwd_apply(
                gb, xb, st, total, count, eps, act))
        xd, gd = x.to(torch.bfloat16), g.to(torch.bfloat16)
        lo, hi = band_rows(h, SP, 0)
        xb, gb = xd[:, :, lo:hi].contiguous(), gd[:, :, lo:hi].contiguous()
        st = kn.in_stats_plain(xd.float())
        u = kn.in_bwd_sums(gb, xb, st, count, eps, act)
        numel = xb.numel()
        kb_ms = cuda_ms(lambda: k1b.wrapper(gd, xd, eps, act), iters=10)
        row('in_bwd_sums', f'{label} {tuple(xb.shape)}',
            lambda: kn.in_bwd_sums(gb, xb, st, count, eps, act),
            lambda: kn.in_bwd_sums_plain(gb, xb, st, count, eps, act),
            kb_ms, 9 * numel, 4 * numel, PEAK_FP32,
            geometry('in_bwd_sums', xb))
        row('in_bwd_apply', f'{label} {tuple(xb.shape)}',
            lambda: kn.in_bwd_apply(gb, xb, st, u, count, eps, act),
            lambda: kn.in_bwd_apply_plain(gb, xb, st, u, count, eps, act),
            kb_ms, 8 * numel, 6 * numel, PEAK_FP32,
            geometry('in_bwd_apply', xb))
    # the layout pass's element paths and partial tiles: pixels a plane
    # no multiple of 8, channels no multiple of 8, the 16-pixel tile of
    # small planes (K2's weight takes it) with a partial channel tile, x
    # one element past 16 bytes
    for shape in ((3, 72, 5, 7), (2, 13, 6, 10), (2, 64, 4, 6),
                  (5, 72, 2, 4), (3, 300, 3, 5)):
        layout_check(rand(*shape).to(torch.bfloat16))
    t = rand(2 * 64 * 8 * 8 + 1).to(torch.bfloat16)[1:].view(2, 64, 8, 8)
    layout_check(t)
    # in_stats, in_bwd_sums' and in_bwd_apply's element paths, every
    # activation, and x and g one element past 16 bytes (element by
    # element); in_stats also at phase 15's bands
    for shape in STATS_BANDS:
        x = rand(*shape) * 2.0 + 0.5
        for dname, dt in dts:
            stats_check(f'{shape}', x.to(dt), dname)
    for shape in BAND_NORM_EDGES:
        x, g = rand(*shape), rand(*shape)
        xo, go = rand(x.numel() + 1), rand(x.numel() + 1)
        for dname, dt in dts:
            stats_check(f'{shape}', x.to(dt), dname)
            stats_check(f'{shape} one element past 16 bytes',
                        xo.to(dt)[1:].view(shape), dname)
        count = 2 * shape[2] * shape[3]
        st = kn.in_stats_plain(x) * 2
        cases = [(str(a), a, lambda dt: (x.to(dt), g.to(dt)))
                 for a in (None, 'tanh', 'relu', 'leakyrelu')]
        cases.append(('relu, one element past 16 bytes', 'relu',
                      lambda dt: (xo.to(dt)[1:].view(shape),
                                  go.to(dt)[1:].view(shape))))
        for alabel, a, make in cases:
            for dname, dt in dts:
                xd, gd = make(dt)
                want = kn.in_bwd_sums_plain(gd.float(), xd.float(), st, count,
                                            eps, a)
                u = kn.in_bwd_sums(gd, xd, st, count, eps, a)
                check('in_bwd_sums', f'{shape} {alabel} {dname}', u, want,
                      scaled(want, dname), 'max_sum_err')
                want = kn.in_bwd_apply_plain(gd.float(), xd.float(), st, u,
                                             count, eps, a)
                check('in_bwd_apply', f'{shape} {alabel} {dname}',
                      kn.in_bwd_apply(gd, xd, st, u, count, eps, a), want,
                      TOL_BWD[dname] * max(1.0, want.abs().max().item()))
                if a == 'relu':
                    same_bits('in_bwd_sums', lambda: kn.in_bwd_sums(
                        gd, xd, st, count, eps, a))
                    same_bits('in_bwd_apply', lambda: kn.in_bwd_apply(
                        gd, xd, st, u, count, eps, a))
    for name in BAND_NORM:
        rows = res[name]['rows']
        total = {k: sum(r[k] for r in rows)
                 for k in ('kernel_ms', 'device_ms', 'bound_ms')}
        print(f'  {name} over the {len(rows)} levels of the sp {SP} top '
              f'band, bf16: {total["kernel_ms"]:.4f} ms by events, '
              f'{total["device_ms"]:.4f} by a graph\'s replay; bound '
              f'{total["bound_ms"]:.4f}', flush=True)
    for name in ('conv_band', 'convt_band'):
        rows = res[name]['rows']
        total = {k: sum(r[k] for r in rows) for k in (
            'kernel_ms', 'wmma_ms', 'device_ms', 'wmma_device_ms',
            'bound_ms', 'layout_ms', 'layout_device_ms', 'layout_bound_ms')}
        print(f'  {name} over the {len(rows)} levels of the sp {SP} top '
              f'band, bf16: the wgmma core {total["kernel_ms"]:.4f} ms by '
              f'events, {total["device_ms"]:.4f} by a graph\'s replay; the '
              f'WMMA core {total["wmma_ms"]:.4f} / '
              f'{total["wmma_device_ms"]:.4f}; bound '
              f'{total["bound_ms"]:.4f}', flush=True)
        print(f'  {name} layout passes alone, over the same levels: '
              f'{total["layout_ms"]:.4f} ms by events, '
              f'{total["layout_device_ms"]:.4f} by a graph\'s replay, bound '
              f'{total["layout_bound_ms"]:.4f}', flush=True)
    return res


def sp_run(torch, np, mesh):
    """17b's step: one fp32 eager step at config 2's widths (tanh, dropout
    off) on a seeded global batch of SP_B at SIZE px, over ``mesh`` (a
    (1, SP) SpatialMesh) or one process; the launches of every wrapper in
    the step alone (the counts set to 0 just before, read just after).
    Returns (losses, the gradients the optimizers are handed, on the
    host, {wrapper: launches})."""
    from patchgan_tpu_torch.models import Discriminator, UNet
    from patchgan_tpu_torch.train.steps import make_optimizer, \
        make_train_step
    init = torch.Generator().manual_seed(9)
    gen = UNet(IN_C, OUT_C, nf=NF, use_dropout=False, activation='tanh',
               final_act='softmax', generator=init).cuda()
    disc = Discriminator(IN_C + OUT_C, ndf=NDF, n_layers=3,
                         generator=init).cuda()
    opts = [make_optimizer(m.parameters(), LR) for m in (gen, disc)]
    grads = []
    for opt in opts:
        def update(gs, opt=opt, update=opt.update):
            grads.append([t.detach().cpu() for t in gs])
            return update(gs)
        opt.update = update
    step = make_train_step(gen, disc, *opts, mesh=mesh)
    x, y = train_batch(torch, np, SP_B, SIZE, 'cuda', 170)
    if mesh is not None:
        x, y = mesh.local_rows((x, y))
    wrappers = kernel_wrappers() + band_wrappers()
    for w in wrappers:
        w.launches = 0
    losses = {k: float(v) for k, v in step(x, y).items()}
    torch.cuda.synchronize()
    return losses, grads, {w.__name__: w.launches for w in wrappers}


def sp_gloo_child():
    """``python -c 'import chip_smoke; chip_smoke.sp_gloo_child()' RANK
    PORT OUT``: one of 17b's two gloo ranks (dp 1 x sp 2) on card 0:
    ``sp_run`` over the spatial mesh into OUT/rank_RANK.pt."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from patchgan_tpu_torch.parallel import spatial_mesh
    rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    torch.cuda.set_device(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dist.init_process_group('gloo', init_method=f'tcp://127.0.0.1:{port}',
                            rank=rank, world_size=SP)
    mesh = spatial_mesh(1, SP, 'cuda:0')
    t0 = time.perf_counter()
    losses, grads, launches = sp_run(torch, np, mesh)
    torch.save({'losses': losses, 'grads': grads, 'launches': launches,
                'seconds': time.perf_counter() - t0},
               os.path.join(out, f'rank_{rank}.pt'))
    dist.destroy_process_group()


def sp_gloo_phase(torch, np, card, tmp):
    """17b: two gloo ranks sharing card 0 at (dp, sp) = (1, SP), against
    one process on the same card from the same seeds (fp32, TF32 off,
    deterministic cuDNN, tanh: the reason phases 14b and 16a give):
    losses within rtol 2e-3 / atol 2e-4 (phase 7's), every gradient
    within 1e-3 of that tensor's max |g|, both ranks' losses and
    gradients equal, and each rank's launches in the step what
    ``band_plan`` plans. Returns (rank 0's launches, the summary)."""
    out_dir = os.path.join(tmp, 'sp_gloo')
    os.makedirs(out_dir)
    port = free_port()
    t0 = time.perf_counter()
    run_ranks([[sys.executable, '-c',
                'import chip_smoke; chip_smoke.sp_gloo_child()', str(rank),
                str(port), out_dir] for rank in range(SP)], tmp, 'sp_gloo',
              timeout=SP_JOIN_S)
    wall = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(out_dir, f'rank_{r}.pt'),
                        weights_only=False) for r in range(SP)]
    with cudnn_flags_kept(torch):
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        t1 = time.perf_counter()
        losses, grads, _ = sp_run(torch, np, None)
        one_s = time.perf_counter() - t1
    plan = band_plan(SIZE, SP)
    want = {k: v for k, v in plan.items() if k != 'gather_level'}
    excess = max(abs(ranks[0]['losses'][k] - v) - 2e-4 - 2e-3 * abs(v)
                 for k, v in losses.items())
    worst = 0.0
    for got_set, want_set in zip(ranks[0]['grads'], grads):
        for a, b in zip(got_set, want_set):
            worst = max(worst, float((a - b).abs().max())
                        / max(float(b.abs().max()), 1e-30))
    same = ranks[0]['losses'] == ranks[1]['losses'] and all(
        torch.equal(a, b) for sa, sb in zip(ranks[0]['grads'],
                                            ranks[1]['grads'])
        for a, b in zip(sa, sb))
    counts = [r['launches'] for r in ranks]
    summary = {'wall_s': wall, 'loss_excess': excess,
               'max_grad_err_over_max_g': worst, 'ranks_equal': same,
               'launches_per_rank': counts, 'planned': want,
               'gather_level': plan['gather_level'],
               'rank_seconds': [r['seconds'] for r in ranks],
               'one_process_seconds': one_s, 'losses': ranks[0]['losses'],
               'one_process_losses': losses}
    print(f'  (1, {SP}) against one process at {SIZE} px, batch {SP_B}, '
          f'fp32: worst loss excess over rtol 2e-3 / atol 2e-4 '
          f'{excess:.3e} (<= 0), the worst gradient error over its '
          f'tensor\'s max |g| {worst:.3e} (<= 1e-3); ranks equal {same}; '
          f'launches a rank {counts[0]} (planned {want}, gather level '
          f'{plan["gather_level"]}); ranks {wall:.1f} s wall, one process '
          f'{one_s:.2f} s on {card}', flush=True)
    if not (excess <= 0 and worst <= 1e-3 and same
            and all(c == want for c in counts)):
        raise AssertionError(f'17b: the spatial step disagrees: {summary}')
    return counts[0], summary


def write_sp_inputs(tmp, np):
    """17c's npz folder at SP_SIZE px (4 training, 2 validation pairs) and
    its config: config 2's widths, spatial_parallelism SP."""
    import yaml
    shutil.copy(os.path.join(ROOT, 'examples', 'io_plugin_example.py'),
                os.path.join(tmp, 'io.py'))
    rng = np.random.default_rng(17)
    for split, n in (('train', 4), ('val', 2)):
        os.makedirs(os.path.join(tmp, split))
        for i in range(n):
            np.savez(os.path.join(tmp, split, f'{i:03d}.npz'),
                     image=rng.random((SP_SIZE, SP_SIZE, IN_C),
                                      dtype=np.float32),
                     labels=rng.integers(1, OUT_C + 1, (SP_SIZE, SP_SIZE))
                     .astype(np.int32))
    cfg = {
        'dataset': {'type': 'NpzSegmentationDataset', 'size': SP_SIZE,
                    'in_channels': IN_C, 'out_channels': OUT_C,
                    'labels': list(range(1, OUT_C + 1)),
                    'train_data': {'images': 'train', 'masks': 'train'},
                    'validation_data': {'images': 'val', 'masks': 'val'}},
        'model_params': {'generator': {'filters': NF, 'activation': 'relu',
                                       'final_activation': 'softmax'},
                         'discriminator': {'filters': NDF, 'n_layers': 3}},
        'checkpoint_path': os.path.join(tmp, 'ck'),
        'train_params': {'loss_type': 'tversky', 'seg_alpha': 200,
                         'gen_learning_rate': 1e-3,
                         'disc_learning_rate': 1e-3, 'save_freq': 1,
                         'spatial_parallelism': SP}}
    path = os.path.join(tmp, 'sp_train.yaml')
    with open(path, 'w') as f:
        yaml.safe_dump(cfg, f)
    return path


def sp_capture_step(torch, np, mesh, device):
    """The captured bf16 step of config 2 at SP_SIZE px, global batch SP_B,
    over ``mesh`` (or one card), after three steps (eager, capture,
    replay) with finite losses. Returns (a function running one step, the
    peak bytes on this card those steps took above what it held before,
    K2's and K3's band launches in those steps as {name: [launches, on the
    wgmma core]})."""
    from patchgan_tpu_torch.ops.kernels import conv_band, convt_band
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    gen, disc = train_models(torch)
    step, _ = config_step(torch, gen, disc, 'off', False, 1, True,
                          mesh=mesh)
    x, y = (t.to(torch.bfloat16) for t in train_batch(
        torch, np, SP_B, SP_SIZE, 'cuda', 18))
    if mesh is not None:
        x, y = mesh.local_rows((x, y))
    before = {w.__name__: [w.launches, w.launches_wgmma]
              for w in (conv_band, convt_band)}
    for _ in range(3):
        losses = step(x, y)
    torch.cuda.synchronize()
    if not all(np.isfinite(float(v)) for v in losses.values()):
        raise AssertionError(f'17c: losses {losses}')
    peak = torch.cuda.max_memory_allocated(device) - held
    bands = {w.__name__: [w.launches - before[w.__name__][0],
                          w.launches_wgmma - before[w.__name__][1]]
             for w in (conv_band, convt_band)}
    return (lambda: step(x, y)), peak, bands


def sp_window(torch, run, mesh=None):
    """img/s (global batch SP_B) of one window of at least WINDOW_S s of
    ``run``, five steps at a time. Over a ``mesh`` the ranks start at a
    barrier, and rank 0's clock ends the window (a one-float broadcast
    after each five steps), so every rank runs the same steps."""
    import torch.distributed as dist
    if mesh is not None:
        mesh.barrier()
    count, t0 = 0, time.perf_counter()
    while True:
        for _ in range(5):
            run()
        torch.cuda.synchronize()
        count += 5
        done = time.perf_counter() - t0 >= WINDOW_S
        if mesh is not None:
            flag = torch.tensor([float(done)], device=mesh.device)
            dist.broadcast(flag, 0)
            done = bool(flag.item())
        if done:
            return SP_B * count / (time.perf_counter() - t0)


def sp_scale_child():
    """``python -c 'import chip_smoke; chip_smoke.sp_scale_child()' RANK
    PORT OUT``: one NCCL rank on card RANK of 17c's (1, SP) grid. Every
    rank builds the captured step over the spatial mesh, rank 0 also one
    card's on its card (``sp_capture_step``); then WINDOWS windows of
    each, in turns (the order reversed every other window), the grid's
    on every rank, one card's on rank 0 while the others wait at the next
    window's barrier; rank 0 writes OUT/spatial.json."""
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from patchgan_tpu_torch.parallel import shutdown, spatial_mesh
    rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    device = torch.device('cuda', rank)
    torch.cuda.set_device(device)
    dist.init_process_group('nccl', init_method=f'tcp://127.0.0.1:{port}',
                            rank=rank, world_size=SP, device_id=device)
    mesh = spatial_mesh(1, SP, device)
    runs, peaks = {}, {}
    runs['grid'], peaks['grid'], bands = sp_capture_step(torch, np, mesh,
                                                         device)
    if rank == 0:
        runs['one'], peaks['one'], _ = sp_capture_step(torch, np, None,
                                                       device)
    rates = {'grid': [], 'one': []}
    for i in range(WINDOWS):
        for side in (('grid', 'one') if i % 2 == 0 else ('one', 'grid')):
            if side == 'grid':
                rates['grid'].append(sp_window(torch, runs['grid'], mesh))
            elif rank == 0:
                rates['one'].append(sp_window(torch, runs['one']))
    if rank == 0:
        with open(os.path.join(out, 'spatial.json'), 'w') as f:
            json.dump({'img_per_s': rates['grid'], 'peak_bytes': peaks['grid'],
                       'one_card_img_per_s': rates['one'],
                       'one_card_peak_bytes': peaks['one'],
                       'band_launches': bands}, f)
    del runs
    shutdown(mesh)


def sp_nccl_phase(torch, np, card, tmp):
    """17c, where the machine has two or more cards: ``patchgan_train``
    under ``torch.distributed.run --nproc_per_node SP`` with
    ``spatial_parallelism: SP`` (bf16, config 2's widths, SP_SIZE px,
    global batch SP_B, the captured step, two steps): exit 0, the spatial
    line, finite losses and weights, one set of epoch files; then the
    captured step over (1, SP) cards beside one card's at the same config:
    img/s and the peak memory a rank."""
    n = torch.cuda.device_count()
    if n < SP:
        print(f'  17c not run: this machine has {n} card; NCCL refuses two '
              f'ranks on one device, so a spatial axis over cards needs '
              f'{SP} or more', flush=True)
        return {'run': False, 'cards': n}
    cfg = write_sp_inputs(tmp, np)
    path = os.environ.get('PYTHONPATH')
    env = dict(os.environ, PYTHONPATH=ROOT + (os.pathsep + path if path
                                              else ''))
    t0 = time.perf_counter()
    log_path = os.path.join(tmp, 'sp_train.log')
    with open(log_path, 'w') as log:
        try:
            rc = subprocess.run(
                [sys.executable, '-m', 'torch.distributed.run', '--nnodes',
                 '1', '--nproc_per_node', str(SP), '--master_addr',
                 '127.0.0.1', '--master_port', str(free_port()), '-m',
                 'patchgan_tpu_torch.cli.train', '-c', cfg, '-n', '1', '-b',
                 str(SP_B), '-d', 'cuda', '--no-summary',
                 '--dataloader_workers', '1'], cwd=tmp, env=env, stdout=log,
                stderr=subprocess.STDOUT, timeout=SP_JOIN_S).returncode
        except subprocess.TimeoutExpired:
            rc = 'a timeout'
    wall = time.perf_counter() - t0
    with open(log_path) as f:
        text = f.read()
    print(text[-2000:], end='')
    ck = os.path.join(tmp, 'ck')
    files = sorted(os.listdir(ck)) if os.path.isdir(ck) else []
    finite = all(np.isfinite(v).all() for f in files
                 for v in np.load(os.path.join(ck, f)).values())
    if rc != 0 or f'Spatial parallel: 1 x {SP} ranks' not in text or \
            re.search(r'\bnan\b', text.lower()) or not finite or \
            files != ['discriminator_ep_001.npz', 'generator_ep_001.npz']:
        print(text[-6000:])
        raise AssertionError(f'17c: patchgan_train under torchrun: exit '
                             f'{rc}, files {files}')
    out_dir = os.path.join(tmp, 'sp_scale')
    os.makedirs(out_dir)
    port = free_port()
    run_ranks([[sys.executable, '-c',
                'import chip_smoke; chip_smoke.sp_scale_child()', str(rank),
                str(port), out_dir] for rank in range(SP)], tmp, 'sp_scale',
              timeout=SP_JOIN_S)
    with open(os.path.join(out_dir, 'spatial.json')) as f:
        grid = json.load(f)
    # [launches, on the wgmma core] of K2's and K3's band entries in rank
    # 0's eager step and capture
    if not all(n > 0 and on == n for n, on in grid['band_launches'].values()):
        raise AssertionError(f'17c: band launches off the wgmma core: '
                             f'{grid["band_launches"]}')
    med = {k: statistics.median(grid[k])
           for k in ('img_per_s', 'one_card_img_per_s')}
    out = {'run': True, 'cards': n, 'train_cli_wall_s': wall,
           'median_img_per_s': med['img_per_s'],
           'one_card_median_img_per_s': med['one_card_img_per_s'], **grid}
    print(f'  (1, {SP}) captured bf16 step at {SP_SIZE} px, batch {SP_B}, '
          f'{WINDOWS} windows of >= {WINDOW_S} s a side in turns: img/s '
          f'{[round(v, 3) for v in grid["img_per_s"]]} (median '
          f'{med["img_per_s"]:.3f}) against one card '
          f'{[round(v, 3) for v in grid["one_card_img_per_s"]]} (median '
          f'{med["one_card_img_per_s"]:.3f}); peak a rank '
          f'{grid["peak_bytes"] / 2 ** 30:.3f} GiB against one card '
          f'{grid["one_card_peak_bytes"] / 2 ** 30:.3f} GiB; band launches '
          f'[all, on the wgmma core] {grid["band_launches"]} on {card}',
          flush=True)
    return out


def sp_phase(torch, np, F, kernels, card):
    """Phase 17: spatial parallelism (see the module's docstring). Returns
    (rank 0's launches in 17b's step, the summary, 17a's rows by band
    entry)."""
    out = {'card': card}
    t0 = time.perf_counter()
    print('  17a: the band kernels at the bands of a 1024-px image',
          flush=True)
    with torch.inference_mode():
        bands = band_kernel_phase(torch, F, kernels[:4])
    out['band_kernel_s'] = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        print(f'  17b: two gloo ranks sharing the card (dp 1 x sp {SP})',
              flush=True)
        launches, out['gloo_sp2'] = sp_gloo_phase(torch, np, card, tmp)
        print('  17c: NCCL across cards', flush=True)
        out['across_cards'] = sp_nccl_phase(torch, np, card, tmp)
    out['phase_wall_s'] = time.perf_counter() - t0
    return launches, out, bands


def sp_only(torch, np, F, kernels, card):
    """``python3 chip_smoke.py --spatial-only``: phase 17 alone."""
    print('== spatial parallelism (ROADMAP item 11d)', flush=True)
    launches, sp, bands = sp_phase(torch, np, F, kernels, card)
    print(json.dumps({'spatial': sp, 'launches': launches,
                      'band_kernels': bands}))
    print(card)


# phase 18b: UNet(remat=...) in the captured step; its runs: (batch, px)
# -> (remat, s2d form)s
REMAT_RUNS = {(TRAIN_B, SIZE): list(REMAT_STEP),
              (SP_B, SP_SIZE): [('off', 'off'), ('all', 'off'),
                                ('ends', 'off')]}


def remat_run(torch, np, wrappers, remat, form, n, size):
    """Three steps (an eager one, a capture and its replay, a replay) of
    the captured bf16 step at config 2's widths with ``remat``, batch
    ``n`` of ``size`` px, in the s2d ``form`` 'on' or 'off', from phase
    17's seeded state: (one step, the
    wrappers' launches over the three, the updated parameters on the
    host with their names, the peak bytes the steps took above what the
    card held before)."""
    gc.collect()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gen, disc = train_models(torch, remat=remat)
    step, _ = config_step(torch, gen, disc, form, False, 1, True)
    x, y = (t.to(torch.bfloat16) for t in train_batch(
        torch, np, n, size, 'cuda', 18))
    for w in wrappers:
        w.launches = 0
    for _ in range(3):
        losses = step(x, y)
    torch.cuda.synchronize()
    launched = [w.launches for w in wrappers]
    if step.replays != 2 or not all(np.isfinite(float(v))
                                    for v in losses.values()):
        raise AssertionError(f'18b {remat}: replays {step.replays}, losses '
                             f'{losses}')
    named = [(f'G.{k}', p) for k, p in gen.named_parameters()] + \
        [(f'D.{k}', p) for k, p in disc.named_parameters()]
    params = [(k, p.detach().float().cpu().numpy()) for k, p in named]
    peak = torch.cuda.max_memory_allocated() - held
    return (lambda: step(x, y)), launched, params, peak


def first_difference(np, want, got):
    """(equal bits, the first parameter in the forward's order that
    differs with its max |diff|, whether every one is within rtol 2e-3 /
    atol 2e-4)."""
    first, close = None, True
    for (name, a), (_, b) in zip(want, got):
        if not np.array_equal(a, b):
            if first is None:
                first = (name, float(np.max(np.abs(a - b))))
            close &= bool(np.allclose(b, a, rtol=2e-3, atol=2e-4))
    return first is None, first, close


def replay_kernels(torch, fn, tries=3, names=PROFILE_NAMES):
    """K1 / K2 / K3 / K1-bwd / K4 / K4-wgrad a call of ``fn`` (a captured
    step's replay) on the device, counted by the profiler as phase 10
    counts them (by ``names``), over two calls after a traced warm-up
    call whose records are dropped: the largest of up to ``tries``
    readings, stopping once one repeats it (the tracer now and then loses
    a run of records, never adds one)."""
    from torch.profiler import ProfilerActivity, profile, schedule
    best = None
    for _ in range(tries):
        cycle = []
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=2),
                     on_trace_ready=lambda p: cycle.append(kernel_rows(p, 2))
                     ) as prof:
            for _ in range(3):
                fn()
                torch.cuda.synchronize()
                prof.step()
        device = [sum(c for _, c, name in cycle[0]
                      if all(part in name for part in parts))
                  for parts in names]
        if device == best:
            break
        best = device if best is None else max(best, device, key=sum)
    return best


def remat_phase(torch, np, wrappers, card):
    """Phase 18b (see the module's docstring). Returns (the wrappers'
    launches of each run by path, the summary)."""
    out, paths = {'card': card}, {}
    t0 = time.perf_counter()
    with cudnn_flags_kept(torch):
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        for (n, size), keys in REMAT_RUNS.items():
            runs, res, base = {}, {}, {}
            for key in keys:
                remat, form = key
                label = f'{remat} s2d {form}'
                fn, launched, params, peak = remat_run(
                    torch, np, wrappers, REMAT_FORMS[remat], form, n, size)
                want = [2 * c for c in REMAT_STEP[key]]
                if launched != want:
                    raise AssertionError(f'18b {size} px {label}: the '
                                         f'wrappers launched {launched}, '
                                         f'expected {want}')
                device = replay_kernels(torch, fn)
                if size == SIZE and device != REMAT_STEP[key]:
                    # the tracer can lose records (phase 10): never more
                    # than the wrappers launched
                    if any(d > w for d, w in zip(device, REMAT_STEP[key])):
                        raise AssertionError(
                            f"18b {size} px {label}: a replay ran {device} "
                            f"of the port's kernels, expected "
                            f"{REMAT_STEP[key]}")
                    print(f'  18b {size} px {label}: the trace lost records '
                          f'of kernels the wrappers launched', flush=True)
                runs[label] = fn
                res[label] = {'peak_memory_bytes': peak,
                              'replay_kernels': device,
                              'wrapper_launches_3_steps': launched,
                              'img_per_s_windows': []}
                if remat == 'off':
                    base[form] = params
                else:
                    same, first, close = first_difference(np, base[form],
                                                          params)
                    res[label].update(equal_bits=same, first_differing=first)
                    if not same and not close:
                        raise AssertionError(
                            f"18b {size} px {label}: parameters after 3 "
                            f"steps differ from remat=False's beyond rtol "
                            f"2e-3 / atol 2e-4, first at {first}")
                paths[f'remat_{remat}_s2d_{form}_{size}px'] = launched
                del params
            base.clear()
            labels = list(runs)
            for i in range(2):
                for label in (labels if i % 2 == 0 else labels[::-1]):
                    count, t1 = 0, time.perf_counter()
                    while time.perf_counter() - t1 < WINDOW_S / 4:
                        for _ in range(5):
                            runs[label]()
                        torch.cuda.synchronize()
                        count += 5
                    res[label]['img_per_s_windows'].append(
                        n * count / (time.perf_counter() - t1))
            for key, label in zip(keys, labels):
                r = res[label]
                r['img_per_s'] = statistics.median(r['img_per_s_windows'])
                first = r.get('first_differing')
                print(f"  18b {size} px batch {n} remat {label} "
                      f"({REMAT_FORMS[key[0]]}): K1 / K2 / K3 / K1-bwd / K4 "
                      f"/ K4-wgrad a replay {r['replay_kernels']} (expected "
                      f"{REMAT_STEP[key]}), the wrappers over eager + "
                      f"capture + replay {r['wrapper_launches_3_steps']}; "
                      f"parameters after 3 steps equal to remat=False's "
                      f"bits {r.get('equal_bits', True)}"
                      f"{'' if first is None else f' (first at {first})'}; "
                      f"peak {r['peak_memory_bytes'] / 2 ** 30:.3f} GiB; "
                      f"img/s {[round(v, 3) for v in r['img_per_s_windows']]}"
                      f" on {card}", flush=True)
            out[f'{size}px_batch_{n}'] = res
            del runs
            gc.collect()
            torch.cuda.empty_cache()
    out['phase_wall_s'] = time.perf_counter() - t0
    return paths, out


def phase_18_only(torch, np, wrappers, card):
    """``python3 chip_smoke.py --phase-18``: phase 13's exact-resume runs
    with 18a beside them, then 18b."""
    with tempfile.TemporaryDirectory() as tmp:
        write_pipeline_inputs(tmp, np)
        resume = resume_phase(torch, np, tmp, card)
    print(json.dumps({'phase_18a': resume['phase_18a']}))
    _, remat = remat_phase(torch, np, wrappers, card)
    print(json.dumps({'phase_18b': remat}))
    print(card)


# phase 19: the G+D step in channels_last (train/auto_layout.py) and the
# NHWC forms of K1, K2, K3 and K1-bwd
CL = 'channels_last'
# the NHWC forms: (name in the kernels line, source, TPU kernel, index of
# their wrapper in ``kernel_wrappers()``); K1's and K1-bwd's source is the
# one-pass kernels' header, K2's and K3's the wgmma core's, which config
# 2's step takes (the segmented kernels, csrc/norm_nhwc.cuh, and the WMMA
# core, csrc/conv_gemm.cuh, beside them in the line)
NHWC_FORMS = (
    ('instance_norm_act_nhwc',
     'patchgan_tpu_torch/csrc/norm_nhwc_cluster.cuh',
     'patchgan_tpu/ops/pallas/norm_act.py:211', 0),
    ('conv_norm_act_nhwc', 'patchgan_tpu_torch/csrc/conv_wgmma.cuh',
     'patchgan_tpu/ops/pallas/conv_norm_act.py:176', 1),
    ('convt_norm_act_nhwc', 'patchgan_tpu_torch/csrc/conv_wgmma.cuh',
     'patchgan_tpu/ops/pallas/convt_norm_act.py:178', 2),
    ('instance_norm_act_backward_nhwc',
     'patchgan_tpu_torch/csrc/norm_nhwc_cluster.cuh',
     'patchgan_tpu/ops/pallas/norm_act.py:253', 3))
# cuDNN's layout transposes, as the profiler names their kernels
# (lower-cased)
TRANSPOSE_KEYS = ('nchwtonhwc', 'nhwctonchw')
SHADOW_STEPS = 3      # steps of the captured shadow's bit-equality


def cl(torch, args):
    """The 4-D tensors of ``args`` in channels_last, with its strides
    (a 1 x 1 plane's tensor too, which ``contiguous`` would leave as it
    is: the same bytes, NCHW strides)."""
    return tuple(torch.empty_like(a, memory_format=torch.channels_last)
                 .copy_(a) if torch.is_tensor(a) and a.dim() == 4 else a
                 for a in args)


def cl_offset(torch, t):
    """t as a channels_last tensor one element past a 16-byte boundary
    (the NHWC forms then go element by element)."""
    n, c, h, w = t.shape
    base = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = base[1:].as_strided(t.shape, (h * w * c, 1, w * c, c))
    out.copy_(t)
    return out


def nhwc_launched(w, fn, one_pass=None, wgmma=None):
    """fn() and whether it launched the NHWC form of wrapper w once (and,
    where ``one_pass`` or ``wgmma`` is True or False, on K1's / K1-bwd's
    one-pass kernel or K2's / K3's wgmma core, or not)."""
    before = (w.launches_nhwc, getattr(w, 'launches_one_pass', 0),
              getattr(w, 'launches_wgmma', 0))
    out = fn()
    if w.launches_nhwc != before[0] + 1:
        raise AssertionError(f'{w.__name__}: the NHWC form did not launch')
    for what, want, i, attr in (('the one-pass kernel', one_pass, 1,
                                 'launches_one_pass'),
                                ('the wgmma core', wgmma, 2,
                                 'launches_wgmma')):
        took = getattr(w, attr) == before[i] + 1 if want is not None \
            else None
        if took != want:
            raise AssertionError(f'{w.__name__}: {what} launched: {took}, '
                                 f'expected {want}')
    return out


def wgmma_ptxas(log_by_lib, marks=('conv_wgmma_kernel',)):
    """ptxas's report of each kernel this process built (the build's
    -Xptxas=-v) whose mangled name holds one of ``marks`` (the wgmma
    core's by default): {(library, kernel): (registers, spill stores,
    spill loads)}; empty where no build ran."""
    out = {}
    for lib, log in log_by_lib.items():
        name = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                name = m.group(1) if any(k in m.group(1) for k in marks) \
                    else None
                continue
            if name is None:
                continue
            m = re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads',
                          line)
            if m:
                out[(lib, name)] = [None, int(m.group(1)), int(m.group(2))]
            m = re.search(r'Used (\d+) registers', line)
            if m and (lib, name) in out:
                out[(lib, name)][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


# K1's and K1-bwd's NHWC kernels as the wrappers' private argument names
# them, with whether the launch counts as the one-pass kernel's
NHWC_KERNELS = (('one_pass', True), ('segmented', False))
# a (sample, channel tile) beyond a cluster's shared memory: the
# segmented kernels'
BEYOND_CLUSTER = (2, NF, 512, 512)


def nhwc_kernel_phase(torch, F, kernels):
    """Each NHWC form (K1, K2, K3, K1-bwd) against its plain version at
    every shape of config 2's step (batch 16, 256 px: ``make_cases`` and
    ``bwd_shapes``), bf16 and fp32 within ``TOL`` / ``TOL_BWD``, its
    output channels_last, the NHWC form launched; K3's NHWC pack exactly
    against ``pack_convt_weight_nhwc_plain``. K2 and K3 there on the
    wgmma core in bf16 (two launches bit-equal) and on the WMMA core in
    fp32 (``check_conv``), and in bf16 on the WMMA core forced on the same
    values; ptxas's registers and spills of the wgmma core (none may
    spill). Check-only cases of the element paths, all on the WMMA core:
    K2 at Cin 16 and 48 (no multiple of the 32-channel K step), K3 ragged
    (13 + 6 -> 40) and with Cs = 0, K2 and K3 one element past 16 bytes;
    K1 and K1-bwd at ``norm_edge_cases`` and one element past 16 bytes. K1
    and K1-bwd at the step's shapes in both NHWC kernels (``check_norm``:
    the one-pass kernel the planner picks there, two launches bit-equal,
    and the segmented kernels), and beyond a cluster's shared memory
    (``BEYOND_CLUSTER``), where the planner picks the segmented kernels.
    Timed in bf16: the NHWC form, the NCHW form on the same values, the
    plain version and a library call in channels_last, the bound; K2 and
    K3 on both cores, by events and by a graph's replay (``timed``); K1
    and K1-bwd by events and by a graph's replay (``timed_norm``).
    Returns {form: rows}."""
    from patchgan_tpu_torch.ops.kernels import (_build,
                                                pack_convt_weight_nhwc,
                                                pack_convt_weight_nhwc_plain)
    from patchgan_tpu_torch.ops.kernels.conv_norm_act import conv_nhwc_plan
    from patchgan_tpu_torch.ops.kernels.convt_norm_act import convt_nhwc_plan
    from patchgan_tpu_torch.ops.kernels.norm_act import nhwc_one_pass_plan
    k1, k2, k3, k1b = kernels[:4]
    ptxas = wgmma_ptxas(_build.build_log)
    for (lib, name), (regs, stores, loads) in sorted(ptxas.items()):
        print(f'  ptxas {lib} {name}: {regs} registers, spill stores '
              f'{stores} / loads {loads} bytes', flush=True)
    if not ptxas:
        print('  ptxas: no build in this process, no report of the wgmma '
              'core', flush=True)
    if any(stores or loads for _, stores, loads in ptxas.values()):
        raise AssertionError(f'the wgmma core spills: {ptxas}')
    rows = {name: [] for name, *_ in NHWC_FORMS}
    form = {k1.name: 'instance_norm_act_nhwc', k2.name: 'conv_norm_act_nhwc',
            k3.name: 'convt_norm_act_nhwc',
            k1b.name: 'instance_norm_act_backward_nhwc'}
    gen = torch.Generator(device='cuda').manual_seed(19)

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device='cuda') * scale

    def check(kernel, label, make, tol_of, offset=False, nk=None,
              one_pass=None, repeat=False, wgmma=None):
        """The NHWC form (``nk``: K1's / K1-bwd's kernel forced) against
        the plain version in both dtypes; ``one_pass``: which kernel must
        have launched; ``wgmma``: {dtype name: whether K2's / K3's wgmma
        core must have}; ``repeat``: a second launch bit-equal."""
        errs = {}
        kw = {} if nk is None else {'_nhwc_kernel': nk}
        name = form[kernel.name] + ('' if nk is None else f' {nk}')
        for dname, dt in (('bfloat16', torch.bfloat16),
                          ('float32', torch.float32)):
            args = cl(torch, make(dt))
            if offset:   # the activations, not K2's / K3's weight
                args = tuple(cl_offset(torch, a) if torch.is_tensor(a)
                             and a.dim() == 4 and (kernel not in (k2, k3)
                                                   or i != 1) else a
                             for i, a in enumerate(args))
            if kernel is k3:
                w = args[1]
                if not torch.equal(pack_convt_weight_nhwc(w),
                                   pack_convt_weight_nhwc_plain(w)):
                    raise AssertionError(f'K3 NHWC pack {label} {dname}')
            got = nhwc_launched(kernel.wrapper,
                                lambda: kernel.wrapper(*args, **kw),
                                one_pass, None if wgmma is None
                                else wgmma[dname])
            if not got.is_contiguous(memory_format=torch.channels_last):
                raise AssertionError(f'{kernel.name} {label}: output not '
                                     f'channels_last')
            want = kernel.plain(*(a.float() if torch.is_tensor(a) else a
                                  for a in args)).float()
            torch.cuda.synchronize()
            e = (got.float() - want).abs().max().item()
            tol = tol_of(dname, want)
            same = ''
            if repeat:
                again = kernel.wrapper(*args, **kw)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f'{name} {label} {dname}: two '
                                         f'launches differ')
                same = ', two launches equal'
            print(f'  {name} {label} {dname}: max_abs_err {e:.3e} (tol '
                  f'{tol:.3e}){same}', flush=True)
            if not e <= tol:
                raise AssertionError(f'{name} {label} {dname}: {e} > {tol}')
            errs[dname] = e
        return errs

    def check_norm(kernel, label, make, tol_of):
        """K1's / K1-bwd's one-pass kernel (which the planner picks here,
        two launches bit-equal) and segmented kernels: the errors of
        each."""
        nhwc_launched(kernel.wrapper,
                      lambda: kernel.wrapper(*cl(torch, make(torch.bfloat16))),
                      True)
        return {nk: check(kernel, label, make, tol_of, nk=nk,
                          one_pass=one, repeat=one)
                for nk, one in NHWC_KERNELS}

    def check_conv(kernel, label, make):
        """K2 / K3 at a step shape: the wgmma core in bf16, two launches
        bit-equal; the WMMA core in fp32."""
        return check(kernel, label, make, fwd_tol, repeat=True,
                     wgmma={'bfloat16': True, 'float32': False})

    def on_wmma(kernel):
        """Element-path cases: the WMMA core in both dtypes."""
        return {'bfloat16': False, 'float32': False}

    def fwd_tol(dname, want):
        return TOL[dname]

    def bwd_tol(dname, want):
        return TOL_BWD[dname] * max(1.0, want.abs().max().item())

    def timed(kernel, label, make, library, flops, nbytes, peak, errs):
        """K2 / K3 in bf16: the wgmma core (the planner's, kernel_ms), the
        WMMA core forced on the same values, the NCHW form, the plain
        version and the library call by CUDA events around 20 eager calls
        each, then the two cores and the library call by a CUDA graph's
        replay (``device_ms``) in the reverse order; the WMMA core's
        error beside the wgmma core's."""
        args = make(torch.bfloat16)
        cargs = cl(torch, args)
        fns = {'kernel': lambda: kernel.wrapper(*cargs),
               'wmma': lambda: kernel.wrapper(*cargs, _nhwc_core='wmma'),
               'nchw': lambda: kernel.wrapper(*args),
               'plain': lambda: kernel.plain(*cargs),
               'library': lambda: library(*cargs)}
        ev = {k: cuda_ms(f) for k, f in fns.items()}
        dev = {k: device_ms(fns[k]) for k in ('library', 'wmma', 'kernel')}
        want = kernel.plain(*(a.float() if torch.is_tensor(a) else a
                              for a in cargs)).float()
        wmma_err = (fns['wmma']().float() - want).abs().max().item()
        x = cargs[0]
        n, c, h, w = x.shape
        plan = conv_nhwc_plan(n, c, h, w, cargs[1].shape[0], x.dtype) \
            if kernel is k2 else convt_nhwc_plan(
                n, c, cargs[4].shape[1], h, w, cargs[1].shape[1], x.dtype)
        row = {'kernel': form[kernel.name], 'case': label,
               'dtype': 'bfloat16', 'bn': plan.bn, 'stages': plan.stages,
               'splits': plan.splits, 'samples_a_tile': plan.samples,
               'smem_bytes': plan.smem,
               **{f'{k}_ms': v for k, v in ev.items()},
               **{f'{k}_device_ms': v for k, v in dev.items()},
               'max_abs_err_bf16': errs['bfloat16'],
               'max_abs_err_fp32': errs['float32'],
               'wmma_max_abs_err_bf16': wmma_err}
        row['device_ms'] = row.pop('kernel_device_ms')
        if not wmma_err <= TOL['bfloat16']:
            raise AssertionError(f'{form[kernel.name]} {label} on the WMMA '
                                 f'core: {wmma_err}')
        row['bound_ms'], row['bound_by'] = bound(flops, nbytes, peak)
        rows[form[kernel.name]].append(row)
        print(json.dumps(row), flush=True)

    def timed_norm(kernel, label, make, library, flops, nbytes, errs):
        """K1 / K1-bwd in bf16: the one-pass kernel (kernel_ms), the
        segmented kernels, the NCHW form on the same values, the plain
        version and the library call, by CUDA events around 20 eager
        calls each in that order, then by a CUDA graph's replay
        (``device_ms``) in the reverse order."""
        args = make(torch.bfloat16)
        cargs = cl(torch, args)
        fns = {'kernel': lambda: kernel.wrapper(*cargs,
                                                _nhwc_kernel='one_pass'),
               'segmented': lambda: kernel.wrapper(
                   *cargs, _nhwc_kernel='segmented'),
               'nchw': lambda: kernel.wrapper(*args),
               'plain': lambda: kernel.plain(*cargs),
               'library': lambda: library(*cargs)}
        ev = {k: cuda_ms(f) for k, f in fns.items()}
        dev = {k: device_ms(f) for k, f in reversed(list(fns.items()))}
        n, c, h, w = cargs[0].shape
        plan = nhwc_one_pass_plan(n, h * w, c, torch.bfloat16,
                                  2 if kernel is k1b else 1)
        row = {'kernel': form[kernel.name], 'case': label,
               'dtype': 'bfloat16', 'lanes': plan.lanes,
               'cluster': plan.cluster, 'ctas': plan.cluster * plan.tiles * n,
               'smem_bytes': plan.smem,
               **{f'{k}_ms': v for k, v in ev.items()},
               **{f'{k}_device_ms': v for k, v in dev.items()},
               'max_abs_err_bf16': errs['one_pass']['bfloat16'],
               'max_abs_err_fp32': errs['one_pass']['float32'],
               'segmented_max_abs_err_bf16': errs['segmented']['bfloat16'],
               'segmented_max_abs_err_fp32': errs['segmented']['float32']}
        row['device_ms'] = row.pop('kernel_device_ms')
        row['bound_ms'], row['bound_by'] = bound(flops, nbytes, PEAK_FP32)
        rows[form[kernel.name]].append(row)
        print(json.dumps(row), flush=True)

    for kernel, label, make, library, flops, elems, _ in make_cases(
            torch, F, (k1, k2, k3), n=TRAIN_B):
        if kernel is k1:
            errs = check_norm(kernel, label, make, fwd_tol)
            timed_norm(kernel, label, make, library, flops, 2 * elems, errs)
            continue
        errs = check_conv(kernel, label, make)
        timed(kernel, label, make, library, flops, 2 * elems, PEAK_BF16,
              errs)
    for label, shape in bwd_shapes():
        x, g = rand(*shape), rand(*shape)

        def make(dt, x=x, g=g):
            return g.to(dt), x.to(dt), 1e-5, 'relu'

        def library(g, x, eps, act):
            xr = x.detach().requires_grad_()
            y = F.relu(F.instance_norm(xr, eps=eps))
            return torch.autograd.grad(y, xr, g)

        errs = check_norm(k1b, f'{label} {shape}', make, bwd_tol)
        timed_norm(k1b, f'{label} {shape}', make, library,
                   BWD_FLOPS * x.numel(), 3 * 2 * x.numel(), errs)
    # beyond a cluster's shared memory the planner takes the segmented
    # kernels
    x, g = rand(*BEYOND_CLUSTER), rand(*BEYOND_CLUSTER)
    check(k1, f'beyond a cluster {BEYOND_CLUSTER}',
          lambda dt: (x.to(dt), 1e-5, 'relu'), fwd_tol, one_pass=False)
    check(k1b, f'beyond a cluster {BEYOND_CLUSTER}',
          lambda dt: (g.to(dt), x.to(dt), 1e-5, 'relu'), bwd_tol,
          one_pass=False)
    del x, g
    # check-only: the element paths, other activations
    for cin, cout, hw in ((16, 40, (24, 40)), (48, 64, (16, 16))):
        x, wt = rand(4, cin, *hw), rand(cout, cin, 4, 4, scale=0.1)
        check(k2, f'Cin {cin} -> {cout} {hw}',
              lambda dt, x=x, wt=wt: (x.to(dt), wt.to(dt), 1e-5, 'tanh'),
              fwd_tol, wgmma=on_wmma(k2))
    for cx, cs, cout, hw in ((13, 6, 40, (12, 20)), (64, 0, 32, (8, 8))):
        x, wt = rand(4, cx, *hw), rand(cx + cs, cout, 4, 4, scale=0.1)
        s = rand(4, cs, *hw) if cs else None
        check(k3, f'({cx}+{cs}) -> {cout} {hw}',
              lambda dt, x=x, wt=wt, s=s: (
                  x.to(dt), wt.to(dt), 1e-5, 'leakyrelu',
                  None if s is None else s.to(dt)), fwd_tol,
              wgmma=on_wmma(k3))
    # the wgmma core's shapes with x (and skip) one element past 16
    # bytes: the WMMA core's element path
    x, wt = rand(4, 64, 16, 16), rand(64, 64, 4, 4, scale=0.1)
    check(k2, 'one element past 16 bytes 64 -> 64 (16, 16)',
          lambda dt: (x.to(dt), wt.to(dt), 1e-5, 'relu'), fwd_tol,
          offset=True, wgmma=on_wmma(k2))
    x, s = rand(4, 64, 8, 8), rand(4, 64, 8, 8)
    wt = rand(128, 64, 4, 4, scale=0.1)
    check(k3, 'one element past 16 bytes (64+64) -> 64 (8, 8)',
          lambda dt: (x.to(dt), wt.to(dt), 1e-5, 'relu', s.to(dt)), fwd_tol,
          offset=True, wgmma=on_wmma(k3))
    for label, pair in norm_edge_cases(torch, gen):
        if 'past' in label:
            continue
        for act in (ACTS if label == '(3, 5, 4, 4)' else ('relu',)):
            check(k1, f'edge {label} act={act}',
                  lambda dt, p=pair, a=act: (p(dt)[0], 1e-5, a), fwd_tol)
            check(k1b, f'edge {label} act={act}',
                  lambda dt, p=pair, a=act: (p(dt)[1], p(dt)[0], 1e-5, a),
                  bwd_tol)
    x, g = rand(2, 16, 16, 16), rand(2, 16, 16, 16)
    check(k1, 'one element past 16 bytes (2, 16, 16, 16)',
          lambda dt: (x.to(dt), 1e-5, 'relu'), fwd_tol, offset=True)
    check(k1b, 'one element past 16 bytes (2, 16, 16, 16)',
          lambda dt: (g.to(dt), x.to(dt), 1e-5, 'relu'), bwd_tol,
          offset=True)
    for name, r in rows.items():
        total = {k: sum(row[k] for row in r) for k in r[0]
                 if k.endswith('_ms')}
        print(f'  {name}, the step\'s {len(r)} shapes: ' + ', '.join(
            f'{k} {v:.4f}' for k, v in total.items()), flush=True)
    return rows


def cl_parity_phase(torch, np, wrappers, refs):
    """The fp32 channels_last step (nf=64, 256 px, batch 2, dropout off,
    TF32 off): the models converted with ``to_layout``, the batch
    channels_last; its losses and gradients against the CPU's and the
    NCHW card step's of ``step_parity_phase`` (``refs``), losses within
    rtol 2e-3 / atol 2e-4, gradients 1e-3 of max |g|; every launch of
    K1, K2, K3 and K1-bwd in its NHWC form; every activation channels_last
    (a forward hook on each block)."""
    from patchgan_tpu_torch.train.auto_layout import to_layout
    gen, disc, x, y = refs['models']
    gen_c, disc_c = copy.deepcopy(gen).cuda(), copy.deepcopy(disc).cuda()
    to_layout((gen_c, disc_c))
    bad = []

    def hook(module, args, out):
        if not out.is_contiguous(memory_format=torch.channels_last):
            bad.append(type(module).__name__)

    hooks = [b.register_forward_hook(hook)
             for b in [*gen_c.encoder, *gen_c.decoder]]
    for w in wrappers:
        w.launches = 0
        if hasattr(w, 'launches_nhwc'):
            w.launches_nhwc = 0
        if hasattr(w, 'launches_one_pass'):
            w.launches_one_pass = 0
        if hasattr(w, 'launches_wgmma'):
            w.launches_wgmma = 0
    losses, grads = step_grads(torch, gen_c, disc_c,
                               *cl(torch, (x.cuda(), y.cuda())), 'off')
    for h in hooks:
        h.remove()
    nhwc = [w.launches_nhwc for w in wrappers[:4]]
    one_pass = [wrappers[i].launches_one_pass for i in (0, 3)]
    wgmma = [w.launches_wgmma for w in wrappers[1:3]]
    print(f'  launches {[w.launches for w in wrappers]}, of them NHWC '
          f'{nhwc}, K1\'s and K1-bwd\'s on the one-pass kernel {one_pass}, '
          f'K2\'s and K3\'s on the wgmma core {wgmma} (fp32: none); '
          f'blocks whose output left channels_last: {bad}', flush=True)
    if nhwc != STEP['off'][:4] or [w.launches for w in wrappers] != \
            STEP['off'] or one_pass != [nhwc[0], nhwc[3]] or bad or \
            wgmma != [0, 0]:
        raise AssertionError(f'channels_last step: NHWC launches {nhwc}, '
                             f'one-pass {one_pass}, wgmma {wgmma}, blocks '
                             f'out of channels_last {bad}')
    out = {}
    for ref in ('cpu', 'card_nchw'):
        want_l, want_g = refs[ref]
        for k, want in want_l.items():
            got = losses[k]
            if not abs(got - want) <= 2e-4 + 2e-3 * abs(want):
                raise AssertionError(f'channels_last loss {k}: {got} vs '
                                     f'{ref} {want}')
        worst = max((a - b).abs().max().item() / max(
            b.abs().max().item(), 1e-30) for a, b in zip(grads, want_g))
        out[ref] = {'losses': losses, 'worst_grad_rel': worst}
        print(f'  channels_last vs {ref}: losses {losses}, worst max |dg| / '
              f'max |g| {worst:.3e} (tol 1e-3)', flush=True)
        if not worst <= 1e-3:
            raise AssertionError(f'channels_last gradients vs {ref}: '
                                 f'{worst}')
    return out


def cl_step(torch, shadow, graph=True):
    """Config 2's bf16 step in channels_last (dropout on), with the
    generator's shadow or without: (step, (gen, disc, opts))."""
    from patchgan_tpu_torch.train.auto_layout import to_layout
    from patchgan_tpu_torch.train.steps import make_optimizer, make_train_step
    gen, disc = train_models(torch)
    to_layout((gen, disc))
    opts = (make_optimizer(gen.parameters(), LR, mu_dtype=torch.bfloat16),
            make_optimizer(disc.parameters(), LR, mu_dtype=torch.bfloat16))
    step = make_train_step(gen, disc, *opts, graph=graph, layout=CL,
                           shadow_dtype=torch.bfloat16 if shadow else None)
    return step, (gen, disc, opts)


def shadow_parity_phase(torch, np):
    """The captured channels_last step with the shadow against the same
    step without it, ``SHADOW_STEPS`` steps each (an eager step, the
    capture, replays), bf16, batch 16, dropout on, deterministic cuDNN:
    every step's losses, then every parameter, moment, count and the
    dropout generator's state bit-equal; the shadows equal the cast
    masters."""
    batches = [tuple(t.to(torch.bfloat16) for t in train_batch(
        torch, np, TRAIN_B, SIZE, 'cuda', 90 + i))
        for i in range(SHADOW_STEPS)]
    result = {}
    with cudnn_flags_kept(torch):
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        for shadow in (False, True):
            step, (gen, disc, opts) = cl_step(torch, shadow)
            losses = [torch.stack(list(step(*b).values())).cpu()
                      for b in batches]
            torch.cuda.synchronize()
            result[shadow] = (losses, step_state(torch, gen, disc, opts))
            if shadow:
                named = dict(gen.named_parameters())
                cast = all(torch.equal(t, named[n].to(t.dtype))
                           for n, t in step.shadows.items())
                counts = (step.eager_steps, step.captures, step.replays)
            del step, gen, disc, opts
    (l_p, (t_p, c_p)), (l_s, (t_s, c_s)) = result[False], result[True]
    same_losses = all(torch.equal(a, b) for a, b in zip(l_p, l_s))
    same = [torch.equal(a, b) for a, b in zip(t_p, t_s)]
    out = {'losses_equal': same_losses, 'tensors_equal': sum(same),
           'tensors': len(same), 'shadows_equal_cast_masters': cast,
           'eager_capture_replay': counts}
    print(f'  shadow vs plain, captured, channels_last, {SHADOW_STEPS} '
          f'steps: {out}, counters {c_s} (plain {c_p})', flush=True)
    if not (same_losses and all(same) and cast and c_p == c_s) or \
            counts != (1, 1, SHADOW_STEPS - 1):
        raise AssertionError(f'the shadow step differs: {out}')
    return out


def transposes_by_op(torch, np, n_steps=1):
    """cuDNN's layout transposes in ``n_steps`` eager channels_last steps
    with the shadow (after one to warm up), each named with the operator
    that launched it: {(operator chain, kernel): launches a step}."""
    from torch.profiler import ProfilerActivity, profile
    step, _ = cl_step(torch, True, graph=False)
    x, y = (t.to(torch.bfloat16) for t in train_batch(
        torch, np, TRAIN_B, SIZE, 'cuda', 95))
    step(x, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        for _ in range(n_steps):
            step(x, y)
        torch.cuda.synchronize()
    found = {}
    for e in prof.events():
        for k in getattr(e, 'kernels', None) or []:
            if any(t in k.name.lower() for t in TRANSPOSE_KEYS):
                chain, p = [e.name], e.cpu_parent
                while p is not None and len(chain) < 4:
                    chain.append(p.name)
                    p = p.cpu_parent
                shapes = [tuple(s) for s in (e.input_shapes or [])[:2]]
                key = (f'{" < ".join(chain)} on {shapes}', k.name[:80])
                found[key] = found.get(key, 0) + 1 / n_steps
    return found


def layout_phase(torch, np, F, kernels, card, refs):
    """Phase 19's checks before phase 10's timing: the NHWC forms, the
    fp32 channels_last step's parity, the captured shadow's bits, the
    transposes an eager channels_last step still launches."""
    t0 = time.perf_counter()
    print('== channels_last: the NHWC forms of K1, K2, K3 and K1-bwd at '
          'config 2\'s step shapes (batch 16, 256 px)', flush=True)
    rows = nhwc_kernel_phase(torch, F, kernels)
    for k in kernels[:4]:
        rows_k = rows[next(n for n, _, _, i in NHWC_FORMS
                           if kernels[i] is k)]
        k.nhwc_rows = rows_k
    wrappers = [k.wrapper for k in kernels]
    print('== channels_last: the fp32 step (nf=64, 256 px, batch 2) against '
          'the CPU and the NCHW card step', flush=True)
    parity = cl_parity_phase(torch, np, wrappers, refs)
    print('== channels_last: the captured step with the shadow against '
          'without, bit for bit', flush=True)
    shadow = shadow_parity_phase(torch, np)
    found = transposes_by_op(torch, np)
    print(f'  cuDNN layout transposes an eager channels_last shadow step '
          f'launches, by operator: {len(found)} kinds', flush=True)
    for (chain, name), n in sorted(found.items(), key=lambda t: -t[1]):
        print(f'    {n:6.1f}/step  {name}  from {chain}', flush=True)
    out = {'parity': parity, 'shadow': shadow,
           'transposes_eager_by_op': {f'{c} :: {k}': n
                                      for (c, k), n in found.items()},
           'card': card, 'phase_wall_s': time.perf_counter() - t0}
    print(json.dumps({'layout': out}), flush=True)
    return out


def layout_only(torch, np, F, kernels, card):
    """``python3 chip_smoke.py --layout-only``: phase 19's checks, then
    phase 10's timing of the plain and the channels_last steps alone."""
    global TRAIN_CONFIGS
    refs = {}
    step_parity_phase(torch, np, [k.wrapper for k in kernels], 'off', refs)
    layout_phase(torch, np, F, kernels, card, refs)
    TRAIN_CONFIGS = {k: v for k, v in {**TRAIN_CONFIGS, **CL_PLAIN}.items()
                     if k in ('off graph', 'cl graph', 'cl shadow graph')}
    train = throughput_phase(torch, np, card)
    print(json.dumps({'train': train}))


def main(only=None):
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device available', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch.nn.functional as F
    from patchgan_tpu_torch.inference import InferenceEngine
    from patchgan_tpu_torch.ops.kernels import (
        _build, conv_norm_act, conv_norm_act_plain, convt_norm_act,
        convt_norm_act_plain, instance_norm_act, instance_norm_act_backward,
        instance_norm_act_backward_plain, instance_norm_act_plain,
        thin_conv3x3, thin_conv3x3_plain, thin_conv3x3_wgrad,
        thin_conv3x3_wgrad_plain)

    t_start = time.perf_counter()

    def mark(phases):
        """The wall since the start, after ``phases``: where the time
        goes, phase by phase."""
        print(f'phases {phases}: {time.perf_counter() - t_start:.3f} s',
              flush=True)

    card = card_line()
    print(f'card: {card}')
    print(f'python {sys.version.split()[0]} torch {torch.__version__} '
          f'cuda {torch.version.cuda}', flush=True)
    t0 = time.perf_counter()
    _build.build()
    print(f'build: {time.perf_counter() - t0:.2f} s', flush=True)
    for name, log in _build.build_log.items():
        for line in log.splitlines():
            if 'registers' in line or 'spill' in line:
                print(f'  ptxas {name}: {line.strip()}')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    kernels = (
        Kernel('instance_norm_act', 'patchgan_tpu_torch/csrc/norm_act.cu',
               'patchgan_tpu/ops/pallas/norm_act.py:211',
               instance_norm_act, instance_norm_act_plain),
        Kernel('conv_norm_act', 'patchgan_tpu_torch/csrc/conv_norm_act.cu',
               'patchgan_tpu/ops/pallas/conv_norm_act.py:176',
               conv_norm_act, conv_norm_act_plain),
        Kernel('convt_norm_act',
               'patchgan_tpu_torch/csrc/convt_norm_act.cu',
               'patchgan_tpu/ops/pallas/convt_norm_act.py:178',
               convt_norm_act, convt_norm_act_plain),
        Kernel('instance_norm_act_backward',
               'patchgan_tpu_torch/csrc/norm_act_bwd.cu',
               'patchgan_tpu/ops/pallas/norm_act.py:253',
               instance_norm_act_backward, instance_norm_act_backward_plain),
        Kernel('thin_conv3x3', 'patchgan_tpu_torch/csrc/thin_conv.cu',
               'patchgan_tpu/ops/pallas/thin_conv.py:196',
               thin_conv3x3, thin_conv3x3_plain),
        Kernel('thin_conv3x3_wgrad', 'patchgan_tpu_torch/csrc/thin_conv.cu',
               'patchgan_tpu/ops/pallas/thin_conv.py:216',
               thin_conv3x3_wgrad, thin_conv3x3_wgrad_plain))
    wrappers = [k.wrapper for k in kernels]
    if only == '--mesh-only':
        mesh_only(torch, np, F, kernels, card)
        return 0
    if only == '--tp-only':
        tp_only(torch, np, F, kernels, card)
        return 0
    if only == '--spatial-only':
        sp_only(torch, np, F, kernels, card)
        return 0
    if only == '--phase-18':
        phase_18_only(torch, np, wrappers, card)
        return 0
    if only == '--layout-only':
        layout_only(torch, np, F, kernels, card)
        print(card_line())
        return 0
    print('== kernel phase (8 tiles of 256 px, nf=64; the s2d paths\' '
          'thin convs)', flush=True)
    with torch.inference_mode():
        kernel_phase(torch, F, kernels[:3])
        thin_conv_phase(torch, F, kernels[4], kernels[5])
    mark('1-2')

    paths = {}
    for s2d in ('off', 'on'):
        print(f'== main path: patchgan_infer -d cuda, PATCHGAN_S2D={s2d}',
              flush=True)
        path = f'infer_s2d_{s2d}'
        paths[path], model, masks = wgmma_grew(path, lambda: infer_path_phase(
            torch, np, kernels, s2d), exact=False)
        if WGMMA_PATHS[path] != [paths[path][k.name] for k in kernels[1:3]]:
            raise AssertionError(f'{path}: K2 / K3 on the wgmma core '
                                 f'{WGMMA_PATHS[path]}, launched '
                                 f'{paths[path]}')
        if s2d == 'off':
            plain_masks = masks
    agree = [float(np.mean(a == b)) for a, b in zip(plain_masks, masks)]
    print(f'  s2d vs plain bf16 masks: label agreement {agree}', flush=True)

    print('== full forward, one bucket of 8 tiles', flush=True)
    tiles = torch.from_numpy(np.random.default_rng(1).random(
        (B, IN_C, SIZE, SIZE), dtype=np.float32))
    model.eval()
    engines = {}
    with torch.inference_mode():
        ref = model.to(torch.float32)(tiles)            # plain path, CPU
        for s2d in ('off', 'on'):
            with s2d_env(s2d):
                eng32 = InferenceEngine(model, dtype=torch.float32)
                engines[s2d] = InferenceEngine(model, dtype=torch.bfloat16)
            for w in wrappers:
                w.launches = 0
            on = conv_norm_act.launches_wgmma
            p32 = eng32._forward(tiles.cuda()).cpu()
            n4 = thin_conv3x3.launches
            d32 = (p32 - ref).abs().max().item()
            del eng32
            if conv_norm_act.launches_wgmma != on:
                raise AssertionError(f's2d {s2d}: the fp32 forward launched '
                                     f'the wgmma core')
            p16 = wgmma_grew(f'forward_8_tiles_s2d_{s2d}', lambda: engines[
                s2d]._forward(tiles.cuda()).cpu())
            d16 = (p16 - ref).abs().max().item()
            agree = (p16.argmax(1) == ref.argmax(1)).float().mean().item()
            print(f'  s2d {s2d}: fp32 kernels vs plain: max |dprob| '
                  f'{d32:.3e} (tol 1e-3), K4 launches {n4}')
            print(f'  s2d {s2d}: bf16 kernels vs fp32 plain: max |dprob| '
                  f'{d16:.3e}, argmax agreement {agree:.5f}', flush=True)
            if not d32 <= 1e-3:
                raise AssertionError(f's2d {s2d}: fp32 forward differs by '
                                     f'{d32}')
            if n4 != (1 if s2d == 'on' else 0):
                raise AssertionError(f's2d {s2d}: {n4} K4 launches')

    print('== inference throughput (bf16), plain and s2d in turns',
          flush=True)
    infer = wgmma_grew('infer_throughput', lambda: infer_throughput_phase(
        torch, np, engines, card))
    print(json.dumps(infer))
    del engines
    mark('1-5')

    print(f'== K1-bwd at the training shapes (batch {TRAIN_B}, 256 px, '
          f'nf={NF})', flush=True)
    backward_phase(torch, F, kernels[3])
    mark('1-6')
    epoch_s, finetune, refs = {}, {}, {}
    names = [k.name for k in kernels]
    for s2d in ('off', 'on'):
        print('== step parity: kernel path on the card vs plain path on '
              f'the CPU (nf=64, 256 px, batch 2, fp32), s2d {s2d}',
              flush=True)
        step_parity_phase(torch, np, wrappers, s2d,
                          refs if s2d == 'off' else None)
        print('== fine-tune step parity: encoder frozen, accumulate 2, '
              'kernel path on the card vs plain path on the CPU (nf=64, '
              f'256 px, two micro-batches of 2, fp32), s2d {s2d}',
              flush=True)
        finetune[f'parity_s2d_{s2d}'] = finetune_parity_phase(
            torch, np, wrappers, s2d)
        with tempfile.TemporaryDirectory() as tmp:
            print(f'== training path: patchgan_train -d cuda, then resume, '
                  f'PATCHGAN_S2D={s2d}', flush=True)
            launches, epoch_s[s2d], train_cfg = train_path_phase(
                torch, np, wrappers, card, s2d, tmp)
            paths[f'train_s2d_{s2d}'] = dict(zip(names, launches))
            print('== fine-tune path: patchgan_train -d cuda from .pth '
                  'files, freeze_encoder, accumulate_steps 2, '
                  f'PATCHGAN_S2D={s2d}', flush=True)
            paths[f'finetune_s2d_{s2d}'] = dict(zip(names, finetune_path_phase(
                torch, np, wrappers, s2d, tmp, train_cfg)))
            if s2d == 'off':
                print('== evaluation path: patchgan_eval -d cuda on the '
                      'training folder\'s validation images', flush=True)
                launches, eval_img_s, results = eval_path_phase(
                    torch, np, wrappers, card, tmp, train_cfg)
                paths['eval'] = dict(zip(names, launches))
    for s2d in ('off', 'on'):
        print(f'  s2d {s2d}, per step as counted in the runs above: the '
              f'port\'s kernels {STEP[s2d]} full, {FT_STEP[s2d]} frozen; '
              f'recomputes {RECOMPUTES["full"]} full, '
              f'{RECOMPUTES["frozen"]} frozen', flush=True)
    print(json.dumps({'eval': results, 'eval_img_per_s': eval_img_s,
                      'finetune': finetune, 'card': card}))
    mark('1-9')
    print('== the captured step against the eager step, bit for bit (bf16, '
          'dropout on, deterministic cuDNN): full and frozen in both forms, '
          'accumulating 2 x 8; an LR written between steps; a restore',
          flush=True)
    t10 = time.perf_counter()
    parity = graph_parity_phase(torch, np, wrappers)
    print(json.dumps({'graph_parity': parity,
                      'phase_wall_s': time.perf_counter() - t10}))
    mark('1-9, 10\'s parity')
    layout_phase(torch, np, F, kernels, card, refs)
    mark('1-9, 10\'s parity, 19')
    print(f'== training throughput (bf16): the full step at batch {TRAIN_B} '
          'and the fine-tune step, plain and s2d, eager and captured, and '
          'the captured step in channels_last without and with the shadow, '
          'in turns', flush=True)
    t10 = time.perf_counter()
    train = throughput_phase(torch, np, card)
    train.update({'epoch_s': epoch_s, 'card': card,
                  'phase_wall_s': time.perf_counter() - t10})
    print(json.dumps(train))
    print('== patchgan_aot --shadow -d cuda: config 2 at batch 16 and 4096',
          flush=True)
    from patchgan_tpu_torch.train.auto_layout import auto_layout_enabled
    aot = aot_phase(torch, card, train[
        'cl shadow graph' if auto_layout_enabled() else 'off graph']
        ['own_peak_memory_bytes'])
    print(json.dumps({'aot': aot}))
    mark('1-10, 19')

    print('== spatial mode: whole-image forward (nf=64), parity on the CPU, '
          'K1-K3 at the 1280x960 image\'s shapes, masks/s against tiled',
          flush=True)
    launches, spatial = wgmma_grew('spatial', lambda: spatial_phase(
        torch, np, F, kernels, model, card), exact=False)
    paths['spatial'] = dict(zip(names, launches))
    print(json.dumps(spatial))
    mark('1-11, 19')
    with tempfile.TemporaryDirectory() as tmp:
        print('== serve path: patchgan_serve -d cuda (bf16): --watch, '
              '--stdin, --http, load, SIGTERM drain', flush=True)
        serve_paths, serve, watch_masks = wgmma_grew(
            'serve', lambda: serve_phase(torch, np, kernels, model, card,
                                         tmp), exact=False)
    paths.update(serve_paths)
    print(json.dumps(serve))
    mark('1-12, 19')
    with tempfile.TemporaryDirectory() as tmp:
        print('== input pipeline and exact resume: native decode, loader '
              'images/s, epoch img/s at config 2, shards against the '
              'folder, a killed run resumed twice, --profile_dir',
              flush=True)
        t13 = time.perf_counter()
        launches, pipeline = pipeline_phase(
            torch, np, wrappers, card, train['off graph']['img_per_s'], tmp)
        pipeline['phase_wall_s'] = time.perf_counter() - t13
        paths['pipeline'] = dict(zip(names, launches))
        print(json.dumps(pipeline))
        print(f'phases 1-13: {time.perf_counter() - t_start:.3f} s',
              flush=True)
        print('== data parallel (BASELINE.json config 5): NCCL at world '
              'size 1 captured, two gloo ranks on the card, patchgan_train '
              'under torch.distributed.run with a kill and resume, NCCL '
              'across cards where there are several', flush=True)
        launches_a, launches_b, dp = dp_phase(torch, np, wrappers, card, tmp)
    paths['dp_nccl_world_1'] = dict(zip(names, launches_a))
    paths['dp_gloo_rank_0'] = dict(zip(names, launches_b))
    print(json.dumps({'data_parallel': dp}))
    print(f'phases 1-14: {time.perf_counter() - t_start:.3f} s', flush=True)
    print('== the engine over the cards of one process: one card listed '
          'twice, 2 and 4 cards where there are several, patchgan_infer and '
          'patchgan_serve -d cuda', flush=True)
    mesh_paths, mesh = wgmma_grew('mesh', lambda: mesh_phase(
        torch, np, F, kernels, model, plain_masks, watch_masks, card),
        exact=False)
    paths.update(mesh_paths)
    print(json.dumps({'mesh': mesh}))
    print(f'phases 1-15: {time.perf_counter() - t_start:.3f} s', flush=True)
    print('== data x model parallel (ROADMAP item 11c): the kernels at the '
          'shards\' shapes, two gloo ranks on the card (dp 1 x tp 2) against '
          'one process, NCCL and patchgan_aot --tp across cards where there '
          'are several', flush=True)
    tp_paths, tp = tp_phase(torch, np, F, kernels, card)
    paths.update({p: dict(zip(names, c)) for p, c in tp_paths.items()})
    print(json.dumps({'tp': tp}))
    print(f'phases 1-16: {time.perf_counter() - t_start:.3f} s', flush=True)
    print('== spatial parallelism (ROADMAP item 11d): the band kernels at '
          'the bands of a 1024-px image, two gloo ranks on the card (dp 1 x '
          'sp 2) against one process, NCCL and patchgan_train across cards '
          'where there are several', flush=True)
    sp_launches, sp, bands = sp_phase(torch, np, F, kernels, card)
    paths['spatial_train_gloo_rank_0'] = {n: sp_launches[n] for n in names}
    print(json.dumps({'spatial': sp}))
    print(f'phases 1-17: {time.perf_counter() - t_start:.3f} s', flush=True)
    print('== the async exact-resume store and UNet(remat=...): 18a ran in '
          'phase 13; 18b the captured step at config 2 and at a 1024-px '
          'image with remat off, all and (enc0, dec0, dec6)', flush=True)
    remat_paths, remat = remat_phase(torch, np, wrappers, card)
    paths.update({p: dict(zip(names, c)) for p, c in remat_paths.items()})
    store = pipeline['resume']['phase_18a']
    print(json.dumps({'remat': remat, 'store': store}))
    print(f'phase 18: 18a {store["runs_wall_s"]:.3f} s beside phase 13, '
          f'18b {remat["phase_wall_s"]:.3f} s', flush=True)
    print(f'phases 1-18: {time.perf_counter() - t_start:.3f} s', flush=True)

    summary = []
    for k in kernels:
        rows = [r for r in k.rows if r.get('calls', 1)]

        def total(key):
            return sum(r.get('calls', 1) * r[key] for r in rows)
        summary.append({
            'name': k.name, 'route': 'cuda', 'source': k.source,
            'replaces': k.replaces,
            'launches': paths['train_s2d_on'][k.name],
            'launches_by_path': {p: c[k.name] for p, c in paths.items()},
            'max_abs_err': max(r['max_abs_err_bf16'] for r in k.rows),
            'ms': total('kernel_ms'), 'plain_ms': total('plain_ms'),
            'bound_ms': total('bound_ms'),
            'bound_by': max(rows, key=lambda r: r['bound_ms'])['bound_by'],
            'library_ms': total('library_ms')})
        timed = ('kernel_ms', 'plain_ms', 'bound_ms', 'library_ms')
        if k.name in ('conv_norm_act', 'convt_norm_act'):
            # the NCHW form: bf16 on the wgmma core behind its layout
            # passes, fp32 and other widths on the WMMA core
            i = 1 if k.name == 'conv_norm_act' else 2
            on = WGMMA_PATHS['train_s2d_on'][i - 1]
            if on != summary[-1]['launches']:
                raise AssertionError(f'{k.name}: {on} of '
                                     f'{summary[-1]["launches"]} launches '
                                     f'on the wgmma core')
            timed += ('device_ms', 'wmma_ms', 'wmma_device_ms', 'layout_ms',
                      'layout_device_ms', 'layout_bound_ms',
                      'library_device_ms')
            summary[-1].update(
                kernel='wgmma',
                kernel_source='patchgan_tpu_torch/csrc/conv_wgmma.cuh',
                wmma_source='patchgan_tpu_torch/csrc/conv_gemm.cuh',
                launches_wgmma=on,
                launches_wgmma_by_path={p: v[i - 1]
                                        for p, v in WGMMA_PATHS.items()},
                wmma_max_abs_err=max(r['max_abs_err_wmma_bf16']
                                     for r in k.rows),
                **{key: total(key) for key in timed[4:]})
        if k.name in ('thin_conv3x3', 'thin_conv3x3_wgrad'):
            # by a graph's replay beside events; K4-wgrad at the s2d step's
            # shapes on its wgmma kernel (thin_conv_phase checked the route)
            summary[-1].update({key: total(key) for key in (
                'device_ms', 'library_device_ms')})
            if k.name == 'thin_conv3x3_wgrad':
                summary[-1].update(kernel=WGRAD_WGMMA, wmma_source=(
                    'patchgan_tpu_torch/csrc/thin_conv.cu thin_wgrad'))
        if k.spatial_rows:
            summary[-1]['spatial_1280x960'] = {
                key: sum(r[key] for r in k.spatial_rows) for key in timed}
    for name, source, replaces in BAND_KERNELS:
        rows = bands[name]['rows']
        summary.append({
            'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'form': 'band (spatial parallelism)',
            'launches': sp_launches[name],
            'launches_by_path': {'spatial_train_gloo_rank_0':
                                 sp_launches[name],
                                 **{p: c[name] for p, c in paths.items()
                                    if name in c}},
            # in_stats and in_bwd_sums write sums only: their sums' error
            'max_abs_err': bands[name]['max_abs_err'] or
            bands[name]['max_sum_abs_err'],
            'max_sum_err_over_max_sum': bands[name]['max_sum_err'],
            'ms': sum(r['kernel_ms'] for r in rows),
            'plain_ms': sum(r['plain_ms'] for r in rows),
            'bound_ms': sum(r['bound_ms'] for r in rows),
            'bound_by': max(rows, key=lambda r: r['bound_ms'])['bound_by'],
            'library_ms': sum(r['library_ms'] for r in rows)
            if all(r['library_ms'] is not None for r in rows) else None,
            'whole_plane_ms': sum(r['whole_ms'] for r in rows)})
        if name in BAND_NORM:
            summary[-1]['device_ms'] = sum(r['device_ms'] for r in rows)
        if name in BAND_NORM_TERMS:
            summary[-1]['kernel_source'] = \
                'patchgan_tpu_torch/csrc/band_norm.cuh'
        if name in ('conv_band', 'convt_band'):
            # bf16 on the wgmma core (phase 15's spatial mode), fp32 on
            # the WMMA core (17b's step, launches above)
            summary[-1].update(
                kernel='wgmma', wmma_source=(
                    'patchgan_tpu_torch/csrc/conv_gemm.cuh'),
                launches_wgmma_by_path={
                    f'spatial_mesh_{label}': v['band_launches_wgmma'][name]
                    for label, v in mesh['spatial'].items()
                    if isinstance(v, dict) and 'band_launches_wgmma' in v},
                **{k: sum(r[k] for r in rows) for k in (
                    'device_ms', 'wmma_ms', 'wmma_device_ms', 'layout_ms',
                    'layout_device_ms', 'layout_bound_ms')})
    for name, source, replaces, i in NHWC_FORMS:
        rows = kernels[i].nhwc_rows
        launches = NHWC_PATHS['train_s2d_off'][i]
        if not launches:
            raise AssertionError(f'{name}: not launched on the main path')
        summary.append({
            'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces, 'form': 'NHWC (channels_last)',
            'launches': launches,
            'launches_by_path': {p: c[i] for p, c in NHWC_PATHS.items()},
            'max_abs_err': max(r['max_abs_err_bf16'] for r in rows),
            'ms': sum(r['kernel_ms'] for r in rows),
            'plain_ms': sum(r['plain_ms'] for r in rows),
            'bound_ms': sum(r['bound_ms'] for r in rows),
            'bound_by': max(rows, key=lambda r: r['bound_ms'])['bound_by'],
            'library_ms': sum(r['library_ms'] for r in rows),
            'nchw_form_ms': sum(r['nchw_ms'] for r in rows)})
        if i in (0, 3):
            # K1's and K1-bwd's: the one-pass kernel; the segmented
            # kernels, which no step shape of config 2 takes, beside it
            one = ONE_PASS_PATHS['train_s2d_off'][0 if i == 0 else 1]
            if one != launches:
                raise AssertionError(f'{name}: {one} of {launches} launches '
                                     f'on the one-pass kernel')
            summary[-1].update(
                kernel='one_pass', launches_one_pass=one,
                launches_segmented=launches - one,
                segmented_source='patchgan_tpu_torch/csrc/norm_nhwc.cuh',
                **{k: sum(r[k] for r in rows) for k in (
                    'device_ms', 'segmented_ms', 'segmented_device_ms',
                    'nchw_device_ms', 'plain_device_ms',
                    'library_device_ms')},
                segmented_max_abs_err=max(
                    r['segmented_max_abs_err_bf16'] for r in rows))
        else:
            # K2's and K3's: the wgmma core; the WMMA core, which the
            # fp32 and element-path calls take, beside it
            on = WGMMA_PATHS['train_s2d_off'][i - 1]
            if on != launches:
                raise AssertionError(f'{name}: {on} of {launches} launches '
                                     f'on the wgmma core')
            summary[-1].update(
                kernel='wgmma', launches_wgmma=on,
                wmma_source='patchgan_tpu_torch/csrc/conv_gemm.cuh',
                **{k: sum(r[k] for r in rows) for k in (
                    'device_ms', 'wmma_ms', 'wmma_device_ms',
                    'library_device_ms')},
                wmma_max_abs_err=max(r['wmma_max_abs_err_bf16']
                                     for r in rows))
    print(json.dumps({'kernels': summary}))
    print(card_line())
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    if sys.argv[1:2] == ['--train-child']:
        # a rank of phase 14c, started by torch.distributed.run
        del sys.argv[1]
        train_child()
        sys.exit(0)
    sys.exit(main(only=sys.argv[1] if sys.argv[1:2] in (
        ['--mesh-only'], ['--tp-only'], ['--spatial-only'],
        ['--phase-18'], ['--layout-only']) else None))
