#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (atlasvae_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device   -- require CUDA, print the card's name and power limit, turn
               TF32 off so every plain reference runs in full float32; say
               whether matplotlib, h5py and scipy import here;
2. build    -- compile the hand-written kernels (csrc/*.cu) with nvcc,
               one process per source, all started together, and beside
               them the host helpers (native/*.cpp: the LZF decoder, the
               ROOT basket decoder) with g++;
3. parity   -- hold each kernel against its plain PyTorch version at the
               scoring path's shape (65,536-row chunks of the canonical
               12->80/40/20/10 VAE), at the training batch (10,000 rows;
               the forward kernel as encoder and as one-head decoder at
               both) and at B = 1,000,003 rows (a ragged tile) for the
               canonical and the constituents-mode 312->256/128/64/32
               stacks, and the backward kernel (K3) in both roles at the
               training batch and 1,000,003 rows, canonical (its fused
               body) and constituents-mode (its layer-wise route, also at
               the 10,000-row batch of const_train), with the same bits
               asked of a second call; time
               kernel, plain version, a torch.addmm/relu chain (library
               yardstick: its forward, or autograd through it) and the
               bound; the forward kernels also at the constituents-mode
               scoring chunks (65,536 x 300->256/128/64/32 and, for 255
               constituents, 65,536 x 765->256/128/64/32) and at
               const_train's 10,000-row batch (K2 in both roles, K1 on the
               decoder), every stack wider than 128 on their layer-wise
               route (its per-launch device ms at 1,000,003 rows), with the
               same bits asked of a second call; the wrapper's host time of
               one canonical K1 call; the Sinkhorn
               EMD kernel (K4) against its plain version at (8192, 100),
               (65,536, 20), (1,000, 128) and at the scoring path's chunks
               (13,421, 100) and (2,064, 255), 100 iterations, and at 20
               iterations on a permuted copy (true EMD 0) and on a far
               transport at (8192, 100), (1,000, 233), (2,064, 255),
               (500, 352) and (200, 400), each beside the plain version in
               float64, with the same bits asked of a second call (no
               PyTorch call computes a staged Sinkhorn, so it has no library
               yardstick): every jet of at most 128 constituents on its
               register route, 129 to 352 on its cluster route, wider ones
               on its wide route, with the wide route's time on the same
               clouds beside the other two; the fused conv
               block (K5) and its backward (K6) against their plain versions
               at the jet-ID training batch (5,000 x 16x16x1 -> 3x3, 100
               maps, pool 2x2), the predict chunk (20,000), a ragged batch,
               the reference's default tower (500 x 64x64x1) and the odd
               shapes of the CPU tests (two channels, pools of 3 and 4 with
               a low pad, 130 maps) on dense and on sparse, tied images,
               with the same bits asked of a second call, beside cuDNN's
               conv + max_pool2d + relu (autograd through it for K6): K5's
               and K6's register routes at the jet-ID shapes (3x3, one
               channel, pool 2x2, at most 128 maps), with their band
               routes' times on the same inputs beside them (K6's band
               route held to the plain version there too), the band routes
               at the odd shapes; then the same in bfloat16 (K5's and K6's
               bf16 forms, both routes, inputs rounded to bf16), the output
               within one bf16 ulp of the plain version (or ATOL where a
               ReLU input sits at 0), dW/db within one bf16 ulp plus
               CONV_GRAD_TOL of each leaf's largest value, the same bits on
               a second call, beside cuDNN's bf16 chain (the bf16 register
               routes run on the tensor cores; CONV_SHAPES' last five
               stress their mma tiles and their runs of sums: an odd
               image, 1, 7 and 128 maps, 100,000 images); beside each
               conv kernel's time a call (host work included), its time
               queued behind a sleeping kernel (device_ms: the device
               alone);
               K1/K2 also at the evaluate phase's 10,000-row chunk; K1, K2
               and K3 at the training batch on stacks of any depth and
               width (DEEP_WIDE_STACKS: 12 hidden layers of 64, a 300-wide
               input and 9 of 128, 1,200 and 2,048 wide), each on the route
               its plan names; K3's dW/db held at GRAD_SCALE_TOL (at the
               2048-wide stack an element beyond it by no more than the
               largest move of one flip of a ReLU input that is 0 to float32
               rounding, tests/relu_ties.py; the count of such inputs, of
               elements beyond the bar and the allowance's largest ratio to
               the bar are printed); K3 on both routes also timed on the
               device alone (device_ms), and on its layer-wise route the
               ReLU masks of its recompute (stack_recompute) counted where
               they differ from K2's forward and from the plain version's;
               the fused bodies of K1 and K2 also timed on the device alone;
               then vae_apply on the card against the CPU's float32 path
               over 2,000 seeded canonical VAEs at random init, each side
               also against float64, with the card's bits asked again at
               seed 3 (phase_seeds: counts, not a bar);
4. slice    -- score a 200k-jet synthetic sample end to end through
               atlasvae_torch.cli.score with the launch counters set to 0
               just before; check rows, finiteness, that both kernels ran
               on their fused body and never on the layer-wise route,
               and MAE/Latent against the plain CPU path on the first jets
               (on a failure: the row, both values and each side's gap to
               a float64 run of the same rows);
               then time a warm run and profile a third (device busy share);
5. evaluate -- the evaluation of vae.sh through the port's own code:
               cli/vae.py::_valid_predictions (make_sample on 200,000
               synthetic QCD-Geneva and 200,000 2HDM-Geneva events with the
               valid cuts, the signal weights divided by 1e3, the slice
               phase's RobustScaler, its seed-7 canonical VAE in chunks of
               10,000: K2 and K1, the counters set to 0 just before;
               filtering), then eval/results.py::_evaluation_numbers, the
               number half of plot_results (the metric bank
               MAE/Latent/KLD/JSD with loss_mapping, mass_deco in its 2d
               form, bump_scan over 100 cuts, bump_hunter at the best cut
               with npe 1000, each metric's ROC rates, the mass-sculpting
               JSD curves, the seven background-suppression cuts); wall ms
               of each step, host ms of the per-cut histograms, CUDA-event
               ms, launches and bound of the 101-cut batched scan and of
               bump_hunter's scan of 1,001 histograms; fails unless that
               scan on the card matches the CPU on the data and 50 injected
               pseudo-histograms (log p rtol 1e-5 / atol 1e-6, the same
               windows, bin significances rtol 1e-5), every window's log p
               is within 2e-5 of float64 scipy, the card's Poisson draws
               repeat with the seed, a constructed tie reports the first
               window, and the best cut's local sigma is finite and
               positive; then cli/vae.py's main on the same weights
               (--n_epochs 0 --apply_cuts ON): where matplotlib cannot be
               imported, its default --plotting ON must be refused before
               any load, and --plotting OFF runs to its end; where it can,
               --plotting ON runs and lists the files it drew;
6. train    -- train the canonical OE-VAE (vae.sh hyper-parameters, 3
               epochs of 1e5 jets in batches of 1e4) through
               atlasvae_torch.cli.vae with the counters set to 0 just
               before; check the history, the weights and that K2 and K3
               ran, all on their fused bodies; time a warm run (epochs 2-3), profile one epoch, hold
               the CUDA path against the plain CPU path (first-step
               gradients, 2-epoch losses with injected noise), the same at
               --FC_layers of 10 entries (9 hidden layers a side: K2 on
               fused segments, K3 on its layer-wise route) over 2 steps,
               and score the trained weights through atlasvae_torch.cli.score;
7. const_train -- train the constituents-mode OE-VAE (300->256/128/64/32,
               100 synthetic constituents a jet, a RobustScaler on them;
               the train phase's hyper-parameters, 3 epochs of 1e5 jets in
               batches of 1e4) through atlasvae_torch.cli.vae with the
               counters set to 0 just before; check the history, the
               weights and that K2 and K3 each ran the layer-wise route
               exactly 4 times a step (two encoders, two decoders) and
               their fused bodies never (K1 neither); time a warm run
               (epochs 2-3), profile one epoch (idle share, K2's and K3's
               device time, share and calls), and hold the first
               step's gradients against the plain CPU path;
8. emd_slice -- constituents mode at full width: 65,536 synthetic QCD and
               65,536 synthetic signal jets of 100 constituents, a
               RobustScaler fitted on the constituents, a seeded
               300->256/128/64/32 VAE, scored through atlasvae_torch.cli.score
               with MAE, Latent, KLD, JSD, EMD and KSD, the counters set to
               0 just before each file; check rows, finiteness, that K1
               and K2 ran on their layer-wise route only and the EMD
               kernel 5 times a file on its register route and never on
               its other routes, MAE, Latent, EMD and KSD against the
               plain CPU path on the first 1,024 jets (KLD and JSD on all
               but 2% of them); print each metric's AUC (bkg against signal);
               then a warm timed run and a profiled run; then the same two
               files made 255 constituents wide (the widest jet the data's
               uint8 counts give; a 765-wide VAE input), scored the same
               way: K4 32 times a file on its cluster route and never on
               the others, every metric against the plain CPU path as at
               100 (the EMD on the first 160 jets), and the EMD of those
               160 jets against the plain version on the CPU fed the
               clouds the CLI's chunk gave the kernel (the kernel on those
               clouds giving the CLI's bits), at the kernel's bar;
9. jetid    -- the jet-ID CNN at the CLI's default widths (16x16 image ->
               conv 3x3/100 -> pool -> conv 3x3/100 -> pool -> 900; scalars
               -> 200; trunk 200/200; softmax 2): train 3 epochs of 1e5 jets
               in batches of 5,000 through atlasvae_torch.cli.jetid on
               200,000-event synthetic files, the counters set to 0 just
               before; check the epochs' ticker, the files, the
               probabilities and that K5 ran once a training step,
               validation batch and predict chunk, and K6 once a training
               step, each on its register route and never on its band
               route; then serve (--n_epochs 0 --model_in)
               in the same folder: the same probabilities, no K6, and the
               first 4,096 jets against the plain CPU path; accuracy, AUC
               and rejections (synthetic data: no physics result); CUDA
               against the plain CPU path at dropout 0 (first-step
               gradients, 2-epoch losses); a warm timed run and a profiled
               epoch (busy, idle share, block 2's cuDNN convolution);
10. jetid_bf16 -- the same at the CLI's own precision (--mixed_precision
               AUTO: bfloat16 compute, float32 master weights): K5 and K6
               counted on their bf16 forms only, the bf16 bars against the
               plain CPU path, the step, prediction and profile beside the
               float32 phase's; then one short bf16 FCN run streaming its
               training chunks (--generator ON) with the flattening
               sample-weight scheme;
11. feature_removal -- cli/jetid.py --NN_type FCN --feature_removal ON (2
               epochs of 1e5 jets, then the model retrained once without
               each HLV): a ranking of every HLV, no kernel of ours;
12. sweep    -- cli/sweep.py --entry vae --vmap ON --grid beta=0.5,2
               lamb=1,5 with vae.sh's other flags at the canonical width on
               the train phase's files (2 epochs of 1e5 jets in batches of
               1e4): 4 lanes over one data preparation, the counters set to
               0 just before; K2 and K3 on their fused bodies at the exact
               counts (4 each a step a lane; K2 and K1 twice each in a
               lane's validation), every lane's history and weights; then
               the same grid with --vmap OFF, each lane's history and
               weights equal to it bit for bit (the same kernels in the
               same order); each run's wall seconds, jets/s a lane and data
               preparation seconds;
13. kfold    -- cli/jetid.py --NN_type CNN --n_folds 3 --vmap_folds ON at
               the CLI's defaults (bf16, batch 5,000) on the jetid phase's
               files, 2 epochs, the counters set to 0 just before: K5 and
               K6 on their bf16 register routes at the exact counts (K5 a
               fold-step, validation batch and cross_valid predict chunk,
               K6 a fold-step), the fold files, the CV accuracy line and
               valid_results.pkl; then --vmap_folds OFF, the fold weights
               (rtol 5e-4 / atol 1e-4) and CV probabilities (rtol 2e-3 /
               atol 2e-4) held to it; wall seconds and ms a fold-step;
14. aae      -- the OE-AAE at the reference's widths (AE 100/100/100,
               discriminator 100/100/3) through atlasvae_torch.cli.aae: one
               GAN cycle (100 AE, 5 Disc, 5 AAE epochs of 1e5 jets in
               batches of 5,000; 2,200 steps) with the counters set to 0
               just before, every K1-K6 count still 0 after it (the AAE's
               products are torch.matmul); a warm timed train_aae, each
               phase's ms a step, a profiled AE epoch (idle share); the
               card against the CPU on a 10,000-jet slice (loss series
               rtol 1e-4, Disc Accuracy within one jet's weight share);
               the evaluation's numbers (cli/aae.py::_signal_numbers on
               200,000 + 200,000 events, the 1-D and the 2-D scan), each
               scan again on the CPU with the card's ROC rates (the same
               best cut, loc sigma rtol 1e-5 / atol 1e-6), the batched
               scan's CUDA-event ms, launches and bound; cli/score.py
               --model_type aae on the card and the CPU (rtol/atol 1e-4);
15. keras    -- Keras weight files through data/hdf5.py (LiteFile where h5py
               is missing, as on the card's machine): the train phase's VAE
               exported to model.h5 and read back (the same bits as its
               model.npz), cli/vae.py's _load_model_in and
               _valid_predictions on the evaluate phase's events from the
               .h5 and the .npz (the same bits; K2 and K1 once a 10,000-row
               chunk); cli/vae.py --model_out model.h5 against model.npz,
               same seed, 2 epochs (the same weights, K3 on its fused body);
               the jetid_bf16 phase's model exported with the CLI's config
               and served by cli/jetid.py --n_epochs 0 from the .h5 and the
               .npz (the same probabilities, K5 bf16 once a predict chunk,
               nothing else); the aae phase's AE as the reference's AE-only
               AE.h5 against its npz cache in train_aae on 10,000 jets (the
               same loss history, the AE epochs skipped, every K1-K6 count
               0); prints each file's size and write and read ms;
16. etl      -- the ETL on the card machine's own installation (no h5py: every
               file through LiteFile): seeded ntuples with the canonical
               branches at the reference's kinematic scale (4 topo-dijet
               files of DSID 361024, 50,000 jets each, 2 topo-ttbar files of
               DSID 410284, 25,000 each; 1-100 constituents a jet) written
               by rootio.write_tree, converted by cli/etl.py (the native
               final_jets kernel checked), the dijet output merged with
               --merging ON and held to the unmerged file (the same multiset
               of rows, float16 constituents, uint8 counts, int8 JZW),
               loaded by load_data (cuts, constituents ON, n_const 100), and
               one constituents-mode epoch of cli/vae.py on it with the
               ttbar file as OoD, the counters set to 0 just before (K2 and
               K3 on their layer-wise routes); the native basket decoder
               against the Python loop on a vector<vector<float>> tree; the
               committed h5py fixtures (tests/fixtures/h5py_*.h5, lzf,
               gzip+shuffle, a raw chunk under lzf's mask, unwritten chunks)
               read through LiteFile bit-equal to their .npz; the MB/s of
               the C and the plain LZF decoder; each stage's seconds;
17. scaleout -- item 11 on the one card (phase_scaleout): a 1-rank NCCL
               world's data-parallel VAE load bit-equal to the one-device
               load; two ranks sharing the card over gloo (NCCL refuses two
               ranks on one device; first a check that this gloo's
               all_reduce takes CUDA tensors), each stepping its half of
               every batch: the train phase's canonical VAE (4 batches of
               10,000 at tests/test_train.py's DP bars), the jet-ID CLI's
               bf16 CNN (three steps of 5,000), both also through Adam's
               first moment after the steps (the exchanged gradients'
               record, which the weights cannot show: Adam is blind to a
               gradient's scale), the emd_slice chunk's EMD
               (13,421 jets of 100 constituents) and a 1,000-experiment
               BumpHunter scan (exactly equal), each against one device on
               the same inputs, the ranks' launch counters summed into the
               phase's; ms a step with 2 ranks beside one device alone;
               cli/vae.py --n_devices 2 refused on one card;
               utils/profiling.trace around a train step, the trace naming
               K2's and K3's kernels;
18. kernels -- one JSON line with every ported kernel (K1 to K6 as an
               entry a route, K4's three, and K5/K6's bf16 forms);
19. last line: {"ok": true, "device": {...}}.

It imports nothing of JAX or of the JAX package.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet, dense): f32 outside the
# tensor cores, TF32 and bf16 products on the tensor cores (f32
# accumulation) and HBM3 bandwidth.  Bounds are stated against these.
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

ATOL = 1e-5
RTOL = 1e-5
SLICE_EVENTS = 200_000
SLICE_CHUNK = 65_536
BIG_B = 1_000_003
REF_ROWS = 4096

# Constituents-mode scoring: 100 (px, py, pz) constituents, the wide VAE.
EMD_EVENTS = 65_536
EMD_CONST = 100
EMD_LAYERS = (256, 128, 64, 32)
EMD_METRICS = ["MAE", "Latent", "KLD", "JSD", "EMD", "KSD"]
EMD_REF_ROWS = 1024
EMD_ITERS = 100
EMD_EPS = 0.01
EMD_STAGES = 10
EMD_RTOL, EMD_ATOL = 2e-5, 1e-6   # kernel vs plain version, same inputs, same card
EMD_MASS_TOL = 1e-5               # of min(sum pt), where the EMD is small beside it
EMD_FEW_ITERS = 20
# The same scoring at the widest jet the data's uint8 counts give (the
# cluster route): a 765-wide VAE input, the plain CPU path on fewer jets
EMD_WIDE_CONST = 255
EMD_WIDE_REF_ROWS = 160
# the KERNELS name of each K4 route
EMD_KERNELS = {"tiles": "emd_sinkhorn", "cluster": "emd_sinkhorn_cluster",
               "wide": "emd_sinkhorn_wide"}
# Constituents-mode training: the emd_slice model, 100 constituents, trained
# The evaluation half of vae.sh (docs/MIGRATION.md:24-28: --decorrelation=ON,
# --npe 1000): the steps of atlasvae/cli/vae.py::_evaluate and
# eval/results.py::plot_results that compute numbers, on the slice phase's
# scaler and seed-7 weights.
EVAL_EVENTS = 200_000          # QCD-Geneva and 2HDM-Geneva each
EVAL_CHUNK = 10_000            # cli/vae.py's prediction chunk
EVAL_METRICS = ["Latent", "MAE", "KLD", "JSD"]
EVAL_CUTS = 100
EVAL_NPE = 1000
EVAL_PARITY_PSEUDO = 50        # injected pseudo-histograms of the card-against-CPU check
EVAL_F64_REL = 2e-5            # log p against float64 scipy (tests/test_gammainc_sweep.py)
EVAL_SEED = 0
# Elementwise operations of one log_gammainc_lower/_upper element, counted
# from atlasvae_torch/ops/gammainc.py (a transcendental counts as one): per
# loop step 4 of the series and 18 of the continued fraction, and about 390
# outside the loops (two Stirling prefactors, two Temme evaluations, the
# selects); the scan adds about 12 a window (sums, masks, selects) and the
# significance (sigma_from_log_pval: _ndtri and 6 Newton steps) about 250.
SERIES_OPS, CF_OPS, GAMMAINC_FIXED_OPS, WINDOW_OPS, SIGMA_OPS = 4, 18, 390, 12, 250


# with TRAIN_ARGS (const_train phase)
CONST_LAYERS = EMD_LAYERS
CONST_ARGS = ["--constituents", "ON", "--HLVs", "OFF", "--n_const", str(EMD_CONST), "--n_dims", "3",
              "--FC_layers", *map(str, CONST_LAYERS), "--const_scaler_type", "RobustScaler"]

KERNELS = {
    "fused_mlp": dict(source="atlasvae_torch/csrc/fused_mlp.cu",
                      replaces="atlasvae/ops/fused_mlp.py:42",
                      main_shape="slice decoder"),
    # K1's layer-wise route: the stacks wider than 128, each wide layer one
    # launch of rows_wgmma_kernel (wgmma, 3xTF32) after one split_weights_kernel
    # a call, the narrow runs on the fused body (csrc/stack_layers.cuh)
    "fused_mlp_layers": dict(source="atlasvae_torch/csrc/gemm_wgmma.cuh",
                             replaces="atlasvae/ops/fused_mlp.py:42",
                             main_shape="emd_slice decoder"),
    "stack_forward": dict(source="atlasvae_torch/csrc/fused_vae.cu",
                          replaces="atlasvae/ops/fused_vae.py:71",
                          main_shape="slice encoder"),
    # K2's layer-wise route: the same kernels as K1's
    "stack_forward_layers": dict(source="atlasvae_torch/csrc/gemm_wgmma.cuh",
                                 replaces="atlasvae/ops/fused_vae.py:71",
                                 main_shape="const_train encoder"),
    "stack_backward": dict(source="atlasvae_torch/csrc/fused_vae_bwd.cu",
                           replaces="atlasvae/ops/fused_vae.py:130",
                           main_shape="train encoder"),
    # K3's layer-wise route: the stacks its fused body does not take, each
    # product one launch on the wgmma mainloop (bwd_rows_kernel, bwd_dw_kernel
    # after one bwd_split_kernel a call), then reduce_splits
    "stack_backward_layers": dict(source="atlasvae_torch/csrc/gemm_wgmma.cuh",
                                  replaces="atlasvae/ops/fused_vae.py:130",
                                  main_shape="const_train encoder"),
    # K4's register route (jets of at most 128 constituents), its cluster
    # route (129 to 352) and its wide route (any width)
    "emd_sinkhorn": dict(source="atlasvae_torch/csrc/emd_sinkhorn.cu",
                         replaces="atlasvae/ops/emd_pallas.py:45",
                         main_shape="emd_slice chunk"),
    "emd_sinkhorn_cluster": dict(source="atlasvae_torch/csrc/emd_sinkhorn.cu",
                                 replaces="atlasvae/ops/emd_pallas.py:45",
                                 main_shape="emd_slice255 chunk"),
    "emd_sinkhorn_wide": dict(source="atlasvae_torch/csrc/emd_sinkhorn.cu",
                              replaces="atlasvae/ops/emd_pallas.py:45",
                              main_shape="200x400 far"),
    # K5's register route (the jet-ID block: 3x3, one channel, pool 2x2) and
    # its band route (every other shape)
    "fused_conv": dict(source="atlasvae_torch/csrc/fused_conv.cu",
                       replaces="atlasvae/ops/fused_conv.py:112",
                       main_shape="jetid train batch sparse"),
    "fused_conv_bands": dict(source="atlasvae_torch/csrc/fused_conv.cu",
                             replaces="atlasvae/ops/fused_conv.py:112",
                             main_shape="two channels pool 3"),
    # K6's register route and its band route, as K5's
    "fused_conv_backward": dict(source="atlasvae_torch/csrc/fused_conv_bwd.cu",
                                replaces="atlasvae/ops/fused_conv.py:130",
                                main_shape="jetid train batch sparse"),
    "fused_conv_backward_bands": dict(source="atlasvae_torch/csrc/fused_conv_bwd.cu",
                                      replaces="atlasvae/ops/fused_conv.py:130",
                                      main_shape="two channels pool 3"),
    # the bf16 forms of K5 and K6, each route
    "fused_conv_bf16": dict(source="atlasvae_torch/csrc/fused_conv.cu",
                            replaces="atlasvae/ops/fused_conv.py:112",
                            main_shape="jetid train batch sparse bf16"),
    "fused_conv_bf16_bands": dict(source="atlasvae_torch/csrc/fused_conv.cu",
                                  replaces="atlasvae/ops/fused_conv.py:112",
                                  main_shape="two channels pool 3 bf16"),
    "fused_conv_backward_bf16": dict(source="atlasvae_torch/csrc/fused_conv_bwd.cu",
                                     replaces="atlasvae/ops/fused_conv.py:130",
                                     main_shape="jetid train batch sparse bf16"),
    "fused_conv_backward_bf16_bands": dict(source="atlasvae_torch/csrc/fused_conv_bwd.cu",
                                           replaces="atlasvae/ops/fused_conv.py:130",
                                           main_shape="two channels pool 3 bf16"),
}
# the key of each K5/K6 entry above in ops/fused_conv_cuda.py's `launches`:
# (dtype, route, direction)
CONV_COUNTERS = {"fused_conv": ("float32", "tiles", "forward"),
                 "fused_conv_bands": ("float32", "bands", "forward"),
                 "fused_conv_backward": ("float32", "tiles", "backward"),
                 "fused_conv_backward_bands": ("float32", "bands", "backward"),
                 "fused_conv_bf16": ("bfloat16", "tiles", "forward"),
                 "fused_conv_bf16_bands": ("bfloat16", "bands", "forward"),
                 "fused_conv_backward_bf16": ("bfloat16", "tiles", "backward"),
                 "fused_conv_backward_bf16_bands": ("bfloat16", "bands", "backward")}

# jet-ID: the CNN the CLI builds by default, on 200,000-event synthetic
# files, cut to 3 epochs of 1e5 jets.
JETID_EVENTS = 200_000
JETID_TRAIN = 100_000
JETID_BATCH = 5_000
JETID_CHUNK = 20_000      # predict_classifier's chunk
JETID_EPOCHS = 3
JETID_IMAGE = 16
# the CLI's own precision: AUTO, its default, is bfloat16 for the CNN
JETID_BF16_ARGS = ["--NN_type", "CNN", "--plotting", "OFF", "--synthetic", str(JETID_EVENTS),
                   "--n_train", "1e5", "--n_valid", "5e4", "--batch_size", "5e3"]
JETID_ARGS = JETID_BF16_ARGS + ["--mixed_precision", "OFF"]
# one short bf16 FCN run streaming its training chunks (the JAX package's
# generator mode takes no CNN) with a sample-weight scheme: 20,000 jets of
# 20 x 3 float32 constituents a chunk, five chunks an epoch
JETID_STREAM_ARGS = ["--NN_type", "FCN", "--mixed_precision", "ON", "--generator", "ON",
                     "--memGB", "0.0048", "--weight_type", "flattening", "--bkg_ratio", "1",
                     "--plotting", "OFF", "--synthetic", str(JETID_EVENTS), "--n_train", "1e5",
                     "--n_valid", "5e4", "--batch_size", "5e3"]
JETID_STREAM_EPOCHS = 2
JETID_REF_ROWS = 4096
JETID_PARITY_BATCHES = 3
CONV_SHAPES = [
    # (name, N, H, W, C, kh, kw, M, pool)
    ("jetid train batch", JETID_BATCH, 16, 16, 1, 3, 3, 100, (2, 2)),
    ("jetid predict chunk", JETID_CHUNK, 16, 16, 1, 3, 3, 100, (2, 2)),
    ("ragged batch", 1037, 16, 16, 1, 3, 3, 100, (2, 2)),
    ("reference tower", 500, 64, 64, 1, 3, 3, 100, (2, 2)),
    ("5x16x16 10 maps", 5, 16, 16, 1, 3, 3, 10, (2, 2)),
    ("two channels pool 3", 3, 13, 11, 2, 3, 2, 7, (3, 3)),
    ("pool 3 low pad", 4, 10, 10, 1, 2, 2, 5, (3, 3)),
    ("130 maps", 2, 12, 9, 1, 3, 3, 130, (2, 2)),
    ("pool 4", 3, 9, 9, 1, 3, 3, 4, (4, 4)),
    # the bf16 register route's mma tiles (16 maps by four pooled pixels)
    ("odd 15x15 100 maps", 37, 15, 15, 1, 3, 3, 100, (2, 2)),
    ("one map", 64, 16, 16, 1, 3, 3, 1, (2, 2)),
    ("7 maps odd H", 64, 13, 16, 1, 3, 3, 7, (2, 2)),
    ("128 maps", 1000, 16, 16, 1, 3, 3, 128, (2, 2)),
    ("jetid large batch", 100000, 16, 16, 1, 3, 3, 100, (2, 2)),
]
# time_ms(queued=True) holds a call's launches behind a sleeping kernel of
# this many clocks a call (0.5 ms at the H100's 1.98 GHz boost), longer than
# any conv case's host work a call
QUEUE_SLEEP_CYCLES_A_CALL = 1_000_000
CONV_GRAD_TOL = 2e-4        # dW/db leaf over its largest value, at test sizes
CONV_GRAD_TOL_BIG = 3e-4    # at a thousand images and more
# CUDA against the CPU through the whole CNN: a batch has 12.5 million conv
# outputs behind a ReLU mask and a pool's argmax, and where one lies within
# float32 rounding of 0 or of its neighbour the two libraries' convolutions
# decide differently.  Each such element moves a tower leaf's gradient by one
# element's share, about 1e-3 of a bias gradient's largest value at 5,000
# jets; the dense leaves behind the towers do not see it.
JETID_CONV_GRAD_TOL = 3e-3
# ... and its 2-epoch loss series.  Adam's first steps move every weight by
# about lr whatever the size of its gradient, so an element whose gradient is
# rounding noise, or 0 on one side after such a flipped decision, parts by a
# whole step: the series part by about 1e-4 after 6 steps (the VAE's dense
# stacks have no such decisions and hold TRAIN_REL_TOL).
JETID_LOSS_REL_TOL = 1e-3
# The same comparisons in bfloat16.  Both sides round every activation and
# gradient to bf16 (8 significant bits); an f32 sum that the two libraries
# order differently rounds the other way now and then, which moves that
# element by one bf16 ulp, 2^-8 to 2^-7 of it, and ties in a pool window are
# far more common.  The inputs and seeds are fixed, and three runs on an
# H100 80GB HBM3 (700 W, torch 2.11) read the same gaps each time, so each
# bar is a small multiple of its reading: first-step gradients 2.1e-3
# (dense) and 3.6e-3 (towers) of a leaf's largest value, bar 1e-2; the
# 2-epoch losses 1.2e-5, bar 1e-4 (Adam turns gradients that part by an ulp
# into whole steps: 1.6e-4 in float32, where decisions flip more often);
# the served probabilities 6.2e-4, bar 2e-3 (the logits leave the output
# layer in bf16; one of them rounded the other way at |logit| in [2, 4),
# an ulp of 2^-6, moves a probability near 0.5 by up to 4e-3, and none of
# the 4,096 rows had such a flip).
JETID_BF16_GRAD_TOL = 1e-2
JETID_BF16_LOSS_REL_TOL = 1e-4
JETID_BF16_PROB_TOL = 2e-3

# The OE-AAE (ROADMAP Queue 1 item 8): cli/aae.py at the reference's widths
# (AE 100/100/100, discriminator 100/100/3), one GAN cycle of 1e5 jets in
# batches of 5,000 (20 batches an epoch, 2,200 shared-counter steps), on
# 200,000-event synthetic files; no kernel of ours (the JAX AAE runs plain
# XLA products, the port torch.matmul).
AAE_EVENTS = 200_000
AAE_BATCH = 5_000
AAE_ARGS = ["--synthetic", str(AAE_EVENTS), "--n_train", "1e5", "--n_OoD", "1e5", "--n_epochs", "1",
            "--batch_size", str(AAE_BATCH), "--layers_sizes", "100", "100", "100", "--lamb", "1",
            "--beta", "1", "--plotting", "OFF", "--apply_cuts", "OFF"]
AAE_EPOCHS = 110                # phase-epochs of the first cycle: 100 AE, 5 Disc, 5 AAE
AAE_PARITY_JETS = 10_000        # card against CPU: the whole schedule, 2 batches an epoch
AAE_REL_TOL = 1e-4              # its loss series, TRAIN_REL_TOL's bar
AAE_SCORE_TOL = 1e-4            # cli/score.py --model_type aae, the slice phase's bar
AAE_SIGMA_TOL = (1e-5, 1e-6)    # loc sigma card against CPU (rtol, atol), evaluate's bar
# --feature_removal ON on the jet-ID FCN (Queue 1 item 9.4): the model
# retrained once without each HLV, 2 epochs each, beside a 2-epoch run
FEATURE_REMOVAL_ARGS = ["--NN_type", "FCN", "--mixed_precision", "OFF", "--feature_removal", "ON",
                        "--plotting", "OFF", "--synthetic", str(JETID_EVENTS), "--n_train", "1e5",
                        "--n_valid", "5e4", "--batch_size", "5e3", "--n_epochs", "2"]

# The sweep (ROADMAP Queue 1 item 10): cli/sweep.py --vmap ON over a 2 x 2
# grid of beta and lamb, the other flags vae.sh's at the canonical width, on
# the train phase's files, 2 epochs of 1e5 jets in batches of 1e4: 4 lanes
SWEEP_GRID = ["--grid", "beta=0.5,2", "lamb=1,5"]
SWEEP_TAGS = ["beta0.5_lamb1", "beta0.5_lamb5", "beta2_lamb1", "beta2_lamb5"]
SWEEP_EPOCHS = 2
SWEEP_ARGS = ["--n_train", "1e5", "--n_valid", "5e4", "--n_OoD", "2e5", "--batch_size", "1e4",
              "--n_epochs", str(SWEEP_EPOCHS), "--lr", "1e-3", "--OE_type", "MAE",
              "--weight_type", "X-S", "--HLV_scaler_type", "RobustScaler", "--plotting", "OFF",
              "--apply_cuts", "OFF"]
# k-fold CV of the jet-ID CNN at the CLI's defaults (bf16 AUTO, 5,000-jet
# batches) on the jetid phase's files: 3 folds, 2 epochs
KFOLD = 3
KFOLD_EPOCHS = 2
KFOLD_ARGS = ["--NN_type", "CNN", "--plotting", "OFF", "--synthetic", str(JETID_EVENTS),
              "--n_train", "6e4", "--n_valid", "3e4", "--n_epochs", str(KFOLD_EPOCHS),
              "--n_folds", str(KFOLD)]
# --vmap_folds ON against OFF: tests/test_ensemble.py's bars (cuDNN may pick
# other algorithms for block 2 from run to run)
KFOLD_WEIGHT_TOL = (5e-4, 1e-4)
KFOLD_PROB_TOL = (2e-3, 2e-4)

# Keras weight files (ROADMAP Queue 1 item 10, second half): the VAE CLI's
# --model_out model.h5 against model.npz, 2 epochs (a fresh run checkpoints
# from its second epoch on, and the export replaces that checkpoint); the
# LiteFile write and read timed as the median of KERAS_REPEATS calls
KERAS_VAE_EPOCHS = 2
KERAS_REPEATS = 5

# The ETL: seeded ntuples with the canonical branches of tests/test_etl.py's
# _fixture_branches at the reference's kinematic scale (pt 450-1200 GeV,
# m 30-300 GeV, in MeV as ntuples store them; 1-100 constituents a jet),
# 4 topo-dijet files of DSID 361024 (tag 1) and 2 topo-ttbar files of DSID
# 410284, converted and merged by cli/etl.py, then one constituents-mode
# epoch of cli/vae.py on them (dijet as QCD, ttbar as OoD).
ETL_DIJET = ("361024", 4, 50_000)     # DSID, files, jets a file
ETL_TTBAR = ("410284", 2, 25_000)
ETL_MAX_CONST = 100
ETL_WRITE_LIMIT_S = 120               # cut the counts if writing alone takes longer
ETL_TRAIN_ARGS = ["--n_train", "1e5", "--n_valid", "5e4", "--n_OoD", "5e4",
                  "--batch_size", "1e4", "--n_epochs", "1", "--lr", "1e-3", "--beta", "2",
                  "--lamb", "5", "--OE_type", "MAE", "--weight_type", "X-S",
                  "--plotting", "OFF", "--apply_cuts", "OFF"] + CONST_ARGS
ETL_STL_JETS = 20_000                 # a vector<vector<float>> tree for the native basket decoder
LZF_MIN_S = 0.5                       # each LZF decoder timed for at least this long
LZF_REF_CHUNK_BYTES = 10_000 * 400 * 2  # a merged file's constituents chunk, float16

# Training: the canonical model with the vae.sh hyper-parameters, cut to
# 3 epochs of 1e5 jets (200,000 synthetic events per sample).
TRAIN_EVENTS = 200_000
TRAIN_BATCH = 10_000
TRAIN_EPOCHS = 3
TRAIN_ARGS = ["--n_train", "1e5", "--n_valid", "5e4", "--n_OoD", "2e5",
              "--batch_size", "1e4", "--n_epochs", str(TRAIN_EPOCHS), "--lr", "1e-3",
              "--beta", "2", "--lamb", "5", "--OE_type", "MAE", "--weight_type", "X-S",
              "--HLV_scaler_type", "RobustScaler", "--plotting", "OFF",
              "--apply_cuts", "OFF"]
# --FC_layers of 10 entries: 9 hidden layers a side, deeper than one fused
# launch of K1-K3 takes (ops/fused_vae.py::FUSED_MAX_HIDDEN)
DEEP_FC_LAYERS = (80, 80, 60, 60, 40, 40, 30, 20, 20, 10)
# Stacks of any depth and width, held in the parity phase at the training
# batch: (fc_layers, input width) of a VAE whose encoder and decoder they are
DEEP_WIDE_STACKS = {
    "deep_12_narrow": ((64,) * 12 + (10,), 12),         # 12 hidden layers of 64
    "deep_10_const": ((128,) * 9 + (32,), 300),         # 300 wide, then 9 of 128
    "const_1200": ((256, 128, 64, 32), 1200),           # 400 constituents x 3
    "wide_2048": ((512, 64, 32), 2048),
}
GRAD_SCALE_TOL = 3e-4   # per dW/db leaf, times the leaf's largest |value|
SEED_TRIALS = 2000      # canonical VAEs at random init in phase_seeds
TRAIN_REL_TOL = 1e-4    # per-epoch losses, CUDA path vs plain CPU path


def counters():
    import torch
    from atlasvae_torch.ops import emd_cuda, fused_conv_cuda, fused_mlp, fused_vae
    conv = {name: fused_conv_cuda.launches[getattr(torch, dtype), which, direction]
            for name, (dtype, which, direction) in CONV_COUNTERS.items()}
    return {"fused_mlp": fused_mlp.launches, "fused_mlp_layers": fused_mlp.layered_launches,
            "stack_forward": fused_vae.launches,
            "stack_forward_layers": fused_vae.layered_launches,
            "stack_backward": fused_vae.backward_launches,
            "stack_backward_layers": fused_vae.layered_backward_launches,
            "emd_sinkhorn": emd_cuda.launches, "emd_sinkhorn_cluster": emd_cuda.cluster_launches,
            "emd_sinkhorn_wide": emd_cuda.wide_launches,
            **conv}


def reset_counters():
    from atlasvae_torch.ops import emd_cuda, fused_conv_cuda, fused_mlp, fused_vae
    fused_mlp.launches = fused_vae.launches = fused_vae.backward_launches = 0
    fused_mlp.layered_launches = fused_vae.layered_launches = 0
    fused_vae.layered_backward_launches = 0
    emd_cuda.launches = emd_cuda.cluster_launches = emd_cuda.wide_launches = 0
    fused_conv_cuda.launches.update(dict.fromkeys(fused_conv_cuda.launches, 0))


def log(phase, **facts):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in facts.items()), flush=True)


def time_ms(fn, iters=20, warmup=3, queued=False):
    """CUDA-event ms a call of fn over iters warm calls.  ``queued``: the
    calls wait behind a sleeping kernel until all are enqueued, so the events
    time the device alone; otherwise a call whose host work (a wrapper's
    checks, allocation, ctypes) outlasts its kernels times the host."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES_A_CALL * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def stack_pairs(params, role):
    """(hidden, heads) (w, b) pairs of the encoder or the decoder."""
    part = params[role]
    hidden = [(l["w"], l["b"]) for l in part["hidden"]]
    if role == "encoder":
        return hidden, [(part["mean"]["w"], part["mean"]["b"]),
                        (part["logvar"]["w"], part["logvar"]["b"])]
    return hidden, [(part["out"]["w"], part["out"]["b"])]


def bound(batch, d0, hidden, heads):
    """Least time (ms) for one call and what bounds it: each input read
    once, each output written once, 2*K*N + N FLOP per row and layer.  Both
    routes of K1/K2 take every product in 3xTF32 on the tensor cores (three
    TF32 products for each f32 one): the 2*K*N at a third of the TF32 peak,
    the bias's N at the f32 one."""
    layers = list(hidden) + list(heads)
    n_params = sum(w.numel() + b.numel() for w, b in layers)
    out_cols = sum(w.shape[1] for w, _ in heads)
    nbytes = 4 * (batch * d0 + n_params + batch * out_cols)
    products = batch * sum(2 * w.shape[0] * w.shape[1] for w, _ in layers)
    other = batch * sum(w.shape[1] for w, _ in layers)
    flops = products + other
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = (3 * products / PEAK_TF32_FLOPS + other / PEAK_F32_FLOPS) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), flops, nbytes


def bound_backward(batch, d0, hidden, heads, want_dx, route):
    """Least time (ms) for one backward call and what bounds it: x, the
    head gradients and the parameters read once, the gradients (and dx)
    written once; per row the forward recompute, dW (2*K*N), db, the ReLU
    masks and g @ W^T (2*K*N) for every layer but the input one unless dx
    is wanted.  The fused body takes its products in f32 on the CUDA cores;
    the layer-wise route (``route`` "layers") in 3xTF32 on the tensor cores
    (three TF32 products for each f32 one), the rest at the f32 rate."""
    layers = list(hidden) + list(heads)
    n_params = sum(w.numel() + b.numel() for w, b in layers)
    head_cols = sum(w.shape[1] for w, _ in heads)
    nbytes = 4 * (batch * d0 + batch * head_cols + 2 * n_params + (batch * d0 if want_dx else 0))
    per_row = sum(2 * w.shape[0] * w.shape[1] + 2 * w.shape[1] for w, _ in hidden)  # recompute, mask
    per_row += sum(2 * w.shape[0] * w.shape[1] + w.shape[1] for w, _ in layers)     # dW, db
    per_row += sum(2 * w.shape[0] * w.shape[1] for i, (w, _) in enumerate(layers)
                   if i > 0 or want_dx)                                            # g @ W^T
    products = sum(2 * w.shape[0] * w.shape[1] for w, _ in hidden)
    products += sum(2 * w.shape[0] * w.shape[1] for w, _ in layers)
    products += sum(2 * w.shape[0] * w.shape[1] for i, (w, _) in enumerate(layers) if i > 0 or want_dx)
    flops = batch * per_row
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    if route == "layers":
        t_ops = (3 * batch * products / PEAK_TF32_FLOPS
                 + (flops - batch * products) / PEAK_F32_FLOPS) * 1e3
    else:
        t_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), flops, nbytes


def kernel_device_ms(fn):
    """Device ms of each kernel one call of fn launches, in launch order
    (torch.profiler, after a warm call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [(re.sub(r"atlasvae::(\w+::)?", "", e.name.split("(")[0].replace("void ", "")),
             round(e.device_time_total / 1e3, 4))
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def recompute_flips(x, hidden):
    """Where the ReLU masks of K3's layer-wise recompute (stack_recompute)
    differ from K2's forward (each hidden layer's pre-activation as the
    stack_forward of the layers below it with that layer as its head) and
    from the plain version's, layer by layer; and the plain version's where
    the recompute's near-ties are not re-decided (redecide=False); and how
    many elements each layer re-decided."""
    import torch
    from atlasvae_torch.ops import fused_vae
    with torch.inference_mode():
        plain = fused_vae.stack_recompute_plain(x, hidden)
        got, redecided = fused_vae.stack_recompute(x, hidden, counts=True)
        vs_plain = [int(((a > 0) != (p > 0)).sum()) for a, p in zip(got, plain)]
        vs_k2 = [int(((fused_vae.stack_forward(x, hidden[:l], [hidden[l]])[0] > 0) != (a > 0)).sum())
                 for l, a in enumerate(got)]
        del got
        raw = fused_vae.stack_recompute(x, hidden, redecide=False)
        raw_vs_plain = [int(((a > 0) != (p > 0)).sum()) for a, p in zip(raw, plain)]
    return dict(recompute_flips_vs_plain=vs_plain, recompute_flips_vs_k2=vs_k2,
                undecided_flips_vs_plain=raw_vs_plain, redecided=redecided.tolist())


def parity_backward(params, role, x, gen, ties=False):
    """K3 vs its plain version on the same inputs and head gradients (a
    mean-loss scale, N(0, 1) / B), and the same bits on a second call;
    timings, autograd yardstick and bound.  ``ties`` (the 2048-wide stack
    only): an element may go beyond its bar by the largest move of one
    flipped ReLU tie there (tests/relu_ties.py), and the count of ties, of
    elements beyond the bar and the allowance's largest ratio to the bar
    are recorded.  On the layer-wise route also the recompute's mask flips
    (recompute_flips) and each launch's device ms.  Returns (the KERNELS name
    of the route backward_plan takes, result)."""
    import torch
    from atlasvae_torch.ops import fused_vae
    hidden, heads = stack_pairs(params, role)
    want_dx = role == "decoder"
    batch = x.shape[0]
    grads = [torch.randn((batch, w.shape[1]), generator=gen, device=x.device) / batch
             for w, _ in heads]
    kernel = lambda: fused_vae.stack_backward(x, hidden, heads, grads, want_dx)
    plain = lambda: fused_vae.stack_backward_plain(x, hidden, heads, grads, want_dx)

    def library():
        leaves = [t.detach().requires_grad_() for pair in hidden + heads for t in pair]
        xin = x.detach().requires_grad_(want_dx)
        h = xin
        for i in range(len(hidden)):
            h = torch.relu(torch.addmm(leaves[2 * i + 1], h, leaves[2 * i]))
        outs = [torch.addmm(leaves[2 * k + 1], h, leaves[2 * k])
                for k in range(len(hidden), len(hidden) + len(heads))]
        return torch.autograd.grad(outs, leaves + ([xin] if want_dx else []), grads)

    dims = tuple([x.shape[1]] + [w.shape[1] for w, _ in hidden])
    route = fused_vae.backward_plan(batch, dims, tuple(w.shape[1] for w, _ in heads), want_dx).route
    got, again, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    same_bits = all(bool(torch.equal(a, b)) for a, b in
                    zip(got[0] + got[1] + [got[2]] * want_dx, again[0] + again[1] + [again[2]] * want_dx))
    del again
    leaf_bars = [GRAD_SCALE_TOL * float(w.abs().max()) for w in want[0] + want[1]]
    allow = [0.0] * len(leaf_bars), 0.0
    ties_seen = {}
    if ties:
        sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
        from relu_ties import largest_over_bar, single_flip_allowance
        a_dws, a_dbs, a_dx, n_ties = single_flip_allowance(x, hidden, heads, grads, want_dx)
        allow = [t.float() for t in a_dws + a_dbs], (0.0 if a_dx is None else a_dx.float())
        ties_seen = dict(relu_ties=n_ties, over_bar=sum(
            int(((g - w).abs() > bar).sum()) for g, w, bar in zip(got[0] + got[1], want[0] + want[1],
                                                                   leaf_bars)),
            tie_allow_over_bar=largest_over_bar(allow[0], leaf_bars))
    err, rel = 0.0, 0.0
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        diff = float((g - w).abs().max())
        scale = float(w.abs().max())
        err, rel = max(err, diff), max(rel, diff / scale if scale > 0 else diff)
    if want_dx:
        err = max(err, float((got[2] - want[2]).abs().max()))
    # every dW/db leaf within GRAD_SCALE_TOL of its largest value, dx within
    # ATOL + RTOL |ref|; beyond that only by one tie's move where ``ties``
    ok = same_bits and all(bool(torch.isfinite(g).all()) for g in got[0] + got[1])
    ok &= all(bool(((g - w).abs() <= bar + a).all())
              for g, w, bar, a in zip(got[0] + got[1], want[0] + want[1], leaf_bars, allow[0]))
    if want_dx:
        ok &= bool(((got[2] - want[2]).abs() <= ATOL + RTOL * want[2].abs() + allow[1]).all())
    b_ms, b_by, flops, nbytes = bound_backward(batch, x.shape[1], hidden, heads, want_dx, route)
    flips = recompute_flips(x, hidden) if route == "layers" else {}
    iters = 50 if batch < BIG_B else 10
    del got, want
    res = dict(batch=batch, widths=[x.shape[1]] + [w.shape[1] for w, _ in hidden]
               + [sum(w.shape[1] for w, _ in heads)], want_dx=want_dx, route=route,
               same_bits=same_bits, max_abs_err=err, **ties_seen, **flips,
               max_err_over_leaf_scale=rel, ms=time_ms(kernel, iters),
               plain_ms=time_ms(plain, iters), library_ms=time_ms(library, iters),
               bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes)
    res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
    # the device alone: every call's launches queued behind a sleeping kernel
    res["device_ms"] = time_ms(kernel, iters, queued=True)
    if route == "layers":
        res["launch_ms"] = kernel_device_ms(kernel)
    if not ok:
        raise AssertionError(f"stack_backward disagrees with its plain version at {res}: "
                             f"dW/db leaf over {GRAD_SCALE_TOL}*max|leaf|, dx over "
                             f"atol {ATOL} + rtol {RTOL}*|ref|"
                             + (" (beyond one flipped ReLU tie's move)" if ties else "")
                             + ", or other bits on a second call")
    return ("stack_backward" if route == "fused" else "stack_backward_layers"), res


def parity(name, params, role, x):
    """Kernel vs plain version on the same inputs, and the same bits on a
    second call; timings and bound.  Returns (the KERNELS name of the route
    forward_plan takes, result)."""
    import torch
    from atlasvae_torch.ops import fused_mlp, fused_vae
    hidden, heads = stack_pairs(params, role)
    dims = (x.shape[1],) + tuple(w.shape[1] for w, _ in hidden)
    route = fused_vae.forward_plan(x.shape[0], dims, tuple(w.shape[1] for w, _ in heads)).route
    if name == "fused_mlp":
        layers = [{"w": w, "b": b} for w, b in hidden + heads]
        kernel = lambda: (fused_mlp.fused_mlp_apply(layers, x),)
        plain = lambda: (fused_mlp.fused_mlp_plain(layers, x),)
    else:
        kernel = lambda: fused_vae.stack_forward(x, hidden, heads)
        plain = lambda: fused_vae.stack_forward_plain(x, hidden, heads)

    def library():
        h = x
        for w, b in hidden:
            h = torch.relu(torch.addmm(b, h, w))
        return tuple(torch.addmm(b, h, w) for w, b in heads)

    got, again, want = kernel(), kernel(), plain()
    torch.cuda.synchronize()
    same_bits = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
    del again
    err, ok = 0.0, same_bits
    for g, w in zip(got, want):
        diff = (g - w).abs()
        err = max(err, float(diff.max()))
        ok &= bool((diff <= ATOL + RTOL * w.abs()).all()) and bool(torch.isfinite(g).all())
    b_ms, b_by, flops, nbytes = bound(x.shape[0], x.shape[1], hidden, heads)
    iters = 50 if x.shape[0] < BIG_B else 20
    del got, want
    res = dict(batch=x.shape[0], widths=[x.shape[1]] + [w.shape[1] for w, _ in hidden]
               + [sum(w.shape[1] for w, _ in heads)], route=route, same_bits=same_bits,
               max_abs_err=err, ms=time_ms(kernel, iters), plain_ms=time_ms(plain, iters),
               library_ms=time_ms(library, iters), bound_ms=b_ms, bound_by=b_by,
               flops=flops, bytes=nbytes)
    res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
    if route == "fused":   # the fused body on the device alone: one launch a call
        res["device_ms"] = time_ms(kernel, iters, queued=True)
    if route == "layers" and x.shape[0] == BIG_B:
        res["launch_ms"] = kernel_device_ms(kernel)
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version at {res}: "
                             f"max abs err {err} > atol {ATOL} + rtol {RTOL}*|ref|, "
                             "or other bits on a second call")
    return (name if route == "fused" else name + "_layers"), res


def bound_emd(batch, n, n_iters=EMD_ITERS):
    """Least time (ms) for one EMD call and what bounds it.  Bytes: the two
    (B, n, 3) clouds read once, one float a pair written.  Operations the
    function needs, per element of an n x n matrix: 4 a Sinkhorn iteration
    (two matrix-vector products, a multiply and an add per element each);
    c = 4 for each of the n_stages Gibbs kernels and the final plan (add,
    subtract, divide by eps, exp; a transcendental counts as one); the cost
    matrix once, 11 (two differences; the phi wrap of an add, a modulo and
    a subtract; two squares, an add, a square root, a division by R); and
    an epilogue of 13 (two masks, the row, column and two deficit sums with
    their two rescalings = 8, the rank-one term and the costed sum = 5).
    The kernel builds the cost matrix anew for every Gibbs kernel instead of
    keeping it: that is its design, not the function's work, and is not in
    the bound."""
    n_stages = max(1, min(EMD_STAGES, n_iters))
    nbytes = 4 * (2 * batch * n * 3 + batch)
    flops = batch * n * n * (4 * n_iters + 4 * (n_stages + 1) + 11 + 13)
    t_bytes, t_ops = nbytes / PEAK_HBM_BYTES * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), flops, nbytes


def emd_clouds(gen, batch, n, device, kind="near"):
    """Jet pairs in (pt, y, phi): falling pt, zero-padded tails.

    near      the second cloud a distorted copy of the first with a tail of
              its own length (what a trained model's reconstruction is to
              its input); the total-pt difference carries most of the EMD.
    permuted  the second cloud is the first with its constituents in the
              reverse order: the true EMD is 0, so the result is all
              rounding and regularisation error, in units of the total pt.
    far       the first cloud's pt in the reverse order at positions about
              one unit of DeltaR away (what an untrained model's
              reconstruction is): equal totals, every bit of pt moved far.
    """
    import torch
    p = torch.zeros((batch, n, 3), device=device)
    p[..., 0] = -torch.log(torch.rand((batch, n), generator=gen, device=device).clamp_min(1e-6))
    p[..., 1:] = torch.randn((batch, n, 2), generator=gen, device=device) * 0.4
    slots = torch.arange(n, device=device)[None, :]
    live = torch.randint(max(1, int(0.5 * n)), n + 1, (batch, 1), generator=gen, device=device)
    p[(slots >= live).expand(batch, n)] = 0.0
    if kind == "permuted":
        return p.contiguous(), p.flip(1).contiguous()
    q = p.clone()
    if kind == "far":
        q[..., 1] += 0.8
        q[..., 2] -= 0.6
        q[..., 1:] += torch.randn((batch, n, 2), generator=gen, device=device) * 0.1
        q[..., 0] = p[..., 0].flip(1)
        return p.contiguous(), q.contiguous()
    q[..., 1:] += torch.randn((batch, n, 2), generator=gen, device=device) * 0.1
    q[..., 0] *= (1 + 0.1 * torch.randn((batch, n), generator=gen, device=device)).clamp_min(0.05)
    live = torch.randint(max(1, int(0.6 * n)), n + 1, (batch, 1), generator=gen, device=device)
    q[(slots >= live).expand(batch, n)] = 0.0
    return p.contiguous(), q.contiguous()


def parity_emd(gen, batch, n, device, kind="near", n_iters=EMD_ITERS, force_route=None):
    """K4 vs its plain version on the same clouds; the gap, both times, the
    bound, and the same bits on a second call.  ``force_route`` runs another
    route than the width's own (``emd_sinkhorn``'s argument).

    The EMD is transport * min(sum p, sum q) + |sum p - sum q|, and the
    float32 rounding of the transport term does not shrink with the
    transport: it is a few 1e-6 of the total pt however small the EMD.  So
    the `near` and `far` clouds are held to rtol + atol on the EMD, and
    the `permuted` clouds, whose EMD is small beside their pt, to rtol on
    the EMD plus EMD_MASS_TOL of min(sum p, sum q).  The plain
    version in float64 is the yardstick for both float32 forms."""
    import torch
    from atlasvae_torch.ops import emd, emd_cuda
    p, q = emd_clouds(gen, batch, n, device, kind)
    kernel = lambda: emd_cuda.emd_sinkhorn(p, q, 1.0, n_iters, EMD_EPS, EMD_STAGES,
                                           force_route=force_route)
    plain = lambda: emd._sinkhorn_emd(p, q, 1.0, n_iters, EMD_EPS, EMD_STAGES)
    got, want = kernel(), plain()
    again = kernel()
    exact = emd._sinkhorn_emd(p.double(), q.double(), 1.0, n_iters, EMD_EPS, EMD_STAGES)
    torch.cuda.synchronize()
    mass = torch.minimum(p[..., 0].clamp_min(0).sum(1), q[..., 0].clamp_min(0).sum(1))
    diff = (got - want).abs()
    rel = float((diff / want.abs().clamp_min(1e-12)).max())
    tol = EMD_RTOL * want.abs() + (EMD_MASS_TOL * mass if kind == "permuted" else EMD_ATOL)
    ok = bool((diff <= tol).all()) and bool(torch.isfinite(got).all())
    same_bits = bool(torch.equal(got, again))
    over_mass = lambda x, y: float(((x.double() - y.double()).abs() / mass.clamp_min(1e-12)).max())
    b_ms, b_by, flops, nbytes = bound_emd(batch, n, n_iters)
    res = dict(batch=batch, n_const=n, n_iters=n_iters, eps_final=EMD_EPS, clouds=kind,
               max_abs_err=float(diff.max()), max_rel_err=rel, same_bits=same_bits,
               mean_emd=float(exact.mean()), mean_mass=float(mass.mean()),
               err_over_mass=over_mass(got, want), kernel_vs_f64_over_mass=over_mass(got, exact),
               plain_vs_f64_over_mass=over_mass(want, exact),
               ms=time_ms(kernel, 10, 2), plain_ms=time_ms(plain, 3, 1), library_ms=None,
               bound_ms=b_ms, bound_by=b_by, flops=flops, bytes=nbytes)
    del exact
    res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
    res["jets_per_s"] = batch / (res["ms"] * 1e-3)
    # one iteration a stage: what the n_stages + 1 rebuilds of K and the
    # epilogue cost beside the iterations (9 in 10 of them left out)
    res["ms_one_iter_a_stage"] = time_ms(
        lambda: emd_cuda.emd_sinkhorn(p, q, 1.0, EMD_STAGES, EMD_EPS, EMD_STAGES,
                                      force_route=force_route), 10, 2)
    res["route"] = force_route or emd_cuda.route(n)[0]
    if res["route"] != "wide":   # the wide route on the same clouds, for comparison
        res["wide_route_ms"] = time_ms(
            lambda: emd_cuda.emd_sinkhorn(p, q, 1.0, n_iters, EMD_EPS, EMD_STAGES,
                                          force_route="wide"), 10, 2)
    if not ok or not same_bits:
        raise AssertionError(f"emd_sinkhorn vs its plain version at {res}: gap over rtol "
                             f"{EMD_RTOL}*|ref| + " + (f"{EMD_MASS_TOL}*min(sum pt)" if kind == "permuted"
                                                       else f"atol {EMD_ATOL}")
                             + ", or a second call gave other bits")
    return res


def bound_conv(n, h, w, c, kh, kw, m, pool, backward, elem=4):
    """Least time (ms) for one call of the fused conv block or its backward
    and what bounds it.  Forward: x, w, b read once, the pooled block written
    once, ``elem`` bytes an element (4 float32, 2 bfloat16); 2*K FLOP of
    products per conv pixel and map (K = kh*kw*C taps), a compare per conv
    pixel, a bias add and a clamp per pooled pixel.  Backward: x, w, b and g
    read, dW and db written; the same recompute and compares, and 2*K FLOP
    of products per pooled pixel and map for dW plus an add for db (only the
    window's first maximum gets gradient).  The products run at the f32
    CUDA-core peak in float32 (TF32 would round them) and at the bf16
    tensor-core peak in bfloat16 (a product of two bf16 values summed in
    f32 is what bf16 MMA computes); the compares, bias, clamp and db adds at
    the f32 peak in either form."""
    hc, wc = h - kh + 1, w - kw + 1
    ho, wo = -(-hc // pool[0]), -(-wc // pool[1])
    k = kh * kw * c
    conv_px, pooled_px = n * hc * wc * m, n * ho * wo * m
    products, other = conv_px * 2 * k, conv_px + 2 * pooled_px
    nbytes = elem * (n * h * w * c + k * m + m + pooled_px)
    if backward:
        products += pooled_px * 2 * k
        other += pooled_px
        nbytes += elem * (k * m + m)
    peak_products = PEAK_BF16_FLOPS if elem == 2 else PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = (products / peak_products + other / PEAK_F32_FLOPS) * 1e3
    return (max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"),
            products + other, nbytes)


def parity_conv(gen, shape, sparse, device, dtype=None):
    """K5 and K6 against their plain versions on the same inputs; the same
    bits on a second call; times of kernel, plain version and the library
    yardstick (cuDNN's conv2d, a -inf pad where XLA's SAME pool has one,
    max_pool2d and relu in NCHW views; autograd through it for K6), and the
    kernel's calls queued behind a sleeping kernel (``device_ms``: the
    device alone, where a call's host work outlasts its kernels); bounds.
    At a shape the register routes take, the band routes' times beside
    theirs, and K6's band route held to the plain version as well.

    ``dtype`` bfloat16 runs the kernels' bf16 forms on inputs drawn as in
    float32 and rounded to bf16.  Bars there: each output equal to the
    plain version's or one bf16 ulp from it (K5 and the plain version both
    round one float32 value once; cuDNN sums the taps in another order, so
    that value may sit on the other side of a rounding boundary), or within
    ATOL where the ReLU's input is 0 to float32 rounding; dW and db, rounded
    once from float32 sums by both, within one bf16 ulp of the plain value
    plus CONV_GRAD_TOL (CONV_GRAD_TOL_BIG) of the leaf's largest value; the
    library yardstick (cuDNN's own bf16 chain, which rounds after the conv
    and after the bias) within 1e-2, the JAX package's bar for the bf16 block
    against its XLA chain (tests/test_fused_conv.py)."""
    import torch
    import torch.nn.functional as F
    from atlasvae_torch.ops import fused_conv, fused_conv_cuda
    from atlasvae_torch.ops.pooling import same_pad_lo
    from atlasvae_torch.utils.bf16 import ulp as bf16_ulp, ulps_apart as bf16_ulps_apart
    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    name, n, h, wd, c, kh, kw, m, pool = shape
    x = torch.randn((n, h, wd, c), generator=gen, device=device)
    if sparse:   # jet images: a few lit pixels, so whole pool windows tie
        x = x.abs() * (torch.rand(x.shape, generator=gen, device=device) < 0.08)
    w = torch.randn((kh, kw, c, m), generator=gen, device=device) * 0.3
    b = torch.randn((m,), generator=gen, device=device) * 0.1
    x, w, b = x.to(dtype), w.to(dtype), b.to(dtype)
    want = fused_conv.conv1_pool_relu_plain(x, w, b, pool)
    g = (torch.randn(want.shape, generator=gen, device=device) / n).to(dtype)

    pads = []
    for size, p in ((wd - kw + 1, pool[1]), (h - kh + 1, pool[0])):   # F.pad: last axis first
        lo, out = same_pad_lo(size, p)
        pads += [lo, out * p - size - lo]
    x_lib, w_lib = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).contiguous()
    g_lib = g.permute(0, 3, 1, 2)

    def library(w_=w_lib, b_=b):
        z = F.conv2d(x_lib, w_, b_)
        if any(pads):
            z = F.pad(z, pads, value=float("-inf"))
        return torch.relu(F.max_pool2d(z, pool))

    def library_backward():
        w_, b_ = w_lib.detach().requires_grad_(), b.detach().requires_grad_()
        return torch.autograd.grad(library(w_, b_), (w_, b_), g_lib)

    which = fused_conv_cuda.route(x.shape, w.shape, pool)
    kernel = lambda: fused_conv_cuda.conv_pool_relu(x, w, b, pool)
    kernel_bwd = lambda: fused_conv_cuda.conv_pool_relu_backward(x, w, b, g, pool)
    plain = lambda: fused_conv.conv1_pool_relu_plain(x, w, b, pool)
    plain_bwd = lambda: fused_conv.conv1_pool_relu_backward_plain(x, w, b, g, pool)

    got, again = kernel(), kernel()
    grads, grads_again, grads_want = kernel_bwd(), kernel_bwd(), plain_bwd()
    bands_bwd = lambda: fused_conv_cuda.conv_pool_relu_backward(x, w, b, g, pool,
                                                                force_route="bands")
    grads_bands = bands_bwd() if which == "tiles" else grads
    lib = library().permute(0, 2, 3, 1)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    err_fwd = float(diff.max())
    if bf16:
        ulps = bf16_ulps_apart(got, want)
        ok = bool(((ulps <= 1) | (diff <= ATOL)).all())
        lib_gap = (lib.float() - want.float()).abs()
        lib_ok = bool((lib_gap <= 1e-2 + 1e-2 * want.float().abs()).all())
        bf16_facts = dict(not_bit_equal=float((ulps > 0).float().mean()),
                          max_ulps=int(ulps.max()), over_one_ulp=int((ulps > 1).sum()))
    else:
        ok = bool((diff <= ATOL + RTOL * want.abs()).all())
        lib_ok = bool(((lib - want).abs() <= 1e-4 + 1e-4 * want.abs()).all())
    ok &= bool(torch.isfinite(got).all()) and got.dtype == dtype
    same_bits = bool(torch.equal(got, again)) and all(
        bool(torch.equal(a, b_)) for a, b_ in zip(grads, grads_again))
    tol = CONV_GRAD_TOL_BIG if n >= 1000 else CONV_GRAD_TOL

    def leaf_errors(leaves):   # (max abs error, over the leaf's largest value, within tol)
        err, rel, fine = 0.0, 0.0, True
        for a, ref in zip(leaves, grads_want):
            gap = (a.float() - ref.float()).abs()
            d, scale = float(gap.max()), float(ref.float().abs().max())
            err, rel = max(err, d), max(rel, d / scale if scale > 0 else d)
            bar = tol * scale + 1e-12 + (bf16_ulp(ref) if bf16 else 0.0)
            fine &= a.shape == ref.shape and a.dtype == dtype and bool((gap <= bar).all()) \
                and bool(torch.isfinite(a).all())
        return err, rel, fine

    err_bwd, rel_bwd, ok_bwd = leaf_errors(grads)
    _, rel_bands, ok_bands = leaf_errors(grads_bands)
    ok_bwd &= ok_bands
    del got, again, want, lib, diff
    iters = 30 if n * h * wd <= 2_000_000 else 10
    out = {}
    form = "_bf16" if bf16 else ""
    route_sfx = "" if which == "tiles" else "_bands"
    fwd_name, bwd_name = "fused_conv" + form + route_sfx, "fused_conv_backward" + form + route_sfx
    for kname, backward, fn, fn_plain, fn_lib in (
            (fwd_name, False, kernel, plain, library),
            (bwd_name, True, kernel_bwd, plain_bwd, library_backward)):
        b_ms, b_by, flops, nbytes = bound_conv(n, h, wd, c, kh, kw, m, pool, backward,
                                               elem=2 if bf16 else 4)
        res = dict(shape=name + (" sparse" if sparse else "") + (" bf16" if bf16 else ""),
                   batch=n, image=[h, wd, c], kernel=[kh, kw], maps=m, pool=list(pool),
                   sparse=sparse, dtype=str(dtype).split(".")[-1], same_bits=same_bits,
                   ms=time_ms(fn, iters), device_ms=time_ms(fn, iters, queued=True),
                   plain_ms=time_ms(fn_plain, iters),
                   library_ms=time_ms(fn_lib, iters), bound_ms=b_ms, bound_by=b_by,
                   flops=flops, bytes=nbytes)
        res["tflops"] = flops / (res["ms"] * 1e-3) / 1e12
        out[kname] = res
    out[fwd_name]["max_abs_err"] = err_fwd
    if bf16:
        out[fwd_name].update(bf16_facts)
    out[fwd_name]["route"] = which
    out[bwd_name]["route"] = which
    if which == "tiles":   # the band routes on the same inputs, for comparison
        out[fwd_name]["bands_route_ms"] = time_ms(
            lambda: fused_conv_cuda.conv_pool_relu(x, w, b, pool, force_route="bands"), iters)
        out[bwd_name].update(bands_route_ms=time_ms(bands_bwd, iters),
                             bands_route_err_over_leaf_scale=rel_bands)
    out[bwd_name].update(max_abs_err=err_bwd, max_err_over_leaf_scale=rel_bwd)
    if not (ok and ok_bwd and same_bits and lib_ok):
        fwd_bar = (f"one bf16 ulp or atol {ATOL}" if bf16 else f"atol {ATOL} + rtol {RTOL}*|ref|")
        raise AssertionError(f"fused conv block vs its plain version at {out}: forward over "
                             f"{fwd_bar} ({not ok}), a dW/db leaf over {tol} * its largest value"
                             f"{' + one bf16 ulp' if bf16 else ''} ({not ok_bwd}), other bits on "
                             f"a second call ({not same_bits}), or the library yardstick computes "
                             f"another function ({not lib_ok})")
    return out


def phase_device():
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log("device", torch=torch.__version__, cuda=torch.version.cuda,
        kind=repr(torch.cuda.get_device_name(0)), count=torch.cuda.device_count(),
        allow_tf32=torch.backends.cuda.matmul.allow_tf32)
    print(smi, flush=True)
    found = {}
    for name in ("matplotlib", "h5py", "scipy"):
        try:
            __import__(name)
            found[name] = True
        except ImportError:
            found[name] = False
    log("imports", **found)
    return smi


def phase_build():
    from concurrent.futures import ThreadPoolExecutor
    from atlasvae_torch import native
    from atlasvae_torch.ops import cuda_build
    start = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        gxx = pool.submit(native.build)            # the g++ runs beside the nvcc ones
        report = cuda_build.build()
        host = gxx.result()
    for name, (path, secs, _) in host.items():
        log("build", lib=path.name, gxx_s=f"{secs:.2f}")
    for name, (path, secs, ptxas) in report.items():
        usage = [l.split("info    :")[-1].strip() for l in ptxas.splitlines()
                 if "registers" in l or "spill" in l]
        log("build", lib=path.name, nvcc_s=f"{secs:.2f}", ptxas=json.dumps(usage))
    log("build", total_s=f"{time.perf_counter() - start:.2f}")


def phase_parity(device):
    import torch
    from atlasvae_torch.models import VAEConfig, init_vae
    gen = torch.Generator(device).manual_seed(1234)
    configs = {
        "slice": (VAEConfig(), SLICE_CHUNK),
        "train": (VAEConfig(), TRAIN_BATCH),
        "canonical": (VAEConfig(), BIG_B),
        "constituents": (VAEConfig(fc_layers=(256, 128, 64, 32), input_dim=312), BIG_B),
        "emd_slice": (VAEConfig(fc_layers=EMD_LAYERS, input_dim=3 * EMD_CONST), SLICE_CHUNK),
        "emd_slice255": (VAEConfig(fc_layers=EMD_LAYERS, input_dim=3 * EMD_WIDE_CONST),
                         SLICE_CHUNK),
        "const_train": (VAEConfig(fc_layers=CONST_LAYERS, input_dim=3 * EMD_CONST), TRAIN_BATCH),
        "evaluate": (VAEConfig(), EVAL_CHUNK),
        **{name: (VAEConfig(fc_layers=fc, input_dim=width), TRAIN_BATCH)
           for name, (fc, width) in DEEP_WIDE_STACKS.items()},
    }
    # K1 runs the decoder (scoring); K2 runs the encoder on both paths and
    # the decoder (one head) in training, so at the scoring chunk and the
    # training batches it is held in both roles, beside K1 on the same
    # decoder.  Stacks wider than 128 take the layer-wise route of both.
    fwd = {"canonical": (("fused_mlp", "decoder"), ("stack_forward", "encoder"))}
    fwd["constituents"] = fwd["emd_slice"] = fwd["emd_slice255"] = fwd["evaluate"] = \
        fwd["canonical"]
    fwd["slice"] = fwd["train"] = fwd["const_train"] = \
        fwd["canonical"] + (("stack_forward", "decoder"),)
    for name in DEEP_WIDE_STACKS:
        fwd[name] = fwd["train"]
    results = {name: [] for name in KERNELS}
    for shape, (cfg, batch) in configs.items():
        params = init_vae(gen, cfg, device=device)
        x = torch.randn((batch, cfg.input_dim), generator=gen, device=device)
        z = torch.randn((batch, cfg.fc_layers[-1]), generator=gen, device=device)
        with torch.inference_mode():
            for name, role in fwd[shape]:
                name, res = parity(name, params, role, x if role == "encoder" else z)
                res["shape"] = f"{shape} {role}"
                results[name].append(res)
                log("parity", kernel=name, shape=json.dumps(res["shape"]), batch=batch,
                    widths=res["widths"], same_bits=res["same_bits"],
                    max_abs_err=f"{res['max_abs_err']:.3g}", ms=f"{res['ms']:.4f}",
                    **({"device_ms": f"{res['device_ms']:.4f}"} if "device_ms" in res else {}),
                    plain_ms=f"{res['plain_ms']:.4f}", library_ms=f"{res['library_ms']:.4f}",
                    bound_ms=f"{res['bound_ms']:.4f}", bound_by=res["bound_by"],
                    tflops=f"{res['tflops']:.2f}",
                    **({"launch_ms": json.dumps(res["launch_ms"])} if "launch_ms" in res else {}))
        del params, x, z
        torch.cuda.empty_cache()
    # K3 at the training batch and at 1,000,003 rows: the canonical encoder
    # (two heads, no dx) and decoder (one head, dx) on the fused body; the
    # constituents-mode encoder and decoder, 312 wide and at const_train's
    # 300-wide batch, on the layer-wise route
    bwd_configs = [("train", VAEConfig(), TRAIN_BATCH),
                   ("canonical", VAEConfig(), BIG_B),
                   ("constituents", VAEConfig(fc_layers=(256, 128, 64, 32), input_dim=312), BIG_B),
                   ("const_train", VAEConfig(fc_layers=CONST_LAYERS, input_dim=3 * EMD_CONST),
                    TRAIN_BATCH)]
    bwd_configs += [(name, VAEConfig(fc_layers=fc, input_dim=width), TRAIN_BATCH)
                    for name, (fc, width) in DEEP_WIDE_STACKS.items()]
    for shape, cfg, batch in bwd_configs:
        params = init_vae(gen, cfg, device=device)
        for role in ("encoder", "decoder"):
            width = cfg.input_dim if role == "encoder" else cfg.fc_layers[-1]
            x = torch.randn((batch, width), generator=gen, device=device)
            name, res = parity_backward(params, role, x, gen, ties=shape == "wide_2048")
            res["shape"] = f"{shape} {role}"
            results[name].append(res)
            log("parity", kernel=name, shape=json.dumps(res["shape"]), batch=batch,
                widths=res["widths"], want_dx=res["want_dx"], same_bits=res["same_bits"],
                max_abs_err=f"{res['max_abs_err']:.3g}",
                max_err_over_leaf_scale=f"{res['max_err_over_leaf_scale']:.3g}",
                **{k: res[k] for k in ("relu_ties", "over_bar") if k in res},
                **{k: json.dumps(res[k]) for k in ("recompute_flips_vs_plain", "recompute_flips_vs_k2",
                                                   "undecided_flips_vs_plain", "redecided")
                   if k in res},
                **({"tie_allow_over_bar": f"{res['tie_allow_over_bar']:.3g}"}
                   if "tie_allow_over_bar" in res else {}),
                ms=f"{res['ms']:.4f}",
                **({"device_ms": f"{res['device_ms']:.4f}"} if "device_ms" in res else {}),
                plain_ms=f"{res['plain_ms']:.4f}",
                library_ms=f"{res['library_ms']:.4f}", bound_ms=f"{res['bound_ms']:.4f}",
                bound_by=res["bound_by"], tflops=f"{res['tflops']:.2f}",
                **({"launch_ms": json.dumps(res["launch_ms"])} if "launch_ms" in res else {}))
            del x
        del params
        torch.cuda.empty_cache()
    # K4 at the three reference shapes and at the chunks emd_pairs cuts a
    # 100- and a 255-constituent sample into (2 GiB / (16 n^2) jets); then,
    # at few iterations, a permuted copy (true EMD 0) and a far transport at
    # n = 100 (the register route), at 233, 255 and the widest jet of the
    # cluster route, and at a width above it (the wide route)
    from atlasvae_torch.ops import emd, emd_cuda
    chunk, chunk255 = (emd._EMD_BUDGET_BYTES // (16 * n ** 2) for n in (EMD_CONST, EMD_WIDE_CONST))
    cases = [("8192x100", 8192, 100, "near", EMD_ITERS), ("65536x20", 65_536, 20, "near", EMD_ITERS),
             ("1000x128", 1000, 128, "near", EMD_ITERS),
             ("emd_slice chunk", chunk, EMD_CONST, "near", EMD_ITERS),
             ("emd_slice255 chunk", chunk255, EMD_WIDE_CONST, "near", EMD_ITERS)]
    cases += [(f"{batch}x{n} {kind}", batch, n, kind, EMD_FEW_ITERS)
              for batch, n in ((8192, 100), (1000, 233), (chunk255, EMD_WIDE_CONST),
                               (500, emd_cuda.CLUSTER_MAX), (200, 400))
              for kind in ("permuted", "far")]
    for shape, batch, n, kind, n_iters in cases:
        res = parity_emd(gen, batch, n, device, kind, n_iters)
        res["shape"] = shape
        name = EMD_KERNELS[res["route"]]
        results[name].append(res)
        log("parity", kernel=name, shape=json.dumps(shape), batch=batch, n_const=n,
            n_iters=n_iters, mean_emd=f"{res['mean_emd']:.4g}", mean_mass=f"{res['mean_mass']:.4g}",
            max_abs_err=f"{res['max_abs_err']:.3g}", max_rel_err=f"{res['max_rel_err']:.3g}",
            err_over_mass=f"{res['err_over_mass']:.3g}",
            kernel_vs_f64_over_mass=f"{res['kernel_vs_f64_over_mass']:.3g}",
            plain_vs_f64_over_mass=f"{res['plain_vs_f64_over_mass']:.3g}",
            same_bits=res["same_bits"], ms=f"{res['ms']:.4f}",
            ms_one_iter_a_stage=f"{res['ms_one_iter_a_stage']:.4f}",
            **({"wide_route_ms": f"{res['wide_route_ms']:.4f}"} if "wide_route_ms" in res else {}),
            plain_ms=f"{res['plain_ms']:.4f}",
            library_ms="none", bound_ms=f"{res['bound_ms']:.4f}", bound_by=res["bound_by"],
            tflops=f"{res['tflops']:.2f}", jets_per_s=f"{res['jets_per_s']:.0f}")
        torch.cuda.empty_cache()
    # K5 and K6: the jet-ID shapes on sparse images (what a jet image is),
    # the CPU tests' odd shapes on dense and on sparse ones; float32, then
    # the bf16 forms
    for dtype in (torch.float32, torch.bfloat16):
        for shape in CONV_SHAPES:
            for sparse in ((True,) if shape[1] >= 500 else (False, True)):
                for name, res in parity_conv(gen, shape, sparse, device, dtype).items():
                    results[name].append(res)
                    log_conv_parity(name, res)
                torch.cuda.empty_cache()
    return results


def log_conv_parity(name, res):
    log("parity", kernel=name, shape=json.dumps(res["shape"]), batch=res["batch"],
        image=res["image"], maps=res["maps"], pool=res["pool"],
        max_abs_err=f"{res['max_abs_err']:.3g}",
        **({"max_err_over_leaf_scale": f"{res['max_err_over_leaf_scale']:.3g}"}
           if "max_err_over_leaf_scale" in res else {}),
        **{k: res[k] for k in ("not_bit_equal", "max_ulps", "over_one_ulp") if k in res},
        same_bits=res["same_bits"], ms=f"{res['ms']:.4f}", device_ms=f"{res['device_ms']:.4f}",
        **({"bands_route_ms": f"{res['bands_route_ms']:.4f}"} if "bands_route_ms" in res else {}),
        plain_ms=f"{res['plain_ms']:.4f}", library_ms=f"{res['library_ms']:.4f}",
        bound_ms=f"{res['bound_ms']:.4f}", bound_by=res["bound_by"],
        tflops=f"{res['tflops']:.2f}")


def profile_slice(run, phase="profile"):
    """A profiled run of a path: device busy share of the wall time, and
    the device time of the busiest kernels and of the port's own kernels.
    Returns the idle share, the device-side rows (microseconds, name,
    count) and the device ms of the kernels launched under PyTorch's
    convolutions, forward and backward (on the jet-ID path: block 2, since
    block 1 is K5/K6).

    Busy time sums the device-side events only (kernels, copies, memsets):
    a host operator's own device time repeats the time of the kernels it
    launched, so it is left out."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        run()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        dev = e.self_device_time_total
        if e.device_type == DeviceType.CUDA and dev > 0:
            rows.append((dev, e.key, e.count))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    conv_ms = sum(e.device_time_total for e in prof.key_averages()
                  if e.key in ("aten::convolution", "aten::convolution_backward")) / 1e3
    log(phase, wall_ms=f"{wall_us / 1e3:.2f}", device_busy_ms=f"{busy_us / 1e3:.3f}",
        idle_share=f"{1 - busy_us / wall_us:.4f}", device_events=sum(r[2] for r in rows),
        cudnn_conv_ms=f"{conv_ms:.3f}",
        top=json.dumps([(k[:60], n, round(d / 1e3, 4)) for d, k, n in rows[:10]]),
        ours=json.dumps([(k[:60], n, round(d / 1e3, 4)) for d, k, n in rows if "atlasvae::" in k]))
    return 1 - busy_us / wall_us, rows, conv_ms


def phase_slice(device, workdir):
    import numpy as np
    import torch
    from atlasvae_torch.cli import score
    from atlasvae_torch.data import (ensure_synthetic_registry, load_data, fit_scaler,
                                     apply_scaler, hdf5, Scaler)
    from atlasvae_torch.eval import compute_metric_bank
    from atlasvae_torch.models import VAEConfig, init_vae, vae_apply
    from atlasvae_torch.train.checkpoint import save_pytree, load_pytree

    t0 = time.perf_counter()
    ensure_synthetic_registry(workdir, n_events=SLICE_EVENTS, n_const_max=20,
                              names=["QCD-Geneva"], seed=0)
    qcd = load_data("QCD-Geneva", SLICE_EVENTS, verbose=False, device=device)
    scaler_path = os.path.join(workdir, "HLV_RobustScaler.pkl")
    fit_scaler(qcd["HLVs"], scaler_out=scaler_path, scaler_type="RobustScaler",
               verbose=False)
    model_path = os.path.join(workdir, "model.npz")
    save_pytree(model_path, init_vae(torch.Generator(device).manual_seed(7), VAEConfig(),
                                     device=device))
    out_path = os.path.join(workdir, "scores.h5")
    log("slice", setup_s=f"{time.perf_counter() - t0:.2f}", events=SLICE_EVENTS)

    metrics = ["MAE", "Latent", "KLD", "JSD"]
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def run(output):
        score.main(["--data", "QCD-Geneva", "--model_in", model_path,
                    "--HLV_scaler_in", scaler_path, "--metrics", *metrics,
                    "--chunk", str(SLICE_CHUNK), "--output", output, "--device", str(device)])
        sync()

    reset_counters()
    sync()
    t0 = time.perf_counter()
    run(out_path)
    cold_s = time.perf_counter() - t0
    launches = counters()

    with hdf5.File(out_path, "r") as f:
        got = {k: f[k][:] for k in f}
    want_keys = {f"score_{m}" for m in metrics} | {"m", "pt", "weights"}
    if set(got) != want_keys:
        raise AssertionError(f"output keys {sorted(got)} != {sorted(want_keys)}")
    for key, val in got.items():
        if val.shape != (SLICE_EVENTS,) or not np.isfinite(val).all():
            raise AssertionError(f"{key}: shape {val.shape}, finite {np.isfinite(val).all()}")

    # reference: the plain CPU path on the first jets, with the latent noise
    # the scorer drew for its first chunk (CUDA generator seeded 0)
    cpu = torch.device("cpu")
    sample = load_data("QCD-Geneva", REF_ROWS, verbose=False, device=cpu)
    x = apply_scaler(torch.as_tensor(sample["HLVs"]), 3, Scaler.load(scaler_path),
                     verbose=False)
    params = load_pytree(model_path, init_vae(torch.Generator().manual_seed(0), VAEConfig(),
                                              device=cpu))
    noise = torch.randn((SLICE_CHUNK, 10), generator=torch.Generator(device).manual_seed(0),
                        device=device)[:REF_ROWS].cpu()
    with torch.inference_mode():
        x_pred = vae_apply(params, x, noise=noise)[0]
        ref = compute_metric_bank(x, x_pred, params, ("MAE", "Latent"),
                                  normal_losses=False, device=cpu)
    ref_err = {}
    for m in ("MAE", "Latent"):
        a, b = got[f"score_{m}"][:REF_ROWS], ref[m]
        ref_err[m] = float(np.max(np.abs(a - b) / (np.abs(b) + 1e-3)))
        if not np.allclose(a, b, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"score_{m} differs from the plain CPU path: max rel err "
                                 f"{ref_err[m]}; " + _slice_gaps(m, a, b, x, params, noise))
    for name in ("fused_mlp", "stack_forward"):
        if launches[name] <= 0 or launches[name + "_layers"] != 0:
            raise AssertionError(f"kernel {name} on the scoring path: fused body "
                                 f"{launches[name]} times (want > 0), layer-wise route "
                                 f"{launches[name + '_layers']} (want 0)")

    # the same slice again, warm (file in the page cache, CUDA modules
    # loaded), then once more under the profiler
    t0 = time.perf_counter()
    run(os.path.join(workdir, "scores_warm.h5"))
    warm_s = time.perf_counter() - t0
    if device.type == "cuda":
        profile_slice(lambda: run(os.path.join(workdir, "scores_profiled.h5")))
    rate = SLICE_EVENTS / warm_s
    log("slice", jets=SLICE_EVENTS, cold_s=f"{cold_s:.4f}",
        cold_jets_per_s=f"{SLICE_EVENTS / cold_s:.0f}", warm_s=f"{warm_s:.4f}",
        warm_jets_per_s=f"{rate:.0f}", launches=json.dumps(launches),
        ref_rel_err=json.dumps(ref_err))
    return launches, rate


def _slice_gaps(metric, card, cpu, x, params, noise):
    """Where the card's and the CPU's scores part: the worst row over the
    bar (rtol/atol 1e-4), both values, and each side's gap to a float64 run
    of the same rows (the plain path in float64 on the CPU), there and at
    most, with the rows each side has over the bar against float64."""
    import numpy as np
    import torch
    from atlasvae_torch.eval.metrics import _latent_kernel, _metric_kernel
    from atlasvae_torch.models import vae_apply
    from atlasvae_torch.train.checkpoint import tree_map
    p64, x64 = tree_map(lambda t: t.double(), params), x.double()
    with torch.inference_mode():
        if metric == "MAE":
            f64 = _metric_kernel(x64, vae_apply(p64, x64, noise=noise.double())[0], "MAE")
        else:
            f64 = _latent_kernel(p64, x64)
    f64 = f64.numpy()
    bar = lambda ref: 1e-4 + 1e-4 * np.abs(ref)
    row = int(np.argmax(np.abs(card - cpu) - bar(cpu)))
    card_gap, cpu_gap = np.abs(card - f64), np.abs(cpu - f64)
    return (f"row {row}: card {card[row]!r} cpu {cpu[row]!r} float64 {f64[row]!r}, gap to "
            f"float64 card {card_gap[row]:.3e} cpu {cpu_gap[row]:.3e}; largest gap to float64 "
            f"card {card_gap.max():.3e} (row {int(card_gap.argmax())}) cpu {cpu_gap.max():.3e} "
            f"(row {int(cpu_gap.argmax())}); rows over the bar against float64: card "
            f"{int((card_gap > bar(f64)).sum())} cpu {int((cpu_gap > bar(f64)).sum())}")


def gammainc_ops():
    from atlasvae_torch.ops.gammainc import _N_ITER
    return (_N_ITER - 1) * (SERIES_OPS + CF_OPS) + GAMMAINC_FIXED_OPS


def valid_windows(ref, widths, steps):
    """Windows a scan of one histogram against ``ref`` must evaluate:
    inside [first, last + 1) of its non-empty bins, at each width's stride."""
    import numpy as np
    non0 = np.nonzero(np.asarray(ref) > 0)[0]
    if not len(non0):
        return 0
    span = int(non0.max()) + 1 - int(non0.min())
    return sum(max(0, (span - w) // s + 1) for w, s in zip(widths, steps))


def bound_scan(n_windows, n_bins_sig, bytes_moved):
    """(ms, "bytes" or "operations") for n_windows p-values and n_bins_sig
    per-bin significances (two tails + sigma each)."""
    flop = n_windows * (gammainc_ops() + WINDOW_OPS) + \
        n_bins_sig * (2 * gammainc_ops() + SIGMA_OPS)
    by_ops, by_bytes = flop / PEAK_F32_FLOPS * 1e3, bytes_moved / PEAK_HBM_BYTES * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes"), flop


def launches_and_busy(fn):
    """Kernels one call of fn launches on the card (copies and memsets not
    counted) and their device ms."""
    events = kernel_device_ms(fn)
    kernels = [(n, ms) for n, ms in events if not n.startswith(("Memcpy", "Memset"))]
    return len(kernels), sum(ms for _, ms in events)


def check_against_f64(log_pvals, hists, ref, widths, hinf, hsup):
    """Each window's log p from the card against scipy's float64 gammainc
    on the same float32 window sums, where scipy does not underflow:
    returns (windows compared, largest |d log p| / max(|log p|, 1))."""
    import numpy as np
    import torch
    from scipy.special import gammainc
    from atlasvae_torch.stats.bumphunter import _window_sums
    worst, count = 0.0, 0
    for wi, w in enumerate(widths):
        nh = _window_sums(torch.tensor(hists), w).double().numpy()
        nr = _window_sums(torch.tensor(ref), w).double().numpy()[None, :]
        pos = np.arange(nh.shape[1])
        ok = (nh > nr) & (nr > 0) & ((pos >= hinf) & (pos + w <= hsup))[None, :]
        with np.errstate(divide="ignore"):
            true = np.log(gammainc(nh, np.maximum(nr, 1e-30)))
        ok &= np.isfinite(true)
        got = log_pvals[wi][:, :nh.shape[1]].astype(np.float64)
        err = np.abs(got - true) / np.maximum(np.abs(true), 1.0)
        count += int(ok.sum())
        worst = max(worst, float(err[ok].max(initial=0.0)))
    return count, worst


def phase_evaluate(device, workdir):
    import shutil
    import numpy as np
    import torch
    from atlasvae_torch.cli import vae as vae_cli
    from atlasvae_torch.data import ensure_synthetic_registry, Scaler, HLV_LIST
    from atlasvae_torch.eval import bump, results
    from atlasvae_torch.eval.roc import _trapezoid
    from atlasvae_torch.models import VAEConfig, init_vae
    from atlasvae_torch.stats import BumpHunter1D, batched_local_sigma, scan_histograms
    from atlasvae_torch.stats.bumphunter import _bin_significance, _poisson_pseudo
    from atlasvae_torch.train.checkpoint import load_pytree

    ensure_synthetic_registry(workdir, n_events=EVAL_EVENTS, n_const_max=20,
                              names=["QCD-Geneva", "2HDM-Geneva"], seed=0)
    cuts = ['(sample["m"] >= 30)', '(sample["pt"] <= 5000)']     # cli/vae.py's valid cuts
    params = load_pytree(os.path.join(workdir, "model.npz"),
                         init_vae(torch.Generator(device).manual_seed(0), VAEConfig(),
                                  device=device))
    scaler = Scaler.load(os.path.join(workdir, "HLV_RobustScaler.pkl"))
    # cli/vae.py's own _evaluate steps: the whole of both files as the
    # validation sample, the 2d decorrelation, the cuts
    args = vae_cli.build_parser().parse_args(["--decorrelation", "2d", "--apply_cuts", "ON",
                                              "--npe", str(EVAL_NPE)])
    args.n_valid, args.n_sig = [0, EVAL_EVENTS], EVAL_EVENTS

    reset_counters()
    t_phase = time.perf_counter()
    y_true, x_true, x_pred, sample, wall = vae_cli._valid_predictions(
        args, params, None, scaler, list(HLV_LIST), cuts, device)
    numbers = results._evaluation_numbers(
        y_true, x_true, x_pred, sample, args.n_dims, params, vae_cli.EVAL_METRICS,
        vae_cli.EVAL_LOSS, args.apply_cuts, args.normal_losses, args.decorrelation, args.npe,
        device)
    phase_ms = (time.perf_counter() - t_phase) * 1e3
    launches = counters()
    wall.update(numbers["wall_ms"])
    best, mae, cut_sample = numbers["best_loss"], numbers["x_losses"]["MAE"], numbers["cut_sample"]
    if best is None:
        raise AssertionError("bump_scan found no cut with 100 background jets")
    loc_sigma, max_sigma = numbers["hunter"]["loc_sigma"], numbers["hunter"]["max_sigma"]
    for name in ("fused_mlp", "stack_forward"):
        if launches[name] <= 0 or launches[name + "_layers"] != 0:
            raise AssertionError(f"kernel {name} in evaluate: fused body {launches[name]} "
                                 f"times (want > 0), layer-wise route "
                                 f"{launches[name + '_layers']} (want 0)")
    if not (np.isfinite(loc_sigma) and loc_sigma > 0):
        raise AssertionError(f"loc_sigma at the best cut is {loc_sigma}")
    curves = numbers["curves"]
    points = {f"{m}_{t}": len(curves[m][t][0]) for m in EVAL_METRICS for t in (0, 1)}
    if sorted(numbers["rates"]) != sorted(EVAL_METRICS) or min(points.values()) == 0 \
            or len(numbers["cuts"]) != 7:
        raise AssertionError(f"evaluate: ROC rates of {sorted(numbers['rates'])}, "
                             f"mass-sculpting points {points}, {len(numbers['cuts'])} cuts")
    log("evaluate", jets=len(y_true), signal=int((y_true == 0).sum()),
        phase_ms=f"{phase_ms:.1f}", wall_ms=json.dumps({k: round(v, 3) for k, v in wall.items()}),
        deco_host_ms=f"{wall['deco']:.3f}", best_cut=json.dumps(
            {"metric": best["metric"], "eff": float(best["eff"]), "loss": float(best["loss"])}),
        loc_sigma=f"{loc_sigma:.6g}", max_sigma=f"{max_sigma}",
        auc=json.dumps({m: round(float(_trapezoid(r[1], r[0]) / 1e4), 6)
                        for m, r in numbers["rates"].items()}),
        mass_sculpting_points=json.dumps(points),
        launches=json.dumps({k: launches[k] for k in ("fused_mlp", "stack_forward")}))

    # the CLI itself: --plotting ON (its default) is refused before any load
    # where matplotlib cannot be imported; then the run without drawing, or
    # with it where matplotlib imports
    root = os.path.join(workdir, "evaluate_cli")
    os.makedirs(root)
    for name in ("model.npz", "HLV_RobustScaler.pkl"):
        shutil.copy(os.path.join(workdir, name), root)
    argv = ["--n_epochs", "0", "--model_in", "model.npz", "--HLV_scaler_type", "RobustScaler",
            "--HLV_scaler_in", "HLV_RobustScaler.pkl", "--apply_cuts", "ON",
            "--npe", str(EVAL_NPE), "--output_dir", root, "--device", str(device)]
    try:
        import matplotlib  # noqa: F401
        drawing = True
    except ImportError:
        drawing = False
    if not drawing:
        try:
            vae_cli.main(argv + ["--bkg_data", "no-such-sample"])
        except ImportError as exc:
            if "matplotlib" not in str(exc):
                raise
            refusal = str(exc)
        else:
            raise AssertionError("cli/vae.py --plotting ON ran where matplotlib is missing")
        if os.path.exists(os.path.join(root, "plots")):
            raise AssertionError("cli/vae.py wrote its output folder before refusing")
        log("evaluate", cli="--plotting ON", refused=json.dumps(refusal))
    t0 = time.perf_counter()
    if vae_cli.main(argv + ["--plotting", "ON" if drawing else "OFF"]) != 0:
        raise AssertionError("cli/vae.py --n_epochs 0 did not return 0")
    written = sorted(os.path.relpath(os.path.join(d, f), root)
                     for d, _, files in os.walk(os.path.join(root, "plots")) for f in files)
    if drawing and len(written) < 25:
        raise AssertionError(f"cli/vae.py --plotting ON wrote {written}")
    log("evaluate", cli=f"--plotting {'ON' if drawing else 'OFF'} --apply_cuts ON",
        wall_ms=f"{(time.perf_counter() - t0) * 1e3:.1f}", files=json.dumps(written))

    # the cut scan's parts, on the same inputs: host histograms, then the
    # 101-cut batched scan on the card
    t0 = time.perf_counter()
    thresholds, _, idx, _ = bump._cut_grid(y_true, mae, sample["weights"], EVAL_CUTS, "bkg",
                                           device)
    grid_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    hist_sample = {k: sample[k] for k in ("JZW", "m", "pt", "weights")}
    data_hists, bkg_hists, kept = bump._cut_histograms(mae, thresholds, idx, hist_sample,
                                                       (0, 800), 5)
    data_mat, bkg_mat = bump.pad_hist_matrices(data_hists, bkg_hists, EVAL_CUTS + 1)
    hist_ms = (time.perf_counter() - t0) * 1e3
    widths, steps = bump._WIDTHS, bump._STEPS
    dm, bm = (torch.as_tensor(m, dtype=torch.float32, device=device) for m in (data_mat, bkg_mat))
    local = lambda: batched_local_sigma(dm, bm, widths, steps, device=device)
    local_ms = time_ms(local, iters=5, warmup=1)
    local_launches, local_busy = launches_and_busy(local)
    n_win = sum(valid_windows(b, widths, steps) for b in bkg_hists)
    n_bins = sum(len(b) for b in bkg_hists)
    rows, cols = data_mat.shape
    local_bytes = 2 * rows * cols * 4 + rows * (4 + 8 + 8) + rows * cols * 4
    (local_bound, local_by), local_flop = bound_scan(n_win, n_bins, local_bytes)
    log("evaluate", scan="batched_local_sigma", cuts=len(kept), matrix=json.dumps([rows, cols]),
        grid_ms=f"{grid_ms:.3f}", histograms_host_ms=f"{hist_ms:.3f}",
        ms=f"{local_ms:.4f}", device_busy_ms=f"{local_busy:.4f}", launches=local_launches,
        windows=n_win, bins=n_bins, flop=f"{local_flop:.4g}", bound_ms=f"{local_bound:.6f}",
        bound_by=local_by)

    # bump_hunter's scan at the best cut: the data and 1,000 pseudo-histograms
    bins = bump._adaptive_bins(cut_sample["m"][cut_sample["JZW"] != -1], (0, 800), 5)
    is_bkg = cut_sample["JZW"] != -1
    data_hist = np.histogram(cut_sample["m"], bins=bins, range=(0, 800),
                             weights=cut_sample["weights"])[0]
    bkg_hist = np.histogram(cut_sample["m"][is_bkg], bins=bins, range=(0, 800),
                            weights=cut_sample["weights"][is_bkg])[0]
    hunter = BumpHunter1D(rang=[0, 800], width_min=2, width_max=6, width_step=1, scan_step=1,
                          npe=EVAL_NPE, seed=None, bins=bins, device=device)
    hunter.bump_scan(data_hist, bkg_hist, is_hist=True, verbose=False)
    again = hunter.bump_info(data_hist, is_hist=True, verbose=False)
    if again != loc_sigma:
        raise AssertionError(f"BumpHunter1D at the best cut gives loc_sigma {again}, "
                             f"bump_hunter {loc_sigma}")
    hw, hs = hunter._widths(len(data_hist))
    n_true = len(data_hist)
    pad = (-n_true) % 32
    data_p = np.pad(data_hist, (0, pad)).astype(np.float32)
    bkg_p = np.pad(bkg_hist, (0, pad)).astype(np.float32)
    hinf, hsup = hunter._scan_range(bkg_p)
    ref_t = torch.as_tensor(bkg_p, device=device)
    hists_t = torch.cat([torch.as_tensor(data_p, device=device)[None],
                         _poisson_pseudo(torch.Generator(device).manual_seed(0), ref_t,
                                         EVAL_NPE)])
    scan = lambda: scan_histograms(hists_t, ref_t, hw, hs, hinf, hsup, device=device)
    scan_ms = time_ms(scan, iters=5, warmup=1)
    scan_launches, scan_busy = launches_and_busy(scan)
    k, n = hists_t.shape
    scan_bytes = (k * n + n) * 4 + k * (4 + 8 + 8 + 4) + len(hw) * k * n * 4
    (scan_bound, scan_by), scan_flop = bound_scan(k * valid_windows(bkg_p, hw, hs), 0, scan_bytes)
    log("evaluate", scan="bump_hunter", histograms=k, bins=n_true, padded_bins=n,
        ms=f"{scan_ms:.4f}", device_busy_ms=f"{scan_busy:.4f}", launches=scan_launches,
        windows=k * valid_windows(bkg_p, hw, hs), flop=f"{scan_flop:.4g}",
        bound_ms=f"{scan_bound:.6f}", bound_by=scan_by,
        global_pval=hunter.global_Pval, significance=f"{hunter.significance:.6g}",
        best_eff=f"{float(best['eff']):.6g}")

    # card against CPU: the data and 50 injected pseudo-histograms
    rng = np.random.default_rng(EVAL_SEED)
    hists = np.concatenate([data_p[None], rng.poisson(
        bkg_p, (EVAL_PARITY_PSEUDO, n)).astype(np.float32)])
    cpu = torch.device("cpu")
    on_card = [t.cpu() for t in scan_histograms(hists, bkg_p, hw, hs, hinf, hsup, device=device)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        on_cpu = scan_histograms(hists, bkg_p, hw, hs, hinf, hsup, device=cpu)
        sig_cpu = _bin_significance(torch.tensor(data_p), torch.tensor(bkg_p))
    finally:
        torch.set_num_threads(threads)
    sig_card = _bin_significance(torch.tensor(data_p, device=device),
                                 torch.tensor(bkg_p, device=device)).cpu()
    gap = lambda a, b, rtol, atol: float(((a - b).abs() - (atol + rtol * b.abs())).max())
    cpu_excess = {"min_log_pval": gap(on_card[0], on_cpu[0], 1e-5, 1e-6),
                  "log_pvals": gap(on_card[4], on_cpu[4], 1e-5, 1e-6),
                  "bin_sigma": gap(sig_card, sig_cpu, 1e-5, 1e-6)}
    same_window = bool(torch.equal(on_card[1], on_cpu[1]) and torch.equal(on_card[2], on_cpu[2]))
    # card against float64 scipy on the same float32 window sums
    n_f64, f64_err = check_against_f64(on_card[4].numpy(), hists, bkg_p, hw, hinf, hsup)
    # determinism of the card's draws, and the first minimum on a constructed tie
    draws = [_poisson_pseudo(torch.Generator(device).manual_seed(s), ref_t, EVAL_NPE)
             for s in (EVAL_SEED, EVAL_SEED)]
    same_draws = bool(torch.equal(*draws))
    tie = np.full(64, 100.0, np.float32)
    tie_hist = tie.copy()
    tie_hist[[10, 11, 40, 41]] += 80
    tie_out = scan_histograms(np.tile(tie_hist, (3, 1)), tie, hw, hs, 0, 64, device=device)
    first_min = bool((tie_out[1] == 10).all() and (tie_out[2] == 2).all())
    log("evaluate", check="card_vs_cpu", histograms=len(hists),
        excess_over_bar=json.dumps(cpu_excess), same_window=same_window,
        f64_windows=n_f64, f64_max_rel_log_err=f"{f64_err:.3g}", same_draws=same_draws,
        first_minimum_on_tie=first_min)
    if not (max(cpu_excess.values()) <= 0 and same_window and n_f64 > 0
            and f64_err <= EVAL_F64_REL and same_draws and first_min):
        raise AssertionError(
            f"evaluate checks: card against CPU over rtol 1e-5 / atol 1e-6 by {cpu_excess}, "
            f"same window {same_window}; against float64 {f64_err:.3g} (bar {EVAL_F64_REL}) "
            f"on {n_f64} windows; same draws {same_draws}; first minimum {first_min}")
    return launches, dict(scan_ms=scan_ms, scan_launches=scan_launches, scan_bound=scan_bound,
                          local_ms=local_ms, local_launches=local_launches,
                          local_bound=local_bound, loc_sigma=loc_sigma)


class _Stamped(list):
    """A list of loads that notes the time (after a device sync) and the
    launch counters each time train_model starts iterating it."""

    def __init__(self, loads, stamps, tag):
        super().__init__(loads)
        self.stamps, self.tag = stamps, tag

    def __iter__(self):
        import torch
        torch.cuda.synchronize()
        self.stamps.append((self.tag, time.perf_counter(), counters()))
        return super().__iter__()


def _train_parity(load, device, cfg=None, losses=True, n_batches=5):
    """The CUDA training path against the plain CPU path on the first
    ``n_batches`` batches of a load: first-step gradients per leaf, and
    (``losses``) 2 epochs of losses with one injected noise stream.  ``cfg``:
    the model's VAEConfig (default: the canonical one)."""
    import numpy as np
    import torch
    from atlasvae_torch.losses import get_losses
    from atlasvae_torch.models import VAEConfig, init_vae
    from atlasvae_torch.train import train_model
    from atlasvae_torch.train.checkpoint import tree_flatten, tree_map
    from atlasvae_torch.train.loop import features

    cfg = cfg or VAEConfig()
    latent = cfg.fc_layers[-1]
    n = n_batches * TRAIN_BATCH
    bkg, ood = load
    small = ({"HLVs": features(bkg)[:n], "weights": bkg["weights"][:n]},
             {"HLVs": features(ood)[:n], "weights": ood["weights"][:n]})
    rng = np.random.default_rng(5)
    noise = {(phase, e): (rng.standard_normal((nb, TRAIN_BATCH if phase == "train" else n, latent))
                          .astype(np.float32),
                          rng.standard_normal((nb, TRAIN_BATCH if phase == "train" else n, latent))
                          .astype(np.float32))
             for e in range(2) for phase, nb in (("train", n_batches), ("valid", 1))}
    source = lambda phase, epoch, load_idx, n_batches, batch: noise[(phase, epoch)]
    cpu = torch.device("cpu")
    init = init_vae(torch.Generator().manual_seed(21), cfg, device=cpu)
    on = {d: tree_map(lambda t, d=d: t.detach().to(d).requires_grad_(), init)
          for d in (cpu, device)}

    # first step's gradients
    grads = {}
    for d, params in on.items():
        x = lambda k, side: torch.as_tensor(side[k][:TRAIN_BATCH]).to(d)
        nz = tuple(torch.as_tensor(a[0]).to(d) for a in noise[("train", 0)])
        total = get_losses(params, x("HLVs", small[0]), x("HLVs", small[1]),
                           x("weights", small[0]), x("weights", small[1]), None, "MAE",
                           2.0, 5.0, 1.0, noise=nz)[3].sum()
        leaves = tree_flatten(params)
        grads[d] = [g.cpu() for g in torch.autograd.grad(total, leaves)]
    grad_rel = 0.0
    for g_dev, g_cpu in zip(grads[device], grads[cpu]):
        scale = float(g_cpu.abs().max())
        diff = float((g_dev - g_cpu).abs().max())
        grad_rel = max(grad_rel, diff / scale if scale > 0 else diff)
        if diff > GRAD_SCALE_TOL * scale:
            raise AssertionError(f"first-step gradient leaf differs: {diff} > "
                                 f"{GRAD_SCALE_TOL} * {scale}")
    if not losses:
        return grad_rel, None

    hists = {}
    for d in (cpu, device):
        _, hists[d] = train_model(tree_map(lambda t, d=d: t.detach().to(d), init),
                                  [small], [small], "MAE", 2, TRAIN_BATCH, 2.0, 5.0, 1.0,
                                  1e-3, noise_source=source)
    loss_rel = 0.0
    for key, want in hists[cpu].items():
        got = np.asarray(hists[device][key])
        want = np.asarray(want)
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        loss_rel = max(loss_rel, rel)
        if not rel <= TRAIN_REL_TOL:
            raise AssertionError(f"{key}: CUDA {got} vs CPU {want}, rel {rel} > {TRAIN_REL_TOL}")
    return grad_rel, loss_rel


def phase_train(device, workdir):
    """Train the canonical OE-VAE through the CLI, then time, profile,
    check against the plain CPU path, and score the result."""
    import pickle
    import numpy as np
    import torch
    from atlasvae_torch.cli import score, vae as cli_vae
    from atlasvae_torch.data import ensure_synthetic_registry, hdf5
    from atlasvae_torch.models import VAEConfig, init_vae
    from atlasvae_torch.train import train_model, load_pytree

    ensure_synthetic_registry(workdir, n_events=TRAIN_EVENTS, n_const_max=20,
                              names=["QCD-Geneva", "OoD-H"], seed=0)
    out_dir = os.path.join(workdir, "train")
    args = TRAIN_ARGS + ["--output_dir", out_dir, "--device", str(device)]
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli_vae.main(args)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = counters()
    for name in ("stack_forward", "stack_backward"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the training path")
    for name in ("stack_forward", "fused_mlp", "stack_backward"):
        if launches[name + "_layers"] != 0:
            raise AssertionError(f"the canonical model's {name} left the fused body: "
                                 f"{launches[name + '_layers']} layer-wise calls")
    with open(os.path.join(out_dir, "history.pkl"), "rb") as f:
        history = pickle.load(f)
    for key, vals in history.items():
        if len(vals) != TRAIN_EPOCHS or not np.isfinite(vals).all():
            raise AssertionError(f"history[{key!r}] = {vals}: want {TRAIN_EPOCHS} finite epochs")
    model_path = os.path.join(out_dir, "model.npz")
    template = init_vae(torch.Generator(device).manual_seed(0), VAEConfig(), device=device)
    load_pytree(model_path, template)
    log("train", cli_s=f"{cli_s:.3f}", launches=json.dumps(launches),
        history=json.dumps(history))

    # the same data, prepared once, for a timed warm run and a profile
    parsed = cli_vae.build_parser().parse_args(args)
    cli_vae._wire_paths(parsed)
    hlv_list, _, train_cuts, _ = cli_vae._select_samples(parsed)
    train_gen, valid_gen, _, _ = cli_vae._make_generators(parsed, hlv_list, train_cuts,
                                                          None, None)
    load, vload = train_gen[0], valid_gen[0]
    jets = len(load[0]["weights"])
    steps = -(-jets // TRAIN_BATCH)
    stamps = []
    params = init_vae(torch.Generator(device).manual_seed(0), VAEConfig(), device=device)
    timed_dir = os.path.join(workdir, "timed")
    os.makedirs(timed_dir)
    reset_counters()
    train_model(params, _Stamped([load], stamps, "train"), _Stamped([vload], stamps, "valid"),
                "MAE", TRAIN_EPOCHS, TRAIN_BATCH, 2.0, 5.0, 1.0, 1e-3,
                hist_file=os.path.join(timed_dir, "history.pkl"),
                model_out=os.path.join(timed_dir, "model.npz"))
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    # training part of epoch e: from its "train" stamp to its "valid" stamp;
    # the whole epoch (validation, history and checkpoint too) to the next
    # epoch's "train" stamp, the last one to the return of train_model
    spans = [(stamps[2 * e][1], stamps[2 * e + 1][1], stamps[2 * e][2], stamps[2 * e + 1][2])
             for e in range(TRAIN_EPOCHS)]
    warm_s = sum(t1 - t0 for t0, t1, _, _ in spans[1:])
    warm_rate = jets * (TRAIN_EPOCHS - 1) / warm_s
    epoch_s = (t_end - stamps[2][1]) / (TRAIN_EPOCHS - 1)
    per_step = {name: (spans[-1][3][name] - spans[-1][2][name]) / steps for name in launches}
    idle, _, _ = profile_slice(
        lambda: (train_model(params, [load], [vload], "MAE", 1, TRAIN_BATCH, 2.0, 5.0, 1.0, 1e-3),
                 torch.cuda.synchronize()),
        phase="train profile")
    grad_rel, loss_rel = _train_parity(load, device)
    # --FC_layers of 10 entries: 2 steps (2 epochs of one batch), card against
    # the CPU at the same bars; K2 on fused segments, K3 on its layer-wise route
    before = counters()
    deep_grad_rel, deep_loss_rel = _train_parity(
        load, device, VAEConfig(fc_layers=DEEP_FC_LAYERS, input_dim=12), n_batches=1)
    deep = {k: v - before[k] for k, v in counters().items() if v != before[k]}
    for name in ("stack_forward_layers", "stack_backward_layers"):
        if deep.get(name, 0) <= 0:
            raise AssertionError(f"the 9-hidden-layer model never ran {name}: {deep}")
    log("train", deep_fc_layers=json.dumps(DEEP_FC_LAYERS), deep_grad_rel=f"{deep_grad_rel:.3g}",
        deep_loss_rel=f"{deep_loss_rel:.3g}", deep_launches=json.dumps(deep))

    # the two paths meet: score the trained weights through cli.score
    scores = os.path.join(workdir, "train_scores.h5")
    score.main(["--data", "QCD-Geneva", "--model_in", model_path, "--HLV_scaler_in",
                os.path.join(out_dir, "HLV_RobustScaler.pkl"), "--metrics", "MAE", "Latent",
                "--chunk", str(SLICE_CHUNK), "--output", scores, "--device", str(device)])
    with hdf5.File(scores, "r") as f:
        mae = f["score_MAE"][:]
    if mae.shape != (TRAIN_EVENTS,) or not np.isfinite(mae).all():
        raise AssertionError(f"scores of the trained model: shape {mae.shape}, "
                             f"finite {np.isfinite(mae).all()}")
    facts = dict(jets_per_epoch=jets, steps_per_epoch=steps,
                 warm_jets_per_s=warm_rate, ms_per_step=warm_s / (steps * (TRAIN_EPOCHS - 1)) * 1e3,
                 warm_epoch_s=epoch_s, warm_epoch_jets_per_s=jets / epoch_s,
                 launches_per_step=per_step, idle_share=idle, grad_rel=grad_rel,
                 loss_rel=loss_rel, scored_mae_mean=float(mae.mean()))
    log("train", **{k: (json.dumps(v) if isinstance(v, dict) else v) for k, v in facts.items()})
    return launches, facts


K3_LAYER_KERNELS = ("bwd_rows_kernel", "bwd_dw_kernel", "bwd_split_kernel", "reduce_splits")
# K1/K2, both routes: the fused body, the row product and its weights' pre-pass
FORWARD_KERNELS = ("fused_stack_kernel", "rows_wgmma_kernel", "split_weights_kernel")


def phase_const_train(device, workdir):
    """Train the constituents-mode OE-VAE (300->256/128/64/32, 100
    constituents, TRAIN_ARGS) through the CLI with the counters set to 0 just
    before: every K2 and K3 call of a step takes the layer-wise route, and
    K1 (validation) too.  Check the launch counts, the history and the
    weights; time a warm run (epochs 2-3), profile one epoch (K2's and K3's
    device time), and hold the first step's gradients against the plain CPU
    path."""
    import pickle
    import numpy as np
    import torch
    from atlasvae_torch.cli import vae as cli_vae
    from atlasvae_torch.data import ensure_synthetic_registry
    from atlasvae_torch.models import VAEConfig, init_vae
    from atlasvae_torch.train import train_model, load_pytree

    t0 = time.perf_counter()
    os.makedirs(workdir)
    ensure_synthetic_registry(workdir, n_events=TRAIN_EVENTS, n_const_max=EMD_CONST,
                              names=["QCD-Geneva", "OoD-H"], seed=0)
    setup_s = time.perf_counter() - t0
    cfg = VAEConfig(fc_layers=CONST_LAYERS, input_dim=3 * EMD_CONST)
    out_dir = os.path.join(workdir, "train")
    args = TRAIN_ARGS + CONST_ARGS + ["--output_dir", out_dir, "--device", str(device)]
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli_vae.main(args)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = counters()
    with open(os.path.join(out_dir, "history.pkl"), "rb") as f:
        history = pickle.load(f)
    for key, vals in history.items():
        if len(vals) != TRAIN_EPOCHS or not np.isfinite(vals).all():
            raise AssertionError(f"history[{key!r}] = {vals}: want {TRAIN_EPOCHS} finite epochs")
    load_pytree(os.path.join(out_dir, "model.npz"),
                init_vae(torch.Generator(device).manual_seed(0), cfg, device=device))

    # the same data, prepared once, for the count check, a timed warm run and a profile
    parsed = cli_vae.build_parser().parse_args(args)
    cli_vae._wire_paths(parsed)
    hlv_list, _, train_cuts, _ = cli_vae._select_samples(parsed)
    train_gen, valid_gen, _, _ = cli_vae._make_generators(parsed, hlv_list, train_cuts,
                                                          None, None)
    load, vload = train_gen[0], valid_gen[0]
    jets = len(load[0]["weights"])
    steps = -(-jets // TRAIN_BATCH)
    want = 4 * steps * TRAIN_EPOCHS   # two encoders and two decoders a step
    if launches["stack_backward_layers"] != want or launches["stack_backward"] != 0:
        raise AssertionError(f"K3 in the training run: layer-wise route "
                             f"{launches['stack_backward_layers']} times (want {want}: 4 a step, "
                             f"{steps} steps, {TRAIN_EPOCHS} epochs), fused body "
                             f"{launches['stack_backward']} (want 0)")
    if launches["stack_forward_layers"] < want or launches["stack_forward"] != 0 \
            or launches["fused_mlp"] != 0:
        raise AssertionError(f"K1/K2 in the training run: K2's layer-wise route "
                             f"{launches['stack_forward_layers']} times (want at least {want}), "
                             f"K2's fused body {launches['stack_forward']}, K1's "
                             f"{launches['fused_mlp']} (want 0)")
    log("const_train", setup_s=f"{setup_s:.2f}", cli_s=f"{cli_s:.3f}", jets_per_epoch=jets,
        launches=json.dumps(launches), history=json.dumps(history))

    stamps = []
    params = init_vae(torch.Generator(device).manual_seed(0), cfg, device=device)
    timed_dir = os.path.join(workdir, "timed")
    os.makedirs(timed_dir)
    reset_counters()
    train_model(params, _Stamped([load], stamps, "train"), _Stamped([vload], stamps, "valid"),
                "MAE", TRAIN_EPOCHS, TRAIN_BATCH, 2.0, 5.0, 1.0, 1e-3,
                hist_file=os.path.join(timed_dir, "history.pkl"),
                model_out=os.path.join(timed_dir, "model.npz"))
    torch.cuda.synchronize()
    spans = [(stamps[2 * e][1], stamps[2 * e + 1][1], stamps[2 * e][2], stamps[2 * e + 1][2])
             for e in range(TRAIN_EPOCHS)]
    warm_s = sum(t1 - t0 for t0, t1, _, _ in spans[1:])
    per_step = {name: (spans[-1][3][name] - spans[-1][2][name]) / steps for name in launches}
    if per_step["stack_backward_layers"] != 4 or per_step["stack_backward"] != 0 \
            or per_step["stack_forward_layers"] != 4 or per_step["stack_forward"] != 0:
        raise AssertionError(f"K2/K3 launches a step in the timed run: {per_step} (want each "
                             "layer-wise route 4 times, each fused body never)")
    before = counters()
    idle, rows, _ = profile_slice(
        lambda: (train_model(params, [load], [vload], "MAE", 1, TRAIN_BATCH, 2.0, 5.0, 1.0, 1e-3),
                 torch.cuda.synchronize()),
        phase="const_train profile")
    calls = {k: v - before[k] for k, v in counters().items()}
    k3_rows = [r for r in rows if any(k in r[1] for k in K3_LAYER_KERNELS)]
    fwd_rows = [r for r in rows if any(k in r[1] for k in FORWARD_KERNELS)]
    busy_ms = sum(r[0] for r in rows) / 1e3
    grad_rel, _ = _train_parity(load, device, cfg, losses=False)
    facts = dict(jets_per_epoch=jets, steps_per_epoch=steps,
                 warm_jets_per_s=jets * (TRAIN_EPOCHS - 1) / warm_s,
                 ms_per_step=warm_s / (steps * (TRAIN_EPOCHS - 1)) * 1e3,
                 launches_per_step=per_step, idle_share=idle,
                 k3_profiled_calls=calls["stack_backward_layers"],
                 k3_profiled_kernels=sum(r[2] for r in k3_rows),
                 k3_profiled_device_ms=sum(r[0] for r in k3_rows) / 1e3,
                 k3_device_share=sum(r[0] for r in k3_rows) / 1e3 / busy_ms,
                 # K2 in the steps and validation, K1 in validation: one set of kernels
                 k2_profiled_calls=calls["stack_forward_layers"],
                 k1_profiled_calls=calls["fused_mlp_layers"],
                 k2_k1_profiled_kernels=sum(r[2] for r in fwd_rows),
                 k2_k1_profiled_device_ms=sum(r[0] for r in fwd_rows) / 1e3,
                 k2_k1_device_share=sum(r[0] for r in fwd_rows) / 1e3 / busy_ms,
                 device_busy_ms=busy_ms, grad_rel=grad_rel)
    log("const_train", **{k: (json.dumps(v) if isinstance(v, dict) else v) for k, v in facts.items()})
    return launches, facts


def _emd_slice_files(device, workdir, n_const):
    """Score a synthetic background and signal file of EMD_EVENTS jets of
    ``n_const`` constituents through cli.score in constituents mode, the
    counters set to 0 just before each file; check the rows, finiteness, K1
    and K2 on their layer-wise routes only, and K4 on the route of its
    width only, once an emd_pairs chunk.  Returns the scores by file, the
    counts by file, the cold seconds by file and what a rerun needs."""
    import numpy as np
    import torch
    from atlasvae_torch.cli import score
    from atlasvae_torch.data import ensure_synthetic_registry, load_data, fit_scaler, hdf5
    from atlasvae_torch.models import VAEConfig, init_vae
    from atlasvae_torch.ops import emd, emd_cuda
    from atlasvae_torch.train.checkpoint import save_weights

    t0 = time.perf_counter()
    os.makedirs(workdir)
    names = ["QCD-Geneva", "2HDM-Geneva"]
    # the generator builds constituents in mirrored pairs, so its files are
    # an even number wide; load_data cuts them to n_const
    ensure_synthetic_registry(workdir, n_events=EMD_EVENTS, n_const_max=n_const + n_const % 2,
                              names=names, seed=0)
    mode = ["--constituents", "ON", "--HLVs", "OFF", "--n_const", str(n_const), "--n_dims", "3"]
    const = load_data("QCD-Geneva", EMD_EVENTS, (), n_const, 3, "ON", "OFF", verbose=False,
                      device=device)["constituents"]
    scaler_path = os.path.join(workdir, "const_RobustScaler.pkl")
    fit_scaler(const, scaler_out=scaler_path, scaler_type="RobustScaler", verbose=False)
    del const
    cfg = VAEConfig(fc_layers=EMD_LAYERS, input_dim=3 * n_const)
    model_path = os.path.join(workdir, "model.npz")
    save_weights(init_vae(torch.Generator(device).manual_seed(11), cfg, device=device), model_path)
    size_mb = os.path.getsize(os.path.join(workdir, "synthetic_QCD-Geneva.h5")) / 1e6
    log("emd_slice", setup_s=f"{time.perf_counter() - t0:.2f}", events=EMD_EVENTS,
        n_const=n_const, file_mb=f"{size_mb:.1f}", input_dim=cfg.input_dim)

    def run(name, output):
        score.main(["--data", name, "--model_in", model_path, "--const_scaler_in", scaler_path,
                    *mode, "--FC_layers", *map(str, EMD_LAYERS), "--metrics", *EMD_METRICS,
                    "--chunk", str(SLICE_CHUNK), "--output", output, "--device", str(device)])
        torch.cuda.synchronize()

    chunk = emd._EMD_BUDGET_BYTES // (16 * n_const ** 2)
    want_emd = {name: 0 for name in EMD_KERNELS.values()}
    want_emd[EMD_KERNELS[emd_cuda.route(n_const)[0]]] = -(-EMD_EVENTS // chunk)
    got, launches, cold_s = {}, {}, {}
    for name in names:
        out_path = os.path.join(workdir, f"scores_{name}.h5")
        reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(name, out_path)
        cold_s[name] = time.perf_counter() - t0
        launches[name] = counters()
        with hdf5.File(out_path, "r") as f:
            got[name] = {k: f[k][:] for k in f}
        want_keys = {f"score_{m}" for m in EMD_METRICS} | {"m", "pt", "weights"}
        if set(got[name]) != want_keys:
            raise AssertionError(f"{name}: output keys {sorted(got[name])} != {sorted(want_keys)}")
        for key, val in got[name].items():
            if val.shape != (EMD_EVENTS,) or not np.isfinite(val).all():
                raise AssertionError(f"{name} {key}: shape {val.shape}, "
                                     f"finite {np.isfinite(val).all()}")
        for kernel in ("fused_mlp", "stack_forward"):
            if launches[name][kernel + "_layers"] <= 0 or launches[name][kernel] != 0:
                raise AssertionError(f"kernel {kernel} scoring {name}: layer-wise route "
                                     f"{launches[name][kernel + '_layers']} times (want > 0), "
                                     f"fused body {launches[name][kernel]} (want 0)")
        ran = {k: launches[name][k] for k in want_emd}
        if ran != want_emd:
            raise AssertionError(f"K4 scoring {name} at {n_const} constituents ran {ran}, "
                                 f"want {want_emd}")
    log("emd_slice", n_const=n_const, cold_s=json.dumps(cold_s), emd_launches=json.dumps(want_emd))
    return names, got, launches, cold_s, dict(run=run, cfg=cfg, model_path=model_path,
                                              scaler_path=scaler_path)


def _card_clouds(device, n_const, files, rows):
    """The (pt, y, phi) clouds that cli.score's first chunk hands the EMD
    for the first ``rows`` background jets, made on the card the way the
    CLI makes them (load, scale, the VAE with generator 0's noise)."""
    import torch
    from atlasvae_torch.data import load_data, apply_scaler, jets_3v, Scaler
    from atlasvae_torch.models import init_vae, vae_apply
    from atlasvae_torch.train.checkpoint import load_pytree
    from atlasvae_torch.train.loop import features
    with torch.inference_mode():
        sample = load_data("QCD-Geneva", (0, min(SLICE_CHUNK, EMD_EVENTS)), (), n_const, 3, "ON",
                           "OFF", verbose=False, device=device)
        sample["constituents"] = apply_scaler(
            torch.as_tensor(sample["constituents"], device=device), 3,
            Scaler.load(files["scaler_path"]), verbose=False)
        x_true = features(sample).contiguous()
        params = load_pytree(files["model_path"],
                             init_vae(torch.Generator().manual_seed(0), files["cfg"], device=device))
        x_pred = vae_apply(params, x_true, torch.Generator(device).manual_seed(0))[0]
        x_pred = torch.stack([x_pred], dim=-1).mean(dim=-1)
        return (jets_3v(x_true[:rows], 3).contiguous(), jets_3v(x_pred[:rows], 3).contiguous())


def _cpu_reference(device, n_const, files, scored, rows, emd_rows=None):
    """Hold the CLI's scores of the first ``rows`` background jets against
    the plain CPU path (load, scale, the VAE with the latent noise the
    scorer drew for its first chunk, CUDA generator 0, then the metric
    bank), the EMD on the first ``emd_rows`` of them (all by default).
    Returns each metric's gap; raises past a bar."""
    import numpy as np
    import torch
    from atlasvae_torch.data import load_data, apply_scaler, Scaler
    from atlasvae_torch.eval import compute_metric_bank
    from atlasvae_torch.models import init_vae, vae_apply
    from atlasvae_torch.train.checkpoint import load_weights
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    emd_rows = rows if emd_rows is None else emd_rows
    sample = load_data("QCD-Geneva", rows, (), n_const, 3, "ON", "OFF", verbose=False, device=cpu)
    x = apply_scaler(torch.as_tensor(sample["constituents"]), 3,
                     Scaler.load(files["scaler_path"]), verbose=False)
    params = load_weights(files["model_path"],
                          init_vae(torch.Generator().manual_seed(0), files["cfg"], device=cpu))
    noise = torch.randn((SLICE_CHUNK, EMD_LAYERS[-1]),
                        generator=torch.Generator(device).manual_seed(0),
                        device=device)[:rows].cpu()
    with torch.inference_mode():
        x_pred = vae_apply(params, x, noise=noise)[0]
        ref = compute_metric_bank(x, x_pred, params, ("MAE", "Latent", "KLD", "JSD", "KSD"),
                                  normal_losses=False, device=cpu)
        ref["EMD"] = compute_metric_bank(x[:emd_rows], x_pred[:emd_rows], None, ("EMD",),
                                         normal_losses=False, device=cpu)["EMD"]
    gaps = {}
    # MAE and Latent at the slice phase's bar, the EMD at its own
    for m, rtol, atol in (("MAE", 1e-4, 1e-4), ("Latent", 1e-4, 1e-4), ("EMD", 1e-3, 1e-4)):
        b = ref[m]
        a = scored[f"score_{m}"][:len(b)]
        gaps[m] = float(np.max(np.abs(a - b) / (np.abs(b) + 1e-3)))
        if not np.allclose(a, b, rtol=rtol, atol=atol):
            raise AssertionError(f"{n_const} constituents: score_{m} differs from the plain CPU "
                                 f"path beyond rtol {rtol} + atol {atol}: max rel gap {gaps[m]}")
    # KSD counts sorted positions in steps of 1/(3 n): equal but where a
    # true and a predicted value lie within the two paths' rounding of each
    # other
    ks_gap = np.abs(scored["score_KSD"][:rows] - ref["KSD"])
    step = 1.0 / (3 * n_const)
    gaps["KSD_max"], gaps["KSD_share_over_1e-6"] = float(ks_gap.max()), float(np.mean(ks_gap > 1e-6))
    if ks_gap.max() > 2 * step + 1e-6 or np.mean(ks_gap > 1e-6) > 0.02:
        raise AssertionError(f"{n_const} constituents: score_KSD differs from the plain CPU "
                             f"path: {gaps}")
    # KLD and JSD sum p log2(p/q) over the features, a term dropped where
    # p/q < 0: a predicted value within the two paths' rounding of 0 flips
    # its sign and the row's sum, so all but a few rows are held at the
    # slice phase's bar
    for m in ("KLD", "JSD"):
        a, b = scored[f"score_{m}"][:rows], ref[m]
        over = np.abs(a - b) > 1e-4 + 1e-4 * np.abs(b)
        gaps[f"{m}_share_over_1e-4"] = float(np.mean(over))
        if np.mean(over) > 0.02 or not np.isfinite(a).all():
            raise AssertionError(f"{n_const} constituents: score_{m} differs from the plain CPU "
                                 f"path beyond rtol/atol 1e-4 on {np.mean(over):.3%} of rows")
    log("emd_slice", n_const=n_const, reference_s=f"{time.perf_counter() - t0:.2f}", rows=rows,
        emd_rows=emd_rows, gaps=json.dumps(gaps))
    return gaps


def phase_emd_slice(device, workdir):
    """Constituents-mode scoring at full width through cli.score, EMD and
    KSD included, on a background and a signal file: at 100 constituents
    (the register route), then at 255 (the cluster route)."""
    import numpy as np
    from atlasvae_torch.eval import auc_score
    from atlasvae_torch.ops import emd, emd_cuda

    names, got, launches, cold_s, files = _emd_slice_files(device, workdir, EMD_CONST)
    run = files["run"]
    gaps = _cpu_reference(device, EMD_CONST, files, got["QCD-Geneva"], EMD_REF_ROWS)
    scored = got["QCD-Geneva"]

    # what each score is worth: background (label 1) against signal (label 0)
    labels = np.concatenate([np.ones(EMD_EVENTS), np.zeros(EMD_EVENTS)])
    aucs = {m: auc_score(labels, np.concatenate([got[names[0]][f"score_{m}"],
                                                 got[names[1]][f"score_{m}"]]), device=device)
            for m in EMD_METRICS}
    for m, val in aucs.items():
        if not 0.0 <= val <= 1.0:
            raise AssertionError(f"AUC of {m} is {val}")
    log("emd_slice", auc=json.dumps(aucs), emd_mean_bkg=f"{scored['score_EMD'].mean():.4f}",
        emd_mean_sig=f"{got[names[1]]['score_EMD'].mean():.4f}")

    # the background file again, warm, then once more under the profiler
    t0 = time.perf_counter()
    run(names[0], os.path.join(workdir, "scores_warm.h5"))
    warm_s = time.perf_counter() - t0
    idle, _, _ = profile_slice(lambda: run(names[0], os.path.join(workdir, "scores_profiled.h5")),
                               phase="emd_slice profile")
    total = {k: sum(launches[name][k] for name in names) for k in launches[names[0]]}
    facts = dict(jets=EMD_EVENTS, cold_s=cold_s[names[0]], warm_s=warm_s,
                 warm_jets_per_s=EMD_EVENTS / warm_s, idle_share=idle,
                 launches_per_file=launches[names[0]], auc=aucs, gaps=gaps)
    log("emd_slice", **{k: (json.dumps(v) if isinstance(v, dict) else v)
                        for k, v in facts.items() if k != "auc"})

    # 255 constituents: the same scoring on the cluster route, held against
    # the plain CPU path as at 100 (the EMD on fewer jets); then the EMD of
    # the first background jets against the plain version on the CPU, fed
    # the clouds the CLI's chunk gave the kernel, at the kernel's own bar
    wide_dir = os.path.join(workdir, f"n{EMD_WIDE_CONST}")
    names, got, launches, cold_s, files = _emd_slice_files(device, wide_dir, EMD_WIDE_CONST)
    for name in names:
        for k in total:
            total[k] += launches[name][k]
    wide_gaps = _cpu_reference(device, EMD_WIDE_CONST, files, got["QCD-Geneva"], EMD_REF_ROWS,
                               EMD_WIDE_REF_ROWS)
    t0 = time.perf_counter()
    p, q = _card_clouds(device, EMD_WIDE_CONST, files, EMD_WIDE_REF_ROWS)
    scored = got["QCD-Geneva"]["score_EMD"][:EMD_WIDE_REF_ROWS]
    again = emd_cuda.emd_sinkhorn(p, q, 1.0, EMD_ITERS, EMD_EPS, EMD_STAGES).cpu().numpy()
    plain = emd._sinkhorn_emd(p.cpu(), q.cpu(), 1.0, EMD_ITERS, EMD_EPS, EMD_STAGES).numpy()
    gap = float(np.max(np.abs(scored - plain) - EMD_RTOL * np.abs(plain)))
    if not np.array_equal(again, scored):
        raise AssertionError(f"emd_slice {EMD_WIDE_CONST}: the kernel on the CLI's clouds of "
                             f"the first {EMD_WIDE_REF_ROWS} jets gives other bits than the CLI: "
                             f"max gap {np.abs(again - scored).max()}")
    if gap > EMD_ATOL:
        raise AssertionError(f"emd_slice {EMD_WIDE_CONST}: score_EMD differs from the plain "
                             f"version on the CPU beyond rtol {EMD_RTOL} + atol {EMD_ATOL}: "
                             f"largest excess over rtol {gap}")
    aucs = {m: auc_score(labels, np.concatenate([got[names[0]][f"score_{m}"],
                                                 got[names[1]][f"score_{m}"]]), device=device)
            for m in EMD_METRICS}
    facts[f"n{EMD_WIDE_CONST}"] = dict(cold_s=cold_s[names[0]], cold_jets_per_s=EMD_EVENTS / cold_s[names[0]],
                         launches_per_file=launches[names[0]], auc=aucs, gaps=wide_gaps)
    log("emd_slice", n_const=EMD_WIDE_CONST, reference_s=f"{time.perf_counter() - t0:.2f}",
        rows=EMD_WIDE_REF_ROWS, emd_gap_over_rtol=f"{gap:.3g}",
        max_rel_gap=f"{float(np.max(np.abs(scored - plain) / np.abs(plain))):.3g}",
        same_bits_as_cli=True,
        **{k: json.dumps(v) for k, v in facts[f"n{EMD_WIDE_CONST}"].items()})
    return total, facts


class _Echo(io.StringIO):
    """Keeps what is printed while passing it on."""

    def write(self, text):
        sys.__stdout__.write(text)
        return super().write(text)


def _jetid_history(printed, epochs=JETID_EPOCHS):
    """The per-epoch series of a training run's ticker lines (the jet-ID CLI
    writes no history file): ``epochs`` finite epochs, the loss falling."""
    import numpy as np
    rows = re.findall(r"Epoch (\d+)/(\d+): loss=(\S+) acc=(\S+)% val_loss=(\S+) ", printed)
    history = {"loss": [float(r[2]) for r in rows], "accuracy": [float(r[3]) for r in rows],
               "val_loss": [float(r[4]) for r in rows]}
    if [r[:2] for r in rows] != [(str(e + 1), str(epochs)) for e in range(epochs)] \
            or not all(np.isfinite(v).all() for v in history.values()) \
            or not history["loss"][-1] < history["loss"][0]:
        raise AssertionError(f"jet-ID training history {history}: want {epochs} finite "
                             "epochs with a falling loss")
    return history


def _jetid_report(results_path, device):
    """(view, labels, probabilities) of a results file and the numbers the
    CLI prints from them."""
    import pickle
    import numpy as np
    from atlasvae_torch.eval import auc_score, compo_matrix, discriminant
    from atlasvae_torch.plotting.performance import background_rejection
    with open(results_path, "rb") as f:
        v_view, v_labels, probs = pickle.load(f)
    n = len(v_labels)
    if probs.shape != (n, 2) or not np.isfinite(probs).all() \
            or np.abs(probs.sum(axis=1) - 1).max() > 1e-5:
        raise AssertionError(f"{results_path}: probabilities of shape {probs.shape} for {n} jets, "
                             f"finite {np.isfinite(probs).all()}")
    _, accuracy = compo_matrix(v_labels, (), probs)
    view, y, disc = discriminant(v_view, v_labels, probs)
    facts = dict(accuracy=float(accuracy), auc=float(auc_score(y, disc, view["weights"], device)),
                 rejection=background_rejection(y, disc, view["weights"], device=device))
    return v_view, v_labels, probs, facts


def _jetid_parity(config, inputs, labels, device):
    """The CUDA path against the plain CPU path at dropout 0, on the first
    batches of a sample: first-step gradients per leaf, and a 2-epoch loss
    series of train_classifier, at the bars of the config's precision."""
    import dataclasses
    import numpy as np
    import torch
    from atlasvae_torch.models import init_jetid
    from atlasvae_torch.train.checkpoint import tree_flatten, tree_map
    from atlasvae_torch.train.jetid_loop import batch_loss, strict_precision, train_classifier

    config = dataclasses.replace(config, dropout=0.0)
    n = JETID_PARITY_BATCHES * JETID_BATCH
    train = {k: v[:n] for k, v in inputs.items()}
    valid = {k: v[n:n + JETID_BATCH] for k, v in inputs.items()}
    cpu = torch.device("cpu")
    init = init_jetid(torch.Generator().manual_seed(21), config, device=cpu)
    grads = {}
    for d in (cpu, device):
        params = tree_map(lambda t, d=d: t.detach().to(d).requires_grad_(), init)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v[:JETID_BATCH])).to(d)
                 for k, v in train.items()}
        with strict_precision():   # as train_epoch holds it
            loss, _ = batch_loss(params, config, batch,
                                 torch.from_numpy(labels[:JETID_BATCH]).to(d),
                                 torch.ones(JETID_BATCH, device=d), None)
            grads[d] = [g.cpu() for g in torch.autograd.grad(loss, tree_flatten(params))]
    # leaves in tree_flatten's order (sorted keys), towers flagged
    in_tower = [key == "towers" for key in sorted(init) for _ in tree_flatten(init[key])]
    bf16 = config.compute_dtype == "bfloat16"
    grad_rel = {"dense": 0.0, "conv": 0.0}
    for leaf, (g_dev, g_cpu, conv) in enumerate(zip(grads[device], grads[cpu], in_tower)):
        scale, diff = float(g_cpu.abs().max()), float((g_dev - g_cpu).abs().max())
        kind, tol = ("conv", JETID_CONV_GRAD_TOL) if conv else ("dense", GRAD_SCALE_TOL)
        if bf16:
            tol = JETID_BF16_GRAD_TOL
        grad_rel[kind] = max(grad_rel[kind], diff / scale if scale > 0 else diff)
        if diff > tol * scale:
            raise AssertionError(f"jet-ID first-step gradient of {kind} leaf {leaf} "
                                 f"{tuple(g_cpu.shape)} differs: {diff} > {tol} * {scale}")
    hists = {}
    for d in (cpu, device):
        _, hists[d] = train_classifier(tree_map(lambda t, d=d: t.detach().to(d), init), config,
                                       train, labels[:n], valid, labels[n:n + JETID_BATCH],
                                       epochs=2, batch_size=JETID_BATCH, verbose=False)
    loss_rel = 0.0
    for key in ("loss", "val_loss"):
        got, want = np.asarray(hists[device][key]), np.asarray(hists[cpu][key])
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        loss_rel = max(loss_rel, rel)
        tol = JETID_BF16_LOSS_REL_TOL if bf16 else JETID_LOSS_REL_TOL
        if not rel <= tol:
            raise AssertionError(f"jet-ID {key}: CUDA {got} vs CPU {want}, rel {rel} > {tol}")
    return grad_rel, loss_rel


def phase_jetid(device, workdir, data_dir, bf16=False):
    """Train and serve the jet-ID CNN through the CLI, hold the CUDA path
    against the plain CPU path, then time and profile it: in float32
    (--mixed_precision OFF), or at the CLI's default, bfloat16 compute."""
    import numpy as np
    import torch
    from atlasvae_torch.cli import jetid as cli_jetid
    from atlasvae_torch.models import JetIDConfig, init_jetid
    from atlasvae_torch.train.checkpoint import load_pytree
    from atlasvae_torch.train.jetid_loop import (predict_classifier, train_classifier,
                                                 train_classifier_streaming)

    phase = "jetid_bf16" if bf16 else "jetid"
    form = "_bf16" if bf16 else ""
    os.makedirs(workdir)
    out_dir = os.path.join(workdir, "out")
    # --synthetic writes its files under the data directory, shared by the
    # jet-ID phases, which come last: the setting stays
    os.environ["ATLASVAE_DATA_DIR"] = data_dir
    args = (JETID_BF16_ARGS if bf16 else JETID_ARGS) + ["--output_dir", out_dir,
                                                        "--device", str(device)]

    # 1. train
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(_Echo()) as printed:
        cli_jetid.main(args + ["--n_epochs", str(JETID_EPOCHS)])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = counters()
    history = _jetid_history(printed.getvalue())
    for name in ("model.npz", "valid_results.pkl", "image_scale.pkl", "scaler_RobustScaler.pkl"):
        if not os.path.isfile(os.path.join(out_dir, name)):
            raise AssertionError(f"the jet-ID training run did not write {name}")
    v_view, v_labels, probs, _ = _jetid_report(os.path.join(out_dir, "valid_results.pkl"), device)
    n_valid = len(v_labels)
    if n_valid < JETID_TRAIN:   # the CLI then trains on half the sample, not on --n_train jets
        raise AssertionError(f"only {n_valid} validation jets: the sample is smaller than planned")
    steps = -(-JETID_TRAIN // JETID_BATCH)
    valid_batches = -(-n_valid // JETID_BATCH)
    chunks = -(-n_valid // JETID_CHUNK)
    # K5/K6 of this precision on their register routes; every other form
    # and route of them not at all
    want = dict.fromkeys(CONV_COUNTERS, 0)
    want["fused_conv" + form] = JETID_EPOCHS * (steps + valid_batches) + chunks
    want["fused_conv_backward" + form] = JETID_EPOCHS * steps
    for name, count in want.items():
        if train_launches[name] != count:
            raise AssertionError(f"{name} launched {train_launches[name]} times in the training "
                                 f"run, want {count} ({JETID_EPOCHS} epochs of {steps} steps and "
                                 f"{valid_batches} validation batches, {chunks} predict chunks)")
    log(phase, train_cli_s=f"{train_s:.3f}", valid_jets=n_valid, steps_per_epoch=steps,
        valid_batches=valid_batches, predict_chunks=chunks, launches=json.dumps(train_launches),
        history=json.dumps(history))

    # 2. serve
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli_jetid.main(args + ["--n_epochs", "0", "--model_in", "model.npz", "--results_out",
                           "served.pkl"])
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    serve_launches = counters()
    want = dict.fromkeys(CONV_COUNTERS, 0)
    want["fused_conv" + form] = chunks
    if any(serve_launches[name] != count for name, count in want.items()):
        raise AssertionError(f"serving launched {serve_launches}: want fused_conv{form} {chunks} "
                             "times on its register route, no other form or route and no "
                             "backward")
    _, served_labels, served, report = _jetid_report(os.path.join(out_dir, "served.pkl"), device)
    gap = float(np.abs(served - probs).max())
    if not np.array_equal(served_labels, v_labels) or gap > 1e-6:
        raise AssertionError(f"served probabilities differ from the training run's by {gap}")
    config = JetIDConfig(n_classes=2, scalars=("HLVs",), scalar_dims=(v_view["HLVs"].shape[1],),
                         nn_type="CNN", images=("images",),
                         image_shapes=((JETID_IMAGE, JETID_IMAGE),), dropout=0.1, l2=1e-7,
                         compute_dtype="bfloat16" if bf16 else "float32")
    inputs = {"HLVs": v_view["HLVs"], "images": v_view["images"]}
    cpu = torch.device("cpu")
    cpu_params = load_pytree(os.path.join(out_dir, "model.npz"),
                             init_jetid(torch.Generator().manual_seed(0), config, device=cpu))
    ref = predict_classifier(cpu_params, config, {k: v[:JETID_REF_ROWS] for k, v in inputs.items()})
    ref_gap = float(np.abs(served[:JETID_REF_ROWS] - ref).max())
    rtol, atol = (0.0, JETID_BF16_PROB_TOL) if bf16 else (1e-4, 1e-5)
    if served.dtype != np.float32 or not np.allclose(served[:JETID_REF_ROWS], ref, rtol=rtol,
                                                     atol=atol):
        raise AssertionError(f"served probabilities ({served.dtype}) differ from the plain CPU "
                             f"path: {ref_gap} over rtol {rtol} / atol {atol}")
    log(phase, serve_cli_s=f"{serve_s:.3f}", launches=json.dumps(serve_launches),
        same_bits_as_training_run=bool(np.array_equal(served, probs)), max_gap=gap,
        cpu_ref_rows=JETID_REF_ROWS, cpu_ref_max_gap=ref_gap,
        accuracy=f"{report['accuracy']:.2f}", auc=f"{report['auc']:.4f}",
        rejection=json.dumps(report["rejection"]), note="synthetic data: no physics result")

    # 3. CUDA against the plain CPU path at dropout 0
    t0 = time.perf_counter()
    grad_rel, loss_rel = _jetid_parity(config, inputs, v_labels, device)
    log(phase, parity_s=f"{time.perf_counter() - t0:.2f}", grad_rel=json.dumps(grad_rel),
        loss_rel=loss_rel)

    # 4. a warm timed run on JETID_TRAIN of these jets, then a profiled epoch
    train_in = {k: v[:JETID_TRAIN] for k, v in inputs.items()}
    valid_in = {k: v[JETID_TRAIN:JETID_TRAIN + 50_000] for k, v in inputs.items()}
    train_y, valid_y = v_labels[:JETID_TRAIN], v_labels[JETID_TRAIN:JETID_TRAIN + 50_000]
    stamps = []

    def loads():
        torch.cuda.synchronize()
        stamps.append((time.perf_counter(), counters()))
        yield train_in, train_y, None
        torch.cuda.synchronize()
        stamps.append((time.perf_counter(), counters()))

    params = init_jetid(torch.Generator(device).manual_seed(0), config, device=device)
    reset_counters()
    train_classifier_streaming(params, config, loads, valid_in, valid_y, JETID_EPOCHS,
                               JETID_BATCH, verbose=False)
    spans = [(stamps[2 * e], stamps[2 * e + 1]) for e in range(JETID_EPOCHS)]
    warm_s = sum(end[0] - start[0] for start, end in spans[1:])
    per_step = {name: (spans[-1][1][1][name] - spans[-1][0][1][name]) / steps
                for name in ("fused_conv" + form, "fused_conv_backward" + form)}
    predict_classifier(params, config, inputs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    predict_classifier(params, config, inputs)
    torch.cuda.synchronize()
    predict_s = time.perf_counter() - t0
    idle, rows, conv_ms = profile_slice(
        lambda: (train_classifier(params, config, train_in, train_y, valid_in, valid_y, epochs=1,
                                  batch_size=JETID_BATCH, verbose=False), torch.cuda.synchronize()),
        phase=phase + " profile")
    busy_ms = sum(r[0] for r in rows) / 1e3
    facts = dict(train_jets=JETID_TRAIN, steps_per_epoch=steps,
                 warm_jets_per_s=JETID_TRAIN * (JETID_EPOCHS - 1) / warm_s,
                 ms_per_step=warm_s / (steps * (JETID_EPOCHS - 1)) * 1e3,
                 launches_per_step=per_step, predict_jets=n_valid,
                 predict_jets_per_s=n_valid / predict_s, idle_share=idle,
                 profiled_busy_ms=busy_ms, block2_conv_ms=conv_ms,
                 block2_conv_share=conv_ms / busy_ms, grad_rel=grad_rel, loss_rel=loss_rel,
                 **report)
    log(phase, **{k: (json.dumps(v) if isinstance(v, dict) else v) for k, v in facts.items()})
    total = {k: train_launches[k] + serve_launches[k] for k in train_launches}
    return total, facts


def jetid_stream(device, workdir, data_dir):
    """One short bf16 FCN run through the CLI that streams its training
    slice in chunks (--generator ON) and weights each chunk with the
    flattening scheme: its epochs, its files and its probabilities.  The
    FCN runs no kernel of ours (dense layers are cuBLAS), so every counter
    stays 0."""
    from atlasvae_torch.cli import jetid as cli_jetid
    os.environ["ATLASVAE_DATA_DIR"] = data_dir
    out_dir = os.path.join(workdir, "out")
    reset_counters()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(_Echo()) as printed:
        cli_jetid.main(JETID_STREAM_ARGS + ["--n_epochs", str(JETID_STREAM_EPOCHS),
                                            "--output_dir", out_dir, "--device", str(device)])
    wall_s = time.perf_counter() - t0
    launches = counters()
    history = _jetid_history(printed.getvalue(), JETID_STREAM_EPOCHS)
    _, v_labels, _, report = _jetid_report(os.path.join(out_dir, "valid_results.pkl"), device)
    degenerate = printed.getvalue().count("degenerate")
    if any(launches.values()) or degenerate:
        raise AssertionError(f"streamed FCN run: launches {launches}, {degenerate} chunks whose "
                             "weight scheme degenerated")
    log("jetid_bf16", stream_cli_s=f"{wall_s:.3f}", epochs=JETID_STREAM_EPOCHS,
        valid_jets=len(v_labels), history=json.dumps(history), accuracy=f"{report['accuracy']:.2f}",
        auc=f"{report['auc']:.4f}", note="synthetic data: no physics result")


def wrapper_host_ms(blocks=20, calls=1000):
    """Host time (ms) of one canonical fused_mlp_apply call (the decoder
    10->20/40/80->12, K1's fused body) on one row: the wall time of a loop
    of calls over their number, the median of ``blocks`` such loops (the
    host's other work stretches single loops).  At one row each kernel
    takes the card less time than its call takes the host, so the loop
    never waits on the card."""
    import torch
    from atlasvae_torch.models import VAEConfig, init_vae
    from atlasvae_torch.ops import fused_mlp
    device = torch.device("cuda")
    params = init_vae(torch.Generator(device).manual_seed(3), VAEConfig(), device=device)
    layers = params["decoder"]["hidden"] + [params["decoder"]["out"]]
    z = torch.randn((1, 10), device=device)
    per_call = []
    with torch.inference_mode():
        for _ in range(50):
            fused_mlp.fused_mlp_apply(layers, z)
        torch.cuda.synchronize()
        for _ in range(blocks):
            t0 = time.perf_counter()
            for _ in range(calls):
                fused_mlp.fused_mlp_apply(layers, z)
            per_call.append((time.perf_counter() - t0) / calls * 1e3)
            torch.cuda.synchronize()
    return sorted(per_call)[blocks // 2]


def _vae_seed_case(seed):
    """test_vae_apply_on_cuda_matches_cpu's inputs at another seed: a
    canonical VAE at random init on the CPU, 777 rows and their noise."""
    import torch
    from atlasvae_torch.models import VAEConfig, init_vae
    gen = torch.Generator().manual_seed(seed)
    params = init_vae(gen, VAEConfig(), device="cpu")
    return params, torch.randn((777, 12), generator=gen), torch.randn((777, 10), generator=gen)


def _rows_over(got, want):
    """Rows of got with an element over atol + rtol |want|, over all outputs."""
    import torch
    over = torch.zeros(want[0].shape[0], dtype=torch.bool)
    for g, w in zip(got, want):
        over |= ((g.double() - w.double()).abs() > ATOL + RTOL * w.double().abs()).any(1)
    return int(over.sum())


def _sha(tensors):
    import hashlib
    digest = hashlib.sha1()
    for t in tensors:
        digest.update(t.detach().cpu().contiguous().numpy().tobytes())
    return digest.hexdigest()[:16]


def phase_seeds(device, trials=SEED_TRIALS):
    """vae_apply (K2 encoder, K1 decoder) on the card against the CPU's
    float32 path over many seeded canonical VAEs at random init, at the
    bar of test_vae_apply_on_cuda_matches_cpu.  A hit is a seed where the
    two part; it is counted with the rows over the bar on each side against
    the same model in float64 on the CPU, so that a kernel fault (the card
    alone far from float64) and a badly conditioned draw (both far) tell
    apart.  Seed 3 is the test's own case: the sha1 of its outputs on each
    side is printed, to compare between processes, and the CPU side is run
    again on the same tensors (do two runs in one process part?) and on
    inputs and weights one float off 16-byte alignment, beside the settings
    that steer the CPU's float32 products.  Fails if
    the card gives other bits on a second call or a non-finite value."""
    import torch
    from atlasvae_torch.models import vae_apply
    from atlasvae_torch.train.checkpoint import tree_map

    def shifted(t):   # the same values at a 4-byte offset from any 16-byte boundary
        buf = torch.empty(t.numel() + 1, dtype=t.dtype)
        view = buf[1:].view(t.shape)
        view.copy_(t)
        return view

    start = time.perf_counter()
    hits, worst, far = [], 0.0, [0, 0]
    for seed in range(3, 3 + trials):
        params, x, noise = _vae_seed_case(seed)
        cpu = vae_apply(params, x, noise=noise)
        f64 = vae_apply(tree_map(lambda t: t.double(), params), x.double(), noise=noise.double())
        on_card = tree_map(lambda t: t.to(device), params)
        with torch.inference_mode():
            card = [t.cpu() for t in vae_apply(on_card, x.to(device), noise=noise.to(device))]
            if seed == 3:
                again = [t.cpu() for t in vae_apply(on_card, x.to(device), noise=noise.to(device))]
                if not all(torch.equal(a, b) for a, b in zip(card, again)):
                    raise AssertionError("seeds: vae_apply on the card gave other bits on a "
                                         "second call at seed 3")
                cpu_shifted = vae_apply(tree_map(shifted, params), shifted(x), noise=shifted(noise))
                cpu_again = vae_apply(params, x, noise=noise)
                cpu_f64_gap = max(float((a.double() - b).abs().max()) for a, b in zip(cpu, f64))
                log("seeds", seed=3, card_sha=_sha(card), cpu_sha=_sha(cpu),
                    cpu_f64_gap=f"{cpu_f64_gap:.3e}",
                    cpu_same_bits_again=all(torch.equal(a, b) for a, b in zip(cpu, cpu_again)),
                    matmul_precision=torch.get_float32_matmul_precision(),
                    cpu_capability=torch.backends.cpu.get_cpu_capability(),
                    threads=torch.get_num_threads(),
                    cpu_shifted_sha=_sha(cpu_shifted),
                    cpu_same_bits_shifted=all(torch.equal(a, b) for a, b in zip(cpu, cpu_shifted)),
                    rows_card_vs_cpu=_rows_over(card, cpu))
        if not all(bool(torch.isfinite(t).all()) for t in card):
            raise AssertionError(f"seeds: non-finite output on the card at seed {seed}")
        gap = max(float((a.double() - b.double()).abs().max()) for a, b in zip(card, cpu))
        worst = max(worst, gap)
        rows, card_f64, cpu_f64 = _rows_over(card, cpu), _rows_over(card, f64), _rows_over(cpu, f64)
        far[0] += card_f64 > 0
        far[1] += cpu_f64 > 0
        if rows:
            hits.append(dict(seed=seed, rows=rows, card_vs_f64=card_f64, cpu_vs_f64=cpu_f64,
                             gap=gap))
    log("seeds", trials=trials, hits=len(hits), max_gap=f"{worst:.3e}",
        seeds_card_over_f64=far[0], seeds_cpu_over_f64=far[1],
        seconds=f"{time.perf_counter() - start:.1f}", first_hits=json.dumps(hits[:12]))


@contextlib.contextmanager
def _rates_of(module, replay=None):
    """``module.get_rates`` recorded (the card's, in call order), or, with
    ``replay``, handing back a recorded run's rates for the same inputs."""
    import numpy as np
    real, seen = module.get_rates, []

    def get_rates(y_true, x_loss, weights, *args, **kwargs):
        if replay is None:
            rates = real(y_true, x_loss, weights, *args, **kwargs)
        else:
            loss, rates = replay[len(seen)]
            if not np.array_equal(loss, x_loss):
                raise AssertionError("the CPU scan asked for the rates of other scores")
        seen.append((np.array(x_loss), rates))
        return rates

    module.get_rates = get_rates
    try:
        yield seen
    finally:
        module.get_rates = real


def _aae_scan_check(numbers, scan_2d, device):
    """The card's scan against the CPU's on the same scores and sample, the
    CPU handed the rates of a second card run (held to the CPU's own
    beside): the same best cut, every local sigma within AAE_SIGMA_TOL.  The
    card's ROC sums are a parallel scan whose float32 rounding can part by an
    ulp from run to run, so the CLI's own run is compared with the second
    one by its best cut's thresholds, and its efficiencies within the ROC
    bar.  Then the batched scan alone on the card: CUDA-event ms, launches,
    device busy ms and bound."""
    import numpy as np
    import torch
    from atlasvae_torch.eval import aae_eval, bump
    from atlasvae_torch.eval.roc import get_rates
    from atlasvae_torch.stats import batched_local_sigma
    cpu = torch.device("cpu")
    y_true, x_loss, sample = numbers["y_true"], numbers["x_loss"], numbers["sample"]
    scan = numbers["scan"]
    with _rates_of(aae_eval) as card_rates:
        if scan_2d:
            again = aae_eval._scan_2d_numbers(y_true, x_loss, sample, device=device)
        else:
            again = aae_eval._scan_numbers(y_true, x_loss["Autoencoder"], "Autoencoder",
                                           sample, device=device)
    with _rates_of(aae_eval, replay=card_rates):
        if scan_2d:
            on_cpu = aae_eval._scan_2d_numbers(y_true, x_loss, sample, device=cpu)
        else:
            on_cpu = aae_eval._scan_numbers(y_true, x_loss["Autoencoder"], "Autoencoder",
                                            sample, device=cpu)
    roc_gap = 0.0
    for loss, (fpr, tpr, thr) in card_rates:
        c_fpr, c_tpr, c_thr = get_rates(y_true, loss, sample["weights"], device=cpu)
        if not np.array_equal(thr, c_thr):
            raise AssertionError("ROC thresholds on the card and the CPU differ")
        roc_gap = max(roc_gap, float(np.abs(fpr - c_fpr).max()), float(np.abs(tpr - c_tpr).max()))
    rtol, atol = AAE_SIGMA_TOL
    sigma_gap = float(np.max(np.abs(again["loc_sigma"] - on_cpu["loc_sigma"])
                             - (atol + rtol * np.abs(on_cpu["loc_sigma"]))))
    repeat_gap = max(abs(float(scan["best"][k]) - float(again["best"][k]))
                     for k in ("sig_eff", "bkg_eff"))
    same_best = again["best"] == on_cpu["best"] and scan["best"]["cuts"] == again["best"]["cuts"]
    if not (same_best and sigma_gap <= 0 and roc_gap <= 1e-4 and repeat_gap <= 1e-4):
        raise AssertionError(f"aae scan (2-D {scan_2d}) card against CPU: best cut "
                             f"{scan['best']} / {again['best']} / {on_cpu['best']} (CLI run, "
                             f"card, CPU), loc sigma over rtol {rtol} / atol {atol} by "
                             f"{sigma_gap:.3g}, ROC rates (percent) {roc_gap:.3g}, the CLI's "
                             f"run's efficiencies {repeat_gap:.3g} from the card's again")
    data_mat, bkg_mat = scan["hists"]
    widths, steps = bump._WIDTHS, bump._STEPS
    dm, bm = (torch.as_tensor(m, dtype=torch.float32, device=device) for m in (data_mat, bkg_mat))
    local = lambda: batched_local_sigma(dm, bm, widths, steps, device=device)
    local_ms = time_ms(local, iters=5, warmup=1)
    n_launch, busy = launches_and_busy(local)
    rows, cols = data_mat.shape
    n_win = sum(valid_windows(b, widths, steps) for b in bkg_mat)
    n_bins = int((bkg_mat > 0).sum())
    local_bytes = 2 * rows * cols * 4 + rows * (4 + 8 + 8) + rows * cols * 4
    (local_bound, local_by), flop = bound_scan(n_win, n_bins, local_bytes)
    return dict(matrix=[rows, cols], ms=local_ms, launches=n_launch, busy_ms=busy,
                windows=n_win, bins=n_bins, flop=flop, bound_ms=local_bound, bound_by=local_by,
                sigma_excess_over_bar=sigma_gap, roc_gap_percent=roc_gap,
                repeat_eff_gap_percent=repeat_gap)


def phase_aae(device, workdir, data_dir):
    """The OE-AAE through its CLI: one GAN cycle at the reference's width,
    timed and profiled; the card against the CPU on a 10,000-jet slice;
    the evaluation's numbers (cli/aae.py::_signal_numbers, 1-D and 2-D
    scans) against the CPU; cli/score.py --model_type aae against the CPU."""
    import pickle
    import numpy as np
    import torch
    from atlasvae_torch.cli import aae as cli_aae, score
    from atlasvae_torch.data import HLV_LIST, hdf5
    from atlasvae_torch.eval.roc import get_rates, _trapezoid
    from atlasvae_torch.models import AAEConfig, init_aae
    from atlasvae_torch.train import aae_loop
    from atlasvae_torch.train.checkpoint import load_pytree

    os.environ["ATLASVAE_DATA_DIR"] = data_dir
    out_dir = os.path.join(workdir, "out")
    argv = AAE_ARGS + ["--output_dir", out_dir, "--device", str(device)]
    cpu = torch.device("cpu")
    quiet = lambda: contextlib.redirect_stdout(io.StringIO())

    # 1. training through the CLI, then the same load timed and profiled
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli_aae.main(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = counters()
    with open(os.path.join(out_dir, "history.pkl"), "rb") as f:
        history = pickle.load(f)
    sizes = {k: len(v) for k, v in history.items()}
    finite = all(np.isfinite([e[2] for e in v]).all() for v in history.values())
    if any(launches.values()) or sizes["QCD-AE Loss"] != 105 or sizes["Disc Loss"] != 10 \
            or not finite:
        raise AssertionError(f"aae: launches {launches} (the AAE runs no kernel of ours), "
                             f"history sizes {sizes}, finite {finite}")
    config = AAEConfig(input_dim=len(HLV_LIST), ae_layers=(100, 100, 100))
    model_path = os.path.join(out_dir, "AAE.npz")
    trained = load_pytree(model_path, init_aae(torch.Generator().manual_seed(0), config,
                                               device=device))
    log("aae", cli_s=f"{cli_s:.3f}", launches=json.dumps(launches), history_sizes=json.dumps(sizes),
        last=json.dumps({k: v[-1][2] for k, v in history.items() if v}))

    parsed = cli_aae.build_parser().parse_args(argv)
    cli_aae._wire_paths(parsed)
    with quiet():
        train_gen, _, _ = cli_aae._make_generator(parsed, list(HLV_LIST), cli_aae.CUTS, None, None)
        load = train_gen[0]
    jets = len(load[0]["weights"])
    fresh = lambda dev: init_aae(torch.Generator().manual_seed(0), config, device=dev)
    timed_dir = os.path.join(workdir, "timed")
    os.makedirs(timed_dir)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with quiet():
        aae_loop.train_aae(fresh(device), [load], 1, AAE_BATCH, timed_dir, hist_file="",
                           model_out="", lamb=1.0, beta=1.0, lr=parsed.lr)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    batches = aae_loop.pack_load(load, AAE_BATCH, device)
    n_batches = batches[0].shape[0]
    ae, disc = aae_loop.gan_states(fresh(device), device)
    fns = aae_loop.make_aae_step_fns(1.0, 1.0, lr=parsed.lr)
    perm = np.arange(n_batches)
    step_ms = {}
    for name, fn in zip(("AE", "Disc", "AAE"), fns):
        fn(ae, disc, perm, batches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            fn(ae, disc, perm, batches)
        torch.cuda.synchronize()
        step_ms[name] = (time.perf_counter() - t0) * 1e3 / (2 * n_batches)
    idle, _, _ = profile_slice(lambda: (fns[0](ae, disc, perm, batches), torch.cuda.synchronize()),
                               phase="aae profile")

    # 2. card against CPU: the whole schedule on a 10,000-jet slice
    part = tuple({k: v[:AAE_PARITY_JETS] for k, v in s.items()} for s in load)
    hists = {}
    for side, dev in (("card", device), ("cpu", cpu)):
        with quiet():
            _, hists[side] = aae_loop.train_aae(fresh(dev), [part], 1, AAE_BATCH, timed_dir,
                                                    hist_file="", model_out="", lamb=1.0,
                                                    beta=1.0, lr=parsed.lr)
    w = aae_loop.pack_load(part, AAE_BATCH, cpu)
    share = float(max(w[2].max(), w[3].max()) / (2 * w[2].sum(1) + w[3].sum(1)).min())
    loss_rel = max(float(np.max(np.abs(np.subtract([e[2] for e in hists["card"][k]],
                                                   [e[2] for e in hists["cpu"][k]]))
                                / np.abs([e[2] for e in hists["cpu"][k]])))
                   for k in hists["cpu"] if hists["cpu"][k] and k != "Disc Accuracy")
    acc_gap = max(abs(a[2] - b[2]) for a, b in zip(hists["card"]["Disc Accuracy"],
                                                   hists["cpu"]["Disc Accuracy"]))
    if loss_rel > AAE_REL_TOL or acc_gap > share * (1 + 1e-6):
        raise AssertionError(f"aae training, card against CPU: loss series {loss_rel:.3g} "
                             f"(bar {AAE_REL_TOL}), Disc Accuracy {acc_gap:.3g} (bar one jet's "
                             f"weight share, {share:.3g})")
    log("aae", jets_per_epoch=jets, steps_per_epoch=n_batches, steps=AAE_EPOCHS * n_batches,
        warm_train_s=f"{warm_s:.3f}", train_jets_per_s=f"{AAE_EPOCHS * jets / warm_s:.0f}",
        ms_per_step=json.dumps({k: round(v, 4) for k, v in step_ms.items()}),
        ae_epoch_idle_share=f"{idle:.4f}", card_vs_cpu_loss_rel=f"{loss_rel:.3g}",
        card_vs_cpu_disc_accuracy=f"{acc_gap:.3g}", one_jet_share=f"{share:.3g}")

    # 3. the evaluation's numbers, both scans, through the CLI's own function
    eval_args = cli_aae.build_parser().parse_args([])
    eval_args.n_valid = eval_args.n_sig = AAE_EVENTS
    facts = {}
    for scan_2d in (False, True):
        eval_args.scan_2d = "ON" if scan_2d else "OFF"
        reset_counters()
        t0 = time.perf_counter()
        with quiet():
            numbers = cli_aae._signal_numbers(eval_args, trained, "top-Geneva", list(HLV_LIST),
                                              cli_aae.CUTS, None, None, device)
        wall_ms = (time.perf_counter() - t0) * 1e3
        if any(counters().values()) or numbers["scan"] is None:
            raise AssertionError(f"aae evaluation: launches {counters()}, scan {numbers['scan']}")
        check = _aae_scan_check(numbers, scan_2d, device)
        scan, y_true = numbers["scan"], numbers["y_true"]
        auc = {k: round(float(_trapezoid(r[1], r[0]) / 1e4), 6) for k, r in
               ((k, get_rates(y_true, v, numbers["sample"]["weights"], device=device))
                for k, v in numbers["x_loss"].items())}
        name = "scan_2d" if scan_2d else "scan"
        facts[name] = check
        log("aae", evaluate=name, events=len(y_true), signal=int((y_true == 0).sum()),
            wall_ms=f"{wall_ms:.1f}",
            steps_ms=json.dumps({k: round(v, 3) for k, v in numbers["wall_ms"].items()}),
            best=json.dumps({"cuts": {k: float(v) for k, v in scan["best"]["cuts"].items()},
                             "sig_eff": float(scan["best"]["sig_eff"]),
                             "bkg_eff": float(scan["best"]["bkg_eff"])}),
            loc_sigma_max=f"{float(np.nanmax(scan['loc_sigma'])):.6g}",
            hunter_loc_sigma=json.dumps([float(h["loc_sigma"]) for h in scan["hunters"]]),
            auc=json.dumps(auc),
            **{k: (json.dumps(v) if isinstance(v, list) else
                   f"{v:.6g}" if isinstance(v, float) else v) for k, v in check.items()})

    # 4. cli/score.py --model_type aae on the trained checkpoint
    scores, rate = {}, None
    for side, dev in (("card", device), ("cpu", cpu)):
        path = os.path.join(workdir, f"scores_{side}.h5")
        reset_counters()
        t0 = time.perf_counter()
        with quiet():
            score.main(["--data", "QCD-Geneva", "--model_in", model_path, "--model_type", "aae",
                        "--chunk", str(SLICE_CHUNK), "--output", path, "--device", str(dev)])
        if side == "card":
            torch.cuda.synchronize()
            rate = AAE_EVENTS / (time.perf_counter() - t0)
            if any(counters().values()):
                raise AssertionError(f"cli/score.py --model_type aae launched {counters()}")
        with hdf5.File(path, "r") as f:
            scores[side] = {k: f[k][:] for k in f}
    gaps = {k: float(np.max(np.abs(v - scores["cpu"][k])
                            - (AAE_SCORE_TOL + AAE_SCORE_TOL * np.abs(scores["cpu"][k]))))
            for k, v in scores["card"].items()}
    rows = {k: len(v) for k, v in scores["card"].items()}
    if max(gaps.values()) > 0 or set(rows.values()) != {AAE_EVENTS} or \
            not all(np.isfinite(v).all() for v in scores["card"].values()):
        raise AssertionError(f"aae scores, card against CPU: excess over rtol/atol "
                             f"{AAE_SCORE_TOL} {gaps}, rows {rows}")
    log("aae", score="--model_type aae", jets_per_s=f"{rate:.0f}",
        excess_over_bar=json.dumps({k: round(v, 8) for k, v in gaps.items()}))
    return launches, dict(train_jets_per_s=AAE_EPOCHS * jets / warm_s, ms_per_step=step_ms,
                          idle_share=idle, score_jets_per_s=rate, trained=trained,
                          parity_load=part, fresh=fresh, lr=parsed.lr, **facts)


def feature_removal_run(device, workdir, data_dir):
    """cli/jetid.py --NN_type FCN --feature_removal ON on the card: the
    ranking of every HLV.  The FCN runs no kernel of ours (cuBLAS dense
    layers), so every counter stays 0."""
    from atlasvae_torch.cli import jetid as cli_jetid
    from atlasvae_torch.data import HLV_LIST
    os.environ["ATLASVAE_DATA_DIR"] = data_dir
    reset_counters()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        cli_jetid.main(FEATURE_REMOVAL_ARGS + ["--output_dir", workdir, "--device", str(device)])
    wall_s = time.perf_counter() - t0
    ranking = printed.getvalue().split("FEATURE-ABLATION RANKING (accuracy drop when "
                                       "removed):\n")[-1].splitlines()[:len(HLV_LIST)]
    rows = [line.split() for line in ranking]
    if any(counters().values()) or sorted(r[0] for r in rows if r) != sorted(HLV_LIST):
        raise AssertionError(f"--feature_removal ON: launches {counters()}, ranking {ranking}")
    log("feature_removal", cli_s=f"{wall_s:.3f}",
        ranking=json.dumps({r[0]: float(r[1]) for r in rows}))


def _largest_gap(got, want, rtol, atol, what):
    """max |got - want|; raises where it passes atol + rtol * |want|."""
    import numpy as np
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape or not np.allclose(got, want, rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: shapes {got.shape} {want.shape}, largest gap "
                             f"{np.abs(got - want).max() if got.shape == want.shape else None} "
                             f"over rtol {rtol} / atol {atol}")
    return float(np.abs(got - want).max()) if got.size else 0.0


def phase_sweep(device, workdir, data_dir, train_facts):
    """cli/sweep.py --entry vae --vmap ON over SWEEP_GRID (4 lanes of the
    canonical model) on the train phase's files, with the counters set to 0
    just before: K2 and K3 on their fused bodies only, 4 calls each a step
    a lane, and K2 and K1 twice each in a lane's validation; every lane's
    history and weights; then the same grid with --vmap OFF (one cli.vae
    run a grid point), each lane equal to it bit for bit; wall seconds,
    jets/s a lane and the data preparation's seconds of each run."""
    import pickle
    import numpy as np
    import torch
    from atlasvae_torch.cli import sweep, vae as cli_vae
    from atlasvae_torch.data import ensure_synthetic_registry

    ensure_synthetic_registry(data_dir, n_events=TRAIN_EVENTS, n_const_max=20,
                              names=["QCD-Geneva", "OoD-H"], seed=0)
    lanes = len(SWEEP_TAGS)
    prep = []
    make_generators = cli_vae._make_generators

    def timed_prep(*args, **kwargs):
        t0 = time.perf_counter()
        out = make_generators(*args, **kwargs)
        prep.append((time.perf_counter() - t0, len(out[0]), len(out[1])))
        return out

    runs = {}
    cli_vae._make_generators = timed_prep
    try:
        for mode in ("ON", "OFF"):
            del prep[:]
            out_dir = os.path.join(workdir, mode)
            reset_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                sweep.main(["--entry", "vae", "--vmap", mode, "--output_dir", out_dir]
                           + SWEEP_GRID + ["--"] + SWEEP_ARGS + ["--device", str(device)])
            torch.cuda.synchronize()
            runs[mode] = dict(wall_s=time.perf_counter() - t0, launches=counters(),
                              prep=list(prep), out_dir=out_dir)
    finally:
        cli_vae._make_generators = make_generators

    jets, steps = train_facts["jets_per_epoch"], train_facts["steps_per_epoch"]
    for mode, run in runs.items():
        if any(n_train != 1 or n_valid != 1 for _, n_train, n_valid in run["prep"]) or \
                len(run["prep"]) != (1 if mode == "ON" else lanes):
            raise AssertionError(f"--vmap {mode}: data preparations (seconds, train loads, "
                                 f"valid loads) {run['prep']}: want one load each, "
                                 f"{'once' if mode == 'ON' else 'once a lane'}")
        want = dict.fromkeys(KERNELS, 0)
        want["stack_backward"] = lanes * SWEEP_EPOCHS * 4 * steps
        want["stack_forward"] = lanes * SWEEP_EPOCHS * (4 * steps + 2)
        want["fused_mlp"] = lanes * SWEEP_EPOCHS * 2
        if run["launches"] != want:
            raise AssertionError(f"--vmap {mode} launched {run['launches']}, want {want} "
                                 f"({lanes} lanes, {SWEEP_EPOCHS} epochs of {steps} steps and one "
                                 "validation batch)")
    for tag in SWEEP_TAGS:
        loaded = {}
        for mode in ("ON", "OFF"):
            with open(os.path.join(runs[mode]["out_dir"], tag, "history.pkl"), "rb") as f:
                history = pickle.load(f)
            with np.load(os.path.join(runs[mode]["out_dir"], tag, "model.npz")) as npz:
                loaded[mode] = history, {k: npz[k] for k in npz.files}
        (history, weights), (seq_history, seq_weights) = loaded["ON"], loaded["OFF"]
        if list(history) != list(seq_history) or any(
                len(v) != SWEEP_EPOCHS or not np.isfinite(v).all() for v in history.values()):
            raise AssertionError(f"{tag}: history {history}, sequential {seq_history}")
        # the lanes run the same kernels in the same order as the
        # sequential runs: any difference is one lane leaking into another
        pairs = [(f"history {k}", history[k], seq_history[k]) for k in history] + \
            [(k, weights.get(k), seq_weights[k]) for k in seq_weights]
        for what, got, want in pairs:
            if got is None or not np.array_equal(np.asarray(got), np.asarray(want)):
                raise AssertionError(f"{tag} {what}: --vmap ON differs from OFF: {got} {want}")
        if set(weights) != set(seq_weights):
            raise AssertionError(f"{tag}: weights {sorted(weights)} against {sorted(seq_weights)}")
    for mode, run in runs.items():
        log("sweep", vmap=mode, lanes=lanes, epochs=SWEEP_EPOCHS, steps_per_epoch=steps,
            wall_s=f"{run['wall_s']:.3f}",
            lane_jets_per_s=f"{SWEEP_EPOCHS * jets / run['wall_s']:.0f}",
            data_prep_s=json.dumps([round(p[0], 3) for p in run["prep"]]),
            launches=json.dumps(run["launches"]))
    log("sweep", lanes_vs_sequential="same_bits",
        wall_ratio_on_over_off=f"{runs['ON']['wall_s'] / runs['OFF']['wall_s']:.4f}")
    return runs["ON"]["launches"], dict(wall_s=runs["ON"]["wall_s"],
                                        seq_wall_s=runs["OFF"]["wall_s"],
                                        lane_jets_per_s=SWEEP_EPOCHS * jets / runs["ON"]["wall_s"])


def phase_kfold(device, workdir, data_dir):
    """cli/jetid.py --NN_type CNN --n_folds 3 --vmap_folds ON at the CLI's
    default widths and precision, with the counters set to 0 just before:
    K5 and K6 on their bf16 register routes only, K5 once a fold-step,
    validation batch and cross_valid predict chunk, K6 once a fold-step;
    the three fold files, the CV accuracy line and valid_results.pkl; then
    --vmap_folds OFF (the folds one after another), the fold weights and CV
    probabilities held to it; wall seconds and ms a fold-step of each run."""
    import pickle
    import numpy as np
    import torch
    from atlasvae_torch.cli import jetid as cli_jetid
    from atlasvae_torch.train import jetid_loop

    os.environ["ATLASVAE_DATA_DIR"] = data_dir
    epochs = []
    train_epoch = jetid_loop.train_epoch

    def timed_epoch(state, config, lr, generator, inputs, labels, weights, mesh=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train_epoch(state, config, lr, generator, inputs, labels, weights, mesh)
        torch.cuda.synchronize()
        epochs.append((time.perf_counter() - t0, labels.shape[0]))
        return out

    runs = {}
    jetid_loop.train_epoch = timed_epoch
    try:
        for mode in ("ON", "OFF"):
            del epochs[:]
            out_dir = os.path.join(workdir, mode)
            reset_counters()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()) as printed:
                cli_jetid.main(KFOLD_ARGS + ["--vmap_folds", mode, "--output_dir", out_dir,
                                             "--device", str(device)])
            torch.cuda.synchronize()
            runs[mode] = dict(wall_s=time.perf_counter() - t0, launches=counters(),
                              epochs=list(epochs), out_dir=out_dir, printed=printed.getvalue())
    finally:
        jetid_loop.train_epoch = train_epoch

    results = {}
    for mode, run in runs.items():
        with open(os.path.join(run["out_dir"], "valid_results.pkl"), "rb") as f:
            _, labels, probs = pickle.load(f)
        n = len(labels)
        if probs.shape != (n, 2) or not np.isfinite(probs).all() or \
                not np.allclose(probs.sum(axis=1), 1.0, atol=1e-5):
            raise AssertionError(f"--vmap_folds {mode}: CV probabilities {probs.shape}")
        cv = re.search(r"3-FOLD CV ACCURACY: (\S+) %", run["printed"])
        accuracy = 100 * float(np.mean(probs.argmax(axis=1) == labels))
        if cv is None or abs(float(cv.group(1)) - accuracy) > 0.01:
            raise AssertionError(f"--vmap_folds {mode}: CV accuracy line {cv and cv.group(0)}, "
                                 f"the probabilities give {accuracy:.2f} %")
        weights = {}
        for fold in range(1, KFOLD + 1):
            with np.load(os.path.join(run["out_dir"], f"model_{fold}.npz")) as npz:
                weights[fold] = {k: npz[k] for k in npz.files}
        results[mode] = labels, probs, weights, accuracy

    n = len(results["ON"][0])
    n_valid = [len(range(fold, n, KFOLD)) for fold in range(KFOLD)]
    n_train = [n - v for v in n_valid]
    bs = min(JETID_BATCH, max(n_train))
    steps = [-(-t // bs) for t in n_train]
    valid_batches = [-(-v // min(bs, v)) for v in n_valid]
    chunks = [-(-v // JETID_CHUNK) for v in n_valid]
    want = dict.fromkeys(KERNELS, 0)
    want["fused_conv_bf16"] = KFOLD_EPOCHS * (sum(steps) + sum(valid_batches)) + sum(chunks)
    want["fused_conv_backward_bf16"] = KFOLD_EPOCHS * sum(steps)
    for mode, run in runs.items():
        if run["launches"] != want:
            raise AssertionError(f"--vmap_folds {mode} launched {run['launches']}, want {want} "
                                 f"({KFOLD_EPOCHS} epochs of {steps} fold-steps and "
                                 f"{valid_batches} validation batches, {chunks} predict chunks)")
    (labels, probs, weights, _), (seq_labels, seq_probs, seq_weights, _) = \
        results["ON"], results["OFF"]
    if not np.array_equal(labels, seq_labels):
        raise AssertionError("--vmap_folds ON and OFF scored different events")
    weight_gap = max(_largest_gap(weights[f][k], seq_weights[f][k], *KFOLD_WEIGHT_TOL,
                                  f"fold {f} {k}") for f in weights for k in seq_weights[f])
    prob_gap = _largest_gap(probs, seq_probs, *KFOLD_PROB_TOL, "CV probabilities")
    facts = {}
    for mode, run in runs.items():
        warm = run["epochs"][1:]
        facts[mode] = 1e3 * sum(t for t, _ in warm) / sum(b for _, b in warm)
        log("kfold", vmap_folds=mode, folds=KFOLD, epochs=KFOLD_EPOCHS, jets=n,
            fold_train_jets=json.dumps(n_train), steps_per_fold_epoch=json.dumps(steps),
            wall_s=f"{run['wall_s']:.3f}", ms_per_fold_step=f"{facts[mode]:.4f}",
            cv_accuracy=f"{results[mode][3]:.2f}", launches=json.dumps(run["launches"]))
    log("kfold", on_vs_off_weight_gap=weight_gap, prob_gap=prob_gap,
        same_bits=bool(np.array_equal(probs, seq_probs)))
    return runs["ON"]["launches"], dict(wall_s=runs["ON"]["wall_s"],
                                        ms_per_fold_step=facts["ON"],
                                        seq_ms_per_fold_step=facts["OFF"])


def _median_ms(fn):
    """Host-clock ms of ``fn``, the median of KERAS_REPEATS calls."""
    import torch
    times = []
    for _ in range(KERAS_REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def _same_bits(a, b, what):
    import torch
    from atlasvae_torch.train.checkpoint import tree_flatten
    a, b = tree_flatten(a), tree_flatten(b)
    if len(a) != len(b) or not all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b)):
        raise AssertionError(f"keras: {what} are not the same bits")


def phase_keras(device, root, jetid_data, aae_facts):
    """Keras weight files on the card, written and read by data/hdf5.py
    (LiteFile where h5py is missing): the train phase's VAE exported and
    read back, then predicted from by cli/vae.py's own _load_model_in and
    _valid_predictions on the evaluate phase's events, from the .h5 and from
    the .npz (the same bits; K2 and K1 once a chunk); cli/vae.py with
    --model_out model.h5 against model.npz, same seed (the same weights, K3
    on the training path); the jetid_bf16 phase's model exported with its
    config and served by cli/jetid.py from the .h5 and from the .npz (the
    same probabilities, K5 bf16 once a predict chunk); the aae phase's AE as
    the reference's AE-only AE.h5 against its npz cache in train_aae on
    10,000 jets (the same loss history, no kernel of ours).  Prints each
    file's size and the write and read ms; returns the phase's launches."""
    import numpy as np
    import torch
    from atlasvae_torch.cli import jetid as cli_jetid, vae as cli_vae
    from atlasvae_torch.data import ensure_synthetic_registry, hdf5, Scaler, HLV_LIST
    from atlasvae_torch.models import VAEConfig, init_vae
    from atlasvae_torch.train import aae_loop, keras_export, keras_import
    from atlasvae_torch.train.checkpoint import load_pytree, save_pytree

    workdir = os.path.join(root, "keras")
    os.makedirs(workdir)
    facts = {"library": "h5py" if hdf5._h5py is not None else "LiteFile"}
    total = dict.fromkeys(counters(), 0)

    def add(launches):
        for name, count in launches.items():
            total[name] += count

    def timed_file(name, write, read):
        path, key = os.path.join(workdir, name), name.replace(".", "_")
        facts[f"{key}_write_ms"] = f"{_median_ms(lambda: write(path)):.3f}"
        facts[f"{key}_read_ms"] = f"{_median_ms(lambda: read(path)):.3f}"
        facts[f"{key}_bytes"] = os.path.getsize(path)
        with open(path, "rb") as f:
            if f.read(8) != b"\x89HDF\r\n\x1a\n":
                raise AssertionError(f"keras: {path} does not start with the HDF5 signature")
        return path

    # 1. the train phase's VAE: export, read back, predict from both files
    # the train and evaluate phases' files, registered again (the jet-ID and
    # AAE phases registered their own under the same names since)
    ensure_synthetic_registry(root, n_events=TRAIN_EVENTS, n_const_max=20,
                              names=["QCD-Geneva", "OoD-H"], seed=0)
    ensure_synthetic_registry(root, n_events=EVAL_EVENTS, n_const_max=20,
                              names=["QCD-Geneva", "2HDM-Geneva"], seed=0)
    train_dir = os.path.join(root, "train")
    npz = os.path.join(train_dir, "model.npz")
    template = lambda: init_vae(torch.Generator(device).manual_seed(1), VAEConfig(),
                                device=device)
    trained = load_pytree(npz, template())
    h5 = timed_file("vae.h5", lambda path: keras_export.export_keras_vae(trained, path),
                    keras_import.read_keras_weights)
    _same_bits(keras_import.load_params_auto(h5, template(), "vae"), trained,
               "the VAE's model.h5 read back and its model.npz")
    scaler = Scaler.load(os.path.join(train_dir, "HLV_RobustScaler.pkl"))
    args = cli_vae.build_parser().parse_args([])
    args.n_valid, args.n_sig = [0, EVAL_EVENTS], EVAL_EVENTS
    cuts = ['(sample["m"] >= 30)', '(sample["pt"] <= 5000)']     # cli/vae.py's valid cuts
    predictions = {}
    for path in (h5, npz):
        args.model_in = path
        params = cli_vae._load_model_in(args, template(), os.path.dirname(path))
        reset_counters()
        with contextlib.redirect_stdout(io.StringIO()):
            _, x_true, x_pred, _, _ = cli_vae._valid_predictions(
                args, params, None, scaler, list(HLV_LIST), cuts, device)
        torch.cuda.synchronize()
        launches = counters()
        chunks = -(-len(x_true) // EVAL_CHUNK)
        if launches["stack_forward"] != chunks or launches["fused_mlp"] != chunks or \
                sum(launches.values()) != 2 * chunks:
            raise AssertionError(f"keras: predicting from {path} launched {launches}, want "
                                 f"stack_forward and fused_mlp {chunks} times each")
        add(launches)
        predictions[path] = x_pred
    if not np.array_equal(predictions[h5], predictions[npz]):
        raise AssertionError("keras: the VAE's predictions from model.h5 and model.npz differ")

    # 2. cli/vae.py --model_out model.h5 against model.npz, the same seed
    argv = TRAIN_ARGS + ["--n_epochs", str(KERAS_VAE_EPOCHS), "--device", str(device)]
    outs = {}
    for name in ("model.npz", "model.h5"):
        run_dir = os.path.join(workdir, "vae_" + name.split(".")[1])
        reset_counters()
        with contextlib.redirect_stdout(io.StringIO()):
            cli_vae.main(argv + ["--model_out", name, "--output_dir", run_dir])
        torch.cuda.synchronize()
        launches = counters()
        if launches["stack_backward"] <= 0 or launches["stack_backward_layers"] != 0:
            raise AssertionError(f"keras: cli/vae.py --model_out {name} launched {launches}: "
                                 "want K3 on its fused body")
        add(launches)
        outs[name] = os.path.join(run_dir, name)
    with open(outs["model.h5"], "rb") as f:
        if f.read(4) != b"\x89HDF":
            raise AssertionError("keras: cli/vae.py --model_out model.h5 left no Keras file")
    _same_bits(keras_import.load_params_auto(outs["model.h5"], template(), "vae"),
               load_pytree(outs["model.npz"], template()),
               "the weights of the --model_out model.h5 and model.npz runs")

    # 3. jet-ID: the jetid_bf16 phase's model served from model.h5 and model.npz
    os.environ["ATLASVAE_DATA_DIR"] = jetid_data
    out_dir = os.path.join(root, "jetid_bf16", "out")
    seen = []
    load = keras_import.load_params_auto

    def recorded(*a, **k):
        seen.append(a)
        return load(*a, **k)

    served = {}
    argv = JETID_BF16_ARGS + ["--output_dir", out_dir, "--device", str(device), "--n_epochs", "0"]
    keras_import.load_params_auto = recorded
    try:
        for name in ("model.npz", "model.h5"):
            if name == "model.h5":       # the model the CLI built, with its config
                (_, jetid_template, _, config), = seen
                jetid_params = load_pytree(os.path.join(out_dir, "model.npz"), jetid_template)
                timed_file("jetid.h5", lambda path: keras_export.export_keras_jetid(
                    jetid_params, path, config), keras_import.read_keras_weights)
                os.replace(os.path.join(workdir, "jetid.h5"), os.path.join(out_dir, name))
            reset_counters()
            results = f"keras_{name.split('.')[1]}.pkl"
            with contextlib.redirect_stdout(io.StringIO()):
                cli_jetid.main(argv + ["--model_in", name, "--results_out", results])
            torch.cuda.synchronize()
            launches = counters()
            _, labels, probs, _ = _jetid_report(os.path.join(out_dir, results), device)
            chunks = -(-len(labels) // JETID_CHUNK)
            want = dict.fromkeys(CONV_COUNTERS, 0)
            want["fused_conv_bf16"] = chunks
            if any(launches[k] != v for k, v in want.items()):
                raise AssertionError(f"keras: serving {name} launched {launches}: want "
                                     f"fused_conv_bf16 {chunks} times, no other form or route")
            add(launches)
            served[name] = (labels, probs)
    finally:
        keras_import.load_params_auto = load
    if not (np.array_equal(served["model.h5"][0], served["model.npz"][0])
            and np.array_equal(served["model.h5"][1], served["model.npz"][1])):
        raise AssertionError("keras: jet-ID probabilities from model.h5 and model.npz differ")

    # 4. the OE-AAE: --AE_weights AE.h5 (the reference's AE-only file) against AE.npz
    trained_aae, part, lr = aae_facts["trained"], aae_facts["parity_load"], aae_facts["lr"]
    ae = timed_file("AE.h5", lambda path: keras_export.export_keras_aae(
        trained_aae, path, include_discriminator=False), keras_import.read_keras_weights)
    save_pytree(os.path.join(workdir, "AE.npz"), aae_loop._subtree(trained_aae, aae_loop.AE_KEYS))
    histories = {}
    for name in (os.path.basename(ae), "AE.npz"):
        reset_counters()
        with contextlib.redirect_stdout(io.StringIO()):
            _, histories[name] = aae_loop.train_aae(
                aae_facts["fresh"](device), [part], 1, AAE_BATCH, workdir, hist_file="",
                model_out="", ae_weights=name, lamb=1.0, beta=1.0, lr=lr)
        torch.cuda.synchronize()
        if any(counters().values()):
            raise AssertionError(f"keras: train_aae launched {counters()} (the AAE runs no "
                                 "kernel of ours)")
    # the AE epochs skipped: the AAE phase's 5 epochs only (105 with the AE's)
    if histories["AE.h5"] != histories["AE.npz"] or len(histories["AE.h5"]["QCD-AE Loss"]) != 5:
        raise AssertionError("keras: train_aae from AE.h5 and from AE.npz: the loss histories "
                             "differ, or the AE epochs were not skipped")
    log("keras", **facts)
    return total


def _etl_branches(rng, n, scale=1.0):
    """The canonical branches (tests/test_etl.py::_fixture_branches) at the
    reference's kinematic scale, in ntuple units (MeV)."""
    import numpy as np
    from atlasvae_torch.etl.root2h5 import MEV_SCALARS, SCALARS
    out = {key: rng.uniform(0.5, 3.0, n).astype(np.float32) for key in SCALARS}
    out.update({key: (rng.uniform(30e3, 300e3, n) if "_m_" in key else
                      rng.uniform(450e3, 1200e3, n)).astype(np.float32) for key in MEV_SCALARS})
    out["weight_mc"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
    out["weight_pileup"] = rng.uniform(0.9, 1.1, n).astype(np.float32)
    out["rljet_topTag_DNN19_qqb_score"] = rng.uniform(0, 1, n).astype(np.float32)
    counts = rng.integers(1, ETL_MAX_CONST + 1, n)
    out["rljet_n_constituents"] = counts.astype(np.int32)
    ends = np.cumsum(counts)[:-1]
    total = int(counts.sum())
    out["rljet_assoc_cluster_pt"] = np.split(rng.uniform(1e3, 2e5, total).astype(np.float32), ends)
    out["rljet_assoc_cluster_eta"] = np.split(rng.normal(0, 1, total).astype(np.float32), ends)
    out["rljet_assoc_cluster_phi"] = np.split(rng.uniform(-3, 3, total).astype(np.float32), ends)
    return out


def _rows_multiset(path, dtypes=None):
    """Every row of an HDF5 file's datasets (cast to ``dtypes``, where
    given, with the cast checked to keep each value) as one sorted array of
    byte strings, and each dataset's dtype."""
    import numpy as np
    from atlasvae_torch.data import hdf5
    columns, kinds = [], {}
    with hdf5.File(path, "r") as f:
        for key in sorted(f.keys()):
            col = f[key][()]
            kinds[key] = col.dtype
            if dtypes is not None and col.dtype != dtypes[key]:
                cast = col.astype(dtypes[key])
                if not np.array_equal(cast.astype(col.dtype), col):
                    raise AssertionError(f"etl: {key} does not fit {dtypes[key]}")
                col = cast
            columns.append(np.ascontiguousarray(col).view(np.uint8).reshape(len(col), -1))
    rows = np.ascontiguousarray(np.hstack(columns))
    return np.sort(rows.view(np.dtype((np.void, rows.shape[1]))).ravel()), kinds


def _lzf_rates(fixtures):
    """MB/s of the C and of the plain LZF decoder, each held to the other,
    twice: over every lzf chunk of the committed fixtures that lzf shrank
    (a smoke rate: about 2 KB a chunk, so each call's overhead weighs), and
    over one stream of LZF_REF_CHUNK_BYTES, a merged file's constituents
    chunk (10,000 x 400 float16), made by concatenating those chunks (an
    LZF back-reference is relative to the output position, so concatenated
    streams decode to the concatenated outputs; the content stays the
    fixtures')."""
    from atlasvae_torch.data import hdf5, lzf
    chunks = []
    for name in fixtures:
        with hdf5.LiteFile(name) as f:
            for key in f.keys():
                store = f[key]._chunks          # lzf alone: the dataset's only filter
                if store is None or [fid for fid, _, _ in store.filters] != [32000]:
                    continue
                with open(name, "rb") as raw:
                    for _, size, mask, addr in store.index:
                        if mask & 1 == 0:
                            raw.seek(addr)
                            chunks.append((raw.read(size), store.nbytes))
    if not chunks:
        raise AssertionError("etl: no lzf chunk in the fixtures")
    for data, size in chunks:
        if lzf.decompress_native(data, size) != lzf.decompress_plain(data, size):
            raise AssertionError("etl: the C and plain LZF decoders disagree")
    fixture_bytes = sum(size for _, size in chunks)
    reps = -(-LZF_REF_CHUNK_BYTES // fixture_bytes)
    big = (b"".join(data for data, _ in chunks) * reps, fixture_bytes * reps)
    if lzf.decompress_native(*big) != b"".join(lzf.decompress_plain(*c) for c in chunks) * reps:
        raise AssertionError("etl: the concatenated LZF stream decodes unlike its parts")
    rates = {}
    for case, streams in (("fixture", chunks), ("ref_chunk", [big])):
        for name, decode in (("native", lzf.decompress_native), ("plain", lzf.decompress_plain)):
            out_bytes, t0 = 0, time.perf_counter()
            while True:
                for data, size in streams:
                    out = decode(data, size)
                    if out is None or len(out) != size:
                        raise AssertionError(f"etl: the {name} LZF decoder gave {out!r:.40}")
                    out_bytes += size
                if time.perf_counter() - t0 >= LZF_MIN_S:
                    break
            rates[f"lzf_{case}_{name}_mb_per_s"] = out_bytes / (time.perf_counter() - t0) / 1e6
    return rates, len(chunks), fixture_bytes, big[1]


def phase_etl(device, workdir):
    """The ETL on the card machine's own installation, which has no h5py
    (the phase fails where h5py is importable): write seeded ntuples with
    the port's rootio.write_tree, convert both samples and merge the dijet
    one through cli/etl.py, hold the merged file to the unmerged one (the
    same multiset of rows, float16 constituents, uint8 counts), load it
    with load_data (cuts, constituents ON, n_const 100) and train one
    constituents-mode epoch of cli/vae.py on it with the ttbar file as OoD,
    the counters set to 0 just before (K2 and K3 on their layer-wise
    routes).  Also: the native basket decoder against the Python loop on a
    vector<vector<float>> tree, the committed h5py fixtures read through
    LiteFile bit-equal to their .npz, and the MB/s of both LZF decoders
    (``_lzf_rates``).  Prints each stage's
    seconds; returns the phase's launches."""
    import pickle
    import numpy as np
    import torch
    from atlasvae_torch import native
    from atlasvae_torch.cli import etl as cli_etl, vae as cli_vae
    from atlasvae_torch.data import hdf5, load_data, lzf
    from atlasvae_torch.etl import rootio, rootnative

    os.makedirs(workdir)
    if hdf5._h5py is not None:
        raise AssertionError("etl: h5py is importable, so the phase would not run "
                             "through LiteFile as the card machine's installation does")
    facts = {"library": "LiteFile", "lzf_backend": lzf.backend()}
    if facts["lzf_backend"] != "native":
        raise AssertionError(f"etl: the C LZF decoder did not build: {native.error('lzf_decode')}")
    rng = np.random.default_rng(16)
    root = os.path.join(workdir, "ntuples")
    counts = {}
    t0 = time.perf_counter()
    for dsid, files, jets in (ETL_DIJET, ETL_TTBAR):
        folder = os.path.join(root, f"user.sim.{dsid}.ntuples")
        os.makedirs(folder)
        for i in range(files):
            rootio.write_tree(os.path.join(folder, f"part._{i:06d}.root"), "nominal",
                              _etl_branches(rng, jets))
        counts[dsid] = files * jets
    facts["write_s"] = time.perf_counter() - t0
    if facts["write_s"] > ETL_WRITE_LIMIT_S:
        raise AssertionError(f"etl: writing the ntuples took {facts['write_s']:.1f} s: cut "
                             "ETL_DIJET and ETL_TTBAR and record the cut")
    facts["ntuple_mb"] = sum(os.path.getsize(os.path.join(d, n)) for d, _, names in os.walk(root)
                             for n in names) / 1e6

    h5_dir, ttbar_dir = os.path.join(workdir, "dijet"), os.path.join(workdir, "ttbar")
    native_before = dict(rootnative.native_calls)
    for stage, argv in (("convert_dijet", ["--sample_type", "topo-dijet", "--tag", "1",
                                           "--output_path", h5_dir]),
                        ("convert_ttbar", ["--sample_type", "topo-ttbar",
                                           "--output_path", ttbar_dir])):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            if cli_etl.main(argv + ["--input_path", root]) != 0:
                raise AssertionError(f"etl: cli/etl.py {' '.join(argv)} failed")
        facts[f"{stage}_s"] = time.perf_counter() - t0
    if rootnative.native_calls["final_jets_native"] - native_before["final_jets_native"] != 2:
        raise AssertionError("etl: convert did not take the native final_jets kernel "
                             f"({rootnative.native_calls})")
    dijet = os.path.join(h5_dir, f"topo-dijet_{ETL_DIJET[0]}.h5")
    ttbar = os.path.join(ttbar_dir, "topo-ttbar.h5")
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        if cli_etl.main(["--merging", "ON", "--input_path", h5_dir]) != 0:
            raise AssertionError("etl: cli/etl.py --merging ON failed")
    facts["merge_s"] = time.perf_counter() - t0
    merged = os.path.join(h5_dir, "merging", "merging.h5")
    facts["merged_mb"] = os.path.getsize(merged) / 1e6

    # the merged file against the unmerged one: the same rows, the reference's dtypes
    got, kinds = _rows_multiset(merged)
    if kinds["constituents"] != np.float16 or kinds["rljet_n_constituents"] != np.uint8 \
            or kinds["JZW"] != np.int8:
        raise AssertionError(f"etl: the merged file's dtypes are {kinds}")
    want, _ = _rows_multiset(dijet, kinds)
    if len(got) != counts[ETL_DIJET[0]] or not np.array_equal(got, want):
        raise AssertionError(f"etl: the merged file holds {len(got)} rows, not the "
                             f"{len(want)} rows of {os.path.basename(dijet)}")

    cuts = ['(sample["m"] >= 30)', '(sample["pt"] <= 5000)']     # cli/vae.py's train cuts
    t0 = time.perf_counter()
    sample = load_data(merged, counts[ETL_DIJET[0]], cuts, ETL_MAX_CONST, 3, "ON", "OFF",
                       verbose=False, device=device)
    facts["load_s"] = time.perf_counter() - t0
    if sample["constituents"].shape != (counts[ETL_DIJET[0]], 3 * ETL_MAX_CONST) or \
            not np.isfinite(sample["constituents"]).all():
        raise AssertionError(f"etl: load_data gave constituents {sample['constituents'].shape}")

    out_dir = os.path.join(workdir, "train")
    reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        cli_vae.main(ETL_TRAIN_ARGS + ["--bkg_data", merged, "--OoD_data", ttbar,
                                       "--output_dir", out_dir, "--device", str(device)])
    torch.cuda.synchronize()
    facts["train_s"] = time.perf_counter() - t0
    launches = counters()
    with open(os.path.join(out_dir, "history.pkl"), "rb") as f:
        history = pickle.load(f)
    if any(len(v) != 1 or not np.isfinite(v).all() for v in history.values()):
        raise AssertionError(f"etl: the epoch's history is {history}")
    if launches["stack_forward_layers"] <= 0 or launches["stack_backward_layers"] <= 0 \
            or launches["stack_backward_layers"] % 4:
        raise AssertionError(f"etl: training launched {launches}: want K2 and K3 on their "
                             "layer-wise routes, K3 4 times a step")
    facts["history"] = json.dumps({k: [float(x) for x in v] for k, v in history.items()})

    # the native basket decoder against the Python loop, on the raw ATLAS layout
    stl = os.path.join(workdir, "stl.root")
    rootio.write_tree(stl, "nominal", {"clusters": [
        [rng.normal(size=c).astype(np.float32) for c in rng.integers(0, 30, k)]
        for k in rng.integers(0, 4, ETL_STL_JETS)]})
    before = rootnative.native_calls["decode_stl_basket"]
    t0 = time.perf_counter()
    fast = rootio.read_tree(stl, "nominal").array_jagged("clusters")
    facts["stl_native_s"] = time.perf_counter() - t0
    if rootnative.native_calls["decode_stl_basket"] == before:
        raise AssertionError("etl: the native basket decoder did not run")
    load_lib, rootnative.load_lib = rootnative.load_lib, lambda: None
    try:
        t0 = time.perf_counter()
        slow = rootio.read_tree(stl, "nominal").array_jagged("clusters")
        facts["stl_python_s"] = time.perf_counter() - t0
    finally:
        rootnative.load_lib = load_lib
    if not all(np.array_equal(a, b) for a, b in zip(fast, slow)):
        raise AssertionError("etl: the native and Python basket decoders disagree")

    # the committed h5py fixtures through LiteFile, and the LZF decoders' rates
    fixtures = ROOT / "tests" / "fixtures"
    expect = np.load(fixtures / "h5py_fixtures.npz")
    names = sorted({key.split("/")[0] for key in expect.files})
    for key in expect.files:
        name, dataset = key.split("/")
        with hdf5.LiteFile(fixtures / name) as f:
            value = f[dataset][()]
        if value.dtype != expect[key].dtype or value.tobytes() != expect[key].tobytes():
            raise AssertionError(f"etl: LiteFile read {key} unlike its .npz")
    facts["fixture_datasets"] = len(expect.files)
    rates, n_chunks, n_bytes, ref_bytes = _lzf_rates([fixtures / name for name in names])
    facts.update(lzf_fixture_chunks=n_chunks, lzf_fixture_bytes=n_bytes,
                 lzf_ref_chunk_bytes=ref_bytes, **rates)
    log("etl", **{k: (f"{v:.3f}" if isinstance(v, float) else v) for k, v in facts.items()},
        launches=json.dumps(launches))
    return launches, facts


# The scale-out phase (ROADMAP Queue 1 item 11): two ranks share the one card
# over gloo (NCCL refuses two ranks on one device), each stepping its half
# of every batch at the train phase's width, the jet-ID CLI's bf16 CNN, the
# emd_slice chunk's EMD and the evaluate phase's BumpHunter scan; a 1-rank
# NCCL world in this process; cli/vae.py --n_devices 2 refused on one card;
# utils/profiling.trace around a train step.
SCALEOUT_WORLD = 2
SCALEOUT_VAE_BATCHES = 4             # of TRAIN_BATCH rows, global
SCALEOUT_JETID_BATCHES = 3           # of JETID_BATCH images, global: three steps
SCALEOUT_EMD_JETS = 13_421           # the emd_slice chunk (jets of EMD_CONST)
SCALEOUT_NPE = 1000
SCALEOUT_LR = 1e-3
SCALEOUT_TIMED = 3                   # timed loads a world size, after a warm one
# DP against one device: tests/test_train.py:34-60's bars (summed metrics
# rtol 2e-3, weights atol 5e-4); the jet-ID bf16 steps: every step's loss
# at JETID_BF16_LOSS_REL_TOL (the second and third after the exchanged
# updates), its accuracy within two jets of the batch, and the weights'
# drift (_drift) within SCALEOUT_BF16_DRIFT_TOL: not each weight, since
# Adam moves a weight by up to lr a step whatever its gradient's size, so
# a gradient that is rounding noise on one side can take the other sign
# and put that weight 2 lr a step apart.  Adam is blind to the gradient's scale, so
# the gradient exchange itself is held through Adam's first moment after
# the steps (a decayed sum of the exchanged gradients), each entry within
# SCALEOUT_MOMENT_TOL (VAE) or SCALEOUT_BF16_MOMENT_TOL (jet-ID) of the
# one-device moment's largest entry: a gradient sum dropped, doubled or
# halved moves it by half that entry or more.  Sound runs on the card gave
# a drift of 0.034 and moment gaps of 1.8e-7 (VAE) and 3.2e-3 (jet-ID) of
# that entry, the CPU's bf16 plain path 0.039 and 6.1e-2 (PERF.md, §6).
SCALEOUT_METRIC_RTOL, SCALEOUT_WEIGHT_ATOL = 2e-3, 5e-4
SCALEOUT_BF16_DRIFT_TOL = 0.2
SCALEOUT_MOMENT_TOL, SCALEOUT_BF16_MOMENT_TOL = 1e-3, 0.2


def _scaleout_cases(device, world):
    """The inputs every rank builds alike: the canonical VAE's load, the
    jet-ID CLI's bf16 CNN and its batches, an emd_slice chunk's clouds and
    a binned background with a signal bump."""
    import numpy as np
    import torch
    from atlasvae_torch.models import JetIDConfig, VAEConfig, init_jetid, init_vae
    from atlasvae_torch.train.jetid_loop import _packed_arrays
    from atlasvae_torch.train.step import batch_load
    rng = np.random.default_rng(0)
    n = SCALEOUT_VAE_BATCHES * TRAIN_BATCH
    vae_load = batch_load(rng.normal(0, 1, (n, 12)).astype(np.float32),
                          rng.normal(2, 1, (n, 12)).astype(np.float32),
                          np.ones(n, np.float32), rng.uniform(0.5, 2, n).astype(np.float32),
                          TRAIN_BATCH, world)
    vae_params = init_vae(torch.Generator(device).manual_seed(7), VAEConfig(), device=device)
    jets = SCALEOUT_JETID_BATCHES * JETID_BATCH
    images = rng.gamma(0.3, 1.0, (jets, JETID_IMAGE, JETID_IMAGE)).astype(np.float32)
    images[rng.random(images.shape) < 0.7] = 0.0
    inputs = {"HLVs": rng.normal(0, 1, (jets, 12)).astype(np.float32), "images": images}
    labels = rng.integers(0, 2, jets)
    config = JetIDConfig(n_classes=2, scalars=("HLVs",), scalar_dims=(12,), images=("images",),
                         image_shapes=((JETID_IMAGE, JETID_IMAGE),), nn_type="CNN",
                         dropout=0.0, compute_dtype="bfloat16")
    jetid = (config, init_jetid(torch.Generator(device).manual_seed(0), config, device=device),
             inputs, _packed_arrays(inputs, labels, np.ones(jets, np.float32), JETID_BATCH))
    clouds = emd_clouds(torch.Generator(device).manual_seed(11), SCALEOUT_EMD_JETS, EMD_CONST,
                        device)
    edges = np.linspace(0, 400, 101)
    bkg = np.histogram(rng.exponential(80, 500_000) + 20, bins=edges)[0].astype(float)
    data = bkg + np.histogram(rng.normal(250, 10, 3000), bins=edges)[0].astype(float)
    return vae_load, vae_params, jetid, clouds, (data, bkg)


def _scaleout_vae(batches, params, device, mesh):
    """One load's steps of the train phase's model (MAE OE, beta 2, lamb 5)
    from ``params`` with the seed-7 generator, over ``mesh`` or on one
    device: (metrics, flat weights, Adam's first moment, the step function
    and its state)."""
    import torch
    from atlasvae_torch.parallel.mesh import shard_batch
    from atlasvae_torch.train.step import TrainState, make_vae_step_fns, to_device
    train_on_load, _ = make_vae_step_fns("MAE", 2.0, 5.0, 1.0, mesh=mesh)
    state = TrainState(params)
    local = to_device(batches if mesh is None else shard_batch(mesh, batches), device)
    metrics = train_on_load(state, SCALEOUT_LR, torch.Generator(device).manual_seed(7), local)
    torch.cuda.synchronize()
    return (metrics.cpu().numpy(), state.flat.cpu().numpy().copy(),
            state.adam.mu.cpu().numpy().copy(), (train_on_load, state, local))


def _scaleout_jetid(jetid, device, mesh):
    import torch
    from atlasvae_torch.parallel.mesh import shard_batch
    from atlasvae_torch.train.jetid_loop import _unflatten, train_epoch
    from atlasvae_torch.train.step import TrainState, to_device
    config, params, inputs, host = jetid
    state = TrainState(params)
    start = state.flat.cpu().numpy().copy()
    batches = _unflatten(inputs, to_device(host if mesh is None else shard_batch(mesh, host),
                                           device))
    metrics = train_epoch(state, config, SCALEOUT_LR, torch.Generator(device).manual_seed(3),
                          *batches, mesh)
    return (metrics.cpu().numpy(), state.flat.cpu().numpy().copy(),
            state.adam.mu.cpu().numpy().copy(), start)


def _drift(got, want, start, tol, what):
    """|got - want| / |want - start| (2-norms): how far two runs from
    ``start`` ended apart, against how far ``want`` travelled; raises
    above ``tol``."""
    import numpy as np
    drift = float(np.linalg.norm(got - want) / np.linalg.norm(want - start))
    if not drift <= tol:
        raise AssertionError(f"{what}: drift {drift} over {tol}")
    return drift


def _moment_gap(got, want, tol, what):
    """max |got - want| of two Adam first moments; raises where it passes
    ``tol`` times the largest |want|."""
    import numpy as np
    return _largest_gap(got, want, 0.0, tol * float(np.abs(want).max()), what)


def _scaleout_step_ms(run):
    """Median ms a step of ``run()`` (one load of SCALEOUT_VAE_BATCHES
    steps) over SCALEOUT_TIMED timed loads after a warm one."""
    import torch
    times = []
    for i in range(SCALEOUT_TIMED + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3 / SCALEOUT_VAE_BATCHES)
    return sorted(times)[len(times) // 2]


def _scaleout_rank(workdir, device):
    """A rank of the gloo world on the one card (``device``): every check's
    reference on one device first, then the data-parallel runs with the
    launch counters set to 0 just before and read just after, then the
    times.  Writes its results to workdir/rank<r>.json."""
    import torch
    import torch.distributed as dist
    from atlasvae_torch.ops.emd import emd_pairs
    from atlasvae_torch.parallel.mesh import data_parallel_mesh
    from atlasvae_torch.stats.bumphunter import bump_sigma_sharded
    rank, world = dist.get_rank(), dist.get_world_size()
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    probe = torch.full((4,), float(rank + 1), device=device)
    try:
        dist.all_reduce(probe)
    except RuntimeError as err:        # this gloo takes no CUDA tensor
        out = {"gloo_cuda": f"{type(err).__name__}: {err}"}
    else:
        if probe.tolist() != [world * (world + 1) / 2] * 4:
            raise AssertionError(f"scaleout: gloo's all_reduce on the card gave {probe}")
        out = _scaleout_ranked(device, world, data_parallel_mesh(), emd_pairs,
                               bump_sigma_sharded)
        out["gloo_cuda"] = True
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def _scaleout_ranked(device, world, mesh, emd_pairs, bump_sigma_sharded):
    import numpy as np
    import torch
    vae_load, vae_params, jetid, (p, q), (data, bkg) = _scaleout_cases(device, world)
    m1, w1, mu1, _ = _scaleout_vae(vae_load, vae_params, device, None)
    jm1, jw1, jmu1, jw0 = _scaleout_jetid(jetid, device, None)
    emd1 = emd_pairs(p, q, device=device)
    bump_kw = dict(widths=(2, 3, 4), scan_steps=(1, 1, 1), npe=SCALEOUT_NPE, seed=5,
                   device=device)
    bump1 = [float(t) for t in bump_sigma_sharded(data, bkg, **bump_kw)]
    torch.cuda.synchronize()
    reset_counters()
    mn, wn, mun, ranked = _scaleout_vae(vae_load, vae_params, device, mesh)
    jmn, jwn, jmun, _ = _scaleout_jetid(jetid, device, mesh)
    emdn = emd_pairs(p, q, mesh=mesh)
    bumpn = [float(t) for t in bump_sigma_sharded(data, bkg, mesh=mesh, **bump_kw)]
    torch.cuda.synchronize()
    launches = counters()
    out = {"launches": launches,
           "vae_metric_gap": _largest_gap(mn[:, :4].sum(0), m1[:, :4].sum(0),
                                          SCALEOUT_METRIC_RTOL, 0.0, "scaleout vae metrics"),
           "vae_weight_gap": _largest_gap(wn, w1, 0.0, SCALEOUT_WEIGHT_ATOL,
                                          "scaleout vae weights"),
           "vae_moment_gap": _moment_gap(mun, mu1, SCALEOUT_MOMENT_TOL,
                                         "scaleout vae first moment"),
           "vae_moment_max": float(np.abs(mu1).max()),
           "jetid_loss_gap": _largest_gap(jmn[:, 0], jm1[:, 0], JETID_BF16_LOSS_REL_TOL, 0.0,
                                          "scaleout jetid bf16 loss"),
           "jetid_accuracy_gap": _largest_gap(jmn[:, 1], jm1[:, 1], 0.0, 2 / JETID_BATCH,
                                              "scaleout jetid bf16 accuracy"),
           "jetid_weight_gap": float(np.abs(jwn - jw1).max()),
           "jetid_weight_drift": _drift(jwn, jw1, jw0, SCALEOUT_BF16_DRIFT_TOL,
                                        "scaleout jetid bf16 weights"),
           "jetid_moment_gap": _moment_gap(jmun, jmu1, SCALEOUT_BF16_MOMENT_TOL,
                                           "scaleout jetid bf16 first moment"),
           "jetid_moment_max": float(np.abs(jmu1).max()),
           "emd_gap": _largest_gap(emdn, emd1, EMD_RTOL, EMD_ATOL, "scaleout emd"),
           "bump": bumpn, "bump_equal": bumpn == bump1}
    if not out["bump_equal"]:
        raise AssertionError(f"scaleout: bump_sigma_sharded {bumpn} != one device {bump1}")
    if not (np.isfinite(wn).all() and np.isfinite(jwn).all()):
        raise AssertionError("scaleout: non-finite weights after the data-parallel steps")
    step, state, local = ranked
    gen = torch.Generator(device).manual_seed(9)
    out["ms_per_step_world"] = _scaleout_step_ms(lambda: step(state, SCALEOUT_LR, gen, local))
    return out


def phase_scaleout(device, workdir, smi):
    """Item 11 on the one card.  (a) A 1-rank NCCL world in this process:
    its data-parallel VAE load bit-equal to the one-device load.  (b) Two
    ranks on the card over gloo (after checking that this gloo's all_reduce
    takes CUDA tensors; where it does not, that is printed and (a) stands
    alone): the VAE DP load at the CPU tests' bars, three jet-ID bf16 DP
    steps of 5,000 images, both with their Adam first moments, the
    emd_slice chunk's EMD sharded (EMD_RTOL/EMD_ATOL)
    and the sharded BumpHunter scan exactly equal, each against one device
    on the same inputs; ms a step with 2 ranks (each timing its own while
    the other runs) beside one device alone on the card.  (c) cli/vae.py
    --n_devices 2 refused here (one card).  (d) utils/profiling.trace around
    a train step: the trace names K2's and K3's kernels.  Returns the
    phase's launches: the ranks' counted runs and (a)'s, summed."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from atlasvae_torch.cli import vae as cli_vae
    from atlasvae_torch.parallel.mesh import data_parallel_mesh
    from atlasvae_torch.parallel.multihost import run_ranks
    from atlasvae_torch.utils.profiling import annotate, trace

    os.makedirs(workdir)
    start = time.perf_counter()
    # (a) a 1-rank NCCL world: the all-reduce of one rank changes no bit
    vae_load, vae_params, *_ = _scaleout_cases(device, 1)
    m1, w1, mu1, _ = _scaleout_vae(vae_load, vae_params, device, None)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"file://{workdir}/nccl_group", world_size=1, rank=0)
    try:
        reset_counters()
        mn, wn, mun, _ = _scaleout_vae(vae_load, vae_params, device, data_parallel_mesh())
        launches = counters()
    finally:
        dist.destroy_process_group()
    if not (np.array_equal(m1, mn) and np.array_equal(w1, wn) and np.array_equal(mu1, mun)):
        raise AssertionError("scaleout: the 1-rank NCCL step differs from the one-device step: "
                             f"metrics {np.abs(m1 - mn).max()}, weights {np.abs(w1 - wn).max()}, "
                             f"first moments {np.abs(mu1 - mun).max()}")
    log("scaleout", nccl_world=1, bit_equal=True, launches=json.dumps(launches))

    # (b) two ranks on the one card over gloo
    run_ranks(_scaleout_rank, (workdir, str(device)), SCALEOUT_WORLD, device.type,
              backend="gloo")
    ranks = []
    for rank in range(SCALEOUT_WORLD):
        with open(os.path.join(workdir, f"rank{rank}.json")) as f:   # written by the rank
            ranks.append(json.load(f))
    if ranks[0]["gloo_cuda"] is not True:
        log("scaleout", gloo_cuda=json.dumps(ranks[0]["gloo_cuda"]),
            note="two ranks on one card need gloo's CUDA all_reduce; the 1-rank world stands")
    else:
        for rank, res in enumerate(ranks):
            for name, n in res.pop("launches").items():
                launches[name] += n
            log("scaleout", world=SCALEOUT_WORLD, rank=rank,
                **{k: (json.dumps(v) if isinstance(v, list) else v) for k, v in res.items()})
        for name in ("stack_forward", "stack_backward", "emd_sinkhorn", "fused_conv_bf16",
                     "fused_conv_backward_bf16"):
            if launches[name] <= 0:
                raise AssertionError(f"scaleout: {name} was not launched by the ranks")
        step, state, local = _scaleout_vae(vae_load, vae_params, device, None)[3]
        gen = torch.Generator(device).manual_seed(9)
        ms_one = _scaleout_step_ms(lambda: step(state, SCALEOUT_LR, gen, local))
        log("scaleout", card=json.dumps(smi), world=SCALEOUT_WORLD,
            ms_per_step_world=f"{ranks[0]['ms_per_step_world']:.4f}",
            ms_per_step_one=f"{ms_one:.4f}", rows_per_step=TRAIN_BATCH)

    # (c) more ranks than cards
    try:
        cli_vae.main(["--n_devices", "2", "--plotting", "OFF",
                      "--output_dir", os.path.join(workdir, "refused")])
    except SystemExit as err:
        if "--n_devices 2: only 1 devices" not in str(err):
            raise
    else:
        raise AssertionError("scaleout: cli/vae.py --n_devices 2 ran on one card")
    if os.path.exists(os.path.join(workdir, "refused")):
        raise AssertionError("scaleout: the refused run wrote its output folder")

    # (d) the trace of one train step names the training kernels
    train_on_load, state, local = _scaleout_vae(vae_load, vae_params, device, None)[3]
    with trace(os.path.join(workdir, "trace")):
        with annotate("train step"):
            train_on_load(state, SCALEOUT_LR, torch.Generator(device).manual_seed(1),
                          tuple(b[:1] for b in local))
            torch.cuda.synchronize()
    (trace_file,) = os.listdir(os.path.join(workdir, "trace"))
    with open(os.path.join(workdir, "trace", trace_file)) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    named = {k: sum(k in n for n in names) for k in ("fused_stack_kernel", "stack_bwd_kernel",
                                                    "train step")}
    if not all(named.values()):
        raise AssertionError(f"scaleout: the trace misses a kernel or span: {named}")
    log("scaleout", trace_events=len(names), trace_names=json.dumps(named),
        seconds=f"{time.perf_counter() - start:.1f}")
    return launches


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import atlasvae_torch  # noqa: F401  (fails outside a checkout of the repo)
    smi = phase_device()
    device = torch.device("cuda")
    phase_build()
    parity_results = phase_parity(device)
    log("parity", kernel="fused_mlp", wrapper_host_ms=f"{wrapper_host_ms():.5f}")
    phase_seeds(device)
    build_root = ROOT / "build"
    build_root.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_root) as workdir:
        slice_launches, rate = phase_slice(device, workdir)
        eval_launches, eval_facts = phase_evaluate(device, workdir)
        train_launches, train = phase_train(device, workdir)
        const_launches, const_facts = phase_const_train(device, os.path.join(workdir, "const_train"))
        emd_launches, emd_facts = phase_emd_slice(device, os.path.join(workdir, "emd_slice"))
        jetid_data = os.path.join(workdir, "jetid_data")
        jetid_launches, jetid_facts = phase_jetid(device, os.path.join(workdir, "jetid"),
                                                  jetid_data)
        bf16_launches, bf16_facts = phase_jetid(device, os.path.join(workdir, "jetid_bf16"),
                                                jetid_data, bf16=True)
        log("jetid_bf16", **{f"{key}_{form}": f"{facts[key]:.4f}"
                             for key in ("ms_per_step", "warm_jets_per_s", "predict_jets_per_s",
                                         "profiled_busy_ms", "idle_share", "block2_conv_ms",
                                         "block2_conv_share")
                             for form, facts in (("float32", jetid_facts),
                                                 ("bfloat16", bf16_facts))})
        jetid_stream(device, os.path.join(workdir, "jetid_stream"), jetid_data)
        feature_removal_run(device, os.path.join(workdir, "feature_removal"), jetid_data)
        sweep_launches, sweep_facts = phase_sweep(device, os.path.join(workdir, "sweep"),
                                                  workdir, train)
        kfold_launches, kfold_facts = phase_kfold(device, os.path.join(workdir, "kfold"),
                                                  jetid_data)
        aae_launches, aae_facts = phase_aae(device, os.path.join(workdir, "aae"), workdir)
        keras_launches = phase_keras(device, workdir, jetid_data, aae_facts)
        etl_launches, etl_facts = phase_etl(device, os.path.join(workdir, "etl"))
        scaleout_launches = phase_scaleout(device, os.path.join(workdir, "scaleout"), smi)

    kernels = []
    for name, meta in KERNELS.items():
        main_shape = next(r for r in parity_results[name] if r["shape"] == meta["main_shape"])
        by_phase = {"slice": slice_launches[name], "evaluate": eval_launches[name],
                    "train": train_launches[name],
                    "const_train": const_launches[name], "emd_slice": emd_launches[name],
                    "jetid": jetid_launches[name], "jetid_bf16": bf16_launches[name],
                    "sweep": sweep_launches[name], "kfold": kfold_launches[name],
                    "aae": aae_launches[name], "keras": keras_launches[name],
                    "etl": etl_launches[name], "scaleout": scaleout_launches[name]}
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"], replaces=meta["replaces"],
            launches=sum(by_phase.values()), launches_by_phase=by_phase,
            max_abs_err=max(r["max_abs_err"] for r in parity_results[name]),
            ms=main_shape["ms"], plain_ms=main_shape["plain_ms"],
            **({"device_ms": main_shape["device_ms"]} if "device_ms" in main_shape else {}),
            bound_ms=main_shape["bound_ms"], bound_by=main_shape["bound_by"],
            library_ms=main_shape["library_ms"],
            phases=["parity"] + [p for p, n in by_phase.items() if n > 0],
            shapes=parity_results[name]))
    log("kernels", card=json.dumps(smi), slice_jets_per_s=f"{rate:.0f}",
        train_jets_per_s=f"{train['warm_jets_per_s']:.0f}",
        const_train_jets_per_s=f"{const_facts['warm_jets_per_s']:.0f}",
        emd_slice_jets_per_s=f"{emd_facts['warm_jets_per_s']:.0f}",
        jetid_train_jets_per_s=f"{jetid_facts['warm_jets_per_s']:.0f}",
        jetid_predict_jets_per_s=f"{jetid_facts['predict_jets_per_s']:.0f}",
        jetid_bf16_train_jets_per_s=f"{bf16_facts['warm_jets_per_s']:.0f}",
        jetid_bf16_predict_jets_per_s=f"{bf16_facts['predict_jets_per_s']:.0f}",
        evaluate_bump_hunter_scan_ms=f"{eval_facts['scan_ms']:.4f}",
        evaluate_cut_scan_ms=f"{eval_facts['local_ms']:.4f}",
        sweep_lane_jets_per_s=f"{sweep_facts['lane_jets_per_s']:.0f}",
        kfold_ms_per_fold_step=f"{kfold_facts['ms_per_fold_step']:.4f}",
        aae_train_jets_per_s=f"{aae_facts['train_jets_per_s']:.0f}",
        aae_score_jets_per_s=f"{aae_facts['score_jets_per_s']:.0f}",
        aae_scan_2d_ms=f"{aae_facts['scan_2d']['ms']:.4f}",
        etl_train_s=f"{etl_facts['train_s']:.3f}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
