#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``keystone_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. build — compile every CUDA kernel of the slice from ``csrc/`` (nvcc,
   sm_90a) and print the build seconds and ptxas' resource report;
2. kernels — hold each kernel against its plain PyTorch version on the
   card, at the slice's shapes (with per-row slot counts, and without)
   and at edge cases (tiles (128, 8) and (3, 5), a ragged N, N = 20 and
   N = 1, padded slots, rows of count 0, junk in padded slots, duplicate
   blocks, an unaligned operand), relative Frobenius error ≤ 1e-5; time
   the kernel, as the slice calls it, in turns with one library call,
   and the plain version, at the slice's shapes; the AᵀY call also with
   L2 flushed before each launch;
3. slice — the hashing-TF → block-sparse least-squares fit of 65,536
   documents (1,024 topics, d = 16,384, k = 20, 16×16 tiles), then 4
   prediction requests of 1,024 held-out documents, through the
   library's entry points. The kernel must launch twice in the fit; the
   same rows refit on the dense in-core path
   (``KEYSTONE_BLOCKSPARSE=off``) must give the same scores to ≤ 1e-4,
   and a small fit on the card must match the same fit on the CPU. A
   second, instrumented run of the fit on the same rows splits ``fit_s``
   into its steps (host BSR build, host transpose + ELL, uploads, the
   two launches, finish + BCD);
4. mnist_default — ``run(MnistRandomFFTConfig())`` (8,192 / 2,048
   synthetic rows, 4 FFTs, block 2,048) through the port's entry point,
   train and test errors within 0.002 of the JAX package's, on the fused
   plan (one ``Fused[RandomSignNode+PaddedFFT+LinearRectifier]`` node per
   branch, no ``StreamFit``); then ``python -m keystone_tpu_torch
   mnist-random-fft --num-ffts 4 --block-size 2048`` in a subprocess must
   exit 0 with its JSON line;
5. mnist_full — the same pipeline at MNIST's sizes (60,000 train, 10,000
   test rows, d = 2,048, k = 10) through ``build_pipeline`` and
   ``Pipeline.fit()``: the optimized fit graph and the fitted graph must
   hold the JAX package's fused plan; ``optimize_s``, ``fit_s``
   (untraced), ``apply_s`` per 10,000 rows (median of 5 after a warm-up),
   per-node times from a second fit under ``trace()``, nodes executed and
   the fit's peak memory (beside the unfused plan's 3,960,183,808 B); errors
   within 0.002 of the JAX package's, scores within 1e-4 of a float64 run
   on the card, save → load → apply bitwise equal, featurization and fit
   once each; then one fit under ``fusion_disabled()`` whose test scores
   must equal the fused fit's to 1e-6 (both peaks printed);
6. serve_mnist — phase 5's fused fitted pipeline saved, loaded through
   ``ModelRegistry.load_fitted`` (which re-fuses) and served by
   ``PipelineServer`` (max_batch 64, max_wait 2 ms, queue 1,024) after
   warming every bucket: 256 requests one after another (the
   single-request floor), then 8 client threads sending 512 test rows
   each with at most 64 in flight (offered load), then the same load
   again while the same artifact is published as version 2 once half of
   it is answered (hot swap), and the same load on a one-node model
   (``MaxClassifier`` over the raw rows: the server's own cost). Every
   served label must equal ``apply_batch`` on the same rows; sheds,
   timeouts, failures, retries and ``cufft_plans_since_warmup`` must be
   0, and no request may be dropped. The fused and unfused batch
   applications of one 64-row batch are counted. Then ``python -m
   keystone_tpu_torch serve --model PATH --max-batch 16 --queue-depth
   256`` in a subprocess answers 256 JSON lines with the same labels;
7. mnist_small_cpu — 1,024 rows, 2 FFTs, block 512 on the card and on
   the CPU: scores within 1e-4, predictions equal, fused plans;
8. stream_fit — the JAX package's streaming bench leg at its full size
   (``bench.py::_bench_streaming``): 131,072 host records of 768 uint8
   values → ``RandomSignNode`` → ``LinearRectifier`` →
   ``BlockLeastSquaresEstimator(512, reg=1e-3)`` with 16 targets from a
   CPU ``ArrayDataset``, chunks of 16,384 rows, prefetch 4. Fit warm,
   then timed, streamed and under ``streaming_disabled()``: one
   ``StreamFit`` node over [RandomSignNode, LinearRectifier], no
   fallback, 8 chunks, 109,576,192 bytes uploaded, host buffers ≤ 5
   chunks, no new chunk shape after the first chunk, host-clock and
   CUDA-event overlap, streamed predictions within 1e-5 of the
   materialized ones (both printed against a float64 fit), and both fits'
   wall time and peak device memory; then the same fit from a
   CUDA-resident dataset, which must upload nothing;
9. solver_precision — ``torch.set_float32_matmul_precision("high")``
   after the port is imported, then ``mnist_small_cpu``'s fit on the card:
   scores within 1e-5 of the same fit at "highest", IEEE fp32 solver
   products launched, ``allow_tf32`` as read during each fit printed;
   and whether a Cholesky factor and solve (PyTorch's cuSOLVER) change
   under the global;
10. gram_modes — a (1,000,000, 1,024) Gram per product kind (bf16 inputs,
   ``default``, ``high``, ``highest``): median of 5 by CUDA events after a
   warm-up, TFLOP/s against the card's data-sheet peak for the kind; on a
   (65,536, 1,024) slice each kind against its plain emulation (inputs
   rounded to nearest, fp32 products) and against float64: ``default``
   ≤ 1e-5 from its emulation, ``highest`` ≤ 1e-5 from float64 and
   ``default`` at least 10× further;
11. timit_exact — ``bench.py::_bench_timit_exact`` at full size:
   ``LinearMapEstimator(reg=1e-2)`` at (2,200,000, 1,024, 138) under
   ``refine``, ``highest`` and ``default`` (one warm fit, median of 3),
   weights against ``centered_solve_refined(gram_precision="highest",
   refine_steps=2)``, ``train_mse`` on 65,536 rows, whether the refine
   guard fired, peak memory;
12. timit_wide_block — ``bench.py::_bench_timit_wide_block`` at full size:
   ``block_coordinate_descent_rematerialized`` at (2,200,000, 16,384),
   block 1,024, k = 138, one epoch (one warm fit, median of 3), beside
   the reference system's 580,555 ms on 16 Spark nodes; a (65,536,
   4,096) run must equal the materialized BCD;
13. timit — ``pipelines/timit.py`` at the published width (50 × 4,096
   cosine features, block 4,096, 5 epochs, λ by the estimator's floor)
   on ``synthetic_timit`` 4,096 / 1,024 rows: ``fit_s``, errors, peak,
   nodes executed, scores against a float64 BCD of the same blocks
   (training rows ≤ 1e-5, held-out rows ≤ 0.15: ``TIMIT_FP64_TEST_TOL``
   says why); then
   ``python -m keystone_tpu_torch timit --num-cosines 4`` in a subprocess,
   errors within 0.003 of the JAX package's;
14. host_streaming_bcd — ``BlockLeastSquaresEstimator(1,024, reg=1e-3)``
   on a (131,072, 8,192) float32 CPU tensor (4.3 GB > the 4e9-byte
   threshold, so the fit streams by itself): predictions within 1e-5 of
   the in-core fit of the same rows on the card, bytes uploaded, wall
   time and a peak of a few panels;
15. reliability — the OOM degradation ladder, executor retry, spans and
   the profile store under the ported fits, each printed on its own line:
   ``oom_real`` refits phase 14's matrix at block 4,096 under
   ``torch.cuda.set_per_process_memory_fraction``, capped midway between
   what an uncapped block-2,048 fit reserved and the 4,096 rung's panel:
   rung 0 must fail with a real ``OutOfMemoryError``, the model carry
   ``degradation`` {rung 2,048, rung_index 1, first_rung 4,096}, the
   recovery log one ``degrade`` event, the rung counter grow by 2, the
   card's allocated bytes be back at their pre-fit value as rung 1 starts,
   and predictions lie within 1e-5 of the uncapped 2,048 fit;
   ``oom_injected_sparse`` refits phase 3's rows under an OOM injected at
   ``BlockLeastSquaresEstimator.solve``'s first call: block 4,096 → 2,048,
   two ELL launches, scores within 1e-5 of a direct 2,048 fit; ``retry``
   fits ``mnist_default``'s pipeline with a ``RetryPolicy`` and one
   transient fault at a fused branch: one retry, scores bitwise equal to
   a clean fit; ``traced_fit`` fits ``mnist_full``'s pipeline untraced
   (three times, beside PR 6's ``fit_s``) and under ``trace()``: one
   ``node:*`` span and one node-seconds observation per executed node,
   the optimizer's batch spans and rule counters, a ``solver:fit`` span
   under the estimator's node; ``profile_store`` reads the run's store
   (a fresh temporary file): ``solver:block_ls…`` entries with a
   torch/CUDA/card fingerprint that a fresh store hits, and a stored
   ``blocksparse:threshold`` of 0.0 for phase 3's rows bucket turning
   its dispatch from ``sparse`` to ``densify`` (and back once marked
   stale);
16. solver_ladder — the six rows of the JAX sweep's ``FULL_GRID``
   (``scripts/solver_comparison.py``): (500,000, 1,024, 138),
   (500,000, 2,048, 138) and (1,000,000, 1,024, 138) dense, drawn on the
   card, and (250,000, 1,024, 2), (250,000, 4,096, 2) and (250,000,
   16,384, 2) at density 0.005 (the sweep's 10^6 rows cut for the time
   cap: cuts 3, 4 and 10) as host CSR matrices. Each eligible rung of the sweep's
   ``solvers()`` (``exact``, ``block`` 1,024 × 3 epochs, ``lbfgs`` 20
   iterations; only ``sparse_lbfgs`` on the sparse rows) is timed after
   one warm fit (the host ``sparse_lbfgs`` cold), with its train MSE;
   every dense rung's predictions lie within 4e-6 of a float64 solve of
   its own objective. Then ``LeastSquaresEstimator(reg=1e-3)`` in a
   ``Pipeline`` under node-level optimization: the rung it picked under
   ``cuda_weights()``, every candidate's predicted cost, and whether the
   pick was the fastest rung measured (a gate on the rows at d = 4,096
   and 16,384, where the sketched rung must also price infinite and
   finite, below and above its 8,192 floor);
17. least_squares_ladder — ``LeastSquaresEstimator.fit`` (no optimizer)
   on phase 3's hashing-TF rows under ``FaultSpec(match=
   "LeastSquaresEstimator.solve", kind="oom", first_n=1)``: the first rung
   (``dense_lbfgs``) fails, the ``block`` rung fits through the ELL kernel
   (two launches). The spec's match is a substring of the block solver's
   own site too, whose ladder halves 4,096 → 2,048; scores within 1e-6 of
   a direct block fit at 2,048;
18. newsgroups — ``run_newsgroups`` on a synthetic 20-class directory tree
   of 2,828 train and 1,883 test documents (a quarter of 20news-bydate's
   11,314 / 7,532, cuts 5 and 17; Zipf vocabularies from the seed), 2-grams,
   100,000 common features: the vectorizer is exactly
   100,000 wide, naive Bayes's (π, θ) within 1e-5 of a float64 closed
   form on the card over the fit's own inputs; ``featurize_s``,
   ``densify_s``, ``fit_s``, ``apply_s`` from ``trace()``, test error and
   the host's peak RSS;
19. amazon_reviews — ``run_amazon`` on synthetic JSON-lines reviews
   (polarity lexicons plus Zipf filler), threshold 3.5, 2-grams, 100,000
   common features, 20 iterations, the reference's 65M rows cut to 8,192
   train / 2,048 test (a 3.3 GB dense train matrix; cuts 6 and 16): L-BFGS iterations,
   objective evaluations, the objective per iteration (non-increasing to
   the line search's 1e-6·|f| allowance), ``fit_s`` and accuracy;
20. sketched — ``bench.py::_bench_sketched`` at its full shape: 2,048 ×
   8,192 rows of effective rank 128, ``LinearRectifier(0) →
   LeastSquaresEstimator(reg=1e-3)`` through ``Pipeline.fit()`` with
   256-row chunks and ``KEYSTONE_SKETCH_SIZE=512``: the optimizer picks the
   sketched rung and the plan streams it (``SKETCH_FITS{countsketch}`` +1,
   no new chunk shape on the timed refit), predictions within 0.05 of the
   labels, the carry 16,828,448 B against a 268,697,600 B Gram (16.0×);
   then the SRHT variant (at the bench's λ it must raise or stay finite;
   it is compared at λ = 1, ``SK_SRHT_REG`` says why) and the in-core pick
   (``streaming_disabled()``: sketch-and-precondition), each model's
   predictions against the same fit on the CPU (``SK_CPU_TOL`` says why
   2e-4);
21. timit_sketched — TIMIT's featurizer at its published width (50 ×
   4,096 cosine features) as one chunk member over the raw 440-wide rows,
   fitted by ``LeastSquaresEstimator.fit_stream`` (which picks the
   sketched rung, CountSketch, s = 4,096) on 65,536 synthetic rows (cut 12) in 16
   chunks; the fit's wall split into fold, capture and finish (spans);
   the captured carry exactly 3,358,687,820 B; W within 1e-5 of a float64
   solve of the same carry with plain PyTorch on the card; K of that
   carry as one fp32 product and as the finish computes it, each against
   float64; the first chunk's buckets and signs equal the CPU's; test
   error on 16,384 rows beside the block solver's ``timit`` error (4,096
   rows, not gated); the peak under the card's memory;
22. kernel_ridge — ``KernelRidgeRegression`` at RandomPatchCifarKernel's
   configuration (γ = 2e-4, block 2,048, 1 epoch, permuter 12,334, λ =
   1e-3) on 25,000 / 5,000 (cut 13) synthetic class-centred rows of d = 800, k =
   10: fit and apply seconds, test error, scores against a float64 sweep
   in plain PyTorch (``KRR_FP64_TOL``), the same fit on the CPU at 4,096
   rows (``KRR_CPU_TOL``); the Nyström rung at 2,048 landmarks (its host
   solve's seconds from a span); an injected OOM at
   ``KernelRidgeRegression.solve`` that must land at block 1,024 with the
   scores of a direct 1,024 fit;
23. cifar_features — ``FusedConvFeaturizer`` at the reference CIFAR
   configuration (10,000 filters of 6×6×3 from ``bench.py::
   _bench_cifar_random_patch``'s seed, α = 0.25, pool 14 / stride 13,
   filter block 512): images/s on 2,048 uniform images (host clock,
   synchronised, median of 3 warm runs); on 256 of them the features
   within ``CIFAR_FUSED_TOL`` of the unfused ``Convolver → SymmetricRectifier
   → Pooler → ImageVectorizer`` chain (a 7.5 GB conv output), within
   ``CIFAR_FP64_TOL`` of the same formula in float64 on the card, and
   within ``CIFAR_TF32_TOL`` of themselves after
   ``torch.backends.cudnn.allow_tf32`` and
   ``torch.backends.cuda.matmul.allow_tf32`` are switched on;
24. cifar_random_patch_fused — ``bench.py::_bench_cifar_random_patch`` at
   full size: ``ConvBlockLeastSquaresEstimator(block_size=4,096,
   num_iter=1, reg=3,000, image_chunk=2,048)`` on 50,000 uniform images
   from seed 0 with random labels over 10 classes (20 blocks of 512
   filters; the (50,000, 80,000) feature matrix never exists), under the
   bench's halving ladder on n: ``end_to_end_fit_s`` (upload included),
   the fit's peak, whether the ladder stepped, one block's featurization
   over all rows; ``ConvBlockModel.apply`` on 2,048 images within
   ``CONV_APPLY_TOL`` of the mapper applied to ``FusedConvFeaturizer``
   output; a one-block fit (512 filters = 4,096 features, so one BCD
   epoch is the exact standardized ridge solve) whose predictions on the
   50,000 rows lie within ``CONV_ONE_BLOCK_FP64_TOL`` of a float64 ridge
   solve of the same features on the card;
25. cifar_workloads — the CLI's seven CIFAR workloads through
   ``pipelines/cifar.py::run`` on synthetic learnable CIFAR (10 prototype
   images N(128, 40²) plus N(0, 10²) noise, as
   ``tests/pipelines/test_cifar.py`` makes them) written as CIFAR-10
   binaries of 50,000 train and 10,000 test images and read back through
   ``load_cifar``: ``random_patch`` and ``random_patch_fused`` at 1,000
   filters, λ = 3,000, ε = 1e-5; ``random_patch_kernel`` at the config's
   defaults and λ = 1e-3; ``linear_pixels``; ``random``; both augmented
   variants on 5,000 training images × 10 crops. Each one's seconds,
   errors and peak; every test error below 0.2 and the block and fused
   variants' within 0.01 of each other; then ``python -m
   keystone_tpu_torch cifar-linear-pixels`` in a subprocess with the same
   test error;
26. voc — the VOC 2007 SIFT + Fisher-vector workload through
   ``pipelines/voc.py::run`` at the JAX CLI's default configuration
   (desc_dim 80, vocab 256, λ 0.5, 10⁶ PCA and GMM samples, 256×256,
   block 4,096: 24,030 descriptors of 128 per image, 40,960 features) on
   generated 500×375 JPEG tars of 1,024 train / 512 test images (cut 7; 20
   classes of oriented gratings, 1–3 per image; ``VOC_*`` says why the
   cut): its seconds split by node and span (ingest, SIFT, the sample
   draws, the PCA pick and fit, the host k-means++ seeding, Lloyd, EM and
   its iterations, Fisher encoding, the block solve, ``end_to_end_fit_s``,
   apply), SIFT images/s on a warm 256-image chunk by CUDA events, the
   peak (< 70 GB), MAP (≥ 0.5) and per-class APs; SIFT on the card
   against the CPU on 8 images (≥ 99.5% within 1, none further);
   descriptors and Fisher vectors bitwise equal under PyTorch's TF32
   switches; Fisher vectors against float64 (``VOC_FISHER_FP64_TOL``);
   the test scores against the same fit in float64
   (``VOC_SCORES_FP64_TOL``) and re-scored to the same MAP;
27. voc_cli — ``python -m keystone_tpu_torch voc-sift-fisher`` at the
   example script's flags on a 64-image tar, 10⁵ PCA and GMM samples (cut
   from 10⁶, ``VOC_CLI_FLAGS`` says why), in a subprocess beside
   ``run()`` on the same tar: the same MAP;
28. native_host — build the native host library (``g++``, into
   ``keystone_tpu_torch/native/build/``) and hold each host kernel against
   its counterpart in the port to the JAX tests' bounds: ``ks_dsift``
   against the card SIFT at 256×256 (≥ 99.5% within 1),
   ``ks_fisher_encode`` against ``FisherVector`` (rtol and atol 1e-3),
   ``ks_gmm_fit`` on planted clusters (each within 0.5, weights summing to
   1 ± 1e-4), and, where ``jpeglib.h`` exists, ``ks_decode_jpeg_batch``
   against PIL (mean absolute difference < 1.5) with the time of the VOC
   JPEGs' native decode; host ``ks_dsift`` images/s beside the card's;
29. imagenet — the ImageNet SIFT + LCS + Fisher-vector flagship through
   ``pipelines/imagenet.py::run`` at the reference configuration (13,165
   SIFT and 3,136 LCS descriptors per image, 4,096 features, 1,000
   classes) on generated 500×375 JPEG tars of 1,024 train / 500 test
   images (``IMAGENET_*`` says why the cut; cut 15): its seconds split by node and
   span (ingest, both extractors, the four sample draws, the PCA picks,
   each GMM's host seeding, Lloyd and EM with its iterations, Fisher
   encoding, the weighted solve and its path), SIFT and LCS images/s by
   CUDA events, the peak (< 70 GB), test and training top-5 error; the
   test scores against a float64 weighted solve of the fit's own
   features (``IMAGENET_SCORES_FP64_TOL``) and re-scored to the same
   top 5; SIFT and LCS on the card against the CPU; descriptors bitwise
   equal under PyTorch's TF32 switches;
30. imagenet_cli — ``python -m keystone_tpu_torch imagenet-sift-lcs-fv``
   at the defaults on a 64-image tar, in a subprocess beside ``run()`` on
   the same tar: the same top-5 error;
31. imagenet_native — ``run_native_resolution`` on the first 256 (cut 14) of
   512 JPEGs (cut 27) at five ImageNet sizes (granularity 32, 10⁶ PCA and GMM
   samples): the split by span, the peak, training top-5 error; over all
   512 the buckets and padding share and, on each bucket's first two
   images, the masked extractors' valid descriptors against each image's
   native-size run (equal counts, SIFT within one step, LCS to
   ``IMAGENET_LCS_STD_ABS``);
32. imagenet_streaming_ondevice — the fused streaming flagship through
   ``pipelines/imagenet_streaming.py::run_flagship_ondevice`` at the JAX
   package's defaults at 25,000 + 2,500 images (cut 11) of 256×256 generated on the
   card in batches of 64, 1,000 classes, the reference configuration's
   widths): codebook, encode, solve and predict seconds, images/s, the
   solve's path and largest class, the peak (< 20 GB), the test top-5
   error (< 50%); on one batch the fused encode against the op-by-op
   composition (``STREAM_FUSED_TOL``) and, on its first 8 images, against
   the CPU (``STREAM_CARD_VS_CPU_TOL``); the test scores of classes 0–47
   against a float64 weighted solve (``IMAGENET_SCORES_FP64_TOL``);
33. imagenet_native_streaming — ``run_native_resolution_streaming`` on
   phase 31's 512 JPEGs (granularity 32, buckets of ≤ 64 rows): its
   seconds and training top-5 error; the bucket shapes and padding share
   equal phase 31's; one bucket's fused encode against the op-by-op
   composition, and bit for bit again after ``save`` → ``load``;
34. imagenet_streaming_cli — ``python -m keystone_tpu_torch
   imagenet-native-streaming`` on phase 30's 64-image tar, in a subprocess
   beside the same run in this process: the same training top-5 error;
35. warm_flagship — ``utils/aot.py::warm_flagship`` at phase 32's bucket
   (64, 256, 256) and solver (50,000, 4,096, 1,000) shapes: seconds per
   shape;
36. stupid_backoff — ``pipelines/stupid_backoff.py::run`` on the CLI's
   2,000-line synthetic corpus and ``fit_language_model`` on 100,000 lines
   from the same generator (host Python): seconds, tokens, vocabulary,
   n-grams, every score in [0, 1]; the lemmatizer over
   ``tests/fixtures/corenlp_lemma_gold.json`` with the CPU test's agreement
   (337 of 337); one ``LinearDiscriminantAnalysis`` fit whose mapper
   applies on the card, its projection against float64 (``LDA_TOL``).
37. durable_fit — ``python -m keystone_tpu_torch fit`` at a TIMIT shape
   (1,048,576 host rows × 440, 147 targets, 16,384-row chunks: 64 chunks,
   checkpoints auto-armed every 32) in subprocesses, side by side where
   nothing orders them: an uninterrupted reference and two runs SIGKILLed
   at ``streaming.chunk`` call 48 (exit −9, one committed cursor at chunk
   32); then, on one killed run's store, the resume (``--expect-resume``:
   resumed from chunk 32, 32 chunks re-ingested, probe predictions ≤
   ``DURABLE_TOL`` from the reference, no resume entry left) and, on the
   other's, the training matrix drifted by 0.5 under
   ``KEYSTONE_VERIFY=strict`` (non-zero exit naming KV306; the entry
   survives: strict refuses the fit, not the entry). The same
   kill-and-resume with ``--solver sketch --ckpt-chunks 2`` at the CLI's
   default size (parity ≤ ``DURABLE_TOL``). Each commit's seconds and
   bytes and every process's wall are printed;
38. serve_checkpoint — ``python -m keystone_tpu_torch serve
   --checkpoint-dir D --digest P`` (P: the 12-hex prefix of phase 37's
   fitted entry, a ``LinearMapper`` over the chain's output) answers the
   64 probe rows through ``FitDemoScaler`` (2x + 0.5) within
   ``SERVE_CKPT_TOL`` of phase 37's predictions; a missing digest and an
   ambiguous one each exit non-zero; beside them phase 37's fit runs once
   more on the resumed store and is restored from it (``checkpoint_hit``,
   nothing streamed, equal predictions);
39. refit_cli — ``python -m keystone_tpu_torch refit`` at the JAX CLI's
   defaults (6 rounds, d = 16, 4 classes) against
   ``scripts/refit_smoke.sh``'s invariants: ≥ 2 publishes, exactly one
   rollback (at round 4), ≥ 1 skip, no dropped request, no new cuFFT
   plan after settling, the ledger's refit kinds, live accuracy above the
   stale model's + 0.15, the incremental fold faster than the scratch
   fit;
40. refit_full — ``run_refit_demo`` in this process at the README main
   path's width (MNIST random-FFT's linear head: d = 2,048, 10 classes),
   32,768 labeled rows per round (cut 8), 1,024-row chunks, the CLI's defaults
   otherwise: the same invariants, the round-1 candidate's weights ≤
   ``REFIT_FP64_TOL`` from a float64 solve of the same statistics, and
   per round ``fold_s``, the state save's seconds and bytes, the round's
   wall and the serving p50/p99 of that round's traffic, and scratch
   against incremental wall;
41. fleet_serve — phase 6's saved artifact behind ``python -m
   keystone_tpu_torch serve --model PATH --workers 2 --listen
   127.0.0.1:0 --max-batch 64``, worker 0 SIGKILLed at its 12th request
   (``KEYSTONE_FAULT_SPECS_WORKER_0``): 2,048 test rows over stdin and
   HTTP at once once both workers are ready, then a second wave after the
   restart. Every answer equals ``apply_batch``'s label, none dropped,
   requeued ≥ 1, ``worker_crash`` and ``worker_restart`` in the
   ``SERVE_STATS`` ledger, the restart inside its backoff budget,
   ``/healthz`` 200, the ``/metrics`` fleet counters monotonic across the
   restart, ``cufft_plans_since_warmup`` 0 on both workers, and the
   card's free memory (``mem_get_info``) given back by the kill. Then the
   JAX bench's multi-worker sweep in this process: fresh
   ``WorkerSupervisor`` fleets of 1 and 2 workers, 2,048 rows with 32 in
   flight, requests/s, client and worst-worker p99, each worker's
   ``init_s``;
42. fleet_elastic — a boot image of the artifact (buckets 1–64); one
   worker from it, one classic and one on a tampered manifest, each with
   an empty kernel build directory: the image worker places the bundled
   library and builds nothing, the classic one builds it with nvcc, the
   tampered one is refused by KV307 and serves through the classic path;
   seconds to ready and the first answer's ms of each. Then ``serve
   --workers 1 --autoscale --min-workers 1 --max-workers 3 --boot-image
   DIR --slo-p99-ms`` (2× phase 41's 1-worker p99; one row a batch,
   ``FLEET_REPLAY_MAX_BATCH`` says why) under a seeded
   ``bursty_offsets`` replay of 4 s (cut 9) through ``run_load`` (bursts
   at 2× its 1-worker requests/s, base 0.2×), then no traffic until it drains back
   to one worker: ≥ 1 ``scale_up`` and ``scale_down``, nothing dropped,
   ``slo`` transitions in the ledger, every answer's label equal;
43. fleet_publish — two card workers serving ``refit_full``'s incumbent
   head from a ``CheckpointStore``; ``SupervisorPublisher`` publishes the
   round-1 candidate and rolls it back while 8 clients send 2,048-wide
   rows: every worker acks each swap with its ``warmup_s``, nothing
   dropped, every answer within ``PUBLISH_TOL`` of the version that
   served it;
44. roofline_probe — ``obs/cost.py``'s roofline on the card: one 8,192²
   product per binding kind (IEEE fp32, TF32, bf16, fp64; CUDA events,
   min of 3) and a 1 GiB device copy, each > 0 and ≤ 1.05× the data
   sheet (67 / 495 / 989 / 67 TFLOP/s, 3.35 TB/s);
45. explain_card — ``explain`` in this process on the hashing-TF slice
   (phase 3's corpus and shape, one pass): its fit node's ELL facts equal
   phase 2's bound counts (2 launches); on the MNIST random-FFT pipeline
   at full width (16,384 rows); on ``explain``'s synthetic pipeline,
   clean (no drift event) and with ``--seed-drift 4`` (exactly one, the
   sentinel's band at 2×: ``EXPLAIN_DRIFT_RATIO`` says why); every node's
   share of its roofline ≤ 1.05;
46. tune_card — ``tune --tasks stream,solver,blocksparse`` at the JAX
   CLI's default shape (8,192 × 256, 4 classes; 6 candidates and 6 s a
   task) into a store of its own: winners under the three key families
   with ``source: tune``, ELL launches in the density sweep, the tuned
   crossover beside the 0.05 default; an MNIST fit under
   ``KEYSTONE_MEASURED_KNOBS=all`` then reads them (the override counter
   moves);
47. profile_card — ``profile`` (8,192 rows, 4 × 2,048, 64 served
   requests): valid Chrome JSON with a ``solver:fit`` span under a
   ``node:*`` span under ``profile``, and the Prometheus file's device
   memory gauges non-zero for each phase;
48. cosched — ``sched/demo.py``: the MNIST artifact served at 320
   requests/s while ``refit_full``'s head (d = 2,048, 10 classes) folds
   16,384 rows a round, serially and co-scheduled with a seeded
   preemption: nothing dropped, the preempted fold resumed from its
   cursor and published, the final states within 1e-6; serial against
   co-scheduled wall and serving p99;
49. trace_fleet — ``python -m keystone_tpu_torch trace`` with two card
   workers serving a synthetic 64-wide pipeline, 64 HTTP requests: every
   request answered, the merged trace holding the front end and both
   workers, none in ``fragments_missing``;
50. obs_cli — on the host: ``bench-diff`` between artifacts made of this
   run's phase lines (itself: OK; one dropped request: a regression; a
   CPU baseline: counts only) and ``quality`` (clean: exit 0; a 3σ shift:
   exit 2 with one rollback);
51. check_card — the static verification tier (``workflow/verify.py``,
   ``lint/``, ``check``), run after ``cosched`` on phase 6's saved MNIST
   artifact: (a) under ``KEYSTONE_VERIFY=strict`` the README's MNIST
   random-FFT plan (8,192 rows, 784 → 4 × 512 → 10) and the hashing-TF →
   block-sparse slice's plan (65,536 documents, d = 16,384) verified by
   ``Pipeline.fit``'s hook and fitted: 0 errors, and 0 ELL launches,
   binding calls and allocated bytes during verification; the slice's fit
   launches the ELL kernel twice; (b) the MNIST plan over a 783-wide
   source: ``fit`` raises ``VerificationError`` with KV101 and nothing
   launched, called or allocated; (c) the MNIST plan over a ``meta`` source
   of 2^25 rows against the card's memory: one KV302 warning, nothing
   allocated; (d) ``check --pipeline`` on the artifact with phase 6's
   warmed buckets (exit 0), one bucket left unwarmed (exit 1, KV301), a
   783-wide request (exit 1, KV101), each reporting 0 launches, calls and
   bytes, and ``check --lint --concurrency`` over the port (exit 0,
   torch-free) — four subprocesses started at once; the phase fails past
   15 s. After the control-plane phases a ``verify_run`` line sums every
   verification the fit and load hooks ran in this process (reports,
   diagnostics by code, seconds): 0 errors outside (b)'s seeded refusal,
   and the torch ops that no shape rule answered
   (``workflow/shape_rules.py``), which made the process import torch's
   Python ``meta`` kernels.

52. mesh_collectives — the multi-device tier (ROADMAP item 14a) on one
   card: an N-shard mesh names ``cuda:0`` N times. Each of the six
   collectives (``parallel/collectives.py``) on 8 shards of 1,024 × 1,024,
   held against its definition on the whole tensor (≤ 1e-5), every
   result on the card, with CUDA-event milliseconds;
53. sharded — ``bench.py::_bench_sharded``'s two fits at its full sizes
   through ``Pipeline.fit`` and the partition batch on 1-, 2-, 4- and
   8-shard meshes: an in-core ``BlockLeastSquaresEstimator`` fit of
   65,536 × 1,024 (k = 16) and a streamed one of 8 host chunks of 8,192
   × 768 (k = 8); per shard count the wall, peak, ``shards_chosen`` and
   collective bytes (equal to ``SHARDED_JAX``, the JAX package's own plan
   counters), predictions against the 1-shard fit (≤ 1e-5);
54. sharded2d — ``_bench_sharded2d``'s width (d = 8,192, k = 8) at
   65,536 card-resident rows in 8 chunks, streamed through
   ``LinearMapEstimator`` on the 8×1, 4×2 and 2×4 layouts of an 8-shard
   mesh: plan counters equal to ``SHARDED2D_JAX``, per-shard carry bytes
   falling by the model-shard count, predictions against 8×1 (≤ 1e-5);
   the sketched rung (2,048 sketch rows) on 8×1 and 2×4 likewise;
55. mesh_legs — the legs of ``__graft_entry__.py::dryrun_multichip`` that
   the tier covers, at its 8-device sizes: featurize + BCD + the exact
   fit through the partition batch, the partitioned streamed fit, the
   2-D solver and ``block_sharded_apply``, the weighted solver and the
   ``all_to_all`` shuffle, host-streamed BCD — each against its closed
   form or 1-shard run; then the hashing-TF slice's fit (phase 3's rows)
   under an 8-shard mesh: 2 ELL launches, scores equal to the 1-shard
   fit's. Walls do not fall with the shard count on one card (the
   ``note`` field); no phase gates a speed.

Where the compiler finds no ``jpeglib.h`` the script prints
``native_decode: unavailable (no jpeglib.h)`` and every VOC and ImageNet
phase decodes with PIL (``use_native=False``, passed explicitly).

Phases 4–14, 16, 18–44 and 47–50 reach no ELL kernel: each sets its
count to 0 and fails if it moved; phase 15 launches it only in
``oom_injected_sparse``, phase 17 exactly twice, phase 45 in the hashing-TF
fit (twice in its node) and the auto-cache planner's sample fits, phase
46 in the density sweep's sparse legs, phase 51 twice in its slice fit
and never during a verification, phases 52–54 never, phase 55 twice
(its block-sparse leg under the 8-shard mesh). Inside ``solver_ladder`` a
``cost_constants_fit`` line fits the cost model's weights to the rungs'
times (``keystone_tpu_torch/tools/solver_comparison.py``). Every phase
starts from a reset ``PipelineEnv`` and reports its peak device memory
and the solver binding's calls per product kind (``ops/cuda/gemm.py``).
Phases 37–39 and 41–43 run their work in other processes (``python -m
keystone_tpu_torch`` subprocesses, serving workers): their counts and
peaks are the children's own, from the ``device_counts`` of each
``FIT_STATS:`` / ``SERVE_STATS:`` / ``REFIT_STATS:`` line or each
worker's final stats; the SIGKILLed, the refused and the retired runs
print none and are listed as not measured.

It prints a ``{"library_bindings": [...]}`` line (the cuBLAS binding, not
a TPU kernel), a ``{"kernels": [...]}`` line, the card's name and power
limit from nvidia-smi, and last ``{"ok": true, "device": {...}}``. It exits
non-zero, printing no result, where no CUDA device is available.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# Slice configuration: the block-sparse bench corpus scaled up.
TOPICS, DOCS_PER_TOPIC, VOCAB_PER_TOPIC, SEED = 1024, 64, 12, 11
NUM_FEATURES, NUM_CLASSES, BLOCK_SIZE, REG = 16384, 20, 4096, 1e-3
REQUESTS, REQUEST_DOCS = 4, 1024
KERNEL_TOL, SLICE_TOL = 1e-5, 1e-4

# MNIST random-FFT path. The JAX package's errors on the same synthetic
# data, which the port must reproduce to MNIST_ERROR_TOL. Produced on the
# CPU (one device, default environment) by
#   python -c "from keystone_tpu.pipelines.mnist_random_fft import *;
#              r = run(MnistRandomFFTConfig()); print(r['train_error'], r['test_error'])"
# and, for MNIST's own sizes, by
#   cfg = MnistRandomFFTConfig(); p = build_pipeline(cfg, synthetic_mnist(60000, seed=0))
#   evaluated with MulticlassClassifierEvaluator(10) on p(train.data) and on
#   p(synthetic_mnist(10000, seed=1).data).
MNIST_DEFAULT_JAX = {"train_error": 0.117431640625, "test_error": 0.60986328125}
MNIST_FULL_JAX = {"train_error": 0.2911833, "test_error": 0.4028}
MNIST_ERROR_TOL = 0.002
MNIST_TRAIN_ROWS, MNIST_TEST_ROWS = 60000, 10000
# The JAX package's plans for this pipeline, operator labels sorted, as
#   p = build_pipeline(MnistRandomFFTConfig(num_ffts=F), synthetic_mnist(N))
#   sorted(op.label for op in PipelineEnv.get_or_create().optimizer.execute(p.graph)[0].operators.values())
#   sorted(op.label for op in p.fit().graph.operators.values())
# print them on the CPU (F = 4, N = 8,192 and F = 2, N = 1,024): a fused
# sign → FFT → ReLU node per branch on each side of the fit, no StreamFit.
FUSED_BRANCH = "Fused[RandomSignNode+PaddedFFT+LinearRectifier]"


def jax_fit_plan(num_ffts: int, rows: int) -> list:
    return sorted(
        ["BlockLeastSquaresEstimator", "ClassLabelIndicators", f"Dataset[n={rows}]",
         f"Dataset[n={rows}]", "DelegatingOperator", "Gather", "Gather", "MaxClassifier",
         "VectorCombiner", "VectorCombiner"] + [FUSED_BRANCH] * (2 * num_ffts)
    )


def jax_fitted_plan(num_ffts: int) -> list:
    return sorted(
        ["Fused[BlockLinearMapper+MaxClassifier]", "Gather", "VectorCombiner"]
        + [FUSED_BRANCH] * num_ffts
    )


# mnist_full's fit peak on an H100 before the port had a fusion pass
# (PERF.md).
MNIST_FULL_UNFUSED_PEAK = 3960183808
FUSION_TOL = 1e-6

# Streaming fit: the JAX package's streaming bench leg, full size
# (bench.py::_bench_streaming).
STREAM_ROWS, STREAM_CHUNK, STREAM_D, STREAM_K = 131072, 16384, 768, 16
STREAM_PREFETCH, STREAM_BLOCK, STREAM_REG, STREAM_TOL = 4, 512, 1e-3, 1e-5
ROOT = os.path.dirname(os.path.abspath(__file__))

# Solver phases: the JAX package's bench shapes (bench.py).
GRAM_ROWS, GRAM_D, GRAM_SLICE, GRAM_TOL = 1_000_000, 1024, 65_536, 1e-5
EXACT_N, EXACT_D, EXACT_K, EXACT_REG = 2_200_000, 1024, 138, 1e-2
WIDE_N, WIDE_D, WIDE_K, WIDE_BLOCK, WIDE_REG = 2_200_000, 16_384, 138, 1024, 1e-2
# bench.py::TIMIT_WIDE_BASELINE_MS: the reference KeystoneML system's block
# solver at this shape on a 16-node Spark cluster
# (scripts/solver-comparisons-final.csv:26 of the reference).
WIDE_SPARK_16_NODE_MS = 580_555.0
STREAM_BCD_N, STREAM_BCD_D, STREAM_BCD_K, STREAM_BCD_BLOCK = 131_072, 8192, 16, 1024
STREAM_BCD_REG, STREAM_BCD_TOL = 1e-3, 1e-5
# The JAX package's TIMIT errors at 4 cosine branches (d = 16,384, the
# defaults otherwise: 4,096 / 1,024 synthetic rows, block 4,096, 5
# epochs, λ floor), produced on the CPU by
#   python -c "from keystone_tpu.pipelines.timit import *;
#              r = run(TimitConfig(num_cosines=4)); print(r['train_error'], r['test_error'])"
TIMIT4_JAX = {"train_error": 0.0, "test_error": 0.9921875}
TIMIT_ERROR_TOL = 0.003
# The published-width TIMIT fit's scores against the same BCD in float64
# (relative Frobenius). n = 4,096 rows against 4,096-wide blocks: each
# centred block Gram has rank ≤ 4,095 and only the λ floor (1e-6 of its
# mean diagonal) holds its null space, so fp32 rounding moves the weights
# along directions the training rows do not see. Training scores agree
# closely (2.8e-6 on an H100); held-out scores do not (8.0e-2, 87.7% of
# predictions equal). Bounds: the training scores at the slice's 1e-5,
# the held-out scores at 0.15.
TIMIT_FP64_TRAIN_TOL, TIMIT_FP64_TEST_TOL = 1e-5, 0.15

# NVIDIA H100 SXM data sheet peaks (dense, at 700 W): HBM3 bytes/s and
# fp32 FLOP/s outside the tensor cores (the kernel runs fp32 FFMA).
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


# Durable fits: a TIMIT-shaped stream (440 raw features, 147 targets) of
# 2^20 host rows in 64 chunks, so checkpoints auto-arm (≥ 10^6 rows) every
# 32 chunks; the kill lands at chunk 48, between the commit at 32 and the
# end. Resumed and uninterrupted fits fold the same chunks in the same
# order: 1e-5 relative covers the solve's fp32 reorderings.
DURABLE_ROWS, DURABLE_DIM, DURABLE_CLASSES, DURABLE_CHUNK = 1_048_576, 440, 147, 16_384
DURABLE_KILL_CALL, DURABLE_CURSOR, DURABLE_TOL = 48, 32, 1e-5
# Served answers against the fit's own probe predictions: the same mapper
# applied at another batch size (bucket 16 against 64 rows).
SERVE_CKPT_TOL = 1e-6
# Refit at the README main path's width; candidate weights against a
# float64 solve of the same statistics.
# Cut 8: 32,768 labeled rows a round (was 65,536); width, classes
# and chunk rows stay.
REFIT_FULL = {"d": 2048, "classes": 10, "rows_per_round": 32_768, "chunk_rows": 1024}
REFIT_FP64_TOL = 1e-5

# The serving fleet (phases 41–43): worker processes on this one card,
# each with its own CUDA context. 2,048 MNIST test rows; worker 0
# SIGKILLed at its 12th request (scripts/serve_chaos_smoke.sh's chaos);
# clients hold a window of requests in flight, as a pool of callers
# does, so the supervisor's admission bound (1,024 outstanding, the SLO
# rungs' 0.3–0.6 of it) never sheds: the sweep 64, the fleet phases 256.
# Each worker's own queue (--queue-depth) holds whatever the supervisor
# dispatches to it.
FLEET_ROWS, FLEET_KILL_AT, FLEET_SWEEP_WINDOW, FLEET_WINDOW = 2048, 12, 64, 256
# Cut 23: 1,024 rows (the sweep's and the kill leg's traffic, the
# autoscaling replay's payloads, serving_partition's requests); the
# worker count, the kill at the 12th request and the windows stay.
FLEET_ROWS = FLEET_ROWS // 2
# The autoscaling replay's fleet serves one row a batch. The serve
# process's ingress (parsing each line and re-encoding its 784 floats for
# the worker, ~1.7 ms a request on the card machine's host) caps what
# reaches a worker below what a worker serves at 64 rows a batch, so no
# worker queues and neither the SLO controller (which reads the workers'
# p99) nor the autoscaler has anything to react to (PERF.md §6: at 64 a
# batch no burst's p99 reached the 126 ms target). One row a batch (the
# apply's ~1.1 ms per batch on every row) makes the worker the bottleneck
# of a burst, as a model without batching gains would be.
FLEET_REPLAY_MAX_BATCH = 1
FLEET_WORKER_QUEUE, FLEET_BUCKETS = 4096, (1, 2, 4, 8, 16, 32, 64)
# The autoscaling replay: bursts at 2× the 1-worker requests/s, a base
# of 0.2×, bursts of 2 s and quiet stretches of 4 s
# on average over 10 s, seeded; then up to 60 s of no traffic for the
# scale-down (the autoscaler's 4 s idle and 8 s cooldown, a worker's
# drain).
# Cut 9: a 4 s replay (was 10 s) at the same burst schedule (2 s bursts
# at 2×, 4 s quiet at 0.2× the 1-worker rate). At one row a batch the
# fleet serves far below the burst rate, so the replay's wall is the
# offered count over that rate: 9,154 requests took 25 s in a 6 s trace.
FLEET_TRACE_S, FLEET_BURST_S, FLEET_QUIET_S, FLEET_TRACE_SEED = 4.0, 2.0, 4.0, 7
# Cut 18: 1,024 requests of that schedule, evenly thinned. Its rates
# follow the measured one-worker rate, so the count offered in 4 s varied
# with the host (1,167, 2,571 and 4,177 requests on three H100 hosts, the
# phase 45–67 s). Thinning keeps the schedule's shape: a burst stays ten
# times the quiet rate and above what one worker serves at one row a
# batch (~290 requests/s on the card), so the autoscaler still has a
# burst to meet, and the replay's length no longer follows the host.
FLEET_REPLAY_REQUESTS = 1024
# Publish across the fleet: each answer against the version that served
# it, applied in this process to all probe rows at once (another batch
# shape than the worker's bucket: fp32 products round in another order).
PUBLISH_ROWS, PUBLISH_CLIENTS, PUBLISH_TOL = 512, 8, 1e-6


def topic_corpus(topics, docs_per_topic, seed, vocab_per_topic=VOCAB_PER_TOPIC):
    """The block-sparse bench generator (RandomState, topic-grouped
    documents of 5–14 tokens from a per-topic vocabulary), joined into
    strings; label = topic % NUM_CLASSES."""
    rng = np.random.RandomState(seed)
    docs, labels = [], []
    for topic in range(topics):
        vocab = [f"t{topic}w{j}" for j in range(vocab_per_topic)]
        for _ in range(docs_per_topic):
            length = 5 + int(rng.randint(0, 10))
            docs.append(" ".join(vocab[int(rng.randint(0, vocab_per_topic))] for _ in range(length)))
            labels.append(topic % NUM_CLASSES)
    return docs, np.asarray(labels, np.int32)


def featurizer(num_features):
    from keystone_tpu_torch.ops.nlp.text import HashingTF, LowerCase, Tokenizer, Trim

    return Trim().to_pipeline().then(LowerCase()).then(Tokenizer()).then(HashingTF(num_features))


def rel_err(got, want) -> float:
    import torch

    return float((got - want).double().norm() / want.double().norm().clamp_min(1e-30))


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: Each phase's last line, by phase (``obs_cli`` diffs some of them).
PHASE_LINES: dict = {}


def log(phase: str, **fields) -> None:
    PHASE_LINES[phase] = fields
    print(json.dumps({"phase": phase, **fields}), flush=True)


# -------------------------------------------------------------- phase 1


def phase_build() -> None:
    from keystone_tpu_torch.ops.cuda import _build

    from keystone_tpu_torch.ops.cuda import gemm

    t0 = time.perf_counter()
    paths = _build.build(["ell_matmul", "solver_gemm"])
    build_s = time.perf_counter() - t0
    print(_build.build_log("ell_matmul").strip(), flush=True)
    gemm._lib()
    # -lcublas names the toolkit's libcublas.so.12; the loader must reuse
    # the one PyTorch loaded (same soname): one cuBLAS in the process.
    with open("/proc/self/maps") as maps:
        mapped = sorted({line.split()[-1] for line in maps if "libcublas.so" in line})
    ldd = subprocess.run(["ldd", str(paths["solver_gemm"])], capture_output=True, text=True).stdout
    log("build", seconds=build_s, nvcc_seconds=_build.build_seconds, cublas_mapped=mapped,
        ldd_cublas=[ln.strip() for ln in ldd.splitlines() if "cublas" in ln])
    if len(mapped) != 1:
        raise AssertionError(f"expected one libcublas in the process, found {mapped}")


# -------------------------------------------------------------- phase 2


def check_kernel(idx, blocks, b, counts=None):
    """Kernel vs plain version on the same inputs; raises past the bound."""
    import torch

    from keystone_tpu_torch.ops.cuda import blocksparse as bs

    out = bs.ell_matmul(idx, blocks, b, counts)
    torch.cuda.synchronize()
    ref = bs.ell_matmul_reference(idx, blocks, b, counts)
    rel = rel_err(out, ref)
    max_abs = float((out - ref).abs().max()) if out.numel() else 0.0
    shape = {"indices": list(idx.shape), "blocks": list(blocks.shape), "b": list(b.shape),
             "counts": counts is not None}
    if not (rel <= KERNEL_TOL and torch.isfinite(out).all()):
        raise AssertionError(f"ell_matmul disagrees with its plain version: rel {rel} at {shape}")
    return rel, max_abs, shape


def edge_cases(device):
    """Without counts: tiles (128, 8) and (3, 5), ragged N, padded slots,
    duplicate blocks, an operand that is not 16-byte aligned. With counts
    (junk in the padded slots: NaN blocks, out-of-range indices): rows of
    count 0, the narrow tile at N = 20 and N = 1, bm = 128 with bn = 8,
    an unaligned operand."""
    import torch

    rng = np.random.RandomState(5)
    cases = []
    for nbr, k_slots, bm, bn, nbc, n, dup, unaligned, with_counts in (
        (9, 4, 128, 8, 12, 131, False, False, False),
        (7, 3, 3, 5, 6, 37, True, False, False),
        (64, 5, 16, 16, 40, 300, True, False, False),
        (16, 3, 16, 16, 8, 64, False, True, False),
        (4, 2, 128, 128, 3, 64, True, False, False),
        (5, 3, 1, 1, 9, 1, False, False, False),
        (64, 6, 16, 16, 40, 300, True, False, True),
        (64, 6, 16, 16, 40, 20, False, False, True),
        (13, 4, 16, 16, 9, 1, False, False, True),
        (9, 4, 128, 8, 12, 131, False, False, True),
        (16, 3, 16, 16, 8, 64, False, True, True),
        (16, 3, 16, 16, 8, 20, False, True, True),
    ):
        idx = rng.randint(0, nbc, size=(nbr, k_slots)).astype(np.int32)
        if dup:
            idx[:, 1] = idx[:, 0]
        blocks = rng.randn(nbr, k_slots, bm, bn).astype(np.float32)
        counts = None
        if with_counts:
            counts = rng.randint(0, k_slots + 1, size=nbr).astype(np.int32)
            counts[0], counts[1] = 0, k_slots
            padded = np.arange(k_slots)[None, :] >= counts[:, None]
            blocks[padded] = np.nan
            idx[padded] = rng.choice([-7, nbc, 10**6], size=int(padded.sum()))
            counts = torch.from_numpy(counts).to(device)
        else:
            idx[:, -1], blocks[:, -1] = 0, 0.0  # padded slot
        b = torch.from_numpy(rng.randn(nbc * bn, n).astype(np.float32)).to(device)
        if unaligned:
            storage = torch.zeros(b.numel() + 1, device=device)
            b = storage[1:].view(b.shape).copy_(b)
        rel, max_abs, shape = check_kernel(
            torch.from_numpy(idx).to(device), torch.from_numpy(blocks).to(device), b, counts
        )
        cases.append({"shape": shape, "rel_err": rel, "max_abs_err": max_abs})
    return cases


def library_call(bsr_t, b):
    """One PyTorch call computing (Aᵀ)_bsr @ b: cuSPARSE's BSR product
    where PyTorch has it for fp32, else a dense fp32 matmul of Aᵀ."""
    import torch

    from keystone_tpu_torch.ops.cuda import blocksparse as bs

    dp, mp = bsr_t.padded_shape
    try:
        sparse = torch.sparse_bsr_tensor(
            torch.from_numpy(bsr_t.indptr.astype(np.int64)).to(b.device),
            torch.from_numpy(bsr_t.indices.astype(np.int64)).to(b.device),
            torch.from_numpy(bsr_t.blocks).to(b.device),
            size=(dp, mp),
        )
        sparse @ b
        torch.cuda.synchronize()
        return (lambda: sparse @ b), "torch.sparse_bsr_tensor @ dense"
    except (RuntimeError, NotImplementedError) as exc:
        print(f"BSR @ dense unavailable for fp32 ({exc!s:.200}); timing a dense matmul", flush=True)
        dense_t = bs.bsr_to_dense(bsr_t, b.device)
        return (lambda: torch.matmul(dense_t, b)), "torch.matmul of dense fp32 A^T"


def cold_cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call with L2 flushed before each call (a
    256 MB write, five times the 50 MB L2), by CUDA events around the
    call alone."""
    import torch

    flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
    fn()
    total = 0.0
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def phase_kernels(device):
    """Check the kernel at the slice's shapes (with and without counts)
    and at the edge cases; time it in turns with the library call:
    kernel, library, kernel. The kernel is timed through the wrapper the
    slice's fit calls (argument checks and launch, no read-back)."""
    import torch

    from keystone_tpu_torch.ops.cuda import blocksparse as bs
    from keystone_tpu_torch.ops.nlp.text import block_sparse_features
    from keystone_tpu_torch.workflow.executor import PipelineEnv

    PipelineEnv.reset()
    torch.cuda.reset_peak_memory_stats()
    train, labels = topic_corpus(TOPICS, DOCS_PER_TOPIC, SEED)
    rows = featurizer(NUM_FEATURES)(train).get().collect()
    bsr = block_sparse_features(rows)
    bsr_t = bsr.transpose()
    idx, blocks, counts = bs.ell_tensors(bsr_t, device)
    a = bs.bsr_to_dense(bsr, device)
    y = torch.full((a.shape[0], NUM_CLASSES), -1.0, device=device)
    y[torch.arange(len(labels), device=device), torch.from_numpy(labels).long().to(device)] = 1.0
    bm, bn = bsr_t.block_shape
    nnzb = bsr_t.nnz_blocks
    shapes = []
    for name, b in (("AtA", a), ("AtY", y)):
        rel, max_abs, shape = check_kernel(idx, blocks, b, counts)
        rel_all_slots, _, _ = check_kernel(idx, blocks, b)
        n = b.shape[1]
        out_bytes = idx.shape[0] * bm * n * 4
        # What these inputs need: the stored slots' indices and blocks,
        # the counts, b and the output, each once.
        moved = nnzb * 4 + counts.numel() * 4 + nnzb * bm * bn * 4 + b.numel() * 4 + out_bytes
        flops = 2.0 * nnzb * bm * bn * n
        bound_ms = max(moved / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS) * 1e3
        reps = 5 if name == "AtA" else 50
        kernel_fn = lambda: bs._ell_matmul_host_counts(idx, blocks, b, counts)
        lib_fn, lib_name = library_call(bsr_t, b)
        turns = {"kernel": [], "library": []}
        for who, fn in (("kernel", kernel_fn), ("library", lib_fn), ("kernel", kernel_fn)):
            turns[who].append(cuda_ms(fn, reps=reps))
        plain_ms = cuda_ms(lambda: bs.ell_matmul_reference(idx, blocks, b, counts), reps=3)
        ref = bs.ell_matmul_reference(idx, blocks, b, counts)
        lib_rel = rel_err(lib_fn(), ref)
        del lib_fn, ref
        kernel_ms = sum(turns["kernel"]) / len(turns["kernel"])
        entry = {
            "call": name, **shape, "rel_err": rel, "rel_err_all_slots": rel_all_slots,
            "max_abs_err": max_abs, "ms": kernel_ms, "ms_turns": turns["kernel"],
            "plain_ms": plain_ms, "library_ms": turns["library"][0],
            "library_call": lib_name, "library_rel_err": lib_rel,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if moved / PEAK_BYTES_PER_S >= flops / PEAK_FP32_FLOPS else "operations",
            "bytes": moved, "useful_flops": flops,
            "useful_tflops_per_s": flops / kernel_ms / 1e9,
            "padded_slot_share": 1.0 - nnzb / idx.numel(),
        }
        if name == "AtY":
            entry["ms_l2_flushed"] = cold_cuda_ms(kernel_fn, reps=20)
        shapes.append(entry)
        log("kernel_shape", **entry)
    del a, y, idx, blocks, counts
    torch.cuda.empty_cache()
    gram_bsr = check_gram_bsr(bsr, device)
    log("gram_bsr", **gram_bsr)
    edges = edge_cases(device)
    log("kernel_edges", cases=edges, peak_device_bytes=torch.cuda.max_memory_allocated())
    main = shapes[0]
    return {
        "name": "ell_matmul",
        "route": "cuda",
        "source": "keystone_tpu_torch/ops/cuda/csrc/ell_matmul.cu",
        "replaces": "keystone_tpu/ops/pallas/blocksparse.py:159",
        "launches": None,  # filled from the slice run
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "max_rel_err": max([s["rel_err"] for s in shapes] + [c["rel_err"] for c in edges]),
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        "library_call": main["library_call"],
        "timed_shape": "AtA",
        "shapes": shapes,
        "gram_bsr_launches": gram_bsr["ell_launches"],
    }


def check_gram_bsr(bsr, device) -> dict:
    """``linalg.gram`` of the hashing-TF ``BlockSparseMatrix`` (the entry
    point that reaches the ELL kernel through ``bsr_gram_totals``) against
    the dense Gram of the same matrix at IEEE fp32: ≤ ``KERNEL_TOL``, with
    the kernel launched."""
    import torch

    from keystone_tpu_torch.ops.cuda import blocksparse as bs
    from keystone_tpu_torch.parallel import linalg

    before = bs.ell_matmul.launches
    g, _ = linalg.gram(bsr, device=device)
    launches = bs.ell_matmul.launches - before
    n, d = bsr.shape
    a = bs.bsr_to_dense(bsr, device)[:n, :d]
    with linalg.solver_mode_scope("highest"):
        dense = linalg.mm_t(a, a)
    del a
    rel = rel_err(g, dense)
    out = {"shape": [n, d], "ell_launches": launches, "rel_err_vs_dense": rel,
           "max_abs_err": float((g - dense).abs().max())}
    del g, dense
    torch.cuda.empty_cache()
    if launches < 1 or not rel <= KERNEL_TOL:
        raise AssertionError(f"linalg.gram(BlockSparseMatrix) failed: {out}")
    return out


# -------------------------------------------------------------- phase 3


def run_slice(train, labels, test, test_labels, device, block_size=None):
    """Fit on ``train``, answer ``REQUESTS`` prediction requests over
    ``test``; returns the model, scores, predictions and timings."""
    import torch

    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.evaluation.multiclass import MulticlassClassifierEvaluator
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.util.labels import ClassLabelIndicators, MaxClassifier
    from keystone_tpu_torch.ops.util.vectors import Densify

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    feat = featurizer(NUM_FEATURES)
    rows = feat(train).get()
    y = ClassLabelIndicators(NUM_CLASSES)(ArrayDataset(labels, device=device)).get()
    t_feat = time.perf_counter()
    model = BlockLeastSquaresEstimator(
        block_size or BLOCK_SIZE, num_iter=1, reg=REG, device=device
    ).fit(rows, y)
    sync()
    t_fit = time.perf_counter()
    classify = feat.then(Densify(device=device)).then(model) >> MaxClassifier()
    size = len(test) // REQUESTS
    preds, request_s = [], []
    for r in range(REQUESTS):
        t_req = time.perf_counter()
        preds.append(classify(test[r * size : (r + 1) * size]).get().data)
        sync()
        request_s.append(time.perf_counter() - t_req)
    pred = torch.cat(preds)
    metrics = MulticlassClassifierEvaluator(NUM_CLASSES).evaluate(pred, test_labels[: len(pred)])
    return {
        "rows": rows, "y": y, "model": model, "pred": pred,
        "featurize_s": t_feat - t0, "fit_s": t_fit - t_feat, "request_s": request_s,
        "test_error": metrics.total_error,
    }


def scores(model, test, device):
    from keystone_tpu_torch.ops.util.vectors import Densify

    return (featurizer(NUM_FEATURES).then(Densify(device=device)).then(model))(test).get().data


def fp64_reference_scores(bsr, y, test, device):
    """Test scores of the same one-epoch BCD fit run in float64 on the
    dense centered matrix — the yardstick both fp32 paths are read
    against."""
    import torch

    from keystone_tpu_torch.ops.cuda import blocksparse as bs
    from keystone_tpu_torch.ops.util.vectors import Densify
    from keystone_tpu_torch.parallel import linalg

    n, d = bsr.shape
    x = bs.bsr_to_dense(bsr, device)[:n, :d].double()
    yd = y[:n].double()
    mu_a, mu_b = x.mean(dim=0), yd.mean(dim=0)
    x -= mu_a
    w = linalg.block_coordinate_descent(x, yd - mu_b, REG, 1, BLOCK_SIZE)
    del x
    xt = Densify(device=device).apply_batch(featurizer(NUM_FEATURES)(test).get()).data.double()
    return ((xt - mu_a) @ w + mu_b).float()


def fit_breakdown(rows, y, device, model):
    """The block-sparse fit of ``BlockLeastSquaresEstimator`` step by
    step, as ``_fit_blocksparse`` runs it, with a host clock and
    ``torch.cuda.synchronize()`` around each step: host BSR build, host
    transpose + ELL, uploads (with the device scatter of dense A), the
    two kernel launches, and the centered finish + BCD solve. The weights
    must match ``model``'s. It is a copy of those steps, and it leaves out
    two branches of ``_fit_blocksparse`` that this configuration does not
    take: the λ floor for reg ≤ 0 and the padding of d to whole solver
    blocks; it raises where either would apply."""
    import torch

    from keystone_tpu_torch.ops.cuda import blocksparse as bs
    from keystone_tpu_torch.parallel import linalg
    from keystone_tpu_torch.utils.sparse import BlockSparseMatrix

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize()

    steps = {}
    sync()
    t = time.perf_counter()

    def lap(name):
        nonlocal t
        sync()
        now = time.perf_counter()
        steps[name] = now - t
        t = now

    items = rows.collect()
    d = int(items[0].shape[-1])
    bsr = BlockSparseMatrix.from_csr_rows(items, bs.default_block_shape(d))
    if bsr.density() > bs.density_threshold():
        raise AssertionError("the breakdown's rows left the block-sparse path")
    block = min(model.block_size, d)
    if REG <= 0 or d % block:
        raise AssertionError("the breakdown covers reg > 0 and d in whole solver blocks only")
    lap("from_csr_rows_s")
    bsr_t = bsr.transpose()
    idx_np, blocks_np = bsr_t.to_ell()
    counts_np = np.diff(bsr_t.indptr).astype(np.int32)
    lap("transpose_to_ell_s")
    n = bsr.shape[0]
    mp, _ = bsr.padded_shape
    idx, blocks, counts = (torch.from_numpy(v).to(device) for v in (idx_np, blocks_np, counts_np))
    a = bs.bsr_to_dense(bsr, device)
    yd = y.data.to(device=device, dtype=torch.float32)[:n]
    yp = torch.zeros(mp, yd.shape[1], device=device)
    yp[:n] = yd
    lap("upload_s")
    g = bs._ell_matmul_host_counts(idx, blocks, a, counts)
    c = bs._ell_matmul_host_counts(idx, blocks, yp, counts)
    totals = (g[:d, :d], c[:d], a.sum(dim=0)[:d], yp.sum(dim=0))
    lap("kernels_s")
    gc, cc, _, _ = linalg.gram_stream_finish(totals, n)
    w = linalg.bcd_from_gram(gc, cc, reg=REG, num_epochs=1, block_size=block)
    lap("finish_bcd_s")
    steps["total_s"] = sum(steps.values())
    steps["weights_rel_to_fit"] = rel_err(w, model.weights)
    if not steps["weights_rel_to_fit"] <= SLICE_TOL:
        raise AssertionError(f"the step-by-step fit differs from the estimator's: {steps}")
    return steps


def phase_slice(device):
    """Phase 3. Returns the kernel's launches in the fit and the fitted
    rows, labels and test documents."""
    import torch

    from keystone_tpu_torch.ops.cuda import blocksparse as bs
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.nlp.text import block_sparse_features
    from keystone_tpu_torch.workflow.executor import PipelineEnv

    train, labels = topic_corpus(TOPICS, DOCS_PER_TOPIC, SEED)
    test, test_labels = topic_corpus(TOPICS, REQUESTS * REQUEST_DOCS // TOPICS, SEED + 1)

    from keystone_tpu_torch.ops.cuda import gemm

    PipelineEnv.reset()
    torch.cuda.reset_peak_memory_stats()
    bs.ell_matmul.launches = 0
    gemm.reset_launches()
    out = run_slice(train, labels, test, test_labels, device)
    launches = bs.ell_matmul.launches
    gemm_launches = SOLVER_GEMM_CALLS["hashing_tf"] = dict(gemm.launches)
    peak = torch.cuda.max_memory_allocated()
    if launches != 2:
        raise AssertionError(f"the fit launched the ELL kernel {launches} times, expected 2")
    pred = out["pred"]
    if tuple(pred.shape) != (len(test),) or pred.min() < 0 or pred.max() >= NUM_CLASSES:
        raise AssertionError(f"bad predictions: shape {tuple(pred.shape)}")
    bsr = block_sparse_features(out["rows"])
    s_sparse = scores(out["model"], test, device)
    if tuple(s_sparse.shape) != (len(test), NUM_CLASSES) or not torch.isfinite(s_sparse).all():
        raise AssertionError("scores are not finite or of the wrong shape")

    os.environ["KEYSTONE_BLOCKSPARSE"] = "off"
    try:
        t0 = time.perf_counter()
        dense_model = BlockLeastSquaresEstimator(BLOCK_SIZE, num_iter=1, reg=REG, device=device).fit(
            out["rows"], out["y"]
        )
        torch.cuda.synchronize()
        dense_fit_s = time.perf_counter() - t0
    finally:
        del os.environ["KEYSTONE_BLOCKSPARSE"]
    s_dense = scores(dense_model, test, device)
    dense_rel = rel_err(s_sparse, s_dense)
    del dense_model
    s_fp64 = fp64_reference_scores(bsr, out["y"].data, test, device)
    sparse_vs_fp64 = rel_err(s_sparse, s_fp64)
    dense_vs_fp64 = rel_err(s_dense, s_fp64)
    log("slice_accuracy", sparse_vs_dense_scores_rel=dense_rel,
        sparse_vs_fp64_scores_rel=sparse_vs_fp64, dense_vs_fp64_scores_rel=dense_vs_fp64)
    if bs.ell_matmul.launches != launches:
        raise AssertionError("the dense in-core fit launched the block-sparse kernel")
    if not dense_rel <= SLICE_TOL:
        raise AssertionError(f"sparse-path scores differ from the dense path by {dense_rel}")

    breakdown = fit_breakdown(out["rows"], out["y"], device, out["model"])
    log("fit_breakdown", **breakdown)

    # Small input: the same fit on the card (kernel) and on the CPU
    # (plain version).
    small_train, small_labels = topic_corpus(32, 16, SEED)
    small_test, small_test_labels = topic_corpus(32, 4, SEED + 1)
    cpu = torch.device("cpu")
    on_card = run_slice(small_train, small_labels, small_test, small_test_labels, device, 128)
    on_cpu = run_slice(small_train, small_labels, small_test, small_test_labels, cpu, 128)
    small_rel = rel_err(on_card["model"].weights.cpu(), on_cpu["model"].weights)
    if not small_rel <= SLICE_TOL or not torch.equal(on_card["pred"].cpu(), on_cpu["pred"]):
        raise AssertionError(f"small fit on the card differs from the CPU: weights rel {small_rel}")

    result = {
        "documents": len(train), "features": NUM_FEATURES, "classes": NUM_CLASSES,
        "block_shape": list(bsr.block_shape), "density": bsr.density(),
        "stored_blocks": bsr.nnz_blocks, "blocks_skipped": bsr.blocks_skipped(),
        "featurize_s": out["featurize_s"], "fit_s": out["fit_s"],
        "request_s": out["request_s"], "request_docs": len(test) // REQUESTS,
        "test_error": out["test_error"], "peak_device_bytes": peak,
        "ell_launches_in_fit": launches, "solver_gemm_launches": gemm_launches,
        "dense_fit_s": dense_fit_s, "sparse_vs_dense_scores_rel": dense_rel,
        "small_card_vs_cpu_weights_rel": small_rel,
    }
    log("slice", **result)
    # The featurized rows, labels and held-out documents, for phase 15.
    return launches, {"rows": out["rows"], "y": out["y"], "test": test}


# -------------------------------------------------------------- phases 4-6
#
# The MNIST random-FFT path (README's main path): graph, optimizer,
# executor, featurizers and the dense in-core solve. It reaches no ELL
# kernel; each phase sets the kernel's count to 0 before it and checks it
# is still 0 after.


def _mapper_of(fitted):
    """The fitted pipeline's ``BlockLinearMapper`` (scores before argmax)."""
    from keystone_tpu_torch.ops.learning.block import BlockLinearMapper

    ops = fitted.graph.operators.values()
    members = [m for op in ops for m in getattr(op, "members", (op,))]  # inside fused chains too
    mappers = [m for m in members if isinstance(m, BlockLinearMapper)]
    if len(mappers) != 1:
        raise AssertionError(f"expected one BlockLinearMapper in the fitted pipeline, found {len(mappers)}")
    return mappers[0]


def _mnist_start():
    """Fresh pipeline state, peak memory and ELL count for one phase."""
    import torch

    from keystone_tpu_torch.ops.cuda import blocksparse as bs
    from keystone_tpu_torch.workflow.executor import PipelineEnv

    from keystone_tpu_torch.ops.cuda import gemm

    PipelineEnv.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    bs.ell_matmul.launches = 0
    gemm.reset_launches()


def _mnist_end(phase: str, ell_allowed: bool = False) -> dict:
    """The phase's peak memory, ELL launches and solver-binding calls per
    product kind; raises if the ELL kernel was launched unless
    ``ell_allowed``."""
    import torch

    from keystone_tpu_torch.ops.cuda import blocksparse as bs
    from keystone_tpu_torch.ops.cuda import gemm

    torch.cuda.synchronize()
    if bs.ell_matmul.launches != 0 and not ell_allowed:
        raise AssertionError(f"{phase} launched the ELL kernel {bs.ell_matmul.launches} times")
    SOLVER_GEMM_CALLS[phase] = dict(gemm.launches)
    return {"peak_device_bytes": torch.cuda.max_memory_allocated(), "ell_launches": bs.ell_matmul.launches,
            "solver_gemm_launches": dict(gemm.launches)}


#: Solver-binding calls per product kind, by phase (filled as phases end).
SOLVER_GEMM_CALLS: dict = {}


def _child_end(phase: str, reports: dict, unmeasured: list) -> dict:
    """``_mnist_end`` for a phase whose work runs in ``python -m
    keystone_tpu_torch`` subprocesses: this process must have launched no
    ELL kernel, and the phase's counts are the children's own, from the
    ``device_counts`` of their stats lines (``reports``, by run), summed
    with this process's binding calls. Raises if a child printed no counts
    or launched the ELL kernel. ``unmeasured`` names the runs that print no
    stats line (SIGKILLed or refused processes): their counts are not
    measured."""
    parent = _mnist_end(phase)
    counts = {}
    for name, stats in reports.items():
        if not isinstance(stats.get("device_counts"), dict):
            raise AssertionError(f"{phase}: run {name!r} printed no device_counts")
        counts[name] = stats["device_counts"]
    ell = sum(c["ell_launches"] for c in counts.values())
    if ell != 0:
        raise AssertionError(f"{phase} launched the ELL kernel {ell} times in its subprocesses")
    calls = {k: n + sum(c["solver_gemm_launches"][k] for c in counts.values())
             for k, n in parent["solver_gemm_launches"].items()}
    SOLVER_GEMM_CALLS[phase] = calls
    return {"ell_launches": ell, "solver_gemm_launches": calls,
            "peak_device_bytes": {name: c["peak_device_bytes"] for name, c in counts.items()},
            "this_process_peak_device_bytes": parent["peak_device_bytes"], "runs_not_measured": unmeasured}


def _check_errors(phase: str, got: dict, want: dict) -> None:
    for name, ref in want.items():
        if not abs(got[name] - ref) <= MNIST_ERROR_TOL:
            raise AssertionError(f"{phase}: {name} {got[name]} is not within {MNIST_ERROR_TOL} of {ref}")


def plan_labels(graph) -> list:
    return sorted(str(op.label) for op in graph.operators.values())


def fusion_dispatches():
    """(fused, unfused) batch applications counted so far."""
    from keystone_tpu_torch.obs import names

    counter = names.metric(names.FUSION_BATCH_DISPATCHES)
    return counter.value(fused="1"), counter.value(fused="0")


def phase_mnist_default(device) -> int:
    """``run(MnistRandomFFTConfig())`` on the card, then the CLI in a
    subprocess."""
    from keystone_tpu_torch.pipelines.mnist_random_fft import (
        MnistRandomFFTConfig, build_pipeline, run, synthetic_mnist,
    )
    from keystone_tpu_torch.workflow.executor import PipelineEnv

    _mnist_start()
    out = run(MnistRandomFFTConfig(), device=device)
    env = PipelineEnv.get_or_create()
    nodes_executed = env.nodes_executed
    # The fitted plan of the pipeline run() evaluated (its fit is reused
    # from the state table, not run again), and the optimized fit plan of
    # the same pipeline built again from fresh state.
    fitted_plan = plan_labels(out["pipeline"].fit().graph)
    PipelineEnv.reset()
    cfg = MnistRandomFFTConfig()
    rebuilt = build_pipeline(cfg, synthetic_mnist(8192, seed=cfg.seed, device=device), device=device)
    fit_plan = plan_labels(PipelineEnv.get_or_create().optimizer.execute(rebuilt.graph)[0])
    if fit_plan != jax_fit_plan(4, 8192) or fitted_plan != jax_fitted_plan(4):
        raise AssertionError(f"mnist_default: plans {fit_plan} / {fitted_plan} are not the JAX package's")
    # A second run in the same process: what of the first run's seconds
    # is one-time set-up (library loading, cuFFT plans).
    PipelineEnv.reset()
    second_s = run(cfg, device=device)["seconds"]
    result = {"train_error": out["train_error"], "test_error": out["test_error"],
              "seconds": out["seconds"], "seconds_second_run": second_s,
              "optimized_fit_plan": fit_plan, "fitted_plan": fitted_plan,
              "nodes_executed": nodes_executed, **_mnist_end("mnist_default")}
    _check_errors("mnist_default", result, MNIST_DEFAULT_JAX)
    cmd = [sys.executable, "-m", "keystone_tpu_torch", "mnist-random-fft",
           "--num-ffts", "4", "--block-size", "2048"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[1:])} exited {proc.returncode}: {proc.stderr[-2000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    if line.get("workload") != "mnist-random-fft":
        raise AssertionError(f"the CLI printed no workload line: {proc.stdout[-500:]}")
    _check_errors("mnist_default CLI", line, MNIST_DEFAULT_JAX)
    result["cli"] = {"line": line, "seconds": time.perf_counter() - t0}
    log("mnist_default", **result)
    return 0


def mnist_test_scores(cfg, fitted, test, device):
    """Test scores (before argmax) of a fitted MNIST pipeline: the same
    featurizer, then the fitted pipeline's ``BlockLinearMapper``."""
    from keystone_tpu_torch.pipelines.mnist_random_fft import build_featurizer

    features = build_featurizer(cfg, device=device)(test.data).get().data
    return _mapper_of(fitted).apply_arrays(features)


def fp64_mnist_scores(cfg, train, test, device, block):
    """Test scores of the same pipeline with the features and the one-epoch
    BCD in float64 on ``device``, λ by the estimator's own floor rule."""
    import torch

    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.learning.block import _scale_aware_reg_floor
    from keystone_tpu_torch.parallel import linalg
    from keystone_tpu_torch.pipelines.mnist_random_fft import NUM_CLASSES, build_featurizer

    feat = build_featurizer(cfg, device=device)
    x = feat(ArrayDataset(train.data.data.double())).get().data
    n = x.shape[0]
    y = torch.full((n, NUM_CLASSES), -1.0, dtype=torch.float64, device=device)
    y[torch.arange(n, device=device), train.labels.data.long()] = 1.0
    mu_a, mu_b = x.mean(dim=0), y.mean(dim=0)
    x -= mu_a
    reg = cfg.reg or _scale_aware_reg_floor(x, n)
    w = linalg.block_coordinate_descent(x, y - mu_b, reg, 1, block)
    del x
    xt = feat(ArrayDataset(test.data.data.double())).get().data
    return (xt - mu_a) @ w + mu_b


def phase_mnist_full(device):
    """The slice at full width: MNIST's 60,000 / 10,000 rows, 4 FFTs,
    d = 2,048, k = 10, block 2,048, one epoch, through ``build_pipeline``
    and ``Pipeline.fit()``. Returns the fitted pipeline and the test set
    for ``phase_serve_mnist``."""
    import statistics
    from collections import Counter, defaultdict

    import torch

    from keystone_tpu_torch.evaluation.multiclass import MulticlassClassifierEvaluator
    from keystone_tpu_torch.pipelines.mnist_random_fft import (
        NUM_CLASSES, MnistRandomFFTConfig, build_pipeline, synthetic_mnist,
    )
    from keystone_tpu_torch.workflow.executor import PipelineEnv
    from keystone_tpu_torch.workflow.fusion import fusion_disabled
    from keystone_tpu_torch.workflow.pipeline import FittedPipeline
    from keystone_tpu_torch.workflow.tracing import trace

    cfg = MnistRandomFFTConfig()
    train = synthetic_mnist(MNIST_TRAIN_ROWS, seed=0, device=device)
    test = synthetic_mnist(MNIST_TEST_ROWS, seed=1, device=device)
    _mnist_start()
    env = PipelineEnv.get_or_create()
    pipeline = build_pipeline(cfg, train, device=device)
    t0 = time.perf_counter()
    optimized, _ = env.optimizer.execute(pipeline.graph)
    optimize_s = time.perf_counter() - t0
    fit_plan = plan_labels(optimized)
    if fit_plan != jax_fit_plan(cfg.num_ffts, MNIST_TRAIN_ROWS):
        raise AssertionError(f"mnist_full: optimized fit plan {fit_plan} is not the JAX package's")
    PipelineEnv.reset()  # the timed optimize above must not seed the fit's state
    env = PipelineEnv.get_or_create()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitted = pipeline.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_nodes = env.nodes_executed
    fit_peak = torch.cuda.max_memory_allocated()
    # Per-node times come from a second fit from fresh state under
    # ``trace()``, which forces and synchronizes after every node, so
    # ``fit_s`` above is not charged for that.
    PipelineEnv.reset()
    with trace() as tr:
        t0 = time.perf_counter()
        pipeline.fit()
        torch.cuda.synchronize()
        traced_fit_s = time.perf_counter() - t0
    counts = Counter(t.label for t in tr.timings)
    if counts[FUSED_BRANCH] != cfg.num_ffts or counts["BlockLeastSquaresEstimator"] != 1:
        raise AssertionError(f"the fit did not featurize once and fit once: {dict(counts)}")
    node_s = defaultdict(float)
    for t in tr.timings:
        node_s[t.label] += t.seconds

    fitted.apply_batch(test.data)  # warm-up
    apply_times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        test_pred = fitted.apply_batch(test.data).data
        torch.cuda.synchronize()
        apply_times.append(time.perf_counter() - t0)
    train_pred = fitted.apply_batch(train.data).data
    evaluator = MulticlassClassifierEvaluator(NUM_CLASSES)
    errors = {
        "train_error": evaluator.evaluate(train_pred, train.labels).total_error,
        "test_error": evaluator.evaluate(test_pred, test.labels).total_error,
    }
    _check_errors("mnist_full", errors, MNIST_FULL_JAX)
    if tuple(test_pred.shape) != (MNIST_TEST_ROWS,):
        raise AssertionError(f"bad prediction shape {tuple(test_pred.shape)}")

    with tempfile.TemporaryDirectory(dir=ROOT) as tmp:
        path = os.path.join(tmp, "mnist_fitted.pt")
        fitted.save(path)
        loaded = FittedPipeline.load(path, device=device)
        if not torch.equal(loaded.apply_batch(test.data).data, test_pred):
            raise AssertionError("save → load → apply changed the predictions")
    # One host (numpy) row through the fitted pipeline runs on the card
    # and predicts what the batch did.
    one = fitted.apply(test.data.data[7].cpu().numpy())
    if one.device.type != "cuda" or int(one) != int(test_pred[7]):
        raise AssertionError(f"single-datum apply gave {one} on {one.device}, batch {test_pred[7]}")

    fitted_plan = plan_labels(fitted.graph)
    if fitted_plan != jax_fitted_plan(cfg.num_ffts):
        raise AssertionError(f"mnist_full: fitted plan {fitted_plan} is not the JAX package's")
    s32 = mnist_test_scores(cfg, fitted, test, device)
    s64 = fp64_mnist_scores(cfg, train, test, device, cfg.block_size)
    fp64_rel = rel_err(s32, s64)
    if not fp64_rel <= SLICE_TOL:
        raise AssertionError(f"fp32 scores are {fp64_rel} from the float64 run")
    del s64

    # The same fit with fusion off: the same kernels in the same order.
    PipelineEnv.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with fusion_disabled():
        t0 = time.perf_counter()
        unfused = pipeline.fit()
        torch.cuda.synchronize()
        unfused_fit_s = time.perf_counter() - t0
    unfused_nodes = PipelineEnv.get_or_create().nodes_executed
    unfused_peak = torch.cuda.max_memory_allocated()
    unfused_rel = rel_err(s32, mnist_test_scores(cfg, unfused, test, device))
    unfused_pred_equal = torch.equal(unfused.apply_batch(test.data).data, test_pred)
    if not (unfused_rel <= FUSION_TOL and unfused_pred_equal):
        raise AssertionError(f"fused and unfused fits differ: scores rel {unfused_rel}")
    result = {
        "rows": [MNIST_TRAIN_ROWS, MNIST_TEST_ROWS], "features": cfg.num_ffts * 512,
        "optimized_fit_plan": fit_plan, "fitted_plan": fitted_plan,
        "optimize_s": optimize_s, "fit_s": fit_s, "traced_fit_s": traced_fit_s,
        "apply_s_per_10000_rows": statistics.median(apply_times) * 10000 / MNIST_TEST_ROWS,
        "apply_s_runs": apply_times, "node_s": dict(node_s), "node_counts": dict(counts),
        "nodes_executed_in_fit": fit_nodes, "fit_peak_device_bytes": fit_peak,
        "unfused_fit_peak_device_bytes_before_fusion_pass": MNIST_FULL_UNFUSED_PEAK,
        "unfused_fit_peak_device_bytes": unfused_peak, "unfused_fit_s": unfused_fit_s,
        "unfused_nodes_executed_in_fit": unfused_nodes, "unfused_plan": plan_labels(unfused.graph),
        "fused_vs_unfused_scores_rel": unfused_rel,
        "fused_vs_unfused_scores_bitwise": bool(unfused_rel == 0.0),
        **errors, "fp32_vs_fp64_scores_rel": fp64_rel, **_mnist_end("mnist_full"),
    }
    del unfused
    log("mnist_full", **result)
    return fitted, test


SERVE_FLOOR_REQUESTS, SERVE_CLIENTS, SERVE_ROWS_PER_CLIENT, SERVE_WINDOW = 256, 8, 512, 64
SERVE_CLI_REQUESTS = 256


def _served_labels(futures, timeout=60.0):
    return np.array([int(np.asarray(f.result(timeout=timeout))) for f in futures])


def _check_labels(phase, got, want, scores):
    """Served labels against ``apply_batch``'s; a mismatch prints the
    top-two score margin of its row, then raises."""
    bad = np.nonzero(got != want)[0]
    if len(bad):
        top2 = np.sort(scores[bad], axis=1)[:, -2:]
        log(f"{phase}_mismatches", rows=bad.tolist(), served=got[bad].tolist(),
            apply_batch=want[bad].tolist(), top2_margin=(top2[:, 1] - top2[:, 0]).tolist())
        raise AssertionError(f"{phase}: {len(bad)} served labels differ from apply_batch")


def _offered_load(server, rows, on_half=None, model=None):
    """``SERVE_CLIENTS`` threads, each submitting its ``SERVE_ROWS_PER_CLIENT``
    rows with at most ``SERVE_WINDOW`` in flight. Returns the served
    labels in row order, the per-request latencies (submit to result),
    the wall seconds and the interpreter's garbage-collection pauses in
    the run; ``on_half`` runs once half the requests are done."""
    import gc
    import threading

    n = SERVE_CLIENTS * SERVE_ROWS_PER_CLIENT
    futures = [None] * n
    latency = np.zeros(n)
    done = {"n": 0}
    lock = threading.Lock()
    half = threading.Event()
    errors = []

    def client(k):
        window = threading.Semaphore(SERVE_WINDOW)
        try:
            for i in range(k * SERVE_ROWS_PER_CLIENT, (k + 1) * SERVE_ROWS_PER_CLIENT):
                window.acquire()
                t_sub = time.monotonic()
                futures[i] = server.submit(rows[i], model=model)

                def finished(_, i=i, t_sub=t_sub):
                    latency[i] = time.monotonic() - t_sub
                    window.release()
                    with lock:
                        done["n"] += 1
                        if done["n"] == n // 2:
                            half.set()

                futures[i].add_done_callback(finished)
        except Exception as exc:  # surfaced below: a client must not die silently
            errors.append(exc)
            half.set()

    gc_started, gc_pauses = [0.0], []

    def on_gc(phase, info):  # collections run one at a time, under the GIL
        if phase == "start":
            gc_started[0] = time.perf_counter()
        else:
            gc_pauses.append((info["generation"], time.perf_counter() - gc_started[0]))

    threads = [threading.Thread(target=client, args=(k,)) for k in range(SERVE_CLIENTS)]
    gc.callbacks.append(on_gc)
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    if on_half is not None:
        half.wait(timeout=120)
        on_half()
    for t in threads:
        t.join(timeout=120)
    gc.callbacks.remove(on_gc)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"offered-load clients failed: {errors}")
    labels = _served_labels(futures)
    wall = time.perf_counter() - t0
    gc_stats = {
        "collections": len(gc_pauses),
        "gen2_collections": sum(1 for g, _ in gc_pauses if g == 2),
        "max_pause_ms": max((p for _, p in gc_pauses), default=0.0) * 1e3,
        "total_pause_ms": sum(p for _, p in gc_pauses) * 1e3,
    }
    return labels, latency.tolist(), wall, gc_stats


def _batch_breakdown(entry, rows, device, reps=20):
    """Median seconds of one full 64-row batch's steps, each ended by a
    synchronize: the pageable host→device copy, the apply, and the one
    device→host copy of its labels."""
    import statistics

    import torch

    from keystone_tpu_torch.data.dataset import ArrayDataset

    steps = {"h2d_s": [], "apply_s": [], "d2h_s": []}
    batch = np.ascontiguousarray(rows[:64])
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dataset = ArrayDataset(batch, device=device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = entry.batch_apply(dataset)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        out.data.cpu()
        t3 = time.perf_counter()
        for name, seconds in (("h2d_s", t1 - t0), ("apply_s", t2 - t1), ("d2h_s", t3 - t2)):
            steps[name].append(seconds)
    return {name: statistics.median(v) for name, v in steps.items()}


def phase_serve_mnist(device, fitted, test, path: str):
    """``mnist_full``'s fitted pipeline behind ``PipelineServer``: warm
    every bucket, the single-request floor, offered load from 8 clients
    with a hot swap in the middle, label parity with ``apply_batch``,
    then the ``serve`` CLI over stdin/JSON. The artifact is saved at
    ``path``, which the fleet phases serve again. Returns the launches,
    and the first ``FLEET_ROWS`` test rows with their ``apply_batch``
    labels."""

    import torch

    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.obs.metrics import percentile
    from keystone_tpu_torch.pipelines.mnist_random_fft import MnistRandomFFTConfig
    from keystone_tpu_torch.ops.util.labels import MaxClassifier
    from keystone_tpu_torch.serving import ModelRegistry, PipelineServer, ServingConfig
    from keystone_tpu_torch.workflow.pipeline import FittedPipeline

    _mnist_start()
    rows = test.data.data.cpu().numpy()  # clients send host rows
    n_load = SERVE_CLIENTS * SERVE_ROWS_PER_CLIENT
    # Reference labels and scores first: their shapes' cuFFT plans then
    # predate the server's warmup baseline.
    want = fitted.apply_batch(ArrayDataset(rows, device=device)).data.cpu().numpy()
    scores = mnist_test_scores(MnistRandomFFTConfig(), fitted, test, device).cpu().numpy()
    config = ServingConfig(max_batch=64, max_wait_ms=2.0, queue_depth=1024)
    result = {"max_batch": config.max_batch, "max_wait_ms": config.max_wait_ms,
              "queue_depth": config.queue_depth}
    fitted.save(path)
    registry = ModelRegistry()
    registry.load_fitted("mnist", path, device=device)
    server = PipelineServer(config=config, registry=registry, name="mnist", device=device)
    server.start()
    try:
        t0 = time.perf_counter()
        result["warmup_bucket_s"] = server.warmup(rows[0])["mnist"]
        result["warmup_s"] = time.perf_counter() - t0

        floor_latency, floor_futures = [], []
        for i in range(SERVE_FLOOR_REQUESTS):
            t_sub = time.monotonic()
            floor_futures.append(server.submit(rows[i]))
            floor_futures[-1].result(timeout=30)
            floor_latency.append(time.monotonic() - t_sub)
        _check_labels("serve_mnist floor", _served_labels(floor_futures),
                      want[:SERVE_FLOOR_REQUESTS], scores)
        result["floor"] = {
            "requests": SERVE_FLOOR_REQUESTS,
            "p50_ms": percentile(floor_latency, 50) * 1e3,
            "p99_ms": percentile(floor_latency, 99) * 1e3,
        }

        def swap():
            t_swap = time.perf_counter()
            registry.load_fitted("mnist", path, device=device)
            result["hot_swap_publish_s"] = time.perf_counter() - t_swap

        # Steady offered load, then the same load with a hot swap of
        # version 2 once half of it is answered.
        # The server's own cost at the same load: a one-node model
        # (MaxClassifier over the raw rows) behind the same server.
        null = MaxClassifier().to_pipeline()
        registry.publish("null", FittedPipeline(null.graph, null.source, null.sink))
        server.warmup(rows[0], models=["null"])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for run, on_half, model, run_want in (
            ("load", None, None, want),
            ("load_hot_swap", swap, None, want),
            ("load_null_model", None, "null", rows.argmax(axis=1)),
        ):
            before = server.stats()
            labels, latency, wall, gc_stats = _offered_load(server, rows, on_half=on_half, model=model)
            after = server.stats()  # before any work at a new shape
            _check_labels(f"serve_mnist {run}", labels, run_want[:n_load], scores)
            delta = {k: after[k] - before[k] for k in
                     ("served", "batches", "sheds", "timeouts", "failures", "retries")}
            result[run] = {
                "clients": SERVE_CLIENTS, "requests": n_load, "window_per_client": SERVE_WINDOW,
                "wall_s": wall, "requests_per_s": n_load / wall,
                "p50_ms": percentile(latency, 50) * 1e3,
                "p95_ms": percentile(latency, 95) * 1e3,
                "p99_ms": percentile(latency, 99) * 1e3,
                "max_ms": max(latency) * 1e3,
                "mean_batch_occupancy": delta["served"] / delta["batches"] / config.max_batch,
                **delta,
                "cufft_plans_since_warmup": after["cufft_plans_since_warmup"],
                "label_mismatches": 0,
                "gc": gc_stats,
            }
            if delta["served"] != n_load or any(delta[k] for k in ("sheds", "timeouts", "failures", "retries")):
                raise AssertionError(f"serve_mnist {run} dropped or failed requests: {delta}")
            if after["cufft_plans_since_warmup"] != 0:
                raise AssertionError(f"serving built {after['cufft_plans_since_warmup']} cuFFT plans after warmup")
        torch.cuda.synchronize()
        result["load_peak_device_bytes"] = torch.cuda.max_memory_allocated()
        result["models"] = after["models"]
        if after["models"]["mnist"]["current"] != 2 or registry.swaps != 1:
            raise AssertionError(f"the hot swap did not land: {after['models']}")
        result["batch_breakdown_64"] = _batch_breakdown(registry.resolve("mnist"), rows, device)
        # The registry serves the fused plan; count the batch
        # applications (fused chains and unfused nodes) of one 64-row batch.
        entry = registry.resolve("mnist")
        result["served_plan"] = plan_labels(entry.model.graph)
        if result["served_plan"] != jax_fitted_plan(4):
            raise AssertionError(f"serve_mnist: the served plan is not fused: {result['served_plan']}")
        fused0, unfused0 = fusion_dispatches()
        entry.batch_apply(ArrayDataset(np.ascontiguousarray(rows[:64]), device=device))
        fused1, unfused1 = fusion_dispatches()
        result["batch_applications_per_64_rows"] = {
            "fused": fused1 - fused0, "unfused": unfused1 - unfused0,
        }
    finally:
        server.stop()

    lines = "".join(
        json.dumps({"id": i, "x": rows[i].tolist()}) + "\n" for i in range(SERVE_CLI_REQUESTS)
    )
    cmd = [sys.executable, "-m", "keystone_tpu_torch", "serve", "--model", path,
           "--max-batch", "16", "--queue-depth", str(SERVE_CLI_REQUESTS)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, input=lines, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"serve CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    out = proc.stdout.strip().splitlines()
    stats = json.loads(out[-1][len("SERVE_STATS:"):]) if out[-1].startswith("SERVE_STATS:") else None
    responses = {r["id"]: r for r in map(json.loads, out[:-1])}
    if stats is None or sorted(responses) != list(range(SERVE_CLI_REQUESTS)) or len(out) != SERVE_CLI_REQUESTS + 1:
        raise AssertionError(f"serve CLI printed {len(out)} lines: {proc.stdout[-500:]}")
    if any("error" in r or "latency_ms" not in r for r in responses.values()):
        raise AssertionError(f"serve CLI answered with errors: {proc.stdout[-500:]}")
    cli_labels = np.array([responses[i]["y"] for i in range(SERVE_CLI_REQUESTS)])
    _check_labels("serve_mnist CLI", cli_labels, want[:SERVE_CLI_REQUESTS], scores)
    if stats["sheds"] != 0 or stats["served"] != SERVE_CLI_REQUESTS or stats.get("cufft_plans_since_warmup") != 0:
        raise AssertionError(f"serve CLI stats: {stats}")
    if stats["device_counts"]["ell_launches"] != 0:
        raise AssertionError(f"the serve CLI launched the ELL kernel: {stats['device_counts']}")
    result["cli"] = {"seconds": time.perf_counter() - t0, "requests": SERVE_CLI_REQUESTS,
                     "p50_ms": stats["p50_ms"], "p99_ms": stats["p99_ms"],
                     "sheds": stats["sheds"], "cufft_plans_since_warmup": stats["cufft_plans_since_warmup"],
                     "device_counts": stats["device_counts"]}
    log("serve_mnist", **result, **_mnist_end("serve_mnist"))
    return 0, rows[:FLEET_ROWS].copy(), want[:FLEET_ROWS].copy()


def phase_mnist_small_cpu(device) -> int:
    """1,024 rows, 2 FFTs, block 512, λ = 10, fit and applied on the card
    and on the CPU: scores within ``SLICE_TOL``, predictions equal."""
    import torch

    from keystone_tpu_torch.pipelines.mnist_random_fft import (
        MnistRandomFFTConfig, build_pipeline, synthetic_mnist,
    )
    from keystone_tpu_torch.workflow.executor import PipelineEnv

    cfg = MnistRandomFFTConfig(num_ffts=2, block_size=512, reg=10.0)
    _mnist_start()
    runs, nodes = [], []
    for dev in (device, torch.device("cpu")):
        PipelineEnv.reset()
        train = synthetic_mnist(1024, seed=0, device=dev)
        test = synthetic_mnist(256, seed=1, device=dev)
        pipeline = build_pipeline(cfg, train, device=dev)
        fit_plan = plan_labels(PipelineEnv.get_or_create().optimizer.execute(pipeline.graph)[0])
        PipelineEnv.reset()
        fitted = pipeline.fit()
        nodes.append(PipelineEnv.get_or_create().nodes_executed)
        fitted_plan = plan_labels(fitted.graph)
        if fit_plan != jax_fit_plan(2, 1024) or fitted_plan != jax_fitted_plan(2):
            raise AssertionError(f"mnist_small_cpu: plans on {dev} are not the JAX package's: {fit_plan} / {fitted_plan}")
        scores = mnist_test_scores(cfg, fitted, test, dev)
        runs.append((scores.cpu(), fitted.apply_batch(test.data).data.cpu()))
    (card_scores, card_pred), (cpu_scores, cpu_pred) = runs
    rel = rel_err(card_scores, cpu_scores)
    if not rel <= SLICE_TOL or not torch.equal(card_pred, cpu_pred):
        raise AssertionError(f"small MNIST fit on the card differs from the CPU: scores rel {rel}")
    log("mnist_small_cpu", card_vs_cpu_scores_rel=rel, optimized_fit_plan=fit_plan, fitted_plan=fitted_plan,
        nodes_executed_in_fit={"card": nodes[0], "cpu": nodes[1]}, **_mnist_end("mnist_small_cpu"))
    return 0


def stream_problem():
    """``_bench_streaming``'s data, drawn in its order from seed 17: the
    uint8 records, their float32 copy and the 16 noisy linear targets."""
    rng = np.random.default_rng(17)
    imgs = rng.integers(0, 256, size=(STREAM_ROWS, STREAM_D), dtype=np.uint8)
    w_true = rng.normal(size=(STREAM_D, STREAM_K)).astype(np.float32)
    x = imgs.astype(np.float32)
    y = (x @ w_true + 0.1 * rng.normal(size=(STREAM_ROWS, STREAM_K))).astype(np.float32)
    return imgs, x, y


def fp64_stream_predictions(imgs, y, signs, device):
    """Predictions on the training rows of the same one-epoch block fit
    (block 512, λ = 1e-3) run in float64 on the featurized rows."""
    import torch

    from keystone_tpu_torch.parallel import linalg

    x = torch.from_numpy(imgs).to(device).double()
    x = torch.clamp_min(x * signs.double(), 0.0)
    yd = torch.from_numpy(y).to(device).double()
    mu_a, mu_b = x.mean(dim=0), yd.mean(dim=0)
    x -= mu_a
    d_pad = -(-STREAM_D // STREAM_BLOCK) * STREAM_BLOCK
    xc = torch.nn.functional.pad(x, (0, d_pad - STREAM_D))
    w = linalg.block_coordinate_descent(xc, yd - mu_b, STREAM_REG, 1, STREAM_BLOCK)
    del xc
    return x @ w[:STREAM_D] + mu_b


def phase_stream_fit(device) -> int:
    """The streaming bench leg at full size, streamed and materialized
    (module docstring, phase 8)."""
    import torch

    from keystone_tpu_torch.data.dataset import ArrayDataset, ObjectDataset
    from keystone_tpu_torch.obs.spans import tracing_session
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.stats.core import LinearRectifier, RandomSignNode
    from keystone_tpu_torch.workflow.executor import PipelineEnv
    from keystone_tpu_torch.workflow.streaming import (
        StreamingFitOperator, last_stream_report, streaming_disabled,
    )

    os.environ["KEYSTONE_STREAM_CHUNK_ROWS"] = str(STREAM_CHUNK)
    os.environ["KEYSTONE_STREAM_PREFETCH"] = str(STREAM_PREFETCH)
    _mnist_start()
    t0 = time.perf_counter()
    imgs, x, y = stream_problem()
    records = [imgs[i] for i in range(STREAM_ROWS)]
    host_labels = ArrayDataset(y, device="cpu")
    data_s = time.perf_counter() - t0

    def build(data, labels=host_labels):
        feat = RandomSignNode.create(STREAM_D, seed=3, device=device).to_pipeline().then(LinearRectifier(0.0))
        est = BlockLeastSquaresEstimator(STREAM_BLOCK, num_iter=1, reg=STREAM_REG, device=device)
        return feat.then_label_estimator(est, data, labels)

    def timed_fit(pipe):
        """Warm fit, then a timed fit from a reset PipelineEnv under a
        tracing session: (fitted, seconds, peak bytes, stream:fit spans)."""
        PipelineEnv.reset()
        pipe.fit()
        PipelineEnv.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with tracing_session() as session:
            t0 = time.perf_counter()
            fitted = pipe.fit()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        return fitted, seconds, torch.cuda.max_memory_allocated(), session.find("stream:fit")

    def predict(fitted):
        return fitted.apply_batch(ArrayDataset(x, device=device)).data

    pipe = build(ObjectDataset(records))
    PipelineEnv.reset()
    plan, _ = PipelineEnv.get_or_create().optimizer.execute(pipe.graph)
    stream_ops = [op for op in plan.operators.values() if isinstance(op, StreamingFitOperator)]
    members = [type(m).__name__ for op in stream_ops for m in op.members]
    if len(stream_ops) != 1 or members != ["RandomSignNode", "LinearRectifier"]:
        raise AssertionError(f"stream_fit: expected one StreamFit over the sign and ReLU: {plan_labels(plan)}")

    # Diagnostic first: the same streamed fit with one prefetch worker
    # (the workers stack records under the interpreter lock).
    os.environ["KEYSTONE_INGEST_WORKERS"] = "1"
    try:
        _, one_worker_s, _, _ = timed_fit(pipe)
        one_worker_stall_s = last_stream_report().stall_s
    finally:
        del os.environ["KEYSTONE_INGEST_WORKERS"]
    fitted, stream_s, stream_peak, spans = timed_fit(pipe)
    rep = last_stream_report()
    fallbacks = [sp.attributes.get("fallback") for sp in spans]
    chunk_bytes = STREAM_CHUNK * STREAM_D + STREAM_CHUNK * STREAM_K * 4 + STREAM_CHUNK * 4
    checks = {
        "no_fallback": len(spans) == 1 and fallbacks == [None],
        "chunks": rep.chunks == STREAM_ROWS // STREAM_CHUNK,
        "bytes_transferred": rep.bytes_transferred == (STREAM_ROWS // STREAM_CHUNK) * chunk_bytes,
        "host_buffer_peak": rep.host_buffer_peak_bytes <= (STREAM_PREFETCH + 1) * chunk_bytes,
        "compiles_steady_state": rep.compiles_steady_state == 0,
        "overlap_ok": rep.overlap_ok(),
        "device_overlap_ok": rep.device_overlap_ok is True,
    }
    streamed = predict(fitted)
    report = {
        "chunks": rep.chunks, "chunk_rows": rep.chunk_rows, "bytes_transferred": rep.bytes_transferred,
        "host_buffer_peak_bytes": rep.host_buffer_peak_bytes, "one_chunk_bytes": chunk_bytes,
        "stall_s": rep.stall_s, "compiles_first_chunk": rep.compiles_first_chunk,
        "compiles_steady_state": rep.compiles_steady_state, "overlap_ok": rep.overlap_ok(),
        "device_overlap_ok": rep.device_overlap_ok, "device_copy_ms": rep.device_copy_ms,
        "device_compute_ms": rep.device_compute_ms, "upload_issued_t": rep.upload_issued_t,
        "dispatch_t": rep.dispatch_t, "compute_done_t": rep.compute_done_t,
    }
    del fitted, pipe

    with streaming_disabled():
        fitted_m, mat_s, mat_peak, _ = timed_fit(build(ObjectDataset(records)))
        materialized = predict(fitted_m)
        mat_plan = plan_labels(fitted_m.graph)
    del fitted_m

    signs = RandomSignNode.create(STREAM_D, seed=3, device=device).signs
    exact = fp64_stream_predictions(imgs, y, signs, device)
    errors = {
        "streamed_vs_materialized_rel": rel_err(streamed, materialized),
        "streamed_vs_fp64_rel": rel_err(streamed, exact),
        "materialized_vs_fp64_rel": rel_err(materialized, exact),
    }
    del exact

    # The same fit from CUDA-resident records and labels: chunks are
    # device slices, and nothing crosses the host link.
    resident = build(ArrayDataset(imgs, device=device), ArrayDataset(y, device=device))
    PipelineEnv.reset()
    resident_preds = predict(resident.fit())
    resident_rep = last_stream_report()
    errors["device_resident_vs_streamed_rel"] = rel_err(resident_preds, streamed)
    checks["device_resident_uploads_nothing"] = (
        resident_rep is not rep and resident_rep.chunks == rep.chunks
        and resident_rep.bytes_transferred == 0
    )
    checks["streamed_vs_materialized"] = errors["streamed_vs_materialized_rel"] <= STREAM_TOL
    checks["device_resident_vs_streamed"] = errors["device_resident_vs_streamed_rel"] <= STREAM_TOL
    finite = bool(torch.isfinite(streamed).all()) and tuple(streamed.shape) == (STREAM_ROWS, STREAM_K)
    checks["finite_predictions"] = finite
    result = {
        "rows": STREAM_ROWS, "d": STREAM_D, "k": STREAM_K, "prefetch": STREAM_PREFETCH,
        "data_s": data_s, "streamed_fit_s": stream_s, "materialized_fit_s": mat_s,
        "streamed_fit_s_one_worker": one_worker_s, "stall_s_one_worker": one_worker_stall_s,
        "streamed_fit_peak_device_bytes": stream_peak, "materialized_fit_peak_device_bytes": mat_peak,
        "materialized_plan": mat_plan, "fallbacks": fallbacks, "report": report, **errors,
        "device_resident_bytes_transferred": resident_rep.bytes_transferred,
        "checks": checks,
    }
    log("stream_fit", **result, **_mnist_end("stream_fit"))
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"stream_fit failed {failed}")
    return 0


# -------------------------------------------------------------- phases 9-14
#
# The solver slice: per-call precision on the cuBLAS binding, the JAX
# package's solver bench shapes, the TIMIT pipeline at its published
# width and host-streamed BCD. None reaches the ELL kernel.


def _precision_flags() -> list:
    import torch

    return [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision()]


def phase_solver_precision(device, flags_around_import) -> int:
    """``mnist_small_cpu``'s fit on the card with the global matmul
    precision at "highest" and then at "high" (set after the import):
    the solver products must stay IEEE fp32 — scores within 1e-5."""
    import torch

    from keystone_tpu_torch.ops.cuda import gemm
    from keystone_tpu_torch.pipelines.mnist_random_fft import (
        MnistRandomFFTConfig, build_pipeline, synthetic_mnist,
    )
    from keystone_tpu_torch.workflow.executor import PipelineEnv

    cfg = MnistRandomFFTConfig(num_ffts=2, block_size=512, reg=10.0)
    _mnist_start()
    runs = {}
    for precision in ("highest", "high"):
        torch.set_float32_matmul_precision(precision)
        try:
            PipelineEnv.reset()  # a fresh fit, not the first one's saved state
            before = dict(gemm.launches)
            fitted = build_pipeline(cfg, synthetic_mnist(1024, seed=0, device=device), device=device).fit()
            test = synthetic_mnist(256, seed=1, device=device)
            scores = mnist_test_scores(cfg, fitted, test, device)
            torch.cuda.synchronize()
            runs[precision] = {
                "scores": scores,
                "allow_tf32_during_fit": torch.backends.cuda.matmul.allow_tf32,
                "launches": {k: gemm.launches[k] - before[k] for k in gemm.launches},
            }
        finally:
            torch.set_float32_matmul_precision("highest")
    rel = rel_err(runs["high"]["scores"], runs["highest"]["scores"])
    # The factorisations stay on PyTorch's cuSOLVER / cuBLAS handles: do
    # they follow the global? A Cholesky factor and solve under each.
    g = torch.Generator(device=device).manual_seed(5)
    a = torch.randn(8192, 2048, device=device, generator=g)
    spd = torch.addmm(torch.eye(2048, device=device), a.T, a)
    rhs = torch.randn(2048, 16, device=device, generator=g)
    factored = {}
    for precision in ("highest", "high"):
        torch.set_float32_matmul_precision(precision)
        try:
            factor = torch.linalg.cholesky(spd)
            factored[precision] = (factor, torch.cholesky_solve(rhs, factor))
        finally:
            torch.set_float32_matmul_precision("highest")
    factorisations_equal = all(
        torch.equal(x, y) for x, y in zip(factored["high"], factored["highest"])
    )
    del a, spd, rhs, factored
    result = {
        "flags_before_import": flags_around_import[0], "flags_after_import": flags_around_import[1],
        "high_vs_highest_scores_rel": rel,
        "cholesky_and_solve_bitwise_equal_under_high": factorisations_equal,
        **{f"{p}_{k}": v for p, r in runs.items() for k, v in r.items() if k != "scores"},
        **_mnist_end("solver_precision"),
    }
    log("solver_precision", **result)
    if not (rel <= 1e-5 and runs["high"]["allow_tf32_during_fit"] and runs["high"]["launches"]["ieee_fp32"] > 0):
        raise AssertionError(f"solver_precision failed: {result}")
    return 0


def card_peaks() -> dict:
    """Data-sheet dense peaks (FLOP/s) of the card by its name: bf16, TF32
    and fp64 on the tensor cores, fp32 outside them. Raises for a card it
    does not know."""
    import torch

    name = torch.cuda.get_device_name(0)
    if "H100" in name and "PCIe" in name:
        return {"bf16": 756e12, "tf32": 378e12, "fp32": 51e12, "fp64": 51e12, "bytes_per_s": 2.0e12}
    if "H100" in name or "H200" in name:
        return {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "fp64": 67e12,
                "bytes_per_s": 4.8e12 if "H200" in name else 3.35e12}
    raise AssertionError(f"no data-sheet peaks for {name!r}")


def event_ms(fn, reps: int = 5) -> list:
    """Milliseconds of each of ``reps`` calls by CUDA events, after a
    warm-up call."""
    import torch

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


GRAM_KINDS = (  # (label, mode, product kind, peak key)
    ("bf16_inputs", None, "bf16_inputs", "bf16"),
    ("default", "default", "bf16", "bf16"),
    ("high", "high", "tf32", "tf32"),
    ("highest", "highest", "ieee_fp32", "fp32"),
)


def phase_gram_modes(device) -> dict:
    """``bench.py::_bench_gram_mfu``'s counterpart (module docstring,
    phase 10). Returns the binding's entry for the ``library_bindings``
    line."""
    import statistics

    import torch

    from keystone_tpu_torch.ops.cuda import gemm
    from keystone_tpu_torch.parallel import linalg

    peaks = card_peaks()
    _mnist_start()
    if torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("the plain versions need IEEE fp32 torch.matmul")
    x = torch.randn(GRAM_ROWS, GRAM_D, device=device, generator=torch.Generator(device=device).manual_seed(1))
    flops = 2.0 * GRAM_ROWS * GRAM_D * GRAM_D
    kinds = {}
    for label, mode, kind, peak_key in GRAM_KINDS:
        xk = x.to(torch.bfloat16) if kind == "bf16_inputs" else x
        with linalg.solver_mode_scope(mode):
            times = event_ms(lambda: linalg.gram(xk))
            # The slice, against its emulation and float64.
            xs = xk[:GRAM_SLICE]
            got = linalg.gram(xs)[0]
        plain = gemm.gemm_tn_chunked_reference(xs, xs, kind)
        exact = xs.double().T @ xs.double()
        ms = statistics.median(times)
        in_bytes = xk.numel() * xk.element_size() + GRAM_D * GRAM_D * 4
        bound_s = max(flops / peaks[peak_key], in_bytes / peaks["bytes_per_s"])
        kinds[label] = {
            "product_kind": kind, "ms": ms, "ms_runs": times, "tflops_per_s": flops / ms / 1e9,
            "peak_tflops_per_s": peaks[peak_key] / 1e12,
            "share_of_peak": flops / ms / 1e9 / (peaks[peak_key] / 1e12),
            "bound_ms": bound_s * 1e3, "bound_by": "operations" if flops / peaks[peak_key] >= in_bytes / peaks["bytes_per_s"] else "bytes",
            "slice_vs_emulation_rel": rel_err(got, plain), "slice_vs_fp64_rel": rel_err(got, exact),
            "slice_max_abs_err_vs_emulation": float((got - plain).abs().max()),
        }
        if label in ("highest", "high"):
            # One PyTorch call computing the same product: torch.matmul at
            # the matching global precision, restored after.
            torch.set_float32_matmul_precision(label)
            try:
                kinds[label]["library_ms"] = statistics.median(event_ms(lambda: torch.matmul(x.T, x)))
            finally:
                torch.set_float32_matmul_precision("highest")
        else:
            kinds[label]["library_ms"] = None
        del xk, xs, got, plain, exact
    # The plain version at full size: rounding plus chunked fp32 products.
    plain_ms = statistics.median(event_ms(lambda: gemm.gemm_tn_chunked_reference(x, x, "bf16"), reps=3))
    del x
    torch.cuda.empty_cache()
    result = {"shape": [GRAM_ROWS, GRAM_D], "slice_rows": GRAM_SLICE, "kinds": kinds,
              "default_plain_ms": plain_ms, **_mnist_end("gram_modes")}
    log("gram_modes", **result)
    d, h = kinds["default"], kinds["highest"]
    checks = {
        "default_vs_emulation": d["slice_vs_emulation_rel"] <= GRAM_TOL,
        "highest_vs_fp64": h["slice_vs_fp64_rel"] <= GRAM_TOL,
        "default_10x_highest_vs_fp64": d["slice_vs_fp64_rel"] >= 10 * h["slice_vs_fp64_rel"],
        "high_vs_emulation": kinds["high"]["slice_vs_emulation_rel"] <= 1e-4,
        "shares_at_most_1": all(k["share_of_peak"] <= 1.0 for k in kinds.values()),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"gram_modes failed {failed}")
    return {
        "name": "solver_gemm", "route": "cuda",
        "source": "keystone_tpu_torch/ops/cuda/csrc/solver_gemm.cu",
        "replaces": None, "binds": "cuBLAS cublasGemmEx at an explicit compute type",
        "launches": None,  # filled from the main paths
        "max_abs_err": d["slice_max_abs_err_vs_emulation"],
        "ms": d["ms"], "plain_ms": plain_ms, "bound_ms": d["bound_ms"], "bound_by": d["bound_by"],
        "library_ms": None, "timed_shape": f"default Gram ({GRAM_ROWS}, {GRAM_D})",
        "kinds": kinds,
    }


def timit_exact_problem(device):
    """``_bench_timit_exact``'s problem on the card: columns scaled by
    logspace(0, -2) (Gram cond ≈ 1e4), a planted ``w_true`` and noise 0.1,
    from a seeded generator."""
    import torch

    from keystone_tpu_torch.ops.cuda import gemm

    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(EXACT_N, EXACT_D, device=device, generator=g)
    x.mul_(torch.logspace(0.0, -2.0, EXACT_D, device=device))
    w_true = torch.randn(EXACT_D, EXACT_K, device=device, generator=g)
    y = gemm.gemm(x, w_true, "ieee_fp32")
    y.add_(torch.randn(EXACT_N, EXACT_K, device=device, generator=g), alpha=0.1)
    return x, y


def phase_timit_exact(device) -> int:
    import statistics

    import torch

    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.cuda import gemm
    from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator
    from keystone_tpu_torch.parallel import linalg

    _mnist_start()
    x, y = timit_exact_problem(device)
    features, labels = ArrayDataset(x), ArrayDataset(y)
    w_ref, _, _ = linalg.centered_solve_refined(
        x, y, EXACT_N, EXACT_REG, gram_precision="highest", refine_steps=2
    )
    head = 65_536
    modes = {}
    for mode in ("refine", "highest", "default"):
        est = LinearMapEstimator(reg=EXACT_REG, device=device)
        fired0 = linalg.centered_solve_refined.guard_fired
        checks0 = linalg.centered_solve_refined.guard_checks
        launches0 = dict(gemm.launches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with linalg.solver_mode_scope(mode):
            model = est.fit(features, labels)
            torch.cuda.synchronize()
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                est.fit(features, labels)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
        pred = gemm.gemm(x[:head] - model.feature_mean, model.weights, "ieee_fp32") + model.intercept
        modes[mode] = {
            "fit_ms": statistics.median(times), "fit_ms_runs": times,
            "weight_rel_err_vs_converged": rel_err(model.weights, w_ref),
            "train_mse": float(((pred - y[:head]) ** 2).mean()),
            "guard_decisions": linalg.centered_solve_refined.guard_checks - checks0,
            "guard_fired": linalg.centered_solve_refined.guard_fired - fired0,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "launches": {k: gemm.launches[k] - launches0[k] for k in gemm.launches},
        }
        del model, pred
    result = {"shape": [EXACT_N, EXACT_D, EXACT_K], "reg": EXACT_REG,
              "x_bytes": x.numel() * 4, "y_bytes": y.numel() * 4, "modes": modes,
              **_mnist_end("timit_exact")}
    del x, y, features, labels, w_ref
    torch.cuda.empty_cache()
    log("timit_exact", **result)
    # ``default`` solves once from a bf16 Gram at cond ≈ 1e4: its weights
    # are far from converged by design; the other two must not be.
    bad = [m for m, r in modes.items() if not np.isfinite(r["train_mse"])
           or (m != "default" and not r["weight_rel_err_vs_converged"] < 1e-3)]
    if bad or modes["refine"]["guard_decisions"] != 4 or modes["refine"]["launches"]["bf16"] == 0:
        raise AssertionError(f"timit_exact failed for {bad}: {modes}")
    return 0


def phase_timit_wide_block(device) -> int:
    import statistics

    import torch

    from keystone_tpu_torch.parallel import linalg

    _mnist_start()

    def block_fn(b, row_offset, rows):
        gen = torch.Generator(device=device).manual_seed(7 * 1_000_003 + b)  # seeded by (7, b)
        return torch.randn(rows, WIDE_BLOCK, device=device, generator=gen)

    # A small run first: rematerialized against materialized BCD.
    small_n, small_blocks = 65_536, 4
    y_small = torch.randn(small_n, WIDE_K, device=device, generator=torch.Generator(device=device).manual_seed(3))
    w_remat = linalg.block_coordinate_descent_rematerialized(
        lambda b, off, rows: block_fn(b, off, rows), y_small, WIDE_REG, 2, WIDE_BLOCK, small_blocks
    )
    a_small = torch.cat([block_fn(b, 0, small_n) for b in range(small_blocks)], dim=1)
    w_mat = linalg.block_coordinate_descent(a_small, y_small, WIDE_REG, 2, WIDE_BLOCK)
    small_rel = rel_err(w_remat, w_mat)
    del a_small, y_small, w_remat, w_mat

    num_blocks = WIDE_D // WIDE_BLOCK
    y = torch.randn(WIDE_N, WIDE_K, device=device, generator=torch.Generator(device=device).manual_seed(3))

    def fit():
        return linalg.block_coordinate_descent_rematerialized(
            block_fn, y, WIDE_REG, 1, WIDE_BLOCK, num_blocks
        )

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    w = fit()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        w = fit()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    fit_ms = statistics.median(times)
    flops = 2.0 * WIDE_N * WIDE_BLOCK * (WIDE_BLOCK + 3 * WIDE_K) * num_blocks
    result = {
        "shape": [WIDE_N, WIDE_D, WIDE_K], "block_size": WIDE_BLOCK, "num_epochs": 1,
        "fit_ms": fit_ms, "fit_ms_runs": times, "solver_tflop": flops / 1e12,
        "tflops_per_s": flops / fit_ms / 1e9,
        "vs_spark_16_node_block_solver": WIDE_SPARK_16_NODE_MS / fit_ms,
        "spark_16_node_ms": WIDE_SPARK_16_NODE_MS,
        "small_remat_vs_materialized_rel": small_rel,
        "weights_finite": bool(torch.isfinite(w).all()), **_mnist_end("timit_wide_block"),
    }
    del w, y
    torch.cuda.empty_cache()
    log("timit_wide_block", **result)
    if not (result["weights_finite"] and small_rel <= 1e-5):
        raise AssertionError(f"timit_wide_block failed: {result}")
    return 0


def fp64_timit_scores(cfg, train, test, device, reg):
    """Train and test scores of the TIMIT fit with the features and the BCD
    (same blocks, same order, same λ) in float64 on the card."""
    import torch

    from keystone_tpu_torch.ops.stats.core import CosineRandomFeatures
    from keystone_tpu_torch.parallel import linalg
    from keystone_tpu_torch.pipelines.timit import NUM_CLASSES, TIMIT_DIMENSION

    branches = [
        CosineRandomFeatures.create(TIMIT_DIMENSION, cfg.num_cosine_features, cfg.gamma,
                                    dist=cfg.rf_type, seed=cfg.seed + i, device=device)
        for i in range(cfg.num_cosines)
    ]

    def featurize(x):
        x = x.double()
        return torch.cat([torch.cos(x @ op.w.double().T + op.b.double()) for op in branches], dim=1)

    x = featurize(train.data.data)
    n = x.shape[0]
    y = torch.full((n, NUM_CLASSES), -1.0, dtype=torch.float64, device=device)
    y[torch.arange(n, device=device), train.labels.data.long()] = 1.0
    mu_a, mu_b = x.mean(dim=0), y.mean(dim=0)
    x -= mu_a
    w = linalg.block_coordinate_descent(x, y - mu_b, reg, cfg.num_epochs, cfg.num_cosine_features)
    train_scores = x @ w + mu_b
    del x
    test_scores = (featurize(test.data.data) - mu_a) @ w + mu_b
    return train_scores, test_scores


def phase_timit(device) -> int:
    """The TIMIT pipeline at its published width (module docstring, phase 13)."""
    import torch

    from keystone_tpu_torch.evaluation.multiclass import MulticlassClassifierEvaluator
    from keystone_tpu_torch.ops.learning.block import _scale_aware_reg_floor
    from keystone_tpu_torch.pipelines.timit import (
        NUM_CLASSES, TimitConfig, build_featurizer, build_pipeline, synthetic_timit,
    )
    from keystone_tpu_torch.workflow.executor import PipelineEnv

    cfg = TimitConfig()
    train = synthetic_timit(4096, seed=cfg.seed, device=device)
    test = synthetic_timit(1024, seed=cfg.seed + 1, device=device)
    _mnist_start()
    env = PipelineEnv.get_or_create()
    pipeline = build_pipeline(cfg, train, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fitted = pipeline.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    nodes = env.nodes_executed
    fit_peak = torch.cuda.max_memory_allocated()
    evaluator = MulticlassClassifierEvaluator(NUM_CLASSES)
    errors = {
        "train_error": evaluator.evaluate(fitted.apply_batch(train.data).data, train.labels).total_error,
        "test_error": evaluator.evaluate(fitted.apply_batch(test.data).data, test.labels).total_error,
    }
    TIMIT_BLOCK_ERRORS.update(errors)
    mapper = _mapper_of(fitted)
    feat = build_featurizer(cfg, device=device)
    x = feat(train.data).get().data
    d = x.shape[1]
    reg = _scale_aware_reg_floor(x - x.mean(dim=0), x.shape[0])
    s32_train = mapper.apply_arrays(x)
    del x
    s32_test = mapper.apply_arrays(feat(test.data).get().data)
    del fitted, pipeline, mapper, feat
    PipelineEnv.reset()
    torch.cuda.empty_cache()
    s64_train, s64_test = fp64_timit_scores(cfg, train, test, device, reg)
    fp64 = {"train_scores_vs_fp64_rel": rel_err(s32_train, s64_train),
            "test_scores_vs_fp64_rel": rel_err(s32_test, s64_test),
            "test_predictions_equal_fp64_share": float((s32_test.argmax(1) == s64_test.argmax(1)).float().mean())}
    del s32_train, s32_test, s64_train, s64_test
    torch.cuda.empty_cache()
    result = {"features": d, "branches": cfg.num_cosines, "block_size": cfg.num_cosine_features,
              "epochs": cfg.num_epochs, "reg_floor": reg, "rows": [4096, 1024], "fit_s": fit_s,
              "nodes_executed_in_fit": nodes, "fit_peak_device_bytes": fit_peak, **errors, **fp64}
    cmd = [sys.executable, "-m", "keystone_tpu_torch", "timit", "--num-cosines", "4"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[1:])} exited {proc.returncode}: {proc.stderr[-2000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    result["cli"] = {"line": line, "seconds": time.perf_counter() - t0, "jax_errors": TIMIT4_JAX}
    log("timit", **result, **_mnist_end("timit"))
    if line.get("workload") != "timit":
        raise AssertionError(f"the CLI printed no workload line: {proc.stdout[-500:]}")
    for name, ref in TIMIT4_JAX.items():
        if not abs(line[name] - ref) <= TIMIT_ERROR_TOL:
            raise AssertionError(f"timit CLI: {name} {line[name]} is not within {TIMIT_ERROR_TOL} of {ref}")
    if not (fp64["train_scores_vs_fp64_rel"] <= TIMIT_FP64_TRAIN_TOL
            and fp64["test_scores_vs_fp64_rel"] <= TIMIT_FP64_TEST_TOL):
        raise AssertionError(f"timit: fp32 scores are not within the float64 bounds: {fp64}")
    return 0


def phase_host_streaming_bcd(device) -> int:
    """Host-streamed BCD picked by the estimator itself (module docstring,
    phase 14). Returns the host matrix and its targets for phase 15."""
    import torch

    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.cuda import gemm
    from keystone_tpu_torch.ops.learning import block
    from keystone_tpu_torch.parallel import linalg

    n, d, k, bs = STREAM_BCD_N, STREAM_BCD_D, STREAM_BCD_K, STREAM_BCD_BLOCK
    _mnist_start()
    g = torch.Generator(device=device).manual_seed(23)
    x_dev = torch.randn(n, d, device=device, generator=g)
    y = gemm.gemm(x_dev, torch.randn(d, k, device=device, generator=g), "ieee_fp32")
    y.add_(torch.randn(n, k, device=device, generator=g), alpha=0.1)
    t0 = time.perf_counter()
    x_host = x_dev.cpu()
    to_host_s = time.perf_counter() - t0
    del x_dev
    torch.cuda.empty_cache()
    auto = block._auto_host_streaming(x_host, device)
    stream_fn = linalg.block_coordinate_descent_streaming
    blocks0, bytes0 = stream_fn.blocks_uploaded, stream_fn.bytes_uploaded
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    streamed = block.BlockLeastSquaresEstimator(bs, num_iter=1, reg=STREAM_BCD_REG, device=device).fit(
        ArrayDataset(x_host), ArrayDataset(y)
    )
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    stream_peak = torch.cuda.max_memory_allocated()
    uploaded = {"blocks": stream_fn.blocks_uploaded - blocks0, "bytes": stream_fn.bytes_uploaded - bytes0}

    x_dev = x_host.to(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    in_core = block.BlockLeastSquaresEstimator(
        bs, num_iter=1, reg=STREAM_BCD_REG, device=device, host_streaming=False
    ).fit(
        ArrayDataset(x_dev), ArrayDataset(y)
    )
    torch.cuda.synchronize()
    in_core_s = time.perf_counter() - t0
    in_core_peak = torch.cuda.max_memory_allocated()
    p_stream = streamed.apply_arrays(x_dev)
    p_core = in_core.apply_arrays(x_dev)
    rel = rel_err(p_stream, p_core)
    finite = bool(torch.isfinite(p_stream).all()) and tuple(p_stream.shape) == (n, k)
    del x_dev, p_stream, p_core, streamed, in_core
    torch.cuda.empty_cache()
    panel = n * bs * 4
    result = {
        "shape": [n, d, k], "block_size": bs, "matrix_bytes": n * d * 4, "panel_bytes": panel,
        "auto_selected_streaming": auto, "uploaded": uploaded, "streamed_fit_s": stream_s,
        "in_core_fit_s": in_core_s, "device_to_host_s": to_host_s,
        "streamed_fit_peak_device_bytes": stream_peak, "in_core_fit_peak_device_bytes": in_core_peak,
        "streamed_vs_in_core_predictions_rel": rel, **_mnist_end("host_streaming_bcd"),
    }
    log("host_streaming_bcd", **result)
    checks = {
        "auto": auto and uploaded["blocks"] == d // bs,
        "bytes": uploaded["bytes"] == n * d * 4,
        "peak_of_a_few_panels": stream_peak <= 3 * panel,
        "parity": rel <= STREAM_BCD_TOL and finite,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"host_streaming_bcd failed {failed}")
    return x_host, y


# -------------------------------------------------------------- phase 15
#
# Reliability and observability under the ported fits. PR 6's fit_s of
# mnist_full, untraced, on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md).
MNIST_FULL_FIT_S_PR6 = (0.0234, 0.0388)
RELIABILITY_TOL = 1e-5
SOLVE_SITE = "BlockLeastSquaresEstimator.solve"
OOM_BLOCK = 4096


def _rung_attempts(solver: str) -> float:
    from keystone_tpu_torch.obs import names

    return names.metric(names.SOLVER_RUNG_ATTEMPTS).value(solver=solver)


def _reliability_oom_real(device, x_host, y) -> dict:
    """A real allocator OOM walked down by the ladder: the host-streamed
    fit at block 4,096 under a per-process memory cap that its panel
    cannot fit in and the 2,048 rung can."""
    import torch

    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.parallel import linalg
    from keystone_tpu_torch.reliability import get_recovery_log
    from keystone_tpu_torch.workflow.executor import PipelineEnv

    n, half = x_host.shape[0], OOM_BLOCK // 2

    def fit(block):
        return BlockLeastSquaresEstimator(block, num_iter=1, reg=STREAM_BCD_REG, device=device).fit(
            ArrayDataset(x_host), ArrayDataset(y)
        )

    # The uncapped fit at the half block: the reference, and what it needs.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    reference = fit(half)
    torch.cuda.synchronize()
    need_half = torch.cuda.max_memory_reserved() - reserved0
    need_half_allocated = torch.cuda.max_memory_allocated() - torch.cuda.memory_allocated()
    panel_full = n * OOM_BLOCK * 4
    if not need_half < 0.9 * panel_full:
        raise AssertionError(f"oom_real: the {half} rung needs {need_half} B, no cap separates it "
                             f"from the {OOM_BLOCK} rung's {panel_full} B panel")
    budget = (need_half + panel_full) // 2

    stream_fn = linalg.block_coordinate_descent_streaming
    entries = []

    def on_entry(*args, **kwargs):  # reads the card's allocated bytes as each rung starts
        entries.append(torch.cuda.memory_allocated())
        return stream_fn(*args, **kwargs)

    on_entry.blocks_uploaded, on_entry.bytes_uploaded = 0, 0  # the real one counts on its name
    PipelineEnv.reset()
    attempts0 = _rung_attempts("block_ls")
    index = device.index if device.index is not None else torch.cuda.current_device()
    total = torch.cuda.get_device_properties(index).total_memory
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    allocated_before = torch.cuda.memory_allocated()
    cap = torch.cuda.memory_reserved() + budget
    torch.cuda.reset_peak_memory_stats()
    linalg.block_coordinate_descent_streaming = on_entry
    torch.cuda.set_per_process_memory_fraction(cap / total, index)
    try:
        t0 = time.perf_counter()
        model = fit(OOM_BLOCK)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        capped_peak = torch.cuda.max_memory_reserved()
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0, index)
        linalg.block_coordinate_descent_streaming = stream_fn
    log_events = get_recovery_log().events()
    degradation = dict(getattr(model, "degradation", {}))
    rows = x_host[:16384].to(device)
    rel = rel_err(model.apply_arrays(rows), reference.apply_arrays(rows))
    result = {
        "shape": list(x_host.shape), "first_block": OOM_BLOCK, "cap_bytes": cap,
        "budget_bytes": budget, "total_bytes": total,
        "uncapped_half_block_peak_reserved_bytes": need_half,
        "uncapped_half_block_peak_allocated_bytes": need_half_allocated,
        "full_block_panel_bytes": panel_full, "capped_peak_reserved_bytes": capped_peak,
        "capped_fit_s": fit_s, "degradation": degradation,
        "recovery_events": [e.kind for e in log_events],
        "rung_attempts": _rung_attempts("block_ls") - attempts0,
        "allocated_before_fit": allocated_before, "allocated_at_rung_entries": entries,
        "vs_uncapped_half_block_predictions_rel": rel,
    }
    checks = {
        "real_oom": degradation.get("reduction_reason", "").startswith("OutOfMemoryError:")
        and "injected" not in degradation.get("reduction_reason", ""),
        "degraded": {k: degradation.get(k) for k in ("rung", "rung_index", "first_rung", "reduced")}
        == {"rung": half, "rung_index": 1, "first_rung": OOM_BLOCK, "reduced": True},
        "one_degrade_event": [e.kind for e in log_events] == ["degrade"],
        "two_rung_attempts": result["rung_attempts"] == 2,
        "memory_back_at_rung_1": len(entries) == 2 and entries[1] == allocated_before,
        "parity": rel <= RELIABILITY_TOL,
    }
    result["failed"] = [name for name, ok in checks.items() if not ok]
    return result


def _reliability_oom_injected_sparse(device, slice_fit) -> dict:
    """The hashing-TF slice fit under an OOM injected at its first attempt:
    the ladder halves the block, and the kernel launches twice."""
    import torch

    from keystone_tpu_torch.ops.cuda import blocksparse as bs
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.reliability import FaultSpec, get_recovery_log, injected
    from keystone_tpu_torch.workflow.executor import PipelineEnv

    PipelineEnv.reset()
    attempts0 = _rung_attempts("block_ls_sparse")
    bs.ell_matmul.launches = 0
    t0 = time.perf_counter()
    with injected(FaultSpec(match=SOLVE_SITE, kind="oom", first_n=1)):
        model = BlockLeastSquaresEstimator(BLOCK_SIZE, num_iter=1, reg=REG, device=device).fit(
            slice_fit["rows"], slice_fit["y"]
        )
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = bs.ell_matmul.launches
    summary = get_recovery_log().summary()
    attempts = _rung_attempts("block_ls_sparse") - attempts0
    # The reference: a direct fit at the half block (its launches are not
    # the main path's).
    direct = BlockLeastSquaresEstimator(BLOCK_SIZE // 2, num_iter=1, reg=REG, device=device).fit(
        slice_fit["rows"], slice_fit["y"]
    )
    rel = rel_err(scores(model, slice_fit["test"], device), scores(direct, slice_fit["test"], device))
    degradation = dict(getattr(model, "degradation", {}))
    result = {
        "documents": len(slice_fit["rows"]), "fit_s": fit_s, "ell_launches": launches,
        "degradation": degradation, "rung_attempts": attempts,
        "recovery_events": [e["kind"] for e in summary["events"]],
        "vs_direct_half_block_scores_rel": rel,
    }
    checks = {
        "two_launches": launches == 2,
        "degraded": degradation.get("rung") == BLOCK_SIZE // 2 and degradation.get("first_rung") == BLOCK_SIZE,
        "events": result["recovery_events"] == ["fault", "degrade"] and attempts == 2,
        "parity": rel <= RELIABILITY_TOL,
    }
    result["failed"] = [name for name, ok in checks.items() if not ok]
    return result


def _reliability_retry(device) -> dict:
    """``mnist_default``'s fit with a retry policy and one transient fault
    at the first forcing of a fused featurizer branch."""
    import torch

    from keystone_tpu_torch.pipelines.mnist_random_fft import (
        MnistRandomFFTConfig, build_pipeline, synthetic_mnist,
    )
    from keystone_tpu_torch.reliability import FaultSpec, RetryPolicy, get_recovery_log, injected
    from keystone_tpu_torch.workflow.executor import PipelineEnv

    cfg = MnistRandomFFTConfig()
    train = synthetic_mnist(8192, seed=cfg.seed, device=device)
    test = synthetic_mnist(2048, seed=cfg.seed + 1, device=device)
    PipelineEnv.reset()
    clean = mnist_test_scores(cfg, build_pipeline(cfg, train, device=device).fit(), test, device)
    PipelineEnv.reset()
    PipelineEnv.get_or_create().retry_policy = RetryPolicy(max_attempts=3, seed=0)
    t0 = time.perf_counter()
    with injected(FaultSpec(match=FUSED_BRANCH, kind="transient", calls=(1,))):
        fitted = build_pipeline(cfg, train, device=device).fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    summary = get_recovery_log().summary()
    retried = mnist_test_scores(cfg, fitted, test, device)
    PipelineEnv.reset()
    bitwise = bool(torch.equal(retried, clean))
    result = {
        "rows": 8192, "num_ffts": cfg.num_ffts, "fault_at": FUSED_BRANCH, "fit_s": fit_s,
        "retries": summary["retries"], "recovery_events": [e["kind"] for e in summary["events"]],
        "scores_bitwise_equal_to_clean_fit": bitwise,
    }
    checks = {"one_retry": summary["retries"] == 1 and result["recovery_events"] == ["fault", "retry"],
              "bitwise": bitwise}
    result["failed"] = [name for name, ok in checks.items() if not ok]
    return result


def _reliability_traced_fit(device) -> dict:
    """``mnist_full``'s fit untraced, then under ``trace()``: a node span
    and a node-seconds observation per executed node, the optimizer's
    batch spans and rule counters, the solver's span under its node."""
    import torch

    from keystone_tpu_torch.obs import names
    from keystone_tpu_torch.pipelines.mnist_random_fft import (
        MnistRandomFFTConfig, build_pipeline, synthetic_mnist,
    )
    from keystone_tpu_torch.workflow.executor import PipelineEnv
    from keystone_tpu_torch.workflow.tracing import trace

    cfg = MnistRandomFFTConfig()
    pipeline = build_pipeline(cfg, synthetic_mnist(MNIST_TRAIN_ROWS, seed=0, device=device), device=device)
    PipelineEnv.reset()
    pipeline.fit()  # warm: this pipeline's first fit in the process
    untraced = []
    for _ in range(3):
        PipelineEnv.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipeline.fit()
        torch.cuda.synchronize()
        untraced.append(time.perf_counter() - t0)

    hist = names.metric(names.NODE_SECONDS)
    runs, rewrites = names.metric(names.RULE_RUNS), names.metric(names.RULE_REWRITES)

    def totals():
        return (sum(s.count for s in hist.series().values()), dict(runs.series()), dict(rewrites.series()),
                names.metric(names.NODES_EXECUTED).total())

    PipelineEnv.reset()
    env = PipelineEnv.get_or_create()
    before = totals()
    with trace() as tr:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipeline.fit()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    after = totals()
    spans = tr.session.spans()
    node_spans = [sp for sp in spans if sp.name.startswith("node:")]
    batch_names = [b.name for b in env.optimizer.batches]
    batch_spans = sorted(sp.name for sp in spans if sp.name.startswith("optimize:batch:"))
    by_id = {sp.span_id: sp for sp in spans}
    solver_spans = [sp for sp in spans if sp.name == "solver:fit"]
    solver_parents = [by_id[sp.parent_id].name for sp in solver_spans if sp.parent_id in by_id]
    rule_runs = {dict(k)["rule"]: v - before[1].get(k, 0.0) for k, v in after[1].items()}
    rule_rewrites = {dict(k)["rule"]: v - before[2].get(k, 0.0) for k, v in after[2].items()}
    nodes = env.nodes_executed
    result = {
        "rows": MNIST_TRAIN_ROWS, "untraced_fit_s": untraced, "untraced_fit_s_pr6": list(MNIST_FULL_FIT_S_PR6),
        "traced_fit_s": traced_s, "nodes_executed": nodes,
        "nodes_executed_counter": after[3] - before[3], "node_spans": len(node_spans),
        "node_seconds_observations": after[0] - before[0], "spans": len(spans),
        "batch_spans": batch_spans, "solver_fit_spans": [sp.attributes.get("solver") for sp in solver_spans],
        "solver_fit_parents": solver_parents, "rule_runs": rule_runs, "rule_rewrites": rule_rewrites,
    }
    checks = {
        "node_spans": len(node_spans) == nodes == after[3] - before[3] > 0,
        "node_seconds": after[0] - before[0] == nodes,
        "batch_spans": batch_spans == sorted(f"optimize:batch:{b}" for b in batch_names),
        "solver_span": result["solver_fit_spans"] == ["block_ls"]
        and solver_parents == ["node:BlockLeastSquaresEstimator"],
        "rules": bool(rule_runs) and all(v >= 1 for v in rule_runs.values()),
    }
    result["failed"] = [name for name, ok in checks.items() if not ok]
    return result


def _reliability_profile_store(device, slice_fit) -> dict:
    """The store the earlier phases wrote to: solver observations with a
    torch/CUDA/card fingerprint, read back by a fresh store; a tuned
    threshold of 0.0 for the slice's rows bucket flips its dispatch."""
    import torch

    from keystone_tpu_torch.obs import store as obs_store
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator

    store = obs_store.get_store()
    fingerprint = obs_store.environment_fingerprint()
    expected = {"torch": torch.__version__, "backend": "cuda", "device_kind": torch.cuda.get_device_name()}
    solver = sorted((k, s) for k, s, _ in store.entries(key_prefix="solver:block_ls"))
    fresh = obs_store.ProfileStore(store.path)
    hits = [fresh.lookup(k, s) is not None for k, s in solver]
    est = BlockLeastSquaresEstimator(BLOCK_SIZE, num_iter=1, reg=REG, device=device)
    rows = slice_fit["rows"]
    shape = f"{obs_store.rows_bucket(obs_store.shape_class(len(rows)))}|{NUM_FEATURES}|float32"
    store.record("blocksparse:threshold", shape, threshold=0.0, speedup=1.0, source="tune")
    tuned = est._blocksparse_dispatch(rows)[0]
    # A stale mark is the store's way to stop a replay (the entry stays on file).
    store.mark_stale("blocksparse:threshold", shape)
    untuned = est._blocksparse_dispatch(rows)[0]
    result = {
        "path": store.path, "fingerprint": fingerprint, "solver_entries": [k for k, _ in solver],
        "fresh_store_hits": fresh.stats()["hits"], "threshold_shape": shape,
        "dispatch_with_threshold_0": tuned, "dispatch_after_stale_mark": untuned,
    }
    checks = {
        "fingerprint": fingerprint == expected,
        "solver_entries": any(k.startswith("solver:block_ls:bs") and ":prec" in k for k, _ in solver),
        "round_trip": bool(hits) and all(hits),
        "dispatch": (tuned, untuned) == ("densify", "sparse"),
    }
    result["failed"] = [name for name, ok in checks.items() if not ok]
    return result


def phase_reliability(device, host_problem, slice_fit) -> int:
    """Phase 15 (module docstring). Returns the ELL kernel's launches in
    the injected-OOM hashing-TF fit."""
    from keystone_tpu_torch.ops.cuda import blocksparse as bs
    from keystone_tpu_torch.ops.cuda import gemm

    _mnist_start()
    t0 = time.perf_counter()
    parts = {"oom_real": _reliability_oom_real(device, *host_problem)}
    if bs.ell_matmul.launches:
        parts["oom_real"]["failed"].append("ell_launched")
    parts["oom_injected_sparse"] = _reliability_oom_injected_sparse(device, slice_fit)
    launches = parts["oom_injected_sparse"]["ell_launches"]
    bs.ell_matmul.launches = 0
    parts["retry"] = _reliability_retry(device)
    parts["traced_fit"] = _reliability_traced_fit(device)
    parts["profile_store"] = _reliability_profile_store(device, slice_fit)
    if bs.ell_matmul.launches:
        parts["profile_store"]["failed"].append(f"ell_launched_{bs.ell_matmul.launches}")
    for name, part in parts.items():
        log(f"reliability_{name}", **part)
    SOLVER_GEMM_CALLS["reliability"] = dict(gemm.launches)
    failed = {name: part["failed"] for name, part in parts.items() if part["failed"]}
    log("reliability", seconds=time.perf_counter() - t0, ell_launches=launches,
        solver_gemm_launches=dict(gemm.launches), failed=failed)
    if failed:
        raise AssertionError(f"reliability failed {failed}")
    return launches


# -------------------------------------------------------------- phases 16-19
#
# The least-squares meta-solver and the text pipelines (ROADMAP item 9).

# solver_ladder: the six rows of the JAX sweep's FULL_GRID
# (scripts/solver_comparison.py:44-54), (n, d, k, density), with the
# sweep's rungs (``solvers()``: reg 1e-3, block 1,024 × 3 epochs, 20
# L-BFGS iterations) and its ceiling on densified sparse problems.
LADDER_GRID = (
    (500_000, 1024, 138, 1.0),
    (500_000, 2048, 138, 1.0),
    (1_000_000, 1024, 138, 1.0),
    # Cut 10: the sparse d = 1,024 row at 250,000 of the sweep's
    # 10^6 rows (its host L-BFGS fit), width and density kept; no gate
    # reads its pick.
    (250_000, 1024, 2, 0.005),
    # Cuts 3 and 4 for the 660 s cap (ROADMAP "Tests"): the sweep's 10^6
    # rows at d = 16,384 spent 34.7 s in one host scipy L-BFGS fit, run
    # twice (timed, and as the pipeline's pick), and the d = 4,096 row
    # ~10 s. Width and density stay; the gates hold at 250,000 rows (the
    # sketched rung priced infinite below its 8,192 floor and finite above
    # it, the pick the fastest rung; the cost model reads n).
    (250_000, 4096, 2, 0.005),
    # Cut 19: the d = 16,384 row at 62,500 rows. Its host L-BFGS fit, run
    # twice (timed, and as the pipeline's pick), took 12.9 + 13.8 s of the
    # phase's 45.8 s at 250,000 and 7.5 + 7.1 s at 125,000 on an H100
    # (PERF.md §4); width and density stay, and its gates read the
    # width (the sketched rung's 8,192 floor) and the measured rungs, not n.
    (62_500, 16384, 2, 0.005),
)
#: Sparse rows on which the sketched rung must price finite (d ≥ the
#: 8,192 floor) or infinite (below it), and the pick must be the fastest
#: measured rung.
LADDER_SKETCH_ROWS = {4096: False, 16384: True}
LADDER_REG, LADDER_ITERS, LADDER_BLOCK, LADDER_EPOCHS = 1e-3, 20, 1024, 3
DENSE_ELEMS_LIMIT = 2e8
# Every dense rung's predictions on the head rows against a float64 solve
# of its own objective ((Gc + λI) for exact and block, (Gc + nλI) for
# L-BFGS, whose loss divides by n): fp32 products over 5e5–1e6 rows on a
# Gram of condition ≈ 1.2–1.3. The limit sits between the IEEE fp32
# rungs' readings and those of a control, the exact and L-BFGS rungs
# with their products at TF32, which must fail it (PERF.md §5).
LADDER_FP64_TOL = 4e-6
LADDER_CONTROL_MODE, LADDER_CONTROL_RUNGS = "high", ("exact", "lbfgs")
# least_squares_ladder: the meta-solver's block rung against a direct
# block fit of the same rows.
LS_LADDER_TOL = 1e-6
LS_SITE = "LeastSquaresEstimator.solve"
# newsgroups: the published split sizes (20news-bydate: 11,314 train,
# 7,532 test) and configuration (NewsgroupsPipeline: 2-grams, 100,000
# common features); the NB parameters against a float64 closed form.
NG_TRAIN, NG_TEST, NG_FEATURES, NB_TOL = 11_314, 7_532, 100_000, 1e-5
# Cut 5 for the time cap: half of each split's documents, 5,657
# train and 3,766 test. The configuration stays (2-grams, 100,000 common
# features: the half corpus still holds ~340,000 distinct uni- and
# bigrams, so the vectorizer stays exactly 100,000 wide).
NG_TRAIN, NG_TEST = NG_TRAIN // 2, NG_TEST // 2
# Cut 17: a quarter of each split (2,828 train, 1,883 test); the width
# gate holds the vectorizer at 100,000 features.
NG_TRAIN, NG_TEST = NG_TRAIN // 2, NG_TEST // 2
# Cut 25: an eighth (1,414 train, 941 test); the width gate holds.
NG_TRAIN, NG_TEST = NG_TRAIN // 2, NG_TEST // 2
# The synthetic text's own parameters have no public source: the tokens
# per document, the vocabulary and lexicon sizes, the topic and polarity
# shares and the Zipf exponent (1.1, near the exponent of about 1 of
# Zipf's law for word frequencies) were chosen so that more than 100,000
# distinct uni- and bigrams occur. Timings of the text phases' host
# featurization on this corpus say nothing of real text.
NG_DOC_TOKENS, NG_VOCAB, NG_TOPIC_WORDS, NG_TOPIC_SHARE = 100, 50_000, 2_000, 0.25
# amazon_reviews: AmazonReviewsPipeline's configuration (threshold 3.5,
# 2-grams, 100,000 common features, 20 iterations) with the rows cut from
# the reference's 65M reviews to 32,768 / 8,192: a 13.1 GB dense float32
# train matrix after Densify.
AMAZON_TRAIN, AMAZON_TEST, AMAZON_REFERENCE_ROWS, AMAZON_FEATURES = 32_768, 8_192, 65_000_000, 100_000
# Cut 6: 16,384 train / 4,096 test reviews (a 6.6 GB dense train
# matrix); the configuration stays (~520,000 distinct uni- and bigrams
# at this size: the vectorizer stays 100,000 wide).
AMAZON_TRAIN, AMAZON_TEST = AMAZON_TRAIN // 2, AMAZON_TEST // 2
# Cut 16: 8,192 train / 2,048 test reviews (a 3.3 GB dense train matrix);
# the width gate holds the vectorizer at 100,000 features.
AMAZON_TRAIN, AMAZON_TEST = AMAZON_TRAIN // 2, AMAZON_TEST // 2
# Cut 26: 4,096 train / 1,024 test reviews; the width gate holds.
AMAZON_TRAIN, AMAZON_TEST = AMAZON_TRAIN // 2, AMAZON_TEST // 2
AMAZON_DOC_TOKENS, AMAZON_LEXICON, AMAZON_POLAR_SHARE, AMAZON_NOISE_SHARE = 60, 300, 0.15, 0.03


def ladder_problem(n, d, k, density, device, seed=0):
    """``make_problem``'s problem: dense rows drawn on the card from a
    seeded generator (x ~ N(0, 1), y = x·w + 0.1·noise); sparse rows a
    host CSR matrix with a fixed count of nonzeros per row, as the sweep
    builds it."""
    import torch

    from keystone_tpu_torch.ops.cuda import gemm

    if density < 1.0:
        import scipy.sparse as sp

        rng = np.random.default_rng(seed)
        w_true = rng.normal(size=(d, k)).astype(np.float32)
        per_row = max(1, round(d * density))
        indices = rng.integers(0, d, size=n * per_row, dtype=np.int32)
        indptr = np.arange(0, n * per_row + 1, per_row, dtype=np.int64)
        data = rng.random(n * per_row, dtype=np.float32)
        x = sp.csr_matrix((data, indices, indptr), shape=(n, d))
        y = np.asarray(x @ w_true, dtype=np.float32)
        y += 0.1 * rng.normal(size=(n, k)).astype(np.float32)
        return x, y
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(n, d, device=device, generator=g)
    y = gemm.gemm(x, torch.randn(d, k, device=device, generator=g), "ieee_fp32")
    y.add_(torch.randn(n, k, device=device, generator=g), alpha=0.1)
    return x, y


def ladder_rungs(n, d, density, device) -> dict:
    """The sweep's ``solvers()`` for one row: name → estimator factory."""
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.learning.lbfgs import DenseLBFGSEstimator, SparseLBFGSEstimator
    from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator

    rungs = {}
    if density >= 1.0 or n * d <= DENSE_ELEMS_LIMIT:
        rungs["exact"] = lambda: LinearMapEstimator(LADDER_REG, device=device)
        rungs["block"] = lambda: BlockLeastSquaresEstimator(
            LADDER_BLOCK, num_iter=LADDER_EPOCHS, reg=LADDER_REG, device=device)
        rungs["lbfgs"] = lambda: DenseLBFGSEstimator(
            num_iterations=LADDER_ITERS, reg=LADDER_REG, device=device)
    if density < 1.0:
        rungs["sparse_lbfgs"] = lambda: SparseLBFGSEstimator(
            num_iterations=LADDER_ITERS, reg=LADDER_REG, device=device)
    return rungs


#: The meta-solver's candidate names by the estimator type it returns.
RUNG_OF = {"LinearMapEstimator": "exact", "BlockLeastSquaresEstimator": "block",
           "DenseLBFGSEstimator": "lbfgs", "SparseLBFGSEstimator": "sparse_lbfgs"}


def fp64_ridge_predictions(x, y, lam, head):
    """Predictions on ``x[:head]`` of the float64 solve of
    (Xcᵀ·Xc + lam·I) W = Xcᵀ·Yc, the Gram summed over 65,536-row chunks on
    the card (PyTorch float64 products, a reference only)."""
    import torch

    n, d = x.shape
    k = y.shape[1]
    dev = x.device
    gram = torch.zeros(d, d, dtype=torch.float64, device=dev)
    cross = torch.zeros(d, k, dtype=torch.float64, device=dev)
    sx = torch.zeros(d, dtype=torch.float64, device=dev)
    sy = torch.zeros(k, dtype=torch.float64, device=dev)
    for s in range(0, n, 65_536):
        xc, yc = x[s : s + 65_536].double(), y[s : s + 65_536].double()
        gram += xc.T @ xc
        cross += xc.T @ yc
        sx += xc.sum(0)
        sy += yc.sum(0)
    mu_x, mu_y = sx / n, sy / n
    gram -= n * torch.outer(mu_x, mu_x)
    cross -= n * torch.outer(mu_x, mu_y)
    w = torch.linalg.solve(gram + lam * torch.eye(d, dtype=torch.float64, device=dev), cross)
    return (x[:head].double() - mu_x) @ w + mu_y


def _timed_fit(make, xd, yd, warm=True):
    """One warm fit (unless ``warm`` is false), then one timed: (model, ms)."""
    import torch

    if warm:
        make().fit(xd, yd)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = make().fit(xd, yd)
    torch.cuda.synchronize()
    return model, (time.perf_counter() - t0) * 1e3


def _ladder_row(n, d, k, density, device) -> dict:
    import torch

    from keystone_tpu_torch.data.dataset import ArrayDataset, ObjectDataset
    from keystone_tpu_torch.ops.learning.cost import cuda_weights
    from keystone_tpu_torch.ops.learning.least_squares import LeastSquaresEstimator
    from keystone_tpu_torch.parallel import linalg
    from keystone_tpu_torch.workflow.executor import PipelineEnv

    sparse = density < 1.0
    t0 = time.perf_counter()
    x, y = ladder_problem(n, d, k, density, device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    head = min(n, 65_536, max(1024, int(1e8 / d)))
    if sparse:
        xd, yd = ObjectDataset([x]), ArrayDataset(y, device="cpu")
        xh = torch.as_tensor(x[:head].toarray(), device=device)
        yh = torch.as_tensor(y[:head], device=device)
    else:
        xd, yd = ArrayDataset(x), ArrayDataset(y)
        xh, yh = x[:head], y[:head]
    references = {}

    def vs_fp64(name, pred):
        lam = LADDER_REG * (n if name == "lbfgs" else 1)
        if lam not in references:
            references[lam] = fp64_ridge_predictions(x, y, lam, head)
        return rel_err(pred, references[lam])

    rungs, failed = {}, []
    for name, make in ladder_rungs(n, d, density, device).items():
        # The host rung (scipy on the CPU) compiles nothing: it is timed cold.
        model, ms = _timed_fit(make, xd, yd, warm=name != "sparse_lbfgs")
        pred = model.apply_arrays(xh)
        entry = {"ms": ms, "train_mse": float(((pred - yh) ** 2).mean())}
        if not sparse:
            entry["vs_fp64_predictions_rel"] = vs_fp64(name, pred)
            if not entry["vs_fp64_predictions_rel"] <= LADDER_FP64_TOL:
                failed.append(f"{name}_vs_fp64")
        if name == "lbfgs":
            entry.update({key: model.lbfgs[key] for key in ("iterations", "evaluations", "objective")})
        if not np.isfinite(entry["train_mse"]):
            failed.append(f"{name}_mse")
        rungs[name] = entry
        del model, pred
    # The control: the gate must reject rungs whose products ran at TF32.
    control = {}
    if not sparse:
        makers = ladder_rungs(n, d, density, device)
        for name in LADDER_CONTROL_RUNGS:
            with linalg.solver_mode_scope(LADDER_CONTROL_MODE):
                model = makers[name]().fit(xd, yd)
            control[name] = vs_fp64(name, model.apply_arrays(xh))
            if not control[name] > LADDER_FP64_TOL:
                failed.append(f"{name}_{LADDER_CONTROL_MODE}_control_passes_the_gate")
            del model
    # The meta-solver inside a Pipeline, node-level optimization on: its
    # pick under the card's weights, every candidate's predicted cost.
    PipelineEnv.reset()
    # The sparse row goes in as the sweep hands it over: one CSR matrix in
    # one ObjectDataset item.
    pipeline = LeastSquaresEstimator(reg=LADDER_REG, device=device).with_data(xd, yd)
    env = PipelineEnv.get_or_create()
    t0 = time.perf_counter()
    optimized, _ = env.optimizer.execute(pipeline.graph)
    optimize_s = time.perf_counter() - t0
    # A picked rung that streams sits inside a StreamFit operator.
    estimators = [getattr(op, "estimator", op) for op in optimized.operators.values()]
    picked = [e for e in estimators if getattr(e, "predicted_cost", None) is not None]
    plan = plan_labels(optimized)
    t0 = time.perf_counter()
    fitted = pipeline.fit()
    pred = fitted.apply_batch(ArrayDataset(xh)).data
    torch.cuda.synchronize()
    pipeline_fit_s = time.perf_counter() - t0
    if len(picked) != 1:
        failed.append("pick")
        pick, candidates = None, []
    else:
        prediction = picked[0].predicted_cost
        pick = RUNG_OF.get(type(picked[0]).__name__, type(picked[0]).__name__)
        candidates = [{"rung": c[0], "predicted_s": c[1], "reason": c[2]} for c in prediction.candidates]
    fastest = min(rungs, key=lambda r: rungs[r]["ms"])
    weights = cuda_weights()
    del x, y, xd, yd, xh, yh, pipeline, fitted, optimized
    PipelineEnv.reset()
    torch.cuda.empty_cache()
    return {
        "shape": [n, d, k], "density": density, "build_s": build_s, "rungs": rungs,
        f"{LADDER_CONTROL_MODE}_control_vs_fp64_predictions_rel": control,
        "pick": pick, "fastest_measured": fastest, "pick_is_fastest": pick == fastest,
        "predicted": candidates, "weights": [weights.cpu, weights.mem, weights.network],
        "optimize_s": optimize_s, "pipeline_plan": plan, "pipeline_fit_and_apply_s": pipeline_fit_s,
        "pipeline_finite": bool(torch.isfinite(pred).all()), "failed": failed,
    }


def phase_solver_ladder(device) -> int:
    """Phase 16: the JAX sweep's first four rows, each rung timed, and the
    meta-solver's pick under ``cuda_weights()`` (module docstring)."""
    _mnist_start()
    t0 = time.perf_counter()
    rows = []
    for n, d, k, density in LADDER_GRID:
        row = _ladder_row(n, d, k, density, device)
        if d in LADDER_SKETCH_ROWS:
            priced = [c["predicted_s"] is not None for c in row["predicted"] if c["rung"] == "sketched"]
            if priced != [LADDER_SKETCH_ROWS[d]]:
                row["failed"].append("sketched_pricing")
            if not row["pick_is_fastest"]:
                row["failed"].append("pick_is_not_the_fastest_rung")
        log("solver_ladder_row", **row)
        rows.append(row)
    fit_cost_constants(rows)
    end = _mnist_end("solver_ladder")
    failed = {f"{r['shape']}": r["failed"] for r in rows if r["failed"] or not r["pipeline_finite"]}
    log("solver_ladder", seconds=time.perf_counter() - t0,
        picks=[[r["shape"], r["pick"], r["fastest_measured"]] for r in rows], failed=failed, **end)
    if failed:
        raise AssertionError(f"solver_ladder failed {failed}")
    return 0


def fit_cost_constants(rows: list) -> dict:
    """``keystone_tpu_torch.tools.solver_comparison``'s constant fit on the
    ladder's measured rung times, each weight bounded below by the card's
    data-sheet peak (``cuda_weights()``): the fitted ``CostWeights``
    beside the defaults, printed only (the defaults stay)."""
    from keystone_tpu_torch.ops.learning.cost import cuda_weights
    from keystone_tpu_torch.tools.solver_comparison import fit_constants

    measured = [
        {"solver": name, "n": r["shape"][0], "d": r["shape"][1], "k": r["shape"][2],
         "sparsity": r["density"], "ms": e["ms"], "machines": 1}
        for r in rows for name, e in r["rungs"].items()
    ]
    defaults = cuda_weights()
    fitted = fit_constants(measured, defaults)
    log("cost_constants_fit", fitted={k: fitted[k] for k in ("cpu", "mem", "network", "dispatch_intercept_ms")},
        defaults={"cpu": defaults.cpu, "mem": defaults.mem, "network": defaults.network},
        fit_residual_ms=fitted["fit_residual_ms"], per_row_rel_residual=fitted["per_row_rel_residual"],
        host_sparse=fitted.get("host_sparse"))
    return fitted


def phase_least_squares_ladder(device, slice_fit) -> int:
    """Phase 17: ``LeastSquaresEstimator.fit`` (no optimizer) on phase 3's
    hashing-TF rows under an OOM injected at its first rung: the
    ``block`` rung fits through the ELL kernel. Returns its launches."""
    import torch

    from keystone_tpu_torch.ops.cuda import blocksparse as bs
    from keystone_tpu_torch.ops.cuda import gemm
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.learning.least_squares import LeastSquaresEstimator
    from keystone_tpu_torch.reliability import FaultSpec, get_recovery_log, injected

    _mnist_start()
    t_phase = t0 = time.perf_counter()
    with injected(FaultSpec(match=LS_SITE, kind="oom", first_n=1)):
        model = LeastSquaresEstimator(
            reg=REG, block_size=BLOCK_SIZE, block_iters=1, device=device
        ).fit(slice_fit["rows"], slice_fit["y"])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = bs.ell_matmul.launches
    gemm_launches = SOLVER_GEMM_CALLS["least_squares_ladder"] = dict(gemm.launches)
    summary = get_recovery_log().summary()
    degradation = dict(getattr(model, "degradation", {}))
    # The spec's match is a substring of the block solver's own probe site
    # ("BlockLeastSquaresEstimator.solve") too, so that site's first call
    # also runs out of memory and the block rung's own ladder halves the
    # block: the reference is a direct block fit of the same rows at the
    # block the model landed on (its launches are not the path's).
    direct = BlockLeastSquaresEstimator(model.block_size, num_iter=1, reg=REG, device=device).fit(
        slice_fit["rows"], slice_fit["y"]
    )
    got, want = scores(model, slice_fit["test"], device), scores(direct, slice_fit["test"], device)
    rel = rel_err(got, want)
    result = {
        "seconds": time.perf_counter() - t_phase, "documents": len(slice_fit["rows"]),
        "block_size": BLOCK_SIZE, "fit_s": fit_s,
        "ell_launches": launches, "landed_block_size": model.block_size, "degradation": degradation,
        "recovery_events": [e["kind"] for e in summary["events"]],
        "vs_direct_block_scores_rel": rel, "solver_gemm_launches": gemm_launches,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
    }
    log("least_squares_ladder", **result)
    checks = {
        "two_launches": launches == 2,
        "block_rung": degradation.get("rung") == "block" and degradation.get("first_rung") == "dense_lbfgs"
        and degradation.get("inner", {}).get("rung") == BLOCK_SIZE // 2 == model.block_size,
        "events": sorted(result["recovery_events"]) == ["degrade", "degrade", "fault", "fault"],
        "parity": rel <= LS_LADDER_TOL and bool(torch.isfinite(got).all()),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"least_squares_ladder failed {failed}")
    return launches


class Zipf:
    """Ranks in [0, size) with P(r) ∝ 1/(r+1)^exponent, drawn by inverse
    CDF from a numpy generator."""

    def __init__(self, size, exponent=1.1):
        p = 1.0 / np.arange(1, size + 1, dtype=np.float64) ** exponent
        self.cdf = np.cumsum(p / p.sum())
        self.size = size

    def draw(self, rng, count):
        return np.minimum(np.searchsorted(self.cdf, rng.random(count), side="right"), self.size - 1)


def _split_docs(words, lengths):
    """Per-document strings from one flat array of token strings."""
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    return [" ".join(words[offsets[i] : offsets[i + 1]].tolist()) for i in range(len(lengths))]


def newsgroups_corpus(root, seed):
    """The 20-class directory tree (``load_newsgroups``'s layout) with
    ``NG_TRAIN`` train and ``NG_TEST`` test documents under ``root``.
    A document of class c has 10 + Poisson(100) tokens: each, with odds 3
    in 4, from a Zipf law over a shared 50,000-word vocabulary, else from
    a Zipf law over class c's own 2,000 topic words (a seeded draw from
    the vocabulary). These text parameters are unsourced (see
    ``NG_DOC_TOKENS``)."""
    from keystone_tpu_torch.data.loaders.text import NEWSGROUPS_CLASSES

    rng = np.random.default_rng(seed)
    vocab = np.array([f"w{i:x}" for i in range(NG_VOCAB)])
    topics = np.stack([rng.permutation(NG_VOCAB)[:NG_TOPIC_WORDS] for _ in NEWSGROUPS_CLASSES])
    shared, topical = Zipf(NG_VOCAB), Zipf(NG_TOPIC_WORDS)
    for split, count in (("train", NG_TRAIN), ("test", NG_TEST)):
        labels = rng.integers(0, len(NEWSGROUPS_CLASSES), size=count)
        lengths = rng.poisson(NG_DOC_TOKENS, size=count) + 10
        ids = shared.draw(rng, int(lengths.sum()))
        on_topic = rng.random(ids.size) < NG_TOPIC_SHARE
        token_class = np.repeat(labels, lengths)[on_topic]
        ids[on_topic] = topics[token_class, topical.draw(rng, int(on_topic.sum()))]
        for cls in NEWSGROUPS_CLASSES:
            os.makedirs(os.path.join(root, split, cls), exist_ok=True)
        for i, (label, doc) in enumerate(zip(labels, _split_docs(vocab[ids], lengths))):
            with open(os.path.join(root, split, NEWSGROUPS_CLASSES[label], f"{i:06d}"), "w") as f:
                f.write(doc)
    return os.path.join(root, "train"), os.path.join(root, "test")


def amazon_corpus(root, seed):
    """JSON-lines reviews (``load_amazon_reviews``'s format). A review is
    positive or negative with equal odds (``overall`` 4 or 5, 1 or 2) and
    has 5 + Poisson(60) tokens: each, with odds 0.15, from a Zipf law over
    its polarity's 300-word lexicon, with odds 0.03 from the other
    polarity's, else from a Zipf law over a 50,000-word filler
    vocabulary. These text parameters are unsourced (see
    ``NG_DOC_TOKENS``)."""
    rng = np.random.default_rng(seed)
    filler = np.array([f"w{i:x}" for i in range(NG_VOCAB)])
    lexicons = np.stack([np.array([f"{tag}{i:x}" for i in range(AMAZON_LEXICON)], dtype="<U8")
                         for tag in ("neg", "pos")])
    shared, lexical = Zipf(NG_VOCAB), Zipf(AMAZON_LEXICON)
    paths = []
    for split, count in (("train", AMAZON_TRAIN), ("test", AMAZON_TEST)):
        positive = (rng.random(count) < 0.5).astype(np.int64)
        lengths = rng.poisson(AMAZON_DOC_TOKENS, size=count) + 5
        words = filler[shared.draw(rng, int(lengths.sum()))].astype("<U8")
        polarity = np.repeat(positive, lengths)
        source = rng.random(words.size)
        own = source < AMAZON_POLAR_SHARE
        other = (source >= AMAZON_POLAR_SHARE) & (source < AMAZON_POLAR_SHARE + AMAZON_NOISE_SHARE)
        words[own] = lexicons[polarity[own], lexical.draw(rng, int(own.sum()))]
        words[other] = lexicons[1 - polarity[other], lexical.draw(rng, int(other.sum()))]
        ratings = np.where(positive == 1, rng.choice([4.0, 5.0], size=count), rng.choice([1.0, 2.0], size=count))
        path = os.path.join(root, f"{split}.json")
        with open(path, "w") as f:
            for doc, rating in zip(_split_docs(words, lengths), ratings):
                f.write(json.dumps({"reviewText": doc, "overall": float(rating)}) + "\n")
        paths.append(path)
    return paths


def _host_rss() -> int:
    """The process's resident bytes (``VmRSS``)."""
    with open("/proc/self/status") as f:
        return next(int(line.split()[1]) * 1024 for line in f if line.startswith("VmRSS:"))


class HostPeak:
    """The process's resident bytes before and after the block and the
    largest seen during it, sampled every 50 ms by a thread (the kernel
    of the card's machine keeps no ``VmHWM`` to reset)."""

    def __enter__(self):
        import threading

        self.before = self.peak = _host_rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.05):
            self.peak = max(self.peak, _host_rss())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.after = _host_rss()
        self.peak = max(self.peak, self.after)

    def report(self) -> dict:
        return {"host_rss_before_bytes": self.before, "host_rss_after_bytes": self.after,
                "host_peak_rss_sampled_bytes": self.peak}


def _node_seconds(timings) -> dict:
    """A traced run's node seconds, summed into featurize / densify / fit
    / apply by operator label. Each ``DelegatingOperator`` applies a
    fitted transformer: the one completing just before a ``Densify`` is
    the fitted vectorizer (featurization), any other one the model."""
    featurize = ("Trim", "LowerCase", "Tokenizer", "NGramsFeaturizer", "TermFrequency",
                 "CommonSparseFeatures")
    out = {"featurize_s": 0.0, "densify_s": 0.0, "fit_s": 0.0, "apply_s": 0.0, "other_s": 0.0}
    labels = [str(t.label) for t in timings]
    for i, t in enumerate(timings):
        label, after = labels[i], labels[i + 1] if i + 1 < len(labels) else ""
        if label.startswith(featurize) or (label == "DelegatingOperator" and after == "Densify"):
            out["featurize_s"] += t.seconds
        elif label == "Densify":
            out["densify_s"] += t.seconds
        elif label.endswith("Estimator"):
            out["fit_s"] += t.seconds
        elif label.startswith("Dataset"):
            out["other_s"] += t.seconds
        else:
            out["apply_s"] += t.seconds
    return out


def _fitted_member(fitted, cls):
    ops = fitted.graph.operators.values()
    found = [m for op in ops for m in getattr(op, "members", (op,)) if isinstance(m, cls)]
    if len(found) != 1:
        raise AssertionError(f"expected one {cls.__name__} in the fitted pipeline, found {len(found)}")
    return found[0]


def fp64_naive_bayes(x, y, k, lam):
    """(π, Θ) in float64 by plain PyTorch on the card, independent of
    ``nb_fit`` and the solver binding: per-class sums by ``index_add_``,
    then the smoothed logs of NaiveBayesModel.scala:57-69."""
    import torch

    sums = torch.zeros(k, x.shape[1], dtype=torch.float64, device=x.device)
    for s in range(0, x.shape[0], 2048):
        sums.index_add_(0, y[s : s + 2048], x[s : s + 2048].double())
    counts = torch.bincount(y, minlength=k).double()
    pi = torch.log(counts + lam) - np.log(y.numel() + k * lam)
    theta = torch.log(sums + lam) - torch.log(sums.sum(1, keepdim=True) + lam * x.shape[1])
    return pi, theta


def phase_newsgroups(device) -> int:
    """Phase 18: ``run_newsgroups`` on the synthetic 20-class tree at the
    published split sizes and configuration (module docstring)."""
    import torch

    from keystone_tpu_torch.ops.learning import naive_bayes
    from keystone_tpu_torch.ops.util.sparse import SparseFeatureVectorizer
    from keystone_tpu_torch.pipelines import text
    from keystone_tpu_torch.workflow.tracing import trace

    _mnist_start()
    captured = {}
    base = text.NaiveBayesEstimator

    class RecordingNaiveBayesEstimator(base):  # the fit's own inputs, for the float64 check
        def fit(self, data, labels):
            captured["data"], captured["labels"] = data, labels
            return super().fit(data, labels)

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="keystone-20news-") as root, HostPeak() as host:
        t0 = time.perf_counter()
        train_dir, test_dir = newsgroups_corpus(root, SEED)
        corpus_s = time.perf_counter() - t0
        text.NaiveBayesEstimator = RecordingNaiveBayesEstimator
        try:
            with trace() as tr:
                t0 = time.perf_counter()
                res = text.run_newsgroups(text.NewsgroupsConfig(
                    train_location=train_dir, test_location=test_dir, n_grams=2,
                    common_features=NG_FEATURES), device=device)
                torch.cuda.synchronize()
                run_s = time.perf_counter() - t0
        finally:
            text.NaiveBayesEstimator = base
    fitted = res["pipeline"].fit()
    width = len(_fitted_member(fitted, SparseFeatureVectorizer).feature_space)
    model = _fitted_member(fitted, naive_bayes.NaiveBayesModel)
    x = captured["data"].data
    y = torch.as_tensor(np.asarray(captured["labels"].collect()), dtype=torch.long, device=device)
    pi64, theta64 = fp64_naive_bayes(x, y, len(text.NEWSGROUPS_CLASSES), 1.0)
    pi_err = float((model.pi.double() - pi64).abs().max())
    theta_err = float((model.theta.double() - theta64).abs().max())
    result = {
        "seconds": time.perf_counter() - t_phase, "train_docs": NG_TRAIN, "test_docs": NG_TEST, "n_grams": 2, "common_features": NG_FEATURES,
        "vectorizer_width": width, "train_matrix_shape": list(x.shape),
        "train_matrix_bytes": x.numel() * x.element_size(), "corpus_s": corpus_s, "run_s": run_s,
        **_node_seconds(tr.timings), "test_error": res["metrics"].total_error,
        "nb_pi_vs_fp64_max_abs": pi_err, "nb_theta_vs_fp64_max_abs": theta_err,
        **host.report(), **_mnist_end("newsgroups"),
    }
    del captured, x, y, pi64, theta64, fitted, model, res
    torch.cuda.empty_cache()
    log("newsgroups", **result)
    checks = {
        "width": width == NG_FEATURES and result["train_matrix_shape"] == [NG_TRAIN, NG_FEATURES],
        "nb_fp64": pi_err <= NB_TOL and theta_err <= NB_TOL,
        "error": 0.0 <= result["test_error"] < 0.5,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"newsgroups failed {failed}")
    return 0


def phase_amazon_reviews(device) -> int:
    """Phase 19: ``run_amazon`` on synthetic JSON-lines reviews at the
    published configuration, rows cut to 32,768 / 8,192 (module
    docstring)."""
    import torch

    from keystone_tpu_torch.ops.learning.lbfgs import APPROX_DEC_RTOL
    from keystone_tpu_torch.ops.learning.linear import LinearMapper
    from keystone_tpu_torch.ops.util.sparse import SparseFeatureVectorizer
    from keystone_tpu_torch.pipelines import text
    from keystone_tpu_torch.workflow.tracing import trace

    _mnist_start()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="keystone-amazon-") as root, HostPeak() as host:
        t0 = time.perf_counter()
        train_path, test_path = amazon_corpus(root, SEED + 1)
        corpus_s = time.perf_counter() - t0
        with trace() as tr:
            t0 = time.perf_counter()
            res = text.run_amazon(text.AmazonReviewsConfig(
                train_location=train_path, test_location=test_path, threshold=3.5, n_grams=2,
                common_features=AMAZON_FEATURES, num_iters=20), device=device)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
    fitted = res["pipeline"].fit()
    width = len(_fitted_member(fitted, SparseFeatureVectorizer).feature_space)
    info = _fitted_member(fitted, LinearMapper).lbfgs
    objective = info["objective"]
    # The line search accepts a step whose value exceeds the start by at
    # most approx_dec_rtol·|f| (optax's approximate Wolfe test): the
    # objective is non-increasing to that allowance.
    increases = [b - a for a, b in zip(objective, objective[1:]) if b > a + APPROX_DEC_RTOL * abs(a)]
    result = {
        "seconds": time.perf_counter() - t_phase, "train_reviews": AMAZON_TRAIN, "test_reviews": AMAZON_TEST,
        "rows_cut": f"{AMAZON_REFERENCE_ROWS} reference reviews -> {AMAZON_TRAIN} train / {AMAZON_TEST} test",
        "threshold": 3.5, "n_grams": 2, "common_features": AMAZON_FEATURES, "num_iters": 20,
        "vectorizer_width": width, "train_matrix_bytes": AMAZON_TRAIN * width * 4,
        "corpus_s": corpus_s, "run_s": run_s, **_node_seconds(tr.timings),
        "lbfgs_iterations": info["iterations"], "objective_evaluations": info["evaluations"],
        "linesearch_steps": info["linesearch_steps"], "objective": objective,
        "accuracy": res["metrics"].accuracy, **host.report(),
        **_mnist_end("amazon_reviews"),
    }
    del fitted, res
    torch.cuda.empty_cache()
    log("amazon_reviews", **result)
    checks = {
        "width": width == AMAZON_FEATURES,
        "iterations": 1 <= info["iterations"] <= 20 and len(objective) == info["iterations"] + 1,
        "non_increasing": not increases and all(np.isfinite(objective)),
        "accuracy": result["accuracy"] > 0.8,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"amazon_reviews failed {failed}: increases {increases}")
    return 0


# ------------------------------------------------------------ sketch tier

# sketched: bench.py::_bench_sketched at its own full shape.
SK_N, SK_D, SK_K, SK_S, SK_CHUNK, SK_LATENT, SK_SEED, SK_REG = 2048, 8192, 8, 512, 256, 128, 31, 1e-3
SK_STATE_BYTES, SK_GRAM_BYTES = 16_828_448, 268_697_600
SK_PARITY_TOL = 0.05
# The card's model against the CPU's on the same rows: predictions. Some
# of the 512 CountSketch buckets receive no row of 2,048, so K = SAc·SAcᵀ
# is singular and K + λI (λ = 1e-3) is ill-conditioned: fp32 runs part in
# their weights by ~5e-3 and in their predictions by 1e-5–3e-5 (an H100
# against its host). ``countsketch_conditioning`` prints the empty
# buckets, the condition and the model's distance from float64 (PERF.md).
SK_CPU_TOL = 2e-4
# SRHT at the bench's λ: rows index only 11 bits of the Hadamard (n =
# 2,048), so the 512 sampled rows collide (≈ 64 duplicate pairs expected),
# K = SAc·SAcᵀ is singular, and λ = 1e-3 ≪ ε·‖K‖ is lost in fp32: the
# dual solve meets an exact zero pivot (the JAX package returns NaN
# weights there). The SRHT model is compared at a ridge that survives
# fp32 next to ‖K‖ ≈ 3e5.
SK_SRHT_REG = 1.0
# timit_sketched: TIMIT's featurizer at its published width, rows cut
# from 2,200,000 to 131,072 train (32 chunks) and 16,384 test.
TS_TRAIN, TS_TEST, TS_CHUNK = 131_072, 16_384, 4096
# Cut 12: 65,536 train rows (16 chunks); the sketch (s = 4,096),
# the width and the carry's bytes stay.
TS_TRAIN = TS_TRAIN // 2
TS_STATE_BYTES, TS_GRAM_BYTES, TS_FP64_TOL = 3_358_687_820, 167_892_582_400, 1e-5
# kernel_ridge: RandomPatchCifarKernel's KRR (keystone_tpu/pipelines/cifar.py:
# gamma, kernel_block_size, num_epochs, seed as block_permuter; d = 8 ·
# num_filters) on CIFAR-10's split sizes. The config's reg is None (0.0);
# the phase sets the JAX CLI's --reg default (keystone_tpu/cli.py:164).
# The features are synthetic (class-centred Gaussian rows, standardized):
# the generator and the Nyström landmark count are unsourced.
KRR_N, KRR_TEST, KRR_D, KRR_K = 50_000, 10_000, 800, 10
# Cut 13: 25,000 / 5,000 rows; γ, the block, λ and d stay.
KRR_N, KRR_TEST = KRR_N // 2, KRR_TEST // 2
# Cut 24: 12,500 / 2,500 rows; γ, the block, λ and d stay (mesh_estimators'
# KRR leg runs at these rows too).
KRR_N, KRR_TEST = KRR_N // 2, KRR_TEST // 2
KRR_GAMMA, KRR_BLOCK, KRR_EPOCHS, KRR_PERMUTER, KRR_REG = 2e-4, 2048, 1, 12334, 1e-3
KRR_SPREAD, KRR_SEED, KRR_CPU_ROWS, KRR_NYSTROM = 2.0, 7, 4096, 2048
# fp32 sweeps against float64 and against each other: γ·‖a − b‖² ≈ 0.3
# on these rows, a smooth kernel, so each block's K_bb + λI is
# ill-conditioned (printed: ``first_block_k_plus_lambda_condition``) and
# fp32 Cholesky solves part by 1e-5–1e-4 (an H100 read 1.48e-4 from
# float64 and 5.1e-5 from the CPU at 4,096 rows): the bounds sit about 3×
# above those readings.
KRR_FP64_TOL, KRR_CPU_TOL, KRR_OOM_TOL = 5e-4, 2e-4, 1e-5
KRR_SITE = "KernelRidgeRegression.solve"
#: Filled by phase_timit: the block solver's errors at the published width.
TIMIT_BLOCK_ERRORS: dict = {}


def scoped_env(**values):
    """Environment variables set for a block, restored after it."""
    from unittest import mock

    return mock.patch.dict(os.environ, {k: str(v) for k, v in values.items()})


def sketched_problem():
    """``_bench_sketched``'s rows: low effective rank (128), shifted +8σ so
    the rectifier is the identity on them."""
    rng = np.random.default_rng(SK_SEED)
    z = rng.normal(size=(SK_N, SK_LATENT)).astype(np.float32)
    basis = rng.normal(size=(SK_LATENT, SK_D)).astype(np.float32) / np.sqrt(SK_LATENT)
    x = (z @ basis + 0.01 * rng.normal(size=(SK_N, SK_D)) + 8.0).astype(np.float32)
    w_true = rng.normal(size=(SK_D, SK_K)).astype(np.float32) / np.sqrt(SK_D)
    return x, (np.maximum(x, 0.0) @ w_true).astype(np.float32)


def _sketched_conditioning(x, y, device, model) -> dict:
    """The same streamed CountSketch fit driven directly, its captured
    carry solved in float64 (``fp64_sketch_dual``): empty buckets, the
    condition of K + λI, and the pipeline model's predictions and
    weights against the float64 solve's."""
    import torch

    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.stats.core import LinearRectifier
    from keystone_tpu_torch.sketch.solvers import SketchedLeastSquaresEstimator
    from keystone_tpu_torch.workflow.streaming import ChunkStream

    est = SketchedLeastSquaresEstimator(reg=SK_REG, device=device)
    est.fit_stream(ChunkStream(ArrayDataset(x, device=device), ArrayDataset(y, device=device),
                               (LinearRectifier(0.0),), chunk_rows=SK_CHUNK, device=device))
    state = est.export_stream_state()
    w64, k64 = fp64_sketch_dual(state, SK_REG, device)
    eig = torch.linalg.eigvalsh(k64)
    head = torch.as_tensor(x[:256], device=device, dtype=torch.float64) - model.feature_mean.double()
    return {"empty_buckets": int(np.all(state.carry[0] == 0, axis=1).sum()),
            "k_plus_lambda_condition": float((eig[-1] + SK_REG) / (eig[0].clamp_min(0) + SK_REG)),
            "predictions_vs_fp64": rel_err(head @ model.weights.double(), head @ w64),
            "weights_vs_fp64": rel_err(model.weights, w64)}


def _srht_outcome(x, y, device) -> dict:
    """The SRHT variant at the bench's λ: it raises (an exact zero pivot
    in the dual solve) or returns a model, finite or not."""
    import torch

    try:
        model = _sketched_fit(x, y, device, "srht")[0]
    except torch.linalg.LinAlgError as e:
        return {"raised": True, "finite": False, "error": str(e)[:120]}
    return {"raised": False, "finite": bool(torch.isfinite(model.weights).all())}


def _sketched_pipeline(x, y, device, reg=SK_REG):
    import torch

    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.learning.cost import cuda_weights
    from keystone_tpu_torch.ops.learning.least_squares import LeastSquaresEstimator
    from keystone_tpu_torch.ops.stats.core import LinearRectifier

    # The card's weights on both devices, so that the CPU fit picks the
    # card's rung.
    est = LeastSquaresEstimator(reg=reg, weights=cuda_weights(torch.cuda.get_device_name(0)), device=device)
    return LinearRectifier(0.0).to_pipeline().then_label_estimator(
        est, ArrayDataset(x, device=device), ArrayDataset(y, device=device))


def _sketched_fit(x, y, device, variant, streamed=True, reg=SK_REG):
    """The bench leg's pipeline fitted on ``device``: (its LinearMapper,
    fit seconds, plan labels)."""
    import contextlib

    import torch

    from keystone_tpu_torch.ops.learning.linear import LinearMapper
    from keystone_tpu_torch.workflow.executor import PipelineEnv
    from keystone_tpu_torch.workflow.streaming import streaming_disabled

    PipelineEnv.reset()
    pipe = _sketched_pipeline(x, y, device, reg)
    with scoped_env(KEYSTONE_SKETCH_VARIANT=variant), (
            contextlib.nullcontext() if streamed else streaming_disabled()):
        plan = plan_labels(PipelineEnv.get_or_create().optimizer.execute(pipe.graph)[0])
        t0 = time.perf_counter()
        fitted = pipe.fit()
        if device.type == "cuda":
            torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    return _fitted_member(fitted, LinearMapper), fit_s, plan


def _model_rel(a, b, x_head) -> dict:
    import torch

    xh = torch.as_tensor(x_head)
    return {"weights": rel_err(a.weights.cpu(), b.weights.cpu()),
            "predictions": rel_err(a.apply_arrays(xh.to(a.weights.device)).cpu(),
                                   b.apply_arrays(xh.to(b.weights.device)).cpu())}


def phase_sketched(device) -> int:
    """Phase 20: ``bench.py::_bench_sketched`` at its full shape, then the
    SRHT variant and the in-core pick, each against the same fit on the
    CPU (module docstring)."""
    import torch

    from keystone_tpu_torch.obs import names
    from keystone_tpu_torch.sketch.core import sketch_state_bytes
    from keystone_tpu_torch.workflow.streaming import last_stream_report

    cpu = torch.device("cpu")
    _mnist_start()
    t_phase = time.perf_counter()
    x, y = sketched_problem()
    fits = names.metric(names.SKETCH_FITS)
    result, failed = {"n": SK_N, "d": SK_D, "k": SK_K, "s": SK_S, "chunk_rows": SK_CHUNK}, []
    with scoped_env(KEYSTONE_STREAM_CHUNK_ROWS=SK_CHUNK, KEYSTONE_SKETCH_SIZE=SK_S):
        _sketched_fit(x, y, device, "countsketch")  # warm
        before = fits.value(variant="countsketch")
        model, fit_s, plan = _sketched_fit(x, y, device, "countsketch")
        report = last_stream_report()
        delta = fits.value(variant="countsketch") - before
        head = torch.as_tensor(x[:256], device=device)
        parity = rel_err(model.apply_arrays(head).cpu(), torch.as_tensor(y[:256]))
        state_bytes = int(names.metric(names.SKETCH_STATE_BYTES).value())
        result.update({
            "plan": plan, "sketched_fit_wall_s": fit_s, "sketch_fits_delta": delta,
            "parity_rel_err": parity, "chunks": report.chunks,
            "compiles_first_chunk": report.compiles_first_chunk,
            "compiles_steady_state": report.compiles_steady_state,
            "sketch_state_bytes": state_bytes, "gram_state_bytes": 4 * (SK_D * SK_D + SK_D * SK_K),
        })
        result["state_bytes_ratio"] = round(result["gram_state_bytes"] / state_bytes, 1)
        cpu_model = _sketched_fit(x, y, cpu, "countsketch")[0]
        result["countsketch_vs_cpu"] = _model_rel(model, cpu_model, x[:256])
        result["vs_cpu_predictions_tol"] = SK_CPU_TOL
        result["countsketch_conditioning"] = _sketched_conditioning(x, y, device, model)
        result["srht_at_reg"] = {dev.type: _srht_outcome(x, y, dev) for dev in (device, cpu)}
        for variant, streamed, label, reg in (("srht", True, "srht", SK_SRHT_REG),
                                              ("countsketch", False, "in_core", SK_REG)):
            card, secs, card_plan = _sketched_fit(x, y, device, variant, streamed, reg)
            on_cpu = _sketched_fit(x, y, cpu, variant, streamed, reg)[0]
            result[label] = {"reg": reg, "fit_s": secs, "plan": card_plan, "vs_cpu": _model_rel(card, on_cpu, x[:256]),
                             "parity_rel_err": rel_err(card.apply_arrays(head).cpu(), torch.as_tensor(y[:256]))}
    result["seconds"] = time.perf_counter() - t_phase
    log("sketched", **result, **_mnist_end("sketched"))
    checks = {
        "rung_is_sketch": delta >= 1 and any("SketchedLeastSquaresEstimator" in p for p in plan),
        "parity": parity < SK_PARITY_TOL,
        "compiles_steady_state": report.compiles_steady_state == 0,
        "state_bytes": state_bytes == SK_STATE_BYTES == sketch_state_bytes(SK_S, SK_D, SK_K)
        and result["gram_state_bytes"] == SK_GRAM_BYTES and result["state_bytes_ratio"] == 16.0,
        "countsketch_vs_cpu": result["countsketch_vs_cpu"]["predictions"] <= SK_CPU_TOL,
        "srht_vs_cpu": result["srht"]["vs_cpu"]["predictions"] <= SK_CPU_TOL,
        "srht_at_reg_never_quietly_non_finite": all(
            o["raised"] or o["finite"] for o in result["srht_at_reg"].values()),
        "in_core_vs_cpu": result["in_core"]["vs_cpu"]["predictions"] <= SK_CPU_TOL,
        "in_core_is_not_streamed": not any(p.startswith("StreamFit") for p in result["in_core"]["plan"]),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"sketched failed {failed}")
    return 0


def timit_features(cfg, device):
    """TIMIT's featurizer (``pipelines/timit.py::build_featurizer``: the
    same 50 seeded cosine branches, concatenated) as one transformer, so
    that the chunk chain runs all of it on each chunk. The plan rule
    takes only a linear chain of transformers into a stream; the gather
    of 50 branches would stop it, and the stream would start from the
    materialized (n, 204,800) matrix."""
    import torch

    from keystone_tpu_torch.ops.stats.core import CosineRandomFeatures
    from keystone_tpu_torch.pipelines.timit import TIMIT_DIMENSION
    from keystone_tpu_torch.workflow.pipeline import BatchTransformer

    class TimitFeatures(BatchTransformer):
        def __init__(self, branches):
            self.branches = branches

        def apply_arrays(self, x):
            return torch.cat([b.apply_arrays(x) for b in self.branches], dim=1)

    return TimitFeatures([
        CosineRandomFeatures.create(TIMIT_DIMENSION, cfg.num_cosine_features, cfg.gamma,
                                    dist=cfg.rf_type, seed=cfg.seed + i, device=device)
        for i in range(cfg.num_cosines)
    ])


def fp64_sketch_dual(state, reg, device):
    """(W, K) of the s×s dual solve of a captured sketch carry in float64
    with plain PyTorch on the card (not the binding)."""
    import torch

    sa, sy, s1, sums_x, sums_y = (torch.from_numpy(a).to(device=device, dtype=torch.float64)
                                  for a in state.carry)
    n = state.num_examples
    sa -= s1[:, None] * (sums_x / n)[None, :]
    sy -= s1[:, None] * (sums_y / n)[None, :]
    k = sa @ sa.T
    s = k.shape[0]
    lam = reg if reg and reg > 0 else max(1e-6 * float(torch.trace(k)) / s, 1e-6)
    duals = torch.linalg.solve(k + lam * torch.eye(s, dtype=k.dtype, device=device), sy)
    return sa.T @ duals, k


def sketch_gram_errors(state, k64, device) -> dict:
    """K = SAc·SAcᵀ of the captured carry at IEEE fp32 as one binding
    product and as the finish computes it (``sketch_gram``: 4,096-column
    partial sums), each against the float64 K."""
    import torch

    from keystone_tpu_torch.ops.cuda import gemm
    from keystone_tpu_torch.sketch.core import sketch_gram, sketch_stream_finish

    carry = [torch.from_numpy(a).to(device) for a in state.carry]
    sa_c = sketch_stream_finish(carry, state.num_examples)[0]
    del carry
    eig = torch.linalg.eigvalsh(k64)
    lam = max(1e-6 * float(eig.sum()) / k64.shape[0], 1e-6)
    return {"k_one_product_vs_fp64": rel_err(gemm.gemm(sa_c, sa_c.T, "ieee_fp32"), k64),
            "k_sketch_gram_vs_fp64": rel_err(sketch_gram(sa_c), k64),
            "k_plus_lambda_condition": float((eig[-1] + lam) / (eig[0].clamp_min(0) + lam))}


def _chunked_error(model, features, data, labels, rows) -> float:
    import torch

    wrong = 0
    for start in range(0, rows, TS_CHUNK):
        scores = model.apply_arrays(features.apply_arrays(data[start:start + TS_CHUNK]))
        wrong += int((scores.argmax(dim=1) != labels[start:start + TS_CHUNK].long()).sum())
    return wrong / rows


def phase_timit_sketched(device) -> int:
    """Phase 21: TIMIT at its published width fitted by the meta-solver's
    streamed path on the sketched rung (module docstring)."""
    import torch

    from keystone_tpu_torch.obs import spans
    from keystone_tpu_torch.ops.learning.least_squares import LeastSquaresEstimator, _stream_width
    from keystone_tpu_torch.ops.util.labels import ClassLabelIndicators
    from keystone_tpu_torch.pipelines.timit import NUM_CLASSES, TimitConfig, synthetic_timit
    from keystone_tpu_torch.sketch.core import countsketch_hash, index_mask, sketch_state_bytes
    from keystone_tpu_torch.workflow.streaming import ChunkStream, last_stream_report

    cfg = TimitConfig()
    _mnist_start()
    t_phase = t0 = time.perf_counter()
    train = synthetic_timit(TS_TRAIN, seed=cfg.seed, device=device)
    test = synthetic_timit(TS_TEST, seed=cfg.seed + 1, device=device)
    labels = ClassLabelIndicators(NUM_CLASSES).apply_batch(train.labels)
    features = timit_features(cfg, device)
    data_s = time.perf_counter() - t0
    est = LeastSquaresEstimator(reg=cfg.reg, device=device)
    stream = ChunkStream(train.data, labels, (features,), chunk_rows=TS_CHUNK, device=device)
    width = _stream_width(stream, est.block_size)
    rung = type(est._stream_solver(width)).__name__
    route = ("LeastSquaresEstimator.fit_stream over ChunkStream(raw 440-wide rows, "
             f"members=[TimitFeatures: {cfg.num_cosines} CosineRandomFeatures, concatenated])")
    torch.cuda.synchronize()
    with spans.tracing_session() as session:
        t0 = time.perf_counter()
        model = est.fit_stream(stream)
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    capture = session.find("stream_state:capture")[-1]
    fold = session.find("stream:fold")[-1]
    split = {"fit_s": t_end - t0, "fold_s": fold.duration_s, "capture_s": capture.duration_s,
             "finish_s": t_end - capture.end_s}
    report = last_stream_report()
    state = est.export_stream_state()
    s = int(state.carry[0].shape[0])
    w64, k64 = fp64_sketch_dual(state, cfg.reg, device)
    w_rel = rel_err(model.weights, w64)
    del w64
    k_errors = sketch_gram_errors(state, k64, device)
    del k64
    bucket, sign = countsketch_hash(index_mask(0, TS_CHUNK, device), s, state.meta["sketch_seed"])
    cpu_bucket, cpu_sign = countsketch_hash(index_mask(0, TS_CHUNK, torch.device("cpu")), s,
                                            state.meta["sketch_seed"])
    hash_equal = bool(torch.equal(bucket.cpu(), cpu_bucket) and torch.equal(sign.cpu(), cpu_sign))
    errors = {
        "train_error_first_16384": _chunked_error(model, features, train.data.data, train.labels.data, TS_TEST),
        "test_error": _chunked_error(model, features, test.data.data, test.labels.data, TS_TEST),
    }
    peak, total = torch.cuda.max_memory_allocated(), torch.cuda.get_device_properties(0).total_memory
    result = {
        "route": route, "rung": rung, "state_estimator": state.estimator, "sketch_variant": state.meta["sketch_variant"],
        "rows": [TS_TRAIN, TS_TEST], "chunk_rows": TS_CHUNK, "chunks": report.chunks, "features": width, "sketch_size": s,
        "data_s": data_s, **split, "captured_state_bytes": state.nbytes(),
        "gram_state_bytes": 4 * (width * width + width * NUM_CLASSES),
        "weights_vs_fp64_same_carry_rel": w_rel, "fp64_tol": TS_FP64_TOL, **k_errors, "first_chunk_hash_equals_cpu": hash_equal, **errors,
        "block_solver_timit_errors_4096_rows": TIMIT_BLOCK_ERRORS, "peak_device_bytes_fit_and_checks": peak,
        "device_total_bytes": total, "seconds": time.perf_counter() - t_phase,
    }
    del model, state, train, test, labels, features, stream, est
    torch.cuda.empty_cache()
    log("timit_sketched", **result, **_mnist_end("timit_sketched"))
    checks = {
        "rung": rung == "SketchedLeastSquaresEstimator" and result["state_estimator"].endswith(rung)
        and result["sketch_variant"] == "countsketch" and s == 4096,
        "state_bytes": result["captured_state_bytes"] == TS_STATE_BYTES == sketch_state_bytes(s, width, NUM_CLASSES)
        and result["gram_state_bytes"] == TS_GRAM_BYTES,
        "fp64": w_rel <= TS_FP64_TOL,
        "hash": hash_equal,
        "peak": peak < total,
        "chunks": report.chunks == TS_TRAIN // TS_CHUNK,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"timit_sketched failed {failed}")
    return 0


def krr_problem():
    """Class-centred Gaussian rows (10 centres ~ N(0, 1), spread
    ``KRR_SPREAD``), standardized by the training rows' column statistics
    as the CIFAR pipeline's ``StandardScaler`` does; ±1 class indicators."""
    rng = np.random.default_rng(KRR_SEED)
    centres = rng.normal(size=(KRR_K, KRR_D)).astype(np.float32)
    labels = rng.integers(0, KRR_K, KRR_N + KRR_TEST)
    x = centres[labels] + KRR_SPREAD * rng.normal(size=(KRR_N + KRR_TEST, KRR_D)).astype(np.float32)
    mu, sd = x[:KRR_N].mean(axis=0), x[:KRR_N].std(axis=0)
    x = ((x - mu) / sd).astype(np.float32)
    y = -np.ones((KRR_N + KRR_TEST, KRR_K), np.float32)
    y[np.arange(KRR_N + KRR_TEST), labels] = 1.0
    return x, y, labels


def fp64_krr_scores(x, y, xt, n, bs):
    """Test scores of the same Gauss-Seidel sweep (block order, padding,
    λ) in float64 with plain PyTorch on the card."""
    import torch

    def kernel(a, b):
        sq = (a * a).sum(1, keepdim=True) - 2.0 * (a @ b.T) + (b * b).sum(1)
        return torch.exp(-KRR_GAMMA * sq.clamp_min(0.0))

    n_pad = -(-n // bs) * bs
    xp = torch.zeros(n_pad, x.shape[1], dtype=torch.float64, device=x.device)
    yp = torch.zeros(n_pad, y.shape[1], dtype=torch.float64, device=x.device)
    xp[:n], yp[:n] = x[:n].double(), y[:n].double()
    valid = (torch.arange(n_pad, device=x.device) < n).double()
    w = torch.zeros_like(yp)
    eye = torch.eye(bs, dtype=torch.float64, device=x.device)
    rng = np.random.default_rng(KRR_PERMUTER)
    for _ in range(KRR_EPOCHS):
        order = np.arange(n_pad // bs)
        rng.shuffle(order)
        for s in (order * bs).tolist():
            cv = valid[s:s + bs]
            panel = kernel(xp, xp[s:s + bs]) * valid[:, None] * cv[None, :]
            kbb = kernel(xp[s:s + bs], xp[s:s + bs]) * cv[:, None] * cv[None, :]
            rhs = yp[s:s + bs] - (panel.T @ w - kbb.T @ w[s:s + bs])
            w[s:s + bs] = torch.cholesky_solve(rhs, torch.linalg.cholesky(kbb + KRR_REG * eye))
    xt = xt.double()
    scores = sum(kernel(xt, xp[s:s + bs]) @ w[s:s + bs] for s in range(0, n_pad, bs))
    eig = torch.linalg.eigvalsh(kernel(xp[:bs], xp[:bs]) + KRR_REG * eye)
    return scores, float(eig[-1] / eig[0])


def _krr(block, device):
    from keystone_tpu_torch.ops.learning.kernel import GaussianKernelGenerator, KernelRidgeRegression

    return KernelRidgeRegression(GaussianKernelGenerator(KRR_GAMMA, device=device), KRR_REG, block,
                                 KRR_EPOCHS, block_permuter=KRR_PERMUTER)


def phase_kernel_ridge(device) -> int:
    """Phase 22: ``KernelRidgeRegression`` at the CIFAR kernel variant's
    configuration, its Nyström rung and its OOM ladder (module docstring)."""
    import torch

    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.obs import names, spans
    from keystone_tpu_torch.reliability import FaultSpec, injected

    cpu = torch.device("cpu")
    _mnist_start()
    t_phase = time.perf_counter()
    xh, yh, labels = krr_problem()
    x, y = torch.as_tensor(xh, device=device), torch.as_tensor(yh, device=device)
    train, targets = ArrayDataset(x[:KRR_N]), ArrayDataset(y[:KRR_N])
    xt, test_labels = x[KRR_N:], torch.as_tensor(labels[KRR_N:], device=device)

    def timed(make):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = make()
        torch.cuda.synchronize()
        return model, time.perf_counter() - t0

    model, fit_s = timed(lambda: _krr(KRR_BLOCK, device).fit(train, targets))
    scores, apply_s = timed(lambda: model.apply_arrays(xt))
    s64, block_condition = fp64_krr_scores(x, y, xt, KRR_N, KRR_BLOCK)
    result = {
        "n": KRR_N, "test": KRR_TEST, "d": KRR_D, "k": KRR_K, "gamma": KRR_GAMMA, "block": KRR_BLOCK,
        "epochs": KRR_EPOCHS, "block_permuter": KRR_PERMUTER, "reg": KRR_REG, "fit_s": fit_s, "apply_s": apply_s,
        "test_error": float((scores.argmax(1) != test_labels).float().mean()),
        "scores_vs_fp64_rel": rel_err(scores, s64), "fp64_tol": KRR_FP64_TOL,
        "fp64_test_error": float((s64.argmax(1) != test_labels).float().mean()),
        "first_block_k_plus_lambda_condition": block_condition,
    }
    del s64
    # The same fit on the CPU at 4,096 rows.
    small = [ArrayDataset(t[:KRR_CPU_ROWS]) for t in (x, y)]
    small_cpu = [ArrayDataset(t[:KRR_CPU_ROWS].cpu()) for t in (x, y)]
    card = _krr(KRR_BLOCK, device).fit(*small).apply_arrays(xt[:1000]).cpu()
    on_cpu = _krr(KRR_BLOCK, cpu).fit(*small_cpu).apply_arrays(xt[:1000].cpu())
    result["cpu_4096_rows_scores_rel"], result["cpu_tol"] = rel_err(card, on_cpu), KRR_CPU_TOL
    # The Nyström rung on the same rows.
    fits = names.metric(names.SKETCH_FITS)
    before = fits.value(variant="nystrom")
    with scoped_env(KEYSTONE_KERNEL_NYSTROM=KRR_NYSTROM), spans.tracing_session() as session:
        nystrom, nystrom_fit_s = timed(lambda: _krr(KRR_BLOCK, device).fit(train, targets))
    n_scores = nystrom.apply_arrays(xt)
    result["nystrom"] = {
        "landmarks": KRR_NYSTROM, "fit_s": nystrom_fit_s,
        "host_solve_s": session.find("sketch:nystrom_host_solve")[-1].duration_s,
        "sketch_fits_delta": fits.value(variant="nystrom") - before,
        "test_error": float((n_scores.argmax(1) != test_labels).float().mean()),
        "scores_vs_full_krr_rel": rel_err(n_scores, scores),
    }
    del nystrom, n_scores
    # An injected OOM at the solve: 2,048 → 1,024, against a direct 1,024 fit.
    with injected(FaultSpec(match=KRR_SITE, kind="oom", first_n=1)):
        degraded, oom_fit_s = timed(lambda: _krr(KRR_BLOCK, device).fit(train, targets))
    direct = _krr(KRR_BLOCK // 2, device).fit(train, targets)
    result["oom"] = {"fit_s": oom_fit_s, "degradation": dict(getattr(degraded, "degradation", {})),
                     "vs_direct_1024_scores_rel": rel_err(degraded.apply_arrays(xt), direct.apply_arrays(xt))}
    result["seconds"] = time.perf_counter() - t_phase
    del degraded, direct, model, scores, x, y, train, targets, xt
    torch.cuda.empty_cache()
    log("kernel_ridge", **result, **_mnist_end("kernel_ridge"))
    checks = {
        "fp64": result["scores_vs_fp64_rel"] <= KRR_FP64_TOL,
        "cpu": result["cpu_4096_rows_scores_rel"] <= KRR_CPU_TOL,
        "nystrom": result["nystrom"]["sketch_fits_delta"] == 1,
        "oom": result["oom"]["degradation"].get("rung") == KRR_BLOCK // 2
        and result["oom"]["degradation"].get("first_rung") == KRR_BLOCK
        and result["oom"]["vs_direct_1024_scores_rel"] <= KRR_OOM_TOL,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"kernel_ridge failed {failed}")
    return 0


# CIFAR-10 phases. cifar_features and cifar_random_patch_fused: the
# reference random-patch configuration (examples/images/cifar_random_patch.sh:
# 10,000 filters of 6×6×3; RandomPatchCifar.scala: α = 0.25, pool 14 /
# stride 13) as bench.py::_bench_cifar_random_patch draws it: filters
# N(0, 0.1²) from seed 0, random labels over 10 classes, 50,000 uniform
# [0, 1) images, filter block 512, ConvBlockLeastSquaresEstimator(block
# 4,096 = 512 filters, 1 epoch, λ = 3,000, 2,048-image chunks): 20 blocks,
# and the 80,000-wide feature matrix never exists.
CIFAR_FILTERS, CIFAR_PATCH, CIFAR_ALPHA, CIFAR_POOL, CIFAR_STRIDE = 10_000, 6, 0.25, 14, 13
CIFAR_FILTER_BLOCK, CIFAR_SOLVER_BLOCK, CIFAR_REG, CIFAR_CHUNK = 512, 4096, 3000.0, 2048
CIFAR_TRAIN, CIFAR_TEST, CIFAR_CLASSES = 50_000, 10_000, 10
CIFAR_RATE_IMAGES, CIFAR_GATE_IMAGES, CIFAR_BENCH_PROBE = 2048, 256, 256 + 32
# Fused against the unfused Convolver → SymmetricRectifier → Pooler →
# ImageVectorizer chain (the same products in another grouping), and the
# features with PyTorch's TF32 flags on against off (the same calls: no
# flag is read, so they should be bitwise equal).
CIFAR_FUSED_TOL, CIFAR_TF32_TOL = 1e-5, 1e-6
# The features against the same formula in float64 on the card: fp32
# products 108 deep and the box statistics' (Σx² − d·m²) on uniform
# pixels; an H100 read 1.08e-6.
CIFAR_FP64_TOL = 1e-5
CONV_APPLY_TOL = 1e-5
# The one-block fit's predictions against the float64 ridge solve of the
# same features: the Gram + λI (λ = 3,000 against a diagonal of ~50,000)
# has condition ~27, so the fp32 solve sits near round-off; an H100 read
# 3.0e-6.
CONV_ONE_BLOCK_FP64_TOL = 2e-5
# cifar_workloads: the CLI's seven CIFAR workloads on synthetic learnable
# CIFAR (tests/pipelines/test_cifar.py:16-23: 10 prototype images
# N(128, 40²) plus N(0, 10²) noise, clipped to 0–255, unsourced), 50,000
# train and 10,000 test images written as CIFAR-10 binaries; the
# augmented workloads' training set is cut to 5,000 images (× 10 crops).
CIFAR_SYNTH_SEED, CIFAR_AUGMENT_TRAIN = 0, 5000
# Cut 22: the augmented workloads' training set at 2,500 images (× 10
# crops; both read test error 0.0 at 5,000); the other five workloads
# keep 50,000 / 10,000.
CIFAR_AUGMENT_TRAIN = CIFAR_AUGMENT_TRAIN // 2
CIFAR_ERROR_BOUND, CIFAR_FUSED_VS_BLOCK = 0.2, 0.01
CIFAR_WORKLOADS = (  # (variant, flags, augmented training set)
    ("random_patch", {"num_filters": 1000, "reg": 3000.0, "whitening_epsilon": 1e-5}, False),
    ("random_patch_fused", {"num_filters": 1000, "reg": 3000.0, "whitening_epsilon": 1e-5}, False),
    ("random_patch_kernel", {"reg": KRR_REG}, False),
    ("linear_pixels", {}, False),
    ("random", {}, False),
    ("random_patch_augmented", {}, True),
    ("random_patch_kernel_augmented", {"reg": KRR_REG}, True),
)


def cifar_reference_draws():
    """``bench.py::_bench_cifar_random_patch``'s draws from seed 0, in its
    order: the filters, the ±1 label rows, its probe batch (drawn and
    dropped); the generator then yields its training images."""
    rng = np.random.default_rng(0)
    filters = rng.normal(size=(CIFAR_FILTERS, CIFAR_PATCH * CIFAR_PATCH * 3)).astype(np.float32) * 0.1
    labels = -np.ones((CIFAR_TRAIN, CIFAR_CLASSES), np.float32)
    labels[np.arange(CIFAR_TRAIN), rng.integers(0, CIFAR_CLASSES, CIFAR_TRAIN)] = 1.0
    rng.random((CIFAR_BENCH_PROBE, 32, 32, 3), dtype=np.float32)
    return filters, labels, rng


def cifar_featurizer(filters, device):
    from keystone_tpu_torch.ops.images import Convolver, FusedConvFeaturizer, Pooler, SymmetricRectifier

    return FusedConvFeaturizer(
        Convolver(filters, 3, normalize_patches=True, device=device),
        SymmetricRectifier(alpha=CIFAR_ALPHA), Pooler(CIFAR_STRIDE, CIFAR_POOL, None, "sum"),
        filter_block=min(CIFAR_FILTER_BLOCK, len(filters)),
    )


def fp64_cifar_features(fz, x):
    """The featurizer's formula (box statistics, (raw − m·Σf)/sd, rectify,
    sum-pool, [pos | neg] vectorized) in float64 with plain PyTorch on the
    card, one filter block at a time."""
    import torch

    conv, s = fz.conv, fz.conv.conv_size
    x = x.double()
    n = x.shape[0]
    p = x.unfold(1, s, 1).unfold(2, s, 1).permute(0, 1, 2, 5, 4, 3)
    rx, ry = p.shape[1], p.shape[2]
    p = p.reshape(n, rx, ry, -1)
    d = float(p.shape[-1])
    m = p.sum(-1, keepdim=True) / d
    sd = torch.sqrt(torch.clamp_min(p.square().sum(-1, keepdim=True) - d * m * m, 0.0) / (d - 1.0)
                    + conv.var_constant)
    k, fs = conv.kernel.double(), conv.filter_sums.double()
    pos, neg = [], []
    for start in range(0, conv.num_filters, fz.filter_block):
        stop = start + fz.filter_block
        out = ((p.reshape(-1, p.shape[-1]) @ k[:, start:stop]).reshape(n, rx, ry, -1) - m * fs[start:stop]) / sd
        pos.append(fz.pool.apply_arrays(torch.clamp_min(out - fz.rect.alpha, fz.rect.max_val)))
        neg.append(fz.pool.apply_arrays(torch.clamp_min(-out - fz.rect.alpha, fz.rect.max_val)))
    pooled = torch.cat(pos + neg, dim=-1)
    return pooled.transpose(1, 2).reshape(n, -1)


def synced_s(fn):
    """(result, seconds) of ``fn()`` on the host clock, the card synchronised
    before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_cifar_features(device) -> int:
    """Phase 23: ``FusedConvFeaturizer`` at the reference configuration:
    images/s, the fused and unfused chains, float64, the TF32 switch."""
    import torch

    from keystone_tpu_torch.ops.images import ImageVectorizer
    from keystone_tpu_torch.parallel import linalg

    _mnist_start()
    filters, _labels, rng = cifar_reference_draws()
    fz = cifar_featurizer(filters, device)
    x = torch.as_tensor(rng.random((CIFAR_RATE_IMAGES, 32, 32, 3), dtype=np.float32), device=device)
    feats, cold_s = synced_s(lambda: fz.apply_arrays(x))
    runs = [synced_s(lambda: fz.apply_arrays(x))[1] for _ in range(3)]
    warm_s = float(np.median(runs))
    del feats
    # One filter block of the 2,048-image chunk, by CUDA events: the patch
    # rows, the box statistics, the product alone, and the whole block
    # (product, normalize, rectify, pool).
    p = fz.patch_matrix(x)
    m, sd = fz.norm_stats(p)
    kb, fsb, offb = fz.packed_filter_blocks()
    block_split_ms = {
        "patch_rows": cuda_ms(lambda: fz.patch_matrix(x), 3),
        "box_stats": cuda_ms(lambda: fz.norm_stats(p), 3),
        "product": cuda_ms(lambda: linalg.mm(p.reshape(-1, p.shape[-1]), kb[0]), 3),
        "block_pooled": cuda_ms(lambda: fz.block_pooled(p, kb[0], fsb[0], offb[0], m, sd), 3),
    }
    del p, m, sd
    xs = x[:CIFAR_GATE_IMAGES]
    fused = fz.apply_arrays(xs)
    chain = fz.conv.apply_arrays(xs)
    unfused_conv_bytes = chain.numel() * chain.element_size()
    chain = ImageVectorizer().apply_arrays(fz.pool.apply_arrays(fz.rect.apply_arrays(chain)))
    result = {
        "filters": CIFAR_FILTERS, "filter_block": CIFAR_FILTER_BLOCK, "images": CIFAR_RATE_IMAGES,
        "feature_width": int(fused.shape[1]), "cold_s": cold_s, "warm_s_runs": runs, "warm_s": warm_s,
        "images_per_s": CIFAR_RATE_IMAGES / warm_s, "block_split_ms": block_split_ms,
        "gate_images": CIFAR_GATE_IMAGES, "unfused_conv_bytes": unfused_conv_bytes,
        "fused_vs_unfused_rel": rel_err(fused, chain), "fused_tol": CIFAR_FUSED_TOL,
    }
    del chain
    torch.cuda.empty_cache()
    result["vs_fp64_rel"], result["fp64_tol"] = rel_err(fused, fp64_cifar_features(fz, xs)), CIFAR_FP64_TOL
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = False, False
        off = fz.apply_arrays(xs)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, True
        on = fz.apply_arrays(xs)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    result["tf32_on_vs_off_rel"], result["tf32_tol"] = rel_err(on, off), CIFAR_TF32_TOL
    result["tf32_bitwise_equal"] = bool(torch.equal(on, off))
    del fused, on, off, x, xs, fz
    torch.cuda.empty_cache()
    log("cifar_features", **result, **_mnist_end("cifar_features"))
    checks = {
        "fused": result["fused_vs_unfused_rel"] <= CIFAR_FUSED_TOL,
        "fp64": result["vs_fp64_rel"] <= CIFAR_FP64_TOL,
        "tf32": result["tf32_on_vs_off_rel"] <= CIFAR_TF32_TOL,
        "width": result["feature_width"] == 8 * CIFAR_FILTERS,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"cifar_features failed {failed}")
    return 0


def fp64_ridge_on_features(feats, y, reg):
    """Predictions of the exact standardized ridge solve (the one-block BCD
    epoch's problem) in float64 with plain PyTorch on the card, and the
    condition of its Gram + λI."""
    import torch

    f = feats.double()
    y64 = y.double()
    mu, sd = f.mean(0), f.std(0)
    a = (f - mu) * torch.where(sd < 1e-8, torch.ones_like(sd), 1.0 / sd)
    del f
    g = a.T @ a + reg * torch.eye(a.shape[1], dtype=torch.float64, device=a.device)
    w = torch.cholesky_solve(a.T @ (y64 - y64.mean(0)), torch.linalg.cholesky(g))
    eig = torch.linalg.eigvalsh(g)
    return a @ w + y64.mean(0), float(eig[-1] / eig[0])


def phase_cifar_random_patch_fused(device) -> int:
    """Phase 24: ``bench.py::_bench_cifar_random_patch`` at full size
    through ``ConvBlockLeastSquaresEstimator`` (halving ladder on n kept),
    the chunked apply, and a one-block fit against float64."""
    import torch

    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.learning.conv_block import ConvBlockLeastSquaresEstimator
    from keystone_tpu_torch.reliability import DegradationLadder, halving_rungs

    _mnist_start()
    t_phase = time.perf_counter()
    filters, labels, rng = cifar_reference_draws()
    fz = cifar_featurizer(filters, device)

    def estimator(featurizer):
        return ConvBlockLeastSquaresEstimator(featurizer, block_size=CIFAR_SOLVER_BLOCK, num_iter=1,
                                              reg=CIFAR_REG, image_chunk=CIFAR_CHUNK, device=device)

    ladder = DegradationLadder(halving_rungs(CIFAR_TRAIN, CIFAR_TRAIN // 4), label="cifar_random_patch")

    def attempt(n_do):
        images = rng.random((n_do, 32, 32, 3), dtype=np.float32)
        model, fit_s = synced_s(lambda: estimator(fz).fit(ArrayDataset(images, device=device),
                                                           ArrayDataset(labels[:n_do], device=device)))
        return n_do, images, model, fit_s

    n_do, images, model, fit_s = ladder.run(attempt)
    fit_peak = torch.cuda.max_memory_allocated()
    x = torch.as_tensor(images, device=device)
    kb, fsb, offb = fz.packed_filter_blocks(CIFAR_FILTER_BLOCK)
    _, block_featurize_s = synced_s(lambda: estimator(fz)._featurize_block(
        x, kb[0], fsb[0], offb[0], CIFAR_SOLVER_BLOCK))
    head = x[:CIFAR_CHUNK]
    apply_scores, apply_s = synced_s(lambda: model.apply_arrays(head))
    direct = model.linear.apply_arrays(fz.apply_arrays(head))
    result = {
        "n": n_do, "filters": CIFAR_FILTERS, "feature_width": int(model.weights.shape[0]),
        "block_size": CIFAR_SOLVER_BLOCK, "blocks": -(-CIFAR_FILTERS // CIFAR_FILTER_BLOCK), "reg": CIFAR_REG,
        "end_to_end_fit_s": fit_s, "fit_peak_device_bytes": fit_peak,
        "ladder_stepped": bool(ladder.reduced), "ladder_record": dict(ladder.record),
        "one_block_featurize_s": block_featurize_s, "apply_s_2048_images": apply_s,
        "apply_vs_featurizer_then_mapper_rel": rel_err(apply_scores, direct), "apply_tol": CONV_APPLY_TOL,
    }
    del model, apply_scores, direct, head
    torch.cuda.empty_cache()
    # One block (512 filters = 4,096 features): one BCD epoch is the exact
    # standardized ridge solve.
    fz1 = cifar_featurizer(filters[:CIFAR_FILTER_BLOCK], device)
    y = torch.as_tensor(labels[:n_do], device=device)
    one, one_fit_s = synced_s(lambda: estimator(fz1).fit(ArrayDataset(x), ArrayDataset(y)))
    feats = fz1.apply_arrays(x)
    p32 = one.linear.apply_arrays(feats)
    p64, condition = fp64_ridge_on_features(feats, y, CIFAR_REG)
    result["one_block"] = {"fit_s": one_fit_s, "vs_fp64_rel": rel_err(p32, p64),
                           "fp64_tol": CONV_ONE_BLOCK_FP64_TOL, "gram_plus_reg_condition": condition}
    result["seconds"] = time.perf_counter() - t_phase
    del one, feats, p32, p64, x, y, fz, fz1
    torch.cuda.empty_cache()
    log("cifar_random_patch_fused", **result, **_mnist_end("cifar_random_patch_fused"))
    checks = {
        "apply": result["apply_vs_featurizer_then_mapper_rel"] <= CONV_APPLY_TOL,
        "one_block_fp64": result["one_block"]["vs_fp64_rel"] <= CONV_ONE_BLOCK_FP64_TOL,
        "width": result["feature_width"] == 8 * CIFAR_FILTERS,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"cifar_random_patch_fused failed {failed}")
    return 0


def write_synthetic_cifar(root):
    """The synthetic learnable CIFAR as CIFAR-10 binaries under ``root``:
    ``train.bin`` (50,000), ``test.bin`` (10,000), ``train_augment.bin``
    (the first 5,000 training images). Train and test share the 10
    prototypes (one draw of 60,000 images, split)."""
    rng = np.random.default_rng(CIFAR_SYNTH_SEED)
    n = CIFAR_TRAIN + CIFAR_TEST
    labels = rng.integers(0, CIFAR_CLASSES, size=n).astype(np.uint8)
    protos = rng.normal(size=(CIFAR_CLASSES, 32, 32, 3)) * 40 + 128
    images = np.clip(protos[labels] + rng.normal(size=(n, 32, 32, 3)) * 10, 0, 255).astype(np.uint8)
    records = np.concatenate([labels[:, None], images.transpose(0, 3, 1, 2).reshape(n, -1)], axis=1)
    paths = {"train": os.path.join(root, "train.bin"), "test": os.path.join(root, "test.bin"),
             "train_augment": os.path.join(root, "train_augment.bin")}
    records[:CIFAR_TRAIN].tofile(paths["train"])
    records[CIFAR_TRAIN:].tofile(paths["test"])
    records[:CIFAR_AUGMENT_TRAIN].tofile(paths["train_augment"])
    return paths


def phase_cifar_workloads(device) -> int:
    """Phase 25: the CLI's seven CIFAR workloads through ``run`` on
    synthetic learnable CIFAR read back through ``load_cifar``, then one
    through ``python -m keystone_tpu_torch``."""
    import torch

    from keystone_tpu_torch.pipelines.cifar import RandomCifarConfig, run
    from keystone_tpu_torch.workflow.executor import PipelineEnv

    _mnist_start()
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="keystone-cifar-")
    t0 = time.perf_counter()
    paths = write_synthetic_cifar(tmp.name)
    write_s = time.perf_counter() - t0
    results = {}
    for variant, flags, augmented in CIFAR_WORKLOADS:
        PipelineEnv.reset()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        config = RandomCifarConfig(train_location=paths["train_augment" if augmented else "train"],
                                   test_location=paths["test"], **flags)
        out, seconds = synced_s(lambda: run(config, variant=variant, device=device))
        results[variant] = {"seconds": seconds, "flags": flags, "peak_device_bytes": torch.cuda.max_memory_allocated(),
                            **{k: v for k, v in out.items() if k in ("train_error", "test_error", "num_augmented_train")}}
        del out
    PipelineEnv.reset()
    cli = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", "cifar-linear-pixels",
         "--train-location", paths["train"], "--test-location", paths["test"]],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
    )
    tmp.cleanup()
    if cli.returncode == 0:
        cli_line = json.loads(cli.stdout.strip().splitlines()[-1])
    else:
        cli_line = {"rc": cli.returncode, "stderr": cli.stderr[-2000:]}
    log("cifar_workloads", write_s=write_s, workloads=results, cli=cli_line,
        seconds=time.perf_counter() - t_phase, **_mnist_end("cifar_workloads"))
    checks = {f"{v}_error": r["test_error"] < CIFAR_ERROR_BOUND for v, r in results.items()}
    checks["fused_vs_block"] = abs(results["random_patch_fused"]["test_error"]
                                   - results["random_patch"]["test_error"]) <= CIFAR_FUSED_VS_BLOCK
    checks["augmented_rows"] = all(results[v]["num_augmented_train"] == 10 * CIFAR_AUGMENT_TRAIN
                                   for v in ("random_patch_augmented", "random_patch_kernel_augmented"))
    checks["cli"] = cli.returncode == 0 and abs(cli_line.get("test_error", 1.0)
                                                - results["linear_pixels"]["test_error"]) <= MNIST_ERROR_TOL
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"cifar_workloads failed {failed}")
    return 0


# VOC 2007 phases. voc: the JAX CLI's default SIFTFisherConfig, which is
# examples/images/voc_sift_fisher.sh's configuration (desc_dim 80, vocab
# 256, λ 0.5, 10⁶ PCA and 10⁶ GMM samples, scale_step 0, 256×256 resize,
# block 4,096; keystone_tpu/pipelines/voc.py:45-64), through run() on
# generated JPEGs: VOC 2007 is not in the repository. Images are 500×375
# (VOC's usual size) under VOCdevkit/VOC2007/JPEGImages/, each the sum of
# its 1–3 classes' oriented gratings (20 classes: 10 angles 18° apart × 2
# periods, 14 and 30 pixels; amplitude 60 shared out) plus N(0, 12²)
# noise, JPEG quality 85; unsourced, separable by design. Train and test
# are cut from VOC 2007's 5,011 / 4,952 to 2,048 / 1,024: the executor
# holds each node's output whole, and 2,048 images are 25.2 GB of
# descriptors and 15.7 GB after PCA. voc_cli: the CLI at the example
# script's flags on a 64-image tar (train = test), against run() on the
# same tar.
VOC_TRAIN, VOC_TEST, VOC_CLI_IMAGES = 2048, 1024, 64
# Cut 7: 1,024 train / 512 test images (51 per class); the
# configuration stays (10⁶ PCA and GMM samples still come from 24.6M
# descriptors).
VOC_TRAIN, VOC_TEST = VOC_TRAIN // 2, VOC_TEST // 2
# Cut 21: 512 train / 256 test images (25 per class; MAP read 0.973 at
# 1,024 against the 0.5 bound); the configuration stays (10⁶ PCA and GMM
# samples still come from 12.3M descriptors).
VOC_TRAIN, VOC_TEST = VOC_TRAIN // 2, VOC_TEST // 2
VOC_WIDTH, VOC_HEIGHT, VOC_CLASSES, VOC_SEED = 500, 375, 20, 7
VOC_PERIODS, VOC_AMPLITUDE, VOC_NOISE, VOC_QUALITY = (14.0, 30.0), 60.0, 12.0, 85
VOC_LABEL_COUNTS, VOC_LABEL_SHARES = (1, 2, 3), (0.5, 0.35, 0.15)
# Flags beyond the data paths: none for the main run (the JAX CLI's
# defaults), the example script's for the CLI run; main() adds the decode
# path (``use_native``) to both.
VOC_FLAGS: dict = {}
# voc_cli's PCA and GMM samples are cut from the defaults' 10⁶ to 10⁵
# each (the script's 660 s cap, ROADMAP "Tests": the second cut in its
# order): both runs of the phase take the same flags, so their MAPs still
# agree.
VOC_CLI_FLAGS = {"desc_dim": 80, "vocab_size": 256, "reg": 0.5,
                 "num_pca_samples": 100_000, "num_gmm_samples": 100_000}
VOC_RATE_CHUNK, VOC_GATE_IMAGES, VOC_FP64_CHUNK = 256, 8, 32
# The reference's widths at 256×256 with scale_step 0: descriptors per
# image (6,241 + 6,084 + 5,929 + 5,776) and Fisher features (2 · 80 · 256).
VOC_DESCRIPTORS_PER_IMAGE, VOC_FEATURE_WIDTH = 24_030, 40_960
VOC_MAP_BOUND, VOC_PEAK_BOUND = 0.5, 70e9
# SIFT on the card against the CPU: the reference's gate (VLFeatSuite.scala:47-52).
VOC_WITHIN_ONE = 0.995
# Fisher vectors against the same formula in float64 on the same PCA'd
# descriptors and GMM (relative Frobenius per image, the largest). Not
# 1e-5: fv2's numerator s2 − 2μ∘s1 + (μ∘μ − σ²)·s0 cancels by about
# μ²/σ² (PCA'd descriptors reach ~430, variances go down to ~1), so the
# fp32 formula — the JAX package's — loses digits: on the CPU, 4 images
# under a 256-Gaussian model fitted at these widths read 1.9e-5–3.3e-4
# for the port and 2.3e-5–1.8e-4 for the JAX package on the same inputs;
# an H100 read 9.3e-4 over 8 images. TF32 statistics would sit thousands
# of times above fp32's.
VOC_FISHER_FP64_TOL = 5e-3
# The fitted pipeline's test scores against the same fit in float64
# (features from the same descriptors, and the block solve): the Fisher
# vectors' error above, damped by the row normalizations and λ = 0.5; an
# H100 read 6.3e-5 (a CPU run at 48 images and 64 Gaussians 6.8e-7).
VOC_SCORES_FP64_TOL = 5e-4

_VOC_GEN: dict = {}


def _voc_gen_init(seed):
    """Per generator process: the classes' gratings as cos/sin pairs (a
    random phase is then two multiply-adds) and a bank of noise fields."""
    rows = np.arange(VOC_HEIGHT, dtype=np.float32)[:, None]
    cols = np.arange(VOC_WIDTH, dtype=np.float32)[None, :]
    cos, sin = [], []
    for c in range(VOC_CLASSES):
        angle, period = np.pi * (c % 10) / 10, VOC_PERIODS[c // 10]
        arg = (2 * np.pi / period) * (cols * np.cos(angle) + rows * np.sin(angle))
        cos.append(np.cos(arg))
        sin.append(np.sin(arg))
    bank = np.random.default_rng(seed).standard_normal(
        (8, VOC_HEIGHT + 32, VOC_WIDTH + 32, 3), dtype=np.float32) * VOC_NOISE
    _VOC_GEN.update(cos=np.stack(cos).astype(np.float32), sin=np.stack(sin).astype(np.float32), bank=bank)


def _voc_jpeg(args) -> bytes:
    import io

    from PIL import Image

    index, labels, seed = args
    rng = np.random.default_rng([seed, index])
    img = np.full((VOC_HEIGHT, VOC_WIDTH), 128.0, np.float32)
    for c in labels:
        phase = rng.uniform(0.0, 2.0 * np.pi)
        img += (VOC_AMPLITUDE / len(labels)) * (np.cos(phase) * _VOC_GEN["cos"][c]
                                                 - np.sin(phase) * _VOC_GEN["sin"][c])
    b, dr, dc = rng.integers(len(_VOC_GEN["bank"])), rng.integers(32), rng.integers(32)
    noisy = img[..., None] + _VOC_GEN["bank"][b, dr : dr + VOC_HEIGHT, dc : dc + VOC_WIDTH]
    buf = io.BytesIO()
    Image.fromarray(np.clip(noisy, 0, 255).astype(np.uint8), "RGB").save(buf, format="JPEG",
                                                                        quality=VOC_QUALITY)
    return buf.getvalue()


def write_voc_data(root):
    """Generate every image (train, test, the CLI's), in processes, and
    write ``voc_{train,test,cli}.tar`` and one label CSV in the loader's
    format under ``root``. Returns (paths, JPEG blobs, label lists)."""
    import io
    import multiprocessing
    import tarfile
    from concurrent.futures import ProcessPoolExecutor

    from keystone_tpu_torch.data.loaders.voc import DEFAULT_NAME_PREFIX

    total = VOC_TRAIN + VOC_TEST + VOC_CLI_IMAGES
    rng = np.random.default_rng(VOC_SEED)
    labels = [sorted(rng.choice(VOC_CLASSES, size=rng.choice(VOC_LABEL_COUNTS, p=VOC_LABEL_SHARES),
                                replace=False).tolist()) for _ in range(total)]
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                             mp_context=multiprocessing.get_context("spawn"),
                             initializer=_voc_gen_init, initargs=(VOC_SEED,)) as pool:
        blobs = list(pool.map(_voc_jpeg, [(i, ls, VOC_SEED) for i, ls in enumerate(labels)], chunksize=16))
    names = [f"{i:06d}.jpg" for i in range(total)]
    bounds = {"train": (0, VOC_TRAIN), "test": (VOC_TRAIN, VOC_TRAIN + VOC_TEST),
              "cli": (VOC_TRAIN + VOC_TEST, total)}
    paths = {}
    for split, (lo, hi) in bounds.items():
        paths[split] = os.path.join(root, f"voc_{split}.tar")
        with tarfile.open(paths[split], "w") as tar:
            for name, blob in zip(names[lo:hi], blobs[lo:hi]):
                info = tarfile.TarInfo(DEFAULT_NAME_PREFIX + name)
                info.size = len(blob)
                tar.addfile(info, io.BytesIO(blob))
    paths["labels"] = os.path.join(root, "voc_labels.csv")
    with open(paths["labels"], "w") as f:
        f.write("id,class,a,b,filename\n")
        for i, (name, labs) in enumerate(zip(names, labels)):
            f.writelines(f'{i},{c + 1},x,y,"{name}"\n' for c in labs)
    return paths, blobs, labels


def fp64_fisher_vectors(x, gmm):
    """The Fisher-vector formula (fisher.py's docstring) in float64 with
    plain PyTorch: PCA'd descriptors (N, n, D), the GMM's parameters
    upcast; posteriors thresholded at the model's threshold."""
    import math

    import torch

    x = x.double()
    means, variances, weights = (t.double() for t in (gmm.means, gmm.variances, gmm.weights))
    n_img, n, d = x.shape
    flat = x.reshape(-1, d)
    inv = 1.0 / variances  # (D, K)
    llh = (-0.5 * d * math.log(2 * math.pi) - 0.5 * torch.log(variances).sum(0) + torch.log(weights)
           - ((flat * flat) @ (0.5 * inv) - flat @ (means * inv) + 0.5 * (means * means * inv).sum(0)))
    q = torch.softmax(llh, dim=1)
    del llh
    q = torch.where(q > gmm.weight_threshold, q, torch.zeros((), dtype=q.dtype, device=q.device))
    q = (q / q.sum(1, keepdim=True).clamp_min(1e-30)).reshape(n_img, n, -1)
    s0 = q.mean(1)[:, None, :]
    s1 = torch.einsum("bnd,bnk->bdk", x, q) / n
    s2 = torch.einsum("bnd,bnk->bdk", x * x, q) / n
    fv1 = (s1 - means * s0) / (torch.sqrt(variances) * torch.sqrt(weights))
    fv2 = (s2 - 2.0 * means * s1 + (means * means - variances) * s0) / (variances * torch.sqrt(2.0 * weights))
    return torch.cat([fv1, fv2], dim=2)


def fp64_voc_features(gray, sift, components, gmm):
    """The pipeline's features in float64 from the images' SIFT
    descriptors (exact integers): PCA, Fisher vectors, vectorize, L2
    rows, signed Hellinger, L2 rows."""
    import torch

    out = []
    for start in range(0, gray.shape[0], VOC_FP64_CHUNK):
        x = sift.apply_arrays(gray[start : start + VOC_FP64_CHUNK]).double() @ components.double()
        f = fp64_fisher_vectors(x, gmm).reshape(x.shape[0], -1)
        f = f / f.norm(dim=1, keepdim=True)
        f = torch.sign(f) * torch.sqrt(f.abs())
        out.append(f / f.norm(dim=1, keepdim=True))
    return torch.cat(out)


def fp64_voc_scores(train_feats, train_labels, test_feats, config):
    """Test scores of the block fit (same centring, blocks, order and λ as
    ``BlockLeastSquaresEstimator``'s in-core fit, one epoch) in float64."""
    import torch

    from keystone_tpu_torch.parallel import linalg

    y = torch.full((train_feats.shape[0], VOC_CLASSES), -1.0, dtype=torch.float64, device=train_feats.device)
    for i, labs in enumerate(train_labels):
        y[i, labs] = 1.0
    mu_a, mu_b = train_feats.mean(0), y.mean(0)
    d = train_feats.shape[1]
    block = min(config.solver_block_size, d)
    pad = -d % block  # zero columns, inert, as the estimator pads
    xc = torch.nn.functional.pad(train_feats - mu_a, (0, pad))
    w = linalg.block_coordinate_descent(xc, y - mu_b, config.reg, 1, block)[:d]
    return (test_feats - mu_a) @ w + mu_b


def _trace_seconds(tr, label):
    return [t.seconds for t in tr.timings if t.label == label]


def _span_seconds(session, name):
    return [s.duration_s for s in session.find(name) if s.name == name]


def phase_voc(device, paths, blobs, labels) -> int:
    """Phase 26: the VOC SIFT + Fisher-vector workload through ``run()`` at
    the JAX CLI's default configuration; its split by node and span; the
    gates on SIFT, the Fisher vectors, the scores, MAP and the peak."""
    import torch

    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.evaluation.mean_average_precision import MeanAveragePrecisionEvaluator
    from keystone_tpu_torch.ops.images import FisherVector, GrayScaler, PixelScaler, SIFTExtractor
    from keystone_tpu_torch.ops.learning.pca import BatchPCATransformer
    from keystone_tpu_torch.pipelines.voc import SIFTFisherConfig, run
    from keystone_tpu_torch.workflow.tracing import trace

    _mnist_start()
    t_phase = time.perf_counter()
    config = SIFTFisherConfig(train_location=paths["train"], test_location=paths["test"],
                              label_path=paths["labels"], **VOC_FLAGS)
    with trace() as tr:
        out, run_s = synced_s(lambda: run(config, device=device))
    run_peak = torch.cuda.max_memory_allocated()
    session = tr.session
    fitted = out["pipeline"]
    sift = _fitted_member(fitted, SIFTExtractor)
    pca = _fitted_member(fitted, BatchPCATransformer)
    fv = _fitted_member(fitted, FisherVector)
    em = session.find("gmm:em")[0]
    sift_label = "Fused[PixelScaler+GrayScaler+SIFTExtractor]"
    pca_picked = [t.label for t in tr.timings if t.label.endswith("ColumnPCAEstimator")]
    samplers = _trace_seconds(tr, "ColumnSampler")
    fisher_s = _trace_seconds(tr, "FisherVector")[0]
    result = {
        "config": {k: getattr(config, k) for k in ("desc_dim", "vocab_size", "reg", "scale_step",
                                                   "num_pca_samples", "num_gmm_samples", "image_size",
                                                   "solver_block_size")},
        "train_images": VOC_TRAIN, "test_images": VOC_TEST,
        "descriptors_per_image": sum(sift.grid_counts(*config.image_size)),
        "feature_width": int(fv.gmm.dim * 2 * fv.gmm.k),
        "run_s": run_s, "ingest_s": sum(_span_seconds(session, "voc:load")),
        "end_to_end_fit_s": _span_seconds(session, "voc:fit")[0],
        "apply_s": _span_seconds(session, "voc:apply")[0],
        "node_optimization_s": _span_seconds(session, "optimize:batch:node-level-optimization"),
        "sift_train_s": _trace_seconds(tr, sift_label)[0],
        "pca_sample_draw_s": samplers[0], "gmm_sample_draw_s": samplers[1],
        "pca_estimator_picked": pca_picked, "pca_fit_s": _trace_seconds(tr, pca_picked[0])[0],
        "pca_project_train_s": _trace_seconds(tr, "BatchPCATransformer")[0],
        "gmm_fit_s": _trace_seconds(tr, "GMMFisherVectorEstimator")[0],
        "kmeanspp_seed_host_s": _span_seconds(session, "kmeans:seed")[0],
        "lloyd_s": _span_seconds(session, "kmeans:lloyd")[0],
        "em_s": em.duration_s, "em_iterations": em.attributes["iterations"],
        "em_updates": em.attributes["updates"],
        "fisher_train_s": fisher_s, "fisher_images_per_s": VOC_TRAIN / fisher_s,
        "block_solver_fit_s": [t.seconds for t in tr.timings if t.label.startswith("StreamFit[Block")
                               or t.label == "BlockLeastSquaresEstimator"][0],
        "run_peak_device_bytes": run_peak,
        "test_map": out["test_map"], "per_class_ap": [float(a) for a in out["per_class_ap"]],
    }
    del tr, session

    # SIFT alone on a warm 256-image chunk, by CUDA events.
    t0 = time.perf_counter()
    images = decoded_images(blobs[: VOC_TRAIN + VOC_TEST], config.image_size, config.use_native)
    train, test = images[:VOC_TRAIN], images[VOC_TRAIN:]
    del images
    result["gate_decode_s"] = time.perf_counter() - t0

    def gray(x):
        return GrayScaler().apply_arrays(PixelScaler().apply_arrays(x.to(device)))[..., 0]

    chunk = gray(train[:VOC_RATE_CHUNK])
    sift_ms = cuda_ms(lambda: sift.apply_arrays(chunk), 3)
    result["sift_chunk_ms"] = sift_ms
    result["sift_images_per_s"] = VOC_RATE_CHUNK / (sift_ms / 1e3)
    result["sift_descriptors_per_s"] = result["sift_images_per_s"] * result["descriptors_per_image"]

    # SIFT on the card against the CPU; descriptors and Fisher vectors
    # under PyTorch's TF32 switches; Fisher vectors against float64.
    g8 = chunk[:VOC_GATE_IMAGES]
    del chunk
    desc = sift.apply_arrays(g8)
    diff = (desc.cpu() - sift.apply_arrays(g8.cpu())).abs()
    result["sift_card_vs_cpu"] = {"within_one": float((diff <= 1).double().mean()),
                                  "max_abs": float(diff.max()), "equal": float((diff == 0).double().mean())}
    pcad = pca.apply_batch(ArrayDataset(desc)).data
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    switched = {}
    try:
        for flag in (False, True):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = flag
            d = sift.apply_arrays(g8)
            switched[flag] = (d, fv.apply_arrays(pca.apply_batch(ArrayDataset(d)).data))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    result["tf32_descriptors_bitwise_equal"] = bool(torch.equal(switched[False][0], switched[True][0]))
    result["tf32_fisher_bitwise_equal"] = bool(torch.equal(switched[False][1], switched[True][1]))
    f32 = fv.apply_arrays(pcad)
    f64 = fp64_fisher_vectors(pcad, fv.gmm)
    per_image = ((f32.double() - f64).flatten(1).norm(dim=1) / f64.flatten(1).norm(dim=1)).cpu()
    result["fisher_vs_fp64_rel_max"] = float(per_image.max())
    del desc, pcad, switched, f32, f64

    # The fitted pipeline's test scores against the same fit in float64.
    scores = fitted.apply_batch(ArrayDataset(test, device=device)).data
    actual = [labels[VOC_TRAIN + i] for i in range(VOC_TEST)]
    result["rescored_map"] = float(np.mean(MeanAveragePrecisionEvaluator(VOC_CLASSES).evaluate(scores, actual)))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    feats_train = fp64_voc_features(gray(train), sift, pca.components, fv.gmm)
    feats_test = fp64_voc_features(gray(test), sift, pca.components, fv.gmm)
    s64 = fp64_voc_scores(feats_train, labels[:VOC_TRAIN], feats_test, config)
    result["scores_vs_fp64_rel"] = rel_err(scores, s64)
    result["fp64_reference_s"] = time.perf_counter() - t0
    del scores, s64, feats_train, feats_test, train, test, fitted, out
    torch.cuda.empty_cache()
    result["seconds"] = time.perf_counter() - t_phase
    log("voc", **result, **_mnist_end("voc"))
    checks = {
        "sift_card_vs_cpu": result["sift_card_vs_cpu"]["within_one"] >= VOC_WITHIN_ONE
        and result["sift_card_vs_cpu"]["max_abs"] <= 1.0,
        "tf32": result["tf32_descriptors_bitwise_equal"] and result["tf32_fisher_bitwise_equal"],
        "fisher_fp64": result["fisher_vs_fp64_rel_max"] <= VOC_FISHER_FP64_TOL,
        "scores_fp64": result["scores_vs_fp64_rel"] <= VOC_SCORES_FP64_TOL,
        "map": result["test_map"] >= VOC_MAP_BOUND,
        "rescored_map": result["rescored_map"] == result["test_map"],
        "peak": result["run_peak_device_bytes"] < VOC_PEAK_BOUND,
        "widths": result["descriptors_per_image"] == VOC_DESCRIPTORS_PER_IMAGE
        and result["feature_width"] == VOC_FEATURE_WIDTH,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"voc failed {failed}")
    return 0


def phase_voc_cli(device, paths) -> int:
    """Phase 27: ``python -m keystone_tpu_torch voc-sift-fisher`` at the
    example script's flags on the 64-image tar, in a subprocess beside
    ``run()`` on the same tar in this process: the same MAP."""
    from keystone_tpu_torch.pipelines.voc import SIFTFisherConfig, run

    _mnist_start()
    t_phase = time.perf_counter()
    cmd = [sys.executable, "-m", "keystone_tpu_torch", "voc-sift-fisher",
           "--train-location", paths["cli"], "--test-location", paths["cli"],
           "--label-path", paths["labels"]]
    for name, value in VOC_CLI_FLAGS.items():
        text = "x".join(map(str, value)) if isinstance(value, tuple) else str(value)
        cmd += ["--" + name.replace("_", "-"), text]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    try:
        config = SIFTFisherConfig(train_location=paths["cli"], test_location=paths["cli"],
                                  label_path=paths["labels"], **VOC_CLI_FLAGS)
        out, run_s = synced_s(lambda: run(config, device=device))
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode == 0:
        cli_line = json.loads(stdout.strip().splitlines()[-1])
    else:
        cli_line = {"rc": proc.returncode, "stderr": stderr[-2000:]}
    log("voc_cli", images=VOC_CLI_IMAGES, flags=VOC_CLI_FLAGS, run_s=run_s, run_test_map=out["test_map"],
        cli=cli_line, seconds=time.perf_counter() - t_phase, **_mnist_end("voc_cli"))
    if proc.returncode != 0 or cli_line.get("test_map") != out["test_map"]:
        raise AssertionError(f"voc_cli: the CLI's MAP {cli_line.get('test_map')} is not run()'s {out['test_map']}")
    return 0


# Native host kernels and the ImageNet flagship (phases 28–31).
# Whether the native JPEG decode can be built here is probed once, at the
# start of main(), by asking the compiler for libjpeg's header: where it
# is missing the VOC and ImageNet phases pass use_native=False (PIL)
# explicitly and the script prints "native_decode: unavailable (no
# jpeglib.h)"; nothing falls back on its own.
NATIVE_SIFT_IMAGES, NATIVE_SIFT_RATE_IMAGES, NATIVE_WITHIN_ONE = 8, 64, 0.995
NATIVE_FISHER_IMAGES, NATIVE_FISHER_TOL = 8, 1e-3
NATIVE_GMM_CENTRES, NATIVE_GMM_ROWS = 16, 40_000
NATIVE_DECODE_MEAN_ABS = 1.5  # at the source size (tests/native/test_native_kernels.py)

# imagenet: ImageNetSiftLcsFVConfig's defaults, which are the reference's
# (ImageNetSiftLcsFV.scala:148-169; keystone_tpu/pipelines/imagenet.py:51-79):
# λ 6e-5, mixture weight 0.25, desc_dim 64, vocab 16, SIFT scale_step 1,
# LCS stride 4 / border 16 / patch 6, 10⁷ PCA and 10⁷ GMM samples, 256×256,
# block 4,096, 1,000 classes, top-5. Every width is the reference's (13,165
# SIFT descriptors of 128 and 3,136 LCS descriptors of 96 per image,
# 2 · 2·64·16 = 4,096 features, 1,000 classes). ImageNet is not in the
# repository: the images are generated JPEGs at ImageNet's usual 500×375
# in its synset/image layout with a "synset label" map, each its class's
# template — a grating at one of 20 angles (9° apart) and 5 periods, in
# one of 10 tints — at a random phase plus N(0, 12²) noise, JPEG quality
# 85; unsourced and separable by design. Train and test are cut from
# 1.28 M / 50,000 to 2,048 / 1,000 because the executor holds each node's
# output whole (PERF.md §4 lists the prediction of the peak).
# imagenet_cli: the CLI at the defaults on a 64-image tar of 16 classes
# (train = test) beside run() on it. imagenet_native: run_native_resolution
# on the first 256 of 512 JPEGs at ImageNet's common sizes (cut from all
# of them for the time cap, cuts 1 and 14; its gate and the streaming
# phase 33 still read all 512, cut 27 below), granularity 32, with the PCA
# and GMM samples cut to 10⁶ each (the time budget).
IMAGENET_TRAIN, IMAGENET_TEST, IMAGENET_CLI_IMAGES, IMAGENET_NATIVE_IMAGES = 2048, 1000, 64, 1024
# Cut 15 for the time cap: 1,024 train / 500 test images (half of each);
# the configuration, the image size and the gates stay.
IMAGENET_TRAIN, IMAGENET_TEST = IMAGENET_TRAIN // 2, IMAGENET_TEST // 2
# Cut 14: 256 (cut 1 took it to 512).
IMAGENET_NATIVE_RUN_IMAGES = 256
# Cut 27: the native-resolution set at 512 JPEGs (was 1,024), 102–103 at
# each of the five sizes. Its loads took 7.8 s (phase 31's gate) and
# 12.5 s (phase 33) of host decode and bucketing on an H100's host
# (PERF.md §4); the sizes, the granularity, the buckets and every gate stay.
IMAGENET_NATIVE_IMAGES = 512
IMAGENET_CLASSES, IMAGENET_CLI_CLASSES, IMAGENET_SEED = 1000, 16, 13
IMAGENET_SIZE = (500, 375)  # (width, height), as ImageNet's sizes are quoted
IMAGENET_NATIVE_SIZES = ((500, 375), (375, 500), (500, 333), (333, 500), (400, 300))
IMAGENET_PERIODS, IMAGENET_AMPLITUDE, IMAGENET_NOISE, IMAGENET_QUALITY = (6.0, 9.0, 13.0, 19.0, 27.0), 60.0, 12.0, 85
IMAGENET_TINTS = ((0, 0, 0), (40, -20, -20), (-20, 40, -20), (-20, -20, 40), (30, 30, -40),
                  (-40, 30, 30), (30, -40, 30), (20, 20, 20), (-30, -30, -30), (45, 0, -45))
IMAGENET_NATIVE_SAMPLES = 10**6
IMAGENET_RATE_CHUNK, IMAGENET_GATE_IMAGES, IMAGENET_TRAIN_SCORED = 256, 8, 256
IMAGENET_SIFT_PER_IMAGE, IMAGENET_LCS_PER_IMAGE, IMAGENET_LCS_WIDTH = 13_165, 3_136, 96
IMAGENET_FEATURE_WIDTH, IMAGENET_PEAK_BOUND = 4_096, 70e9
# The float64 gate: the weighted solve of the fit's own features and
# labels (the dense per-class formula, float64 on the card) for the
# classes of the first IMAGENET_FP64_CLASSES test images, their test
# scores against the pipeline's (fp32 Woodbury with its correction step).
# An H100 read 3.3e-6 (a CPU rehearsal at 48 images 7.7e-6); the bound
# was 5e-4 before that first reading.
IMAGENET_FP64_CLASSES = 48
IMAGENET_SCORES_FP64_TOL = 1e-4
# LCS on the card against the CPU: means relative to the largest, stds
# absolute on the 0–255 scale (tests/test_torch_imagenet.py says why).
IMAGENET_LCS_MEAN_TOL, IMAGENET_LCS_STD_ABS = 1e-5, 0.05

_IMAGENET_GEN: dict = {}


def _imagenet_gen_init(seed):
    """Per generator process: a bank of noise fields."""
    side = max(max(s) for s in IMAGENET_NATIVE_SIZES) + 32
    _IMAGENET_GEN["bank"] = np.random.default_rng(seed).standard_normal(
        (8, side, side, 3), dtype=np.float32) * IMAGENET_NOISE


def _imagenet_jpeg(args) -> bytes:
    """One image of class ``cls`` at ``width`` × ``height``: its template
    grating at a random phase, tinted, plus noise."""
    import io

    from PIL import Image

    index, cls, width, height, seed = args
    rng = np.random.default_rng([seed, index])
    angle = np.pi * (cls % 20) / 20
    period = IMAGENET_PERIODS[(cls // 20) % 5]
    rows = np.arange(height, dtype=np.float32)[:, None]
    cols = np.arange(width, dtype=np.float32)[None, :]
    arg = (2 * np.pi / period) * (cols * np.cos(angle) + rows * np.sin(angle)) + rng.uniform(0, 2 * np.pi)
    img = 128.0 + IMAGENET_AMPLITUDE * np.cos(arg)
    b, dr, dc = rng.integers(len(_IMAGENET_GEN["bank"])), rng.integers(32), rng.integers(32)
    noisy = (img[..., None] + np.asarray(IMAGENET_TINTS[cls // 100], np.float32)
             + _IMAGENET_GEN["bank"][b, dr : dr + height, dc : dc + width])
    buf = io.BytesIO()
    Image.fromarray(np.clip(noisy, 0, 255).astype(np.uint8), "RGB").save(
        buf, format="JPEG", quality=IMAGENET_QUALITY)
    return buf.getvalue()


def write_imagenet_data(root):
    """Generate every ImageNet-layout image (train, test, the CLI's, the
    native-resolution set), in processes; write ``imagenet_{split}.tar``
    and the ``synset label`` map under ``root``. Returns (paths, blobs by
    split, labels by split)."""
    import io
    import multiprocessing
    import tarfile
    from concurrent.futures import ProcessPoolExecutor

    splits = {
        "train": [(i % IMAGENET_CLASSES, IMAGENET_SIZE) for i in range(IMAGENET_TRAIN)],
        "test": [(i % IMAGENET_CLASSES, IMAGENET_SIZE) for i in range(IMAGENET_TEST)],
        "cli": [(i % IMAGENET_CLI_CLASSES, IMAGENET_SIZE) for i in range(IMAGENET_CLI_IMAGES)],
        "native": [(i % IMAGENET_CLASSES, IMAGENET_NATIVE_SIZES[i % len(IMAGENET_NATIVE_SIZES)])
                   for i in range(IMAGENET_NATIVE_IMAGES)],
    }
    jobs, index = [], 0
    for split, items in splits.items():
        for cls, (w, h) in items:
            jobs.append((index, cls, w, h, IMAGENET_SEED))
            index += 1
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                             mp_context=multiprocessing.get_context("spawn"),
                             initializer=_imagenet_gen_init, initargs=(IMAGENET_SEED,)) as pool:
        all_blobs = list(pool.map(_imagenet_jpeg, jobs, chunksize=16))
    paths, blobs, labels, start = {}, {}, {}, 0
    for split, items in splits.items():
        blobs[split] = all_blobs[start : start + len(items)]
        labels[split] = [cls for cls, _ in items]
        paths[split] = os.path.join(root, f"imagenet_{split}.tar")
        with tarfile.open(paths[split], "w") as tar:
            for i, (blob, cls) in enumerate(zip(blobs[split], labels[split])):
                info = tarfile.TarInfo(f"n{cls:08d}/{split}_{i:06d}.JPEG")
                info.size = len(blob)
                tar.addfile(info, io.BytesIO(blob))
        start += len(items)
    # The materialized native-resolution run reads the first
    # IMAGENET_NATIVE_RUN_IMAGES of the native set.
    paths["native_run"] = os.path.join(root, "imagenet_native_run.tar")
    with tarfile.open(paths["native"]) as src, tarfile.open(paths["native_run"], "w") as tar:
        for member in src.getmembers()[:IMAGENET_NATIVE_RUN_IMAGES]:
            tar.addfile(member, src.extractfile(member))
    paths["labels"] = os.path.join(root, "imagenet_labels.txt")
    with open(paths["labels"], "w") as f:
        f.writelines(f"n{c:08d} {c}\n" for c in range(IMAGENET_CLASSES))
    return paths, blobs, labels


def decoded_images(blobs, size, use_native):
    """(N, X, Y, 3) float32 host tensor of the blobs as the loader decodes
    and resizes them: the native libjpeg kernel unless ``use_native`` is
    False, else PIL's ``load_image`` + ``_resize_image`` on threads."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from keystone_tpu_torch.data.loaders.archive import _resize_image, native_decode_batch
    from keystone_tpu_torch.utils.image import load_image

    if use_native is not False:
        images, ok = native_decode_batch(list(blobs), tuple(size))
        if not ok.all():
            raise AssertionError(f"native decode failed on {int((~ok).sum())} generated JPEGs")
        return torch.from_numpy(images)
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        images = list(pool.map(lambda b: _resize_image(load_image(b), tuple(size)).astype(np.float32), blobs))
    return torch.from_numpy(np.stack(images))


def host_cpu() -> str:
    """The host CPU's model name (lscpu), and its core count."""
    out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=60).stdout
    model = next((ln.split(":", 1)[1].strip() for ln in out.splitlines() if ln.startswith("Model name")), "")
    return f"{model or 'unknown'} ({os.cpu_count()} logical CPUs)"


def phase_native_host(device, voc_blobs, decode_available: bool) -> int:
    """Phase 28: build the native host library from the port's sources
    and hold each host kernel against its counterpart in the port, to the
    JAX tests' bounds (tests/native/test_native_kernels.py); time
    ``ks_dsift`` on the host against the card SIFT, and the native decode
    of the VOC tar's JPEGs against PIL's."""
    import torch

    from keystone_tpu_torch import native
    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.images.external import NativeFisherVector, NativeSIFTExtractor, native_gmm_fit
    from keystone_tpu_torch.ops.images.fisher import FisherVector
    from keystone_tpu_torch.ops.images.sift import SIFTExtractor
    from keystone_tpu_torch.ops.learning.gmm import GaussianMixtureModel

    _mnist_start()
    t_phase = time.perf_counter()
    result = {"host_cpu": host_cpu(), "jpeglib_h": decode_available, "openmp": native.openmp_requested()}
    native.load("kernels")
    result["build_kernels_s"] = native.build_seconds["kernels"]
    result["library"] = os.path.relpath(native.loaded_path("kernels"), ROOT)

    # ks_dsift against the card SIFT at 256×256, scale_step 1.
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(21)
    imgs = np.stack([gaussian_filter(rng.random((256, 256)), 1.5)
                     for _ in range(NATIVE_SIFT_RATE_IMAGES)]).astype(np.float32)
    host_sift, card_sift = NativeSIFTExtractor(scale_step=1), SIFTExtractor(scale_step=1)
    t0 = time.perf_counter()
    host_desc = host_sift._extract(imgs)
    result["dsift_host_s"] = time.perf_counter() - t0
    result["dsift_host_images_per_s"] = NATIVE_SIFT_RATE_IMAGES / result["dsift_host_s"]
    card_in = torch.from_numpy(imgs).to(device)
    card_ms = cuda_ms(lambda: card_sift.apply_arrays(card_in), 3)
    result["sift_card_images_per_s"] = NATIVE_SIFT_RATE_IMAGES / (card_ms / 1e3)
    card_desc = card_sift.apply_arrays(card_in[:NATIVE_SIFT_IMAGES]).cpu().numpy()
    diff = np.abs(host_desc[:NATIVE_SIFT_IMAGES] - card_desc)
    result["dsift_vs_card"] = {"within_one": float((diff <= 1).mean()), "equal": float((diff == 0).mean()),
                               "max_abs": float(diff.max())}
    del card_in

    # ks_fisher_encode against the port's FisherVector on the card.
    d, k = 64, 16
    gmm = GaussianMixtureModel(rng.normal(size=(d, k)) * 30, rng.uniform(200, 600, size=(d, k)),
                               np.full(k, 1.0 / k), device=device)
    x = (rng.normal(size=(NATIVE_FISHER_IMAGES, IMAGENET_SIFT_PER_IMAGE, d)) * 30).astype(np.float32)
    t0 = time.perf_counter()
    host_fv = NativeFisherVector(gmm).apply_batch(ArrayDataset(x, device="cpu")).data.numpy()
    result["fisher_host_s"] = time.perf_counter() - t0
    card_fv = FisherVector(gmm).apply_arrays(torch.from_numpy(x).to(device)).cpu().numpy()
    excess = np.abs(host_fv - card_fv) - (NATIVE_FISHER_TOL + NATIVE_FISHER_TOL * np.abs(card_fv))
    result["fisher_vs_card_max_abs"] = float(np.abs(host_fv - card_fv).max())
    result["fisher_within_rtol_atol"] = bool((excess <= 0).all())

    # ks_gmm_fit recovers planted clusters; its weights sum to 1.
    centres = rng.normal(size=(NATIVE_GMM_CENTRES, 8)) * 10
    pts = (centres[rng.integers(0, NATIVE_GMM_CENTRES, NATIVE_GMM_ROWS)]
           + 0.3 * rng.normal(size=(NATIVE_GMM_ROWS, 8))).astype(np.float32)
    t0 = time.perf_counter()
    fit = native_gmm_fit(pts, NATIVE_GMM_CENTRES, seed=0, device="cpu")
    result["gmm_host_s"] = time.perf_counter() - t0
    means = fit.means.numpy().T
    result["gmm_worst_centre_miss"] = float(max(np.linalg.norm(means - c, axis=1).min() for c in centres))
    result["gmm_weight_sum"] = float(fit.weights.sum())

    # The native decode against PIL, and its time over the VOC JPEGs.
    if decode_available:
        from keystone_tpu_torch.data.loaders.archive import native_decode_batch
        from keystone_tpu_torch.utils.image import load_image

        sample = [np.asarray(load_image(b), np.float32) for b in voc_blobs[:8]]
        decoded, ok = native_decode_batch(voc_blobs[:8], (VOC_HEIGHT, VOC_WIDTH))
        result["decode_vs_pil_mean_abs"] = float(max(np.abs(a - b).mean() for a, b in zip(decoded, sample)))
        t0 = time.perf_counter()
        _, ok = native_decode_batch(voc_blobs, (256, 256))
        result["decode_voc_s"] = time.perf_counter() - t0
        result["decode_voc_images"] = int(ok.sum())
        result["decode_build_s"] = native.build_seconds.get("decode", 0.0)
    else:
        print("native_decode: unavailable (no jpeglib.h)", flush=True)
        result["decode"] = "unavailable (no jpeglib.h)"
    result["seconds"] = time.perf_counter() - t_phase
    log("native_host", **result, **_mnist_end("native_host"))
    checks = {
        "dsift": result["dsift_vs_card"]["within_one"] >= NATIVE_WITHIN_ONE,
        "fisher": result["fisher_within_rtol_atol"],
        "gmm": result["gmm_worst_centre_miss"] < 0.5 and abs(result["gmm_weight_sum"] - 1.0) <= 1e-4,
        "library_in_port": result["library"].startswith(os.path.join("keystone_tpu_torch", "native", "build")),
    }
    if decode_available:
        checks["decode"] = (result["decode_vs_pil_mean_abs"] < NATIVE_DECODE_MEAN_ABS
                            and result["decode_voc_images"] == len(voc_blobs))
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"native_host failed {failed}")
    return 0


def fp64_weighted_scores(x, y_labels, x_test, classes, config):
    """Test scores of the mixture-weighted solve (one block, one pass:
    ``BlockWeightedLeastSquaresEstimator`` at d = block) for ``classes``,
    in float64 by the dense per-class formula with plain PyTorch."""
    import torch

    x = x.double()
    n, d = x.shape
    mw, reg = config.mixture_weight, config.reg
    labels = torch.as_tensor(y_labels, device=x.device)
    counts = torch.bincount(labels, minlength=config.num_classes).double()
    jlm = torch.where(counts > 0, 2 * mw + 2 * (1 - mw) * counts / n - 1, torch.full_like(counts, -1.0))
    y = torch.full((n, config.num_classes), -1.0, dtype=torch.float64, device=x.device)
    y[torch.arange(n, device=x.device), labels] = 1.0
    resid = y - jlm
    pop_mean = x.mean(0)
    pop_cov = x.T @ x / n - torch.outer(pop_mean, pop_mean)
    pop_xtr = x.T @ resid / n
    eye = torch.eye(d, dtype=torch.float64, device=x.device)
    out = []
    for c in classes:
        rows = labels == c
        win, r_c = x[rows], resid[rows, c]
        n_c = win.shape[0]
        class_mean = win.mean(0)
        class_cov = win.T @ win / n_c - torch.outer(class_mean, class_mean)
        delta = class_mean - pop_mean
        joint_mean = mw * class_mean + (1 - mw) * pop_mean
        mean_mix = (1 - mw) * resid[:, c].mean() + mw * r_c.mean()
        rhs = (1 - mw) * pop_xtr[:, c] + mw * (win.T @ r_c) / n_c - joint_mean * mean_mix
        lhs = (1 - mw) * pop_cov + mw * class_cov + mw * (1 - mw) * torch.outer(delta, delta) + reg * eye
        w = torch.linalg.solve(lhs, rhs)
        out.append(x_test.double() @ w + (jlm[c] - joint_mean @ w))
    return torch.stack(out, dim=1)


class _Capture:
    """Keeps the weighted estimator's inputs and the fitted mapper's test
    inputs and outputs of one ``run()`` (references only: the script's
    float64 gate reads the features the pipeline itself computed)."""

    def __init__(self, test_rows):
        self.test_rows = test_rows
        self.seen = {}

    def __enter__(self):
        from keystone_tpu_torch.ops.learning.block import BlockLinearMapper
        from keystone_tpu_torch.ops.learning.weighted import BlockWeightedLeastSquaresEstimator

        self._fit, self._apply = BlockWeightedLeastSquaresEstimator.fit, BlockLinearMapper.apply_arrays
        seen, test_rows, fit, apply = self.seen, self.test_rows, self._fit, self._apply

        def capture_fit(est, data, labels):
            seen["train_x"], seen["train_y"] = data, labels
            return fit(est, data, labels)

        def capture_apply(mapper, x):
            out = apply(mapper, x)
            if x.shape[0] == test_rows:
                seen["test_x"], seen["test_scores"] = x, out
            return out

        BlockWeightedLeastSquaresEstimator.fit, BlockLinearMapper.apply_arrays = capture_fit, capture_apply
        return self

    def __exit__(self, *exc):
        from keystone_tpu_torch.ops.learning.block import BlockLinearMapper
        from keystone_tpu_torch.ops.learning.weighted import BlockWeightedLeastSquaresEstimator

        BlockWeightedLeastSquaresEstimator.fit, BlockLinearMapper.apply_arrays = self._fit, self._apply


def _by_width(members, width):
    found = [m for m in members if m.components.shape[0] == width]
    if len(found) != 1:
        raise AssertionError(f"expected one PCA of width {width}, found {len(found)}")
    return found[0]


def _all_members(fitted, cls):
    return [m for op in fitted.graph.operators.values() for m in getattr(op, "members", (op,))
            if isinstance(m, cls)]


def phase_imagenet(device, paths, blobs, labels, use_native) -> int:
    """Phase 29: the ImageNet SIFT + LCS + Fisher-vector flagship through
    ``run()`` at the reference configuration; its split by node and span;
    the gates on the scores (float64), LCS card vs CPU, the TF32 switches,
    the widths and the peak."""
    import torch

    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.images import GrayScaler, LCSExtractor, PixelScaler, SIFTExtractor
    from keystone_tpu_torch.ops.images.fisher import FisherVector
    from keystone_tpu_torch.ops.learning.block import BlockLinearMapper
    from keystone_tpu_torch.ops.learning.pca import BatchPCATransformer
    from keystone_tpu_torch.ops.stats.core import SignedHellingerMapper
    from keystone_tpu_torch.ops.util.labels import TopKClassifier
    from keystone_tpu_torch.pipelines.imagenet import ImageNetSiftLcsFVConfig, run, top_k_err_percent
    from keystone_tpu_torch.workflow.tracing import trace

    _mnist_start()
    t_phase = time.perf_counter()
    config = ImageNetSiftLcsFVConfig(train_location=paths["train"], test_location=paths["test"],
                                     label_path=paths["labels"], use_native=use_native)
    with trace() as tr, _Capture(IMAGENET_TEST) as cap:
        out, run_s = synced_s(lambda: run(config, device=device))
    run_peak = torch.cuda.max_memory_allocated()
    session = tr.session
    fitted = out["pipeline"]
    sift, lcs = _fitted_member(fitted, SIFTExtractor), _fitted_member(fitted, LCSExtractor)
    mapper = _fitted_member(fitted, BlockLinearMapper)
    pcas = _all_members(fitted, BatchPCATransformer)
    sift_pca, lcs_pca = _by_width(pcas, 128), _by_width(pcas, IMAGENET_LCS_WIDTH)
    weighted_span = session.find("weighted:bcd")[0]
    em = session.find("gmm:em")
    lcs_keypoints = len(lcs._grid(*config.image_size)[0]) * len(lcs._grid(*config.image_size)[1])
    sift_label = "Fused[PixelScaler+GrayScaler+SIFTExtractor+SignedHellingerMapper]"
    result = {
        "config": {k: getattr(config, k) for k in (
            "reg", "mixture_weight", "desc_dim", "vocab_size", "sift_scale_step", "lcs_stride",
            "lcs_border", "lcs_patch", "num_pca_samples", "num_gmm_samples", "image_size",
            "solver_block_size", "num_classes", "use_native")},
        "train_images": IMAGENET_TRAIN, "test_images": IMAGENET_TEST,
        "sift_descriptors_per_image": sum(sift.grid_counts(*config.image_size)),
        "lcs_descriptors_per_image": lcs_keypoints,
        "feature_width": int(mapper.weights.shape[0]), "classes": int(mapper.weights.shape[1]),
        "run_s": run_s, "ingest_s": sum(_span_seconds(session, "imagenet:load")),
        "end_to_end_fit_s": _span_seconds(session, "imagenet:fit")[0],
        "apply_s": _span_seconds(session, "imagenet:apply")[0],
        "node_optimization_s": _span_seconds(session, "optimize:batch:node-level-optimization"),
        "sift_train_s": _trace_seconds(tr, sift_label)[:1],
        "lcs_train_s": _trace_seconds(tr, "LCSExtractor")[:1],
        "sample_draws_s": _trace_seconds(tr, "ColumnSampler"),
        "pca_picked": [t.label for t in tr.timings if t.label.endswith("ColumnPCAEstimator")],
        "pca_fit_s": [t.seconds for t in tr.timings if t.label.endswith("ColumnPCAEstimator")],
        "gmm_fit_s": _trace_seconds(tr, "GMMFisherVectorEstimator"),
        "kmeanspp_seed_host_s": _span_seconds(session, "kmeans:seed"),
        "kmeanspp_rows": [s.attributes["rows"] for s in session.find("kmeans:seed")],
        "lloyd_s": _span_seconds(session, "kmeans:lloyd"),
        "em_s": [s.duration_s for s in em], "em_iterations": [s.attributes["iterations"] for s in em],
        "fisher_s": _trace_seconds(tr, "FisherVector")[:2],
        "weighted_solve_s": weighted_span.duration_s, "weighted_path": weighted_span.attributes["path"],
        "weighted_max_class_rows": weighted_span.attributes["max_class_rows"],
        "weighted_fit_node_s": _trace_seconds(tr, "BlockWeightedLeastSquaresEstimator"),
        "run_peak_device_bytes": run_peak,
        "test_top5_error_percent": out["test_error_percent"],
    }
    del tr, session

    # The float64 gate on the fit's own features.
    train_x = cap.seen["train_x"].data[: IMAGENET_TRAIN].float()
    train_labels = torch.argmax(cap.seen["train_y"].data[: IMAGENET_TRAIN], dim=1)
    test_x, test_scores = cap.seen["test_x"], cap.seen["test_scores"]
    rescored = TopKClassifier(5).apply_arrays(test_scores).cpu().numpy()
    result["rescored_predictions_equal"] = bool(np.array_equal(rescored, out["test_predictions"]))
    classes = sorted(set(labels["test"][:IMAGENET_FP64_CLASSES]))
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    s64 = fp64_weighted_scores(train_x, train_labels, test_x, classes, config)
    result["fp64_reference_s"] = time.perf_counter() - t0
    result["scores_vs_fp64_rel"] = rel_err(test_scores[:, classes].double(), s64)
    result["fp64_classes"] = len(classes)
    del cap, train_x, test_x, test_scores, s64

    # SIFT and LCS rates on a warm 256-image chunk; the gates on 8 images.
    t0 = time.perf_counter()
    train = decoded_images(blobs["train"][:IMAGENET_TRAIN_SCORED], config.image_size, use_native)
    result["gate_decode_s"] = time.perf_counter() - t0
    chunk = train[:IMAGENET_RATE_CHUNK].to(device)
    gray = GrayScaler().apply_arrays(PixelScaler().apply_arrays(chunk))
    hell = SignedHellingerMapper()
    sift_ms = cuda_ms(lambda: hell.apply_arrays(sift.apply_arrays(gray)), 3)
    lcs_ms = cuda_ms(lambda: lcs.apply_arrays(chunk), 3)
    result["sift_chunk_ms"], result["lcs_chunk_ms"] = sift_ms, lcs_ms
    result["sift_images_per_s"] = IMAGENET_RATE_CHUNK / (sift_ms / 1e3)
    result["lcs_images_per_s"] = IMAGENET_RATE_CHUNK / (lcs_ms / 1e3)
    g8, c8 = gray[:IMAGENET_GATE_IMAGES], chunk[:IMAGENET_GATE_IMAGES]
    del gray
    lcs_card = lcs.apply_arrays(c8).cpu()
    lcs_cpu = lcs.apply_arrays(c8.cpu())
    result["lcs_card_vs_cpu"] = {
        "mean_rel_to_max": float((lcs_card[..., 0::2] - lcs_cpu[..., 0::2]).abs().max() / lcs_cpu.abs().max()),
        "std_max_abs": float((lcs_card[..., 1::2] - lcs_cpu[..., 1::2]).abs().max())}
    sdiff = (sift.apply_arrays(g8).cpu() - sift.apply_arrays(g8.cpu())).abs()
    result["sift_card_vs_cpu"] = {"within_one": float((sdiff <= 1).double().mean()), "max_abs": float(sdiff.max())}
    saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    switched = {}
    try:
        for flag in (False, True):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = flag
            switched[flag] = (sift.apply_arrays(g8), lcs.apply_arrays(c8))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    result["tf32_sift_bitwise_equal"] = bool(torch.equal(switched[False][0], switched[True][0]))
    result["tf32_lcs_bitwise_equal"] = bool(torch.equal(switched[False][1], switched[True][1]))
    del chunk, g8, c8, switched

    # Top-5 error on the first 256 training images.
    pred = fitted.apply_batch(ArrayDataset(train, device=device)).data
    result["train_top5_error_percent_256"] = top_k_err_percent(pred, labels["train"][:IMAGENET_TRAIN_SCORED])
    del train, pred, fitted, out, sift_pca, lcs_pca, pcas
    torch.cuda.empty_cache()
    result["seconds"] = time.perf_counter() - t_phase
    log("imagenet", **result, **_mnist_end("imagenet"))
    checks = {
        "scores_fp64": result["scores_vs_fp64_rel"] <= IMAGENET_SCORES_FP64_TOL,
        "rescored": result["rescored_predictions_equal"],
        "lcs_card_vs_cpu": result["lcs_card_vs_cpu"]["mean_rel_to_max"] <= IMAGENET_LCS_MEAN_TOL
        and result["lcs_card_vs_cpu"]["std_max_abs"] <= IMAGENET_LCS_STD_ABS,
        "sift_card_vs_cpu": result["sift_card_vs_cpu"]["within_one"] >= VOC_WITHIN_ONE
        and result["sift_card_vs_cpu"]["max_abs"] <= 1.0,
        "tf32": result["tf32_sift_bitwise_equal"] and result["tf32_lcs_bitwise_equal"],
        "peak": result["run_peak_device_bytes"] < IMAGENET_PEAK_BOUND,
        "widths": result["sift_descriptors_per_image"] == IMAGENET_SIFT_PER_IMAGE
        and result["lcs_descriptors_per_image"] == IMAGENET_LCS_PER_IMAGE
        and result["feature_width"] == IMAGENET_FEATURE_WIDTH and result["classes"] == IMAGENET_CLASSES,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"imagenet failed {failed}")
    return 0


def phase_imagenet_cli(device, paths, use_native) -> int:
    """Phase 30: ``python -m keystone_tpu_torch imagenet-sift-lcs-fv`` at
    the defaults on the 64-image tar (train = test), in a subprocess beside
    ``run()`` on the same tar in this process: the same top-5 error."""
    from keystone_tpu_torch.pipelines.imagenet import ImageNetSiftLcsFVConfig, run

    _mnist_start()
    t_phase = time.perf_counter()
    cmd = [sys.executable, "-m", "keystone_tpu_torch", "imagenet-sift-lcs-fv",
           "--train-location", paths["cli"], "--test-location", paths["cli"],
           "--label-path", paths["labels"], "--use-native", str(use_native).lower()]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    try:
        config = ImageNetSiftLcsFVConfig(train_location=paths["cli"], test_location=paths["cli"],
                                         label_path=paths["labels"], use_native=use_native)
        out, run_s = synced_s(lambda: run(config, device=device))
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode == 0:
        cli_line = json.loads(stdout.strip().splitlines()[-1])
    else:
        cli_line = {"rc": proc.returncode, "stderr": stderr[-2000:]}
    log("imagenet_cli", images=IMAGENET_CLI_IMAGES, classes_present=IMAGENET_CLI_CLASSES, run_s=run_s,
        run_test_top5_error_percent=out["test_error_percent"], cli=cli_line,
        seconds=time.perf_counter() - t_phase, **_mnist_end("imagenet_cli"))
    if proc.returncode != 0 or cli_line.get("test_error_percent") != out["test_error_percent"]:
        raise AssertionError(f"imagenet_cli: the CLI's top-5 error {cli_line.get('test_error_percent')} "
                             f"is not run()'s {out['test_error_percent']}")
    return 0


def phase_imagenet_native(device, paths):
    """Phase 31: ``run_native_resolution`` on the first ``IMAGENET_NATIVE_RUN_IMAGES`` of 512 JPEGs
    at ImageNet's common sizes (granularity 32; PCA and GMM samples cut to
    10⁶): the split by span, the peak, the training top-5 error; over all
    512, the buckets and their padding share and, per bucket, the masked
    extractors' valid descriptors against each image's native-size run.
    Returns the ELL launches and the 512 images' bucket shapes and
    padding share."""
    import torch

    from keystone_tpu_torch.data.buckets import bucketize_dataset
    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.data.loaders.imagenet import load_imagenet
    from keystone_tpu_torch.ops.images import GrayScaler, LCSExtractor, MaskedExtractor, PixelScaler, SIFTExtractor
    from keystone_tpu_torch.pipelines.imagenet import ImageNetSiftLcsFVConfig, run_native_resolution
    from keystone_tpu_torch.workflow.tracing import trace

    _mnist_start()
    t_phase = time.perf_counter()
    config = ImageNetSiftLcsFVConfig(train_location=paths["native_run"], label_path=paths["labels"],
                                     num_pca_samples=IMAGENET_NATIVE_SAMPLES,
                                     num_gmm_samples=IMAGENET_NATIVE_SAMPLES, image_size=None)
    with trace() as tr:
        out, run_s = synced_s(lambda: run_native_resolution(config, device=device))
    peak = torch.cuda.max_memory_allocated()
    session = tr.session
    weighted_span = session.find("weighted:bcd")[0]
    result = {
        "images": IMAGENET_NATIVE_RUN_IMAGES, "gate_images": IMAGENET_NATIVE_IMAGES,
        "sizes": IMAGENET_NATIVE_SIZES,
        "num_samples": IMAGENET_NATIVE_SAMPLES, "run_s": run_s,
        "load_and_bucket_s": _span_seconds(session, "imagenet_native:load")[0],
        "fit_s": _span_seconds(session, "imagenet_native:fit")[0],
        "apply_s": _span_seconds(session, "imagenet_native:apply")[0],
        "masked_extractor_s": _trace_seconds(tr, "MaskedExtractor"),
        "kmeanspp_seed_host_s": _span_seconds(session, "kmeans:seed"),
        "em_iterations": [s.attributes["iterations"] for s in session.find("gmm:em")],
        "weighted_solve_s": weighted_span.duration_s, "weighted_path": weighted_span.attributes["path"],
        "num_buckets": out["num_buckets"], "num_train": out["num_train"],
        "run_peak_device_bytes": peak, "train_top5_error_percent": out["train_error_percent"],
    }
    del tr, session, out
    torch.cuda.empty_cache()

    # Buckets and padding; the gate on each bucket's first two images.
    t0 = time.perf_counter()
    buckets = bucketize_dataset(load_imagenet(paths["native"], paths["labels"]), granularity=32)
    result["gate_load_s"] = time.perf_counter() - t0
    true_px = sum(int(np.prod(b.dims, axis=1).sum()) for b in buckets)
    padded_px = sum(len(b) * b.bucket_shape[0] * b.bucket_shape[1] for b in buckets)
    result["buckets"] = [{"shape": list(b.bucket_shape), "images": len(b)} for b in buckets]
    result["padding_share"] = 1.0 - true_px / padded_px
    pre = lambda x: GrayScaler().apply_arrays(PixelScaler().apply_arrays(x))  # noqa: E731
    sift, lcs = SIFTExtractor(scale_step=config.sift_scale_step), LCSExtractor()
    gate = {"sift_valid_counts_equal": True, "lcs_valid_counts_equal": True, "sift_within_one": 1.0,
            "sift_max_abs": 0.0, "lcs_max_abs": 0.0}
    for b in buckets:
        images = torch.from_numpy(b.images[:2].astype(np.float32)).to(device)
        dims = torch.from_numpy(b.dims[:2]).to(device)
        s_out = MaskedExtractor(sift, pre=pre).apply_batch(ArrayDataset({"image": images, "dims": dims}))
        l_desc, l_valid = lcs.apply_arrays_masked(images, dims)
        for i, (xn, yn) in enumerate(b.dims[:2]):
            own_s = sift.apply_arrays(pre(images[i : i + 1, :xn, :yn]))[0]
            own_l = lcs.apply_arrays(images[i : i + 1, :xn, :yn])[0]
            mine_s = s_out.data["desc"][i][s_out.data["valid"][i]]
            mine_l = l_desc[i][l_valid[i]]
            gate["sift_valid_counts_equal"] &= mine_s.shape == own_s.shape
            gate["lcs_valid_counts_equal"] &= mine_l.shape == own_l.shape
            if mine_s.shape == own_s.shape:
                d = (mine_s - own_s).abs()
                gate["sift_within_one"] = min(gate["sift_within_one"], float((d <= 1).double().mean()))
                gate["sift_max_abs"] = max(gate["sift_max_abs"], float(d.max()))
            if mine_l.shape == own_l.shape:
                gate["lcs_max_abs"] = max(gate["lcs_max_abs"], float((mine_l - own_l).abs().max()))
    result["native_size_gate"] = gate
    del buckets
    torch.cuda.empty_cache()
    result["seconds"] = time.perf_counter() - t_phase
    log("imagenet_native", **result, **_mnist_end("imagenet_native"))
    checks = {
        "valid_keypoints": gate["sift_valid_counts_equal"] and gate["lcs_valid_counts_equal"],
        "sift_native_size": gate["sift_within_one"] >= VOC_WITHIN_ONE and gate["sift_max_abs"] <= 1.0,
        "lcs_native_size": gate["lcs_max_abs"] <= IMAGENET_LCS_STD_ABS,
        "count": result["num_train"] == IMAGENET_NATIVE_RUN_IMAGES,
        "peak": peak < IMAGENET_PEAK_BOUND,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"imagenet_native failed {failed}")
    return 0, {"shapes": sorted(b["shape"] for b in result["buckets"]),
               "padding_share": result["padding_share"]}


# imagenet_streaming_ondevice: run_flagship_ondevice() at the JAX package's
# defaults (keystone_tpu/pipelines/imagenet_streaming.py:489-498), whose
# widths are the reference configuration's: desc_dim 64, vocab 16, 4,096
# features, 1,000 classes, λ 6e-5, mixture weight 0.25, block 4,096;
# 50,000 training and 5,000 test images of 256×256 in batches of 64,
# generated on the card (ImageNet is not in the repository: per-class 8×8
# templates upsampled plus N(0, 28²) noise, learnable by design). Gates:
# the fused encode against the op-by-op composition on one batch
# (STREAM_FUSED_TOL), the same batch's first STREAM_GATE_IMAGES rows on the
# card against the CPU (STREAM_CARD_VS_CPU_TOL, beside SIFT within one
# quantization step: the two SIFTs differ by a step at a few entries, which
# the signed Hellinger map and the GMM posterior threshold, neither smooth,
# carry into the rows; on the CPU two such SIFTs, the JAX package's and the
# port's, read 1.0e-4 on tests/test_torch_imagenet_streaming.py's images,
# and an H100 read 1.57e-3 here, over the first bound of 1e-3), the test
# scores of classes 0–47 against a float64
# weighted solve (IMAGENET_SCORES_FP64_TOL), the peak (the point of the
# path: 16 KB of rows per image, not the materialized phase's 57 GB at
# 2,048 images) and the test top-5 error (chance is 99.5%).
STREAM_TRAIN, STREAM_TEST, STREAM_CLASSES, STREAM_SIZE, STREAM_BATCH = 50_000, 5_000, 1_000, 256, 64
# Cut 11: 25,000 train / 2,500 test images (25 a class), the
# configuration and widths kept.
STREAM_TRAIN, STREAM_TEST = STREAM_TRAIN // 2, STREAM_TEST // 2
# Cut 20: 12,500 train / 1,250 test images (12.5 a class; the top-5
# error read 0.0% at 25 a class against the 50% bound); configuration and
# widths kept.
STREAM_TRAIN, STREAM_TEST = STREAM_TRAIN // 2, STREAM_TEST // 2
STREAM_FUSED_TOL, STREAM_CARD_VS_CPU_TOL, STREAM_GATE_IMAGES = 1e-5, 5e-3, 8
STREAM_FP64_CLASSES, STREAM_PEAK_BOUND, STREAM_TOP5_BOUND = 48, 20e9, 50.0
# imagenet_native_streaming: run_native_resolution_streaming on
# imagenet_native's 512 JPEGs (cut 27) (granularity 32, buckets of at most 64
# rows); its gate bucket is the first bucket of the tar's first
# STREAM_NATIVE_GATE_IMAGES images. imagenet_streaming_cli: the CLI at the
# defaults on imagenet_cli's 64-image tar beside the same run in process.
STREAM_NATIVE_GATE_IMAGES = 64
# warm_flagship: the on-device run's bucket and solver shapes.
WARM_BUCKETS, WARM_SOLVES = ((64, 256, 256),), ((50_000, 4_096, 1_000),)
# stupid_backoff: the CLI's synthetic corpus (2,000 lines), then
# fit_language_model on 100,000 lines from the same generator; the
# lemmatizer over tests/fixtures/corenlp_lemma_gold.json, whose agreement
# tests/test_torch_nlp.py reads on the CPU (337 of 337); one LDA fit of
# LDA_ROWS × LDA_WIDTH Gaussian rows in LDA_CLASSES classes whose mapper
# applies on the card, its projection against float64 on the host
# (LDA_TOL: one fp32 product of width 128).
SB_LINES, LEMMA_GOLD_HITS = 100_000, 337
LDA_ROWS, LDA_WIDTH, LDA_CLASSES, LDA_DIMS, LDA_TOL = 100_000, 128, 10, 9, 1e-5


def streaming_op_by_op(fs, images, dims):
    """The streaming flagship's encode one workflow operator at a time:
    masked extractor → PCA → Fisher vector → vectorize → normalize →
    Hellinger → normalize per branch, then the combiner."""
    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.images import GrayScaler, MaskedExtractor, PixelScaler
    from keystone_tpu_torch.ops.learning.pca import BatchPCATransformer
    from keystone_tpu_torch.ops.stats.core import NormalizeRows, SignedHellingerMapper
    from keystone_tpu_torch.ops.util.vectors import MatrixVectorizer, VectorCombiner
    from keystone_tpu_torch.pipelines.imagenet import ApplyArrays

    data = ArrayDataset({"image": images, "dims": dims})
    cb = fs.codebooks
    rows = []
    for extractor, pca, fv in (
        (MaskedExtractor(fs._sift, pre=ApplyArrays(PixelScaler(), GrayScaler()),
                         post=SignedHellingerMapper().apply_arrays), cb.sift_pca, cb.sift_fv),
        (MaskedExtractor(fs._lcs), cb.lcs_pca, cb.lcs_fv),
    ):
        out = extractor.apply_batch(data)
        for op in (BatchPCATransformer(pca), fv, MatrixVectorizer(), NormalizeRows(),
                   SignedHellingerMapper(), NormalizeRows()):
            out = op.apply_batch(out)
        rows.append(out.data)
    return VectorCombiner().apply_arrays(rows)


def _on_cpu(fs):
    """A CPU twin of a streaming flagship, holding the same codebooks."""
    from keystone_tpu_torch.convert import flagship_codebooks_from_numpy
    from keystone_tpu_torch.pipelines.imagenet_streaming import StreamingFlagship, _gmm_arrays

    cb = fs.codebooks
    twin = StreamingFlagship(fs.config, device="cpu")
    twin.adopt_codebooks(flagship_codebooks_from_numpy(
        cb.sift_pca.cpu().numpy(), cb.lcs_pca.cpu().numpy(), _gmm_arrays(cb.sift_fv.gmm),
        _gmm_arrays(cb.lcs_fv.gmm), device="cpu"))
    return twin


def phase_imagenet_streaming_ondevice(device) -> int:
    """Phase 32: ``run_flagship_ondevice()`` at the JAX package's defaults
    (``STREAM_TRAIN`` + ``STREAM_TEST`` device-generated images of 256×256, 1,000 classes):
    its phases' seconds, images/s, the solve's path, the peak and the test
    top-5 error; the fused encode against the op-by-op composition and
    against the CPU on one batch, the test scores against float64."""
    import torch

    from keystone_tpu_torch.ops.images import GrayScaler, PixelScaler
    from keystone_tpu_torch.pipelines.imagenet import ImageNetSiftLcsFVConfig
    from keystone_tpu_torch.pipelines.imagenet_streaming import _synth_images, run_flagship_ondevice

    torch.cuda.empty_cache()
    _mnist_start()
    t_phase = time.perf_counter()
    with _Capture(STREAM_TEST) as cap:
        out, run_s = synced_s(lambda: run_flagship_ondevice(
            STREAM_TRAIN, STREAM_TEST, STREAM_CLASSES, STREAM_SIZE, STREAM_BATCH, device=device))
    run_peak = torch.cuda.max_memory_allocated()
    fs = out.pop("flagship")
    MESH_STASH["flagship"] = fs  # mesh_estimators encodes with its codebooks
    result = {**out, "run_s": run_s, "run_peak_device_bytes": run_peak}

    # The float64 gate on the run's own features.
    config = ImageNetSiftLcsFVConfig()
    train_x = cap.seen["train_x"].data[:STREAM_TRAIN].float()
    train_labels = torch.argmax(cap.seen["train_y"].data[:STREAM_TRAIN], dim=1)
    test_x, test_scores = cap.seen["test_x"], cap.seen["test_scores"]
    classes = list(range(STREAM_FP64_CLASSES))
    del cap
    t0 = time.perf_counter()
    s64 = fp64_weighted_scores(train_x, train_labels, test_x, classes, config)
    result["fp64_reference_s"] = time.perf_counter() - t0
    result["scores_vs_fp64_rel"] = rel_err(test_scores[:, classes].double(), s64)
    del train_x, train_labels, test_x, test_scores, s64
    torch.cuda.empty_cache()

    # One batch: fused against op by op on the card, and card against CPU.
    labels = torch.arange(STREAM_BATCH, device=device) % STREAM_CLASSES
    images = _synth_images(labels, STREAM_SIZE, torch.Generator(device=device).manual_seed(0))
    dims = torch.full((STREAM_BATCH, 2), STREAM_SIZE, dtype=torch.int32, device=device)
    fused = fs._encode_bucket(images, dims, fs.codebooks.sift_pca, fs.codebooks.lcs_pca)
    result["fused_vs_op_by_op_rel"] = rel_err(fused, streaming_op_by_op(fs, images, dims))
    cpu = _on_cpu(fs)
    g = STREAM_GATE_IMAGES
    t0 = time.perf_counter()
    on_cpu = cpu._encode_bucket(images[:g].cpu(), dims[:g].cpu(), cpu.codebooks.sift_pca,
                                cpu.codebooks.lcs_pca)
    result["cpu_gate_s"] = time.perf_counter() - t0
    half = on_cpu.shape[1] // 2
    gray = GrayScaler().apply_arrays(PixelScaler().apply_arrays(images[:g]))
    sdiff = (fs._sift.apply_arrays(gray).cpu() - fs._sift.apply_arrays(gray.cpu())).abs()
    result["sift_card_vs_cpu"] = {"within_one": float((sdiff <= 1).double().mean()),
                                  "equal": float((sdiff == 0).double().mean()), "max_abs": float(sdiff.max())}
    del gray, sdiff
    result["card_vs_cpu_rel"] = rel_err(fused[:g].cpu(), on_cpu)
    result["card_vs_cpu_rel_by_branch"] = {"sift": rel_err(fused[:g, :half].cpu(), on_cpu[:, :half]),
                                           "lcs": rel_err(fused[:g, half:].cpu(), on_cpu[:, half:])}
    del fs, cpu, images, fused, on_cpu
    torch.cuda.empty_cache()
    result["seconds"] = time.perf_counter() - t_phase
    log("imagenet_streaming_ondevice", **result, **_mnist_end("imagenet_streaming_ondevice"))
    checks = {
        "fused_vs_op_by_op": result["fused_vs_op_by_op_rel"] <= STREAM_FUSED_TOL,
        "card_vs_cpu": result["card_vs_cpu_rel"] <= STREAM_CARD_VS_CPU_TOL
        and result["sift_card_vs_cpu"]["within_one"] >= VOC_WITHIN_ONE
        and result["sift_card_vs_cpu"]["max_abs"] <= 1.0,
        "scores_fp64": result["scores_vs_fp64_rel"] <= IMAGENET_SCORES_FP64_TOL,
        "peak": run_peak < STREAM_PEAK_BOUND,
        "top5": result["top5_err_percent"] < STREAM_TOP5_BOUND,
        "complete": "truncated" not in result and result["encoded_images"] == STREAM_TRAIN + STREAM_TEST
        and result["fv_dim_combined"] == IMAGENET_FEATURE_WIDTH,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"imagenet_streaming_ondevice failed {failed}")
    return 0


def _first_native_bucket(path):
    """The first size bucket of the tar's first STREAM_NATIVE_GATE_IMAGES
    images, decoded with PIL as the streaming loader decodes them."""
    import tarfile

    from keystone_tpu_torch.data.buckets import bucketize_images
    from keystone_tpu_torch.utils.image import load_image

    records = []
    with tarfile.open(path) as tar:
        for member in tar:
            if len(records) == STREAM_NATIVE_GATE_IMAGES:
                break
            records.append({"image": load_image(tar.extractfile(member).read())})
    bucket = bucketize_images(records, granularity=32, max_rows=64)[0]
    bucket.images = np.clip(bucket.images, 0, 255).astype(np.uint8)
    return bucket


def phase_imagenet_native_streaming(device, paths, use_native, native_buckets) -> int:
    """Phase 33: ``run_native_resolution_streaming`` on imagenet_native's
    512 JPEGs: its seconds, buckets and training top-5 error; the same
    bucket shapes and padding share as the materialized phase; one
    bucket's fused encode against the op-by-op composition, and encoded
    bit for bit again after ``save`` → ``load``."""
    import torch

    from keystone_tpu_torch.pipelines.imagenet import ImageNetSiftLcsFVConfig
    from keystone_tpu_torch.pipelines.imagenet_streaming import (
        StreamingFlagship,
        run_native_resolution_streaming,
    )

    torch.cuda.empty_cache()
    _mnist_start()
    t_phase = time.perf_counter()
    config = ImageNetSiftLcsFVConfig(train_location=paths["native"], label_path=paths["labels"],
                                     image_size=None, use_native=use_native)
    out, run_s = synced_s(lambda: run_native_resolution_streaming(config, device=device))
    peak = torch.cuda.max_memory_allocated()
    fs = out.pop("flagship")
    del out["model"]
    result = {**out, "run_s": run_s, "run_peak_device_bytes": peak,
              "bucket_shapes": [list(s) for s in out["bucket_shapes"]],
              "materialized_bucket_shapes": native_buckets["shapes"],
              "materialized_padding_share": native_buckets["padding_share"]}

    bucket = _first_native_bucket(paths["native"])
    images, dims = torch.from_numpy(bucket.images).to(device), torch.from_numpy(bucket.dims).to(device)
    fused = fs._encode_bucket(images, dims, fs.codebooks.sift_pca, fs.codebooks.lcs_pca)
    result["gate_bucket"] = {"shape": list(bucket.bucket_shape), "images": len(bucket)}
    result["fused_vs_op_by_op_rel"] = rel_err(fused, streaming_op_by_op(fs, images, dims))
    with tempfile.TemporaryDirectory(prefix="keystone-flagship-") as tmp:
        path = os.path.join(tmp, "flagship.pkl")
        fs.save(path)
        loaded, _ = StreamingFlagship.load(path, device=device)
    again = loaded._encode_bucket(images, dims, loaded.codebooks.sift_pca, loaded.codebooks.lcs_pca)
    result["save_load_bitwise_equal"] = bool(torch.equal(again, fused))
    del fs, loaded, images, dims, fused, again
    torch.cuda.empty_cache()
    result["seconds"] = time.perf_counter() - t_phase
    log("imagenet_native_streaming", **result, **_mnist_end("imagenet_native_streaming"))
    checks = {
        "buckets": sorted(result["bucket_shapes"]) == sorted(native_buckets["shapes"])
        and result["padding_share"] == native_buckets["padding_share"],
        "count": result["num_train"] == IMAGENET_NATIVE_IMAGES,
        "fused_vs_op_by_op": result["fused_vs_op_by_op_rel"] <= STREAM_FUSED_TOL,
        "save_load": result["save_load_bitwise_equal"],
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"imagenet_native_streaming failed {failed}")
    return 0


def phase_imagenet_streaming_cli(device, paths, use_native) -> int:
    """Phase 34: ``python -m keystone_tpu_torch imagenet-native-streaming``
    at the defaults on imagenet_cli's 64-image tar, in a subprocess beside
    ``run_native_resolution_streaming`` on the same tar in this process:
    the same training top-5 error."""
    from keystone_tpu_torch.pipelines.imagenet import ImageNetSiftLcsFVConfig
    from keystone_tpu_torch.pipelines.imagenet_streaming import run_native_resolution_streaming

    _mnist_start()
    t_phase = time.perf_counter()
    cmd = [sys.executable, "-m", "keystone_tpu_torch", "imagenet-native-streaming",
           "--train-location", paths["cli"], "--label-path", paths["labels"],
           "--use-native", str(use_native).lower()]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    try:
        config = ImageNetSiftLcsFVConfig(train_location=paths["cli"], label_path=paths["labels"],
                                         image_size=None, use_native=use_native)
        out, run_s = synced_s(lambda: run_native_resolution_streaming(config, device=device))
        stdout, stderr = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if proc.returncode == 0:
        cli_line = json.loads(stdout.strip().splitlines()[-1])
    else:
        cli_line = {"rc": proc.returncode, "stderr": stderr[-2000:]}
    want = out["train_top5_err_percent"]
    log("imagenet_streaming_cli", images=IMAGENET_CLI_IMAGES, run_s=run_s,
        run_train_top5_err_percent=want, cli=cli_line,
        seconds=time.perf_counter() - t_phase, **_mnist_end("imagenet_streaming_cli"))
    if proc.returncode != 0 or cli_line.get("train_top5_err_percent") != want:
        raise AssertionError(f"imagenet_streaming_cli: the CLI's top-5 error "
                             f"{cli_line.get('train_top5_err_percent')} is not the run's {want}")
    return 0


def phase_warm_flagship(device) -> int:
    """Phase 35: ``warm_flagship`` at the on-device run's bucket and solver
    shapes: seconds per shape."""
    from keystone_tpu_torch.utils.aot import warm_flagship

    _mnist_start()
    t_phase = time.perf_counter()
    out = warm_flagship(bucket_shapes=WARM_BUCKETS, solver_shapes=WARM_SOLVES, device=device)
    log("warm_flagship", **out, seconds=time.perf_counter() - t_phase, **_mnist_end("warm_flagship"))
    want = {f"encode_{r}x{x}x{y}_s" for r, x, y in WARM_BUCKETS} | {
        f"solve_{n}x{d}x{c}_s" for n, d, c in WARM_SOLVES}
    if set(out) != want:
        raise AssertionError(f"warm_flagship returned {sorted(out)}, not {sorted(want)}")
    return 0


def phase_stupid_backoff(device) -> int:
    """Phase 36: the Stupid Backoff workload on the CLI's corpus and
    ``fit_language_model`` on 100,000 lines (host Python), the lemmatizer
    over the gold fixture, and one LDA fit whose mapper applies on the
    card."""
    import torch

    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.learning.lda import LinearDiscriminantAnalysis
    from keystone_tpu_torch.ops.nlp import lemmatize
    from keystone_tpu_torch.pipelines.stupid_backoff import (
        StupidBackoffConfig,
        _synthetic_corpus,
        fit_language_model,
        run,
    )

    _mnist_start()
    t_phase = time.perf_counter()
    small = run(StupidBackoffConfig(), device=device)
    t0 = time.perf_counter()
    lines = _synthetic_corpus(SB_LINES)
    corpus_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = fit_language_model(lines)
    fit_s = time.perf_counter() - t0
    in_unit = all(0.0 <= s <= 1.0 for m in (small["model"], model) for s in m.scores.values())
    result = {
        "run_s": small["seconds"], "run_tokens": small["num_tokens"], "run_vocab": small["vocab_size"],
        "run_ngrams": small["num_ngrams"], "lines": SB_LINES, "corpus_s": corpus_s, "fit_s": fit_s,
        "tokens": model.num_tokens, "vocab": len(model.unigram_counts), "ngrams": len(model.scores),
        "scores_in_unit_interval": in_unit,
    }
    del small, model, lines

    with open(os.path.join(ROOT, "tests", "fixtures", "corenlp_lemma_gold.json")) as f:
        gold = json.load(f)
    t0 = time.perf_counter()
    result["lemma_gold_hits"] = sum(lemmatize(w) == g for w, g in gold.items())
    result["lemma_s"] = time.perf_counter() - t0
    result["lemma_gold_words"] = len(gold)

    rng = np.random.default_rng(SEED)
    centres = rng.normal(scale=3.0, size=(LDA_CLASSES, LDA_WIDTH))
    y = rng.integers(0, LDA_CLASSES, LDA_ROWS)
    x = (centres[y] + rng.normal(size=(LDA_ROWS, LDA_WIDTH))).astype(np.float32)
    t0 = time.perf_counter()
    mapper = LinearDiscriminantAnalysis(LDA_DIMS, device=device).fit(
        ArrayDataset(x, device=device), ArrayDataset(y.astype(np.int32), device=device))
    result["lda_fit_s"] = time.perf_counter() - t0
    proj, apply_s = synced_s(lambda: mapper.apply_batch(ArrayDataset(x, device=device)).data)
    w64 = mapper.weights.double().cpu().numpy()
    want = torch.from_numpy(x.astype(np.float64) @ w64)
    result.update({"lda_apply_s": apply_s, "lda_weights_device": str(mapper.weights.device),
                   "lda_vs_fp64_rel": rel_err(proj.cpu(), want)})
    del mapper, proj, x
    result["seconds"] = time.perf_counter() - t_phase
    log("stupid_backoff", **result, **_mnist_end("stupid_backoff"))
    checks = {
        "scores_in_unit_interval": in_unit,
        "lemma_gold": result["lemma_gold_hits"] == LEMMA_GOLD_HITS == len(gold),
        "lda_on_card": result["lda_weights_device"].startswith("cuda"),
        "lda_fp64": result["lda_vs_fp64_rel"] <= LDA_TOL,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"stupid_backoff failed {failed}")
    return 0


def _port_cli(command: str, args: list, env: dict = None, stdin: str = None, timeout: float = 600) -> dict:
    """One ``python -m keystone_tpu_torch <command>`` subprocess: exit code,
    output and wall seconds."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "keystone_tpu_torch", command, *args], cwd=ROOT, input=stdin,
        capture_output=True, text=True, timeout=timeout, env={**os.environ, **(env or {})},
    )
    return {"rc": proc.returncode, "stdout": proc.stdout, "stderr": proc.stderr,
            "wall_s": time.perf_counter() - t0}


def _port_clis(runs: dict) -> dict:
    """Several independent ``_port_cli`` runs at once (one thread each),
    by name."""
    import threading

    out: dict = {}
    threads = [threading.Thread(target=lambda k=k, v=v: out.__setitem__(k, _port_cli(*v))) for k, v in runs.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def _tagged_json(run: dict, tag: str) -> dict:
    lines = [line for line in run["stdout"].splitlines() if line.startswith(tag)]
    if run["rc"] not in (0, 2) or len(lines) != 1:
        raise AssertionError(f"no {tag} line (rc {run['rc']}): {run['stderr'][-3000:]}")
    return json.loads(lines[0][len(tag):])


def _durable_entries(store_dir: str, device):
    """(entry files, the committed resume cursor or None) of a fit store."""
    from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator
    from keystone_tpu_torch.reliability.checkpoint import CheckpointStore
    from keystone_tpu_torch.reliability.durable import load_resume_entry, resume_key
    from keystone_tpu_torch.workflow.fitcmd import FitDemoScaler

    key = resume_key(LinearMapEstimator(), (FitDemoScaler(2.0, 0.5),), DURABLE_ROWS)
    entry = load_resume_entry(CheckpointStore(store_dir, device=device), key)
    return sorted(os.listdir(store_dir)), (entry.cursor if entry is not None else None)


def phase_durable_fit(device, work: str) -> dict:
    """Phase 37: durable fits across real processes through the ``fit``
    CLI: the kill, the KV306 refusal, the resume, and the sketch solver's
    kill-and-resume (the prefix restore runs beside phase 38). Returns
    what phase 38 needs: the resumed store, its fitted entry's digest,
    the probe predictions and the fit command."""
    _mnist_start()
    t_phase = time.perf_counter()
    big = ["--rows", str(DURABLE_ROWS), "--dim", str(DURABLE_DIM), "--classes", str(DURABLE_CLASSES),
           "--chunk-rows", str(DURABLE_CHUNK), "--device", device.type]
    sketch = ["--solver", "sketch", "--ckpt-chunks", "2", "--device", device.type]
    path = {name: os.path.join(work, name) for name in ("ref", "dur", "kv", "sk_ref", "sk_dur")}
    npz = {name: os.path.join(work, name + ".npz") for name in ("ref", "res", "sk_ref", "sk_res")}

    def kill_at(call):
        return {"KEYSTONE_FAULT_SPECS": json.dumps([{"match": "streaming.chunk", "kind": "kill", "calls": [call]}])}

    # Side by side where nothing orders them: each store is its own.
    stage_a = _port_clis({
        "ref": ("fit", big + ["--store-dir", path["ref"], "--out", npz["ref"]]),
        "kill": ("fit", big + ["--store-dir", path["dur"]], kill_at(DURABLE_KILL_CALL)),
        "kill_kv": ("fit", big + ["--store-dir", path["kv"]], kill_at(DURABLE_KILL_CALL)),
        "sk_ref": ("fit", sketch + ["--store-dir", path["sk_ref"], "--out", npz["sk_ref"]]),
        "sk_kill": ("fit", sketch + ["--store-dir", path["sk_dur"]], kill_at(5)),
    })
    ref = _tagged_json(stage_a["ref"], "FIT_STATS:")
    sk_ref = _tagged_json(stage_a["sk_ref"], "FIT_STATS:")
    killed_files, killed_cursor = _durable_entries(path["dur"], device)
    stage_b = _port_clis({
        "strict": ("fit", big + ["--store-dir", path["kv"], "--drift-data", "0.5"], {"KEYSTONE_VERIFY": "strict"}),
        "res": ("fit", big + ["--store-dir", path["dur"], "--out", npz["res"], "--expect-resume"]),
        "sk_res": ("fit", sketch + ["--store-dir", path["sk_dur"], "--out", npz["sk_res"], "--expect-resume"]),
    })
    _, strict_cursor = _durable_entries(path["kv"], device)
    res = _tagged_json(stage_b["res"], "FIT_STATS:")
    res_files, res_cursor = _durable_entries(path["dur"], device)
    sk_res = _tagged_json(stage_b["sk_res"], "FIT_STATS:")
    preds = {k: np.load(v)["preds"] for k, v in npz.items()}

    def rel(a, b):
        return float(np.linalg.norm(preds[a] - preds[b]) / np.linalg.norm(preds[b]))

    result = {
        "rows": DURABLE_ROWS, "dim": DURABLE_DIM, "classes": DURABLE_CLASSES, "chunk_rows": DURABLE_CHUNK,
        "walls_s": {k: r["wall_s"] for k, r in {**stage_a, **stage_b}.items()},
        "ref": {k: ref.get(k) for k in ("fit_s", "chunks", "checkpoints", "checkpoint_s", "checkpoint_bytes")},
        "kill_rc": stage_a["kill"]["rc"], "killed_cursor": getattr(killed_cursor, "chunk_index", None),
        "killed_entries": len(killed_files),
        "strict_rc": stage_b["strict"]["rc"], "strict_kv306": "KV306" in stage_b["strict"]["stderr"],
        "strict_kept_cursor": getattr(strict_cursor, "chunk_index", None),
        "resume": {k: res.get(k) for k in ("fit_s", "chunks", "checkpoints", "checkpoint_s", "checkpoint_bytes",
                                            "resumed_from_chunk", "reingested_chunks", "ledger_kinds")},
        "resume_vs_ref": rel("res", "ref"), "entries_after_resume": res_files,
        "cursor_after_resume": getattr(res_cursor, "chunk_index", None),
        "sketch_kill_rc": stage_a["sk_kill"]["rc"],
        "sketch_resume": {k: sk_res.get(k) for k in ("chunks", "checkpoints", "resumed_from_chunk",
                                                     "reingested_chunks")},
        "sketch_resume_vs_ref": rel("sk_res", "sk_ref"),
        "seconds": time.perf_counter() - t_phase,
    }
    counts = _child_end("durable_fit", {"ref": ref, "res": res, "sk_ref": sk_ref, "sk_res": sk_res},
                        ["kill", "kill_kv", "sk_kill", "strict"])
    log("durable_fit", **result, **counts)
    checks = {
        "ref_streamed": ref.get("streamed") and ref.get("chunks") == 64 and ref.get("checkpoints") == 1,
        "killed": stage_a["kill"]["rc"] == -9 and killed_cursor is not None
        and killed_cursor.chunk_index == DURABLE_CURSOR and len(killed_files) == 1,
        "strict_kv306": stage_a["kill_kv"]["rc"] == -9 and stage_b["strict"]["rc"] not in (0, -9)
        and result["strict_kv306"] and strict_cursor is not None and strict_cursor.chunk_index == DURABLE_CURSOR,
        "resumed": stage_b["res"]["rc"] == 0 and res.get("resumed_from_chunk") == DURABLE_CURSOR
        and res.get("reingested_chunks") == 64 - DURABLE_CURSOR == res.get("chunks"),
        "resume_parity": result["resume_vs_ref"] <= DURABLE_TOL,
        "no_resume_entry_left": res_cursor is None and len(res_files) == 1,
        "sketch_resume": stage_a["sk_kill"]["rc"] == -9 and stage_b["sk_res"]["rc"] == 0
        and sk_res.get("resumed_from_chunk") == 4 and result["sketch_resume_vs_ref"] <= DURABLE_TOL,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"durable_fit failed {failed}")
    digests = res.get("checkpoint_digests") or []
    if len(digests) != 1:
        raise AssertionError(f"durable_fit: expected one fitted entry, got {digests}")
    return {"store": path["dur"], "digest": digests[0], "preds": preds["res"], "fit_args": big,
            "ell_launches": counts["ell_launches"]}


def phase_serve_checkpoint(device, durable: dict, work: str) -> int:
    """Phase 38: serve phase 37's fitted store entry by digest prefix;
    beside it, phase 37's fit once more on the same store (both only
    read it), which must restore from the prefix store."""
    import shutil

    _mnist_start()
    t_phase = time.perf_counter()
    probe = np.random.default_rng(12345).normal(size=(64, DURABLE_DIM)).astype(np.float32)
    features = probe * np.float32(2.0) + np.float32(0.5)  # FitDemoScaler's affine map
    lines = "".join(json.dumps({"id": i, "x": row.tolist()}) + "\n" for i, row in enumerate(features))
    (entry,) = [f for f in os.listdir(durable["store"]) if f.startswith(durable["digest"])]
    ambiguous = os.path.join(work, "ambiguous")
    os.makedirs(ambiguous)
    shutil.copy(os.path.join(durable["store"], entry), os.path.join(ambiguous, entry))
    shutil.copy(os.path.join(durable["store"], entry), os.path.join(ambiguous, durable["digest"] + "0.pkl"))
    common = ["--device", device.type, "--max-batch", "16", "--queue-depth", "256"]
    again_npz = os.path.join(work, "again.npz")
    runs = _port_clis({
        "serve": ("serve", common + ["--checkpoint-dir", durable["store"], "--digest", durable["digest"]], None, lines),
        "missing": ("serve", common + ["--checkpoint-dir", durable["store"], "--digest", "f" * 12 + "0"], None, lines),
        "ambiguous": ("serve", common + ["--checkpoint-dir", ambiguous, "--digest", durable["digest"]], None, lines),
        "again": ("fit", durable["fit_args"] + ["--store-dir", durable["store"], "--out", again_npz]),
    })
    serve = runs["serve"]
    stats = _tagged_json(serve, "SERVE_STATS:")
    again = _tagged_json(runs["again"], "FIT_STATS:")
    answers = {}
    for line in serve["stdout"].splitlines():
        if line.startswith("{"):
            obj = json.loads(line)
            answers[obj["id"]] = obj.get("y")
    got = np.asarray([answers.get(i) for i in range(len(features))], np.float64)
    want = durable["preds"].astype(np.float64)
    err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    again_err = float(np.linalg.norm(np.load(again_npz)["preds"] - want) / np.linalg.norm(want))
    result = {
        "digest": durable["digest"], "served": stats.get("served"), "failures": stats.get("failures"),
        "p50_ms": stats.get("p50_ms"), "p99_ms": stats.get("p99_ms"), "source": stats["models"]["default"]["source"],
        "vs_fit_rel": err, "missing_rc": runs["missing"]["rc"], "ambiguous_rc": runs["ambiguous"]["rc"],
        "missing_error": "FileNotFoundError" in runs["missing"]["stderr"],
        "ambiguous_error": "ambiguous" in runs["ambiguous"]["stderr"],
        "again": {k: again.get(k) for k in ("fit_s", "streamed", "ledger_kinds")}, "again_vs_res": again_err,
        "walls_s": {k: r["wall_s"] for k, r in runs.items()}, "seconds": time.perf_counter() - t_phase,
    }
    counts = _child_end("serve_checkpoint", {"serve": stats, "again": again}, ["missing", "ambiguous"])
    log("serve_checkpoint", **result, **counts)
    checks = {
        "served": serve["rc"] == 0 and stats.get("served") == 64 and stats.get("failures") == 0,
        "answers": err <= SERVE_CKPT_TOL,
        "missing_refused": runs["missing"]["rc"] != 0 and result["missing_error"],
        "ambiguous_refused": runs["ambiguous"]["rc"] != 0 and result["ambiguous_error"],
        "prefix_restore": runs["again"]["rc"] == 0 and not again.get("streamed")
        and "checkpoint_hit" in again.get("ledger_kinds", []) and again_err <= 1e-6,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"serve_checkpoint failed {failed}")
    return counts["ell_launches"]


def _refit_invariants(stats: dict) -> dict:
    """``scripts/refit_smoke.sh``'s invariants on a refit demo's results."""
    outcomes = {r["round"]: r["outcome"] for r in stats["rounds"]}
    return {
        "publishes": stats["publishes"] >= 2,
        "one_rollback_at_the_bad_round": stats["rollbacks"] == 1 and outcomes.get(4) == "rolled_back",
        "skip": stats["skips"] >= 1,
        "dropped": stats["dropped"] == 0,
        "steady_plans": stats["cufft_plans_since_warmup_post_settle"] == 0,
        "ledger": {"refit_publish", "refit_rollback", "refit_skip"} <= set(stats["ledger_kinds"]),
        "live_beats_stale": stats["live_accuracy_final"] > stats["stale_v1_accuracy_final"] + 0.15,
        "incremental_faster": stats["speedup_ok"] and stats["refit_speedup"] > 1.0,
        "recovers": outcomes.get(6) == "published",
    }


def phase_refit_cli(device, work: str) -> int:
    """Phase 39: the ``refit`` CLI at the JAX CLI's defaults."""
    _mnist_start()
    t_phase = time.perf_counter()
    run = _port_cli("refit", ["--device", device.type, "--store-dir", os.path.join(work, "refit_cli")],
                    {"KEYSTONE_FLIGHT_DIR": os.path.join(work, "flight")})
    stats = _tagged_json(run, "REFIT_STATS:")
    checks = _refit_invariants(stats)
    counts = _child_end("refit_cli", {"refit": stats}, [])
    log("refit_cli", rounds=[{k: r[k] for k in ("round", "outcome", "live_accuracy", "fold_s")}
                             for r in stats["rounds"]],
        **{k: stats[k] for k in ("publishes", "rollbacks", "skips", "dropped", "cufft_plans_since_warmup_post_settle",
                                 "live_accuracy_final", "stale_v1_accuracy_final", "incremental_refit_wall_s",
                                 "scratch_fit_wall_s", "refit_speedup", "ledger_kinds")},
        wall_s=run["wall_s"], seconds=time.perf_counter() - t_phase, **counts)
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"refit_cli failed {failed}")
    return counts["ell_launches"]


def phase_refit_full(device, work: str) -> dict:
    """Phase 40: ``run_refit_demo`` at d = 2,048 with ``REFIT_FULL`` rows a round.
    Returns the incumbent (version 1) and the round-1 candidate, which
    ``fleet_publish`` serves."""
    import torch

    from keystone_tpu_torch.refit.daemon import RefitDemoConfig, run_refit_demo

    _mnist_start()
    t_phase = time.perf_counter()
    captured = {}

    def on_round(r, daemon):
        if r == 1:
            captured["heads"] = {"incumbent": daemon.publisher.server.registry.resolve("demo", version=1).model,
                                 "candidate": daemon.last_candidate}
            captured["state"] = daemon.state
            captured["weights"] = daemon.last_candidate.weights.double().cpu()
            captured["reg"] = daemon.estimator.reg

    os.environ["KEYSTONE_FLIGHT_DIR"] = os.path.join(work, "flight")
    out = run_refit_demo(RefitDemoConfig(store_dir=os.path.join(work, "refit"), **REFIT_FULL),
                         device=device, on_round=on_round)
    # Float64 solve of the round-1 statistics, in plain PyTorch on the card.
    state = captured["state"]
    g, c, sa, sb = (torch.from_numpy(np.asarray(a, np.float64)).to(device) for a in state.carry)
    n = float(state.num_examples)
    mu_a, mu_b = sa / n, sb / n
    gc = g - n * torch.outer(mu_a, mu_a)
    cc = c - n * torch.outer(mu_a, mu_b)
    w64 = torch.linalg.solve(gc + captured["reg"] * torch.eye(gc.shape[0], dtype=torch.float64, device=device), cc)
    fp64_rel = rel_err(captured["weights"].to(device), w64)
    checks = _refit_invariants(out)
    checks["candidate_fp64"] = fp64_rel <= REFIT_FP64_TOL
    rounds = [{k: r[k] for k in ("round", "outcome", "rows", "live_accuracy", "fold_s", "state_save_s",
                                 "state_bytes", "round_wall_s", "serve_p50_ms", "serve_p99_ms")}
              for r in out["rounds"]]
    log("refit_full", **REFIT_FULL, rounds=rounds, candidate_vs_fp64_rel=fp64_rel,
        **{k: out[k] for k in ("publishes", "rollbacks", "skips", "dropped", "cufft_plans_since_warmup_post_settle",
                               "state_rows", "live_accuracy_final", "stale_v1_accuracy_final",
                               "incremental_refit_wall_s", "scratch_fit_wall_s", "refit_speedup", "ledger_kinds")},
        seconds=time.perf_counter() - t_phase, **_mnist_end("refit_full"))
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"refit_full failed {failed}")
    return captured["heads"]


class _LineClient:
    """A ``python -m keystone_tpu_torch serve`` process as a client: request
    lines to its stdin with at most ``window`` unanswered, each response
    line settling its future by id; its ``SERVE_STATS:`` line, its
    ``SERVE_LISTEN:`` address and its stderr are kept."""

    def __init__(self, args: list, env: dict, window: int):
        import itertools
        import threading

        self.proc = subprocess.Popen(
            [sys.executable, "-m", "keystone_tpu_torch", "serve", *args], cwd=ROOT,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, bufsize=1,
            env={**os.environ, **env},
        )
        self.t0 = time.perf_counter()
        self.stats = None
        self.listen = None
        self.stderr_tail: list = []
        self._window = threading.Semaphore(window)
        self._futures: dict = {}
        self._lock = threading.Lock()
        self._write_lock = threading.Lock()
        self._ids = itertools.count()
        self._listening = threading.Event()
        self._readers = [threading.Thread(target=self._read_stdout, daemon=True),
                         threading.Thread(target=self._read_stderr, daemon=True)]
        for t in self._readers:
            t.start()

    def submit(self, payload, deadline_s=None):
        from concurrent.futures import Future

        self._window.acquire()
        request_id, future = next(self._ids), Future()
        with self._lock:
            self._futures[request_id] = future
        line = {"id": request_id, "x": payload}
        if deadline_s is not None:
            line["deadline_ms"] = deadline_s * 1e3
        with self._write_lock:
            self.proc.stdin.write(json.dumps(line) + "\n")
            self.proc.stdin.flush()
        return future

    def _read_stdout(self):
        for line in self.proc.stdout:
            if line.startswith("SERVE_STATS:"):
                self.stats = json.loads(line[len("SERVE_STATS:"):])
                continue
            obj = json.loads(line)
            with self._lock:
                future = self._futures.pop(obj.get("id"), None)
            if future is None:
                continue
            self._window.release()
            if "error" in obj:
                future.set_exception(RuntimeError(obj["error"]))
            else:
                future.set_result(obj["y"])

    def _read_stderr(self):
        for line in self.proc.stderr:
            self.stderr_tail = (self.stderr_tail + [line.rstrip()])[-40:]
            if line.startswith("SERVE_LISTEN:"):
                self.listen = line.strip()[len("SERVE_LISTEN:"):]
                self._listening.set()

    def url(self, path: str, timeout: float = 600) -> str:
        if not self._listening.wait(timeout):
            raise AssertionError(f"serve printed no SERVE_LISTEN: {self.stderr_tail[-10:]}")
        return f"http://{self.listen}{path}"

    def close(self, timeout: float = 300) -> int:
        self.proc.stdin.close()
        rc = self.proc.wait(timeout)
        for t in self._readers:
            t.join(30)
        return rc


def _http(url: str, obj=None, timeout: float = 120):
    """(status, body text) of one GET (or a JSON POST when ``obj`` is given)."""
    import urllib.error
    import urllib.request

    data = json.dumps(obj).encode() if obj is not None else None
    request = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(request, timeout=timeout) as response:
            return response.status, response.read().decode()
    except urllib.error.HTTPError as exc:
        return exc.code, exc.read().decode()


def _wait_health(client: _LineClient, predicate, timeout: float, what: str) -> dict:
    deadline = time.monotonic() + timeout
    while True:
        code, body = _http(client.url("/healthz"), timeout=30)
        health = json.loads(body)
        if predicate(health):
            return health
        if time.monotonic() > deadline:
            raise AssertionError(f"fleet never reached {what}: {health} {client.stderr_tail[-10:]}")
        time.sleep(0.05)


def _fleet_counters(text: str) -> dict:
    """``keystone_fleet_*`` counter samples of a /metrics body, by series."""
    return {line.rsplit(" ", 1)[0]: float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
            if line.startswith(("keystone_fleet_requests_total{", "keystone_fleet_failures_total{"))}


def _windowed(submit, window: int):
    """``submit`` with at most ``window`` requests in flight."""
    import threading

    slots = threading.Semaphore(window)

    def call(payload, deadline_s=None):
        slots.acquire()
        future = submit(payload, deadline_s=deadline_s)
        future.add_done_callback(lambda _: slots.release())
        return future

    return call


def _labels_of(futures) -> np.ndarray:
    return np.array([int(np.asarray(f.result(timeout=300)).reshape(-1)[0]) for f in futures])


def _start_fleet(device, artifact, workers: int):
    """A fresh in-process ``WorkerSupervisor`` of ``workers`` card workers
    serving the MNIST artifact, started (not yet ready), and its start."""
    from keystone_tpu_torch.serving.supervisor import SupervisorConfig, WorkerSupervisor

    t0 = time.perf_counter()
    return WorkerSupervisor({"model": artifact}, SupervisorConfig(
        workers=workers, max_batch=64, worker_queue_depth=FLEET_WORKER_QUEUE, device=device.type)).start(), t0


def _fleet_sweep(fleet, rows, want) -> dict:
    """``bench.py::_bench_serving_multiworker``'s sweep at this width on a
    fleet from ``_start_fleet``: once ready, requests until every worker
    has warmed its buckets, then the 2,048 rows through ``run_load`` with
    ``FLEET_SWEEP_WINDOW`` in flight."""
    from keystone_tpu_torch.serving.loadgen import run_load

    sup, t0 = fleet
    workers = sup.config.workers
    try:
        sup.wait_ready(timeout_s=600)
        ready_s = time.perf_counter() - t0
        # The ring spreads request ids over the workers: each one meets
        # its first request (and warms every bucket) before the timing.
        _labels_of([sup.submit(rows[i].tolist()) for i in range(16 * workers)])
        futures = []
        submit = _windowed(sup.submit, FLEET_SWEEP_WINDOW)

        def recorded(payload, deadline_s=None):
            futures.append(submit(payload, deadline_s=deadline_s))
            return futures[-1]

        report = run_load(recorded, [0.0] * len(rows), payload=lambda i: rows[i].tolist(),
                          deadline_s=120.0, settle_timeout_s=300.0)
        labels = _labels_of(futures)
        time.sleep(0.6)  # two beats: the workers' final windows reach the supervisor
        stats = sup.stats()
    finally:
        sup.stop()
    final = sup.stats()
    _check_labels(f"fleet_serve sweep {workers}", labels, want, np.zeros((len(want), 2)))
    worker_p99 = [w["stats"].get("p99_ms") for w in stats["workers"].values()]
    return {
        "workers": workers, "requests": len(rows), "window": FLEET_SWEEP_WINDOW,
        "requests_per_s": report.rps, "client_p50_ms": report.p(50), "client_p99_ms": report.p(99),
        "worst_worker_p99_ms": max(worker_p99), "worker_p99_ms": worker_p99, "dropped": report.dropped,
        "init_s": [w["ready"].get("init_s") for w in stats["workers"].values()],
        "spawn_to_ready_s": [w["ready"].get("spawn_to_ready_s") for w in stats["workers"].values()],
        "fleet_ready_s": ready_s,
        "cufft_plans_since_warmup": [w["stats"].get("cufft_plans_since_warmup") for w in stats["workers"].values()],
        "reports": {f"sweep{workers}_worker{w}": row["stats"] for w, row in final["workers"].items()},
    }


def phase_fleet_serve(device, artifact: str, rows: np.ndarray, want: np.ndarray) -> dict:
    """Phase 41: the MNIST artifact behind ``serve --workers 2 --listen``,
    worker 0 SIGKILLed at its 12th request, 2,048 rows over stdin and HTTP
    at once; then the 1- and 2-worker sweep in this process."""
    import threading

    import torch

    from keystone_tpu_torch.serving.supervisor import HashRing

    _mnist_start()
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    free_before = torch.cuda.mem_get_info()[0]
    kill = json.dumps([{"match": "serving.worker.request", "kind": "kill", "calls": [FLEET_KILL_AT]}])
    client = _LineClient(
        ["--model", artifact, "--workers", "2", "--listen", "127.0.0.1:0", "--max-batch", "64",
         "--queue-depth", str(FLEET_WORKER_QUEUE), "--device", device.type],
        {"KEYSTONE_FAULT_SPECS_WORKER_0": kill}, FLEET_WINDOW,
    )
    health_samples, stop, sweep_one = [], threading.Event(), None
    try:
        _wait_health(client, lambda h: h["alive"] == 2, 600, "two ready workers")
        fleet_ready_s = time.perf_counter() - client.t0
        free_up = torch.cuda.mem_get_info()[0]
        # One request per worker (affinity keys the ring places on each)
        # warms both before the traffic: the memory baseline is the warm
        # fleet's. Worker 0's count starts here: the kill is its 12th.
        ring = HashRing(["0", "1"])
        for worker in ("0", "1"):
            key = next(f"warm-{i}" for i in range(10_000) if next(ring.walk(f"default:warm-{i}")) == worker)
            code, body = _http(client.url("/v1/apply"), {"x": rows[0].tolist(), "key": key})
            if code != 200 or int(json.loads(body)["y"][0]) != int(want[0]):
                raise AssertionError(f"fleet_serve: warm request to worker {worker}: {code} {body[:200]}")
        free_warm = torch.cuda.mem_get_info()[0]

        def monitor():  # worker 0's state and the card's free memory, every 50 ms
            while not stop.is_set():
                try:
                    code, body = _http(client.url("/healthz"), timeout=30)
                except OSError:  # the front-end closed under us: the phase is ending
                    return
                health_samples.append((time.perf_counter(), json.loads(body)["workers"].get("0"),
                                       torch.cuda.mem_get_info()[0]))
                stop.wait(0.05)

        watcher = threading.Thread(target=monitor, daemon=True)
        watcher.start()
        half = len(rows) // 2
        http_answers, http_errors, scrapes = {}, [], []

        def http_client(k, indices):
            for i in indices[k::8]:
                code, body = _http(client.url("/v1/apply"), {"x": rows[i].tolist()})
                if code != 200:
                    http_errors.append((i, code, body[:200]))
                else:
                    http_answers[i] = int(json.loads(body)["y"][0])

        def wave(stdin_idx, http_idx):
            threads = [threading.Thread(target=http_client, args=(k, http_idx)) for k in range(8)]
            for t in threads:
                t.start()
            futures = [(i, client.submit(rows[i].tolist())) for i in stdin_idx]
            scrapes.append(_http(client.url("/metrics"))[1])
            for t in threads:
                t.join(600)
            return futures

        t_traffic = time.perf_counter()
        stdin_futures = wave(range(half), list(range(half, len(rows))))
        stdin_labels = {i: int(np.asarray(f.result(timeout=300))[0]) for i, f in stdin_futures}
        traffic_s = time.perf_counter() - t_traffic
        # The sweep's 1-worker fleet starts while this one waits for its
        # restart (only the restart's seconds share the host with it).
        sweep_one = _start_fleet(device, artifact, 1)
        # Worker 0 died at its 12th request: wait for its restart, then a
        # second wave so the restarted incarnation serves and warms too.
        _wait_health(client, lambda h: h["alive"] == 2 and any(s[1] != "ready" for s in health_samples),
                     600, "worker 0's restart")
        scrapes.append(_http(client.url("/metrics"))[1])
        second = list(range(256))
        stdin_futures = wave(second[:128], second[128:])
        stdin_labels.update({("again", i): int(np.asarray(f.result(timeout=300))[0]) for i, f in stdin_futures})
        health_code = _http(client.url("/healthz"))[0]
        scrapes.append(_http(client.url("/metrics"))[1])
    except BaseException:
        if sweep_one is not None:
            sweep_one[0].stop(drain=False)
        raise
    finally:
        stop.set()
        rc = client.close()
    stats = client.stats or {}
    # The kill: the first sample with worker 0 not ready, its restart the
    # next sample with it ready again. What the kill gave back is the most
    # free memory while it was down against the warm fleet's, beside one
    # warm worker's share.
    down = [k for k, s in enumerate(health_samples) if s[1] != "ready"]
    restart_s = (health_samples[down[-1] + 1][0] - health_samples[down[0]][0]
                 if down and down[-1] + 1 < len(health_samples) else None)
    free_after_kill = max(health_samples[k][2] for k in down) if down else None
    freed = free_after_kill - free_warm if down else None
    share = (free_before - free_warm) / 2
    labels = np.array([stdin_labels[i] if i < half else http_answers.get(i, -1) for i in range(len(rows))])
    again = np.array([stdin_labels[("again", i)] if i < 128 else http_answers.get(i, -1) for i in second])
    _check_labels("fleet_serve", labels, want, np.zeros((len(want), 2)))
    _check_labels("fleet_serve second wave", again, want[:256], np.zeros((256, 2)))
    counters = [_fleet_counters(t) for t in scrapes]
    monotonic = all(later.get(k, -1) >= v for a, later in zip(counters, counters[1:]) for k, v in a.items())
    workers = stats.get("workers", {})
    kinds = [e["kind"] for e in stats.get("recovery", {}).get("events", [])]
    sweeps = {1: _fleet_sweep(sweep_one, rows, want)}
    sweeps[2] = _fleet_sweep(_start_fleet(device, artifact, 2), rows, want)
    reports = {f"serve_worker{w}": row["stats"] for w, row in workers.items()}
    for sweep in sweeps.values():
        reports.update(sweep.pop("reports"))
    result = {
        "rc": rc, "rows": len(rows), "kill_at_request": FLEET_KILL_AT, "fleet_ready_s": fleet_ready_s,
        "traffic_s": traffic_s, "served": stats.get("served"), "p50_ms": stats.get("p50_ms"),
        "p99_ms": stats.get("p99_ms"), "requeued": stats.get("supervisor", {}).get("requeued"),
        "restarts": stats.get("supervisor", {}).get("restarts"), "restart_s": restart_s,
        "http_errors": len(http_errors), "healthz_after": health_code, "metrics_monotonic": monotonic,
        "fleet_requests_total": [sum(v for k, v in c.items() if "requests" in k) for c in counters],
        "ledger_kinds": sorted(set(kinds)),
        "workers": {w: {k: row[k] for k in ("incarnation", "restarts", "state", "ready")}
                    | {"cufft_plans_since_warmup": row["stats"].get("cufft_plans_since_warmup")}
                    for w, row in workers.items()},
        "free_bytes": {"before_spawn": free_before, "fleet_up": free_up, "fleet_warm": free_warm,
                       "after_kill": free_after_kill,
                       "after_restart": health_samples[-1][2] if health_samples else None},
        "worker_share_bytes": share, "freed_by_kill_bytes": freed,
        "sweep": sweeps, "two_vs_one_worker_rps": sweeps[2]["requests_per_s"] / sweeps[1]["requests_per_s"],
        "seconds": time.perf_counter() - t_phase,
    }
    counts = _child_end("fleet_serve", reports, ["worker0 incarnation 0 (SIGKILLed)"])
    log("fleet_serve", **result, **counts)
    policy_first_delay = 0.2  # SupervisorConfig's restart policy: the first backoff
    checks = {
        "exit_0": rc == 0 and bool(stats),
        "nothing_dropped": not http_errors and stats.get("served") is not None,
        "requeued": (result["requeued"] or 0) >= 1,
        "crash_and_restart_in_ledger": {"worker_crash", "worker_restart"} <= set(kinds),
        "restart_in_budget": workers.get("0", {}).get("restarts") == 1 and restart_s is not None
        and restart_s <= policy_first_delay + 120.0 and all(r["state"] != "failed" for r in workers.values()),
        "healthz": health_code == 200,
        "metrics_monotonic": monotonic and len(counters) == 4,
        # cuFFT's plan count is the card's (absent on the CPU).
        "steady_plans": len(workers) == 2 and all(
            w["cufft_plans_since_warmup"] == (0 if device.type == "cuda" else None)
            for w in result["workers"].values()),
        "kill_returns_memory": freed is not None and freed >= 0.5 * share,
        "sweeps_drop_nothing": all(s["dropped"] == 0 for s in sweeps.values()),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"fleet_serve failed {failed}: {client.stderr_tail[-10:]}")
    return {"one_worker_rps": sweeps[1]["requests_per_s"], "one_worker_p99_ms": sweeps[1]["worst_worker_p99_ms"],
            "ell_launches": counts["ell_launches"]}


def _single_worker(device, artifact, rows, want, boot_image, build_dir) -> dict:
    """One card worker from ``boot_image`` (None: the classic path) with
    its kernel libraries looked for in ``build_dir``: seconds to ready,
    the first answer's milliseconds, 64 labels against ``apply_batch``."""
    from keystone_tpu_torch.serving.supervisor import SupervisorConfig, WorkerSupervisor

    t0 = time.perf_counter()
    sup = WorkerSupervisor({"model": artifact}, SupervisorConfig(
        workers=1, max_batch=64, worker_queue_depth=FLEET_WORKER_QUEUE, boot_image=boot_image,
        device=device.type),
        env={"KEYSTONE_CUDA_BUILD_DIR": build_dir}).start()
    try:
        sup.wait_ready(timeout_s=600)
        ready_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        first = _labels_of([sup.submit(rows[0].tolist())])
        first_ms = (time.perf_counter() - t1) * 1e3
        labels = _labels_of(sup.submit_many([r.tolist() for r in rows[:64]]))
    finally:
        sup.stop()
    _check_labels("fleet_elastic single worker", np.concatenate([first, labels]),
                  np.concatenate([want[:1], want[:64]]), np.zeros((65, 2)))
    (row,) = sup.stats()["workers"].values()
    return {"seconds_to_ready": ready_s, **row["ready"], "first_answer_ms": first_ms,
            "nvcc_builds": row["stats"].get("nvcc_builds"),
            "cufft_plans_since_warmup": row["stats"].get("cufft_plans_since_warmup"),
            "libraries_in_build_dir": sorted(os.listdir(build_dir)) if os.path.isdir(build_dir) else [],
            "report": row["stats"]}


def phase_fleet_elastic(device, artifact: str, rows: np.ndarray, want: np.ndarray, serve: dict, work: str) -> int:
    """Phase 42: a boot image of the MNIST artifact; one worker from it,
    one classic and one from a tampered manifest (KV307), side by side,
    each with its own empty kernel build directory; then ``serve
    --autoscale`` from the image under a seeded bursty replay."""
    import shutil
    import threading

    from keystone_tpu_torch.serving.bootimage import MANIFEST, build_boot_image
    from keystone_tpu_torch.serving.loadgen import bursty_offsets, run_load

    _mnist_start()
    t_phase = time.perf_counter()
    image = os.path.join(work, "image")
    t0 = time.perf_counter()
    manifest = build_boot_image({"model": artifact}, image, buckets=FLEET_BUCKETS, max_batch=64,
                                example=rows[0], device=device)
    build_s = time.perf_counter() - t0
    tampered = os.path.join(work, "tampered")
    shutil.copytree(image, tampered)
    with open(os.path.join(tampered, MANIFEST)) as f:
        stale = json.load(f)
    stale["torch_version"] = "0.0.0+stale"
    with open(os.path.join(tampered, MANIFEST), "w") as f:
        json.dump(stale, f)
    # The image's worker, the classic one and the refused one, side by
    # side, each in its own empty build directory (starting the image's
    # first, alone, cost one more worker start in sequence).
    singles = {}

    def run(tag, boot_image):
        singles[tag] = _single_worker(device, artifact, rows, want, boot_image, os.path.join(work, f"build-{tag}"))

    threads = [threading.Thread(target=run, args=a)
               for a in (("image", image), ("classic", None), ("refused", tampered))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(900)

    # The autoscaler under a bursty replay, from the image.
    target_ms = 2 * serve["one_worker_p99_ms"]
    rps = serve["one_worker_rps"]
    offsets = bursty_offsets(FLEET_TRACE_S, base_rps=0.2 * rps, burst_rps=2 * rps, burst_len_s=FLEET_BURST_S,
                             quiet_len_s=FLEET_QUIET_S, seed=FLEET_TRACE_SEED)
    if len(offsets) > FLEET_REPLAY_REQUESTS:
        keep = np.unique(np.linspace(0, len(offsets) - 1, FLEET_REPLAY_REQUESTS).round().astype(int))
        offsets = [offsets[i] for i in keep]
    client = _LineClient(
        ["--model", artifact, "--workers", "1", "--autoscale", "--min-workers", "1", "--max-workers", "3",
         "--boot-image", image, "--slo-p99-ms", repr(target_ms), "--listen", "127.0.0.1:0",
         "--max-batch", str(FLEET_REPLAY_MAX_BATCH), "--queue-depth", str(FLEET_WORKER_QUEUE),
         "--device", device.type], {},
        FLEET_WINDOW,
    )
    futures, sizes, sizes_stop = [], [], threading.Event()
    try:
        _wait_health(client, lambda h: h["alive"] >= 1, 600, "a ready worker")

        def fleet_sizes():
            while not sizes_stop.is_set():
                try:
                    body = _http(client.url("/healthz"))[1]
                except OSError:  # the front-end closed under us: the phase is ending
                    return
                sizes.append((time.perf_counter(), len(json.loads(body)["workers"])))
                sizes_stop.wait(0.25)

        sizer = threading.Thread(target=fleet_sizes, daemon=True)
        sizer.start()

        def recorded(payload, deadline_s=None):
            futures.append((len(futures), client.submit(payload, deadline_s=deadline_s)))
            return futures[-1][1]

        report = run_load(recorded, offsets, payload=lambda i: rows[i % len(rows)].tolist(),
                          settle_timeout_s=300.0)
        # No traffic now: the fleet must drain back to one worker.
        _wait_health(client, lambda h: len(h["workers"]) == 1 and h["draining"] == 0
                     and max((n for _, n in sizes), default=0) > 1, 60, "a scale-down to one worker")
    finally:
        sizes_stop.set()
        rc = client.close()
    stats = client.stats or {}
    labels = _labels_of([f for _, f in futures])
    _check_labels("fleet_elastic replay", labels, want[[i % len(rows) for i, _ in futures]],
                  np.zeros((len(futures), 2)))
    events = stats.get("recovery", {}).get("events", [])
    kinds = [e["kind"] for e in events]
    autoscaler = stats.get("autoscaler", {})
    reports = {f"{tag}_worker": single.pop("report") for tag, single in singles.items()}
    reports.update({f"autoscale_worker{w}": row["stats"] for w, row in stats.get("workers", {}).items()})
    result = {
        "build_s": build_s, "buckets": manifest["buckets"], "libraries": manifest["libraries"],
        "image_bytes": sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(image) for f in fs),
        "singles": singles, "target_p99_ms": target_ms, "burst_rps": 2 * rps, "base_rps": 0.2 * rps,
        "replay": report.summary(),
        "fleet_size_changes": [[round(t - sizes[0][0], 2), n] for k, (t, n) in enumerate(sizes)
                               if k == 0 or n != sizes[k - 1][1]],
        "autoscaler": autoscaler, "slo_transitions": [e for e in events if e["kind"] == "slo"],
        "slo": stats.get("supervisor", {}).get("slo"), "worker_p99_ms": stats.get("p99_ms"),
        "ledger_kinds": sorted(set(kinds)), "rc": rc, "seconds": time.perf_counter() - t_phase,
    }
    counts = _child_end("fleet_elastic", reports, ["the autoscaler's retired workers (not in SERVE_STATS)"])
    log("fleet_elastic", **result, **counts)
    card = device.type == "cuda"  # kernel libraries and cuFFT plans are the card's
    checks = {
        "image_loaded": singles["image"]["boot_image"] == "loaded" and singles["image"]["nvcc_builds"] == 0
        and singles["image"]["cufft_plans_since_warmup"] == (0 if card else None),
        "image_placed_libraries": not card or (manifest["libraries"] != []
                                               and set(manifest["libraries"]) <= set(singles["image"]["libraries_in_build_dir"])),
        "classic_built": singles["classic"]["boot_image"] is None
        and (not card or singles["classic"]["nvcc_builds"] >= 1),
        "kv307_refused": singles["refused"]["boot_image"] == "refused"
        and "bootimage_refused" in (singles["refused"]["ledger_kinds"] or []),
        "exit_0": rc == 0 and bool(stats),
        "scaled_up_and_down": autoscaler.get("scale_ups", 0) >= 1 and autoscaler.get("scale_downs", 0) >= 1,
        "nothing_dropped": report.dropped == 0,
        "slo_transitions": "slo" in kinds,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"fleet_elastic failed {failed}: {client.stderr_tail[-10:]}")
    return counts["ell_launches"]


def phase_fleet_publish(device, heads: dict, work: str) -> int:
    """Phase 43: two card workers serving ``refit_full``'s incumbent head
    from a ``CheckpointStore``; ``SupervisorPublisher`` publishes the
    round-1 candidate and rolls it back while 8 clients send load."""
    import threading

    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.refit.publish import SupervisorPublisher
    from keystone_tpu_torch.reliability.checkpoint import CheckpointStore
    from keystone_tpu_torch.serving.supervisor import SupervisorConfig, WorkerSupervisor

    _mnist_start()
    t_phase = time.perf_counter()
    store_dir = os.path.join(work, "publish-store")
    digest = "incumbent" + "0" * 31
    if not CheckpointStore(store_dir, device=device).save(None, heads["incumbent"], digest=digest):
        raise AssertionError("fleet_publish: the store refused the incumbent")
    x = np.random.default_rng(43).normal(size=(PUBLISH_ROWS, REFIT_FULL["d"])).astype(np.float32)
    refs = {tag: np.asarray(heads[tag].apply_batch(ArrayDataset(x, device=device)).data.cpu(), np.float64)
            for tag in ("incumbent", "candidate")}
    sup = WorkerSupervisor({"checkpoint_dir": store_dir, "digest": digest}, SupervisorConfig(
        workers=2, max_batch=64, worker_queue_depth=FLEET_WORKER_QUEUE, device=device.type)).start()
    acks, answers, errors, stop = [], [], [], threading.Event()
    swap = sup.swap
    sup.swap = lambda *a, **k: acks.append(swap(*a, **k)) or acks[-1]
    try:
        sup.wait_ready(timeout_s=600)
        ready_s = time.perf_counter() - t_phase
        _labels_of([sup.submit(x[i].tolist()) for i in range(16)])  # both workers warm their buckets

        def client(k):
            i = k
            while not stop.is_set():
                t_sub = time.perf_counter()
                try:
                    y = sup.submit(x[i].tolist()).result(timeout=120)
                    answers.append((i, t_sub, time.perf_counter(), np.asarray(y, np.float64)))
                except Exception as exc:  # surfaced by the gate
                    errors.append(f"{type(exc).__name__}: {exc}")
                i = (i + PUBLISH_CLIENTS) % PUBLISH_ROWS

        threads = [threading.Thread(target=client, args=(k,)) for k in range(PUBLISH_CLIENTS)]
        for t in threads:
            t.start()
        time.sleep(1.0)
        publisher = SupervisorPublisher(sup, store_dir, incumbent=heads["incumbent"], incumbent_digest=digest,
                                        device=device)
        t_pub = (time.perf_counter(), None)
        ticket = publisher.publish(heads["candidate"], round_index=1)
        t_pub = (t_pub[0], time.perf_counter())
        time.sleep(1.0)
        t_back = (time.perf_counter(), None)
        publisher.rollback(ticket, reason="fleet_publish")
        t_back = (t_back[0], time.perf_counter())
        time.sleep(1.0)
        stop.set()
        for t in threads:
            t.join(300)
    finally:
        stop.set()
        sup.stop()
    stats = sup.stats()

    def rel(y, ref):
        return float(np.linalg.norm(y - ref) / np.linalg.norm(ref))

    served, worst, wrong = {"incumbent": 0, "candidate": 0}, {"incumbent": 0.0, "candidate": 0.0}, []
    for i, t_sub, t_done, y in answers:
        errs = {tag: rel(y, refs[tag][i]) for tag in refs}
        version = next((tag for tag in refs if errs[tag] <= PUBLISH_TOL), None)
        expected = ("incumbent" if t_done < t_pub[0] or t_sub > t_back[1]
                    else "candidate" if t_sub > t_pub[1] and t_done < t_back[0] else None)
        if version is None or (expected is not None and version != expected):
            wrong.append({"row": i, "errs": errs, "expected": expected})
            continue
        served[version] += 1
        worst[version] = max(worst[version], errs[version])
    result = {
        "rows": PUBLISH_ROWS, "clients": PUBLISH_CLIENTS, "fleet_ready_s": ready_s, "answers": len(answers),
        "served_by": served, "worst_rel": worst, "mismatched": wrong[:5], "errors": errors[:5],
        "publish_s": t_pub[1] - t_pub[0], "rollback_s": t_back[1] - t_back[0],
        "acks": [{w: {k: a.get(k) for k in ("kind", "version", "warmup_s")} for w, a in ack.items()} for ack in acks],
        "candidate_vs_incumbent_rel": rel(refs["candidate"], refs["incumbent"]),
        "seconds": time.perf_counter() - t_phase,
    }
    counts = _child_end("fleet_publish", {f"worker{w}": row["stats"] for w, row in stats["workers"].items()}, [])
    log("fleet_publish", **result, **counts)
    checks = {
        "every_worker_acks": len(acks) == 2 and all(
            set(ack) == {"0", "1"} and all(a.get("kind") == "swapped" and a.get("warmup_s") is not None
                                           for a in ack.values()) for ack in acks),
        "nothing_dropped": not errors,
        "answers_from_the_version_served": not wrong and served["incumbent"] > 0 and served["candidate"] > 0,
        "versions_distinct": result["candidate_vs_incumbent_rel"] > 100 * PUBLISH_TOL,
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"fleet_publish failed {failed}")
    return counts["ell_launches"]


# -------------------------------------------------------------- phases 44-50
#
# The cost observatory and the plan-tuning control plane (ROADMAP item
# 13b): the card's roofline per product kind, explain, tune, profile, the
# serving + refit co-scheduler, the fleet trace and the host-side
# bench-diff / quality commands.

#: explain_card: the hashing-TF slice's corpus and shape (phase 3's), one
#: pass (the featurization is host Python); the MNIST pipeline at full
#: width on 16,384 synthetic rows, 3 passes; the drift check clean and
#: with a 4× seeded mis-prediction. The sentinel baselines a node on its
#: first pass, and on the card later passes ran 0.75–1.48× that wall in
#: clean runs (four runs recorded on an H100): so a 4× corruption reads
#: 3–6× and a clean run under 1.5×. The JAX package's 4× band would miss
#: the corruption as often as not, a 3× band missed it once in two card
#: runs; the band here is 2×, with room on both sides. Each run gets a
#: fresh store and sentinel, as a fresh ``explain`` process would.
EXPLAIN_MNIST_ROWS, EXPLAIN_PASSES, EXPLAIN_DRIFT_FACTOR, EXPLAIN_DRIFT_RATIO = 16_384, 3, 4.0, "2.0"
#: The drift check runs on ``explain``'s own synthetic pipeline (the JAX
#: package's default), whose auto-cache predictions the sentinel scores;
#: on the MNIST pipeline the planner's 128-row sample fits are singular
#: (8,192 features) and it plans nothing, so no calibrated prediction
#: exists there to corrupt. 65,536 rows × 512 make its nodes' walls tens
#: of milliseconds on the card.
EXPLAIN_SYNTHETIC = ["--rows", "65536", "--dim", "512", "--classes", "8"]
#: Achieved share of a node's roofline: ≤ 1.05 (the probe's min of 3
#: against a node's one synced wall).
ROOF_SHARE_MAX = 1.05
#: tune_card: the JAX CLI's default shape (8,192 × 256, 4 classes), each
#: task's candidate and wall budget sized to the phases' 75 s.
TUNE_FLAGS = ["--rows", "8192", "--dim", "256", "--classes", "4", "--budget", "6",
              "--time-budget-s", "6", "--seed", "0"]
#: profile_card: the MNIST random-FFT pipeline (4 × 2,048) on 8,192 rows,
#: 64 served requests.
PROFILE_FLAGS = ["--rows", "8192", "--num-ffts", "4", "--block-size", "2048", "--serve-requests", "64"]
#: cosched: refit_full's head (d = 2,048, 10 classes) folding 16,384 rows
#: a round in 2,048-row chunks while the MNIST artifact serves 96
#: requests a round at 320/s, 3 rounds per phase (the preemption in the
#: second); the serial and
#: co-scheduled final states within 1e-6 (the JAX demo's bound).
COSCHED = {"d": 2048, "classes": 10, "rows_per_round": 16_384, "chunk_rows": 2048, "rounds": 3,
           "serve_requests": 96, "serve_rps": 320.0}
COSCHED_PARITY_TOL = 1e-6
#: trace_fleet: two card workers serving a synthetic 64-wide pipeline, 64
#: HTTP requests.
TRACE_FLEET_FLAGS = ["--backend", "synthetic", "--dim", "64", "--workers", "2", "--requests", "64"]


def _cli(argv: list) -> tuple:
    """``python -m keystone_tpu_torch <argv>`` run in this process (the
    subcommand's own entry point, without a process start): its exit code
    and the JSON of each ``PREFIX:{...}`` line it printed, by prefix."""
    import contextlib
    import io

    from keystone_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(argv))
    lines = {}
    for line in buf.getvalue().splitlines():
        head, sep, body = line.partition(":")
        if sep and head.isupper() and body.startswith("{"):
            lines[head] = json.loads(body)
    return rc, lines


def phase_roofline_probe(device) -> dict:
    """Phase 44: ``obs/cost.py``'s roofline probe on the card — one
    8,192² product per binding kind (CUDA events, min of 3) and a 1 GiB
    device copy — against the data sheet: every reading > 0 and ≤ 1.05×
    its peak. Returns the roofline, which the later phases price with."""
    from keystone_tpu_torch.obs import cost

    _mnist_start()
    t0 = time.perf_counter()
    cost.set_roofline(None)
    roof = cost.get_roofline(refresh=True, device=device)
    peaks = card_peaks()
    sheet = {"ieee_fp32": peaks["fp32"], "tf32": peaks["tf32"], "bf16": peaks["bf16"], "fp64": peaks["fp64"]}
    readings = {k: roof.peak_flops_by_kind.get(k, 0.0) for k in sheet}
    share = {k: readings[k] / sheet[k] for k in sheet}
    share["copy_bytes_per_s"] = roof.peak_bytes_per_s / peaks["bytes_per_s"]
    failed = [k for k, v in share.items() if not 0.0 < v <= 1.05]
    log("roofline_probe", backend=roof.backend,
        probed_tflops_per_s={k: v / 1e12 for k, v in readings.items()},
        data_sheet_tflops_per_s={k: v / 1e12 for k, v in sheet.items()},
        probed_copy_tb_per_s=roof.peak_bytes_per_s / 1e12, data_sheet_tb_per_s=peaks["bytes_per_s"] / 1e12,
        share_of_data_sheet=share, ridge_fp32_flop_per_byte=roof.ridge_intensity,
        seconds=time.perf_counter() - t0, failed=failed, **_mnist_end("roofline_probe"))
    if failed:
        raise AssertionError(f"roofline_probe failed {failed}")
    return roof.to_json()


def _explain_fresh(argv: list, work: str, name: str) -> tuple:
    """``explain`` in this process as a fresh process would run it: its
    own profile store and a reset observatory, the probed roofline kept."""
    from keystone_tpu_torch.obs import cost, store

    roof = cost.get_roofline()
    saved = os.environ.get("KEYSTONE_PROFILE_STORE")
    os.environ["KEYSTONE_PROFILE_STORE"] = os.path.join(work, f"{name}.jsonl")
    store.set_store(None)
    cost.reset_cost_observatory()
    cost.set_roofline(roof)
    try:
        rc, out = _cli(argv)
    finally:
        os.environ["KEYSTONE_PROFILE_STORE"] = saved
        store.set_store(None)
    return rc, out


def _node_shares(report: dict) -> list:
    return [(n["node"], n["bound_frac"]) for n in report["nodes"] if n.get("bound_frac") is not None]


def phase_explain_card(device, kernel: dict) -> int:
    """Phase 45: ``explain`` on the card. The hashing-TF slice (phase 3's
    corpus, 65,536 documents, d = 16,384, 16×16 tiles): its fit node ran
    the ELL kernel twice with the FLOP and bytes of the kernel table's
    bound (phase 2's AᵀA and AᵀY counts, summed). The MNIST random-FFT
    pipeline at full width. ``explain``'s synthetic pipeline clean, no
    drift event, and with ``--seed-drift 4``, exactly one. Every node's
    achieved share of its roofline ≤ 1.05."""
    from keystone_tpu_torch.ops.cuda import blocksparse as bs

    _mnist_start()
    t0 = time.perf_counter()
    failed = []
    rc, out = _cli(["explain", "--pipeline", "hashing-tf", "--rows", str(TOPICS * DOCS_PER_TOPIC),
                    "--dim", str(NUM_FEATURES), "--classes", str(NUM_CLASSES), "--seed", str(SEED),
                    "--passes", "1", "--json", "--device", str(device)])
    hashing = out["EXPLAIN_JSON"]
    hashing_s = time.perf_counter() - t0
    fit_nodes = [n for n in hashing["nodes"] if "ell_matmul" in n.get("sites", {})]
    want_flops = sum(e["useful_flops"] for e in kernel["shapes"])
    want_bytes = sum(e["bytes"] for e in kernel["shapes"])
    ell = fit_nodes[0]["sites"]["ell_matmul"] if len(fit_nodes) == 1 else {}
    if rc != 0 or len(fit_nodes) != 1:
        failed.append("hashing_tf_fit_node")
    elif ell["launches"] != 2 or ell["flops"] != want_flops or ell["bytes"] != want_bytes:
        failed.append("ell_facts_vs_bound_counts")
    ell_launches = bs.ell_matmul.launches
    os.environ["KEYSTONE_COST_DRIFT_RATIO"] = EXPLAIN_DRIFT_RATIO
    work = tempfile.TemporaryDirectory(prefix="keystone-explain-")
    mnist = ["explain", "--pipeline", "mnist", "--rows", str(EXPLAIN_MNIST_ROWS), "--num-ffts", "4",
             "--passes", str(EXPLAIN_PASSES), "--json", "--device", str(device)]
    synthetic = ["explain", "--pipeline", "synthetic", *EXPLAIN_SYNTHETIC, "--passes", str(EXPLAIN_PASSES),
                 "--json", "--device", str(device)]
    try:
        t1 = time.perf_counter()
        rc_mnist, mnist_out = _explain_fresh(mnist, work.name, "mnist")
        mnist_s = time.perf_counter() - t1
        rc_clean, clean = _explain_fresh(synthetic, work.name, "clean")
        rc_drift, drift = _explain_fresh(synthetic + ["--seed-drift", str(EXPLAIN_DRIFT_FACTOR)], work.name, "drift")
    finally:
        os.environ.pop("KEYSTONE_COST_DRIFT_RATIO", None)
        work.cleanup()
    mnist_report, clean, drift = mnist_out["EXPLAIN_JSON"], clean["EXPLAIN_JSON"], drift["EXPLAIN_JSON"]
    if rc_mnist != 0:
        failed.append("mnist")
    if rc_clean != 0 or clean["drift_events"]:
        failed.append("drift_without_seed")
    if rc_drift != 2 or len(drift["drift_events"]) != 1 or drift["seeded_corruptions"] != 1:
        failed.append("seeded_drift_not_flagged_once")
    shares = {"hashing_tf": _node_shares(hashing), "mnist": _node_shares(mnist_report),
              "synthetic": _node_shares(clean), "synthetic_drift": _node_shares(drift)}
    over = [(run, node, v) for run, rows in shares.items() for node, v in rows if not v <= ROOF_SHARE_MAX]
    if over:
        failed.append("share_over_roofline")
    if any(r["harvest_compiles"] for r in (hashing, mnist_report, clean, drift)):
        failed.append("harvest_compiles")
    keep = ("node", "seconds", "flops", "bytes_accessed", "roofline", "bound_frac", "predicted_s",
            "predicted_model", "sites", "cold", "drift")
    log("explain_card",
        hashing_tf={"seconds": hashing_s, "nodes": [{k: n[k] for k in keep if k in n} for n in fit_nodes],
                    "bound_counts": {"flops": want_flops, "bytes": want_bytes}},
        mnist={"seconds": mnist_s, "passes": mnist_report["passes"],
               "nodes": [{k: n[k] for k in keep if k in n} for n in mnist_report["nodes"]]},
        synthetic={"passes": clean["passes"], "drift_events": clean["drift_events"],
                   "nodes": [{k: n[k] for k in keep if k in n} for n in clean["nodes"]]},
        synthetic_seeded_drift={"passes": drift["passes"], "drift_events": drift["drift_events"],
                                "stale_keys": drift["store"]["stale_keys"]},
        shares_over_roofline=over, ell_launches_hashing_tf_run=ell_launches,
        seconds=time.perf_counter() - t0, failed=failed, **_mnist_end("explain_card", ell_allowed=True))
    if failed:
        raise AssertionError(f"explain_card failed {failed}")
    return ell_launches


def phase_tune_card(device) -> int:
    """Phase 46: ``tune --tasks stream,solver,blocksparse`` at the JAX
    CLI's default shape into a store of its own: winners persisted under
    the three key families with ``source: tune``, ELL launches in the
    blocksparse sweep, the tuned crossover density beside the 0.05
    default; then an MNIST fit under ``KEYSTONE_MEASURED_KNOBS=all`` on
    8,192 rows (the tuned rows bucket) reads them (the knob-override
    counter moves)."""
    from keystone_tpu_torch.obs import names, store
    from keystone_tpu_torch.ops.cuda import blocksparse as bs
    from keystone_tpu_torch.pipelines.mnist_random_fft import (
        MnistRandomFFTConfig,
        build_pipeline,
        synthetic_mnist,
    )

    _mnist_start()
    t0 = time.perf_counter()
    failed = []
    saved = {k: os.environ.get(k) for k in ("KEYSTONE_PROFILE_STORE", "KEYSTONE_MEASURED_KNOBS")}
    work = tempfile.TemporaryDirectory(prefix="keystone-tune-")
    os.environ["KEYSTONE_PROFILE_STORE"] = os.path.join(work.name, "tuned.jsonl")
    store.set_store(None)
    try:
        rc, out = _cli(["tune", "--tasks", "stream,solver,blocksparse", *TUNE_FLAGS, "--device", str(device)])
        tune_s = time.perf_counter() - t0
        payload = out["TUNE_JSON"]
        ps = store.get_store()
        families = {f: sorted(k for k, _s, m in ps.entries(key_prefix=f) if m.get("source") == "tune")
                    for f in ("stream:", "solver:block_ls:", "blocksparse:threshold")}
        if rc != 0 or not all(families.values()):
            failed.append("winners_persisted")
        sweep = payload["tasks"]["blocksparse"]["measured"]
        sweep_launches = sum(m.get("ell_launches", 0) for m in sweep)
        if sweep_launches <= 0:
            failed.append("ell_launches_in_sweep")
        threshold = [m for _k, _s, m in ps.entries(key_prefix="blocksparse:threshold")][0]
        overrides = names.metric(names.PROFILE_STORE_KNOB_OVERRIDES)
        before = sum(overrides.series().values())
        os.environ["KEYSTONE_MEASURED_KNOBS"] = "all"
        t1 = time.perf_counter()
        train = synthetic_mnist(8192, seed=0, device=device)
        build_pipeline(MnistRandomFFTConfig(), train, device=device).fit()
        knob_fit_s = time.perf_counter() - t1
        knob_overrides = sum(overrides.series().values()) - before
        if knob_overrides <= 0:
            failed.append("measured_knobs_read")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        store.set_store(None)
        work.cleanup()
    ell_launches = bs.ell_matmul.launches
    log("tune_card", tasks={t: {k: payload["tasks"][t][k] for k in
                                ("winner", "winner_objective", "default", "default_objective", "improved",
                                 "candidates_measured", "seconds")} for t in payload["tasks"]},
        blocksparse_sweep=[{"density": m["knobs"]["density"], "sparse_over_dense": m["objective"],
                            "sparse_fit_wall_s": m["sparse_fit_wall_s"], "dense_fit_wall_s": m["dense_fit_wall_s"],
                            "ell_launches": m["ell_launches"]} for m in sweep],
        crossover_density=threshold["threshold"], crossover_speedup=threshold["speedup"],
        default_density_threshold=bs.DEFAULT_DENSITY_THRESHOLD,
        donation_probe=next((m["donation_probe"] for m in payload["tasks"]["solver"]["measured"]
                             if "donation_probe" in m), None),
        winner_keys=families, knob_overrides=knob_overrides, knob_fit_s=knob_fit_s, tune_s=tune_s,
        seconds=time.perf_counter() - t0, failed=failed, **_mnist_end("tune_card", ell_allowed=True))
    if failed:
        raise AssertionError(f"tune_card failed {failed}")
    return ell_launches


def phase_profile_card(device) -> int:
    """Phase 47: ``profile`` on the card: the trace is valid Chrome JSON in
    which a ``solver:fit`` span sits under a ``node:*`` span under the
    ``profile`` root, and the Prometheus file's device memory gauges are
    non-zero for every phase."""
    _mnist_start()
    t0 = time.perf_counter()
    failed = []
    work = tempfile.TemporaryDirectory(prefix="keystone-profile-")
    try:
        rc, out = _cli(["profile", *PROFILE_FLAGS, "--out-dir", work.name, "--device", str(device)])
        summary = out["PROFILE_JSON"]
        with open(os.path.join(work.name, "profile_trace.json")) as f:
            trace = json.load(f)
        with open(os.path.join(work.name, "profile_metrics.prom")) as f:
            prom = f.read()
    finally:
        work.cleanup()
    # Span slices carry their ids; the stream engine's chunk slices do not.
    spans = {e["args"]["span_id"]: e for e in trace["traceEvents"]
             if e.get("ph") == "X" and "span_id" in e.get("args", {})}

    def chain(event):
        names_up = []
        while event is not None:
            names_up.append(event["name"])
            event = spans.get(event["args"].get("parent_id"))
        return names_up

    nested = [chain(e) for e in spans.values() if e["name"] == "solver:fit"]
    nested_ok = any(any(n.startswith("node:") for n in c[1:]) and c[-1] == "profile" for c in nested)
    gauges = {}
    for line in prom.splitlines():
        if line.startswith(("keystone_peak_memory_bytes{", "keystone_memory_in_use_bytes{")):
            key, value = line.rsplit(" ", 1)
            gauges[key] = float(value)
    peaks = {k: v for k, v in gauges.items() if k.startswith("keystone_peak_memory_bytes")}
    device_in_use = {k: v for k, v in gauges.items() if 'source="device"' in k}
    if rc != 0:
        failed.append("exit")
    if not nested_ok:
        failed.append("pipeline_node_solver_nesting")
    if len(peaks) < 3 or not all(v > 0 for v in peaks.values()) or not device_in_use \
            or not all(v > 0 for v in device_in_use.values()):
        failed.append("device_memory_gauges")
    cost_tracks = sum(1 for e in trace["traceEvents"] if e.get("name") == "cost-ledger" and e.get("ph") == "C")
    log("profile_card", summary={k: summary.get(k) for k in ("fit_s", "apply_s", "serve", "spans")},
        trace_events=len(trace["traceEvents"]), cost_ledger_samples=cost_tracks,
        solver_chains=nested[:2], memory_gauges=gauges,
        seconds=time.perf_counter() - t0, failed=failed, **_mnist_end("profile_card"))
    if failed:
        raise AssertionError(f"profile_card failed {failed}")
    return 0


def phase_cosched(device, artifact: str) -> int:
    """Phase 48: ``sched/demo.py`` on the card: the MNIST artifact serves a
    paced trace while refit_full's head (d = 2,048, 10 classes) folds, one
    serial and one co-scheduled phase with a seeded preemption. Nothing
    dropped, the preempted fold resumed from its cursor, the co-scheduled
    final state within 1e-6 of the serial one."""
    from keystone_tpu_torch.sched.demo import CoschedDemoConfig, run_cosched_demo
    from keystone_tpu_torch.workflow.pipeline import FittedPipeline

    _mnist_start()
    t0 = time.perf_counter()
    work = tempfile.TemporaryDirectory(prefix="keystone-cosched-")
    try:
        served = FittedPipeline.load(artifact, device=device)
        ev = run_cosched_demo(CoschedDemoConfig(store_dir=work.name, serve_model=served, serve_dim=784,
                                                **COSCHED), device=device)
    finally:
        work.cleanup()
    resumed = [r for r in ev["rounds"] if r["outcomes"][:1] == ["deferred"]]
    checks = {
        "dropped": ev["dropped"] == 0,
        "preempted_once": ev["preemptions"] == 1 and ev["preempted_at_chunk"] is not None,
        "resumed_and_published": len(resumed) == 1 and resumed[0]["outcomes"][-1] == "published",
        "parity": ev["parity_max_abs_diff"] <= COSCHED_PARITY_TOL,
        "cufft_plans": ev["cufft_plans_steady_state_post_settle"] == 0,
    }
    failed = [k for k, ok in checks.items() if not ok]
    log("cosched", **COSCHED, **{k: ev[k] for k in (
        "serial_wall_s", "cosched_wall_s", "cosched_vs_serial_ratio", "serial_p99_ms_worst", "p99_ms_worst",
        "dropped", "publishes", "deferred_rounds", "leases", "preemptions", "preempted_at_chunk",
        "parity_max_abs_diff", "idle_harvest_s", "ledger_kinds", "cufft_plans_steady_state_post_settle")},
        round_records=ev["rounds"], schedule=ev["obs"]["schedule"],
        seconds=time.perf_counter() - t0, failed=failed, **_mnist_end("cosched"))
    if failed:
        raise AssertionError(f"cosched failed {failed}")
    return 0


def phase_trace_fleet(device) -> int:
    """Phase 49: ``python -m keystone_tpu_torch trace`` with two card
    workers serving a synthetic pipeline: every request answered and the
    merged trace holding the front-end and every worker, none named in
    ``fragments_missing`` (the merge after the fleet stops)."""
    _mnist_start()
    t0 = time.perf_counter()
    work = tempfile.TemporaryDirectory(prefix="keystone-trace-")
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "keystone_tpu_torch", "trace", *TRACE_FLEET_FLAGS, "--device", str(device),
             "--out-dir", work.name], cwd=ROOT, capture_output=True, text=True, timeout=300,
        )
    finally:
        work.cleanup()
    stats = next((json.loads(line.split(":", 1)[1]) for line in proc.stdout.splitlines()
                  if line.startswith("TRACE_STATS:")), None)
    if proc.returncode != 0 or stats is None:
        raise AssertionError(f"trace_fleet: exit {proc.returncode}: {proc.stderr[-3000:]}")
    roles = sorted(stats["processes"].values())
    workers = [r for r in roles if r.startswith("worker")]
    checks = {
        "errors": stats["errors"] == 0,
        "frontend": "frontend" in roles,
        "every_worker": len(set(workers)) == 2,
        "fragments_missing": stats["fragments_missing"] == [],
    }
    failed = [k for k, ok in checks.items() if not ok]
    log("trace_fleet", roles=roles, span_counts=stats["span_counts"], span_names=stats["span_names"],
        fragments_missing=stats["fragments_missing"], requests=stats["requests"], errors=stats["errors"],
        trace_ids=len(stats["trace_ids"]), metric_families=stats["metric_families"],
        seconds=time.perf_counter() - t0, failed=failed, **_mnist_end("trace_fleet"))
    if failed:
        raise AssertionError(f"trace_fleet failed {failed}")
    return 0


def phase_obs_cli(artifacts: dict) -> int:
    """Phase 50, on the host: ``bench-diff`` between two artifacts made of
    this run's own phase lines (``"platform": "gpu"``) — the same run
    against itself is OK (exit 0), a copy with one dropped request
    regresses (exit 1), and a baseline from another platform compares
    counts only — then ``quality`` on its seeded scenario: clean traffic
    exits 0 with no decision, a 3σ shift exits 2 with one rollback."""
    t0 = time.perf_counter()
    work = tempfile.TemporaryDirectory(prefix="keystone-obs-cli-")
    try:
        base = dict(artifacts, platform="gpu")
        worse = json.loads(json.dumps(base))
        worse["cosched"]["dropped"] = 1
        other = dict(base, platform="cpu")
        paths = {}
        for name, body in (("base", base), ("worse", worse), ("other", other)):
            paths[name] = os.path.join(work.name, f"{name}.json")
            with open(paths[name], "w") as f:
                json.dump(body, f)
        same_rc, same = _cli(["bench-diff", "--baseline", paths["base"], "--current", paths["base"]])
        worse_rc, worse_v = _cli(["bench-diff", "--baseline", paths["base"], "--current", paths["worse"]])
        other_rc, other_v = _cli(["bench-diff", "--baseline", paths["other"], "--current", paths["base"]])
    finally:
        work.cleanup()
    clean_rc, clean = _cli(["quality", "--json"])
    shift_rc, shift = _cli(["quality", "--json", "--shift", "3"])
    checks = {
        "same_ok": same_rc == 0 and same["BENCH_DIFF_JSON"]["ok"],
        "regression_caught": worse_rc == 1 and worse_v["BENCH_DIFF_JSON"]["regressions"] == ["cosched"],
        "cross_platform_counts_only": other_rc == 0 and not other_v["BENCH_DIFF_JSON"]["timings_comparable"],
        "quality_clean": clean_rc == 0 and clean["QUALITY_STATS"]["decisions"] == [],
        "quality_shift": shift_rc == 2 and shift["QUALITY_STATS"]["rollbacks"] == 1,
    }
    failed = [k for k, ok in checks.items() if not ok]
    log("obs_cli", legs=sorted(artifacts), verdicts={"same": same["BENCH_DIFF_JSON"]["legs"],
                                                     "worse": worse_v["BENCH_DIFF_JSON"]["regressions"]},
        quality_shift_drift_events=shift["QUALITY_STATS"]["drift_events"],
        seconds=time.perf_counter() - t0, failed=failed)
    if failed:
        raise AssertionError(f"obs_cli failed {failed}")
    return 0


# -------------------------------------------------------------- phase 51

#: Every plan-time verification the fit and load hooks ran in this process
#: (``_install_verify_recorder``): context, report, seconds and what the
#: card did during it.
VERIFY_RECORDS: list = []

#: Contexts of the verifications ``check_card`` seeds to fail: they stop a
#: fit on purpose and are left out of the run-wide error gate.
SEEDED_VERIFY_CONTEXTS = ("check_card:kv101",)

#: ``check_card`` (c): rows of the meta-device MNIST plan whose estimated
#: peak (its 784-wide source alone is 105 GB at 2^25 rows) passes the
#: card's 80 GB.
KV302_ROWS = 1 << 25

#: ``check_card`` (a): MNIST rows of the strict fit (mnist_default's
#: 8,192; the width is the README's, 784 → 4 × 512 → 10).
CHECK_MNIST_ROWS = 8192

#: ``check_card``'s gate on each torch-importing ``check`` process: the
#: graph verification itself (``verify_s``) under this many seconds, with
#: torch's symbolic-shapes machinery never imported and no op falling
#: back from the shape rules to torch's own ``meta`` kernel. That import
#: (sympy, dynamo: 5–9 s on the card's host, which writes no bytecode) is
#: what the shape rules removed; the readings were 0.005–0.008 s (PERF.md
#: §5). The phase's wall and each process's ``wall_s`` are printed, not
#: gated: they are mostly the process's torch and CUDA start, which
#: varies with the host (12.3 s and 17.3 s on two hosts for the same
#: tree).
CHECK_VERIFY_BUDGET_S = 1.0


def _card_counters() -> tuple:
    import torch

    from keystone_tpu_torch.ops.cuda import blocksparse as bs
    from keystone_tpu_torch.ops.cuda import gemm

    return bs.ell_matmul.launches, sum(gemm.launches.values()), torch.cuda.memory_allocated()


def _install_verify_recorder() -> None:
    """Wrap the fit/load hook (``workflow.verify.verify_and_enforce``,
    which ``Pipeline.fit`` and ``ModelRegistry.load_fitted`` look up at
    call time) so that every verification in this process is recorded
    with the card's counters around it. A strict-mode refusal is recorded
    from its ``VerificationError`` and re-raised."""
    from keystone_tpu_torch.workflow import verify

    real = verify.verify_and_enforce

    def recording(graph, context, source_specs=None, **kwargs):
        before = _card_counters()
        report, error = None, None
        try:
            report = real(graph, context, source_specs, **kwargs)
        except verify.VerificationError as e:
            report, error = e.report, e
        after = _card_counters()
        VERIFY_RECORDS.append({
            "context": context, "report": report,
            "ell_launches": after[0] - before[0], "binding_calls": after[1] - before[1],
            "memory_allocated_delta": after[2] - before[2],
        })
        if error is not None:
            raise error
        return report

    verify.verify_and_enforce = recording


def _report_line(record: dict) -> dict:
    """A verification record as ``check_card`` prints it."""
    import re

    report = record["report"]
    # The last axis of every rendered leaf, "(8192, 784):float32" → 784.
    widths = sorted({int(w) for a in report.annotations for w in re.findall(r", (\d+)\):", a.spec)})
    return {"context": record["context"], "ok": report.ok, "seconds": report.seconds,
            "errors": len(report.errors()), "codes": sorted({d.code for d in report.diagnostics}),
            "nodes": len(report.annotations), "widths": widths,
            "ell_launches": record["ell_launches"], "binding_calls": record["binding_calls"],
            "memory_allocated_delta": record["memory_allocated_delta"]}


def _records_for(context: str, start: int) -> list:
    return [r for r in VERIFY_RECORDS[start:] if r["context"] == context]


def _check_clis(artifact: str, buckets: list) -> dict:
    """(d)'s four ``check`` runs, started at once: the saved MNIST artifact
    with phase 6's warmed buckets (exit 0), one bucket left out of the
    warmed set (exit 1, KV301), a 783-wide request (exit 1, KV101), and
    the static tier over the port's tree (exit 0, torch-free)."""
    spec = ["--pipeline", artifact, "--input-spec", "16x784:float32", "--buckets", ",".join(map(str, buckets)),
            "--json"]
    warmed = ["--warmed-buckets", ",".join(map(str, buckets))]
    return _port_clis({
        "clean": ("check", spec + warmed),
        "cold_bucket": ("check", spec + ["--warmed-buckets", ",".join(map(str, buckets[:-1]))]),
        "seed_mismatch": ("check", spec + warmed + ["--seed-mismatch"]),
        "static": ("check", ["--lint", "--concurrency", "--json"]),
    })


def phase_check_card(device, artifact: str) -> int:
    """Phase 51: the static verification tier on the card.

    (a) Under ``KEYSTONE_VERIFY=strict`` the README's MNIST random-FFT
    plan (784 → 4 × 512 → 10, ``CHECK_MNIST_ROWS`` rows) and the
    hashing-TF → block-sparse slice's plan (65,536 documents, d = 16,384)
    are verified by ``Pipeline.fit``'s hook and fitted: 0 errors, and 0
    ELL launches, binding calls and allocated bytes during verification;
    the slice's fit then launches the ELL kernel twice. (b) The MNIST plan
    over a 783-wide source: ``fit`` raises ``VerificationError`` (KV101)
    with nothing launched, called or allocated. (c) The MNIST plan over a
    ``meta`` source of ``KV302_ROWS`` rows against the card's memory: a
    KV302 warning, no refusal, nothing allocated. (d) ``check`` in four
    subprocesses (``_check_clis``), started first and read last. (e) One
    line over every verification of the run (``VERIFY_RECORDS``): reports,
    diagnostics by code, errors (0 outside the seeded ones), seconds."""
    import torch

    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.data.loaders.csv import LabeledData
    from keystone_tpu_torch.ops.cuda import blocksparse as bs
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.util.labels import ClassLabelIndicators
    from keystone_tpu_torch.pipelines.mnist_random_fft import MnistRandomFFTConfig, build_pipeline, synthetic_mnist
    from keystone_tpu_torch.serving.config import ServingConfig, default_bucket_sizes
    from keystone_tpu_torch.workflow.executor import PipelineEnv
    from keystone_tpu_torch.workflow.verify import VerificationError, verify_and_enforce

    _mnist_start()
    t0 = time.perf_counter()
    # Phase 6 served with max_batch 64 and warmed every bucket of it.
    buckets = list(default_bucket_sizes(ServingConfig(max_batch=64).max_batch))
    import threading

    clis: dict = {}
    cli_thread = threading.Thread(target=lambda: clis.update(_check_clis(artifact, buckets)))
    cli_thread.start()
    start = len(VERIFY_RECORDS)
    failed = []
    previous = os.environ.get("KEYSTONE_VERIFY")
    os.environ["KEYSTONE_VERIFY"] = "strict"
    try:
        # (a) the two clean plans, verified and fitted under strict.
        config = MnistRandomFFTConfig()
        fitted = build_pipeline(config, synthetic_mnist(CHECK_MNIST_ROWS, seed=0, device=device),
                                device=device).fit()
        del fitted
        PipelineEnv.reset()
        train, labels = topic_corpus(TOPICS, DOCS_PER_TOPIC, SEED)
        y = ClassLabelIndicators(NUM_CLASSES)(ArrayDataset(labels, device=device)).get()
        ell_before = bs.ell_matmul.launches
        slice_fitted = featurizer(NUM_FEATURES).then_label_estimator(
            BlockLeastSquaresEstimator(BLOCK_SIZE, num_iter=1, reg=REG, device=device), train, y
        ).fit()
        torch.cuda.synchronize()
        slice_fit_launches = bs.ell_matmul.launches - ell_before
        del slice_fitted, y
        fits = _records_for("fit", start)
        if len(fits) != 2:
            raise AssertionError(f"check_card: expected 2 fit verifications, recorded {len(fits)}")
        clean = [_report_line(r) for r in fits]
        for name, line in zip(("mnist", "hashing_tf"), clean):
            if line["errors"] or any(line[k] for k in ("ell_launches", "binding_calls", "memory_allocated_delta")):
                failed.append(f"clean_{name}")
        if slice_fit_launches != 2:
            failed.append("slice_fit_launches")

        # (b) a 783-wide source: refused before anything reaches the card.
        PipelineEnv.reset()
        rng = np.random.default_rng(0)
        narrow = LabeledData(
            ArrayDataset(rng.integers(0, 10, CHECK_MNIST_ROWS).astype(np.int32), device=device),
            ArrayDataset(rng.standard_normal((CHECK_MNIST_ROWS, 783)).astype(np.float32), device=device),
        )
        pipe = build_pipeline(config, narrow, device=device)
        torch.cuda.synchronize()
        before = _card_counters()
        refused = None
        try:
            pipe.fit()
        except VerificationError as e:
            refused = e
        torch.cuda.synchronize()
        after = _card_counters()
        seeded = {
            "raised": refused is not None,
            "codes": sorted({d.code for d in refused.report.errors()}) if refused else [],
            "ell_launches": after[0] - before[0], "binding_calls": after[1] - before[1],
            "memory_allocated_delta": after[2] - before[2],
        }
        if refused is not None:
            VERIFY_RECORDS[-1]["context"] = "check_card:kv101"
        if not (seeded["raised"] and seeded["codes"] == ["KV101"]) or any(
                seeded[k] for k in ("ell_launches", "binding_calls", "memory_allocated_delta")):
            failed.append("seeded_kv101")
        del pipe, narrow

        # (c) a plan whose estimated peak passes the card's memory.
        PipelineEnv.reset()
        card_bytes = int(torch.cuda.mem_get_info(device)[1])
        huge = LabeledData(
            ArrayDataset(torch.empty(KV302_ROWS, dtype=torch.int32, device="meta")),
            ArrayDataset(torch.empty(KV302_ROWS, 784, device="meta")),
        )
        graph, _ = PipelineEnv.get_or_create().optimizer.execute(build_pipeline(config, huge, device=device).graph)
        before = _card_counters()
        report = verify_and_enforce(graph, context="check_card:kv302", device_memory_bytes=card_bytes)
        after = _card_counters()
        kv302 = report.by_code("KV302")
        memory = {
            "card_bytes": card_bytes, "kv302": len(kv302), "severity": kv302[0].severity if kv302 else None,
            "peak_bytes": kv302[0].details["peak_bytes"] if kv302 else None, "ok": report.ok,
            "ell_launches": after[0] - before[0], "binding_calls": after[1] - before[1],
            "memory_allocated_delta": after[2] - before[2],
        }
        if len(kv302) != 1 or memory["severity"] != "warning" or any(
                memory[k] for k in ("ell_launches", "binding_calls", "memory_allocated_delta")):
            failed.append("kv302")
        del graph, huge
    finally:
        if previous is None:
            os.environ.pop("KEYSTONE_VERIFY", None)
        else:
            os.environ["KEYSTONE_VERIFY"] = previous
        cli_thread.join()

    # (d) the CLI runs.
    cli = {}
    for name, run in clis.items():
        lines = [ln for ln in run["stdout"].splitlines() if ln.startswith("{")]
        payload = json.loads(lines[-1]) if lines else {}
        entry = {"rc": run["rc"], "wall_s": run["wall_s"]}
        if "pipeline" in payload:
            entry["codes"] = sorted({d["code"] for d in payload["pipeline"]["diagnostics"]
                                     if d["severity"] == "error"})
            entry["device_counts"] = payload.get("device_counts")
            entry["verify_s"] = payload["pipeline"]["seconds"]
            entry["shape_rule_fallbacks"] = payload.get("shape_rule_fallbacks")
            entry["symbolic_shapes_imported"] = payload.get("symbolic_shapes_imported")
        if "concurrency" in payload:
            entry["torch_free"] = payload["concurrency"]["torch_free"]
            entry["lint_findings"] = len(payload["lint"]["findings"])
            entry["concurrency_findings"] = len(payload["concurrency"]["findings"])
            entry["locks"] = len(payload["concurrency"]["lock_graph"]["locks"])
        if run["rc"] not in (0, 1) or not payload:
            entry["stderr"] = run["stderr"][-1500:]
        cli[name] = entry
    want = {"clean": (0, []), "cold_bucket": (1, ["KV301"]), "seed_mismatch": (1, ["KV101"])}
    for name, (rc, codes) in want.items():
        entry = cli.get(name, {})
        zero = {"ell_launches": 0, "binding_calls": 0, "memory_allocated_delta": 0}
        if entry.get("rc") != rc or entry.get("codes") != codes or entry.get("device_counts") != zero:
            failed.append(f"cli_{name}")
        # The shape rules' repair, read in the process itself: no symbolic
        # shapes imported, no fallback to torch's meta kernels, and the
        # verification quick.
        if entry.get("symbolic_shapes_imported") is not False or entry.get("shape_rule_fallbacks") != {} \
                or not (entry.get("verify_s") is not None and entry["verify_s"] <= CHECK_VERIFY_BUDGET_S):
            failed.append(f"cli_{name}_verify")
    static = cli.get("static", {})
    if static.get("rc") != 0 or static.get("torch_free") is not True:
        failed.append("cli_static")

    seconds = time.perf_counter() - t0
    log("check_card", mnist_rows=CHECK_MNIST_ROWS, slice_documents=len(train), slice_features=NUM_FEATURES,
        clean=clean, slice_fit_ell_launches=slice_fit_launches, seeded_kv101=seeded, kv302=memory,
        kv302_rows=KV302_ROWS, warmed_buckets=buckets, cli=cli, seconds=seconds,
        verify_budget_s=CHECK_VERIFY_BUDGET_S, failed=failed, **_mnist_end("check_card", ell_allowed=True))
    if failed:
        raise AssertionError(f"check_card failed {failed}")
    return bs.ell_matmul.launches


def log_verify_run() -> None:
    """(e) of phase 51: every verification this run's fits and loads went
    through, in this process (the subprocesses' own fits verify in their
    own processes and are not counted here). An error-severity diagnostic
    outside ``SEEDED_VERIFY_CONTEXTS`` is a verifier fault on a plan that
    fits, and fails the run. The card's counters are not summed here:
    serving threads share them with the verifications of some phases;
    ``check_card`` reads them where nothing else runs."""
    from keystone_tpu_torch.workflow.shape_rules import FALLBACKS

    by_code: dict = {}
    contexts: dict = {}
    errors = []
    for record in VERIFY_RECORDS:
        report = record["report"]
        contexts[record["context"].split(":")[0]] = contexts.get(record["context"].split(":")[0], 0) + 1
        for d in report.diagnostics:
            by_code[d.code] = by_code.get(d.code, 0) + 1
        if record["context"] not in SEEDED_VERIFY_CONTEXTS:
            errors += [f"{record['context']}: {d.render()[:300]}" for d in report.errors()]
    log("verify_run", reports=len(VERIFY_RECORDS), by_context=contexts, diagnostics_by_code=by_code,
        errors=len(errors), error_samples=errors[:5], seeded_contexts=list(SEEDED_VERIFY_CONTEXTS),
        seconds=sum(r["report"].seconds for r in VERIFY_RECORDS),
        # Ops no shape rule answered: each made this process import
        # torch's Python meta kernels (workflow/shape_rules.py).
        shape_rule_fallbacks=dict(FALLBACKS))
    if errors:
        raise AssertionError(f"verify_run: {len(errors)} error diagnostics on plans that fit: {errors[:3]}")


# ------------------------------------------------------------ phases 52-55
#
# The multi-device tier (ROADMAP item 14a) on one card. An N-shard mesh
# names cuda:0 N times (``make_mesh(devices=[cuda:0] * N)``): the mesh,
# the collectives, the partitioner's plans and the sharded solvers all
# run as they would over N cards; only the copies between two cards are
# left out. Walls therefore do not scale with the shard count
# (MESH_NOTE), and no phase gates a speed.

MESH_NOTE = ("N shards of one card: every shard's work runs on the same SMs in shard order, so wall time "
             "does not fall with the shard count; the plan-pure counters (shards, collective bytes, "
             "per-shard state) and the parity carry the evidence")
MESH_TOL = 1e-5
MESH_COLLECTIVE_ROWS, MESH_COLLECTIVE_COLS = 8 * 1024, 1024

# _bench_sharded's full sizes (bench.py): the in-core Gram fit (n, d, k),
# and the streamed fit: 8 chunks of 8,192 rows × 768, k = 8.
SHARDED_GRAM = (65_536, 1_024, 16)
SHARDED_STREAM = (8_192, 768, 8)
SHARDED_COUNTS = (1, 2, 4, 8)
# Plan-pure counters of the JAX package's own run of the same legs on the
# CPU (8 virtual devices), rows cut (they do not depend on rows), widths
# as above:
#   JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 python -c "..."
#   (_bench_sharded's gram_fit and stream_fit at 1,024 and 8 × 64 rows:
#   shards_chosen from last_partition_report(), collective bytes from
#   last_stream_report())
SHARDED_JAX = {
    1: {"gram_shards_chosen": 1, "stream_shards_chosen": 1, "stream_collective_bytes": 0},
    2: {"gram_shards_chosen": 2, "stream_shards_chosen": 2, "stream_collective_bytes": 2_386_976},
    4: {"gram_shards_chosen": 4, "stream_shards_chosen": 4, "stream_collective_bytes": 7_160_928},
    8: {"gram_shards_chosen": 8, "stream_shards_chosen": 8, "stream_collective_bytes": 16_708_832},
}
# _bench_sharded2d's width (d = 8,192, k = 8, LinearMapEstimator) at
# n = 65,536 rows (8 chunks of 8,192) on 8 shards, three layouts; the
# JAX package's plan-pure counters from the same CPU run (32-row chunks).
SHARDED2D = (65_536, 8_192, 8, 8_192)
SHARDED2D_LAYOUTS = ((1, "8x1"), (2, "4x2"), (4, "2x4"))
SHARDED2D_JAX = {
    "8x1": {"shards": 8, "model_shards": 1, "state_bytes_per_device": 268_730_400,
            "collective_bytes_data": 1_881_112_800, "collective_bytes_model": 0},
    "4x2": {"shards": 4, "model_shards": 2, "state_bytes_per_device": 134_365_216,
            "collective_bytes_data": 806_191_296, "collective_bytes_model": 134_365_216},
    "2x4": {"shards": 2, "model_shards": 4, "state_bytes_per_device": 67_182_624,
            "collective_bytes_data": 268_730_496, "collective_bytes_model": 201_547_872},
}
SHARDED2D_SKETCH = 2_048  # sketch rows of the sketched rung's 2-D fit


def card_hybrid_mesh(replicas: int, shards: int):
    """``make_hybrid_mesh``'s (replica, data) mesh over ``shards`` shards of
    the card, in this one process."""
    import torch

    from keystone_tpu_torch.parallel.mesh import make_hybrid_mesh

    return make_hybrid_mesh(replicas, [torch.device("cuda", 0)] * shards)


def card_mesh(shards: int, shape=None, axes=("data",)):
    import torch

    from keystone_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(shape, axes, devices=[torch.device("cuda", 0)] * shards)


def phase_mesh_collectives(device) -> int:
    """Phase 52: each of the six collectives on 8 shards of the card,
    held against its definition on the whole tensor."""
    import torch

    from keystone_tpu_torch.parallel import collectives as coll

    _mnist_start()
    t0 = time.perf_counter()
    mesh = card_mesh(8)
    g = torch.Generator(device=device).manual_seed(52)
    x = torch.randn(MESH_COLLECTIVE_ROWS, MESH_COLLECTIVE_COLS, device=device, generator=g)
    xs = list(x.split(MESH_COLLECTIVE_ROWS // 8))
    blocks = x.view(8, -1, MESH_COLLECTIVE_COLS)
    total = blocks.sum(dim=0)
    checks, ms = {}, {}

    def run(name, fn, check):
        out = fn()
        torch.cuda.synchronize()
        checks[name] = check(out)
        ms[name] = cuda_ms(fn, 5)

    run("allreduce_sum", lambda: coll.allreduce_sum(xs, mesh),
        lambda out: max(rel_err(t, total) for t in out))
    run("all_gather", lambda: coll.all_gather(xs, mesh, tiled=True),
        lambda out: max(rel_err(t, x) for t in out))
    run("ring_permute", lambda: coll.ring_permute(xs, mesh, shift=1),
        lambda out: max(rel_err(out[i], xs[(i - 1) % 8]) for i in range(8)))
    run("reduce_scatter", lambda: coll.reduce_scatter(xs, mesh),
        lambda out: rel_err(torch.cat(out), total))
    run("all_to_all", lambda: coll.all_to_all(xs, mesh, split_axis=0, concat_axis=1),
        lambda out: max(rel_err(out[j], torch.cat([t.chunk(8)[j] for t in xs], dim=1)) for j in range(8)))
    index = coll.axis_index(mesh)
    checks["axis_index"] = 0.0 if index == list(range(8)) else 1.0
    mesh2d = card_mesh(8, (4, 2), ("data", "model"))
    pairs = coll.allreduce_sum(xs, mesh2d, "model")
    checks["allreduce_sum_model_axis_of_4x2"] = max(rel_err(pairs[i], xs[i - i % 2] + xs[i - i % 2 + 1])
                                                  for i in range(8))
    on_card = all(t.device.type == device.type for t in pairs)
    counts = _mnist_end("mesh_collectives")
    log("mesh_collectives", shards=8, shard_bytes=xs[0].numel() * 4, rel_err=checks, ms=ms,
        on_card=on_card, seconds=time.perf_counter() - t0, note=MESH_NOTE, **counts)
    bad = {k: v for k, v in checks.items() if not v <= MESH_TOL}
    if bad or not on_card:
        raise AssertionError(f"mesh_collectives: {bad}, on_card={on_card}")
    return counts["ell_launches"]


def phase_sharded(device) -> int:
    """Phase 53: ``_bench_sharded``'s two fits through ``Pipeline.fit``
    and the partition batch on 1-, 2-, 4- and 8-shard meshes of the
    card."""
    import torch

    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.stats.core import LinearRectifier
    from keystone_tpu_torch.parallel import collectives as coll
    from keystone_tpu_torch.parallel.mesh import use_mesh
    from keystone_tpu_torch.parallel.partitioner import last_partition_report
    from keystone_tpu_torch.workflow.executor import PipelineEnv
    from keystone_tpu_torch.workflow.streaming import last_stream_report, streaming_disabled

    _mnist_start()
    t0 = time.perf_counter()
    gn, gd, gk = SHARDED_GRAM
    chunk, sd, sk = SHARDED_STREAM
    rng = np.random.default_rng(11)
    gx = ArrayDataset(rng.normal(size=(gn, gd)).astype(np.float32), device=device)
    gy = ArrayDataset(rng.normal(size=(gn, gk)).astype(np.float32), device=device)
    # The streamed fit's records stay on the host: every chunk is uploaded.
    sx = ArrayDataset(rng.normal(size=(8 * chunk, sd)).astype(np.float32), device="cpu")
    sy = ArrayDataset(rng.normal(size=(8 * chunk, sk)).astype(np.float32), device="cpu")
    probe_g, probe_s = gx.data[:64], sx.data[:64].to(device)
    os.environ["KEYSTONE_STREAM_CHUNK_ROWS"] = str(chunk)

    def fit(data, labels, block):
        PipelineEnv.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        est = BlockLeastSquaresEstimator(block_size=block, num_iter=1, reg=1e-2, device=device)
        pipe = LinearRectifier(0.0).to_pipeline().then_label_estimator(est, data, labels)
        before = coll.calls["allreduce_sum"]
        t = time.perf_counter()
        fitted = pipe.fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        return fitted, wall, torch.cuda.max_memory_allocated(), coll.calls["allreduce_sum"] - before

    def scores(fitted, rows):
        return fitted.apply_batch(ArrayDataset(rows)).data.clone()

    with streaming_disabled():
        fit(gx, gy, gd)  # warm: the first fit's one-time costs stay out of the walls
    legs, ref, failures = {}, {}, []
    for c in SHARDED_COUNTS:
        with use_mesh(card_mesh(c)):
            with streaming_disabled():  # the in-core path
                fitted, wall, peak, allreduces = fit(gx, gy, gd)
            decisions = [d.to_json() for d in last_partition_report() if d.eligible]
            gram = {"wall_s": wall, "peak_device_bytes": peak, "allreduce_sum_calls": allreduces,
                    "shards_chosen": decisions[0]["shards"] if decisions else 1,
                    "spec": decisions[0]["spec"] if decisions else ""}
            preds = scores(fitted, probe_g)
            ref.setdefault("gram", preds)
            gram["vs_1_shard_rel"] = rel_err(preds, ref["gram"])
            fitted, wall, peak, _ = fit(sx, sy, 64)
            rep = last_stream_report()
            stream = {"wall_s": wall, "peak_device_bytes": peak, "shards_chosen": rep.shards,
                      "collective_bytes": rep.collective_bytes, "chunks": rep.chunks,
                      "chunk_rows": rep.chunk_rows, "compiles_steady_state": rep.compiles_steady_state,
                      "state_bytes_per_device": rep.state_bytes_per_device}
            preds = scores(fitted, probe_s)
            ref.setdefault("stream", preds)
            stream["vs_1_shard_rel"] = rel_err(preds, ref["stream"])
        legs[c] = {"gram": gram, "stream": stream}
        want = SHARDED_JAX[c]
        got = {"gram_shards_chosen": gram["shards_chosen"], "stream_shards_chosen": stream["shards_chosen"],
               "stream_collective_bytes": stream["collective_bytes"]}
        if got != want:
            failures.append(f"{c} shards: plan counters {got} != the JAX package's {want}")
        if (gram["allreduce_sum_calls"] > 0) != (c > 1):
            failures.append(f"{c} shards: {gram['allreduce_sum_calls']} allreduce_sum calls in the in-core fit")
        if not (gram["vs_1_shard_rel"] <= MESH_TOL and stream["vs_1_shard_rel"] <= MESH_TOL):
            failures.append(f"{c} shards: predictions vs 1 shard {gram['vs_1_shard_rel']}, "
                            f"{stream['vs_1_shard_rel']}")
        if stream["chunks"] != 8 or stream["compiles_steady_state"] != 0:
            failures.append(f"{c} shards: {stream['chunks']} chunks, {stream['compiles_steady_state']} new shapes")
    os.environ.pop("KEYSTONE_STREAM_CHUNK_ROWS", None)
    counts = _mnist_end("sharded")
    log("sharded", gram={"n": gn, "d": gd, "k": gk}, stream={"n": 8 * chunk, "d": sd, "k": sk, "chunk_rows": chunk},
        by_shards=legs, jax_plan_counters=SHARDED_JAX, note=MESH_NOTE,
        seconds=time.perf_counter() - t0, **counts)
    if failures:
        raise AssertionError(f"sharded: {failures}")
    return counts["ell_launches"]


def phase_sharded2d(device) -> int:
    """Phase 54: ``_bench_sharded2d``'s wide streamed fit (d = 8,192) on
    the 8×1, 4×2 and 2×4 layouts of an 8-shard mesh of the card, and the
    sketched rung on 8×1 and 2×4."""
    import torch

    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator
    from keystone_tpu_torch.ops.stats.core import LinearRectifier
    from keystone_tpu_torch.parallel.mesh import use_mesh
    from keystone_tpu_torch.sketch.solvers import SketchedLeastSquaresEstimator
    from keystone_tpu_torch.workflow.executor import PipelineEnv
    from keystone_tpu_torch.workflow.streaming import last_stream_report

    _mnist_start()
    t0 = time.perf_counter()
    n, d, k, chunk = SHARDED2D
    g = torch.Generator(device=device).manual_seed(17)
    # Made on the card: 2 GiB of host draws would take longer than the
    # fits. The records stay card-resident (chunks are device slices).
    x = ArrayDataset(torch.randn(n, d, device=device, generator=g))
    y = ArrayDataset(torch.randn(n, k, device=device, generator=g))
    probe = x.data[:64]
    env = {"KEYSTONE_STREAM_CHUNK_ROWS": str(chunk), "KEYSTONE_PARTITION_MIN_WIDTH": "64"}
    os.environ.update(env)

    def fit(est, p_m):
        os.environ["KEYSTONE_PARTITION_MODEL_SHARDS"] = str(p_m)
        PipelineEnv.reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        fitted = LinearRectifier(0.0).to_pipeline().then_label_estimator(est, x, y).fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        rep = last_stream_report()
        return fitted.apply_batch(ArrayDataset(probe)).data, {
            "wall_s": wall, "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "shards": rep.shards, "model_shards": rep.model_shards,
            "state_bytes_per_device": rep.state_bytes_per_device,
            "collective_bytes_data": rep.collective_bytes_data,
            "collective_bytes_model": rep.collective_bytes_model,
            "chunks": rep.chunks, "compiles_steady_state": rep.compiles_steady_state}

    layouts, failures, ref = {}, [], None
    with use_mesh(card_mesh(8)):
        for p_m, name in SHARDED2D_LAYOUTS:
            preds, leg = fit(LinearMapEstimator(reg=1e-2, device=device), p_m)
            ref = preds if ref is None else ref
            leg["vs_8x1_rel"] = rel_err(preds, ref)
            layouts[name] = leg
            plan = {key: leg[key] for key in SHARDED2D_JAX[name]}
            if plan != SHARDED2D_JAX[name]:
                failures.append(f"{name}: plan counters {plan} != the JAX package's {SHARDED2D_JAX[name]}")
            if not leg["vs_8x1_rel"] <= MESH_TOL or leg["chunks"] != n // chunk or leg["compiles_steady_state"]:
                failures.append(f"{name}: {leg}")
        sketch = {}
        for p_m, name in ((1, "8x1"), (4, "2x4")):
            est = SketchedLeastSquaresEstimator(reg=1e-2, sketch_size=SHARDED2D_SKETCH, device=device)
            sketch[name] = fit(est, p_m)
    for name, (_preds, leg) in sketch.items():
        leg["vs_8x1_rel"] = rel_err(_preds, sketch["8x1"][0])
    sketch = {name: leg for name, (_p, leg) in sketch.items()}
    for key in ("KEYSTONE_PARTITION_MODEL_SHARDS", *env):
        os.environ.pop(key, None)
    carry_fall = {name: layouts["8x1"]["state_bytes_per_device"] / leg["state_bytes_per_device"]
                  for name, leg in layouts.items()}
    counts = _mnist_end("sharded2d")
    log("sharded2d", n=n, d=d, k=k, chunk_rows=chunk, layouts=layouts, per_shard_carry_fall=carry_fall,
        sketched=sketch, sketch_size=SHARDED2D_SKETCH, note=MESH_NOTE, seconds=time.perf_counter() - t0,
        **counts)
    s24 = sketch["2x4"]
    if (s24["model_shards"], s24["shards"]) != (4, 2) or not s24["vs_8x1_rel"] <= MESH_TOL:
        failures.append(f"sketched 2x4: {s24}")
    if not s24["state_bytes_per_device"] < sketch["8x1"]["state_bytes_per_device"]:
        failures.append("sketched 2x4: per-shard state did not fall")
    if failures:
        raise AssertionError(f"sharded2d: {failures}")
    return counts["ell_launches"]


def _dryrun_check(what, got, want, tol) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if not np.isfinite(got).all():
        raise AssertionError(f"mesh_legs {what}: non-finite result")
    rel = float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))
    if rel > tol:
        raise AssertionError(f"mesh_legs {what}: rel_err {rel:.3e} > {tol:g}")
    return rel


def phase_mesh_legs(device, slice_fit) -> int:
    """Phase 55: the legs of ``__graft_entry__.py::dryrun_multichip`` this
    slice covers, at their sizes (8 shards: n = 64, d = 32, k = 4), on
    8 shards of the card, each against its closed form or its 1-shard
    run with the dryrun's tolerance and against the 1-shard run at
    MESH_TOL; then the hashing-TF slice's block-sparse fit under the
    8-shard mesh."""
    import torch

    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.cuda import blocksparse as bs
    from keystone_tpu_torch.ops.learning.block import BlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.learning.weighted import PerClassWeightedLeastSquaresEstimator
    from keystone_tpu_torch.ops.stats.core import LinearRectifier, PaddedFFT, RandomSignNode
    from keystone_tpu_torch.parallel import collectives as coll
    from keystone_tpu_torch.parallel import linalg
    from keystone_tpu_torch.parallel.mesh import use_mesh
    from keystone_tpu_torch.parallel.partitioner import last_partition_report, partition_disabled
    from keystone_tpu_torch.workflow.executor import PipelineEnv
    from keystone_tpu_torch.workflow.streaming import last_stream_report

    _mnist_start()
    t0 = time.perf_counter()
    shards = 8
    mesh, mesh1 = card_mesh(shards), card_mesh(1)
    rng = np.random.default_rng(0)
    n, d, k = 8 * shards, 32, 4
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = rng.normal(size=(n, k)).astype(np.float32)
    legs, lam = {}, 0.1

    def featurize_and_bcd(m):
        with use_mesh(m):
            ds = ArrayDataset(x, device=device).shard(m)
            feats = RandomSignNode.create(d, seed=0, device=device).apply_batch(ds)
            feats = LinearRectifier(0.0).apply_batch(PaddedFFT().apply_batch(feats))
            f = feats.data[:n]
            w = linalg.block_coordinate_descent(f, torch.as_tensor(y, device=device), lam, 30, 8, mesh=m)
            PipelineEnv.reset()
            est = BlockLeastSquaresEstimator(block_size=256, num_iter=1, reg=lam, device=device)
            pipe = est.with_data(ArrayDataset(f), ArrayDataset(y, device=device))
            preds = pipe.fit().apply_batch(ArrayDataset(f)).data
            eligible = [dec for dec in last_partition_report() if dec.kind == "fit" and dec.eligible]
        return f.double().cpu().numpy(), w, preds, eligible

    fh, w8, p8, eligible = featurize_and_bcd(mesh)
    _, w1, p1, _ = featurize_and_bcd(mesh1)
    df = fh.shape[1]
    fc, yc = fh - fh.mean(axis=0), y - y.mean(axis=0)
    w_c = np.linalg.solve(fc.T @ fc + lam * np.eye(df), fc.T @ yc)
    if not eligible:
        raise AssertionError("mesh_legs: the partition batch recorded no eligible fit decision")
    legs["featurize_and_bcd"] = {
        "bcd_vs_ridge_closed_form": _dryrun_check(
            "bcd", w8.cpu(), np.linalg.solve(fh.T @ fh + lam * np.eye(df), fh.T @ y), 5e-2),
        "exact_centered_preds_partitioned": _dryrun_check("exact", p8.cpu(), fc @ w_c + y.mean(axis=0), 5e-2),
        "bcd_vs_1_shard": _dryrun_check("bcd 8 vs 1", w8.cpu(), w1.cpu(), MESH_TOL),
        "preds_vs_1_shard": _dryrun_check("preds 8 vs 1", p8.cpu(), p1.cpu(), MESH_TOL),
        "decision": eligible[0].to_json(),
    }

    chunk = 8 * shards
    xs = np.random.default_rng(7).normal(size=(16 * chunk, 16)).astype(np.float32)
    ys = np.random.default_rng(8).normal(size=(16 * chunk, 3)).astype(np.float32)
    os.environ["KEYSTONE_STREAM_CHUNK_ROWS"] = str(chunk)

    def stream_preds(m, disabled):
        with use_mesh(m):
            PipelineEnv.reset()
            est = BlockLeastSquaresEstimator(block_size=8, num_iter=1, reg=0.1, device=device)
            pipe = LinearRectifier(0.0).to_pipeline().then_label_estimator(
                est, ArrayDataset(xs, device="cpu"), ArrayDataset(ys, device="cpu"))
            if disabled:
                with partition_disabled():
                    fitted = pipe.fit()
            else:
                fitted = pipe.fit()
            return fitted.apply_batch(ArrayDataset(xs[:32], device=device)).data.cpu()

    got = stream_preds(mesh, False)
    rep = last_stream_report()
    legs["partitioner_runtime"] = {
        "partitioned_fit_stream_vs_single_device": _dryrun_check("fit_stream", got, stream_preds(mesh1, True),
                                                                 MESH_TOL),
        "shards": rep.shards, "collective_bytes": rep.collective_bytes,
    }
    os.environ.pop("KEYSTONE_STREAM_CHUNK_ROWS", None)
    if rep.shards != shards:
        raise AssertionError(f"mesh_legs: the streamed fit ran {rep.shards} shards")

    mesh2d = card_mesh(shards, (shards // 2, 2), ("data", "model"))
    a2 = rng.normal(size=(4 * shards, 16)).astype(np.float32)
    y2 = rng.normal(size=(4 * shards, k)).astype(np.float32)
    w2 = linalg.block_coordinate_descent_2d(
        torch.as_tensor(a2, device=device), torch.as_tensor(y2, device=device), lam, 40, 4, mesh=mesh2d)
    applied = linalg.block_sharded_apply(torch.as_tensor(a2, device=device), w2, mesh=mesh2d)
    w2h = w2.double().cpu().numpy()
    legs["mesh2d_data_model"] = {
        "bcd2d_vs_ridge_closed_form": _dryrun_check(
            "bcd2d", w2h, np.linalg.solve(a2.T @ a2 + lam * np.eye(16), a2.T @ y2), 5e-2),
        "block_sharded_apply_vs_matmul": _dryrun_check("apply", applied.cpu(), a2.astype(np.float64) @ w2h, 1e-3),
    }

    labels = -np.ones((n, k), dtype=np.float32)
    labels[np.arange(n), rng.integers(0, k, n)] = 1.0

    def weighted(m):
        with use_mesh(m):
            pcw = PerClassWeightedLeastSquaresEstimator(block_size=16, num_iter=1, reg=0.1, mixture_weight=0.25)
            return pcw.fit(ArrayDataset(x, device=device), ArrayDataset(labels, device=device)).weights.cpu()

    rows_per_pair = 2
    demo = torch.arange(rows_per_pair * shards * shards * 4, dtype=torch.float32, device=device).reshape(-1, 4)
    shuffled = torch.cat(coll.all_to_all(list(demo.split(demo.shape[0] // shards)), mesh)).cpu()
    want = demo.cpu().numpy().reshape(shards, shards, rows_per_pair, 4).transpose(1, 0, 2, 3).reshape(demo.shape)
    legs["weighted_and_shuffle"] = {
        "perclass_weighted_vs_single_device": _dryrun_check("weighted", weighted(mesh), weighted(mesh1), 1e-3),
        "all_to_all_shard_transpose": _dryrun_check("all_to_all", shuffled, want, 1e-6),
    }

    xw = rng.normal(size=(8 * shards, 24)).astype(np.float32)
    yw = rng.normal(size=(8 * shards, k)).astype(np.float32)

    def host_stream(m):
        return linalg.block_coordinate_descent_streaming(xw, yw, 0.1, 2, 8, device=device, mesh=m)[0].cpu()

    legs["streaming_bcd"] = {
        "streaming_bcd_vs_single_device": _dryrun_check("streaming_bcd", host_stream(mesh), host_stream(mesh1),
                                                        MESH_TOL)}
    torch.cuda.synchronize()
    if bs.ell_matmul.launches:
        raise AssertionError(f"mesh_legs: the dense legs launched the ELL kernel {bs.ell_matmul.launches} times")

    # The hashing-TF slice's fit (phase 3's rows) under the 8-shard
    # ambient mesh: the block-sparse Gram ignores the mesh, so the ELL
    # kernel launches twice and the model predicts as the 1-shard fit.
    def slice_scores():
        model = BlockLeastSquaresEstimator(BLOCK_SIZE, num_iter=1, reg=REG, device=device).fit(
            slice_fit["rows"], slice_fit["y"])
        return scores(model, slice_fit["test"], device)

    reference = slice_scores()
    torch.cuda.synchronize()
    bs.ell_matmul.launches = 0
    with use_mesh(mesh):
        sharded_scores = slice_scores()
    torch.cuda.synchronize()
    sparse_launches = bs.ell_matmul.launches
    legs["block_sparse_slice"] = {"ell_launches": sparse_launches,
                                  "scores_vs_1_shard": rel_err(sharded_scores, reference)}
    counts = _mnist_end("mesh_legs", ell_allowed=True)
    log("mesh_legs", shards=shards, legs=legs, seconds=time.perf_counter() - t0, note=MESH_NOTE,
        dense_legs_ell_launches=0, **counts)
    if sparse_launches != 2 or not legs["block_sparse_slice"]["scores_vs_1_shard"] <= MESH_TOL:
        raise AssertionError(f"mesh_legs: block-sparse slice {legs['block_sparse_slice']}")
    return sparse_launches


# ------------------------------------------------------ multi-device, part 2

# shard_loss / sharded_durable: _bench_sharded's streamed size (8 host
# chunks of 8,192 × 768, k = 8) through LinearMapEstimator, the estimator
# of the JAX package's durable tests; the 2-D loss at _bench_sharded2d's
# width (d = 8,192) on a 2 × 4 layout, card-resident.
RECOVERY_TOL = 1e-5
DURABLE_CKPT_CHUNKS, DURABLE_CRASH_CALL = 2, 5  # commits after 2, 4, 6; the 5th dispatch dies
# mesh_estimators: KRR at kernel_ridge's widths and rows; PCA at VOC's
# SIFT descriptor width (128 → desc_dim 80) on voc_cli's 10^5 PCA
# samples; one conv-block epoch at the CIFAR reference's 10,000 filters
# on MESH_CONV_IMAGES images (rows cut from 50,000: depth); the flagship's
# encode on MESH_ENCODE_BUCKETS buckets of MESH_ENCODE_ROWS images at its
# widths (not a multiple of 8: pad rows dropped).
MESH_PCA_ROWS, MESH_PCA_WIDTH, MESH_PCA_DIMS = 100_000, 128, 80
# The PCA gate: components are eigenvectors of a float32 Gram whose
# relative eigengaps near component 80 are ~1.6%, so 8 shards against 1
# move them by round-off over the gap: the card read 7.2e-5 on the whole
# matrix on an H100 (a CPU 6.7e-6; PERF.md); the gate is on the whole
# matrix at 1e-4.
MESH_PCA_TOL = 1e-4
# The KRR gate: each float32 fit of kernel_ridge's problem is itself
# ~1e-4 from float64 (8.0e-5 on an H100; the first block's K + λI
# has condition 4.8e4), so another grouping of the panel products and the
# residual's sum moves the scores by as much: 8 shards against 1 read
# 5.6e-5–9.9e-5 on an H100 (PERF.md). The gate is kernel_ridge's
# own float64 bound.
MESH_KRR_TOL = KRR_FP64_TOL
MESH_CONV_IMAGES = 2048
MESH_ENCODE_BUCKETS, MESH_ENCODE_ROWS = 3, 60
# tune_shards: the JAX CLI's default stream shape, the stream grid whole
# (chunk sizes up to rows / 2: 5 × 2 prefetch depths × shards [1, 8] = 20
# candidates; the budget of 24 leaves none out).
TUNE_SHARDS_FLAGS = ["--rows", "8192", "--dim", "256", "--classes", "4", "--budget", "24", "--time-budget-s", "120"]
# rehearsal_card: two processes, 4 shards of the card each, on gloo.
REHEARSAL_SHARDS, REHEARSAL_TOL, REHEARSAL_DEVICE = 4, 1e-5, "cuda"
MESH_STASH: dict = {}


def _stream_problem_host():
    """The streamed legs' host rows (65,536 × 768, k = 8), drawn once."""
    if "stream" not in MESH_STASH:
        chunk, d, k = SHARDED_STREAM
        rng = np.random.default_rng(56)
        x = rng.normal(size=(8 * chunk, d)).astype(np.float32)
        y = (x[:, :k] + 0.1 * rng.normal(size=(8 * chunk, k))).astype(np.float32)
        MESH_STASH["stream"] = (x, y)
    return MESH_STASH["stream"]


def _recovery_fit(device, x, y, probe, shards, faults=(), one_device=False):
    """One ``Pipeline.fit`` of LinearRectifier → LinearMapEstimator over
    ``shards`` shards of the card (or with partitioning off): the probe
    rows' predictions, the stream report and the wall."""
    import torch

    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.learning.linear import LinearMapEstimator
    from keystone_tpu_torch.ops.stats.core import LinearRectifier
    from keystone_tpu_torch.parallel.mesh import use_mesh
    from keystone_tpu_torch.parallel.partitioner import partition_disabled
    from keystone_tpu_torch.reliability.faultinject import injected
    from keystone_tpu_torch.workflow.executor import PipelineEnv
    from keystone_tpu_torch.workflow.streaming import last_stream_report

    store = PipelineEnv.get_or_create().checkpoint
    PipelineEnv.reset()
    if store is not None:
        PipelineEnv.get_or_create().checkpoint = store
    pipe = LinearRectifier(0.0).to_pipeline().then_label_estimator(
        LinearMapEstimator(reg=1e-2, device=device), x, y)
    torch.cuda.synchronize()
    t = time.perf_counter()
    with use_mesh(card_mesh(shards)), injected(*faults), \
            (partition_disabled() if one_device else contextlib.nullcontext()):
        fitted = pipe.fit()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return fitted.apply_batch(ArrayDataset(probe)).data.clone(), last_stream_report(), wall


def _recovery_line(report, wall, preds, ref) -> dict:
    return {"shard_losses": report.shard_losses, "shards": report.shards, "model_shards": report.model_shards,
            "reingested_chunks": report.reingested_chunks, "resumed_from_chunk": report.resumed_from_chunk,
            "chunks": report.chunks, "checkpoints": report.checkpoints, "wall_s": wall,
            "vs_uninterrupted_rel": rel_err(preds, ref)}


def phase_shard_loss(device) -> int:
    """Phase 56: seeded shard losses mid-fold, each against the
    uninterrupted 8-shard fold of the same rows: the last shard, the
    seed-bearing shard 0, two losses in turn, and a loss on the model
    axis of a 2 × 4 layout at d = 8,192."""
    import torch

    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.obs import names
    from keystone_tpu_torch.reliability.faultinject import FaultSpec

    _mnist_start()
    t0 = time.perf_counter()
    chunk, d, k = SHARDED_STREAM
    hx, hy = _stream_problem_host()
    x, y = ArrayDataset(hx, device="cpu"), ArrayDataset(hy, device="cpu")
    probe = torch.as_tensor(hx[:64], device=device)
    os.environ["KEYSTONE_STREAM_CHUNK_ROWS"] = str(chunk)
    losses_before = names.metric(names.DURABLE_SHARD_LOSSES).value()
    ref, ref_report, ref_wall = _recovery_fit(device, x, y, probe, 8)
    legs = {"uninterrupted": _recovery_line(ref_report, ref_wall, ref, ref)}
    cases = (("last_shard", None, (4,), (1, 7)), ("seed_shard_0", "0", (4,), (1, 7)),
             ("two_losses", None, (2, 6), (2, 6)))
    failed = []
    for name, index, calls, (losses, shards) in cases:
        if index is None:
            os.environ.pop("KEYSTONE_SHARD_LOSS_INDEX", None)
        else:
            os.environ["KEYSTONE_SHARD_LOSS_INDEX"] = index
        preds, report, wall = _recovery_fit(
            device, x, y, probe, 8, (FaultSpec(match="parallel.shard_loss", kind="transient", calls=calls),))
        legs[name] = _recovery_line(report, wall, preds, ref)
        if (report.shard_losses, report.shards) != (losses, shards) or not report.reingested_chunks \
                or not legs[name]["vs_uninterrupted_rel"] <= RECOVERY_TOL:
            failed.append(name)
    os.environ.pop("KEYSTONE_SHARD_LOSS_INDEX", None)

    # The model axis of a 2 × 4 layout: flat shard 7 is (row 1, column 3).
    n2, d2, k2, chunk2 = SHARDED2D
    g = torch.Generator(device=device).manual_seed(56)
    x2 = ArrayDataset(torch.randn(n2, d2, device=device, generator=g))
    y2 = ArrayDataset(torch.randn(n2, k2, device=device, generator=g))
    probe2 = x2.data[:64]
    os.environ.update({"KEYSTONE_STREAM_CHUNK_ROWS": str(chunk2), "KEYSTONE_PARTITION_MIN_WIDTH": "64",
                       "KEYSTONE_PARTITION_MODEL_SHARDS": "4"})
    ref2, rep2, wall2 = _recovery_fit(device, x2, y2, probe2, 8)
    legs["2x4_uninterrupted"] = _recovery_line(rep2, wall2, ref2, ref2)
    preds2, rep2, wall2 = _recovery_fit(
        device, x2, y2, probe2, 8, (FaultSpec(match="parallel.shard_loss", kind="transient", calls=(3,)),))
    legs["2x4_model_axis"] = _recovery_line(rep2, wall2, preds2, ref2)
    if legs["2x4_uninterrupted"]["model_shards"] != 4 or (rep2.shard_losses, rep2.shards, rep2.model_shards) \
            != (1, 7, 1) or not legs["2x4_model_axis"]["vs_uninterrupted_rel"] <= RECOVERY_TOL:
        failed.append("2x4_model_axis")
    for key in ("KEYSTONE_STREAM_CHUNK_ROWS", "KEYSTONE_PARTITION_MIN_WIDTH", "KEYSTONE_PARTITION_MODEL_SHARDS"):
        os.environ.pop(key, None)
    del x2, y2, probe2, ref2, preds2
    torch.cuda.empty_cache()
    counted = names.metric(names.DURABLE_SHARD_LOSSES).value() - losses_before
    if counted != 5:
        failed.append(f"shard_losses_metric_{counted}")
    counts = _mnist_end("shard_loss")
    log("shard_loss", stream={"n": 8 * chunk, "d": d, "k": k, "chunk_rows": chunk},
        wide={"n": n2, "d": d2, "k": k2, "chunk_rows": chunk2, "layout": "2x4"}, legs=legs,
        shard_losses_counted=counted, tol=RECOVERY_TOL, note=MESH_NOTE, seconds=time.perf_counter() - t0,
        failed=failed, **counts)
    if failed:
        raise AssertionError(f"shard_loss failed {failed}")
    return counts["ell_launches"]


def phase_sharded_durable(device) -> int:
    """Phase 57: the 8-shard streamed fold with a checkpoint store,
    stopped by an injected fault at its 5th chunk, resumed on 8 shards
    and, from the same stopped state, on one device; both against the
    uninterrupted fold."""
    import shutil

    import torch

    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.reliability import enable_checkpointing
    from keystone_tpu_torch.reliability.faultinject import FaultSpec
    from keystone_tpu_torch.workflow.executor import PipelineEnv

    _mnist_start()
    t0 = time.perf_counter()
    chunk, d, k = SHARDED_STREAM
    hx, hy = _stream_problem_host()
    x, y = ArrayDataset(hx, device="cpu"), ArrayDataset(hy, device="cpu")
    probe = torch.as_tensor(hx[:64], device=device)
    os.environ.update({"KEYSTONE_STREAM_CHUNK_ROWS": str(chunk), "KEYSTONE_STREAM_CKPT_CHUNKS": str(DURABLE_CKPT_CHUNKS)})
    work = tempfile.TemporaryDirectory(prefix="keystone-sharded-durable-")
    legs, failed = {}, []
    try:
        ref, report, wall = _recovery_fit(device, x, y, probe, 8)
        legs["uninterrupted"] = _recovery_line(report, wall, ref, ref)
        crash = FaultSpec(match="streaming.chunk", kind="transient", calls=(DURABLE_CRASH_CALL,))
        stopped = os.path.join(work.name, "stopped")
        for name, one_device in (("resumed_8_shards", False), ("resumed_one_device", True)):
            store_dir = os.path.join(work.name, name)
            PipelineEnv.reset()
            enable_checkpointing(store_dir, device=device)
            try:
                _recovery_fit(device, x, y, probe, 8, (crash,))
                failed.append(f"{name}_not_stopped")
            except ConnectionError:
                pass
            if name == "resumed_8_shards":
                shutil.copytree(store_dir, stopped)
            PipelineEnv.reset()
            enable_checkpointing(store_dir, device=device)
            preds, report, wall = _recovery_fit(device, x, y, probe, 8, one_device=one_device)
            legs[name] = _recovery_line(report, wall, preds, ref)
            want_shards = 1 if one_device else 8
            if report.resumed_from_chunk != 4 or report.shards != want_shards or report.chunks != 4 \
                    or not legs[name]["vs_uninterrupted_rel"] <= RECOVERY_TOL:
                failed.append(name)
        legs["stopped_store_files"] = sorted(os.listdir(stopped))
    finally:
        PipelineEnv.reset()
        for key in ("KEYSTONE_STREAM_CHUNK_ROWS", "KEYSTONE_STREAM_CKPT_CHUNKS"):
            os.environ.pop(key, None)
        work.cleanup()
    counts = _mnist_end("sharded_durable")
    log("sharded_durable", n=8 * chunk, d=d, k=k, chunk_rows=chunk, ckpt_chunks=DURABLE_CKPT_CHUNKS,
        crash_at_dispatch=DURABLE_CRASH_CALL, legs=legs, tol=RECOVERY_TOL, seconds=time.perf_counter() - t0,
        failed=failed, **counts)
    if failed:
        raise AssertionError(f"sharded_durable failed {failed}")
    return counts["ell_launches"]


def _timed_on_shards(fn, shards, mesh=None):
    """``fn()`` under a mesh of ``shards`` shards of the card: its result,
    wall and peak."""
    import torch

    from keystone_tpu_torch.parallel.mesh import use_mesh

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with use_mesh(mesh if mesh is not None else card_mesh(shards)):
        out = fn()
    torch.cuda.synchronize()
    return out, {"wall_s": time.perf_counter() - t, "peak_device_bytes": torch.cuda.max_memory_allocated()}


def phase_mesh_estimators(device) -> int:
    """Phase 58: the estimators' mesh paths, 8 shards against 1: KRR at
    kernel_ridge's widths on 8 × 1 and on a 2 × 4 hybrid mesh (fit and
    ring apply), the TSQR PCA at VOC's descriptor width, one conv-block
    epoch at the CIFAR reference's 10,000 filters, and the flagship's
    encode over a few buckets."""
    import torch

    from keystone_tpu_torch.data.dataset import ArrayDataset
    from keystone_tpu_torch.ops.learning.conv_block import ConvBlockLeastSquaresEstimator
    from keystone_tpu_torch.ops.learning.pca import DistributedPCAEstimator
    from keystone_tpu_torch.parallel import collectives as coll
    from keystone_tpu_torch.pipelines.imagenet_streaming import _synth_images

    _mnist_start()
    t0 = time.perf_counter()
    legs, failed = {}, []

    def compare(name, run, tol, meshes):
        out = {}
        ref, out["1"] = _timed_on_shards(run, 1)
        for label, mesh in meshes:
            calls = dict(coll.calls)
            got, out[label] = _timed_on_shards(run, 8, mesh)
            out[label]["collective_calls"] = {c: coll.calls[c] - calls[c] for c in calls if coll.calls[c] > calls[c]}
            out[label]["vs_1_shard_rel"] = rel_err(got, ref)
            if not out[label]["vs_1_shard_rel"] <= tol or not out[label]["collective_calls"]:
                failed.append(f"{name}_{label}")
        out["tol"] = tol
        legs[name] = out
        return ref

    # KRR: the fit and the apply's scores on the test rows.
    x, y, _labels = krr_problem()
    xd = torch.as_tensor(x, device=device)
    train, test = ArrayDataset(xd[:KRR_N]), xd[KRR_N:]
    labels = ArrayDataset(torch.as_tensor(y[:KRR_N], device=device))

    def krr():
        return _krr(KRR_BLOCK, device).fit(train, labels).apply_arrays(test)

    compare("krr", krr, MESH_KRR_TOL, (("8x1", card_mesh(8)), ("2x4_hybrid", card_hybrid_mesh(2, 8))))
    legs["krr"].update(n=KRR_N, test=KRR_TEST, d=KRR_D, k=KRR_K, block=KRR_BLOCK)
    del xd, train, test, labels

    # PCA at VOC's SIFT width: a spectrum of scales 1…128.
    rng = np.random.default_rng(58)
    z = rng.normal(size=(MESH_PCA_ROWS, MESH_PCA_WIDTH)) * np.arange(1, MESH_PCA_WIDTH + 1)
    q, _ = np.linalg.qr(rng.normal(size=(MESH_PCA_WIDTH, MESH_PCA_WIDTH)))
    descriptors = ArrayDataset(torch.as_tensor((z @ q.T).astype(np.float32), device=device))
    compare("pca", lambda: DistributedPCAEstimator(MESH_PCA_DIMS).fit(descriptors).components, MESH_PCA_TOL,
            (("8x1", card_mesh(8)),))
    legs["pca"].update(n=MESH_PCA_ROWS, d=MESH_PCA_WIDTH, dims=MESH_PCA_DIMS)
    del descriptors

    # One conv-block epoch at 10,000 filters (20 blocks of 512).
    filters, cifar_labels, crng = cifar_reference_draws()
    fz = cifar_featurizer(filters, device)
    images = ArrayDataset(torch.as_tensor(crng.random((MESH_CONV_IMAGES, 32, 32, 3), dtype=np.float32),
                                          device=device))
    targets = ArrayDataset(torch.as_tensor(cifar_labels[:MESH_CONV_IMAGES], device=device))
    probe = images.data[:256]

    def conv():
        model = ConvBlockLeastSquaresEstimator(fz, block_size=CIFAR_SOLVER_BLOCK, num_iter=1, reg=CIFAR_REG,
                                               image_chunk=CIFAR_CHUNK, device=device).fit(images, targets)
        return model.apply_arrays(probe)

    compare("conv_block", conv, MESH_TOL, (("8x1", card_mesh(8)),))
    legs["conv_block"].update(images=MESH_CONV_IMAGES, filters=CIFAR_FILTERS, feature_width=8 * CIFAR_FILTERS,
                              solver_block=CIFAR_SOLVER_BLOCK)
    del fz, images, targets, probe
    torch.cuda.empty_cache()

    # The flagship's encode over buckets whose rows are not a multiple of 8.
    fs = MESH_STASH.pop("flagship")
    gen = torch.Generator(device=device).manual_seed(58)
    buckets = []
    for b in range(MESH_ENCODE_BUCKETS):
        lab = torch.arange(MESH_ENCODE_ROWS, device=device) % STREAM_CLASSES
        buckets.append({"image": _synth_images(lab, STREAM_SIZE, gen).cpu().numpy(),
                        "dims": np.full((MESH_ENCODE_ROWS, 2), STREAM_SIZE, np.int32)})
    plain = fs.encode_buckets(iter(buckets))
    sharded, timing = _timed_on_shards(lambda: fs.encode_buckets(iter(buckets), mesh=card_mesh(8)), 8)
    encode_rel = rel_err(torch.from_numpy(sharded), torch.from_numpy(plain)) if sharded.shape == plain.shape else None
    legs["encode"] = {"buckets": MESH_ENCODE_BUCKETS, "rows_per_bucket": MESH_ENCODE_ROWS, "size": STREAM_SIZE,
                      "fv_dim": int(plain.shape[1]), "8x1": {**timing, "vs_1_shard_rel": encode_rel},
                      "tol": MESH_TOL}
    if encode_rel is None or not encode_rel <= MESH_TOL:
        failed.append("encode")
    del fs, buckets
    torch.cuda.empty_cache()
    counts = _mnist_end("mesh_estimators")
    log("mesh_estimators", legs=legs, note=MESH_NOTE, seconds=time.perf_counter() - t0, failed=failed, **counts)
    if failed:
        raise AssertionError(f"mesh_estimators failed {failed}")
    return counts["ell_launches"]


def phase_serving_partition(device, artifact: str, rows: np.ndarray, want: np.ndarray) -> int:
    """Phase 59: phase 6's MNIST artifact behind a ``PipelineServer`` on an
    8-shard mesh of the card: the registry's load and the warmup attach
    one serving decision, every divisible batch is applied shard by shard,
    and the answers equal the unsharded server's, with nothing dropped."""
    from concurrent.futures import wait

    from keystone_tpu_torch.obs import names
    from keystone_tpu_torch.parallel.mesh import use_mesh
    from keystone_tpu_torch.serving import ModelRegistry, PipelineServer, ServingConfig
    from keystone_tpu_torch.serving.config import default_bucket_sizes

    _mnist_start()
    t0 = time.perf_counter()
    config = ServingConfig(max_batch=64, max_wait_ms=2.0, queue_depth=4096)
    buckets = list(default_bucket_sizes(config.max_batch))
    decisions = names.metric(names.PARTITION_DECISIONS)

    def serve(shards):
        with use_mesh(card_mesh(shards)):
            before = decisions.value(kind="serve", eligible="1")
            registry = ModelRegistry()
            registry.load_fitted("mnist", artifact, device=device, buckets=buckets, warmed_buckets=buckets)
            server = PipelineServer(config=config, registry=registry, name="mnist", device=device)
            server.start()
            try:
                warm = server.warmup(rows[0])
                server.warmup(rows[0])  # a second attach: one decision all the same
                t = time.perf_counter()
                futures = [server.submit(r) for r in rows]
                wait(futures, timeout=120)
                wall = time.perf_counter() - t
                labels = _served_labels(futures)
                stats = server.stats()
            finally:
                server.stop()
            handle = registry.resolve("mnist").model.compiled_apply()
            return labels, {
                "decision": warm.get("partition_decisions", {}).get("mnist"),
                "decisions_recorded": decisions.value(kind="serve", eligible="1") - before,
                "sharded_batches": handle.sharded_calls, "batches": stats["batches"],
                "served": stats["served"], "dropped": stats["sheds"] + stats["timeouts"] + stats["failures"],
                "wall_s": wall, "requests_per_s": len(rows) / wall}

    plain_labels, plain = serve(1)
    labels, sharded = serve(8)
    _check_labels("serving_partition unsharded", plain_labels, want, np.zeros((len(rows), 2)))
    _check_labels("serving_partition sharded", labels, plain_labels, np.zeros((len(rows), 2)))
    counts = _mnist_end("serving_partition")
    log("serving_partition", requests=len(rows), buckets=buckets, unsharded=plain, sharded=sharded,
        answers_equal=bool((labels == plain_labels).all()), seconds=time.perf_counter() - t0, **counts)
    checks = {
        "decision": (sharded["decision"] or {}).get("eligible") is True and sharded["decision"]["shards"] == 8,
        "one_decision": sharded["decisions_recorded"] == 1 and plain["decisions_recorded"] == 0,
        "sharded_batches": sharded["sharded_batches"] > 0 and plain["sharded_batches"] == 0,
        "nothing_dropped": sharded["dropped"] == 0 and sharded["served"] >= len(rows),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"serving_partition failed {failed}")
    return counts["ell_launches"]


def phase_tune_shards(device) -> int:
    """Phase 60: ``tune --tasks stream`` under an 8-shard mesh of the card:
    candidates at shards 1 and 8, each with the shard count that ran, and
    the persisted winner with its shard count."""
    from keystone_tpu_torch.obs import store
    from keystone_tpu_torch.parallel.mesh import use_mesh

    _mnist_start()
    t0 = time.perf_counter()
    saved = os.environ.get("KEYSTONE_PROFILE_STORE")
    work = tempfile.TemporaryDirectory(prefix="keystone-tune-shards-")
    os.environ["KEYSTONE_PROFILE_STORE"] = os.path.join(work.name, "tuned.jsonl")
    store.set_store(None)
    try:
        with use_mesh(card_mesh(8)):
            rc, out = _cli(["tune", "--tasks", "stream", *TUNE_SHARDS_FLAGS, "--device", str(device)])
        task = out["TUNE_JSON"]["tasks"]["stream"]
        entries = {k: m for k, _s, m in store.get_store().entries(key_prefix="stream:") if m.get("source") == "tune"}
    finally:
        if saved is None:
            os.environ.pop("KEYSTONE_PROFILE_STORE", None)
        else:
            os.environ["KEYSTONE_PROFILE_STORE"] = saved
        store.set_store(None)
        work.cleanup()
    measured = [{"knobs": m["knobs"], "rows_per_s": m["objective"], "shards_actual": m.get("shards_actual"),
                 "chunk_rows_actual": m.get("chunk_rows_actual")} for m in task["measured"]]
    winner = task["winner"]
    ran = next((m for m in measured if m["knobs"] == winner), None)
    # The winner's own entry, by the chunk rows, prefetch depth and shard
    # count that ran, and the store's best entry, which the knob rule replays.
    suffix = ran and f":cr{ran['chunk_rows_actual']}:p{winner['prefetch']}:s{ran['shards_actual']}"
    persisted = next((e for k, e in entries.items() if suffix and k.endswith(suffix)), None)
    best = max(entries.values(), key=lambda e: e["rows_per_s"], default=None)
    counts = _mnist_end("tune_shards")
    log("tune_shards", measured=measured, winner=winner, winner_objective=task["winner_objective"],
        persisted_winner=persisted, best_persisted=best, entries=len(entries), candidates=len(measured),
        seconds=time.perf_counter() - t0, **counts)
    checks = {
        "exit_0": rc == 0,
        "both_shard_counts": {m["knobs"]["shards"] for m in measured} == {1, 8},
        "shards_actual": all(m["shards_actual"] == m["knobs"]["shards"] for m in measured),
        "one_entry_per_candidate": len(entries) == len(measured),
        "winner_persisted_with_shards": bool(persisted) and persisted is best
        and (persisted["shards"], persisted["prefetch_depth"], persisted["chunk_rows"])
        == (ran["shards_actual"], winner["prefetch"], ran["chunk_rows_actual"]),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"tune_shards failed {failed}")
    return counts["ell_launches"]


def start_rehearsal_card() -> dict:
    """Phase 61's two rehearsal processes, started at once and early (as
    ``check_card`` starts its CLIs), so that their torch and CUDA starts
    overlap the in-process phases 56–60; :func:`phase_rehearsal_card`
    joins them."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs = {
        i: subprocess.Popen(
            [sys.executable, "-m", "keystone_tpu_torch.parallel.rehearsal", "--coordinator", f"127.0.0.1:{port}",
             "--num-hosts", "2", "--host-id", str(i), "--local-shards", str(REHEARSAL_SHARDS),
             "--device", REHEARSAL_DEVICE, "--backend", "gloo"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for i in (0, 1)
    }
    return {"procs": procs, "t0": time.perf_counter(), "port": port}


def phase_rehearsal_card(started: dict) -> int:
    """Phase 61: two processes join a gloo group on the card (NCCL refuses
    two ranks on one GPU), each holding 4 shards of its half of the known
    matrix; the sharded Gram crosses them and matches the closed form."""
    runs, failed = {}, []
    try:
        for i, proc in started["procs"].items():
            out, err = proc.communicate(timeout=300)
            line = next((ln for ln in out.splitlines() if ln.startswith("REHEARSAL_OK")), None)
            fields = dict(kv.split("=") for kv in line.split()[1:]) if line else {}
            runs[i] = {"rc": proc.returncode, "line": line, "host": next(
                (ln for ln in out.splitlines() if ln.startswith("host ")), None),
                "wall_s": time.perf_counter() - started["t0"]}
            if proc.returncode != 0 or not line or not float(fields["rel_err"]) <= REHEARSAL_TOL \
                    or fields.get("mode") != "gloo":
                runs[i]["stderr"] = err[-1500:]
                failed.append(f"process_{i}")
    finally:
        for proc in started["procs"].values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log("rehearsal_card", processes=2, local_shards=REHEARSAL_SHARDS, backend="gloo", runs=runs,
        tol=REHEARSAL_TOL, seconds=time.perf_counter() - started["t0"], failed=failed)
    if failed:
        raise AssertionError(f"rehearsal_card failed {failed}")
    return 0


def card_name_and_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # A store of this run's own: a tuned threshold left in ~/.cache by an
    # earlier run must not change this run's dispatch.
    store_dir = tempfile.TemporaryDirectory(prefix="keystone-profile-store-")
    os.environ["KEYSTONE_PROFILE_STORE"] = os.path.join(store_dir.name, "profile-store.jsonl")
    os.environ["KEYSTONE_BLOCKSPARSE_BLOCK"] = "16x16"
    os.environ.pop("KEYSTONE_BLOCKSPARSE_THRESHOLD", None)
    os.environ.pop("KEYSTONE_BLOCKSPARSE", None)
    # Importing the port must leave PyTorch's precision flags as it
    # found them: the solvers pin precision per call.
    flags_before = _precision_flags()
    import keystone_tpu_torch.parallel.linalg  # noqa: F401

    flags_around_import = (flags_before, _precision_flags())
    log("precision_flags", before_import=flags_around_import[0], after_import=flags_around_import[1])
    if flags_around_import[0] != flags_around_import[1]:
        raise AssertionError(f"importing the port changed {flags_around_import}")

    device = torch.device("cuda")
    t0 = time.perf_counter()
    _install_verify_recorder()
    phase_build()
    kernel = phase_kernels(device)
    kernel["launches"], slice_fit = phase_slice(device)
    launches_by_path = {"hashing_tf": kernel["launches"], "mnist_default": phase_mnist_default(device)}
    fitted, test = phase_mnist_full(device)
    launches_by_path["mnist_full"] = 0  # phase_mnist_full raises otherwise
    # The saved artifact lives until the fleet phases serve it again.
    artifact_dir = tempfile.TemporaryDirectory(prefix="keystone-fleet-")
    artifact = os.path.join(artifact_dir.name, "mnist_fitted.pt")
    launches_by_path["serve_mnist"], fleet_rows, fleet_want = phase_serve_mnist(device, fitted, test, artifact)
    del fitted, test
    launches_by_path["mnist_small_cpu"] = phase_mnist_small_cpu(device)
    launches_by_path["stream_fit"] = phase_stream_fit(device)
    launches_by_path["solver_precision"] = phase_solver_precision(device, flags_around_import)
    binding = phase_gram_modes(device)
    launches_by_path["gram_modes"] = 0
    launches_by_path["timit_exact"] = phase_timit_exact(device)
    launches_by_path["timit_wide_block"] = phase_timit_wide_block(device)
    launches_by_path["timit"] = phase_timit(device)
    host_problem = phase_host_streaming_bcd(device)
    launches_by_path["host_streaming_bcd"] = 0  # phase_host_streaming_bcd raises otherwise
    launches_by_path["reliability"] = phase_reliability(device, host_problem, slice_fit)
    del host_problem
    launches_by_path["solver_ladder"] = phase_solver_ladder(device)
    launches_by_path["least_squares_ladder"] = phase_least_squares_ladder(device, slice_fit)
    launches_by_path["newsgroups"] = phase_newsgroups(device)
    launches_by_path["amazon_reviews"] = phase_amazon_reviews(device)
    launches_by_path["sketched"] = phase_sketched(device)
    launches_by_path["timit_sketched"] = phase_timit_sketched(device)
    launches_by_path["kernel_ridge"] = phase_kernel_ridge(device)
    launches_by_path["cifar_features"] = phase_cifar_features(device)
    launches_by_path["cifar_random_patch_fused"] = phase_cifar_random_patch_fused(device)
    launches_by_path["cifar_workloads"] = phase_cifar_workloads(device)
    from keystone_tpu_torch import native

    decode_available = native.has_header("jpeglib.h")
    print("native_decode: " + ("available (jpeglib.h)" if decode_available else "unavailable (no jpeglib.h)"),
          flush=True)
    if not native.has_openmp():
        # The compiler has no OpenMP runtime: the native kernels build
        # single-threaded, asked for explicitly (their results are equal).
        os.environ["KEYSTONE_NATIVE_OPENMP"] = "off"
        print("native_openmp: unavailable (no libgomp): KEYSTONE_NATIVE_OPENMP=off", flush=True)
    use_native = None if decode_available else False
    VOC_FLAGS["use_native"] = VOC_CLI_FLAGS["use_native"] = use_native
    voc_dir = tempfile.TemporaryDirectory(prefix="keystone-voc-")
    t_voc = time.perf_counter()
    voc_paths, voc_blobs, voc_labels = write_voc_data(voc_dir.name)
    log("voc_data", seconds=time.perf_counter() - t_voc,
        tar_bytes={k: os.path.getsize(v) for k, v in voc_paths.items()})
    launches_by_path["voc"] = phase_voc(device, voc_paths, voc_blobs, voc_labels)
    launches_by_path["voc_cli"] = phase_voc_cli(device, voc_paths)
    launches_by_path["native_host"] = phase_native_host(device, voc_blobs, decode_available)
    del voc_blobs
    voc_dir.cleanup()
    imagenet_dir = tempfile.TemporaryDirectory(prefix="keystone-imagenet-")
    t_gen = time.perf_counter()
    imagenet_paths, imagenet_blobs, imagenet_labels = write_imagenet_data(imagenet_dir.name)
    log("imagenet_data", seconds=time.perf_counter() - t_gen,
        tar_bytes={k: os.path.getsize(v) for k, v in imagenet_paths.items()})
    launches_by_path["imagenet"] = phase_imagenet(device, imagenet_paths, imagenet_blobs, imagenet_labels,
                                                  use_native)
    del imagenet_blobs
    launches_by_path["imagenet_cli"] = phase_imagenet_cli(device, imagenet_paths, use_native)
    launches_by_path["imagenet_native"], native_buckets = phase_imagenet_native(device, imagenet_paths)
    launches_by_path["imagenet_streaming_ondevice"] = phase_imagenet_streaming_ondevice(device)
    launches_by_path["imagenet_native_streaming"] = phase_imagenet_native_streaming(
        device, imagenet_paths, use_native, native_buckets)
    launches_by_path["imagenet_streaming_cli"] = phase_imagenet_streaming_cli(device, imagenet_paths, use_native)
    launches_by_path["warm_flagship"] = phase_warm_flagship(device)
    launches_by_path["stupid_backoff"] = phase_stupid_backoff(device)
    imagenet_dir.cleanup()
    durable_dir = tempfile.TemporaryDirectory(prefix="keystone-durable-")
    durable = phase_durable_fit(device, durable_dir.name)
    launches_by_path["durable_fit"] = durable["ell_launches"]
    launches_by_path["serve_checkpoint"] = phase_serve_checkpoint(device, durable, durable_dir.name)
    launches_by_path["refit_cli"] = phase_refit_cli(device, durable_dir.name)
    heads = phase_refit_full(device, durable_dir.name)
    launches_by_path["refit_full"] = 0  # phase_refit_full raises otherwise
    durable_dir.cleanup()
    fleet_dir = tempfile.TemporaryDirectory(prefix="keystone-fleet-work-")
    serve = phase_fleet_serve(device, artifact, fleet_rows, fleet_want)
    launches_by_path["fleet_serve"] = serve["ell_launches"]
    launches_by_path["fleet_elastic"] = phase_fleet_elastic(device, artifact, fleet_rows, fleet_want, serve,
                                                            fleet_dir.name)
    launches_by_path["fleet_publish"] = phase_fleet_publish(device, heads, fleet_dir.name)
    del heads
    fleet_dir.cleanup()
    t_new = time.perf_counter()
    phase_roofline_probe(device)
    launches_by_path["roofline_probe"] = 0  # phase_roofline_probe raises otherwise
    launches_by_path["explain_card"] = phase_explain_card(device, kernel)
    launches_by_path["tune_card"] = phase_tune_card(device)
    launches_by_path["profile_card"] = phase_profile_card(device)
    launches_by_path["cosched"] = phase_cosched(device, artifact)
    launches_by_path["check_card"] = phase_check_card(device, artifact)
    launches_by_path["trace_fleet"] = phase_trace_fleet(device)
    phase_obs_cli({name: {k: v for k, v in PHASE_LINES[name].items() if not isinstance(v, list)}
                   for name in ("roofline_probe", "profile_card", "cosched")})
    log("control_plane_phases", seconds=time.perf_counter() - t_new)
    t_mesh = time.perf_counter()
    launches_by_path["mesh_collectives"] = phase_mesh_collectives(device)
    launches_by_path["sharded"] = phase_sharded(device)
    launches_by_path["sharded2d"] = phase_sharded2d(device)
    launches_by_path["mesh_legs"] = phase_mesh_legs(device, slice_fit)
    del slice_fit
    log("mesh_phases", seconds=time.perf_counter() - t_mesh)
    t_mesh2 = time.perf_counter()
    # Started after the first mesh phases, so that their starts share the
    # host and the card with none of those timings; they overlap the
    # in-process phases below.
    rehearsal = start_rehearsal_card()
    launches_by_path["shard_loss"] = phase_shard_loss(device)
    launches_by_path["sharded_durable"] = phase_sharded_durable(device)
    launches_by_path["mesh_estimators"] = phase_mesh_estimators(device)
    launches_by_path["serving_partition"] = phase_serving_partition(device, artifact, fleet_rows, fleet_want)
    artifact_dir.cleanup()
    launches_by_path["tune_shards"] = phase_tune_shards(device)
    launches_by_path["rehearsal_card"] = phase_rehearsal_card(rehearsal)
    log("mesh_phases_part_2", seconds=time.perf_counter() - t_mesh2)
    log_verify_run()
    # The binding's calls on the paths (gram_modes times it and is left out).
    paths = {p: c for p, c in SOLVER_GEMM_CALLS.items() if p != "gram_modes"}
    binding["launches"] = {k: sum(c[k] for c in paths.values()) for k in next(iter(paths.values()))}
    binding["launches_by_path"] = paths
    launches_by_path["gram_bsr"] = kernel.pop("gram_bsr_launches")
    kernel["launches_by_path"] = launches_by_path
    smi = card_name_and_limit()
    log("done", seconds=time.perf_counter() - t0)
    print(json.dumps({"library_bindings": [binding]}))
    print(json.dumps({"kernels": [kernel]}))
    print(smi)
    store_dir.cleanup()
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
