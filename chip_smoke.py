#!/usr/bin/env python3
"""Drive the PyTorch port (``torchmetrics_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one JSON line (a failure raises and exits non-zero):

1. ``device``: the card's name and power limit (``nvidia-smi``) and the CUDA version.
2. ``build``: compile the CUDA kernels from ``torchmetrics_tpu_torch/ops/csrc/``.
3. ``kernels``: each kernel against its plain PyTorch version on a CPU copy, at stress
   shapes and at the shapes the main path gives it, with its time, its bound, the
   plain version's time, where one PyTorch call computes the same function that
   call's time, and the launches the check and timing made. Counts must be equal;
   the weighted bincount's float rows must agree within WEIGHTED_RTOL, the SSIM
   moments within MOMENTS_ATOL (with NaN where the plain version has it). Each
   confusion-matrix and weighted-bincount record also splits a call's host µs into its
   steps, and each of those and each binned-curve and bincount record, once every
   record is timed, counts the device operations of one of its calls (torch.profiler:
   one kernel, else the run fails) and their device µs. A confusion-matrix,
   binned-curve or bincount record names its label or index dtypes (the ImageNet
   step's preds are int64, as argmax gives them) and bounds the bytes those dtypes
   make; a binned-curve record also times the composed library sequence
   (searchsorted, bincount, flip-cumsum-flip) and keeps the compare's operations bound
   of the first port beside its bytes bound. Each SSIM-moments record gives the GB/s
   its bytes make at its time and its bound's share of that time.
4. ``imagenet_eval``: an ImageNet-1k validation pass, 50,000 samples, 1000 classes,
   batch 500: top-1 and macro accuracy, macro F1, macro precision and recall, the
   confusion matrix, macro Jaccard, Matthews, Cohen's kappa, calibration error
   (15 bins), AUROC (100 thresholds) and the micro-averaged PR curve (200 thresholds).
5. ``binary_eval``: a CTR-style pass, 2^22 scores in 16 batches with 1% of targets
   ignored: AUROC and average precision (1000 thresholds), accuracy, F1, the
   confusion matrix, Matthews, Jaccard and calibration error (15 bins).
6. ``collection_eval``: both eval loops again, each metric set as one
   ``MetricCollection`` with compute groups, against the same metrics updated one by
   one on the card: the groups, the launches per step of the confusion-matrix,
   binned-curve and weighted-bincount kernels on both sides, µs per step from
   alternating (per metric, grouped) pairs in one process with no profiler in
   between, then one profile of each grouped loop. Integer states and every value of a
   group of two or more must be bitwise the per-metric loop's; other floats within
   the classification tolerance.
7. ``pipeline_eval``: both eval loops' grouped collections three ways, in one round
   (two alternating rounds before a cut of script time that pays for
   ``model_image_eval``): the collection's eager loop, ``MetricPipeline`` with ``fuse=1``
   (one CUDA-graph replay a step) and with ``fuse=8`` (one replay a chunk of 8; K1,
   K2 and K3 inside the graph), each captured by its warmup before the clock starts.
   It prints µs per step, graph replays and host dispatches per batch, K1/K2/K3
   launches per step counted through replays, the captured variants and capture
   seconds of each pipeline, the peak device memory of the fused ImageNet run, and
   after every timing a profile's device busy share of each. It fails unless both
   pipelines' profiles hold as many K1, K2 and K3 device kernels as their replays
   counted (launches per step times the profiled steps; a trace short of one is taken
   again, twice at most), both
   pipelines equal the eager loop on the card (integers exactly, floats within the
   classification tolerance), the fused one equals its CPU run on a prefix of 9
   ImageNet and 1 CTR batch, the replays equal the chunks with no capture, degraded
   chunk or eager batch in the loop, and a fault run (NaN put into ImageNet batches
   13 and 42 under the ``quarantine`` policy) quarantines exactly those update
   indices, replays their two chunks per batch and equals the eager loop without them.
8. ``session_eval``: both grouped collections as tenant sessions (``imagenet``,
   ``ctr``) of ``MetricPipeline(fuse=8)`` with an alert engine (a non-finite and an
   out-of-bounds rule, evaluated at every commit) and ``CheckpointPolicy(every_batches=16,
   full_every=4, keep=4)``: µs per step with and without the policy and the engine,
   in three alternating rounds; then the session migrated — the origin folds 48
   ImageNet / 6 CTR batches, holds 2 behind its cursor, drains and checkpoints with
   them as the tail — and restored in a spawned process on cuda:0 that replays the
   tail, folds the rest and computes; then the origin's epoch fenced, its next bundle
   refused; then a crashed session beside a torn ``bundle-*.tmp.*`` directory restored
   from ``latest_valid_bundle`` with its gap re-fed; then a NaN in one batch. It prints
   bundle bytes (full and delta), seconds to write, verify and restore a bundle, the
   restored process's capture seconds and K1/K2/K3 launches per step, and the peak
   device memory of the rounds. It fails unless the migrated and the crash-recovered
   sessions are bitwise the control, the restored process launched K1/K2/K3 at
   ``pipeline_eval``'s fuse=8 counts per step (ImageNet 2/1/1, CTR 1/1/1), its registry
   row, report and value timelines continue the origin's, the fenced bundle raises
   ``FencedBundleError``, no alert fires on clean data and the NaN fires the non-finite
   rule with one flight dump.
9. ``mux_eval``: the tenant multiplexer at W = 8 and 64 tenants of each grouped
   collection, batches of 256 rows, max(3, 128 // W) rounds (128 tenant-updates a
   pass at W = 8, 192 at W = 64): one ``TenantMultiplexer`` (one width bucket, one captured graph holding every
   row's K1/K2/K3 launches, one replay per group) against W tenant sessions of
   ``MetricPipeline(fuse=1)``, both warmed up and fed a warm round before the clock,
   timed in turns (mux, baseline, baseline, mux). It prints µs per tenant-update of
   both, dispatches per update, fused, replayed and padded rows, K1/K2/K3 launches per
   dispatch counted from the replays, the captured variants and capture seconds of
   both sides, the peak device memory, the host copies one dispatch makes and their
   µs, and the cost ledger's flops and bytes per fused row beside the kernels' own
   counts. It fails unless every tenant is bitwise its own eager loop on the card (one
   also equals the CPU), one NaN batch among 8 tenants under ``warn_skip`` is isolated to
   its tenant with one flight dump naming it, an admission controller sheds and defers
   one tenant each (counted, every priced charge with flops and bytes), a tenant's
   slice taken mid-stream and restored in a spawned process finishes bitwise the
   control, the warmup manifest carries estimated flops and bytes, and no group
   degrades on clean data.
10. ``multilabel_eval``: an MS-COCO 2014 validation pass at its own width, 40,504
   images x 80 labels (seeded labels, about 2.9 positives an image, and the sigmoid of
   seeded logits), batch 256: the multi-label image classification protocol's mAP
   (exact, and at 200 thresholds), AUROC macro and micro (200 thresholds), CP, CR, CF1
   (macro) and OP, OR, OF1 (micro) precision, recall and F1, accuracy, the confusion
   matrices, Jaccard and Matthews. Three ways: metric by metric over all 159 batches,
   held against the same loop on the CPU (integer states equal, floats within
   FLOAT_ATOL), with a profile's busy share; as one MetricCollection, which must form
   JAX's 4 compute groups (7 stat-score metrics, 3 confusion-matrix ones, 3 binned
   curves, the exact mAP), over the 158 full batches with the exact mAP in a
   MaskedBuffer; and through ``MetricPipeline(fuse=8)``, whose states must be bitwise
   the grouped eager loop's. No run may launch K1-K5 (the multilabel path is plain sums
   and einsums, in JAX too). Then ``MulticlassPrecisionRecallCurve(1000,
   average="macro", thresholds=200)`` on the first 5,000 ImageNet rows, card against
   CPU: the mean precision and the thresholds bitwise, the mean recall within 1e-6.
11. ``family_eval``: the rest of the classification family on three loops at their own
   widths. CTR (``binary_data``, batch 2^18, 1% ignored): specificity, Hamming
   distance, hinge loss, recall at precision 0.5, precision at recall 0.5, sensitivity
   at specificity 0.9, specificity at sensitivity 0.9 and the ROC at 1000 thresholds,
   and beside them a fairness audit (``BinaryGroupStatRates(8)``, ``BinaryFairness(8)``)
   over 8 seeded user segments whose shares fall as 1 / (g + 1). ImageNet (50,000 x
   1000, batch 500): macro specificity and Hamming, hinge loss in both multiclass
   modes, recall at precision 0.5 and specificity at sensitivity 0.5 at 100
   thresholds, the micro ROC at 200 and micro Dice. MS-COCO (``multilabel_data``,
   batch 256): Hamming loss, subset accuracy, macro specificity, coverage error, LRAP,
   ranking loss, recall at precision 0.5 and the ROC at 200 thresholds. Each loop runs
   metric by metric over all its batches, its first batches (CTR 2, ImageNet 10,
   MS-COCO 40) held against the CPU (integer states equal, floats within FLOAT_ATOL
   plus 1e-6 of the CPU's value, the fixed points' thresholds bitwise); as one
   MetricCollection, which must form JAX's compute groups (CTR 1 / 2 / 5, ImageNet and
   MS-COCO 1 / 1 / 1 / 1 / 2 / 2), the fairness pair updated beside it; and through
   ``MetricPipeline(fuse=8)``, whose states must be bitwise the grouped loop's with one
   replay a chunk and no capture in the loop. It prints µs per step, K1/K2/K4 launches
   per step and a profile's busy share of each way. It fails unless CTR launches K2
   and K4 (one K4 launch per fairness update, no K3) and ImageNet K1 and K2.
12. ``collection_sync``: two ranks in one gloo world on the one card
   (``torch.multiprocessing`` spawn, a timeout on the rendezvous and on each
   collective, one on the whole world). Each rank makes the full seeded data, updates
   a grouped and an ungrouped collection with every other batch on ``cuda:0`` and
   calls ``compute``, which syncs: once untimed, then in turns with the value cache
   off. It reports the backend, whether a collective stages the CUDA tensors through
   host memory (gloo gathers CPU tensors), the ``all_gather`` calls per ``compute``
   grouped and ungrouped, the ms per synced ``compute`` and the ms of the sync alone
   (``sync_state`` of the leaders' states). Both ranks' synced values and states must equal the single-process
   collection's over all the data (integers exactly, floats within the
   classification tolerance); a rank that fails or hangs fails the run.
13. ``retrieval_grouping``: ``_flexible_bincount`` over the query ids of a top-1000
   reranking evaluation at MS MARCO passage dev-small's size, 6,980 queries x 1000
   candidates (6.98 M int32 ids) in a seeded order, through the bincount kernel.
14. ``retrieval_eval``: an MS MARCO passage dev (small)-shaped reranking run, 6,980
   queries with sparse ids below 1.1 M, each with its top-1000 candidates (6.98 M rows),
   made with numpy from a seed: reranker scores rounded to 4 decimals (so ties occur),
   about 1.07 relevant passages a query and none for 14% of them. 70 updates of 100
   queries each, rows shuffled within a batch, into all eleven retrieval metrics in one
   ``MetricCollection`` at the leaderboard's and BEIR's settings (MRR@10, Recall@1000,
   NDCG@10, MAP, P@10, hit rate@10, fall-out@10, R-precision, AUROC, the PR curve and
   recall at precision 0.1 up to k = 100). Each ``compute`` scores every query in one
   batched pass (sort, per-query sums on the weighted-bincount kernel, documents per
   query on the bincount kernel). It prints µs per update, each metric's compute
   seconds (first and warm), the CPU's, a per-query loop's seconds on the first 200
   queries scaled to 6,980, the peak device memory and a profile's busy share of one
   warm compute of all eleven. It fails unless every value equals the same run with
   ``device="cpu"`` within 1e-6 (the curve's best k exactly), the batched per-query
   scores of the first 200 queries on the card equal the loop of the port's
   single-query functions on the card (1e-6; AUROC 1e-5: the functions integrate a
   float32 trapezoid), ``RetrievalAUROC(max_fpr=0.1)`` (a per-query loop) on those
   queries equals the CPU within 1e-5, K3 and K4 were launched by ``compute``, and a
   ``RetrievalMAP(buffer_capacity=...)`` whose update is captured and replayed through
   ``MetricPipeline(fuse=8)`` gives the list-state value.
15. ``wrappers_eval``: Pearson, Spearman, Kendall, Concordance, R², explained variance
   and RSE over 1,500 STS-B-validation-shaped pairs (scores 0 to 5), and at ImageNet
   width (1000 classes, 20 batches of 500) a seeded ``BootStrapper`` of macro accuracy
   (20 copies), ``ClasswiseWrapper`` of per-class F1, ``MinMaxMetric``, a 3-epoch
   ``MetricTracker`` with its best step, ``Running(MeanMetric(), 5)``, ``RunningSum``,
   ``MultioutputWrapper(R2Score(), 5)``, a classification-and-regression
   ``MultitaskWrapper`` and ``BinaryTargetTransformer``. It fails unless every value
   equals its CPU twin (integers exactly, floats within 1e-5) and the confusion-matrix
   kernel was launched through the wrappers.
16. ``clustering_eval``: ImageNet-1k validation clustered into 1000 clusters, the NMI /
   AMI / ARI protocol of SCAN (Van Gansbeke et al., ECCV 2020): 50,000 seeded labels (50
   a class) and a seeded clustering of them, fed in 100 batches of 500 to the nine
   extrinsic classes, and 50,000 x 2048 float32 features (ResNet-50's pooled width)
   around 1000 centroids fed with the clusters to Calinski-Harabasz, Davies-Bouldin and
   the Dunn index. It prints each ``compute``'s value, seconds and bincount launches (one
   each: the 1000 x 1000 contingency table, or the cluster counts) and fails unless every
   value equals the same run on the CPU on all the data (1e-6; AMI 1e-5; the intrinsic
   scores 1e-5 relative).
17. ``nominal_eval``: the UCI Adult census's shape, 48,842 rows of its nine categorical
   columns at their published cardinalities (workclass 9, education 16, marital-status
   7, occupation 15, relationship 6, race 5, sex 2, native-country 42, income 2), about
   7% NaN in workclass, occupation and native-country: the four ``*_matrix`` functions
   under ``replace`` and ``drop`` (36 + 36 + 36 + 72 confusion-matrix launches each),
   the four stateful classes over education and occupation in batches of 4,096 (one
   launch an update), and ``FleissKappa`` over 100,000 items x 5 categories x 10 raters
   in both modes. It fails unless the launches are those and every state equals the CPU
   exactly and every value within 1e-6.
18. ``segmentation_eval``: Cityscapes validation's shape, 1024 x 2048 index maps of 19
   classes with 255 void, 100 images (cut from 500) in batches of 4: ``MeanIoU`` per
   class or not, with and without background, and ``GeneralizedDiceScore`` (square
   weights), one bincount launch a metric an update. The CPU twin runs on the first 8
   images (states and values within 1e-6, the tables exactly), and one-hot input
   (``[4, 19, 1024, 2048]``) on the same images must give the index route's scores. A
   profile of two updates last splits their device time into the bincount kernel and
   the id preparation around it.
19. ``pairwise_eval``: retrieval embeddings at BERT-base width: cosine, linear and
   Euclidean of 6,980 queries (MS MARCO dev-small) against 65,536 passages, x 768; then
   Manhattan and Minkowski (p = 3) of 4,096 embeddings with themselves, zero diagonal,
   whose peak memory must stay within three outputs (no ``[N, M, d]`` temporary).
   The CPU computes the first 256 rows (cosine within 1e-5, the others within 1e-5 of
   the matrix's largest magnitude).
20. ``text_eval``: the text domain's string and token metrics on five published
   workloads, each corpus synthesized from a seed at its published counts and lengths
   (words from a seeded Zipf vocabulary, hypotheses made from the references by seeded
   substitutions, deletions and insertions; no dataset is in the repo). ASR:
   LibriSpeech test-clean's 2,620 utterances and 52,576 words at ~5% word errors,
   batches of 64: WER, CER, MER, WIL, WIP and ``EditDistance`` (``mean`` and ``none``).
   MT: WMT14 newstest2014 en-de's 3,003 segments of ~21 words, one reference each, ~40%
   edits, batches of 128: BLEU, SacreBLEU (13a), chrF, chrF++, TER and EED, on the first
   6 batches (768 segments; a cut of script time, which pays for ``detection_eval``).
   Summarization: CNN/DailyMail 3.0.0 test's 11,490 pairs, references of ~55 words in 3-4
   sentences, batches of 256, on the first 8 batches (2,048 pairs; the same cut):
   ROUGE-1/2/L/Lsum with the regex sentence splitter
   installed (punkt is never downloaded). QA: SQuAD v1.1 dev's 10,570 questions with 1-3
   gold answers of 1-10 words, ~80% exact, batches of 512. LM: ``Perplexity`` at
   Llama-2's vocabulary of 32,000 over 40 windows of 4 x 2,048 float32 logits drawn on the
   card (327,680 tokens, the last window's last 1,024 ignored), eager and with
   ``jit_update=True``. It prints per loop the host seconds, items per second and µs per
   update (the final compute included), the values, for the ASR corpus the host seconds
   of its unit-cost edit distances by bit vectors and by the numpy DP, and for
   perplexity the device ms per update from a profile, the logits' read rate and their
   bound at the memory rate. It fails unless the two edit-distance totals agree, every
   string loop's states live on the card and its states and values after its first 2
   batches equal the same batches with ``device="cpu"`` (counters exactly, scores and
   per-sentence lists within 1e-6), perplexity on the first window equals the CPU within
   1e-5 relative, the captured perplexity is bitwise the eager one, and no K1-K5 kernel
   was launched.
21. ``audio_eval``: two published audio evaluations, synthesized from seeds at their
   counts and rates (speech stands in as band-limited noise, amplitude-modulated at a
   syllable rate and gated into phrases). Separation: WSJ0-2mix's test set ("tt", min
   mode, 8 kHz), 3,000 two-speaker mixtures cropped to 4 s, batches of 16, each estimate
   its source plus the other's crosstalk and noise about 10 dB below it, half the rows
   with the speakers swapped: PIT on SI-SDR (fed the swapped rows; on the first batch the
   functional must find the swap and ``pit_permutate`` undo it), SI-SDR, SDR (512 taps),
   SA-SDR, SNR and SI-SNR. Enhancement: VoiceBank+DEMAND's test set, 824 utterances at 16
   kHz of 1.5-6 s, batches of 8 cropped to their shortest, the clean speech plus coloured
   noise at 5-20 dB: STOI, ESTOI, SRMR (``fast=False`` and ``fast=True``), SNR, SI-SNR and
   C-SI-SNR on a 512-point STFT. It prints per loop the wall seconds, µs per update and
   seconds per ``compute`` of each metric (each call timed alone) and the values; SDR's
   device ms per update and its solve's share from a profile, SRMR's peak memory at the
   longest batch, and a profile of two enhancement steps. It fails unless each loop's
   states and values after its first 2 batches equal the same batches with
   ``device="cpu"`` (``total`` exactly; per sample SNR-family scores within 1e-4 dB, SDR
   1e-2 dB, STOI 1e-5, SRMR 1e-4 relative; ``sum_score`` within that times ``total``),
   every value is finite and in range, and no K1-K5 kernel was launched. Then DNSMOS:
   the DNS Challenge (Interspeech 2020) synthetic no-reverb test set, 150 noisy clips of
   10 s at 16 kHz, batches of 8, ``personalized`` False and True, on graphs fabricated in
   the ONNX wire format with seeded weights (no DNS checkpoint is in the repo): a
   P.808-shaped CNN over the 900 x 120 log-mel input and P.835 ``sig_bak_ovr``-shaped
   graphs over the raw 144,160-sample segment, in a model directory under
   ``build/audio`` (two as raw ``.onnx`` drops, converted on first use, one converted
   already; removed at the end). It prints µs per update (the first, which converts and
   loads, apart) and the executor's device ms by op, and fails unless the card's per-clip
   scores and the class's states on the first 2 batches equal the CPU's within 1e-4, the
   mean is a MOS in [1, 5] and the raw drop was converted.
22. ``image_quality_eval``: PanCollection's WorldView-3 test sets (Deng et al., IEEE GRSM
   2022), synthesized from seeds at their sizes: 20 reduced-resolution images (an 8-band
   256 x 256 ground truth beside the fused output; SAM, ERGAS at ratio 4, SCC, VIF, RASE)
   and 20 full-resolution ones (fused output and panchromatic image 8 x 512 x 512, the
   multispectral image 8 x 128 x 128; D-lambda, D-s with and without ``pan_lr``, QNR),
   batches of 4, and the image gradients of the fused images. It prints µs per update and
   seconds per ``compute`` of each metric, the values and a profile of each resolution.
   It fails unless the first 4 images of each resolution give on the card what they give
   with ``device="cpu"`` (1e-5 plus 1e-6 relative; SAM's pixel sum 1e-5 relative; the
   gradients bitwise), every value is finite and in range, and no K1-K5 kernel was
   launched.
23. ``detection_eval``: three published detection evaluations, synthesized from seeds at
   their sizes (no dataset is in the repo). COCO val2017 bbox: 5,000 images of 480 x 640,
   36,781 boxes of 80 categories (a heavy head, COCO's mix of small, medium and large
   boxes), 100 scored detections an image, batches of 16: ``MeanAveragePrecision`` with
   class metrics, micro-averaged and with the extended summary, and the four IoU
   classes. segm: the first 500 images as ellipse masks in the buffered, bit-packed
   layout (``mask_shape=(480, 640)``). COCO panoptic val2017: 5,000 images of 480 x 640,
   80 thing and 53 stuff categories, batches of 8: ``PanopticQuality`` and
   ``ModifiedPanopticQuality``. It prints µs per update of each metric, ``compute``
   seconds first and warm, the peak memory of the computes, a profile of a warm
   ``compute`` (busy share, the matcher's and the accumulation's device ms), the values
   and one profiled panoptic update. It fails unless each panoptic update launched the
   bincount kernel exactly once a metric and nothing else launched a kernel, the values
   are in range, and the card equals its CPU twin on the first 500 (bbox), 16 (segm) and
   16 (panoptic) images: the mean AP surfaces, ``ious``, classes and every count
   exactly, summary values and IoUs within 1e-6, panoptic ``iou_sum`` within 1e-6
   relative.
24. ``model_image_eval``: the model-based image metrics at published sizes on seeded
   random weights at the published widths (no checkpoint is in the repo), synthesized
   from seeds: FID-10k at CIFAR-10's shape (10,000 + 10,000 uint8 images of 3 x 32 x
   32, batches of 200, ``FrechetInceptionDistance(feature=2048)``), then IS (10
   splits of ``logits_unbiased``), KID (100 subsets of 1,000) and MiFID on the first
   2,000 images of each set, each through its own extractor; LPIPS on AlexNet, VGG16
   and SqueezeNet1.1 (1,000 pairs of 3 x 256 x 256 in batches of 50, the repo's heads;
   the backbones written as torchvision ``.pth`` files and converted with
   ``convert_lpips_backbone``); perceptual path length with JAX's defaults over a
   seeded 512-wide stand-in generator. It prints the extractor's images per second,
   ms an update, ``compute`` seconds, peak memory and a profiled update's device ms by
   kernel kind, each LPIPS backbone's ms an update and profile, and PPL's samples per
   second. It fails unless no K1-K5 kernel launched, no profiled kernel is a cuDNN
   convolution or a TF32 product, the values are finite and in range, and the card
   equals its CPU twin (16 + 16 images: FID states within 1e-4 of their largest
   magnitude, FID / IS / KID / MiFID within 1e-3 of the mean; 4 pairs a backbone:
   LPIPS within 1e-5 relative; 8 PPL samples within 1e-2 relative).
25. ``image_restoration_eval``: a super-resolution validation pass at the size of the
   DIV2K validation set, 100 RGB images of 1356 x 2040, batch 4, 25 steps: SSIM,
   MS-SSIM, PSNR, UQI, sliding-window RMSE (window 8) and the total variation of the
   predictions. It requires 6 launches of the SSIM moments kernel per step (1 for
   SSIM, 5 for the MS-SSIM scales), then holds the card against the CPU on the first
   4 images with fresh metrics on both sides. It reports the kernel's device ms per
   warm step inside the loop (profile) beside its main-path shapes timed alone.
26. ``ssim_gradient``: ``structural_similarity_index_measure(...).backward()`` on one
   2 x 3 x 256 x 256 pair, on the card and on the CPU.
27. ``obs_eval``: the robust and observability planes on the main path. With tracing,
   lineage and the conservation auditor on: both grouped collections as
   ``MetricPipeline(fuse=8)`` tenant sessions with a checkpoint policy (64 ImageNet
   batches with one NaN batch quarantined, 8 CTR batches), the ImageNet session
   restored from its bundle and fed 8 more, and a ``TenantMultiplexer`` at W = 8 of
   the ImageNet collection (one NaN batch quarantined, the noisy tenant's last round
   shed by admission). It prints each tenant's flow ledger, the violations, an
   ``audit_stream`` of the bundle stream, every collection's ``memory_footprint()``
   and ``device_memory_stats()``, the Prometheus page's and the JSONL's robust counters
   read back, and the Perfetto export's span and flow counts. Meanwhile a spawned
   process runs ``profile_session`` over 8 eager ImageNet steps, and two spawned gloo
   ranks on cuda:0 sync the ImageNet collection under the guard: one injected
   ``raise`` (retried), then an injected hang on a gloo group of their own. Then the
   host profiler samples an eager, a fused and a mux pass, and the fused loops are
   timed with every plane off and on, in turns (reported, not gated). It fails unless
   every ledger balances with no violation, every footprint equals byte for byte the
   footprint of the same collection built with ``device="cpu"``, the exported
   counters equal the metrics' and account for every processed batch, the trace holds
   the metric ranges with every K1 and K2 launch inside one, the retried sync is
   bitwise the unguarded one after one retry on each rank, and the hung sync degrades
   on both ranks to their local values with ``aggregate()`` naming the missing rank.
28. ``fleet_eval``: the fleet plane and the live endpoints. Eight tenant sessions
   (``MetricPipeline(fuse=8)`` of the grouped ImageNet and CTR collections, four each)
   on two virtual hosts, six on host "0" and two CTR tenants on host "1", are fed
   round-robin with tracing, lineage and the auditor on, while an
   ``IntrospectionServer`` on port 0 answers a scraper thread that sweeps every route
   (up to 10 sweeps a second). Every ``/metrics`` scrape ticks the installed
   ``FleetSampler`` and ``PlacementController``; the controller's mover moves a session
   (drain, checkpoint, restore, replay the tail) between two steps of the loop. It
   fails unless every session's states are bitwise those of the same batches without
   the plane, every route answers 200 but the planned 404s (an unknown tenant, a trace
   id never minted, the evicted first batch), ``/metrics`` parses and carries the
   ``fleet.*``, ``placement.*`` and server-request families, the imbalance opens above
   the high band and closes below the low one after at least one move, ``/healthz`` answers
   degraded with the moving tenant named during each move, each bundle verifies, the
   audit ledgers balance with no violation, and the K1/K2/K3 launches equal the
   graphs' replays times their captured counts plus the restored sessions' warm runs.
   Meanwhile two spawned gloo ranks on cuda:0 each serve a CTR session and sample the
   fleet (rank 0's ``/fleet`` must show both hosts and the rate table), then rank 1 stops answering and rank 0's next sample must degrade
   within the guard's 2 s with ``missing_hosts`` [1] and ``/healthz`` degraded; and
   ``python -m torchmetrics_tpu_torch.obs.serve --demo --port 0`` runs as a subprocess
   whose ``/tenants``, ``/alerts``, ``/trace/<id>`` and ``/audit`` must show the demo's
   two tenants, the firing ``non_finite`` alert, the NaN batch with the alert linked and
   the seeded violation. Then a 12-tenant CTR ``TenantMultiplexer`` adopts the
   controller's proposed ladder (1, 2, 4, 8, 16) with states bitwise those of the
   default ladder, and one ImageNet and one CTR session are timed with the plane on
   and off in turns (reported, not gated).
29. ``chaos_eval``: the chaos plane on the card. The seven scenarios of the JAX
   package's ``bench.py --chaos`` (default and skewed load with 8 tenants, 64 tenants
   multiplexed at ``mux_max_width=64``, rolling deploy, host crash, hung host, and a
   12-tenant flash crowd after its controller-off control arm) replay their seeded
   schedules through ``chaos.replay`` with every tenant on the card, while a scraper
   thread reads the live server; each is judged by its SLO spec with JAX's thresholds
   and prefix. One line per scenario gives its wall seconds, updates per second,
   batches fed, SLOs passed and failed, the server-side scrape p95/p99 per route, time
   to fire and to resolve each fault, captured variants and capture seconds, moves,
   migration, recovery, detection and failover seconds, convergence, and the K1–K5
   launches (none: the chaos tenants run micro accuracy, MSE and ``CatMetric``). Then
   the default scenario runs at ImageNet width (1000 classes, batches of 256 and 500),
   judged by the default spec, and again with ``device="cpu"``. It fails unless every
   SLO of every scenario passes, and the two ImageNet-width runs share their batches,
   faults, named poisoned batches, fired-and-resolved alert episodes and robust
   counters, with every tenant's final states and value equal (the victim's MSE sums
   within 1e-6 relative, all else bitwise).

Both eval phases run their first steps again with ``device="cpu"`` (ImageNet 20 of its
100 steps, CTR 4 of 16), against the card's states and values snapshotted after the
same step, and require equal integer states and floats within 1e-5; the calibration ``bins`` state, whose sums
reach 10^3 where a float32 ulp is 10^-4, within 1e-5 plus a relative 1e-6. Each
phase requires its kernels to have launched. Each eval phase then profiles a few
warm steps on fresh metrics (``torch.profiler``): the device time per step, the
device's busy share of the wall clock and the kernels that take most of it. The
retrieval phase requires the CPU's counts to be equal.
The image phase compares floats within 1e-5 plus 1e-6 of the CPU's value (sums over
images), and the states that sum over pixels (PSNR's squared error, UQI's sum, the
total variation) within 1e-5 relative: float32 sums of ~10^7 terms in another order.
Every phase line carries its wall time; the last four lines are the script's total
wall time, the ``nvidia-smi`` line, a JSON line with every kernel, and
``{"ok": true, "device": {...}}``. Times come from CUDA events over many launches
(inputs warm in L2) or from the host clock around work that ends in a synchronise.
Without a card the script exits non-zero before printing any result.

    python3 chip_smoke.py --kernel-times

builds the kernels and prints only one JSON line: the confusion matrix and the binned
curve at their five shapes, the weighted bincount, the bincount and the SSIM moments
timed through their public wrappers at the shapes of the ``kernels`` phase (and three
larger SSIM windows), each checked against its plain version on the card, with the
host µs, device kernels and device µs per confusion-matrix, binned-curve,
weighted-bincount and bincount call, the library call's time beside the confusion
matrix and the bincount, the composed library sequence's time beside the binned curve
and a digest of each SSIM output. The five wrappers' interfaces have not changed
since they were ported, so a copy of this script run from the root of an earlier
revision's checkout times that revision: running earlier, this, this, earlier on one
card compares two revisions.

    python3 chip_smoke.py --pipeline-eval

builds the kernels and prints only the ``pipeline_eval`` phase's line (its checks
included), so that two revisions of the capture cache and the pipeline are compared
the same way: earlier, this, this, earlier on one card.

    python3 chip_smoke.py --session-eval

builds the kernels and prints only the ``session_eval`` phase's line (its checks
included).

    python3 chip_smoke.py --mux-eval

builds the kernels and prints only the ``mux_eval`` phase's line (its checks included).

    python3 chip_smoke.py --multilabel-eval

builds the kernels and prints only the ``multilabel_eval`` phase's line (its checks
included).

    python3 chip_smoke.py --family-eval

builds the kernels and prints only the ``family_eval`` phase's line (its checks
included).

    python3 chip_smoke.py --obs-eval

builds the kernels and prints only the ``obs_eval`` phase's line (its checks
included).

    python3 chip_smoke.py --fleet-eval

builds the kernels and prints only the ``fleet_eval`` phase's line (its checks
included).

    python3 chip_smoke.py --chaos-eval

builds the kernels and prints only the ``chaos_eval`` phase's lines (its checks
included).

    python3 chip_smoke.py --retrieval-eval --wrappers-eval --clustering-eval --nominal-eval \
        --segmentation-eval --pairwise-eval --text-eval --audio-eval --image-quality-eval \
        --detection-eval --model-image-eval

builds the kernels and prints only the line of each phase named (its checks
included).

``bound_ms`` is the larger of the bytes a kernel must move over the memory rate and
its operations over the float32 rate of the data sheet (an FMA counting two), both
counted by the kernel's ``*_cost`` function in ``ops/kernels.py``, which the cost
ledger adds too.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import warnings

HBM_BYTES_PER_S = 3.35e12  # H100 SXM memory rate
FP32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores (an FMA counts two)
FLOAT_ATOL = 1e-5
# the calibration state: float32 per-bin sums of up to ~10^3, each step summed in
# float64 and rounded once on the card and on the CPU alike
BINS_RTOL = 1e-6
# the weighted bincount's float rows against its plain version: both sum in float64 and
# round once, so they differ by at most about one float32 ulp whatever the atomics' order
WEIGHTED_RTOL = 1e-6
KERNEL_SOURCES = {
    "confusion_matrix": ("torchmetrics_tpu_torch/ops/csrc/confusion_matrix.cu", "torchmetrics_tpu/ops/pallas_kernels.py:70"),
    "binned_curve_counts": (
        "torchmetrics_tpu_torch/ops/csrc/binned_curve_counts.cu",
        "torchmetrics_tpu/ops/pallas_kernels.py:140",
    ),
    "weighted_bincount": (
        "torchmetrics_tpu_torch/ops/csrc/weighted_bincount.cu",
        "torchmetrics_tpu/ops/pallas_kernels.py:205",
    ),
    "bincount": ("torchmetrics_tpu_torch/ops/csrc/bincount.cu", "torchmetrics_tpu/ops/pallas_kernels.py:267"),
    "ssim_moments": ("torchmetrics_tpu_torch/ops/csrc/ssim_moments.cu", "torchmetrics_tpu/ops/pallas_kernels.py:334"),
}
# the SSIM moments kernel against its plain version, inputs in [0, 1]: float32 window
# sums of up to 71 taps per pass in the same order, the card fusing each multiply-add
MOMENTS_ATOL = 1e-5
# the library yardstick (a float32 convolution, TF32 off) against the plain
# version: another summation order over up to 71 x 71 taps; TF32 would miss by ~1e-3
LIBRARY_CONV_ATOL = 1e-4
# image_restoration_eval: float states that sum over images get 1e-6 of the CPU's
# value on top of FLOAT_ATOL; those that sum over ~10^7 pixels get PIXEL_SUM_RTOL
IMAGE_RTOL = 1e-6
PIXEL_SUM_RTOL = 1e-5
PIXEL_SUMS = ("state.psnr.sum_squared_error", "state.uqi.sum_uqi", "state.tv_preds.score", "value.uqi",
              "value.tv_preds")
# PSNR = 10 log10(range^2 / mse): a relative error e of the squared error moves it by
# 10 / ln(10) * e dB
PSNR_ATOL = FLOAT_ATOL + 10 / 2.302585092994046 * PIXEL_SUM_RTOL
# the SSIM gradient on the card against the CPU: 1e-5 absolute, and 1e-4 of the
# largest gradient, since the gradient of a mean over 3 * 256^2 pixels is ~1e-5
GRAD_ATOL = 1e-5
GRAD_RTOL_OF_MAX = 1e-4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms over ``reps`` back-to-back calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, calls: int = 2000) -> float:
    """Mean host wall time of ``fn()`` in µs over ``calls`` calls, the card drained before and after."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / calls * 1e6


def device_kernels_per_call(fn, trials: int = 5) -> dict:
    """Device kernels (and memsets) that one warm call of ``fn()`` runs, from torch.profiler,
    and their device µs in that trace.

    A trace can miss a kernel, never add one, so the largest count of ``trials``
    single-call traces is the one reported."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best, best_us = {}, 0.0
    for _ in range(trials):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names, device_us = {}, 0.0
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and e.count:
                names[e.key[:80]] = names.get(e.key[:80], 0) + e.count
                device_us += getattr(e, "self_device_time_total", 0) or 0
        if sum(names.values()) > sum(best.values()):
            best, best_us = names, device_us
    return {"per_call": sum(best.values()), "names": best, "device_us": best_us}


# ----------------------------------------------------------------------- kernels


def confusion_matrix_case(n: int, c: int, seed: int, device: str = "cuda", preds_dtype=None, target_dtype=None,
                          high_bits: bool = False):
    """Labels with 20% invalid samples and about 1% out-of-range preds and targets, int32
    unless a dtype is given. With ``high_bits`` the int64 labels also carry multiples of
    2^32, which the kernel drops as JAX's conversion to int32 does."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    preds = torch.randint(0, c, (n,), generator=g, device=device, dtype=torch.int32)
    target = torch.randint(0, c, (n,), generator=g, device=device, dtype=torch.int32)
    valid = torch.rand(n, generator=g, device=device) >= 0.2
    bad = torch.rand(n, generator=g, device=device) < 0.01
    preds = torch.where(bad, torch.where(preds % 2 == 0, c, -1), preds).to(preds_dtype or torch.int32)
    bad = torch.rand(n, generator=g, device=device) < 0.01
    target = torch.where(bad, torch.where(target % 2 == 0, c + 5, -3), target).to(target_dtype or torch.int32)
    if high_bits:
        preds = preds + (torch.randint(-2, 3, (n,), generator=g, device=device) << 32).to(preds.dtype)
        target = target + (torch.randint(-2, 3, (n,), generator=g, device=device) << 32).to(target.dtype)
    return preds, target, valid


def curve_case(n: int, t: int, seed: int, unsorted_ties: bool = False, device: str = "cuda", label_dtype=None):
    """Scores, labels (int32 unless a dtype is given), 20% invalid, and the default grid
    (or a shuffled grid with exact ties)."""
    import torch

    from torchmetrics_tpu_torch.functional.classification.precision_recall_curve import _linspace_thresholds

    g = torch.Generator(device=device).manual_seed(seed)
    thresholds = _linspace_thresholds(t).to(device)
    scores = torch.rand(n, generator=g, device=device)
    if unsorted_ties:
        thresholds = thresholds[torch.randperm(t, generator=g, device=device)]
        tie = torch.rand(n, generator=g, device=device) < 0.5
        pick = torch.randint(0, t, (n,), generator=g, device=device)
        scores = torch.where(tie, thresholds[pick], scores)
    labels = torch.randint(0, 2, (n,), generator=g, device=device, dtype=torch.int32).to(label_dtype or torch.int32)
    valid = torch.rand(n, generator=g, device=device) >= 0.2
    return scores, labels, valid, thresholds


def bound_of(cost) -> tuple:
    """(ms, "bytes" or "operations"): the larger of a kernel's bytes over the memory
    rate and its operations over the float32 rate, from the (operations, bytes) that
    its ``kernels.*_cost`` function counts, the same count the cost ledger adds."""
    ops, nbytes = cost
    byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def curve_bound_ms(labels, t: int) -> float:
    """Each score, label (at its own width) and mask byte read once, the thresholds
    read, int32 [T, 2] written; the search's N * ceil(log2(T + 1)) compares take far
    less (``kernels.binned_curve_counts_cost``)."""
    from torchmetrics_tpu_torch.ops import kernels

    return bound_of(kernels.binned_curve_counts_cost(labels, t))[0]


def curve_compare_bound_ms(n: int, t: int) -> float:
    """The bound of the earlier O(N * T) compare design: its 2 * N * T operations."""
    return 2.0 * n * t / FP32_OPS_PER_S * 1e3


def curve_library(scores, labels, valid, thresholds):
    """The composed library sequence (no single PyTorch call computes the binned curve):
    ``torch.searchsorted`` over the sorted thresholds, the masked bucket code,
    ``torch.bincount``, then flip, ``cumsum``, flip. The thresholds are sorted before the
    returned call; an unsorted list is scattered back in its order. A reference only: no
    NaN among the scores (searchsorted puts NaN after every threshold)."""
    import torch

    t = thresholds.numel()
    sorted_thr, order = torch.sort(thresholds)
    identity = bool((order == torch.arange(t, device=order.device)).all())
    positive = labels.to(torch.int32) != 0

    def call():
        pos = torch.searchsorted(sorted_thr, scores, right=True)
        code = torch.where(valid, 2 * pos + (~positive), 2 * (t + 1))
        hist = torch.bincount(code, minlength=2 * t + 3)[: 2 * (t + 1)].view(t + 1, 2)
        counts = hist.flip(0).cumsum(0).flip(0)[1:]
        return counts if identity else torch.empty_like(counts).index_copy_(0, order, counts)

    return call


def confusion_matrix_bound_ms(preds, target, c: int) -> float:
    """Each label read at its own width, the bool mask, and the int32 [C, C] output
    written (``kernels.confusion_matrix_cost``)."""
    from torchmetrics_tpu_torch.ops import kernels

    return bound_of(kernels.confusion_matrix_cost(preds, target, c))[0]


def confusion_matrix_library(preds, target, valid, c: int):
    """The yardstick's inputs: one torch.bincount over the codes of the pairs that count,
    weighted 0 or 1, labels taken by their low 32 bits as the kernel takes them."""
    import torch

    p, t = preds.to(torch.int32).long(), target.to(torch.int32).long()
    keep = valid & (p >= 0) & (p < c) & (t >= 0) & (t < c)
    code = torch.where(keep, t * c + p, torch.zeros_like(p))
    return code, keep.to(torch.float32)


def kernel_record_confusion_matrix(n: int, c: int, seed: int, main_path: bool, preds_dtype=None, target_dtype=None,
                                   high_bits: bool = False) -> dict:
    """Also: the host µs of each step of a call. The record's ``_trace`` counts the device
    operations of one call once every timing is done (``trace_records``)."""
    import torch

    from torchmetrics_tpu_torch.ops import kernels

    preds, target, valid = confusion_matrix_case(n, c, seed, preds_dtype=preds_dtype, target_dtype=target_dtype,
                                                 high_bits=high_bits)
    before = kernels.LAUNCHES["confusion_matrix"]
    got = kernels.confusion_matrix(preds, target, valid, c)
    torch.cuda.synchronize()
    want = kernels.confusion_matrix_plain(preds.cpu(), target.cpu(), valid.cpu(), c)
    err = int((got.cpu().to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got.cpu(), want):
        raise AssertionError(f"confusion_matrix kernel != plain at N={n}, C={c}: max abs err {err}")
    code, weight = confusion_matrix_library(preds, target, valid, c)
    library = torch.bincount(code, weights=weight, minlength=c * c).reshape(c, c)
    if not torch.equal(library.cpu().to(torch.int32), want):
        raise AssertionError("the torch.bincount yardstick disagrees with the plain version")
    call = lambda: kernels.confusion_matrix(preds, target, valid, c)  # noqa: E731
    record = {
        "kernel": "confusion_matrix", "n": n, "classes": c, "preds_dtype": str(preds.dtype),
        "target_dtype": str(target.dtype), "high_bits": high_bits, "main_path": main_path, "max_abs_err": err,
        "kernel_ms": time_ms(call),
        "plain_ms": time_ms(lambda: kernels.confusion_matrix_plain(preds, target, valid, c)),
        "library_ms": time_ms(lambda: torch.bincount(code, weights=weight, minlength=c * c)),
        "bound_ms": confusion_matrix_bound_ms(preds, target, c),
        "bound_by": bound_of(kernels.confusion_matrix_cost(preds, target, c))[1],
        "host_us": confusion_host_breakdown(preds, target, valid, c, calls=500),
    }
    record["_trace"] = lambda: confusion_trace(call)
    return {**record, "launches": kernels.LAUNCHES["confusion_matrix"] - before}


def confusion_trace(call) -> dict:
    """The device operations of one call (torch.profiler): one kernel and nothing else."""
    ran = device_kernels_per_call(call)
    kernel_names = [name for name in ran["names"] if "confusion_matrix" in name]
    if len(kernel_names) != 1 or ran["names"][kernel_names[0]] != 1 or ran["per_call"] != 1:
        raise AssertionError(f"confusion_matrix ran {ran} device operations per call, expected one kernel")
    return {"device_kernels_per_call": ran["per_call"], "device_kernels": ran["names"],
            "device_us_per_call": ran["device_us"]}


def confusion_host_breakdown(preds, target, valid, c: int, calls: int = 2000) -> dict:
    """Host µs per call of each step of ``kernels.confusion_matrix`` on these inputs,
    each step timed alone over ``calls`` calls, and of the whole call."""
    import torch

    from torchmetrics_tpu_torch.ops import kernels

    index = preds.get_device()
    stream = kernels._raw_stream(index)
    n = preds.numel()

    def scratch():
        need = kernels._confusion_slots_bytes(index, n, c)
        return kernels._stream_scratch(kernels._CONFUSION_SCRATCH, index, stream, need, zero=False) if need else None

    slots, need = scratch(), kernels._confusion_slots_bytes(index, n, c)
    out = preds.new_empty((c, c), dtype=torch.int32)
    fn = kernels._entry_point("confusion_matrix")
    args = (preds.data_ptr(), preds.element_size(), target.data_ptr(), target.element_size(), valid.data_ptr(), n, c,
            None if slots is None else slots.data_ptr(), need, out.data_ptr(), stream)
    accepted = kernels._CONFUSION_DTYPES
    return {
        "checks": host_us(lambda: (preds.dtype not in accepted, target.dtype not in accepted, valid.dtype not in accepted,
                                   preds.numel(), target.numel(), valid.numel(), 0 <= c <= kernels._MAX_CLASSES), calls),
        "on_card": host_us(lambda: kernels._on_card(preds, target, valid), calls),
        "operands": host_us(lambda: (kernels._label_operand(preds), kernels._label_operand(target),
                                     valid.dtype != torch.bool, valid.is_contiguous()), calls),
        "empty_out": host_us(lambda: preds.new_empty((c, c), dtype=torch.int32), calls),
        "stream_lookup": host_us(lambda: (preds.get_device(), torch.cuda.current_device(), kernels._raw_stream(index)),
                                 calls),
        "scratch_lookup": host_us(scratch, calls),
        "ctypes_call_and_launch": host_us(lambda: fn(*args), calls),
        "whole_call": host_us(lambda: kernels.confusion_matrix(preds, target, valid, c), calls),
    }


def kernel_record_curve(n: int, t: int, seed: int, main_path: bool, unsorted_ties: bool = False,
                        label_dtype=None) -> dict:
    """Also: the composed library sequence's time (``curve_library``), the host µs of a
    whole call, and the earlier compare design's operations bound beside the bytes
    bound. The record's ``_trace`` counts the device operations of one call once every
    timing is done (``trace_records``)."""
    import torch

    from torchmetrics_tpu_torch.ops import kernels

    scores, labels, valid, thresholds = curve_case(n, t, seed, unsorted_ties, label_dtype=label_dtype)
    before = kernels.LAUNCHES["binned_curve_counts"]
    got = kernels.binned_curve_counts(scores, labels, valid, thresholds)
    torch.cuda.synchronize()
    want = kernels.binned_curve_counts_plain(scores.cpu(), labels.cpu(), valid.cpu(), thresholds.cpu())
    err = int((got.cpu().to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got.cpu(), want):
        raise AssertionError(f"binned_curve_counts kernel != plain at N={n}, T={t}: max abs err {err}")
    library = curve_library(scores, labels, valid, thresholds)
    if not torch.equal(library().cpu().to(torch.int32), want):
        raise AssertionError("the composed searchsorted + bincount + cumsum yardstick disagrees with the plain version")
    call = lambda: kernels.binned_curve_counts(scores, labels, valid, thresholds)  # noqa: E731
    record = {
        "kernel": "binned_curve_counts", "n": n, "thresholds": t, "unsorted_ties": unsorted_ties,
        "labels_dtype": str(labels.dtype), "main_path": main_path, "max_abs_err": err,
        "kernel_ms": time_ms(call),
        "plain_ms": time_ms(lambda: kernels.binned_curve_counts_plain(scores, labels, valid, thresholds), reps=3),
        "library_ms": None,
        "composed_library_ms": time_ms(library),
        "composed_library": "searchsorted(sorted thresholds, right=True), masked code, bincount, flip-cumsum-flip",
        "bound_ms": curve_bound_ms(labels, t),
        "bound_by": bound_of(kernels.binned_curve_counts_cost(labels, t))[1],
        "compare_bound_ms": curve_compare_bound_ms(n, t),
        "host_us_per_call": host_us(call, calls=500),
    }
    record["_trace"] = lambda: curve_trace(call)
    return {**record, "launches": kernels.LAUNCHES["binned_curve_counts"] - before}


def curve_trace(call) -> dict:
    """The device operations of one call (torch.profiler): one kernel and nothing else."""
    ran = device_kernels_per_call(call)
    if ran["per_call"] != 1 or any("curve_" not in name for name in ran["names"]):
        raise AssertionError(f"binned_curve_counts ran {ran} device operations per call, expected one kernel")
    return traced(ran)


def traced(ran: dict) -> dict:
    """A record's keys for what ``device_kernels_per_call`` found."""
    return {"device_kernels_per_call": ran["per_call"], "device_kernels": ran["names"],
            "device_us_per_call": ran["device_us"]}


def weighted_case(n: int, k: int, c: int, seed: int, device: str = "cuda"):
    """Indices with about 1% outside [0, C); K weight rows, the last a 0/1 count row and
    the others floats in [0, 1), each with 20% zeros (calibration's rows are
    confidence * valid, accuracy * valid and valid)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randint(0, c, (n,), generator=g, device=device, dtype=torch.int32)
    bad = torch.rand(n, generator=g, device=device) < 0.01
    x = torch.where(bad, torch.where(x % 2 == 0, c + 7, -1), x).to(torch.int32)
    keep = (torch.rand((k, n), generator=g, device=device) >= 0.2).to(torch.float32)
    w = torch.rand((k, n), generator=g, device=device) * keep
    w[-1] = keep[-1]
    return x, w


def kernel_record_weighted_bincount(n: int, k: int, c: int, seed: int, main_path: bool) -> dict:
    """Also: the device kernels one call runs (torch.profiler; it must be one) and the
    host µs of each step of a call."""
    import torch

    from torchmetrics_tpu_torch.ops import kernels

    x, w = weighted_case(n, k, c, seed)
    before = kernels.LAUNCHES["weighted_bincount"]
    got = kernels.weighted_bincount(x, w, c)
    torch.cuda.synchronize()
    got = got.cpu()
    want = kernels.weighted_bincount_plain(x.cpu(), w.cpu(), c)
    err = float((got.to(torch.float64) - want.to(torch.float64)).abs().max())
    if not torch.equal(got[-1], want[-1]):
        raise AssertionError(f"weighted_bincount count row != plain at N={n}, K={k}, C={c}")
    torch.testing.assert_close(got, want, rtol=WEIGHTED_RTOL, atol=0)
    # the yardstick: one index_add_ over the same function's in-range samples (an index
    # outside [0, C) would fail it on the card)
    in_range = (x >= 0) & (x < c)
    x_lib = torch.where(in_range, x, torch.zeros_like(x))
    w_lib = w * in_range
    library = torch.zeros((k, c), device=w.device).index_add_(1, x_lib, w_lib)
    torch.testing.assert_close(library.cpu(), want, rtol=1e-3, atol=1e-2)  # float32 atomics, in any order
    record = {
        "kernel": "weighted_bincount", "n": n, "rows": k, "bins": c, "main_path": main_path, "max_abs_err": err,
        "kernel_ms": time_ms(lambda: kernels.weighted_bincount(x, w, c)),
        "plain_ms": time_ms(lambda: kernels.weighted_bincount_plain(x, w, c)),
        "library_ms": time_ms(lambda: torch.zeros((k, c), device=w.device).index_add_(1, x_lib, w_lib)),
        "bound_ms": bound_of(kernels.weighted_bincount_cost(n, k, c))[0],
        "bound_by": bound_of(kernels.weighted_bincount_cost(n, k, c))[1],
    }
    record["host_us"] = weighted_host_breakdown(x, w, c, calls=500)
    record["_trace"] = lambda: weighted_trace(lambda: kernels.weighted_bincount(x, w, c))
    return {**record, "launches": kernels.LAUNCHES["weighted_bincount"] - before}


def weighted_trace(call) -> dict:
    """The device kernels of one call (torch.profiler): it must be one."""
    ran = device_kernels_per_call(call)
    if ran["per_call"] != 1 or any("weighted_bincount_kernel" not in name for name in ran["names"]):
        raise AssertionError(f"weighted_bincount ran {ran} device kernels per call, not one")
    return traced(ran)


def trace_records(records: list) -> None:
    """Run each record's torch.profiler check, after every timing of the ``kernels``
    phase: a process that has run the profiler spends more host time per launch from
    then on. (Single-call traces taken after the eval phases' profiles held no device
    event, so they run before those phases.)"""
    for record in records:
        trace = record.pop("_trace", None)
        if trace is not None:
            record.update(trace())


def weighted_host_breakdown(x, w, c: int, calls: int = 2000) -> dict:
    """Host µs per call of each step of ``kernels.weighted_bincount`` on these inputs,
    each step timed alone over ``calls`` calls, and of the whole call."""
    import torch

    from torchmetrics_tpu_torch.ops import kernels

    index = w.get_device()
    k, n = w.shape
    stream = kernels._raw_stream(index)
    scratch = lambda: kernels._stream_scratch(kernels._WEIGHTED_SCRATCH, index, stream,  # noqa: E731
                                              kernels._weighted_scratch_bytes(k, c), zero=True)
    out = w.new_empty((k, c))
    fn = kernels._entry_point("weighted_bincount")
    args = (x.data_ptr(), w.data_ptr(), n, k, c, scratch().data_ptr(), out.data_ptr(), stream)
    return {
        "checks_and_casts": host_us(lambda: (kernels._on_card(x, w), x.dim() != 1, x.dtype != torch.int32,
                                             x.is_contiguous(), w.dtype != torch.float32, w.is_contiguous(),
                                             w.ndim != 2 or w.shape[1] != x.numel()), calls),
        "empty_out": host_us(lambda: w.new_empty((k, c)), calls),
        "stream_lookup": host_us(lambda: (w.get_device(), torch.cuda.current_device(), kernels._raw_stream(index)),
                                 calls),
        "scratch_lookup": host_us(scratch, calls),
        "ctypes_call_and_launch": host_us(lambda: fn(*args), calls),
        "whole_call": host_us(lambda: kernels.weighted_bincount(x, w, c), calls),
    }


def query_ids(queries: int = 6980, candidates: int = 1000, seed: int = 9, device: str = "cuda"):
    """int32 query ids of a top-``candidates`` reranking run, ``candidates`` per query,
    in a seeded order."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    ids = torch.arange(queries, device=device, dtype=torch.int32).repeat_interleave(candidates)
    return ids[torch.randperm(ids.numel(), generator=g, device=device)]


def bincount_case(n: int, c: int, seed: int, ids: str = "random", dtype=None):
    """Indices for the bincount kernel, int32 unless ``dtype`` is given: "queries", the
    query ids of a reranking run (C queries, N / C candidates each) in a seeded order;
    "segments", the fairness update's bins of N CTR scores over (C - 1) / 4 segments;
    "grouped", the same ids grouped by query, as retrieval users pass them (runs of
    N / C equal ids); "cityscapes", the (target, pred) ids of a Cityscapes update's
    per-image tables (``n * 20^2 + t' * 20 + p'``, void as bin 19); "random", uniform in
    [0, C)."""
    import torch

    if ids == "queries":
        x = query_ids(c, n // c, seed)
    elif ids == "segments":
        x = segment_cell_ids(n, (c - 1) // 4, seed)
    elif ids == "grouped":
        x = torch.arange(c, device="cuda", dtype=torch.int32).repeat_interleave(n // c)
    elif ids == "cityscapes":
        preds, target = cityscapes_batch(seed, batch=n // (1024 * 2048))
        side = CITYSCAPES_CLASSES + 1
        image = torch.arange(preds.shape[0], device="cuda")[:, None, None]
        x = ((image * side + target.clamp(max=CITYSCAPES_CLASSES)) * side + preds).reshape(-1)
    else:
        g = torch.Generator(device="cuda").manual_seed(seed)
        x = torch.randint(0, c, (n,), generator=g, device="cuda", dtype=torch.int32)
    return x if dtype is None else x.to(dtype)


def bincount_bound_ms(x, c: int) -> float:
    """The indices read at their own width, int32 [C] written (``kernels.bincount_cost``)."""
    from torchmetrics_tpu_torch.ops import kernels

    return bound_of(kernels.bincount_cost(x, c))[0]


def kernel_record_bincount(n: int, c: int, seed: int, main_path: bool, ids: str = "random", dtype=None) -> dict:
    """Also: the host µs of a call and, once every record is timed, the device operations
    of one call (torch.profiler: one kernel)."""
    import torch

    from torchmetrics_tpu_torch.ops import kernels

    x = bincount_case(n, c, seed, ids, dtype)
    before = kernels.LAUNCHES["bincount"]
    got = kernels.bincount(x, None, c)
    torch.cuda.synchronize()
    want = kernels.bincount_plain(x.cpu(), c)
    err = int((got.cpu().to(torch.int64) - want.to(torch.int64)).abs().max())
    if not torch.equal(got.cpu(), want):
        raise AssertionError(f"bincount kernel != plain at N={n}, C={c}, {ids} {x.dtype} ids: max abs err {err}")
    if not torch.equal(torch.bincount(x, minlength=c).cpu().to(torch.int32), want):
        raise AssertionError("the torch.bincount yardstick disagrees with the plain version")
    call = lambda: kernels.bincount(x, None, c)  # noqa: E731
    record = {
        "kernel": "bincount", "n": n, "bins": c, "ids": ids, "dtype": str(x.dtype).removeprefix("torch."),
        "main_path": main_path, "max_abs_err": err,
        "kernel_ms": time_ms(call),
        "plain_ms": time_ms(lambda: kernels.bincount_plain(x, c)),
        "library_ms": time_ms(lambda: torch.bincount(x, minlength=c)),
        "bound_ms": bincount_bound_ms(x, c),
        "bound_by": bound_of(kernels.bincount_cost(x, c))[1],
        "host_us_per_call": host_us(call, calls=500),
    }
    record["_trace"] = lambda: bincount_trace(call)
    return {**record, "launches": kernels.LAUNCHES["bincount"] - before}


def bincount_trace(call) -> dict:
    """The device operations of one call (torch.profiler): one kernel and nothing else."""
    ran = device_kernels_per_call(call)
    if ran["per_call"] != 1 or any("bincount_" not in name for name in ran["names"]):
        raise AssertionError(f"bincount ran {ran} device operations per call, expected one kernel")
    return traced(ran)


def _window(kind: str, size: int, sigma: float, device: str = "cuda"):
    """A 1D SSIM window: the port's cached gaussian, or a uniform one."""
    import torch

    from torchmetrics_tpu_torch.functional.image.utils import _gaussian

    if kind == "uniform":
        return torch.full((size,), 1.0 / size, device=device)
    return _gaussian(size, sigma, torch.float32, device)[0]


def kernel_record_ssim_moments(planes: int, hp: int, wp: int, window_h: tuple, window_w: tuple, seed: int,
                               main_path: bool, nan: bool = False) -> dict:
    """Padded planes in [0, 1] (one NaN pixel with ``nan``); the yardstick is the grouped
    convolution of the JAX package's conv branch over the stacked products, timed alone."""
    import torch
    import torch.nn.functional as F

    from torchmetrics_tpu_torch.ops import kernels

    g = torch.Generator(device="cuda").manual_seed(seed)
    p = torch.rand(planes, hp, wp, generator=g, device="cuda")
    t = torch.rand(planes, hp, wp, generator=g, device="cuda")
    if nan:
        p[0, hp // 2, wp // 3] = float("nan")
    wh, ww = _window(*window_h), _window(*window_w)
    kh, kw = wh.numel(), ww.numel()
    ho, wo = hp - kh + 1, wp - kw + 1
    before = kernels.LAUNCHES["ssim_moments"]
    got = kernels.ssim_moments(p, t, wh, ww)
    torch.cuda.synchronize()
    got = got.cpu()
    want = kernels.ssim_moments_plain(p.cpu(), t.cpu(), wh.cpu(), ww.cpu())
    if not torch.equal(torch.isnan(got), torch.isnan(want)):
        raise AssertionError(f"ssim_moments kernel spreads NaN unlike the plain version at P={planes}, {hp}x{wp}")
    if nan:  # E[p], E[p^2] and E[pt] are NaN at every output whose window reads the pixel
        y, x = hp // 2, wp // 3
        reach = (min(y, ho - 1) - max(0, y - kh + 1) + 1) * (min(x, wo - 1) - max(0, x - kw + 1) + 1)
        if int(torch.isnan(want).sum()) != 3 * reach:
            raise AssertionError("the NaN pixel did not reach the moments whose windows read it")
    err = float(torch.nan_to_num((got - want).abs(), nan=0.0).max())
    if err > MOMENTS_ATOL:
        raise AssertionError(f"ssim_moments kernel != plain at P={planes}, {hp}x{wp}, {kh}x{kw}: max abs err {err}")

    channels = 3 if planes % 3 == 0 else 1
    stacked = torch.stack((p, t, p * p, t * t, p * t)).reshape(5 * planes // channels, channels, hp, wp)
    kernel2d = (wh[:, None] * ww[None, :]).expand(channels, 1, kh, kw).contiguous()

    cudnn = torch.backends.cudnn

    def library():
        # a single-channel stack is a cuDNN convolution: TF32 off for the yardstick's call
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                         allow_tf32=False):
            return F.conv2d(stacked, kernel2d, groups=channels)

    lib = library().reshape(5, planes, ho, wo).transpose(0, 1).cpu()
    finite = ~torch.isnan(want)
    library_err = float((lib - want).abs()[finite].max())
    if library_err > LIBRARY_CONV_ATOL:
        raise AssertionError(f"the float32 convolution yardstick disagrees with the plain version: {library_err}")
    big = planes * hp * wp > 1 << 24
    ops, nbytes = kernels.ssim_moments_cost(planes, hp, wp, kh, kw)
    byte_ms, op_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    kernel_ms = time_ms(lambda: kernels.ssim_moments(p, t, wh, ww), reps=10 if big else 20)
    record = {
        "kernel": "ssim_moments", "planes": planes, "hp": hp, "wp": wp, "kh": kh, "kw": kw, "nan": nan,
        "main_path": main_path, "max_abs_err": err, "library_max_abs_err": library_err,
        "kernel_ms": kernel_ms,
        "plain_ms": time_ms(lambda: kernels.ssim_moments_plain(p, t, wh, ww), reps=3, warmup=1),
        "library_ms": time_ms(library, reps=5 if big else 20, warmup=1),
        "library": "F.conv2d over the stacked products, groups=C, TF32 off, the convolution alone",
        "bound_ms": max(byte_ms, op_ms),
        "bound_by": "operations" if op_ms >= byte_ms else "bytes",
        # the bytes it must move over its time, and its bound over its time
        "gb_per_s": byte_ms / kernel_ms * HBM_BYTES_PER_S / 1e9,
        "bound_share": max(byte_ms, op_ms) / kernel_ms,
    }
    return {**record, "launches": kernels.LAUNCHES["ssim_moments"] - before}


# -------------------------------------------------------------------------- evals


def imagenet_metrics(device: str) -> dict:
    from torchmetrics_tpu_torch import classification as tc

    c = 1000
    kw = {"validate_args": False, "device": device}
    return {
        "accuracy_top1": tc.MulticlassAccuracy(c, average="micro", **kw),
        "accuracy_macro": tc.MulticlassAccuracy(c, average="macro", **kw),
        "f1_macro": tc.MulticlassF1Score(c, average="macro", **kw),
        "precision_macro": tc.MulticlassPrecision(c, average="macro", **kw),
        "recall_macro": tc.MulticlassRecall(c, average="macro", **kw),
        "confusion_matrix": tc.MulticlassConfusionMatrix(c, **kw),
        "jaccard_macro": tc.MulticlassJaccardIndex(c, average="macro", **kw),
        "matthews": tc.MulticlassMatthewsCorrCoef(c, **kw),
        "cohen_kappa": tc.MulticlassCohenKappa(c, **kw),
        "calibration_error_b15": tc.MulticlassCalibrationError(c, n_bins=15, **kw),
        "auroc_t100": tc.MulticlassAUROC(c, thresholds=100, **kw),
        "pr_curve_micro_t200": tc.MulticlassPrecisionRecallCurve(c, average="micro", thresholds=200, **kw),
    }


def imagenet_data(n: int = 50_000, c: int = 1000, seed: int = 0, device: str = "cuda"):
    """Seeded logits with a signal on the true class; the metrics get their softmax.

    The softmax runs once, on the card, as a model's head would: the card's run and
    the CPU run then score the same probability bits.
    """
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    target = torch.randint(0, c, (n,), generator=g, device=device)
    logits = torch.randn(n, c, generator=g, device=device)
    logits[torch.arange(n, device=device), target] += 3.0
    return torch.softmax(logits, dim=1), target


def binary_metrics(device: str) -> dict:
    from torchmetrics_tpu_torch import classification as tc

    kw = {"validate_args": False, "device": device, "ignore_index": -1}
    return {
        "auroc_t1000": tc.BinaryAUROC(thresholds=1000, **kw),
        "accuracy": tc.BinaryAccuracy(**kw),
        "f1": tc.BinaryF1Score(**kw),
        "confusion_matrix": tc.BinaryConfusionMatrix(**kw),
        "average_precision_t1000": tc.BinaryAveragePrecision(thresholds=1000, **kw),
        "matthews": tc.BinaryMatthewsCorrCoef(**kw),
        "jaccard": tc.BinaryJaccardIndex(**kw),
        "calibration_error_b15": tc.BinaryCalibrationError(n_bins=15, **kw),
    }


def binary_data(n: int = 1 << 22, seed: int = 1, device: str = "cuda"):
    """Click labels, 1% ignored (-1), and the sigmoid of seeded logits as scores."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    target = torch.randint(0, 2, (n,), generator=g, device=device)
    logits = torch.randn(n, generator=g, device=device) + 1.2 * target - 0.6
    target = torch.where(torch.rand(n, generator=g, device=device) < 0.01, -1, target)
    return torch.sigmoid(logits), target


def run_loop(metrics: dict, preds, target, batch: int, snapshot_after: int | None = None):
    """Update every metric batch by batch (``preds`` and ``target`` are tensors or lists,
    sliced alike), then compute; returns (values, states, seconds, snapshot), where
    ``snapshot`` is the (values, states) after ``snapshot_after`` steps, taken with the
    clock stopped, or the final ones where that is None."""
    import torch

    def taken() -> tuple:
        return ({name: m.compute() for name, m in metrics.items()},
                {name: m.state_dict(persistent_only=False) for name, m in metrics.items()})

    snapshot = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step, start in enumerate(range(0, len(preds), batch), 1):
        p, t = preds[start:start + batch], target[start:start + batch]
        for m in metrics.values():
            m.update(p, t)
        if step == snapshot_after:
            torch.cuda.synchronize()
            paused = time.perf_counter()
            snapshot = taken()
            torch.cuda.synchronize()
            t0 += time.perf_counter() - paused
    values = {name: m.compute() for name, m in metrics.items()}
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    states = {name: m.state_dict(persistent_only=False) for name, m in metrics.items()}
    return values, states, seconds, snapshot or (values, states)


def _classification_tolerance(where: str):
    return FLOAT_ATOL, BINS_RTOL if where.endswith(".bins") else 0.0


def compare(card, cpu, where: str, tolerance=_classification_tolerance) -> float:
    """Integers (and thresholds) equal, floats within ``tolerance(where)`` = (atol, rtol of
    the CPU's value): FLOAT_ATOL, plus BINS_RTOL for a calibration ``bins`` state, in the
    classification phases. Returns the largest float gap."""
    import torch

    if isinstance(card, dict):
        return max([compare(card[k], cpu[k], f"{where}.{k}", tolerance) for k in card] or [0.0])
    if isinstance(card, (list, tuple)):
        return max([compare(a, b, f"{where}[{i}]", tolerance)
                    for i, (a, b) in enumerate(zip(card, cpu, strict=True))] or [0.0])
    a, b = card.cpu(), cpu
    if a.shape != b.shape or a.dtype != b.dtype:
        raise AssertionError(f"{where}: card {tuple(a.shape)} {a.dtype} vs cpu {tuple(b.shape)} {b.dtype}")
    if not a.is_floating_point():
        if not torch.equal(a, b):
            raise AssertionError(f"{where}: integer state differs between the card and the CPU")
        return 0.0
    if not a.numel():
        return 0.0
    both_nan = torch.isnan(a) & torch.isnan(b)
    diff = torch.where(both_nan, torch.zeros_like(a), (a - b).abs())
    atol, rtol = tolerance(where)
    excess = diff - (atol + rtol * b.abs())
    if not bool((excess <= 0).all()):
        raise AssertionError(f"{where}: float gap {float(diff.max())} over {atol} + {rtol} * |cpu|")
    return float(diff.max())


def eval_phase(name: str, metrics_fn, data, batch: int, required: tuple, profile_steps: int,
               cpu_steps: int) -> dict:
    """Drive the main path on the card with fresh launch counts, then the same loop on the
    CPU over the first ``cpu_steps`` steps, against the card's states and values
    snapshotted after the same step."""
    from torchmetrics_tpu_torch.ops import kernels

    preds, target = data
    steps = -(-preds.shape[0] // batch)
    card_metrics = metrics_fn("cuda")
    kernels.reset_launch_counts()
    card_values, _, seconds, (prefix_values, prefix_states) = run_loop(card_metrics, preds, target, batch,
                                                                         snapshot_after=cpu_steps)
    launches = dict(kernels.LAUNCHES)
    for kernel in required:
        if launches[kernel] <= 0:
            raise AssertionError(f"{name}: kernel {kernel} was never launched on the main path")

    rows = cpu_steps * batch
    cpu_values, cpu_states, cpu_seconds, _ = run_loop(metrics_fn("cpu"), preds[:rows].cpu(), target[:rows].cpu(),
                                                      batch)
    gaps = {
        metric: {"state": compare(prefix_states[metric], cpu_states[metric], f"state.{metric}"),
                 "value": compare(prefix_values[metric], cpu_values[metric], f"value.{metric}")}
        for metric in prefix_states
    }
    summary = {}
    for metric, value in card_values.items():
        if isinstance(value, tuple):  # a curve: report its size
            summary[metric] = {"points": int(value[0].numel())}
        elif value.numel() == 1:
            summary[metric] = float(value)
        else:
            summary[metric] = {"shape": list(value.shape), "sum": int(value.sum())}
    return {
        "phase": name, "samples": int(preds.shape[0]), "batch": batch, "steps": steps,
        "wall_s": seconds, "us_per_step": seconds / steps * 1e6, "launches": launches,
        "cpu_compared_steps": cpu_steps, "cpu_wall_s": cpu_seconds, "max_float_gap": max(max(g.values()) for g in gaps.values()),
        "float_gaps": {metric: g for metric, g in gaps.items() if any(g.values())}, "values": summary,
        "profile": profile_loop(metrics_fn("cuda"), preds, target, batch, profile_steps),
    }


# ------------------------------------------------------------------ collections

# (set, metrics, data, batch, profiled steps): the two eval loops, as MetricCollections
COLLECTION_SETS = (("imagenet", imagenet_metrics, imagenet_data, 500, 10),
                   ("binary", binary_metrics, binary_data, 1 << 18, 4))
COLLECTION_KERNELS = ("confusion_matrix", "binned_curve_counts", "weighted_bincount")
# alternating (per metric, grouped) pairs timed in one process, no profiler in between
COLLECTION_PAIRS = 5
# the two-rank world: its rendezvous and each collective, then the whole world
SYNC_COLLECTIVE_TIMEOUT_S = 120
SYNC_WORLD_TIMEOUT_S = 300
# synced computes timed on each side, alternating, after one untimed compute of each
SYNC_REPEATS = 4


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree.cpu()


def bitwise_equal(a, b) -> bool:
    """Equal dtypes, shapes and bits (NaN included)."""
    import torch

    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(bitwise_equal(x, y) for x, y in zip(a, b))
    a, b = a.cpu().contiguous(), b.cpu().contiguous()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    return torch.equal(a.view(bits), b.view(bits))


def collection_states(col) -> dict:
    """{metric: {state: tensor}} of a collection, as ``run_loop`` gives a per-metric loop's."""
    return {name: m.state_dict(persistent_only=False) for name, m in col.items(keep_base=True)}


def collection_eval_phase() -> tuple:
    """Each eval loop's metrics as one MetricCollection with compute groups, on the card,
    against the same metrics one by one: launches per step, µs per step from alternating
    pairs, then one profile of each grouped loop; integer states and every grouped
    member's value must be bitwise the per-metric loop's, other floats within the
    classification tolerance. Returns the phase and, for ``collection_sync``, each
    grouped loop's values and states."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.ops import kernels

    sets, launches, data, reference = {}, {name: 0 for name in kernels.LAUNCHES}, {}, {}
    for kind, metrics_fn, data_fn, batch, _ in COLLECTION_SETS:
        preds, target = data[kind] = data_fn()
        steps = -(-preds.shape[0] // batch)
        us = {"per_metric": [], "grouped": []}
        runs = {}
        for pair in range(COLLECTION_PAIRS):
            for side in ("per_metric", "grouped") if pair % 2 == 0 else ("grouped", "per_metric"):
                metrics = metrics_fn("cuda")
                col = MetricCollection(metrics) if side == "grouped" else None
                kernels.reset_launch_counts()
                if col is None:
                    values, states, seconds, _ = run_loop(metrics, preds, target, batch)
                else:
                    values, _, seconds, _ = run_loop({"all": col}, preds, target, batch)
                    values, states = values["all"], collection_states(col)
                us[side].append(seconds / steps * 1e6)
                if side not in runs:
                    runs[side] = {"values": values, "states": to_cpu(states), "launches": dict(kernels.LAUNCHES),
                                  "groups": col.compute_groups if col is not None else None}
        grouped, per_metric = runs["grouped"], runs["per_metric"]
        for kernel in COLLECTION_KERNELS:
            if grouped["launches"][kernel] <= 0:
                raise AssertionError(f"collection_eval {kind}: kernel {kernel} was never launched by the collection")
        for name in launches:
            launches[name] += grouped["launches"][name]
        state_gap = max(compare(grouped["states"][m], per_metric["states"][m], f"state.{m}")
                        for m in per_metric["states"])
        value_gap, bitwise = 0.0, []
        for members in grouped["groups"].values():
            for m in members:
                if len(members) > 1:
                    if not bitwise_equal(grouped["values"][m], per_metric["values"][m]):
                        raise AssertionError(f"collection_eval {kind}: grouped member {m}'s value is not bitwise"
                                             " the per-metric loop's")
                    bitwise.append(m)
                else:
                    value_gap = max(value_gap, compare(grouped["values"][m], to_cpu(per_metric["values"][m]),
                                                       f"value.{m}"))
        sets[kind] = {
            "samples": int(preds.shape[0]), "batch": batch, "steps": steps,
            "groups": [list(g) for g in grouped["groups"].values()],
            "launches_per_step": {side: {k: runs[side]["launches"][k] / steps for k in COLLECTION_KERNELS}
                                  for side in ("per_metric", "grouped")},
            "us_per_step": us, "us_per_step_mean": {side: statistics.mean(v) for side, v in us.items()},
            "us_per_step_median": {side: statistics.median(v) for side, v in us.items()},
            "bitwise_members": bitwise, "max_state_float_gap": state_gap, "max_value_float_gap": value_gap,
        }
        reference[kind] = {"values": to_cpu(grouped["values"]), "states": grouped["states"]}
    # one profile of each grouped loop, after every timing
    for kind, metrics_fn, _, batch, profile_steps in COLLECTION_SETS:
        preds, target = data.pop(kind)
        sets[kind]["profile"] = profile_loop({"all": MetricCollection(metrics_fn("cuda"))}, preds, target, batch,
                                             profile_steps)
    return {"phase": "collection_eval", "sets": sets, "launches": launches}, reference


# ------------------------------------------------------------------- pipeline

# the fused chunk of the third variant, and the two faulted ImageNet batches (chunks 1
# and 5 of 8) of the fault run
PIPELINE_FUSE = 8
# one round of the three variants: a cut of script time that pays for ``model_image_eval``
# (two alternating rounds before; the checks are those of every round)
PIPELINE_ROUNDS = 1
PIPELINE_FAULTS = (13, 42)
# batches of each set that the card's fused pipeline and the CPU's run alike: a full
# chunk and a padded one (ImageNet 8 + 1; CTR 1, padded to 8, since the same cut): a CPU
# step costs 1.7 s of ImageNet and 7 s of CTR (its 1000-threshold curves)
PIPELINE_CPU_BATCHES = {"imagenet": 9, "binary": 1}
PIPELINE_VARIANTS = ("eager", "fuse_1", "fuse_8")


def release_graphs() -> None:
    """Free the CUDA graphs (and their memory pools) of the pipelines just dropped: a
    pipeline's fused function refers to the pipeline, so only the collector frees it."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def batches_of(preds, target, batch: int, count: int | None = None) -> list:
    steps = -(-preds.shape[0] // batch)
    return [(preds[i * batch:(i + 1) * batch], target[i * batch:(i + 1) * batch]) for i in range(steps)][:count]


def pipeline_run(metrics_fn, device: str, batches: list, variant: str) -> dict:
    """One pass of a variant over ``batches`` with fresh metrics: ``eager`` is the
    grouped collection's own loop, ``fuse_1`` and ``fuse_8`` a MetricPipeline over it,
    captured by its warmup before the clock starts. Launch counts are zeroed just before
    the timed pass and read just after; the wall clock covers the pass and ``compute``
    and ends in a synchronise."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig
    from torchmetrics_tpu_torch.ops import kernels

    col = MetricCollection(metrics_fn(device))
    pipe, manifest = None, None
    if variant != "eager":
        pipe = MetricPipeline(col, PipelineConfig(fuse=1 if variant == "fuse_1" else PIPELINE_FUSE))
        manifest = pipe.warmup(*batches[0])
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    if pipe is None:
        for p, t in batches:
            col.update(p, t)
    else:
        pipe.run(batches)
    values = col.compute()
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    out = {"seconds": seconds, "launches": dict(kernels.LAUNCHES), "values": values,
           "states": to_cpu(collection_states(col)), "col": col}
    if pipe is not None:
        report, info = pipe.report(), pipe.cache_info()
        out.update({
            "report": report.asdict(), "replays": sum(i["replays"] for i in info),
            "misses_in_loop": sum(i["misses"] for i in info),
            "variants": manifest["variants"], "capture_s": manifest["total_compile_seconds"], "pipe": pipe,
        })
    return out


# the device kernels of K1, K2 and K3 by a part of their names (their .cu sources)
DEVICE_KERNEL_NAMES = {"confusion_matrix": "confusion_matrix_", "binned_curve_counts": "curve_",
                       "weighted_bincount": "weighted_bincount_kernel"}


def profile_pipeline(metrics_fn, batches: list, variant: str, lead: int = 1) -> dict:
    """A torch.profiler trace of one variant's pass over ``batches`` after its warmup:
    device time per step, the busy share of the wall clock, and the K1/K2/K3 device
    kernels the trace holds beside the launches the wrappers counted in the pass (for a
    pipeline, through its replays). ``lead`` small kernels run to completion in the trace
    before the pass: the trace is live when the pass starts, and a retry with another
    lead puts the pass's kernels at other positions of the trace's records."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig
    from torchmetrics_tpu_torch.ops import kernels

    col = MetricCollection(metrics_fn("cuda"))
    if variant == "eager":
        def loop():
            for p, t in batches:
                col.update(p, t)
        loop()
        col.reset()
    else:
        pipe = MetricPipeline(col, PipelineConfig(fuse=1 if variant == "fuse_1" else PIPELINE_FUSE))
        pipe.warmup(*batches[0])

        def loop():
            pipe.run(batches)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(lead):
            torch.cuda._sleep(1)  # a kernel of its own name, left out of the sums below
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loop()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counted = {k: kernels.LAUNCHES[k] for k in COLLECTION_KERNELS}
    device_us, events, traced_kernels = 0.0, 0, {k: 0 for k in COLLECTION_KERNELS}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA and "spin_kernel" not in e.key:
            device_us += us
            events += e.count
            for k in COLLECTION_KERNELS:
                if DEVICE_KERNEL_NAMES[k] in e.key:
                    traced_kernels[k] += e.count
    steps = len(batches)
    return {"steps": steps, "wall_ms_per_step": wall / steps * 1e3, "device_ms_per_step": device_us / steps / 1e3,
            "device_busy_share": device_us / 1e6 / wall if wall else None, "device_events": events,
            "counted_launches": counted, "traced_kernels": traced_kernels}


def pipeline_fault_run(batches: list) -> dict:
    """ImageNet through the fused pipeline under the ``quarantine`` policy with NaN put
    into two batches: exactly those two update indices must be quarantined, their two
    chunks replayed per batch, and the state must equal the eager loop without them."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig
    from torchmetrics_tpu_torch.robust import error_policy, faults

    col = MetricCollection(imagenet_metrics("cuda"))
    dump_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "flight")
    pipe = MetricPipeline(col, PipelineConfig(fuse=PIPELINE_FUSE, flight_dump_dir=dump_dir))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with error_policy("quarantine"), faults.inject_nan_updates(indices=PIPELINE_FAULTS):
            report = pipe.run(batches)
    values = col.compute()
    leaders = [members[0] for members in col.compute_groups.values()]
    quarantined = {name: [q["update_index"] for q in col[name].quarantined_batches] for name in leaders}
    for name, indices in quarantined.items():
        if indices != list(PIPELINE_FAULTS):
            raise AssertionError(f"pipeline_eval fault run: {name} quarantined {indices}, not {list(PIPELINE_FAULTS)}")
    if report.chunks_replayed != len(PIPELINE_FAULTS) or report.replayed_batches != PIPELINE_FUSE * 2:
        raise AssertionError(f"pipeline_eval fault run: {report.chunks_replayed} chunks and"
                             f" {report.replayed_batches} batches replayed, not 2 chunks of {PIPELINE_FUSE}")
    clean = MetricCollection(imagenet_metrics("cuda"))
    for i, (p, t) in enumerate(batches):
        if i not in PIPELINE_FAULTS:
            clean.update(p, t)
    # the guarded leaders' state_dicts also carry their guard counters (`__robust__`)
    states = {m: {k: v for k, v in st.items() if k != "__robust__"} for m, st in collection_states(col).items()}
    state_gap = compare(to_cpu(states), to_cpu(collection_states(clean)), "fault.state")
    value_gap = compare(to_cpu(values), to_cpu(clean.compute()), "fault.value")
    return {"faulted_batches": list(PIPELINE_FAULTS), "quarantined": quarantined,
            "chunks_replayed": report.chunks_replayed, "replayed_batches": report.replayed_batches,
            "fused_batches": report.fused_batches, "flight_dumps": len(pipe.flight_dumps),
            "max_state_float_gap": state_gap, "max_value_float_gap": value_gap}


def pipeline_eval_phase() -> dict:
    """Both eval loops as one grouped MetricCollection three ways, in PIPELINE_ROUNDS rounds:
    its own eager loop, a MetricPipeline with fuse=1 (one graph replay a step) and one
    with fuse=8 (one replay a chunk). Fails unless the pipelines equal the eager loop on
    the card, the fused one equals its CPU run on a prefix, every batch of a pipeline
    went through a replay (the replay count equals the chunk count, no miss and no
    degraded chunk in the loop), and the fault run quarantines exactly its batches.
    Profiles and peak memory come after every timing."""
    import torch

    from torchmetrics_tpu_torch.ops import kernels

    sets, data, launches = {}, {}, {name: 0 for name in kernels.LAUNCHES}
    for kind, metrics_fn, data_fn, batch, _ in COLLECTION_SETS:
        preds, target = data[kind] = data_fn()
        batches = batches_of(preds, target, batch)
        steps = len(batches)
        chunks = {"eager": steps, "fuse_1": steps, "fuse_8": -(-steps // PIPELINE_FUSE)}
        us, runs = {v: [] for v in PIPELINE_VARIANTS}, {}
        for rnd in range(PIPELINE_ROUNDS):
            order = PIPELINE_VARIANTS if rnd % 2 == 0 else PIPELINE_VARIANTS[::-1]
            for variant in order:
                run = pipeline_run(metrics_fn, "cuda", batches, variant)
                us[variant].append(run["seconds"] / steps * 1e6)
                if variant != "eager":
                    report = run["report"]
                    if run["replays"] != chunks[variant] or run["misses_in_loop"]:
                        raise AssertionError(f"pipeline_eval {kind} {variant}: {run['replays']} replays and"
                                             f" {run['misses_in_loop']} captures in the loop for {chunks[variant]}"
                                             " chunks")
                    if report["chunks_replayed"] or (variant == "fuse_8" and report["eager_batches"]):
                        raise AssertionError(f"pipeline_eval {kind} {variant}: a chunk degraded or a batch went eager")
                run.pop("pipe", None)
                run.pop("col")
                runs.setdefault(variant, run)
                release_graphs()
        eager = runs["eager"]
        for kernel in COLLECTION_KERNELS:
            if runs["fuse_8"]["launches"][kernel] <= 0:
                raise AssertionError(f"pipeline_eval {kind}: kernel {kernel} never launched through a replay")
        for name in launches:
            launches[name] += runs["fuse_8"]["launches"][name]
        gaps = {}
        for variant in ("fuse_1", "fuse_8"):
            gaps[variant] = {
                "state": max(compare(runs[variant]["states"][m], eager["states"][m], f"{variant}.state.{m}")
                             for m in eager["states"]),
                "value": compare(to_cpu(runs[variant]["values"]), to_cpu(eager["values"]), f"{variant}.value"),
                "bitwise_states": all(bitwise_equal(list(runs[variant]["states"][m].values()),
                                                    list(eager["states"][m].values())) for m in eager["states"]),
            }
        prefix = batches[:PIPELINE_CPU_BATCHES[kind]]
        card = pipeline_run(metrics_fn, "cuda", prefix, "fuse_8")
        cpu = pipeline_run(metrics_fn, "cpu", [(p.cpu(), t.cpu()) for p, t in prefix], "fuse_8")
        release_graphs()
        cpu_gap = max(compare(card["states"][m], cpu["states"][m], f"cpu.state.{m}") for m in cpu["states"])
        cpu_gap = max(cpu_gap, compare(to_cpu(card["values"]), cpu["values"], "cpu.value"))
        sets[kind] = {
            "samples": int(preds.shape[0]), "batch": batch, "steps": steps, "fuse": PIPELINE_FUSE,
            "us_per_step": us, "us_per_step_mean": {v: statistics.mean(x) for v, x in us.items()},
            "us_per_step_median": {v: statistics.median(x) for v, x in us.items()},
            "replays_per_batch": {v: runs[v]["replays"] / steps for v in ("fuse_1", "fuse_8")},
            "host_dispatches_per_batch": {v: runs[v]["report"]["dispatches_per_batch"] for v in ("fuse_1", "fuse_8")},
            "launches_per_step": {v: {k: runs[v]["launches"][k] / steps for k in COLLECTION_KERNELS}
                                  for v in PIPELINE_VARIANTS},
            "captured_variants": {v: runs[v]["variants"] for v in ("fuse_1", "fuse_8")},
            "capture_s": {v: runs[v]["capture_s"] for v in ("fuse_1", "fuse_8")},
            "padded_steps": runs["fuse_8"]["report"]["padded_steps"], "float_gaps": gaps,
            "cpu_compared_batches": len(prefix), "max_cpu_float_gap": cpu_gap,
        }
    imagenet_batches = batches_of(*data["imagenet"], COLLECTION_SETS[0][3])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    pipeline_run(imagenet_metrics, "cuda", imagenet_batches, "fuse_8")
    sets["imagenet"]["peak_mb_fuse_8"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    release_graphs()
    fault = pipeline_fault_run(imagenet_batches)
    release_graphs()
    # profiles after every timing: a process that has run the profiler is slower afterwards
    for kind, metrics_fn, _, batch, profile_steps in COLLECTION_SETS:
        batches = batches_of(*data.pop(kind), batch, count=2 * PIPELINE_FUSE)
        sets[kind]["profile"] = profiles = {v: profile_pipeline(metrics_fn, batches, v) for v in PIPELINE_VARIANTS}
        for variant in ("fuse_1", "fuse_8"):
            # the replay-counted launches must be kernels the card ran; a trace may drop
            # a kernel (the eager loop's drops one of 32 in some runs, the same record in
            # every trace of one run) but never adds one, so up to two more traces are
            # taken, each after another number of lead kernels, before the run fails
            per_step = sets[kind]["launches_per_step"][variant]
            want = {k: round(per_step[k] * len(batches)) for k in COLLECTION_KERNELS}
            got = profiles[variant]
            for attempt in (1, 2):
                if got["counted_launches"] == want and got["traced_kernels"] == want:
                    break
                again = profile_pipeline(metrics_fn, batches, variant, lead=1 + 97 * attempt)
                if sum(again["traced_kernels"].values()) > sum(got["traced_kernels"].values()):
                    got = profiles[variant] = again
            if got["counted_launches"] != want or got["traced_kernels"] != want:
                raise AssertionError(f"pipeline_eval {kind} {variant}: over {len(batches)} profiled steps the"
                                     f" wrappers counted {got['counted_launches']} and the trace holds"
                                     f" {got['traced_kernels']} K1/K2/K3 kernels, not {want}")
    return {"phase": "pipeline_eval", "sets": sets, "fault_run": fault, "launches": launches}


# -------------------------------------------------------------------- session

# the migrated session: the origin folds the first SESSION_CUT batches, holds the next
# SESSION_TAIL behind its cursor, and the restored process replays them and folds the
# rest; the restored process then runs 52 ImageNet / 10 CTR batches, which split into
# chunks of 8 and one unpadded bucket (4 / 2), so its launches per step are exact
SESSION_CUT = {"imagenet": 48, "binary": 6}
SESSION_TAIL = 2
# the crash run dies after this many fed batches (CTR: the whole stream, since a
# 16-batch cadence writes its one bundle at the end of the 16-batch stream)
SESSION_CRASH_AT = {"imagenet": 75, "binary": 16}
# the batch whose first score is NaN in the alert run
SESSION_NAN_BATCH = {"imagenet": 30, "binary": 5}
SESSION_TENANT = {"imagenet": "imagenet", "binary": "ctr"}
SESSION_ROUNDS = 3
SESSION_VARIANTS = ("plain", "alerts", "checkpoint")
# K1/K2/K3 launches per step of pipeline_eval's fuse=8 variant
SESSION_LAUNCHES_PER_STEP = {"imagenet": {"confusion_matrix": 2, "binned_curve_counts": 1, "weighted_bincount": 1},
                             "binary": {"confusion_matrix": 1, "binned_curve_counts": 1, "weighted_bincount": 1}}
SESSION_CHILD_TIMEOUT_S = 300


def session_root() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "session")


def session_engine():
    """An alert engine with its own value log: the non-finite and the out-of-bounds rule
    over every metric's scalar values."""
    from torchmetrics_tpu_torch.obs.alerts import AlertEngine, AlertRule
    from torchmetrics_tpu_torch.obs.values import ValueLog

    return AlertEngine(rules=[AlertRule(name="non_finite", kind="non_finite"),
                              AlertRule(name="out_of_bounds", kind="bounds")], value_log=ValueLog())


def session_config(kind: str, variant: str, directory: str, engine=None):
    from torchmetrics_tpu_torch.engine import PipelineConfig
    from torchmetrics_tpu_torch.engine.migrate import CheckpointPolicy

    policy = None
    if variant == "checkpoint":
        policy = CheckpointPolicy(directory=directory, every_batches=16, full_every=4, keep=4)
    return PipelineConfig(fuse=PIPELINE_FUSE, tenant=SESSION_TENANT[kind], alert_every=1,
                          alert_engine=engine if variant != "plain" else None, checkpoint=policy,
                          flight_dump_dir=os.path.join(session_root(), "flight"))


def session_run(kind: str, metrics_fn, batches: list, variant: str, directory: str) -> dict:
    """One tenant session over ``batches`` after its warmup: ``plain`` (fuse=8), with the
    alert engine evaluated at every commit, and with it and the continuous checkpoint
    policy too (the control). The clock covers the pass, ``compute`` and a synchronise."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine import MetricPipeline

    col = MetricCollection(metrics_fn("cuda"))
    engine = session_engine()
    pipe = MetricPipeline(col, session_config(kind, variant, directory, engine))
    pipe.warmup(*batches[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.run(batches)
    values = col.compute()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    pipe.close()
    stats = pipe._checkpointer.stats if pipe._checkpointer is not None else None
    return {"seconds": seconds, "values": to_cpu(values), "states": to_cpu(collection_states(col)),
            "firing": engine.firing(), "checkpoint_stats": stats, "flight_dumps": len(pipe.flight_dumps)}


def session_restore_set(kind: str, metrics_fn, data_fn, batch: int, bundle: str) -> dict:
    """The restored half of the migration, in a process of its own: fresh metrics,
    ``restore_session`` (the tail replays into the open chunk), a warmup that captures
    the restored pipeline's graphs (the cold start), then the rest of the stream with
    launch counts zeroed just before and read just after."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine.migrate import CheckpointPolicy, restore_session
    from torchmetrics_tpu_torch.obs import scope
    from torchmetrics_tpu_torch.ops import kernels

    batches = batches_of(*data_fn(), batch)
    col = MetricCollection(metrics_fn("cuda"))
    engine = session_engine()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe, manifest = restore_session(
        col, bundle, alert_engine=engine, value_log=engine._log(),
        flight_dump_dir=os.path.join(session_root(), "flight"),
        checkpoint=CheckpointPolicy(directory=os.path.join(session_root(), kind, "restored"), every_batches=16,
                                    full_every=4, keep=4))
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    cursor = manifest["cursor"]["batches_ingested"] + manifest["cursor"]["tail_batches"]
    origin_row = manifest["registry"]
    restored_row = next(r for r in scope.get_registry().rows() if r["tenant"] == SESSION_TENANT[kind])
    warm = pipe.warmup(*batches[cursor])
    before = pipe.report()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    pipe.run(batches[cursor:])
    values = col.compute()
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    report = pipe.report()
    pipe.close()
    row = next(r for r in scope.get_registry().rows() if r["tenant"] == SESSION_TENANT[kind])
    series = [s for s in engine._log().series() if s["tenant"] == SESSION_TENANT[kind]]
    return {
        "values": to_cpu(values), "states": to_cpu(collection_states(col)), "launches": launches,
        "steps": len(batches) - manifest["cursor"]["batches_ingested"],
        "padded_steps": report.padded_steps - before.padded_steps, "report": report.asdict(),
        "restore_s": restore_s, "capture_s": warm["total_compile_seconds"], "variants": warm["variants"],
        "origin_row": origin_row, "restored_row": restored_row, "row": row,
        "leaders": len(col.compute_groups),
        "series_steps": {f"{s['metric']}[{s['inst']}].{s['leaf']}": [p[0] for p in s["points"]] for s in series},
        "firing": engine.firing(), "lineage_epoch": pipe.lineage_epoch,
    }


def session_restore_worker(bundles: dict, queue) -> None:
    """The restoring process (spawned): every set's bundle restored on cuda:0; the
    result goes back as ``torch.save`` bytes."""
    import io
    import traceback

    import torch

    try:
        torch.cuda.set_device(0)
        out = {}
        for kind, metrics_fn, data_fn, batch, _ in COLLECTION_SETS:
            out[kind] = session_restore_set(kind, metrics_fn, data_fn, batch, bundles[kind])
            release_graphs()
        payload = io.BytesIO()
        torch.save(out, payload)
        queue.put((payload.getvalue(), None))
    except BaseException:  # reported to the parent, which fails the run
        queue.put((None, traceback.format_exc()))
        raise


def session_restore_elsewhere(bundles, worker=None) -> dict:
    """Run ``worker`` (default :func:`session_restore_worker`) on ``bundles`` in a
    spawned process and wait for it (a timeout on the whole process; a failure or a
    hang fails the run)."""
    import io
    import queue as queue_mod

    import torch
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    proc = ctx.Process(target=worker or session_restore_worker, args=(bundles, results))
    proc.start()
    try:
        deadline = time.monotonic() + SESSION_CHILD_TIMEOUT_S
        while True:
            if time.monotonic() > deadline:
                raise AssertionError("the restoring process hung")
            try:
                result, error = results.get(timeout=1)
                break
            except queue_mod.Empty:
                if proc.exitcode not in (None, 0):
                    raise AssertionError(f"the restoring process exited with {proc.exitcode}")
        if error is not None:
            raise AssertionError(f"the restoring process failed:\n{error}")
        proc.join(timeout=60)
        if proc.exitcode != 0:
            raise AssertionError(f"the restoring process ended with exit code {proc.exitcode}")
        return torch.load(io.BytesIO(result))
    finally:
        if proc.is_alive():
            proc.kill()
            proc.join()


def session_bitwise(where: str, got: dict, want: dict) -> None:
    """Every state and value of ``got`` bitwise ``want``'s."""
    for m in want["states"]:
        if not bitwise_equal(list(got["states"][m].values()), list(want["states"][m].values())):
            raise AssertionError(f"session_eval {where}: the states of {m} are not bitwise the control's")
    for m, value in want["values"].items():
        a = list(value) if isinstance(value, tuple) else value
        b = list(got["values"][m]) if isinstance(got["values"][m], tuple) else got["values"][m]
        if not bitwise_equal(a, b):
            raise AssertionError(f"session_eval {where}: the value of {m} is not bitwise the control's")


def session_eval_phase() -> dict:
    """A tenant session of each eval loop's grouped collection, migrated and crashed.

    1. Control: ``MetricPipeline(fuse=8)`` as tenant ``imagenet`` / ``ctr`` with an
       alert engine (non-finite and out-of-bounds rules, ``alert_every=1``) and
       ``CheckpointPolicy(every_batches=16, full_every=4, keep=4)``, in alternating
       rounds with the same session without the policy and without either.
    2. Migrated run: the same session anew folds the first half of the stream but for
       two batches it holds behind its cursor; ``drain`` and ``checkpoint_session``
       with those two as the tail.
    3. A spawned process restores each bundle on cuda:0, replays the tail, folds the
       rest and computes (``session_restore_worker``).
    4. Fencing: the origin's epoch is fenced; the origin's next bundle must raise
       ``FencedBundleError`` and the migration bundle must still verify.
    5. Crash recovery: a session with the policy dies mid-stream beside a torn
       ``bundle-*.tmp.*`` directory; ``latest_valid_bundle`` must skip it with a
       warning, and a restore plus a re-feed of the gap must compute the control.

    Fails unless every state and value of 3 and 5 is bitwise the control's, the
    restored process launched K1/K2/K3 at pipeline_eval's fuse=8 counts per step, its
    registry row, report and value timelines continue the origin's, no alert fired on
    clean data, and a NaN in one batch fires the non-finite rule with one flight dump.
    """
    import shutil

    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine import MetricPipeline
    from torchmetrics_tpu_torch.engine.migrate import (
        FencedBundleError,
        checkpoint_session,
        fence_epoch,
        latest_valid_bundle,
        restore_session,
        verify_bundle,
    )

    root = session_root()
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    sets, data, controls, bundles, origins = {}, {}, {}, {}, {}
    try:
        for kind, metrics_fn, data_fn, batch, _ in COLLECTION_SETS:
            batches = data[kind] = batches_of(*data_fn(), batch)
            steps = len(batches)
            us, runs = {v: [] for v in SESSION_VARIANTS}, {}
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            for rnd in range(SESSION_ROUNDS):
                order = SESSION_VARIANTS if rnd % 2 == 0 else SESSION_VARIANTS[::-1]
                for variant in order:
                    directory = os.path.join(root, kind, f"{variant}{rnd}")
                    run = session_run(kind, metrics_fn, batches, variant, directory)
                    us[variant].append(run["seconds"] / steps * 1e6)
                    if run["firing"]:
                        raise AssertionError(f"session_eval {kind} {variant}: alerts fired on clean data:"
                                             f" {run['firing']}")
                    runs.setdefault(variant, run)
                    session_bitwise(f"{kind} {variant} round {rnd}", run, runs["plain"] if "plain" in runs else run)
                    release_graphs()
            peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
            control = controls[kind] = runs["checkpoint"]
            session_bitwise(f"{kind} control", control, runs["plain"])
            stats = control["checkpoint_stats"]

            # 2. the migrated run's origin
            cut = SESSION_CUT[kind]
            col = MetricCollection(metrics_fn("cuda"))
            engine = session_engine()
            origin = MetricPipeline(col, session_config(kind, "checkpoint", os.path.join(root, kind, "origin"), engine))
            origin.warmup(*batches[0])
            for b in batches[:cut]:
                origin.feed(*b)
            migrate_dir = os.path.join(root, kind, "migrate")
            bundle = bundles[kind] = os.path.join(migrate_dir, "bundle-000000")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            manifest = checkpoint_session(origin, bundle, tail=batches[cut:cut + SESSION_TAIL])
            write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            verify_bundle(bundle)
            verify_s = time.perf_counter() - t0
            origins[kind] = (origin, col, manifest)
            sets[kind] = {
                "samples": int(sum(b[0].shape[0] for b in batches)), "batch": batch, "steps": steps,
                "tenant": SESSION_TENANT[kind], "fuse": PIPELINE_FUSE,
                "us_per_step": us, "us_per_step_mean": {v: statistics.mean(x) for v, x in us.items()},
                "us_per_step_median": {v: statistics.median(x) for v, x in us.items()},
                "control_bundles": {k: dict(v) for k, v in stats.items()},
                "bundle_bytes": {k: (v["bytes"] / v["count"] if v["count"] else None) for k, v in stats.items()},
                "migration_bundle_bytes": sum(os.path.getsize(os.path.join(bundle, f)) for f in os.listdir(bundle)),
                "bundle_write_s": write_s, "bundle_verify_s": verify_s,
                "origin_cursor": manifest["cursor"]["batches_ingested"], "tail": manifest["cursor"]["tail_batches"],
                "peak_mb_rounds": peak_mb,
            }
            del col
            release_graphs()

        # 3. the restoring process
        t0 = time.perf_counter()
        restored = session_restore_elsewhere(bundles)
        child_wall = time.perf_counter() - t0
        launches = {}
        for kind, _, _, _, _ in COLLECTION_SETS:
            got, record = restored[kind], sets[kind]
            session_bitwise(f"{kind} migrated", got, controls[kind])
            want = {k: n * got["steps"] for k, n in SESSION_LAUNCHES_PER_STEP[kind].items()}
            counted = {k: got["launches"][k] for k in want}
            if got["padded_steps"] or counted != want:
                raise AssertionError(f"session_eval {kind}: the restored process launched {counted} over"
                                     f" {got['steps']} steps ({got['padded_steps']} padded), not {want}")
            for name, n in got["launches"].items():
                launches[name] = launches.get(name, 0) + n
            origin_row, row = got["origin_row"], got["row"]
            if got["restored_row"]["updates"] != origin_row["updates"] or \
                    row["updates"] != origin_row["updates"] + got["leaders"] * got["steps"] or \
                    row["first_seen_unix"] != origin_row["first_seen_unix"]:
                raise AssertionError(f"session_eval {kind}: the registry row restarted: origin {origin_row},"
                                     f" restored {got['restored_row']}, final {row}")
            if got["report"]["batches"] != record["steps"] or got["report"]["processed_batches"] != record["steps"]:
                raise AssertionError(f"session_eval {kind}: the restored report counts {got['report']['batches']}"
                                     f" batches, not the stream's {record['steps']}")
            # a value series is keyed by metric instance: the origin's series come back
            # with their step anchors, and the restored metrics' own series go on from
            # the origin's update counts, not from 0
            cursor = record["origin_cursor"]
            carried = {k: s for k, s in got["series_steps"].items() if s and s[0] <= cursor}
            fresh = {k: s for k, s in got["series_steps"].items() if k not in carried}
            if not carried or not fresh or any(s != sorted(s) for s in got["series_steps"].values()) or \
                    any(s[-1] > cursor for s in carried.values()) or \
                    any(s[0] <= cursor or s[-1] != record["steps"] for s in fresh.values()):
                raise AssertionError(f"session_eval {kind}: the value timelines did not continue across the"
                                     f" move: {got['series_steps']}")
            if got["firing"]:
                raise AssertionError(f"session_eval {kind}: alerts fired in the restored process: {got['firing']}")
            record.update({"restore_s": got["restore_s"], "restored_capture_s": got["capture_s"],
                           "restored_captured_variants": got["variants"], "restored_steps": got["steps"],
                           "restored_launches_per_step": {k: got["launches"][k] / got["steps"] for k in want},
                           "registry_updates": {"origin": origin_row["updates"], "final": row["updates"]},
                           "value_series": {"carried": len(carried), "fresh": len(fresh)}})

            # 4. fencing: the origin writes again after its epoch is fenced
            origin, _, manifest = origins.pop(kind)
            migrate_dir = os.path.dirname(bundles[kind])
            fence_epoch(migrate_dir, origin.lineage_epoch, tenant=SESSION_TENANT[kind], by="session_eval")
            zombie = os.path.join(migrate_dir, "bundle-000001")
            checkpoint_session(origin, zombie)
            try:
                verify_bundle(zombie)
            except FencedBundleError:
                pass
            else:
                raise AssertionError(f"session_eval {kind}: the fenced origin's bundle verified")
            verify_bundle(bundles[kind])
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                chosen = latest_valid_bundle(migrate_dir)
            if chosen != bundles[kind] or not any("zombie" in str(w.message) for w in caught):
                raise AssertionError(f"session_eval {kind}: recovery chose {chosen} beside the fenced bundle")
            origin.close()
            record["fenced"] = {"epoch": origin.lineage_epoch, "zombie_rejected": True}
            release_graphs()

        # 5. crash recovery, and the NaN run
        for kind, metrics_fn, _, _, _ in COLLECTION_SETS:
            batches, record = data[kind], sets[kind]
            crash_dir = os.path.join(root, kind, "crash")
            col = MetricCollection(metrics_fn("cuda"))
            crashed = MetricPipeline(col, session_config(kind, "checkpoint", crash_dir, session_engine()))
            for b in batches[:SESSION_CRASH_AT[kind]]:
                crashed.feed(*b)
            torch.cuda.synchronize()
            del crashed, col  # the process "dies": no drain, no close, no final bundle
            release_graphs()
            torn = os.path.join(crash_dir, "bundle-000099.tmp.4242.deadbeef")
            os.makedirs(torn)
            with open(os.path.join(torn, "state.npz"), "wb") as fh:
                fh.write(b"PK\x03\x04 torn")
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                latest = latest_valid_bundle(crash_dir)
            if latest is None or not any(os.path.basename(torn) in str(w.message) for w in caught):
                raise AssertionError(f"session_eval {kind}: the crash scan chose {latest} and did not name the"
                                     " torn directory")
            col = MetricCollection(metrics_fn("cuda"))
            pipe, manifest = restore_session(col, latest, alert_engine=session_engine(),
                                             flight_dump_dir=os.path.join(root, "flight"))
            gap_from = manifest["cursor"]["batches_ingested"]
            pipe.run(batches[gap_from:])
            recovered = {"values": to_cpu(col.compute()), "states": to_cpu(collection_states(col))}
            pipe.close()
            session_bitwise(f"{kind} crash-recovered", recovered, controls[kind])
            record["crash"] = {"died_after": SESSION_CRASH_AT[kind], "restored_from": os.path.basename(latest),
                               "gap_refed": len(batches) - gap_from}
            del col, pipe
            release_graphs()

            poisoned = list(batches)
            p, t = poisoned[SESSION_NAN_BATCH[kind]]
            p = p.clone()
            p.view(-1)[0] = float("nan")
            poisoned[SESSION_NAN_BATCH[kind]] = (p, t)
            run = session_run_with_nan(kind, metrics_fn, poisoned)
            record["nan_run"] = run
            release_graphs()
    finally:
        for origin, _, _ in origins.values():
            origin.close()
        shutil.rmtree(root, ignore_errors=True)
    return {"phase": "session_eval", "sets": sets, "restoring_process_wall_s": child_wall, "launches": launches}


def session_run_with_nan(kind: str, metrics_fn, batches: list) -> dict:
    """The session with the alert engine over a stream with one NaN score: the
    non-finite rule must fire and the pipeline must write exactly one flight dump."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine import MetricPipeline

    col = MetricCollection(metrics_fn("cuda"))
    engine = session_engine()
    pipe = MetricPipeline(col, session_config(kind, "alerts", "", engine))
    pipe.run(batches)
    pipe.close()
    fired = sorted({a["rule"] for a in engine.firing()})
    dumps = pipe.flight_dumps
    if "non_finite" not in fired or len(dumps) != 1:
        raise AssertionError(f"session_eval {kind}: a NaN batch fired {fired} and wrote {len(dumps)} flight dumps")
    with open(dumps[0], encoding="utf-8") as fh:
        reason = json.loads(fh.readline())["reason"]
    if not reason.startswith("value_alert:") or "non_finite" not in reason:
        raise AssertionError(f"session_eval {kind}: the flight dump's reason is {reason!r}")
    return {"nan_batch": SESSION_NAN_BATCH[kind], "fired": fired, "flight_dumps": len(dumps), "reason": reason,
            "series_firing": sorted({a["series"] for a in engine.firing()})}


# --------------------------------------------------------------------- mux_eval

MUX_WIDTHS = (8, 64)
MUX_BATCH = 256
MUX_TENANT_UPDATES = 128
# timed passes of each side, in the order mux, baseline, baseline, mux
MUX_PASSES = 2
# the tenants the admission check holds to a small quota: one shed, one deferred
MUX_QUOTA = 2
# the NaN check: tenants of the group, the tenant whose batch is poisoned, its round
MUX_NAN_TENANTS = 8
MUX_NAN_AT = (3, 1)
MUX_CPU_TENANTS = 1
MUX_KERNELS = ("confusion_matrix", "binned_curve_counts", "weighted_bincount")


def mux_rounds(width: int) -> int:
    # one round past the admission quota, so that the quota sheds and defers at every width
    return max(MUX_QUOTA + 1, MUX_TENANT_UPDATES // width)


def mux_slice(preds, target, k: int):
    """The k-th batch of 256 rows of a data set, wrapping at its end."""
    k %= preds.shape[0] // MUX_BATCH
    return preds[k * MUX_BATCH:(k + 1) * MUX_BATCH], target[k * MUX_BATCH:(k + 1) * MUX_BATCH]


def mux_stream(preds, target, width: int, j: int) -> list:
    """Tenant j's batches: the warm round (slice j), then every timed pass, round r
    taking slice r * W + j, then one admission pass alike."""
    rounds = mux_rounds(width)
    order = [j] + [r * width + j for _ in range(MUX_PASSES + 1) for r in range(rounds)]
    return [mux_slice(preds, target, k) for k in order]


def mux_feed_pass(mux, tenants: list, streams: dict, start: int, rounds: int) -> None:
    for r in range(rounds):
        for j, t in enumerate(tenants):
            mux.feed(t, *streams[j][start + r])
    mux.flush()


def mux_base_pass(pipes: list, streams: dict, start: int, rounds: int) -> None:
    for r in range(rounds):
        for j, pipe in enumerate(pipes):
            pipe.feed(*streams[j][start + r])
    for pipe in pipes:
        pipe.flush()


def graph_parts(variant, replays: int = 5) -> dict:
    """One captured variant's dispatch in parts: the copies it makes on the host (its
    static inputs filled, its outputs cloned, one ``torch._foreach_copy_`` per dtype each
    way, as ``core/jit.py``'s replay makes them) with their host µs, and the device ms
    of its graph replayed alone (CUDA events on its stream)."""
    import torch

    from torchmetrics_tpu_torch.core.jit import _copy_by_dtype, _dtype_groups

    sources = [t.clone() for t in variant.inputs]
    outs = [t for t in variant.out_leaves if isinstance(t, torch.Tensor)]
    groups = _dtype_groups(outs)
    reps = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        variant.copy_in(sources)
    copy_in_us = (time.perf_counter() - t0) / reps * 1e6
    t0 = time.perf_counter()
    for _ in range(reps):
        _copy_by_dtype([torch.empty_like(t) for t in outs], outs, groups)
    clone_us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(variant.stream):
        variant.graph.replay()  # warm
        start.record()
        for _ in range(replays):
            variant.graph.replay()
        end.record()
    end.synchronize()
    return {"copy_in": len(variant.inputs), "clones": len(outs), "copy_in_us": copy_in_us, "clone_us": clone_us,
            "host_copy_us": copy_in_us + clone_us, "device_ms": start.elapsed_time(end) / replays}


def only_graph(cached):
    """The one captured variant of a capture cache."""
    (variant,) = [v for v in cached._compiled.values() if hasattr(v, "graph")]
    return variant


def mux_row_kernel_counts(metrics_fn, batch) -> dict:
    """What one row's update counts, all of it and the kernel wrappers' part (the
    capture cache's counter around one update of a fresh collection on the card)."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.core.jit import _CostCount

    col = MetricCollection(metrics_fn("cuda"))
    with _CostCount() as count:
        col.update(*batch)
    return {"flops": count.flops, "bytes": count.bytes_accessed, "kernel_flops": count.kernel_flops,
            "kernel_bytes": count.kernel_bytes}


def mux_cell(kind: str, metrics_fn, data, width: int, root: str) -> tuple:
    """One (collection, width) cell: the multiplexer and the per-tenant baseline timed in
    turns, then checks 1, 3, 5 and the slice of check 4 (restored by the caller)."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine import MetricPipeline, MuxConfig, PipelineConfig, TenantMultiplexer
    from torchmetrics_tpu_torch.engine.migrate import checkpoint_session
    from torchmetrics_tpu_torch.obs import scope
    from torchmetrics_tpu_torch.ops import kernels

    preds, target = data
    rounds = mux_rounds(width)
    tenants = [f"{kind}-m{j:02d}" for j in range(width)]
    streams = {j: mux_stream(preds, target, width, j) for j in range(width)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    # one bucket: every group of the run is full, so the default ladder's smaller graphs
    # would be captured by the warmup and never replayed
    mux = TenantMultiplexer(lambda: MetricCollection(metrics_fn("cuda")),
                            MuxConfig(max_width=width, width_buckets=(width,),
                                      flight_dump_dir=os.path.join(root, "flight")))
    for t in tenants:
        mux.adopt(t)
    manifest = mux.warmup(*streams[0][0])
    if manifest["estimated_flops"] is None or manifest["estimated_bytes"] is None:
        raise AssertionError(f"mux_eval {kind} W={width}: the warmup manifest has no estimated cost: {manifest}")
    pipes = [MetricPipeline(MetricCollection(metrics_fn("cuda")), PipelineConfig(fuse=1, tenant=f"{kind}-b{j:02d}"))
             for j in range(width)]
    base_manifests = [pipe.warmup(*streams[j][0]) for j, pipe in enumerate(pipes)]
    mux_feed_pass(mux, tenants, streams, 0, 1)  # the warm round
    mux_base_pass(pipes, streams, 0, 1)
    torch.cuda.synchronize()
    us = {"mux": [], "baseline": []}
    launches, dispatches = {}, 0
    for i, side in enumerate(("mux", "baseline", "baseline", "mux")):
        start = 1 + (rounds if i >= 2 else 0)  # each side's pass 0, then its pass 1
        before = mux.report()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        if side == "mux":
            mux_feed_pass(mux, tenants, streams, start, rounds)
        else:
            mux_base_pass(pipes, streams, start, rounds)
        torch.cuda.synchronize()
        us[side].append((time.perf_counter() - t0) / (rounds * width) * 1e6)
        if side == "mux":
            for name in MUX_KERNELS:
                launches[name] = launches.get(name, 0) + kernels.LAUNCHES[name]
            dispatches += mux.report().dispatches - before.dispatches
    report = mux.report()
    if report.replayed_updates or report.eager_updates or report.dispatches * width != report.fused_updates:
        raise AssertionError(f"mux_eval {kind} W={width}: groups degraded or ran eagerly: {report.asdict()}")
    want = {k: n * width * dispatches for k, n in SESSION_LAUNCHES_PER_STEP[kind].items()}
    if launches != want:
        raise AssertionError(f"mux_eval {kind} W={width}: the replays launched {launches} over {dispatches}"
                             f" dispatches, not {want}")
    (fused,) = mux._fused_fns.values()
    host = graph_parts(only_graph(fused))
    (step,) = pipes[0]._step_fns.values()
    base_parts = graph_parts(only_graph(step))
    # 4. a slice of the last tenant, mid-stream (its tail: the admission pass's batches)
    slice_tenant = width - 1
    bundle = os.path.join(root, f"{kind}-{width}", "slice")
    t0 = time.perf_counter()
    slice_manifest = checkpoint_session(mux, bundle, tenant=tenants[slice_tenant])
    slice_s = time.perf_counter() - t0
    # 3. admission: one tenant held to MUX_QUOTA updates and shed, one deferred
    charges = []
    controller = scope.AdmissionController()
    controller.set_quota(tenants[0], scope.TenantQuota(updates_per_window=MUX_QUOTA, window_seconds=3600.0))
    controller.set_quota(tenants[1], scope.TenantQuota(updates_per_window=MUX_QUOTA, window_seconds=3600.0,
                                                       over_quota=scope.DEFER))
    real_charge = controller.charge

    def charge(tenant, **kwargs):
        charges.append(kwargs)
        return real_charge(tenant, **kwargs)

    controller.charge = charge
    mux.config.admission = controller
    admission_start = 1 + MUX_PASSES * rounds
    mux_feed_pass(mux, tenants, streams, admission_start, rounds)
    final = mux.close()
    priced = [kw for kw in charges if "flops" in kw]
    if final.shed_batches != rounds - MUX_QUOTA or final.deferred_batches != rounds - MUX_QUOTA or \
            (rounds > MUX_QUOTA and not final.shed_batches) or \
            final.deferred_replayed != rounds - MUX_QUOTA or not priced or \
            any(kw["flops"] is None or kw["bytes_accessed"] is None or kw["flops"] <= 0 or kw["bytes_accessed"] <= 0
                for kw in priced):
        raise AssertionError(f"mux_eval {kind} W={width}: admission shed {final.shed_batches}, deferred"
                             f" {final.deferred_batches}, replayed {final.deferred_replayed}; charges {priced[:3]}")
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - base_mem) / 2**20
    # 1. every tenant bitwise its eager loop on the card (the shed tenant folds what was
    # admitted); at the widest W the first tenant also against the CPU (at W=8 the NaN run's does)
    t0 = time.perf_counter()
    cpu_s = 0.0
    for j, t in enumerate(tenants):
        fed = streams[j][:admission_start + (MUX_QUOTA if j == 0 else rounds)]
        eager = MetricCollection(metrics_fn("cuda"))
        for b in fed:
            eager.update(*b)
        session_bitwise(f"mux {kind} W={width} {t}", {"states": to_cpu(collection_states(mux.metric(t))),
                                                       "values": to_cpu(mux.compute(t))},
                        {"states": to_cpu(collection_states(eager)), "values": to_cpu(eager.compute())})
        if j < MUX_CPU_TENANTS and width == max(MUX_WIDTHS):
            t1 = time.perf_counter()
            cpu = MetricCollection(metrics_fn("cpu"))
            for p, y in fed:
                cpu.update(p.cpu(), y.cpu())
            compare(collection_states(mux.metric(t)), collection_states(cpu), f"mux {kind} W={width} {t} states")
            compare(mux.compute(t), cpu.compute(), f"mux {kind} W={width} {t} values")
            cpu_s += time.perf_counter() - t1
        if j == slice_tenant:
            control = {"states": to_cpu(collection_states(eager)), "values": to_cpu(eager.compute())}
    check_s = {"eager_and_cpu": time.perf_counter() - t0, "cpu": cpu_s,
               "cpu_tenants": MUX_CPU_TENANTS if width == max(MUX_WIDTHS) else 0}
    for pipe in pipes:
        pipe.close()
    info = mux.cache_info()
    per_batch = [e for e in manifest["entries"] if e["kind"] == "per_batch"]
    base_variants = sum(i["compiled_variants"] for pipe in pipes for i in pipe.cache_info())
    (entry,) = fused._cost_entries.values()
    row = mux_row_kernel_counts(metrics_fn, streams[0][0])
    record = {
        "width": width, "tenants": width, "rounds": rounds, "batch": MUX_BATCH, "tenant_updates": rounds * width,
        "us_per_tenant_update": us, "us_per_tenant_update_median": {k: statistics.median(v) for k, v in us.items()},
        "dispatches_per_update": dispatches / (MUX_PASSES * rounds * width),
        "fused_updates": report.fused_updates, "replayed_updates": report.replayed_updates,
        "padded_rows": report.padded_rows, "dispatches": report.dispatches,
        "launches": launches, "launches_per_dispatch": {k: n / dispatches for k, n in launches.items()},
        "captured_variants": {"mux_fused": info["compiled_variants"], "mux_per_batch": len(per_batch),
                              "baseline": base_variants},
        "capture_s": {"mux": manifest["total_compile_seconds"],
                      "baseline": sum(m["total_compile_seconds"] for m in base_manifests)},
        "peak_mb": peak_mb, "host_copies_per_dispatch": host, "baseline_dispatch": base_parts,
        "device_ms_per_tenant_update": {"mux": host["device_ms"] / width, "baseline": base_parts["device_ms"]},
        "check_s": check_s,
        "ledger_per_fused_row": {"flops": entry.flops / width, "bytes": entry.bytes_accessed / width,
                                 "temp_bytes": entry.temp_bytes, "argument_bytes": entry.argument_bytes,
                                 "capture_s": entry.compile_seconds},
        "one_row_counted": row,
        "manifest": {"estimated_flops": manifest["estimated_flops"], "estimated_bytes": manifest["estimated_bytes"],
                     "variants": manifest["variants"]},
        "admission": {"shed": final.shed_batches, "deferred": final.deferred_batches,
                      "deferred_replayed": final.deferred_replayed, "priced_charges": len(priced),
                      "flops_per_row_charged": priced[0]["flops"], "bytes_per_row_charged": priced[0]["bytes_accessed"]},
        "slice": {"tenant": tenants[slice_tenant], "cursor": slice_manifest["cursor"]["batches_ingested"],
                  "write_s": slice_s},
    }
    spec = {"kind": kind, "width": width, "j": slice_tenant, "bundle": bundle,
            "start": slice_manifest["cursor"]["batches_ingested"]}
    del mux, pipes
    release_graphs()
    return record, spec, control


def mux_nan_check(kind: str, metrics_fn, data, root: str) -> dict:
    """2. One NaN batch of one tenant among 8 under ``warn_skip``: that tenant equals its
    own guarded eager loop, the other 7 land fused, one flight dump names the tenant."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine import MuxConfig, TenantMultiplexer

    def guarded():
        col = MetricCollection(metrics_fn("cuda"))
        for m in col.values(copy_state=False):
            m.error_policy = "warn_skip"
        return col

    preds, target = data
    width, (bad_tenant, bad_round) = MUX_NAN_TENANTS, MUX_NAN_AT
    tenants = [f"{kind}-n{j}" for j in range(width)]
    streams = {j: [mux_slice(preds, target, r * width + j) for r in range(2)] for j in range(width)}
    p, y = streams[bad_tenant][bad_round]
    p = p.clone()
    p.view(-1)[0] = float("nan")
    streams[bad_tenant][bad_round] = (p, y)
    mux = TenantMultiplexer(guarded, MuxConfig(max_width=width, flight_dump_dir=os.path.join(root, "nan-flight")))
    for t in tenants:
        mux.adopt(t)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for r in range(2):
            for j, t in enumerate(tenants):
                mux.feed(t, *streams[j][r])
        report = mux.close()
        for j, t in enumerate(tenants):
            eager = guarded()
            for b in streams[j]:
                eager.update(*b)
            # a row that landed fused ran no guarded update: its state_dict carries no
            # guard counters (``__robust__``), as in JAX; the poisoned tenant's must match
            got, want = collection_states(mux.metric(t)), collection_states(eager)
            if j != bad_tenant:
                for states in (got, want):
                    for m in states.values():
                        m.pop("__robust__", None)
            session_bitwise(f"mux nan {kind} {t}", {"states": to_cpu(got), "values": to_cpu(mux.compute(t))},
                            {"states": to_cpu(want), "values": to_cpu(eager.compute())})
            if j != bad_tenant and j < MUX_CPU_TENANTS:
                # the W=8 group's card-against-CPU check: an unguarded CPU loop, no guard
                # counters on either side
                cpu = MetricCollection(metrics_fn("cpu"))
                for q, z in streams[j]:
                    cpu.update(q.cpu(), z.cpu())
                compare(got, collection_states(cpu), f"mux nan {kind} {t} states")
                compare(mux.compute(t), cpu.compute(), f"mux nan {kind} {t} values")
        skipped = sum(m.updates_skipped for m in mux.metric(tenants[bad_tenant]).values(copy_state=False))
    dumps = mux.flight_dumps
    with open(dumps[0], encoding="utf-8") as fh:
        meta = json.loads(fh.readline())
    if report.replayed_updates != 1 or report.fused_updates != 2 * width - 1 or len(dumps) != 1 or not skipped or \
            meta["tenant"] != tenants[bad_tenant] or meta["poisoned_batches"] != [bad_round]:
        raise AssertionError(f"mux_eval {kind}: the NaN run reported {report.asdict()}, {len(dumps)} dumps, {meta}")
    torch.cuda.synchronize()
    del mux
    release_graphs()
    return {"tenants": width, "poisoned": {"tenant": meta["tenant"], "batch": bad_round},
            "cpu_checked_tenants": [t for j, t in enumerate(tenants) if j != bad_tenant and j < MUX_CPU_TENANTS],
            "replayed_updates": report.replayed_updates, "fused_updates": report.fused_updates,
            "skipped_updates": skipped, "flight_dumps": len(dumps), "reason": meta["reason"]}


def mux_restore_worker(specs: list, queue) -> None:
    """The restoring process (spawned): each tenant slice restored into a MetricPipeline
    on cuda:0, the tenant's stream finished from the slice's cursor; the states and
    values go back as ``torch.save`` bytes."""
    import io
    import traceback

    import torch

    try:
        torch.cuda.set_device(0)
        from torchmetrics_tpu_torch import MetricCollection
        from torchmetrics_tpu_torch.engine.migrate import restore_session

        sets = {kind: (metrics_fn, data_fn) for kind, metrics_fn, data_fn, _, _ in COLLECTION_SETS}
        out, data = {}, {}
        for spec in specs:
            metrics_fn, data_fn = sets[spec["kind"]]
            if spec["kind"] not in data:
                data[spec["kind"]] = data_fn()
            stream = mux_stream(*data[spec["kind"]], spec["width"], spec["j"])
            col = MetricCollection(metrics_fn("cuda"))
            pipe, manifest = restore_session(col, spec["bundle"])
            for b in stream[spec["start"]:]:
                pipe.feed(*b)
            pipe.close()
            out[(spec["kind"], spec["width"])] = {"states": to_cpu(collection_states(col)),
                                                 "values": to_cpu(col.compute()),
                                                 "mux_slice": manifest["mux_slice"]}
            del col, pipe
            release_graphs()
        payload = io.BytesIO()
        torch.save(out, payload)
        queue.put((payload.getvalue(), None))
    except BaseException:  # reported to the parent, which fails the run
        queue.put((None, traceback.format_exc()))
        raise


def mux_eval_phase() -> dict:
    """The tenant multiplexer at W = 8 and 64 tenants of each grouped collection.

    For each (collection, W): W tenants fed 256-row batches for max(3, 128 // W) rounds,
    through one ``TenantMultiplexer`` (one captured graph for the width, one replay per
    group) and through W tenant sessions of ``MetricPipeline(fuse=1)`` (one replay per
    batch), each warmed up and fed a warm round before the clock, then timed in turns
    (mux, baseline, baseline, mux). It fails unless: (1) every tenant's state is bitwise
    its batches through its own eager collection on the card and one tenant equals the
    CPU within the classification tolerance; (2) one NaN batch of one tenant among 8
    under ``warn_skip`` leaves that tenant equal to its guarded eager loop, the other 7
    fused, one flight dump naming it; (3) an admission controller sheds one tenant's
    batches past its quota and defers another's, both counted, the others unchanged,
    every priced charge with flops and bytes; (4) a tenant's slice taken mid-stream,
    restored in a spawned process into a MetricPipeline that finishes the stream, is
    bitwise the control; (5) the warmup manifest's estimated flops and bytes are set.
    No group may degrade or replay on clean data.
    """
    import shutil

    root = os.path.join(session_root(), "mux")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    from torchmetrics_tpu_torch.ops import kernels

    cells, specs, controls, nan_runs = {}, [], {}, {}
    launches = dict.fromkeys(kernels.LAUNCHES, 0)
    try:
        for kind, metrics_fn, data_fn, _, _ in COLLECTION_SETS:
            data = data_fn()
            for width in MUX_WIDTHS:
                t0 = time.perf_counter()
                record, spec, control = mux_cell(kind, metrics_fn, data, width, root)
                record["wall_s"] = time.perf_counter() - t0
                cells[f"{kind}_w{width}"] = record
                specs.append(spec)
                controls[(kind, width)] = control
                for name, n in record["launches"].items():
                    launches[name] = launches.get(name, 0) + n
            nan_runs[kind] = mux_nan_check(kind, metrics_fn, data, root)
            del data
            release_graphs()
        t0 = time.perf_counter()
        restored = session_restore_elsewhere(specs, worker=mux_restore_worker)
        child_wall = time.perf_counter() - t0
        for key, control in controls.items():
            got = restored[key]
            if not got["mux_slice"]:
                raise AssertionError(f"mux_eval {key}: the restored bundle is not a mux slice")
            session_bitwise(f"mux slice {key}", got, control)
            cells[f"{key[0]}_w{key[1]}"]["slice"]["restored_bitwise"] = True
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"phase": "mux_eval", "cells": cells, "nan": nan_runs, "restoring_process_wall_s": child_wall,
            "launches": launches}


# ----------------------------------------------------------------- multilabel

# MS-COCO 2014 validation at its own width: 40,504 images x 80 labels, about 2.9
# positive labels an image, batch 256 (158 full steps and one of 56)
MULTILABEL_LABELS = 80
MULTILABEL_IMAGES = 40_504
MULTILABEL_DENSITY = 2.9
MULTILABEL_BATCH = 256
MULTILABEL_THRESHOLDS = 200
# the fused run's capacity for map_exact's scores: the 158 full batches, 40,448 images
MULTILABEL_BUFFER = 40_960
# the compute groups JAX's MetricCollection forms from the same 14 metrics
MULTILABEL_GROUP_SIZES = [1, 3, 3, 7]
MULTILABEL_PROFILE_STEPS = 16
# the macro PR curve at ImageNet width: the first rows of imagenet_data, in batches
MACRO_CURVE_CLASSES = 1000
MACRO_CURVE_ROWS = 5000
MACRO_CURVE_BATCH = 500
MACRO_RECALL_ATOL = 1e-6


def multilabel_metrics(device: str, buffer_capacity: int | None = None) -> dict:
    """mAP (exact and at 200 thresholds), AUROC macro and micro, the per-class (CP, CR,
    CF1) and overall (OP, OR, OF1) precision, recall and F1 of the multi-label image
    classification protocol, accuracy, the confusion matrices, Jaccard and Matthews.
    With ``buffer_capacity`` the exact mAP keeps its scores in a MaskedBuffer."""
    from torchmetrics_tpu_torch import classification as tc

    labels, t = MULTILABEL_LABELS, MULTILABEL_THRESHOLDS
    kw = {"validate_args": False, "device": device}
    return {
        "map_exact": tc.MultilabelAveragePrecision(labels, "macro", buffer_capacity=buffer_capacity, **kw),
        "map_t200": tc.MultilabelAveragePrecision(labels, "macro", thresholds=t, **kw),
        "auroc_macro_t200": tc.MultilabelAUROC(labels, "macro", thresholds=t, **kw),
        "auroc_micro_t200": tc.MultilabelAUROC(labels, "micro", thresholds=t, **kw),
        "cp": tc.MultilabelPrecision(labels, average="macro", **kw),
        "cr": tc.MultilabelRecall(labels, average="macro", **kw),
        "cf1": tc.MultilabelF1Score(labels, average="macro", **kw),
        "op": tc.MultilabelPrecision(labels, average="micro", **kw),
        "or": tc.MultilabelRecall(labels, average="micro", **kw),
        "of1": tc.MultilabelF1Score(labels, average="micro", **kw),
        "accuracy": tc.MultilabelAccuracy(labels, **kw),
        "confusion_matrix": tc.MultilabelConfusionMatrix(labels, **kw),
        "jaccard": tc.MultilabelJaccardIndex(labels, **kw),
        "matthews": tc.MultilabelMatthewsCorrCoef(labels, **kw),
    }


def multilabel_data(n: int = MULTILABEL_IMAGES, labels: int = MULTILABEL_LABELS, seed: int = 3,
                    device: str = "cuda"):
    """Seeded COCO-like labels and scores: per-label prevalences drawn long-tailed
    (u**2) and scaled to MULTILABEL_DENSITY positives an image on average, logits with
    a signal on the positives, and their sigmoid taken once, on ``device``."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(labels, generator=g, device=device)
    prevalence = u * u / (u * u).mean() * (MULTILABEL_DENSITY / labels)
    target = (torch.rand(n, labels, generator=g, device=device) < prevalence).to(torch.int32)
    logits = torch.randn(n, labels, generator=g, device=device) + 3.0 * target - 2.0
    return torch.sigmoid(logits), target


def state_leaves(tree) -> list:
    """The tensors of a state tree (dicts in key order, lists and tuples in order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in state_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in state_leaves(v)]
    return [tree]


def macro_curve_check() -> dict:
    """``MulticlassPrecisionRecallCurve(1000, average="macro", thresholds=200)`` on the
    first MACRO_CURVE_ROWS rows of ``imagenet_data``, card against CPU: mean precision and
    thresholds bitwise, mean recall within MACRO_RECALL_ATOL."""
    import torch

    from torchmetrics_tpu_torch import classification as tc

    preds, target = imagenet_data(c=MACRO_CURVE_CLASSES)
    preds, target = preds[:MACRO_CURVE_ROWS], target[:MACRO_CURVE_ROWS]
    out, seconds = {}, {}
    for device in ("cuda", "cpu"):
        m = tc.MulticlassPrecisionRecallCurve(MACRO_CURVE_CLASSES, average="macro", thresholds=200,
                                             validate_args=False, device=device)
        p, t = preds.to(m.device), target.to(m.device)
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for start in range(0, MACRO_CURVE_ROWS, MACRO_CURVE_BATCH):
            m.update(p[start:start + MACRO_CURVE_BATCH], t[start:start + MACRO_CURVE_BATCH])
        out[device] = m.compute()
        if device == "cuda":
            torch.cuda.synchronize()
        seconds[device] = time.perf_counter() - t0
    (cp, cr, ct), (hp, hr, ht) = to_cpu(out["cuda"]), out["cpu"]
    for name, a, b in (("mean_precision", cp, hp), ("thresholds", ct, ht)):
        if not bitwise_equal(a, b):
            raise AssertionError(f"multilabel_eval macro curve: {name} differs between the card and the CPU")
    recall_gap = float((cr - hr).abs().max())
    if not recall_gap <= MACRO_RECALL_ATOL or not bool(torch.isfinite(cr).all()):
        raise AssertionError(f"multilabel_eval macro curve: mean recall gap {recall_gap} over {MACRO_RECALL_ATOL}")
    return {"classes": MACRO_CURVE_CLASSES, "thresholds": 200, "rows": MACRO_CURVE_ROWS, "points": int(cp.numel()),
            "mean_recall_gap": recall_gap, "card_s": seconds["cuda"], "cpu_s": seconds["cpu"],
            "bitwise": ["mean_precision", "thresholds"]}


def multilabel_eval_phase() -> dict:
    """An MS-COCO-sized multi-label evaluation, three ways, then the macro PR curve.

    (1) Eager, metric by metric, over all 159 batches, then the same loop on the CPU
    (integer states equal, floats within FLOAT_ATOL) and a profile of warm steps;
    (2) grouped: one MetricCollection of the same metrics, which must form JAX's 4
    compute groups, over the 158 full batches with the exact mAP in a MaskedBuffer;
    (3) fused: MetricPipeline(fuse=8) over that collection, whose states must be
    bitwise the grouped eager loop's. No run may launch K1-K5: the multilabel path is
    plain sums and einsums in JAX and in the port. Profiles come after every timing."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.ops import kernels

    preds, target = multilabel_data()
    batch = MULTILABEL_BATCH
    steps = -(-preds.shape[0] // batch)
    launches = dict.fromkeys(kernels.LAUNCHES, 0)

    def count(run_launches: dict, where: str) -> None:
        for name, n in run_launches.items():
            launches[name] += n
        if any(run_launches.values()):
            raise AssertionError(f"multilabel_eval {where}: a kernel launched on the multilabel path:"
                                 f" {run_launches}")

    # (1) eager, metric by metric, all the data; the CPU runs the same loop
    kernels.reset_launch_counts()
    card_values, card_states, seconds, _ = run_loop(multilabel_metrics("cuda"), preds, target, batch)
    count(dict(kernels.LAUNCHES), "eager")
    cpu_values, cpu_states, cpu_seconds, _ = run_loop(multilabel_metrics("cpu"), preds.cpu(), target.cpu(), batch)
    state_gap = max(compare(card_states[m], cpu_states[m], f"state.{m}") for m in card_states)
    value_gap = compare(card_values, cpu_values, "value")
    for name, value in card_values.items():
        if not bool(torch.isfinite(value).all()):
            raise AssertionError(f"multilabel_eval: {name} is not finite")
    eager = {"wall_s": seconds, "us_per_step": seconds / steps * 1e6, "cpu_wall_s": cpu_seconds,
             "cpu_compared_steps": steps, "max_state_float_gap": state_gap, "max_value_float_gap": value_gap}

    # (2) grouped and (3) fused over the full batches, the exact mAP buffered
    def buffered(device: str) -> dict:
        return multilabel_metrics(device, buffer_capacity=MULTILABEL_BUFFER)

    full = batches_of(preds, target, batch)[: preds.shape[0] // batch]
    groups = MetricCollection(buffered("cuda")).compute_groups
    sizes = sorted(len(g) for g in groups.values())
    if sizes != MULTILABEL_GROUP_SIZES:
        raise AssertionError(f"multilabel_eval: the collection formed groups {list(groups.values())}, not"
                             f" sizes {MULTILABEL_GROUP_SIZES}")
    runs, us = {}, {"eager": [], "fuse_8": []}
    for variant in ("eager", "fuse_8", "fuse_8", "eager"):
        run = pipeline_run(buffered, "cuda", full, variant)
        count(run["launches"], variant)
        us[variant].append(run["seconds"] / len(full) * 1e6)
        run.pop("pipe", None)
        run.pop("col")
        runs.setdefault(variant, run)
        release_graphs()
    grouped, fused = runs["eager"], runs["fuse_8"]
    for m in grouped["states"]:
        if not bitwise_equal(state_leaves(fused["states"][m]), state_leaves(grouped["states"][m])):
            raise AssertionError(f"multilabel_eval: the fused state of {m} is not bitwise the grouped eager loop's")
    chunks = -(-len(full) // PIPELINE_FUSE)
    if fused["replays"] != chunks or fused["misses_in_loop"] or fused["report"]["chunks_replayed"]:
        raise AssertionError(f"multilabel_eval fused: {fused['replays']} replays, {fused['misses_in_loop']}"
                             f" captures in the loop for {chunks} chunks")
    fused_value_gap = compare(to_cpu(fused["values"]), to_cpu(grouped["values"]), "fused.value")

    # profiles after every timing: a process that has run the profiler is slower afterwards
    eager["profile"] = profile_loop(multilabel_metrics("cuda"), preds, target, batch, MULTILABEL_PROFILE_STEPS)
    profiled = full[: 2 * PIPELINE_FUSE]
    profiles = {v: profile_pipeline(buffered, profiled, v) for v in ("eager", "fuse_8")}
    macro = macro_curve_check()

    summary = {}
    for name, value in card_values.items():
        summary[name] = float(value) if value.numel() == 1 else {"shape": list(value.shape), "sum": int(value.sum())}
    return {
        "phase": "multilabel_eval", "images": int(preds.shape[0]), "labels": MULTILABEL_LABELS, "batch": batch,
        "steps": steps, "positives_per_image": float(target.sum()) / preds.shape[0], "eager": eager,
        "grouped": {"steps": len(full), "groups": [list(g) for g in groups.values()], "us_per_step": us["eager"],
                    "profile": profiles["eager"]},
        "fused": {"fuse": PIPELINE_FUSE, "steps": len(full), "us_per_step": us["fuse_8"],
                  "replays_per_batch": fused["replays"] / len(full), "capture_s": fused["capture_s"],
                  "captured_variants": fused["variants"], "padded_steps": fused["report"]["padded_steps"],
                  "bitwise_states": True, "max_value_float_gap": fused_value_gap, "profile": profiles["fuse_8"]},
        "macro_curve": macro, "values": summary, "launches": launches,
    }


# ------------------------------------------------------------------ family_eval

# the CTR loop's fairness audit across user segments: segment g takes a share of the
# impressions proportional to 1 / (g + 1)
FAMILY_SEGMENTS = 8
_CTR_KW = {"validate_args": False, "ignore_index": -1}
_KW = {"validate_args": False}
# each loop's metrics: name -> (class of the classification module, positional args, kwargs)
FAMILY_SPECS = {
    "ctr": {
        "specificity": ("BinarySpecificity", (), _CTR_KW),
        "hamming": ("BinaryHammingDistance", (), _CTR_KW),
        "hinge": ("BinaryHingeLoss", (), _CTR_KW),
        "recall_at_precision_50_t1000": ("BinaryRecallAtFixedPrecision", (0.5,), {**_CTR_KW, "thresholds": 1000}),
        "precision_at_recall_50_t1000": ("BinaryPrecisionAtFixedRecall", (0.5,), {**_CTR_KW, "thresholds": 1000}),
        "sensitivity_at_specificity_90_t1000": ("BinarySensitivityAtSpecificity", (0.9,),
                                                {**_CTR_KW, "thresholds": 1000}),
        "specificity_at_sensitivity_90_t1000": ("BinarySpecificityAtSensitivity", (0.9,),
                                                {**_CTR_KW, "thresholds": 1000}),
        "roc_t1000": ("BinaryROC", (), {**_CTR_KW, "thresholds": 1000}),
    },
    "imagenet": {
        "specificity_macro": ("MulticlassSpecificity", (1000,), {**_KW, "average": "macro"}),
        "hamming_macro": ("MulticlassHammingDistance", (1000,), {**_KW, "average": "macro"}),
        "hinge_crammer_singer": ("MulticlassHingeLoss", (1000,), _KW),
        "hinge_one_vs_all": ("MulticlassHingeLoss", (1000,), {**_KW, "multiclass_mode": "one-vs-all"}),
        "recall_at_precision_50_t100": ("MulticlassRecallAtFixedPrecision", (1000, 0.5), {**_KW, "thresholds": 100}),
        "specificity_at_sensitivity_50_t100": ("MulticlassSpecificityAtSensitivity", (1000, 0.5),
                                               {**_KW, "thresholds": 100}),
        "roc_micro_t200": ("MulticlassROC", (1000,), {**_KW, "average": "micro", "thresholds": 200}),
        "dice_micro": ("Dice", (), {"num_classes": 1000, "average": "micro"}),
    },
    "coco": {
        "hamming": ("MultilabelHammingDistance", (MULTILABEL_LABELS,), _KW),
        "exact_match": ("MultilabelExactMatch", (MULTILABEL_LABELS,), _KW),
        "specificity_macro": ("MultilabelSpecificity", (MULTILABEL_LABELS,), {**_KW, "average": "macro"}),
        "coverage_error": ("MultilabelCoverageError", (MULTILABEL_LABELS,), _KW),
        "ranking_average_precision": ("MultilabelRankingAveragePrecision", (MULTILABEL_LABELS,), _KW),
        "ranking_loss": ("MultilabelRankingLoss", (MULTILABEL_LABELS,), _KW),
        "recall_at_precision_50_t200": ("MultilabelRecallAtFixedPrecision", (MULTILABEL_LABELS, 0.5),
                                        {**_KW, "thresholds": MULTILABEL_THRESHOLDS}),
        "roc_t200": ("MultilabelROC", (MULTILABEL_LABELS,), {**_KW, "thresholds": MULTILABEL_THRESHOLDS}),
    },
}
# the CTR loop's fairness metrics, whose update takes the segment ids as well: beside
# the collection, not in it
FAMILY_FAIRNESS = {
    "group_stat_rates": ("BinaryGroupStatRates", (FAMILY_SEGMENTS,), _CTR_KW),
    "fairness": ("BinaryFairness", (FAMILY_SEGMENTS,), {**_CTR_KW, "task": "all"}),
}
# the compute groups JAX's MetricCollection forms from each loop's metrics
FAMILY_GROUP_SIZES = {"ctr": [1, 2, 5], "imagenet": [1, 1, 1, 1, 2, 2], "coco": [1, 1, 1, 1, 2, 2]}
# (data, batch, batches the CPU runs, profiled steps, kernels the loop must launch): the
# CPU's binned curve at 1000 thresholds takes ~1.2 s a CTR batch and metric
FAMILY_LOOPS = {
    "ctr": (binary_data, 1 << 18, 2, 4, ("binned_curve_counts", "bincount")),
    "imagenet": (imagenet_data, 500, 10, 10, ("confusion_matrix", "binned_curve_counts")),
    "coco": (multilabel_data, MULTILABEL_BATCH, 40, 16, ()),
}
FAMILY_KERNELS = ("confusion_matrix", "binned_curve_counts", "weighted_bincount", "bincount")
# float states against the CPU, on top of FLOAT_ATOL: the hinge, ranking and Dice sums
# add up to 4M terms in another order
FAMILY_RTOL = 1e-6


def family_metrics(kind: str, device: str | None = None, classes=None, fairness: bool = False) -> dict:
    """The metrics of one ``family_eval`` loop (with ``fairness``, the CTR loop's two
    fairness metrics), built from ``classes``, the port's classification module unless
    another module with the same class names is given, on ``device`` unless it is None."""
    if classes is None:
        from torchmetrics_tpu_torch import classification as classes
    extra = {} if device is None else {"device": device}
    specs = FAMILY_FAIRNESS if fairness else FAMILY_SPECS[kind]
    return {name: getattr(classes, cls)(*args, **kw, **extra) for name, (cls, args, kw) in specs.items()}


def segment_ids(n: int = 1 << 22, segments: int = FAMILY_SEGMENTS, seed: int = 2, device: str = "cuda"):
    """Seeded user-segment ids of the CTR loop's fairness audit, int32 in [0, segments):
    segment g takes a share of the impressions proportional to 1 / (g + 1)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    share = 1.0 / torch.arange(1, segments + 1, device=device, dtype=torch.float64)
    edges = torch.cumsum(share, 0) / share.sum()
    u = torch.rand(n, generator=g, device=device, dtype=torch.float64)
    return torch.searchsorted(edges, u).clamp_max(segments - 1).to(torch.int32)


def segment_cell_ids(n: int, segments: int, seed: int, device: str = "cuda"):
    """The bincount kernel's input in the fairness update (``_group_cell_ids``) for n
    seeded CTR scores, 1% ignored, over ``segment_ids``."""
    from torchmetrics_tpu_torch.functional.classification.group_fairness import _group_cell_ids
    from torchmetrics_tpu_torch.functional.classification.stat_scores import _binary_stat_scores_format

    preds, target = binary_data(n, seed, device)
    preds, target, valid = _binary_stat_scores_format(preds, target, 0.5, -1)
    return _group_cell_ids(preds, target, segment_ids(n, segments, seed + 1, device), valid, segments)


def _family_tolerance(where: str):
    return FLOAT_ATOL, FAMILY_RTOL


def family_run(kind: str, device: str, batches: list, segments: list | None, variant: str) -> dict:
    """One pass of a ``family_eval`` loop over ``batches`` with fresh metrics: ``metric``
    updates each metric in turn, ``eager`` the loop's MetricCollection, ``fuse_8`` a
    MetricPipeline(fuse=8) over it, captured by its warmup before the clock starts. With
    ``segments`` (one tensor a batch) the fairness metrics take each batch beside them,
    eagerly. Launch counts are zeroed just before the pass and read just after; the clock
    covers the pass and ``compute`` and ends in a synchronise."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig
    from torchmetrics_tpu_torch.ops import kernels

    metrics = family_metrics(kind, device)
    fair = {} if segments is None else family_metrics(kind, device, fairness=True)
    col = None if variant == "metric" else MetricCollection(metrics)
    pipe = manifest = None
    if variant == "fuse_8":
        pipe = MetricPipeline(col, PipelineConfig(fuse=PIPELINE_FUSE))
        manifest = pipe.warmup(*batches[0])
    cuda = device == "cuda"
    if cuda:
        torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    if pipe is not None:
        pipe.run(batches)
    for i, (p, t) in enumerate(batches):
        if variant == "metric":
            for m in metrics.values():
                m.update(p, t)
        elif variant == "eager":
            col.update(p, t)
        for m in fair.values():
            m.update(p, t, segments[i])
    values = {name: m.compute() for name, m in metrics.items()} if col is None else dict(col.compute())
    values.update({name: m.compute() for name, m in fair.items()})
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    states = ({name: m.state_dict(persistent_only=False) for name, m in metrics.items()} if col is None
              else collection_states(col))
    states.update({name: m.state_dict(persistent_only=False) for name, m in fair.items()})
    out = {"seconds": seconds, "launches": dict(kernels.LAUNCHES), "values": to_cpu(values), "states": to_cpu(states)}
    if pipe is not None:
        info = pipe.cache_info()
        out.update({"replays": sum(i["replays"] for i in info), "misses_in_loop": sum(i["misses"] for i in info),
                    "chunks_replayed": pipe.report().chunks_replayed, "variants": manifest["variants"],
                    "capture_s": manifest["total_compile_seconds"]})
    return out


def family_loop(kind: str) -> dict:
    """One ``family_eval`` loop three ways (see ``family_eval_phase``)."""
    import functools

    import torch

    from torchmetrics_tpu_torch import MetricCollection

    data_fn, batch, cpu_batches, profile_steps, required = FAMILY_LOOPS[kind]
    preds, target = data_fn()
    batches = batches_of(preds, target, batch)
    full = preds.shape[0] // batch
    segments = None
    if kind == "ctr":
        ids = segment_ids(preds.shape[0])
        segments = [ids[i * batch:(i + 1) * batch] for i in range(len(batches))]

    def check_launches(run: dict, where: str, steps: int) -> None:
        for kernel in required:
            if run["launches"][kernel] <= 0:
                raise AssertionError(f"family_eval {kind} {where}: kernel {kernel} was never launched")
        if kind == "ctr":
            # one bincount launch per fairness update, none through the weighted bincount
            if run["launches"]["bincount"] != len(FAMILY_FAIRNESS) * steps or run["launches"]["weighted_bincount"]:
                raise AssertionError(f"family_eval ctr {where}: the fairness counts took {run['launches']}")

    def head(seq: list | None, n: int, device: str = "cuda") -> list | None:
        return None if seq is None else to_cpu(seq[:n]) if device == "cpu" else seq[:n]

    # (1) metric by metric: the card's first batches against the CPU's, then all of them timed
    card = family_run(kind, "cuda", head(batches, cpu_batches), head(segments, cpu_batches), "metric")
    t0 = time.perf_counter()
    cpu = family_run(kind, "cpu", head(batches, cpu_batches, "cpu"), head(segments, cpu_batches, "cpu"), "metric")
    cpu_seconds = time.perf_counter() - t0
    state_gap = compare(card["states"], cpu["states"], f"{kind}.state", _family_tolerance)
    value_gap = compare(card["values"], cpu["values"], f"{kind}.value", _family_tolerance)
    for name, value in card["values"].items():
        if "_at_" in name and not bitwise_equal(value[1], cpu["values"][name][1]):
            raise AssertionError(f"family_eval {kind}: the thresholds of {name} differ between the card and the CPU")
    timed = family_run(kind, "cuda", batches, segments, "metric")
    check_launches(timed, "metric by metric", len(batches))
    for leaf in state_leaves(timed["values"]):
        if leaf.is_floating_point() and not bool(torch.isfinite(leaf).all()):
            raise AssertionError(f"family_eval {kind}: a value is not finite")
    launches = dict(timed["launches"])

    # (2) grouped and (3) fused over the full batches
    groups = MetricCollection(family_metrics(kind, "cuda")).compute_groups
    sizes = sorted(len(g) for g in groups.values())
    if sizes != FAMILY_GROUP_SIZES[kind]:
        raise AssertionError(f"family_eval {kind}: the collection formed groups {list(groups.values())}, not"
                             f" sizes {FAMILY_GROUP_SIZES[kind]}")
    runs, us = {}, {"eager": [], "fuse_8": []}
    for variant in ("eager", "fuse_8", "fuse_8", "eager"):
        run = family_run(kind, "cuda", head(batches, full), head(segments, full), variant)
        check_launches(run, variant, full)
        for name, n in run["launches"].items():
            launches[name] += n
        us[variant].append(run["seconds"] / full * 1e6)
        runs.setdefault(variant, run)
        release_graphs()
    grouped, fused = runs["eager"], runs["fuse_8"]
    for m in grouped["states"]:
        if not bitwise_equal(state_leaves(fused["states"][m]), state_leaves(grouped["states"][m])):
            raise AssertionError(f"family_eval {kind}: the fused state of {m} is not bitwise the grouped eager loop's")
    chunks = -(-full // PIPELINE_FUSE)
    if fused["replays"] != chunks or fused["misses_in_loop"] or fused["chunks_replayed"]:
        raise AssertionError(f"family_eval {kind} fused: {fused['replays']} replays, {fused['misses_in_loop']}"
                             f" captures in the loop for {chunks} chunks")
    fused_value_gap = compare(fused["values"], grouped["values"], f"{kind}.fused.value")

    # profiles after every timing, of the metrics without the fairness pair
    profile = profile_loop(family_metrics(kind, "cuda"), preds, target, batch, profile_steps)
    metrics_fn = functools.partial(family_metrics, kind)
    profiles = {v: profile_pipeline(metrics_fn, batches[:min(full, 2 * PIPELINE_FUSE)], v) for v in ("eager", "fuse_8")}

    def per_step(run: dict, steps: int) -> dict:
        return {k: run["launches"][k] / steps for k in FAMILY_KERNELS}

    summary = {}
    for name, value in timed["values"].items():
        if isinstance(value, dict):
            summary[name] = {k: v.tolist() for k, v in value.items()}
        elif isinstance(value, tuple) and "_at_" in name:
            summary[name] = {"value": value[0].tolist() if value[0].numel() <= 4 else float(value[0].mean()),
                             "threshold": value[1].tolist() if value[1].numel() <= 4 else float(value[1].mean())}
        elif isinstance(value, tuple):
            summary[name] = {"points": int(value[0].numel())}
        else:
            summary[name] = float(value) if value.numel() == 1 else {"shape": list(value.shape),
                                                                      "mean": float(value.mean())}
    return {
        "samples": int(preds.shape[0]), "batch": batch, "steps": len(batches), "values": summary,
        "metric_by_metric": {"us_per_step": timed["seconds"] / len(batches) * 1e6,
                             "launches_per_step": per_step(timed, len(batches)), "cpu_compared_steps": cpu_batches,
                             "cpu_wall_s": cpu_seconds, "max_state_float_gap": state_gap,
                             "max_value_float_gap": value_gap, "profile": profile},
        "grouped": {"steps": full, "groups": [list(g) for g in groups.values()], "us_per_step": us["eager"],
                    "launches_per_step": per_step(grouped, full), "profile": profiles["eager"]},
        "fused": {"fuse": PIPELINE_FUSE, "steps": full, "us_per_step": us["fuse_8"],
                  "launches_per_step": per_step(fused, full), "replays_per_batch": fused["replays"] / full,
                  "capture_s": fused["capture_s"], "captured_variants": fused["variants"], "bitwise_states": True,
                  "max_value_float_gap": fused_value_gap, "profile": profiles["fuse_8"]},
        "launches": launches,
    }


def family_eval_phase() -> dict:
    """The rest of the classification family on three eval loops at their own widths:
    CTR (2^22 scores, batch 2^18, 1% ignored; specificity, Hamming, hinge, the four
    fixed operating points and ROC at 1000 thresholds, and a fairness audit over 8 user
    segments), ImageNet (50,000 x 1000, batch 500; macro specificity and Hamming, hinge
    in both modes, recall at fixed precision and specificity at sensitivity at 100
    thresholds, the micro ROC at 200, micro Dice) and MS-COCO multi-label (40,504 x 80,
    batch 256; Hamming loss, subset accuracy, macro specificity, coverage, LRAP, ranking
    loss, recall at fixed precision and ROC at 200 thresholds). Each loop runs (1)
    metric by metric over all its batches, its first batches held against the CPU
    (integer states equal, floats within FLOAT_ATOL plus FAMILY_RTOL of the CPU's, the
    fixed points' thresholds bitwise); (2) as one MetricCollection, which must form
    JAX's compute groups, the fairness metrics beside it; (3) through
    MetricPipeline(fuse=8), whose states must be bitwise the grouped loop's with one
    replay a chunk and no capture in the loop. CTR must launch K2 and K4 (exactly one
    K4 launch per fairness update, no K3), ImageNet K1 and K2. Profiles come after
    every timing."""
    loops = {kind: family_loop(kind) for kind in FAMILY_LOOPS}
    launches = {k: sum(loop["launches"][k] for loop in loops.values()) for k in loops["ctr"]["launches"]}
    return {"phase": "family_eval", **loops, "launches": launches}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def collection_sync_rank(rank: int, port: int) -> dict:
    """One rank of the two-rank world on the one card: the full seeded data, every other
    batch into a grouped and an ungrouped collection on cuda:0, then synced ``compute``s
    of each, timed in turns and with their ``all_gather`` calls counted, and the sync of
    the leaders' states alone, timed the same way (the grouped one also for the parent's
    check)."""
    import datetime

    import torch
    import torch.distributed as dist

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.ops import kernels
    from torchmetrics_tpu_torch.parallel.sync import stages_through_host

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=SYNC_COLLECTIVE_TIMEOUT_S))
    try:
        gathers = []
        all_gather = dist.all_gather
        # every collective of the sync layer is an all_gather: count them
        dist.all_gather = lambda *a, **k: gathers.append(1) or all_gather(*a, **k)
        kernels.reset_launch_counts()
        out = {"backend": str(dist.get_backend()), "world": dist.get_world_size(),
               "staged": stages_through_host(torch.zeros(1, device="cuda")), "sets": {}}
        for kind, metrics_fn, data_fn, batch, _ in COLLECTION_SETS:
            preds, target = data_fn()
            cols = {"grouped": MetricCollection(metrics_fn("cuda")),
                    "ungrouped": MetricCollection(metrics_fn("cuda"), compute_groups=False)}
            for start in range(rank * batch, preds.shape[0], 2 * batch):
                for col in cols.values():
                    col.update(preds[start:start + batch], target[start:start + batch])
            record = {name: {"ms_per_compute": [], "ms_per_sync_state": [], "groups": len(col.compute_groups)}
                      for name, col in cols.items()}
            leader_states = {name: {members[0]: col[members[0]].state_dict(persistent_only=False)
                                    for members in col.compute_groups.values()} for name, col in cols.items()}
            for col in cols.values():
                for m in col.values():
                    m.compute_with_cache = False  # every compute syncs again
                col.compute()  # the first compute pays the first use of its kernels and of the gloo pairs
            for repeat in range(SYNC_REPEATS):
                for name in ("grouped", "ungrouped") if repeat % 2 == 0 else ("ungrouped", "grouped"):
                    torch.cuda.synchronize()
                    dist.barrier()
                    del gathers[:]
                    t0 = time.perf_counter()
                    values = cols[name].compute()
                    torch.cuda.synchronize()
                    record[name]["ms_per_compute"].append((time.perf_counter() - t0) * 1e3)
                    record[name]["collectives"] = len(gathers)
                    dist.barrier()
                    t0 = time.perf_counter()
                    synced = cols[name].sync_state(leader_states[name])
                    torch.cuda.synchronize()
                    record[name]["ms_per_sync_state"].append((time.perf_counter() - t0) * 1e3)
                    if name == "grouped":
                        record["values"], record["states"] = to_cpu(values), to_cpu(synced)
            out["sets"][kind] = record
            del preds, target, cols
        out["launches"] = dict(kernels.LAUNCHES)
        return out
    finally:
        dist.destroy_process_group()


def collection_sync_worker(rank: int, port: int, queue) -> None:
    """Run one rank and put its result on ``queue`` as ``torch.save`` bytes (a tensor
    put on a queue would be shared through a file descriptor that dies with the rank)."""
    import io
    import traceback

    import torch

    try:
        payload = io.BytesIO()
        torch.save(collection_sync_rank(rank, port), payload)
        queue.put((rank, payload.getvalue(), None))
    except BaseException:  # reported to the parent, which fails the run
        queue.put((rank, None, traceback.format_exc()))
        raise


def collection_sync_phase(reference: dict) -> dict:
    """Two ranks in one gloo world on the one card (``torch.multiprocessing`` spawn). Each
    rank's synced values and leader states must equal the single-process collection's
    over all the data (``reference``, from ``collection_eval``): integers exactly, floats
    within the classification tolerance. A rank that fails or hangs fails the run."""
    import io
    import queue as queue_mod

    import torch
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results_queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=collection_sync_worker, args=(rank, port, results_queue)) for rank in range(2)]
    t0 = time.perf_counter()
    for proc in procs:
        proc.start()
    results = {}
    try:
        deadline = time.monotonic() + SYNC_WORLD_TIMEOUT_S
        while len(results) < 2:
            if time.monotonic() > deadline:
                raise AssertionError(f"collection_sync: the world hung ({sorted(results)} of 2 ranks reported)")
            try:
                rank, result, error = results_queue.get(timeout=1)
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise AssertionError(f"collection_sync: a rank exited with {dead} before it reported")
                continue
            if error is not None:
                raise AssertionError(f"collection_sync: rank {rank} failed:\n{error}")
            results[rank] = torch.load(io.BytesIO(result))
        for proc in procs:
            proc.join(timeout=max(1.0, deadline - time.monotonic()))
            if proc.exitcode != 0:
                raise AssertionError(f"collection_sync: a rank ended with exit code {proc.exitcode}")
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
    wall = time.perf_counter() - t0

    launches = {}
    for rank, result in results.items():
        for kernel in COLLECTION_KERNELS:
            if result["launches"][kernel] <= 0:
                raise AssertionError(f"collection_sync: rank {rank} never launched {kernel}")
        for kernel, n in result["launches"].items():
            launches[kernel] = launches.get(kernel, 0) + n
    sets, gap = {}, 0.0
    for kind, _, _, _, _ in COLLECTION_SETS:
        ref = reference[kind]
        for rank, result in results.items():
            record = result["sets"][kind]
            for leader, state in record["states"].items():
                gap = max(gap, compare(state, ref["states"][leader], f"rank{rank}.state.{leader}"))
            for metric, value in record["values"].items():
                gap = max(gap, compare(value, ref["values"][metric], f"rank{rank}.value.{metric}"))
        rank0 = results[0]["sets"][kind]
        summary = {}
        for metric, value in rank0["values"].items():
            if isinstance(value, tuple):
                summary[metric] = {"points": int(value[0].numel())}
            elif value.numel() == 1:
                summary[metric] = float(value)
            else:
                summary[metric] = {"shape": list(value.shape), "sum": int(value.sum())}
        sets[kind] = {
            "collectives_per_compute": {side: rank0[side]["collectives"] for side in ("grouped", "ungrouped")},
            "groups": {side: rank0[side]["groups"] for side in ("grouped", "ungrouped")},
            "ms_per_synced_compute": {side: {f"rank{r}": results[r]["sets"][kind][side]["ms_per_compute"]
                                             for r in results} for side in ("grouped", "ungrouped")},
            "ms_per_sync_state": {side: {f"rank{r}": results[r]["sets"][kind][side]["ms_per_sync_state"]
                                         for r in results} for side in ("grouped", "ungrouped")},
            "median_ms_rank0": {side: {"compute": statistics.median(rank0[side]["ms_per_compute"]),
                                       "sync_state": statistics.median(rank0[side]["ms_per_sync_state"])}
                                for side in ("grouped", "ungrouped")},
            "values": summary,
        }
    return {"phase": "collection_sync", "ranks": 2, "backend": results[0]["backend"],
            "staged": results[0]["staged"], "world": results[0]["world"], "max_float_gap": gap,
            "world_wall_s": wall, "sets": sets, "launches": launches}


class PredsOnly:
    """Feeds a one-input metric (total variation) the predictions of an eval loop."""

    def __init__(self, metric):
        self.metric = metric

    def update(self, preds, target) -> None:
        self.metric.update(preds)

    def compute(self):
        return self.metric.compute()

    def state_dict(self, persistent_only: bool = True) -> dict:
        return self.metric.state_dict(persistent_only=persistent_only)


def image_metrics(device: str) -> dict:
    from torchmetrics_tpu_torch import image as ti

    kw = {"device": device}
    return {
        "ssim": ti.StructuralSimilarityIndexMeasure(data_range=1.0, **kw),
        "ms_ssim": ti.MultiScaleStructuralSimilarityIndexMeasure(data_range=1.0, **kw),
        "psnr": ti.PeakSignalNoiseRatio(data_range=1.0, **kw),
        "uqi": ti.UniversalImageQualityIndex(**kw),
        "rmse_sw": ti.RootMeanSquaredErrorUsingSlidingWindow(window_size=8, **kw),
        "tv_preds": PredsOnly(ti.TotalVariation(**kw)),
    }


def image_data(n: int = 100, height: int = 1356, width: int = 2040, seed: int = 21, device: str = "cuda"):
    """A seeded smooth RGB field in [0, 1] (bicubic over a coarse random grid) as the
    target, and the target plus gaussian noise of sigma 0.05, clipped, as the output
    of a restoration model. Made on the card in bulk: about 3.3 GB per tensor."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device=device).manual_seed(seed)
    coarse = torch.rand(n, 3, height // 40, width // 40, generator=g, device=device)
    target = F.interpolate(coarse, size=(height, width), mode="bicubic", align_corners=False).clamp_(0, 1)
    noise = torch.randn(target.shape, generator=g, device=device)
    preds = noise.mul_(0.05).add_(target).clamp_(0, 1)
    return preds, target


def _image_tolerance(where: str):
    if where in PIXEL_SUMS:
        return FLOAT_ATOL, PIXEL_SUM_RTOL
    if where == "value.psnr":
        return PSNR_ATOL, 0.0
    return FLOAT_ATOL, IMAGE_RTOL


# padded planes of MS-SSIM's scales 3 to 5 at the DIV2K size (1356 x 2040 halved, then
# padded by 5 on each side)
MS_SSIM_SMALL_SCALES = ((349, 520), (179, 265), (94, 137))


def k5_ms_per_step_alone(records: list) -> float:
    """K5's device ms per step of the image loop, from its main-path shapes timed alone:
    the full-size planes twice (SSIM and MS-SSIM's first scale), each smaller scale once."""
    full = [r for r in records if r["kernel"] == "ssim_moments" and r["main_path"]]
    return 2 * full[0]["kernel_ms"] + sum(r["kernel_ms"] for r in full[1:])


def image_phase(batch: int = 4, cpu_images: int = 4, profile_steps: int = 3,
                ssim_alone_ms: float | None = None) -> dict:
    """The restoration eval loop on the card, then the card against the CPU on the first images.
    Reports K5's device ms per warm step in the loop (profile) beside ``ssim_alone_ms``."""
    import torch

    from torchmetrics_tpu_torch.ops import kernels

    preds, target = image_data()
    steps = -(-preds.shape[0] // batch)
    card_metrics = image_metrics("cuda")
    kernels.reset_launch_counts()
    card_values, _, seconds, _ = run_loop(card_metrics, preds, target, batch)
    launches = dict(kernels.LAUNCHES)
    if launches["ssim_moments"] != 6 * steps:
        raise AssertionError(f"image_restoration_eval: {launches['ssim_moments']} ssim_moments launches, "
                             f"expected 6 per step over {steps} steps")
    for name, value in card_values.items():
        if not bool(torch.isfinite(value).all()):
            raise AssertionError(f"image_restoration_eval: {name} is not finite: {value}")
    if not 0.0 < float(card_values["ssim"]) <= 1.0 or not 0.0 < float(card_values["ms_ssim"]) <= 1.0:
        raise AssertionError("image_restoration_eval: SSIM or MS-SSIM outside (0, 1]")

    # a trace can drop a launch now and then: K5's time per step in the loop is taken
    # from a trace that holds all 6 per step, retried up to three times
    for _ in range(3):
        profile = profile_loop(image_metrics("cuda"), preds, target, batch, profile_steps,
                               track="ssim_moments_kernel")
        if profile["tracked"]["calls"] == 6 * profile_steps:
            break
    p8, t8 = preds[:cpu_images], target[:cpu_images]
    card8_values, card8_states, _, _ = run_loop(image_metrics("cuda"), p8, t8, batch)
    cpu_values, cpu_states, cpu_seconds, _ = run_loop(image_metrics("cpu"), p8.cpu(), t8.cpu(), batch)
    gaps = {}
    for metric in card8_states:
        for key, value in card8_states[metric].items():
            where = f"state.{metric}.{key}"
            gaps[where] = compare(value, cpu_states[metric][key], where, _image_tolerance)
        where = f"value.{metric}"
        gaps[where] = compare(card8_values[metric], cpu_values[metric], where, _image_tolerance)
    return {
        "phase": "image_restoration_eval", "images": int(preds.shape[0]), "image_shape": list(preds.shape[1:]),
        "batch": batch, "steps": steps, "wall_s": seconds, "us_per_step": seconds / steps * 1e6,
        "launches": launches, "values": {name: float(v) for name, v in card_values.items()},
        "cpu_compared_images": cpu_images, "cpu_wall_s": cpu_seconds, "gaps": gaps,
        "values_first_images": {name: float(v) for name, v in cpu_values.items()},
        "profile": profile,
        # null unless the trace held every launch of its steps
        "k5_ms_per_step_in_loop": (profile["tracked"]["ms_per_step"]
                                   if profile["tracked"]["calls"] == 6 * profile_steps else None),
        "k5_launches_traced": profile["tracked"]["calls"], "k5_launches_run": 6 * profile_steps,
        "k5_ms_per_step_alone": ssim_alone_ms,
    }


def gradient_phase() -> dict:
    """``structural_similarity_index_measure(...).backward()`` on the card and on the CPU."""
    import torch

    from torchmetrics_tpu_torch.functional.image import structural_similarity_index_measure
    from torchmetrics_tpu_torch.ops import kernels

    preds, target = image_data(n=2, height=256, width=256, seed=31)
    grads, values = [], []
    before = kernels.LAUNCHES["ssim_moments"]
    for device in ("cuda", "cpu"):
        x = preds.detach().to(device).requires_grad_()
        value = structural_similarity_index_measure(x, target.to(device), data_range=1.0)
        value.backward()
        grads.append(x.grad.cpu())
        values.append(float(value.detach()))
    launches = kernels.LAUNCHES["ssim_moments"] - before
    if launches != 1:
        raise AssertionError(f"ssim_gradient: expected one ssim_moments launch, got {launches}")
    gap = float((grads[0] - grads[1]).abs().max())
    largest = float(grads[1].abs().max())
    if not bool(torch.isfinite(grads[0]).all()) or gap > GRAD_ATOL or gap > GRAD_RTOL_OF_MAX * largest:
        raise AssertionError(f"ssim_gradient: card vs CPU gap {gap} (largest gradient {largest})")
    return {"phase": "ssim_gradient", "shape": list(preds.shape), "ssim_card": values[0], "ssim_cpu": values[1],
            "max_grad_gap": gap, "max_abs_grad": largest, "launches": launches}


def retrieval_phase() -> dict:
    """Group the query ids of a reranking run with ``_flexible_bincount`` on the card and on the CPU."""
    import torch

    from torchmetrics_tpu_torch.ops import kernels
    from torchmetrics_tpu_torch.utils.data import _flexible_bincount

    ids = query_ids()
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    counts = _flexible_bincount(ids)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if launches["bincount"] <= 0:
        raise AssertionError("retrieval_grouping: kernel bincount was never launched on the main path")
    t0 = time.perf_counter()
    cpu_counts = _flexible_bincount(ids.cpu())
    cpu_seconds = time.perf_counter() - t0
    if not torch.equal(counts.cpu(), cpu_counts):
        raise AssertionError("retrieval_grouping: the card's counts differ from the CPU's")
    if counts.numel() != 6980 or not bool((counts == 1000).all()):
        raise AssertionError("retrieval_grouping: expected 6,980 groups of 1000 candidates")
    warm = []
    for _ in range(5):  # the same call again, with the card's allocator and sort warm
        t0 = time.perf_counter()
        _flexible_bincount(ids)
        torch.cuda.synchronize()
        warm.append(time.perf_counter() - t0)
    return {
        "phase": "retrieval_grouping", "ids": int(ids.numel()), "groups": int(counts.numel()),
        "wall_s": seconds, "warm_wall_s_min": min(warm), "cpu_wall_s": cpu_seconds, "launches": launches,
    }


# ------------------------------------------------------------------ retrieval and wrappers

# MS MARCO passage ranking, dev (small): 6,980 queries, each reranking its top-1000
# candidates; query ids are sparse below 1.1 M as the dev qids are
RETRIEVAL_QUERIES = 6980
RETRIEVAL_CANDIDATES = 1000
RETRIEVAL_QID_RANGE = 1_100_000
# queries per update (70 updates), and the queries whose per-query loop is timed
RETRIEVAL_BATCH_QUERIES = 100
RETRIEVAL_LOOP_QUERIES = 200
# relevant passages a query has among its candidates: 14% none (BM25's recall@1000 of
# about 0.857), about 1.07 a judged query
RETRIEVAL_POSITIVES = ((0, 0.14), (1, 0.80), (2, 0.06))
# the tests' tolerance of retrieval scores, which lie in [0, 1]
RETRIEVAL_ATOL = 1e-6
# AUROC's batched Mann-Whitney count against ``binary_auroc``'s float32 trapezoid over
# up to 1000 points of one query
RETRIEVAL_AUROC_ATOL = 1e-5
RETRIEVAL_FUSE = 8


def retrieval_metrics(device: str) -> dict:
    """The leaderboard's and BEIR's settings: MRR@10, Recall@1000, NDCG@10, MAP, then
    the rest of the family at their usual cut-offs."""
    from torchmetrics_tpu_torch import retrieval as tr

    kw = {"device": device}
    return {
        "mrr_at_10": tr.RetrievalMRR(top_k=10, **kw),
        "recall_at_1000": tr.RetrievalRecall(top_k=1000, **kw),
        "ndcg_at_10": tr.RetrievalNormalizedDCG(top_k=10, **kw),
        "map": tr.RetrievalMAP(**kw),
        "precision_at_10": tr.RetrievalPrecision(top_k=10, **kw),
        "hit_rate_at_10": tr.RetrievalHitRate(top_k=10, **kw),
        "fall_out_at_10": tr.RetrievalFallOut(top_k=10, **kw),
        "r_precision": tr.RetrievalRPrecision(**kw),
        "auroc": tr.RetrievalAUROC(**kw),
        "pr_curve_max_k_100": tr.RetrievalPrecisionRecallCurve(max_k=100, **kw),
        "recall_at_precision_0_1": tr.RetrievalRecallAtFixedPrecision(min_precision=0.1, max_k=100, **kw),
    }


def msmarco_batches(queries: int = RETRIEVAL_QUERIES, candidates: int = RETRIEVAL_CANDIDATES,
                    batch_queries: int = RETRIEVAL_BATCH_QUERIES, seed: int = 18, device: str = "cuda") -> list:
    """A reranking run shaped like MS MARCO dev (small), made with numpy from a seed:
    (scores float32, labels int32, query ids int32) of ``batch_queries`` queries a batch,
    the rows of each batch shuffled. Scores are a reranker's logits (positives about
    two standard deviations up) rounded to 4 decimals, as run files print them, so
    ties occur."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    qids = rng.choice(RETRIEVAL_QID_RANGE, queries, replace=False).astype(np.int32)
    counts = rng.choice([k for k, _ in RETRIEVAL_POSITIVES], queries, p=[p for _, p in RETRIEVAL_POSITIVES])
    labels = np.zeros((queries, candidates), dtype=np.int32)
    slots = rng.randint(0, candidates, (queries, 2))
    for k in range(2):
        rows = np.flatnonzero(counts > k)
        labels[rows, slots[rows, k]] = 1
    scores = np.round(rng.randn(queries, candidates) + 2.0 * labels, 4).astype(np.float32)
    batches = []
    for start in range(0, queries, batch_queries):
        q = slice(start, start + batch_queries)
        order = rng.permutation(labels[q].size)
        ids = np.repeat(qids[q], candidates)[order]
        batches.append(tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                             for a in (scores[q].reshape(-1)[order], labels[q].reshape(-1)[order], ids)))
    return batches


def retrieval_feed(metrics: dict, batches: list) -> float:
    """Every batch into every metric (one collection); the seconds it took."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection

    collection = MetricCollection(metrics, compute_groups=False)
    cuda = batches[0][0].is_cuda
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for preds, target, ids in batches:
        collection.update(preds, target, indexes=ids)
    if cuda:
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def retrieval_computes(metrics: dict) -> tuple:
    """Each metric's value and the seconds its ``compute`` took (ended by a synchronise)."""
    import torch

    values, seconds = {}, {}
    for name, m in metrics.items():
        m._computed = None
        if m.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        values[name] = m.compute()
        if m.device.type == "cuda":
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
    return values, seconds


def retrieval_loop_check(metrics: dict, batches: list, queries: int) -> dict:
    """The batched per-query scores of the first ``queries`` queries on the card against
    a loop of the port's single-query functions on the card, query by query; the
    loop's seconds for each metric; and ``RetrievalAUROC(max_fpr=0.1)``, which scores
    one query at a time, on the card against the CPU."""
    import torch

    from torchmetrics_tpu_torch import retrieval as tr
    from torchmetrics_tpu_torch.functional.retrieval import retrieval_precision_recall_curve
    from torchmetrics_tpu_torch.retrieval import segments
    from torchmetrics_tpu_torch.retrieval.base import RetrievalMetric

    take = -(-queries // RETRIEVAL_BATCH_QUERIES)
    preds, target, ids = (torch.cat([b[i] for b in batches[:take]]) for i in range(3))
    seg = segments.QuerySegments(ids, preds, target)
    if seg.num_queries != queries:
        raise AssertionError(f"retrieval_eval: {seg.num_queries} queries in the loop check, expected {queries}")
    out = {}
    for name, m in metrics.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if isinstance(m, RetrievalMetric):
            loop_scores, loop_empty = RetrievalMetric._query_scores(m, seg)
            torch.cuda.synchronize()
            loop_s = time.perf_counter() - t0
            scores, empty = m._query_scores(seg)
            if not torch.equal(empty, loop_empty):
                raise AssertionError(f"retrieval_eval: {name}'s batched empty queries differ from the loop's")
            scores = torch.where(empty, torch.zeros_like(scores), scores)
            atol = RETRIEVAL_AUROC_ATOL if name == "auroc" else RETRIEVAL_ATOL
        else:  # the curves: each query's precision and recall at k = 1..max_k
            curves = [retrieval_precision_recall_curve(p, t, m.max_k) for p, t in seg.groups()]
            loop_scores = torch.stack([torch.stack(c[:2]) for c in curves])
            torch.cuda.synchronize()
            loop_s = time.perf_counter() - t0
            precision, recall, empty = segments.curve_scores(seg, m.max_k, m.adaptive_k)
            zero = empty[:, None]
            scores = torch.stack([torch.where(zero, torch.zeros_like(precision), precision),
                                  torch.where(zero, torch.zeros_like(recall), recall)], dim=1)
            atol = RETRIEVAL_ATOL
        gap = float((scores - loop_scores).abs().max())
        if not gap <= atol:
            raise AssertionError(f"retrieval_eval: {name}'s batched scores differ from the loop's by {gap} > {atol}")
        out[name] = {"max_gap": gap, "loop_s": loop_s, "loop_s_scaled": loop_s * RETRIEVAL_QUERIES / queries}
    # AUROC with max_fpr has no batched form: its per-query loop is the compute, on the
    # card and on the CPU
    loops = {}
    for device, s in (("cuda", seg), ("cpu", segments.QuerySegments(ids.cpu(), preds.cpu(), target.cpu()))):
        partial = tr.RetrievalAUROC(max_fpr=0.1, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores, empty = partial._query_scores(s)
        torch.cuda.synchronize()
        loops[device] = (scores.cpu(), empty.cpu(), time.perf_counter() - t0)
    gap = float((loops["cuda"][0] - loops["cpu"][0]).abs().max())
    if not torch.equal(loops["cuda"][1], loops["cpu"][1]) or not gap <= RETRIEVAL_AUROC_ATOL:
        raise AssertionError(f"retrieval_eval: AUROC(max_fpr=0.1) per query on the card differs from the CPU by {gap}")
    out["auroc_max_fpr_0_1"] = {"max_gap_card_cpu": gap, "loop_s": loops["cuda"][2],
                                "loop_s_scaled": loops["cuda"][2] * RETRIEVAL_QUERIES / queries,
                                "cpu_loop_s": loops["cpu"][2]}
    return out


def retrieval_captured_map(batches: list, reference) -> dict:
    """``RetrievalMAP(buffer_capacity=...)`` with its update captured, fed through
    ``MetricPipeline(fuse=8)``: its value must equal the list-state metric's."""
    import torch

    from torchmetrics_tpu_torch import retrieval as tr
    from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig

    rows = sum(b[0].numel() for b in batches)
    buffered = tr.RetrievalMAP(buffer_capacity=rows, jit_update=True, device="cuda")
    pipe = MetricPipeline(buffered, PipelineConfig(fuse=RETRIEVAL_FUSE))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.run(batches)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    replays = sum(info["replays"] for info in pipe.cache_info())
    if buffered.preds.count != rows or replays <= 0:
        raise AssertionError(f"retrieval_eval: the captured MAP holds {buffered.preds.count} of {rows} rows"
                             f" after {replays} replays")
    value = buffered.compute()
    gap = abs(float(value) - float(reference))
    if not gap <= RETRIEVAL_ATOL:
        raise AssertionError(f"retrieval_eval: the captured buffered MAP {float(value)} != list-state {float(reference)}")
    del pipe, buffered
    release_graphs()
    return {"value": float(value), "gap": gap, "replays": replays, "wall_s": seconds,
            "us_per_update": seconds / len(batches) * 1e6}


def retrieval_profile(metrics: dict) -> dict:
    """One warm ``compute`` of every metric under torch.profiler: device time, the wall
    clock and the device's busy share of it, and the kernels that take most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        retrieval_computes(metrics)
        wall = time.perf_counter() - t0
    device = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            device[e.key] = (us, e.count)
    total_us = sum(us for us, _ in device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1][0])[:8]
    return {"wall_s": wall, "device_s": total_us / 1e6, "device_busy_share": total_us / 1e6 / wall if wall else None,
            "top_kernels": [{"name": k[:90], "ms": us / 1e3, "calls": n} for k, (us, n) in top]}


def retrieval_eval_phase() -> dict:
    """The eleven retrieval metrics over an MS MARCO dev-small-shaped reranking run on the
    card, against the same run on the CPU."""
    import torch

    from torchmetrics_tpu_torch.ops import kernels

    batches = msmarco_batches()
    rows = sum(b[0].numel() for b in batches)
    card = retrieval_metrics("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    feed_s = retrieval_feed(card, batches)
    values, compute_s = retrieval_computes(card)
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    for kernel in ("weighted_bincount", "bincount"):
        if launches[kernel] <= 0:
            raise AssertionError(f"retrieval_eval: kernel {kernel} was never launched by compute")
    _, warm_s = retrieval_computes(card)

    cpu = retrieval_metrics("cpu")
    cpu_batches = [tuple(a.cpu() for a in b) for b in batches]
    cpu_feed_s = retrieval_feed(cpu, cpu_batches)
    cpu_values, cpu_compute_s = retrieval_computes(cpu)
    gaps = {name: compare(values[name], cpu_values[name], f"value.{name}", lambda _: (RETRIEVAL_ATOL, 0.0))
            for name in values}
    del cpu, cpu_batches

    loop = retrieval_loop_check(card, batches, RETRIEVAL_LOOP_QUERIES)
    captured = retrieval_captured_map(batches, values["map"])
    profile_record = retrieval_profile(card)
    summary = {}
    for name, value in values.items():
        if name == "pr_curve_max_k_100":
            summary[name] = {"precision_at_1": float(value[0][0]), "recall_at_100": float(value[1][-1])}
        elif name == "recall_at_precision_0_1":
            summary[name] = {"recall": float(value[0]), "best_k": int(value[1])}
        else:
            summary[name] = float(value)
    return {
        "phase": "retrieval_eval", "queries": RETRIEVAL_QUERIES, "candidates": RETRIEVAL_CANDIDATES, "rows": rows,
        "updates": len(batches), "launches": launches, "values": summary,
        "us_per_update": feed_s / len(batches) * 1e6, "compute_s": compute_s, "warm_compute_s": warm_s,
        "compute_s_total": sum(compute_s.values()), "cpu_us_per_update": cpu_feed_s / len(batches) * 1e6,
        "cpu_compute_s": cpu_compute_s, "max_float_gap": max(gaps.values()), "loop_check": loop,
        "captured_map": captured, "peak_memory_bytes": peak, "profile": profile_record,
    }


WRAPPER_STS_PAIRS = 1500  # STS-B validation
WRAPPER_STS_BATCH = 100
WRAPPER_IMAGENET_BATCHES = 20  # batches of 500 of the ImageNet-1k data
WRAPPER_EPOCHS = 3
WRAPPER_SEED = 7


def sts_data(n: int = WRAPPER_STS_PAIRS, outputs: int = 5, seed: int = 19, device: str = "cuda"):
    """Gold similarity scores 0..5 (as STS-B's averaged ratings, in steps of 0.2) and a
    model's noisy predictions, ``outputs`` columns (one per annotator or model head)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    gold = np.round(rng.rand(n, outputs) * 25) / 5
    pred = np.clip(gold + rng.randn(n, outputs) * 0.9, 0.0, 5.0)
    return (torch.from_numpy(pred.astype(np.float32)).to(device), torch.from_numpy(gold.astype(np.float32)).to(device))


def wrappers_run(device: str, sts, imagenet) -> dict:
    """The regression metrics over the STS-B pairs and the wrappers over ImageNet batches
    of 500 (1000 classes), metrics on ``device`` and data where it is given; every value."""
    import numpy as np
    import torch

    from torchmetrics_tpu_torch import aggregation, regression as tr, wrappers as tw
    from torchmetrics_tpu_torch import classification as tc

    kw = {"device": device}
    pred, gold = sts
    preds, target = imagenet
    regression = {
        "pearson": tr.PearsonCorrCoef(**kw), "spearman": tr.SpearmanCorrCoef(**kw),
        "kendall": tr.KendallRankCorrCoef(**kw), "concordance": tr.ConcordanceCorrCoef(**kw),
        "r2": tr.R2Score(**kw), "explained_variance": tr.ExplainedVariance(**kw),
        "rse": tr.RelativeSquaredError(**kw),
    }
    np.random.seed(WRAPPER_SEED)
    wrapped = {
        "bootstrap_macro_accuracy": tw.BootStrapper(tc.MulticlassAccuracy(1000, average="macro", **kw),
                                                    num_bootstraps=20),
        "classwise_f1": tw.ClasswiseWrapper(tc.MulticlassF1Score(1000, average=None, **kw)),
        "minmax_top1": tw.MinMaxMetric(tc.MulticlassAccuracy(1000, average="micro", **kw)),
        "multitask": tw.MultitaskWrapper({"classification": tc.MulticlassAccuracy(1000, average="macro", **kw),
                                          "regression": tr.MeanSquaredError(**kw)}),
    }
    tracker = tw.MetricTracker(tc.MulticlassAccuracy(1000, average="macro", **kw))
    running = {"mean_w5": tw.Running(aggregation.MeanMetric(**kw), window=5),
               "sum_w5": aggregation.RunningSum(window=5, **kw)}
    multioutput = tw.MultioutputWrapper(tr.R2Score(**kw), 5)
    binarized = tw.BinaryTargetTransformer(tc.BinaryAccuracy(**kw), threshold=2.5)

    values = {}
    for start in range(0, pred.shape[0], WRAPPER_STS_BATCH):
        p, g = pred[start:start + WRAPPER_STS_BATCH], gold[start:start + WRAPPER_STS_BATCH]
        for m in regression.values():
            m.update(p[:, 0], g[:, 0])
        for m in running.values():
            m.update(p[:, 0] - g[:, 0])
        multioutput.update(p, g)
        binarized.update(p[:, 0] / 5, g[:, 0])
    batch = preds.shape[0] // WRAPPER_IMAGENET_BATCHES
    minmax = []
    for i in range(WRAPPER_IMAGENET_BATCHES):
        p, t = preds[i * batch:(i + 1) * batch], target[i * batch:(i + 1) * batch]
        wrapped["bootstrap_macro_accuracy"].update(p, t)
        wrapped["classwise_f1"].update(p, t)
        wrapped["minmax_top1"].update(p, t)
        minmax.append(wrapped["minmax_top1"].compute())
        s = i * 75 % (pred.shape[0] - batch)
        wrapped["multitask"].update({"classification": p, "regression": pred[s:s + batch, 0]},
                                    {"classification": t, "regression": gold[s:s + batch, 0]})
        if i % (WRAPPER_IMAGENET_BATCHES // WRAPPER_EPOCHS) == 0 and tracker.n_steps < WRAPPER_EPOCHS:
            tracker.increment()
        tracker.update(p, t)
    values.update({name: m.compute() for name, m in regression.items()})
    values.update({name: m.compute() for name, m in running.items()})
    values.update({name: m.compute() for name, m in wrapped.items()})
    values["minmax_after_each_batch"] = [d["raw"] for d in minmax]
    values["multioutput_r2"] = multioutput.compute()
    values["binary_target_accuracy"] = binarized.compute()
    values["tracker_all"] = tracker.compute_all()
    best, step = tracker.best_metric(return_step=True)
    values["tracker_best"] = torch.tensor([best, float(step)])
    return values


def wrappers_eval_phase() -> dict:
    """The rest of regression and the wrappers on the card, against the CPU."""
    import torch

    from torchmetrics_tpu_torch.ops import kernels

    sts = sts_data()
    preds, target = imagenet_data(n=WRAPPER_IMAGENET_BATCHES * 500)
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = wrappers_run("cuda", sts, (preds, target))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    if launches["confusion_matrix"] <= 0:
        raise AssertionError("wrappers_eval: kernel confusion_matrix was never launched through the wrappers")
    t0 = time.perf_counter()
    cpu = wrappers_run("cpu", tuple(a.cpu() for a in sts), (preds.cpu(), target.cpu()))
    cpu_seconds = time.perf_counter() - t0
    gap = compare(card, cpu, "value")
    summary = {k: float(v) for k, v in card.items() if isinstance(v, torch.Tensor) and v.numel() == 1}
    return {"phase": "wrappers_eval", "sts_pairs": WRAPPER_STS_PAIRS, "imagenet_rows": int(preds.shape[0]),
            "launches": launches, "wall_s": seconds, "cpu_wall_s": cpu_seconds, "max_float_gap": gap,
            "values": summary}


# ------------------------------------------------- clustering, nominal, segmentation, pairwise

# ImageNet-1k validation clustered into 1000 clusters, SCAN's NMI / AMI / ARI protocol
# (Van Gansbeke et al., ECCV 2020): 50,000 labels (50 a class) fed in 100 batches of 500,
# and 50,000 x 2048 float32 features (ResNet-50's pooled width) around 1000 centroids
CLUSTER_SAMPLES = 50_000
CLUSTER_CLASSES = 1000
CLUSTER_BATCH = 500
CLUSTER_FEATURES = 2048
CLUSTER_EXTRINSIC = ("MutualInfoScore", "NormalizedMutualInfoScore", "AdjustedMutualInfoScore", "RandScore",
                     "AdjustedRandScore", "FowlkesMallowsIndex", "HomogeneityScore", "CompletenessScore",
                     "VMeasureScore")
CLUSTER_INTRINSIC = ("CalinskiHarabaszScore", "DaviesBouldinScore", "DunnIndex")
CLUSTER_ATOL = 1e-6
CLUSTER_AMI_ATOL = 1e-5  # its expected mutual information is summed in another order
CLUSTER_INTRINSIC_RTOL = 1e-5  # float32 products and sums of 10^8 terms in another order


def imagenet_clusters(n: int = CLUSTER_SAMPLES, classes: int = CLUSTER_CLASSES, features: int = CLUSTER_FEATURES,
                      seed: int = 41, device: str = "cuda"):
    """The validation labels (``n / classes`` a class, shuffled), a clustering of them (60%
    of the samples in their class's cluster under a seeded relabelling, the rest in a
    uniform one), and float32 features drawn around one centroid a class."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    target = torch.arange(classes, device=device).repeat_interleave(n // classes)
    target = target[torch.randperm(n, generator=g, device=device)]
    relabel = torch.randperm(classes, generator=g, device=device)
    noise = torch.randint(0, classes, (n,), generator=g, device=device)
    preds = torch.where(torch.rand(n, generator=g, device=device) < 0.6, relabel[target], noise)
    centroids = torch.randn(classes, features, generator=g, device=device) * 0.5
    data = centroids[target] + torch.randn(n, features, generator=g, device=device)
    return preds, target, data


def clustering_run(device: str, preds, target, data) -> dict:
    """The nine extrinsic classes over (``preds``, ``target``) and the three intrinsic ones
    over (``data``, ``preds``) in batches of CLUSTER_BATCH on ``device``: each compute's
    value, seconds and bincount launches, and on the card the seconds of a second, warm
    compute (its value cache dropped)."""
    import torch

    from torchmetrics_tpu_torch import clustering as tcl
    from torchmetrics_tpu_torch.ops import kernels

    extrinsic = {name: getattr(tcl, name)(device=device) for name in CLUSTER_EXTRINSIC}
    intrinsic = {name: getattr(tcl, name)(device=device) for name in CLUSTER_INTRINSIC}
    t0 = time.perf_counter()
    for start in range(0, preds.shape[0], CLUSTER_BATCH):
        p, t, d = (a[start:start + CLUSTER_BATCH] for a in (preds, target, data))
        for m in extrinsic.values():
            m.update(p, t)
        for m in intrinsic.values():
            m.update(d, p)
    feed_s = time.perf_counter() - t0
    values, seconds, warm, launches = {}, {}, {}, {}
    for name, m in {**extrinsic, **intrinsic}.items():
        for run in range(1 if device == "cpu" else 2):  # the first compute; on the card a warm one too
            m._computed = None
            before = kernels.LAUNCHES["bincount"]
            if device != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            values[name] = m.compute()
            if device != "cpu":
                torch.cuda.synchronize()
            (warm if run else seconds)[name] = time.perf_counter() - t0
            launches.setdefault(name, kernels.LAUNCHES["bincount"] - before)
    return {"values": values, "compute_s": seconds, "warm_compute_s": warm, "bincount_per_compute": launches,
            "feed_s": feed_s}


def _clustering_tolerance(where: str):
    if any(name in where for name in CLUSTER_INTRINSIC):
        return 0.0, CLUSTER_INTRINSIC_RTOL
    return (CLUSTER_AMI_ATOL if "AdjustedMutualInfo" in where else CLUSTER_ATOL), 0.0


def clustering_eval_phase() -> dict:
    """The twelve clustering classes over an ImageNet-1k validation clustering on the card,
    against the same run on the CPU."""
    import torch

    from torchmetrics_tpu_torch.ops import kernels

    preds, target, data = imagenet_clusters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    card = clustering_run("cuda", preds, target, data)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    wrong = {name: n for name, n in card["bincount_per_compute"].items() if n != 1}
    if wrong:
        raise AssertionError(f"clustering_eval: expected one bincount launch a compute, got {wrong}")
    t0 = time.perf_counter()
    cpu = clustering_run("cpu", preds.cpu(), target.cpu(), data.cpu())
    cpu_wall = time.perf_counter() - t0
    gap = compare(card["values"], cpu["values"], "value", _clustering_tolerance)
    return {
        "phase": "clustering_eval", "samples": CLUSTER_SAMPLES, "classes": CLUSTER_CLASSES,
        "clusters": int(torch.unique(preds).numel()), "features": CLUSTER_FEATURES, "batches":
        CLUSTER_SAMPLES // CLUSTER_BATCH, "launches": launches,
        "values": {name: float(v) for name, v in card["values"].items()},
        "compute_s": card["compute_s"], "warm_compute_s": card["warm_compute_s"],
        "bincount_per_compute": card["bincount_per_compute"],
        "feed_s": card["feed_s"], "wall_s": wall, "peak_memory_bytes": peak, "cpu_compute_s": cpu["compute_s"],
        "cpu_feed_s": cpu["feed_s"], "cpu_wall_s": cpu_wall, "cpu_rows": CLUSTER_SAMPLES, "max_float_gap": gap,
    }


# The UCI Adult census (48,842 rows) at its nine categorical columns' published
# cardinalities; about 7% NaN where Adult has "?"
ADULT_ROWS = 48_842
ADULT_COLUMNS = (("workclass", 9), ("education", 16), ("marital-status", 7), ("occupation", 15),
                 ("relationship", 6), ("race", 5), ("sex", 2), ("native-country", 42), ("income", 2))
ADULT_MISSING = ("workclass", "occupation", "native-country")
ADULT_BATCH = 4096
ADULT_PAIR = ("education", "occupation")  # the stateful classes' two series
NOMINAL_MATRICES = {"cramers_v_matrix": True, "pearsons_contingency_coefficient_matrix": True,
                    "tschuprows_t_matrix": True, "theils_u_matrix": False}
NOMINAL_CLASSES = ("CramersV", "PearsonsContingencyCoefficient", "TschuprowsT", "TheilsU")
FLEISS_ITEMS, FLEISS_CATEGORIES, FLEISS_RATERS, FLEISS_BATCH = 100_000, 5, 10, 10_000
NOMINAL_ATOL = 1e-6


def adult_matrix(rows: int = ADULT_ROWS, seed: int = 43, device: str = "cuda"):
    """float32 [rows, 9]: each column half from a latent class of 8 and half from a
    skewed (1 / (k + 1)) draw over its cardinality; NaN in about 7% of the rows of the
    three columns Adult leaves unknown."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    latent = torch.randint(0, 8, (rows,), generator=g, device=device)
    columns = []
    for index, (name, k) in enumerate(ADULT_COLUMNS):
        weights = 1.0 / torch.arange(1, k + 1, device=device, dtype=torch.float32)
        skewed = torch.multinomial(weights, rows, replacement=True, generator=g)
        column = torch.where(torch.rand(rows, generator=g, device=device) < 0.5, (latent * 7 + index) % k, skewed)
        column = column.to(torch.float32)
        if name in ADULT_MISSING:
            column = torch.where(torch.rand(rows, generator=g, device=device) < 0.07, float("nan"), column)
        columns.append(column)
    return torch.stack(columns, dim=1)


def fleiss_ratings(seed: int = 44, device: str = "cuda"):
    """[items, categories] counts of 10 raters an item (70% pick the item's category) and
    [items, categories, raters] float32 probabilities whose argmax is each rater's pick."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    truth = torch.randint(0, FLEISS_CATEGORIES, (FLEISS_ITEMS, 1), generator=g, device=device)
    picks = torch.where(torch.rand(FLEISS_ITEMS, FLEISS_RATERS, generator=g, device=device) < 0.7, truth,
                        torch.randint(0, FLEISS_CATEGORIES, (FLEISS_ITEMS, FLEISS_RATERS), generator=g, device=device))
    counts = torch.zeros(FLEISS_ITEMS, FLEISS_CATEGORIES, dtype=torch.int64, device=device)
    counts.scatter_add_(1, picks, torch.ones_like(picks))
    probs = torch.rand(FLEISS_ITEMS, FLEISS_CATEGORIES, FLEISS_RATERS, generator=g, device=device)
    probs.scatter_(1, picks[:, None, :], 2.0)
    return counts, probs


def nominal_run(device: str, matrix, counts, probs) -> dict:
    """The four ``*_matrix`` functions under ``replace`` and ``drop``, the four stateful
    classes over ADULT_PAIR in batches of ADULT_BATCH, and ``FleissKappa`` in both modes
    in batches of FLEISS_BATCH, on ``device``: values, states and seconds."""
    import warnings

    import torch

    from torchmetrics_tpu_torch import nominal as tnom
    from torchmetrics_tpu_torch.functional import nominal as fnom

    def timed(fn):
        if device != "cpu":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if device != "cpu":
            torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    values, seconds = {}, {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a bias correction that cannot apply warns, as in JAX
        for name in NOMINAL_MATRICES:
            for strategy in ("replace", "drop"):
                key = f"{name}.{strategy}"
                values[key], seconds[key] = timed(lambda: getattr(fnom, name)(matrix, nan_strategy=strategy))
    names = [name for name, _ in ADULT_COLUMNS]
    p, t = matrix[:, names.index(ADULT_PAIR[0])], matrix[:, names.index(ADULT_PAIR[1])]
    classes = {name: getattr(tnom, name)(num_classes=16, device=device) for name in NOMINAL_CLASSES}
    classes["FleissKappa.counts"] = tnom.FleissKappa(mode="counts", device=device)
    classes["FleissKappa.probs"] = tnom.FleissKappa(mode="probs", device=device)

    def feed():
        for start in range(0, p.shape[0], ADULT_BATCH):
            for name in NOMINAL_CLASSES:
                classes[name].update(p[start:start + ADULT_BATCH], t[start:start + ADULT_BATCH])
        for start in range(0, counts.shape[0], FLEISS_BATCH):
            classes["FleissKappa.counts"].update(counts[start:start + FLEISS_BATCH])
            classes["FleissKappa.probs"].update(probs[start:start + FLEISS_BATCH])

    _, seconds["feed"] = timed(feed)
    for name, m in classes.items():
        values[name], seconds[name] = timed(m.compute)
    states = {name: classes[name].confmat for name in NOMINAL_CLASSES}
    return {"values": values, "states": states, "seconds": seconds}


def nominal_eval_phase() -> dict:
    """Nominal association over a UCI Adult-shaped table on the card, against the CPU."""
    import torch

    from torchmetrics_tpu_torch.ops import kernels

    matrix = adult_matrix()
    counts, probs = fleiss_ratings()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    card = nominal_run("cuda", matrix, counts, probs)
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    columns = len(ADULT_COLUMNS)
    pairs = sum(2 * (columns * (columns - 1) // (2 if symmetric else 1)) for symmetric in NOMINAL_MATRICES.values())
    updates = -(-matrix.shape[0] // ADULT_BATCH) * len(NOMINAL_CLASSES)
    if launches["confusion_matrix"] != pairs + updates:
        raise AssertionError(f"nominal_eval: expected {pairs} + {updates} confusion-matrix launches, got {launches}")
    t0 = time.perf_counter()
    cpu = nominal_run("cpu", matrix.cpu(), counts.cpu(), probs.cpu())
    cpu_wall = time.perf_counter() - t0
    compare(card["states"], cpu["states"], "state", lambda _: (0.0, 0.0))
    gap = compare(card["values"], cpu["values"], "value", lambda _: (NOMINAL_ATOL, 0.0))
    summary = {name: (float(v) if v.numel() == 1 else [round(float(x), 4) for x in v[0]])
               for name, v in card["values"].items()}
    return {
        "phase": "nominal_eval", "rows": int(matrix.shape[0]), "columns": dict(ADULT_COLUMNS),
        "nan_rows": {name: int(matrix[:, i].isnan().sum()) for i, (name, _) in enumerate(ADULT_COLUMNS)
                     if name in ADULT_MISSING},
        "launches": launches, "matrix_launches": pairs, "class_update_launches": updates,
        "values": summary, "seconds": card["seconds"], "wall_s": wall, "peak_memory_bytes": peak,
        "cpu_seconds": cpu["seconds"], "cpu_wall_s": cpu_wall, "max_float_gap": gap,
        "fleiss": {"items": FLEISS_ITEMS, "categories": FLEISS_CATEGORIES, "raters": FLEISS_RATERS},
    }


# Cityscapes validation: 1024 x 2048, 19 classes, 255 void; 100 images (cut from 500) in
# batches of 4, index input
CITYSCAPES_IMAGES = 100
CITYSCAPES_FULL_IMAGES = 500
CITYSCAPES_BATCH = 4
CITYSCAPES_CLASSES = 19
CITYSCAPES_SHAPE = (1024, 2048)
CITYSCAPES_CPU_IMAGES = 8
SEGMENTATION_ATOL = 1e-6


def cityscapes_batch(index: int, batch: int = CITYSCAPES_BATCH, device: str = "cuda"):
    """Batch ``index``: int64 target maps of 32 x 32-pixel regions of one class each, 10%
    of the regions void (255), and predictions that follow the target on 80% of the
    pixels, a uniform class elsewhere and on void."""
    import torch

    g = torch.Generator(device=device).manual_seed(1000 + index)
    h, w = CITYSCAPES_SHAPE
    regions = torch.randint(0, CITYSCAPES_CLASSES, (batch, h // 32, w // 32), generator=g, device=device)
    regions = torch.where(torch.rand(regions.shape, generator=g, device=device) < 0.1, 255, regions)
    target = regions.repeat_interleave(32, dim=1).repeat_interleave(32, dim=2)
    noise = torch.randint(0, CITYSCAPES_CLASSES, (batch, h, w), generator=g, device=device)
    follow = (torch.rand((batch, h, w), generator=g, device=device) < 0.8) & (target != 255)
    return torch.where(follow, target, noise), target


def segmentation_metrics(device: str) -> dict:
    from torchmetrics_tpu_torch import segmentation as tseg

    kw = {"num_classes": CITYSCAPES_CLASSES, "input_format": "index", "device": device}
    return {
        "miou": tseg.MeanIoU(**kw), "miou_per_class": tseg.MeanIoU(per_class=True, **kw),
        "miou_no_background": tseg.MeanIoU(include_background=False, **kw),
        "miou_per_class_no_background": tseg.MeanIoU(per_class=True, include_background=False, **kw),
        "gdice_square": tseg.GeneralizedDiceScore(weight_type="square", **kw),
    }


def segmentation_eval_phase() -> dict:
    """MeanIoU and GeneralizedDiceScore over Cityscapes-shaped index maps on the card: one
    bincount launch a metric an update; the CPU on the first images; one-hot input on the
    first images against the index route."""
    import torch

    from torchmetrics_tpu_torch.functional import segmentation as fseg
    from torchmetrics_tpu_torch.ops import kernels

    card = segmentation_metrics("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    updates, feed_s = 0, 0.0
    t0 = time.perf_counter()
    for index in range(CITYSCAPES_IMAGES // CITYSCAPES_BATCH):
        preds, target = cityscapes_batch(index)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for m in card.values():
            m.update(preds, target)
        torch.cuda.synchronize()
        feed_s += time.perf_counter() - t1
        updates += 1
    values = {name: m.compute() for name, m in card.items()}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    if launches["bincount"] != updates * len(card):
        raise AssertionError(f"segmentation_eval: expected {updates * len(card)} bincount launches, got {launches}")

    # the CPU twin on the first images, fresh metrics on both sides
    first = [cityscapes_batch(i) for i in range(CITYSCAPES_CPU_IMAGES // CITYSCAPES_BATCH)]
    prefix, cpu = segmentation_metrics("cuda"), segmentation_metrics("cpu")
    t0 = time.perf_counter()
    for preds, target in first:
        p, t = preds.cpu(), target.cpu()
        for name in cpu:
            cpu[name].update(p, t)
            prefix[name].update(preds, target)
    cpu_s = time.perf_counter() - t0
    states = {name: m.state_dict(persistent_only=False) for name, m in prefix.items()}
    cpu_states = {name: m.state_dict(persistent_only=False) for name, m in cpu.items()}
    gap = compare(states, cpu_states, "state", lambda _: (SEGMENTATION_ATOL, 0.0))
    gap = max(gap, compare({k: m.compute() for k, m in prefix.items()}, {k: m.compute() for k, m in cpu.items()},
                           "value", lambda _: (SEGMENTATION_ATOL, 0.0)))
    counts = fseg.scores._index_class_sums(*first[0], CITYSCAPES_CLASSES)
    cpu_counts = fseg.scores._index_class_sums(first[0][0].cpu(), first[0][1].cpu(), CITYSCAPES_CLASSES)
    compare(counts, cpu_counts, "counts", lambda _: (0.0, 0.0))

    # one-hot input ([4, 19, 1024, 2048] bool maps) against the index route, on the card
    classes = torch.arange(CITYSCAPES_CLASSES, device=first[0][0].device)[None, :, None, None]
    one_hot_gap = 0.0
    for preds, target in first:
        for fn in (fseg.mean_iou, fseg.generalized_dice_score):
            for per_class in (False, True):
                by_index = fn(preds, target, CITYSCAPES_CLASSES, per_class=per_class, input_format="index")
                by_one_hot = fn(preds[:, None] == classes, target[:, None] == classes, CITYSCAPES_CLASSES,
                                per_class=per_class)
                one_hot_gap = max(one_hot_gap, compare(by_index, by_one_hot.cpu(), f"one_hot.{fn.__name__}",
                                                       lambda _: (SEGMENTATION_ATOL, 0.0)))
    summary = {name: (float(v) if v.numel() == 1 else [round(float(x), 5) for x in v]) for name, v in values.items()}
    # last, after every timing: an update's device time by kernel, the bincount kernel
    # against the id preparation around it
    profile = profile_loop(segmentation_metrics("cuda"), torch.cat([p for p, _ in first]),
                           torch.cat([t for _, t in first]), CITYSCAPES_BATCH, 2, track="bincount")
    return {
        "phase": "segmentation_eval", "images": CITYSCAPES_IMAGES,
        "cut": f"{CITYSCAPES_IMAGES} of Cityscapes' {CITYSCAPES_FULL_IMAGES} validation images",
        "shape": list(CITYSCAPES_SHAPE), "classes": CITYSCAPES_CLASSES, "batch": CITYSCAPES_BATCH,
        "updates": updates, "metrics": len(card), "launches": launches,
        "bincount_per_update": launches["bincount"] / updates, "values": summary,
        "us_per_update": feed_s / updates * 1e6, "wall_s": wall, "peak_memory_bytes": peak,
        "cpu_images": CITYSCAPES_CPU_IMAGES, "cpu_s": cpu_s, "max_float_gap": gap, "one_hot_gap": one_hot_gap,
        "profile": profile,
    }


# MS MARCO dev-small's 6,980 queries against 65,536 passages, BERT-base width; Manhattan
# and Minkowski (p = 3) of 4,096 embeddings with themselves
PAIRWISE_QUERIES = 6980
PAIRWISE_PASSAGES = 65_536
PAIRWISE_WIDTH = 768
PAIRWISE_SELF = 4096
PAIRWISE_CPU_ROWS = 256
PAIRWISE_COSINE_ATOL = 1e-5
PAIRWISE_RTOL = 1e-5  # of the matrix's largest magnitude


def msmarco_embeddings(seed: int = 45, device: str = "cuda"):
    """float32 query and passage embeddings: unit-variance noise around a shared direction
    (sentence embeddings are anisotropic)."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    shared = torch.randn(PAIRWISE_WIDTH, generator=g, device=device) * 0.5
    x = torch.randn(PAIRWISE_QUERIES, PAIRWISE_WIDTH, generator=g, device=device) + shared
    y = torch.randn(PAIRWISE_PASSAGES, PAIRWISE_WIDTH, generator=g, device=device) + shared
    return x, y


def pairwise_eval_phase() -> dict:
    """The five pairwise functions at MS MARCO scale on the card, against the CPU on the
    first rows; Manhattan and Minkowski within three outputs' memory."""
    import torch

    from torchmetrics_tpu_torch.functional import pairwise as fpw
    from torchmetrics_tpu_torch.ops import kernels

    x, y = msmarco_embeddings()
    z = y[:PAIRWISE_SELF].contiguous()
    # (function, kwargs, rows, columns): the card takes every row (the self sets with y
    # omitted: zero diagonal), the CPU the first PAIRWISE_CPU_ROWS
    cases = {
        "cosine": (fpw.pairwise_cosine_similarity, {}, x, y),
        "linear": (fpw.pairwise_linear_similarity, {}, x, y),
        "euclidean": (fpw.pairwise_euclidean_distance, {}, x, y),
        "manhattan": (fpw.pairwise_manhattan_distance, {}, z, None),
        "minkowski_3": (fpw.pairwise_minkowski_distance, {"exponent": 3}, z, None),
    }
    kernels.reset_launch_counts()
    seconds, peaks, gaps = {}, {}, {}
    t0 = time.perf_counter()
    for name, (fn, kw, rows, columns) in cases.items():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        out = fn(rows, columns, **kw)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t1
        peaks[name] = torch.cuda.max_memory_allocated() - base
        if columns is None:
            budget = 3 * out.numel() * out.element_size()
            if peaks[name] > budget:
                raise AssertionError(f"pairwise_eval: {name} took {peaks[name]} bytes, over its budget {budget}")
            if bool(out.diagonal().any()):
                raise AssertionError(f"pairwise_eval: {name}'s diagonal is not zero")
        t1 = time.perf_counter()
        want = fn(rows[:PAIRWISE_CPU_ROWS].cpu(), (rows if columns is None else columns).cpu(),
                  zero_diagonal=columns is None, **kw)
        seconds[f"{name}.cpu"] = time.perf_counter() - t1
        atol = PAIRWISE_COSINE_ATOL if name == "cosine" else PAIRWISE_RTOL * float(want.abs().max())
        gaps[name] = compare(out[:PAIRWISE_CPU_ROWS], want, f"pairwise.{name}", lambda _: (atol, 0.0))
        del out, want
    wall = time.perf_counter() - t0
    return {
        "phase": "pairwise_eval", "x": [PAIRWISE_QUERIES, PAIRWISE_WIDTH], "y": [PAIRWISE_PASSAGES, PAIRWISE_WIDTH],
        "self": [PAIRWISE_SELF, PAIRWISE_WIDTH], "launches": dict(kernels.LAUNCHES), "seconds": seconds,
        "peak_bytes_over_inputs": peaks, "max_float_gap": gaps, "cpu_rows": PAIRWISE_CPU_ROWS, "wall_s": wall,
    }


# ------------------------------------------------------------------------- text

# The five text workloads at their published sizes. No corpus is in the repo or
# downloaded: each is synthesized from a seed at the published counts and lengths, its
# words drawn from a seeded Zipf vocabulary and its hypotheses made from the references
# by seeded substitutions, deletions and insertions. LibriSpeech test-clean: 2,620
# utterances, 52,576 words. WMT14 newstest2014 en-de: 3,003 segments, one reference of
# ~21 words each. CNN/DailyMail 3.0.0 test: 11,490 pairs, references of ~55 words in 3-4
# sentences. SQuAD v1.1 dev: 10,570 questions, 1-3 gold answers of 1-10 words each.
# Perplexity at Llama-2's vocabulary, 40 windows of 4 x 2,048 tokens (327,680 tokens,
# about WikiText-2 test's length), the last window's last tokens set to ignore_index.
TEXT_VOCAB = 30_000
TEXT_ZIPF = 1.1
LIBRISPEECH_UTTERANCES = 2620
LIBRISPEECH_WORDS = 52_576
ASR_EDITS = 0.05
ASR_BATCH = 64
WMT_SEGMENTS = 3003
WMT_MEAN_WORDS = 21
MT_EDITS = 0.40
MT_BATCH = 128
CNNDM_PAIRS = 11_490
CNNDM_MEAN_WORDS = 55
SUMMARY_EDITS = 0.40
SUMMARY_BATCH = 256
SQUAD_QUESTIONS = 10_570
SQUAD_EXACT = 0.80
QA_BATCH = 512
LM_VOCAB = 32_000
LM_WINDOW = (4, 2048)
LM_UPDATES = 40
LM_PADDED = 1024
LM_IGNORE = -100
LM_PROFILED = 3
# the CPU twin of each string loop takes its first batches (the string work is the same
# host code on both sides), perplexity's its first window
TEXT_CPU_BATCHES = 2
# a cut of script time that pays for ``detection_eval``: the MT and summarization loops
# run on the first batches of their corpora (drawn whole, so those batches are the same)
TEXT_LOOP_BATCHES = {"mt": 6, "summarization": 8}  # 768 of 3,003 segments, 2,048 of 11,490 pairs
TEXT_ATOL = 1e-6
PERPLEXITY_RTOL = 1e-5
# list states of per-sentence scores, held within TEXT_ATOL; every other state exactly
TEXT_SCORE_STATES = ("sentence_", "rouge")


@functools.lru_cache(maxsize=1)
def text_vocabulary(seed: int = 70):
    """``TEXT_VOCAB`` distinct lowercase words (a few with German letters), most frequent
    first, and the cumulative Zipf distribution over them."""
    import numpy as np

    rng = np.random.RandomState(seed)
    letters = np.array(list("etaoinshrdlucmfwypvbgkjqxz"))
    weights = 1.0 / np.arange(1, len(letters) + 1) ** 0.8
    words, seen = [], set()
    while len(words) < TEXT_VOCAB:
        n = min(1 + rng.poisson(5.0), 14)
        word = "".join(rng.choice(letters, n, p=weights / weights.sum()))
        if rng.rand() < 0.02:
            word += rng.choice(["ä", "ö", "ü", "ß"])
        if word not in seen:
            seen.add(word)
            words.append(word)
    probs = 1.0 / np.arange(1, TEXT_VOCAB + 1) ** TEXT_ZIPF
    return np.array(words, dtype=object), np.cumsum(probs / probs.sum())


def text_draw(rng, n: int) -> list:
    """``n`` words drawn from the Zipf vocabulary."""
    import numpy as np

    vocab, cdf = text_vocabulary()
    return vocab[np.minimum(np.searchsorted(cdf, rng.random_sample(n), side="right"), len(vocab) - 1)].tolist()


def text_lengths(rng, count: int, total: int, low: int, high: int) -> list:
    """``count`` lengths in [low, high] from a gamma of mean total / count, summing to ``total``."""
    import numpy as np

    lengths = np.clip(np.rint(rng.gamma(4.0, total / count / 4.0, count)), low, high).astype(int)
    while lengths.sum() != total:
        i = rng.randint(count)
        step = 1 if lengths.sum() < total else -1
        if low <= lengths[i] + step <= high:
            lengths[i] += step
    return lengths.tolist()


def text_edit(rng, words: list, rate: float) -> list:
    """``words`` with each word substituted, deleted or followed by an inserted word at
    ``rate`` (the three alike)."""
    out = []
    draws = rng.rand(len(words))
    ops = rng.randint(0, 3, len(words))
    fresh = text_draw(rng, len(words))
    for word, u, op, new in zip(words, draws, ops, fresh):
        if u >= rate:
            out.append(word)
        elif op == 0:
            out.append(new)
        elif op == 2:
            out += [word, new]
    return out


def text_sentence(rng, words: list) -> str:
    """Capitalised, a comma after one word in ten, a full stop at the end."""
    words = [w + "," if rng.rand() < 0.1 else w for w in words[:-1]] + words[-1:]
    return (" ".join(words)[:1].upper() + " ".join(words)[1:] + ".") if words else ""


def librispeech_batches(seed: int = 71) -> list:
    """(hypotheses, references) batches of ``ASR_BATCH`` utterances: lowercase words, no
    punctuation, as LibriSpeech's normalised transcripts; ~5% word errors."""
    import numpy as np

    rng = np.random.RandomState(seed)
    lengths = text_lengths(rng, LIBRISPEECH_UTTERANCES, LIBRISPEECH_WORDS, 1, 120)
    words = text_draw(rng, LIBRISPEECH_WORDS)
    refs, hyps, start = [], [], 0
    for n in lengths:
        ref = words[start:start + n]
        start += n
        refs.append(" ".join(ref))
        hyps.append(" ".join(text_edit(rng, ref, ASR_EDITS)))
    return [(hyps[i:i + ASR_BATCH], refs[i:i + ASR_BATCH]) for i in range(0, len(refs), ASR_BATCH)]


def wmt14_batches(seed: int = 72) -> list:
    """(hypotheses, [[reference]]) batches of ``MT_BATCH`` segments, ~40% edits."""
    import numpy as np

    rng = np.random.RandomState(seed)
    lengths = text_lengths(rng, WMT_SEGMENTS, WMT_SEGMENTS * WMT_MEAN_WORDS, 1, 100)
    hyps, refs = [], []
    for n in lengths:
        ref = text_draw(rng, n)
        refs.append([text_sentence(rng, ref)])
        hyps.append(text_sentence(rng, text_edit(rng, ref, MT_EDITS)))
    return [(hyps[i:i + MT_BATCH], refs[i:i + MT_BATCH]) for i in range(0, len(refs), MT_BATCH)]


def cnndm_batches(seed: int = 73) -> list:
    """(summaries, references) batches of ``SUMMARY_BATCH`` pairs: references of 3-4
    sentences, ~55 words; summaries sentence by sentence with ~40% edits."""
    import numpy as np

    rng = np.random.RandomState(seed)
    lengths = text_lengths(rng, CNNDM_PAIRS, CNNDM_PAIRS * CNNDM_MEAN_WORDS, 12, 160)
    hyps, refs = [], []
    for n in lengths:
        cuts = np.sort(rng.choice(np.arange(3, n - 2), rng.randint(2, 4), replace=False)) if n > 8 else [n // 2]
        words = text_draw(rng, n)
        sentences = np.split(np.array(words, dtype=object), cuts)
        refs.append(" ".join(text_sentence(rng, s.tolist()) for s in sentences))
        hyps.append(" ".join(text_sentence(rng, text_edit(rng, s.tolist(), SUMMARY_EDITS))
                             for s in sentences))
    return [(hyps[i:i + SUMMARY_BATCH], refs[i:i + SUMMARY_BATCH]) for i in range(0, len(refs), SUMMARY_BATCH)]


def squad_batches(seed: int = 74) -> list:
    """(predictions, targets) batches of ``QA_BATCH`` questions in SQuAD's format: 1-3
    gold answers of 1-10 words (the others a word shorter or longer than the first, as
    annotators' spans of one passage are); ~80% of predictions exact up to case,
    articles and punctuation, the rest overlapping."""
    import numpy as np

    rng = np.random.RandomState(seed)
    preds, targets = [], []
    for i in range(SQUAD_QUESTIONS):
        qid = f"{seed:02x}{i:022x}"
        first = text_draw(rng, rng.randint(1, 11))
        golds = [" ".join(first)]
        for _ in range(rng.randint(0, 3)):
            extra = text_draw(rng, 1)[0]
            golds.append(" ".join(first[1:] if len(first) > 1 and rng.rand() < 0.5 else first + [extra]))
        if rng.rand() < SQUAD_EXACT:
            answer = golds[rng.randint(len(golds))]
            answer = rng.choice([answer, answer.capitalize(), "the " + answer, answer + "."])
        else:
            answer = " ".join(text_edit(rng, first, 0.5) or first[:1])
        preds.append({"prediction_text": answer, "id": qid})
        targets.append({"answers": {"answer_start": [0] * len(golds), "text": golds}, "id": qid})
    return [(preds[i:i + QA_BATCH], targets[i:i + QA_BATCH]) for i in range(0, len(preds), QA_BATCH)]


def text_metrics(loop: str, device: str) -> dict:
    from torchmetrics_tpu_torch import text as tt

    kw = {"device": device}
    if loop == "asr":
        return {"wer": tt.WordErrorRate(**kw), "cer": tt.CharErrorRate(**kw), "mer": tt.MatchErrorRate(**kw),
                "wil": tt.WordInfoLost(**kw), "wip": tt.WordInfoPreserved(**kw),
                "edit_mean": tt.EditDistance(**kw), "edit_none": tt.EditDistance(reduction="none", **kw)}
    if loop == "mt":
        return {"bleu": tt.BLEUScore(**kw), "sacrebleu_13a": tt.SacreBLEUScore(tokenize="13a", **kw),
                "chrf": tt.CHRFScore(n_word_order=0, **kw), "chrf_pp": tt.CHRFScore(n_word_order=2, **kw),
                "ter": tt.TranslationEditRate(**kw), "eed": tt.ExtendedEditDistance(**kw)}
    if loop == "summarization":
        return {"rouge": tt.ROUGEScore(rouge_keys=("rouge1", "rouge2", "rougeL", "rougeLsum"), **kw)}
    return {"squad": tt.SQuAD(**kw)}


TEXT_LOOPS = (("asr", librispeech_batches, "LibriSpeech test-clean", LIBRISPEECH_UTTERANCES),
              ("mt", wmt14_batches, "WMT14 newstest2014 en-de", WMT_SEGMENTS),
              ("summarization", cnndm_batches, "CNN/DailyMail 3.0.0 test", CNNDM_PAIRS),
              ("qa", squad_batches, "SQuAD v1.1 dev", SQUAD_QUESTIONS))


def _text_tolerance(where: str):
    """Scores and per-sentence lists within TEXT_ATOL; every other state exactly."""
    state = where.split(".")[2] if where.startswith("state.") else None
    if state is None or state.startswith(TEXT_SCORE_STATES):
        return TEXT_ATOL, 0.0
    return 0.0, 0.0


def text_values(values) -> object:
    """A JSON summary of a text metric's value: a float, or a vector's length and mean."""
    if isinstance(values, dict):
        return {k: text_values(v) for k, v in values.items()}
    if isinstance(values, tuple):
        return [text_values(v) for v in values]
    if values.numel() == 1:
        return float(values)
    return {"n": int(values.numel()), "mean": float(values.float().mean())}


def text_string_loop(loop: str, batches: list) -> dict:
    """One string loop on the card (states and values snapshotted after the CPU twin's
    prefix), then the twin on that prefix; fails unless they agree."""
    batch = len(batches[0][0])
    preds = [p for ps, _ in batches for p in ps]
    target = [t for _, ts in batches for t in ts]
    card = text_metrics(loop, "cuda")
    values, states, wall, (prefix_values, prefix_states) = run_loop(card, preds, target, batch,
                                                                    snapshot_after=TEXT_CPU_BATCHES)
    for name, metric_states in states.items():
        for key, state in metric_states.items():
            for t in (state if isinstance(state, list) else [state]):
                if not t.is_cuda:
                    raise AssertionError(f"text_eval: {loop}.{name}.{key} is not on the card")

    rows = TEXT_CPU_BATCHES * batch
    cpu_values, cpu_states, cpu_s, _ = run_loop(text_metrics(loop, "cpu"), preds[:rows], target[:rows], batch)
    gap = max(compare(prefix_states, cpu_states, "state", _text_tolerance),
              compare(prefix_values, cpu_values, "value", _text_tolerance))
    return {"batches": len(batches), "batch": batch, "items": len(preds), "wall_s": wall,
            "items_per_s": len(preds) / wall, "us_per_update": wall / len(batches) * 1e6,
            "values": text_values(values), "cpu_batches": TEXT_CPU_BATCHES, "cpu_s": cpu_s, "max_float_gap": gap}


def levenshtein_times(batches: list) -> dict:
    """The unit-cost edit distances of the ASR loop (each utterance by words and by
    characters) through ``helper``'s bit vectors and through the JAX package's numpy DP,
    in host seconds; fails unless the totals agree."""
    from torchmetrics_tpu_torch.functional.text import helper

    pairs = [(p.split(), t.split()) for ps, ts in batches for p, t in zip(ps, ts)]
    pairs += [(list(p), list(t)) for ps, ts in batches for p, t in zip(ps, ts)]
    pairs = [(p, t) for p, t in pairs if p and t]  # as ``_edit_distance_cost`` routes them
    seconds, totals = {}, {}
    for name, fn in (("bit_vector", helper._levenshtein_bit_vector),
                     ("numpy_dp", lambda p, t: helper._edit_distance_dp(p, t, 1))):
        t0 = time.perf_counter()
        totals[name] = sum(fn(p, t) for p, t in pairs)
        seconds[name] = time.perf_counter() - t0
    if totals["bit_vector"] != totals["numpy_dp"]:
        raise AssertionError(f"text_eval: the edit distances disagree: {totals}")
    return {"pairs": len(pairs), "total": totals["bit_vector"], "host_s": seconds}


def lm_window(g, index: int):
    """One window of float32 logits over Llama-2's vocabulary and its targets, on the
    card (a signal of +8 on the target logit); the last window ends in ignored tokens."""
    import torch

    target = torch.randint(0, LM_VOCAB, LM_WINDOW, generator=g, device="cuda")
    logits = torch.randn(*LM_WINDOW, LM_VOCAB, generator=g, device="cuda")
    logits.scatter_add_(-1, target[..., None], torch.full((*LM_WINDOW, 1), 8.0, device="cuda"))
    if index == LM_UPDATES - 1:
        target[-1, -LM_PADDED:] = LM_IGNORE
    return logits, target


def perplexity_loop() -> dict:
    """Perplexity eager and captured (``jit_update=True``) over the same windows, the
    captured states bitwise the eager ones; the CPU on the first window; a profile of
    eager updates for the device time and the logits' read rate."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from torchmetrics_tpu_torch.text import Perplexity

    eager = Perplexity(ignore_index=LM_IGNORE, device="cuda")
    captured = Perplexity(ignore_index=LM_IGNORE, device="cuda", jit_update=True)
    g = torch.Generator(device="cuda").manual_seed(75)
    eager_s, captured_s, first = [], [], None
    tokens = 0
    for index in range(LM_UPDATES):
        logits, target = lm_window(g, index)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager.update(logits, target)
        torch.cuda.synchronize()
        eager_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        captured.update(logits, target)
        torch.cuda.synchronize()
        captured_s.append(time.perf_counter() - t0)
        tokens += int((target != LM_IGNORE).sum())
        if index == 0:
            first = (logits.cpu(), target.cpu(), eager.state_dict(persistent_only=False), eager.compute())
        del logits, target
    value = eager.compute()
    states = eager.state_dict(persistent_only=False)
    captured_states = captured.state_dict(persistent_only=False)
    for key in states:
        if not bitwise_equal(states[key], captured_states[key]):
            raise AssertionError(f"text_eval: captured perplexity state {key} differs from eager")
    if not bitwise_equal(value, captured.compute()):
        raise AssertionError("text_eval: captured perplexity value differs from eager")
    if int(states["count"]) != tokens or not bool(torch.isfinite(value)):
        raise AssertionError(f"text_eval: perplexity counted {float(states['count'])} of {tokens} tokens: {value}")
    info = captured._jitted_update.cache_info() if captured._jitted_update is not None else None

    cpu = Perplexity(ignore_index=LM_IGNORE, device="cpu")
    t0 = time.perf_counter()
    cpu.update(first[0], first[1])
    cpu_value = cpu.compute()
    cpu_s = time.perf_counter() - t0
    cpu_states = cpu.state_dict(persistent_only=False)
    compare(first[2]["count"], cpu_states["count"], "perplexity.count", lambda _: (0.0, 0.0))
    gap = max(compare(first[2]["total_log_probs"], cpu_states["total_log_probs"], "perplexity.total_log_probs",
                      lambda _: (0.0, PERPLEXITY_RTOL)),
              compare(first[3], cpu_value, "perplexity.value", lambda _: (0.0, PERPLEXITY_RTOL)))
    del first

    # last, after every timing: the device time of eager updates from torch.profiler. A
    # trace in a long run can drop a whole update's kernels, the same in every identical
    # trace: it counts only when it holds one target gather an update, and is taken again
    # (up to three times) behind one more lead kernel each time
    logits, target = lm_window(torch.Generator(device="cuda").manual_seed(76), 0)
    probe = Perplexity(ignore_index=LM_IGNORE, device="cuda")
    probe.update(logits, target)
    torch.cuda.synchronize()
    for lead in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(lead):
                torch.cuda._sleep(1)  # a kernel of its own name, left out of the sums below
            for _ in range(LM_PROFILED):
                probe.update(logits, target)
            torch.cuda.synchronize()
        by_kernel, gathers = {}, 0
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0) or 0
            if us > 0 and "spin_kernel" not in e.key:
                by_kernel[e.key] = us
                gathers += e.count if "gather" in e.key else 0
        if gathers == LM_PROFILED:
            break
    complete = gathers == LM_PROFILED
    device_ms = sum(by_kernel.values()) / LM_PROFILED / 1e3 if complete else None
    logits_bytes = logits.numel() * logits.element_size()
    bound_ms = logits_bytes / HBM_BYTES_PER_S * 1e3
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]
    return {
        "windows": LM_UPDATES, "window": list(LM_WINDOW), "vocab": LM_VOCAB, "tokens_scored": tokens,
        "value": float(value), "eager_us_per_update": statistics.median(eager_s) * 1e6,
        "captured_us_per_update": statistics.median(captured_s) * 1e6, "captured_bitwise_equal": True,
        "captured_cache": None if info is None else {k: info[k] for k in ("hits", "misses", "replays",
                                                                          "capture_seconds")},
        "cpu_window_s": cpu_s, "cpu_rel_gap": gap,
        # null unless the trace held every profiled update
        "device_ms_per_update": device_ms, "updates_traced": gathers, "logits_bytes": logits_bytes,
        "bound_ms": bound_ms,
        "logits_read_tb_per_s": logits_bytes / (device_ms / 1e3) / 1e12 if device_ms else None,
        "bound_share": bound_ms / device_ms if device_ms else None,
        "top_kernels": [{"name": k[:90], "ms_per_update": us / LM_PROFILED / 1e3} for k, us in top],
    }


def text_eval_phase() -> dict:
    """The four string loops and perplexity on the card, each against its CPU twin."""
    from torchmetrics_tpu_torch.functional.text.rouge import _regex_split_sentence, set_rouge_sentence_splitter
    from torchmetrics_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    # rougeLsum splits sentences with the regex splitter: punkt is not installed and is
    # never downloaded here
    set_rouge_sentence_splitter(_regex_split_sentence)
    loops, data_s = {}, {}
    try:
        for loop, data_fn, source, size in TEXT_LOOPS:
            t0 = time.perf_counter()
            batches = data_fn()
            data_s[loop] = time.perf_counter() - t0
            if sum(len(p) for p, _ in batches) != size:
                raise AssertionError(f"text_eval: {loop} has {sum(len(p) for p, _ in batches)} items, not {size}")
            batches = batches[:TEXT_LOOP_BATCHES.get(loop, len(batches))]
            loops[loop] = {"source": source, "corpus_items": size, **text_string_loop(loop, batches)}
            if loop == "asr":
                loops[loop]["levenshtein"] = levenshtein_times(batches)
    finally:
        set_rouge_sentence_splitter(None)
    loops["lm"] = {"source": "Llama-2 vocabulary, WikiText-2 test length", **perplexity_loop()}
    launches = dict(kernels.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"text_eval: the text path launched a kernel: {launches}")
    return {"phase": "text_eval", "loops": loops, "data_s": data_s, "launches": launches,
            "cuts": {"corpora": "synthesized from seeds at the published counts and lengths (no dataset is in the repo)",
                     "loops": {loop: f"the first {n} batches" for loop, n in TEXT_LOOP_BATCHES.items()},
                     "cpu_twin": f"the first {TEXT_CPU_BATCHES} batches of each string loop, the first window of "
                                 "perplexity"}}


# ------------------------------------------------------------------------ audio

# Two published audio evaluations at their sizes, synthesized from seeds (no recording
# is in the repo or downloaded). Speech stands in as noise shaped to a 1/sqrt(f) spectrum
# between 100 Hz and 3.8 kHz, amplitude-modulated at a syllable rate of 3-6 Hz (silent
# half a cycle) and gated into phrases by a 0.2-0.5 Hz envelope that drops 20 dB.
# WSJ0-2mix, test set "tt", min mode, 8 kHz: 3,000 two-speaker mixtures, cropped to 4 s
# (32,000 samples; the set's mixtures average about 5 s), batches of 16. Each estimate
# is its source plus crosstalk of the other source and noise, about 10 dB below it, and
# half the rows come with the speakers swapped, for PIT to find.
WSJ0_MIXTURES = 3000
WSJ0_FS = 8000
WSJ0_SAMPLES = 32_000
WSJ0_BATCH = 16
# VoiceBank+DEMAND test set: 824 utterances at 16 kHz, lengths drawn between 1.5 and 6 s,
# batches of 8 cropped to the batch's shortest; each enhanced output is the clean
# utterance plus coloured noise at 5-20 dB SNR.
VOICEBANK_UTTERANCES = 824
VOICEBANK_FS = 16_000
VOICEBANK_SECONDS = (1.5, 6.0)
VOICEBANK_BATCH = 8
STFT_FFT = 512
STFT_HOP = 128
AUDIO_CPU_BATCHES = 2
AUDIO_DB_ATOL = 1e-4  # SNR, SI-SNR, SI-SDR, SA-SDR, C-SI-SNR, PIT on SI-SDR, per sample
AUDIO_SDR_ATOL = 1e-2  # float32 Toeplitz solves by cuSOLVER and LAPACK, per sample
AUDIO_STOI_ATOL = 1e-5
AUDIO_SRMR_RTOL = 1e-4
AUDIO_PROFILED = 3
# kernels of a batched dense LU solve (MAGMA's and cuBLAS's, as torch.linalg.solve runs
# it), by name; SDR's own steps are FFTs, gathers and elementwise, so every product
# kernel in its trace belongs to the solve
SOLVE_KERNELS = ("getrf", "getf2", "getrs", "trsm", "laswp", "pivinfo", "displace_pointers", "gemm", "ipiv",
                 "magma", "cusolver")
# The DNS Challenge (Interspeech 2020) synthetic no-reverb test set: 150 noisy clips of
# 10 s at 16 kHz (clean speech plus noise at 0-25 dB SNR), batches of 8, scored by DNSMOS
# with ``personalized`` False and True. The repo carries no DNS Challenge checkpoint, so
# the graphs are fabricated in the ONNX wire format with seeded weights
# (``dnsmos_graphs``): a P.808-shaped CNN (3 x 3 convolutions of 16 to 128 channels over
# the 900 x 120 log-mel input, max pooling, a dense head) and P.835 sig_bak_ovr-shaped
# graphs over the raw 144,160-sample segment (a strided 400-tap filterbank convolution,
# batch norm, pooling, a dense head of three outputs in [1, 5]).
DNS_CLIPS = 150
DNS_FS = 16_000
DNS_SECONDS = 10
DNS_BATCH = 8
DNS_CPU_BATCHES = 2
DNSMOS_ATOL = 1e-4  # per clip, each of the four scores
DNSMOS_P808_WIDTHS = (16, 32, 64, 128)
DNSMOS_SBO_WIDTHS = (32, 64, 64)


def speech_like(g, rows: int, samples: int, fs: int, device: str = "cuda"):
    """``rows`` seeded stand-ins for speech of ``samples`` samples at ``fs``, unit power."""
    import math

    import torch

    spec = torch.fft.rfft(torch.randn(rows, samples, generator=g, device=device))
    f = torch.fft.rfftfreq(samples, 1.0 / fs, device=device)
    band = ((f >= 100) & (f <= min(3800.0, fs / 2 - 100))).float() / torch.sqrt(f.clamp(min=100.0) / 100.0)
    x = torch.fft.irfft(spec * band, n=samples)
    t = torch.arange(samples, device=device) / fs
    syllables = 3 + 3 * torch.rand(rows, 1, generator=g, device=device)
    phrases = 0.2 + 0.3 * torch.rand(rows, 1, generator=g, device=device)
    phase = 2 * math.pi * torch.rand(rows, 2, generator=g, device=device)
    envelope = torch.sin(2 * math.pi * syllables * t + phase[:, :1]).clamp(min=0).sqrt()
    envelope = envelope * (0.1 + 0.9 * (torch.sin(2 * math.pi * phrases * t + phase[:, 1:]) > -0.5))
    x = x * envelope
    return x / x.pow(2).mean(dim=-1, keepdim=True).sqrt().clamp(min=1e-8)


def wsj0_2mix_batches(seed: int = 80) -> list:
    """(the estimates with half the rows' speakers swapped, the estimates in source order,
    the sources, the swapped rows) for each batch of the WSJ0-2mix test set, made on the
    card."""
    import torch

    batches = []
    for index, start in enumerate(range(0, WSJ0_MIXTURES, WSJ0_BATCH)):
        rows = min(WSJ0_BATCH, WSJ0_MIXTURES - start)
        g = torch.Generator(device="cuda").manual_seed(seed * 100_000 + index)
        sources = speech_like(g, 2 * rows, WSJ0_SAMPLES, WSJ0_FS).reshape(rows, 2, WSJ0_SAMPLES)
        noise = speech_like(g, 2 * rows, WSJ0_SAMPLES, WSJ0_FS).reshape(rows, 2, WSJ0_SAMPLES)
        # crosstalk at -14 dB and noise at -12 dB: about 10 dB below the source
        estimates = sources + 0.2 * sources.flip(1) + 0.25 * noise
        swapped = torch.rand(rows, generator=g, device="cuda") < 0.5
        shuffled = torch.where(swapped[:, None, None], estimates.flip(1), estimates)
        batches.append((shuffled, estimates, sources, swapped))
    return batches


def voicebank_batches(seed: int = 81) -> list:
    """(enhanced, clean) for each batch of the VoiceBank+DEMAND test set, made on the card,
    each batch cropped to its shortest utterance."""
    import numpy as np
    import torch

    lengths = np.random.RandomState(seed).uniform(*VOICEBANK_SECONDS, VOICEBANK_UTTERANCES)
    batches = []
    for index, start in enumerate(range(0, VOICEBANK_UTTERANCES, VOICEBANK_BATCH)):
        rows = min(VOICEBANK_BATCH, VOICEBANK_UTTERANCES - start)
        samples = int(lengths[start:start + rows].min() * VOICEBANK_FS)
        g = torch.Generator(device="cuda").manual_seed(seed * 100_000 + index)
        clean = speech_like(g, rows, samples, VOICEBANK_FS)
        # DEMAND's noises are coloured: low-passed white noise at 5-20 dB SNR
        noise = torch.randn(rows, samples, generator=g, device="cuda").cumsum(-1)
        noise = noise - noise.mean(dim=-1, keepdim=True)
        noise = noise / noise.pow(2).mean(dim=-1, keepdim=True).sqrt()
        snr_db = 5 + 15 * torch.rand(rows, 1, generator=g, device="cuda")
        batches.append((clean + noise * 10 ** (-snr_db / 20), clean))
    return batches


class Spectrogram:
    """Feeds a C-SI-SNR metric the 512-point STFT (hop 128, Hann window) of each pair."""

    def __init__(self, metric):
        self.metric = metric

    def update(self, preds, target) -> None:
        import torch

        window = torch.hann_window(STFT_FFT, device=preds.device)
        spec = [torch.stft(x, STFT_FFT, STFT_HOP, window=window, return_complex=True) for x in (preds, target)]
        self.metric.update(*spec)

    def compute(self):
        return self.metric.compute()

    def state_dict(self, persistent_only: bool = True) -> dict:
        return self.metric.state_dict(persistent_only=persistent_only)


def separation_metrics(device: str) -> dict:
    from torchmetrics_tpu_torch import audio as ta
    from torchmetrics_tpu_torch.functional.audio import scale_invariant_signal_distortion_ratio

    kw = {"device": device}
    return {
        "pit_si_sdr": ta.PermutationInvariantTraining(scale_invariant_signal_distortion_ratio, eval_func="max", **kw),
        "si_sdr": ta.ScaleInvariantSignalDistortionRatio(**kw),
        "sdr": ta.SignalDistortionRatio(filter_length=512, **kw),
        "sa_sdr": ta.SourceAggregatedSignalDistortionRatio(**kw),
        "snr": ta.SignalNoiseRatio(**kw),
        "si_snr": ta.ScaleInvariantSignalNoiseRatio(**kw),
    }


def enhancement_metrics(device: str) -> dict:
    from torchmetrics_tpu_torch import audio as ta

    kw = {"device": device}
    return {
        "stoi": ta.ShortTimeObjectiveIntelligibility(VOICEBANK_FS, **kw),
        "estoi": ta.ShortTimeObjectiveIntelligibility(VOICEBANK_FS, extended=True, **kw),
        "srmr": PredsOnly(ta.SpeechReverberationModulationEnergyRatio(VOICEBANK_FS, **kw)),
        "srmr_fast": PredsOnly(ta.SpeechReverberationModulationEnergyRatio(VOICEBANK_FS, fast=True, **kw)),
        "snr": ta.SignalNoiseRatio(**kw),
        "si_snr": ta.ScaleInvariantSignalNoiseRatio(**kw),
        "c_si_snr": Spectrogram(ta.ComplexScaleInvariantSignalNoiseRatio(**kw)),
    }


def _audio_tolerance(where: str):
    """(atol, rtol) of a mean score's ``value`` and of its ``sum_score`` state (a sum of
    ``total`` per-sample scores: the per-sample bound times the count, ``total`` equal)."""
    metric = where.split(".")[1]
    if metric.startswith("srmr"):
        return 0.0, AUDIO_SRMR_RTOL
    atol = AUDIO_SDR_ATOL if metric == "sdr" else AUDIO_STOI_ATOL if "stoi" in metric else AUDIO_DB_ATOL
    if ".sum_score#" in where:
        atol *= int(where.split("#")[1])
    return atol, 0.0


def timed_loop(metrics: dict, batches: list, snapshot_after: int | None = None) -> tuple:
    """Every metric updated batch by batch, each update and the final computes timed alone
    (host clock around the call and a synchronise); returns (values, states, update
    seconds per metric, loop seconds, the (values, states) after ``snapshot_after``
    batches), and the compute seconds per metric as ``seconds["compute"]``."""
    import torch

    seconds = dict.fromkeys(metrics, 0.0)
    compute_s = {}
    snapshot = None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step, (preds, target) in enumerate(batches, 1):
        for name, m in metrics.items():
            t1 = time.perf_counter()
            m.update(preds, target)
            torch.cuda.synchronize()
            seconds[name] += time.perf_counter() - t1
        if step == snapshot_after:
            paused = time.perf_counter()
            snapshot = ({name: m.compute() for name, m in metrics.items()},
                        {name: m.state_dict(persistent_only=False) for name, m in metrics.items()})
            torch.cuda.synchronize()
            t0 += time.perf_counter() - paused
    values = {}
    for name, m in metrics.items():
        t1 = time.perf_counter()
        values[name] = m.compute()
        torch.cuda.synchronize()
        compute_s[name] = time.perf_counter() - t1
    loop_s = time.perf_counter() - t0
    states = {name: m.state_dict(persistent_only=False) for name, m in metrics.items()}
    return values, states, {**seconds, "compute": compute_s}, loop_s, snapshot or (values, states)


def audio_twin(metrics_fn, batches: list, snapshot) -> dict:
    """The first AUDIO_CPU_BATCHES batches with ``device="cpu"`` against the card's states
    and values after the same batches: ``total`` exactly, the mean within its tolerance
    and ``sum_score`` within that times ``total``."""
    card_values, card_states = snapshot
    cpu_values, cpu_states, _, cpu_s, _ = timed_loop(metrics_fn("cpu"), to_cpu(batches[:AUDIO_CPU_BATCHES]))
    gaps = {}
    for name, state in card_states.items():
        total = int(cpu_states[name]["total"])
        compare(state["total"], cpu_states[name]["total"], f"state.{name}.total", lambda _: (0.0, 0.0))
        gaps[name] = max(compare(state["sum_score"], cpu_states[name]["sum_score"],
                                 f"state.{name}.sum_score#{total}", _audio_tolerance),
                         compare(card_values[name], cpu_values[name], f"value.{name}", _audio_tolerance))
    return {"batches": AUDIO_CPU_BATCHES, "seconds": cpu_s, "max_gaps": gaps}


def audio_values(values: dict) -> dict:
    import torch

    for name, value in values.items():
        if not bool(torch.isfinite(value).all()):
            raise AssertionError(f"audio_eval: {name} is not finite: {value}")
    return {name: float(value) for name, value in values.items()}


def profile_updates(metrics: dict, batches: list, compute: bool = False, tracked: tuple = ()) -> dict:
    """torch.profiler over one update of every metric per batch (then one ``compute`` of
    each with ``compute``), after a warm pass: device ms per batch, the busy share of
    the wall clock, the kernels that take most of the device time and the share of it
    in kernels whose names hold one of ``tracked``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for preds, target in batches:
        for m in metrics.values():
            m.update(preds, target)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for preds, target in batches:
            for m in metrics.values():
                m.update(preds, target)
        if compute:
            for m in metrics.values():
                m.compute()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.key] = us
    total = sum(by_kernel.values())
    share = sum(us for k, us in by_kernel.items() if any(t in k.lower() for t in tracked))
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"batches": len(batches), "compute": compute, "wall_ms": wall * 1e3, "device_ms": total / 1e3,
            "device_ms_per_batch": total / 1e3 / len(batches),
            "device_busy_share": total / 1e6 / wall if wall else None,
            "tracked_share": share / total if tracked and total else None,
            "top_kernels": [{"name": k[:90], "ms": us / 1e3} for k, us in top]}


def sdr_profile(preds, target) -> dict:
    """Device ms per ``SignalDistortionRatio`` update over AUDIO_PROFILED updates, and the
    share of it in the dense solve's kernels."""
    from torchmetrics_tpu_torch.audio import SignalDistortionRatio

    metric = SignalDistortionRatio(filter_length=512, device="cuda")
    return profile_updates({"sdr": metric}, [(preds, target)] * AUDIO_PROFILED, tracked=SOLVE_KERNELS)


def srmr_peak_memory(preds) -> dict:
    """Peak device bytes of one SRMR update (both modes) over what was allocated before it."""
    import torch

    from torchmetrics_tpu_torch.audio import SpeechReverberationModulationEnergyRatio

    peaks = {}
    for fast in (False, True):
        metric = SpeechReverberationModulationEnergyRatio(VOICEBANK_FS, fast=fast, device="cuda")
        metric.update(preds)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        metric.update(preds)
        torch.cuda.synchronize()
        peaks["fast" if fast else "full"] = torch.cuda.max_memory_allocated() - base
    return {"rows": int(preds.shape[0]), "samples": int(preds.shape[-1]), "peak_bytes": peaks}


class Separated:
    """Feeds a separation metric one WSJ0-2mix batch: PIT the estimates with half the rows'
    speakers swapped, every other metric the estimates in source order."""

    def __init__(self, metric, shuffled: bool):
        self.metric, self.shuffled = metric, shuffled

    def update(self, batch, sources) -> None:
        self.metric.update(batch[0] if self.shuffled else batch[1], sources)

    def compute(self):
        return self.metric.compute()

    def state_dict(self, persistent_only: bool = True) -> dict:
        return self.metric.state_dict(persistent_only=persistent_only)


def separated_metrics(device: str) -> dict:
    return {name: Separated(m, name == "pit_si_sdr") for name, m in separation_metrics(device).items()}


def audio_loop(metrics_fn, batches: list) -> dict:
    """One loop on the card, each metric's updates timed alone, then its CPU twin."""
    values, _, seconds, loop_s, snapshot = timed_loop(metrics_fn("cuda"), batches, snapshot_after=AUDIO_CPU_BATCHES)
    steps = len(batches)
    compute_s = seconds.pop("compute")
    return {"updates": steps, "wall_s": loop_s, "update_s": seconds, "compute_s": compute_s,
            "us_per_update": {k: v / steps * 1e6 for k, v in seconds.items()}, "values": audio_values(values),
            "cpu_twin": audio_twin(metrics_fn, batches, snapshot)}


def _varint(v: int) -> bytes:
    out = bytearray()
    v = v if v >= 0 else v + (1 << 64)
    while True:
        byte, v = v & 0x7F, v >> 7
        out.append(byte | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _field(number: int, payload) -> bytes:
    """A protobuf field: a varint (int) or a length-delimited payload (bytes)."""
    if isinstance(payload, int):
        return _varint(number << 3) + _varint(payload)
    return _varint(number << 3 | 2) + _varint(len(payload)) + payload


def onnx_tensor(name: str, arr) -> bytes:
    """TensorProto of a float32, int32 or int64 array (dims, data type, name, raw data)."""
    import numpy as np

    arr = np.asarray(arr)
    code = {np.dtype(np.float32): 1, np.dtype(np.int32): 6, np.dtype(np.int64): 7}[arr.dtype]
    return b"".join(_field(1, int(d)) for d in arr.shape) + _field(2, code) + _field(8, name.encode()) + \
        _field(9, arr.astype(arr.dtype.newbyteorder("<")).tobytes())


def onnx_node(op: str, inputs: list, outputs: list, **attrs) -> bytes:
    """NodeProto with int, float, string, int-list and tensor attributes."""
    import struct

    import numpy as np

    msg = b"".join(_field(1, i.encode()) for i in inputs) + b"".join(_field(2, o.encode()) for o in outputs)
    msg += _field(3, f"{op}_{outputs[0]}".encode()) + _field(4, op.encode())
    for key, value in attrs.items():
        attr = _field(1, key.encode())
        if isinstance(value, float):
            attr += _varint(2 << 3 | 5) + struct.pack("<f", value) + _field(20, 1)
        elif isinstance(value, int):
            attr += _field(3, value) + _field(20, 2)
        elif isinstance(value, str):
            attr += _field(4, value.encode()) + _field(20, 3)
        elif isinstance(value, np.ndarray):
            attr += _field(5, onnx_tensor("", value)) + _field(20, 4)
        else:
            attr += b"".join(_field(8, int(v)) for v in value) + _field(20, 7)
        msg += _field(5, attr)
    return msg


def onnx_model(nodes: list, initializers: dict, inputs: list, outputs: list) -> bytes:
    """ModelProto bytes (ONNX's wire format) of a graph: nodes, initializers, the graph's
    input and output names."""
    graph = b"".join(_field(1, n) for n in nodes) + _field(2, b"g")
    graph += b"".join(_field(5, onnx_tensor(name, arr)) for name, arr in initializers.items())
    graph += b"".join(_field(11, _field(1, i.encode())) for i in inputs)
    graph += b"".join(_field(12, _field(1, o.encode())) for o in outputs)
    return _field(1, 8) + _field(7, graph)


def dnsmos_graphs(seed: int = 91, p808_widths: tuple = DNSMOS_P808_WIDTHS,
                  sbo_widths: tuple = DNSMOS_SBO_WIDTHS) -> dict:
    """ONNX ModelProto bytes with seeded weights (``onnx_model`` writes the wire format):
    ``model_v8``, a P.808-shaped CNN over the ``[B, 900, 120]`` log-mel input
    (a keras-style Shape/Gather/Concat/Reshape to NCHW, 3 x 3 convolutions with max
    pooling, a global max pool and two dense layers, one MOS out), and ``sig_bak_ovr`` and
    ``p_sig_bak_ovr``, P.835-shaped graphs over the raw 144,160-sample segment (three
    raw (sig, bak, ovr) scores in [1, 5])."""
    import numpy as np

    _model, _node = onnx_model, onnx_node
    r = np.random.RandomState(seed)

    def he(*shape):
        fan_in = int(np.prod(shape[1:]))
        return (r.randn(*shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)

    init = {"idx0": np.asarray(0, np.int64), "tail": np.asarray([1, 900, 120], np.int64)}
    nodes = [
        _node("Shape", ["input_1"], ["sh"]),
        _node("Gather", ["sh", "idx0"], ["n"], axis=0),
        _node("Unsqueeze", ["n"], ["n1"], axes=[0]),
        _node("Concat", ["n1", "tail"], ["target"], axis=0),
        _node("Reshape", ["input_1", "target"], ["x0"]),
    ]
    x, cin = "x0", 1
    for i, cout in enumerate(p808_widths):
        init[f"w{i}"], init[f"b{i}"] = he(cout, cin, 3, 3), np.full(cout, 0.01, np.float32)
        nodes += [_node("Conv", [x, f"w{i}", f"b{i}"], [f"c{i}"], pads=[1, 1, 1, 1]),
                  _node("Relu", [f"c{i}"], [f"r{i}"])]
        x, cin = f"r{i}", cout
        if i + 1 < len(p808_widths):
            nodes.append(_node("MaxPool", [x], [f"p{i}"], kernel_shape=[2, 2], strides=[2, 2]))
            x = f"p{i}"
    init["wd1"], init["bd1"] = he(64, cin).T.copy() * 0.5, np.zeros(64, np.float32)
    init["wd2"], init["bd2"] = he(64, 1) * 0.1, np.asarray([3.0], np.float32)
    nodes += [_node("GlobalMaxPool", [x], ["gmp"]), _node("Flatten", ["gmp"], ["fl"], axis=1),
              _node("Gemm", ["fl", "wd1", "bd1"], ["d1"]), _node("Relu", ["d1"], ["rd1"]),
              _node("Dropout", ["rd1"], ["dr"]), _node("Gemm", ["dr", "wd2", "bd2"], ["mos"])]
    graphs = {"model_v8": _model(nodes, init, ["input_1"], ["mos"])}

    for key in ("sig_bak_ovr", "p_sig_bak_ovr"):
        c0, c1, c2 = sbo_widths
        init = {
            "shape": np.asarray([0, 1, -1], np.int64),
            "w0": he(c0, 1, 400) * 0.2, "b0": np.zeros(c0, np.float32),
            "w1": he(c1, c0, 3), "b1": np.zeros(c1, np.float32),
            "s": (1.0 + 0.1 * r.randn(c1)).astype(np.float32), "bb": (0.1 * r.randn(c1)).astype(np.float32),
            "m": (0.1 * r.randn(c1)).astype(np.float32), "v": (1.0 + r.rand(c1)).astype(np.float32),
            "w2": he(c2, c1, 3), "b2": np.zeros(c2, np.float32),
            "wd": he(c2, 3) * 0.5, "bd": np.asarray([0.3, 0.5, 0.1], np.float32),
            "four": np.asarray(4.0, np.float32), "one": np.asarray(1.0, np.float32),
        }
        nodes = [
            _node("Reshape", ["input_1", "shape"], ["x"]),
            _node("Conv", ["x", "w0", "b0"], ["c0"], strides=[160]),
            _node("Relu", ["c0"], ["r0"]),
            _node("Conv", ["r0", "w1", "b1"], ["c1"], pads=[1, 1]),
            _node("BatchNormalization", ["c1", "s", "bb", "m", "v"], ["bn"], epsilon=1e-3),
            _node("Relu", ["bn"], ["r1"]),
            _node("MaxPool", ["r1"], ["p1"], kernel_shape=[2], strides=[2]),
            _node("Conv", ["p1", "w2", "b2"], ["c2"], pads=[1, 1]),
            _node("Tanh", ["c2"], ["t2"]),
            _node("GlobalAveragePool", ["t2"], ["gap"]),
            _node("Flatten", ["gap"], ["fl"], axis=1),
            _node("Gemm", ["fl", "wd", "bd"], ["d"]),
            _node("Sigmoid", ["d"], ["sg"]),
            _node("Mul", ["sg", "four"], ["sc"]),
            _node("Add", ["sc", "one"], ["out"]),
        ]
        graphs[key] = _model(nodes, init, ["input_1"], ["out"])
    return graphs


def dnsmos_dir(root: str, graphs: dict) -> str:
    """A DNSMOS model directory: ``model_v8`` and the personalized head as raw ``.onnx``
    drops in the reference's layout (converted on first use), ``sig_bak_ovr`` already
    converted (by the port's converter, from a drop outside the directory)."""
    from torchmetrics_tpu_torch.convert.onnx_torch import convert_onnx_flax

    os.makedirs(os.path.join(root, "DNSMOS"), exist_ok=True)
    os.makedirs(os.path.join(root, "pDNSMOS"), exist_ok=True)
    with open(os.path.join(root, "DNSMOS", "model_v8.onnx"), "wb") as fh:
        fh.write(graphs["model_v8"])
    with open(os.path.join(root, "pDNSMOS", "sig_bak_ovr.onnx"), "wb") as fh:
        fh.write(graphs["p_sig_bak_ovr"])
    staged = os.path.join(os.path.dirname(root), "sig_bak_ovr.onnx")
    with open(staged, "wb") as fh:
        fh.write(graphs["sig_bak_ovr"])
    convert_onnx_flax(staged, os.path.join(root, "sig_bak_ovr"))
    os.remove(staged)
    return root


def dns_challenge_batches(seed: int = 92, device: str = "cuda") -> list:
    """The noisy clips of each batch of the DNS Challenge test set, made on the card."""
    import torch

    samples = DNS_SECONDS * DNS_FS
    batches = []
    for index, start in enumerate(range(0, DNS_CLIPS, DNS_BATCH)):
        rows = min(DNS_BATCH, DNS_CLIPS - start)
        g = torch.Generator(device=device).manual_seed(seed * 100_000 + index)
        clean = speech_like(g, rows, samples, DNS_FS, device=device)
        noise = torch.randn(rows, samples, generator=g, device=device).cumsum(-1)
        noise = noise - noise.mean(dim=-1, keepdim=True)
        noise = noise / noise.pow(2).mean(dim=-1, keepdim=True).sqrt()
        snr_db = 25 * torch.rand(rows, 1, generator=g, device=device)
        batches.append(0.05 * (clean + noise * 10 ** (-snr_db / 20)))
    return batches


def dnsmos_loop(root: str) -> dict:
    """DNSMOS over the DNS Challenge clips on the card, ``personalized`` False and True:
    µs per update (the first, which converts and loads the graphs, apart), the executor's
    device ms by op over one batch, and the CPU twin on the first batches: per-clip scores
    within DNSMOS_ATOL and the class's states."""
    import torch

    from torchmetrics_tpu_torch.audio import DeepNoiseSuppressionMeanOpinionScore
    from torchmetrics_tpu_torch.functional.audio import dnsmos as fdnsmos

    graphs = dnsmos_graphs()
    model_dir = dnsmos_dir(os.path.join(root, "dnsmos"), graphs)
    previous = os.environ.get("TORCHMETRICS_TPU_DNSMOS_DIR")
    os.environ["TORCHMETRICS_TPU_DNSMOS_DIR"] = model_dir
    fdnsmos._load_model.cache_clear()
    try:
        batches = dns_challenge_batches()
        result = {"source": "DNS Challenge (Interspeech 2020) synthetic no-reverb test set, 16 kHz",
                  "clips": DNS_CLIPS, "seconds": DNS_SECONDS, "batch": DNS_BATCH,
                  "graphs": "fabricated: seeded weights in P.808 and P.835 shapes (no DNS checkpoint is in the repo)",
                  "graph_bytes": {k: len(v) for k, v in graphs.items()}}
        cpu_batches = [b.cpu() for b in batches[:DNS_CPU_BATCHES]]
        for personalized in (False, True):
            metric = DeepNoiseSuppressionMeanOpinionScore(DNS_FS, personalized, device="cuda")
            times = []
            for preds in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                metric.update(preds)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            value = metric.compute()
            if not bool(torch.isfinite(value)) or not 1.0 <= float(value) <= 5.0:
                raise AssertionError(f"audio_eval: DNSMOS mean {float(value)} is not a MOS")
            scores = [fdnsmos.deep_noise_suppression_mean_opinion_score(b, DNS_FS, personalized)
                      for b in batches[:DNS_CPU_BATCHES]]
            cpu_scores = [fdnsmos.deep_noise_suppression_mean_opinion_score(b, DNS_FS, personalized)
                          for b in cpu_batches]
            gap = compare(scores, cpu_scores, "dnsmos.scores", lambda _: (DNSMOS_ATOL, 0.0))
            card_prefix = DeepNoiseSuppressionMeanOpinionScore(DNS_FS, personalized, device="cuda")
            cpu_prefix = DeepNoiseSuppressionMeanOpinionScore(DNS_FS, personalized, device="cpu")
            for card_b, cpu_b in zip(batches, cpu_batches):
                card_prefix.update(card_b)
                cpu_prefix.update(cpu_b)
            total = int(cpu_prefix.total)
            compare(card_prefix.total, cpu_prefix.total, "dnsmos.total", lambda _: (0.0, 0.0))
            gap = max(gap, compare(card_prefix.sum_score, cpu_prefix.sum_score, "dnsmos.sum_score",
                                   lambda _: (DNSMOS_ATOL * total, 0.0)))
            op_ms: dict = {}
            fdnsmos.deep_noise_suppression_mean_opinion_score(batches[0], DNS_FS, personalized, op_times=op_ms)
            per_clip = torch.cat(scores).mean(dim=0).tolist()
            result["personalized" if personalized else "plain"] = {
                "updates": len(batches), "first_update_s": times[0],
                "us_per_update": sum(times[1:]) / (len(times) - 1) * 1e6, "value": float(value),
                "first_batches_mean_scores": dict(zip(("p808", "sig", "bak", "ovr"), per_clip)),
                "cpu_twin": {"batches": DNS_CPU_BATCHES, "max_gap": gap},
                "executor_device_ms_by_op": dict(sorted(op_ms.items(), key=lambda kv: -kv[1])),
            }
        if not os.path.isfile(os.path.join(model_dir, "model_v8", "graph.json")):
            raise AssertionError("audio_eval: the raw model_v8.onnx drop was not converted")
        return result
    finally:
        fdnsmos._load_model.cache_clear()
        if previous is None:
            os.environ.pop("TORCHMETRICS_TPU_DNSMOS_DIR", None)
        else:
            os.environ["TORCHMETRICS_TPU_DNSMOS_DIR"] = previous


def audio_eval_phase() -> dict:
    """WSJ0-2mix separation and VoiceBank+DEMAND enhancement on the card, each loop held
    against its CPU twin on its first batches; no K1-K5 launch."""
    import torch

    from torchmetrics_tpu_torch.functional.audio import (
        permutation_invariant_training,
        pit_permutate,
        scale_invariant_signal_distortion_ratio,
    )
    from torchmetrics_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    separation = wsj0_2mix_batches()
    torch.cuda.synchronize()
    data_s = {"separation": time.perf_counter() - t0}
    shuffled, ordered, sources, swapped = separation[0]
    best, perm = permutation_invariant_training(shuffled, sources, scale_invariant_signal_distortion_ratio)
    want = torch.where(swapped[:, None], torch.tensor([[1, 0]], device="cuda"), torch.tensor([[0, 1]], device="cuda"))
    if not torch.equal(perm.long(), want) or not torch.equal(pit_permutate(shuffled, perm), ordered):
        raise AssertionError("audio_eval: PIT did not find the swapped speakers of the first batch")
    loops = {"separation": {
        "source": "WSJ0-2mix tt (min), 8 kHz", "mixtures": WSJ0_MIXTURES, "samples": WSJ0_SAMPLES, "batch": WSJ0_BATCH,
        **audio_loop(separated_metrics, [((s, o), t) for s, o, t, _ in separation]),
        "pit_first_batch": {"swapped_rows": int(swapped.sum()), "mean_best": float(best.mean())},
    }}
    del separation, shuffled

    t0 = time.perf_counter()
    enhancement = voicebank_batches()
    torch.cuda.synchronize()
    data_s["enhancement"] = time.perf_counter() - t0
    loops["enhancement"] = {
        "source": "VoiceBank+DEMAND test, 16 kHz", "utterances": VOICEBANK_UTTERANCES, "batch": VOICEBANK_BATCH,
        "samples": sum(int(b[0].numel()) for b in enhancement), **audio_loop(enhancement_metrics, enhancement),
        "srmr_memory": srmr_peak_memory(max(enhancement, key=lambda b: b[0].shape[-1])[0]),
    }
    # last, after every timing: a process that has run the profiler is slower afterwards
    loops["separation"]["sdr_profile"] = sdr_profile(ordered, sources)
    loops["enhancement"]["profile"] = profile_updates(enhancement_metrics("cuda"), enhancement[:2])
    values = loops["enhancement"]["values"]
    if not (0.0 < values["stoi"] < 1.0 and 0.0 < values["estoi"] < 1.0 and values["srmr"] > 0):
        raise AssertionError(f"audio_eval: enhancement scores out of range: {values}")
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "audio")
    t0 = time.perf_counter()
    try:
        loops["dnsmos"] = {**dnsmos_loop(root), "wall_s": time.perf_counter() - t0}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = dict(kernels.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"audio_eval: the audio path launched a kernel: {launches}")
    return {"phase": "audio_eval", "loops": loops, "data_s": data_s, "launches": launches,
            "cuts": {"separation": f"mixtures cropped to {WSJ0_SAMPLES // WSJ0_FS} s",
                     "cpu_twin": f"the first {AUDIO_CPU_BATCHES} batches of each loop",
                     "audio": "synthesized from seeds at the published counts and rates (no recording is in the repo)"}}


# -------------------------------------------------------------- image quality

# The WorldView-3 test sets of PanCollection (Deng et al., "Machine learning in
# pansharpening: a benchmark", IEEE GRSM 2022), synthesized from seeds at their sizes:
# 20 reduced-resolution images (an 8-band 256 x 256 ground truth beside the fused
# output) and 20 full-resolution ones (fused output and panchromatic image 512 x 512,
# the 8-band multispectral image 128 x 128, resolution ratio 4), reflectances in [0, 1].
WV3_IMAGES = 20
WV3_BANDS = 8
WV3_RR_SIZE = 256
WV3_FR_SIZE = 512
WV3_RATIO = 4
WV3_BATCH = 4
WV3_CPU_IMAGES = 4
WV3_PIXEL_SUMS = ("sum_sam",)  # states summed over every pixel: within PIXEL_SUM_RTOL
WV3_DARKEST = 1e-3  # no pixel is black in every band, where the spectral angle is 0 / 0


def smooth_bands(g, n: int, bands: int, size: int, device: str = "cuda"):
    """Seeded multispectral scenes: a shared smooth field scaled per band, a smooth
    band-specific part and fine texture (mostly shared by the bands), in [WV3_DARKEST, 1]."""
    import torch
    import torch.nn.functional as F

    def field(channels: int, cells: int):
        coarse = torch.rand(n, channels, cells, cells, generator=g, device=device)
        return F.interpolate(coarse, size=(size, size), mode="bicubic", align_corners=False)

    gains = 0.6 + 0.6 * torch.rand(1, bands, 1, 1, generator=g, device=device)
    texture = torch.randn(n, 1, size, size, generator=g, device=device) * gains
    texture = texture + 0.3 * torch.randn(n, bands, size, size, generator=g, device=device)
    scene = 0.05 + 0.6 * field(1, size // 16) * gains + 0.2 * field(bands, size // 32) + 0.03 * texture
    return scene.clamp_(WV3_DARKEST, 1)


def worldview3_data(seed: int = 90) -> dict:
    """The reduced-resolution pairs and the full-resolution quadruples, made on the card."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device="cuda").manual_seed(seed)
    gt = smooth_bands(g, WV3_IMAGES, WV3_BANDS, WV3_RR_SIZE)
    fused = (gt + 0.01 * torch.randn(gt.shape, generator=g, device="cuda")).clamp_(WV3_DARKEST, 1)
    hr = smooth_bands(g, WV3_IMAGES, WV3_BANDS, WV3_FR_SIZE)
    preds = (hr + 0.01 * torch.randn(hr.shape, generator=g, device="cuda")).clamp_(WV3_DARKEST, 1)
    pan = (hr.mean(dim=1, keepdim=True) + 0.01 * torch.randn(hr.shape[0], 1, *hr.shape[2:], generator=g,
                                                              device="cuda")).clamp_(0, 1)
    pan = pan.expand(-1, WV3_BANDS, -1, -1).contiguous()  # the panchromatic band, one copy a band
    ms = F.avg_pool2d(hr, WV3_RATIO)
    pan_lr = F.avg_pool2d(pan, WV3_RATIO)
    return {"rr": (fused, gt), "fr": (preds, ms, pan, pan_lr)}


class FullResolution:
    """Feeds a no-reference metric one full-resolution quadruple: D-lambda the fused image
    and the multispectral one, D-s and QNR the fused image and its target dict."""

    def __init__(self, metric, target: str):
        self.metric, self.target = metric, target

    def update(self, batch, _) -> None:
        preds, ms, pan, pan_lr = batch
        if self.target == "ms":
            self.metric.update(preds, ms)
        else:
            self.metric.update(preds, {"ms": ms, "pan": pan, **({"pan_lr": pan_lr} if self.target == "pan_lr" else {})})

    def compute(self):
        return self.metric.compute()

    def state_dict(self, persistent_only: bool = True) -> dict:
        return self.metric.state_dict(persistent_only=persistent_only)


def reduced_resolution_metrics(device: str) -> dict:
    from torchmetrics_tpu_torch import image as ti

    kw = {"device": device}
    return {
        "sam": ti.SpectralAngleMapper(**kw),
        "ergas": ti.ErrorRelativeGlobalDimensionlessSynthesis(ratio=WV3_RATIO, **kw),
        "scc": ti.SpatialCorrelationCoefficient(**kw),
        "vif": ti.VisualInformationFidelity(**kw),
        "rase": ti.RelativeAverageSpectralError(**kw),
    }


def full_resolution_metrics(device: str) -> dict:
    from torchmetrics_tpu_torch import image as ti

    kw = {"device": device}
    return {
        "d_lambda": FullResolution(ti.SpectralDistortionIndex(**kw), "ms"),
        "d_s": FullResolution(ti.SpatialDistortionIndex(**kw), "pan"),
        "d_s_pan_lr": FullResolution(ti.SpatialDistortionIndex(**kw), "pan_lr"),
        "qnr": FullResolution(ti.QualityWithNoReference(**kw), "pan"),
    }


def _image_quality_tolerance(where: str):
    if where.rsplit(".", 1)[-1] in WV3_PIXEL_SUMS:
        return FLOAT_ATOL, PIXEL_SUM_RTOL
    return FLOAT_ATOL, IMAGE_RTOL


def image_quality_loop(metrics_fn, batches: list) -> dict:
    """One resolution's loop on the card (each update and each compute timed alone), then
    its CPU twin on the first WV3_CPU_IMAGES images against the card's same prefix."""
    import torch

    values, _, seconds, loop_s, _ = timed_loop(metrics_fn("cuda"), batches)
    compute_s = seconds.pop("compute")
    for name, value in values.items():
        if not bool(torch.isfinite(value).all()):
            raise AssertionError(f"image_quality_eval: {name} is not finite: {value}")
    prefix = batches[:WV3_CPU_IMAGES // WV3_BATCH]
    card_values, card_states, _, _, _ = timed_loop(metrics_fn("cuda"), prefix)
    cpu_values, cpu_states, _, cpu_s, _ = timed_loop(metrics_fn("cpu"), [(to_cpu(p), None if t is None else to_cpu(t))
                                                                          for p, t in prefix])
    gap = max(compare(card_states, cpu_states, "state", _image_quality_tolerance),
              compare(card_values, cpu_values, "value", _image_quality_tolerance))
    steps = len(batches)
    return {"updates": steps, "wall_s": loop_s, "update_s": seconds,
            "us_per_update": {k: v / steps * 1e6 for k, v in seconds.items()}, "compute_s": compute_s,
            "values": {name: float(v) for name, v in values.items()},
            "cpu_twin": {"images": WV3_CPU_IMAGES, "seconds": cpu_s, "max_float_gap": gap,
                         "values": {name: float(v) for name, v in cpu_values.items()}}}


def image_quality_eval_phase() -> dict:
    """WorldView-3 pansharpening quality on the card at reduced and full resolution, and
    the image gradients of the fused images; each against its CPU twin on the first 4
    images; no K1-K5 launch."""
    import torch

    from torchmetrics_tpu_torch.functional.image import image_gradients
    from torchmetrics_tpu_torch.ops import kernels

    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    data = worldview3_data()
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    splits = {key: [tuple(x[i:i + WV3_BATCH] for x in tensors) for i in range(0, WV3_IMAGES, WV3_BATCH)]
              for key, tensors in data.items()}
    loops = {"reduced_resolution": image_quality_loop(reduced_resolution_metrics, splits["rr"]),
             "full_resolution": image_quality_loop(full_resolution_metrics, [(b, None) for b in splits["fr"]])}
    fr = loops["full_resolution"]["values"]
    if not all(0.0 <= fr[k] <= 1.0 for k in fr) or not 0.0 < loops["reduced_resolution"]["values"]["scc"] <= 1.0:
        raise AssertionError(f"image_quality_eval: scores outside [0, 1]: {loops}")

    grad_s = 0.0
    for fused, _ in splits["rr"]:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        image_gradients(fused)
        torch.cuda.synchronize()
        grad_s += time.perf_counter() - t1
    fused = splits["rr"][0][0]
    card_grads = image_gradients(fused)
    for got, want in zip(card_grads, image_gradients(fused.cpu())):
        if not torch.equal(got.cpu(), want):
            raise AssertionError("image_quality_eval: the card's image gradients differ from the CPU's")
    loops["gradients"] = {"updates": len(splits["rr"]), "us_per_update": grad_s / len(splits["rr"]) * 1e6,
                          "cpu_twin": {"images": WV3_BATCH, "bitwise": True}}
    launches = dict(kernels.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"image_quality_eval: the image-quality path launched a kernel: {launches}")
    loops["reduced_resolution"]["profile"] = profile_updates(reduced_resolution_metrics("cuda"), splits["rr"][:1])
    loops["full_resolution"]["profile"] = profile_updates(full_resolution_metrics("cuda"),
                                                          [(b, None) for b in splits["fr"]], compute=True)
    return {"phase": "image_quality_eval", "source": "PanCollection WorldView-3 test sets (reduced and full "
            "resolution)", "images": WV3_IMAGES, "bands": WV3_BANDS, "batch": WV3_BATCH,
            "sizes": {"rr": WV3_RR_SIZE, "fr": WV3_FR_SIZE, "ms": WV3_FR_SIZE // WV3_RATIO}, "data_s": data_s,
            "loops": loops, "launches": launches,
            "cuts": {"images": "synthesized from seeds at the test sets' counts and sizes",
                     "cpu_twin": f"the first {WV3_CPU_IMAGES} images of each resolution"}}


# ------------------------------------------------------------------ detection

# COCO val2017 (Lin et al., ECCV 2014; ``instances_val2017.json``), synthesized from seeds
# at its sizes: 5,000 images of 480 x 640, 36,781 boxes of 80 categories (COCO's thing
# ids), each image's count drawn around the mean of 7.36 (a negative binomial, then
# fixed to the total), the categories with a heavy head ("person" 30%, the rest a Zipf
# tail), and COCO's size mix (41% small below 32^2, 34% medium, 25% large). Each image
# has 100 scored detections: up to 60 jittered copies of its boxes (1-2 a box, noise
# 2-35% of the box's size, scores falling with the noise, the category kept 90% of the
# time) and random false positives with lower scores; scores are rounded to 3 decimals,
# so ties occur. Batches of 16 images.
COCO_IMAGES = 5000
COCO_BOXES = 36_781
COCO_SHAPE = (480, 640)
COCO_BATCH = 16
COCO_DETECTIONS = 100
COCO_COPIES = 60
COCO_THINGS = tuple(i for i in range(1, 91) if i not in (12, 26, 29, 30, 45, 66, 68, 69, 71, 83))
COCO_PERSON_SHARE = 0.30
COCO_SIZE_MIX = (0.41, 0.34, 0.25)
COCO_SIDES = ((2.0, 32.0), (32.0, 96.0), (96.0, 400.0))
COCO_CPU_IMAGES = 500
# segm: the first 500 images, masks of 480 x 640 (ellipses inscribed in the boxes), in
# the buffered, bit-packed layout: 50,000 detection rows of 38,400 bytes a buffer
SEGM_IMAGES = 500
SEGM_CPU_IMAGES = 16
# COCO panoptic val2017 (Kirillov et al., CVPR 2019), synthesized: 5,000 images of 480 x
# 640, 133 categories (80 things, 53 stuff, COCO panoptic's ids), batches of 8. Each
# image has 4 stuff categories over 32 x 32 blocks (5% unlabeled, category 0: void in
# the target) and 3-14 thing instances (ellipses of COCO's size mix) painted over them;
# the prediction jitters each instance (10% missed, 10% of categories changed) and
# reassigns 10% of the stuff blocks.
PANOPTIC_IMAGES = 5000
PANOPTIC_BATCH = 8
PANOPTIC_STUFFS = (92, 93, 95, 100, 107, 109, 112, 118, 119, 122, 125, 128, 130, 133, 138, 141, 144, 145, 147,
                   148, 149, 151, 154, 155, 156, 159, 161, 166, 168, 171, 175, 176, 177, 178, 180, 181, 184, 185,
                   186, 187, 188, 189, 190, 191, 192, 193, 194, 195, 196, 197, 198, 199, 200)
PANOPTIC_INSTANCES = (3, 14)
PANOPTIC_CPU_IMAGES = 16
DETECTION_ATOL = 1e-6  # summary values, IoUs of the IoU family, panoptic qualities
PANOPTIC_IOU_RTOL = 1e-6  # the float32 iou_sum state: a float64 sum in another order
DETECTION_EXACT = (".precision", ".recall", ".scores", ".classes", ".ious")


def coco_plan(seed: int = 93) -> dict:
    """Each image's box count (summing to COCO_BOXES) and the category distribution."""
    import numpy as np

    r = np.random.RandomState(seed)
    mean = COCO_BOXES / COCO_IMAGES
    counts = r.negative_binomial(1.2, 1.2 / (1.2 + mean), COCO_IMAGES)
    while counts.sum() != COCO_BOXES:
        i = r.randint(COCO_IMAGES)
        counts[i] = max(0, counts[i] + (1 if counts.sum() < COCO_BOXES else -1))
    tail = 1.0 / np.arange(2, len(COCO_THINGS) + 1) ** 1.1
    probs = np.concatenate([[COCO_PERSON_SHARE], (1 - COCO_PERSON_SHARE) * tail / tail.sum()])
    return {"counts": counts, "probs": probs}


def coco_boxes(g, n: int, device: str = "cuda"):
    """``n`` xyxy float32 boxes in a 480 x 640 image of COCO's size mix."""
    import math

    import torch

    mix = torch.tensor(COCO_SIZE_MIX, device=device)
    size = torch.multinomial(mix, n, replacement=True, generator=g) if n else torch.zeros(0, dtype=torch.int64,
                                                                                          device=device)
    lo = torch.tensor([math.log(a) for a, _ in COCO_SIDES], device=device)[size]
    hi = torch.tensor([math.log(b) for _, b in COCO_SIDES], device=device)[size]
    side = torch.exp(lo + (hi - lo) * torch.rand(n, generator=g, device=device))
    aspect = torch.exp(0.5 * torch.randn(n, generator=g, device=device)).sqrt()
    h_img, w_img = COCO_SHAPE
    w = (side * aspect).clamp(1.0, w_img - 1)
    h = (side / aspect).clamp(1.0, h_img - 1)
    x1 = torch.rand(n, generator=g, device=device) * (w_img - w)
    y1 = torch.rand(n, generator=g, device=device) * (h_img - h)
    return torch.stack([x1, y1, x1 + w, y1 + h], dim=1)


def coco_batch(index: int, plan: dict, device: str = "cuda", images: int | None = None) -> tuple:
    """(preds, target) of batch ``index``: per-image dicts of boxes, scores and labels on
    ``device``, made from the batch's seed (``images`` cuts the batch short)."""
    import torch

    start = index * COCO_BATCH
    n_img = min(COCO_BATCH, COCO_IMAGES - start, images or COCO_BATCH)
    g = torch.Generator(device=device).manual_seed(3000 + index)
    counts = plan["counts"][start:start + n_img].tolist()
    probs = torch.tensor(plan["probs"], dtype=torch.float32, device=device)
    things = torch.tensor(COCO_THINGS, device=device)
    n_gt = sum(counts)
    gt_boxes = coco_boxes(g, n_gt, device)
    gt_labels = things[torch.multinomial(probs, n_gt, replacement=True, generator=g)] if n_gt else \
        torch.zeros(0, dtype=torch.int64, device=device)
    per = torch.tensor(counts, device=device)
    offset = torch.cumsum(per, 0) - per
    slot = torch.arange(COCO_DETECTIONS, device=device)[None, :]
    copies = torch.minimum(2 * per, torch.tensor(COCO_COPIES, device=device))[:, None]
    is_copy = slot < copies
    src = (offset[:, None] + slot % per.clamp(min=1)[:, None]).clamp(max=max(n_gt - 1, 0))
    total = n_img * COCO_DETECTIONS
    sigma = 0.02 + 0.33 * torch.rand(n_img, COCO_DETECTIONS, generator=g, device=device)
    fp = coco_boxes(g, total, device).reshape(n_img, COCO_DETECTIONS, 4)
    fp_labels = things[torch.multinomial(probs, total, replacement=True, generator=g)].reshape(n_img, -1)
    if n_gt:
        base = gt_boxes[src]
        wh = (base[..., 2:] - base[..., :2]).repeat(1, 1, 2)
        jittered = base + torch.randn(base.shape, generator=g, device=device) * sigma[..., None] * wh
        jittered = torch.cat([torch.minimum(jittered[..., :2], jittered[..., 2:]),
                              torch.maximum(jittered[..., :2], jittered[..., 2:])], dim=-1)
        keep_label = torch.rand(n_img, COCO_DETECTIONS, generator=g, device=device) < 0.9
        copy_labels = torch.where(keep_label, gt_labels[src], fp_labels)
    else:
        jittered, copy_labels = fp, fp_labels
    boxes = torch.where(is_copy[..., None], jittered, fp)
    labels = torch.where(is_copy, copy_labels, fp_labels)
    noise = 0.05 * torch.randn(n_img, COCO_DETECTIONS, generator=g, device=device)
    scores = torch.where(is_copy, (1.0 - 2.2 * sigma + noise).clamp(0.01, 1.0),
                         0.45 * torch.rand(n_img, COCO_DETECTIONS, generator=g, device=device))
    scores = torch.round(scores, decimals=3)
    gt_box_list, gt_label_list = torch.split(gt_boxes, counts), torch.split(gt_labels, counts)
    preds = [{"boxes": boxes[i], "scores": scores[i], "labels": labels[i]} for i in range(n_img)]
    target = [{"boxes": gt_box_list[i], "labels": gt_label_list[i]} for i in range(n_img)]
    return preds, target


def ellipse_masks(boxes, shape=COCO_SHAPE):
    """[n, H, W] bool: the ellipse inscribed in each xyxy box."""
    import torch

    y = torch.arange(shape[0], device=boxes.device, dtype=torch.float32)[None, :, None] + 0.5
    x = torch.arange(shape[1], device=boxes.device, dtype=torch.float32)[None, None, :] + 0.5
    c = (boxes[:, :2] + boxes[:, 2:]) / 2
    half = ((boxes[:, 2:] - boxes[:, :2]) / 2).clamp(min=0.5)
    return ((x - c[:, None, None, 0]) / half[:, None, None, 0]) ** 2 + \
        ((y - c[:, None, None, 1]) / half[:, None, None, 1]) ** 2 <= 1.0


def with_masks(preds: list, target: list) -> tuple:
    """The batch's dicts with each box's ellipse mask added."""
    return ([{**p, "masks": ellipse_masks(p["boxes"])} for p in preds],
            [{**t, "masks": ellipse_masks(t["boxes"])} for t in target])


def bbox_metrics(device: str) -> dict:
    from torchmetrics_tpu_torch import detection as tdet

    return {
        "map_class_metrics": tdet.MeanAveragePrecision(class_metrics=True, device=device),
        "map_micro": tdet.MeanAveragePrecision(average="micro", device=device),
        "map_extended": tdet.MeanAveragePrecision(extended_summary=True, device=device),
        "iou": tdet.IntersectionOverUnion(device=device),
        "giou": tdet.GeneralizedIntersectionOverUnion(device=device),
        "diou": tdet.DistanceIntersectionOverUnion(device=device),
        "ciou": tdet.CompleteIntersectionOverUnion(class_metrics=True, device=device),
    }


def segm_metrics(device: str, images: int = SEGM_IMAGES) -> dict:
    from torchmetrics_tpu_torch import detection as tdet

    return {"map_segm": tdet.MeanAveragePrecision(
        iou_type="segm", buffer_capacity=images * COCO_DETECTIONS, image_capacity=images,
        mask_shape=COCO_SHAPE, extended_summary=True, device=device)}


def panoptic_metrics(device: str) -> dict:
    from torchmetrics_tpu_torch import detection as tdet

    kw = {"things": set(COCO_THINGS), "stuffs": set(PANOPTIC_STUFFS), "device": device}
    return {"pq": tdet.PanopticQuality(return_sq_and_rq=True, **kw), "pq_modified": tdet.ModifiedPanopticQuality(**kw)}


def panoptic_batch(index: int, device: str = "cuda", images: int = PANOPTIC_BATCH) -> tuple:
    """(preds, target) int64 [B, 480, 640, 2] (category, instance) maps of batch ``index``."""
    import torch

    g = torch.Generator(device=device).manual_seed(4000 + index)
    h, w = COCO_SHAPE
    bh, bw = h // 32, w // 32
    stuffs = torch.tensor(PANOPTIC_STUFFS, device=device)
    things = torch.tensor(COCO_THINGS, device=device)
    choice = stuffs[torch.randint(0, len(PANOPTIC_STUFFS), (images, 4), generator=g, device=device)]
    block = torch.randint(0, 4, (images, bh, bw), generator=g, device=device)
    stuff = choice.gather(1, block.reshape(images, -1)).reshape(images, bh, bw)
    void = torch.rand(images, bh, bw, generator=g, device=device) < 0.05
    moved = torch.rand(images, bh, bw, generator=g, device=device) < 0.1
    pred_stuff = torch.where(moved, choice.gather(1, ((block + 1) % 4).reshape(images, -1)).reshape(images, bh, bw),
                             stuff)

    def up(x):
        return x.repeat_interleave(32, dim=1).repeat_interleave(32, dim=2)

    k = PANOPTIC_INSTANCES[1]
    count = torch.randint(PANOPTIC_INSTANCES[0], k + 1, (images, 1), generator=g, device=device)
    present = torch.arange(k, device=device)[None, :] < count
    boxes = coco_boxes(g, images * k, device).reshape(images, k, 4)
    category = things[torch.randint(0, len(COCO_THINGS), (images, k), generator=g, device=device)]
    wh = (boxes[..., 2:] - boxes[..., :2]).repeat(1, 1, 2)
    shifted = boxes + 0.08 * torch.randn(boxes.shape, generator=g, device=device) * wh
    pred_present = present & (torch.rand(images, k, generator=g, device=device) >= 0.1)
    changed = torch.rand(images, k, generator=g, device=device) < 0.1
    pred_category = torch.where(changed, things[torch.randint(0, len(COCO_THINGS), (images, k), generator=g,
                                                                 device=device)], category)

    def paint(boxes, present, category, stuff_map, void_map):
        cover = ellipse_masks(boxes.reshape(-1, 4)).reshape(images, k, h, w) & present[..., None, None]
        ids = (cover * torch.arange(1, k + 1, device=device)[None, :, None, None]).amax(dim=1)  # last on top
        cat = torch.where(ids > 0, category.gather(1, (ids - 1).clamp(min=0).reshape(images, -1)).reshape(ids.shape),
                          up(stuff_map))
        if void_map is not None:
            cat = torch.where((ids == 0) & up(void_map), 0, cat)
        return torch.stack([cat, ids.to(torch.int64)], dim=-1)

    return paint(shifted, pred_present, pred_category, pred_stuff, None), paint(boxes, present, category, stuff, void)


def _detection_tolerance(where: str):
    return (0.0, 0.0) if any(key in where for key in DETECTION_EXACT) else (DETECTION_ATOL, 0.0)


def detection_feed(metrics: dict, batches, seconds: dict) -> int:
    """Update every metric with each batch of the iterable, each update timed alone (host
    clock and a synchronise); returns the number of batches."""
    import torch

    steps = 0
    for preds, target in batches:
        for name, m in metrics.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m.update(preds, target)
            torch.cuda.synchronize()
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0
        steps += 1
    return steps


def detection_computes(metrics: dict) -> tuple:
    """Each metric's value and its ``compute`` seconds (the cache cleared first)."""
    import torch

    values, seconds = {}, {}
    for name, m in metrics.items():
        m._computed = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        values[name] = m.compute()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
    return values, seconds


def detection_twin(card: dict, cpu: dict, where: str) -> float:
    """Card against CPU: states and values, the surfaces, IoU dicts and counts exactly,
    the rest within DETECTION_ATOL (panoptic's ``iou_sum`` within PANOPTIC_IOU_RTOL)."""
    def tolerance(path):
        if path.endswith(".iou_sum"):
            return 0.0, PANOPTIC_IOU_RTOL
        return _detection_tolerance(path)

    gap = 0.0
    for name in card:
        gap = max(gap, compare(card[name].state_dict(persistent_only=False), cpu[name].state_dict(persistent_only=False),
                               f"{where}.state.{name}", tolerance))
        gap = max(gap, compare(card[name].compute(), cpu[name].compute(), f"{where}.value.{name}", tolerance))
    return gap


def coco_prefix(plan: dict, images: int, device: str, masks: bool = False):
    """The batches of the first ``images`` images."""
    for index in range(-(-images // COCO_BATCH)):
        preds, target = coco_batch(index, plan, device, images=images - index * COCO_BATCH)
        yield with_masks(preds, target) if masks else (preds, target)


def map_profile(metric) -> dict:
    """torch.profiler over one warm ``compute`` (the metric has computed before): device ms
    (kernels), busy share, and for the matcher's and the accumulation's ranges the device
    ms of the kernels launched in each and each range's span on the device."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    metric._computed = None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        metric.compute()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_us, spans, top = 0.0, {}, {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            if e.key.startswith("MeanAveragePrecision."):  # a range's span on the device, not a kernel
                spans[e.key] = us / 1e3
                continue
            device_us += us
            top[e.key] = us
    ranges = {}
    for e in prof.events():  # the kernels launched inside each range (its host-side event)
        if e.name.startswith("MeanAveragePrecision.") and e.device_type == torch.autograd.DeviceType.CPU:
            total = getattr(e, "device_time_total", None)
            total = getattr(e, "cuda_time_total", 0) if total is None else total
            ranges[e.name] = ranges.get(e.name, 0.0) + total / 1e3
    return {"wall_ms": wall * 1e3, "device_ms": device_us / 1e3,
            "device_busy_share": device_us / 1e6 / wall if wall else None,
            "range_kernel_ms": ranges, "range_device_span_ms": spans,
            "top_kernels": [{"name": k[:90], "ms": us / 1e3} for k, us in sorted(top.items(), key=lambda kv: -kv[1])[:8]]}


def detection_eval_phase() -> dict:
    """COCO val2017 bbox (three mean APs and the IoU family), its first 500 images as
    segm, and COCO panoptic val2017 on the card, each held against its CPU twin; one
    bincount launch a panoptic update a metric."""
    import torch

    from torchmetrics_tpu_torch.ops import kernels

    plan = coco_plan()
    kernels.reset_launch_counts()
    result = {"phase": "detection_eval"}
    parts, last = {}, [time.perf_counter()]

    def mark(name: str) -> None:  # the seconds since the last mark
        now = time.perf_counter()
        parts[name] = now - last[0]
        last[0] = now

    # ---- bbox: COCO val2017
    card = bbox_metrics("cuda")
    seconds: dict = {}
    t0 = time.perf_counter()
    updates = detection_feed(card, (coco_batch(i, plan) for i in range(-(-COCO_IMAGES // COCO_BATCH))), seconds)
    feed_s = time.perf_counter() - t0
    mark("bbox_feed")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    values, compute_s = detection_computes(card)
    peak = torch.cuda.max_memory_allocated() - base
    _, warm_s = detection_computes(card)
    mark("bbox_computes")
    detections = sum(int(m.numel()) for m in card["map_class_metrics"].detection_scores)
    boxes = sum(int(m.numel()) for m in card["map_class_metrics"].groundtruth_labels)
    if detections != COCO_IMAGES * COCO_DETECTIONS or boxes != COCO_BOXES:
        raise AssertionError(f"detection_eval: {detections} detections and {boxes} boxes accumulated")
    for name in ("map_class_metrics", "map_micro", "map_extended"):
        v = values[name]
        if not 0.0 < float(v["map"]) < 1.0 or not 0.0 < float(v["map_50"]) <= 1.0:
            raise AssertionError(f"detection_eval: {name} out of range: map {float(v['map'])}")
    summary = {name: {k: float(x) for k, x in v.items() if torch.is_tensor(x) and x.numel() == 1}
               for name, v in values.items()}
    profile = map_profile(card["map_class_metrics"])
    mark("bbox_profile")
    ext = values["map_extended"]
    result["bbox"] = {
        "source": "COCO val2017 (instances), synthesized at its sizes", "images": COCO_IMAGES, "boxes": boxes,
        "detections": detections, "batch": COCO_BATCH, "updates": updates, "feed_s": feed_s,
        "us_per_update": {k: v / updates * 1e6 for k, v in seconds.items()},
        "compute_s": compute_s, "warm_compute_s": warm_s, "peak_compute_bytes": peak, "values": summary,
        "classes": int(values["map_class_metrics"]["classes"].numel()), "iou_dict_entries": len(ext["ious"]),
        "compute_profile": profile,
    }
    del card, values, ext

    cpu_images = COCO_CPU_IMAGES
    prefix, cpu = bbox_metrics("cuda"), bbox_metrics("cpu")
    t0 = time.perf_counter()
    for preds, target in coco_prefix(plan, cpu_images, "cuda"):
        for name in prefix:
            prefix[name].update(preds, target)
            cpu[name].update(to_cpu_dicts(preds), to_cpu_dicts(target))
    result["bbox"]["cpu_twin"] = {"images": cpu_images, "max_float_gap": detection_twin(prefix, cpu, "bbox"),
                                  "seconds": time.perf_counter() - t0}
    del prefix, cpu
    mark("bbox_twin")

    # ---- segm: the first 500 images, buffered bit-packed masks
    card = segm_metrics("cuda")
    seconds = {}
    t0 = time.perf_counter()
    segm_updates = detection_feed(card, coco_prefix(plan, SEGM_IMAGES, "cuda", masks=True), seconds)
    feed_s = time.perf_counter() - t0
    mark("segm_feed")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    state_bytes = sum(int(getattr(card["map_segm"], n).data.nbytes) for n in ("det_mask_rows", "gt_mask_rows"))
    values, compute_s = detection_computes(card)
    peak = torch.cuda.max_memory_allocated() - base
    _, warm_s = detection_computes(card)
    result["segm"] = {
        "images": SEGM_IMAGES, "mask_shape": list(COCO_SHAPE), "updates": segm_updates, "feed_s": feed_s,
        "us_per_update": {k: v / segm_updates * 1e6 for k, v in seconds.items()}, "compute_s": compute_s,
        "warm_compute_s": warm_s, "mask_state_bytes": state_bytes, "peak_compute_bytes": peak,
        "values": {k: float(x) for k, x in values["map_segm"].items() if torch.is_tensor(x) and x.numel() == 1},
    }
    del card, values
    mark("segm_computes")
    prefix, cpu = segm_metrics("cuda", SEGM_CPU_IMAGES), segm_metrics("cpu", SEGM_CPU_IMAGES)
    for preds, target in coco_prefix(plan, SEGM_CPU_IMAGES, "cuda", masks=True):
        for name in prefix:
            prefix[name].update(preds, target)
            cpu[name].update(to_cpu_dicts(preds), to_cpu_dicts(target))
    result["segm"]["cpu_twin"] = {"images": SEGM_CPU_IMAGES, "max_float_gap": detection_twin(prefix, cpu, "segm")}
    del prefix, cpu
    torch.cuda.empty_cache()
    mark("segm_twin")

    # ---- panoptic: COCO panoptic val2017
    before = kernels.LAUNCHES["bincount"]
    card = panoptic_metrics("cuda")
    seconds = {}
    t0 = time.perf_counter()
    pq_updates = detection_feed(card, (panoptic_batch(i) for i in range(PANOPTIC_IMAGES // PANOPTIC_BATCH)), seconds)
    feed_s = time.perf_counter() - t0
    mark("panoptic_feed")
    launched = kernels.LAUNCHES["bincount"] - before
    if launched != pq_updates * len(card):
        raise AssertionError(f"detection_eval: {launched} bincount launches for {pq_updates} panoptic updates of "
                             f"{len(card)} metrics")
    values, compute_s = detection_computes(card)
    launches = dict(kernels.LAUNCHES)  # the main path's: bbox, segm and panoptic
    if any(v for k, v in launches.items() if k != "bincount"):
        raise AssertionError(f"detection_eval: a kernel other than bincount was launched: {launches}")
    pq_value = values["pq"]
    if not 0.0 < float(pq_value[0]) < 1.0:
        raise AssertionError(f"detection_eval: panoptic quality out of range: {pq_value.tolist()}")
    result["panoptic"] = {
        "source": "COCO panoptic val2017, synthesized at its sizes", "images": PANOPTIC_IMAGES,
        "categories": {"things": len(COCO_THINGS), "stuffs": len(PANOPTIC_STUFFS)}, "batch": PANOPTIC_BATCH,
        "updates": pq_updates, "feed_s": feed_s, "us_per_update": {k: v / pq_updates * 1e6 for k, v in seconds.items()},
        "bincount_per_update_per_metric": launched / pq_updates / len(card), "compute_s": compute_s,
        "values": {"pq": float(pq_value[0]), "sq": float(pq_value[1]), "rq": float(pq_value[2]),
                   "pq_modified": float(values["pq_modified"])},
        "true_positives": int(card["pq"].true_positives.sum()), "false_positives": int(card["pq"].false_positives.sum()),
        "false_negatives": int(card["pq"].false_negatives.sum()),
    }
    prefix, cpu = panoptic_metrics("cuda"), panoptic_metrics("cpu")
    for i in range(PANOPTIC_CPU_IMAGES // PANOPTIC_BATCH):
        preds, target = panoptic_batch(i)
        for name in prefix:
            prefix[name].update(preds, target)
            cpu[name].update(preds.cpu(), target.cpu())
    result["panoptic"]["cpu_twin"] = {"images": PANOPTIC_CPU_IMAGES,
                                      "max_float_gap": detection_twin(prefix, cpu, "panoptic")}
    mark("panoptic_twin")
    # last, after every timing: one update of both panoptic metrics under the profiler
    result["panoptic"]["profile"] = profile_updates(panoptic_metrics("cuda"), [panoptic_batch(0)], tracked=("bincount",))
    mark("panoptic_profile")
    result["launches"] = launches
    result["parts_s"] = parts
    result["cuts"] = {"data": "synthesized from seeds at the published counts, sizes and mixes (no dataset is in "
                              "the repo)", "segm": f"the first {SEGM_IMAGES} images",
                      "cpu_twin": f"bbox {COCO_CPU_IMAGES}, segm {SEGM_CPU_IMAGES} and panoptic "
                                  f"{PANOPTIC_CPU_IMAGES} images"}
    return result


def to_cpu_dicts(items: list) -> list:
    return [{k: v.cpu() for k, v in d.items()} for d in items]


def profile_loop(metrics: dict, preds, target, batch: int, steps: int, track: str | None = None) -> dict:
    """Device time by kernel over ``steps`` warm steps of an eval loop, from torch.profiler.
    With ``track``, also the device ms per step and the traced calls of the kernels whose
    name holds it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def loop(n):
        for i in range(n):
            p, t = preds[i * batch:(i + 1) * batch], target[i * batch:(i + 1) * batch]
            for m in metrics.values():
                m.update(p, t)
        torch.cuda.synchronize()

    loop(2)  # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loop(steps)
        wall = time.perf_counter() - t0
    kernels_by_time = {}
    for e in prof.key_averages():
        device_us = getattr(e, "self_device_time_total", 0) or 0
        if device_us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            kernels_by_time[e.key] = (device_us, e.count)
    total_device_us = sum(us for us, _ in kernels_by_time.values())
    top = sorted(kernels_by_time.items(), key=lambda kv: -kv[1][0])[:10]
    result = {
        "steps": steps, "wall_ms_per_step": wall / steps * 1e3,
        "device_ms_per_step": total_device_us / steps / 1e3,
        "device_busy_share": total_device_us / 1e6 / wall if wall else None,
        "top_kernels": [{"name": k[:90], "ms_per_step": us / steps / 1e3, "calls": n} for k, (us, n) in top],
    }
    if track:
        mine = [v for k, v in kernels_by_time.items() if track in k]
        result["tracked"] = {"name": track, "ms_per_step": sum(us for us, _ in mine) / steps / 1e3,
                             "calls": sum(n for _, n in mine)}
    return result


# ------------------------------------------------------------------ kernel times

WEIGHTED_SHAPES = [(500, 3, 15), (1 << 18, 3, 15)] + [(1 << 20, k, c) for c in (15, 1000, 8192) for k in (1, 3)]
GAUSS11 = ("gauss", 11, 1.5)
SSIM_SHAPES = [(12, 1366, 2050, GAUSS11, GAUSS11), (12, 688, 1030, GAUSS11, GAUSS11),
               (12, 349, 520, GAUSS11, GAUSS11), (12, 179, 265, GAUSS11, GAUSS11), (12, 94, 137, GAUSS11, GAUSS11),
               (12, 522, 534, GAUSS11, ("gauss", 23, 3.0)), (3, 326, 326, ("gauss", 71, 10.0), ("gauss", 71, 10.0)),
               (2, 90, 400, ("gauss", 5, 1.0), ("gauss", 151, 21.5))]


# K1's shapes: the ImageNet step (int64 preds from argmax), the binary step, three
# stress shapes, and the nominal tables (an Adult column pair whole, a class's batch)
CONFUSION_SHAPES = [(500, 1000, "int64"), (1 << 18, 2, "int32"), (1 << 20, 10, "int32"), (1 << 20, 100, "int32"),
                    (1 << 20, 1000, "int32"), (ADULT_ROWS, 43, "int32"), (ADULT_BATCH, 16, "int32")]


# K2's shapes (N, T, shuffled thresholds with ties, main path, seed): the ImageNet micro
# PR curve's step (N = 500 x 1000 pairs), the binary step, and three stress shapes
CURVE_SHAPES = [(500 * 1000, 200, False, True, 4), (1 << 18, 1000, False, True, 5), (1 << 20, 100, False, False, 100),
                (1 << 20, 1000, False, False, 1000), (1 << 20, 200, True, False, 3)]


# K4's shapes (N, C, ids, dtype, main path): the retrieval grouping's 6.98 M query ids
# (shuffled as in its phase; as int64; grouped by query, as retrieval's compute counts
# the documents of its sorted queries), the CTR step's fairness
# update (8 segments: 33 bins), four stress shapes from a per-lane copy (C = 100) to
# an output beyond shared memory (C = 2^20), the clustering contingency table (50,000
# int64 ids into 1000 x 1000 bins, global atomics) and a Cityscapes update's tables
# (4 images of 1024 x 2048 into 4 x 20^2 bins)
BINCOUNT_SHAPES = [(6980 * 1000, 6980, "queries", "int32", True), (6980 * 1000, 6980, "queries", "int64", False),
                   (6980 * 1000, 6980, "grouped", "int32", True),
                   (1 << 18, 4 * FAMILY_SEGMENTS + 1, "segments", "int32", True)] + [
    (1 << 20, c, "random", "int32", False) for c in (100, 8192, 1 << 16, 1 << 20)] + [
    (CLUSTER_SAMPLES, CLUSTER_CLASSES ** 2, "random", "int64", True),
    (CITYSCAPES_BATCH * 1024 * 2048, CITYSCAPES_BATCH * (CITYSCAPES_CLASSES + 1) ** 2, "cityscapes", "int32", True)]


def kernel_times() -> dict:
    """The confusion matrix, the binned curve, the weighted bincount and the SSIM moments
    through their public wrappers only."""
    import hashlib

    import torch

    from torchmetrics_tpu_torch.ops import kernels

    confusion, calls = [], []
    for n, c, preds_dtype in CONFUSION_SHAPES:
        preds, target, valid = confusion_matrix_case(n, c, seed=c, preds_dtype=getattr(torch, preds_dtype))
        got = kernels.confusion_matrix(preds, target, valid, c).cpu()
        if not torch.equal(got, kernels.confusion_matrix_plain(preds.cpu(), target.cpu(), valid.cpu(), c)):
            raise AssertionError(f"confusion_matrix != plain at N={n}, C={c}")
        code, weight = confusion_matrix_library(preds, target, valid, c)
        call = (lambda p, t, v, c: lambda: kernels.confusion_matrix(p, t, v, c))(preds, target, valid, c)
        calls.append(call)
        confusion.append({
            "n": n, "classes": c, "preds_dtype": preds_dtype, "kernel_ms": time_ms(call, reps=200),
            "library_ms": time_ms(lambda: torch.bincount(code, weights=weight, minlength=c * c), reps=200),
            "host_us_per_call": host_us(call), "bound_ms": confusion_matrix_bound_ms(preds, target, c),
        })
    curve = []
    for n, t, unsorted, _, seed in CURVE_SHAPES:
        scores, labels, valid, thresholds = curve_case(n, t, seed, unsorted)
        got = kernels.binned_curve_counts(scores, labels, valid, thresholds).cpu()
        if not torch.equal(got, kernels.binned_curve_counts_plain(scores.cpu(), labels.cpu(), valid.cpu(),
                                                                  thresholds.cpu())):
            raise AssertionError(f"binned_curve_counts != plain at N={n}, T={t}")
        call = (lambda s, l, v, th: lambda: kernels.binned_curve_counts(s, l, v, th))(scores, labels, valid, thresholds)
        calls.append(call)
        curve.append({
            "n": n, "thresholds": t, "unsorted_ties": unsorted, "kernel_ms": time_ms(call, reps=200),
            "composed_library_ms": time_ms(curve_library(scores, labels, valid, thresholds), reps=200),
            "host_us_per_call": host_us(call), "bound_ms": curve_bound_ms(labels, t),
        })
    weighted = []
    for n, k, c in WEIGHTED_SHAPES:
        x, w = weighted_case(n, k, c, seed=13 + k + c)
        got = kernels.weighted_bincount(x, w, c).cpu()
        want = kernels.weighted_bincount_plain(x.cpu(), w.cpu(), c)
        if not torch.equal(got[-1], want[-1]):
            raise AssertionError(f"weighted_bincount count row != plain at N={n}, K={k}, C={c}")
        torch.testing.assert_close(got, want, rtol=WEIGHTED_RTOL, atol=0)
        calls.append((lambda x, w, c: lambda: kernels.weighted_bincount(x, w, c))(x, w, c))
        weighted.append({
            "n": n, "rows": k, "bins": c, "kernel_ms": time_ms(calls[-1], reps=200),
            "host_us_per_call": host_us(calls[-1]),
        })
    bincount = []
    for n, c, ids, dtype, _ in BINCOUNT_SHAPES:
        x = bincount_case(n, c, 9 if ids == "queries" else c, ids, getattr(torch, dtype))
        if not torch.equal(kernels.bincount(x, None, c).cpu(), kernels.bincount_plain(x.cpu(), c)):
            raise AssertionError(f"bincount != plain at N={n}, C={c}, {ids} {dtype} ids")
        calls.append((lambda x, c: lambda: kernels.bincount(x, None, c))(x, c))
        bincount.append({
            "n": n, "bins": c, "ids": ids, "dtype": dtype, "kernel_ms": time_ms(calls[-1], reps=200),
            "library_ms": time_ms(lambda: torch.bincount(x, minlength=c), reps=200),
            "host_us_per_call": host_us(calls[-1]), "bound_ms": bincount_bound_ms(x, c),
        })
        del x
    # what the steps of a wrapper cost alone at the ImageNet step's shape: the casts, a
    # float64 and an int32 zero fill, an empty output and a torch.cuda.Stream object
    x, w = weighted_case(500, 3, 15, seed=11)
    device = w.device
    torch_steps_us = {
        "casts": host_us(lambda: (x.reshape(-1).to(torch.int32).contiguous(), w.to(torch.float32).contiguous())),
        "zeros_float64_k_c": host_us(lambda: torch.zeros((3, 15), dtype=torch.float64, device=device)),
        "zeros_int32_k_plus_k_c": host_us(lambda: torch.zeros(3 + 3 * 15, dtype=torch.int32, device=device)),
        "empty_float32_k_c": host_us(lambda: torch.empty((3, 15), dtype=torch.float32, device=device)),
        "current_stream_object": host_us(lambda: torch.cuda.current_stream(device).cuda_stream),
    }
    ssim = []
    for planes, hp, wp, window_h, window_w in SSIM_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(hp)
        p = torch.rand(planes, hp, wp, generator=g, device="cuda")
        t = torch.rand(planes, hp, wp, generator=g, device="cuda")
        wh, ww = _window(*window_h), _window(*window_w)
        got = kernels.ssim_moments(p, t, wh, ww)
        err = float((got - kernels.ssim_moments_plain(p, t, wh, ww)).abs().max())
        if err > MOMENTS_ATOL:
            raise AssertionError(f"ssim_moments != plain at P={planes}, {hp}x{wp}: max abs err {err}")
        big = planes * hp * wp > 1 << 24
        ssim.append({
            "planes": planes, "hp": hp, "wp": wp, "kh": wh.numel(), "kw": ww.numel(), "max_abs_err": err,
            "kernel_ms": time_ms(lambda: kernels.ssim_moments(p, t, wh, ww), reps=10 if big else 20),
            "sha256_16": hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()[:16],
        })
        del got
    # traced last: a process that has run the profiler spends more host time per launch
    for record, call in zip(confusion + curve + weighted + bincount, calls):
        record.update(traced(device_kernels_per_call(call)))
    return {"phase": "kernel_times", "confusion_matrix": confusion, "binned_curve_counts": curve,
            "weighted_bincount": weighted, "bincount": bincount,
            "torch_steps_us": torch_steps_us, "ssim_moments": ssim}


# ------------------------------------------------------------------ obs and robust planes

# the phase's data: ImageNet-1k rows (batch 500) and CTR scores (batch 2^18), both grouped
OBS_IMAGENET_BATCHES = 64
OBS_CTR_BATCHES = 8
OBS_RESTORED_BATCHES = 8  # fed to the restored ImageNet session after its bundle
OBS_NAN_BATCH = 13  # the ImageNet pipeline's update index that gets NaN (quarantined)
OBS_CHECKPOINT_EVERY = 16
OBS_MUX_WIDTH = 8
OBS_MUX_ROUNDS = 4
OBS_MUX_NAN = (1, 1)  # (tenant, round) whose batch gets one NaN under ``quarantine``
OBS_MUX_QUOTA = 3  # the noisy tenant's updates a window: its last round is shed
OBS_MAX_EVENTS = 200_000
OBS_PROFILE_STEPS = 8
OBS_PROFILE_RANGES = ("MulticlassAccuracy.update", "MulticlassAUROC.update")
OBS_SYNC_BATCHES = 8  # ImageNet batches each rank of the degraded-sync world folds (every other one)
OBS_RETRY_TIMEOUT_S = 20.0
OBS_HANG_TIMEOUT_S = 2.0
OBS_HANG_GROUP_TIMEOUT_S = 30  # the hang's own gloo group: its abandoned collectives end by then
OBS_CHILD_TIMEOUT_S = 240
OBS_COST_ROUNDS = 5  # rounds of (planes off, sampler alone, planes on) timed in turns
OBS_COST_CTR_REPEAT = 8  # the CTR stream fed this many times in a timed pass (64 steps)


def obs_root() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "obs")


def obs_config() -> dict:
    """The sizes a spawned child of the phase takes (a child imports this module anew)."""
    return {"profile_steps": OBS_PROFILE_STEPS, "sync_batches": OBS_SYNC_BATCHES,
            "retry_timeout_s": OBS_RETRY_TIMEOUT_S, "hang_timeout_s": OBS_HANG_TIMEOUT_S,
            "hang_group_timeout_s": OBS_HANG_GROUP_TIMEOUT_S, "ranges": OBS_PROFILE_RANGES}


def obs_guarded(metrics_fn, device: str, policy: str = "quarantine"):
    from torchmetrics_tpu_torch import MetricCollection

    col = MetricCollection(metrics_fn(device))
    for m in col.values(copy_state=False):
        m.error_policy = policy
    return col


def obs_ledger(report: dict) -> dict:
    """Each tenant's merged flow ledger, and whether it balances: every fed batch is
    processed, shed, deferred, quarantined, skipped, in flight or handed off."""
    fields = ("fed", "processed", "shed", "deferred_pending", "quarantined", "skipped", "in_flight", "handed_off")
    out = {}
    for tenant, entry in sorted(report["tenants"].items()):
        totals = {f: int(entry["totals"][f]) for f in fields}
        totals["balanced"] = totals["fed"] == sum(totals[f] for f in fields[1:])
        out[tenant] = totals
    return out


def obs_parse_robust(text: str) -> dict:
    """{(metric, instance): {counter: value}} from the per-metric ``tm_tpu_robust_*``
    rows of a Prometheus page."""
    import re

    row = re.compile(r"^tm_tpu_robust_(\w+?)(?:_total)?\{(.*)\} (\S+)$")
    out = {}
    for line in text.splitlines():
        match = row.match(line)
        if match is None:
            continue
        labels = dict(re.findall(r'(\w+)="([^"]*)"', match.group(2)))
        if "instance" not in labels:
            continue  # a trace counter of the robust plane (robust.*), not a metric's row
        out.setdefault((labels["metric"], int(labels["instance"])), {})[match.group(1)] = float(match.group(3))
    return out


def obs_export_check(pipe, leaders: list, root: str, name: str) -> dict:
    """The Prometheus page and the JSONL of a pipeline's driven metrics, parsed back: the
    robust counters equal each metric's own, and every driven metric accounts for every
    batch the pipeline's report processed."""
    from torchmetrics_tpu_torch.obs import export

    report = pipe.report()
    text = export.prometheus_text(metrics=leaders)
    path = os.path.join(root, f"{name}.jsonl")
    lines = export.write_jsonl(path, metrics=leaders)
    with open(path, encoding="utf-8") as fh:
        rows = [json.loads(line) for line in fh]
    if len(rows) != lines or rows[0]["type"] != "meta":
        raise AssertionError(f"obs_eval export {name}: {len(rows)} JSONL rows read back of {lines} written")
    jsonl = {(r["metric"], r["instance"]): r for r in rows if r["type"] == "robust"}
    prom = obs_parse_robust(text)
    counters = ("updates_ok", "updates_skipped", "updates_quarantined", "quarantine_dropped")
    for index, m in enumerate(leaders):
        key = (type(m).__name__, index)
        want = {c: int(getattr(m, c)) for c in counters}
        got_prom = {c: int(prom[key][c]) for c in counters}
        got_jsonl = {c: int(jsonl[key][c]) for c in counters}
        if got_prom != want or got_jsonl != want or bool(prom[key]["sync_degraded"]) != m.sync_degraded:
            raise AssertionError(f"obs_eval export {name}: {key} exported {got_prom} / {got_jsonl}, holds {want}")
        if want["updates_ok"] + want["updates_quarantined"] + want["updates_skipped"] != report.processed_batches():
            raise AssertionError(f"obs_eval export {name}: {key} counts {want}, the pipeline processed"
                                 f" {report.processed_batches()} batches")
    return {"prometheus_lines": len(text.splitlines()), "jsonl_lines": lines,
            "processed_batches": report.processed_batches(),
            "robust": {f"{k[0]}#{k[1]}": {c: int(v[c]) for c in ("updates_ok", "updates_quarantined")}
                       for k, v in sorted(prom.items())}}


def obs_footprint_twin(card_col, metrics_fn, batches: list, nan_index: int | None = None) -> dict:
    """The card collection's footprint beside a twin built with ``device="cpu"`` and fed
    the first batch (and the NaN batch, quarantined, where the card's run had one):
    equal byte for byte."""
    import torch

    from torchmetrics_tpu_torch.obs import memory

    twin = obs_guarded(metrics_fn, "cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        p, t = batches[0]
        twin.update(p.cpu(), t.cpu())
        if nan_index is not None:
            p, t = batches[nan_index]
            twin.update(torch.full_like(p.cpu(), float("nan")), t.cpu())
    card, cpu = card_col.memory_footprint(), memory.footprint(twin)
    if card != cpu:
        raise AssertionError(f"obs_eval memory: the card footprint {card['unique_bytes']} B"
                             f" / {card['total_bytes']} B is not the CPU twin's"
                             f" {cpu['unique_bytes']} B / {cpu['total_bytes']} B")
    return {k: card[k] for k in ("total_bytes", "unique_bytes", "device_bytes", "host_bytes", "n_states")}


def obs_mux_streams(batches: list, width: int, rounds: int) -> dict:
    """Tenant j's rows: 256-row slices of the ImageNet batches, distinct per tenant."""
    rows = [(p[i:i + 256], t[i:i + 256]) for p, t in batches for i in (0, 250)]
    return {j: [rows[(r * width + j) % len(rows)] for r in range(rounds)] for j in range(width)}


def obs_audit_run(data: dict, root: str) -> dict:
    """Audit, memory, export and Perfetto over the main path with tracing, lineage and the
    auditor on: both grouped collections as ``MetricPipeline(fuse=8)`` tenant sessions
    with a checkpoint policy (a NaN ImageNet batch quarantined), the ImageNet session
    restored from its bundle and fed on, and a ``TenantMultiplexer`` at W = 8 (one NaN
    batch quarantined, the noisy tenant's last round shed by admission)."""
    import torch

    from torchmetrics_tpu_torch.engine import (CheckpointPolicy, MetricPipeline, MuxConfig, PipelineConfig,
                                               TenantMultiplexer, restore_session)
    from torchmetrics_tpu_torch.obs import audit, lineage, memory, perfetto, scope, trace
    from torchmetrics_tpu_torch.ops import kernels
    from torchmetrics_tpu_torch.robust import faults

    device = "cuda"
    trace.enable(max_events=OBS_MAX_EVENTS)
    lineage.enable()
    auditor = audit.ConservationAuditor(cadence_seconds=1e-6)
    audit.install_auditor(auditor)
    kernels.reset_launch_counts()
    out = {"pipelines": {}, "memory": {}, "export": {}}
    try:
        sessions = {}
        for kind, metrics_fn, tenant in (("imagenet", imagenet_metrics, "imagenet"), ("binary", binary_metrics, "ctr")):
            col = obs_guarded(metrics_fn, device)
            policy = CheckpointPolicy(directory=os.path.join(root, "stream", tenant), every_batches=OBS_CHECKPOINT_EVERY)
            pipe = MetricPipeline(col, PipelineConfig(fuse=PIPELINE_FUSE, tenant=tenant, checkpoint=policy))
            nan = (faults.inject_nan_updates(indices=(OBS_NAN_BATCH,)) if kind == "imagenet"
                   else contextlib.nullcontext())
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                with nan:
                    report = pipe.run(data[kind])
            torch.cuda.synchronize()
            leaders = [col[members[0]] for members in col.compute_groups.values()]
            quarantined = {m.__class__.__name__: [q["update_index"] for q in m.quarantined_batches] for m in leaders}
            if kind == "imagenet" and any(v != [OBS_NAN_BATCH] for v in quarantined.values()):
                raise AssertionError(f"obs_eval: the ImageNet leaders quarantined {quarantined}, not [{OBS_NAN_BATCH}]")
            out["export"][tenant] = obs_export_check(pipe, leaders, root, tenant)
            bundle = pipe.checkpoint_now()
            pipe.close()
            sessions[kind] = (pipe, col, bundle, policy)
            out["pipelines"][tenant] = {"report": report.asdict(), "bundle": os.path.basename(bundle)}
            out["memory"][tenant] = obs_footprint_twin(col, metrics_fn, data[kind],
                                                       OBS_NAN_BATCH if kind == "imagenet" else None)
        # the ImageNet session restored from its last bundle and fed on, as a migration would
        _, _, bundle, policy = sessions["imagenet"]
        restored, _ = restore_session(obs_guarded(imagenet_metrics, device), bundle,
                                      checkpoint=CheckpointPolicy(directory=policy.directory,
                                                                  every_batches=OBS_CHECKPOINT_EVERY))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            restored.run(data["imagenet"][:OBS_RESTORED_BATCHES])
        restored.close()
        out["restored"] = {"report": restored.report().asdict()}

        # the multiplexer: W tenants of the grouped ImageNet collection
        controller = scope.AdmissionController()
        noisy = f"imagenet-m{OBS_MUX_WIDTH - 1}"
        controller.set_quota(noisy, scope.TenantQuota(updates_per_window=OBS_MUX_QUOTA, window_seconds=3600.0,
                                                      over_quota="shed"))
        mux = TenantMultiplexer(lambda: obs_guarded(imagenet_metrics, device),
                                MuxConfig(max_width=OBS_MUX_WIDTH, admission=controller))
        tenants = [f"imagenet-m{j}" for j in range(OBS_MUX_WIDTH)]
        streams = obs_mux_streams(data["imagenet"], OBS_MUX_WIDTH, OBS_MUX_ROUNDS)
        bad_tenant, bad_round = OBS_MUX_NAN
        p, y = streams[bad_tenant][bad_round]
        p = p.clone()
        p.view(-1)[0] = float("nan")
        streams[bad_tenant][bad_round] = (p, y)
        for t in tenants:
            mux.adopt(t)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            for r in range(OBS_MUX_ROUNDS):
                for j, t in enumerate(tenants):
                    mux.feed(t, *streams[j][r])
            mux.flush()
        torch.cuda.synchronize()
        out["launches"] = dict(kernels.LAUNCHES)
        auditor.tick(now=1.0)
        auditor.tick(now=2.0)
        live = obs_ledger(auditor.report())
        mux_report = mux.close()
        auditor.tick(now=3.0)
        report = auditor.report()
        ledger = obs_ledger(report)
        out["mux"] = {"report": mux_report.asdict(), "tenants": OBS_MUX_WIDTH, "nan": list(OBS_MUX_NAN),
                      "shed_tenant": noisy}
        if ledger[tenants[bad_tenant]]["quarantined"] < 1 or ledger[noisy]["shed"] != 1:
            raise AssertionError(f"obs_eval: the mux ledger shows {ledger[tenants[bad_tenant]]} for the NaN tenant"
                                 f" and {ledger[noisy]} for the noisy one")
        unbalanced = [t for t, row in {**live, **ledger}.items() if not row["balanced"]]
        if unbalanced or report["violations"]:
            raise AssertionError(f"obs_eval audit: unbalanced {unbalanced}, violations {report['violations']}")
        out["audit"] = {"ledger": ledger, "violations": len(report["violations"]), "sessions": report["sessions"],
                        "approximate": report["approximate"],
                        "invariants": {row["invariant"]: row["passed"] for row in report["invariants"]}}
        stream = audit.audit_stream(os.path.join(root, "stream"))
        if stream["corrupt"] or stream["violations"] or not stream["bundles"]:
            raise AssertionError(f"obs_eval audit_stream: {stream['bundles']} bundles, corrupt {stream['corrupt']},"
                                 f" violations {stream['violations']}")
        out["audit_stream"] = {"bundles": stream["bundles"], "tenants": stream["tenants"]}

        # the multiplexer's state bytes: its tenants, each beside its CPU twin
        mux_fp = {"total_bytes": 0, "unique_bytes": 0}
        for j, t in enumerate(tenants):
            twin = obs_footprint_twin(mux.metric(t), imagenet_metrics, streams[j],
                                      bad_round if j == bad_tenant else None)
            for key in mux_fp:
                mux_fp[key] += twin[key]
        out["memory"]["mux"] = mux_fp
        out["memory"]["device_memory_stats"] = memory.device_memory_stats()
        stats = out["memory"]["device_memory_stats"]
        if not stats or not all({"bytes_in_use", "peak_bytes_in_use"} <= set(row) for row in stats.values()):
            raise AssertionError(f"obs_eval: device_memory_stats() gave {out['memory']['device_memory_stats']}")
        # what one fresh ImageNet collection's states take from the allocator, beside its bytes
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        fresh = obs_guarded(imagenet_metrics, device)
        torch.cuda.synchronize()
        fresh_fp = fresh.memory_footprint()
        out["memory"]["fresh_imagenet"] = {
            "unique_bytes": fresh_fp["unique_bytes"], "device_bytes": fresh_fp["device_bytes"],
            "allocator_growth_bytes": torch.cuda.memory_allocated() - before,
        }
        del fresh

        # Perfetto: the run's spans, written and read back
        path = os.path.join(root, "trace.json")
        events = perfetto.write_trace(path)
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
        fed = sum(row["fed"] for row in ledger.values())
        spans = sum(1 for e in doc["traceEvents"] if e["ph"] == "X")
        if len(doc["traceEvents"]) != events or not spans or not doc["otherData"]["n_flows"]:
            raise AssertionError(f"obs_eval perfetto: {events} events written, {len(doc['traceEvents'])} read,"
                                 f" {spans} spans, {doc['otherData']['n_flows']} flows")
        out["perfetto"] = {"events": events, "x_events": spans, "flows": doc["otherData"]["n_flows"],
                           "fed_batches": fed, "flows_per_batch": doc["otherData"]["n_flows"] / fed,
                           "dropped_events": trace.get_recorder().dropped_events}
        del mux
    finally:
        audit.install_auditor(None)
        lineage.disable()
        trace.disable()
        trace.get_recorder().clear()
        scope.reset()
    release_graphs()
    return out


def obs_profile_worker(log_dir: str, cfg: dict, queue) -> None:
    """The spawned profile: ``profile_session`` over eager ImageNet steps of the grouped
    collection; the trace must hold the metrics' ``<Class>.update`` ranges, and every K1
    and K2 launch of those steps inside one of them (the launch's CUDA runtime call by
    its correlation id, else the kernel inside the range's device span)."""
    import traceback

    try:
        import torch

        from torchmetrics_tpu_torch import MetricCollection
        from torchmetrics_tpu_torch.obs import profile
        from torchmetrics_tpu_torch.ops import kernels

        torch.cuda.set_device(0)
        preds, target = imagenet_data(n=cfg["profile_steps"] * 500, device="cuda")
        col = MetricCollection(imagenet_metrics("cuda"))
        col.update(preds[:500], target[:500])  # the first use of each kernel, outside the trace
        col.reset()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        with profile.profile_session(log_dir, host=True) as session:
            for i in range(cfg["profile_steps"]):
                col.update(preds[i * 500:(i + 1) * 500], target[i * 500:(i + 1) * 500])
            torch.cuda.synchronize()
        launches = dict(kernels.LAUNCHES)
        path = profile.last_trace_path()
        with open(path, encoding="utf-8") as fh:
            doc = json.load(fh)
        queue.put(("profile", {"session": session["device"], "trace_bytes": os.path.getsize(path),
                               "launches": launches, **obs_trace_ranges(doc, cfg["ranges"]),
                               "host_samples": session["host"].stats()["samples"]}, None))
    except BaseException:
        queue.put(("profile", None, traceback.format_exc()))
        raise


def obs_trace_ranges(doc: dict, required: tuple) -> dict:
    """The metric ranges of a torch.profiler Chrome trace and the K1/K2 kernels launched
    inside each."""
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    ranges = [e for e in events if e.get("cat") == "user_annotation" and str(e.get("name", "")).endswith(".update")]
    gpu_ranges = [e for e in events if e.get("cat") == "gpu_user_annotation"]
    runtime = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") == "cuda_runtime" and corr is not None:
            runtime[corr] = e
    names = {"confusion_matrix": DEVICE_KERNEL_NAMES["confusion_matrix"],
             "binned_curve_counts": DEVICE_KERNEL_NAMES["binned_curve_counts"]}
    inside = {k: {} for k in names}
    outside = {k: 0 for k in names}
    by = {k: 0 for k in ("runtime", "device")}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        kernel = next((k for k, part in names.items() if part in e.get("name", "")), None)
        if kernel is None:
            continue
        host = runtime.get((e.get("args") or {}).get("correlation"))
        if host is not None:
            owner = next((r for r in ranges if r.get("tid") == host.get("tid")
                          and r["ts"] <= host["ts"] <= r["ts"] + r["dur"]), None)
            by["runtime"] += owner is not None
        else:
            owner = next((r for r in gpu_ranges if r["ts"] <= e["ts"] <= r["ts"] + r["dur"]), None)
            by["device"] += owner is not None
        if owner is None:
            outside[kernel] += 1
        else:
            inside[kernel][owner["name"]] = inside[kernel].get(owner["name"], 0) + 1
    range_names = sorted({r["name"] for r in ranges})
    return {"ranges": {n: sum(1 for r in ranges if r["name"] == n) for n in range_names},
            "kernels_inside": inside, "kernels_outside": outside, "matched_by": by,
            "missing_ranges": [n for n in required if n not in range_names]}


def obs_sync_rank(rank: int, port: int, cfg: dict, queue) -> None:
    """One rank of the degraded-sync world (two gloo ranks on cuda:0). The grouped
    ImageNet collection folds every other batch; then (a) with the guard configured and
    one injected ``raise`` on each rank the synced ``compute`` is bitwise the unguarded
    one after one retry, and (b) on a gloo group of its own with a short timeout, rank 1's
    collectives hang (injected): both ranks degrade, every synced metric is flagged, the
    values equal the local compute, and ``aggregate()`` lists the missing rank. The rank
    reports, then leaves with ``os._exit``: rank 0's abandoned collective threads must not
    hold up its exit."""
    import datetime
    import io
    import traceback

    code = 0
    try:
        import torch
        import torch.distributed as dist

        from torchmetrics_tpu_torch import MetricCollection
        from torchmetrics_tpu_torch.obs import aggregate, trace
        from torchmetrics_tpu_torch.robust import faults, sync_guard

        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=2,
                                timeout=datetime.timedelta(seconds=120))
        hang_group = dist.new_group(ranks=[0, 1], backend="gloo",
                                    timeout=datetime.timedelta(seconds=cfg["hang_group_timeout_s"]))
        preds, target = imagenet_data(n=cfg["sync_batches"] * 500, device="cuda")
        col = MetricCollection(imagenet_metrics("cuda"))
        for start in range(rank * 500, preds.shape[0], 1000):
            col.update(preds[start:start + 500], target[start:start + 500])
        members = list(col.values(copy_state=False))
        for m in members:
            m.compute_with_cache = False
            m._to_sync = False
        local = to_cpu(col.compute())
        for m in members:
            m._to_sync = True
        plain = to_cpu(col.compute())
        trace.enable()
        dist.barrier()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with sync_guard(cfg["retry_timeout_s"], 1), faults.inject_collective_fault("raise", 1):
                retried = to_cpu(col.compute())
        snap = trace.get_recorder().snapshot()
        counted = {c["name"]: 0.0 for c in snap["counters"]}
        for c in snap["counters"]:
            counted[c["name"]] += c["value"]
        out = {"rank": rank, "retry": {"bitwise": bitwise_equal(list(flatten_values(retried)),
                                                                  list(flatten_values(plain))),
                                       "retries": counted.get("sync.collective_retry", 0.0),
                                       "collectives": counted.get("sync.collectives", 0.0),
                                       "degraded": sum(m.sync_degraded for m in members)}}
        trace.get_recorder().clear()
        dist.barrier()
        for m in members:
            m.process_group = hang_group
        hang = faults.inject_collective_fault("hang", 10_000) if rank == 1 else contextlib.nullcontext()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with sync_guard(cfg["hang_timeout_s"], 1), hang:
                hung = to_cpu(col.compute())
                hung_s = time.perf_counter() - t0
                agg = aggregate.aggregate(process_group=hang_group)
        snap = trace.get_recorder().snapshot()
        degraded_syncs = sum(c["value"] for c in snap["counters"] if c["name"] == "sync.degraded")
        out["hang"] = {"seconds": hung_s, "degraded_syncs": degraded_syncs,
                       "flagged": sum(m.sync_degraded for m in members), "synced": sum(m._is_synced for m in members),
                       "equals_local": bitwise_equal(list(flatten_values(hung)), list(flatten_values(local))),
                       "aggregate_degraded": agg["aggregate_degraded"], "missing_hosts": agg["missing_hosts"],
                       "degraded_error": agg.get("degraded_error")}
        payload = io.BytesIO()
        torch.save(out, payload)
        queue.put(("sync", payload.getvalue(), None))
    except BaseException:
        queue.put(("sync", None, traceback.format_exc()))
        code = 1
    finally:
        queue.close()
        queue.join_thread()
        os._exit(code)


def flatten_values(tree):
    """The tensors of a computed value tree, in a fixed order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from flatten_values(tree[key])
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            yield from flatten_values(item)
    else:
        yield tree


def obs_start_children(root: str) -> tuple:
    """Spawn the profile process and the two ranks of the degraded-sync world; they run
    while the parent audits."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    cfg = obs_config()
    port = free_port()
    procs = [ctx.Process(target=obs_profile_worker, args=(os.path.join(root, "profile"), cfg, results))]
    procs += [ctx.Process(target=obs_sync_rank, args=(rank, port, cfg, results)) for rank in range(2)]
    for proc in procs:
        proc.start()
    return procs, results


def obs_join_children(procs: list, results) -> dict:
    import io
    import queue as queue_mod

    import torch

    got = {"profile": [], "sync": []}
    deadline = time.monotonic() + OBS_CHILD_TIMEOUT_S
    try:
        while len(got["profile"]) + len(got["sync"]) < len(procs):
            if time.monotonic() > deadline:
                raise AssertionError(f"obs_eval: a child hung ({len(got['profile'])} profile,"
                                     f" {len(got['sync'])} sync results)")
            try:
                kind, result, error = results.get(timeout=1)
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise AssertionError(f"obs_eval: a child exited with {dead} before it reported")
                continue
            if error is not None:
                raise AssertionError(f"obs_eval: the {kind} child failed:\n{error}")
            got[kind].append(torch.load(io.BytesIO(result)) if kind == "sync" else result)
        for proc in procs:
            proc.join(timeout=max(1.0, deadline - time.monotonic()))
            if proc.exitcode != 0:
                raise AssertionError(f"obs_eval: a child ended with exit code {proc.exitcode}")
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
    return got


def obs_check_children(got: dict) -> dict:
    profile = got["profile"][0]
    if not profile["session"] or profile["missing_ranges"] or any(profile["kernels_outside"].values()) \
            or not all(profile["kernels_inside"].values()):
        raise AssertionError(f"obs_eval profile: {profile}")
    for kernel, owners in profile["kernels_inside"].items():
        if sum(owners.values()) != profile["launches"][kernel]:
            raise AssertionError(f"obs_eval profile: {kernel} traced {owners}, launched {profile['launches'][kernel]}")
    ranks = sorted(got["sync"], key=lambda r: r["rank"])
    for r in ranks:
        retry, hang = r["retry"], r["hang"]
        if not retry["bitwise"] or retry["retries"] != 1 or retry["degraded"]:
            raise AssertionError(f"obs_eval sync rank {r['rank']}: the retried compute {retry}")
        if not hang["flagged"] or hang["synced"] or not hang["equals_local"] or not hang["aggregate_degraded"] \
                or hang["missing_hosts"] != [1 - r["rank"]]:
            raise AssertionError(f"obs_eval sync rank {r['rank']}: the hung compute {hang}")
    return {"profile": profile, "sync": ranks}


def obs_hostprof_run(data: dict) -> dict:
    """The host profiler at its default rate over an eager pass, a fused pass and a mux
    pass of the grouped ImageNet collection, each a tenant session."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine import MetricPipeline, MuxConfig, PipelineConfig, TenantMultiplexer
    from torchmetrics_tpu_torch.obs import hostprof, scope

    device = "cuda"
    batches = data["imagenet"][:32]
    col = MetricCollection(imagenet_metrics(device))
    pipe = MetricPipeline(MetricCollection(imagenet_metrics(device)), PipelineConfig(fuse=PIPELINE_FUSE, tenant="fused"))
    pipe.warmup(*batches[0])
    mux = TenantMultiplexer(lambda: MetricCollection(imagenet_metrics(device)), MuxConfig(max_width=OBS_MUX_WIDTH))
    streams = obs_mux_streams(batches, OBS_MUX_WIDTH, OBS_MUX_ROUNDS)
    tenants = [f"mux-{j}" for j in range(OBS_MUX_WIDTH)]
    for t in tenants:
        mux.adopt(t)
    torch.cuda.synchronize()
    try:
        with hostprof.sampling() as prof:
            with scope.scope("eager"):
                for p, t in batches:
                    col.update(p, t)
                torch.cuda.synchronize()
            pipe.run(batches)
            torch.cuda.synchronize()
            for r in range(OBS_MUX_ROUNDS):
                for j, t in enumerate(tenants):
                    mux.feed(t, *streams[j][r])
            mux.flush()
            torch.cuda.synchronize()
        pipe.close()
        mux.close()
        floor = prof.floor_report()
        return {"rate_hz": prof.rate_hz, "samples": prof.stats()["samples"], "breakdown": prof.breakdown(),
                "attributed_percent": prof.attributed_percent(),
                "self_overhead_percent": prof.self_overhead_percent(),
                "python_floor_fraction": floor["python_floor_fraction"], "paths": floor["paths"],
                "tenants": prof.tenant_breakdown()}
    finally:
        scope.reset()


def obs_plane_cost(data: dict) -> dict:
    """µs per step of the fused ImageNet and CTR loops with every plane off, with the
    host sampler alone, and with tracing, lineage, the auditor and the sampler on, in
    turns (off, sampler, on, off, ...), each pass on a new pipeline; the median, the
    spread and the median of each round's difference from its own ``off`` pass.
    Reported, not gated."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig
    from torchmetrics_tpu_torch.obs import audit, hostprof, lineage, trace

    out = {}
    for kind, metrics_fn in (("imagenet", imagenet_metrics), ("binary", binary_metrics)):
        batches = data[kind] * (OBS_COST_CTR_REPEAT if kind == "binary" else 1)
        times = {"off": [], "sampler": [], "on": []}
        for _ in range(OBS_COST_ROUNDS):
            for planes in times:
                pipe = MetricPipeline(MetricCollection(metrics_fn("cuda")), PipelineConfig(fuse=PIPELINE_FUSE))
                pipe.warmup(*batches[0])
                torch.cuda.synchronize()
                prof = None
                if planes == "on":
                    trace.enable(max_events=OBS_MAX_EVENTS)
                    lineage.enable()
                    audit.install_auditor(audit.ConservationAuditor())
                if planes != "off":
                    prof = hostprof.HostProfiler()
                    hostprof.install(prof)
                    prof.start()
                try:
                    t0 = time.perf_counter()
                    pipe.run(batches)
                    torch.cuda.synchronize()
                    times[planes].append((time.perf_counter() - t0) / len(batches) * 1e6)
                finally:
                    if prof is not None:
                        prof.stop()
                        hostprof.install(None)
                    audit.install_auditor(None)
                    lineage.disable()
                    trace.disable()
                    trace.get_recorder().clear()
                pipe.close()
                del pipe
                release_graphs()
        out[kind] = {"steps": len(batches), "us_per_step": times,
                     "median_us": {k: statistics.median(v) for k, v in times.items()},
                     "spread_us": {k: [min(v), max(v)] for k, v in times.items()},
                     "median_delta_us": {k: statistics.median(x - off for x, off in zip(v, times["off"]))
                                         for k, v in times.items() if k != "off"}}
    return out


def obs_eval_phase() -> dict:
    """The robust and observability planes on the main path: audit, memory, export and
    Perfetto over the fused pipelines and the multiplexer; a spawned profile session and
    a spawned two-rank degraded sync running meanwhile; then the host profiler and the
    planes' cost per fused step."""
    import shutil

    root = obs_root()
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    procs, results = obs_start_children(root)
    try:
        data = {"imagenet": batches_of(*imagenet_data(n=OBS_IMAGENET_BATCHES * 500, device="cuda"), 500),
                "binary": batches_of(*binary_data(n=OBS_CTR_BATCHES << 18, device="cuda"), 1 << 18)}
        t0 = time.perf_counter()
        audited = obs_audit_run(data, root)
        audited["seconds"] = time.perf_counter() - t0
    except BaseException:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        raise
    t0 = time.perf_counter()
    children = obs_check_children(obs_join_children(procs, results))
    children["wait_seconds"] = time.perf_counter() - t0
    hostprof_record = obs_hostprof_run(data)
    cost = obs_plane_cost(data)
    shutil.rmtree(root, ignore_errors=True)
    launches = audited.pop("launches")
    return {"phase": "obs_eval", **audited, "children": children, "hostprof": hostprof_record,
            "plane_cost": cost, "launches": launches}


# --------------------------------------------------------------------------- fleet

# the two virtual hosts, named by process index as the JAX package names them (its
# ``serve --demo``): the sampler's rate table keys the cost ledger's burn by the real
# process index, so a virtual host named otherwise would stand beside a phantom host "0"
# in the skew (JAX ``obs/fleet.py:352-362``), and the controller would find its coldest
# host unmanaged. "0" plays host-a, "1" host-b.
FLEET_HOSTS = ("0", "1")
# tenant -> (data set, host): six on host "0" (every ImageNet tenant), two CTR tenants on
# host "1". An ImageNet batch folds 6 group leaders, a CTR batch 4, so host "0" carries
# 32 of 40 leader updates per round: imbalance (0.8 - 1/2) / (1 - 1/2) = 0.6
FLEET_TENANTS = {
    "imagenet-0": ("imagenet", "0"), "imagenet-1": ("imagenet", "0"),
    "imagenet-2": ("imagenet", "0"), "imagenet-3": ("imagenet", "0"),
    "ctr-0": ("binary", "0"), "ctr-1": ("binary", "0"),
    "ctr-2": ("binary", "1"), "ctr-3": ("binary", "1"),
}
FLEET_STEPS = 800  # batches each tenant is fed in the served run
FLEET_POOL = {"imagenet": 32, "binary": 16}  # distinct batches each set's tenants cycle through
FLEET_SAMPLER_CADENCE_S = 0.25
FLEET_CONTROLLER_CADENCE_S = 1.0
# the controller reads rates over 8 sampler cadences (2 s, ~20 fused chunks a tenant):
# over one cadence a chunk more or less is 10-40% of a tenant's rate, and on an H100
# the band thrashed at a 0.6 s window (a tenant moved there and back)
FLEET_SMOOTHING_WINDOWS = 8.0
# the scraper's sweep period: each route read at up to 10 Hz. Under load a sweep of the
# 19 probes takes 0.2-0.6 s on an H100's host, so each route is read at 2-4 Hz; a thread
# per route read each at 4-7 Hz but held the feeding loop 3-4x longer
FLEET_SCRAPE_PERIOD_S = 0.1
FLEET_MOVE_WAIT_S = 120.0
FLEET_COST_ROUNDS = 5
FLEET_COST_STEPS = {"imagenet": 256, "binary": 512}
FLEET_WIDTH_TENANTS = 12
FLEET_WIDTH_ROUNDS = 4
FLEET_RANK_STEPS = 8  # CTR batches each rank folds between two samples
FLEET_RANK_GUARD_S = 30.0
FLEET_HANG_TIMEOUT_S = 2.0
FLEET_CHILD_TIMEOUT_S = 240
FLEET_CLI_DURATION_S = 300
FLEET_NEVER_MINTED = "imagenet-0-000000000000-0"


def fleet_root() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "fleet")


def fleet_get(url: str) -> tuple:
    """(status, body) of one GET, whatever the status."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, resp.read().decode("utf-8")
    except urllib.error.HTTPError as err:
        return err.code, err.read().decode("utf-8")


def fleet_routes(trace_id: str, tenant: str = "ctr-0") -> list:
    """Every route of ``obs/server.py``'s ``ROUTES`` with the status it must answer: the
    planned 404s are an unknown tenant and a trace id that was never minted."""
    return [("/metrics", 200), (f"/metrics?tenant={tenant}", 200), ("/healthz", 200), ("/readyz", 200),
            ("/snapshot", 200), ("/memory", 200), ("/costs", 200), ("/alerts", 200), ("/tenants", 200),
            ("/leases", 200), ("/fleet", 200), ("/fleet/history", 200), ("/placement", 200), ("/profile", 200),
            ("/audit", 200), ("/traces", 200), (f"/trace/{trace_id}", 200), (f"/trace/{FLEET_NEVER_MINTED}", 404),
            ("/fleet?tenant=nope", 404)]


class FleetScraper:
    """A scraper thread that sweeps every route of :func:`fleet_routes` once per
    ``FLEET_SCRAPE_PERIOD_S`` (or as fast as the server answers), keeping the statuses
    it got beside the ones it expected. ``trace_id`` gives a live batch's trace id for
    ``/trace/<id>``, or ``None`` to leave that route out of the sweep."""

    def __init__(self, url: str, trace_id=None, tenant: str = "ctr-0"):
        import threading

        self.url, self.trace_id, self.tenant = url, trace_id or (lambda: None), tenant
        self.stop_event = threading.Event()
        self.counts, self.wrong, self.sweeps = {}, [], 0
        self.thread = threading.Thread(target=self._run, name="fleet-scraper", daemon=True)

    def _run(self) -> None:
        while not self.stop_event.is_set():
            t0 = time.monotonic()
            trace_id = self.trace_id()
            for route, want in fleet_routes(trace_id or "-", self.tenant):
                key = route
                if route == f"/trace/{trace_id or '-'}":
                    if not trace_id:  # no batch fed yet, or no lineage: nothing to look up
                        continue
                    key = "/trace/<id>"
                try:
                    status, _ = fleet_get(self.url + route)
                except Exception as err:  # noqa: BLE001 - reported, and fails the phase
                    status = repr(err)
                self.counts[key] = self.counts.get(key, 0) + 1
                if status != want:
                    self.wrong.append((route, status, want))
            self.sweeps += 1
            self.stop_event.wait(max(0.0, FLEET_SCRAPE_PERIOD_S - (time.monotonic() - t0)))

    def __enter__(self) -> "FleetScraper":
        self.thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop_event.set()
        self.thread.join(120)


class FleetMover:
    """The placement controller's ``mover``. The controller runs in a scrape thread (a
    ``/metrics`` scrape ticks it); the move itself (drain, checkpoint, restore, replay
    the tail) runs on the thread that drives the sessions, between two of its steps: the
    mover posts the request and waits for it to be done."""

    def __init__(self):
        import queue

        self.requests = queue.Queue()

    def __call__(self, tenant: str, from_host: str, to_host: str) -> bool:
        import threading

        done, box = threading.Event(), {}
        self.requests.put((tenant, from_host, to_host, done, box))
        if not done.wait(FLEET_MOVE_WAIT_S):
            return False
        if "error" in box:
            raise RuntimeError(box["error"])
        return True

    def serve(self, execute) -> int:
        """Run every pending move on this thread; returns how many ran."""
        import queue
        import traceback

        ran = 0
        while True:
            try:
                tenant, from_host, to_host, done, box = self.requests.get_nowait()
            except queue.Empty:
                return ran
            try:
                execute(tenant, from_host, to_host)
            except BaseException:  # noqa: BLE001 - handed to the controller, which counts it failed
                box["error"] = traceback.format_exc()
            done.set()
            ran += 1


def fleet_pools() -> dict:
    return {"imagenet": batches_of(*imagenet_data(n=FLEET_POOL["imagenet"] * 500, seed=31), 500),
            "binary": batches_of(*binary_data(n=FLEET_POOL["binary"] << 18, seed=32), 1 << 18)}


def fleet_stream(pools: dict, tenant: str, steps: int) -> list:
    """A tenant's batches: its set's pool from an offset of its own, cycled."""
    kind, _ = FLEET_TENANTS[tenant]
    pool = pools[kind]
    offset = 7 * list(FLEET_TENANTS).index(tenant)
    return [pool[(offset + k) % len(pool)] for k in range(steps)]


FLEET_METRICS = {"imagenet": imagenet_metrics, "binary": binary_metrics}


def fleet_graph_launches(pipes: list, replayed: bool = True) -> dict:
    """What the captured graphs of these pipelines launched: each variant's captured
    counts times its replays, or (``replayed=False``) once, as its capture's warm run
    launched them."""
    from torchmetrics_tpu_torch.core.jit import _Graph

    out = {}
    for pipe in pipes:
        for fn in (*pipe._fused_fns.values(), *pipe._step_fns.values()):
            for variant in fn._compiled.values():
                if isinstance(variant, _Graph):
                    for name, n in variant.launches.items():
                        out[name] = out.get(name, 0) + n * (variant.replays if replayed else 1)
    return out


def fleet_served_run(pools: dict, root: str) -> dict:
    """Part 1: eight tenant sessions on two virtual hosts, served, sampled and placed.

    The sessions (``MetricPipeline(fuse=8)``, tracing, lineage and the auditor on) are fed
    round-robin while an ``IntrospectionServer`` answers a scraper that sweeps every route;
    each ``/metrics`` scrape ticks the installed ``FleetSampler`` and
    ``PlacementController``, whose mover moves a tenant session through ``engine/migrate``
    between two steps of the feeding loop. Returns every session's final states."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch import fleet as placement
    from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig
    from torchmetrics_tpu_torch.engine.migrate import checkpoint_session, restore_session, verify_bundle
    from torchmetrics_tpu_torch.obs import alerts, audit, fleet, lineage, scope, server, trace
    from torchmetrics_tpu_torch.ops import kernels

    streams = {t: fleet_stream(pools, t, FLEET_STEPS) for t in FLEET_TENANTS}
    trace.enable()
    lineage.enable()
    auditor = audit.ConservationAuditor(cadence_seconds=0.5)
    audit.install_auditor(auditor)
    alerts.configure(fleet.imbalance_rule(for_seconds=0.0), audit.audit_violation_rule())
    sampler = fleet.FleetSampler(cadence_seconds=FLEET_SAMPLER_CADENCE_S, hosts=FLEET_HOSTS,
                                 placement={t: host for t, (_, host) in FLEET_TENANTS.items()})
    fleet.install_sampler(sampler)
    mover = FleetMover()
    controller = placement.PlacementController(
        placement.PlacementConfig(hosts=FLEET_HOSTS, cadence_seconds=FLEET_CONTROLLER_CADENCE_S,
                                  smoothing_windows=FLEET_SMOOTHING_WINDOWS), mover=mover)
    controller.seed({t: host for t, (_, host) in FLEET_TENANTS.items()})
    placement.install_controller(controller)
    sessions, cols, retired, restored, moves = {}, {}, [], [], []
    srv = server.IntrospectionServer(port=0).start()

    def execute(tenant: str, from_host: str, to_host: str) -> None:
        kind, _ = FLEET_TENANTS[tenant]
        t0 = time.perf_counter()
        pipe = sessions[tenant]
        tail = pipe.drain()
        bundle = os.path.join(root, "moves", f"{tenant}-{len(moves)}")
        checkpoint_session(pipe, bundle, tail=tail)
        verified = verify_bundle(bundle)
        status, body = fleet_get(srv.url + "/healthz")
        health = json.loads(body)
        pipe.close()
        retired.append(pipe)
        srv.unregister(cols[tenant])
        col = MetricCollection(FLEET_METRICS[kind]("cuda"))
        new, _ = restore_session(col, bundle)
        new.warmup(*streams[tenant][0])
        restored.append(new)
        sessions[tenant], cols[tenant] = new, col
        srv.register(col)
        moves.append({"tenant": tenant, "from": from_host, "to": to_host, "seconds": time.perf_counter() - t0,
                      "bundle_verified": bool(verified), "healthz": status, "health": health["status"],
                      "migrating": health["tenants_migrating"],
                      "named": tenant in health["tenants_degraded"] and tenant in health["tenants_migrating"]})

    latest = {"trace": None}
    try:
        for tenant, (kind, _) in FLEET_TENANTS.items():
            col = cols[tenant] = MetricCollection(FLEET_METRICS[kind]("cuda"))
            pipe = sessions[tenant] = MetricPipeline(col, PipelineConfig(fuse=PIPELINE_FUSE, tenant=tenant))
            pipe.warmup(*streams[tenant][0])
            srv.register(col)
        first_trace = sessions["imagenet-0"].trace_id_for(0)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with FleetScraper(srv.url, lambda: latest["trace"]) as scraper:
            for k in range(FLEET_STEPS):
                for tenant in FLEET_TENANTS:
                    sessions[tenant].feed(*streams[tenant][k])
                latest["trace"] = sessions["imagenet-0"].trace_id_for(k)
                mover.serve(execute)
            for pipe in sessions.values():
                pipe.flush()
            feed_s = time.perf_counter() - t0
            scraper.stop_event.set()
            while scraper.thread.is_alive():  # a tick in flight may still wait on a move
                mover.serve(execute)
                scraper.thread.join(0.02)
        torch.cuda.synchronize()
        loop_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        replayed = fleet_graph_launches([*sessions.values(), *retired])
        # the sessions restored in the loop captured their graphs there: one warm run each
        warm = fleet_graph_launches(restored, replayed=False)
        for name in COLLECTION_KERNELS:
            if launches.get(name, 0) != replayed.get(name, 0) + warm.get(name, 0) or not replayed.get(name):
                raise AssertionError(f"fleet_eval: {name} launched {launches.get(name, 0)}; the graphs' replays"
                                     f" account for {replayed.get(name, 0)} and the restored sessions' warm"
                                     f" runs for {warm.get(name, 0)}")
        # the last pages, with the loop stopped and every session flushed
        status, page = fleet_get(srv.url + "/metrics")
        families = {f: f in page for f in ("tm_tpu_fleet_imbalance", "tm_tpu_placement_assignments",
                                            "tm_tpu_server_request_seconds_bucket")}
        bad_lines = [line for line in page.splitlines() if line and not line.startswith("#")
                     and not re.fullmatch(r'[a-zA-Z_:][a-zA-Z0-9_:]*(\{.*\})? \S+', line)]
        for line in page.splitlines():
            if line and not line.startswith("#"):
                float(line.rsplit(" ", 1)[1])
        evicted_status, evicted_body = fleet_get(srv.url + f"/trace/{first_trace}")
        stats = srv.request_stats()
        auditor.tick(now=time.monotonic() + 10.0)
        report = auditor.report()
        ledger = obs_ledger(report)
        decisions = controller.report()["decisions"]
        states = {t: to_cpu(collection_states(cols[t])) for t in FLEET_TENANTS}
        placement_report = controller.report()
    finally:
        srv.stop()
        placement.install_controller(None)
        fleet.install_sampler(None)
        audit.install_auditor(None)
        alerts.uninstall()
        lineage.disable()
        trace.disable()
        trace.get_recorder().clear()
        for pipe in sessions.values():
            pipe.close()
        scope.reset()
    opened = [d for d in decisions if d["action"] == "episode-open"]
    closed = [d for d in decisions if d["action"] == "episode-close"]
    done = [d for d in decisions if d["action"] == "move"]
    failures = []
    if scraper.wrong:
        failures.append(f"routes answered {scraper.wrong[:5]} ({len(scraper.wrong)} wrong)")
    missing = [r for r in ("/trace/<id>" if r == "/trace/-" else r for r, _ in fleet_routes("-"))
               if r not in scraper.counts]
    if missing:
        failures.append(f"routes never scraped: {missing}")
    if status != 200 or not all(families.values()) or bad_lines:
        failures.append(f"/metrics: status {status}, families {families}, unparsed {bad_lines[:3]}")
    if evicted_status != 404 or "evicted" not in json.loads(evicted_body).get("lineage", {}):
        failures.append(f"/trace of the evicted first batch answered {evicted_status}")
    if not opened or opened[0]["imbalance"] <= controller.config.hysteresis_high:
        failures.append(f"the first episode opened at {opened[:1]}, not above {controller.config.hysteresis_high}")
    if not done or not all(d["ok"] for d in done) or placement_report["moves"]["failed"]:
        failures.append(f"moves {done}, failed {placement_report['moves']['failed']}")
    if not closed or closed[-1]["imbalance"] >= controller.config.hysteresis_low:
        failures.append(f"no episode closed below {controller.config.hysteresis_low}: {closed}")
    if len(moves) != placement_report["moves"]["completed"] or not all(
            m["bundle_verified"] and m["healthz"] == 200 and m["health"] == "degraded" and m["named"] for m in moves):
        failures.append(f"the moves' bundles and /healthz: {moves}")
    unbalanced = [t for t, row in ledger.items() if not row["balanced"]]
    if unbalanced or report["violations"]:
        failures.append(f"audit: unbalanced {unbalanced}, violations {report['violations']}")
    if failures:
        raise AssertionError("fleet_eval served run: " + "; ".join(failures))
    from torchmetrics_tpu_torch.obs import export

    latency = {route: {"count": row["count"], "p50_ms": 1e3 * export.histogram_quantile(row["buckets"], 0.5),
                       "p99_ms": 1e3 * export.histogram_quantile(row["buckets"], 0.99)}
               for route, row in sorted(stats.items())}
    return {"states": states, "record": {
        "tenants": {t: {"set": kind, "host": host, "final_host": placement_report["assignments"][t]["host"]}
                    for t, (kind, host) in FLEET_TENANTS.items()},
        "steps_per_tenant": FLEET_STEPS, "feed_s": feed_s, "loop_s": loop_s,
        "us_per_round": loop_s / FLEET_STEPS * 1e6, "sweeps": scraper.sweeps, "sweeps_per_s": scraper.sweeps / loop_s,
        "scrapes": scraper.counts,
        "scrape_latency": latency, "imbalance_opened": opened[0]["imbalance"],
        "imbalance_closed": closed[-1]["imbalance"], "convergence_s": closed[-1]["convergence_seconds"],
        "moves": [{k: m[k] for k in ("tenant", "from", "to", "seconds", "migrating")} for m in moves],
        "controller_move_s": [d["seconds"] for d in done], "episodes_closed": len(closed),
        "audit": {"tenants": len(ledger), "violations": 0,
                  "handed_off": sum(row["handed_off"] for row in ledger.values())},
        "launches": launches, "restored_capture_launches": warm, "replayed_launches": replayed,
    }}


def fleet_reference(pools: dict) -> dict:
    """Every tenant's batches through a plain ``MetricPipeline(fuse=8)``: no server, no
    sampler, no controller, no move."""
    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig

    out = {}
    for tenant, (kind, _) in FLEET_TENANTS.items():
        col = MetricCollection(FLEET_METRICS[kind]("cuda"))
        pipe = MetricPipeline(col, PipelineConfig(fuse=PIPELINE_FUSE))
        pipe.run(fleet_stream(pools, tenant, FLEET_STEPS))
        pipe.close()
        out[tenant] = to_cpu(collection_states(col))
        del pipe, col
        release_graphs()
    return out


def fleet_plane_cost(pools: dict) -> dict:
    """µs per fused step of one ImageNet and one CTR session with the fleet plane on
    (server, sampler, placement controller, the scraper sweeping every route) against
    all off, in turns (off, on, off, ...) over one captured pipeline per set: the
    median, the range and the median of each round's difference from its own ``off``
    pass."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch import fleet as placement
    from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig
    from torchmetrics_tpu_torch.obs import fleet, scope, server

    out = {}
    for kind, tenant in (("imagenet", "imagenet-0"), ("binary", "ctr-0")):
        pool = pools[kind]
        batches = [pool[k % len(pool)] for k in range(FLEET_COST_STEPS[kind])]
        col = MetricCollection(FLEET_METRICS[kind]("cuda"))
        pipe = MetricPipeline(col, PipelineConfig(fuse=PIPELINE_FUSE, tenant=tenant))
        pipe.warmup(*batches[0])
        times = {"off": [], "on": []}
        for _ in range(FLEET_COST_ROUNDS):
            for planes in times:
                srv, scraper = None, contextlib.nullcontext()
                if planes == "on":
                    sampler = fleet.FleetSampler(cadence_seconds=FLEET_SAMPLER_CADENCE_S, hosts=FLEET_HOSTS,
                                                 placement={tenant: FLEET_HOSTS[0]})
                    fleet.install_sampler(sampler)
                    controller = placement.PlacementController(
                        placement.PlacementConfig(hosts=FLEET_HOSTS, cadence_seconds=FLEET_CONTROLLER_CADENCE_S))
                    controller.seed({tenant: FLEET_HOSTS[0]})
                    placement.install_controller(controller)
                    srv = server.IntrospectionServer([col], port=0).start()
                    scraper = FleetScraper(srv.url, tenant=tenant)
                torch.cuda.synchronize()
                try:
                    with scraper:
                        t0 = time.perf_counter()
                        pipe.run(batches)
                        torch.cuda.synchronize()
                        times[planes].append((time.perf_counter() - t0) / len(batches) * 1e6)
                finally:
                    if srv is not None:
                        srv.stop()
                    placement.install_controller(None)
                    fleet.install_sampler(None)
                if planes == "on" and scraper.wrong:
                    raise AssertionError(f"fleet_eval cost pass: routes answered {scraper.wrong[:5]}")
        pipe.close()
        del pipe, col
        scope.reset()
        release_graphs()
        out[kind] = {"steps": len(batches), "us_per_step": times,
                     "median_us": {k: statistics.median(v) for k, v in times.items()},
                     "range_us": {k: [min(v), max(v)] for k, v in times.items()},
                     "median_delta_us": statistics.median(x - off for x, off in zip(times["on"], times["off"]))}
    return out


def fleet_width_check(pools: dict) -> dict:
    """Part 3: a 12-tenant CTR ``TenantMultiplexer`` adopts the controller's proposed
    ladder through ``retune_width_buckets``; its fused states must be bitwise those of
    the same multiplexer with the default ladder."""
    import torch

    from torchmetrics_tpu_torch import MetricCollection
    from torchmetrics_tpu_torch import fleet as placement
    from torchmetrics_tpu_torch.engine import MuxConfig, TenantMultiplexer
    from torchmetrics_tpu_torch.obs import scope

    controller = placement.PlacementController(placement.PlacementConfig(hosts=FLEET_HOSTS))
    tenants = [f"ctr-w{j}" for j in range(FLEET_WIDTH_TENANTS)]
    for t in tenants:
        controller.assign(t)
    proposed = controller.propose_width_buckets(64)
    if proposed != (1, 2, 4, 8, 16):
        raise AssertionError(f"fleet_eval: {FLEET_WIDTH_TENANTS} tenants proposed the ladder {proposed}")
    preds = torch.cat([p for p, _ in pools["binary"]])
    target = torch.cat([t for _, t in pools["binary"]])
    runs = {}
    for name, ladder in (("default", None), ("proposed", proposed)):
        mux = TenantMultiplexer(lambda: MetricCollection(binary_metrics("cuda")), MuxConfig(max_width=64))
        adopted = mux.retune_width_buckets(ladder) if ladder is not None else mux.config.buckets()
        for r in range(FLEET_WIDTH_ROUNDS):
            for j, t in enumerate(tenants):
                mux.feed(t, *mux_slice(preds, target, r * FLEET_WIDTH_TENANTS + j))
        mux.flush()
        info, report = mux.cache_info(), mux.report()
        runs[name] = {"ladder": list(adopted), "captured_variants": info["compiled_variants"],
                      "replays": info["replays"], "padded_rows": report.padded_rows,
                      "states": {t: to_cpu(collection_states(mux.metric(t))) for t in tenants}}
        mux.close()
        del mux
        scope.reset()
        release_graphs()
    differ = [t for t in tenants if not bitwise_equal(list(flatten_values(runs["proposed"]["states"][t])),
                                                      list(flatten_values(runs["default"]["states"][t])))]
    if differ:
        raise AssertionError(f"fleet_eval: the retuned multiplexer's states differ for {differ}")
    return {"proposed": list(proposed), "tenants": FLEET_WIDTH_TENANTS, "rounds": FLEET_WIDTH_ROUNDS,
            **{name: {k: v for k, v in run.items() if k != "states"} for name, run in runs.items()}}


def fleet_rank(rank: int, port: int, cfg: dict, release, queue) -> None:
    """Part 2: one rank of a two-rank gloo world on cuda:0, each with its own CTR tenant
    session, ``FleetSampler`` and ``IntrospectionServer``. Two clean samples; rank 0's
    ``/fleet`` must show both hosts and the rate table. Then rank 1 stops answering:
    rank 0's next sample must be degraded within the guard's timeout with
    ``missing_hosts`` naming rank 1, and its ``/healthz`` must answer degraded, not
    dead. No collective follows the abandoned one: the ranks leave with ``os._exit``."""
    import datetime
    import traceback

    code = 0
    try:
        import torch
        import torch.distributed as dist

        from torchmetrics_tpu_torch import MetricCollection
        from torchmetrics_tpu_torch.engine import MetricPipeline, PipelineConfig
        from torchmetrics_tpu_torch.obs import fleet, server, trace
        from torchmetrics_tpu_torch.robust import sync_guard

        trace.enable()  # a degraded aggregation is counted on the recorder, which /healthz reads
        torch.cuda.set_device(0)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=2,
                                timeout=datetime.timedelta(seconds=120))
        tenant = f"ctr-r{rank}"
        col = MetricCollection(binary_metrics("cuda"))
        pipe = MetricPipeline(col, PipelineConfig(fuse=PIPELINE_FUSE, tenant=tenant))
        preds, target = binary_data(n=2 * cfg["steps"] << 18, seed=40 + rank)
        batches = batches_of(preds, target, 1 << 18)
        sampler = fleet.FleetSampler(cadence_seconds=3600.0)
        fleet.install_sampler(sampler)
        srv = server.IntrospectionServer([col], port=0).start()
        out = {"rank": rank}
        for half in range(2):
            pipe.run(batches[half * cfg["steps"]:(half + 1) * cfg["steps"]])
            dist.barrier()
            with sync_guard(cfg["guard_s"], 0):
                sample = sampler.sample()
            out[f"clean_{half}"] = {"degraded": sample["degraded"], "missing_hosts": sample["missing_hosts"]}
        if rank == 0:
            status, body = fleet_get(srv.url + "/fleet")
            page = json.loads(body)
            out["fleet"] = {"status": status, "hosts": sorted(row["process_index"] for row in page["hosts"]),
                            "tenants": {t: row["updates_per_second"] for t, row in page["tenants"].items()},
                            "rate_hosts": sorted(page["skew"]["hosts"])}
        dist.barrier()
        if rank == 1:
            release.wait(cfg["child_timeout_s"])  # stops answering: no further sample
        else:
            t0 = time.perf_counter()
            with sync_guard(cfg["hang_timeout_s"], 0), warnings.catch_warnings():
                warnings.simplefilter("ignore")
                sample = sampler.sample()
            out["hung"] = {"seconds": time.perf_counter() - t0, "degraded": sample["degraded"],
                           "missing_hosts": sample["missing_hosts"]}
            status, body = fleet_get(srv.url + "/healthz")
            health = json.loads(body)
            out["healthz"] = {"status": status, "health": health["status"], "reasons": health["reasons"]}
            status, body = fleet_get(srv.url + "/fleet")
            out["fleet_after"] = {"status": status, "degraded": json.loads(body)["sampler"]["degraded"],
                                  "missing_hosts": json.loads(body)["sampler"]["missing_hosts"]}
        srv.stop()
        queue.put(("rank", out, None))
    except BaseException:
        queue.put(("rank", None, traceback.format_exc()))
        code = 1
    finally:
        if rank == 0:
            release.set()
        queue.close()
        queue.join_thread()
        os._exit(code)


def fleet_start_children() -> tuple:
    """Start the two ranks of part 2 and the demo CLI of part 4; they run while the
    parent serves its fleet."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results, release = ctx.Queue(), ctx.Event()
    cfg = {"steps": FLEET_RANK_STEPS, "guard_s": FLEET_RANK_GUARD_S,
           "hang_timeout_s": FLEET_HANG_TIMEOUT_S, "child_timeout_s": FLEET_CHILD_TIMEOUT_S}
    port = free_port()
    procs = [ctx.Process(target=fleet_rank, args=(rank, port, cfg, release, results)) for rank in range(2)]
    for proc in procs:
        proc.start()
    root = os.path.dirname(os.path.abspath(__file__))
    cli = subprocess.Popen(
        [sys.executable, "-m", "torchmetrics_tpu_torch.obs.serve", "--demo", "--port", "0", "--duration",
         str(FLEET_CLI_DURATION_S)],
        cwd=root, env={**os.environ, "PYTHONPATH": root}, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    return procs, results, release, cli


def fleet_join_ranks(procs: list, results) -> dict:
    import queue as queue_mod

    got = {}
    deadline = time.monotonic() + FLEET_CHILD_TIMEOUT_S
    try:
        while len(got) < len(procs):
            if time.monotonic() > deadline:
                raise AssertionError(f"fleet_eval: a rank hung ({len(got)} of {len(procs)} reported)")
            try:
                _, result, error = results.get(timeout=1)
            except queue_mod.Empty:
                dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise AssertionError(f"fleet_eval: a rank exited with {dead} before it reported")
                continue
            if error is not None:
                raise AssertionError(f"fleet_eval: a rank failed:\n{error}")
            got[result["rank"]] = result
        for proc in procs:
            proc.join(timeout=max(1.0, deadline - time.monotonic()))
            if proc.exitcode != 0:
                raise AssertionError(f"fleet_eval: a rank ended with exit code {proc.exitcode}")
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
    r0 = got[0]
    for rank, r in got.items():
        if any(r[f"clean_{h}"]["degraded"] for h in range(2)):
            raise AssertionError(f"fleet_eval rank {rank}: a clean sample degraded: {r}")
    fleet_page = r0["fleet"]
    if fleet_page["status"] != 200 or fleet_page["hosts"] != [0, 1] or fleet_page["rate_hosts"] != ["0", "1"] \
            or sorted(fleet_page["tenants"]) != ["ctr-r0", "ctr-r1"] \
            or not all(v > 0 for v in fleet_page["tenants"].values()):
        raise AssertionError(f"fleet_eval rank 0's /fleet: {fleet_page}")
    hung, health = r0["hung"], r0["healthz"]
    if not hung["degraded"] or hung["missing_hosts"] != [1] or hung["seconds"] > FLEET_HANG_TIMEOUT_S + 5.0:
        raise AssertionError(f"fleet_eval rank 0's sample with rank 1 silent: {hung}")
    if health["status"] != 200 or health["health"] != "degraded" or \
            not any("degraded telemetry aggregation" in reason for reason in health["reasons"]):
        raise AssertionError(f"fleet_eval rank 0's /healthz with rank 1 silent: {health}")
    if not r0["fleet_after"]["degraded"] or r0["fleet_after"]["missing_hosts"] != [1]:
        raise AssertionError(f"fleet_eval rank 0's /fleet with rank 1 silent: {r0['fleet_after']}")
    return {"fleet": fleet_page, "degraded_sample_s": hung["seconds"], "guard_timeout_s": FLEET_HANG_TIMEOUT_S,
            "missing_hosts": hung["missing_hosts"], "healthz": health["health"]}


def fleet_check_cli(cli) -> dict:
    """Part 4: the demo CLI's URL from its output, then its four routes."""
    lines = []
    try:
        for line in cli.stdout:
            lines.append(line)
            if line.startswith("conservation audit:"):
                break
        text = "".join(lines)
        url = re.search(r"introspection on (http://\S+)", text)
        trace_id = re.search(r"batch lineage: curl -s \S+/trace/(\S+)", text)
        if url is None or trace_id is None or "demo metrics unavailable" in text:
            raise AssertionError(f"fleet_eval: the demo CLI printed:\n{text}")
        url = url.group(1)
        out = {}
        status, body = fleet_get(url + "/tenants")
        out["tenants"] = sorted(row["tenant"] for row in json.loads(body)["tenants"])
        status_a, body = fleet_get(url + "/alerts")
        out["firing"] = sorted({(a["rule"], a.get("tenant")) for a in json.loads(body)["firing"]})
        status_t, body = fleet_get(url + f"/trace/{trace_id.group(1)}")
        page = json.loads(body)
        out["trace"] = {"found": page.get("found"), "tenant": (page.get("record") or {}).get("tenant"),
                        "alerts": sorted({a["rule"] for a in page.get("alerts", [])})}
        status_d, body = fleet_get(url + "/audit")
        out["violations"] = [(v["invariant"], v["tenant"]) for v in json.loads(body)["violations"]]
    finally:
        cli.terminate()
        try:
            _, err = cli.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            cli.kill()
            _, err = cli.communicate()
    if (status, status_a, status_t, status_d) != (200, 200, 200, 200) or \
            not {"tenant-a", "tenant-b"} <= set(out["tenants"]) or ("non_finite", "tenant-b") not in out["firing"] \
            or out["trace"] != {"found": True, "tenant": "tenant-b", "alerts": ["non_finite"]} or \
            out["violations"] != [("exec_reconcile", "tenant-b")]:
        raise AssertionError(f"fleet_eval: the demo CLI answered {out} (statuses {status}, {status_a}, {status_t},"
                             f" {status_d}); stderr:\n{err[-2000:]}")
    return out


def fleet_eval_phase() -> dict:
    """The fleet plane and the live endpoints on the main path: a served, sampled and
    rebalanced fleet of eight tenant sessions (part 1) beside the same batches unserved;
    meanwhile two spawned gloo ranks (part 2) and the demo CLI (part 4); then the
    width-bucket proposal through a 12-tenant multiplexer (part 3) and the plane's cost
    per fused step."""
    import shutil

    root = fleet_root()
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    # ``release`` stays referenced until the ranks are joined: they rebuild its semaphore
    procs, results, release, cli = fleet_start_children()
    try:
        pools = fleet_pools()
        served = fleet_served_run(pools, root)
        reference = fleet_reference(pools)
        differ = [t for t in FLEET_TENANTS if not bitwise_equal(list(flatten_values(served["states"][t])),
                                                               list(flatten_values(reference[t])))]
        if differ:
            raise AssertionError(f"fleet_eval: served states differ from the unserved run for {differ}")
        ranks = fleet_join_ranks(procs, results)
        del release
        demo = fleet_check_cli(cli)
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
        if cli.poll() is None:
            cli.kill()
            cli.communicate()
        shutil.rmtree(root, ignore_errors=True)
    width = fleet_width_check(pools)
    cost = fleet_plane_cost(pools)
    record = served["record"]
    launches = record.pop("launches")
    return {"phase": "fleet_eval", "served": {**record, "bitwise_unserved": True}, "ranks": ranks, "width": width,
            "cli": demo, "plane_cost": cost, "launches": launches}


# -------------------------------------------------------------------------- chaos

CHAOS_SEED = 0
CHAOS_TENANTS = 8
CHAOS_HIGH_TENANTS = 64
CHAOS_FLASH_TENANTS = 12
# the default scenario again at ImageNet width, then its CPU twin
CHAOS_WIDE = {"seed": 0, "tenants": 8, "num_classes": 1000, "batch_sizes": (256, 500)}
CHAOS_MSE_RTOL = 1e-6
CHAOS_TIME_KEYS = ("migration_seconds", "recovery_seconds", "time_to_detect_seconds", "time_to_failover_seconds",
                   "time_to_detect_imbalance_seconds")


def chaos_scenarios() -> list:
    """(name, schedule config, replay configs, spec factory, prefix) of the seven scenarios,
    as the JAX package's ``bench.py --chaos`` runs them; a flash crowd's control arm first."""
    from torchmetrics_tpu_torch import chaos

    default = chaos.ScheduleConfig(seed=CHAOS_SEED, tenants=CHAOS_TENANTS)
    return [
        ("default", default, [{}], chaos.SLOSpec, "chaos"),
        ("high_tenant", chaos.high_tenant_config(seed=CHAOS_SEED, tenants=CHAOS_HIGH_TENANTS),
         [{"multiplex": True, "mux_max_width": CHAOS_HIGH_TENANTS}], chaos.high_tenant_slo_spec, "chaos_ht"),
        ("rolling_deploy", default, [{"rolling_deploy": True}], chaos.rolling_deploy_slo_spec, "chaos_rd"),
        ("host_crash", default, [{"host_crash": True}], chaos.host_crash_slo_spec, "chaos_hc"),
        ("hung_host", default, [{"hung_host": True}], chaos.hung_host_slo_spec, "chaos_hh"),
        ("skewed_load", chaos.skewed_load_config(seed=CHAOS_SEED, tenants=CHAOS_TENANTS), [{"skewed_load": True}],
         chaos.skewed_load_slo_spec, "chaos_sk"),
        ("flash_crowd", chaos.flash_crowd_config(seed=CHAOS_SEED, tenants=CHAOS_FLASH_TENANTS),
         [{"flash_crowd": True, "placement_enabled": False}, {"flash_crowd": True}], chaos.flash_crowd_slo_spec,
         "chaos_fc"),
    ]


def chaos_replay(schedule, device: str = "cuda", **config) -> tuple:
    """``chaos.replay`` of ``schedule`` on ``device``, with the tenants' metrics as the run
    left them (read through the replay's tenant factory)."""
    import importlib

    replay_mod = importlib.import_module("torchmetrics_tpu_torch.chaos.replay")
    built = {}
    original = replay_mod._build_tenants

    def build(*args, **kwargs):
        out = original(*args, **kwargs)
        built["metrics"] = out[0]
        return out

    replay_mod._build_tenants = build
    try:
        result = replay_mod.replay(schedule, replay_mod.ReplayConfig(device=device, **config))
    finally:
        replay_mod._build_tenants = original
    return result, built["metrics"]


def chaos_summary(name: str, result: dict, report: dict, launches: dict, seconds: float) -> dict:
    """One scenario's line: throughput, SLOs, server-side scrape quantiles per route, time
    to fire and resolve, captured variants and capture seconds, the recovery walls, the
    kernel launches."""
    from torchmetrics_tpu_torch.obs.export import histogram_quantile

    scrape = {route: {"count": hist.get("count"), "p95_s": histogram_quantile(hist["buckets"], 0.95),
                      "p99_s": histogram_quantile(hist["buckets"], 0.99)}
              for route, hist in sorted((result["scrapes"].get("server") or {}).items()) if hist.get("buckets")}
    rows = {row["slo"]: row["value"] for row in report["slos"]}
    placement = result.get("placement") or {}
    return {
        "scenario": name, "seconds": seconds, "wall_s": result["wall_seconds"],
        "updates_per_s": result["updates_per_second"], "batches_fed": result["batches_fed"],
        "slos_passed": report["n_slos"] - len(report["failed"]), "slos_failed": report["failed"],
        "scrape": scrape,
        "scrape_max_s": {route: stats.get("max_seconds")
                         for route, stats in sorted((result["scrapes"].get("driver") or {}).items())},
        "move_s": [row.get("seconds") for row in (placement.get("report") or {}).get("decisions", [])
                   if row.get("action") == "move"],
        "time_to": {k: v for k, v in rows.items() if k.startswith(("time_to_fire", "time_to_resolve"))},
        "captured_variants": result["cost"]["compiled_variants"], "capture_s": result["cost"]["compile_seconds"],
        "moves": placement.get("moves_completed"), "post_shift_moves": placement.get("post_shift_moves"),
        "convergence_s": placement.get("convergence_seconds"),
        "throughput_ratio": rows.get("placement_throughput_ratio"),
        **{key: rows.get(key) for key in CHAOS_TIME_KEYS},
        "launches": launches,
    }


def chaos_events(result: dict) -> dict:
    """What two runs of one schedule must share: faults, named poisoned batches, alert
    episodes that fired and resolved, quarantines and degraded syncs."""
    return {
        "batches_fed": result["batches_fed"],
        "faults": [(f["fault"], f["tenant"], f.get("batch_index")) for f in result["faults"]],
        "named": sorted({(d["tenant"], i) for d in result["flight"]["dumps"] for i in d["poisoned_batches"]}),
        "episodes": sorted({(e["rule"], e["tenant"]) for e in result["alerts"]["episodes"]
                            if e.get("fired_at") is not None and e.get("resolved_at") is not None}),
        "robust": result["robust"],
    }


def chaos_states_equal(card: dict, cpu: dict, victim: str) -> dict:
    """Every tenant's final state and value, card against CPU: the victim's MSE sums within
    1e-6 relative, everything else (counts, buffers) bitwise."""
    import torch

    checked = {}
    for tenant in sorted(card):
        got = {**card[tenant].state_dict(persistent_only=False), "value": card[tenant].compute()}
        want = {**cpu[tenant].state_dict(persistent_only=False), "value": cpu[tenant].compute()}
        if sorted(got) != sorted(want):
            raise AssertionError(f"chaos_eval: {tenant}'s states differ in keys: {sorted(got)} / {sorted(want)}")
        for key in got:
            g, w = torch.as_tensor(got[key]).cpu(), torch.as_tensor(want[key]).cpu()
            if tenant == victim and g.is_floating_point():
                ok = g.shape == w.shape and torch.allclose(g, w, rtol=CHAOS_MSE_RTOL, atol=0.0, equal_nan=True)
            else:
                ok = bitwise_equal(g, w)
            if not ok:
                raise AssertionError(f"chaos_eval: {tenant}.{key} on the card {g} differs from the CPU's {w}")
        checked[tenant] = type(card[tenant]).__name__
    return checked


def chaos_eval_phase() -> dict:
    """The chaos plane on the card: the seven scenarios of the JAX package's
    ``bench.py --chaos``, each judged by its SLO spec, then the default scenario at
    ImageNet width against its CPU twin."""
    import torch

    from torchmetrics_tpu_torch import chaos
    from torchmetrics_tpu_torch.ops import kernels

    scenarios, failed = [], {}
    for name, schedule_config, configs, spec_fn, prefix in chaos_scenarios():
        schedule = chaos.generate(schedule_config)
        arms = []
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        for config in configs:
            arms.append(chaos_replay(schedule, **config)[0])
        torch.cuda.synchronize()
        launches = {kernel: kernels.LAUNCHES.get(kernel, 0) for kernel in KERNEL_SOURCES}
        result = arms[-1]
        if len(arms) == 2:  # the flash crowd's controller-off control arm, as bench.py joins it
            control = arms[0]
            result["placement"]["control_arm_updates_per_second"] = control["updates_per_second"]
            result["placement"]["control_arm"] = {
                "batches_fed": control["batches_fed"], "wall_seconds": control["wall_seconds"],
                "sleep_seconds": control["sleep_seconds"], "compile_seconds": control["cost"]["compile_seconds"],
                "updates_per_second": control["updates_per_second"]}
        report = chaos.judge(result, spec_fn(), prefix=prefix)
        summary = chaos_summary(name, result, report, launches, time.perf_counter() - t0)
        emit({"phase": "chaos_eval", **summary})
        scenarios.append(summary)
        if not report["passed"]:
            failed[name] = report

    # the default scenario at ImageNet width on the card, then the same schedule on the CPU
    schedule = chaos.generate(chaos.ScheduleConfig(**CHAOS_WIDE))
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    card, card_metrics = chaos_replay(schedule)
    torch.cuda.synchronize()
    launches = {kernel: kernels.LAUNCHES.get(kernel, 0) for kernel in KERNEL_SOURCES}
    report = chaos.judge(card, chaos.SLOSpec(), prefix="chaos")
    wide = chaos_summary("default_imagenet_width", card, report, launches, time.perf_counter() - t0)
    emit({"phase": "chaos_eval", **wide})
    scenarios.append(wide)
    if not report["passed"]:
        failed["default_imagenet_width"] = report
    t0 = time.perf_counter()
    cpu, cpu_metrics = chaos_replay(schedule, device="cpu")
    cpu_s = time.perf_counter() - t0
    if chaos_events(card) != chaos_events(cpu):
        raise AssertionError(f"chaos_eval: the card's ImageNet-width run {chaos_events(card)} differs from the"
                             f" CPU's {chaos_events(cpu)}")
    checked = chaos_states_equal(card_metrics, cpu_metrics, schedule.victim)
    if failed:
        # the failed rows last, so that the end of the output names them
        rows = [f"  {name}: {row['slo']} value={row['value']} threshold={row['threshold']} {row['detail']}"
                for name, failed_report in failed.items() for row in failed_report["slos"] if not row["passed"]]
        raise AssertionError("chaos_eval: SLOs failed on the card:\n"
                             + "\n".join(chaos.format_report(r) for r in failed.values())
                             + "\nthe failed SLOs:\n" + "\n".join(rows))
    total = {kernel: sum(s["launches"][kernel] for s in scenarios) for kernel in KERNEL_SOURCES}
    return {"phase": "chaos_eval", "scenarios": {s["scenario"]: {k: s[k] for k in (
                "wall_s", "updates_per_s", "batches_fed", "slos_passed", "captured_variants", "capture_s")}
                for s in scenarios},
            "imagenet_width": {"events": chaos_events(card), "tenants_equal_cpu": checked, "cpu_replay_s": cpu_s},
            "launches": total}


# --------------------------------------------------------------------------- main


# ------------------------------------------------------------------ model-based image

# FID-10k at CIFAR-10's shape (Krizhevsky 2009; FID over the 10,000 test images against
# 10,000 generated ones, the protocol of the GAN literature's CIFAR-10 tables),
# synthesized from seeds: 10,000 "real" and 10,000 "generated" uint8 images of 3 x 32 x
# 32 (low-frequency fields plus pixel noise, the generated set with another seed and
# more contrast), batches of 200, resized to 299^2 by the extractor. The networks run
# at their published widths on seeded random weights (no checkpoint is in the repo):
# the FID Inception-v3 from ``torch.Generator`` seed 0, the LPIPS backbones He-normal
# from seeds 1-3 written as torchvision ``.pth`` files and converted with
# ``convert_lpips_backbone``; the LPIPS heads are the repo's.
FID10K_IMAGES = 10_000
FID10K_BATCH = 200
CIFAR_SHAPE = (3, 32, 32)
# IS, KID and MiFID on the first 2,000 images of each set, each through its own extractor
SUBSET_IMAGES = 2_000
KID_SUBSETS, KID_SUBSET_SIZE, IS_SPLITS = 100, 1000, 10
# LPIPS (Zhang et al., CVPR 2018) at 256^2: 1,000 pairs in batches of 50 per backbone
LPIPS_PAIRS, LPIPS_BATCH, LPIPS_SIZE = 1_000, 50, 256
LPIPS_NETS = ("alex", "vgg", "squeeze")
LPIPS_HINTS = {"alex": "alexnet-owt-random.pth", "vgg": "vgg16-random.pth", "squeeze": "squeezenet1_1-random.pth"}
# perceptual path length with JAX's defaults (10,000 samples, batch 128, epsilon 1e-4,
# lerp, resize 64, VGG LPIPS) over a seeded stand-in generator: a 512-wide latent
# through a fixed random map to 3 x 32 x 32, upsampled to 3 x 256 x 256, tanh
PPL_LATENT, PPL_IMAGE = 512, 256
# CPU twins: 16 + 16 images for the Inception family (KID with subsets of 8), 4 pairs a
# LPIPS net, 8 PPL samples; the bounds are the parity tests' (tests/test_torch_inception.py,
# test_torch_lpips.py, test_torch_perceptual_path_length.py)
MODEL_CPU_IMAGES = 16
LPIPS_CPU_PAIRS = 4
PPL_CPU_SAMPLES = 8
MODEL_STATE_TOL = 1e-4  # the FID states: within 1e-4 of each state's largest magnitude
MODEL_SCORE_RTOL = 1e-3  # FID, IS, KID, MiFID from the net
LPIPS_TWIN_RTOL = 1e-5
PPL_TWIN_RTOL = 1e-2  # epsilon 1e-4 divides each distance by 1e-8
# a kernel name that would mean a convolution on cuDNN or a TF32 product
# the card (a rehearsal on the CPU sets "cpu")
MODEL_DEVICE = "cuda"
CONV_OR_TF32_MARKS = ("cudnn", "tf32", "implicit_convolve", "fprop", "dgrad", "wgrad", "conv2d", "convolution")


def model_image_root() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "model_image")


def cifar10_sets(seed: int = 101, device: str = "") -> tuple:
    """FID10K_IMAGES real and generated uint8 images of CIFAR_SHAPE, made on ``device``."""
    import torch
    import torch.nn.functional as F

    device = device or MODEL_DEVICE

    def one(g, contrast: float):
        base = torch.rand(FID10K_IMAGES, 3, 8, 8, generator=g, device=device)
        smooth = F.interpolate(base, size=CIFAR_SHAPE[1:], mode="bilinear", align_corners=False)
        noise = torch.rand(FID10K_IMAGES, *CIFAR_SHAPE, generator=g, device=device) - 0.5
        return ((smooth - 0.5) * contrast + 0.5 + 0.2 * noise).clamp(0, 1).mul(255).to(torch.uint8)

    return (one(torch.Generator(device=device).manual_seed(seed), 1.0),
            one(torch.Generator(device=device).manual_seed(seed + 1), 1.4))


def lpips_pairs(batch_index: int, n: int = 0, device: str = "") -> tuple:
    """Batch ``batch_index`` of the LPIPS pairs: images in [-1, 1] and their distortions."""
    import torch

    device, n = device or MODEL_DEVICE, n or LPIPS_BATCH
    g = torch.Generator(device=device).manual_seed(700 + batch_index)
    img1 = torch.rand(n, 3, LPIPS_SIZE, LPIPS_SIZE, generator=g, device=device) * 2 - 1
    img2 = (img1 + 0.3 * torch.randn(n, 3, LPIPS_SIZE, LPIPS_SIZE, generator=g, device=device)).clamp(-1, 1)
    return img1, img2


def lpips_backbone_files(root: str) -> dict:
    """Seeded random torchvision-layout backbones as ``.pth`` files, converted to
    ``{net}.npz`` by the port's converter; the seconds it took."""
    import torch

    from torchmetrics_tpu_torch.convert import convert_lpips_backbone
    from torchmetrics_tpu_torch.functional.image._lpips_backbones import LpipsPyramid

    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    paths = {}
    for seed, net in enumerate(LPIPS_NETS, start=1):
        pth = os.path.join(root, LPIPS_HINTS[net])
        torch.save(LpipsPyramid(net).init_random(torch.Generator().manual_seed(seed)).state_dict(), pth)
        paths[net] = convert_lpips_backbone(pth, net, os.path.join(root, f"{net}.npz"))
    return {"paths": paths, "seconds": time.perf_counter() - t0}


class PPLGenerator:
    """The seeded stand-in generator of the PPL loop: latents drawn on the host from
    ``seed`` (so the card and its CPU twin see the same ones), images made on ``device``."""

    def __init__(self, device: str, seed: int = 0) -> None:
        import torch

        self.device = torch.device(device)
        self.g = torch.Generator().manual_seed(seed)
        w = torch.randn(PPL_LATENT, 3 * 32 * 32, generator=torch.Generator().manual_seed(1000)) / PPL_LATENT ** 0.5
        self.w = w.to(self.device)

    def sample(self, n: int):
        import torch

        return torch.randn(n, PPL_LATENT, generator=self.g).to(self.device)

    def __call__(self, z):
        import torch
        import torch.nn.functional as F

        from torchmetrics_tpu_torch.utils.compute import _matmul_full_float32

        x = _matmul_full_float32(z, self.w).reshape(-1, 3, 32, 32)
        return torch.tanh(F.interpolate(x, size=(PPL_IMAGE, PPL_IMAGE), mode="bilinear", align_corners=False))


def model_kernel_profile(fn, warm: bool = True) -> dict:
    """torch.profiler over one call of ``fn`` (after a warm one): wall and device ms,
    the busy share, device ms by kernel kind (im2col, products, pools, concatenation,
    gathers and upsampling, elementwise: batch norm, ReLU and the rest), the top kernels,
    and any kernel whose name marks a cuDNN convolution or a TF32 product."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_kernel = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[e.key] = us

    def kind(name: str) -> str:
        low = name.lower()
        if "im2col" in low:
            return "im2col"
        if any(m in low for m in ("gemm", "xmma", "cutlass", "gemv")):
            return "products"
        if "pool" in low:
            return "pools"
        if "catarray" in low or "cat_" in low:
            return "concatenation"
        if any(m in low for m in ("index", "gather", "upsample")):
            return "gathers_and_upsampling"
        if "reduce" in low:
            return "reductions"
        return "elementwise"

    kinds = {}
    for name, us in by_kernel.items():
        kinds[kind(name)] = kinds.get(kind(name), 0.0) + us / 1e3
    total = sum(by_kernel.values()) / 1e3
    return {"wall_ms": wall * 1e3, "device_ms": total, "device_busy_share": total / (wall * 1e3) if wall else None,
            "device_ms_by_kind": dict(sorted(kinds.items(), key=lambda kv: -kv[1])),
            "top_kernels": [{"name": k[:90], "ms": us / 1e3}
                            for k, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:6]],
            "conv_or_tf32_kernels": sorted(k for k in by_kernel if any(m in k.lower() for m in CONV_OR_TF32_MARKS))}


def timed_updates(metric, batches, **kwargs) -> list:
    """Seconds of each ``metric.update(batch, **kwargs)``, each ending in a synchronise."""
    import torch

    seconds = []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metric.update(*batch, **kwargs) if isinstance(batch, tuple) else metric.update(batch, **kwargs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return seconds


def _rel_gap(got, want) -> float:
    got, want = float(got), float(want)
    return abs(got - want) / max(abs(want), 1e-30)


def inception_family(real, fake) -> dict:
    """FID-10k, then IS, KID and MiFID on the first SUBSET_IMAGES of each set."""
    import numpy as np
    import torch

    from torchmetrics_tpu_torch.image import (
        FrechetInceptionDistance,
        InceptionScore,
        KernelInceptionDistance,
        MemorizationInformedFrechetInceptionDistance,
    )
    from torchmetrics_tpu_torch.utils.compute import IM2COL_CHUNK_BYTES

    out = {}
    t0 = time.perf_counter()
    fid = FrechetInceptionDistance(feature=2048, device=MODEL_DEVICE)
    construct_s = time.perf_counter() - t0
    batches = [real[i:i + FID10K_BATCH] for i in range(0, FID10K_IMAGES, FID10K_BATCH)]
    fakes = [fake[i:i + FID10K_BATCH] for i in range(0, FID10K_IMAGES, FID10K_BATCH)]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    first = timed_updates(fid, batches[:1], real=True)
    seconds = timed_updates(fid, batches[1:], real=True) + timed_updates(fid, fakes, real=False)
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    value = float(fid.compute())
    compute_s = time.perf_counter() - t0
    if not (np.isfinite(value) and value >= 0):
        raise AssertionError(f"model_image_eval: FID-10k is {value}")
    if int(fid.real_features_num_samples) != FID10K_IMAGES or int(fid.fake_features_num_samples) != FID10K_IMAGES:
        raise AssertionError("model_image_eval: FID-10k did not count 10,000 images a side")
    per_update = sorted(seconds)
    out["fid"] = {"value": value, "updates": len(seconds) + 1, "first_update_s": first[0],
                  "ms_per_update_median": per_update[len(per_update) // 2] * 1e3,
                  "images_per_s": FID10K_BATCH * len(seconds) / sum(seconds), "compute_s": compute_s,
                  "peak_bytes_over_data": peak - base, "im2col_chunk_bytes": IM2COL_CHUNK_BYTES,
                  "construct_s": construct_s, "feed_s": sum(first) + sum(seconds)}
    ext = fid.inception
    batch = batches[0]
    t0 = time.perf_counter()
    # one traced update: the profiler's own cost grows with the ~1,500 kernels an update
    out["fid"]["profile_update"] = model_kernel_profile(lambda: fid.update(batch, real=True), warm=False)
    out["fid"]["profile_resize"] = model_kernel_profile(lambda: ext._preprocess(batch))
    out["fid"]["profiles_s"] = time.perf_counter() - t0

    n = SUBSET_IMAGES
    subsets = [(real[i:i + FID10K_BATCH], fake[i:i + FID10K_BATCH]) for i in range(0, n, FID10K_BATCH)]
    t0 = time.perf_counter()
    inception = InceptionScore(splits=IS_SPLITS, device=MODEL_DEVICE)
    kid = KernelInceptionDistance(subsets=KID_SUBSETS, subset_size=KID_SUBSET_SIZE, device=MODEL_DEVICE)
    mifid = MemorizationInformedFrechetInceptionDistance(device=MODEL_DEVICE)
    out["construct_three_s"] = time.perf_counter() - t0
    for name, metric in (("inception_score", inception), ("kid", kid), ("mifid", mifid)):
        t0 = time.perf_counter()
        for r, f in subsets:
            if name == "inception_score":
                metric.update(f)
            else:
                metric.update(r, real=True)
                metric.update(f, real=False)
        torch.cuda.synchronize()
        feed_s = time.perf_counter() - t0
        np.random.seed(0)
        t0 = time.perf_counter()
        result = metric.compute()
        values = [float(v) for v in result] if isinstance(result, tuple) else [float(result)]
        out[name] = {"values": values, "feed_s": feed_s, "compute_s": time.perf_counter() - t0,
                     "images": n * (1 if name == "inception_score" else 2)}
        if not all(np.isfinite(values)):
            raise AssertionError(f"model_image_eval: {name} is not finite: {values}")
    if out["inception_score"]["values"][0] < 1.0:
        raise AssertionError(f"model_image_eval: inception score below 1: {out['inception_score']}")
    return out


def inception_twins(real, fake) -> dict:
    """FID, IS, KID (10 subsets of 8) and MiFID on the first MODEL_CPU_IMAGES of each set
    on the card (each through its own extractor) and on the CPU. The CPU side runs one
    forward of the same seeded network per set, at the 2048 and ``logits_unbiased``
    taps together, and feeds those features to the four CPU metrics (``feature`` the
    identity); the bounds are the parity tests'."""
    import numpy as np
    import torch

    from torchmetrics_tpu_torch.image import (
        FrechetInceptionDistance,
        InceptionScore,
        KernelInceptionDistance,
        MemorizationInformedFrechetInceptionDistance,
    )
    from torchmetrics_tpu_torch.image._inception_net import InceptionFeatureExtractor

    k = MODEL_CPU_IMAGES
    r, f = real[:k], fake[:k]
    t0 = time.perf_counter()
    ext = InceptionFeatureExtractor(feature=2048, device="cpu")
    ext.net.features_list = ("2048", "logits_unbiased")
    cpu = {"real": ext.net(ext._preprocess(r)), "fake": ext.net(ext._preprocess(f))}
    cpu_forward_s = time.perf_counter() - t0

    def run(device: str) -> tuple:
        on_card = device != "cpu"
        feature = {} if on_card else {"feature": lambda x: x}
        fid = FrechetInceptionDistance(**(feature or {"feature": 2048}), num_features=2048, device=device)
        inception = InceptionScore(**feature, splits=IS_SPLITS, device=device)
        kid = KernelInceptionDistance(**feature, subsets=10, subset_size=k // 2, device=device)
        mifid = MemorizationInformedFrechetInceptionDistance(**feature, device=device)
        for metric in (fid, kid, mifid):
            metric.update(r.to(device) if on_card else cpu["real"]["2048"], real=True)
            metric.update(f.to(device) if on_card else cpu["fake"]["2048"], real=False)
        inception.update(f.to(device) if on_card else cpu["fake"]["logits_unbiased"])
        values = {}
        for name, metric in (("fid", fid), ("inception_score", inception), ("kid", kid), ("mifid", mifid)):
            np.random.seed(1)
            result = metric.compute()
            values[name] = [float(v) for v in result] if isinstance(result, tuple) else [float(result)]
        states = {key: getattr(fid, key).cpu() for key in ("real_features_sum", "real_features_cov_sum",
                                                            "fake_features_sum", "fake_features_cov_sum")}
        return values, states

    (card_values, card_states), (cpu_values, cpu_states) = run(MODEL_DEVICE), run("cpu")
    gaps = {}
    for key, want in cpu_states.items():
        gaps[key] = float((card_states[key] - want).abs().max()) / float(want.abs().max())
        if gaps[key] > MODEL_STATE_TOL:
            raise AssertionError(f"model_image_eval: the card's FID {key} is {gaps[key]} of its largest magnitude"
                                 " off the CPU")
    for name, want in cpu_values.items():
        # a (mean, std) pair: both within the bound of the mean (random weights make IS's
        # splits agree to 1e-7, so its std is rounding on either side)
        for i, (g, w) in enumerate(zip(card_values[name], want)):
            gaps[f"{name}.{i}"] = abs(g - w) / max(abs(want[0]), 1e-30)
            if gaps[f"{name}.{i}"] > MODEL_SCORE_RTOL:
                raise AssertionError(f"model_image_eval: card {name} {card_values[name]} != CPU {want}")
    return {"images": k, "values": card_values, "cpu_values": cpu_values, "gaps": gaps,
            "cpu_forward_s": cpu_forward_s, "seconds": time.perf_counter() - t0}


def lpips_family(paths: dict) -> dict:
    """Each backbone's class over LPIPS_PAIRS pairs on the card, a profiled update, and
    the first LPIPS_CPU_PAIRS pairs on the card against the CPU."""
    import torch

    from torchmetrics_tpu_torch.image import LearnedPerceptualImagePatchSimilarity

    out = {}
    for net in LPIPS_NETS:
        metric = LearnedPerceptualImagePatchSimilarity(net_type=net, weights_path=paths[net], device=MODEL_DEVICE)
        batches = [lpips_pairs(i) for i in range(LPIPS_PAIRS // LPIPS_BATCH)]
        seconds = timed_updates(metric, batches)
        value = float(metric.compute())
        if not (0.0 < value < float("inf")) or int(metric.total) != LPIPS_PAIRS:
            raise AssertionError(f"model_image_eval: LPIPS {net} is {value} over {int(metric.total)} pairs")
        warm = sorted(seconds[1:])
        record = {"value": value, "updates": len(seconds), "first_update_s": seconds[0],
                  "ms_per_update_median": warm[len(warm) // 2] * 1e3,
                  "pairs_per_s": LPIPS_BATCH * len(warm) / sum(warm)}
        record["profile_update"] = model_kernel_profile(lambda: metric.update(*batches[0]))
        del batches
        img1, img2 = lpips_pairs(0, LPIPS_CPU_PAIRS)
        twins = {}
        for device in (MODEL_DEVICE, "cpu"):
            twin = LearnedPerceptualImagePatchSimilarity(net_type=net, weights_path=paths[net], device=device)
            twin.update(img1.to(device), img2.to(device))
            twins[device] = float(twin.compute())
        record["cpu_twin"] = {"pairs": LPIPS_CPU_PAIRS, **twins, "gap": _rel_gap(twins[MODEL_DEVICE], twins["cpu"])}
        if record["cpu_twin"]["gap"] > LPIPS_TWIN_RTOL:
            raise AssertionError(f"model_image_eval: LPIPS {net} on the card {twins[MODEL_DEVICE]} != CPU {twins['cpu']}")
        out[net] = record
        torch.cuda.empty_cache()
    return out


def ppl_run(root: str) -> dict:
    """PerceptualPathLength with JAX's defaults on the card (the VGG backbone found through
    ``$TORCHMETRICS_TPU_LPIPS_BACKBONES``), then PPL_CPU_SAMPLES samples on the card
    against the CPU."""
    import numpy as np
    import torch

    from torchmetrics_tpu_torch.image import PerceptualPathLength

    previous = os.environ.get("TORCHMETRICS_TPU_LPIPS_BACKBONES")
    os.environ["TORCHMETRICS_TPU_LPIPS_BACKBONES"] = root
    try:
        metric = PerceptualPathLength(device=MODEL_DEVICE)
        metric.update(generator=PPLGenerator(MODEL_DEVICE, seed=5))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mean, std, kept = metric.compute()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if not (np.isfinite(float(mean)) and kept.numel() >= 0.95 * metric.num_samples):
            raise AssertionError(f"model_image_eval: PPL mean {float(mean)} over {kept.numel()} kept samples")
        twins = {}
        for device in (MODEL_DEVICE, "cpu"):
            twin = PerceptualPathLength(num_samples=PPL_CPU_SAMPLES, batch_size=PPL_CPU_SAMPLES, device=device)
            twin.update(generator=PPLGenerator(device, seed=6))
            twins[device] = [t.cpu() for t in twin.compute()]
    finally:
        if previous is None:
            os.environ.pop("TORCHMETRICS_TPU_LPIPS_BACKBONES", None)
        else:
            os.environ["TORCHMETRICS_TPU_LPIPS_BACKBONES"] = previous
    card, cpu = twins[MODEL_DEVICE], twins["cpu"]
    if card[2].shape != cpu[2].shape:
        raise AssertionError(f"model_image_eval: PPL kept {card[2].shape} on the card, {cpu[2].shape} on the CPU")
    gap = max(float(((c - w).abs() / w.abs()).max()) for c, w in zip(card, cpu))
    if gap > PPL_TWIN_RTOL:
        raise AssertionError(f"model_image_eval: PPL on the card {card} != CPU {cpu}")
    return {"samples": metric.num_samples, "batch": metric.batch_size, "epsilon": metric.epsilon,
            "mean": float(mean), "std": float(std), "kept": int(kept.numel()), "compute_s": seconds,
            "samples_per_s": metric.num_samples / seconds,
            "cpu_twin": {"samples": PPL_CPU_SAMPLES, "card_mean": float(card[0]), "cpu_mean": float(cpu[0]),
                         "gap": gap}}


def model_image_eval_phase() -> dict:
    """The model-based image metrics at published sizes on seeded random weights: FID-10k
    at CIFAR-10's shape, IS, KID and MiFID, LPIPS on its three backbones at 256^2, and
    perceptual path length with JAX's defaults; each against its CPU twin. No K1-K5
    launch, and no cuDNN convolution or TF32 product in any profiled update."""
    import shutil

    import torch

    from torchmetrics_tpu_torch.ops import kernels

    root = model_image_root()
    shutil.rmtree(root, ignore_errors=True)
    kernels.reset_launch_counts()
    record = {"phase": "model_image_eval"}
    try:
        t0 = time.perf_counter()
        real, fake = cifar10_sets()
        torch.cuda.synchronize()
        record["data_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        record["inception"] = inception_family(real, fake)
        record["inception_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        record["inception_cpu_twins"] = inception_twins(real.cpu(), fake.cpu())
        record["inception_twins_s"] = time.perf_counter() - t0
        del real, fake
        torch.cuda.empty_cache()
        files = lpips_backbone_files(root)
        record["backbone_files_s"] = files["seconds"]
        t0 = time.perf_counter()
        record["lpips"] = lpips_family(files["paths"])
        record["lpips_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        record["ppl"] = ppl_run(root)
        record["ppl_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    launches = dict(kernels.LAUNCHES)
    if any(launches.values()):
        raise AssertionError(f"model_image_eval: the model-based path launched a kernel: {launches}")
    profiles = [record["inception"]["fid"]["profile_update"]] + [r["profile_update"] for r in record["lpips"].values()]
    conv = sorted({name for p in profiles for name in p["conv_or_tf32_kernels"]})
    if conv:
        raise AssertionError(f"model_image_eval: a convolution reached cuDNN or a product took TF32: {conv}")
    return {**record, "launches": launches,
            "sizes": {"fid_images": FID10K_IMAGES, "fid_batch": FID10K_BATCH, "shape": CIFAR_SHAPE,
                      "subset_images": SUBSET_IMAGES, "kid": [KID_SUBSETS, KID_SUBSET_SIZE],
                      "lpips": [LPIPS_PAIRS, LPIPS_BATCH, LPIPS_SIZE], "ppl_latent": PPL_LATENT},
            "cuts": {"weights": "seeded random at the published widths (no checkpoint in the repo)",
                     "images": "synthesized from seeds at CIFAR-10's count and shape and at 256^2",
                     "cpu_twin": f"{MODEL_CPU_IMAGES} + {MODEL_CPU_IMAGES} images, {LPIPS_CPU_PAIRS} pairs a net,"
                                 f" {PPL_CPU_SAMPLES} PPL samples"}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torchmetrics_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "cuda": torch.version.cuda, "torch": torch.__version__})

    script_t0 = time.perf_counter()
    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SOURCES:
        _build.library(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "sources": {
        name: {"seconds": rec["seconds"], "ptxas": [line.strip() for line in rec["log"].splitlines() if "Used" in line]}
        for name, rec in _build.BUILD_LOG.items()
    }})
    if "--kernel-times" in sys.argv[1:]:
        emit({**kernel_times(), "card": smi, "root": os.path.dirname(os.path.abspath(__file__))})
        return 0
    if "--pipeline-eval" in sys.argv[1:]:
        t0 = time.perf_counter()
        emit({**pipeline_eval_phase(), "card": smi, "root": os.path.dirname(os.path.abspath(__file__)),
              "phase_wall_s": time.perf_counter() - t0})
        return 0
    if "--session-eval" in sys.argv[1:]:
        t0 = time.perf_counter()
        emit({**session_eval_phase(), "card": smi, "root": os.path.dirname(os.path.abspath(__file__)),
              "phase_wall_s": time.perf_counter() - t0})
        return 0
    if "--multilabel-eval" in sys.argv[1:]:
        t0 = time.perf_counter()
        emit({**multilabel_eval_phase(), "card": smi, "root": os.path.dirname(os.path.abspath(__file__)),
              "phase_wall_s": time.perf_counter() - t0})
        return 0
    if "--family-eval" in sys.argv[1:]:
        t0 = time.perf_counter()
        emit({**family_eval_phase(), "card": smi, "root": os.path.dirname(os.path.abspath(__file__)),
              "phase_wall_s": time.perf_counter() - t0})
        return 0
    if "--obs-eval" in sys.argv[1:]:
        t0 = time.perf_counter()
        emit({**obs_eval_phase(), "card": smi, "root": os.path.dirname(os.path.abspath(__file__)),
              "phase_wall_s": time.perf_counter() - t0})
        return 0
    if "--mux-eval" in sys.argv[1:]:
        t0 = time.perf_counter()
        emit({**mux_eval_phase(), "card": smi, "root": os.path.dirname(os.path.abspath(__file__)),
              "phase_wall_s": time.perf_counter() - t0})
        return 0
    if "--fleet-eval" in sys.argv[1:]:
        t0 = time.perf_counter()
        emit({**fleet_eval_phase(), "card": smi, "root": os.path.dirname(os.path.abspath(__file__)),
              "phase_wall_s": time.perf_counter() - t0})
        return 0
    if "--chaos-eval" in sys.argv[1:]:
        t0 = time.perf_counter()
        emit({**chaos_eval_phase(), "card": smi, "root": os.path.dirname(os.path.abspath(__file__)),
              "phase_wall_s": time.perf_counter() - t0})
        return 0
    only = [phase for flag, phase in (("--retrieval-eval", retrieval_eval_phase),
                                      ("--wrappers-eval", wrappers_eval_phase),
                                      ("--clustering-eval", clustering_eval_phase),
                                      ("--nominal-eval", nominal_eval_phase),
                                      ("--segmentation-eval", segmentation_eval_phase),
                                      ("--pairwise-eval", pairwise_eval_phase),
                                      ("--text-eval", text_eval_phase),
                                      ("--audio-eval", audio_eval_phase),
                                      ("--image-quality-eval", image_quality_eval_phase),
                                      ("--detection-eval", detection_eval_phase),
                                      ("--model-image-eval", model_image_eval_phase)) if flag in sys.argv[1:]]
    for phase_fn in only:
        t0 = time.perf_counter()
        emit({**phase_fn(), "card": smi, "root": os.path.dirname(os.path.abspath(__file__)),
              "phase_wall_s": time.perf_counter() - t0})
    if only:
        return 0
    t0 = time.perf_counter()
    records = [kernel_record_confusion_matrix(1 << 20, c, seed=c, main_path=False) for c in (10, 100, 1000)]
    # the ImageNet step's stat scores: argmax's int64 preds beside int32 targets
    records.append(kernel_record_confusion_matrix(500, 1000, seed=7, main_path=True, preds_dtype=torch.int64))
    records.append(kernel_record_confusion_matrix(1 << 18, 2, seed=8, main_path=True))
    records.append(kernel_record_confusion_matrix(1 << 16, 10, seed=9, main_path=False, preds_dtype=torch.int64,
                                                  target_dtype=torch.int64, high_bits=True))
    # the nominal tables: a pair of Adult's columns (up to 42 categories and the NaN
    # replacement), whole and in a stateful class's batch of 4,096
    records += [kernel_record_confusion_matrix(n, c, seed=c, main_path=True) for n, c, _ in CONFUSION_SHAPES[5:]]
    records += [kernel_record_curve(n, t, seed=seed, main_path=main, unsorted_ties=unsorted)
                for n, t, unsorted, main, seed in CURVE_SHAPES]
    # the micro curve's shape with int64 labels, read in place; past 4096 thresholds (the compare mode)
    records.append(kernel_record_curve(500 * 1000, 200, seed=6, main_path=False, label_dtype=torch.int64))
    records.append(kernel_record_curve(1 << 16, 5000, seed=7, main_path=False, unsorted_ties=True))
    records.append(kernel_record_weighted_bincount(500, 3, 15, seed=11, main_path=True))
    records.append(kernel_record_weighted_bincount(1 << 18, 3, 15, seed=12, main_path=True))
    records += [kernel_record_weighted_bincount(1 << 20, k, c, seed=13 + k + c, main_path=False)
                for c in (15, 1000, 8192) for k in (1, 3)]
    # retrieval's compute: AUROC's six per-query sums over 6,980 queries, and the PR
    # curve's hits in 6,980 x 100 (query, rank) cells
    records.append(kernel_record_weighted_bincount(RETRIEVAL_QUERIES * RETRIEVAL_CANDIDATES, 6, RETRIEVAL_QUERIES,
                                                   seed=14, main_path=True))
    records.append(kernel_record_weighted_bincount(RETRIEVAL_QUERIES * RETRIEVAL_CANDIDATES, 1,
                                                   RETRIEVAL_QUERIES * 100, seed=15, main_path=True))
    records += [kernel_record_bincount(n, c, seed=9 if ids == "queries" else c, main_path=main, ids=ids,
                                       dtype=getattr(torch, dtype))
                for n, c, ids, dtype, main in BINCOUNT_SHAPES]
    # main path: 4 DIV2K validation images (12 planes) padded by 5, then the first MS-SSIM scale
    records.append(kernel_record_ssim_moments(12, 1366, 2050, GAUSS11, GAUSS11, seed=51, main_path=True))
    records.append(kernel_record_ssim_moments(12, 688, 1030, GAUSS11, GAUSS11, seed=52, main_path=True))
    # the three smaller MS-SSIM scales, for K5's time per step of the image loop timed alone
    records += [kernel_record_ssim_moments(12, hp, wp, GAUSS11, GAUSS11, seed=60 + i, main_path=True)
                for i, (hp, wp) in enumerate(MS_SSIM_SMALL_SCALES)]
    records += [
        kernel_record_ssim_moments(3, 42, 42, ("uniform", 7, 0.0), ("uniform", 7, 0.0), seed=53, main_path=False),
        kernel_record_ssim_moments(48, 266, 266, GAUSS11, GAUSS11, seed=54, main_path=False),
        kernel_record_ssim_moments(12, 522, 534, GAUSS11, ("gauss", 23, 3.0), seed=55, main_path=False),
        kernel_record_ssim_moments(3, 326, 326, ("gauss", 71, 10.0), ("gauss", 71, 10.0), seed=56, main_path=False),
        kernel_record_ssim_moments(2, 90, 400, ("gauss", 5, 1.0), ("gauss", 151, 21.5), seed=57, main_path=False),
        kernel_record_ssim_moments(5, 77, 101, GAUSS11, GAUSS11, seed=58, main_path=False),
        kernel_record_ssim_moments(1, 266, 266, GAUSS11, GAUSS11, seed=59, main_path=False, nan=True),
    ]
    trace_records(records)
    emit({"phase": "kernels", "card": smi, "l2": "warm below 50 MB of inputs", "wall_s": time.perf_counter() - t0,
          "records": records})

    phases = []
    # the CPU twins take the first 20 of ImageNet's 100 steps and 4 of CTR's 16
    for name, metrics_fn, data_fn, batch, profile_steps, cpu_steps in (
        ("imagenet_eval", imagenet_metrics, imagenet_data, 500, 10, 20),
        ("binary_eval", binary_metrics, binary_data, 1 << 18, 4, 4),
    ):
        t0 = time.perf_counter()
        phase = eval_phase(name, metrics_fn, data_fn(), batch=batch, profile_steps=profile_steps,
                           cpu_steps=cpu_steps,
                           required=("confusion_matrix", "binned_curve_counts", "weighted_bincount"))
        phases.append(phase)
        emit({**phase, "card": smi, "phase_wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    collection, reference = collection_eval_phase()
    phases.append(collection)
    emit({**collection, "card": smi, "phase_wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    pipeline = pipeline_eval_phase()
    phases.append(pipeline)
    emit({**pipeline, "card": smi, "phase_wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    session = session_eval_phase()
    phases.append(session)
    emit({**session, "card": smi, "phase_wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    mux = mux_eval_phase()
    phases.append(mux)
    emit({**mux, "card": smi, "phase_wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    multilabel = multilabel_eval_phase()
    phases.append(multilabel)
    emit({**multilabel, "card": smi, "phase_wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    family = family_eval_phase()
    phases.append(family)
    emit({**family, "card": smi, "phase_wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    sync = collection_sync_phase(reference)
    phases.append(sync)
    emit({**sync, "card": smi, "phase_wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    retrieval = retrieval_phase()
    phases.append(retrieval)
    emit({**retrieval, "card": smi, "phase_wall_s": time.perf_counter() - t0})
    for phase_fn in (retrieval_eval_phase, wrappers_eval_phase, clustering_eval_phase, nominal_eval_phase,
                     segmentation_eval_phase, pairwise_eval_phase, text_eval_phase, audio_eval_phase,
                     image_quality_eval_phase, detection_eval_phase, model_image_eval_phase):
        t0 = time.perf_counter()
        record = phase_fn()
        phases.append(record)
        emit({**record, "card": smi, "phase_wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    image = image_phase(ssim_alone_ms=k5_ms_per_step_alone(records))
    phases.append(image)
    emit({**image, "card": smi, "phase_wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    emit({**gradient_phase(), "card": smi, "phase_wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    obs = obs_eval_phase()
    phases.append(obs)
    emit({**obs, "card": smi, "phase_wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    fleet_record = fleet_eval_phase()
    phases.append(fleet_record)
    emit({**fleet_record, "card": smi, "phase_wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    chaos_record = chaos_eval_phase()
    phases.append(chaos_record)
    emit({**chaos_record, "card": smi, "phase_wall_s": time.perf_counter() - t0})

    line = []
    for name, (source, replaces) in KERNEL_SOURCES.items():
        mine = [r for r in records if r["kernel"] == name]
        main = next(r for r in mine if r["main_path"])  # the first main-path shape of each kernel
        line.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": sum(phase["launches"][name] for phase in phases),
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main["kernel_ms"], "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "library_ms": main["library_ms"],
            "shape": {k: main[k] for k in ("n", "classes", "thresholds", "rows", "bins", "planes", "hp", "wp", "kh",
                                           "kw") if k in main},
        })
    emit({"total_wall_s": time.perf_counter() - script_t0})
    print(smi)
    emit({"kernels": line})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
