#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card (an H100 for the numbers
in PERF.md).

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the port's CUDA kernels from csrc/ (set-up time).
3. Kernel phases, serving: holds each serving kernel (GRU scan, decode
   step, GRU chain) against its plain PyTorch version at the flagship
   shapes, in float32 (tolerance 1e-4 absolute: summation order only) and
   in bfloat16 (tolerance 2e-2 absolute on outputs in [-1, 1]: bf16
   rounding of the outputs and of products the kernel keeps in f32); then
   the scan on a ragged batch (B=61, one row all padding) and on T=1 in
   both directions, the decode step and chain at N=1000 and N=3 with one
   row whose source is all padding, and each for bit-identical outputs in
   two launches. Times at bf16: kernel, plain version and, for the scan,
   cuDNN's nn.GRU forward (which also does the input projection), at the
   scan's serving shape (B=256) and training shape (B=64, T=24); for the
   GRU chain, cuDNN's 2-layer nn.GRU over one step on [emb; feed] (which
   also does layer 0's input projection) and the chain's own time, both
   on the device's clock (torch.profiler's kernel times); cuDNN's times in
   the ``kernels`` line are on the device's clock, with the eager reading
   (CUDA events around back-to-back calls, host-bound at these sizes)
   beside them. Each prints its launch plan.
   Kernel phases, training: the GRU-scan backward (B=64, T=24, H=250, both
   directions, padded rows) and the decoder sequence forward and backward
   (B=64, T=25, S=24, H=500, dropout mask at p=0.3), every output and
   gradient held to max|kernel - plain| / max|plain| per tensor, 1e-4 in
   float32 (summation order) and 2e-2 in bfloat16 (rounding): gradients
   are not bounded in [-1, 1], so the tolerance is relative to each
   tensor's largest entry. The decoder's weights have the init scale (std
   1/sqrt(H)) and its attention memory (keys, mem_v) std 0.1 for this
   check. With memory of std 0.5 the scores are large, the softmax peaked,
   and the 25-step recurrence through the fed-back attention amplifies
   bf16 rounding until two correct bf16 evaluations differ by a few 1e-2
   elementwise at the late steps. There the phase holds the bf16 kernel
   against the bf16 plain version at 2e-2 over the first 4 steps each pass
   processes (forward t < 4, backward t >= T-4), before the drift grows,
   and over the whole sequence requires the kernel's distance from the f32
   math of the same inputs to be at most 1.5 times the plain version's
   (readings of 1.0 and 1.3 times, forward and backward, set that limit).
   Both backward kernels and the decoder forward are also held at the same
   tolerances on a ragged batch (B=61, which fills no row group or tile; for
   the scan with one row all padding, for the decoder forward with one
   source of a single real position) and on T=1, in both directions for the
   scan, and must give bit-identical outputs in two launches on the same
   inputs (a missing cluster or grid barrier can hide inside a tolerance);
   each prints the launch plan it chose (cluster size, rows per cluster or
   CTA, CTAs, shared memory per CTA, co-resident clusters or CTAs). Times at bf16:
   kernel, plain version and, for the scan backward, cuDNN's nn.GRU
   backward (which also computes the input-projection gradients that the
   port leaves to cuBLAS).
   Kernel phases, the reset stream (sequence packing): both GRU-scan
   kernels with a reset stream at the packed path's shape (B=64, T=64,
   H=250; resets at every row's t=0, at 2-3 more segment starts a row and on
   the first padded step of every padded row), f32 and bf16, both
   directions, then B=61 (a row all padding) and T=1, held to the
   reset-free checks' tolerances, and bit-identical in two launches; bf16
   times of each beside its reset-free launch on the same inputs, in turns,
   with the plain version's and the bound.
4. Serving phase: vmmt_c at full width (the port's configs/vmmt_c_multi30k.json,
   vocab 10000/10000, bf16, use_pallas) with random weights from numpy seed 0
   through convert.py; Translator(device="cuda") answers three request
   batches of 256 sentences (beam 4, max_length 60) with pallas_step=1 and
   three with pallas_step=2, and every kernel's launch count must rise;
   outputs must be well formed; sent/s is measured twice for each of
   pallas_step 0, 1 and 2, in turns (1 2 0 0 2 1); in float32, 32 sentences
   through the kernel path and the all-plain path must agree on at least
   31 top-1 hypotheses.
5. Training phase: the same model and weights (bf16, use_pallas, fused_ce,
   pallas_decoder) in Trainer(device="cuda"): 30 optimizer steps over 4
   fixed batches of 64 sentence pairs (lengths uniform in 8-24, 2048-d
   |N(0,1)| image features, numpy seed 1). Every loss must be finite, the
   mean loss of the last 4 steps below that of the first 4, and the launch
   counts of the GRU scan, its backward and the decoder sequence kernels
   must rise. Step time and target tokens/s for pallas_decoder True and
   False, four runs of 48 steps each (12 passes over the batches), in
   turns (1 0 0 1 1 0 0 1), each after one untimed pass of its route, with
   each route's spread (max - min) / mean over its runs, each route's MFU
   (``utils/flops.train_step_flops`` of the batches' padded lengths over the
   step time and NVIDIA's dense bf16 peak of 989 TFLOP/s), and the peak
   device memory.
6. f32 training check: one batch, deterministic, no sampling; the kernel
   path (use_pallas, pallas_decoder, fused_ce) against the all-plain path
   (use_pallas=False, pallas_decoder=False, fused_ce=False): losses within
   1e-4 relative, every parameter gradient within 1e-3 of its plain
   tensor's largest entry, before and after 3 optimizer steps.
7. Packed training phase: the same model and weights in Trainer with
   train.pack over 4 fixed packed batches (64 rows of 64 tokens, up to 4
   sentences a row, pairs drawn as in phase 5, numpy seed 1; sentences,
   real target tokens and fill printed), 20 steps: every loss finite, the
   mean of the last 4 below that of the first 4, and each GRU-scan kernel
   launched 6 times a step, every launch with a reset stream (the decoder
   takes its plain loop, as in JAX); peak device memory; three timed runs
   of 12 steps, ms/step and real target tokens/s beside phase 5's unpacked
   routes. Then f32, deterministic, no sampling: the sentences of the
   first 8 packed rows unpacked through ``forward`` (kernel route) and
   packed through ``forward_packed`` (reset kernels): loss within 2e-5
   relative, every gradient within 2e-4 relative and 2e-5 x max(1, its
   largest entry) absolute (tests/test_pack.py's tolerances).
8. Kernels at the quality gate's shapes (hidden 256): phase 3's checks
   and times (without the reset stream) again, the GRU scan and its
   backward at B=64, T=32, H=128, the decoder sequence forward and
   backward at B=64, T=33, S=32, H=256, the decode step and GRU chain at
   N=256, S=32, H=256.
9. Families phase: nmt, vmmt_f and vmmt_c at the gate's width and depth
   (tools/quality_gate.py ``build_cfg``: vocab 200, emb and hidden 256,
   latent 64, img 512, 2+2 layers, z_cond=init+input, bf16, use_pallas,
   pallas_decoder, fused_ce) with random weights from numpy seed 0 and 4
   batches of 64 pairs of the gate's ambiguous corpus (data seed 0): 20
   Trainer steps (finite losses, the mean of the last 4 below the first 4,
   the scans and the decoder sequence kernels launched) and 20 timed ones;
   phase 6's f32 check on the first batch; beam-4 decoding of 64 sentences
   (max_length 40) at pallas_step 1 and 2, well formed, with the scan and
   the decode step or GRU chain launched, sent/s; then, with the trained
   weights in f32, the kernel path and the all-plain path must agree on at
   least 31 of 32 top-1 hypotheses.
10. Entry-point phase: the port's CLIs at the flagship's widths. A
    preprocessed corpus written with the port's writers into a temporary
    directory (the synthetic corpus of data/synthetic.py, vocab 10000,
    2048/256/256 pairs, its image vectors through one fixed projection to
    2048-d; ``write_cli_corpus``) and a ``-config`` file, the port's
    configs/vmmt_c_multi30k.json with pallas_decoder on (emb and hidden
    500, 2+2 layers, latent 128, bf16, use_pallas, fused_ce). ``cli.train``
    runs 60 steps of batch 64 with validation, reports and checkpoints every
    20 steps, keeping 2: every loss finite, 3 validations, checkpoints 40
    and 60 kept. The step-40 checkpoint, loaded, must equal the live state
    at step 40 bit for bit (params, Adam state, step, lr, generator state),
    and one step from it must equal one from the live state on the same
    batch: bit for bit when two steps from the live state agree bit for bit
    (the route is deterministic), else no farther from the first than the
    second is. ``-train_from`` that checkpoint up to step 60 (the data
    restarting at epoch 0), finite losses. ``cli.translate`` from the last
    checkpoint, beam 4, at pallas_step 1 and 2, with ``-report_bleu`` on the
    256 test pairs: well formed, rows 1 and 3 (then 1 and 4) launched,
    sent/s. Then save -> load -> translate at pallas_step 1 must give the
    same n-best ids. Prints the CLI's ms/step over its loop (validations and
    checkpoints included) beside phase 5's Trainer ms/step, sent/s and the
    checkpoint's size. Rows 1, 2, 3, 5 and 6 must run on the train and
    translate runs, row 4 on the pallas_step 2 run; comparison steps are not
    counted.
11. Online-serving phase, from phase 10's last checkpoint and test set
    (256 sentences with their 2048-d features). ``python -m
    variational_mmt_torch.cli.serve -model <ckpt> -port 0 -batch_size 32``
    runs twice as subprocesses, with ``-pipeline_depth`` 1 and 2 (the port
    is read from its ``serving on http://HOST:PORT`` line); each timed run
    sends, over loopback HTTP (the msgpack wire, float32 image bytes), the
    256 sentences as single-sentence requests from 32 closed-loop client
    threads, then 8 requests of 32 sentences at once, to depth 1, 2, 2, 1 in
    turns; every answer must equal the offline Translator's for the serve
    CLI's DecodeConfig (beam 4, max_length 100, batch 32). Printed per run:
    sent/s, p50 and p99 request latency, mean batch fill and the service's
    busy_s share of the run. Then one run through ``-procs 2`` (dispatcher
    processes, the id-level wire). Then the counted runs of the main path:
    the service the serve CLI builds (its loader and defaults, warmup)
    behind an in-process ``ServingServer`` at ``-pipeline_depth`` 1 and at
    AUTO (2 on a multi-core host), the same traffic and checks sent from a
    client process of their own; per depth one run with the launch counts
    set to 0 just before it and read just after (``serve_online`` is the
    AUTO run's; the CLI serves at pallas_step 0, so row 1 must run there
    and rows 3 and 4 do not), with this process's CPU time and the device
    thread's as shares of the served time, then one run under
    ``torch.profiler`` for the device's busy share. In process, f32:
    ``TranslationService`` with ``coverage_beta 0.2``, with
    ``block_ngram_repeat 2`` and an exclusion token, and with
    ``replace_unk``, at pallas_step 1 and 2 each against 0, at least 31 of
    32 top-1 entries equal (ids; with ``replace_unk`` also the attention
    positions, on a copy of the model whose generator scores ``<unk>`` as
    the exclusion word plus 1, and at least one answer must hold
    ``<unk>``); rows 1, 3 and 4 must be launched by these checks
    (``serve_options``). In bf16 at pallas_step 1: sampling (temperature
    1.0, top-k 10) keyed by ``sample_ids`` gives identical answers for 32
    requests sent at once and one by one; the decode streams give identical
    uniforms on the card and the CPU; ``latent_from sample`` repeats for a
    seed and differs from the mean's decode. Last, rows 3 and 4 against
    their plain versions (f32 1e-4, bf16 2e-2) at N = 128 (batch 32 x beam
    4) and N = 32 (sampling) for S at each warmed bucket (16, 24, 32, 48,
    64), H = 500, with kernel ms in f32 and bf16, bf16 plain ms and the
    bound; and row 1 timed at the served encoder's shape (B = 32, T = 16
    and 24, H = 250). Every server
    process group is stopped (SIGINT, then SIGKILL).
12. Evaluation phase, from phase 10's last checkpoint and its 256 test
    pairs. ``cli.translate -iw_eval 10 -latent_diag -dump_attn <file>
    -report_meteor -tgt ...`` (beam 4, batch 64, the checkpoint's bf16
    kernel route), counted with the launch counts set to 0 just before and
    read just after (``eval``): prints the IW bounds, the IW pass's
    sentences/s, METEOR, BLEU and the active units; rows 1 and 5 must run.
    The same IW pass alone in process: row 1 launched and row 5 exactly 10
    times a batch; then under ``torch.profiler`` for the device's busy
    share of it. In f32, the kernel route (use_pallas, pallas_decoder)
    against the plain route on the same eps: each sentence's joint and
    text bounds within 1e-3 of max(1, |bound|), the corpus bounds within
    1e-4 relative, and the force-decoded attention of the 1-best
    hypotheses within 1e-4 absolute (the dumped file holds one matrix of
    that shape a sentence). Then MBR in f32 (8 samples at temperature 1.0,
    32 sentences) at pallas_step 0, 1 and 2: at least 31 of 32 picks of
    steps 1 and 2 equal step 0's.
13. Widths phase: rows 1 and 2 on the wide plan (the persistent
    cooperative kernels above 512 units) at H = 520, 1000 and 1024, each at
    B = 64, T = 25 and B = 256, T = 24, in f32 and bf16, with and without a
    reset stream, both directions, against their plain versions (forward
    1e-4 / 2e-2 absolute, backward the same relative to each tensor's
    largest entry), the plans printed and required wide; bf16 times by CUDA
    events in turns with the plain version (kernel, plain, plain, kernel,
    10 calls a turn) and on the device's clock, beside cuDNN's nn.GRU
    forward and backward at the same shape and the bound. Rows 1 and 2 at
    H = 512 (16-CTA clusters; B = 64, T = 24 in f32 and bf16, B = 256 in
    bf16) and H = 300 (B = 64, both dtypes) the same way, bf16 times beside
    cuDNN's nn.GRU and the bound; rows 3-6 at H = 250 (padded to 252 by the
    wrappers): phase 3's step checks at N = 128 and 32 (S = 24) and its
    decoder checks at B = 64, T = 25, S = 24. Then the entry points at
    these widths from phase 10's corpus, 10 steps of ``cli.train`` each:
    ``-rnn_size 1024`` with the flagship config's ``pallas_decoder`` off
    (encoder halves of 512 units on 16-CTA clusters of rows 1 and 2; the
    decoder kernels are off, as JAX ships them), ``-rnn_size 250`` with it
    on (rows 1, 2, 5 and 6 at 252), ``-rnn_size 2048`` with it off
    (encoder halves of 1024 units on the wide plan) and the fast config
    ``-input_feed 0 -use_pallas 1 -rnn_size 1000`` (the decoder's two
    layers at 1000 units on the wide plan): finite losses, rows 1 and 2
    launched, a scan of 1024 (resp. 1000) units seen, and no "takes the
    plain scan" log line; then ``cli.translate`` of the 250 model at
    pallas_step 1 and 2 (rows 3 and 4 at 252); all counted as ``widths``.
    Last, phase 6's f32 check of the fast config at hidden 1000 (random
    weights, numpy seed 0): its kernel route against the plain route, loss
    within 1e-4 relative and every gradient within 1e-3 of its largest
    entry, before and after 3 optimizer steps.
14. Ensemble phase, from phase 10's checkpoint and corpus: two more
    full-width vmmt_c members with random weights (numpy seeds 1 and 2,
    through convert.py) saved by the port's checkpoint writer with phase
    10's vocabs; decoding is beam 4, max_length 60, over phase 10's 256
    test sentences and one request of 256 at the flagship's shapes (numpy
    seed 4). Checks, in f32 compute: the same checkpoint three times at
    pallas_step 0, in both ensemble modes, gives the single model's top-1
    on at least 255 of the 256 test sentences; the 3-member ensemble at
    pallas_step 1 and 2 agrees with pallas_step 0 on at least 31 of 32.
    The int8 codes, scales and dequantized bf16 weights the card computes
    equal the CPU's bit for bit. Each member's bytes at rest, the
    ``memory_allocated`` delta of building its int8 Translator from a
    host model (after ``empty_cache``, before any request), must equal
    the count from its shapes (1 byte a weight of two or more dimensions,
    4 a scale, 4 an element of a 1-D leaf) up to the caching allocator's
    rounding (511 bytes a block, and below 1 MiB of unsplit segment for a
    block above 1 MiB), the requested-bytes delta exactly, and the three
    members' sum likewise; f32 and bf16 bytes at rest are printed beside
    them. Counted as ``ensemble``: sent/s of the single model and of the
    3-member ensemble at infer_dtype float32, bfloat16 and int8, each at
    pallas_step 0, 1 and 2 (rows 1, 3 and 4 must run), as decoded and with
    every hypothesis held to 60 steps (min_length 60), two timed runs each
    in turns after one untimed, with the int8 vs bf16 top-1 agreement; at
    bf16 and int8 the top-1 at pallas_step 1 and 2 must equal pallas_step
    0's on at least 31 in 32 of the 512 sentences (the step kernels on
    bf16-stored and int8-rebuilt weights against the plain step). Not
    counted: ms a batch of 32 of the f32 single model through the
    Translator (which lends its weights with ``functional_call``) and
    through the translate function on the model itself, three runs each
    in turns. Counted again: ``cli.translate -model a,b,c`` at
    ``-infer_dtype int8`` and ``bfloat16``. Then ``cli.serve -model a,b,c
    -infer_dtype int8`` answers 32 single-sentence requests sent at once,
    each equal to the offline int8 ensemble Translator's. Last, the port's
    preprocess CLI from phase 10's 2048 training pairs written as text
    (BPE, ``-shard_size 512``: 4 shards), timed, and 5 steps of the train
    CLI on its corpus (counted as ``preprocess``).
15. Options phase: the model options of ROADMAP.md item 5.5 at the
    flagship's width and depth (emb and hidden 500, 2+2 layers, latent
    128, bf16, use_pallas, vocab 10000), each with random weights from
    numpy seed 0 through convert.py and phase 5's batches (conv features:
    (64, 49, 2048) |N(0,1)| a batch, numpy seed 5). The fast config
    (``input_feed=False``, pool5): 20 Trainer steps, finite losses, rows 1
    and 2 launched 8 times a step each, 6 at 250 units (the encoders) and
    2 at 500 (the decoder's layers from the bridge's state), rows 5 and 6
    not at all; phase 6's f32 check of its kernel route (bridge gradients
    printed); ms/step in turns beside the input-feed flagship with
    pallas_decoder 1 and 0 (two runs of 20 steps each); beam-4 decoding of
    256 requests (numpy seed 6) at pallas_step 0, every hypothesis held to
    60 steps (min_length 60), well formed, sent/s; with
    the trained weights in f32, the kernel route and the all-plain route
    agree on at least 31 of 32 top-1 hypotheses. LSTM cells, dot attention,
    mlp attention, and conv features (49 regions) with ``img_pool=attn``
    (and pallas_decoder, whose kernels compute that decoder): 5 Trainer
    steps with finite losses and the same beam-4 decoding, well formed
    (conv + attn at pallas_step 1: row 3 must run; the others' encoder scan
    must run, LSTM's has no kernel). The four models the step kernels do
    not compute decode 64 sentences at pallas_step 1 and 2: rows 3-6
    launched 0 times, ``Translator.step_routes`` ``plain``, n-best equal to
    pallas_step 0's. Counted as ``options``: the training runs, the beam-4
    decodes and the pallas_step 1 and 2 decodes. Prints the phase's
    seconds.
16. Host-path phase (``host_path_phase(card, cfg, state, root)``, on phase
    10's corpus: 2048 pairs, vocab 10000, 2048-d features). The native
    library (g++, built at first use) must load, else the run fails with
    its reason. Over one shuffled epoch every batch of ``BucketIterator``
    (batch 64, the config's buckets, features) and of
    ``PackedBucketIterator`` (64 rows of 64, K=4) must be array-identical
    natively and in Python, and the BPE segmentation of every word of the
    corpus (1000 merges learned from it) identical both ways; host us a
    batch and BPE words/s both ways, in turns. Then the flagship (bf16,
    use_pallas, pallas_decoder 1, fused_ce, the feature table on the
    device): the ``Trainer`` (native batches through the prefetcher, data/
    prefetch.py) against ``DirectLoop``, how the parent trained
    (``make_train_step`` over ``batch_tensors`` of Python-assembled
    batches): the first 20 losses must be equal to the bit (same kernels,
    batches and generator draws; counted as ``host_path``); ms/step in
    turns, 4 runs of 48 steps each with the spread, beside the same direct
    loop over native batches (``direct_native``) and over native batches
    from the prefetch thread, copied on the consumer (``thread_only``);
    the Trainer's and the direct loop's device busy share from one
    ``torch.profiler`` run of 4 steps each (read as tools/profile_train.py
    reads it); packed training likewise (the first 4 losses, 3 runs of 12
    steps, 2 profiled; the Trainer and the direct loop). Last the
    ``fused_decoder`` route (``pallas_decoder`` 0): phase 6's f32 check
    against the plain route (loss 1e-4 relative, every gradient 1e-3 of its
    max); 20 bf16
    Trainer steps with finite losses, rows 5 and 6 launched 0 times
    (counted); ms/step in turns beside ``pallas_decoder`` 1 and 0 (2 runs
    of 12 steps each); ``cli.train -config`` with the flagship config and
    ``fused_decoder: true`` (``pallas_decoder`` off) runs 10 steps, each
    through the fused route, rows 5 and 6 not at all (counted). Prints the
    phase's seconds.
17. Parallel phase (``parallel_phase(card, cfg, state)``, ROADMAP item
    5.8), the flagship at full width on the kernel route (use_pallas,
    pallas_decoder, fused_ce), batch 64. (a) An NCCL process group of one
    rank: the ``Trainer`` with ``make_mesh(1, 1)`` (the data-parallel code
    path: the global sentence count and the bucketed gradient all-reduce
    on) in turns with the plain ``Trainer`` on the same batches and seed,
    4 runs of 5 bf16 steps each (the first untimed): the 20 losses must be
    equal to the bit, rows 1, 2, 5 and 6 launched (counted as
    ``parallel``); ms/step of both with the spread; the bytes all-reduced
    a step, from the parameter count. (b) Two ranks on the one card
    (``chip_smoke.py --parallel-rank R DIR``, a timeout of their own),
    gloo with CUDA tensors (NCCL refuses two ranks on one device): DP 2 x
    TP 1, then DP 1 x TP 2, 10 f32 steps each, dropout off, z the
    posterior mean, against one process on the same batches: the loss
    within 1e-4 relative at every step, rows 1, 2, 5 and 6 launched on
    each rank; ms/step as read (two ranks share one card and gloo stages
    every collective through the host: not a scaling number); the TP-2
    beam-4 f32 decode (pallas_step 1) of 32 requests (numpy seed 7): top-1
    equal to one process's on at least 31; the TP-2 checkpoint after the
    10 steps, gathered and written by rank 0, loaded by one process,
    decodes the ranks' top-1 on at least 31. The ranks' launches are
    counted as ``parallel`` too. Prints the phase's seconds.
18. Feature-extraction phase (``extract_phase(card, root)``, ROADMAP item
    5.9), inside phase 10's directory: the ResNet-50 trunk
    (``models/resnet.py``: base 64, stages 3-4-6-3, 224x224) with random
    torchvision-layout weights (``tools/flagship.resnet_weights``, numpy
    seed 2), images N(0, 1) already normalized (numpy seed 3). (a) 4
    images, f32 on the card against the port's trunk on the CPU: pool5
    and conv within 1e-4 of each output's largest entry. (b)
    ``extract_features`` over 37 images at batch 32 (a last, partial
    batch of 5) against each image run alone, pool5 and conv, within the
    same 1e-4. (c) The trunk at batch 32 on images already on the card:
    images/s and ms a batch (CUDA events, 10 calls a turn) in float32 and
    in TF32 (cuDNN's TF32 convolutions around the trunk's own
    ``trunk_nchw``; a finding, the entry points stay float32), in turns
    (f32, TF32, TF32, f32), with TF32's distance from f32 and the bound
    max(bytes / 3.35 TB/s, conv FLOPs / 67 TFLOP/s f32 or 494.7 TFLOP/s
    TF32): bytes the images, weights and both outputs once, FLOPs 2 x the
    multiply-adds of every convolution from the state dict's shapes. (d)
    Where PIL is installed: 64 PNG files (numpy seed 4, 200-400 pixels a
    side) through ``python -m variational_mmt_torch.cli.extract_features``
    in a fresh process with PyTorch's default flags (``-weights`` an
    ``.npz``, ``.npy`` out), equal within 1e-5 of the largest entry to the
    same extraction in this process (TF32 off globally), so the CLI does
    not drift to TF32; images/s of both, decoding included. Without PIL it
    prints ``"cli": "not run: PIL is not installed"`` and goes on. (e)
    ``save_features`` to ``.h5``: written and read back equal where h5py
    is installed, else the error naming ``.npy``; prints which. (f) The
    pool5 features of 32 images with the first 32 test sentences through
    the ``Translator`` at pallas_step 1 (beam 4, max_length 60) on phase
    10's checkpoint: well formed; rows 1 and 3 launched (counted as
    ``extract``). Prints the phase's seconds.
19. Serving across ranks (``serve_ranks_phase(card, root)``, ROADMAP item
    5.10), on phase 10's checkpoint (in f32) and its test sentences: two
    ranks on the one card (``chip_smoke.py --serve-rank R DIR``, a timeout
    of their own), gloo with CUDA tensors (NCCL refuses two ranks on one
    device), ``TranslationService(mesh=)`` on TP-2 (1 x 2) and then DP-2
    (2 x 1), beam 4, max_length 60, ``-batch_size`` 32, pallas_step 1,
    warm-up on: rank 0 serves 128 single-sentence requests from 32
    closed-loop client threads, rank 1 follows. The top-1 of the first 32
    must equal one process's service (f32, the same decode options) on at
    least 31; sent/s, p50 and p99 as read (not a scaling number); rank 0's
    stop must end both ranks with exit code 0; rows 1 and 3 must run on
    each rank, whose launches are counted (set to 0 before each service is
    built, read after it stops) as ``serve_ranks``.
20. Prints one JSON line of per-kernel numbers (all six TPU kernels'
    counterparts; the scan forward's top-level times are at the serving
    shape, ``by_shape`` holds both; the two scans' ``reset`` records hold
    the reset stream's checks and times, ``gate_shape`` each kernel's
    numbers at the gate's shape, ``serve_shapes`` rows 1, 3 and 4 at the
    service's, ``widths`` each kernel's numbers at the widths phase's
    shapes, ``launches_by_path`` the serving, training, packed-training,
    families, CLI, online-serving, option-check, eval, widths, ensemble,
    preprocess, options, host-path, parallel, extract and serve_ranks
    counts) with the ``host_path``, ``parallel``, ``extract`` and
    ``serve_ranks`` records, then the last line {"ok": true, "device":
    {...}}.

Exits non-zero, with no result line, when CUDA is unavailable, when the
port's package is not beside this script, or when any phase fails.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

from typing import Optional, Tuple

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

H100_BF16_FLOPS = 989e12  # dense tensor-core peak (NVIDIA data sheet, SXM)
H100_F32_FLOPS = 67e12  # non-tensor-core float32 peak
H100_BYTES_PER_S = 3.35e12
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
SCAN_SHAPE = dict(B=256, T=24, H=250)
STEP_SHAPE = dict(N=1024, S=24, H=500)
TRAIN_SCAN_SHAPE = dict(B=64, T=24, H=250)
DEC_SHAPE = dict(B=64, T=25, S=24, H=500)
DEC_MEM_STD, DEC_MEM_STD_PEAKED = 0.1, 0.5  # std of keys and mem_v (module docstring)
PEAKED_STEPS, PEAKED_DRIFT_RATIO = 4, 1.5  # checks at memory std 0.5 (module docstring)
TRAIN_BATCH, TRAIN_BATCHES, TRAIN_STEPS, TIMED_STEPS = 64, 4, 30, 48  # timed: whole passes
TIMED_ORDER = (True, False, False, True, True, False, False, True)  # pallas_decoder, in turns
PACK_SCAN_SHAPE = dict(B=64, T=64, H=250)  # the packed training path's encoder scans
PACK_ROW, PACK_K = 64, 4  # packed row length, most segments a row
PACKED_STEPS, PACKED_RUNS, PACKED_TIMED_STEPS = 20, 3, 12
PACKED_CHECK_ROWS = 8  # rows of the first packed batch in the f32 packed = unpacked check
PACKED_TOL = dict(loss=2e-5, rtol=2e-4, atol=2e-5)  # tests/test_pack.py:169-181
GATE_SCAN_SHAPE = dict(B=64, T=32, H=128)  # the quality gate's encoder scans (hidden 256)
GATE_DEC_SHAPE = dict(B=64, T=33, S=32, H=256)  # its decoder, one step past bucket 32
GATE_STEP_SHAPE = dict(N=256, S=32, H=256)  # its beam-4 decoding of 64 sentences
FAMILIES = ("nmt", "vmmt_f", "vmmt_c")
FAMILY_STEPS, FAMILY_SENTENCES, FAMILY_CHECK = 20, 64, 32
CLI_STEPS, CLI_EVERY, CLI_KEEP, CLI_RESUME_AT = 60, 20, 2, 40  # the entry-point phase
CLI_TRAIN, CLI_VALID, CLI_TEST, CLI_VOCAB, CLI_IMG = 2048, 256, 256, 10000, 64
CLI_KERNELS = ("gru_layer_scan", "gru_layer_scan_bwd", "decode_step", "gru_chain",
               "decoder_fwd", "decoder_bwd")
SERVE_CLIENTS, SERVE_BATCH, SERVE_BIG = 32, 32, 8  # closed-loop clients, -batch_size, big requests
SERVE_DEPTHS = (1, 2, 2, 1)  # -pipeline_depth of the timed runs, in turns
SERVE_BUCKETS = (16, 24, 32, 48, 64)  # the serve CLI's warmed buckets
SERVE_STEP_NS = (128, 32)  # rows of the decode step: batch 32 x beam 4, and sampling
SERVE_CHECK = 32  # sentences of the in-process option checks
SERVE_SCAN_TS = (16, 24)  # buckets of the served encoder scan timed at B = 32
SERVE_KERNELS = ("gru_layer_scan", "decode_step", "gru_chain")
EVAL_K, EVAL_BATCH, EVAL_SEED = 10, 64, 3  # the IW samples, the eval CLI's batch, its -seed
EVAL_TOL = dict(sent=1e-3, corpus=1e-4, attn=1e-4)  # f32 kernel route vs plain route
EVAL_MBR_SAMPLES, EVAL_MBR_CHECK = 8, 32  # MBR's samples and sentences, pallas_step 0, 1, 2
WIDTH_SCANS = ((64, 24, 512, ("float32", "bfloat16")), (256, 24, 512, ("bfloat16",)),
               (64, 24, 300, ("float32", "bfloat16")))  # B, T, H and the checked dtypes
WIDTH_STEP_NS, WIDTH_DEC = (128, 32), dict(B=64, T=25, S=24, H=250)  # rows 3-6 at H = 250
WIDTH_CLI_STEPS = 10  # train CLI steps at each -rnn_size of phase 13
# rows 1 and 2 on the wide plan: (B, T, H), f32 and bf16, with and without a reset stream
WIDE_SCANS = ((64, 25, 520), (256, 24, 520), (64, 25, 1000), (256, 24, 1000), (64, 25, 1024),
              (256, 24, 1024))
WIDE_ITERS = 10  # CUDA-event calls a turn of the wide scans' bf16 times
FAST_WIDE = dict(hidden_dim=1000, input_feed=False)  # the fast config at -rnn_size 1000
ENS_SEEDS, ENS_SEED = (1, 2), 4  # numpy seeds: the random members; the flagship request
OPTION_STEPS, OPTION_OTHER_STEPS = 20, 5
# the timed runs in turns: the fast config and the input-feed flagship with
# pallas_decoder 1 and 0
OPTION_TIMED = ("fast", "input_feed_1", "input_feed_0", "input_feed_0", "input_feed_1", "fast")
OPTION_SENTENCES, OPTION_CHECK, OPTION_INELIGIBLE = 256, 32, 64
OPTION_REGIONS = 49  # conv features: ResNet's 7x7 grid of 2048-d regions
OPTIONS = {"fast": dict(input_feed=False), "lstm": dict(rnn_type="lstm"),
           "dot": dict(attn_type="dot"), "mlp": dict(attn_type="mlp"),
           "conv_attn": dict(img_feat_type="conv", img_pool="attn")}
ENS_DTYPES = ("float32", "bfloat16", "int8")  # -infer_dtype of the timed decodes
HOST_BATCH, HOST_ROW, HOST_K = 64, 64, 4  # phase 16: batch 64; packed 64 rows of 64, K = 4
HOST_CHECK_STEPS, HOST_TIMED, HOST_PACKED_CHECK, HOST_PACKED_TIMED = 20, 48, 4, 12
# phase 16's step fed four ways, in turns; packed: the Trainer and the parent's loop
HOST_FEEDS = ("prefetched", "direct", "direct_native", "thread_only")
HOST_ORDER = (HOST_FEEDS + HOST_FEEDS[::-1]) * 2
HOST_PACKED_ORDER = ("prefetched", "direct", "direct", "prefetched", "prefetched", "direct")
HOST_PROFILE_STEPS, HOST_PACKED_PROFILE_STEPS, HOST_BPE_MERGES = 4, 2, 1000
FUSED_STEPS, FUSED_TIMED, FUSED_CLI_STEPS = 20, 12, 10
FUSED_ORDER = ("fused", "pallas_decoder=1", "pallas_decoder=0", "pallas_decoder=0",
               "pallas_decoder=1", "fused")
ENS_SENT, ENS_MAXLEN = 256, 60  # sentences an input (test set; flagship request), max_length
ENS_CHECK, ENS_SERVE = 32, 32  # f32 kernel-vs-plain sentences; requests to the serve CLI
ENS_SHARD, ENS_PP_STEPS = 512, 5  # preprocess -shard_size; train CLI steps on its corpus
PAR_TURNS, PAR_TURN_STEPS = 4, 5  # phase 17 (a): bf16 steps in turns, the first turn untimed
PAR_F32_STEPS, PAR_TOL = 10, 1e-4  # phase 17 (b): f32 steps a mesh; loss, relative
PAR_DECODE, PAR_DECODE_SEED = 32, 7  # phase 17 (b): TP-2 beam-4 sentences, request seed
PAR_CHILD_TIMEOUT_S = 240  # phase 17 (b): the two ranks, start-up included
PAR_ROWS = ("gru_layer_scan", "gru_layer_scan_bwd", "decoder_fwd", "decoder_bwd")
SRV_RANK_CLIENTS, SRV_RANK_SENT, SRV_RANK_CHECK = 32, 128, 32  # phase 19: clients, sentences
SRV_RANK_BATCH, SRV_RANK_MAXLEN = 32, 60  # -batch_size, max_length (beam 4, pallas_step 1)
SRV_RANK_TIMEOUT_S = 300  # phase 19: the two ranks, start-up included
SRV_RANK_ROWS = ("gru_layer_scan", "decode_step")
EXTRACT_CHECK, EXTRACT_BATCH, EXTRACT_PARTIAL = 4, 32, 37  # phase 18 (a), (b)
EXTRACT_TOL, EXTRACT_CLI_TOL = 1e-4, 1e-5  # relative to each output's largest entry
EXTRACT_TURNS, EXTRACT_ITERS = ("f32", "tf32", "tf32", "f32"), 10  # phase 18 (c)
EXTRACT_CLI_IMAGES, EXTRACT_SENT = 64, 32  # phase 18 (d), (f)
H100_TF32_FLOPS = 494.7e12  # dense TF32 tensor-core peak (NVIDIA data sheet, SXM)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time of one call, by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, warmup: int = 3) -> Optional[float]:
    """Mean device time of one call: the time of the CUDA kernels that
    ``torch.profiler`` records over ``iters`` calls, without the host's
    cost of launching them (None: the profiler recorded none)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                             torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / iters if us else None


def bound(n_bytes: float, flops: float, dtype: str):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    FLOPs over the peak rate of the dtype."""
    peak = H100_BF16_FLOPS if dtype == "bfloat16" else H100_F32_FLOPS
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def scan_fwd_bound(B: int, T: int, H: int):
    """Bound of the GRU-scan forward in bf16: x_proj, mask, h0, Wh, bh in;
    outs and final (f32) out; one (B*T, H) x (H, 3H) product."""
    n_bytes = B * T * 3 * H * 2 + B * T * 4 + B * H * 4 + H * 3 * H * 2 + 3 * H * 4 \
        + B * T * H * 4 + B * H * 4
    return bound(n_bytes, 2.0 * B * T * H * 3 * H, "bfloat16")


def scan_bwd_bound(B: int, T: int, H: int):
    """Bound of the GRU-scan backward in bf16."""
    b = 2  # bf16 bytes
    n_bytes = (B * T * 3 * H * b + B * T * 4 + B * H * 4 + H * 3 * H * b + 3 * H * 4
               + 2 * B * T * H * 4  # outs, g
               + B * T * 3 * H * 4 + B * H * 4 + H * 3 * H * 4 + 3 * H * 4)  # dx, dh0, dWh, dbh
    # gate recompute, dh_proj @ Wh^T, h_prev^T dh_proj: three (B*T, H) x (H, 3H) products
    return bound(n_bytes, 3 * 2.0 * B * T * H * 3 * H, "bfloat16")


def decoder_bounds(B: int, T: int, S: int, H: int):
    """Bounds of the decoder sequence forward and backward in bf16."""
    b = 2  # bf16 bytes
    ins = (B * T * 3 * H * b + B * T * H * b + 2 * B * H * 4 + 4 * H * 3 * H * b + 3 * 3 * H * 4
           + 2 * B * S * H * b + H * H * b)
    streams = 3 * B * T * H * b + B * T * S * b  # attn_hs, h0s, h1s, probs
    # the first step has no feed, so its feed product is skipped
    fwd_flops = T * (4 * 2.0 * B * H * 3 * H + 2.0 * B * H * H + 4.0 * B * S * H) \
        - 2.0 * B * H * 3 * H
    bwd_bytes = (ins + streams + B * T * H * 4 + B * T * S * 4  # + d_attn, d_probs
                 + 4 * B * T * 3 * H * 4 + B * T * H * 4 + B * T * S * 4 + 2 * B * H * 4)
    # two gate recomputes (two products each), four products with W^T of
    # (B, 3H) x (3H, H), dq, and the two attention contractions
    bwd_flops = T * (8 * 2.0 * B * H * 3 * H + 2.0 * B * H * H + 4.0 * B * S * H) \
        - 2.0 * B * H * 3 * H
    return (bound(ins + B * S * 4 + streams, fwd_flops, "bfloat16"),
            bound(bwd_bytes, bwd_flops, "bfloat16"))


def step_bounds(N: int, S: int, H: int):
    """Bounds of the decode step and of the GRU chain in bf16."""
    b = 2  # bf16 bytes
    chain_bytes = N * 3 * H * b + 3 * N * H * b + 4 * H * 3 * H * b + 3 * 3 * H * 4 + 2 * N * H * b
    chain_flops = 2.0 * N * H * 3 * H * 4
    step_bytes = chain_bytes + H * H * b + 2 * N * S * H * b + N * S * 4 + N * H * b + N * S * b
    step_flops = chain_flops + 2.0 * N * H * H + 4.0 * N * S * H
    return bound(step_bytes, step_flops, "bfloat16"), bound(chain_bytes, chain_flops, "bfloat16")


def max_err(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))


def check_close(name: str, dtype: str, err: float, what: str = "max_abs_err") -> None:
    ok = math.isfinite(err) and err <= TOL[dtype]
    print(f"  {name} {dtype}: {what} {err:.3e} (tolerance {TOL[dtype]:.0e}) "
          f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} kernel disagrees with its plain version in {dtype}")


def rel_err(got, want) -> float:
    """max over tensors of max|got - want| / max|want|."""
    return max(float((g.float() - w.float()).abs().max()) / max(float(w.float().abs().max()),
                                                                1e-30)
               for g, w in zip(got, want))


def deterministic(name: str, fn) -> None:
    """Two launches on the same inputs must agree bit for bit: a missing
    cluster or grid barrier can hide inside a tolerance, not here."""
    first, second = fn(), fn()
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    print(f"  {name} bfloat16: two launches bit-identical: {'ok' if same else 'MISMATCH'}")
    if not same:
        fail(f"{name} kernel gives different outputs for the same inputs")


def print_plan(name: str, plan: dict) -> None:
    print(f"  {name} launch plan: " + ", ".join(f"{k} {v}" for k, v in plan.items()))


def scan_bwd_inputs(g, dt, B, T, H, min_len):
    """Inputs of the scan backward, lengths uniform in min_len..T; with
    min_len 0 row 2 is all padding."""
    lengths = torch.randint(max(min_len, 1), T + 1, (B,), generator=g, device="cuda")
    if min_len == 0:
        lengths[2] = 0
    mask = (torch.arange(T, device="cuda")[None, :] < lengths[:, None]).float()
    return (torch.randn(B, T, 3 * H, generator=g, device="cuda").to(dt), mask,
            torch.zeros(B, H, device="cuda"),
            (torch.randn(H, 3 * H, generator=g, device="cuda") / math.sqrt(H)).to(dt),
            0.1 * torch.randn(3 * H, generator=g, device="cuda"),
            torch.randn(B, T, H, generator=g, device="cuda"))


def reset_stream(rng, mask):
    """(B,T) f32 resets where packing puts segment starts: every row's t=0
    and 2-3 more starts among its real positions (pads are at the row's
    end), and a reset on the first padded step of every padded row."""
    B, T = mask.shape
    lengths = mask.sum(1).long().tolist()
    reset = np.zeros((B, T), np.float32)
    reset[:, 0] = 1.0
    for b, n in enumerate(lengths):
        if n > 1:
            reset[b, 1 + rng.permutation(n - 1)[:min(n - 1, int(rng.integers(2, 4)))]] = 1.0
        if n < T:
            reset[b, n] = 1.0  # on a masked step
    return torch.from_numpy(reset).to("cuda")


def reset_inputs(g, rng, dt, B, T, H, min_len):
    """Scan inputs (x, mask, h0, wh, bh), a cotangent of outs, and a reset
    stream; h0 not zero, so that a reset that is missed shows."""
    x, mask, _, wh, bh, gout = scan_bwd_inputs(g, dt, B, T, H, min_len)
    h0 = 0.1 * torch.randn(B, H, generator=g, device="cuda")
    return (x, mask, h0, wh, bh), gout, reset_stream(rng, mask)


def reset_errs(gru_scan, ins, gout, reset):
    """Forward (max abs err) and backward (max rel err, max abs err) of the
    reset kernels against their plain versions, both directions."""
    fwd, bwd, bwd_abs = [], [], []
    for reverse in (False, True):
        got = gru_scan.gru_layer_scan(*ins, reverse, reset)
        want = gru_scan.gru_layer_scan_ref(*ins, reverse, reset)
        got_b = gru_scan.gru_layer_scan_bwd(*ins, want[0], gout, reverse, reset)
        want_b = gru_scan.gru_layer_scan_bwd_ref(*ins, want[0], gout, reverse, reset)
        torch.cuda.synchronize()
        fwd.append(max_err(got, want))
        bwd.append(rel_err(got_b, want_b))
        bwd_abs.append(max_err(got_b, want_b))
    return max(fwd), max(bwd), max(bwd_abs)


def in_turns(name: str, fns: dict, iters: int = 20) -> dict:
    """Event times of each variant, two runs each in turns (a b b a), and
    their means."""
    order = list(fns) + list(fns)[::-1]
    runs = {k: [] for k in fns}
    for k in order:
        runs[k].append(cuda_ms(fns[k], iters=iters))
    out = {f"{k}_ms": float(np.mean(v)) for k, v in runs.items()}
    out["runs_ms"] = runs
    print(f"  {name}: " + ", ".join(f"{k} {np.mean(v):.4f} ms (runs "
                                    + " ".join(f"{r:.4f}" for r in v) + ")"
                                    for k, v in runs.items()))
    return out


def scan_reset_checks(gru_scan):
    """The reset stream of both GRU-scan kernels (sequence packing) against
    their plain versions at the packed path's shape (B=64, T=64, H=250), f32
    and bf16, both directions; at B=61 (a row all padding) and T=1;
    bit-identical repeats; times beside the reset-free launch on the same
    inputs and the bounds. Returns (forward record, backward record)."""
    B, T, H = (PACK_SCAN_SHAPE[k] for k in ("B", "T", "H"))
    g = torch.Generator(device="cuda").manual_seed(5)
    rng = np.random.default_rng(5)
    fwd, bwd = {}, {}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        ins, gout, reset = reset_inputs(g, rng, dt, B, T, H, 8)
        fwd[f"err_{dt_name}"], bwd[f"err_{dt_name}"], bwd[f"abs_err_{dt_name}"] = \
            reset_errs(gru_scan, ins, gout, reset)
        check_close(f"gru_scan with reset B={B} T={T}", dt_name, fwd[f"err_{dt_name}"])
        check_close(f"gru_scan_bwd with reset B={B} T={T}", dt_name, bwd[f"err_{dt_name}"],
                    "max_rel_err")
        edges = [reset_errs(gru_scan, *reset_inputs(g, rng, dt, b, t, H, 0))
                 for b, t in ((61, T), (B, 1))]
        fwd[f"edge_err_{dt_name}"] = max(e[0] for e in edges)
        bwd[f"edge_err_{dt_name}"] = max(e[1] for e in edges)
        check_close("gru_scan with reset B=61 and T=1, a row all padding", dt_name,
                    fwd[f"edge_err_{dt_name}"])
        check_close("gru_scan_bwd with reset B=61 and T=1, a row all padding", dt_name,
                    bwd[f"edge_err_{dt_name}"], "max_rel_err")
    outs, _ = gru_scan.gru_layer_scan_ref(*ins, True, reset)
    deterministic("gru_scan with reset", lambda: gru_scan.gru_layer_scan(*ins, True, reset))
    deterministic("gru_scan_bwd with reset",
                  lambda: gru_scan.gru_layer_scan_bwd(*ins, outs, gout, True, reset))
    n_starts = int(reset.sum())
    print(f"  reset stream B={B} T={T}: {n_starts} resets, "
          f"{int((reset * (1 - ins[1])).sum())} of them on masked steps")
    # bf16 times, reset against reset-free on the same inputs, in turns
    fwd.update(in_turns(f"gru_scan B={B} T={T} bfloat16", {
        "no_reset": lambda: gru_scan.gru_layer_scan(*ins, True),
        "reset": lambda: gru_scan.gru_layer_scan(*ins, True, reset)}))
    bwd.update(in_turns(f"gru_scan_bwd B={B} T={T} bfloat16", {
        "no_reset": lambda: gru_scan.gru_layer_scan_bwd(*ins, outs, gout, True),
        "reset": lambda: gru_scan.gru_layer_scan_bwd(*ins, outs, gout, True, reset)}))
    fwd["ms"], bwd["ms"] = fwd.pop("reset_ms"), bwd.pop("reset_ms")
    fwd["plain_ms"] = cuda_ms(lambda: gru_scan.gru_layer_scan_ref(*ins, True, reset), iters=5)
    bwd["plain_ms"] = cuda_ms(
        lambda: gru_scan.gru_layer_scan_bwd_ref(*ins, outs, gout, True, reset), iters=5)
    b = 2  # bf16 bytes
    ins_bytes = B * T * 3 * H * b + 2 * B * T * 4 + B * H * 4 + H * 3 * H * b + 3 * H * 4
    fwd["bound_ms"], fwd["bound_by"] = bound(ins_bytes + B * T * H * 4 + B * H * 4,
                                             2.0 * B * T * H * 3 * H, "bfloat16")
    bwd_bytes = (ins_bytes + 2 * B * T * H * 4  # outs, g
                 + B * T * 3 * H * 4 + B * H * 4 + H * 3 * H * 4 + 3 * H * 4)  # dx, dh0, dWh, dbh
    bwd["bound_ms"], bwd["bound_by"] = bound(bwd_bytes, 3 * 2.0 * B * T * H * 3 * H, "bfloat16")
    bwd["plan"] = gru_scan.gru_layer_scan_bwd.plan
    fwd["plan"] = gru_scan.gru_layer_scan.plan
    print_plan(f"gru_scan with reset B={B} T={T}", fwd["plan"])
    for name, rec in (("gru_scan", fwd), ("gru_scan_bwd", bwd)):
        print(f"  {name} with reset B={B} T={T} bfloat16: kernel {rec['ms']:.4f} ms "
              f"(reset-free {rec['no_reset_ms']:.4f}, {rec['ms'] / rec['no_reset_ms'] - 1:+.1%}), "
              f"plain {rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms "
              f"({rec['bound_by']})")
    return fwd, bwd


def scan_bwd_errs(gru_scan, args):
    """(max rel err, max abs err) of the kernel against the plain version,
    both directions."""
    *ins, gout = args
    errs, abs_errs = [], []
    for reverse in (False, True):
        outs, _ = gru_scan.gru_layer_scan_ref(*ins, reverse)
        got = gru_scan.gru_layer_scan_bwd(*ins, outs, gout, reverse)
        want = gru_scan.gru_layer_scan_bwd_ref(*ins, outs, gout, reverse)
        torch.cuda.synchronize()
        errs.append(rel_err(got, want))
        abs_errs.append(max_err(got, want))
    return max(errs), max(abs_errs), outs


def cudnn_bwd_ms(g, B: int, T: int, H: int) -> Tuple[Optional[float], float]:
    """cuDNN's nn.GRU backward in bf16 (which also computes the
    input-projection gradients that the port leaves to cuBLAS): (ms on the
    device's clock, eager ms by CUDA events)."""
    gru = torch.nn.GRU(2 * H, H, batch_first=True, device="cuda", dtype=torch.bfloat16)
    gru.flatten_parameters()
    xin = torch.randn(B, T, 2 * H, generator=g, device="cuda").to(torch.bfloat16)
    xin.requires_grad_(True)
    y, _ = gru(xin)
    gy = torch.randn(y.shape, generator=g, device="cuda").to(torch.bfloat16)
    call = lambda: torch.autograd.grad(y, [xin, *gru.parameters()], gy,  # noqa: E731
                                       retain_graph=True)
    return device_ms(call), cuda_ms(call)


def scan_bwd_phase(gru_scan, shape):
    """GRU-scan backward at ``shape`` (B, T, H), both directions; then a
    ragged batch (B=61, row 2 all padding) and T=1, and determinism."""
    B, T, H = shape["B"], shape["T"], shape["H"]
    at = f"B={B} T={T} H={H}"
    g = torch.Generator(device="cuda").manual_seed(3)
    rec = {}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        args = scan_bwd_inputs(g, dt, B, T, H, 8)
        err, abs_err, outs = scan_bwd_errs(gru_scan, args)
        check_close(f"gru_scan_bwd {at}", dt_name, err, "max_rel_err")
        rec[f"err_{dt_name}"], rec[f"abs_err_{dt_name}"] = err, abs_err
        edge = max(scan_bwd_errs(gru_scan, scan_bwd_inputs(g, dt, b, t, H, 0))[0]
                   for b, t in ((61, T), (B, 1)))
        check_close(f"gru_scan_bwd H={H}, B=61 and T=1, a row all padding", dt_name, edge,
                    "max_rel_err")
        rec[f"edge_err_{dt_name}"] = edge
    x, mask, h0, wh, bh, gout = args
    args = (x, mask, h0, wh, bh, outs, gout, True)
    deterministic(f"gru_scan_bwd {at}", lambda: gru_scan.gru_layer_scan_bwd(*args))
    rec["plan"] = gru_scan.gru_layer_scan_bwd.plan
    print_plan(f"gru_scan_bwd {at}", rec["plan"])
    rec["ms"] = cuda_ms(lambda: gru_scan.gru_layer_scan_bwd(*args))
    rec["plain_ms"] = cuda_ms(lambda: gru_scan.gru_layer_scan_bwd_ref(*args), iters=5)
    rec["library_ms"], rec["library_eager_ms"] = cudnn_bwd_ms(g, B, T, H)
    rec["bound_ms"], rec["bound_by"] = scan_bwd_bound(B, T, H)
    print(f"  gru_scan_bwd {at} bfloat16: kernel {rec['ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.3f} ms, nn.GRU backward {fmt_ms(rec['library_ms'])} on the "
          f"device's clock (eager, host-bound: {rec['library_eager_ms']:.4f} ms), bound "
          f"{rec['bound_ms']:.4f} ms")
    return rec


def decoder_inputs(g, dt, B, T, S, H, mem_std):
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    w = lambda *s: (r(*s) / math.sqrt(H)).to(dt)  # noqa: E731
    dmid = ((torch.rand(B, T, H, generator=g, device="cuda") > 0.3).float() / 0.7).to(dt)
    lengths = torch.randint(8, S + 1, (B,), generator=g, device="cuda")
    mask_bias = (torch.arange(S, device="cuda")[None, :] >= lengths[:, None]).float() * -1e9
    return (r(B, T, 3 * H).to(dt), dmid, torch.tanh(r(B, H)), torch.tanh(r(B, H)),
            w(H, 3 * H), w(H, 3 * H), 0.1 * r(3 * H), w(H, 3 * H), 0.1 * r(3 * H),
            w(H, 3 * H), 0.1 * r(3 * H), (mem_std * r(B, S, H)).to(dt),
            (mem_std * r(B, S, H)).to(dt), w(H, H), mask_bias)


def decoder_phase(dec, shape):
    """Decoder sequence forward and backward at ``shape`` (B, T, S, H);
    then both at B=61 and at T=1 (the forward with a source of one real
    position), their determinism, and the peaked-attention checks."""
    B, T, S, H = (shape[k] for k in ("B", "T", "S", "H"))
    at = f"B={B} T={T} S={S} H={H}"
    g = torch.Generator(device="cuda").manual_seed(4)
    kernel = (dec.decoder_fwd, dec.decoder_bwd)
    plain = (dec.decoder_fwd_ref, dec.decoder_bwd_ref)

    def draw(dt, mem_std, B=B, T=T):
        """Inputs, the forward streams the backward reads, and cotangents."""
        args = decoder_inputs(g, dt, B, T, S, H, mem_std)
        d = (torch.randn(B, T, H, generator=g, device="cuda"),
             torch.randn(B, T, S, generator=g, device="cuda"))
        return args, dec.decoder_fwd_ref(*args), d

    def both(fns, args, streams, d):
        out = fns[0](*args), fns[1](*args[:14], *streams, *d)
        torch.cuda.synchronize()
        return out

    fwd, bwd = {}, {}
    for dt_name in ("float32", "bfloat16"):
        args, streams, d = draw(getattr(torch, dt_name), DEC_MEM_STD)
        (got, got_b), (want, want_b) = both(kernel, args, streams, d), both(plain, args, streams, d)
        for rec, gw in ((fwd, (got, want)), (bwd, (got_b, want_b))):
            rec[f"err_{dt_name}"] = rel_err(*gw)
            rec[f"abs_err_{dt_name}"] = max_err(*gw)
        check_close(f"decoder_fwd {at}", dt_name, fwd[f"err_{dt_name}"], "max_rel_err")
        check_close(f"decoder_bwd {at}", dt_name, bwd[f"err_{dt_name}"], "max_rel_err")
        edge, edge_f = [], []
        for b, t in ((61, T), (B, 1)):
            a, st, dd = draw(getattr(torch, dt_name), DEC_MEM_STD, b, t)
            edge.append(rel_err(dec.decoder_bwd(*a[:14], *st, *dd),
                                dec.decoder_bwd_ref(*a[:14], *st, *dd)))
            mask_bias = a[14].clone()
            mask_bias[2, 1:] = -1e9  # a source of one real position
            edge_f.append(rel_err(dec.decoder_fwd(*a[:14], mask_bias),
                                  dec.decoder_fwd_ref(*a[:14], mask_bias)))
        check_close(f"decoder_fwd H={H}, B=61 and T=1, a source of one position", dt_name,
                    max(edge_f), "max_rel_err")
        check_close(f"decoder_bwd H={H}, B=61 and T=1", dt_name, max(edge), "max_rel_err")
        fwd[f"edge_err_{dt_name}"], bwd[f"edge_err_{dt_name}"] = max(edge_f), max(edge)
    bargs = (*args[:14], *streams, *d)  # bf16, for the times below
    deterministic(f"decoder_fwd {at}", lambda: dec.decoder_fwd(*args))
    deterministic(f"decoder_bwd {at}", lambda: dec.decoder_bwd(*bargs))
    fwd["plan"], bwd["plan"] = dec.decoder_fwd.plan, dec.decoder_bwd.plan
    print_plan(f"decoder_fwd {at}", fwd["plan"])
    print_plan(f"decoder_bwd {at}", bwd["plan"])

    # peaked attention: kernel against plain over the first steps each pass
    # processes, and each bf16 version against the f32 math of its inputs
    a16, s16, d = draw(torch.bfloat16, DEC_MEM_STD_PEAKED)
    k, p = both(kernel, a16, s16, d), both(plain, a16, s16, d)
    x = both(plain, tuple(a.float() for a in a16), tuple(t.float() for t in s16), d)
    first = (range(PEAKED_STEPS), range(T - PEAKED_STEPS, T))  # forward, backward
    for i, (name, rec) in enumerate((("decoder_fwd", fwd), ("decoder_bwd", bwd))):
        dk, dp = rel_err(k[i], x[i]), rel_err(p[i], x[i])
        ks, ps = [a for a in k[i] if a.dim() == 3], [a for a in p[i] if a.dim() == 3]
        per_step = [rel_err([a[:, t] for a in ks], [a[:, t] for a in ps]) for t in range(T)]
        early = max(per_step[t] for t in first[i])
        rec["peaked"] = {"kernel_vs_f32": dk, "plain_vs_f32": dp, "first_steps": early,
                         "per_step": per_step}
        ok_early = math.isfinite(early) and early <= TOL["bfloat16"]
        ok_drift = math.isfinite(dk) and dk <= PEAKED_DRIFT_RATIO * dp
        print(f"  {name} {at} bfloat16, memory std {DEC_MEM_STD_PEAKED}: max_rel_err over the first "
              f"{PEAKED_STEPS} steps {early:.3e} (tolerance {TOL['bfloat16']:.0e}) "
              f"{'ok' if ok_early else 'MISMATCH'}; by step t "
              + " ".join(f"{e:.1e}" for e in per_step))
        print(f"  {name} {at} bfloat16, memory std {DEC_MEM_STD_PEAKED}: distance from the f32 math "
              f"{dk:.3e} (kernel) vs {dp:.3e} (plain), ratio {dk / dp:.2f} (limit "
              f"{PEAKED_DRIFT_RATIO}) {'ok' if ok_drift else 'MISMATCH'}")
        if not ok_early:
            fail(f"{name} kernel disagrees with its plain version over the first steps at "
                 f"memory std {DEC_MEM_STD_PEAKED}")
        if not ok_drift:
            fail(f"{name} kernel is further from the f32 math than {PEAKED_DRIFT_RATIO} times "
                 f"the plain version")
    fwd["ms"] = cuda_ms(lambda: dec.decoder_fwd(*args))
    fwd["plain_ms"] = cuda_ms(lambda: dec.decoder_fwd_ref(*args), iters=5)
    bwd["ms"] = cuda_ms(lambda: dec.decoder_bwd(*bargs))
    bwd["plain_ms"] = cuda_ms(lambda: dec.decoder_bwd_ref(*bargs), iters=5)
    fwd["library_ms"] = bwd["library_ms"] = None
    (fwd["bound_ms"], fwd["bound_by"]), (bwd["bound_ms"], bwd["bound_by"]) = \
        decoder_bounds(B, T, S, H)
    for name, rec in (("decoder_fwd", fwd), ("decoder_bwd", bwd)):
        print(f"  {name} {at} bfloat16: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.3f} "
              f"ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})")
    return fwd, bwd


def scan_inputs(g, dt, B, T, H, min_len):
    """Inputs of the scan forward, lengths uniform in min_len..T; with
    min_len 0 row 2 is all padding."""
    return scan_bwd_inputs(g, dt, B, T, H, min_len)[:5]


def scan_timing(gru_scan, g, B, T, H):
    """Kernel, plain version and cuDNN's nn.GRU forward (which also does the
    input projection that the port leaves to cuBLAS) at one shape in bf16,
    the bound and the launch plan."""
    x, mask, h0, wh, bh = scan_inputs(g, torch.bfloat16, B, T, H, 8)
    h0 = 0.1 * torch.randn(B, H, generator=g, device="cuda")
    rec = {"ms": cuda_ms(lambda: gru_scan.gru_layer_scan(x, mask, h0, wh, bh, True))}
    rec["plan"] = gru_scan.gru_layer_scan.plan
    rec["plain_ms"] = cuda_ms(lambda: gru_scan.gru_layer_scan_ref(x, mask, h0, wh, bh, True),
                              iters=5)
    gru = torch.nn.GRU(2 * H, H, batch_first=True, device="cuda", dtype=torch.bfloat16)
    xin = torch.randn(B, T, 2 * H, generator=g, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        rec["library_ms"] = device_ms(lambda: gru(xin))
        rec["library_eager_ms"] = cuda_ms(lambda: gru(xin))
    rec["bound_ms"], rec["bound_by"] = scan_fwd_bound(B, T, H)
    print_plan(f"gru_scan B={B} T={T}", rec["plan"])
    print(f"  gru_scan B={B} T={T} bfloat16: kernel {rec['ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.3f} ms, nn.GRU forward {fmt_ms(rec['library_ms'])} on the "
          f"device's clock (eager, host-bound: {rec['library_eager_ms']:.4f} ms), bound "
          f"{rec['bound_ms']:.4f} ms")
    return rec


def scan_phase(gru_scan, shape, timed):
    """GRU scan at ``shape`` (B, T, H), both directions; then a ragged batch
    (B=61, row 2 all padding) and T=1, determinism, and the times at each
    shape of ``timed`` ({label: shape}, H that of ``shape``); the record's
    top-level times are the first label's."""
    B, T, H = shape["B"], shape["T"], shape["H"]
    at = f"B={B} T={T} H={H}"
    g = torch.Generator(device="cuda").manual_seed(1)
    rec = {}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        errs, edge = [], []
        for b, t, min_len, out in ((B, T, 8, errs), (61, T, 0, edge), (B, 1, 0, edge)):
            x, mask, h0, wh, bh = scan_inputs(g, dt, b, t, H, min_len)
            h0 = 0.1 * torch.randn(b, H, generator=g, device="cuda")
            for reverse in (False, True):
                got = gru_scan.gru_layer_scan(x, mask, h0, wh, bh, reverse)
                want = gru_scan.gru_layer_scan_ref(x, mask, h0, wh, bh, reverse)
                torch.cuda.synchronize()
                out.append(max_err(got, want))
        check_close(f"gru_scan {at}", dt_name, max(errs))
        check_close(f"gru_scan H={H}, B=61 and T=1, a row all padding", dt_name, max(edge))
        rec[f"err_{dt_name}"], rec[f"edge_err_{dt_name}"] = max(errs), max(edge)
    args = scan_inputs(g, torch.bfloat16, 61, T, H, 0)
    deterministic(f"gru_scan {at}", lambda: gru_scan.gru_layer_scan(*args, True))
    shapes = {k: scan_timing(gru_scan, g, s["B"], s["T"], H) for k, s in timed.items()}
    rec.update(shapes[next(iter(timed))])
    rec["by_shape"] = shapes
    return rec


def step_inputs(g, dt, N, S, H):
    r = lambda *s: torch.randn(*s, generator=g, device="cuda")  # noqa: E731
    lengths = torch.randint(8, S + 1, (N,), generator=g, device="cuda")
    mask_bias = (torch.arange(S, device="cuda")[None, :] >= lengths[:, None]).float() * -1e9
    w = lambda *s: (r(*s) / math.sqrt(H)).to(dt)  # noqa: E731
    chain = (r(N, 3 * H).to(dt), torch.tanh(r(N, H)).to(dt), torch.tanh(r(N, H)).to(dt),
             torch.tanh(r(N, H)).to(dt), w(H, 3 * H), w(H, 3 * H), 0.1 * r(3 * H),
             w(H, 3 * H), 0.1 * r(3 * H), w(H, 3 * H), 0.1 * r(3 * H))
    attn = ((0.5 * r(N, S, H)).to(dt), (0.5 * r(N, S, H)).to(dt), w(H, H), mask_bias)
    return chain, attn


def step_phase(ds, shape):
    """Decode step and GRU chain at ``shape`` (N, S, H); then N=1000 and
    N=3 with a row whose source is all padding, and determinism."""
    N, S, H = shape["N"], shape["S"], shape["H"]
    at = f"N={N} S={S} H={H}"
    g = torch.Generator(device="cuda").manual_seed(2)
    step_rec, chain_rec = {}, {}
    for dt_name in ("float32", "bfloat16"):
        dt = getattr(torch, dt_name)
        edge_s, edge_c = [], []
        for n in (1000, 3):
            chain, attn = step_inputs(g, dt, n, S, H)
            attn[3][min(2, n - 1)] = -1e9  # a row whose source is all padding
            edge_s.append(max_err(ds.decode_step(*chain, *attn), ds.decode_step_ref(*chain, *attn)))
            edge_c.append(max_err(ds.gru_chain(*chain), ds.gru_chain_ref(*chain)))
        chain, attn = step_inputs(g, dt, N, S, H)
        got = ds.decode_step(*chain, *attn)
        want = ds.decode_step_ref(*chain, *attn)
        got_c = ds.gru_chain(*chain)
        want_c = ds.gru_chain_ref(*chain)
        torch.cuda.synchronize()
        for rec, err, edge in ((step_rec, max_err(got, want), edge_s),
                               (chain_rec, max_err(got_c, want_c), edge_c)):
            rec[f"err_{dt_name}"], rec[f"edge_err_{dt_name}"] = err, max(edge)
        check_close(f"decode_step {at}", dt_name, step_rec[f"err_{dt_name}"])
        check_close(f"gru_chain {at}", dt_name, chain_rec[f"err_{dt_name}"])
        check_close(f"decode_step H={H}, N=1000 and N=3, a source all padding", dt_name,
                    max(edge_s))
        check_close(f"gru_chain H={H}, N=1000 and N=3", dt_name, max(edge_c))
    deterministic(f"decode_step {at}", lambda: ds.decode_step(*chain, *attn))
    deterministic(f"gru_chain {at}", lambda: ds.gru_chain(*chain))
    step_rec["ms"] = cuda_ms(lambda: ds.decode_step(*chain, *attn))
    step_rec["plan"] = ds.decode_step.plan
    step_rec["plain_ms"] = cuda_ms(lambda: ds.decode_step_ref(*chain, *attn))
    chain_rec["ms"] = cuda_ms(lambda: ds.gru_chain(*chain))
    chain_rec["plan"] = ds.gru_chain.plan
    chain_rec["plain_ms"] = cuda_ms(lambda: ds.gru_chain_ref(*chain))
    print_plan(f"decode_step cells {at}", step_rec["plan"])
    (step_rec["bound_ms"], step_rec["bound_by"]), (chain_rec["bound_ms"], chain_rec["bound_by"]) \
        = step_bounds(N, S, H)
    step_rec["library_ms"] = None  # no one PyTorch call: cells and attention
    # row 4 beside cuDNN on the device's clock: eager back-to-back calls of
    # nn.GRU time the host's cost of its call, not the card's work
    chain_rec["device_ms"] = device_ms(lambda: ds.gru_chain(*chain))
    chain_rec["library_ms"], chain_rec["library_eager_ms"] = gru_chain_library_ms(N, H)
    for name, rec in (("decode_step", step_rec), ("gru_chain", chain_rec)):
        lib = "" if name == "decode_step" else (
            f", on the device's clock (torch.profiler) kernel {fmt_ms(rec['device_ms'])}, cuDNN "
            f"2-layer nn.GRU one step {fmt_ms(rec['library_ms'])} (eager, host-bound: "
            f"{rec['library_eager_ms']:.4f} ms)")
        print(f"  {name} {at} bfloat16: kernel {rec['ms']:.4f} ms, plain {rec['plain_ms']:.3f} "
              f"ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}){lib}")
    return step_rec, chain_rec


def fmt_ms(ms: Optional[float]) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def gru_chain_library_ms(N: int, H: int) -> Tuple[Optional[float], float]:
    """bf16 ms of cuDNN's 2-layer ``nn.GRU`` over one step of N rows on
    [emb; feed] (emb width H, as at both shapes): the GRU chain's function,
    plus layer 0's input projection, which the chain takes precomputed.
    Returns (device time, eager time by CUDA events)."""
    gru = torch.nn.GRU(2 * H, H, num_layers=2, batch_first=True, device="cuda",
                       dtype=torch.bfloat16)
    g = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(N, 1, 2 * H, generator=g, device="cuda").to(torch.bfloat16)
    h = torch.tanh(torch.randn(2, N, H, generator=g, device="cuda")).to(torch.bfloat16)
    with torch.no_grad():
        return device_ms(lambda: gru(x, h)), cuda_ms(lambda: gru(x, h))


def well_formed(out, n_sent: int, vocab_size: int, max_length: int) -> None:
    if len(out) != n_sent:
        fail(f"{len(out)} results for {n_sent} sentences")
    for nbest in out:
        score, ids = nbest[0]
        if not math.isfinite(score):
            fail(f"non-finite score {score}")
        if len(ids) > max_length or any(not (0 < i < vocab_size) for i in ids):
            fail(f"malformed hypothesis {ids[:10]}...")


def load_flagship():
    """The port's vmmt_c config and its random weights (numpy seed 0)."""
    from variational_mmt_torch.tools import flagship

    t0 = time.time()
    cfg, state = flagship.load()
    m = cfg.model
    print(f"flagship: vmmt_c emb {m.emb_dim} hidden {m.hidden_dim} layers "
          f"{m.enc_layers}+{m.dec_layers} latent {m.latent_dim} img {m.img_feat_dim} "
          f"vocab {m.src_vocab_size}/{m.tgt_vocab_size} {m.compute_dtype} "
          f"use_pallas={m.use_pallas} fused_ce={m.fused_ce}; weights from numpy seed 0 "
          f"in {time.time() - t0:.1f} s")
    return cfg, state


def slice_phase(card: str, cfg, state):
    from variational_mmt_torch.config import DecodeConfig
    from variational_mmt_torch.data.vocab import SPECIALS, Vocab
    from variational_mmt_torch.decode.translator import Translator
    from variational_mmt_torch.models.model import build_model
    from variational_mmt_torch.ops import decode_step as ds, gru_scan
    from variational_mmt_torch.tools import flagship

    V = cfg.tgt_vocab_size
    model = build_model(cfg, device="cuda")
    model.load_state_dict(state)
    vocab = Vocab(SPECIALS + [f"w{i}" for i in range(V - len(SPECIALS))])

    request = flagship.requests(cfg)
    requests = [request(256) for _ in range(3)]
    translators = {m: Translator(model, vocab, vocab,
                                 DecodeConfig(beam_size=4, max_length=60, batch_size=256,
                                              pallas_step=m), device="cuda")
                   for m in (0, 1, 2)}
    for m, tr in translators.items():  # warm-up: library load, cuBLAS handles
        tr.translate_ids(*request(8))

    top1_lengths = []

    def serve(mode):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for src, img in requests:
            out = translators[mode].translate_ids(src, img)
            well_formed(out, len(src), V, 60)
            top1_lengths.extend(len(nbest[0][1]) for nbest in out)
        torch.cuda.synchronize()
        return sum(len(s) for s, _ in requests) / (time.perf_counter() - t)

    counters = (gru_scan.gru_layer_scan, ds.decode_step, ds.gru_chain)
    for fn in counters:
        fn.launches = 0
    runs = {1: [serve(1)], 2: [serve(2)], 0: []}
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"slice: launches on the main path {launches}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    for m in (0, 0, 2, 1):  # in turns: 1 2 0 0 2 1
        runs[m].append(serve(m))
    rate = {m: sum(r) / len(r) for m, r in runs.items()}
    print(f"slice: mean top-1 hypothesis length {np.mean(top1_lengths):.2f} tokens "
          f"(max_length 60)")
    for m in (0, 1, 2):
        print(f"slice: beam-4 sent/s pallas_step={m}: {rate[m]:.1f} (runs "
              f"{', '.join(f'{r:.1f}' for r in runs[m])}; batch 256, max_length 60, {card})")

    # f32: kernel path against the all-plain path on 32 sentences
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    plain_cfg = dataclasses.replace(cfg32, use_pallas=False)
    src, img = request(32)
    outs = []
    for c, mode in ((cfg32, 1), (plain_cfg, 0)):
        m = build_model(c, device="cuda")
        m.load_state_dict(state)
        tr = Translator(m, vocab, vocab, DecodeConfig(beam_size=4, max_length=60,
                                                      batch_size=32, pallas_step=mode),
                        device="cuda")
        outs.append(tr.translate_ids(src, img))
    same = sum(a[0][1] == b[0][1] for a, b in zip(*outs))
    dscore = max((abs(a[0][0] - b[0][0]) for a, b in zip(*outs) if a[0][1] == b[0][1]),
                 default=float("nan"))
    print(f"slice: f32 kernel path vs all-plain path: {same}/32 identical top-1 "
          f"hypotheses, max score difference {dscore:.2e}")
    if same < 31:
        fail("kernel path and plain path disagree on more than 1 of 32 sentences")
    return launches, rate


def train_batches(cfg):
    """The training cell's 4 fixed batches of 64 sentence pairs (numpy seed 1)."""
    from variational_mmt_torch.tools import flagship

    return flagship.train_batches(cfg.model, TRAIN_BATCHES, TRAIN_BATCH)


def trainer_for(cfg, state, batches, **model_over):
    from variational_mmt_torch.models.model import build_model
    from variational_mmt_torch.train.trainer import Trainer

    c = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model_over))
    model = build_model(c.model, device="cuda")
    model.load_state_dict(state)
    return Trainer(c, model, batches, device="cuda")


def train_phase(card: str, cfg, state):
    """Trainer steps at full width; returns (launches, step numbers)."""
    from variational_mmt_torch.ops import decoder as dec, gru_scan
    from variational_mmt_torch.utils import flops

    batches = train_batches(cfg)
    print(f"train: {len(batches)} batches of {TRAIN_BATCH} pairs, "
          f"{sum(b.n_tokens for b in batches)} target tokens, lengths 8-24, seed 1")
    counters = (gru_scan.gru_layer_scan, gru_scan.gru_layer_scan_bwd, dec.decoder_fwd,
                dec.decoder_bwd)
    trainers = {p: trainer_for(cfg, state, batches, pallas_decoder=p) for p in (True, False)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    hist = trainers[True].train(TRAIN_STEPS)
    launches = {fn.__name__: fn.launches for fn in counters}
    peak = torch.cuda.max_memory_allocated()
    print(f"train: launches on the training path ({TRAIN_STEPS} steps) {launches}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the training path")
    losses = [h["loss"] for h in hist]
    print("train: losses " + " ".join(f"{v:.3f}" for v in losses))
    if not all(math.isfinite(v) for v in losses):
        fail("a training loss is not finite")
    first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    print(f"train: mean loss of the first 4 steps {first:.4f}, of the last 4 {last:.4f}")
    if not last < first:
        fail("the loss did not fall over the training steps")
    print(f"train: peak device memory {peak / 2**20:.1f} MiB "
          f"(torch.cuda.max_memory_allocated, pallas_decoder=True, {card})")

    # a timed run is whole passes over the batches: its mean step does the
    # batches' mean FLOPs
    step_flops = float(np.mean([flops.train_step_flops(cfg.model, b.batch_size, b.src.shape[1],
                                                       b.tgt_in.shape[1]) for b in batches]))
    runs = {True: [], False: []}
    for p in TIMED_ORDER:
        trainers[p].train(TRAIN_BATCHES)  # untimed: no run starts cold after the other route
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = trainers[p].train(TIMED_STEPS)
        wall = time.perf_counter() - t0
        runs[p].append((wall / TIMED_STEPS * 1e3, sum(h["n_tokens"] for h in done) / wall))
    steps = {}
    for p in (True, False):
        ms_runs = [r[0] for r in runs[p]]
        ms = float(np.mean(ms_runs))
        tok = float(np.mean([r[1] for r in runs[p]]))
        spread = (max(ms_runs) - min(ms_runs)) / ms
        mfu = step_flops / (ms / 1e3) / flops.H100_SXM_BF16_DENSE_PEAK
        steps[f"pallas_decoder={int(p)}"] = {"step_ms": ms, "tgt_tok_per_s": tok,
                                             "spread": spread, "runs_ms": ms_runs, "mfu": mfu}
        print(f"train: pallas_decoder={int(p)}: {ms:.2f} ms/step, {tok:.1f} target tok/s, "
              f"MFU {mfu:.4f} ({step_flops / 1e9:.1f} GFLOP a step over 989 TFLOP/s), "
              f"spread {spread:.1%} (runs {', '.join(f'{a:.2f}' for a in ms_runs)} ms; "
              f"batch {TRAIN_BATCH}, {TIMED_STEPS} steps per run, {card})")
    steps["peak_mem_mib"] = peak / 2**20
    return launches, steps


def packed_train_phase(card: str, cfg, state, unpacked: dict):
    """Trainer steps with train.pack on the packed cell's batches at full
    width; every step must launch both GRU-scan kernels 6 times, each with
    a reset stream. Returns (launches, reset launches, step numbers)."""
    from variational_mmt_torch.ops import decoder as dec, gru_scan
    from variational_mmt_torch.tools import flagship

    batches = flagship.packed_batches(cfg.model, TRAIN_BATCHES, TRAIN_BATCH, PACK_ROW, PACK_K)
    for i, b in enumerate(batches):
        print(f"train_packed: batch {i}: {b.n_sentences} sentences, {b.n_tokens} real target "
              f"tokens, fill {b.n_tokens / (TRAIN_BATCH * PACK_ROW):.4f} "
              f"({TRAIN_BATCH} rows of {PACK_ROW}, K={PACK_K}, lengths 8-24, seed 1)")
    c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, pack=True,
                                                           pack_segments=PACK_K))
    trainer = trainer_for(c, state, batches)
    scans = (gru_scan.gru_layer_scan, gru_scan.gru_layer_scan_bwd)
    counters = scans + (dec.decoder_fwd, dec.decoder_bwd)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    for fn in scans:
        fn.reset_launches = 0
    hist = trainer.train(PACKED_STEPS)
    launches = {fn.__name__: fn.launches for fn in counters}
    resets = {fn.__name__: fn.reset_launches for fn in scans}
    peak = torch.cuda.max_memory_allocated()
    print(f"train_packed: launches ({PACKED_STEPS} steps) {launches}, with a reset stream "
          f"{resets} (the decoder takes the plain loop, as in JAX)")
    for name, n in resets.items():
        if n != 6 * PACKED_STEPS or launches[name] != n:
            fail(f"{name}: {n} launches with a reset stream of {launches[name]}, expected "
                 f"6 a step, all with reset")
    losses = [h["loss"] for h in hist]
    print("train_packed: losses " + " ".join(f"{v:.3f}" for v in losses))
    if not all(math.isfinite(v) for v in losses):
        fail("a packed training loss is not finite")
    first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
    print(f"train_packed: mean loss of the first 4 steps {first:.4f}, of the last 4 {last:.4f}")
    if not last < first:
        fail("the packed loss did not fall over the training steps")
    print(f"train_packed: peak device memory {peak / 2**20:.1f} MiB "
          f"(torch.cuda.max_memory_allocated, {card})")
    runs = []
    for _ in range(PACKED_RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        done = trainer.train(PACKED_TIMED_STEPS)
        wall = time.perf_counter() - t0
        runs.append((wall / PACKED_TIMED_STEPS * 1e3, sum(h["n_tokens"] for h in done) / wall))
    ms_runs = [r[0] for r in runs]
    rec = {"step_ms": float(np.mean(ms_runs)),
           "tgt_tok_per_s": float(np.mean([r[1] for r in runs])), "runs_ms": ms_runs, "peak_mem_mib": peak / 2**20,
           "sentences_per_batch": [b.n_sentences for b in batches],
           "tokens_per_batch": [b.n_tokens for b in batches],
           "fill": [b.n_tokens / (TRAIN_BATCH * PACK_ROW) for b in batches]}
    print(f"train_packed: {rec['step_ms']:.2f} ms/step, {rec['tgt_tok_per_s']:.1f} real target "
          f"tok/s (runs {', '.join(f'{a:.2f}' for a in ms_runs)} ms; {PACKED_RUNS} runs of "
          f"{PACKED_TIMED_STEPS} steps, {card})")
    for route, u in unpacked.items():
        if isinstance(u, dict):
            print(f"train_packed: beside the unpacked route {route} of this call: "
                  f"{u['step_ms']:.2f} ms/step, {u['tgt_tok_per_s']:.1f} target tok/s")
    return launches, resets, rec


def packed_check_f32(cfg, state):
    """The sentences of the first PACKED_CHECK_ROWS packed rows, unpacked
    through ``forward`` (kernel route) and packed through ``forward_packed``
    (reset kernels), f32, deterministic, no sampling: the loss within 2e-5
    relative, every gradient within 2e-4 relative and 2e-5 times max(1,
    |largest entry|) absolute."""
    from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator
    from variational_mmt_torch.ops import gru_scan
    from variational_mmt_torch.tools import flagship
    from variational_mmt_torch.train.trainer import batch_tensors, loss_and_grads

    pb = flagship.packed_batches(cfg.model, 1, TRAIN_BATCH, PACK_ROW, PACK_K)[0]
    pb = dataclasses.replace(pb, **{f.name: getattr(pb, f.name)[:PACKED_CHECK_ROWS]
                                    for f in dataclasses.fields(pb)})
    src, tgt, img = [], [], []
    for r, k in zip(*np.nonzero(pb.seg_mask)):
        src.append(pb.src[r][pb.src_seg[r] == k])
        tgt.append(pb.tgt_out[r][pb.tgt_seg[r] == k][:-1])  # without EOS
        img.append(pb.img[r, k])
    unpacked = next(BucketIterator(BinarizedDataset(src, tgt), len(src), [25],
                                   img_feats=np.stack(img)).epoch())
    dev = torch.device("cuda")
    res = {}
    gru_scan.gru_layer_scan.reset_launches = gru_scan.gru_layer_scan_bwd.reset_launches = 0
    for name, batch, pack in (("packed", pb, True), ("unpacked", unpacked, False)):
        c = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, pack=pack))
        tr = trainer_for(c, state, [], compute_dtype="float32", use_pallas=True,
                         pallas_decoder=True, fused_ce=True)
        loss, _, grads = loss_and_grads(tr.cfg, tr.model, batch_tensors(batch, dev), 0, None,
                                        deterministic=True, sample=False)
        res[name] = (float(loss.detach()), [g.detach().clone() for g in grads],
                     [n for n, _ in tr.model.named_parameters()])
    if min(gru_scan.gru_layer_scan.reset_launches, gru_scan.gru_layer_scan_bwd.reset_launches) < 6:
        fail("the packed f32 check did not run the reset kernels")
    (lp, gp, names), (lu, gu, _) = res["packed"], res["unpacked"]
    dloss = abs(lp - lu) / abs(lu)
    worst, worst_name = 0.0, ""
    for n, a, b in zip(names, gp, gu):
        atol = PACKED_TOL["atol"] * max(1.0, float(b.abs().max()))
        ratio = float(((a - b).abs() / (atol + PACKED_TOL["rtol"] * b.abs())).max())
        if ratio > worst:
            worst, worst_name = ratio, n
    print(f"train_packed f32 check: {len(src)} sentences of {PACKED_CHECK_ROWS} packed rows; "
          f"loss packed {lp:.6f} unpacked {lu:.6f} rel diff {dloss:.2e} (tolerance "
          f"{PACKED_TOL['loss']:.0e}); worst gradient {worst_name} at {worst:.3f} of its "
          f"tolerance (rtol {PACKED_TOL['rtol']:.0e}, atol {PACKED_TOL['atol']:.0e} x "
          f"max(1, |max|))")
    if not (dloss <= PACKED_TOL["loss"] and worst <= 1.0):
        fail("f32 packed and unpacked training disagree")
    return {"sentences": len(src), "loss_rel": dloss, "grad_worst_of_tol": worst,
            "grad_worst": worst_name}


def train_check_f32(cfg, state, batch=None, label: str = "train", kernel=None):
    """Kernel path against the all-plain path in f32: loss and gradients
    before and after 3 optimizer steps, on ``batch`` (default: the
    training cell's first batch). ``kernel``: the model options of the
    path held to the plain one (default: use_pallas, pallas_decoder and
    fused_ce)."""
    from variational_mmt_torch.train.trainer import batch_tensors, loss_and_grads, make_train_step

    batch = batch_tensors(train_batches(cfg)[0] if batch is None else batch,
                          torch.device("cuda"))
    paths = {}
    kernel = dict(use_pallas=True, pallas_decoder=True, fused_ce=True) if kernel is None else kernel
    for name, over in (("kernel", kernel),
                       ("plain", dict(use_pallas=False, pallas_decoder=False, fused_ce=False))):
        paths[name] = trainer_for(cfg, state, [], compute_dtype="float32", **over)
    worst = {}
    for rnd in ("before", "after 3 steps"):
        if rnd != "before":
            for tr in paths.values():
                step = make_train_step(tr.cfg, deterministic=True, sample=False)
                for _ in range(3):
                    tr.state, _ = step(tr.state, batch, None)
        res = {}
        for name, tr in paths.items():
            loss, _, grads = loss_and_grads(tr.cfg, tr.model, batch, tr.state.step, None,
                                            deterministic=True, sample=False)
            res[name] = (float(loss.detach()), [g.detach().clone() for g in grads])
        (lk, gk), (lp, gp) = res["kernel"], res["plain"]
        dloss = abs(lk - lp) / abs(lp)
        names = [n for n, _ in paths["plain"].model.named_parameters()]
        gerr = {n: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for n, a, b in zip(names, gk, gp)}
        wn = max(gerr, key=gerr.get)
        bridge = max(v for n, v in gerr.items() if n.startswith("bridge"))
        print(f"{label} f32 check ({rnd}): loss kernel {lk:.6f} plain {lp:.6f} rel diff "
              f"{dloss:.2e} (tolerance 1e-4); worst gradient {wn} {gerr[wn]:.2e} of its max "
              f"(tolerance 1e-3); worst bridge gradient {bridge:.2e}")
        if not (dloss <= 1e-4 and gerr[wn] <= 1e-3):
            fail(f"f32 kernel path and plain path disagree ({rnd})")
        worst[rnd] = {"loss_rel": dloss, "grad_rel": gerr[wn], "bridge_grad_rel": bridge}
    return worst


def families_phase(card: str):
    """The model families at the quality gate's width and depth (vocab 200,
    emb and hidden 256, latent 64, img 512, 2+2 layers, z_cond=init+input,
    bf16 kernel route, ``quality_gate.build_cfg``), random weights from
    numpy seed 0, the gate's ambiguous corpus (data seed 0): for nmt,
    vmmt_f and vmmt_c, 20 Trainer steps (the loss must fall, rows 1, 2, 5
    and 6 must run) and 20 timed ones; the f32 kernel route against the
    all-plain route on one batch (train_check_f32's limits); beam-4
    decoding of 64 sentences at pallas_step 1 and 2 (well formed; rows 1
    and 3, then rows 1 and 4 must run; sent/s); with the trained weights in
    f32, the kernel path and the all-plain path agree on at least 31 of 32
    top-1 hypotheses. Returns ({kernel name: launches}, {family: record})."""
    from variational_mmt_torch.config import DecodeConfig
    from variational_mmt_torch.convert import params_from_jax
    from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator
    from variational_mmt_torch.data.synthetic import make_ambiguous_corpus
    from variational_mmt_torch.decode.translator import Translator
    from variational_mmt_torch.models.model import build_model, init_params
    from variational_mmt_torch.ops import decode_step as ds, decoder as dec, gru_scan
    from variational_mmt_torch.tools import quality_gate
    from variational_mmt_torch.train.trainer import Trainer

    args = quality_gate.parse_args([])
    n_pairs = TRAIN_BATCH * TRAIN_BATCHES
    src, tgt, feats, sv, tv, _, _ = make_ambiguous_corpus(
        n_pairs + FAMILY_SENTENCES, vocab_size=args.vocab_size, img_dim=args.img_dim,
        seed=args.data_seed)
    train_ds = BinarizedDataset([np.asarray(sv.encode(s), np.int32) for s in src[:n_pairs]],
                                [np.asarray(tv.encode(t), np.int32) for t in tgt[:n_pairs]])
    dec_src = [sv.encode(s) for s in src[n_pairs:]]
    dec_img = feats[n_pairs:]
    counters = {fn.__name__: fn for fn in (gru_scan.gru_layer_scan, gru_scan.gru_layer_scan_bwd,
                                           ds.decode_step, ds.gru_chain, dec.decoder_fwd,
                                           dec.decoder_bwd)}

    def run(fn):
        """Launches of each kernel while ``fn`` runs, and its result."""
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return {k: c.launches for k, c in counters.items()}, out

    def need(where: str, launches: dict, names) -> None:
        print(f"families: {where}: launches {launches}")
        for name in names:
            if launches[name] <= 0:
                fail(f"kernel {name} was not launched ({where})")

    total = {k: 0 for k in counters}
    recs = {}
    V = args.vocab_size
    for fam in FAMILIES:
        cfg = quality_gate.build_cfg(fam, 11, args)
        m = cfg.model
        text_only = fam == "nmt"
        img = None if text_only else dec_img
        # 4 batches, 5 passes: the first and the last 4 steps see the same batches
        batches = list(BucketIterator(train_ds, TRAIN_BATCH, quality_gate.BUCKETS,
                                      img_feats=None if text_only else feats[:n_pairs])
                       .epoch())[:TRAIN_BATCHES]
        print(f"families: {fam}: emb {m.emb_dim} hidden {m.hidden_dim} layers "
              f"{m.enc_layers}+{m.dec_layers} latent {m.latent_dim} img {m.img_feat_dim} vocab "
              f"{m.src_vocab_size} z_cond {m.z_cond} {m.compute_dtype}; {len(batches)} batches "
              f"of {TRAIN_BATCH} pairs, lengths {[b.src.shape[1] for b in batches]}, weights "
              f"numpy seed 0")
        state = params_from_jax(init_params(m, seed=0), m)
        model = build_model(m, device="cuda")
        model.load_state_dict(state)
        trainer = Trainer(cfg, model, batches, device="cuda")
        launches, hist = run(lambda: trainer.train(FAMILY_STEPS))
        need(f"{fam} training, {FAMILY_STEPS} steps", launches,
             ("gru_layer_scan", "gru_layer_scan_bwd", "decoder_fwd", "decoder_bwd"))
        rec = {"train_launches": launches}
        total = {k: total[k] + launches[k] for k in total}
        losses = [h["loss"] for h in hist]
        first, last = float(np.mean(losses[:4])), float(np.mean(losses[-4:]))
        print(f"families: {fam}: losses " + " ".join(f"{v:.3f}" for v in losses))
        print(f"families: {fam}: mean loss of the first 4 steps {first:.4f}, of the last 4 "
              f"{last:.4f}")
        if not (all(math.isfinite(v) for v in losses) and last < first):
            fail(f"{fam}: the training loss is not finite or did not fall")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train(FAMILY_STEPS)
        torch.cuda.synchronize()
        rec.update(loss_first=first, loss_last=last,
                   step_ms=(time.perf_counter() - t0) / FAMILY_STEPS * 1e3)
        print(f"families: {fam}: {rec['step_ms']:.2f} ms/step ({FAMILY_STEPS} steps after the "
              f"checked ones, batch {TRAIN_BATCH}, {card})")
        rec["f32_check"] = train_check_f32(cfg, state, batch=batches[0], label=f"families {fam}")
        rec["sent_per_s"] = {}
        for mode, row in ((1, "decode_step"), (2, "gru_chain")):
            tr = Translator(trainer.model, sv, tv,
                            DecodeConfig(beam_size=4, max_length=40,
                                         batch_size=FAMILY_SENTENCES, pallas_step=mode),
                            buckets=quality_gate.BUCKETS, device="cuda")
            tr.translate_ids(dec_src[:8], None if img is None else img[:8])  # warm-up
            t0 = time.perf_counter()
            launches, out = run(lambda: tr.translate_ids(dec_src, img))
            rate = len(dec_src) / (time.perf_counter() - t0)
            need(f"{fam} beam-4 decoding, pallas_step {mode}", launches, ("gru_layer_scan", row))
            well_formed(out, len(dec_src), V, 40)
            total = {k: total[k] + launches[k] for k in total}
            rec["sent_per_s"][mode] = rate
            print(f"families: {fam}: beam-4 sent/s pallas_step={mode}: {rate:.1f} "
                  f"({len(dec_src)} sentences, max_length 40, {card})")
        # f32, the trained weights: kernel path against the all-plain path
        trained = trainer.model.state_dict()
        outs = []
        for over, mode in ((dict(compute_dtype="float32"), 1),
                           (dict(compute_dtype="float32", use_pallas=False, pallas_decoder=False,
                                 fused_ce=False), 0)):
            m32 = build_model(dataclasses.replace(m, **over), device="cuda")
            m32.load_state_dict(trained)
            tr = Translator(m32, sv, tv, DecodeConfig(beam_size=4, max_length=40,
                                                      batch_size=FAMILY_CHECK, pallas_step=mode),
                            buckets=quality_gate.BUCKETS, device="cuda")
            outs.append(tr.translate_ids(dec_src[:FAMILY_CHECK],
                                         None if img is None else img[:FAMILY_CHECK]))
        same = sum(a[0][1] == b[0][1] for a, b in zip(*outs))
        rec["f32_top1_same"] = same
        print(f"families: {fam}: f32 kernel path vs all-plain path, trained weights: "
              f"{same}/{FAMILY_CHECK} identical top-1 hypotheses")
        if same < FAMILY_CHECK - 1:
            fail(f"{fam}: kernel path and plain path disagree on more than 1 of "
                 f"{FAMILY_CHECK} sentences")
        recs[fam] = rec
    print(f"families: launches of each kernel over the three families {total}")
    return total, recs



def write_cli_corpus(root: str):
    """The entry-point phase's preprocessed corpus, written with the port's
    writers only: the synthetic corpus (data/synthetic.py, vocab 10000,
    seed 5) split 2048/256/256 into ``<root>/corpus.{train,valid}.npz``,
    ``corpus.vocab.{src,tgt}.json``, ``{train,valid,test}.feats.npy`` (its
    64-d image vectors through one fixed projection from numpy seed 6 to
    2048-d) and ``test.src`` / ``test.tgt`` text; and ``config.json``, the
    port's configs/vmmt_c_multi30k.json with pallas_decoder on."""
    from variational_mmt_torch.data.dataset import BinarizedDataset
    from variational_mmt_torch.data.synthetic import make_corpus

    n = CLI_TRAIN + CLI_VALID + CLI_TEST
    src, tgt, img, sv, tv = make_corpus(n, vocab_size=CLI_VOCAB, img_dim=CLI_IMG, seed=5)
    proj = np.random.default_rng(6).standard_normal((CLI_IMG, 2048)).astype(np.float32)
    feats = (img @ proj / np.sqrt(CLI_IMG)).astype(np.float32)
    cuts = {"train": (0, CLI_TRAIN), "valid": (CLI_TRAIN, CLI_TRAIN + CLI_VALID),
            "test": (CLI_TRAIN + CLI_VALID, n)}
    prefix = os.path.join(root, "corpus")
    for split, (a, b) in cuts.items():
        np.save(os.path.join(root, f"{split}.feats.npy"), feats[a:b])
        if split != "test":
            BinarizedDataset([np.asarray(sv.encode(s), np.int32) for s in src[a:b]],
                             [np.asarray(tv.encode(t), np.int32) for t in tgt[a:b]]
                             ).save(f"{prefix}.{split}.npz")
    a, b = cuts["test"]
    for name, lines in (("test.src", src[a:b]), ("test.tgt", tgt[a:b])):
        with open(os.path.join(root, name), "w", encoding="utf-8") as f:
            f.writelines(" ".join(line) + "\n" for line in lines)
    sv.save(prefix + ".vocab.src.json")
    tv.save(prefix + ".vocab.tgt.json")
    with open(os.path.join(HERE, "variational_mmt_torch", "configs", "vmmt_c_multi30k.json")) as f:
        cfg = json.load(f)
    cfg["model"]["pallas_decoder"] = True
    with open(os.path.join(root, "config.json"), "w") as f:
        json.dump(cfg, f)
    return prefix


def snapshot(state) -> dict:
    """A copy of a live TrainState's numbers (params, optimizer state,
    generator state, step, lr)."""
    return {"params": [p.detach().clone() for p in state.model.parameters()],
            "opt": {k: ([t.clone() for t in v] if isinstance(v, list) else v.clone())
                    for k, v in state.opt_state.items()},
            "gen": state.generator.get_state().clone(), "step": state.step, "lr": state.lr}


def same_state(snap: dict, state) -> list:
    """The parts of ``state`` that differ from ``snap`` in any bit."""
    bad = [n for (n, p), q in zip(state.model.named_parameters(), snap["params"])
           if not torch.equal(p, q)]
    for k, v in snap["opt"].items():
        got = state.opt_state[k]
        if not (all(torch.equal(a, b) for a, b in zip(got, v)) if isinstance(v, list)
                else torch.equal(got, v)):
            bad.append(f"opt_state.{k}")
    if not torch.equal(state.generator.get_state(), snap["gen"]):
        bad.append("generator")
    if state.step != snap["step"] or state.lr != snap["lr"]:
        bad.append(f"step/lr {state.step}/{state.lr} != {snap['step']}/{snap['lr']}")
    return bad


def cli_phase(card: str, trainer_ms: float, root: str):
    """The entry points at full width (module docstring, phase 10), in the
    directory ``root``: the train CLI for 60 steps with validation and
    checkpoints, the step-40 checkpoint against the live state, a resume
    from it, then the translate CLI, and save -> load -> translate. Returns
    ({kernel: launches on the CLI runs}, record); the run's checkpoints stay
    in ``root/run`` for phase 11."""
    from variational_mmt_torch.cli import train as cli_train, translate as cli_translate
    from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator
    from variational_mmt_torch.data.features import load_features
    from variational_mmt_torch.models.model import build_model
    from variational_mmt_torch.train import checkpoint as ck
    from variational_mmt_torch.train.trainer import TrainState, batch_tensors, make_train_step

    total = dict.fromkeys(kernel_counters(), 0)

    def counted(fn):
        """``counted_run(fn)``, its counts also added to the CLI path's."""
        got, out = counted_run(fn)
        for k in total:
            total[k] += got[k]
        return got, out

    rec = {}
    t0 = time.time()
    prefix = write_cli_corpus(root)
    run, resumed = os.path.join(root, "run"), os.path.join(root, "resumed")
    print(f"cli: corpus of {CLI_TRAIN}/{CLI_VALID}/{CLI_TEST} pairs (synthetic, vocab "
          f"{CLI_VOCAB}, 2048-d features) written in {time.time() - t0:.1f} s")
    feats = ("-train_img_feats", os.path.join(root, "train.feats.npy"),
             "-valid_img_feats", os.path.join(root, "valid.feats.npy"))
    argv = ["-data", prefix, "-config", os.path.join(root, "config.json"), *feats,
            "-batch_size", str(TRAIN_BATCH), "-report_every", str(CLI_EVERY),
            "-valid_every", str(CLI_EVERY), "-checkpoint_every", str(CLI_EVERY),
            "-keep_checkpoints", str(CLI_KEEP), "-max_steps", str(CLI_STEPS)]
    snaps = {}

    def keep(state, path):
        if state.step == CLI_RESUME_AT:
            snaps["live"] = snapshot(state)

    launches, trainer = counted(lambda: cli_train.main(
        argv + ["-save_model", run], on_checkpoint=keep))
    print(f"cli: train launches ({CLI_STEPS} steps) {launches}")
    for k in ("gru_layer_scan", "gru_layer_scan_bwd", "decoder_fwd", "decoder_bwd"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched by the train CLI")
    m = trainer.cfg.model
    print(f"cli: model {m.model_type} emb {m.emb_dim} hidden {m.hidden_dim} layers "
          f"{m.enc_layers}+{m.dec_layers} latent {m.latent_dim} img {m.img_feat_dim} vocab "
          f"{m.src_vocab_size}/{m.tgt_vocab_size} {m.compute_dtype} use_pallas="
          f"{m.use_pallas} pallas_decoder={m.pallas_decoder} fused_ce={m.fused_ce}")
    losses = [h["loss"] for h in trainer.last_run["metrics"]]
    if len(losses) != CLI_STEPS or not all(math.isfinite(v) for v in losses):
        fail(f"train CLI: {len(losses)} steps, or a loss that is not finite")
    kept = ck.list_checkpoints(run)
    print(f"cli: checkpoints kept {kept}; validations {[h['step'] for h in trainer.history]}")
    if kept != [CLI_RESUME_AT, CLI_STEPS] or len(trainer.history) != CLI_STEPS // CLI_EVERY:
        fail("train CLI: wrong checkpoints kept or validations run")
    run_rec = trainer.last_run
    side_s = run_rec["validation_seconds"] + run_rec["checkpoint_seconds"]
    run_ms = run_rec["seconds"] / run_rec["steps"] * 1e3
    steps_ms = (run_rec["seconds"] - side_s) / run_rec["steps"] * 1e3
    rec.update(train_ms_per_step=run_ms, train_ms_per_step_steps_only=steps_ms,
               validation_s=run_rec["validation_seconds"],
               checkpoint_s=run_rec["checkpoint_seconds"])
    print(f"cli: train CLI {run_ms:.2f} ms/step over its {CLI_STEPS}-step loop, "
          f"{steps_ms:.2f} without its 3 validations of {CLI_VALID} pairs "
          f"({run_rec['validation_seconds']:.2f} s) and 3 checkpoints "
          f"({run_rec['checkpoint_seconds']:.2f} s); batch {TRAIN_BATCH}; the Trainer phase of "
          f"this call {trainer_ms:.2f} ms/step ({card})")

    # the step-40 checkpoint against the live state at step 40
    path40 = os.path.join(run, f"step_{CLI_RESUME_AT:08d}")
    loaded, cfg, model, sv, tv = ck.load_checkpoint(path40, device="cuda")
    bad = same_state(snaps["live"], loaded)
    print(f"cli: step-{CLI_RESUME_AT} checkpoint vs the live state: "
          f"{'bit-identical' if not bad else bad}")
    if bad:
        fail(f"the loaded checkpoint differs from the live state: {bad}")
    ds_train = BinarizedDataset.load(prefix + ".train.npz")
    batch = next(BucketIterator(ds_train, TRAIN_BATCH, cfg.data.buckets,
                                img_feats=load_features(feats[1])).epoch(0))
    batch = batch_tensors(batch, torch.device("cuda"))
    step = make_train_step(cfg)

    def one_step(state):
        state, metrics = step(state, batch, state.generator)
        return (float(metrics["loss"].detach()),
                [p.detach().clone() for p in state.model.parameters()])

    def live_copy():
        mod = build_model(cfg.model, device="cuda")
        with torch.no_grad():
            for p, q in zip(mod.parameters(), snaps["live"]["params"]):
                p.copy_(q)
        gen = torch.Generator(device="cuda")
        gen.set_state(snaps["live"]["gen"])
        opt = {k: ([t.clone() for t in v] if isinstance(v, list) else v.clone())
               for k, v in snaps["live"]["opt"].items()}
        return TrainState(model=mod, opt_state=opt, step=CLI_RESUME_AT,
                          lr=snaps["live"]["lr"], generator=gen)

    (la, pa), (lb, pb), (lc, pc) = one_step(live_copy()), one_step(live_copy()), \
        one_step(loaded)
    spread = max(float((a - b).abs().max()) for a, b in zip(pa, pb))
    dist = max(float((a - c).abs().max()) for a, c in zip(pa, pc))
    print(f"cli: one step from the live state {la!r}, again {lb!r}, from the loaded state "
          f"{lc!r}; params: live vs live max |diff| {spread:.3e}, live vs loaded {dist:.3e}")
    # bit-identical where the route is deterministic; else no farther
    # from the live step than a second live step is
    if not (dist <= spread and abs(lc - la) <= abs(lb - la)):
        fail("one step from the loaded checkpoint differs from one from the live state")
    rec["resume_check"] = {"loss_live": la, "loss_loaded": lc, "live_spread": spread,
                           "loaded_dist": dist}
    del loaded, model, snaps["live"]

    # resume the step-40 checkpoint to step 60 (the data restart at epoch 0)
    launches, tr2 = counted(lambda: cli_train.main(
        argv + ["-save_model", resumed, "-train_from", path40]))
    losses2 = [h["loss"] for h in tr2.last_run["metrics"]]
    print(f"cli: resumed from step {CLI_RESUME_AT}: {len(losses2)} steps to "
          f"{tr2.final_state.step}, losses {' '.join(f'{v:.3f}' for v in losses2[:3])} ... "
          f"{losses2[-1]:.3f}; launches {launches}")
    if (tr2.final_state.step != CLI_STEPS or len(losses2) != CLI_STEPS - CLI_RESUME_AT
            or not all(math.isfinite(v) for v in losses2)):
        fail("the resumed run did not reach its step count with finite losses")

    # the translate CLI from the last checkpoint, beam 4
    size = os.path.getsize(os.path.join(run, f"step_{CLI_STEPS:08d}", "state.msgpack"))
    rec["checkpoint_bytes"] = size
    print(f"cli: checkpoint state.msgpack {size} bytes ({size / 2**20:.1f} MiB; params, "
          "Adam moments, step, lr, rng, generator)")
    tr_argv = ["-src", os.path.join(root, "test.src"), "-tgt", os.path.join(root, "test.tgt"),
               "-img_feats", os.path.join(root, "test.feats.npy"), "-pretokenized",
               "-beam_size", "4", "-batch_size", str(CLI_TEST), "-max_length", "60",
               "-report_bleu", "-output", os.path.join(root, "pred.txt")]
    rec["sent_per_s"] = {}
    outs = {}
    for mode, model_dir in ((1, run), (2, run)):
        launches, out = counted(lambda: cli_translate.main(
            tr_argv + ["-model", model_dir, "-pallas_step", str(mode)]))
        row = "decode_step" if mode == 1 else "gru_chain"
        print(f"cli: translate pallas_step={mode}: {out['sent_per_s']:.1f} sent/s "
              f"({CLI_TEST} sentences, beam 4, max_length 60, {card}), BLEU "
              f"{out['bleu']:.2f}; launches {launches}")
        if launches["gru_layer_scan"] <= 0 or launches[row] <= 0:
            fail(f"the translate CLI did not launch the scan and {row}")
        well_formed(out["nbest"], CLI_TEST, CLI_VOCAB, 60)
        rec["sent_per_s"][mode] = out["sent_per_s"]
        outs[mode] = out

    # save -> load -> translate: identical n-best ids
    state, cfg, model, sv, tv = ck.load_checkpoint(ck.latest_checkpoint(run), device="cuda")
    t0 = time.perf_counter()
    copy = ck.save_checkpoint(os.path.join(root, "copy"), state, cfg, sv, tv)
    rec["save_s"] = time.perf_counter() - t0
    del state, model
    launches, again = counted(lambda: cli_translate.main(
        tr_argv + ["-model", copy, "-pallas_step", "1"]))
    same = sum([i for _, i in a] == [i for _, i in b]
               for a, b in zip(outs[1]["nbest"], again["nbest"]))
    print(f"cli: save ({rec['save_s']:.2f} s) -> load -> translate: {same}/{CLI_TEST} "
          f"identical n-best id lists")
    if same != CLI_TEST:
        fail("a saved and reloaded checkpoint translates differently")
    print(f"cli: launches of each kernel on the CLI runs {total}")
    for k in CLI_KERNELS:
        if total[k] <= 0:
            fail(f"kernel {k} was not launched on the CLI path")
    return total, rec


class Server:
    """``python -m variational_mmt_torch.cli.serve`` on a checkpoint, in a
    process group of its own; ``port`` is read from its ``serving on
    http://HOST:PORT`` line, ``log`` holds its output."""

    def __init__(self, ckpt: str, *flags: str):
        import re
        import threading

        cmd = [sys.executable, "-m", "variational_mmt_torch.cli.serve", "-model", ckpt,
               "-port", "0", "-batch_size", str(SERVE_BATCH), *flags]
        env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""))
        self.flags = " ".join(flags)
        self.proc = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True,
                                     start_new_session=True)
        self.log, self.port = [], None
        up = threading.Event()

        def drain():  # keeps the pipe empty for the server's whole life
            for line in self.proc.stdout:
                self.log.append(line.rstrip())
                m = re.search(r"serving on http://[^:]+:(\d+)", line)
                if m:
                    self.port = int(m.group(1))
                    up.set()
            up.set()

        threading.Thread(target=drain, daemon=True).start()
        self._up = up

    def wait(self, timeout: float = 300.0) -> "Server":
        self._up.wait(timeout)
        if self.port is None:
            self.stop()
            fail(f"the serve CLI ({self.flags}) did not start: " + " | ".join(self.log[-20:]))
        return self

    def stop(self) -> None:
        """SIGINT to the server's group (it stops its dispatchers), then
        SIGKILL whatever is left; prints the tail of its output."""
        import signal

        for sig, wait in ((signal.SIGINT, 30), (signal.SIGKILL, 10)):
            try:
                os.killpg(self.proc.pid, sig)
            except ProcessLookupError:
                break
            try:
                self.proc.wait(timeout=wait)
                break
            except subprocess.TimeoutExpired:
                continue
        try:  # the group may outlive its leader
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        print(f"serve: server ({self.flags}) output, last lines: " + " | ".join(self.log[-6:]))


def http_json(port: int, path: str, payload=None, timeout: float = 120.0):
    import http.client

    from variational_mmt_torch.utils.msgpack_codec import packb, unpackb

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        if payload is None:
            conn.request("GET", path)
        else:
            conn.request("POST", path, body=packb(payload),
                         headers={"Content-Type": "application/x-msgpack"})
        resp = conn.getresponse()
        body = resp.read()
        if resp.status != 200:
            fail(f"HTTP {resp.status} from {path}: {body[:200]!r}")
        return unpackb(body) if payload is not None else json.loads(body)
    finally:
        conn.close()


def serve_traffic(port: int, texts, feats, want):
    """One timed run: ``len(texts)`` single-sentence requests from
    SERVE_CLIENTS closed-loop client threads, then SERVE_BIG requests of
    SERVE_BATCH sentences at once, over loopback HTTP (msgpack, float32
    image bytes). Every answer must equal ``want`` (the offline
    Translator's top-1 text). Returns the run's numbers."""
    import threading

    def req(idx):
        imgs = np.ascontiguousarray(feats[idx], dtype="<f4")
        return {"texts": [texts[i] for i in idx], "timeout": 120,
                "imgs": {"shape": list(imgs.shape), "data": imgs.tobytes()}}

    def check(idx, out):
        got = [nbest[0]["text"] for nbest in out["results"]]
        bad = [i for i, g in zip(idx, got) if g != want[i]]
        if bad:
            fail(f"served answers differ from the offline Translator for sentences {bad[:8]}")

    before = http_json(port, "/stats")
    lat, nxt, lock = [], iter(range(len(texts))), threading.Lock()

    def client():
        while True:
            with lock:
                i = next(nxt, None)
            if i is None:
                return
            t = time.perf_counter()
            out = http_json(port, "/translate", req([i]))
            lat.append(time.perf_counter() - t)
            check([i], out)

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client) for _ in range(SERVE_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads) or len(lat) != len(texts):
        fail("the closed-loop clients did not finish")
    mid = http_json(port, "/stats")
    big = [list(range(k * SERVE_BATCH, (k + 1) * SERVE_BATCH)) for k in range(SERVE_BIG)]
    big_lat = []

    def big_client(idx):
        t = time.perf_counter()
        out = http_json(port, "/translate", req(idx))
        big_lat.append(time.perf_counter() - t)
        check(idx, out)

    t1 = time.perf_counter()
    threads = [threading.Thread(target=big_client, args=(idx,)) for idx in big]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    big_wall = time.perf_counter() - t1
    if any(t.is_alive() for t in threads) or len(big_lat) != SERVE_BIG:
        fail("the 32-sentence requests did not finish")
    d = {k: mid[k] - before[k] for k in ("requests", "batches", "busy_s")}
    lat_ms = np.asarray(lat) * 1e3
    return {"sent_per_s": len(texts) / wall, "p50_ms": float(np.percentile(lat_ms, 50)),
            "p99_ms": float(np.percentile(lat_ms, 99)),
            "mean_batch_fill": d["requests"] / max(d["batches"], 1),
            "busy_share": d["busy_s"] / wall, "wall_s": wall, "big_wall_s": big_wall,
            "big_sent_per_s": SERVE_BIG * SERVE_BATCH / big_wall,
            "big_p50_ms": float(np.percentile(np.asarray(big_lat) * 1e3, 50))}


def client_traffic(port: int, root: str) -> dict:
    """serve_traffic from a client process of its own, on phase 10's test
    set in ``root`` and the offline answers in ``root/want.json``."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "chip_smoke.client_main(int(sys.argv[2]), sys.argv[3])")
    try:
        out = subprocess.run([sys.executable, "-c", code, HERE, str(port), root],
                             capture_output=True, text=True, timeout=600)
    except subprocess.TimeoutExpired:
        fail("the client process did not finish in 600 s")
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("TRAFFIC ")]
    if out.returncode != 0 or not lines:
        fail(f"the client process failed (exit {out.returncode}): {out.stderr[-2000:]}")
    return json.loads(lines[-1][len("TRAFFIC "):])


def client_main(port: int, root: str) -> None:
    """The client process of :func:`client_traffic`."""
    with open(os.path.join(root, "test.src"), encoding="utf-8") as f:
        texts = [line.rstrip("\n") for line in f]
    with open(os.path.join(root, "want.json"), encoding="utf-8") as f:
        want = json.load(f)
    feats = np.load(os.path.join(root, "test.feats.npy"))
    print("TRAFFIC " + json.dumps(serve_traffic(port, texts, feats, want)), flush=True)


def serve_step_checks(gru_scan, ds) -> dict:
    """Rows 3 and 4 against their plain versions at the service's shapes:
    N = 128 (batch 32 x beam 4) and 32 (sampling), S at each warmed bucket,
    H = 500; f32 and bf16 errors, kernel ms in both (the option checks run
    f32), bf16 plain ms, bounds. Row 1 timed at the served encoder's shape,
    B = 32 at T = 16 and 24 (its checks are phase 3's)."""
    g = torch.Generator(device="cuda").manual_seed(3)
    H = STEP_SHAPE["H"]
    recs = {"decode_step": {}, "gru_chain": {}, "gru_layer_scan": {}}
    for N in SERVE_STEP_NS:
        for S in SERVE_BUCKETS:
            at = f"N={N} S={S}"
            step_b, chain_b = step_bounds(N, S, H)
            got, ms32 = {}, {}
            for dt_name in ("float32", "bfloat16"):
                chain, attn = step_inputs(g, getattr(torch, dt_name), N, S, H)
                got[dt_name] = (max_err(ds.decode_step(*chain, *attn),
                                        ds.decode_step_ref(*chain, *attn)),
                                max_err(ds.gru_chain(*chain), ds.gru_chain_ref(*chain)))
                check_close(f"decode_step {at}", dt_name, got[dt_name][0])
                check_close(f"gru_chain {at}", dt_name, got[dt_name][1])
                if dt_name == "float32":
                    ms32 = {"decode_step": cuda_ms(lambda: ds.decode_step(*chain, *attn)),
                            "gru_chain": cuda_ms(lambda: ds.gru_chain(*chain))}
            for k, (name, fn, ref, (b_ms, b_by)) in enumerate((
                    ("decode_step", lambda: ds.decode_step(*chain, *attn),
                     lambda: ds.decode_step_ref(*chain, *attn), step_b),
                    ("gru_chain", lambda: ds.gru_chain(*chain), lambda: ds.gru_chain_ref(*chain),
                     chain_b))):
                rec = {"err_float32": got["float32"][k], "err_bfloat16": got["bfloat16"][k],
                       "ms": cuda_ms(fn), "ms_float32": ms32[name], "plain_ms": cuda_ms(ref),
                       "bound_ms": b_ms, "bound_by": b_by}
                recs[name][at] = rec
                print(f"  {name} {at} H={H} bfloat16: kernel {rec['ms']:.4f} ms (float32 "
                      f"{rec['ms_float32']:.4f}), plain {rec['plain_ms']:.3f} ms, bound "
                      f"{b_ms:.4f} ms ({b_by})")
    for T in SERVE_SCAN_TS:
        recs["gru_layer_scan"][f"B={SERVE_BATCH} T={T}"] = scan_timing(
            gru_scan, g, SERVE_BATCH, T, SCAN_SHAPE["H"])
    return recs


def serve_phase(card: str, root: str):
    """Online serving (module docstring, phase 11) from phase 10's
    checkpoint in ``root``. Returns ({kernel: launches on the in-process
    service runs}, record)."""
    import dataclasses as dc

    from variational_mmt_torch.config import DecodeConfig
    from variational_mmt_torch.data.tokenizer import tokenize
    from variational_mmt_torch.decode import streams
    from variational_mmt_torch.decode.translator import Translator
    from variational_mmt_torch.models.model import build_model
    from variational_mmt_torch.ops import decode_step as ds, gru_scan
    from variational_mmt_torch.cli.loading import load_model_spec
    from variational_mmt_torch.data.vocab import UNK
    from variational_mmt_torch.serve import ServeConfig, ServingServer, TranslationService
    from variational_mmt_torch.train import checkpoint as ck

    ckpt = ck.latest_checkpoint(os.path.join(root, "run"))
    with open(os.path.join(root, "test.src"), encoding="utf-8") as f:
        texts = [line.rstrip("\n") for line in f]
    feats = np.load(os.path.join(root, "test.feats.npy"))
    if len(texts) < SERVE_BIG * SERVE_BATCH:
        fail(f"phase 11 needs {SERVE_BIG * SERVE_BATCH} test sentences, has {len(texts)}")
    t0 = time.time()
    servers = {d: Server(ckpt, "-pipeline_depth", str(d)) for d in (1, 2)}
    for srv in servers.values():
        srv.wait()
    rec = {"server_start_s": time.time() - t0}
    try:
        # the offline Translator for the serve CLI's DecodeConfig (beam 4,
        # max_length 100, batch 32, pallas_step 0) on the same sentences
        state, cfg, model, sv, tv = ck.load_checkpoint(ckpt, device="cuda")
        dcfg = DecodeConfig(beam_size=4, max_length=100, batch_size=SERVE_BATCH)
        tr = Translator(model, sv, tv, dcfg, buckets=cfg.data.buckets or SERVE_BUCKETS,
                        device="cuda")
        toks = [tokenize(t) for t in texts]
        offline = tr.translate_tokens(toks, feats)
        want = [nbest[0][1] for nbest in offline]
        tr.close()
        runs = {1: [], 2: []}
        for d in SERVE_DEPTHS:
            r = serve_traffic(servers[d].port, texts, feats, want)
            runs[d].append(r)
            print(f"serve: -pipeline_depth {d}: {r['sent_per_s']:.1f} sent/s, p50 "
                  f"{r['p50_ms']:.2f} ms, p99 {r['p99_ms']:.2f} ms, mean batch fill "
                  f"{r['mean_batch_fill']:.2f}, busy share {r['busy_share']:.3f} "
                  f"({len(texts)} single-sentence requests, {SERVE_CLIENTS} closed-loop "
                  f"clients); {SERVE_BIG} x {SERVE_BATCH}-sentence requests "
                  f"{r['big_sent_per_s']:.1f} sent/s; answers = offline ({card})")
        rec["depth"] = runs
    finally:
        for srv in servers.values():
            srv.stop()
    srv = Server(ckpt, "-procs", "2").wait()
    port = srv.port
    try:
        health = http_json(port, "/healthz")
        if not health.get("ids_wire"):
            fail("the -procs 2 server's dispatchers do not take the id-level wire")
        r = serve_traffic(port, texts, feats, want)
        rec["procs2"] = r
        print(f"serve: -procs 2: {r['sent_per_s']:.1f} sent/s, p50 {r['p50_ms']:.2f} ms, p99 "
              f"{r['p99_ms']:.2f} ms, mean batch fill {r['mean_batch_fill']:.2f}, busy share "
              f"{r['busy_share']:.3f}; answers = offline ({card})")
    finally:
        srv.stop()

    # the main path, counted: the service the serve CLI builds (its loader,
    # its defaults), behind ServingServer in this process, at depth 1 and
    # at AUTO (the CLI's default, 2 here); the clients run in a process of
    # their own, as they do against the CLI. Per depth: one run with every
    # count set to 0 just before it and read just after, and the CPU time
    # of this process and of the device thread over it; then one run under
    # torch.profiler for the device's busy time
    counters = {fn.__name__: fn for fn in (gru_scan.gru_layer_scan, ds.decode_step,
                                           ds.gru_chain)}

    def counts():
        torch.cuda.synchronize()
        return {k: c.launches for k, c in counters.items()}

    with open(os.path.join(root, "want.json"), "w", encoding="utf-8") as f:
        json.dump(want, f)
    lm = load_model_spec(ckpt, device="cuda")
    rec["in_process"] = {}
    for depth in (1, 0):
        svc = TranslationService(lm.models[0], lm.src_vocab, lm.tgt_vocab, dcfg,
                                 buckets=lm.cfgs[0].data.buckets or SERVE_BUCKETS,
                                 scfg=ServeConfig(pipeline_depth=depth), device="cuda")
        http = ServingServer(svc, "127.0.0.1", 0, info={"model_type": lm.cfgs[0].model.model_type})
        http.start()
        device_thread = svc.translator._device_thread()
        try:
            counts()
            for c in counters.values():
                c.launches = 0
            dev_cpu, cpu = device_thread.submit(time.thread_time).result(60), time.process_time()
            r = client_traffic(http.port, root)
            dev_cpu = device_thread.submit(time.thread_time).result(60) - dev_cpu
            cpu = time.process_time() - cpu
            r["launches"] = counts()
            served_s = r["wall_s"] + r["big_wall_s"]
            r.update(process_cpu_share=cpu / served_s, device_thread_cpu_share=dev_cpu / served_s)
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                     torch.profiler.ProfilerActivity.CUDA]) as prof:
                p = client_traffic(http.port, root)
                torch.cuda.synchronize()
            busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                          if e.device_type == torch.autograd.DeviceType.CUDA)
            # None: the profiler saw no device time (not measured)
            r["profiled"] = {"sent_per_s": p["sent_per_s"], "p50_ms": p["p50_ms"],
                             "device_busy_ms": busy_us / 1e3 if busy_us else None,
                             "device_busy_share": busy_us / 1e6 / (p["wall_s"] + p["big_wall_s"])
                             if busy_us else None}
        finally:
            http.stop()
            svc.stop()
        rec["in_process"][svc.pipeline_depth] = r
        q = r["profiled"]
        print(f"serve: in process (ServingServer, clients in a process of their own), "
              f"-pipeline_depth {svc.pipeline_depth}{' (AUTO)' if depth == 0 else ''}: "
              f"{r['sent_per_s']:.1f} sent/s, p50 {r['p50_ms']:.2f} ms, p99 {r['p99_ms']:.2f} ms, "
              f"mean batch fill {r['mean_batch_fill']:.2f}, busy share {r['busy_share']:.3f}, "
              f"CPU of this process {r['process_cpu_share']:.3f} and of the device thread "
              f"{r['device_thread_cpu_share']:.3f} of the served time; answers = offline; "
              f"launches {r['launches']}; profiled run {q['sent_per_s']:.1f} sent/s, device busy "
              f"{q['device_busy_ms']} ms, {q['device_busy_share']} of the served time ({card})")
    rec["launches"] = rec["in_process"][svc.pipeline_depth]["launches"]
    if rec["launches"]["gru_layer_scan"] <= 0:
        fail("kernel gru_layer_scan was not launched on the served path")
    del lm, svc, http

    # in process: the decode options on the kernel steps against the plain
    # step, f32 (31 of 32 top-1 entries equal, as phase 4)
    for c in counters.values():
        c.launches = 0
    m32 = build_model(dc.replace(cfg.model, compute_dtype="float32"), device="cuda")
    m32.load_state_dict(model.state_dict())
    idx = list(range(SERVE_CHECK))
    ids = [sv.encode(toks[i]) for i in idx]
    common = {}  # the exclusion token: the commonest word of the offline answers
    for nbest in offline[:SERVE_CHECK]:
        for w in nbest[0][1].split():
            common[w] = common.get(w, 0) + 1
    excl = max(common, key=common.get)
    # replace_unk: a copy whose generator scores <unk> as the exclusion
    # word plus 1, so that answers hold <unk> and its attention positions
    # (row 3's probs on pallas_step 1) are compared
    m_unk = build_model(dc.replace(cfg.model, compute_dtype="float32"), device="cuda")
    m_unk.load_state_dict(model.state_dict())
    w = tv.stoi[excl]
    with torch.no_grad():
        kern, bias = m_unk.generator_params()
        kern[:, UNK] = kern[:, w]
        bias[UNK] = bias[w] + 1.0
    options = {"coverage_beta 0.2": (m32, dict(coverage_beta=0.2)),
               f"block_ngram_repeat 2, ignore_when_blocking {excl}":
                   (m32, dict(block_ngram_repeat=2, ignore_when_blocking=excl)),
               "replace_unk": (m_unk, dict(replace_unk=True))}
    rec["options"] = {}

    def served(mdl, **kw):
        svc = TranslationService(mdl, sv, tv, DecodeConfig(**{
            "beam_size": 4, "max_length": 100, "batch_size": SERVE_BATCH, **kw}),
            buckets=cfg.data.buckets or SERVE_BUCKETS,
            scfg=ServeConfig(max_wait_ms=5.0, warmup=False), device="cuda")
        try:
            return [f.result(timeout=300) for f in svc.submit_ids_batch(ids, feats[idx])]
        finally:
            svc.stop()

    for name, (mdl, kw) in options.items():
        outs = {mode: served(mdl, pallas_step=mode, **kw) for mode in (0, 1, 2)}
        # the top-1 entry past its score: ids, and with replace_unk the
        # attention positions too
        same = {mode: sum(a[0][1:] == b[0][1:] for a, b in zip(outs[mode], outs[0]))
                for mode in (1, 2)}
        rec["options"][name] = same
        what = "ids and attention positions" if kw.get("replace_unk") else "ids"
        print(f"serve: f32 {name}: pallas_step 1 vs 0 {same[1]}/{SERVE_CHECK}, 2 vs 0 "
              f"{same[2]}/{SERVE_CHECK} identical top-1 {what}")
        if min(same.values()) < SERVE_CHECK - 1:
            fail(f"{name}: the kernel steps and the plain step disagree on more than 1 of "
                 f"{SERVE_CHECK} sentences")
        if kw.get("replace_unk"):
            unk = {mode: sum(UNK in o[0][1] for o in outs[mode]) for mode in (0, 1, 2)}
            rec["options"][name]["answers_with_unk"] = unk
            print(f"serve: replace_unk: answers holding <unk> at pallas_step 0/1/2 "
                  f"{unk[0]}/{unk[1]}/{unk[2]} of {SERVE_CHECK}")
            if min(unk.values()) == 0:
                fail("replace_unk: no answer holds <unk>, so no attention position was compared")
    rec["option_launches"] = counts()
    print(f"serve: launches of the in-process option checks {rec['option_launches']}")
    for k in SERVE_KERNELS:
        if rec["option_launches"][k] <= 0:
            fail(f"kernel {k} was not launched by the in-process option checks")

    # sampling keyed by sample_ids: the same answers grouped two ways (bf16,
    # pallas_step 1)
    sdcfg = DecodeConfig(beam_size=1, max_length=100, batch_size=SERVE_BATCH, sampling_temp=1.0,
                         sampling_topk=10, pallas_step=1, decode_seed=7)
    svc = TranslationService(model, sv, tv, sdcfg, buckets=cfg.data.buckets or SERVE_BUCKETS,
                             scfg=ServeConfig(max_wait_ms=5.0, warmup=False), device="cuda")
    try:
        sids = [1000 + i for i in idx]
        together = [f.result(timeout=300) for f in svc.submit_ids_batch(ids, feats[idx],
                                                                         sample_ids=sids)]
        alone = [svc.submit_ids_batch([i], feats[[k]], sample_ids=[s])[0].result(timeout=300)
                 for k, (i, s) in enumerate(zip(ids, sids))]
    finally:
        svc.stop()
    same = sum(a == b for a, b in zip(together, alone))
    print(f"serve: sampling (temp 1.0, topk 10, sample_ids): {same}/{SERVE_CHECK} answers "
          f"identical grouped at once and one by one")
    if same != SERVE_CHECK:
        fail("sampled answers depend on how the batcher grouped the requests")
    ids_gpu = torch.arange(64, device="cuda") * 7919
    a = streams.DecodeStreams(7, ids_gpu)
    b = streams.DecodeStreams(7, ids_gpu.cpu())
    gum = float((a.token_gumbel(5, len(tv)).cpu() - b.token_gumbel(5, len(tv))).abs().max())
    eps = float((a.latent_eps(0, 128).cpu() - b.latent_eps(0, 128)).abs().max())
    uni = torch.equal(streams.uniforms(a.keys, 4096).cpu(), streams.uniforms(b.keys, 4096))
    print(f"serve: decode streams card vs CPU: uniforms identical {uni}, Gumbel max |diff| "
          f"{gum:.3e}, eps max |diff| {eps:.3e}")
    if not uni or gum > 1e-5 or eps > 1e-5:
        fail("the decode streams differ between the card and the CPU")
    rec["sampling"] = {"grouping_identical": same, "streams_gumbel_diff": gum,
                       "streams_eps_diff": eps}

    # latent_from sample: deterministic for a seed, different from the mean
    outs = []
    for lf in ("sample", "sample", "mean"):
        t = Translator(model, sv, tv, DecodeConfig(beam_size=4, max_length=100,
                                                   batch_size=SERVE_BATCH, latent_from=lf,
                                                   pallas_step=1, decode_seed=7),
                       buckets=cfg.data.buckets or SERVE_BUCKETS, device="cuda")
        outs.append(t.translate_ids(ids, feats[idx]))
        t.close()
    repeat = outs[0] == outs[1]
    moved = sum(a[0][0] != b[0][0] for a, b in zip(outs[0], outs[2]))
    print(f"serve: latent_from sample: repeat identical {repeat}, {moved}/{SERVE_CHECK} scores "
          f"differ from the mean's")
    if not repeat or moved == 0:
        fail("latent_from sample is not deterministic for its seed, or equals the mean")
    rec["latent_sample"] = {"repeat_identical": repeat, "differ_from_mean": moved}
    rec["step_shapes"] = serve_step_checks(gru_scan, ds)
    return {"serve_online": rec["launches"], "serve_options": rec["option_launches"]}, rec


def kernel_counters():
    """{name: wrapper} of the six kernels' launch counters."""
    from variational_mmt_torch.ops import decode_step as ds, decoder as dec, gru_scan

    return {fn.__name__: fn for fn in (gru_scan.gru_layer_scan, gru_scan.gru_layer_scan_bwd,
                                       ds.decode_step, ds.gru_chain, dec.decoder_fwd,
                                       dec.decoder_bwd)}


def counted_run(fn):
    """({kernel: launches}, fn()): the counts set to 0 just before ``fn``
    and read just after."""
    counters = kernel_counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return {k: c.launches for k, c in counters.items()}, out


def eval_phase(card: str, root: str):
    """The evaluation path (module docstring, phase 12) on phase 10's
    checkpoint and test pairs in ``root``. Returns ({kernel: launches on
    the eval CLI run}, record)."""
    from variational_mmt_torch.cli import translate as cli_translate
    from variational_mmt_torch.config import DecodeConfig
    from variational_mmt_torch.data.dataset import BucketIterator, binarize, buckets_with_catchall
    from variational_mmt_torch.decode.iw_eval import make_iw_elbo_fn
    from variational_mmt_torch.decode.mbr import mbr_translate_ids
    from variational_mmt_torch.decode.score import score_corpus
    from variational_mmt_torch.decode.translator import Translator
    from variational_mmt_torch.models.model import build_model
    from variational_mmt_torch.train import checkpoint as ck
    from variational_mmt_torch.train.trainer import batch_tensors

    ckpt = ck.latest_checkpoint(os.path.join(root, "run"))
    attn_path = os.path.join(root, "attn.npz")
    argv = ["-model", ckpt, "-src", os.path.join(root, "test.src"),
            "-tgt", os.path.join(root, "test.tgt"), "-img_feats",
            os.path.join(root, "test.feats.npy"), "-pretokenized", "-beam_size", "4",
            "-batch_size", str(EVAL_BATCH), "-max_length", "60", "-output",
            os.path.join(root, "pred_eval.txt"), "-iw_eval", str(EVAL_K), "-latent_diag",
            "-dump_attn", attn_path, "-report_meteor", "-seed", str(EVAL_SEED)]
    launches, out = counted_run(lambda: cli_translate.main(argv))
    iw = out["iw"]
    rec = {"iw": iw, "iw_sent_per_s": iw["n_sents"] / out["iw_s"], "meteor": out["meteor"],
           "bleu": out["bleu"], "latent_diag": out["latent_diag"], "launches": launches}
    print(f"eval: translate CLI -iw_eval {EVAL_K} -latent_diag -dump_attn -report_meteor "
          f"(bf16, use_pallas, pallas_decoder): IW-ELBO joint {iw['iw_elbo_per_sent']:.4f} / "
          f"text {iw['iw_text_per_sent']:.4f} per sentence, IW-ppl {iw['iw_ppl']:.4f}, "
          f"{iw['n_sents']:.0f} sentences; IW pass {out['iw_s']:.3f} s, "
          f"{rec['iw_sent_per_s']:.1f} sent/s; METEOR {out['meteor']:.2f}, BLEU "
          f"{out['bleu']:.2f}; AU {out['latent_diag']['au']}/{out['latent_diag']['latent_dim']};"
          f" launches {launches} ({card})")
    for k in ("gru_layer_scan", "decoder_fwd"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the eval CLI run")

    # the IW pass alone (bf16, kernel route): rows 1 and 5 must run, K
    # launches of row 5 a batch; then under torch.profiler for the busy share
    state, cfg, model, sv, tv = ck.load_checkpoint(ckpt, device="cuda")
    with open(os.path.join(root, "test.src"), encoding="utf-8") as f:
        src_ids = [sv.encode(line.lower().split()) for line in f]
    with open(os.path.join(root, "test.tgt"), encoding="utf-8") as f:
        gold_ids = [tv.encode(line.lower().split()) for line in f]
    feats = np.load(os.path.join(root, "test.feats.npy"))
    buckets = cfg.data.buckets or SERVE_BUCKETS  # the translate CLI's default
    # the CLI's IW batches: a catch-all bucket keeps every pair whole
    it = BucketIterator(binarize(src_ids, gold_ids), EVAL_BATCH, buckets_with_catchall(
        buckets, max([len(s) for s in src_ids] + [len(t) + 1 for t in gold_ids])),
        img_feats=feats)
    batches = [batch_tensors(b, torch.device("cuda")) for b in it.epoch(0)]
    fn = make_iw_elbo_fn(model, EVAL_K)

    def iw_pass(m_fn, eps_list=None, gen=None):
        return [m_fn(b, gen, None if eps_list is None else eps_list[i])
                for i, b in enumerate(batches)]

    gen = torch.Generator(device="cuda").manual_seed(EVAL_SEED)
    iw_launches, _ = counted_run(lambda: iw_pass(fn, gen=gen))
    print(f"eval: the IW pass alone, {len(batches)} batches: launches {iw_launches}")
    if iw_launches["gru_layer_scan"] <= 0 or \
            iw_launches["decoder_fwd"] != EVAL_K * len(batches):
        fail("the IW pass did not launch row 1, or row 5 once a sample and batch")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                             torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        iw_pass(fn, gen=gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    # None: the profiler saw no device time (not measured)
    rec["iw_profiled"] = {"wall_s": wall, "device_busy_ms": busy_us / 1e3 if busy_us else None,
                          "device_busy_share": busy_us / 1e6 / wall if busy_us else None}
    print(f"eval: IW pass under torch.profiler: {wall:.3f} s, device busy "
          f"{rec['iw_profiled']['device_busy_ms']} ms, "
          f"{rec['iw_profiled']['device_busy_share']} of it ({card})")

    # f32: the kernel route against the plain route on the same eps
    def f32_model(**over):
        m = build_model(dataclasses.replace(cfg.model, compute_dtype="float32", **over),
                        device="cuda")
        m.load_state_dict(model.state_dict())
        return m

    kern = f32_model()
    plain = f32_model(use_pallas=False, pallas_decoder=False, fused_ce=False)
    g = torch.Generator(device="cuda").manual_seed(EVAL_SEED + 1)
    eps = [torch.randn((EVAL_K, b["src"].shape[0], cfg.model.latent_dim), generator=g,
                       device="cuda") for b in batches]
    got = iw_pass(make_iw_elbo_fn(kern, EVAL_K), eps)
    want = iw_pass(make_iw_elbo_fn(plain, EVAL_K), eps)
    sent_err = max(float(((a["iw_per_sent"] - b["iw_per_sent"]).abs()
                          / b["iw_per_sent"].abs().clamp(min=1.0)).max())
                   for a, b in zip(got, want))
    corpus_err = max(abs(sum(float(a[k]) for a in got) - sum(float(b[k]) for b in want))
                     / abs(sum(float(b[k]) for b in want))
                     for k in ("iw_elbo_sum", "iw_text_sum"))
    pred_ids = [n[0][1] for n in out["nbest"]]
    _, _, att_k = score_corpus(kern, src_ids, pred_ids, feats, buckets=buckets,
                               batch_size=EVAL_BATCH, return_attn=True)
    _, _, att_p = score_corpus(plain, src_ids, pred_ids, feats, buckets=buckets,
                               batch_size=EVAL_BATCH, return_attn=True)
    dumped = np.load(attn_path)
    attn_err = max(float(np.abs(a - b).max()) for a, b in zip(att_k, att_p))
    shapes_ok = all(dumped[f"attn_{i}"].shape == a.shape for i, a in enumerate(att_k))
    rec["f32_check"] = {"per_sentence_rel_err": sent_err, "corpus_rel_err": corpus_err,
                        "attn_abs_err": attn_err}
    ok = (sent_err <= EVAL_TOL["sent"] and corpus_err <= EVAL_TOL["corpus"]
          and attn_err <= EVAL_TOL["attn"] and shapes_ok and len(dumped.files) == len(src_ids))
    print(f"eval: f32 IW kernel route vs plain route, same eps: per-sentence bounds max rel err "
          f"{sent_err:.3e} (tolerance {EVAL_TOL['sent']:.0e}), corpus {corpus_err:.3e} "
          f"({EVAL_TOL['corpus']:.0e}); force-decoded attention max abs err {attn_err:.3e} "
          f"({EVAL_TOL['attn']:.0e}); dumped {len(dumped.files)} matrices of the right shapes: "
          f"{shapes_ok} {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail("the f32 IW bounds or attention of the kernel route disagree with the plain route")

    # MBR in f32 at pallas_step 0, 1 and 2: the picks agree
    picks, rates = {}, {}
    for mode in (0, 1, 2):
        dcfg = DecodeConfig(beam_size=1, sampling_temp=1.0, max_length=60,
                            batch_size=EVAL_MBR_CHECK, pallas_step=mode, decode_seed=EVAL_SEED)
        tr = Translator(kern, sv, tv, dcfg, buckets=buckets, device="cuda")
        t0 = time.perf_counter()
        res = mbr_translate_ids(tr, src_ids[:EVAL_MBR_CHECK], feats[:EVAL_MBR_CHECK],
                                n_samples=EVAL_MBR_SAMPLES)
        rates[mode] = EVAL_MBR_CHECK / (time.perf_counter() - t0)
        tr.close()
        picks[mode] = [n[0][1] for n in res]
        well_formed(res, EVAL_MBR_CHECK, len(tv), 60)
    same = {m: sum(a == b for a, b in zip(picks[m], picks[0])) for m in (1, 2)}
    rec["mbr"] = {"same_as_step0": same, "sent_per_s": rates}
    print(f"eval: MBR {EVAL_MBR_SAMPLES} samples, f32, {EVAL_MBR_CHECK} sentences: picks equal "
          f"to pallas_step 0's {same[1]}/{EVAL_MBR_CHECK} (step 1), {same[2]}/{EVAL_MBR_CHECK} "
          f"(step 2); sent/s {', '.join(f'{m}: {r:.1f}' for m, r in rates.items())}")
    if min(same.values()) < EVAL_MBR_CHECK - 1:
        fail("MBR picks of the decode-step kernels disagree with the plain step's")
    del kern, plain, model, state
    return launches, rec


def wide_scan_checks(gru_scan, g, rng, B: int, T: int, H: int, card: str) -> dict:
    """Rows 1 and 2 on the wide plan at (B, T, H): f32 and bf16, with and
    without a reset stream, both directions, against their plain versions
    (forward max abs, backward max rel); bf16 times (CUDA events, in turns
    with the plain version, and the device's clock), cuDNN's nn.GRU forward
    and backward, the bounds."""
    at = f"B={B} T={T} H={H}"
    r = {}
    for dt_name in ("float32", "bfloat16"):
        ins, gout, reset = reset_inputs(g, rng, getattr(torch, dt_name), B, T, H, 8)
        for label, rs in (("", None), ("reset_", reset)):
            fwd, bwd, _ = reset_errs(gru_scan, ins, gout, rs)
            what = f"{at}{' with a reset stream' if rs is not None else ''}"
            check_close(f"gru_scan {what}", dt_name, fwd)
            check_close(f"gru_scan_bwd {what}", dt_name, bwd, "max_rel_err")
            r[f"{label}err_{dt_name}"], r[f"bwd_{label}err_{dt_name}"] = fwd, bwd
        r[f"plan_{dt_name}"] = gru_scan.gru_layer_scan.plan
        r[f"bwd_plan_{dt_name}"] = gru_scan.gru_layer_scan_bwd.plan
        for plan in (r[f"plan_{dt_name}"], r[f"bwd_plan_{dt_name}"]):
            if plan["layout"] != "wide":
                fail(f"gru_scan {at} {dt_name}: the {plan['layout']} plan, not the wide one")
        print_plan(f"gru_scan {at} {dt_name}", r[f"plan_{dt_name}"])
        print_plan(f"gru_scan_bwd {at} {dt_name}", r[f"bwd_plan_{dt_name}"])
    x, mask, h0, wh, bh, gout = scan_bwd_inputs(g, torch.bfloat16, B, T, H, 8)
    outs, _ = gru_scan.gru_layer_scan_ref(x, mask, h0, wh, bh, True)
    fwd_k = lambda: gru_scan.gru_layer_scan(x, mask, h0, wh, bh, True)  # noqa: E731
    bargs = (x, mask, h0, wh, bh, outs, gout, True)
    bwd_k = lambda: gru_scan.gru_layer_scan_bwd(*bargs)  # noqa: E731
    for key, kernel, plain, bound_of in (
            ("fwd", fwd_k, lambda: gru_scan.gru_layer_scan_ref(x, mask, h0, wh, bh, True),
             scan_fwd_bound),
            ("bwd", bwd_k, lambda: gru_scan.gru_layer_scan_bwd_ref(*bargs), scan_bwd_bound)):
        t = in_turns(f"gru_scan{'_bwd' if key == 'bwd' else ''} {at} bfloat16",
                     {"kernel": kernel, "plain": plain}, iters=WIDE_ITERS)
        rec = {"ms": t["kernel_ms"], "plain_ms": t["plain_ms"], "runs_ms": t["runs_ms"],
               "device_ms": device_ms(kernel, iters=WIDE_ITERS)}
        rec["bound_ms"], rec["bound_by"] = bound_of(B, T, H)
        r[key] = rec
    gru = torch.nn.GRU(2 * H, H, batch_first=True, device="cuda", dtype=torch.bfloat16)
    xin = torch.randn(B, T, 2 * H, generator=g, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        r["fwd"]["library_ms"] = device_ms(lambda: gru(xin))
        r["fwd"]["library_eager_ms"] = cuda_ms(lambda: gru(xin))
    r["bwd"]["library_ms"], r["bwd"]["library_eager_ms"] = cudnn_bwd_ms(g, B, T, H)
    for key, name in (("fwd", "gru_scan"), ("bwd", "gru_scan_bwd")):
        t = r[key]
        print(f"  {name} {at} bfloat16: kernel {t['ms']:.4f} ms (device clock "
              f"{fmt_ms(t['device_ms'])}), plain {t['plain_ms']:.3f} ms, nn.GRU "
              f"{'backward' if key == 'bwd' else 'forward'} {fmt_ms(t['library_ms'])} on the "
              f"device's clock (eager {t['library_eager_ms']:.4f} ms), bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}; {card})")
    return r


def widths_phase(card: str, root: str):
    """The kernels' widths (module docstring, phase 13). Returns ({kernel:
    launches on the two CLI trains and the translates}, record)."""
    from variational_mmt_torch.cli import train as cli_train, translate as cli_translate
    from variational_mmt_torch.ops import decode_step as ds, decoder as dec, gru_scan
    from variational_mmt_torch.train import checkpoint as ck

    rec = {"scan": {}}
    g = torch.Generator(device="cuda").manual_seed(8)
    rng = np.random.default_rng(8)
    for B, T, H in WIDE_SCANS:  # the wide plan
        rec["scan"][f"B={B} T={T} H={H}"] = wide_scan_checks(gru_scan, g, rng, B, T, H, card)
    for B, T, H, dtypes in WIDTH_SCANS:
        at = f"B={B} T={T} H={H}"
        r = {}
        for dt_name in dtypes:
            args = scan_bwd_inputs(g, getattr(torch, dt_name), B, T, H, 8)
            x, mask, h0, wh, bh, gout = args
            fwd_err = 0.0
            for reverse in (False, True):
                got = gru_scan.gru_layer_scan(x, mask, h0, wh, bh, reverse)
                want = gru_scan.gru_layer_scan_ref(x, mask, h0, wh, bh, reverse)
                fwd_err = max(fwd_err, max_err(got, want))
            check_close(f"gru_scan {at}", dt_name, fwd_err)
            bwd_err, _, _ = scan_bwd_errs(gru_scan, args)
            check_close(f"gru_scan_bwd {at}", dt_name, bwd_err, "max_rel_err")
            r[f"err_{dt_name}"], r[f"bwd_err_{dt_name}"] = fwd_err, bwd_err
            r[f"plan_{dt_name}"] = gru_scan.gru_layer_scan.plan
            r[f"bwd_plan_{dt_name}"] = gru_scan.gru_layer_scan_bwd.plan
            print_plan(f"gru_scan {at} {dt_name}", r[f"plan_{dt_name}"])
            print_plan(f"gru_scan_bwd {at} {dt_name}", r[f"bwd_plan_{dt_name}"])
        if "bfloat16" in dtypes:  # times in bf16, beside cuDNN and the bound
            r["fwd"] = scan_timing(gru_scan, g, B, T, H)
            x, mask, h0, wh, bh, gout = scan_bwd_inputs(g, torch.bfloat16, B, T, H, 8)
            outs, _ = gru_scan.gru_layer_scan_ref(x, mask, h0, wh, bh, True)
            bargs = (x, mask, h0, wh, bh, outs, gout, True)
            b = {"ms": cuda_ms(lambda: gru_scan.gru_layer_scan_bwd(*bargs)),
                 "plain_ms": cuda_ms(lambda: gru_scan.gru_layer_scan_bwd_ref(*bargs), iters=5)}
            b["library_ms"], b["library_eager_ms"] = cudnn_bwd_ms(g, B, T, H)
            b["bound_ms"], b["bound_by"] = scan_bwd_bound(B, T, H)
            r["bwd"] = b
            print(f"  gru_scan_bwd {at} bfloat16: kernel {b['ms']:.4f} ms, plain "
                  f"{b['plain_ms']:.3f} ms, nn.GRU backward {fmt_ms(b['library_ms'])} on the "
                  f"device's clock (eager, host-bound: {b['library_eager_ms']:.4f} ms), bound "
                  f"{b['bound_ms']:.4f} ms ({card})")
        rec["scan"][at] = r
    # rows 3-6 at a width that is not a multiple of 4 (padded to 252)
    rec["step"] = {N: step_phase(ds, dict(N=N, S=WIDTH_DEC["S"], H=WIDTH_DEC["H"]))
                   for N in WIDTH_STEP_NS}
    # the step's calls as a request makes them: weights, keys and mem_v
    # padded once (``GRUDecoder.step_weights``, ``project_memory``), the
    # states padded by the wrapper at each call
    S, H = WIDTH_DEC["S"], WIDTH_DEC["H"]
    Hp = ds.padded_width(H)
    for N in WIDTH_STEP_NS:
        chain, attn = step_inputs(g, torch.bfloat16, N, S, H)
        w = ds.pad_step_weights(*chain[4:], attn[2])
        keys, mem_v = (ds.pad_units(t, H, Hp) for t in attn[:2])
        def step_w():
            return ds.decode_step(*chain[:4], *w[:7], keys, mem_v, w[7], attn[3])

        err = max_err(step_w(), ds.decode_step_ref(*chain, *attn))
        check_close(f"decode_step N={N} S={S} H={H}, weights padded once", "bfloat16", err)
        rec["step"][N][0]["ms_weights_padded"] = cuda_ms(step_w)
        rec["step"][N][1]["ms_weights_padded"] = cuda_ms(lambda: ds.gru_chain(*chain[:4],
                                                                               *w[:7]))
        print(f"  decode_step / gru_chain N={N} S={S} H={H} bfloat16, weights padded once: "
              f"{rec['step'][N][0]['ms_weights_padded']:.4f} / "
              f"{rec['step'][N][1]['ms_weights_padded']:.4f} ms (every input padded at each "
              f"call: {rec['step'][N][0]['ms']:.4f} / {rec['step'][N][1]['ms']:.4f} ms)")
    rec["decoder"] = decoder_phase(dec, WIDTH_DEC)

    # the entry points at these widths, from phase 10's corpus
    with open(os.path.join(root, "config.json")) as f:
        config = json.load(f)
    config["model"]["pallas_decoder"] = False
    nodec = os.path.join(root, "config_nodec.json")
    with open(nodec, "w") as f:
        json.dump(config, f)
    base = ["-data", os.path.join(root, "corpus"), "-train_img_feats",
            os.path.join(root, "train.feats.npy"), "-valid_img_feats",
            os.path.join(root, "valid.feats.npy"), "-batch_size", str(TRAIN_BATCH),
            "-max_steps", str(WIDTH_CLI_STEPS), "-report_every", str(WIDTH_CLI_STEPS),
            "-valid_every", str(10 * WIDTH_CLI_STEPS), "-checkpoint_every",
            str(WIDTH_CLI_STEPS)]
    total = dict.fromkeys(kernel_counters(), 0)
    rec["cli"] = {}
    scans = ("gru_layer_scan", "gru_layer_scan_bwd")
    # (label, flags, config, rows that must run, width of a wide-plan scan)
    for label, flags, config_path, rows, wide in (
            ("1024", ["-rnn_size", "1024"], nodec, scans, None),
            ("250", ["-rnn_size", "250"], os.path.join(root, "config.json"),
             scans + ("decoder_fwd", "decoder_bwd"), None),
            ("2048", ["-rnn_size", "2048"], nodec, scans, 1024),
            ("fast1000", ["-rnn_size", "1000", "-input_feed", "0", "-use_pallas", "1"], nodec,
             scans, 1000)):
        run = os.path.join(root, f"run{label}")
        t0 = time.perf_counter()
        with plain_scan_log() as logged:
            launches, (trainer, by_width) = counted_run(lambda: scan_widths(lambda: cli_train.main(
                base + ["-config", config_path, *flags, "-save_model", run])))
        secs = time.perf_counter() - t0
        losses = [h["loss"] for h in trainer.last_run["metrics"]]
        scan_plan = gru_scan.gru_layer_scan.plan
        print(f"widths: train CLI {' '.join(flags)} (pallas_decoder "
              f"{trainer.cfg.model.pallas_decoder}): {len(losses)} steps in {secs:.1f} s, losses "
              f"{' '.join(f'{v:.3f}' for v in losses)}; launches {launches}; GRU scans by width "
              f"{by_width}; the last scan's plan {scan_plan}")
        if len(losses) != WIDTH_CLI_STEPS or not all(math.isfinite(v) for v in losses):
            fail(f"train CLI {' '.join(flags)}: a step count or a loss that is not right")
        for k in rows:
            if launches[k] <= 0:
                fail(f"kernel {k} was not launched by the train CLI {' '.join(flags)}")
        if logged:
            fail(f"train CLI {' '.join(flags)}: a layer took the plain scan: {logged}")
        if label == "1024" and scan_plan["cluster"] != 16:
            fail("the encoder halves of 512 units did not run on 16-CTA clusters")
        if label == "250" and dec.decoder_bwd.plan["padded"] != 252:
            fail("the decoder kernels did not run at the padded width 252")
        if wide is not None and not by_width.get(wide):
            fail(f"train CLI {' '.join(flags)}: no scan of {wide} units (the wide plan) ran")
        rec["cli"][label] = {"losses": losses, "seconds": secs, "launches": launches,
                             "scan_widths": by_width}
        for k in total:
            total[k] += launches[k]
    # the fast config at H = 1000 in f32: its kernel route (rows 1 and 2 on
    # the wide plan for the decoder's layers) against the plain route
    from variational_mmt_torch.convert import params_from_jax
    from variational_mmt_torch.models.model import init_params
    from variational_mmt_torch.tools import flagship

    fcfg, _ = flagship.load()
    fm = dataclasses.replace(fcfg.model, pallas_decoder=True, **FAST_WIDE)
    fcfg = dataclasses.replace(fcfg, model=fm)
    rec["fast1000_f32_check"] = train_check_f32(fcfg, params_from_jax(init_params(fm, seed=0), fm),
                                                label="widths fast config H=1000")
    ckpt = ck.latest_checkpoint(os.path.join(root, "run250"))
    for mode, row in ((1, "decode_step"), (2, "gru_chain")):
        launches, out = counted_run(lambda: cli_translate.main(
            ["-model", ckpt, "-src", os.path.join(root, "test.src"), "-img_feats",
             os.path.join(root, "test.feats.npy"), "-pretokenized", "-beam_size", "4",
             "-batch_size", str(CLI_TEST), "-max_length", "60", "-pallas_step", str(mode),
             "-output", os.path.join(root, f"pred250_{mode}.txt")]))
        plan = (ds.decode_step if mode == 1 else ds.gru_chain).plan
        print(f"widths: translate CLI at hidden 250, pallas_step={mode}: "
              f"{out['sent_per_s']:.1f} sent/s, launches {launches}; cells at padded width "
              f"{plan['padded']}")
        well_formed(out["nbest"], CLI_TEST, CLI_VOCAB, 60)
        if launches[row] <= 0 or plan["padded"] != 252:
            fail(f"the translate CLI at hidden 250 did not launch {row} at width 252")
        rec["cli"][f"translate_{mode}"] = {"sent_per_s": out["sent_per_s"],
                                           "launches": launches}
        for k in total:
            total[k] += launches[k]
    return total, rec


def int8_rest_bytes(shapes) -> int:
    """Bytes an int8 member holds between requests, from its parameter
    shapes: 1 a weight of two or more dimensions, 4 a scale (one a
    last-axis column), 4 an element of a 1-D leaf."""
    return sum(math.prod(s) + 4 * s[-1] if len(s) >= 2 else 4 * math.prod(s)
               for s in shapes.values())


def allocator_slack(shapes) -> int:
    """The most by which ``torch.cuda.memory_allocated`` may exceed the
    bytes of these int8 tensors: each block is rounded up to 512 bytes, and
    a block of more than 1 MiB may keep an unsplit remainder of its segment
    below 1 MiB (the caching allocator's large pool splits only a larger
    one)."""
    sizes = [n for s in shapes.values()
             for n in ((math.prod(s), 4 * s[-1]) if len(s) >= 2 else (4 * math.prod(s),))]
    return sum(511 if n <= 2 ** 20 else 2 ** 20 for n in sizes)


def resident(build):
    """(the object ``build()`` returns, device bytes it added as
    ``memory_allocated`` and as the requested bytes), read after
    ``empty_cache``."""
    def now():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        stats = torch.cuda.memory_stats()
        return torch.cuda.memory_allocated(), stats.get("requested_bytes.all.current")

    a0, r0 = now()
    out = build()
    a1, r1 = now()
    return out, a1 - a0, (None if r0 is None else r1 - r0)


def ensemble_phase(card: str, root: str):
    """Checkpoint ensembles, the inference dtypes and the port's preprocess
    (module docstring, phase 14) from phase 10's checkpoint and corpus in
    ``root``. Returns ({path: {kernel: launches}}, record)."""
    from variational_mmt_torch.cli import preprocess as cli_preprocess
    from variational_mmt_torch.cli import train as cli_train, translate as cli_translate
    from variational_mmt_torch.cli.loading import load_model_spec
    from variational_mmt_torch.config import DecodeConfig
    from variational_mmt_torch.convert import params_from_jax
    from variational_mmt_torch.data.synthetic import make_corpus
    from variational_mmt_torch.data.tokenizer import tokenize
    from variational_mmt_torch.decode.translator import (Translator, dequantize_params,
                                                         quantize_params_int8)
    from variational_mmt_torch.models.model import build_model, init_params, param_shapes
    from variational_mmt_torch.tools import flagship
    from variational_mmt_torch.train import checkpoint as ck
    from variational_mmt_torch.train.trainer import create_train_state

    rec, t_phase = {}, time.time()
    ckpt = ck.latest_checkpoint(os.path.join(root, "run"))
    lm = load_model_spec(ckpt, device="cpu")
    cfg, sv, tv = lm.cfgs[0], lm.src_vocab, lm.tgt_vocab
    host, paths = [lm.models[0]], [ckpt]
    for seed in ENS_SEEDS:  # random full-width members, saved with phase 10's vocabs
        m = build_model(cfg.model, device="cpu")
        m.load_state_dict(params_from_jax(init_params(cfg.model, seed=seed), cfg.model))
        paths.append(ck.save_checkpoint(os.path.join(root, f"member{seed}"),
                                        create_train_state(cfg, m), cfg, sv, tv))
        host.append(m)
    V, shapes = cfg.model.tgt_vocab_size, param_shapes(cfg.model)
    with open(os.path.join(root, "test.src"), encoding="utf-8") as f:
        test_tok = [line.split() for line in f]
    feats = np.load(os.path.join(root, "test.feats.npy"))
    inputs = [([sv.encode(t) for t in test_tok], feats),
              flagship.requests(cfg.model, seed=ENS_SEED)(ENS_SENT)]
    n_in = sum(len(s) for s, _ in inputs)

    def dcfg(**kw):
        return DecodeConfig(**{"beam_size": 4, "max_length": ENS_MAXLEN,
                               "batch_size": ENS_SENT, **kw})

    def top1(out):
        return [nbest[0][1] for nbest in out]

    def on_card(mcfg, members):
        out = []
        for m in members:
            c = build_model(mcfg, device="cuda")
            c.load_state_dict(m.state_dict())
            out.append(c.eval())
        return out

    # f32 checks, not counted: a self-ensemble is the single model; the
    # step kernels against the plain step on the 3-member ensemble
    cfg32 = dataclasses.replace(cfg.model, compute_dtype="float32")
    m32 = on_card(cfg32, host)
    src, img = inputs[0]
    single = top1(Translator(m32[0], sv, tv, dcfg(), device="cuda").translate_ids(src, img))
    rec["self_ensemble_same"] = {}
    for mode in ("prob", "logprob"):
        trio = Translator([m32[0]] * 3, sv, tv, dcfg(ensemble_mode=mode), device="cuda")
        same = sum(a == b for a, b in zip(single, top1(trio.translate_ids(src, img))))
        rec["self_ensemble_same"][mode] = same
        print(f"ensemble: f32 self-ensemble x3 ({mode}) vs the single model: "
              f"{same}/{len(src)} identical top-1")
        if same < len(src) - 1:
            fail(f"a self-ensemble ({mode}) decodes differently from its model")
    src32, img32 = src[:ENS_CHECK], img[:ENS_CHECK]
    outs = {s: top1(Translator(m32, sv, tv, dcfg(batch_size=ENS_CHECK, pallas_step=s),
                               device="cuda").translate_ids(src32, img32)) for s in (0, 1, 2)}
    rec["kernel_vs_plain_same"] = {}
    for s in (1, 2):
        same = sum(a == b for a, b in zip(outs[s], outs[0]))
        rec["kernel_vs_plain_same"][s] = same
        print(f"ensemble: f32 3-member ensemble, pallas_step {s} vs 0: {same}/{ENS_CHECK} "
              "identical top-1")
        if same < ENS_CHECK - 1:
            fail(f"the ensemble at pallas_step {s} disagrees with the plain step")
    del m32

    # int8 codes on the card against the CPU's, bit for bit
    state = host[0].state_dict()
    q_cpu = quantize_params_int8(state)
    q_gpu = quantize_params_int8({k: v.cuda() for k, v in state.items()})
    d_cpu, d_gpu = dequantize_params(q_cpu), dequantize_params(q_gpu)
    bad = []
    for k, v in q_cpu.items():
        if isinstance(v, dict):
            same = (torch.equal(v["int8"], q_gpu[k]["int8"].cpu())
                    and torch.equal(v["scale"].view(torch.int32),
                                    q_gpu[k]["scale"].cpu().view(torch.int32))
                    and torch.equal(d_cpu[k].view(torch.int16), d_gpu[k].cpu().view(torch.int16)))
            if not same:
                bad.append(k)
    n_q = sum(isinstance(v, dict) for v in q_cpu.values())
    print(f"ensemble: int8 codes, scales and dequantized bf16 of {n_q} weights: card = CPU bit "
          f"for bit {'yes' if not bad else bad}")
    if bad:
        fail(f"the card's int8 codes differ from the CPU's: {bad[:4]}")
    del q_gpu, d_gpu

    # bytes at rest: each member alone, then the three together
    want, slack = int8_rest_bytes(shapes), allocator_slack(shapes)
    rest = {}
    for dt in ENS_DTYPES:
        per = []
        for m in host:
            # the model stays in host memory: only the translator's copy is on the card
            tr, alloc, req = resident(lambda: Translator(m, sv, tv, dcfg(infer_dtype=dt),
                                                         device="cuda"))
            per.append({"allocated": alloc, "requested": req, "held": tr.weight_bytes()})
            del tr
        rest[dt] = per
        print(f"ensemble: bytes at rest a member, {dt}: "
              f"{', '.join(str(p['allocated']) for p in per)} allocated "
              f"({', '.join(str(p['requested']) for p in per)} requested)")
    for p in rest["int8"]:
        if p["held"] != want or (p["requested"] is not None and p["requested"] != want) \
                or not 0 <= p["allocated"] - want <= slack:
            fail(f"an int8 member holds {p} bytes at rest; its shapes say {want} (allocator "
                 f"rounding up to {slack})")
    _, alloc3, req3 = resident(lambda: Translator(host, sv, tv, dcfg(infer_dtype="int8"),
                                                  device="cuda"))
    print(f"ensemble: int8 at rest, {want} bytes a member from the shapes (the allocator "
          f"may add up to {slack}); 3 members {alloc3} allocated, {req3} requested; f32 "
          f"{rest['float32'][0]['allocated']}, bf16 {rest['bfloat16'][0]['allocated']} a member")
    if req3 is not None and req3 != 3 * want or not 0 <= alloc3 - 3 * want <= 3 * slack:
        fail("the 3-member int8 ensemble holds more than its codes, scales and 1-D leaves")
    rec["rest_bytes"] = dict(rest, int8_from_shapes=want, allocator_slack=slack,
                             int8_ensemble_allocated=alloc3, int8_ensemble_requested=req3)

    # the main path, counted: sent/s of one model and of three, each dtype and step
    members = on_card(cfg.model, host)
    rate, tops = {}, {}

    configs = list(itertools.product(("single", "ensemble"), (False, True), ENS_DTYPES,
                                     (0, 1, 2)))

    def timed():
        """Every configuration (members, held to all ``max_length`` steps by
        ``min_length`` or not: phase 10's model ends its hypotheses early,
        dtype, step): one untimed pass over the inputs, then timed passes
        in turns, all configurations forward and then backward."""
        trs = {c: Translator(members if c[0] == "ensemble" else members[0], sv, tv,
                             dcfg(infer_dtype=c[2], pallas_step=c[3],
                                  min_length=ENS_MAXLEN if c[1] else 0), device="cuda")
               for c in configs}
        runs = {c: [] for c in configs}
        for i, c in enumerate(configs + configs + configs[::-1]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = [trs[c].translate_ids(s_, i_) for s_, i_ in inputs]
            torch.cuda.synchronize()
            if i >= len(configs):  # the first pass warms up
                runs[c].append(n_in / (time.perf_counter() - t))
            for o, (s_, _) in zip(out, inputs):
                well_formed(o, len(s_), V, ENS_MAXLEN)
            if not c[1] and c[2] != "float32":  # bf16 and int8 top-1 at each step
                tops[c[0], c[2], c[3]] = [x for o in out for x in top1(o)]
        for c, tr in trs.items():
            tr.close()
            rate[f"{c[0]}{' full' if c[1] else ''} {c[2]} pallas_step={c[3]}"] = runs[c]

    launches, _ = counted_run(timed)
    for name in ("single", "ensemble", "single full", "ensemble full"):
        print(f"ensemble: beam-4 sent/s, {name} ({3 if 'ensemble' in name else 1} member(s); "
              f"{n_in} sentences, max_length {ENS_MAXLEN}"
              f"{', min_length too' if 'full' in name else ''}, {card}; two runs in "
              "turns): " + "; ".join(f"{dt} " + " / ".join(
                  ", ".join(f"{r:.1f}" for r in rate[f"{name} {dt} pallas_step={s}"])
                  for s in (0, 1, 2)) for dt in ENS_DTYPES) + " (pallas_step 0 / 1 / 2)")
    agree = {name: sum(a == b for a, b in zip(tops[name, "int8", 0],
                                              tops[name, "bfloat16", 0]))
             for name in ("single", "ensemble")}
    mean_len = {name: float(np.mean([len(x) for x in tops[name, "bfloat16", 0]]))
                for name in ("single", "ensemble")}
    # the kernels on bf16-stored and int8-rebuilt weights against the plain
    # step on the same weights: 31 of 32 top-1 equal, as the f32 checks
    kernel_same = {f"{name} {dt} pallas_step={s}": sum(
        a == b for a, b in zip(tops[name, dt, s], tops[name, dt, 0]))
        for name in ("single", "ensemble") for dt in ("bfloat16", "int8") for s in (1, 2)}
    print(f"ensemble: top-1 at pallas_step 1 and 2 vs 0 on the same weights ({n_in} "
          "sentences): " + "; ".join(f"{k} {v}" for k, v in kernel_same.items()))
    low = [k for k, v in kernel_same.items() if 32 * v < 31 * n_in]
    if low:
        fail(f"the step kernels disagree with the plain step on more than 1 in 32 sentences "
             f"at bf16/int8 weights: {low}")
    print(f"ensemble: int8 vs bf16 top-1 agreement at pallas_step 0: single "
          f"{agree['single']}/{n_in}, ensemble {agree['ensemble']}/{n_in}; mean top-1 "
          f"length (bfloat16) single {mean_len['single']:.2f}, ensemble "
          f"{mean_len['ensemble']:.2f} tokens")
    rec.update(sent_per_s=rate, int8_bf16_top1_same=agree, mean_top1_len=mean_len,
               kernel_vs_plain_same_cast=kernel_same)
    rec["lending_ms_a_batch"] = lending_cost(members[0], sv, tv, dcfg(batch_size=SERVE_BATCH),
                                             inputs[0])
    del members

    # the CLIs over the three checkpoints
    spec = ",".join(paths)
    tr_argv = ["-model", spec, "-src", os.path.join(root, "test.src"), "-tgt",
               os.path.join(root, "test.tgt"), "-img_feats", os.path.join(root, "test.feats.npy"),
               "-pretokenized", "-beam_size", "4", "-batch_size", str(ENS_SENT), "-max_length",
               str(ENS_MAXLEN), "-report_bleu", "-output", os.path.join(root, "ens_pred.txt")]
    rec["cli_translate"] = {}
    for dt in ("int8", "bfloat16"):
        got, out = counted_run(lambda: cli_translate.main(tr_argv + ["-infer_dtype", dt]))
        for k in launches:
            launches[k] += got[k]
        well_formed(out["nbest"], len(test_tok), V, ENS_MAXLEN)
        if got["gru_layer_scan"] <= 0:
            fail(f"the translate CLI's ensemble at {dt} launched no scan")
        rec["cli_translate"][dt] = out["sent_per_s"]
        print(f"ensemble: cli.translate -model a,b,c -infer_dtype {dt}: "
              f"{out['sent_per_s']:.1f} sent/s, BLEU {out['bleu']:.2f}; launches {got}")
    for k in ("gru_layer_scan", "decode_step", "gru_chain"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the ensemble path")
    with open(os.path.join(root, "test.src"), encoding="utf-8") as f:
        texts = [line.rstrip("\n") for line in f][:ENS_SERVE]
    dcfg_srv = DecodeConfig(beam_size=4, max_length=ENS_MAXLEN, batch_size=SERVE_BATCH,
                            infer_dtype="int8")
    tr = Translator(host, sv, tv, dcfg_srv, buckets=cfg.data.buckets or SERVE_BUCKETS,
                    device="cuda")
    want_txt = [nb[0][1] for nb in tr.translate_tokens([tokenize(t) for t in texts],
                                                       feats[:ENS_SERVE])]
    tr.close()
    srv = Server(spec, "-infer_dtype", "int8", "-max_length", str(ENS_MAXLEN),
                 "-no_warmup").wait()
    try:
        info = http_json(srv.port, "/healthz")
        got = [None] * ENS_SERVE

        def ask(i):
            imgs = np.ascontiguousarray(feats[i:i + 1], dtype="<f4")
            got[i] = http_json(srv.port, "/translate", {
                "texts": [texts[i]], "imgs": {"shape": list(imgs.shape),
                                              "data": imgs.tobytes()}})["results"][0][0]["text"]

        import threading

        t = time.perf_counter()
        threads = [threading.Thread(target=ask, args=(i,)) for i in range(ENS_SERVE)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        served_s = time.perf_counter() - t
    finally:
        srv.stop()
    same = sum(a == b for a, b in zip(got, want_txt))
    print(f"ensemble: cli.serve -model a,b,c -infer_dtype int8: {ENS_SERVE} requests in "
          f"{served_s:.2f} s, {same}/{ENS_SERVE} answers = the offline Translator's; info "
          f"ensemble {info.get('ensemble')} model_types {info.get('model_types')}")
    if same != ENS_SERVE or info.get("ensemble") != 3:
        fail("the serve CLI's ensemble answers differ from the offline Translator's")
    rec["serve"] = {"requests": ENS_SERVE, "seconds": served_s, "same": same}

    # the port's preprocess from raw text, then 5 steps of the train CLI on it
    n = CLI_TRAIN + CLI_VALID + CLI_TEST
    src_l, tgt_l, _, _, _ = make_corpus(n, vocab_size=CLI_VOCAB, img_dim=CLI_IMG, seed=5)
    raw = os.path.join(root, "raw")
    os.makedirs(raw, exist_ok=True)
    for name, lines in (("train.src", src_l[:CLI_TRAIN]), ("train.tgt", tgt_l[:CLI_TRAIN]),
                        ("valid.src", src_l[CLI_TRAIN:CLI_TRAIN + CLI_VALID]),
                        ("valid.tgt", tgt_l[CLI_TRAIN:CLI_TRAIN + CLI_VALID])):
        with open(os.path.join(raw, name), "w", encoding="utf-8") as f:
            f.writelines(" ".join(line) + "\n" for line in lines)
    prefix = os.path.join(raw, "data")
    t = time.perf_counter()
    cli_preprocess.main(["-train_src", os.path.join(raw, "train.src"), "-train_tgt",
                         os.path.join(raw, "train.tgt"), "-valid_src",
                         os.path.join(raw, "valid.src"), "-valid_tgt",
                         os.path.join(raw, "valid.tgt"), "-save_data", prefix,
                         "-shard_size", str(ENS_SHARD)])
    pp_s = time.perf_counter() - t
    shards = len([p for p in os.listdir(raw) if p.startswith("data.train.")])
    pp_launches, trainer = counted_run(lambda: cli_train.main([
        "-data", prefix, "-config", os.path.join(root, "config.json"), "-train_img_feats",
        os.path.join(root, "train.feats.npy"), "-valid_img_feats",
        os.path.join(root, "valid.feats.npy"), "-batch_size", str(TRAIN_BATCH),
        "-max_steps", str(ENS_PP_STEPS), "-valid_every", str(ENS_PP_STEPS),
        "-checkpoint_every", str(ENS_PP_STEPS), "-save_model", os.path.join(raw, "run")]))
    losses = [h["loss"] for h in trainer.last_run["metrics"]]
    print(f"ensemble: preprocess from raw text ({CLI_TRAIN}/{CLI_VALID} pairs, BPE, "
          f"-shard_size {ENS_SHARD}: {shards} shards) {pp_s:.2f} s; cli.train on it "
          f"{len(losses)} steps, losses {' '.join(f'{v:.3f}' for v in losses)}; "
          f"launches {pp_launches}")
    if shards != CLI_TRAIN // ENS_SHARD or len(losses) != ENS_PP_STEPS \
            or not all(math.isfinite(v) for v in losses) or pp_launches["gru_layer_scan"] <= 0:
        fail("the port's preprocess -> train chain did not run")
    rec.update(preprocess_s=pp_s, preprocess_train_losses=losses, phase_s=time.time() - t_phase)
    print(f"ensemble phase {rec['phase_s']:.1f} s")
    return {"ensemble": launches, "preprocess": pp_launches}, rec


def lending_cost(model, sv, tv, dcfg, inputs, runs: int = 3) -> dict:
    """ms a batch of the f32 serving path (pallas_step 0), through the
    Translator, which lends its weights to the model's parameterless copy
    with ``functional_call`` every batch, and through the translate
    function called on the model itself; ``runs`` runs each, in turns."""
    from variational_mmt_torch.decode.translator import Translator, make_translate_fn

    src, img = inputs
    lent = Translator(model, sv, tv, dcfg, device="cuda")
    own = Translator(model, sv, tv, dcfg, device="cuda")
    fn = make_translate_fn([model], dcfg)
    own._call = lambda s_, i_, streams: fn(s_, i_, streams)
    out = {"lent": [], "own": []}
    n_batches = -(-len(src) // dcfg.batch_size)
    trs = {"lent": lent, "own": own}
    order = ["lent", "own"] + (["lent", "own", "own", "lent"] * runs)[:2 * runs]
    for i, name in enumerate(order):
        tr = trs[name]
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.translate_ids(src, img)
        torch.cuda.synchronize()
        if i >= 2:  # one untimed pass each
            out[name].append((time.perf_counter() - t) * 1e3 / n_batches)
    for tr in trs.values():
        tr.close()
    print(f"ensemble: f32 single model, batches of {dcfg.batch_size}, pallas_step 0: "
          f"{', '.join(f'{v:.3f}' for v in out['lent'])} ms a batch through the Translator "
          f"(functional_call) vs {', '.join(f'{v:.3f}' for v in out['own'])} ms through the "
          "translate function on the model itself (in turns)")
    return out


class plain_scan_log:
    """A context that gathers the port's "takes the plain scan" log lines
    (every layer's, not once a width: the record of logged layers is
    cleared on entry)."""

    def __enter__(self):
        import logging

        from variational_mmt_torch.models import gru as gru_mod

        self.lines = []
        self.logger = logging.getLogger(gru_mod.__name__)
        gru_mod._wide_logged.clear()
        lines = self.lines

        class Grab(logging.Handler):
            def emit(self, record):
                if "plain scan" in record.getMessage():
                    lines.append(record.getMessage())

        self.handler = Grab(logging.WARNING)
        self.logger.addHandler(self.handler)
        return self.lines

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        return False


def scan_widths(fn):
    """(fn(), {H: calls}): the width of every ``gru_layer_scan_ad`` call
    while ``fn`` runs (each launches row 1 once on a CUDA tensor, and row 2
    once when its gradient is taken), read by wrapping the function that
    the models import when they call it."""
    from variational_mmt_torch.ops import gru_scan

    seen = {}
    orig = gru_scan.gru_layer_scan_ad

    def call(x_proj, *a, **k):
        H = x_proj.shape[-1] // 3
        seen[H] = seen.get(H, 0) + 1
        return orig(x_proj, *a, **k)

    gru_scan.gru_layer_scan_ad = call
    try:
        out = fn()
    finally:
        gru_scan.gru_layer_scan_ad = orig
    return out, seen


def options_phase(card: str, cfg, state):
    """Phase 15 (module docstring): the model options of ROADMAP.md item
    5.5 at the flagship's width. Returns ({kernel: launches on the counted
    runs}, record)."""
    from variational_mmt_torch.config import DecodeConfig
    from variational_mmt_torch.convert import params_from_jax
    from variational_mmt_torch.data.vocab import SPECIALS, Vocab
    from variational_mmt_torch.decode.translator import Translator
    from variational_mmt_torch.models.model import build_model, init_params
    from variational_mmt_torch.tools import flagship
    from variational_mmt_torch.train.trainer import Trainer

    t_phase = time.time()
    V, D = cfg.model.tgt_vocab_size, cfg.model.img_feat_dim
    vocab = Vocab(SPECIALS + [f"w{i}" for i in range(V - len(SPECIALS))])
    rng = np.random.default_rng(5)
    pool5 = train_batches(cfg)
    conv = [dataclasses.replace(b, img=np.abs(rng.standard_normal(
        (b.batch_size, OPTION_REGIONS, D))).astype(np.float32)) for b in pool5]
    src, img = flagship.requests(cfg.model, seed=6)(OPTION_SENTENCES)
    conv_img = np.abs(rng.standard_normal((OPTION_SENTENCES, OPTION_REGIONS, D))
                      ).astype(np.float32)
    total = {k: 0 for k in kernel_counters()}

    def add(launches):
        for k, n in launches.items():
            total[k] += n

    def translator(model, mode, batch, min_length=0):
        return Translator(model, vocab, vocab,
                          DecodeConfig(beam_size=4, max_length=60, min_length=min_length,
                                       batch_size=batch, pallas_step=mode), device="cuda")

    recs = {}
    for name, over in OPTIONS.items():
        # pallas_decoder: the decoder sequence kernels wherever they compute the
        # decoder (conv_attn); the other options' decoders take the plain loop
        m = dataclasses.replace(cfg.model, pallas_decoder=True, **over)
        ocfg = dataclasses.replace(cfg, model=m)
        ostate = params_from_jax(init_params(m, seed=0), m)
        model = build_model(m, device="cuda")
        model.load_state_dict(ostate)
        is_conv = m.img_feat_type == "conv"
        batches, dec_img = (conv, conv_img) if is_conv else (pool5, img)
        trainer = Trainer(ocfg, model, batches, device="cuda")
        steps = OPTION_STEPS if name == "fast" else OPTION_OTHER_STEPS
        launches, (hist, widths) = counted_run(
            lambda: scan_widths(lambda: trainer.train(steps)))
        add(launches)
        losses = [h["loss"] for h in hist]
        rec = {"train_launches": launches, "train_widths": widths, "losses": losses}
        print(f"options: {name} ({over}): {steps} training steps, losses "
              + " ".join(f"{v:.3f}" for v in losses) + f"; launches {launches}, GRU scans "
              f"by width {widths}")
        if not all(math.isfinite(v) for v in losses):
            fail(f"options {name}: a training loss is not finite")
        if name == "fast":
            # rows 1 and 2: the encoder's 4 and the target encoder's 2 layers at
            # H/2 as in the input-feed model, plus the decoder's 2 at H
            want = {m.hidden_dim // 2: 6 * steps, m.hidden_dim: 2 * steps}
            if widths != want or launches["gru_layer_scan"] != 8 * steps \
                    or launches["gru_layer_scan_bwd"] != 8 * steps \
                    or launches["decoder_fwd"] or launches["decoder_bwd"]:
                fail(f"options fast: scans by width {widths}, want {want}; rows 1 and 2 "
                     f"{8 * steps} launches each, rows 5 and 6 none")
            rec["f32_check"] = train_check_f32(ocfg, ostate, label="options fast")
            trainers = {"fast": trainer,
                        **{f"input_feed_{p}": trainer_for(cfg, state, pool5, pallas_decoder=p)
                           for p in (1, 0)}}
            runs = {k: [] for k in trainers}
            for k in OPTION_TIMED:
                trainers[k].train(len(pool5))  # untimed: no run starts cold after another
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainers[k].train(OPTION_STEPS)
                torch.cuda.synchronize()
                runs[k].append((time.perf_counter() - t0) / OPTION_STEPS * 1e3)
            del trainers
            rec["step_ms"] = {k: float(np.mean(v)) for k, v in runs.items()}
            rec["step_ms_runs"] = runs
            print("options: ms/step " + "; ".join(
                f"{k} {rec['step_ms'][k]:.2f} (runs {', '.join(f'{v:.2f}' for v in r)})"
                for k, r in runs.items()) + f"; the fast config against the input-feed "
                f"flagship with pallas_decoder 1 and 0, in turns, {OPTION_STEPS} steps of batch "
                f"{TRAIN_BATCH} a run, {card}")
        # beam-4 decoding of 256 sentences, every hypothesis held to 60 steps
        # (a model a few steps from random ends them after a few tokens):
        # conv+attn computes the step kernel's decoder (pallas_step 1), the
        # others take the plain step
        mode = 1 if name == "conv_attn" else 0
        tr = translator(trainer.model, mode, OPTION_SENTENCES, min_length=60)
        tr.translate_ids(src[:8], dec_img[:8])  # warm-up
        t0 = time.perf_counter()
        launches, out = counted_run(lambda: tr.translate_ids(src, dec_img))
        rate = len(src) / (time.perf_counter() - t0)
        add(launches)
        well_formed(out, len(src), V, 60)
        rec.update(decode_launches=launches, sent_per_s=rate, route=tr.step_routes[0])
        print(f"options: {name}: beam-4 sent/s {rate:.1f} (pallas_step {mode}, route "
              f"{tr.step_routes[0]}, {len(src)} sentences held to 60 steps, {card}); "
              f"launches {launches}")
        if name != "lstm" and launches["gru_layer_scan"] <= 0:
            fail(f"options {name}: the encoder's scan kernel was not launched")
        if name == "conv_attn" and launches["decode_step"] <= 0:
            fail("options conv_attn: the decode-step kernel was not launched")
        if name == "fast":
            # f32, the trained weights: the kernel route against the all-plain route
            trained = trainer.model.state_dict()
            outs = []
            for route in (dict(compute_dtype="float32"),
                          dict(compute_dtype="float32", use_pallas=False,
                               pallas_decoder=False, fused_ce=False)):
                m32 = build_model(dataclasses.replace(m, **route), device="cuda")
                m32.load_state_dict(trained)
                outs.append(translator(m32, 0, OPTION_CHECK).translate_ids(
                    src[:OPTION_CHECK], img[:OPTION_CHECK]))
            same = sum(a[0][1] == b[0][1] for a, b in zip(*outs))
            rec["f32_top1_same"] = same
            print(f"options: fast: f32 kernel route vs all-plain route, trained weights: "
                  f"{same}/{OPTION_CHECK} identical top-1 hypotheses")
            if same < OPTION_CHECK - 1:
                fail("options fast: kernel route and plain route disagree on more than 1 of "
                     f"{OPTION_CHECK} sentences")
        if name != "conv_attn":
            # pallas_step 1 and 2 on a decoder the step kernels do not compute:
            # the plain step, as JAX's translator routes it
            n = OPTION_INELIGIBLE
            ref = translator(trainer.model, 0, n).translate_ids(src[:n], dec_img[:n])
            rec["ineligible"] = {}
            for mode in (1, 2):
                tr = translator(trainer.model, mode, n)
                launches, out = counted_run(lambda: tr.translate_ids(src[:n], dec_img[:n]))
                add(launches)
                rows36 = {k: launches[k] for k in ("decode_step", "gru_chain", "decoder_fwd",
                                                   "decoder_bwd")}
                same = sum(a == b for a, b in zip(out, ref))
                rec["ineligible"][mode] = {"route": tr.step_routes[0], "rows_3_6": rows36,
                                           "same_as_step_0": same}
                print(f"options: {name} at pallas_step {mode}: route {tr.step_routes}, rows "
                      f"3-6 launches {rows36}, n-best equal to pallas_step 0's on "
                      f"{same}/{n}")
                if tr.step_routes != ["plain"] or any(rows36.values()) or same != n:
                    fail(f"options {name}: pallas_step {mode} did not take the plain step")
        recs[name] = rec
        del trainer, model
        torch.cuda.empty_cache()
    recs["phase_s"] = time.time() - t_phase
    print(f"options: launches over the counted runs {total}; phase {recs['phase_s']:.1f} s")
    return total, recs


def same_batches(a: list, b: list) -> list:
    """The fields in which two lists of batches differ (array for array)."""
    bad = [] if len(a) == len(b) else [f"{len(a)} batches != {len(b)}"]
    for i, (x, y) in enumerate(zip(a, b)):
        for f in dataclasses.fields(x):
            u, v = getattr(x, f.name), getattr(y, f.name)
            if (u is None) != (v is None) or (u is not None and not (
                    u.dtype == v.dtype and u.shape == v.shape and np.array_equal(u, v))):
                bad.append(f"batch {i} {f.name}")
    return bad


class DirectLoop:
    """How the parent trained: ``make_train_step`` over ``batch_tensors``
    of host batches (``batches``, an iterator), copied from pageable memory
    on the thread that launches the step; metrics read once a run."""

    def __init__(self, cfg, state, batches, table):
        from variational_mmt_torch.models.model import build_model
        from variational_mmt_torch.train.trainer import create_train_state, make_train_step

        model = build_model(cfg.model, device="cuda")
        model.load_state_dict(state)
        self.state = create_train_state(cfg, model)
        self.step = make_train_step(cfg)
        self.batches = batches
        self.table = table

    def train(self, n: int) -> list:
        from variational_mmt_torch.train.trainer import batch_tensors

        dev, losses = torch.device("cuda"), []
        for _ in range(n):
            batch = batch_tensors(next(self.batches), dev, self.table)
            self.state, m = self.step(self.state, batch, self.state.generator)
            losses.append(m["loss"].detach().float())
        return torch.stack(losses).cpu().tolist()


def timed_turns(runs: dict, order, steps: int) -> dict:
    """ms/step of each ``runs[key](n)`` in the given order, each run after
    an untimed 2 steps; {key: {"step_ms", "spread", "runs_ms"}}."""
    got = {k: [] for k in runs}
    for k in order:
        runs[k](2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[k](steps)
        torch.cuda.synchronize()
        got[k].append((time.perf_counter() - t0) / steps * 1e3)
    return {k: {"step_ms": float(np.mean(v)), "runs_ms": v,
                "spread": (max(v) - min(v)) / float(np.mean(v))} for k, v in got.items()}


def busy_share(run, steps: int) -> dict:
    """Device busy time over host wall time of ``run(steps)`` under
    torch.profiler, read as tools/profile_train.py reads it."""
    from variational_mmt_torch.tools.profile_train import profiled

    run(1)
    wall_us, by_kernel = profiled(lambda: run(steps))
    busy = sum(t for t, _ in by_kernel.values())
    return {"wall_ms": wall_us / 1e3 / steps, "busy_ms": busy / 1e3 / steps,
            "busy_share": busy / wall_us}


def host_path_phase(card: str, cfg, state, root: str):
    """Phase 16 (module docstring): the trainer's host path on phase 10's
    corpus in ``root`` -- the native batcher, packer and BPE against their
    Python paths, the prefetched Trainer against the parent's direct loop,
    and the fused_decoder route. Returns ({kernel: launches on the counted
    runs}, record)."""
    from variational_mmt_torch import native
    from variational_mmt_torch.cli import train as cli_train
    from variational_mmt_torch.data.bpe import BPE, learn_bpe
    from variational_mmt_torch.data.dataset import BinarizedDataset, BucketIterator
    from variational_mmt_torch.data.packing import PackedBucketIterator
    from variational_mmt_torch.data.prefetch import prefetch
    from variational_mmt_torch.data.synthetic import make_corpus
    from variational_mmt_torch.models import decoder as mdec
    from variational_mmt_torch.models.model import build_model
    from variational_mmt_torch.train.trainer import Trainer, host_batches

    t_phase = time.time()
    total = dict.fromkeys(kernel_counters(), 0)
    rec = {}

    def counted(fn):
        got, out = counted_run(fn)
        for k in total:
            total[k] += got[k]
        return got, out

    t0 = time.time()
    if not native.available():
        fail(f"the native library is unavailable: {native.unavailable_reason()}")
    print(f"host_path: native library built and loaded in {time.time() - t0:.2f} s")
    prefix = os.path.join(root, "corpus")
    ds = BinarizedDataset.load(prefix + ".train.npz")
    feats = np.load(os.path.join(root, "train.feats.npy"))
    buckets, seed = cfg.data.buckets, cfg.train.seed

    def iterator(kind: str, use_native: bool, with_feats: bool = True):
        f = feats if with_feats else None
        if kind == "bucket":
            return BucketIterator(ds, HOST_BATCH, buckets, img_feats=f, shuffle=True, seed=seed,
                                  use_native=use_native)
        return PackedBucketIterator(ds, HOST_BATCH, [HOST_ROW], img_feats=f, seed=seed,
                                    max_segments=HOST_K, use_native=use_native)

    rec["batch_us"] = {}
    for kind in ("bucket", "packed"):
        its = {nat: iterator(kind, nat) for nat in (True, False)}
        for it in its.values():
            list(it.epoch(0))  # untimed: the flat layout, caches
        bad = same_batches(list(its[True].epoch(1)), list(its[False].epoch(1)))
        if bad:
            fail(f"{kind}: native and Python batches differ: {bad[:5]}")
        us = {True: [], False: []}
        for nat in (True, False, False, True):
            t0 = time.perf_counter()
            n = sum(1 for _ in its[nat].epoch(2))
            us[nat].append((time.perf_counter() - t0) / n * 1e6)
        r = {"native_us": float(np.mean(us[True])), "python_us": float(np.mean(us[False])),
             "batches": n}
        rec["batch_us"][kind] = r
        print(f"host_path: {kind} iterator, one shuffled epoch of {n} batches identical both "
              f"ways; host {r['native_us']:.1f} us a batch native, {r['python_us']:.1f} Python "
              f"(2048-d features gathered on the host; runs in turns)")

    src, tgt, _, _, _ = make_corpus(CLI_TRAIN + CLI_VALID + CLI_TEST, vocab_size=CLI_VOCAB,
                                    img_dim=CLI_IMG, seed=5)
    lines = list(src) + list(tgt)
    t0 = time.time()
    merges = learn_bpe(lines, HOST_BPE_MERGES)
    learn_s = time.time() - t0
    words = sorted({w for line in lines for w in line})
    pieces, rate = {}, {True: [], False: []}
    for nat in (True, False, False, True):
        bpe = BPE(merges, use_native=nat)
        if nat and bpe._native is None:
            fail("BPE did not take the native segmenter")
        t0 = time.perf_counter()
        pieces[nat] = [bpe.segment_word(w) for w in words]
        rate[nat].append(len(words) / (time.perf_counter() - t0))
    diff = [w for w, a, b in zip(words, pieces[True], pieces[False]) if a != b]
    if diff:
        fail(f"BPE: native and Python segmentations differ on {len(diff)} words: {diff[:5]}")
    rec["bpe"] = {"words": len(words), "merges": len(merges), "learn_s": learn_s,
                  "native_words_per_s": float(np.mean(rate[True])),
                  "python_words_per_s": float(np.mean(rate[False]))}
    print(f"host_path: BPE ({len(merges)} merges learned in {learn_s:.1f} s) segments the "
          f"corpus's {len(words)} words identically both ways; "
          f"{rec['bpe']['native_words_per_s']:.0f} words/s native, "
          f"{rec['bpe']['python_words_per_s']:.0f} Python (uncached)")

    # the prefetched Trainer (native batches) against the parent's direct loop
    table = torch.as_tensor(feats).to("cuda")
    loops = {}
    for kind, over, check_steps, order, steps in (
            ("train", {}, HOST_CHECK_STEPS, HOST_ORDER, HOST_TIMED),
            ("train_packed", {"pack": True, "pack_segments": HOST_K}, HOST_PACKED_CHECK,
             HOST_PACKED_ORDER, HOST_PACKED_TIMED)):
        c = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, pallas_decoder=True),
                                train=dataclasses.replace(cfg.train, **over))
        it_kind = "packed" if over else "bucket"
        model = build_model(c.model, device="cuda")
        model.load_state_dict(state)
        trainer = Trainer(c, model, iterator(it_kind, True, with_feats=False), device="cuda",
                          train_feats=feats)
        direct = DirectLoop(c, state, host_batches(iterator(it_kind, False, with_feats=False)),
                            table)
        runs = {"prefetched": lambda n: [h["loss"] for h in trainer.train(n)],
                "direct": direct.train}
        if not over:  # where the prefetcher's time goes: native batches, then the thread
            native_src = lambda: host_batches(iterator(it_kind, True, with_feats=False))  # noqa: E731
            runs["direct_native"] = DirectLoop(c, state, native_src(), table).train
            runs["thread_only"] = DirectLoop(c, state, prefetch(native_src()), table).train
        got, lp = counted(lambda: runs["prefetched"](check_steps))
        ld = direct.train(check_steps)
        rel = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(lp, ld))
        print(f"host_path: {kind}: the first {check_steps} losses, prefetched Trainer vs the "
              f"direct loop: {'equal to the bit' if lp == ld else f'max rel diff {rel:.2e}'}; "
              f"launches {got}")
        if lp != ld or not all(math.isfinite(v) for v in lp):
            fail(f"{kind}: the prefetched Trainer's losses differ from the direct loop's")
        times = timed_turns(runs, order, steps)
        for k in runs:
            t = times[k]
            if k in ("prefetched", "direct"):
                t.update(busy_share(runs[k], HOST_PACKED_PROFILE_STEPS if over
                                    else HOST_PROFILE_STEPS))
            busy = (f"; profiled {t['wall_ms']:.2f} ms/step wall, {t['busy_ms']:.2f} device "
                    f"busy, busy share {t['busy_share']:.3f}" if "busy_share" in t else "")
            print(f"host_path: {kind} {k}: {t['step_ms']:.2f} ms/step, spread "
                  f"{t['spread']:.1%} (runs {', '.join(f'{v:.2f}' for v in t['runs_ms'])}; "
                  f"{steps} steps a run){busy} ({card})")
        loops[kind] = times
        trainer.close()
        del trainer, direct, model, runs
        torch.cuda.empty_cache()
    rec["loops"] = loops

    # the fused_decoder route
    fused = dict(use_pallas=True, pallas_decoder=False, fused_decoder=True, fused_ce=True)
    rec["fused_f32_check"] = train_check_f32(cfg, state, label="fused_decoder", kernel=fused)
    batches = train_batches(cfg)
    trainers = {"fused": trainer_for(cfg, state, batches, pallas_decoder=False,
                                     fused_decoder=True),
                "pallas_decoder=1": trainer_for(cfg, state, batches, pallas_decoder=True),
                "pallas_decoder=0": trainer_for(cfg, state, batches, pallas_decoder=False)}
    got, hist = counted(lambda: trainers["fused"].train(FUSED_STEPS))
    losses = [h["loss"] for h in hist]
    print(f"host_path: fused_decoder bf16, {FUSED_STEPS} steps: launches {got}; losses "
          + " ".join(f"{v:.3f}" for v in losses))
    if not all(math.isfinite(v) for v in losses):
        fail("fused_decoder: a bf16 training loss is not finite")
    if got["decoder_fwd"] or got["decoder_bwd"] or not got["gru_layer_scan_bwd"]:
        fail("fused_decoder: rows 5 and 6 ran, or the scans did not")
    fused_ms = timed_turns({k: (lambda n, t=t: t.train(n)) for k, t in trainers.items()},
                           FUSED_ORDER, FUSED_TIMED)
    for k, t in fused_ms.items():
        print(f"host_path: {k}: {t['step_ms']:.2f} ms/step (runs "
              f"{', '.join(f'{v:.2f}' for v in t['runs_ms'])}; batch {TRAIN_BATCH}, "
              f"{FUSED_TIMED} steps a run, in turns; {card})")
    for t in trainers.values():
        t.close()
    del trainers
    torch.cuda.empty_cache()
    rec["fused_bf16"] = {"launches": got, "losses": losses, "routes": fused_ms}

    with open(os.path.join(root, "config.json")) as f:
        conf = json.load(f)
    conf["model"].update(fused_decoder=True, pallas_decoder=False)
    conf_path = os.path.join(root, "config_fused.json")
    with open(conf_path, "w") as f:
        json.dump(conf, f)
    calls = []
    route = mdec.fused_input_feed_decoder
    mdec.fused_input_feed_decoder = lambda *a: calls.append(1) or route(*a)
    try:
        got, tr = counted(lambda: cli_train.main(
            ["-data", prefix, "-config", conf_path, "-train_img_feats",
             os.path.join(root, "train.feats.npy"), "-batch_size", str(TRAIN_BATCH),
             "-max_steps", str(FUSED_CLI_STEPS), "-report_every", str(FUSED_CLI_STEPS),
             "-save_model", os.path.join(root, "fused_run")]))
    finally:
        mdec.fused_input_feed_decoder = route
    losses = [h["loss"] for h in tr.last_run["metrics"]]
    print(f"host_path: cli.train -config {{model: fused_decoder true}}: {len(losses)} steps, "
          f"the fused route taken {len(calls)} times, launches {got}")
    if (len(losses) != FUSED_CLI_STEPS or not all(math.isfinite(v) for v in losses)
            or len(calls) != FUSED_CLI_STEPS or got["decoder_fwd"] or got["decoder_bwd"]):
        fail("cli.train with fused_decoder: wrong steps, a loss not finite, or the wrong route")
    rec["fused_cli"] = {"steps": len(losses), "launches": got}
    rec["phase_s"] = time.time() - t_phase
    print(f"host_path: launches over the counted runs {total}; phase {rec['phase_s']:.1f} s")
    return total, rec


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def parallel_cfg(cfg, dtype: str):
    """The flagship on the kernel route (use_pallas, pallas_decoder,
    fused_ce) at ``dtype``; float32 also drops dropout and word dropout."""
    over = dict(compute_dtype=dtype, use_pallas=True, pallas_decoder=True, fused_ce=True)
    if dtype == "float32":
        over.update(dropout=0.0, word_dropout=0.0)
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **over))


def f32_trainer(cfg, state, batches, device: str, mesh=None):
    """A Trainer of the f32 flagship whose step is deterministic with z the
    posterior mean (``make_train_step(deterministic=True, sample=False)``)."""
    from variational_mmt_torch.models.model import build_model
    from variational_mmt_torch.train.trainer import Trainer, make_train_step

    model = build_model(cfg.model, device=device)
    model.load_state_dict(state)
    tr = Trainer(cfg, model, batches, device=device, mesh=mesh)
    tr.train_step = make_train_step(cfg, deterministic=True, sample=False, mesh=mesh)
    return tr


def top1(nbest) -> list:
    return [n[0][1] for n in nbest]


def parallel_child(rank: int, workdir: str) -> int:
    """One of phase 17 (b)'s two ranks (run as ``chip_smoke.py
    --parallel-rank R DIR``): both on cuda:0, gloo with CUDA tensors. DP 2 x
    TP 1 and DP 1 x TP 2, PAR_F32_STEPS f32 steps each; the TP-2 beam-4
    decode of PAR_DECODE requests; the TP-2 checkpoint (rank 0 writes) and
    the decode with its trained weights. Writes its numbers to
    DIR/rank<R>.json."""
    sys.path.insert(0, HERE)
    from variational_mmt_torch.config import DecodeConfig
    from variational_mmt_torch.data.vocab import SPECIALS, Vocab
    from variational_mmt_torch.decode.translator import Translator
    from variational_mmt_torch.models.model import build_model
    from variational_mmt_torch.parallel import mesh as pm
    from variational_mmt_torch.tools import flagship
    from variational_mmt_torch.train import checkpoint as ck

    # the kernels' libraries, built by the parent, load at first use
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg, state = flagship.load()
    cfg = parallel_cfg(cfg, "float32")
    batches = flagship.train_batches(cfg.model, TRAIN_BATCHES, TRAIN_BATCH)
    meshes = {name: pm.make_mesh(d, m, device="cuda:0", backend="gloo",
                                 init_method=f"file://{workdir}/store", rank=rank, world_size=2)
              for name, d, m in (("dp2", 2, 1), ("tp2", 1, 2))}
    out = {}
    for name, mesh in meshes.items():
        tr = f32_trainer(cfg, state, batches, device="cuda:0", mesh=mesh)
        t0 = time.perf_counter()
        launches, hist = counted_run(lambda: tr.train(PAR_F32_STEPS))
        out[name] = {"losses": [h["loss"] for h in hist], "launches": launches,
                     "ms_step": (time.perf_counter() - t0) * 1e3 / PAR_F32_STEPS}
    tp_trainer = tr
    V = cfg.model.tgt_vocab_size
    vocab = Vocab(SPECIALS + [f"w{i}" for i in range(V - len(SPECIALS))])
    src, img = flagship.requests(cfg.model, PAR_DECODE_SEED)(PAR_DECODE)
    dcfg = DecodeConfig(beam_size=4, max_length=60, batch_size=PAR_DECODE, pallas_step=1)
    model = build_model(cfg.model, device="cuda:0")
    model.load_state_dict(state)
    tr = Translator(model, vocab, vocab, dcfg, mesh=meshes["tp2"])
    launches, nbest = counted_run(lambda: tr.translate_ids(src, img))
    tr.close()
    out["decode"] = {"top1": top1(nbest), "launches": launches}
    path = ck.save_checkpoint(os.path.join(workdir, "ckpt"), tp_trainer.state, cfg, vocab,
                              vocab, mesh=meshes["tp2"])
    tr = Translator(tp_trainer.model, vocab, vocab, dcfg, mesh=meshes["tp2"])
    out["trained_decode"] = {"top1": top1(tr.translate_ids(src, img)), "checkpoint": path}
    tr.close()
    tp_trainer.close()
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    meshes["dp2"].close()
    return 0


def parallel_phase(card: str, cfg, state):
    """Phase 17 (module docstring): (a) the Trainer through the DP code
    path on an NCCL group of one rank, in turns with the plain Trainer;
    (b) two ranks on the one card over gloo. Returns ({kernel: launches of
    (a)'s mesh trainer and (b)'s ranks}, record)."""
    from variational_mmt_torch.config import DecodeConfig
    from variational_mmt_torch.data.vocab import SPECIALS, Vocab
    from variational_mmt_torch.decode.translator import Translator
    from variational_mmt_torch.models.model import build_model
    from variational_mmt_torch.parallel import mesh as pm
    from variational_mmt_torch.tools import flagship
    from variational_mmt_torch.train import checkpoint as ck
    from variational_mmt_torch.train.trainer import Trainer

    t_phase = time.time()
    rec = {"card": card}
    # (a) NCCL, one rank, bf16
    batches = train_batches(cfg)
    cfg16 = parallel_cfg(cfg, "bfloat16")
    mesh = pm.make_mesh(1, 1, device="cuda:0", backend="nccl",
                        init_method=f"tcp://localhost:{free_port()}", rank=0, world_size=1)
    trainers = {}
    for name, m in (("plain", None), ("mesh", mesh)):
        model = build_model(cfg16.model, device="cuda")
        model.load_state_dict(state)
        trainers[name] = Trainer(cfg16, model, batches, device="cuda", mesh=m)
    losses = {"plain": [], "mesh": []}
    ms = {"plain": [], "mesh": []}
    launches = dict.fromkeys(kernel_counters(), 0)
    for turn in range(PAR_TURNS):
        for name in (("mesh", "plain") if turn % 2 == 0 else ("plain", "mesh")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if name == "mesh":
                counts, hist = counted_run(lambda: trainers[name].train(PAR_TURN_STEPS))
                launches = {k: launches[k] + n for k, n in counts.items()}
            else:
                hist = trainers[name].train(PAR_TURN_STEPS)
            torch.cuda.synchronize()
            if turn > 0:  # the first turn warms both up
                ms[name].append((time.perf_counter() - t0) * 1e3 / PAR_TURN_STEPS)
            losses[name].extend(h["loss"] for h in hist)
    n_params = sum(p.numel() for p in trainers["mesh"].model.parameters())
    for tr in trainers.values():
        tr.close()
    mesh.close()
    same = losses["mesh"] == losses["plain"]
    print(f"parallel (a): NCCL group of 1 rank, DP code path vs plain Trainer, "
          f"{len(losses['mesh'])} bf16 steps in turns: losses equal to the bit: {same}")
    if not same:
        diff = [(i, a, b) for i, (a, b) in enumerate(zip(losses["mesh"], losses["plain"]))
                if a != b]
        fail(f"the DP code path's losses differ from the plain Trainer's: {diff[:4]}")
    for name in ("mesh", "plain"):
        mean = float(np.mean(ms[name]))
        print(f"parallel (a): {name}: {mean:.2f} ms/step, spread "
              f"{(max(ms[name]) - min(ms[name])) / mean:.1%} (runs "
              f"{', '.join(f'{v:.2f}' for v in ms[name])} ms; batch {TRAIN_BATCH}, "
              f"{PAR_TURN_STEPS} steps a run, {card})")
    grad_bytes = 4 * n_params
    print(f"parallel (a): all-reduced a step: {n_params} f32 gradients = "
          f"{grad_bytes / 2**20:.1f} MiB in 64 MiB buckets, plus 4 B (sentence count); the "
          "metrics once a read")
    for name in PAR_ROWS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the DP code path")
    rec["a"] = {"losses_equal": same, "steps": len(losses["mesh"]),
                "ms_step": {k: float(np.mean(v)) for k, v in ms.items()},
                "runs_ms": ms, "allreduce_bytes_per_step": grad_bytes, "launches": launches}

    # (b) two ranks on the one card, gloo with CUDA tensors
    cfg32 = parallel_cfg(cfg, "float32")
    V = cfg32.model.tgt_vocab_size
    vocab = Vocab(SPECIALS + [f"w{i}" for i in range(V - len(SPECIALS))])
    src, img = flagship.requests(cfg32.model, PAR_DECODE_SEED)(PAR_DECODE)
    dcfg = DecodeConfig(beam_size=4, max_length=60, batch_size=PAR_DECODE, pallas_step=1)
    with tempfile.TemporaryDirectory(prefix="vmmt_par_") as workdir:
        logs = [open(os.path.join(workdir, f"log{r}.txt"), "w") for r in range(2)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-rank",
                                   str(r), workdir], stdout=logs[r], stderr=subprocess.STDOUT)
                 for r in range(2)]
        try:
            # the single process's references while the ranks start
            ref = f32_trainer(cfg32, state, batches, device="cuda")
            ref_losses = [h["loss"] for h in ref.train(PAR_F32_STEPS)]
            ref.close()
            model = build_model(cfg32.model, device="cuda")
            model.load_state_dict(state)
            tr = Translator(model, vocab, vocab, dcfg, device="cuda")
            ref_top1 = top1(tr.translate_ids(src, img))
            tr.close()
            deadline = time.monotonic() + PAR_CHILD_TIMEOUT_S
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                with open(os.path.join(workdir, f"log{r}.txt")) as f:
                    print(f.read()[-6000:], file=sys.stderr)
                fail(f"phase 17 (b): rank {r} failed or timed out (exit {p.returncode})")
        ranks = []
        for r in range(2):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        state_l, _, model_l, _, _ = ck.load_checkpoint(ranks[0]["trained_decode"]["checkpoint"],
                                                       device="cuda")
        tr = Translator(model_l, vocab, vocab, dcfg, device="cuda")
        ckpt_top1 = top1(tr.translate_ids(src, img))
        tr.close()
    rec["b"] = {}
    for name in ("dp2", "tp2"):
        worst = 0.0
        for r, got in enumerate(ranks):
            run = got[name]
            rel = [abs(a - b) / abs(b) for a, b in zip(run["losses"], ref_losses)]
            worst = max(worst, max(rel))
            if len(rel) != PAR_F32_STEPS or max(rel) > PAR_TOL:
                fail(f"phase 17 (b): {name} rank {r} losses {run['losses']} against one "
                     f"process {ref_losses} (tolerance {PAR_TOL} relative)")
            for k in PAR_ROWS:
                if run["launches"][k] <= 0:
                    fail(f"phase 17 (b): {name} rank {r} did not launch {k}")
        ms_ranks = [got[name]["ms_step"] for got in ranks]
        print(f"parallel (b): {name}: {PAR_F32_STEPS} f32 steps, worst loss difference from "
              f"one process {worst:.2e} relative (tolerance {PAR_TOL}); "
              f"{', '.join(f'{v:.1f}' for v in ms_ranks)} ms/step on ranks 0, 1 (two ranks "
              f"share one card and gloo stages every collective through the host: not a "
              f"scaling number; {card})")
        rec["b"][name] = {"worst_loss_rel": worst, "ms_step_ranks": ms_ranks,
                          "launches_ranks": [got[name]["launches"] for got in ranks]}
    dec_same = [sum(a == b for a, b in zip(got["decode"]["top1"], ref_top1)) for got in ranks]
    ck_same = sum(a == b for a, b in zip(ranks[0]["trained_decode"]["top1"], ckpt_top1))
    print(f"parallel (b): TP-2 beam-4 f32 decode of {PAR_DECODE} requests (pallas_step 1): "
          f"top-1 equal to one process's on {dec_same} of {PAR_DECODE} (ranks 0, 1); the TP-2 "
          f"checkpoint (step {state_l.step}, written by rank 0) loaded by one process decodes "
          f"the TP-2 ranks' top-1 on {ck_same} of {PAR_DECODE}")
    if min(dec_same) < PAR_DECODE - 1:
        fail("phase 17 (b): the TP-2 decode disagrees with one process on more than 1 sentence")
    if ck_same < PAR_DECODE - 1 or state_l.step != PAR_F32_STEPS:
        fail("phase 17 (b): the TP-2 checkpoint does not decode as the TP-2 ranks do")
    rec["b"].update(decode_top1_same=dec_same, checkpoint_top1_same=ck_same)
    for got in ranks:
        for part in ("dp2", "tp2", "decode"):
            launches = {k: launches[k] + n for k, n in got[part]["launches"].items()}
    rec["phase_s"] = time.time() - t_phase
    print(f"parallel phase {rec['phase_s']:.1f} s")
    return launches, rec


def serve_rank_model(ckpt: str, device: str):
    """Phase 10's checkpoint as an f32 model on ``device``, with its vocabs."""
    from variational_mmt_torch.models.model import build_model
    from variational_mmt_torch.train import checkpoint as ck

    _, cfg, model, sv, tv = ck.load_checkpoint(ckpt, device=device)
    m32 = build_model(dataclasses.replace(cfg.model, compute_dtype="float32"), device=device)
    m32.load_state_dict(model.state_dict())
    return m32, sv, tv


def serve_rank_requests(root: str, sv):
    """Phase 10's first SRV_RANK_SENT test sentences as ids, with their
    features."""
    with open(os.path.join(root, "test.src"), encoding="utf-8") as f:
        ids = [sv.encode(line.split()) for line in f][:SRV_RANK_SENT]
    return ids, np.load(os.path.join(root, "test.feats.npy"))[:SRV_RANK_SENT]


def serve_rank_dcfg():
    from variational_mmt_torch.config import DecodeConfig

    return DecodeConfig(beam_size=4, max_length=SRV_RANK_MAXLEN, batch_size=SRV_RANK_BATCH,
                        pallas_step=1)


def serve_rank_child(rank: int, workdir: str) -> int:
    """One of phase 19's two ranks (``chip_smoke.py --serve-rank R DIR``),
    both on cuda:0 over gloo with CUDA tensors: the service on TP-2, then
    on DP-2. Rank 0 serves SRV_RANK_SENT single-sentence requests from
    SRV_RANK_CLIENTS closed-loop client threads; rank 1 follows. Each
    rank's launch counts are set to 0 before its service is built and read
    after it stops. Writes DIR/rank<R>.json."""
    import threading

    sys.path.insert(0, HERE)
    from variational_mmt_torch.parallel import mesh as pm
    from variational_mmt_torch.serve import ServeConfig, TranslationService

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with open(os.path.join(workdir, "inputs.json")) as f:
        inp = json.load(f)
    model, sv, tv = serve_rank_model(inp["ckpt"], "cuda:0")
    ids, feats = serve_rank_requests(inp["root"], sv)
    meshes = {name: pm.make_mesh(d, m, device="cuda:0", backend="gloo",
                                 init_method=f"file://{workdir}/store", rank=rank, world_size=2)
              for name, d, m in (("tp2", 1, 2), ("dp2", 2, 1))}
    out = {}
    for name, mesh in meshes.items():
        def served():
            svc = TranslationService(model, sv, tv, serve_rank_dcfg(), buckets=SERVE_BUCKETS,
                                     scfg=ServeConfig(max_wait_ms=5.0, pipeline_depth=2),
                                     mesh=mesh, device="cuda:0")
            if rank != 0:
                svc.follow()
                return {}
            answers, lat = [None] * len(ids), []
            order, lock = iter(range(len(ids))), threading.Lock()

            def client():
                while True:
                    with lock:
                        i = next(order, None)
                    if i is None:
                        return
                    t = time.perf_counter()
                    answers[i] = svc.submit_ids_batch([ids[i]], feats[i:i + 1])[0].result(300)
                    lat.append(time.perf_counter() - t)

            threads = [threading.Thread(target=client) for _ in range(SRV_RANK_CLIENTS)]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            secs = time.perf_counter() - t0
            stats = dict(svc.stats)
            svc.stop()
            return {"top1": top1(answers[:SRV_RANK_CHECK]), "sent_per_s": len(ids) / secs,
                    "p50_ms": float(np.percentile(lat, 50)) * 1e3,
                    "p99_ms": float(np.percentile(lat, 99)) * 1e3, "stats": stats}

        launches, rec = counted_run(served)
        out[name] = dict(rec, launches=launches)
    with open(os.path.join(workdir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    meshes["tp2"].close()
    return 0


def serve_ranks_phase(card: str, root: str):
    """Phase 19 (module docstring): the service across two ranks on the
    one card. Returns ({kernel: both ranks' launches}, record)."""
    from variational_mmt_torch.serve import ServeConfig, TranslationService
    from variational_mmt_torch.train import checkpoint as ck

    t_phase = time.time()
    ckpt = ck.latest_checkpoint(os.path.join(root, "run"))
    with tempfile.TemporaryDirectory(prefix="vmmt_srv_") as workdir:
        with open(os.path.join(workdir, "inputs.json"), "w") as f:
            json.dump({"ckpt": ckpt, "root": root}, f)
        logs = [open(os.path.join(workdir, f"log{r}.txt"), "w") for r in range(2)]
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--serve-rank",
                                   str(r), workdir], stdout=logs[r], stderr=subprocess.STDOUT)
                 for r in range(2)]
        try:
            # one process's service, the reference, while the ranks start
            model, sv, tv = serve_rank_model(ckpt, "cuda")
            ids, feats = serve_rank_requests(root, sv)
            svc = TranslationService(model, sv, tv, serve_rank_dcfg(), buckets=SERVE_BUCKETS,
                                     scfg=ServeConfig(warmup=False), device="cuda")
            ref = top1([f.result(300) for f in svc.submit_ids_batch(ids[:SRV_RANK_CHECK],
                                                                    feats[:SRV_RANK_CHECK])])
            svc.stop()
            deadline = time.monotonic() + SRV_RANK_TIMEOUT_S
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                with open(os.path.join(workdir, f"log{r}.txt")) as f:
                    print(f.read()[-6000:], file=sys.stderr)
                fail(f"phase 19: rank {r} failed or timed out (exit {p.returncode}): the "
                     "stop did not reach it, or it failed")
        ranks = []
        for r in range(2):
            with open(os.path.join(workdir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    rec = {"card": card}
    launches = dict.fromkeys(kernel_counters(), 0)
    for name in ("tp2", "dp2"):
        got = ranks[0][name]
        same = sum(a == b for a, b in zip(got["top1"], ref))
        print(f"serve ranks: {name}: {SRV_RANK_SENT} requests from {SRV_RANK_CLIENTS} closed-loop "
              f"clients, {got['sent_per_s']:.1f} sent/s, p50 {got['p50_ms']:.0f} ms, p99 "
              f"{got['p99_ms']:.0f} ms as read (two ranks share one card and gloo stages every "
              f"collective through the host: not a scaling number; {card}); top-1 equal to one "
              f"process's service (f32) on {same} of {SRV_RANK_CHECK}; launches rank 0 "
              f"{got['launches']}, rank 1 {ranks[1][name]['launches']}")
        if same < SRV_RANK_CHECK - 1:
            fail(f"phase 19: {name} serving disagrees with one process on more than 1 sentence")
        for r, ranked in enumerate(ranks):
            for k in SRV_RANK_ROWS:
                if ranked[name]["launches"][k] <= 0:
                    fail(f"phase 19: {name} rank {r} did not launch {k}")
            launches = {k: launches[k] + n for k, n in ranked[name]["launches"].items()}
        rec[name] = {k: got[k] for k in ("sent_per_s", "p50_ms", "p99_ms", "stats")}
        rec[name].update(top1_same=same, launches_ranks=[rk[name]["launches"] for rk in ranks])
    rec["phase_s"] = time.time() - t_phase
    print(f"serve ranks phase {rec['phase_s']:.1f} s")
    return launches, rec


def resnet_conv_flops(sd: dict, stages, n_images: int, size: int = 224) -> float:
    """2 x the multiply-adds of every convolution of the trunk over
    ``n_images`` of size x size, from the state dict's kernel shapes."""
    out = lambda r, k, stride, pad: (r + 2 * pad - k) // stride + 1  # noqa: E731

    def conv(key, r_out):
        o, i, kh, kw = sd[key].shape
        return 2.0 * o * i * kh * kw * r_out * r_out

    r = out(size, 7, 2, 3)
    total = conv("conv1.weight", r)
    r = out(r, 3, 2, 1)  # maxpool
    for si, n_blocks in enumerate(stages, start=1):
        for bi in range(n_blocks):
            p, stride = f"layer{si}.{bi}", 2 if (si > 1 and bi == 0) else 1
            r_mid = out(r, 3, stride, 1)
            total += conv(f"{p}.conv1.weight", r) + conv(f"{p}.conv2.weight", r_mid) \
                + conv(f"{p}.conv3.weight", r_mid)
            if f"{p}.downsample.0.weight" in sd:
                total += conv(f"{p}.downsample.0.weight", r_mid)
            r = r_mid
    return total * n_images


def extract_phase(card: str, root: str):
    """Image features on the card (module docstring, phase 18), in phase
    10's directory ``root``. Returns ({kernel: launches of step (f)},
    record)."""
    import importlib.util

    from variational_mmt_torch.cli.extract_features import LazyImages
    from variational_mmt_torch.config import DecodeConfig
    from variational_mmt_torch.data.features import load_features, save_features
    from variational_mmt_torch.decode.translator import Translator
    from variational_mmt_torch.models import resnet
    from variational_mmt_torch.tools import flagship
    from variational_mmt_torch.train import checkpoint as ck

    t_phase = time.time()
    rec = {}
    sd = flagship.resnet_weights()
    stages = resnet.stage_sizes(sd)
    n_params = sum(v.size for v in sd.values())
    trunk = resnet.ResNetTrunk(sd, device="cuda")
    rng = np.random.default_rng(3)
    images = rng.standard_normal((EXTRACT_PARTIAL, 224, 224, 3), np.float32)
    print(f"extract: ResNet-50 stages {stages}, {n_params} weights (numpy seed 2), "
          f"{EXTRACT_PARTIAL} 224x224 images (numpy seed 3)")

    def rel(got, want) -> float:
        return float(np.abs(got - want).max() / np.abs(want).max())

    # (a) the card's float32 against the port's trunk on the CPU
    with torch.inference_mode():
        card_out = [t.cpu().numpy() for t in trunk(torch.from_numpy(images[:EXTRACT_CHECK]))]
        cpu_out = [t.numpy() for t in resnet.ResNetTrunk(sd, device="cpu")(
            torch.from_numpy(images[:EXTRACT_CHECK]))]
    rec["card_vs_cpu"] = {k: rel(a, b) for k, a, b in zip(("pool5", "conv"), card_out, cpu_out)}
    print(f"extract (a): f32 card vs CPU on {EXTRACT_CHECK} images, max |diff| / max |CPU|: "
          f"pool5 {rec['card_vs_cpu']['pool5']:.3e}, conv {rec['card_vs_cpu']['conv']:.3e} "
          f"(tolerance {EXTRACT_TOL}); shapes {card_out[0].shape}, {card_out[1].shape}")
    if card_out[0].shape != (EXTRACT_CHECK, 2048) or card_out[1].shape != (EXTRACT_CHECK, 49, 2048):
        fail("phase 18 (a): wrong feature shapes")
    if not all(np.isfinite(a).all() for a in card_out) or \
            max(rec["card_vs_cpu"].values()) > EXTRACT_TOL:
        fail("phase 18 (a): the card's features disagree with the CPU's")

    # (b) rows of a batch of 32 and of a last partial batch against each
    # image run alone
    rec["alignment"] = {}
    feats = {}
    for feat_type in ("pool5", "conv"):
        feats[feat_type] = resnet.extract_features(sd, images, feat_type, EXTRACT_BATCH,
                                                   device="cuda")
        alone = resnet.extract_features(sd, images, feat_type, 1, device="cuda")
        rec["alignment"][feat_type] = rel(feats[feat_type], alone)
    print(f"extract (b): {EXTRACT_PARTIAL} images at batch {EXTRACT_BATCH} (a last batch of "
          f"{EXTRACT_PARTIAL - EXTRACT_BATCH}) against each alone: pool5 "
          f"{rec['alignment']['pool5']:.3e}, conv {rec['alignment']['conv']:.3e} "
          f"(tolerance {EXTRACT_TOL})")
    if max(rec["alignment"].values()) > EXTRACT_TOL:
        fail("phase 18 (b): a row depends on the other images of its batch")

    # (c) the trunk's speed at batch 32, float32 and TF32 in turns
    x = torch.from_numpy(images[:EXTRACT_BATCH]).cuda()
    x_nchw = x.permute(0, 3, 1, 2)

    def f32():
        return trunk(x)

    def tf32():
        prev = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = True
        try:
            y = trunk.trunk_nchw(x_nchw)
            return y.mean(dim=(2, 3)), y.permute(0, 2, 3, 1).reshape(y.shape[0], -1, y.shape[1])
        finally:
            torch.backends.cudnn.allow_tf32 = prev

    runs = {"f32": [], "tf32": []}
    with torch.inference_mode():
        for mode in EXTRACT_TURNS:
            runs[mode].append(cuda_ms(f32 if mode == "f32" else tf32, iters=EXTRACT_ITERS))
        tf32_err = {k: rel(a.cpu().numpy(), b.cpu().numpy())
                    for k, a, b in zip(("pool5", "conv"), tf32(), f32())}
    conv_flops = resnet_conv_flops(sd, stages, EXTRACT_BATCH)
    n_bytes = 4.0 * (x.numel() + n_params + EXTRACT_BATCH * 2048 * 50)
    rec["trunk"] = {"batch": EXTRACT_BATCH, "gflop_per_image": conv_flops / EXTRACT_BATCH / 1e9,
                    "bytes": n_bytes, "tf32_vs_f32": tf32_err}
    for mode, peak in (("f32", H100_F32_FLOPS), ("tf32", H100_TF32_FLOPS)):
        ms = float(np.mean(runs[mode]))
        b_ms = max(n_bytes / H100_BYTES_PER_S, conv_flops / peak) * 1e3
        rec["trunk"][mode] = {"ms": ms, "runs_ms": runs[mode],
                              "images_per_s": EXTRACT_BATCH / ms * 1e3, "bound_ms": b_ms,
                              "bound_by": "bytes" if n_bytes / H100_BYTES_PER_S
                              > conv_flops / peak else "operations",
                              "bound_images_per_s": EXTRACT_BATCH / b_ms * 1e3}
        r = rec["trunk"][mode]
        print(f"extract (c): trunk {mode} at batch {EXTRACT_BATCH}: {ms:.3f} ms a batch (runs "
              f"{', '.join(f'{v:.3f}' for v in runs[mode])}), {r['images_per_s']:.1f} images/s; "
              f"bound {b_ms:.3f} ms ({r['bound_by']}; {r['bound_images_per_s']:.1f} images/s; "
              f"{conv_flops / EXTRACT_BATCH / 1e9:.3f} GFLOP an image, {n_bytes / 1e6:.1f} MB) "
              f"({card})")
    print(f"extract (c): TF32 against f32, max |diff| / max |f32|: pool5 "
          f"{tf32_err['pool5']:.3e}, conv {tf32_err['conv']:.3e} (a finding: the entry points "
          "compute in f32)")

    # (d) the CLI in a fresh process with PyTorch's default flags
    if importlib.util.find_spec("PIL") is None:
        rec["cli"] = "not run: PIL is not installed"
        print("extract (d): " + json.dumps({"cli": rec["cli"]}))
    else:
        from PIL import Image as PILImage

        img_dir = os.path.join(root, "images")
        os.makedirs(img_dir, exist_ok=True)
        img_rng = np.random.default_rng(4)
        names = []
        for i in range(EXTRACT_CLI_IMAGES):
            hw = tuple(int(v) for v in img_rng.integers(200, 401, 2))
            PILImage.fromarray(img_rng.integers(0, 256, hw + (3,), dtype=np.uint8)).save(
                os.path.join(img_dir, f"img{i:03d}.png"))
            names.append(f"img{i:03d}.png")
        with open(os.path.join(root, "images.txt"), "w") as f:
            f.writelines(n + "\n" for n in names)
        weights = os.path.join(root, "resnet50_random.npz")
        np.savez(weights, **sd)
        out_path = os.path.join(root, "cli_feats.npy")
        t0 = time.time()
        r = subprocess.run([sys.executable, "-m", "variational_mmt_torch.cli.extract_features",
                            "-images_dir", img_dir, "-image_list",
                            os.path.join(root, "images.txt"), "-output", out_path,
                            "-weights", weights, "-batch_size", str(EXTRACT_BATCH)],
                           cwd=HERE, capture_output=True, text=True, timeout=300)
        wall = time.time() - t0
        if r.returncode != 0:
            print(r.stdout[-4000:] + r.stderr[-4000:], file=sys.stderr)
            fail("phase 18 (d): the extract_features CLI failed")
        cli_feats = load_features(out_path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        here = resnet.extract_features(sd, LazyImages(img_dir, names), "pool5", EXTRACT_BATCH,
                                       device="cuda")
        here_s = time.perf_counter() - t0
        err = rel(cli_feats, here)
        line = r.stdout.strip().splitlines()[-1]
        cli_rate = float(line.split(" s, ")[1].split(" images/s")[0])
        rec["cli"] = {"images": EXTRACT_CLI_IMAGES, "vs_in_process": err,
                      "cli_images_per_s": cli_rate, "process_wall_s": wall,
                      "in_process_images_per_s": EXTRACT_CLI_IMAGES / here_s}
        print(f"extract (d): CLI ({line}); process wall {wall:.1f} s; in this process "
              f"{rec['cli']['in_process_images_per_s']:.1f} images/s (decoding included, "
              f"warm); CLI vs in-process max |diff| / max |in-process| {err:.3e} (tolerance "
              f"{EXTRACT_CLI_TOL}) ({card})")
        if cli_feats.shape != (EXTRACT_CLI_IMAGES, 2048) or err > EXTRACT_CLI_TOL:
            fail("phase 18 (d): the CLI's features differ from the in-process extraction")

    # (e) save_features to .h5 with or without h5py
    h5 = os.path.join(root, "feats.h5")
    if importlib.util.find_spec("h5py") is None:
        try:
            save_features(h5, feats["pool5"])
        except ImportError as e:
            if ".npy" not in str(e):
                fail(f"phase 18 (e): the error without h5py does not name .npy: {e}")
            rec["h5"] = f"h5py is not installed: save_features raised {e}"
        else:
            fail("phase 18 (e): save_features wrote .h5 without h5py")
    else:
        save_features(h5, feats["pool5"])
        if not np.array_equal(load_features(h5), feats["pool5"]):
            fail("phase 18 (e): the .h5 file does not read back equal")
        rec["h5"] = "h5py is installed: .h5 written and read back equal"
    print(f"extract (e): {rec['h5']}")

    # (f) images to translations on phase 10's checkpoint
    _, cfg, model, sv, tv = ck.load_checkpoint(ck.latest_checkpoint(os.path.join(root, "run")),
                                               device="cuda")
    with open(os.path.join(root, "test.src"), encoding="utf-8") as f:
        src_ids = [sv.encode(line.lower().split())
                   for line in itertools.islice(f, EXTRACT_SENT)]
    tr = Translator(model, sv, tv, DecodeConfig(beam_size=4, max_length=60,
                                                batch_size=EXTRACT_SENT, pallas_step=1),
                    device="cuda")
    launches, out = counted_run(lambda: tr.translate_ids(src_ids, feats["pool5"][:EXTRACT_SENT]))
    tr.close()
    well_formed(out, EXTRACT_SENT, cfg.model.tgt_vocab_size, 60)
    rec["translate"] = {"sentences": EXTRACT_SENT, "launches": launches,
                        "mean_top1_len": float(np.mean([len(n[0][1]) for n in out]))}
    print(f"extract (f): {EXTRACT_SENT} sentences with extracted pool5 features through the "
          f"Translator (pallas_step 1, beam 4) on phase 10's checkpoint: well formed, mean "
          f"top-1 length {rec['translate']['mean_top1_len']:.2f}; launches {launches}")
    for k in ("gru_layer_scan", "decode_step"):
        if launches[k] <= 0:
            fail(f"phase 18 (f): kernel {k} was not launched on the extraction path")
    del trunk, x, x_nchw, model
    torch.cuda.empty_cache()
    rec["phase_s"] = time.time() - t_phase
    print(f"extract phase {rec['phase_s']:.1f} s")
    return launches, rec


def width_record(name: str, widths: dict) -> dict:
    """One kernel's numbers at the widths phase's shapes: rows 1 and 2 by
    shape (errors, plans, bf16 times, cuDNN, bounds), rows 3-6 at H=250."""
    keys = ("ms", "ms_weights_padded", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "plan", "err_float32", "err_bfloat16", "edge_err_float32", "edge_err_bfloat16")
    if name in ("gru_layer_scan", "gru_layer_scan_bwd"):
        bwd = name.endswith("bwd")
        out = {}
        for at, r in widths["scan"].items():
            out[at] = {k: v for k, v in r.items()
                       if k.startswith("bwd_") == bwd and k not in ("fwd", "bwd")}
            if ("bwd" if bwd else "fwd") in r:
                out[at].update(r["bwd" if bwd else "fwd"])
        return out
    if name in ("decode_step", "gru_chain"):
        i = 0 if name == "decode_step" else 1
        return {f"N={n} S={WIDTH_DEC['S']} H={WIDTH_DEC['H']}": {k: r[i][k] for k in keys
                                                                if k in r[i]}
                for n, r in widths["step"].items()}
    r = widths["decoder"][0 if name == "decoder_fwd" else 1]
    return {" ".join(f"{k}={v}" for k, v in WIDTH_DEC.items()): {k: r[k] for k in keys
                                                                 if k in r}}


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--parallel-rank":
        return parallel_child(int(sys.argv[2]), sys.argv[3])
    if len(sys.argv) == 4 and sys.argv[1] == "--serve-rank":
        return serve_rank_child(int(sys.argv[2]), sys.argv[3])
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a CUDA card")
    if not os.path.isdir(os.path.join(HERE, "variational_mmt_torch")):
        fail("variational_mmt_torch/ is not beside chip_smoke.py: run it from a checkout")
    sys.path.insert(0, HERE)
    from variational_mmt_torch import kernels
    from variational_mmt_torch.ops import decode_step as ds, decoder as dec, gru_scan

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.time()
    logs = kernels.build()
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "error" in line.lower():
                print(f"  nvcc {name}: {line.strip()}")
    print(f"build: {time.time() - t0:.1f} s")

    scan = scan_phase(gru_scan, SCAN_SHAPE, {"serve": SCAN_SHAPE, "train": TRAIN_SCAN_SHAPE})
    step, chain = step_phase(ds, STEP_SHAPE)
    scan_bwd = scan_bwd_phase(gru_scan, TRAIN_SCAN_SHAPE)
    # the reset stream of both scans (sequence packing)
    scan["reset"], scan_bwd["reset"] = scan_reset_checks(gru_scan)
    dec_fwd, dec_bwd = decoder_phase(dec, DEC_SHAPE)
    cfg, state = load_flagship()
    serve_launches, rate = slice_phase(card, cfg.model, state)
    train_launches, steps = train_phase(card, cfg, state)
    check = train_check_f32(cfg, state)
    packed_launches, packed_resets, packed = packed_train_phase(card, cfg, state, steps)
    packed["f32_check"] = packed_check_f32(cfg, state)
    # every kernel again, with every check, at the quality gate's shapes
    gate_shape = {"gru_layer_scan": scan_phase(gru_scan, GATE_SCAN_SHAPE,
                                               {"gate": GATE_SCAN_SHAPE}),
                  "gru_layer_scan_bwd": scan_bwd_phase(gru_scan, GATE_SCAN_SHAPE)}
    gate_shape["decode_step"], gate_shape["gru_chain"] = step_phase(ds, GATE_STEP_SHAPE)
    gate_shape["decoder_fwd"], gate_shape["decoder_bwd"] = decoder_phase(dec, GATE_DEC_SHAPE)
    family_launches, families = families_phase(card)
    with tempfile.TemporaryDirectory(prefix="vmmt_cli_") as root:
        cli_launches, cli = cli_phase(card, steps["pallas_decoder=1"]["step_ms"], root)
        online_launches, served = serve_phase(card, root)
        t0 = time.time()
        eval_launches, evals = eval_phase(card, root)
        evals["phase_s"] = time.time() - t0
        t0 = time.time()
        width_launches, widths = widths_phase(card, root)
        widths["phase_s"] = time.time() - t0
        print(f"eval phase {evals['phase_s']:.1f} s, widths phase {widths['phase_s']:.1f} s")
        ens_launches, ens = ensemble_phase(card, root)
        opt_launches, options = options_phase(card, cfg, state)
        host_launches, host = host_path_phase(card, cfg, state, root)
        extract_launches, extract = extract_phase(card, root)
        srv_rank_launches, srv_ranks = serve_ranks_phase(card, root)
    par_launches, par = parallel_phase(card, cfg, state)

    entries = []
    for name, rec, src, replaces in (
        ("gru_layer_scan", scan, "variational_mmt_torch/csrc/gru_scan.cu",
         "variational_mmt_tpu/ops/pallas/gru.py:165"),
        ("gru_layer_scan_bwd", scan_bwd, "variational_mmt_torch/csrc/gru_scan.cu",
         "variational_mmt_tpu/ops/pallas/gru.py:297"),
        ("decode_step", step, "variational_mmt_torch/csrc/decode_step.cu",
         "variational_mmt_tpu/ops/pallas/decode_step.py:176"),
        ("gru_chain", chain, "variational_mmt_torch/csrc/decode_step.cu",
         "variational_mmt_tpu/ops/pallas/decode_step.py:118"),
        ("decoder_fwd", dec_fwd, "variational_mmt_torch/csrc/decoder.cu",
         "variational_mmt_tpu/ops/pallas/decoder.py:153"),
        ("decoder_bwd", dec_bwd, "variational_mmt_torch/csrc/decoder.cu",
         "variational_mmt_tpu/ops/pallas/decoder.py:304"),
    ):
        by_path = {"serve": serve_launches.get(name, 0), "train": train_launches.get(name, 0),
                   "train_packed": packed_launches.get(name, 0),
                   "families": family_launches[name], "cli": cli_launches[name],
                   **{path: n.get(name, 0) for path, n in online_launches.items()},
                   "eval": eval_launches[name], "widths": width_launches[name],
                   **{path: n[name] for path, n in ens_launches.items()},
                   "options": opt_launches[name], "host_path": host_launches[name],
                   "parallel": par_launches[name], "extract": extract_launches[name],
                   "serve_ranks": srv_rank_launches[name]}
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": rec.get("abs_err_bfloat16", rec["err_bfloat16"]),
            "dtype": "bfloat16", "ms": rec["ms"], "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"],
        }
        if "peaked" in rec:  # the decoder's checks at attention memory std 0.5
            entry["peaked"] = {k: v for k, v in rec["peaked"].items() if k != "per_step"}
        for key in ("plan", "edge_err_float32", "edge_err_bfloat16", "by_shape", "reset",
                    "library_eager_ms", "device_ms"):
            if key in rec:
                entry[key] = rec[key]
        if name in packed_resets:
            entry["reset_launches"] = packed_resets[name]
        g = gate_shape[name]
        entry["gate_shape"] = {k: g[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                                 "library_ms", "plan", "err_float32",
                                                 "err_bfloat16", "edge_err_float32",
                                                 "edge_err_bfloat16")}
        if name in served["step_shapes"]:  # rows 1, 3 and 4 at the service's shapes
            entry["serve_shapes"] = served["step_shapes"][name]
        entry["widths"] = width_record(name, widths)
        if "peaked" in g:
            entry["gate_shape"]["peaked"] = {k: v for k, v in g["peaked"].items()
                                             if k != "per_step"}
        if "abs_err_bfloat16" in rec:  # gradients: the relative error is the check
            entry.update(max_rel_err=rec["err_bfloat16"], max_rel_err_f32=rec["err_float32"])
        else:
            entry.update(max_abs_err_f32=rec["err_float32"])
        entries.append(entry)
    print(json.dumps({"kernels": entries, "sent_per_s": rate, "train": steps,
                      "train_f32_check": check, "train_packed": packed, "families": families,
                      "cli": cli, "serve_online": {k: v for k, v in served.items()
                                                   if k != "step_shapes"},
                      "eval": evals, "widths_cli": widths["cli"], "ensemble": ens,
                      "options": options, "host_path": host, "parallel": par,
                      "extract": extract, "serve_ranks": srv_ranks,
                      "widths_f32_check": widths["fast1000_f32_check"], "card": card}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
