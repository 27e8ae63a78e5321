"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives ``paddle_tpu_torch`` (never JAX or ``paddle_tpu``) in phases; any
failure raises and exits non-zero before the result line is printed:

1. device: CUDA must be present; prints the card and its power limit;
2. build: compiles every kernel of ``paddle_tpu_torch/csrc`` that is
   missing or older than its source (one nvcc per source, in parallel) and
   prints ptxas' register/smem/spill lines from each kernel's build log
   (a C7520 or C7512 warning there, wgmmas serialized, fails the run);
3. parity: each kernel against its plain PyTorch version on the card at
   the main path's shapes (tolerances stated beside each case); the
   flash forward, the flash backward and the fused CE under their judges
   (``judge_forward``: relative norms of out over all rows and over the
   last quarter of the rows, lse max-abs; ``judge_backward``: relative
   norms of dq, dk and dv, likewise; ``judge_ce``), which must also reject
   planted faults made from the plain versions (``forward_faults``,
   ``backward_faults``, ``ce_faults``, ``ragged_faults``), and each case
   must take the variant it should (bf16 on the tensor cores; fp32,
   unaligned bf16 and the backward at D = 256 on the CUDA cores; the
   ragged kernel's bf16 operands that TMA cannot read on its first,
   ``mma.sync`` kernel); the forward also at GPT-2 small's scoring call
   (causal, B=1, L=1024, H=12, D=64, q/k/v views of one fused
   projection) with its two planted faults; flash decode under
   ``judge_decode`` (relative error per (slot, head), zeros in a slot
   that attends nothing) up to 4096 positions, on the split kernel, with
   slots at a split edge, also at GPT-2's heads (head dim 64, group 1)
   with 512- and 1,024-position tables in bf16 and fp32, which its four
   planted faults (``decode_faults``) must fail with their chunk edges at
   64 positions and at the split length; the int8
   matmul bit for bit with wq in both layouts at the 7B shapes and its
   tile edges, the K-major wq on the tensor cores
   (``"tc"``), the row-major one and the odd tail on the first kernel
   (``"mma_sync"``), its four planted faults (``int8_faults``) failing;
4. Llama-2-7B forward at full width and depth (random seeded weights,
   bf16): ``model(ids[1, 512])`` must be finite, take the flash path and
   launch the flash-attention kernel once per layer, each launch on the
   tensor cores (as must every flash-forward, flash-backward and fused-CE
   launch of phases 8, 9 and 10);
5. the serving engine on the same model (``flash_decode=True``): 8
   staggered requests sharing a 64-token system prefix, 32 new tokens
   each; every request finishes, prefix blocks are shared, refcounts hold
   and the flash-decode kernel runs once per layer per decode step,
   every launch on the split kernel;
6. token identity at LLAMA_TINY fp32 (TF32 off), phase 5's workload:
   the kernel and the gathered engines give identical tokens, greedy and
   sampled with chunked prefill (``do_sample=True, top_k=50, top_p=0.9,
   prefill_chunk=64``, temperature 0.6, seeds 1000 + i); the slot layout
   gives the paged layout's tokens and chunked prefill the one-shot
   prefill's, greedy; the threefry words on the card equal the CPU's and
   the known ``jax.random`` words (``PRNG_WORDS``);
7. timings (CUDA events, L2 flushed, after warm-up) of each kernel, its
   plain version and a PyTorch library call, beside the card's bound;
   the redesigned flash forward, flash backward (dq, dk/dv), fused CE,
   ragged matmul, int8 matmul and flash decode (at 512 and 4096
   positions, and at GPT-2's heads at 512 and 1,024; with ptxas' lines of
   its split kernel) also beside their first versions (the flash forward
   also at GPT-2's scoring call; the
   int8 matmul at the 7B q/k/v/o, up, down and head shapes, beside
   ``torch._int_mm`` on the same K-major wq and on a row-major one);
8. training: Llama-2-7B widths cut to 8 layers (bf16, random seeded
   weights) through ``fleet.distributed_optimizer(AdamW)
   .make_train_step`` on one repeated 2 x 2048 batch with the fused LM
   head (``fused_ce_chunk=8192``): a warm-up step and 3 timed steps, each
   launching the flash forward, dq and dk/dv kernels once per layer and
   the fused-CE kernel once; losses finite, the first within 1.0 of
   ln(32000), falling across the timed steps; then one step under
   ``torch.profiler`` (top device kernels, device busy vs wall);
9. ERNIE-MoE training at ``bench.py``'s configuration, nothing cut
   (vocab 32000, hidden 1024, 6 layers, 16 heads, FFN 4096, 8 experts
   top-2 on every second layer; bf16, dropout 0.1, AdamW(lr=1e-4)), one
   repeated 8 x 1024 batch: auto dispatch must pick sparse, and every MoE
   layer runs the ragged expert kernel; a warm-up step and 3 timed steps,
   each launching the ragged kernel 12 times (2 forward + 2 dx per MoE
   layer, all on the tensor cores) and the flash forward, dq and dk/dv 6
   times each; losses
   finite, the first within 1.0 of ln(32000), the last timed one below
   the first; then one profiled step;
10. PTQ Llama-2-7B at full width and depth (phase 4's bf16 model, run
    after phase 5): ``PostTrainingQuantization(algo="abs_max")`` on two
    seeded 1 x 512 calibration batches swaps all 225 ``Linear``s for
    ``Int8Linear``; the quantized forward must launch the int8 kernel 225
    times, all on the tensor cores, and the flash forward 32 times, read
    no ``act_scale`` to the host, give finite logits, and give the same
    logits bit for bit with the int8 kernel's plain version swapped in;
    the relative error and top-1 agreement against the bf16 logits, int8
    vs bf16 forward times, weight bytes, peak memory and one profiled
    quantized forward (device busy, idle share, the int8 kernel's summed
    time) are printed; then the public stochastic quantizers on a 7B FFN
    weight (one launch each).
11. sampled, chunked serving at Llama-2-7B full width and depth (phase
    4's bf16 model, run after phase 5 and before phase 10, which swaps
    the ``Linear``s): ``Engine(n_slots=8, max_len=512, block_size=16,
    flash_decode=True, do_sample=True, top_k=50, top_p=0.9,
    prefill_chunk=64)`` (Llama-2-7b-chat's published temperature 0.6 and
    top_p 0.9; top_k 50, the transformers default) on phase 5's
    workload, every prompt longer than a chunk, seeds 1000 + i: every
    request finishes with 32 tokens, prompts are chunked and a shared
    leading chunk skipped, refcounts hold, the flash-decode kernel runs
    once per layer per decode step, all on the split kernel, and a second
    run with the same seeds gives the same tokens; the wall, the
    ``serving.ledger``, peak memory, and one profiled decode step
    (launches, device busy) beside phase 5's greedy engine at the same
    state and the sampling glue alone are printed; then the same workload
    on ``kv_layout="slot"``, greedy (wall, decode steps, slab bytes).
12. hybrid Fleet training (after phase 9). 12a: phase 8's trainer
    through ``distributed.spawn(nprocs=1)`` on a world of one over NCCL
    with ``sharding_stage=3`` (sharding and mp degrees 1): every
    collective is the identity, so the losses must equal phase 8's bit
    for bit and the launches per step phase 8's; the step time is
    printed beside phase 8's. 12b: Llama-2-7B width cut to 4 layers,
    saved as numpy arrays and run at world 1, then two ranks sharing
    cuda:0 over gloo (NCCL refuses two ranks on one device): a probe of
    which collectives gloo carries on CUDA tensors, then ``mp_degree=2``
    and ``sharding_degree=2`` stage 3 from those weights through
    ``load_numpy_state_dict``; losses within 1e-2 relative of world 1
    over 3 steps, per rank and step the flash kernels once per layer and
    the fused CE once, all on the tensor cores, and under mp2 rank r's
    fused-CE launch on its half of the vocabulary; a configuration whose
    collectives gloo does not carry is left out and named. 12b's times
    are two processes sharing one card through the host, not multi-GPU
    speeds.
13. GPT-2 serving (after phase 12): GPT-2 small at its published widths
    (``GPTConfig()``: hidden 768, 12 layers, 12 heads, FFN 3072, 1,024
    positions, vocab 50304), random weights from seed 0, ``eval()``, in
    bf16. 13a: ``model(ids[1, 1024])`` under inference_mode, 12
    flash-forward launches all ``"tc"`` on GPT's strided q/k/v, finite
    logits within ``judge_forward``'s bf16 limits of the same model's with
    the plain forward swapped in (``judge_logits``). 13b:
    ``Engine(n_slots=8, max_len=1024, block_size=16, flash_decode=True)``
    on phase 5's workload plus a 960-token prompt (``gpt2_workload``), 32
    new tokens each: flash-decode launches = 12 x decode steps all
    ``"split"``, a prefix hit. 13c: the same, sampled (top_k 50, top_p
    0.9, temperature 0.6, seeds 1000 + i) with ``prefill_chunk=64``:
    prompts chunked, the same seeds the same tokens. Both beside the
    gathered engine, whose bf16 token agreement is printed. The token
    identities are held on the fp32 twin (the same draws, TF32 off; bf16
    round-off flips greedy near-ties, ``phase_gpt2``): 13b and 13c kernel
    vs gathered, and 13d ``model.generate`` on a right-padded batch of two
    of the prompts, 16 tokens, equal to 13b's engine tokens. Tokens/s,
    TTFT and ITL p50/p95, the scoring latency and peak memory are printed
    beside the card's name and power limit.
14. tensor-parallel serving (after phase 13): ``Engine(model, tp=2)`` as
    two ranks sharing cuda:0 over gloo (NCCL refuses two ranks on one
    device), each holding the whole fp32 model on the CPU and only its
    shards and half the KV heads on the card. 14a: GPT-2 small at its
    published widths and depth with phase 13's 9 requests; 14b:
    Llama-2-7B widths cut to 4 layers (12b's cut) with phase 5's
    workload; each greedy, then sampled + chunked (top_k 50, top_p 0.9,
    temperature 0.6, seeds 1000 + i, ``prefill_chunk=64``). Each rank's
    tokens must equal those of a tp=1 engine on the same weights on the
    card (fp32, TF32 off); no flash-decode launch (refused with tp > 1,
    as in JAX); each run's collectives as counted by
    ``collective_matmul.launches`` equal 2 per layer per prefill, chunk
    and decode step plus one all-gather per decode step and sampling
    prefill (``tp_collectives``); each rank's pool holds half the kv
    heads. Peak memory per rank, tokens/s, TTFT and ITL over gloo are
    printed: two processes sharing one card through the host, not
    multi-GPU speeds.
15. sequence-parallel training (after phase 14), ``phase_sep``. A probe
    of gloo on CUDA tensors: point-to-point unstaged (two throwaway
    ranks; gloo refuses it), the tiled all-to-all, and the ring rotation
    that ``collective.ppermute`` stages through the host. 15a, two ranks
    on cuda:0 over gloo: ``ring_attention_local`` and
    ``ulysses_attention_local`` at [1, 8192, 16, 128] bf16 causal, sep
    2, gathered and judged against world-1 ``flash_attention_fn`` on the
    whole sequence (``judge_forward``, ``judge_backward``), launches of
    rows 1-3 per rank equal to the kept chunk pairs, all on the tensor
    cores; three planted faults (the wraparound pair left unmasked, dk/dv
    one rotation short of home, Ulysses' return all-to-all in the wrong
    rank order) must fail the judges. 15b: ``bench.py:
    bench_llama_long_context``'s cell cut to ``SEP_LAYERS`` layers (vocab
    32000, hidden 2048, 16 heads, FFN 5504, 8,192 positions, bf16, selective
    remat, AdamW lr 1e-4), batch 1 x 8192 from seed 0: at world 1 on the
    card, then ``sep_degree=2`` ring and Ulysses as two gloo ranks, a
    warm-up and 3 steps each; every rank's losses within 1e-2 relative of
    world 1's, rows 1-3 launches per rank and step equal to
    ``want_sep_launches``, all on the tensor cores; step time, tokens/s
    and peak memory per rank printed (gloo between two processes on one
    card: not a multi-GPU speed).
16. pipeline-parallel training (after phase 15), ``phase_pp``:
    ``LlamaForCausalLMPipe`` at Llama-2-7B width cut to 4 layers (2 a
    stage at pp 2), batch 4 x 2048 (ids then labels from
    ``default_rng(0)``), 4 micro-batches of [1, 2048, 4096] bf16. 16a, two
    gloo ranks on cuda:0: ``spmd_pipeline`` (backward of a seeded
    cotangent) and ``pipeline_1f1b`` (the model's norm, head and CE in
    the last stage) against world 1 on the same stack and inputs
    (``judge_rel``: output, each stacked weight's gradient on the rank's
    chunk, dx, the loss and the last-stage gradients, bf16 1e-2 over all
    and over the last quarter), rows 1-3 launches per rank = 2 layers x 4
    micro-batches, all on the tensor cores; three planted faults (the
    stages in the wrong order, a micro-batch's cotangent paired with a
    neighbour's saved graph, the replicated output's backward summing
    over pp) must fail. 16b: the GPipe step at world 1 on the card, then
    ``pp_degree=2`` GPipe and 1F1B steps (AdamW, a warm-up and 3 steps)
    as two gloo ranks: every rank's losses within 1e-2 relative of world
    1's, rows 1-3 launches per rank and step = ``want_pp_launches``, all
    ``"tc"``, host-staged point-to-point calls = ``pp_p2p_calls``, 1F1B's
    micro-batches in flight at most 2 - stage, each rank holding 2 of the
    4 layers; step time, tokens/s and peak memory per rank printed (not a
    multi-GPU speed).
17. GPT-2 small training (after phase 16), ``phase_gpt2_train``. 17a:
    OpenAI's widths (hidden 768, 12 layers, 12 heads, FFN 3072, vocab
    50,304, dropout 0.1), bf16, AdamW(lr=1e-4, wd=0.01), a repeated
    8 x 1024 batch, a warm-up + 3 steps on the card: the loss finite, its
    first value within 1.0 of ln 50304, the last timed below the first;
    rows 1-3 12 launches each a step, all on the tensor cores, on the
    q/k/v views of the fused qkv; step time, tokens/s, peak memory and a
    profiled step. 17b: the same weights under ``mp_degree=2`` as two
    gloo ranks on the card: every rank's losses within 1e-2 relative of
    17a's, rows 1-3 12 each per rank and step on its 6 heads, all
    ``"tc"``. Phase 3 holds rows 2-3 at 17a's batch (views of the fused
    qkv) under ``judge_backward`` with its planted faults, and phase 7
    times them there.
18. expert-parallel ERNIE-MoE training (after phase 17), ``phase_ep``:
    phase 9's configuration under ``mp_degree=2`` as two gloo ranks on
    the card, each holding 4 of the 8 experts, against world 1 on the same
    weights and seeds: the gradients of ``EP_PROBED`` within 1e-2 of world
    1's (``judge_rel``), outside it with each planted fault of
    ``EP_FAULTS`` (the expert input's dx not all-reduced over tp;
    ``reduce_from_tp``'s backward summing over tp); a warm-up + 3 steps
    within 1e-2 relative of world 1's losses; per rank and step 12 ragged
    launches on ``[4, 2560, d]`` expert inputs and rows 1-3 6 each, all
    on the tensor cores. Phase 7 times the ragged kernel on the 4 experts
    of a rank.
19. comm-efficient data parallel (after phase 18), ``phase_comm``:
    ``bench.py:bench_llama``'s 0.5B Llama (bf16, the fused head) at
    ``COMM_LAYERS`` layers on its 4 x 2048 batch, world 1 on the card,
    then dp2 as two gloo ranks on the card from the same weights under
    each arm of ``COMM_ARMS`` (``comm_opt`` exact, zero1, bf16, int8;
    ``fp16_allreduce`` int8; ``localsgd`` k 2; ``a_sync`` k 2; ``dgc``
    0.99 with Momentum; and the planted fault: int8 with ``e1``
    dropped), a warm-up + 3 steps each: every loss finite and equal on
    both ranks; exact and zero1 within 1e-2 of the comm_opt step at world 1
    (its flat update keeps no fp32 master, as JAX's), zero1 bitwise the
    replicated flat arm; the compressed arms within 5e-2 of the exact
    arm; error feedback conserved on the int8 arm (``EFProbe``) and
    broken by the fault; rows 1-3 once per layer and row 5 once per rank
    and step, all on the tensor cores; the gloo probe of every dtype the
    exchanges send (nothing bit-cast); the plain quantizer and top-k
    timed at the model's flat size.
20. speculative decoding and beam search (after phase 11, on phase 4's
    model), ``phase_spec``. 20b, latency-shaped (``bench.py:
    bench_serving_spec``'s shape): Llama-2-7B bf16 on phase 5's geometry
    with ``flash_decode=True``, phase 5's 8 prompts submitted one at a
    time (each finished before the next), 48 new tokens, greedy; arms:
    plain, n-gram (k 4), the model as its own draft (k 4), and
    ``bench.py:bench_llama``'s 0.5B widths at ``SPEC_DRAFT_LAYERS`` layers
    as a small same-family draft (random weights: acceptance near 0, what
    a rejected draft costs). Each arm prints ITL p50/p95, tokens/s, target steps per
    token, acceptance, draft steps, row 4's launches, peak memory and the
    share of its tokens equal to the plain arm's; every request finishes
    with 48 tokens, the self-draft takes fewer than 0.6 target steps a
    token, and row 4 launches layers x (decode steps - verifies) times,
    all ``"split"`` (> 0 over the arms: a draft that is always accepted
    may take no plain step). 20c: ``generate(ids[2, 128], 32 new,
    num_beams=4)`` timed with its peak memory; one beam equals greedy
    ``generate``. 20a, token identity on fp32 twins (TF32 off):
    Llama-2-7B widths at 2 layers and GPT-2 small, ``Engine(n_slots=4,
    max_len=256, block_size=16, flash_decode=True)``, greedy then sampled
    + chunked (top_k 50, top_p 0.9, temperature 0.6, seeds 1000 + i,
    ``prefill_chunk=64``), two logit-masked repetitive and two random
    requests, 32 new tokens; arms plain, n-gram, self-draft and a hostile
    proposer, every one token-identical to the plain engine, with 20b's
    launch equation and refcounts; the greedy self-draft under 0.6 target
    steps a token; on the Llama twin each row's beam-4 sequence log-prob
    at least greedy's - 1e-4.

21. mixed precision and attention dropout (after phase 19),
    ``phase_amp_train``, ``phase_mha``, ``phase_amp_pair``. 21a:
    ``bench.py:bench_llama``'s 0.5B Llama with fp32 parameters (hidden
    2048, 8 layers, 16 heads, FFN 5504, the fused head, AdamW lr 1e-4) on
    its repeated 4 x 2048 batch, a warm-up + 3 steps in each arm: fp32; O1
    (``amp_level="O1"``); O1 with a ``GradScaler``; O2 after
    ``amp.decorate``. Launches by variant a step (``want_amp_launches``):
    rows 1-3 8 each on the CUDA cores in fp32 and on the tensor cores
    under O1 and O2, row 5 once, fp32 on the CUDA cores except under O2
    (JAX's fused head does not cast); losses finite and falling, the
    bf16 arms within 2e-2 of fp32's; step time, tokens/s and peak memory
    per arm, and the scaler's host read as the difference of the two O1
    arms. 21b: the scaler arm takes a step whose loss is inf: found_inf,
    parameters and the whole optimizer state unchanged bit for bit, the
    scale halved. 21c: ``nn.MultiHeadAttention`` at BERT-base widths on
    ``bench_bert``'s 16 x 512 batch (head dim 64), bf16: in eval row 1
    once on the tensor cores, within 1e-2 of the plain composite; in
    training (dropout 0.1) the plain composite and no launch; the keep
    rate over 50M probabilities within 6 binomial sigmas of 0.9. 21d: the
    0.5B widths at 2 layers under O1 with a scaler, world 1, then
    ``mp_degree=2`` as two gloo ranks on the card: losses within 1e-2 of
    world 1, rows 1-3 on the tensor cores and row 5 once per rank and
    step; an inf planted on rank 1 only makes both ranks skip bit for bit
    and halve the scale.
22. the encoder families (after phase 21), ``phase_bert``, ``phase_t5``,
    ``phase_vit``. 22a: ``bench.py:bench_bert``'s configuration (BERT-base,
    dropout 0.1, bf16, AdamW lr 1e-4, MLM labels at every position) on its
    repeated 16 x 512 batch, a warm-up + 3 steps: losses finite, the first
    within 1.0 of ln 30522, falling; attention on the plain composite (the
    dropout), no launch of rows 1-3, as in JAX; step time, tokens/s, peak
    memory, one profiled step. 22b: the same weights without dropout: rows
    1-3 once per layer and step on the tensor cores, every loss within
    1e-2 of the same steps with attention routed to the plain composite
    (inside this script only). 22c: ``BertForSequenceClassification``'s
    eval forward at 16 x 512, bf16: unmasked, row 1 once per layer and
    the logits within 1e-2 of the plain-routed forward's; with a 2-D
    padding mask no launch. 22d: T5 at ``T5Config()``'s widths, bf16
    training (16 x (512 -> 128), AdamW) finite and falling, no flash
    launch; fp32 untied ``generate(ids[8, 64], 32 new)`` token-identical
    to an incremental greedy loop; the card's bucket tables equal to the
    CPU's for every length used. 22e: ``bench.py:bench_vit``'s ViT-B/16
    (32 images of 224 x 224, bf16, AdamW lr 3e-4, fp32 CE over 1000
    classes): finite and falling, the plain composite (197 tokens),
    images/s and peak memory. Phase 3 holds rows 1-3 at BERT-base's
    [16, 512, 12, 64] non-causal shape under their judges and planted
    faults, and phase 7 times them there.
23. the serving deployment path (after phase 22), ``phase_deploy``, on
    phase 20a's fp32 twins (TF32 off): GPT-2 small whole, then Llama-2-7B
    widths at 2 layers, ``Engine(n_slots=4, max_len=256, block_size=16,
    flash_decode=True)``, phase 5's staggered prompts that fit 256 with 32
    new tokens (seven: shared 64-token prefix), greedy and phase 11's
    sampled + chunked. 23a: ``serving.save_lm`` to a temporary directory,
    ``inference.create_llm_predictor`` from it per mode: the predictor's
    tokens equal the source engine's; the artifact's size, the save and
    load walls. 23b: ``EngineSupervisor(kv_probe_interval=1)`` under
    ChaosMonkey's decode-stall, decode-raise and kv-corrupt at supervised
    step 5 (four requests decoding at different positions, two queued),
    and a real wedge (``step_timeout_s`` 0.5, a decode step that sleeps
    1.0 s inside): every request's tokens equal the uninterrupted
    engine's, one rebuild, at least two replayed requests, the zombie's
    late tokens dropped, row 4 once per layer per decode step summed over
    both incarnations, all on the split kernel; the recovery wall (fault
    to the first replayed token) beside the uninterrupted decode step, and
    the KV probe's device span and wall. 23c, on the Llama twin:
    ``ReplicaFleet(n_replicas=2)`` through replica-kill (greedy, sampled)
    and route-flap: the migrated requests' tokens equal the uninterrupted
    run's, row 4 per layer per decode step over every engine, each
    replica's weights views of the model's, the peak memory above the
    weights beside the two pools; a request sharing the prefix routes to
    the busier replica that holds it; a GPT-2 handle offered to a Llama
    replica raises ``AdoptMismatch``.
24. training robustness (after phase 23), ``phase_robust_gpt2`` and
    ``phase_robust_comm``. 24a: phase 17's GPT-2 small trainer (OpenAI's
    widths, vocab 50,304, bf16, 8 x 1024, AdamW, dropout 0.1) cut to
    ``P24_LAYERS`` layers, under ``resilience.Supervisor`` with a ``CheckpointManager`` on
    local disk (``save_interval`` 4), batches from ``io.DataLoader`` over
    a seeded 48-sequence ``TensorDataset`` with
    ``DistributedBatchSampler(shuffle=True)`` in a ``ResumableLoader``,
    11 steps over 2 epochs. The uninterrupted run twice: losses and final
    parameters equal bit for bit. A chaos run (``P24_PLAN``: a transient
    error, a real wedge under ``step_timeout_s`` that wakes and is
    dropped, the newest checkpoint corrupted, a NaN streak of NaN
    patience 2): ``P24_WANT``'s retries, skipped batch and rollback, the
    rollback over the corrupted step 7 to step 3, the parameters at every
    attempt's entry equal the uninterrupted run's at the same
    consumed-batch count up to the first skipped batch and right after
    the rollback. A child process SIGKILLed at step 10 (beside the repeat
    run) and a resuming child: the resumed losses equal the uninterrupted
    run's bit for bit. Rows 1-3 launch once a layer each per executed
    step attempt, all on the tensor cores. Printed: the guard capture, a step with and
    without the supervisor, the first run's last cadence save (host copy,
    pickle with its CRC, fsync, wall), the checkpoint's bytes, the
    rollback and the resume walls. 24b: phase 19's 0.5B Llama at 2 layers, 4 x 2048,
    ``CommOptTrainStep(zero1=True, grad_compress="int8")``: dp2 as two
    gloo ranks on the card, 3 steps, a checkpoint (each rank its file,
    rank 0 seals); the dp2 restore continues 2 steps bit for bit; world 1
    restores the two rank files (moments joined in position, ``e1`` the
    ranks' sum, bit for bit) and takes 2 steps within ``COMM_TOL`` of
    dp2's.
25. the high-level API and the CNN path (after phase 24),
    ``phase_hapi_cnn``. 25a (``phase_resnet``): ``bench_resnet50``'s
    trainer (``vision.models.resnet50(num_classes=1000)``, bf16,
    ``fleet.distributed_model``, Momentum(0.1, 0.9), the fp32 CE) on one
    seeded batch of 224 x 224 images at batches 64, 128 and 256, a
    warm-up + 5 steps each, then the batch with the most images/s again
    under ``framework.layout.to_channels_last``: losses finite, no port
    kernel launched (convolutions on cuDNN, batch norm and pooling on
    torch's ops: JAX computes them outside Pallas); images/s, ms a step,
    peak memory and one profiled step (device idle share, device launches
    a step, top kernels). The fp32 twin (TF32 off, batch 8,
    ``resnet_twin``): the channels-last copy's output, and
    ``fold_conv_bn``'s eval output, within ``RESNET_TWIN_TOL`` (relative
    norm) of the NCHW model's; its gradients no further from a float64
    copy's than twice the NCHW model's (NCHW fp32 is not within 1e-4 of
    float64 there). 25b (``hapi_resnet``): ``paddle.Model(resnet18(
    num_classes=10))`` on the synthetic ``Cifar10`` with ``ToTensor`` +
    ``Normalize`` through ``io.DataLoader``, ``fit`` for 2 epochs of 4
    batches of 64 with ``EarlyStopping``, ``ModelCheckpoint`` and
    ``LRScheduler`` (a cosine schedule: the LR after it the schedule's
    after 8 steps; the checkpoint files written), ``evaluate`` with
    ``Accuracy(topk=(1, 5))``, ``predict(stack_outputs=True)``, ``save``
    -> a fresh ``Model.load`` -> ``evaluate`` equal; ``summary`` and
    ``flops`` equal the figures the CPU tests pin. 25c (``hapi_bert``):
    ``paddle.Model(BertForSequenceClassification)`` at phase 22b's
    dropout-free BERT-base, bf16, 16 x 512, AdamW(lr=1e-4), no mask,
    ``fit`` over 4 seeded batches (a warm-up + 3): rows 1-3 launch 12
    times each a step, all on the tensor cores, and the losses equal bit
    for bit those of ``make_train_step`` on the same weights and batches;
    the step times of both (the difference is hapi's host overhead).
26. the eager user surface (after phase 25). 26a (``phase_eager_ops``):
    every row of ``op_cases`` (the flat op namespace and
    ``nn.functional``'s activations, the table the CPU tests hold against
    the JAX package) at ``OP_ROWS_CARD`` x 8 elements (linalg at its own
    shapes) on the card against the same op on a CPU copy, gradients too:
    integer, bool, index and manipulation results bit for bit, floats
    within ``OP_TOL``; rows passed per module. 26b (``phase_user_layer``):
    ``user_decoder_layer`` at Llama-2-7B's widths (hidden 4096, 32 x 128
    heads, FFN 11008, fp32, [1, 2048]) holding the weights of the port's
    ``LlamaDecoderLayer`` from the same seed: the output and every
    parameter's gradient after ``loss.backward()`` within ``P26_TOL``
    (relative norm); rows 1-3 launch once each per call of the port's
    layer, never in the user's; the median of 5 fwd+bwd times and the
    peak memory of each. 26c (``phase_eager_loop``):
    ``tools/bench_eager.py``'s loop (``Sequential(Linear, ReLU, Linear)``,
    ``cross_entropy``, ``backward``, ``Adam``, ``clear_grad``) at its
    defaults: ms a step, device launches a step, losses repeating bit for
    bit under ``seed``. 26d (``phase_autograd``): a ``PyLayer`` (cube),
    ``jacobian`` and ``hessian`` on the card against the CPU.
27. serving robustness under tp and the observability surface. 27a and
    27b (``_p27_work`` on phase 14b's two ranks, after its runs, on its
    cell: Llama-2-7B widths at ``TP_LLAMA_LAYERS`` layers, fp32, TF32 off,
    phase 5's prompts and geometry, two gloo ranks on cuda:0; checked by
    ``phase_tp_robust``): a plain ``Engine(tp=2)`` greedy run and a
    fault-free ``EngineSupervisor(tp=2)`` one (both tokens equal tp=1's;
    the walls and the verdicts' collectives and their wall printed), then
    ``EngineSupervisor(tp=2)`` through the ``P27_RUNS`` faults, two a run
    at supervised steps ``P27_AT`` (``decode-raise`` on both ranks, and a
    raise, a stall inside the decode step past ``P27_TIMEOUT_S`` and a KV
    corruption of its shard confined to rank 1), greedy and
    ``TP_SAMPLED``; the greedy run also stalls rank 1 past its timeout
    after the last collective of the first decode step
    (``stall_inside(late=True)``), so that rank 0 has emitted the step's
    tokens before the group's verdict: every rank's tokens equal phase
    14's uninterrupted ``Engine(tp=2)`` run's and the tp-1 fp32 engine's
    on the card, one group rebuild per fault with equal counters and
    ledgers on both ranks, the recovery walls printed; then
    ``ReplicaFleet(tp_degrees=[2, 1])`` killing r0 and then r1
    mid-decode: tokens identical to a tp-1 engine's on the card,
    ``migrations >= 2``. 27c (``phase_observe``, after phase 20, on phase
    4's model): phase 5's workload on a fresh engine for each of
    ``P27C_ARMS``: an untimed warm-up, tracing off and on alternated
    twice, then under ``profiler.Profiler(targets=[GPU])`` (CUDA
    activity): the same tokens, row 4 launching 32 x decode steps on
    ``"split"`` in each run and the profile's
    ``flash_decode_split_kernel`` count equal to it, every request's five
    lifecycle spans under its one trace id, the Chrome trace and the
    Prometheus text well formed and the token counter equal to the
    handles' tokens; every run's wall printed.
28. the nn layer library (after phase 26), ``phase_nn_table``,
    ``phase_seq2seq`` and ``phase_dcgan``. 28a: every row of
    ``nn_cases`` (every ``nn.functional`` function and ``nn`` layer the
    library adds, at ``NN_ROWS_CARD`` size) on the card against a CPU
    copy of the same inputs and weights: dtypes equal, integer, mask and
    index results bit for bit, floats within the row's ``OP_TOL`` class,
    every gradient (a layer's input and parameters) within ``GRAD_TOL``.
    28b: ``seq2seq`` at PaddleNLP's IWSLT'15 widths (``S2S``), fp32,
    batch ``S2S_BATCH``: 3 Adam steps (``ClipGradByGlobalNorm(5.0)``),
    the loss finite, the first within 1.0 of ln 7,709 and falling; beam
    decoding (``BeamSearchDecoder(beam_size=10)`` + ``dynamic_decode``,
    256 steps at most), ``predicted_ids`` the numpy backtrace of the step
    tokens; on an fp32 twin (dropout 0, batch 8) the logits within 1e-4
    of a CPU copy's, the backtrace again and ``beam_size=1`` equal to the
    greedy loop. 28c: ``dcgan`` at the paper's widths (``DCGAN``), fp32,
    batch 128: 3 D/G steps, the losses finite; on an fp32 twin (batch 8)
    one G and one D step within 1e-4 of a CPU copy. The step and decode
    walls and images/s printed.

Every phase prints its wall ("wall: phase n ... s", from its "[n]" line
to the next). The line before the last is a JSON object ``{"kernels": [...]}``; the
last line is ``{"ok": true, "device": {...}}``. Peak rates for the bound:
989e12 bf16 FLOP/s, 1979e12 int8 OP/s and 3.35e12 B/s (H100 SXM data
sheet). Phases 3 and 7 cover the ragged kernel and the flash kernels at
the ERNIE-MoE shapes too, and the int8 matmul and the two stochastic
quantizers at the Llama-2-7B shapes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
# 32-bit integer operations: 64 a clock on each of the 132 SMs (the Hopper
# white paper's SM: half its fp32 rate) at the 1.98 GHz boost clock
PEAK_INT32_OPS = 132 * 64 * 1.98e9
BF16_TOL = 2e-2           # bf16 out tolerance: a few bf16 ulps at |x| ~ 1


_WALL = {"tag": None, "t0": None, "start": None}


def log(*a):
    """Print a line; a phase's "[n] ..." line first closes the phase
    before it (``end_phase``)."""
    m = re.match(r"\[(\w+)\]", str(a[0])) if a else None
    if m:
        end_phase()
        _WALL["tag"], _WALL["t0"] = m.group(1), time.perf_counter()
        _WALL["start"] = _WALL["start"] or _WALL["t0"]
    print(*a, flush=True)


def end_phase():
    """Print the wall of the phase in progress: from its "[n]" line to
    now, and the script's since phase 1."""
    if _WALL["tag"] is not None:
        now = time.perf_counter()
        print(f"  wall: phase {_WALL['tag']} {now - _WALL['t0']:.1f} s "
              f"(script {now - _WALL['start']:.1f} s)", flush=True)
        _WALL["tag"] = None


def smi_line():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def time_ms(fn, flush, reps=20):
    """Median device time of ``fn`` over ``reps`` runs: L2 flushed before
    each, the stream held busy while the host enqueues so the events
    bracket device work only."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


# ---------------------------------------------------------------------------
# phase 3 inputs
# ---------------------------------------------------------------------------

def decode_case(S, H, n_kv, hd, bs, mb, nb, dtype, seed, fixed=()):
    """Pools, block tables with distinct blocks per slot and trash (0)
    tails past each slot's bound, ragged write positions including 0 and
    a full table; ``fixed`` pairs (slot, write position) set those slots'
    positions (split edges). Where the pool holds ``S * mb`` blocks
    besides block 0, each slot is dealt its own slice of one permutation,
    so no two slots share a block (every attended row is a distinct one,
    as phase 7's byte bound counts it)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = torch.randn(S, H, hd, generator=g, device=dev).to(dtype)
    kc = torch.randn(nb, bs, n_kv, hd, generator=g, device=dev).to(dtype)
    vc = torch.randn(nb, bs, n_kv, hd, generator=g, device=dev).to(dtype)
    rng = np.random.default_rng(seed)
    wp = rng.integers(0, mb * bs, S)
    wp[0], wp[-1] = 0, mb * bs - 1
    for s, w in fixed:
        wp[s] = w
    tables = np.zeros((S, mb), np.int32)
    deal = rng.permutation(np.arange(1, nb)) if nb > S * mb else None
    for s in range(S):
        used = wp[s] // bs + 1
        tables[s, :used] = (deal[s * mb:s * mb + used] if deal is not None
                            else rng.choice(np.arange(1, nb), used,
                                            replace=False))
    return (q, kc, vc, torch.from_numpy(tables).to(dev),
            torch.from_numpy(wp.astype(np.int32)).to(dev))


def attn_case(B, Lq, Lk, Hq, Hkv, D, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    mk = (lambda L, H: torch.randn(B, L, H, D, generator=g,
                                   device="cuda").to(dtype))
    return mk(Lq, Hq), mk(Lk, Hkv), mk(Lk, Hkv)


def phase_parity(fa, fd, fc, rm, im, sr):
    errs = parity_decode(fd)
    errs.update(parity_forward(fa))
    errs.update(parity_bwd(fa))
    errs.update(parity_fused_ce(fc))
    errs.update(parity_ragged(rm))
    for k, e in parity_ernie_attention(fa).items():
        errs[k] = max(errs[k], e)
    errs.update(parity_int8(im))
    errs.update(parity_stochastic(sr))
    return errs


def rel_err(got, want):
    """||got - want|| / ||want|| over the whole tensor, in fp32."""
    want = want.float()
    return ((got.float() - want).norm() / want.norm()).item()


# ---------------------------------------------------------------------------
# judges: each compares a kernel's result with its plain version's, and each
# must reject planted faults made from the plain version
# (tests/test_torch_kernel_judges.py holds them to that on the CPU)
# ---------------------------------------------------------------------------

FWD_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
FWD_LSE_TOL = {torch.bfloat16: 1e-3, torch.float32: 1e-4}


def judge_forward(out, lse, want_out, want_lse):
    """The flash forward's judge: ``||got - want|| / ||want||`` of out over
    all rows and separately over the last quarter of the query rows (whose
    entries are the smallest: with randn inputs row i has a spread of about
    sqrt(e / i)), below 1e-2 in bf16 (out's own bf16 rounding is ~1e-3) and
    1e-4 in fp32 (reduction order only, TF32 off); lse within 1e-3 (bf16)
    or 1e-4 (fp32) absolute. Returns (rel_all, rel_tail, lse_err, ok)."""
    tol = FWD_REL_TOL[want_out.dtype]
    ltol = FWD_LSE_TOL[want_out.dtype]
    Lq = want_out.shape[1]
    tail = slice(Lq - max(1, Lq // 4), Lq)
    rel_all = rel_err(out, want_out)
    rel_tail = rel_err(out[:, tail], want_out[:, tail])
    lse_err = (lse.float() - want_lse.float()).abs().max().item()
    ok = (bool(torch.isfinite(out.float()).all())
          and bool(torch.isfinite(lse).all())
          and rel_all < tol and rel_tail < tol and lse_err < ltol)
    return rel_all, rel_tail, lse_err, ok


def plain_attention(q, k, v, mask, scale=None):
    """The plain forward's arithmetic (fp32 scores and softmax, p rounded
    to v's dtype before the PV product, fully masked rows give out = 0 and
    lse = the mask value) under any [Lq, Lk] boolean mask: the source of
    the forward's planted faults."""
    D = q.shape[-1]
    group = q.shape[2] // k.shape[2]
    scale = 1.0 / D ** 0.5 if scale is None else scale
    mask_value = -0.7 * float(torch.finfo(torch.float32).max)
    qh = q.transpose(1, 2).float()
    kh = k.transpose(1, 2).repeat_interleave(group, dim=1).float()
    vh = v.transpose(1, 2).repeat_interleave(group, dim=1)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    s = s.masked_fill(~mask, mask_value)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l > 0, l, torch.ones_like(l))
    out = torch.matmul(p.to(v.dtype).float(), vh.float()) / safe_l
    return out.to(q.dtype).transpose(1, 2), (m + torch.log(safe_l))[..., 0]


def causal_mask(Lq, Lk, causal, device, shift=0):
    """Row i sees key j iff j <= i + Lk - Lq + shift (every key if not
    causal)."""
    mask = torch.ones(Lq, Lk, dtype=torch.bool, device=device)
    return mask.tril(diagonal=Lk - Lq + shift) if causal else mask


def forward_faults(q, k, v, causal, tile=64):
    """Planted faults of the forward, from the plain version: the causal
    mask shifted by one key (each row also sees the next key; in a
    non-causal case the last key is hidden instead), and the last visible
    ``tile``-key tile of each ``tile``-row block of queries dropped.
    Returns {name: (out, lse)}."""
    Lq, Lk = q.shape[1], k.shape[1]
    dev = q.device
    mask = causal_mask(Lq, Lk, causal, dev)
    if causal:
        shifted = causal_mask(Lq, Lk, True, dev, shift=1)
    else:
        shifted = mask.clone()
        shifted[:, -1] = False
    dropped = mask.clone()
    for r0 in range(0, Lq, tile):
        last = min(Lk - 1, r0 + tile - 1 + Lk - Lq) if causal else Lk - 1
        if last < 0:
            continue
        t0 = last // tile * tile
        dropped[r0:r0 + tile, t0:t0 + tile] = False
    return {"causal mask shifted by one key":
            plain_attention(q, k, v, shifted),
            "last visible key tile of each 64-row block dropped":
            plain_attention(q, k, v, dropped)}


def judge_ce(got, want):
    """The fused-CE stats' judge: (m, s, lab) each within rtol 1e-4 / atol
    1e-3 of the plain version (fp32 sums of H products and V exps in
    another order; bf16 inputs are exact in the fp32 products). Returns
    (max abs error of m, s, lab; ok)."""
    errs = [(a - b).abs().max().item() for a, b in zip(got, want)]
    ok = all(bool(torch.isfinite(a).all())
             and torch.allclose(a, b, atol=1e-3, rtol=1e-4)
             for a, b in zip(got, want))
    return errs, ok


def ce_faults(fc, hidden, w, labels, vocab_offset=0):
    """Planted faults of the fused-CE stats, from the plain version: the
    last 128 vocabulary columns dropped, and the label read one column
    off. Returns {name: (m, s, lab)}."""
    return {"last 128 vocabulary columns dropped":
            fc.fused_ce_stats_reference(hidden, w[:, :-128], labels,
                                        vocab_offset),
            "label read one column off":
            fc.fused_ce_stats_reference(hidden, w, labels + 1,
                                        vocab_offset)}


DECODE_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


def judge_decode(got, want, write_pos, tol):
    """The flash-decode judge: ``||got - want|| / ||want||`` over the head
    dim of each (slot, head) whose slot attends a position (``write_pos >=
    0``), at most ``tol`` (bf16 1e-2: the output's rounding is ~2e-3 of a
    row; fp32 1e-4: sums in another order); exact zeros in the slots that
    attend none; everything finite. Judging each (slot, head) at its own
    scale sees one dropped position of a 4096-position slot, which an
    absolute limit on the whole tensor does not. Returns (worst relative
    error, zeros held, ok)."""
    got, want = got.float(), want.float()
    live = write_pos.to(got.device).long() >= 0
    rel = ((got - want).norm(dim=-1)[live]
           / want.norm(dim=-1)[live].clamp_min(1e-30))
    worst = rel.max().item() if rel.numel() else 0.0
    zeros = bool((got[~live] == 0).all())
    finite = bool(torch.isfinite(got).all())
    return worst, zeros, finite and zeros and worst <= tol


def decode_faults(fd, q, kc, vc, tables, wp, chunk=64):
    """Planted faults of flash decode, from its plain version: each slot's
    last attended position dropped; the last ``chunk``-position chunk of
    the longest slot dropped; one block-table entry of the longest slot
    read one block off where a block starts on a chunk edge; with more
    than one kv head, each query head read against the next kv head (head
    h against kv head h + 1 at group 1, as GPT-2's MHA). Returns {name:
    out}."""
    ref = fd.flash_decode_reference
    S, H, _ = q.shape
    bs, n_kv = kc.shape[1], kc.shape[2]
    s_long = int(torch.argmax(wp))
    longest = int(wp[s_long])
    faults = {"last position of each slot dropped":
              ref(q, kc, vc, tables, wp - 1)}
    short = wp.clone()
    short[s_long] = longest // chunk * chunk - 1
    faults["last chunk of the longest slot dropped"] = ref(
        q, kc, vc, tables, short)
    edge = chunk * bs // np.gcd(chunk, bs)       # a block start on a chunk
    e = edge // bs                               # edge, and its entry
    if edge + bs <= longest:
        off = tables.clone()
        off[s_long, e] = tables[s_long, e + 1]
        faults["a table entry read one block off at a chunk edge"] = ref(
            q, kc, vc, off, wp)
    if n_kv > 1:
        faults["query heads read against the next kv head"] = ref(
            q, kc.roll(-1, 2), vc.roll(-1, 2), tables, wp)
    return faults


# (S, H, n_kv, head dim, block size, blocks per slot, dtype, an empty slot):
# the Llama engine's shape (bs=16) at 512, 2048 and 4096 positions, GQA (at
# 2048 positions its splits are 128 long, so the 2-stage ring runs), fp32,
# a 128-position block (one block spans two 64-position chunks), and
# GPT-2's heads (64, 1) at its engine's 512- and 1,024-position tables in
# both dtypes
DECODE_CASES = (
    (8, 32, 32, 128, 16, 32, torch.bfloat16, False),
    (8, 32, 8, 128, 16, 32, torch.bfloat16, True),
    (8, 32, 8, 128, 16, 32, torch.float32, False),
    (8, 32, 8, 128, 16, 128, torch.bfloat16, True),
    (8, 32, 8, 128, 16, 128, torch.float32, False),
    (8, 32, 32, 128, 128, 4, torch.bfloat16, False),
    (8, 32, 32, 128, 16, 128, torch.bfloat16, False),
    (8, 32, 32, 128, 16, 256, torch.bfloat16, False),
    (8, 12, 12, 64, 16, 32, torch.bfloat16, True),
    (8, 12, 12, 64, 16, 64, torch.bfloat16, False),
    (8, 12, 12, 64, 16, 32, torch.float32, False),
    (8, 12, 12, 64, 16, 64, torch.float32, True),
)


def parity_decode(fd):
    """Flash decode against its plain version under ``judge_decode`` at
    ``DECODE_CASES``, each launch on the split kernel, slots 2-4 at a split
    edge (``P - 1``, ``P``, ``P + 1``; ``P`` from ``split_plan``); every
    planted fault (``decode_faults``) must fail the same judge on the same
    case, its chunk edges at 64 positions and at ``P``."""
    err = 0.0
    for (S, H, n_kv, hd, bs, mb, dtype, empty) in DECODE_CASES:
        P = fd.split_plan(mb, bs)[0]
        q, kc, vc, tables, wp = decode_case(
            S, H, n_kv, hd, bs, mb, mb + 1, dtype, seed=S + H + mb,
            fixed=((2, P - 1), (3, P), (4, P + 1)))
        if empty:
            wp[1] = -1                       # a slot that attends nothing
        got, variant = launched_variant(
            fd.flash_decode, lambda: fd.flash_decode(q, kc, vc, tables, wp))
        want = fd.flash_decode_reference(q, kc, vc, tables, wp)
        tol = DECODE_TOL[dtype]
        rel, zeros, ok = judge_decode(got, want, wp, tol)
        live = wp.long() >= 0            # an empty slot is judged by zeros
        err = max(err, (got.float() - want.float())[live].abs().max().item())
        log(f"  flash_decode S={S} H={H} n_kv={n_kv} hd={hd} bs={bs} "
            f"positions={mb * bs} {dtype} on {variant} (P={P}): worst "
            f"(slot, head) rel err {rel:.3e} (tol {tol}), empty slot zeros "
            f"{zeros} {'ok' if ok else 'FAIL'}")
        if not ok or variant != "split":
            raise AssertionError("flash_decode disagrees with its plain "
                                 "version, or did not run the split kernel")
        for chunk in sorted({64, P}):
            for name, bad in decode_faults(fd, q, kc, vc, tables, wp,
                                           chunk).items():
                brel, _, bok = judge_decode(bad, want, wp, tol)
                log(f"    planted fault, chunk {chunk} ({name}): rel err "
                    f"{brel:.3e}, must fail: "
                    f"{'ok' if not bok else 'PASSED (FAIL)'}")
                if bok:
                    raise AssertionError(f"the decode judge passes a "
                                         f"planted fault: {name}")
        del q, kc, vc
    torch.cuda.empty_cache()
    return {"flash_decode": err}


def launched_variant(wrapper, fn):
    """Runs ``fn()`` and returns (its result, the one variant of
    ``wrapper`` it launched); raises unless exactly one launch ran."""
    before = dict(wrapper.launches_by_variant)
    res = fn()
    diff = {k: n - before[k] for k, n in wrapper.launches_by_variant.items()
            if n != before[k]}
    if list(diff.values()) != [1]:
        raise AssertionError(f"expected one launch, got {diff}")
    return res, next(iter(diff))


# (what, B, Lq, Lk, Hq, Hkv, D, causal, dtype, the variant it must take);
# the bf16 cases hit the tensor-core kernel's tile edges: ragged lengths,
# fully masked rows, GQA, every head dim, causal offsets that are not a
# multiple of its 128-row block, strided and misaligned operands
FWD_CASES = (
    ("L=512", 1, 512, 512, 32, 32, 128, True, torch.bfloat16, "tc"),
    ("L=2048", 1, 2048, 2048, 32, 32, 128, True, torch.bfloat16, "tc"),
    ("GQA group 4", 1, 512, 512, 32, 8, 128, True, torch.bfloat16, "tc"),
    ("Lq < Lk", 1, 384, 512, 32, 32, 128, True, torch.bfloat16, "tc"),
    ("Lq = Lk = 200", 1, 200, 200, 8, 8, 128, True, torch.bfloat16, "tc"),
    ("Lq > Lk, masked rows, GQA", 1, 328, 200, 8, 2, 128, True,
     torch.bfloat16, "tc"),
    # Lk - Lq = +-64: a block's first warpgroup sees one key tile fewer
    # than the block loads, and releases it after its own tiles
    ("Lk - Lq = 64", 1, 256, 320, 8, 8, 128, True, torch.bfloat16, "tc"),
    ("Lq - Lk = 64, GQA", 1, 384, 320, 8, 2, 128, True, torch.bfloat16,
     "tc"),
    ("D=64", 2, 300, 300, 8, 8, 64, True, torch.bfloat16, "tc"),
    ("D=256, group 4", 1, 300, 300, 4, 1, 256, True, torch.bfloat16, "tc"),
    ("D=32 non-causal", 1, 200, 200, 4, 4, 32, False, torch.bfloat16, "tc"),
    ("strided qkv", 2, 333, 333, 8, 8, 128, True, torch.bfloat16, "tc"),
    # GPT-2 small's scoring call: q/k/v views of one [B, L, 3h] projection
    ("GPT-2 fused qkv", 1, 1024, 1024, 12, 12, 64, True, torch.bfloat16,
     "tc"),
    # BERT-base's attention (phase 22): bench_bert's batch, non-causal
    ("BERT-base", 16, 512, 512, 12, 12, 64, False, torch.bfloat16, "tc"),
    ("misaligned", 1, 256, 256, 4, 4, 128, True, torch.bfloat16,
     "cuda_core"),
    ("fp32", 1, 512, 512, 8, 8, 128, True, torch.float32, "cuda_core"))


def gpt_qkv(qkv, H):
    """q, k, v [B, L, H, D] as GPT's block makes them: views of the fused
    projection [B, L, 3h] (row stride 3h, k and v at offsets h and 2h)."""
    B, L, h3 = qkv.shape
    return tuple(t.reshape(B, L, H, h3 // 3 // H)
                 for t in qkv.split(h3 // 3, dim=-1))


def fwd_inputs(what, B, Lq, Lk, Hq, Hkv, D, dtype, seed):
    """q, k, v for a FWD_CASES entry: randn, or views of one fused qkv
    tensor (strided: heads-major, or GPT's [B, L, 3h] split), or views
    offset by one element (not 16-byte aligned)."""
    if what == "strided qkv":
        g = torch.Generator(device="cuda").manual_seed(seed)
        qkv = torch.randn(B, Lq, 3, Hq, D, generator=g, device="cuda")
        return qkv.to(dtype).unbind(2)
    if what.startswith("GPT-2"):
        g = torch.Generator(device="cuda").manual_seed(seed)
        qkv = torch.randn(B, Lq, 3 * Hq * D, generator=g, device="cuda")
        return gpt_qkv(qkv.to(dtype), Hq)
    if what == "misaligned":
        q, k, v = attn_case(B, Lq, Lk, Hq, Hkv, D + 8, dtype, seed)
        return q[..., 1:D + 1], k[..., 1:D + 1], v[..., 1:D + 1]
    return attn_case(B, Lq, Lk, Hq, Hkv, D, dtype, seed)


def parity_forward(fa):
    """The forward kernel against its plain version under judge_forward,
    at FWD_CASES, each taking the variant it must; at L=2048, at GPT-2's
    causal D=64 and at BERT-base's non-causal D=64 both planted faults of
    forward_faults must fail the same judge."""
    err = 0.0
    for case in FWD_CASES:
        what, B, Lq, Lk, Hq, Hkv, D, causal, dtype, variant = case
        q, k, v = fwd_inputs(what, B, Lq, Lk, Hq, Hkv, D, dtype,
                             seed=Lq + Hkv + D)
        (out, lse), took = launched_variant(
            fa.flash_attention, lambda: fa.flash_attention(q, k, v, causal))
        rout, rlse = fa.flash_attention_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        rel, tail, lerr, ok = judge_forward(out, lse, rout, rlse)
        e = (out.float() - rout.float()).abs().max().item()
        ok = ok and took == variant
        log(f"  flash_attention [{what}] B={B} Lq={Lq} Lk={Lk} Hq={Hq} "
            f"Hkv={Hkv} D={D} {'causal' if causal else 'full'} {dtype}: "
            f"variant {took} (want {variant}), out rel_err {rel:.3e} / last "
            f"quarter {tail:.3e} (tol {FWD_REL_TOL[dtype]}), lse max_abs_err "
            f"{lerr:.3e} (tol {FWD_LSE_TOL[dtype]}), out max_abs_err {e:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("flash_attention disagrees with its plain "
                                 "version or took the wrong variant")
        if what in ("L=2048", "GPT-2 fused qkv", "BERT-base"):
            for name, (fo, fl) in forward_faults(q, k, v, causal).items():
                r = judge_forward(fo, fl, rout, rlse)
                log(f"  planted fault ({name}): rel_err {r[0]:.3e} / last "
                    f"quarter {r[1]:.3e}, lse {r[2]:.3e}: "
                    f"{'PASSES (bad)' if r[3] else 'fails, as it must'}")
                if r[3]:
                    raise AssertionError("the forward judge does not see a "
                                         "planted fault")
        err = max(err, e)
        del q, k, v, out, lse, rout, rlse
    torch.cuda.empty_cache()
    return {"flash_attention_fwd": err}


BWD_REL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


def judge_backward(got, want):
    """The flash backward's judge: ``||got - want|| / ||want||`` of each of
    dq, dk and dv over all rows (keys) and separately over the last
    quarter of them (with randn inputs an entry of row or key i has a
    spread of about sqrt(e / i), 0.04 at i = 2048, so the late ones are the
    small ones), below 1e-2 in bf16 (the output's bf16 rounding alone is
    ~1e-3) and 1e-4 in fp32 (reduction order only, TF32 off); every entry
    finite. ``got``/``want`` are (dq, dk, dv). Returns ([(rel_all,
    rel_tail)] per gradient, ok)."""
    tol = BWD_REL_TOL[want[0].dtype]
    rels, ok = [], True
    for g, w in zip(got, want):
        n = w.shape[1]
        tail = slice(n - max(1, n // 4), n)
        r = (rel_err(g, w), rel_err(g[:, tail], w[:, tail]))
        rels.append(r)
        ok = ok and bool(torch.isfinite(g.float()).all()) and max(r) < tol
    return rels, ok


def plain_backward(q, k, v, dout, lse, delta, mask, keep_heads=None,
                   scale=None):
    """The plain backward's arithmetic (fp32 p = exp(s - lse) and ds, ds
    and p rounded to the operands' dtype before the products, fp32 sums)
    under any [Lq, Lk] boolean mask; ``keep_heads`` ([Hq] bool) leaves
    query heads out of dk/dv's group sum. The source of the backward's
    planted faults. Returns (dq, dk, dv)."""
    B, Lq, Hq, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = 1.0 / D ** 0.5 if scale is None else scale

    def heads(x, rep=1):
        return x.transpose(1, 2).repeat_interleave(rep, dim=1).float()

    s = torch.matmul(heads(q), heads(k, group).transpose(-1, -2)) * scale
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.matmul(heads(dout), heads(v, group).transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.matmul(ds.to(k.dtype).float(), heads(k, group))
    dk = torch.matmul(ds.to(q.dtype).float().transpose(-1, -2), heads(q))
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2),
                      heads(dout))
    if keep_heads is not None:
        w = keep_heads.to(dk.dtype)[None, :, None, None]
        dk, dv = dk * w, dv * w
    dk = dk.reshape(B, Hkv, group, Lk, D).sum(2)
    dv = dv.reshape(B, Hkv, group, Lk, D).sum(2)
    return (dq.to(q.dtype).transpose(1, 2), dk.to(k.dtype).transpose(1, 2),
            dv.to(v.dtype).transpose(1, 2))


def backward_faults(q, k, v, dout, lse, delta, causal, want, tile=64):
    """Planted faults of the backward, from the plain version (``want`` is
    the right (dq, dk, dv)): the causal mask shifted by one key (in a
    non-causal case the last key hidden instead); the last visible
    ``tile``-key tile of each ``tile``-row block dropped from dq; the last
    visible query tile of each ``tile``-key block dropped from dk/dv; the
    last query head of each GQA group left out of dk/dv's sum. Returns
    {name: (dq, dk, dv)}."""
    Lq, Lk, Hq, Hkv = q.shape[1], k.shape[1], q.shape[2], k.shape[2]
    dev = q.device
    mask = causal_mask(Lq, Lk, causal, dev)
    if causal:
        shifted = causal_mask(Lq, Lk, True, dev, shift=1)
    else:
        shifted = mask.clone()
        shifted[:, -1] = False
    no_key_tile = mask.clone()
    for r0 in range(0, Lq, tile):
        last = min(Lk - 1, r0 + tile - 1 + Lk - Lq) if causal else Lk - 1
        if last >= 0:
            t0 = last // tile * tile
            no_key_tile[r0:r0 + tile, t0:t0 + tile] = False
    # every key is seen by the last query row, so each key block's last
    # visible query tile is the last one
    no_query_tile = mask.clone()
    r0 = (Lq - 1) // tile * tile
    for c0 in range(0, Lk, tile):
        no_query_tile[r0:, c0:c0 + tile] = False
    keep = torch.ones(Hq, dtype=torch.bool, device=dev)
    keep[Hq // Hkv - 1::Hq // Hkv] = False

    def plain(m, keep_heads=None):
        return plain_backward(q, k, v, dout, lse, delta, m, keep_heads)

    return {
        "causal mask shifted by one key": plain(shifted),
        "last visible key tile of each 64-row block dropped from dq":
            (plain(no_key_tile)[0], want[1], want[2]),
        "last visible query tile of each 64-key block dropped from dk/dv":
            (want[0], *plain(no_query_tile)[1:]),
        "one query head of each GQA group left out of dk/dv":
            (want[0], *plain(mask, keep)[1:])}


def check_backward_faults(q, k, v, dout, lse, delta, causal, want):
    """Every planted fault of backward_faults must fail judge_backward."""
    for name, bad in backward_faults(q, k, v, dout, lse, delta, causal,
                                     want).items():
        rels, ok = judge_backward(bad, want)
        log(f"  planted fault ({name}): dq/dk/dv rel_err "
            + " / ".join(f"{a:.3e} (last quarter {b:.3e})" for a, b in rels)
            + f": {'PASSES (bad)' if ok else 'fails, as it must'}")
        if ok:
            raise AssertionError("the backward judge does not see a planted "
                                 "fault")


# (what, B, Lq, Lk, Hq, Hkv, D, causal, dtype, the variant it must take);
# the bf16 cases hit the tensor-core kernels' tile edges: ragged lengths,
# fully masked rows, GQA, every head dim, causal offsets of +-64 (a block's
# two warpgroups need different numbers of tiles; in the causal cases the
# dk/dv block's two warpgroups mostly start at different query tiles),
# strided and misaligned operands
BWD_CASES = (
    ("trainer", 2, 2048, 2048, 32, 32, 128, True, torch.bfloat16, "tc"),
    ("GQA group 4", 1, 512, 512, 32, 8, 128, True, torch.bfloat16, "tc"),
    ("ragged, Lq < Lk", 1, 200, 328, 8, 2, 128, True, torch.bfloat16, "tc"),
    ("masked rows", 1, 160, 96, 8, 8, 128, True, torch.bfloat16, "tc"),
    ("Lk - Lq = 64", 1, 256, 320, 8, 8, 128, True, torch.bfloat16, "tc"),
    ("Lq - Lk = 64, GQA", 1, 384, 320, 8, 2, 128, True, torch.bfloat16,
     "tc"),
    ("D=64", 2, 300, 300, 8, 8, 64, True, torch.bfloat16, "tc"),
    ("D=64 non-causal, GQA", 1, 333, 333, 8, 2, 64, False, torch.bfloat16,
     "tc"),
    ("D=32 non-causal", 1, 200, 200, 4, 4, 32, False, torch.bfloat16, "tc"),
    ("D=256, group 4", 1, 300, 300, 4, 1, 256, True, torch.bfloat16,
     "cuda_core"),
    ("strided qkv", 2, 333, 333, 8, 8, 128, True, torch.bfloat16, "tc"),
    # GPT-2 small's scoring call: q/k/v views of one [B, L, 3h] projection
    ("GPT-2 fused qkv", 1, 1024, 1024, 12, 12, 64, True, torch.bfloat16,
     "tc"),
    # and its training batch (phase 17), with the planted faults
    ("GPT-2 training", 8, 1024, 1024, 12, 12, 64, True, torch.bfloat16,
     "tc"),
    # BERT-base's dropout-free step (phase 22b), non-causal, with the
    # planted faults
    ("BERT-base", 16, 512, 512, 12, 12, 64, False, torch.bfloat16, "tc"),
    ("misaligned", 1, 256, 256, 4, 4, 128, True, torch.bfloat16,
     "cuda_core"),
    ("fp32", 1, 384, 512, 8, 8, 128, True, torch.float32, "cuda_core"))


def run_backward(fa, q, k, v, do, lse, delta, causal):
    """dq, dk, dv through the two backward wrappers, and the variant each
    launched (one launch each)."""
    dq, dq_var = launched_variant(
        fa.flash_attention_bwd_dq,
        lambda: fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, causal))
    (dk, dv), dkv_var = launched_variant(
        fa.flash_attention_bwd_dkv,
        lambda: fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal))
    return (dq, dk, dv), (dq_var, dkv_var)


def parity_bwd(fa):
    """dq and dk/dv kernels against their plain versions under
    judge_backward, from the forward kernel's (out, lse), at BWD_CASES,
    each kernel taking the variant it must; fully masked rows (Lq > Lk,
    causal) must give exactly 0 in dq. At the trainer's shape, at GPT-2's
    training batch (q/k/v views of the fused qkv) and at BERT-base's
    non-causal batch every planted fault of backward_faults must fail the
    same judge."""
    errs = {"flash_attention_bwd_dq": 0.0, "flash_attention_bwd_dkv": 0.0}
    for case in BWD_CASES:
        what, B, Lq, Lk, Hq, Hkv, D, causal, dtype, variant = case
        q, k, v = fwd_inputs(what, B, Lq, Lk, Hq, Hkv, D, dtype,
                             seed=Lq + 7)
        do = fwd_inputs(what, B, Lq, Lq, Hq, Hq, D, dtype, seed=Lq + 8)[0]
        out, lse = fa.flash_attention(q, k, v, causal=causal)
        delta = fa.attention_delta(out, do)
        got, took = run_backward(fa, q, k, v, do, lse, delta, causal)
        want = (fa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                    causal),
                *fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse,
                                                      delta, causal))
        torch.cuda.synchronize()
        e = [(g.float() - w.float()).abs().max().item()
             for g, w in zip(got, want)]
        rels, ok = judge_backward(got, want)
        ok = ok and took == (variant, variant)
        zeros = None
        if causal and Lq > Lk:
            zeros = bool((got[0][:, :Lq - Lk] == 0).all())
            ok = ok and zeros
        log(f"  flash_attention_bwd [{what}] B={B} Lq={Lq} Lk={Lk} Hq={Hq} "
            f"Hkv={Hkv} D={D} {'causal' if causal else 'full'} {dtype}: "
            f"variants dq {took[0]} / dk/dv {took[1]} (want {variant}), "
            f"dq/dk/dv rel_err "
            + " / ".join(f"{a:.3e} (last quarter {b:.3e})" for a, b in rels)
            + f" (tol {BWD_REL_TOL[dtype]}), max_abs_err {e[0]:.3e}/"
            f"{e[1]:.3e}/{e[2]:.3e}"
            + ("" if zeros is None else f", masked rows of dq exactly 0 "
               f"{zeros}") + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("flash_attention backward disagrees with "
                                 "its plain version or took the wrong "
                                 "variant")
        if what in ("trainer", "GPT-2 training", "BERT-base"):
            check_backward_faults(q, k, v, do, lse, delta, causal, want)
        errs["flash_attention_bwd_dq"] = max(
            errs["flash_attention_bwd_dq"], e[0])
        errs["flash_attention_bwd_dkv"] = max(
            errs["flash_attention_bwd_dkv"], e[1], e[2])
        del q, k, v, do, out, lse, delta, got, want
        torch.cuda.empty_cache()
    return errs


def ce_case(N, H, V, dtype, seed, offset=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    h = torch.randn(N, H, generator=g, device="cuda").to(dtype)
    w = (0.02 * torch.randn(H, V, generator=g, device="cuda")).to(dtype)
    lab = torch.randint(offset, offset + V, (N,), generator=g, device="cuda")
    lab[0] = offset + V - 1                         # the last column
    return h, w, lab


def parity_fused_ce(fc):
    """The fused-CE kernel against its plain version under judge_ce, each
    case taking the variant it must (bf16 with TMA-readable operands: the
    tensor cores; fp32, or a row stride off 16 bytes: the CUDA cores); at
    the trainer head both planted faults of ce_faults must fail the same
    judge."""
    err = 0.0
    for (N, H, V, dtype, offset, variant, what) in (
            (4094, 4096, 32000, torch.bfloat16, 0, "tc", "trainer head"),
            (77, 96, 1000, torch.bfloat16, 500, "tc",
             "ragged N and H, vocab_offset"),
            (77, 96, 1000, torch.float32, 500, "cuda_core",
             "ragged, vocab_offset"),
            (33, 64, 301, torch.bfloat16, 0, "cuda_core",
             "V=301: row stride off 16 bytes")):
        h, w, lab = ce_case(N, H, V, dtype, seed=N, offset=offset)
        if offset:
            lab[1] = offset + V + 3                 # another shard's label
        got, took = launched_variant(
            fc.fused_ce_stats,
            lambda: fc.fused_ce_stats(h, w, lab, vocab_offset=offset))
        want = fc.fused_ce_stats_reference(h, w, lab, vocab_offset=offset)
        torch.cuda.synchronize()
        e, ok = judge_ce(got, want)
        ok = ok and took == variant
        if offset:
            ok = ok and got[2][1].item() == 0
        log(f"  fused_ce_stats [{what}] N={N} H={H} V={V} {dtype}: variant "
            f"{took} (want {variant}), m/s/lab max_abs_err {e[0]:.3e}/"
            f"{e[1]:.3e}/{e[2]:.3e} (rtol 1e-4, atol 1e-3) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("fused_ce_stats disagrees with its plain "
                                 "version or took the wrong variant")
        if what == "trainer head":
            for name, bad in ce_faults(fc, h, w, lab, offset).items():
                be, bok = judge_ce(bad, want)
                log(f"  planted fault ({name}): m/s/lab max_abs_err "
                    f"{be[0]:.3e}/{be[1]:.3e}/{be[2]:.3e}: "
                    f"{'PASSES (bad)' if bok else 'fails, as it must'}")
                if bok:
                    raise AssertionError("the fused-CE judge does not see a "
                                         "planted fault")
        err = max(err, e[0], e[2])
        del h, w, lab, got, want
    torch.cuda.empty_cache()
    return {"fused_ce_stats": err}


# ERNIE-MoE at bench.py's configuration (bench_ernie_moe): E=8 experts,
# top-2 of S = 8 x 1024 tokens, capacity C = ceil(2 * S * 1.25 / E),
# hidden 1024, FFN 4096
ERNIE_MOE = dict(vocab_size=32000, hidden_size=1024, num_hidden_layers=6,
                 num_attention_heads=16, intermediate_size=4096,
                 num_experts=8, max_position_embeddings=1024,
                 dtype="bfloat16")
ERNIE_BATCH = (8, 1024)
MOE_E, MOE_D, MOE_F = (ERNIE_MOE[k] for k in (
    "num_experts", "hidden_size", "intermediate_size"))
MOE_C = -(-2 * ERNIE_BATCH[0] * ERNIE_BATCH[1] * 5 // (4 * MOE_E))   # 2560
RAGGED_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def ragged_case(G, C, K, N, counts, dtype, seed):
    """x [G, C, K] (0.02-scaled w [G, K, N]) and counts on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(G, C, K, generator=g, device="cuda").to(dtype)
    w = (0.02 * torch.randn(G, K, N, generator=g, device="cuda")).to(dtype)
    cnt = torch.tensor(counts, dtype=torch.int32, device="cuda")
    return x, w, cnt


def judge_ragged(got, want, counts, tol):
    """(rel_err over the live rows, rows past counts exactly 0, ok)."""
    C = got.shape[1]
    live = (torch.arange(C, device=got.device)[None, :]
            < counts.long()[:, None])[..., None]
    rel = rel_err(torch.where(live, got.float(), 0.0),
                  torch.where(live, want.float(), 0.0))
    zeros = bool((torch.where(live, 0.0, got.float()) == 0).all())
    return rel, zeros, bool(torch.isfinite(got).all()) and zeros and rel < tol


def ragged_faults(rm, x, w, counts, out_dtype=None, rows=128, cols=256,
                  depth=64):
    """Planted faults for ``judge_ragged``: the plain version with one
    thing wrong that a ragged kernel could get wrong. x must be finite.
    Returns {name: out}:

    - counts ignored (every row computed);
    - half of K dropped;
    - the last ``depth``-deep K chunk dropped (a ring that stops early);
    - the first K chunk summed twice (a stale ring stage);
    - the rows of a partly live ``rows``-row tile past the count given
      their product instead of 0 (only where some group has such a tile);
    - the last ``cols``-column tile of each group computed against the
      next group's w (only for more than one group)."""
    ref = rm.ragged_group_matmul_reference
    G, C, K = x.shape
    N = w.shape[2]
    live = counts.long().clamp(0, C)
    out = {"counts ignored": ref(x, w, torch.full_like(counts, C),
                                 out_dtype)}
    for name, k0, k1, scale in (
            ("half of K dropped", K // 2, K, 0),
            ("last K chunk dropped", (K - 1) // depth * depth, K, 0),
            ("first K chunk summed twice", 0, min(depth, K), 2)):
        xb = x.clone()
        xb[..., k0:k1] *= scale
        out[name] = ref(xb, w, counts, out_dtype)
    ends = ((live + rows - 1) // rows * rows).clamp(max=C)
    if bool((ends != live).any()):
        out["rows past the count of a partly live tile computed"] = ref(
            x, w, ends, out_dtype)
    if G > 1:
        n0 = (N - 1) // cols * cols
        bad = ref(x, w, counts, out_dtype).clone()
        bad[..., n0:] = ref(x, w.roll(-1, 0), counts, out_dtype)[..., n0:]
        out["last column tile against the next group's w"] = bad
    return out


def check_ragged_faults(rm, x, w, counts, want, tol, n_faults):
    """Every fault of ``ragged_faults`` (``n_faults`` of them) must fail
    ``judge_ragged``."""
    faults = ragged_faults(rm, x, w, counts)
    for name, bad in faults.items():
        rel, zeros, ok = judge_ragged(bad, want, counts, tol)
        log(f"    planted fault [{name}]: rel_err {rel:.3e}, zeros past "
            f"counts {zeros}: {'passed (BAD)' if ok else 'fails, as it must'}")
        if ok:
            raise AssertionError(f"the ragged check does not see the planted "
                                 f"fault '{name}'")
    if len(faults) != n_faults:
        raise AssertionError(f"{len(faults)} planted faults, want {n_faults}")


# (what, G, C, K, N, counts, dtype, out dtype (None: x's), operand form,
# NaN past the counts, the variant it must take, planted faults checked
# here). Forms: "mn" w [G, K, N] contiguous (the forward's projections);
# "k" w^T as a view (dx's call); "x sliced" x = wide[..., :K], a row stride
# of K + 4 elements; "w misaligned" w's base 2 bytes off 16. The bf16 cases
# hit the tensor-core kernel's tile edges (128 rows, 256 columns in 64-wide
# boxes, 64 deep)
RAGGED_CASES = (
    ("small", 4, 19, 8, 13, [0, 5, 19, 12], torch.float32, None, "mn",
     False, "cuda_core", 0),
    ("small", 4, 19, 8, 13, [0, 5, 19, 12], torch.bfloat16, None, "mn",
     False, "mma_sync", 0),
    ("C not a multiple of 128, an empty group", 3, 300, 256, 256,
     [300, 200, 0], torch.bfloat16, None, "mn", False, "tc", 0),
    ("counts end at 1, 64, 127, 129 and C of a tile", 5, 384, 1024, 512,
     [1, 64, 127, 129, 384], torch.bfloat16, None, "mn", True, "tc", 6),
    ("K a multiple of 8, not of 64", 2, 256, 200, 192, [256, 100],
     torch.bfloat16, None, "mn", False, "tc", 0),
    ("N a multiple of 8, not of 64", 2, 256, 192, 328, [130, 256],
     torch.bfloat16, None, "mn", False, "tc", 0),
    ("w K-major", 3, 300, 328, 392, [300, 129, 5], torch.bfloat16, None, "k",
     True, "tc", 0),
    ("fp32 out", 3, 200, 64, 48, [130, 0, 200], torch.bfloat16,
     torch.float32, "mn", True, "tc", 0),
    ("fp32 out, w K-major", 2, 300, 72, 136, [257, 64], torch.bfloat16,
     torch.float32, "k", True, "tc", 0),
    ("x sliced", 2, 200, 64, 96, [200, 77], torch.bfloat16, None,
     "x sliced", False, "mma_sync", 0),
    ("w misaligned", 2, 200, 64, 96, [130, 200], torch.bfloat16, None,
     "w misaligned", False, "mma_sync", 0),
    ("counts > C", 3, 100, 64, 96, [150, 100, 7], torch.bfloat16, None, "mn",
     False, "tc", 0),
    ("counts > C", 3, 100, 64, 96, [150, 100, 7], torch.float32, None, "mn",
     False, "cuda_core", 0),
    ("MoE up", MOE_E, MOE_C, MOE_D, MOE_F, "imbalanced", torch.bfloat16,
     None, "mn", True, "tc", 5),
    ("MoE down", MOE_E, MOE_C, MOE_F, MOE_D, "imbalanced", torch.bfloat16,
     None, "mn", True, "tc", 0),
    ("dx: dy @ w^T", MOE_E, MOE_C, MOE_F, MOE_D, "imbalanced",
     torch.bfloat16, None, "k", False, "tc", 0))


def ragged_operands(G, C, K, N, counts, dtype, form, nan_past, seed):
    """x, x's finite twin, w and counts for a RAGGED_CASES entry. With
    ``nan_past`` x's rows past each count hold NaN, which the kernel must
    never read into a result; the twin is the same draw without it."""
    x, w, cnt = ragged_case(G, C, K, N, counts, dtype, seed)
    xf = x
    if nan_past:
        x = x.clone()
        x[~(torch.arange(C, device="cuda")[None, :]
            < cnt.long()[:, None])] = float("nan")
    if form == "k":         # the up projection's w [G, N, K] read as w^T
        w = w.reshape(G, N, K).transpose(1, 2)
    elif form == "x sliced":
        wide = torch.zeros(G, C, K + 4, dtype=dtype, device="cuda")
        wide[..., :K] = x
        x = xf = wide[..., :K]
    elif form == "w misaligned":
        flat = torch.empty(w.numel() + 1, dtype=dtype, device="cuda")
        flat[1:] = w.reshape(-1)
        w = flat[1:].view(G, K, N)
    return x, xf, w, cnt


def parity_ragged(rm):
    """The ragged kernels against their plain version (``RAGGED_CASES``):
    ``||got - want|| / ||want||`` over the live rows below 1e-2 for a bf16
    result (its rounding, ~1e-3) and 1e-5 for an fp32 one (TF32 off: sum
    order only), every row past ``counts[g]`` exactly 0 (NaN there never
    read into a result), and each case on the variant it must take. At
    the tile-edge counts and the MoE up shape the planted faults of
    ``ragged_faults`` must fail the check."""
    err = 0.0
    imb = [MOE_C if e % 2 == 0 else MOE_C // 2 for e in range(MOE_E)]
    for (what, G, Cc, K, N, counts, dtype, out_dtype, form, nan_past, want_v,
         n_faults) in RAGGED_CASES:
        counts = imb if counts == "imbalanced" else counts
        out_dtype = out_dtype or dtype
        tol = RAGGED_TOL[out_dtype]
        x, xf, w, cnt = ragged_operands(G, Cc, K, N, counts, dtype, form,
                                        nan_past, seed=G + K)
        got, took = launched_variant(rm.ragged_group_matmul, lambda: (
            rm.ragged_group_matmul(x, w, cnt, out_dtype=out_dtype)))
        want = rm.ragged_group_matmul_reference(x, w, cnt, out_dtype)
        torch.cuda.synchronize()
        rel, zeros, ok = judge_ragged(got, want, cnt, tol)
        ok = ok and took == want_v
        e = (got.float() - want.float()).abs().max().item()
        log(f"  ragged_group_matmul [{what}] G={G} C={Cc} K={K} N={N} "
            f"{dtype}->{out_dtype}, w {form}"
            f"{', NaN past counts' if nan_past else ''}: {took} (want "
            f"{want_v}), rel_err {rel:.3e} (tol {tol}), zeros past counts "
            f"{zeros}, max_abs_err {e:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("ragged_group_matmul disagrees with its "
                                 "plain version, or took another variant")
        if n_faults:
            check_ragged_faults(rm, xf, w, cnt, want, tol, n_faults)
        err = max(err, e)
        del x, xf, w, cnt, got, want
    torch.cuda.empty_cache()
    return {"ragged_group_matmul": err}


def parity_ernie_attention(fa):
    """The flash forward, dq and dk/dv kernels at ERNIE-MoE's attention
    shape (B=8, L=1024, H=16, D=64, non-causal, bf16) under the judges of
    the Llama shapes above, all three on the tensor-core variants: the
    forward under judge_forward, the backward under judge_backward, whose
    planted faults must fail here too."""
    q, k, v = attn_case(8, 1024, 1024, 16, 16, 64, torch.bfloat16, seed=64)
    do = attn_case(8, 1024, 1024, 16, 16, 64, torch.bfloat16, seed=65)[0]
    (out, lse), took = launched_variant(
        fa.flash_attention, lambda: fa.flash_attention(q, k, v, False))
    rout, rlse = fa.flash_attention_reference(q, k, v, causal=False)
    delta = fa.attention_delta(out, do)
    got, btook = run_backward(fa, q, k, v, do, lse, delta, False)
    want = (fa.flash_attention_bwd_dq_reference(q, k, v, do, lse, delta,
                                                False),
            *fa.flash_attention_bwd_dkv_reference(q, k, v, do, lse, delta,
                                                  False))
    torch.cuda.synchronize()
    oerr = (out.float() - rout.float()).abs().max().item()
    orel, otail, lerr, ok = judge_forward(out, lse, rout, rlse)
    rels, bok = judge_backward(got, want)
    e = [(g.float() - w.float()).abs().max().item()
         for g, w in zip(got, want)]
    ok = ok and bok and took == "tc" and btook == ("tc", "tc")
    log(f"  flash_attention [ERNIE] B=8 L=1024 H=16 D=64 non-causal bf16: "
        f"forward variant {took}, out rel_err {orel:.3e} / last quarter "
        f"{otail:.3e} (tol 1e-2), lse max_abs_err {lerr:.3e} (tol 1e-3), "
        f"out max_abs_err {oerr:.3e}; backward variants dq {btook[0]} / "
        f"dk/dv {btook[1]}, dq/dk/dv rel_err "
        + " / ".join(f"{a:.3e} (last quarter {b:.3e})" for a, b in rels)
        + f" (tol 1e-2) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("flash attention disagrees with its plain "
                             "version at the ERNIE shape or took the wrong "
                             "variant")
    check_backward_faults(q, k, v, do, lse, delta, False, want)
    del q, k, v, do, out, lse, rout, rlse, delta, got, want
    torch.cuda.empty_cache()
    return {"flash_attention_fwd": oerr, "flash_attention_bwd_dq": e[0],
            "flash_attention_bwd_dkv": max(e[1], e[2])}


# Llama-2-7B projections at the forward's M = 1 x 512 rows: q/k/v/o, the
# FFN up (gate, up) and down, and the head
INT8_SHAPES = (("qkvo", 512, 4096, 4096), ("up", 512, 4096, 11008),
               ("down", 512, 11008, 4096), ("head", 512, 4096, 32000))
# and the tensor-core kernel's tile edges (128 x 128 tiles, 128-deep
# stages): M = 1, 37, 130; N = 129, 300; K = 128 and 11008; the odd tail
# (K = 200: not a multiple of 16, so TMA cannot read it)
INT8_EDGES = (("M=1 N=129", 1, 4096, 129), ("M=37 N=300 K=128", 37, 128, 300),
              ("M=130 N=129 K=11008", 130, 11008, 129),
              ("odd tail", 37, 200, 300))


def int8_case(M, K, N, seed):
    """Per-row-quantized activations (as ``_quant_rows`` makes them) and
    a per-column-quantized weight, all on the card; wq row-major [K, N]."""
    from paddle_tpu_torch.ops.int8_matmul import _quant_rows
    g = torch.Generator(device="cuda").manual_seed(seed)
    xq, xs = _quant_rows(torch.randn(M, K, generator=g, device="cuda"))
    w = 0.02 * torch.randn(K, N, generator=g, device="cuda")
    ws = torch.clamp_min(w.abs().amax(0, keepdim=True) / 127.0, 1e-10)
    wq = torch.clamp(torch.round(w / ws), -127, 127).to(torch.int8)
    return xq, xs, wq, ws


def k_major(wq):
    """The [K, N] view of wq's K-major copy ([N, K] storage), as
    ``Int8Linear.qweight`` lies."""
    return wq.t().contiguous().t()


def same_bits(a, b):
    """Bit-for-bit equality of two tensors of one dtype and shape."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    view = {1: torch.int8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return torch.equal(a.view(view), b.view(view))


def int8_faults(im, name, xq, xs, wq, ws, dt):
    """Planted faults of the int8 matmul, from its plain version, at the
    shapes where each is a fault of the tensor-core design: at the up
    shape the last 128-deep K chunk dropped, the last 128-column tile
    computed against the next tile's columns (the first tile's, past the
    last) and the row scales shifted by one row; at the square q/k/v/o
    shape the K-major storage read as if it were row-major."""
    ref = im.int8_matmul_rescale_reference
    K, N = wq.shape
    if name == "up":
        Kc = (K - 1) // 128 * 128
        c0 = (N - 1) // 128 * 128
        nxt = ref(xq, xs, torch.roll(wq, -128, 1)[:, c0:],
                  torch.roll(ws, -128, 1)[:, c0:], dt)
        tile = ref(xq, xs, wq, ws, dt)
        tile[:, c0:] = nxt
        return {"last 128-deep K chunk dropped":
                ref(xq[:, :Kc], xs, wq[:Kc], ws, dt),
                "last column tile against the next tile's columns": tile,
                "row scales shifted": ref(xq, torch.roll(xs, 1, 0), wq, ws,
                                          dt)}
    if name == "qkvo":
        # the bytes of wq^T [N, K] taken as [K, N] rows
        return {"K-major storage read as row-major":
                ref(xq, xs, wq.t().contiguous().view(K, N), ws, dt)}
    return {}


def parity_int8(im):
    """The int8 kernel against its plain version, bit for bit, in bf16 and
    fp32, at the 7B shapes and the tile edges (``INT8_SHAPES``,
    ``INT8_EDGES``), with wq in both layouts: K-major (``Int8Linear``'s)
    takes the tensor cores (``"tc"``) wherever TMA can read it, row-major
    and the odd tail the first kernel (``"mma_sync"``). The planted faults
    (``int8_faults``) must fail the same check."""
    err = 0.0
    for name, M, K, N in INT8_SHAPES + INT8_EDGES:
        xq, xs, wq, ws = int8_case(M, K, N, seed=K + N)
        for layout, w in (("K-major", k_major(wq)), ("row-major", wq)):
            must = ("tc" if layout == "K-major" and K % 16 == 0
                    else "mma_sync")
            for dt in (torch.bfloat16, torch.float32):
                got, variant = launched_variant(
                    im.int8_matmul_rescale,
                    lambda: im.int8_matmul_rescale(xq, xs, w, ws,
                                                   out_dtype=dt))
                want = im.int8_matmul_rescale_reference(xq, xs, wq, ws, dt)
                torch.cuda.synchronize()
                ok = (same_bits(got, want) and variant == must
                      and bool(torch.isfinite(got).all()))
                e = (got.float() - want.float()).abs().max().item()
                log(f"  int8_matmul_rescale [{name}] M={M} K={K} N={N} "
                    f"wq {layout} -> {dt}: variant {variant} (must be "
                    f"{must}), bit-exact {same_bits(got, want)}, "
                    f"max_abs_err {e:.3e} (tol: exact) "
                    f"{'ok' if ok else 'FAIL'}")
                if not ok:
                    raise AssertionError("int8_matmul_rescale disagrees with "
                                         "its plain version, or took the "
                                         "wrong variant")
                err = max(err, e)
                if dt != torch.bfloat16 or layout != "K-major":
                    continue
                for what, bad in int8_faults(im, name, xq, xs, wq, ws,
                                             dt).items():
                    seen = same_bits(bad, want)
                    log(f"    planted fault ({what}): bit-exact {seen}, "
                        f"must be False")
                    if seen:
                        raise AssertionError("the int8 check does not see "
                                             f"a planted fault: {what}")
        del xq, xs, wq, ws
    torch.cuda.empty_cache()
    return {"int8_matmul_rescale": err}


SR_SHAPES = ((256, 256), (4096, 11008))      # bench.py's; a 7B FFN weight


def sr_rounding_stats(x, bits16):
    """bf16 outputs (their 16 bits, int64) of fp32 ``x``: (every output is
    one of the two bf16 values around x, |round-up share - mean dropped
    fraction|, its 6-sigma bound 3 / sqrt(n)): the difference (up - frac)
    has mean 0 and variance at most 1/4 per element."""
    xb = x.view(torch.int32).long() & 0xFFFFFFFF
    lo = xb >> 16
    bracket = bool(((bits16 == lo) | (bits16 == lo + 1)).all())
    up = (bits16 != lo).double()
    frac = (xb & 0xFFFF).double() / 65536.0
    return bracket, abs((up - frac).mean().item()), 3.0 / x.numel() ** 0.5


def q_rounding_stats(x, q, s):
    """int8 outputs: (|q s - x| < s everywhere, |round-up share - mean
    fractional part of x / s|, its 6-sigma bound)."""
    t = x.double() / s.double()
    within = bool(((q.double() * s.double() - x.double()).abs()
                   < s.double()).all())
    up = (q.double() > torch.floor(t)).double()
    return within, abs((up - (t - torch.floor(t))).mean().item()), \
        3.0 / x.numel() ** 0.5


def parity_stochastic(sr):
    """Both stochastic kernels against their plain versions, bit for bit
    (the same threefry words), at 256 x 256 and 4096 x 11008; then, on the
    kernels' 4096 x 11008 outputs (4.5e7 draws), the statistical checks of
    ``sr_rounding_stats`` / ``q_rounding_stats``, which a planted
    truncating version (all-zero words, u = 0) must fail; and the mean of
    q s over 64 seeds at 256 x 256 within 0.5 s of x (8 sigma: its spread
    is at most s / 16) and unbiased overall (6 sigma)."""
    errs = {"stochastic_round": 0.0, "quantize_int8_stochastic": 0.0}
    for R, C in SR_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(R)
        x = 0.02 * torch.randn(R, C, generator=g, device="cuda")
        seed = R + 1
        words = sr.random_bits(seed, x.numel(), device="cuda")
        a = sr.stochastic_round_bf16(x, seed)
        b = sr.stochastic_round_bf16_reference(x, words)
        q, s = sr.quantize_int8_stochastic(x, seed)
        q2, s2 = sr.quantize_int8_stochastic_reference(x, words)
        torch.cuda.synchronize()
        ok = same_bits(a, b) and same_bits(q, q2) and same_bits(s, s2)
        ea = (a.float() - b.float()).abs().max().item()
        eq = (q.float() - q2.float()).abs().max().item()
        log(f"  stochastic_round / quantize_int8_stochastic {R}x{C} seed "
            f"{seed}: bit-exact {ok} (tol: exact), max_abs_err {ea:.3e} / "
            f"{eq:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("a stochastic kernel disagrees with its "
                                 "plain version")
        errs["stochastic_round"] = max(errs["stochastic_round"], ea)
        errs["quantize_int8_stochastic"] = max(
            errs["quantize_int8_stochastic"], eq)
        if (R, C) != SR_SHAPES[-1]:
            continue
        zero = torch.zeros_like(words)
        checks = {
            "bf16": sr_rounding_stats(x, a.view(torch.int16).long() & 0xFFFF),
            "bf16 planted u=0": sr_rounding_stats(
                x, sr.stochastic_round_bf16_reference(x, zero).view(
                    torch.int16).long() & 0xFFFF),
            "int8": q_rounding_stats(x, q, s),
            "int8 planted u=0": q_rounding_stats(
                x, *sr.quantize_int8_stochastic_reference(x, zero))}
        for what, (held, dev, bnd) in checks.items():
            passed = held and dev < bnd
            log(f"  rounding statistics [{what}] n={x.numel()}: bracket/"
                f"within {held}, |up share - dropped fraction| {dev:.3e} "
                f"(bound {bnd:.3e}) {'pass' if passed else 'fail'}")
            if passed == what.endswith("u=0"):
                raise AssertionError(f"rounding statistics [{what}]: "
                                     f"{'passed' if passed else 'failed'}")
        del words, zero, a, b, q, q2
    small = 0.02 * torch.randn(256, 256, device="cuda",
                               generator=torch.Generator(
                                   device="cuda").manual_seed(3))
    acc = torch.zeros_like(small, dtype=torch.float64)
    for seed in range(64):
        q, s = sr.quantize_int8_stochastic(small, seed)
        acc += q.double() * s.double()
    dev = (acc / 64 - small.double()) / s.double()
    worst, bias = dev.abs().max().item(), abs(dev.mean().item())
    bbound = 6 * 0.5 / (64 * small.numel()) ** 0.5
    ok = worst < 0.5 and bias < bbound
    log(f"  mean of q s over 64 seeds: max |mean - x| {worst:.3f} s (bound "
        f"0.5 s), mean bias {bias:.3e} s (bound {bbound:.3e}) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError("quantize_int8_stochastic is biased")
    torch.cuda.empty_cache()
    return errs


# ---------------------------------------------------------------------------
# phases 4-6: the main path
# ---------------------------------------------------------------------------

# Known words of jax.random (JAX 0.9.0, partitionable threefry), for the
# card, where there is no JAX; tests/test_torch_prng.py holds JAX itself and
# the port's CPU words to them
PRNG_WORDS = {
    "split(PRNGKey(11))": [[1943334310, 1180745302],
                           [3947986621, 4020105687]],
    "split(PRNGKey(2**32 - 1))": [[2973345818, 897673333],
                                  [3461607691, 1112781462]],
    "split(PRNGKey(2**31), 3)": [[2175920781, 1058516002],
                                 [4249812751, 4277599006],
                                 [824838306, 2653515278]],
    "bits(PRNGKey(0), (5,))": [4070199207, 4202968722, 1427181096,
                               2012915765, 2447653815],
    "bits(PRNGKey(7), (300000,))[-3:]": [4092374875, 4081220091, 3582496677],
}


def prng_words(prng, device):
    """``PRNG_WORDS``' entries computed by ``ops.prng`` on ``device``."""
    key = lambda s: prng.prng_key(s, device)                  # noqa: E731
    return {
        "split(PRNGKey(11))": prng.split(key(11)).tolist(),
        "split(PRNGKey(2**32 - 1))": prng.split(key(2**32 - 1)).tolist(),
        "split(PRNGKey(2**31), 3)": prng.split(key(2**31), 3).tolist(),
        "bits(PRNGKey(0), (5,))": prng.random_bits(key(0), (5,)).tolist(),
        "bits(PRNGKey(7), (300000,))[-3:]":
            prng.random_bits(key(7), (300000,))[-3:].tolist(),
    }


def workload(vocab, seed):
    """8 prompts: a shared 64-token system prefix + 16..192-token
    suffixes."""
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, vocab, 64)
    return [np.concatenate([sys_p, rng.integers(0, vocab, n)]).astype(
        np.int32) for n in (16, 40, 64, 96, 128, 160, 192, 24)]


def staggered(eng, prompts, max_new, per_request=None):
    """Two requests, two steps, then one request per step; drain.
    ``per_request[i]`` holds request i's extra ``submit`` arguments."""
    kw = per_request or [{}] * len(prompts)
    hs = [eng.submit(prompts[0], max_new_tokens=max_new, **kw[0]),
          eng.submit(prompts[1], max_new_tokens=max_new, **kw[1])]
    eng.step()
    eng.step()
    for p, k in zip(prompts[2:], kw[2:]):
        hs.append(eng.submit(p, max_new_tokens=max_new, **k))
        eng.step()
    eng.drain()
    return hs


def reset_counts(wrapper):
    """Zeroes a kernel wrapper's launch count and, where it has variants,
    its count per variant."""
    wrapper.launches = 0
    for k in getattr(wrapper, "launches_by_variant", {}):
        wrapper.launches_by_variant[k] = 0


def phase_forward(model, fa, fd, F):
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.config.vocab_size, (1, 512))).cuda()
    with torch.inference_mode():                 # scoring
        model(ids)                               # warm-up
        torch.cuda.synchronize()
        reset_counts(fa.flash_attention)
        reset_counts(fd.flash_decode)
        t0 = time.perf_counter()
        logits = model(ids)
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = fa.flash_attention.launches
    by_variant = dict(fa.flash_attention.launches_by_variant)
    path = F.attention_path()
    log(f"  logits {tuple(logits.shape)} {logits.dtype}, path={path}, "
        f"flash_attention launches={launches} {by_variant}, forward "
        f"{dt * 1e3:.1f} ms")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite logits")
    if path["path"] != "flash":
        raise AssertionError(f"attention did not take the flash path: {path}")
    n = model.config.num_hidden_layers
    if launches != n or by_variant != {"tc": n, "cuda_core": 0}:
        raise AssertionError(f"flash_attention launched {launches} times "
                             f"({by_variant}), want {n}, all on the tensor "
                             f"cores")
    return launches


def phase_engine(model, fa, fd, Engine, ledger):
    prompts = workload(model.config.vocab_size, seed=1)
    eng = Engine(model, n_slots=8, max_len=512, block_size=16,
                 flash_decode=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention.launches = 0
    reset_counts(fd.flash_decode)
    t0 = time.perf_counter()
    hs = staggered(eng, prompts, 32)
    wall = time.perf_counter() - t0
    launches = fd.flash_decode.launches
    by_variant = dict(fd.flash_decode.launches_by_variant)
    st = eng.stats()
    led = ledger(hs)
    peak = torch.cuda.max_memory_allocated()
    log(f"  {len(hs)} requests, wall {wall:.2f} s, decode steps "
        f"{st['decode_steps']}, prefills {st['prefills']}, prefix_hit_tokens"
        f" {st['prefix_hit_tokens']}, cow_copies {st['cow_copies']}, "
        f"flash_decode launches {launches} {by_variant}")
    log("  ledger " + json.dumps(led))
    log(f"  peak memory {peak / 2**30:.2f} GiB, KV pool "
        f"{st['kv_cache_bytes'] / 2**30:.2f} GiB")
    if not all(h.finished and h.finish_reason == "length"
               and len(h.tokens) == 32 for h in hs):
        raise AssertionError("a request did not finish with 32 tokens")
    if st["prefix_hit_tokens"] <= 0 or not eng.cache.check_refcounts():
        raise AssertionError("prefix sharing or refcounts failed")
    want = model.config.num_hidden_layers * st["decode_steps"]
    if launches != want or launches == 0 \
            or by_variant != {"split": want, "one_pass": 0}:
        raise AssertionError(f"flash_decode launched {launches} times "
                             f"({by_variant}), want {want}, all on the "
                             f"split kernel")
    return launches


def phase_identity(LlamaForCausalLM, LLAMA_TINY, Engine, seed, prng):
    """Token identity at LLAMA_TINY fp32 (TF32 off): kernel vs gathered,
    greedy and sampled + chunked; slot vs paged and chunked vs one-shot,
    greedy; and the PRNG words on the card vs the CPU's and the known
    words."""
    cfg = dataclasses.replace(LLAMA_TINY, dtype="float32")
    seed(0)
    tiny = LlamaForCausalLM(cfg, device="cuda")
    prompts = workload(cfg.vocab_size, seed=2)
    geo = dict(n_slots=8, max_len=512, block_size=16)
    sampled = dict(do_sample=True, top_k=50, top_p=0.9, prefill_chunk=64)
    per_request = [dict(temperature=0.6, seed=1000 + i)
                   for i in range(len(prompts))]

    def tokens(**kw):
        eng = Engine(tiny, **geo, **kw)
        hs = staggered(eng, prompts, 32,
                       per_request if kw.get("do_sample") else None)
        paged = kw.get("kv_layout", "paged") == "paged"
        if eng.cache.n_free != eng.n_slots \
                or paged and not eng.cache.check_refcounts():
            raise AssertionError(f"{kw}: the engine did not free its KV")
        return [list(h.tokens) for h in hs], eng.stats()

    cases = {
        "kernel vs gathered, greedy": (dict(flash_decode=True),
                                       dict(flash_decode=False)),
        "kernel vs gathered, sampled + chunked": (
            dict(sampled, flash_decode=True),
            dict(sampled, flash_decode=False)),
        "slot vs paged, greedy": (dict(kv_layout="slot"), {}),
        "chunked vs one-shot, greedy": (dict(prefill_chunk=64), {}),
    }
    out = {}
    for what, (a, b) in cases.items():
        (ta, sa), (tb, _) = tokens(**a), tokens(**b)
        out[what] = ta == tb
        log(f"  tiny fp32 engine tokens identical ({what}): {ta == tb}"
            + (f", chunked_prefills {sa['chunked_prefills']}, chunk_steps "
               f"{sa['chunk_steps']}" if sa["chunked_prefills"] else ""))
        if a.get("prefill_chunk") and not sa["chunked_prefills"]:
            raise AssertionError(f"{what}: no prompt was chunked")
    cpu, card = (prng_words(prng, d) for d in ("cpu", "cuda"))
    out["prng words, card vs CPU vs known"] = cpu == card == PRNG_WORDS
    log(f"  PRNG words on the card equal the CPU's and the known words: "
        f"{out['prng words, card vs CPU vs known']}")
    if not all(out.values()):
        raise AssertionError(f"token identity failed: {out}")


# ---------------------------------------------------------------------------
# phase 11: sampled, chunked serving at Llama-2-7B
# ---------------------------------------------------------------------------

# Llama-2-7b-chat's published generation_config.json: temperature 0.6,
# top_p 0.9; top_k 50 is the transformers default
SAMPLED = dict(do_sample=True, top_k=50, top_p=0.9, prefill_chunk=64)
SERVE_GEO = dict(n_slots=8, max_len=512, block_size=16)


def run_sampled(model, Engine, prompts):
    eng = Engine(model, **SERVE_GEO, flash_decode=True, **SAMPLED)
    per_request = [dict(temperature=0.6, seed=1000 + i)
                   for i in range(len(prompts))]
    t0 = time.perf_counter()
    hs = staggered(eng, prompts, 32, per_request)
    torch.cuda.synchronize()
    return eng, hs, time.perf_counter() - t0


def step_syncs(step):
    """The host synchronisations that ``step()`` makes, as torch's sync
    debug mode reports them."""
    import warnings
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's first use also warns that it is a prototype: not a sync
    return sum("called a synchronizing CUDA operation" in str(w.message)
               for w in caught)


def profile_decode_step(model, Engine, prompts, **kw):
    """One steady-state decode step under torch.profiler (every slot
    decoding: all prefills and chunks done; after two warm-up steps),
    and the host synchronisations of the step before it."""
    eng = Engine(model, **SERVE_GEO, **kw)
    for i, p in enumerate(prompts):
        eng.submit(p, max_new_tokens=48, temperature=0.6, seed=1000 + i)
    while eng._chunking or eng.scheduler.queue_depth:
        eng.step()
    eng.step()
    syncs = step_syncs(eng.step)
    return dict(profile_step(eng.step), host_syncs=syncs)


def profile_sampling_glue(model, Engine):
    """The decode step's sampling glue alone (``serving.engine.
    _next_tokens``: filter, key split, Gumbel draw, arg-max) at the 7B
    vocabulary over 8 slots, under torch.profiler."""
    from paddle_tpu_torch.serving import engine as E
    S, V = SERVE_GEO["n_slots"], model.config.vocab_size
    g = torch.Generator(device="cuda").manual_seed(0)
    logits = torch.randn((S, V), device="cuda", generator=g)
    keys = torch.arange(2 * S, device="cuda").view(S, 2)
    tok = torch.zeros(S, dtype=torch.int32, device="cuda")
    active = torch.ones(S, dtype=torch.bool, device="cuda")
    temps = torch.full((S,), 0.6, device="cuda")
    kw = {k: SAMPLED[k] for k in ("do_sample", "top_k", "top_p")}
    E._next_tokens(logits, tok, active, keys, temps, **kw)      # warm-up
    return profile_step(lambda: E._next_tokens(logits, tok, active, keys,
                                               temps, **kw))


def phase_sampled(model, fd, Engine, ledger):
    """Sampled, chunked serving at Llama-2-7B (phase 4's bf16 model):
    phase 5's workload with Llama-2-7b-chat's sampling, every prompt
    chunked; then the same workload on the slot layout, greedy."""
    prompts = workload(model.config.vocab_size, seed=1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fd.flash_decode)
    eng, hs, wall = run_sampled(model, Engine, prompts)
    launches = fd.flash_decode.launches
    by_variant = dict(fd.flash_decode.launches_by_variant)
    st = eng.stats()
    led = ledger(hs)
    peak = torch.cuda.max_memory_allocated()
    out = dict(wall_s=wall, decode_steps=st["decode_steps"],
               chunk_steps=st["chunk_steps"],
               chunked_prefills=st["chunked_prefills"],
               prefills=st["prefills"],
               prefix_hit_tokens=st["prefix_hit_tokens"],
               flash_decode_launches=launches, ledger=led,
               peak_memory_gib=peak / 2**30)
    log(f"  {len(hs)} requests, wall {wall:.2f} s, decode steps "
        f"{st['decode_steps']}, chunk steps {st['chunk_steps']} "
        f"({st['chunked_prefills']} chunked prefills), prefix_hit_tokens "
        f"{st['prefix_hit_tokens']}, flash_decode launches {launches} "
        f"{by_variant}")
    log("  ledger " + json.dumps(led))
    log(f"  peak memory {peak / 2**30:.2f} GiB")
    if not all(h.finished and h.finish_reason == "length"
               and len(h.tokens) == 32 for h in hs):
        raise AssertionError("a request did not finish with 32 tokens")
    if not (st["chunked_prefills"] > 0
            and st["chunk_steps"] >= st["chunked_prefills"]
            and st["prefix_hit_tokens"] > 0 and eng.cache.check_refcounts()):
        raise AssertionError(f"chunking, prefix sharing or refcounts "
                             f"failed: {st}")
    want = model.config.num_hidden_layers * st["decode_steps"]
    if launches != want or by_variant != {"split": want, "one_pass": 0}:
        raise AssertionError(f"flash_decode launched {launches} times "
                             f"({by_variant}), want {want}, all on the "
                             f"split kernel")
    toks = [list(h.tokens) for h in hs]
    del eng, hs
    _, hs2, _ = run_sampled(model, Engine, prompts)
    same = [list(h.tokens) for h in hs2] == toks
    log(f"  a second run with the same seeds gives the same tokens: {same}")
    if not same:
        raise AssertionError("the same seeds gave other tokens")
    del hs2
    torch.cuda.empty_cache()
    prof = {"sampled": profile_decode_step(model, Engine, prompts,
                                           flash_decode=True, **SAMPLED),
            "greedy (phase 5's engine)": profile_decode_step(
                model, Engine, prompts, flash_decode=True),
            "sampling glue alone": profile_sampling_glue(model, Engine)}
    for what, p in prof.items():
        log(f"  one profiled decode step, {what}: wall "
            f"{p['step_wall_ms']:.2f} ms, device busy "
            f"{p['device_busy_ms']:.3f} ms, idle "
            f"{p['device_idle_share']:.3f}, "
            f"{p['device_kernel_launches']} launches"
            + (f", {p['host_syncs']} host syncs" if "host_syncs" in p
               else ""))
    out["profiled_decode_step"] = {
        k: {f: p[f] for f in ("step_wall_ms", "device_busy_ms",
                              "device_idle_share", "device_kernel_launches",
                              "port_kernels_ms", "host_syncs") if f in p}
        for k, p in prof.items()}
    syncs = [prof[k]["host_syncs"] for k in
             ("sampled", "greedy (phase 5's engine)")]
    if syncs[0] != syncs[1] or not syncs[0]:
        raise AssertionError(f"host syncs per decode step: sampled "
                             f"{syncs[0]}, greedy {syncs[1]}: sampling "
                             f"must add none")
    out["profiled_decode_step"]["sampled"]["top_kernels_ms"] = \
        prof["sampled"]["top_kernels_ms"]
    torch.cuda.empty_cache()
    # the slot layout: one max_len slab row per slot, greedy, gathered
    eng = Engine(model, **SERVE_GEO, kv_layout="slot")
    t0 = time.perf_counter()
    hs = staggered(eng, prompts, 32)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st = eng.stats()
    out["slot_layout"] = dict(wall_s=wall, decode_steps=st["decode_steps"],
                              kv_cache_bytes=st["kv_cache_bytes"],
                              ledger=ledger(hs))
    log(f"  slot layout, greedy: wall {wall:.2f} s, decode steps "
        f"{st['decode_steps']}, slabs {st['kv_cache_bytes'] / 2**30:.2f} GiB")
    if not all(h.finished and len(h.tokens) == 32 for h in hs) \
            or eng.cache.n_free != eng.n_slots:
        raise AssertionError("the slot engine did not finish every request")
    del eng, hs
    torch.cuda.empty_cache()
    return launches, out


# ---------------------------------------------------------------------------
# phase 10: PTQ Llama-2-7B
# ---------------------------------------------------------------------------

def forward_ms(model, ids, reps=5):
    """Median time of ``model(ids)`` under inference_mode: CUDA events
    around each forward (host syncs inside it included), after a
    warm-up."""
    times = []
    with torch.inference_mode():
        model(ids)
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            model(ids)
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
    return float(np.median(times))


def weight_bytes(model):
    return sum(t.numel() * t.element_size()
               for t in list(model.parameters()) + list(model.buffers()))


def phase_ptq(model, fa, im, sr, tq):
    """PTQ of phase 4's bf16 Llama-2-7B (32 layers) through the public
    entry point, then the quantized forward (see the module docstring).
    Returns (launches of the quantized forward, launches of the
    stochastic quantizers, printed numbers)."""
    V = model.config.vocab_size
    rng = np.random.default_rng(10)
    ids = torch.from_numpy(rng.integers(0, V, (1, 512))).cuda()
    calib = [torch.from_numpy(rng.integers(0, V, (1, 512))).cuda()
             for _ in range(2)]
    w_ffn = model.llama.layers[0].mlp.gate_proj.weight.detach().float()
    with torch.inference_mode():
        logits_bf16 = model(ids).float()
    bf16_ms = forward_ms(model, ids)
    bf16_bytes = weight_bytes(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ptq = tq.PostTrainingQuantization(model, algo="abs_max")
    ptq.quantize(calib)
    torch.cuda.synchronize()
    ptq_s = time.perf_counter() - t0
    n_int8 = sum(isinstance(m, tq.Int8Linear) for m in model.modules())
    log(f"  PostTrainingQuantization(abs_max) on 2 x [1, 512]: {n_int8} "
        f"Int8Linear, {len(ptq.activation_ranges)} activation ranges, "
        f"{ptq_s:.1f} s")
    if n_int8 != 7 * model.config.num_hidden_layers + 1:
        raise AssertionError(f"{n_int8} Int8Linear after PTQ")
    torch.cuda.empty_cache()
    int8_bytes = weight_bytes(model)
    with torch.inference_mode():
        model(ids)                               # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts(im.int8_matmul_rescale)
        reset_counts(fa.flash_attention)
        reads = tq.act_scale_reads
        logits = model(ids)
        reads = tq.act_scale_reads - reads
        torch.cuda.synchronize()
    launches = {"int8_matmul_rescale": im.int8_matmul_rescale.launches,
                "flash_attention_fwd": fa.flash_attention.launches}
    fwd_variants = dict(fa.flash_attention.launches_by_variant)
    int8_variants = dict(im.int8_matmul_rescale.launches_by_variant)
    peak = torch.cuda.max_memory_allocated()
    # the same forward with the int8 kernel's plain version swapped in
    kernel = im.int8_matmul_rescale
    im.int8_matmul_rescale = (
        lambda xq, xs, wq, ws, *, out_dtype=torch.bfloat16, **kw:
        im.int8_matmul_rescale_reference(xq, xs, wq, ws, out_dtype))
    try:
        with torch.inference_mode():
            logits_plain = model(ids)
        torch.cuda.synchronize()
    finally:
        im.int8_matmul_rescale = kernel
    same = same_bits(logits, logits_plain)
    int8_ms = forward_ms(model, ids)
    top1 = (logits.float().argmax(-1) == logits_bf16.argmax(-1)).float()
    out = dict(
        launches=launches, int8_variants=int8_variants,
        act_scale_host_reads=reads, logits=list(logits.shape),
        finite=bool(torch.isfinite(logits).all()),
        plain_int8_bit_identical=same,
        rel_err_vs_bf16=rel_err(logits, logits_bf16),
        top1_agreement_vs_bf16=top1.mean().item(),
        bf16_forward_ms=bf16_ms, int8_forward_ms=int8_ms,
        weight_bytes_bf16=bf16_bytes, weight_bytes_int8=int8_bytes,
        peak_gib_int8_forward=peak / 2**30, ptq_s=ptq_s)
    log(f"  quantized forward: launches {launches} (flash forward "
        f"{fwd_variants}, int8 {int8_variants}; act_scale host reads "
        f"{reads}), finite "
        f"{out['finite']}, bit-identical with the plain int8 version "
        f"{same}; rel err vs bf16 {out['rel_err_vs_bf16']:.4f}, top-1 "
        f"agreement {out['top1_agreement_vs_bf16']:.4f}; forward int8 "
        f"{int8_ms:.2f} ms vs bf16 {bf16_ms:.2f} ms; weights "
        f"{int8_bytes / 2**30:.2f} vs {bf16_bytes / 2**30:.2f} GiB; peak "
        f"{peak / 2**30:.2f} GiB")
    want = {"int8_matmul_rescale": n_int8,
            "flash_attention_fwd": model.config.num_hidden_layers}
    n = model.config.num_hidden_layers
    if (launches != want or fwd_variants != {"tc": n, "cuda_core": 0}
            or int8_variants != {"tc": n_int8, "mma_sync": 0}):
        raise AssertionError(f"quantized forward launched {launches} (flash "
                             f"forward {fwd_variants}, int8 "
                             f"{int8_variants}), want {want}, the flash "
                             f"forward and the int8 matmul all on the "
                             f"tensor cores")
    if reads != 0:
        raise AssertionError(f"the steady-state quantized forward read "
                             f"act_scale to the host {reads} times")
    if not (out["finite"] and same):
        raise AssertionError("quantized logits not finite, or not the plain "
                             "int8 version's")

    def fwd():
        with torch.inference_mode():
            model(ids)

    out["profile"] = prof = profile_step(fwd)
    out["int8_kernel_ms"] = sum(v for k, v in prof["port_kernels_ms"].items()
                                if "int8_" in k)
    log("  profiled quantized forward " + json.dumps(prof))
    log(f"  profiled quantized forward: device busy "
        f"{prof['device_busy_ms']:.2f} ms of {prof['step_wall_ms']:.2f} ms "
        f"wall (idle share {prof['device_idle_share']:.3f}), int8 kernel "
        f"{out['int8_kernel_ms']:.2f} ms over "
        f"{launches['int8_matmul_rescale']} launches")
    # the public stochastic quantizers on a 7B FFN weight (fp32 copy of
    # layer 0's gate_proj taken before PTQ)
    sr.stochastic_round_bf16.launches = 0
    sr.quantize_int8_stochastic.launches = 0
    r = tq.stochastic_round(w_ffn, seed=1)
    q, s = tq.quantize_int8_stochastic(w_ffn, seed=2)
    torch.cuda.synchronize()
    sr_launches = {"stochastic_round": sr.stochastic_round_bf16.launches,
                   "quantize_int8_stochastic":
                   sr.quantize_int8_stochastic.launches}
    held = (sr_rounding_stats(w_ffn, r.view(torch.int16).long() & 0xFFFF)[0]
            and q_rounding_stats(w_ffn, q, s)[0])
    log(f"  stochastic_round / quantize_int8_stochastic on a "
        f"{tuple(w_ffn.shape)} weight: launches {sr_launches}, outputs "
        f"bracket x / |q s - x| < s: {held}")
    if sr_launches != {"stochastic_round": 1, "quantize_int8_stochastic": 1} \
            or not held:
        raise AssertionError("the stochastic quantizers did not run their "
                             "kernels once each, or rounded wrongly")
    del logits, logits_plain, logits_bf16, w_ffn, r, q
    torch.cuda.empty_cache()
    return launches, sr_launches, out


# ---------------------------------------------------------------------------
# phase 7: timings
# ---------------------------------------------------------------------------

def phase_timings(fa, fd, fc, rm, im, sr, flush):
    TF = torch.nn.functional
    out = timings_decode(fd, flush)
    # flash attention at the forward's shape (L=512) and at L=2048; the
    # first version (the CUDA-core variant) beside the tensor-core one
    for L in (512, 2048):
        q, k, v = attn_case(1, L, L, 32, 32, 128, torch.bfloat16, seed=L)
        pairs = L * (L + 1) // 2
        flops = 4 * 32 * 128 * pairs
        byts = 4 * q.numel() * 2 + 32 * L * 4
        with forced_variant(fa, "cuda_core"):
            first = time_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                            flush, reps=5)
        out[f"flash_attention_fwd_L{L}"] = dict(
            first_version_ms=first,
            ms=time_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                       flush),
            plain_ms=time_ms(lambda: fa.flash_attention_reference(
                q, k, v, causal=True), flush, reps=5),
            library_ms=time_ms(lambda: TF.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True), flush),
            bound_ms=1e3 * max(byts / PEAK_BYTES, flops / PEAK_BF16_FLOPS),
            bound_by="bytes" if byts / PEAK_BYTES >= flops / PEAK_BF16_FLOPS
            else "operations",
            shape=f"B=1 L={L} H=32 D=128 causal bf16")
    out.update(timings_gpt_forward(fa, flush))
    out.update(timings_bwd(fa, flush))
    # GPT-2 small's training batch (phase 17): q/k/v views of the fused qkv
    out.update(timings_bwd(fa, flush, B=8, L=1024, H=12, D=64,
                           what="GPT-2 training", suffix="_gpt2_train"))
    out.update(timings_fused_ce(fc, flush))
    out.update(timings_ragged(rm, flush))
    # one expert-parallel rank's 4 of the 8 experts (phase 18, mp2)
    out.update(timings_ragged(rm, flush, E=MOE_E // EP_DEGREE, suffix="_ep"))
    out.update(timings_ernie_attention(fa, flush))
    # BERT-base's attention (phase 22b/22c): bench_bert's 16 x 512 batch
    out.update(timings_ernie_attention(fa, flush, B=16, L=512, H=12, D=64,
                                       suffix="_bert", seed=96))
    out.update(timings_int8(im, flush))
    out.update(timings_stochastic(sr, flush))
    for name, t in out.items():
        lib = "none" if t["library_ms"] is None else \
            f"{t['library_ms']:.4f} ms"
        first = (f" (first version {t['first_version_ms']:.4f} ms)"
                 if "first_version_ms" in t else "")
        log(f"  {name} [{t['shape']}]: kernel {t['ms']:.4f} ms{first}, plain "
            f"{t['plain_ms']:.4f} ms, library {lib}, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']})"
            + (f", _int_mm on the row-major wq "
               f"{t['int_mm_row_major_ms']}, bf16 x @ w_deq "
               f"{t['bf16_ms']:.4f} ms" if "bf16_ms" in t else ""))
    return out


def split_kernel_ptxas(_build):
    """ptxas' register, shared-memory and spill lines of the split-K
    decode kernel's instantiations, from the flash_decode build log."""
    lines, take = [], False
    for line in _build.build_log("flash_decode").splitlines():
        if "Compiling entry" in line:
            take = "split" in line
        if take and any(k in line for k in ("Compiling entry", "registers",
                                            "spill", "smem")):
            lines.append(line.strip())
    return lines


def timings_decode(fd, flush):
    """Flash decode at the Llama engine's shape (S=8, H=n_kv=32, hd=128,
    bs=16, bf16) with a 512-position table (the engine's ``max_len``) and
    a 4096-position one (``mb=256``), and at GPT-2 small's (H=n_kv=12,
    hd=64) with its engine's 512- and 1,024-position tables
    (``time_decode``)."""
    out = {}
    for tag, H, hd, mb, seed in (("", 32, 128, 32, 40),
                                 ("_T4096", 32, 128, 256, 41),
                                 ("_gpt2", 12, 64, 32, 42),
                                 ("_gpt2_T1024", 12, 64, 64, 43)):
        out["flash_decode" + tag] = time_decode(fd, flush, H, hd, mb, seed)
    torch.cuda.empty_cache()
    return out


def time_decode(fd, flush, H, hd, mb, seed, S=8, bs=16):
    """One decode shape (MHA, bf16): each pool holds ``S * mb`` blocks
    besides block 0, dealt to the slots without overlap, so no row is
    read twice. The split kernel, the first version (``"one_pass"``,
    median of 5), the plain version and SDPA on a pre-gathered view
    (never called by the port). Bound: each attended K/V row read once, q
    read and out written once, the tables and write positions; operations
    ``4 * positions * H * hd`` (bytes bound it)."""
    TF = torch.nn.functional
    q, kc, vc, tables, wp = decode_case(S, H, H, hd, bs, mb, S * mb + 1,
                                        torch.bfloat16, seed=seed)
    n_kv = kc.shape[2]
    keys = int((wp.long() + 1).sum())                   # attended positions
    byts = 2 * keys * n_kv * hd * 2 + 2 * q.numel() * 2 \
        + tables.numel() * 4 + S * 4
    T = mb * bs
    kview = kc[tables.long()].reshape(S, T, n_kv, hd).transpose(1, 2)
    vview = vc[tables.long()].reshape(S, T, n_kv, hd).transpose(1, 2)
    valid = (torch.arange(T, device="cuda")[None, :]
             <= wp[:, None])[:, None, None, :]

    def run():
        return fd.flash_decode(q, kc, vc, tables, wp)
    with forced_variant(fd, "one_pass"):
        first = time_ms(run, flush, reps=5)
    return dict(
        ms=time_ms(run, flush), variant=fd._variant(q, kc),
        first_version_ms=first,
        plain_ms=time_ms(lambda: fd.flash_decode_reference(
            q, kc, vc, tables, wp), flush, reps=5),
        library_ms=time_ms(lambda: TF.scaled_dot_product_attention(
            q[:, :, None], kview, vview, attn_mask=valid), flush),
        shape=f"S={S} H={H} n_kv={n_kv} hd={hd} bs={bs} bf16, {T}-position "
              f"table, {keys} positions, P={fd.split_plan(mb, bs)[0]}",
        **bound(byts, 4 * keys * H * hd))


def timings_gpt_forward(fa, flush):
    """The flash forward at GPT-2 small's scoring call: B=1, L=1024, H=12,
    D=64, causal, bf16, q/k/v the strided views of one fused projection
    (``gpt_qkv``), as the model hands them; yardsticks as at the Llama
    shapes."""
    TF = torch.nn.functional
    B, L, H, D = 1, 1024, 12, 64
    g = torch.Generator(device="cuda").manual_seed(96)
    q, k, v = gpt_qkv(torch.randn(B, L, 3 * H * D, generator=g,
                                  device="cuda").to(torch.bfloat16), H)
    pairs = B * H * L * (L + 1) // 2
    byts = 4 * B * L * H * D * 2 + B * H * L * 4          # q, k, v, out; lse
    with forced_variant(fa, "cuda_core"):
        first = time_ms(lambda: fa.flash_attention(q, k, v, causal=True),
                        flush, reps=5)
    out = dict(
        first_version_ms=first, variant=fa._variant(q, k, v),
        ms=time_ms(lambda: fa.flash_attention(q, k, v, causal=True), flush),
        plain_ms=time_ms(lambda: fa.flash_attention_reference(
            q, k, v, causal=True), flush, reps=5),
        library_ms=time_ms(lambda: TF.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True), flush),
        shape=f"B={B} L={L} H={H} D={D} causal bf16, q/k/v views of the "
              f"fused qkv",
        **bound(byts, 4 * D * pairs))
    del q, k, v
    torch.cuda.empty_cache()
    return {"flash_attention_fwd_gpt2": out}


class forced_variant:
    """``with forced_variant(module, "cuda_core"):`` makes the module's
    wrappers take that variant whatever the operands (phase 7 times the
    first version beside the new one in the same run); ``rule`` names the
    module's variant rule (``"_bwd_variant"`` for the flash backward)."""

    def __init__(self, module, variant, rule="_variant"):
        self.module, self.variant, self.rule = module, variant, rule

    def __enter__(self):
        self.saved = getattr(self.module, self.rule)
        setattr(self.module, self.rule, lambda *a: self.variant)

    def __exit__(self, *exc):
        setattr(self.module, self.rule, self.saved)


def bound(byts, flops, peak_ops=PEAK_BF16_FLOPS):
    """The least time the card could take: bytes over the memory rate or
    operations over the tensor-core rate (bf16 unless ``peak_ops`` says
    otherwise), whichever is longer."""
    b, f = byts / PEAK_BYTES, flops / peak_ops
    return dict(bound_ms=1e3 * max(b, f),
                bound_by="bytes" if b >= f else "operations")


def timings_int8(im, flush):
    """The int8 kernel at the 7B shapes (M=512: q/k/v/o, up, down, head)
    and bench.py's (M=256, K=N=8192), bf16 out: the tensor-core variant on
    the K-major wq the main path gives it, and in the same run the first
    version (``"mma_sync"``) on the row-major wq it ran on before.
    Yardsticks: ``torch._int_mm`` (cuBLASLt int8 -> int32, no scale
    epilogue; never called by the port) on the same K-major operand and on
    the row-major one, and the bf16 product with the dequantized weight
    ``x @ w_deq`` (what the dequant route runs, w_deq made beforehand).
    Bound: 1979e12 int8 OP/s; bytes xq, wq, both scales, the bf16 out."""
    out = {}
    for name, M, K, N in INT8_SHAPES + (("bench", 256, 8192, 8192),):
        xq, xs, wq, ws = int8_case(M, K, N, seed=K * 3 + N)
        wk = k_major(wq)
        xb = (xq.float() * xs).to(torch.bfloat16)
        wd = (wq.float() * ws).to(torch.bfloat16)
        try:
            lib = time_ms(lambda: torch._int_mm(xq, wk), flush)
            lib_row = time_ms(lambda: torch._int_mm(xq, wq), flush)
        except RuntimeError as e:             # a yardstick only
            log(f"  torch._int_mm at M={M} K={K} N={N}: {e}")
            lib = lib_row = None
        with forced_variant(im, "mma_sync"):
            first = time_ms(lambda: im.int8_matmul_rescale(xq, xs, wq, ws),
                            flush)
        out[f"int8_matmul_rescale_{name}"] = dict(
            ms=time_ms(lambda: im.int8_matmul_rescale(xq, xs, wk, ws),
                       flush),
            variant=im._variant(xq, wk), first_version_ms=first,
            plain_ms=time_ms(lambda: im.int8_matmul_rescale_reference(
                xq, xs, wk, ws), flush, reps=5),
            library_ms=lib, int_mm_row_major_ms=lib_row,
            bf16_ms=time_ms(lambda: xb @ wd, flush),
            shape=f"M={M} K={K} N={N} int8 -> bf16",
            **bound(M * K + K * N + 4 * (M + N) + 2 * M * N, 2 * M * K * N,
                    PEAK_INT8_OPS))
        del xq, xs, wq, ws, wk, xb, wd
    torch.cuda.empty_cache()
    return out


def timings_stochastic(sr, flush):
    """The two stochastic kernels at bench.py's 256 x 256 and at a 7B FFN
    weight (4096 x 11008), fp32 in. No single PyTorch call computes either
    function (library none). ``stochastic_round``'s bound is in bytes, its
    input read once: 4 B in + 2 B (bf16) out per element.
    ``quantize_int8_stochastic`` must read x twice -- pass 1 its abs-max
    across the whole tensor, pass 2 the rounding, which needs the scale
    the whole tensor gives; at 4096 x 11008 x is 180 MB, more than the 50
    MB L2, so the second read comes from device memory too -- and write 1
    B per element and the 4 B scale: 9 B per element. Its threefry words
    cost ~35 32-bit integer operations per element (~70 per pair, the note
    at the top of ``csrc/stochastic_round.cu``), against the SMs' integer
    issue rate, ``PEAK_INT32_OPS``. The bound is the larger of the two."""
    out = {}
    for R, C in SR_SHAPES:
        x = torch.randn(R, C, device="cuda")
        n = x.numel()
        tag = "" if (R, C) == SR_SHAPES[-1] else "_small"
        out["stochastic_round" + tag] = dict(
            ms=time_ms(lambda: sr.stochastic_round_bf16(x, 1), flush),
            plain_ms=time_ms(lambda: sr.stochastic_round_bf16_reference(
                x, sr.random_bits(1, n, device="cuda")), flush, reps=5),
            library_ms=None, shape=f"{R}x{C} fp32 -> bf16",
            **bound(6 * n, 0))
        out["quantize_int8_stochastic" + tag] = dict(
            ms=time_ms(lambda: sr.quantize_int8_stochastic(x, 1), flush),
            plain_ms=time_ms(lambda: sr.quantize_int8_stochastic_reference(
                x, sr.random_bits(1, n, device="cuda")), flush, reps=5),
            library_ms=None, shape=f"{R}x{C} fp32 -> int8",
            **bound(9 * n + 4, 35 * n, PEAK_INT32_OPS))
        del x
    torch.cuda.empty_cache()
    return out


def timings_bwd(fa, flush, B=2, L=2048, H=32, D=128, what="trainer",
                suffix=""):
    """The backward kernels at the trainer's attention shape (B=2, L=2048,
    H=32, D=128, causal, bf16; or another, its q/k/v made by
    ``fwd_inputs(what, ...)``: at GPT-2's training batch, views of the
    fused qkv), the first (CUDA-core) versions beside the tensor-core
    ones. Yardstick: the backward of TF.scaled_dot_product_attention (dq,
    dk and dv together), timed alone through autograd.grad on a retained
    graph."""
    TF = torch.nn.functional
    q, k, v = fwd_inputs(what, B, L, L, H, H, D, torch.bfloat16, seed=91)
    do = attn_case(B, L, L, H, H, D, torch.bfloat16, seed=92)[0]
    out, lse = fa.flash_attention(q, k, v, causal=True)
    delta = fa.attention_delta(out, do)
    leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    o = TF.scaled_dot_product_attention(*leaves, is_causal=True)
    dot = do.transpose(1, 2)
    lib = time_ms(lambda: torch.autograd.grad(o, leaves, dot,
                                              retain_graph=True), flush)
    pairs = B * H * L * (L + 1) // 2
    elems = B * L * H * D
    reads = 4 * elems * 2 + 2 * B * H * L * 4      # q, k, v, dO; lse, delta
    shape = f"B={B} L={L} H={H} D={D} causal bf16" + (
        ", q/k/v views of the fused qkv" if what.startswith("GPT-2") else "")
    _, took = launched_variant(fa.flash_attention_bwd_dq,
                               lambda: fa.flash_attention_bwd_dq(
                                   q, k, v, do, lse, delta, True))
    with forced_variant(fa, "cuda_core", "_bwd_variant"):
        first = [time_ms(lambda: fa.flash_attention_bwd_dq(
                     q, k, v, do, lse, delta, True), flush, reps=5),
                 time_ms(lambda: fa.flash_attention_bwd_dkv(
                     q, k, v, do, lse, delta, True), flush, reps=5)]
    res = {
        "flash_attention_bwd_dq": dict(
            first_version_ms=first[0],
            ms=time_ms(lambda: fa.flash_attention_bwd_dq(
                q, k, v, do, lse, delta, True), flush),
            plain_ms=time_ms(lambda: fa.flash_attention_bwd_dq_reference(
                q, k, v, do, lse, delta, True), flush, reps=5),
            library_ms=lib, shape=shape,
            **bound(reads + elems * 2, 6 * D * pairs)),
        "flash_attention_bwd_dkv": dict(
            first_version_ms=first[1],
            ms=time_ms(lambda: fa.flash_attention_bwd_dkv(
                q, k, v, do, lse, delta, True), flush),
            plain_ms=time_ms(lambda: fa.flash_attention_bwd_dkv_reference(
                q, k, v, do, lse, delta, True), flush, reps=5),
            library_ms=lib, shape=shape,
            **bound(reads + 2 * elems * 2, 8 * D * pairs)),
    }
    del q, k, v, do, out, lse, delta, leaves, o
    torch.cuda.empty_cache()
    return {k + suffix: dict(t, variant=took) for k, t in res.items()}


def timings_fused_ce(fc, flush):
    """The fused-CE kernel at the trainer's head (N = 2 x 2047 rows,
    H=4096, V=32000, bf16). Yardstick: the dense
    TF.cross_entropy((h @ w).float(), labels)."""
    TF = torch.nn.functional
    N, H, V = 4094, 4096, 32000
    h, w, lab = ce_case(N, H, V, torch.bfloat16, seed=93)
    with forced_variant(fc, "cuda_core"):
        first = time_ms(lambda: fc.fused_ce_stats(h, w, lab), flush, reps=5)
    return {"fused_ce_stats": dict(
        first_version_ms=first,
        ms=time_ms(lambda: fc.fused_ce_stats(h, w, lab), flush),
        plain_ms=time_ms(lambda: fc.fused_ce_stats_reference(h, w, lab),
                         flush, reps=5),
        library_ms=time_ms(lambda: TF.cross_entropy((h @ w).float(), lab),
                           flush),
        shape=f"N={N} H={H} V={V} bf16",
        **bound(N * H * 2 + H * V * 2 + N * 8 + 3 * N * 4, 2 * N * H * V))}


def timings_ragged(rm, flush, E=MOE_E, suffix=""):
    """The ragged kernel at the MoE expert shapes (bench.py's
    ``_bench_moe_ragged_kernel``: E=8, C=2560, bf16, counts [C, C/2] x 4;
    or E=4, one expert-parallel rank's share at mp2, phase 18),
    up (K=1024, N=4096), down (K=4096, N=1024) and the backward's dx of
    the up projection (dy [E, C, 4096] @ w_up^T, w read through the
    strides of the transposed view), each on the variant the main path
    takes (``variant``) and, in the same run, on the first bf16 kernel
    (``first_version_ms``, the ``"mma_sync"`` variant). Yardstick: the
    masked ``torch.bmm`` over the full capacity (what
    ``expert_kernel="einsum"`` runs). The bound counts this run's data:
    the live rows' products and x rows, all of w, all of out (zeros
    included) and counts."""
    C = MOE_C
    counts = [C if e % 2 == 0 else C // 2 for e in range(E)]
    rows = sum(counts)
    out = {}
    for name, K, N in (("up", MOE_D, MOE_F), ("down", MOE_F, MOE_D),
                       ("dx", MOE_F, MOE_D)):
        x, w, cnt = ragged_case(E, C, K, N, counts, torch.bfloat16, seed=K)
        if name == "dx":
            w = w.reshape(E, N, K).transpose(1, 2)
        x = x * (torch.arange(C, device="cuda")[None, :]
                 < cnt.long()[:, None])[..., None].to(x.dtype)
        _, variant = launched_variant(
            rm.ragged_group_matmul, lambda: rm.ragged_group_matmul(x, w, cnt))
        with forced_variant(rm, "mma_sync"):
            first = time_ms(lambda: rm.ragged_group_matmul(x, w, cnt), flush,
                            reps=5)
        out[f"ragged_group_matmul_{name}{suffix}"] = dict(
            variant=variant,
            first_version_ms=first,
            ms=time_ms(lambda: rm.ragged_group_matmul(x, w, cnt), flush),
            plain_ms=time_ms(lambda: rm.ragged_group_matmul_reference(
                x, w, cnt), flush, reps=5),
            library_ms=time_ms(lambda: torch.bmm(x, w), flush),
            shape=f"E={E} C={C} K={K} N={N} bf16, {rows} live rows"
                  + (", w^T strided" if name == "dx" else ""),
            **bound(rows * K * 2 + E * K * N * 2 + E * C * N * 2 + E * 4,
                    2 * rows * K * N))
        del x, w, cnt
    torch.cuda.empty_cache()
    return out


def timings_ernie_attention(fa, flush, B=8, L=1024, H=16, D=64,
                            suffix="_ernie", seed=94):
    """The flash forward, dq and dk/dv kernels at ERNIE-MoE's attention
    shape (B=8, L=1024, H=16, D=64, non-causal, bf16), or at another
    non-causal shape (BERT-base's: B=16, L=512, H=12, D=64, ``suffix``
    "_bert"); yardsticks as at the Llama shapes (SDPA forward; SDPA's
    whole backward)."""
    TF = torch.nn.functional
    q, k, v = attn_case(B, L, L, H, H, D, torch.bfloat16, seed=seed)
    do = attn_case(B, L, L, H, H, D, torch.bfloat16, seed=seed + 1)[0]
    out, lse = fa.flash_attention(q, k, v, causal=False)
    delta = fa.attention_delta(out, do)
    leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    o = TF.scaled_dot_product_attention(*leaves)
    lib_bwd = time_ms(lambda: torch.autograd.grad(o, leaves,
                                                  do.transpose(1, 2),
                                                  retain_graph=True), flush)
    pairs = B * H * L * L
    elems = B * L * H * D
    reads = 4 * elems * 2 + 2 * B * H * L * 4      # q, k, v, dO; lse, delta
    shape = f"B={B} L={L} H={H} D={D} non-causal bf16"
    with forced_variant(fa, "cuda_core"):
        first = time_ms(lambda: fa.flash_attention(q, k, v), flush, reps=5)
    with forced_variant(fa, "cuda_core", "_bwd_variant"):
        first_dq = time_ms(lambda: fa.flash_attention_bwd_dq(
            q, k, v, do, lse, delta, False), flush, reps=5)
        first_dkv = time_ms(lambda: fa.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, False), flush, reps=5)
    res = {
        "flash_attention_fwd": dict(
            first_version_ms=first,
            ms=time_ms(lambda: fa.flash_attention(q, k, v), flush),
            plain_ms=time_ms(lambda: fa.flash_attention_reference(q, k, v),
                             flush, reps=5),
            library_ms=time_ms(lambda: TF.scaled_dot_product_attention(
                *(x.transpose(1, 2) for x in (q, k, v))), flush),
            shape=shape, **bound(4 * elems * 2 + B * H * L * 4,
                                 4 * D * pairs)),
        "flash_attention_bwd_dq": dict(
            first_version_ms=first_dq,
            ms=time_ms(lambda: fa.flash_attention_bwd_dq(
                q, k, v, do, lse, delta, False), flush),
            plain_ms=time_ms(lambda: fa.flash_attention_bwd_dq_reference(
                q, k, v, do, lse, delta, False), flush, reps=5),
            library_ms=lib_bwd, shape=shape,
            **bound(reads + elems * 2, 6 * D * pairs)),
        "flash_attention_bwd_dkv": dict(
            first_version_ms=first_dkv,
            ms=time_ms(lambda: fa.flash_attention_bwd_dkv(
                q, k, v, do, lse, delta, False), flush),
            plain_ms=time_ms(lambda: fa.flash_attention_bwd_dkv_reference(
                q, k, v, do, lse, delta, False), flush, reps=5),
            library_ms=lib_bwd, shape=shape,
            **bound(reads + 2 * elems * 2, 8 * D * pairs)),
    }
    del q, k, v, do, out, lse, delta, leaves, o
    torch.cuda.empty_cache()
    return {k + suffix: t for k, t in res.items()}


# ---------------------------------------------------------------------------
# phase 8: training
# ---------------------------------------------------------------------------

def _counters(fa, fc, rm):
    """Each kernel wrapper of the training paths, by kernel name."""
    return dict(flash_attention_fwd=fa.flash_attention,
                flash_attention_bwd_dq=fa.flash_attention_bwd_dq,
                flash_attention_bwd_dkv=fa.flash_attention_bwd_dkv,
                fused_ce_stats=fc.fused_ce_stats,
                ragged_group_matmul=rm.ragged_group_matmul)


def _counts(fa, fc, rm):
    """Launches per kernel, and for the kernels with variants the launches
    that took the tensor cores (``<name>_tc``)."""
    out = {k: f.launches for k, f in _counters(fa, fc, rm).items()}
    for name, f in _counters(fa, fc, rm).items():
        if hasattr(f, "launches_by_variant"):
            out[name + "_tc"] = f.launches_by_variant["tc"]
    return out


def _reset(fa, fc, rm):
    for f in _counters(fa, fc, rm).values():
        reset_counts(f)


# the port's own kernels (csrc/*.cu), by their function names
PORT_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "flash_decode",
                "fused_ce_stats", "merge_splits", "ragged_tc", "ragged_mma",
                "ragged_fma", "int8_tc", "int8_mma", "absmax_kernel",
                "quant_sr", "sr_bf16")


def profile_step(step, *batch):
    """One train step under torch.profiler: device busy vs wall, the top
    device kernels by time, and the device time of each of the port's own
    kernels (``port_kernels_ms``, by kernel, whatever its rank)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(*batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, launches = {}, 0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels[e.key] = kernels.get(e.key, 0.0) + e.self_device_time_total
            launches += e.count
    busy_ms = sum(kernels.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    return {"step_wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / (wall * 1e3)),
            "device_kernel_launches": launches,
            "top_kernels_ms": {k: v / 1e3 for k, v in top},
            "port_kernels_ms": {k: v / 1e3 for k, v in kernels.items()
                                if any(p in k for p in PORT_KERNELS)}}


def llama_trainer(LlamaForCausalLM, cfg, fleet, optimizer, seed,
                  device="cuda"):
    """Phase 8's trainer: random weights from seed 0 (bf16), placed by
    ``fleet.distributed_model`` on the current mesh, and
    ``fleet.distributed_optimizer(AdamW(lr=1e-4, wd=0.01,
    multi_precision)).make_train_step``."""
    seed(0)
    model = fleet.distributed_model(LlamaForCausalLM(cfg, device=device))
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        learning_rate=1e-4, weight_decay=0.01,
        parameters=model.parameters()))
    return model, opt.make_train_step(model, lambda m, x, y: m(x, labels=y))


def train_ids(vocab, B, L, device="cuda"):
    """Phase 8's batch: one repeated B x L batch of seeded random ids (the
    labels are the ids)."""
    return torch.from_numpy(np.random.default_rng(3).integers(
        0, vocab, (B, L))).to(device)


def run_steps(fa, fc, rm, step, ids, n, tag="", warm_up=True, labels=None):
    """``n`` steps on ``ids`` (the labels too, unless ``labels`` are
    given): (losses, seconds, launches per step); each step's counts are
    reset before it and read after it."""
    losses, secs, per_step = [], [], []
    labels = ids if labels is None else labels
    for i in range(n):
        _reset(fa, fc, rm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(ids, labels)))  # reads the loss: a sync
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per_step.append(_counts(fa, fc, rm))
        log(f"  {tag}step {i}{' (warm-up)' if warm_up and i == 0 else ''}: "
            f"loss {losses[-1]:.6f}, {secs[-1] * 1e3:.1f} ms, launches "
            f"{per_step[-1]}")
    return losses, secs, per_step


def want_train_launches(layers):
    """The launches of one Llama train step: the flash forward, dq and
    dk/dv once per layer, the fused CE once, all on the tensor cores."""
    want = dict(flash_attention_fwd=layers, flash_attention_bwd_dq=layers,
                flash_attention_bwd_dkv=layers, fused_ce_stats=1,
                ragged_group_matmul=0)
    want.update({k + "_tc": v for k, v in list(want.items())})
    return want


PHASE8_LAYERS, PHASE8_BATCH = 8, (2, 2048)


def phase_train(fa, fc, rm, LlamaForCausalLM, LLAMA2_7B, fleet, optimizer,
                seed, layers=PHASE8_LAYERS, batch=PHASE8_BATCH):
    cfg = dataclasses.replace(LLAMA2_7B, num_hidden_layers=layers,
                              fused_ce_chunk=8192)
    B, L = batch
    model, step = llama_trainer(LlamaForCausalLM, cfg, fleet, optimizer,
                                seed)
    n_params = sum(p.numel() for p in model.parameters())
    ids = train_ids(cfg.vocab_size, B, L)
    log(f"  {cfg.num_hidden_layers} layers of Llama-2-7B width, "
        f"{n_params / 1e9:.3f}e9 params, batch {B} x {L}, AdamW(lr=1e-4, "
        f"wd=0.01, multi_precision), fused_ce_chunk={cfg.fused_ce_chunk}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = want_train_launches(cfg.num_hidden_layers)
    # warm-up + 3 timed steps
    losses, secs, per_step = run_steps(fa, fc, rm, step, ids, 4)
    peak = torch.cuda.max_memory_allocated()
    timed = secs[1:]
    step_s = float(np.median(timed))
    log(f"  step time median {step_s * 1e3:.1f} ms over 3 (min "
        f"{min(timed) * 1e3:.1f}, max {max(timed) * 1e3:.1f}), "
        f"{B * L / step_s:.1f} tokens/s, peak memory {peak / 2**30:.2f} GiB")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if abs(losses[0] - np.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"first loss {losses[0]} not within 1.0 of "
                             f"ln({cfg.vocab_size})")
    if not losses[1] > losses[2] > losses[3]:
        raise AssertionError(f"loss does not fall across the timed steps: "
                             f"{losses[1:]}")
    for i, c in enumerate(per_step):
        if c != want:
            raise AssertionError(f"step {i} launched {c}, want {want}")
    prof = profile_step(step, ids, ids)
    log("  profiled step " + json.dumps(prof))
    if prof["device_busy_ms"] <= 0:
        log("  (the profiler saw no device time: device busy not measured)")
    del step, model
    torch.cuda.empty_cache()
    return per_step[1], dict(losses=losses, step_ms=step_s * 1e3,
                             step_secs=secs, tokens_per_s=B * L / step_s,
                             peak_gib=peak / 2**30, launches=per_step)


# ---------------------------------------------------------------------------
# phase 9: ERNIE-MoE training
# ---------------------------------------------------------------------------

def phase_ernie(fa, fc, rm, ErnieMoEConfig, ErnieMoEForPretraining, fleet,
                optimizer, seed):
    """bench.py's ERNIE-MoE configuration, nothing cut (318M parameters,
    bf16): every MoE layer on sparse dispatch (auto picks it here) with
    the ragged expert kernel; AdamW(lr=1e-4); one repeated 8 x 1024 batch
    of random ids and labels; dropout 0.1 as configured."""
    cfg = ErnieMoEConfig(**ERNIE_MOE)
    B, L = ERNIE_BATCH
    seed(0)
    model = fleet.distributed_model(ErnieMoEForPretraining(cfg,
                                                           device="cuda"))
    moes = model.moe_layers()
    for m in moes:
        m.expert_kernel = "ragged"
    modes = [m.resolve_dispatch(B * L) for m in moes]
    C = moes[0].gate.capacity(B * L)
    log(f"  {cfg.num_hidden_layers} layers ({len(moes)} MoE, {cfg.num_experts}"
        f" experts, top-{cfg.top_k}, capacity {C}), "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M params, "
        f"batch {B} x {L}, dispatch {modes} (S*E*C = "
        f"{B * L * cfg.num_experts * C:,} vs limit "
        f"{moes[0].DENSE_DISPATCH_LIMIT:,}), AdamW(lr=1e-4), dropout "
        f"{cfg.dropout}")
    if modes != ["sparse"] * len(moes):
        raise AssertionError(f"auto dispatch did not pick sparse: {modes}")
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        learning_rate=1e-4, parameters=model.parameters()))
    step = opt.make_train_step(model, lambda m, x, y: m(x, labels=y))
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, L))).cuda()
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (B, L))).cuda()
    n = cfg.num_hidden_layers
    want = dict(flash_attention_fwd=n, flash_attention_bwd_dq=n,
                flash_attention_bwd_dkv=n, fused_ce_stats=0,
                ragged_group_matmul=4 * len(moes),    # 2 forward + 2 dx
                flash_attention_fwd_tc=n, flash_attention_bwd_dq_tc=n,
                flash_attention_bwd_dkv_tc=n, fused_ce_stats_tc=0,
                ragged_group_matmul_tc=4 * len(moes))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, secs, per_step = [], [], []
    for i in range(4):                          # warm-up + 3 timed steps
        _reset(fa, fc, rm)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(ids, labels)))   # reads the loss: a sync
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per_step.append(_counts(fa, fc, rm))
        log(f"  step {i}{' (warm-up)' if i == 0 else ''}: loss "
            f"{losses[-1]:.6f}, {secs[-1] * 1e3:.1f} ms, launches "
            f"{per_step[-1]}")
    peak = torch.cuda.max_memory_allocated()
    timed = secs[1:]
    step_s = float(np.median(timed))
    log(f"  step time median {step_s * 1e3:.1f} ms over 3 (min "
        f"{min(timed) * 1e3:.1f}, max {max(timed) * 1e3:.1f}), "
        f"{B * L / step_s:.1f} tokens/s, peak memory {peak / 2**30:.2f} GiB")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"non-finite loss: {losses}")
    if abs(losses[0] - np.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"first loss {losses[0]} not within 1.0 of "
                             f"ln({cfg.vocab_size})")
    if not losses[3] < losses[1]:
        raise AssertionError(f"the last timed loss is not below the first: "
                             f"{losses[1:]}")
    for i, c in enumerate(per_step):
        if c != want:
            raise AssertionError(f"step {i} launched {c}, want {want}")
    prof = profile_step(step, ids, labels)
    log("  profiled step " + json.dumps(prof))
    if prof["device_busy_ms"] <= 0:
        log("  (the profiler saw no device time: device busy not measured)")
    del step, opt, model
    torch.cuda.empty_cache()
    return per_step[1], dict(losses=losses, step_ms=step_s * 1e3,
                             tokens_per_s=B * L / step_s,
                             peak_gib=peak / 2**30, profile=prof)


# ---------------------------------------------------------------------------
# phase 12: hybrid Fleet training
# ---------------------------------------------------------------------------

PAIR_LAYERS = 4         # 12b's depth cut: two ranks' gloo traffic is staged
                        # through the host, so 7B width at 4 layers, not 8
PAIR_CONFIGS = {"mp2": dict(mp_degree=2),
                "sharding2_stage3": dict(sharding_degree=2, stage=3)}
# the collectives each 12b configuration runs, as gloo_probe names them
PAIR_NEEDS = {"mp2": ("all_reduce_sum_bf16", "all_reduce_sum_fp32",
                      "all_reduce_max_fp32"),
              "sharding2_stage3": ("all_gather_bf16", "reduce_scatter_bf16",
                                   "all_reduce_sum_fp32")}
PAIR_REL_TOL = 1e-2     # bf16 training, other reduction orders


def save_weights(workdir, model):
    """Every parameter of ``model`` as ``<name>.npy`` (float32)."""
    for k, v in model.state_dict().items():
        np.save(os.path.join(workdir, k + ".npy"),
                v.detach().float().cpu().numpy())


def saved_weights(workdir):
    """The arrays ``save_weights`` wrote: name -> array (memory-mapped)."""
    return {f[:-4]: np.load(os.path.join(workdir, f), mmap_mode="r")
            for f in os.listdir(workdir) if f.endswith(".npy")}


def _strategy(fleet, mp_degree=1, sharding_degree=1, stage=0):
    s = fleet.DistributedStrategy()
    s.hybrid_configs.update(mp_degree=mp_degree,
                            sharding_degree=sharding_degree)
    s.sharding = stage > 0
    s.sharding_configs["sharding_stage"] = stage
    return s


def _world1_run(fa, fc, rm, LlamaForCausalLM, cfg, fleet, optimizer, seed,
                batch, dist):
    """Phase 8's run on a world of one over NCCL (spawn's environment),
    sharding stage 3, sharding and mp degrees 1."""
    dist.init_parallel_env()                     # NCCL on cuda:0
    try:
        fleet.init(is_collective=True,
                   strategy=_strategy(fleet, stage=3))
        model, step = llama_trainer(LlamaForCausalLM, cfg, fleet, optimizer,
                                    seed)
        ids = train_ids(cfg.vocab_size, *batch)
        torch.cuda.synchronize()
        losses, secs, per_step = run_steps(fa, fc, rm, step, ids, 4,
                                           tag="hybrid, world 1: ")
        out = dict(backend=torch.distributed.get_backend(),
                   world_size=dist.get_world_size(),
                   stage=step.stage, losses=losses, step_secs=secs,
                   launches=per_step)
        del step, model
    finally:
        dist.destroy_process_group()
        fleet.init()                # the default strategy and mesh again
    torch.cuda.empty_cache()
    return out


def phase_hybrid_world1(fa, fc, rm, LlamaForCausalLM, LLAMA2_7B, fleet,
                        optimizer, seed, train, layers=PHASE8_LAYERS,
                        batch=PHASE8_BATCH):
    """12a: phase 8's configuration through ``spawn(nprocs=1)``: a world of
    one over NCCL, ``sharding_stage=3``, sharding and mp degrees 1. Every
    collective is the identity there, so the losses must equal phase 8's
    bit for bit and the launches per step phase 8's; the step time beside
    phase 8's is the hybrid path's own overhead."""
    from paddle_tpu_torch import distributed as dist
    cfg = dataclasses.replace(LLAMA2_7B, num_hidden_layers=layers,
                              fused_ce_chunk=8192)
    out = dist.spawn(_world1_run, args=(fa, fc, rm, LlamaForCausalLM, cfg,
                                        fleet, optimizer, seed, batch, dist),
                     nprocs=1)
    if out["backend"] != "nccl" or out["world_size"] != 1:
        raise AssertionError(f"12a ran on {out['backend']}, world "
                             f"{out['world_size']}")
    if out["losses"] != train["losses"]:
        raise AssertionError(f"12a losses {out['losses']} differ from "
                             f"phase 8's {train['losses']}")
    if out["launches"] != train["launches"]:
        raise AssertionError(f"12a launched {out['launches']}, phase 8 "
                             f"{train['launches']}")
    step_ms = float(np.median(out["step_secs"][1:])) * 1e3
    out.update(step_ms=step_ms, phase8_step_ms=train["step_ms"],
               overhead_ms=step_ms - train["step_ms"])
    log(f"  12a: losses equal phase 8's bit for bit, launches per step "
        f"equal; step time median {step_ms:.1f} ms vs phase 8's "
        f"{train['step_ms']:.1f} ms")
    return out


def gloo_probe(dist):
    """Which collectives gloo carries between this world's ranks on CUDA
    tensors: ``{name: "ok" or the error}``, each checked for its
    values."""
    from paddle_tpu_torch.distributed import collective as C
    world = C.get_group()
    n, r = world.nranks, world.rank
    out = {}
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        x = torch.full((2 * n, 8), float(r + 1), dtype=dt, device="cuda")
        total = n * (n + 1) / 2
        cases = {
            "all_reduce_sum": (lambda: C.all_reduce(x.clone()),
                               lambda y: bool((y == total).all())),
            "all_reduce_max": (lambda: C.all_reduce(x.clone(),
                                                    C.ReduceOp.MAX),
                               lambda y: bool((y == n).all())),
            "all_gather": (lambda: C.gather_dim(x, 0, world),
                           lambda y: y.shape[0] == 2 * n * n and all(
                               bool((y[2 * n * i:2 * n * (i + 1)] == i + 1)
                                    .all()) for i in range(n))),
            "reduce_scatter": (lambda: C.reduce_scatter_dim(x, 0, world),
                               lambda y: y.shape[0] == 2
                               and bool((y == total).all())),
            "broadcast": (lambda: C.broadcast(x.clone(), src=0),
                          lambda y: bool((y == 1).all())),
        }
        for name, (run, ok) in cases.items():
            key = f"{name}_{tag}"
            try:
                y = run()
                torch.cuda.synchronize()
                out[key] = "ok" if ok(y) else "wrong values"
            except RuntimeError as e:
                out[key] = f"{type(e).__name__}: {str(e)[:160]}"
    return out


def _pair_worker(workdir, cfg, steps):
    """One of 12b's two ranks on cuda:0 (gloo): the probe, then each
    configuration the probe allows, from the saved weights and batch."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework.io import load_numpy_state_dict
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_ce as fc
    from paddle_tpu_torch.ops import ragged_matmul as rm
    from paddle_tpu_torch.text.models.llama import LlamaForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env(backend="gloo", device="cuda:0", timeout=600)
    rank = dist.get_rank()
    out = dict(rank=rank, backend=torch.distributed.get_backend(),
               torch=torch.__version__, probe=gloo_probe(dist), configs={})
    with np.load(os.path.join(workdir, "batch.npz")) as z:
        ids = torch.from_numpy(z["ids"]).cuda()
    for name, kw in PAIR_CONFIGS.items():
        missing = [op for op in PAIR_NEEDS[name] if out["probe"][op] != "ok"]
        if missing:
            out["configs"][name] = dict(left_out=missing)
            continue
        fleet.init(is_collective=True, strategy=_strategy(fleet, **kw))
        model, step = llama_trainer(LlamaForCausalLM, cfg, fleet, optimizer,
                                    pt.seed)
        load_numpy_state_dict(model, saved_weights(workdir))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, secs, per_step = run_steps(
            fa, fc, rm, step, ids, steps, tag=f"[rank {rank}, {name}] ",
            warm_up=False)
        out["configs"][name] = dict(
            losses=losses, step_secs=secs, launches=per_step,
            ce_columns=list(fc.fused_ce_stats.last_columns),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del step, model
        torch.cuda.empty_cache()
    with open(os.path.join(workdir, f"pair.r{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def phase_hybrid_pair(fa, fc, rm, LlamaForCausalLM, LLAMA2_7B, fleet,
                      optimizer, seed, layers=PAIR_LAYERS,
                      batch=PHASE8_BATCH, steps=3, workdir="build/phase12"):
    """12b: two ranks sharing cuda:0 over gloo (NCCL refuses two ranks on
    one device): Llama-2-7B width cut to ``layers`` layers, fused head,
    phase 8's batch and optimizer. After a probe of which collectives
    gloo carries on CUDA tensors, ``mp_degree=2`` and ``sharding_degree=2``
    stage 3 each run ``steps`` steps from the weights of a world-1 run
    (saved as numpy arrays, carried by ``load_numpy_state_dict``), and
    their losses must be within ``PAIR_REL_TOL`` of it. Per rank and step
    the flash kernels launch once per layer and the fused CE once, all on
    the tensor cores; under mp2 rank r's fused-CE launch covers its half
    of the vocabulary. A configuration whose collectives gloo does not
    carry is left out and named. Times are two processes sharing one card
    through the host: not multi-GPU speeds."""
    import shutil

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.framework.io import load_numpy_state_dict
    cfg = dataclasses.replace(LLAMA2_7B, num_hidden_layers=layers,
                              fused_ce_chunk=8192)
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        model, step = llama_trainer(LlamaForCausalLM, cfg, fleet, optimizer,
                                    seed)
        save_weights(workdir, model)
        load_numpy_state_dict(model, saved_weights(workdir))
        ids = train_ids(cfg.vocab_size, *batch)
        np.savez(os.path.join(workdir, "batch.npz"), ids=ids.cpu().numpy())
        losses, secs, _ = run_steps(fa, fc, rm, step, ids, steps,
                                    tag="world 1: ", warm_up=False)
        del step, model
        torch.cuda.empty_cache()
        dist.spawn(_pair_worker, args=(workdir, cfg, steps), nprocs=2,
                   timeout=600)
        ranks = []
        for r in range(2):
            with open(os.path.join(workdir, f"pair.r{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"  12b gloo on CUDA tensors, torch {ranks[0]['torch']}: "
        + json.dumps(ranks[0]["probe"]))
    want = want_train_launches(layers)
    V = cfg.vocab_size
    result = dict(world1=dict(losses=losses, step_secs=secs),
                  probe=ranks[0]["probe"], torch=ranks[0]["torch"],
                  configs={})
    for name in PAIR_CONFIGS:
        got = [rk["configs"][name] for rk in ranks]
        if "left_out" in got[0]:
            log(f"  12b {name}: left out, gloo (torch {ranks[0]['torch']}) "
                f"does not carry {got[0]['left_out']} on CUDA tensors")
            result["configs"][name] = got[0]
            continue
        for r, g in enumerate(got):
            rel = max(abs(a - b) / abs(b) for a, b in zip(g["losses"],
                                                           losses))
            if not rel <= PAIR_REL_TOL:
                raise AssertionError(f"12b {name} rank {r}: losses "
                                     f"{g['losses']} vs world 1 {losses} "
                                     f"(relative {rel:.3g})")
            for i, c in enumerate(g["launches"]):
                if c != want:
                    raise AssertionError(f"12b {name} rank {r} step {i} "
                                         f"launched {c}, want {want}")
            cols = ([r * V // 2, (r + 1) * V // 2] if name == "mp2"
                    else [0, V])
            if g["ce_columns"] != cols:
                raise AssertionError(f"12b {name} rank {r}: the fused CE "
                                     f"covered columns {g['ce_columns']}, "
                                     f"want {cols}")
        if got[0]["losses"] != got[1]["losses"]:
            raise AssertionError(f"12b {name}: the ranks' losses differ: "
                                 f"{got[0]['losses']} {got[1]['losses']}")
        result["configs"][name] = dict(
            losses=got[0]["losses"],
            max_rel_to_world1=max(abs(a - b) / abs(b) for a, b in
                                  zip(got[0]["losses"], losses)),
            step_secs=[g["step_secs"] for g in got],
            peak_gib=[g["peak_gib"] for g in got],
            launches_per_rank_step=got[0]["launches"][-1],
            ce_columns=[g["ce_columns"] for g in got])
        log(f"  12b {name}: losses {got[0]['losses']} vs world 1 {losses}; "
            f"step times {[[round(t, 3) for t in g['step_secs']] for g in got]}"
            f" s per rank (two ranks sharing one H100 through gloo: not "
            f"multi-GPU speeds)")
    return result


# ---------------------------------------------------------------------------
# phase 13: GPT-2 serving
# ---------------------------------------------------------------------------

# GPT-2 small's engine: its whole 1,024-position table per slot
GPT2_GEO = dict(n_slots=8, max_len=1024, block_size=16)
GPT2_LONG = 960         # a prompt whose decode reads a near-full table
GPT2_GEN = (0, 1)       # 13d's batch: the first two of 13b's prompts
GPT2_GEN_NEW = 16


def gpt2_workload(vocab):
    """Phase 5's workload (8 prompts: a shared 64-token system prefix +
    16..192-token suffixes) and one 960-token prompt (9 requests), so that
    row 4 reads tables from ~80 to ~990 positions, every split of the
    1,024-position table live."""
    prompts = workload(vocab, seed=3)
    rng = np.random.default_rng(4)
    return prompts + [rng.integers(0, vocab, GPT2_LONG).astype(np.int32)]


def judge_logits(got, want):
    """Logits against the plain forward's: ``judge_forward``'s limits on
    out (``||got - want|| / ||want||`` over all rows and over the last
    quarter of the rows, bf16 1e-2); logits have no lse. Returns
    (rel_all, rel_tail, ok)."""
    none = torch.zeros(1, device=got.device)
    rel_all, rel_tail, _, ok = judge_forward(got, none, want, none)
    return rel_all, rel_tail, ok


def gpt2_scoring(model, fa, F):
    """13a: ``model(ids[1, 1024])`` under inference_mode: 12 flash-forward
    launches, all ``"tc"``, on GPT's strided q/k/v; finite logits equal
    to those of the same model with the plain forward swapped in, under
    ``judge_logits``; the scoring latency (``forward_ms``)."""
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        0, model.config.vocab_size, (1, 1024))).cuda()
    with torch.inference_mode():
        model(ids)                               # warm-up
        torch.cuda.synchronize()
        reset_counts(fa.flash_attention)
        logits = model(ids)
        torch.cuda.synchronize()
        launches = fa.flash_attention.launches
        by_variant = dict(fa.flash_attention.launches_by_variant)
        path = F.attention_path()
        kernel = fa.flash_attention
        fa.flash_attention = (
            lambda q, k, v, causal=False, scale=None:
            fa.flash_attention_reference(q, k, v, causal=causal,
                                         scale=scale))
        try:
            plain = model(ids)
            torch.cuda.synchronize()
        finally:
            fa.flash_attention = kernel
    rel_all, rel_tail, ok = judge_logits(logits, plain)
    n = model.config.num_hidden_layers
    out = dict(launches=launches, variants=by_variant,
               logits=list(logits.shape), rel_err_vs_plain=rel_all,
               rel_err_vs_plain_last_quarter=rel_tail,
               top1_agreement_vs_plain=(logits.argmax(-1) == plain.argmax(
                   -1)).float().mean().item(),
               scoring_ms=forward_ms(model, ids))
    log(f"  13a scoring [1, 1024]: logits {tuple(logits.shape)} "
        f"{logits.dtype}, path {path['path']}, flash_attention launches "
        f"{launches} {by_variant}, rel err vs the plain forward {rel_all:.3e}"
        f" / last quarter {rel_tail:.3e} (tol {FWD_REL_TOL[logits.dtype]}),"
        f" latency {out['scoring_ms']:.3f} ms "
        f"{'ok' if ok else 'FAIL'}")
    if path["path"] != "flash" or launches != n \
            or by_variant != {"tc": n, "cuda_core": 0}:
        raise AssertionError(f"13a: flash_attention launched {launches} "
                             f"times ({by_variant}, path {path}), want {n}, "
                             f"all on the tensor cores")
    if not ok:
        raise AssertionError("13a: the logits are not finite or disagree "
                             "with the plain forward's")
    return out


def gpt2_serve(model, fd, Engine, prompts, sampled=False, **kw):
    """One run of the GPT-2 engine on ``prompts`` (32 new tokens each,
    staggered; sampled runs with temperature 0.6 and seeds 1000 + i), the
    flash-decode counts reset just before it and read just after.
    Returns (tokens, stats, handles, launches, launches by variant)."""
    eng = Engine(model, **GPT2_GEO, **kw)
    per_request = ([dict(temperature=0.6, seed=1000 + i)
                    for i in range(len(prompts))] if sampled else None)
    torch.cuda.synchronize()
    reset_counts(fd.flash_decode)
    hs = staggered(eng, prompts, 32, per_request)
    torch.cuda.synchronize()
    launches = fd.flash_decode.launches
    by_variant = dict(fd.flash_decode.launches_by_variant)
    st = eng.stats()
    if not all(h.finished and h.finish_reason == "length"
               and len(h.tokens) == 32 for h in hs):
        raise AssertionError(f"{kw}: a request did not finish with 32 "
                             f"tokens")
    if eng.cache.n_free != eng.n_slots or not eng.cache.check_refcounts():
        raise AssertionError(f"{kw}: the engine did not free its KV")
    return [list(h.tokens) for h in hs], st, hs, launches, by_variant


def check_decode_launches(what, n_layers, st, launches, by_variant):
    want = n_layers * st["decode_steps"]
    if launches != want or launches == 0 \
            or by_variant != {"split": want, "one_pass": 0}:
        raise AssertionError(f"{what}: flash_decode launched {launches} "
                             f"times ({by_variant}), want {want} (12 x "
                             f"decode steps), all on the split kernel")


def agreement(a, b):
    """How far two runs' tokens agree: requests identical, and each
    request's first differing token (None where identical)."""
    first = [next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y),
                  None) for ta, tb in zip(a, b)]
    return dict(identical_requests=sum(f is None for f in first),
                requests=len(first), first_difference=first)


def gpt2_identity(model32, fd, Engine, prompts, sampled):
    """The token identity of 13b-13d on the fp32 twin (TF32 off): the kernel
    engine and the gathered one, greedy (13b) and sampled + chunked (13c),
    give identical tokens, the kernel launching 12 times a decode step on
    the split kernel; batch ``generate`` (slot cache, plain attention)
    gives the greedy engine's tokens (13d). Returns the greedy tokens."""
    n = model32.config.num_hidden_layers
    out = {}
    for what, kw, per in (("13b", {}, False), ("13c", sampled, True)):
        toks, st, _, launches, by_variant = gpt2_serve(
            model32, fd, Engine, prompts, sampled=per, flash_decode=True,
            **kw)
        plain = gpt2_serve(model32, fd, Engine, prompts, sampled=per,
                           flash_decode=False, **kw)[0]
        check_decode_launches(f"{what} fp32", n, st, launches, by_variant)
        out[what] = toks
        log(f"  {what} fp32 twin: tokens identical to flash_decode=False: "
            f"{toks == plain} ({agreement(toks, plain)}), flash_decode "
            f"launches {launches} {by_variant}")
        if toks != plain:
            raise AssertionError(f"{what} fp32: the kernel and gathered "
                                 f"engines gave other tokens")
    batch = [prompts[i] for i in GPT2_GEN]
    L0 = max(len(p) for p in batch)
    ids = np.zeros((len(batch), L0), np.int64)
    mask = np.zeros((len(batch), L0), np.int64)
    for r, p in enumerate(batch):
        ids[r, :len(p)], mask[r, :len(p)] = p, 1
    gen = model32.generate(torch.from_numpy(ids).cuda(),
                           max_new_tokens=GPT2_GEN_NEW,
                           attention_mask=torch.from_numpy(mask).cuda())
    got = gen[:, L0:].tolist()
    want = [out["13b"][i][:GPT2_GEN_NEW] for i in GPT2_GEN]
    log(f"  13d fp32 twin: generate on a batch of {len(batch)} (prompts of "
        f"{[len(p) for p in batch]} tokens, right-padded), {GPT2_GEN_NEW} "
        f"tokens, equal to 13b's engine tokens: {got == want}")
    if got != want:
        raise AssertionError("13d: generate() disagrees with the engine")
    return out


def phase_gpt2(fa, fd, F, Engine, ledger, GPTConfig, GPTForCausalLM, seed):
    """Phase 13: GPT-2 small at its published widths (hidden 768, 12
    layers, 12 heads, FFN 3072, 1,024 positions, vocab 50304), random
    weights from seed 0, ``eval()``. In bf16: 13a scoring; 13b greedy
    paged serving and 13c sampled + chunked serving with the kernel
    (launches, prefix hits, chunking, seed repeatability, latencies),
    each beside the gathered engine's run, whose token agreement is
    printed. bf16 cannot hold the two engines to identical tokens: two
    right attention sums differ by a bf16 ulp, which 12 layers carry to
    ~1e-2 of the logits (13a measures it), and a greedy near-tie among
    50,304 logits then flips. So the identities of 13b-13d are held on
    the fp32 twin (the same seed-0 draws before their bf16 rounding, TF32
    off), as phase 6 holds Llama's. Returns (flash-forward launches of
    13a, flash-decode launches of 13b and of 13c in bf16, printed
    numbers)."""
    cfg = dataclasses.replace(GPTConfig(), dtype="bfloat16")
    seed(0)
    model = GPTForCausalLM(cfg, device="cuda").eval()
    n = cfg.num_hidden_layers
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = {"13a": gpt2_scoring(model, fa, F)}
    smi = smi_line()
    prompts = gpt2_workload(cfg.vocab_size)

    # ---- 13b: greedy paged, bf16 --------------------------------------------
    t0 = time.perf_counter()
    toks, st, hs, launches, by_variant = gpt2_serve(
        model, fd, Engine, prompts, flash_decode=True)
    wall = time.perf_counter() - t0
    led = ledger(hs)
    plain, _, _, plain_launches, _ = gpt2_serve(model, fd, Engine, prompts,
                                                flash_decode=False)
    agree = agreement(toks, plain)
    log(f"  13b greedy: {len(hs)} requests, wall {wall:.2f} s, decode steps "
        f"{st['decode_steps']}, prefix_hit_tokens {st['prefix_hit_tokens']},"
        f" flash_decode launches {launches} {by_variant} (gathered run: "
        f"{plain_launches}); bf16 agreement with flash_decode=False: "
        f"{agree}")
    log(f"  13b ledger {json.dumps(led)} ({smi})")
    check_decode_launches("13b", n, st, launches, by_variant)
    if st["prefix_hit_tokens"] <= 0 or plain_launches:
        raise AssertionError(f"13b: no prefix hit, or the gathered run "
                             f"launched the kernel: {st}")
    out["13b"] = dict(wall_s=wall, decode_steps=st["decode_steps"],
                      prefix_hit_tokens=st["prefix_hit_tokens"],
                      flash_decode_launches=launches, ledger=led,
                      bf16_agreement_with_gathered=agree)

    # ---- 13c: sampled + chunked, bf16; the same seeds repeat ----------------
    sampled = dict(do_sample=True, top_k=50, top_p=0.9, prefill_chunk=64)
    t0 = time.perf_counter()
    stoks, sst, shs, slaunches, sby_variant = gpt2_serve(
        model, fd, Engine, prompts, sampled=True, flash_decode=True,
        **sampled)
    swall = time.perf_counter() - t0
    sled = ledger(shs)
    again = gpt2_serve(model, fd, Engine, prompts, sampled=True,
                       flash_decode=True, **sampled)[0]
    splain = gpt2_serve(model, fd, Engine, prompts, sampled=True,
                        flash_decode=False, **sampled)[0]
    sagree = agreement(stoks, splain)
    log(f"  13c sampled + chunked: wall {swall:.2f} s, decode steps "
        f"{sst['decode_steps']}, chunk steps {sst['chunk_steps']} "
        f"({sst['chunked_prefills']} chunked prefills), flash_decode "
        f"launches {slaunches} {sby_variant}; the same seeds give the same "
        f"tokens: {stoks == again}; bf16 agreement with flash_decode=False: "
        f"{sagree}")
    log(f"  13c ledger {json.dumps(sled)} ({smi})")
    check_decode_launches("13c", n, sst, slaunches, sby_variant)
    if not sst["chunked_prefills"] > 0:
        raise AssertionError(f"13c: no prompt was chunked: {sst}")
    if stoks != again:
        raise AssertionError("13c: two runs with the same seeds gave other "
                             "tokens")
    out["13c"] = dict(wall_s=swall, decode_steps=sst["decode_steps"],
                      chunk_steps=sst["chunk_steps"],
                      chunked_prefills=sst["chunked_prefills"],
                      flash_decode_launches=slaunches, ledger=sled,
                      bf16_agreement_with_gathered=sagree)
    peak = torch.cuda.max_memory_allocated()
    out["peak_memory_gib"] = peak / 2**30
    log(f"  phase 13 bf16 peak memory {peak / 2**30:.2f} GiB ({smi})")
    del model
    torch.cuda.empty_cache()

    # ---- 13b-13d token identity on the fp32 twin ---------------------------
    seed(0)
    model32 = GPTForCausalLM(dataclasses.replace(cfg, dtype="float32"),
                             device="cuda").eval()
    gpt2_identity(model32, fd, Engine, prompts, sampled)
    del model32
    torch.cuda.empty_cache()
    return out["13a"]["launches"], launches, slaunches, out


# ---------------------------------------------------------------------------
# phase 14: tensor-parallel serving
# ---------------------------------------------------------------------------

TP_LLAMA_LAYERS = PAIR_LAYERS   # 14b's depth cut, 12b's: two ranks' gloo
                                # traffic is staged through the host
TP_SAMPLED = dict(do_sample=True, top_k=50, top_p=0.9, prefill_chunk=64)
TP_STATS = ("decode_steps", "prefills", "chunked_prefills", "chunk_steps",
            "prefix_hit_tokens", "preemptions", "kv_cache_bytes")


def tp_cell(name):
    """(model class, fp32 config, engine geometry, prompts) of a phase-14
    cell: 14a GPT-2 small at its published widths and depth with phase
    13's 9 requests; 14b Llama-2-7B widths cut to ``TP_LLAMA_LAYERS``
    layers with phase 5's workload."""
    from paddle_tpu_torch.text.models import GPTConfig, GPTForCausalLM
    from paddle_tpu_torch.text.models.llama import (LLAMA2_7B,
                                                    LlamaForCausalLM)
    if name == "14a":
        cfg = dataclasses.replace(GPTConfig(), dtype="float32")
        return GPTForCausalLM, cfg, GPT2_GEO, gpt2_workload(cfg.vocab_size)
    cfg = dataclasses.replace(LLAMA2_7B, dtype="float32",
                              num_hidden_layers=TP_LLAMA_LAYERS)
    return LlamaForCausalLM, cfg, SERVE_GEO, workload(cfg.vocab_size, seed=1)


def tp_model(name, device):
    """The cell's fp32 model from seed 0 on ``device``, in eval mode."""
    import paddle_tpu_torch as pt
    cls, cfg, _, _ = tp_cell(name)
    pt.seed(0)
    return cls(cfg, device=device).eval()


def tp_serve(model, Engine, ledger, geo, prompts, sampled, **kw):
    """One staggered run, 32 new tokens each (sampled: ``TP_SAMPLED``,
    temperature 0.6, seeds 1000 + i): every request must finish with 32
    tokens and the engine free its KV. Returns (tokens, stats, ledger,
    wall seconds)."""
    eng = Engine(model, **geo, **(TP_SAMPLED if sampled else {}), **kw)
    per_request = ([dict(temperature=0.6, seed=1000 + i)
                    for i in range(len(prompts))] if sampled else None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hs = staggered(eng, prompts, 32, per_request)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not all(h.finished and h.finish_reason == "length"
               and len(h.tokens) == 32 for h in hs):
        raise AssertionError(f"{kw}: a request did not finish with 32 "
                             f"tokens")
    if eng.cache.n_free != eng.n_slots or not eng.cache.check_refcounts():
        raise AssertionError(f"{kw}: the engine did not free its KV")
    return [list(h.tokens) for h in hs], eng.stats(), ledger(hs), wall


def _tp_worker(workdir, name, p27dir=None):
    """One of phase 14's two ranks on cuda:0 (gloo): the cell's whole fp32
    model on the CPU, ``Engine(model, tp=2)`` holding this rank's shards
    and half the KV heads on the card, greedy then sampled + chunked, the
    flash-decode and collective counts set to 0 just before each run and
    read just after. With ``p27dir`` the ranks then run 27a and 27b on the
    same model (``_p27_work``), which saves a spawn and a model build."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed import collective_matmul as cm
    from paddle_tpu_torch.ops import flash_decode as fd
    from paddle_tpu_torch.serving import Engine, ledger

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env(backend="gloo", device="cuda:0", timeout=600)
    rank = dist.get_rank()
    _, _, geo, prompts = tp_cell(name)
    model = tp_model(name, "cpu")          # no card holds all of it
    torch.cuda.reset_peak_memory_stats()
    out = dict(rank=rank, backend=torch.distributed.get_backend(), runs={})
    for what, sampled in (("greedy", False), ("sampled", True)):
        reset_counts(fd.flash_decode)
        for k in cm.launches:
            cm.launches[k] = 0
        toks, st, led, wall = tp_serve(model, Engine, ledger, geo, prompts,
                                       sampled, tp=2)
        out["runs"][what] = dict(
            tokens=toks, wall_s=wall, ledger=led,
            flash_decode_launches=fd.flash_decode.launches,
            collectives=dict(cm.launches), mesh=st["mesh"],
            **{k: st[k] for k in TP_STATS})
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    with open(os.path.join(workdir, f"tp.{name}.r{rank}.json"), "w") as f:
        json.dump(out, f)
    if p27dir is not None:
        _p27_work(model, rank, geo, prompts, p27dir)
    dist.destroy_process_group()


def tp_collectives(n_layers, run):
    """The collectives the tp programs of a run must issue: an all-reduce
    for each row-parallel projection (2 a layer) of every prefill, chunk
    and decode step, and the head's all-gather for every decode step and
    every prefill that samples (a chunked prompt's final chunk)."""
    calls = run["prefills"] - run["chunked_prefills"] + run["chunk_steps"]
    return {"all_reduce": 2 * n_layers * (calls + run["decode_steps"]),
            "all_gather": run["decode_steps"] + run["prefills"]}


def phase_tp(Engine, ledger, load_numpy_state_dict,
             workdir="build/phase14", refs=None, p27dir=None):
    """Phase 14: ``Engine(model, tp=2)`` as two ranks sharing cuda:0 over
    gloo (NCCL refuses two ranks on one device), each holding the whole
    fp32 model on the CPU and its shards and half the KV heads on the
    card. Per cell (``tp_cell``), greedy and then sampled + chunked, each
    rank's tokens must equal those of a tp=1 fp32 engine on the same
    weights on the card (TF32 off): fp32 changes only the order of the
    sums. No flash-decode launch (refused with tp > 1, as in JAX); the
    collectives each run issues (``tp_collectives``); the pool at half
    the kv heads. Throughput and ITL over gloo are two processes sharing
    one card through the host, not multi-GPU speeds. ``refs`` (a dict)
    receives each cell's tokens, tp=1's and rank 0's, by run; with
    ``p27dir`` 14b's ranks go on to phase 27a/27b and write there."""
    import shutil

    from paddle_tpu_torch import distributed as dist
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    smi = smi_line()
    result = {}
    try:
        for name in ("14a", "14b"):
            _, cfg, geo, prompts = tp_cell(name)
            # the tp=1 reference: the same seed-0 draws, made on the CPU as
            # the ranks make them, copied into a model on the card
            card = tp_model(name, "cuda")
            load_numpy_state_dict(card, {
                k: v.numpy() for k, v in tp_model(name, "cpu")
                .state_dict().items()})
            ref = {what: tp_serve(card, Engine, ledger, geo, prompts, s)
                   for what, s in (("greedy", False), ("sampled", True))}
            del card
            torch.cuda.empty_cache()
            p27 = p27dir if name == "14b" else None
            if p27 is not None:
                shutil.rmtree(p27, ignore_errors=True)
                os.makedirs(p27)
            t0 = time.perf_counter()
            dist.spawn(_tp_worker, args=(workdir, name, p27), nprocs=2,
                       timeout=900)
            spawn_s = time.perf_counter() - t0
            if p27 is not None:     # 27a/27b's share of the spawn
                with open(os.path.join(p27, "p27.r0.json")) as f:
                    spawn_s -= json.load(f)["work_s"]
            ranks = []
            for r in range(2):
                with open(os.path.join(workdir, f"tp.{name}.r{r}.json")) as f:
                    ranks.append(json.load(f))
            n = cfg.num_hidden_layers
            n_kv = getattr(cfg, "num_key_value_heads",
                           cfg.num_attention_heads)
            cell = dict(layers=n, backend=ranks[0]["backend"],
                        peak_gib_per_rank=[rk["peak_gib"] for rk in ranks],
                        spawn_s=spawn_s, runs={})
            for what, (toks, st, led, wall) in ref.items():
                got = [rk["runs"][what] for rk in ranks]
                if refs is not None:
                    refs.setdefault(name, {})[what] = dict(
                        tp1=toks, tp2=got[0]["tokens"])
                same = [g["tokens"] == toks for g in got]
                log(f"  {name} {what}: tp=2 tokens identical to tp=1 on "
                    f"rank 0 / rank 1: {same} ({agreement(got[0]['tokens'], toks)})"
                    f"; decode steps {got[0]['decode_steps']}, chunk steps "
                    f"{got[0]['chunk_steps']}, prefix_hit_tokens "
                    f"{got[0]['prefix_hit_tokens']}, collectives "
                    f"{got[0]['collectives']}, flash_decode launches "
                    f"{[g['flash_decode_launches'] for g in got]}")
                log(f"  {name} {what} tp=2 over gloo, rank 0: wall "
                    f"{got[0]['wall_s']:.2f} s, ledger "
                    f"{json.dumps(got[0]['ledger'])}; tp=1 on the card: "
                    f"wall {wall:.2f} s, ledger {json.dumps(led)} ({smi})")
                if not all(same):
                    raise AssertionError(f"{name} {what}: tp=2 tokens differ "
                                         f"from tp=1's")
                for r, g in enumerate(got):
                    want = tp_collectives(n, g)
                    if g["flash_decode_launches"] or g["collectives"] != want:
                        raise AssertionError(
                            f"{name} {what} rank {r}: flash_decode launched "
                            f"{g['flash_decode_launches']}, collectives "
                            f"{g['collectives']} (want 0 and {want})")
                    m = g["mesh"]
                    if m["kv_heads_per_device"] != n_kv // 2 \
                            or 2 * m["kv_pool_bytes_per_device"] \
                            != st["kv_cache_bytes"]:
                        raise AssertionError(f"{name} rank {r}: the pool is "
                                             f"not half the tp=1 one: {m}")
                if what == "greedy" and got[0]["prefix_hit_tokens"] <= 0:
                    raise AssertionError(f"{name}: no prefix hit")
                if what == "sampled" and got[0]["chunked_prefills"] <= 0:
                    raise AssertionError(f"{name}: no prompt was chunked")
                cell["runs"][what] = dict(
                    tokens_identical=True, decode_steps=got[0]["decode_steps"],
                    chunk_steps=got[0]["chunk_steps"],
                    collectives=got[0]["collectives"],
                    wall_s=[g["wall_s"] for g in got],
                    ledger=got[0]["ledger"], tp1_wall_s=wall, tp1_ledger=led,
                    kv_pool_bytes_per_rank=got[0]["mesh"][
                        "kv_pool_bytes_per_device"],
                    tp1_kv_pool_bytes=st["kv_cache_bytes"])
            log(f"  {name} peak memory per rank "
                f"{[round(p, 3) for p in cell['peak_gib_per_rank']]} GiB "
                f"(the pool at {n_kv // 2} of {n_kv} kv heads), spawn and "
                f"both runs {spawn_s:.1f} s ({smi})")
            result[name] = cell
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return result


# ---------------------------------------------------------------------------
# phase 15: sequence-parallel training
# ---------------------------------------------------------------------------

# bench.py:bench_llama_long_context's configuration (bench.py:363): the
# 0.5B Llama at 8,192 positions with selective remat, batch 1 x 8192, its
# 8 layers cut to SEP_LAYERS (the launch equations follow the depth)
SEP_LAYERS = 4
SEP_CELL = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5504,
                num_hidden_layers=SEP_LAYERS, num_attention_heads=16,
                num_key_value_heads=16, max_position_embeddings=8192,
                dtype="bfloat16", remat="selective")
SEP_BATCH = (1, 8192)
SEP_OPS = (1, 8192, 16, 128)    # 15a: [B, L, H, D], bf16, causal
SEP_DEGREE = 2
SEP_MODES = ("ring", "ulysses")
SEP_REL_TOL = PAIR_REL_TOL      # bf16 training, other reduction orders


def sep_batch(vocab, B, L, device="cuda"):
    """The cell's batch, as ``bench_llama_long_context`` draws it: ids,
    then labels, from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab, (B, L))
    labels = rng.integers(0, vocab, (B, L))
    return (torch.from_numpy(ids).to(device),
            torch.from_numpy(labels).to(device))


def want_sep_launches(layers, n, rank, mode, remat):
    """Rows 1-3 launches per rank and train step under sequence parallel
    (``mode`` "ring" or "ulysses"; n = 1 is the world-1 step): per layer
    the ring runs rank + 1 causal chunk pairs (the wraparound pairs are
    not launched), Ulysses and world 1 one attention over the whole
    sequence (on the rank's heads); remat recomputes the forward in the
    backward. No fused head in the cell, so no row-5 launch."""
    pairs = min(rank + 1, n) if mode == "ring" else 1
    want = dict(flash_attention_fwd=layers * pairs * (2 if remat else 1),
                flash_attention_bwd_dq=layers * pairs,
                flash_attention_bwd_dkv=layers * pairs,
                fused_ce_stats=0, ragged_group_matmul=0)
    want.update({k + "_tc": v for k, v in list(want.items())})
    return want


def weights_fingerprint(model):
    """Each parameter's fp64 sum, on the host: equal models, equal
    fingerprints."""
    return {k: float(p.detach().double().cpu().sum())
            for k, p in model.state_dict().items()}


def _raw_p2p_worker(path):
    """One rank of the raw probe: a gloo ``batch_isend_irecv`` of a CUDA
    tensor, not staged."""
    import torch.distributed as tdist
    from paddle_tpu_torch import distributed as dist
    dist.init_parallel_env(backend="gloo", device="cuda:0", timeout=60)
    r = dist.get_rank()
    x = torch.full((8,), float(r + 1), device="cuda")
    y = torch.empty_like(x)
    for w in tdist.batch_isend_irecv([tdist.P2POp(tdist.isend, x, 1 - r),
                                      tdist.P2POp(tdist.irecv, y, 1 - r)]):
        w.wait()
    torch.cuda.synchronize()
    with open(os.path.join(path, f"p2p.r{r}"), "w") as f:
        f.write("ok" if bool((y == 2 - r).all()) else "wrong values")
    dist.destroy_process_group()


def raw_p2p_probe(workdir):
    """Whether gloo carries point-to-point on CUDA tensors when nothing
    stages them (two throwaway ranks: the failing case aborts its
    process)."""
    from paddle_tpu_torch import distributed as dist
    try:
        dist.spawn(_raw_p2p_worker, args=(workdir,), nprocs=2, timeout=120)
    except RuntimeError as e:
        return f"refused: {e}"
    with open(os.path.join(workdir, "p2p.r0")) as f:
        return f.read()


def sep_probe(C, world):
    """The sequence-parallel collectives on CUDA tensors, by name: the
    tiled all-to-all (gloo carries it) and the ring rotation (staged
    through the host on gloo, counted in ``host_staged``), each checked
    for its values."""
    n, r = world.nranks, world.rank
    out = {}
    for dt, tag in ((torch.bfloat16, "bf16"), (torch.float32, "fp32")):
        x = torch.full((2 * n, 8), float(r + 1), dtype=dt, device="cuda")
        staged = C.host_staged["ppermute"]
        try:
            y = C.all_to_all(x, 0, 0, world)
            out[f"all_to_all_{tag}"] = "ok" if all(
                bool((y[2 * i:2 * i + 2] == i + 1).all())
                for i in range(n)) else "wrong values"
            y = C.ppermute(x, 1, world)
            ok = bool((y == (r - 1) % n + 1).all())
            out[f"ppermute_{tag}"] = ("ok" if ok else "wrong values") + (
                ", host-staged" if C.host_staged["ppermute"] > staged
                else "")
        except RuntimeError as e:
            out[f"sep_{tag}"] = f"{type(e).__name__}: {str(e)[:160]}"
    return out


def _gather_seq(C, g, *xs, dim=1):
    return [C.gather_dim(x.detach().contiguous(), dim, g) for x in xs]


def _head_to_seq_wrong_order(C):
    """Ulysses' return all-to-all with the heads concatenated in the
    wrong rank order (a planted fault)."""
    def wrong(x, group):
        y = C.all_to_all(x, 1, 2, group)
        return y.unflatten(2, (group.nranks, -1)).flip(2).flatten(2, 3)
    return wrong


def sep_ops(fa, fc, rm, C, ra, ua, g, shape=SEP_OPS, device="cuda"):
    """15a on this rank: ring and Ulysses at ``shape`` (bf16, causal) on
    the rank's block, gathered over the group and judged against world-1
    ``flash_attention_fn`` on the whole sequence (``judge_forward``,
    ``judge_backward``); the launches of rows 1-3 counted around each
    body; three planted faults (the wraparound pair left unmasked, dk/dv
    one rotation short of home, Ulysses' return all-to-all in the wrong
    rank order) must fail the judges."""
    from unittest import mock
    B, L, H, D = shape
    gen = torch.Generator(device=device).manual_seed(15)
    q, k, v, do = (torch.randn(shape, generator=gen, device=device,
                               dtype=torch.bfloat16) for _ in range(4))
    qw, kw, vw = (t.clone().requires_grad_() for t in (q, k, v))
    want_out = fa.flash_attention_fn(qw, kw, vw, causal=True)
    want_out.backward(do)
    want_lse = fa.flash_attention(q, k, v, causal=True)[1]
    want_grads = (qw.grad, kw.grad, vw.grad)
    per = L // g.nranks
    blk = slice(g.rank * per, (g.rank + 1) * per)
    scale = 1.0 / D ** 0.5
    res = {}
    for mode, body in (("ring", ra.ring_attention_local),
                       ("ulysses", ua.ulysses_attention_local)):
        qs, ks, vs = (t[:, blk].clone().requires_grad_() for t in (q, k, v))
        _reset(fa, fc, rm)
        o = body(qs, ks, vs, g, causal=True)
        o.backward(do[:, blk])
        if o.is_cuda:
            torch.cuda.synchronize()
        launches = _counts(fa, fc, rm)
        out, dq, dk, dv = _gather_seq(C, g, o, qs.grad, ks.grad, vs.grad)
        if mode == "ring":
            lse = ra._ring_fwd_pass(qs.detach(), ks.detach(), vs.detach(), g,
                                    True, scale)[1]
            lse = _gather_seq(C, g, lse, dim=2)[0]
        else:
            lse = want_lse               # Ulysses keeps no lse
        fwd = judge_forward(out, lse, want_out, want_lse)
        bwd = judge_backward((dq, dk, dv), want_grads)
        res[mode] = dict(launches=launches, forward=fwd[:3],
                         forward_ok=fwd[3], backward=bwd[0],
                         backward_ok=bwd[1])
    # planted faults
    qs, ks, vs = (t[:, blk].contiguous() for t in (q, k, v))
    with mock.patch.object(ra, "_kept", lambda idx, s, causal: True):
        o, lse = ra._ring_fwd_pass(qs, ks, vs, g, True, scale)
    out, lse = _gather_seq(C, g, o)[0], _gather_seq(C, g, lse, dim=2)[0]
    faults = {"wraparound pair unmasked":
              judge_forward(out, lse, want_out, want_lse)[3]}
    qs, ks, vs = (t[:, blk].clone().requires_grad_() for t in (q, k, v))
    ra.ring_attention_local(qs, ks, vs, g, causal=True).backward(do[:, blk])
    dq, dk, dv = _gather_seq(C, g, qs.grad, C.ppermute(ks.grad, -1, g),
                             C.ppermute(vs.grad, -1, g))
    faults["dk/dv one rotation short of home"] = judge_backward(
        (dq, dk, dv), want_grads)[1]
    with mock.patch.object(ua, "_head_to_seq", _head_to_seq_wrong_order(C)):
        o = ua.ulysses_attention_local(qs.detach(), ks.detach(),
                                       vs.detach(), g, causal=True)
    faults["Ulysses heads in the wrong rank order"] = judge_forward(
        _gather_seq(C, g, o)[0], want_lse, want_out, want_lse)[3]
    res["faults_passed"] = faults
    return res


def _sep_worker(workdir, cell, batch, ops_shape, steps, fingerprint,
                device="cuda"):
    """One of phase 15's two ranks on cuda:0 (gloo): the sequence-parallel
    probe, 15a's ops, then 15b's cell under sep 2, ring then Ulysses, from
    the seed-0 weights (their fingerprint checked against the world-1
    run's), each step's counts set to 0 before it and read after it."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_ce as fc
    from paddle_tpu_torch.ops import ragged_matmul as rm
    from paddle_tpu_torch.ops import ring_attention as ra
    from paddle_tpu_torch.ops import ulysses_attention as ua
    from paddle_tpu_torch.text.models.llama import (LlamaConfig,
                                                    LlamaForCausalLM)

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env(backend="gloo", device="cuda:0" if device == "cuda"
                           else device, timeout=900)
    rank = dist.get_rank()
    out = dict(rank=rank, probe=sep_probe(C, C.get_group()), cells={})
    s = fleet.DistributedStrategy()
    s.hybrid_configs["sep_degree"] = SEP_DEGREE
    fleet.init(is_collective=True, strategy=s)
    g = fleet.get_hybrid_communicate_group().mesh.group("sep")
    out["ops"] = sep_ops(fa, fc, rm, C, ra, ua, g, ops_shape, device)
    for mode in SEP_MODES:
        cfg = LlamaConfig(**{**cell, "sequence_parallel": True,
                             "sep_mode": mode})
        model, step = llama_trainer(LlamaForCausalLM, cfg, fleet, optimizer,
                                    pt.seed, device)
        if weights_fingerprint(model) != fingerprint:
            raise AssertionError(f"rank {rank} {mode}: the seed-0 weights "
                                 "differ from the world-1 run's")
        ids, labels = sep_batch(cfg.vocab_size, *batch, device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        staged = C.host_staged["ppermute"]
        losses, secs, per_step = run_steps(
            fa, fc, rm, step, ids, steps + 1, tag=f"[rank {rank}, {mode}] ",
            labels=labels)
        out["cells"][mode] = dict(
            losses=losses, step_secs=secs, launches=per_step,
            staged_ppermutes_per_step=(C.host_staged["ppermute"] - staged)
            / (steps + 1),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        del step, model
        torch.cuda.empty_cache()
    with open(os.path.join(workdir, f"sep.r{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def phase_sep(fa, fc, rm, LlamaConfig, LlamaForCausalLM, fleet, optimizer,
              seed, cell=SEP_CELL, batch=SEP_BATCH, ops_shape=SEP_OPS,
              steps=3, workdir="build/phase15", device="cuda"):
    """Phase 15: sequence-parallel training. First the raw probe (gloo
    point-to-point on CUDA tensors, unstaged) and the cell at world 1 on
    the card (``sdpa_raw``: rows 1-3 over all 8,192 positions), then two
    gloo ranks sharing the card (``_sep_worker``): 15a, ring and Ulysses
    at ``ops_shape`` under the judges, their launches and three planted
    faults; 15b, the cell under ``sep_degree=2``, ring then Ulysses, a
    warm-up and ``steps`` steps each: every rank's losses within
    ``SEP_REL_TOL`` of world 1's, rows 1-3 launches per rank and step
    equal to ``want_sep_launches``, all on the tensor cores. Times are two
    processes sharing one card through the host: not multi-GPU speeds."""
    import shutil

    from paddle_tpu_torch import distributed as dist
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    smi = smi_line()
    try:
        p2p = raw_p2p_probe(workdir)
        log(f"  gloo point-to-point on CUDA tensors, unstaged: {p2p}")
        cfg = LlamaConfig(**cell)
        layers, remat = cfg.num_hidden_layers, bool(cfg.remat)
        model, step = llama_trainer(LlamaForCausalLM, cfg, fleet, optimizer,
                                    seed, device)
        fingerprint = weights_fingerprint(model)
        ids, labels = sep_batch(cfg.vocab_size, *batch, device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, secs, per_step = run_steps(fa, fc, rm, step, ids, steps + 1,
                                           tag="world 1: ", labels=labels)
        peak = torch.cuda.max_memory_allocated() / 2**30
        del step, model
        torch.cuda.empty_cache()
        want1 = want_sep_launches(layers, 1, 0, "world 1", remat)
        for i, c in enumerate(per_step):
            if c != want1:
                raise AssertionError(f"15b world 1 step {i} launched {c}, "
                                     f"want {want1}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"15b world 1: non-finite loss {losses}")
        t0 = time.perf_counter()
        dist.spawn(_sep_worker, args=(workdir, cell, batch, ops_shape, steps,
                                      fingerprint, device),
                   nprocs=SEP_DEGREE, timeout=900)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(SEP_DEGREE):
            with open(os.path.join(workdir, f"sep.r{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    B, L = batch
    step1 = float(np.median(secs[1:]))
    result = dict(raw_p2p=p2p, probe=ranks[0]["probe"], spawn_s=spawn_s,
                  world1=dict(losses=losses, step_ms=step1 * 1e3,
                              tokens_per_s=B * L / step1, peak_gib=peak,
                              launches=per_step[-1]),
                  ops={}, cells={})
    log(f"  sequence-parallel collectives on CUDA tensors over gloo: "
        + json.dumps(ranks[0]["probe"]))
    # 15a
    for r, rk in enumerate(ranks):
        ops = rk["ops"]
        for mode in SEP_MODES:
            o = ops[mode]
            want = want_sep_launches(1, SEP_DEGREE, r, mode, False)
            log(f"  15a {mode} rank {r}: forward (rel all, rel tail, lse "
                f"err) {o['forward']}, backward (rel all, rel tail) "
                f"{o['backward']}, launches {o['launches']}")
            if not (o["forward_ok"] and o["backward_ok"]):
                raise AssertionError(f"15a {mode} rank {r} fails its judge")
            if o["launches"] != want:
                raise AssertionError(f"15a {mode} rank {r} launched "
                                     f"{o['launches']}, want {want}")
        passed = [k for k, ok in ops["faults_passed"].items() if ok]
        if passed:
            raise AssertionError(f"15a rank {r}: planted faults pass the "
                                 f"judges: {passed}")
        result["ops"][f"rank{r}"] = {m: {k: ops[m][k] for k in (
            "forward", "backward")} for m in SEP_MODES}
    log(f"  15a planted faults, each failing its judge on both ranks: "
        f"{list(ranks[0]['ops']['faults_passed'])}")
    # 15b
    for mode in SEP_MODES:
        got = [rk["cells"][mode] for rk in ranks]
        worst = 0.0
        for r, gr in enumerate(got):
            rel = max(abs(a - b) / abs(b) for a, b in zip(gr["losses"],
                                                           losses))
            worst = max(worst, rel)
            if not rel <= SEP_REL_TOL:
                raise AssertionError(f"15b {mode} rank {r}: losses "
                                     f"{gr['losses']} vs world 1 {losses} "
                                     f"(relative {rel:.3g})")
            want = want_sep_launches(layers, SEP_DEGREE, r, mode, remat)
            for i, c in enumerate(gr["launches"]):
                if c != want:
                    raise AssertionError(f"15b {mode} rank {r} step {i} "
                                         f"launched {c}, want {want}")
        med = [float(np.median(gr["step_secs"][1:])) for gr in got]
        result["cells"][mode] = dict(
            losses=got[0]["losses"], max_rel_to_world1=worst,
            step_ms_per_rank=[m * 1e3 for m in med],
            tokens_per_s=B * L / max(med),
            peak_gib_per_rank=[gr["peak_gib"] for gr in got],
            launches_per_rank_step=[gr["launches"][-1] for gr in got],
            staged_ppermutes_per_rank_step=[gr["staged_ppermutes_per_step"]
                                            for gr in got])
        steps_ms = [round(m * 1e3, 1) for m in med]
        log(f"  15b {mode}, sep 2 over gloo on one card: losses "
            f"{got[0]['losses']} vs world 1 {losses}, worst relative "
            f"{worst:.3g} (limit {SEP_REL_TOL}); step {steps_ms} ms "
            f"per rank, {B * L / max(med):.1f} tokens/s, peak "
            f"{[gr['peak_gib'] for gr in got]} GiB per rank, host-staged "
            f"ppermutes per rank and step "
            f"{[gr['staged_ppermutes_per_step'] for gr in got]} (two "
            f"processes sharing one card through gloo: not a multi-GPU "
            f"speed; {smi})")
    log(f"  15b world 1 on the card: step {step1 * 1e3:.1f} ms, "
        f"{B * L / step1:.1f} tokens/s, peak {peak} GiB ({smi}); spawn and "
        f"both sep runs {spawn_s:.1f} s")
    return result


# ---------------------------------------------------------------------------
# phase 16: pipeline-parallel training
# ---------------------------------------------------------------------------

# Llama-2-7B widths cut to 4 layers (12b's cut: two ranks' gloo traffic is
# staged through the host), 2 a stage at pp 2; 4 micro-batches of 1 x 2048
PP_LAYERS = PAIR_LAYERS
PP_DEGREE = 2
PP_MICRO = 4
PP_BATCH = (4, 2048)
PP_REL_TOL = PAIR_REL_TOL     # bf16, other micro-batch shapes and orders
PP_SCHEDULES = ("gpipe", "1f1b")
# the planted faults of 16a, by key: (what, the bodies it is planted into)
PP_FAULTS = {
    "wrong_order": ("stages applied in the wrong order", ("gpipe", "1f1b")),
    "next_input": ("micro-batch b's cotangent paired with a neighbour's "
                   "saved graph", ("gpipe", "1f1b")),
    "sum_over_pp": ("the replicated output's backward summing over pp",
                    ("gpipe",)),
}


def want_pp_launches(layers_per_stage, n_micro, remat=False):
    """Rows 1-3 launches per rank and train step under pp: every
    micro-batch runs the rank's layers forward once and backward once (a
    remat stage recomputes the forward); no fused head, no row 5."""
    n = layers_per_stage * n_micro
    want = dict(flash_attention_fwd=n * (2 if remat else 1),
                flash_attention_bwd_dq=n, flash_attention_bwd_dkv=n,
                fused_ce_stats=0, ragged_group_matmul=0)
    want.update({k + "_tc": v for k, v in list(want.items())})
    return want


def pp_p2p_calls(schedule, n, p, m):
    """The ``batch_isend_irecv`` calls rank p of n makes in one pipeline
    call with m micro-batches (each carries a transfer; on gloo each is
    staged through the host): GPipe's ticks with a transfer, forward and
    backward; 1F1B's warm-up, steady and cool-down transfers."""
    first, last = p == 0, p == n - 1
    if schedule == "gpipe":
        return 2 * (m + (not first and not last))
    w = min(n - p - 1, m)
    s = m - w
    return (w * (1 + (not first)) + (s > 0 and not first)
            + s * ((not last) + (not first)) + w * ((not last) + (not first)))


def pp_fault(pl, C, fault):
    """A context that plants ``fault`` (a key of ``PP_FAULTS``) into
    ``ops.pipeline``."""
    from unittest import mock
    if fault == "wrong_order":
        real = pl._local_chunk
        return mock.patch.object(
            pl, "_local_chunk",
            lambda st, n, p, ax: real(st, n, n - 1 - p, ax))
    if fault == "next_input":
        real_take = pl._InFlight.take

        def take(self, i):
            # micro-batch i's entry swapped with a neighbour's still held:
            # i + 1's (1F1B), or i - 1's (GPipe's backward runs in reverse)
            h = self._held
            j = i + 1 if i + 1 in h else i - 1
            if j in h:
                h[i], h[j] = h[j], h[i]
            return real_take(self, i)
        return mock.patch.object(pl._InFlight, "take", take)
    return mock.patch.object(
        pl, "_output_cotangent",
        lambda ring, g: C.all_reduce(g.clone(), group=ring.group))


def judge_rel(got, want, tol):
    """(``||got - want|| / ||want||`` over everything, the same over the
    last quarter of dim 1 (the sequence, or a weight's rows), within
    ``tol``)."""
    got, want = got.detach().double(), want.detach().double()

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))
    if want.dim() < 2:
        r = rel(got, want)
        return r, r, r <= tol
    q = want.shape[1] - want.shape[1] // 4
    a, t = rel(got, want), rel(got[:, q:], want[:, q:])
    return a, t, a <= tol and t <= tol


def _pp_body(pl, body, parts, x, labels, ct, mesh, n_micro):
    """One body on this rank: GPipe's output and, after the backward of
    ``ct``, the gradients of the rank's chunk and of x; or 1F1B's loss,
    chunk gradients, last-stage gradients and dx."""
    _, stacked, last, _, stage_fn, last_fn = parts
    n, p = mesh.axis_size("pp"), mesh.axis_index("pp")
    if body == "gpipe":
        w = {k: v.detach().clone().requires_grad_()
             for k, v in stacked.items()}
        xl = x.detach().clone().requires_grad_()
        y = pl.spmd_pipeline(stage_fn, w, xl, mesh=mesh, n_micro=n_micro)
        y.backward(ct)
        k0 = next(iter(w.values())).shape[0] // n
        return dict(out=y.detach(), dx=xl.grad,
                    **{f"grad {k}": v.grad[p * k0:(p + 1) * k0]
                       for k, v in w.items()})
    loss, g, lg, dx = pl.pipeline_1f1b(
        stage_fn, last_fn, {k: v.detach() for k, v in stacked.items()},
        x.detach(), labels, last_params={k: v.detach()
                                         for k, v in last.items()},
        mesh=mesh, n_micro=n_micro)
    return dict(loss=loss.reshape(1), dx=dx,
                **{f"grad {k}": v for k, v in g.items()},
                **{f"last grad {k}": v for k, v in lg.items()})


def _pp_reference(body, parts, x, labels, ct, n_micro, chunk):
    """World 1 on the same inputs: ``stage_fn`` over every layer (the
    model's ``_decoder_chunk``), autograd for the gradients; the stacked
    gradients cut to the rank's ``chunk`` of layers."""
    _, stacked, last, _, stage_fn, last_fn = parts
    w = {k: v.detach().clone().requires_grad_() for k, v in stacked.items()}
    xl = x.detach().clone().requires_grad_()
    lp = {k: v.detach().clone().requires_grad_() for k, v in last.items()}
    if body == "gpipe":
        y = stage_fn(w, xl)
        y.backward(ct)
        out = dict(out=y.detach())
    else:
        mb = x.shape[0] // n_micro
        loss = sum(last_fn(lp, stage_fn(w, xl[i * mb:(i + 1) * mb]),
                           labels[i * mb:(i + 1) * mb])
                   for i in range(n_micro)) / n_micro
        loss.backward()
        out = dict(loss=loss.detach().reshape(1),
                   **{f"last grad {k}": v.grad for k, v in lp.items()})
    out["dx"] = xl.grad
    out.update({f"grad {k}": v.grad[chunk] for k, v in w.items()})
    return out


def pp_bodies(fa, fc, rm, C, pl, LlamaForCausalLMPipe, cfg, batch, n_micro,
              mesh, seed, device="cuda"):
    """16a on this rank: ``spmd_pipeline`` (the backward of a seeded
    cotangent) and ``pipeline_1f1b`` (the model's ``last_fn``: final norm,
    head, CE) on the whole seed-0 stack of ``LlamaForCausalLMPipe(cfg)``,
    each rank running its chunk, against world 1 on the same inputs
    (``_pp_reference``), every result under ``judge_rel`` at bf16's
    ``PP_REL_TOL``; rows 1-3 launches counted around each body; the
    planted faults of ``PP_FAULTS`` must fail the judge on some rank."""
    seed(0)
    model = LlamaForCausalLMPipe(cfg, device=device)
    parts = model.pipeline_parts()
    ids, labels = sep_batch(cfg.vocab_size, *batch, device=device)
    x = parts[3](parts[0], ids).detach()
    gen = torch.Generator(device=device).manual_seed(16)
    ct = torch.randn(x.shape, generator=gen, device=device, dtype=x.dtype)
    n, p = mesh.axis_size("pp"), mesh.axis_index("pp")
    k = cfg.num_hidden_layers // n
    chunk = slice(p * k, (p + 1) * k)
    res = {}
    for body in PP_SCHEDULES:
        want = _pp_reference(body, parts, x, labels, ct, n_micro, chunk)
        _reset(fa, fc, rm)
        got = _pp_body(pl, body, parts, x, labels, ct, mesh, n_micro)
        if x.is_cuda:
            torch.cuda.synchronize()
        launches = _counts(fa, fc, rm)
        judged = {key: judge_rel(got[key], v, PP_REL_TOL)
                  for key, v in want.items()}
        faults = {}
        for fault, (_, bodies) in PP_FAULTS.items():
            if body in bodies:
                with pp_fault(pl, C, fault):
                    bad = _pp_body(pl, body, parts, x, labels, ct, mesh,
                                   n_micro)
                faults[fault] = all(judge_rel(bad[key], v, PP_REL_TOL)[2]
                                    for key, v in want.items())
        res[body] = dict(judged={key: j[:2] for key, j in judged.items()},
                         ok=all(j[2] for j in judged.values()),
                         launches=launches,
                         max_in_flight=pl.counters["max_in_flight"],
                         faults_passed=faults)
        del want, got
    del model, parts
    if x.is_cuda:
        torch.cuda.empty_cache()
    return res


def pipe_trainer(LlamaForCausalLMPipe, cfg, fleet, optimizer, seed,
                 schedule, n_micro, device="cuda"):
    """Phase 16's trainer: ``LlamaForCausalLMPipe`` from seed 0 (its
    fingerprint taken before placement), placed by
    ``fleet.distributed_model`` on the current mesh, AdamW(lr=1e-4,
    wd=0.01, multi_precision) as phase 8's; the GPipe step
    (``make_train_step``) or the 1F1B one (``make_1f1b_train_step``)."""
    seed(0)
    bare = LlamaForCausalLMPipe(cfg, n_micro=n_micro, device=device)
    fingerprint = weights_fingerprint(bare)
    model = fleet.distributed_model(bare)
    adam = optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                           parameters=model.parameters())
    if schedule == "1f1b":
        step = fleet.make_1f1b_train_step(model, adam, n_micro=n_micro)
    else:
        step = fleet.distributed_optimizer(adam).make_train_step(
            model, lambda m, x, y: m(x, labels=y))
    return model, step, fingerprint


def _pp_worker(workdir, cfg, batch, n_micro, steps, fingerprint,
               device="cuda"):
    """One of phase 16's two ranks on cuda:0 (gloo): 16a's bodies, then
    16b's GPipe and 1F1B steps from the seed-0 weights (their fingerprint
    checked against the world-1 run's), each step's counts set to 0
    before it and read after it."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_ce as fc
    from paddle_tpu_torch.ops import pipeline as pl
    from paddle_tpu_torch.ops import ragged_matmul as rm
    from paddle_tpu_torch.text.models import LlamaForCausalLMPipe

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env(backend="gloo", device="cuda:0" if device == "cuda"
                           else device, timeout=900)
    rank = dist.get_rank()
    s = fleet.DistributedStrategy()
    s.hybrid_configs["pp_degree"] = PP_DEGREE
    fleet.init(is_collective=True, strategy=s)
    mesh = fleet.get_hybrid_communicate_group().mesh
    out = dict(rank=rank, stage=mesh.axis_index("pp"), cells={},
               bodies=pp_bodies(fa, fc, rm, C, pl, LlamaForCausalLMPipe, cfg,
                                batch, n_micro, mesh, pt.seed, device))
    for schedule in PP_SCHEDULES:
        model, step, fp = pipe_trainer(LlamaForCausalLMPipe, cfg, fleet,
                                       optimizer, pt.seed, schedule, n_micro,
                                       device)
        if fp != fingerprint:
            raise AssertionError(f"rank {rank} {schedule}: the seed-0 "
                                 "weights differ from the world-1 run's")
        ids, labels = sep_batch(cfg.vocab_size, *batch, device=device)
        if ids.is_cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        staged = C.host_staged["batch_isend_irecv"]
        losses, secs, per_step = run_steps(
            fa, fc, rm, step, ids, steps + 1,
            tag=f"[rank {rank}, {schedule}] ", labels=labels)
        out["cells"][schedule] = dict(
            losses=losses, step_secs=secs, launches=per_step,
            staged_p2p_per_step=(C.host_staged["batch_isend_irecv"] - staged)
            / (steps + 1),
            max_in_flight=pl.counters["max_in_flight"],
            held={k: list(p.shape) for k, p in model.named_parameters()},
            peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                      if ids.is_cuda else 0.0))
        del step, model
        if ids.is_cuda:
            torch.cuda.empty_cache()
    with open(os.path.join(workdir, f"pp.r{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def phase_pp(fa, fc, rm, LlamaConfig, LlamaForCausalLMPipe, fleet, optimizer,
             seed, cfg=None, batch=PP_BATCH, n_micro=PP_MICRO, steps=3,
             workdir="build/phase16", device="cuda"):
    """Phase 16: pipeline-parallel training. The world-1 run on the card
    (pp 1: ``_decoder_chunk`` over every layer), then two gloo ranks
    sharing the card (``_pp_worker``): 16a, ``spmd_pipeline`` and
    ``pipeline_1f1b`` against world 1 under ``judge_rel`` (bf16
    ``PP_REL_TOL``), rows 1-3 launches per rank equal to
    ``want_pp_launches``, all on the tensor cores, and the planted faults
    failing; 16b, ``pp_degree=2`` GPipe then 1F1B, a warm-up and ``steps``
    steps each: every rank's losses within ``PP_REL_TOL`` of world 1's,
    launches per rank and step equal to ``want_pp_launches``, host-staged
    point-to-point calls per step equal to ``pp_p2p_calls``, 1F1B's
    ``max_in_flight`` at most ``PP_DEGREE - stage``, each rank holding
    only its chunk. Times are two processes sharing one card through the
    host: not multi-GPU speeds."""
    import shutil

    from paddle_tpu_torch import distributed as dist
    if cfg is None:
        cfg = LlamaConfig(num_hidden_layers=PP_LAYERS)
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    smi = smi_line()
    B, L = batch
    layers = cfg.num_hidden_layers
    try:
        model, step, fingerprint = pipe_trainer(
            LlamaForCausalLMPipe, cfg, fleet, optimizer, seed, "gpipe",
            n_micro, device)
        ids, labels = sep_batch(cfg.vocab_size, *batch, device=device)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, secs, per_step = run_steps(fa, fc, rm, step, ids, steps + 1,
                                           tag="world 1: ", labels=labels)
        peak = torch.cuda.max_memory_allocated() / 2**30
        del step, model
        torch.cuda.empty_cache()
        want1 = want_pp_launches(layers, 1)
        for i, c in enumerate(per_step):
            if c != want1:
                raise AssertionError(f"16b world 1 step {i} launched {c}, "
                                     f"want {want1}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"16b world 1: non-finite loss {losses}")
        t0 = time.perf_counter()
        dist.spawn(_pp_worker, args=(workdir, cfg, batch, n_micro, steps,
                                     fingerprint, device),
                   nprocs=PP_DEGREE, timeout=900)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(PP_DEGREE):
            with open(os.path.join(workdir, f"pp.r{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    per_stage = layers // PP_DEGREE
    want = want_pp_launches(per_stage, n_micro)
    step1 = float(np.median(secs[1:]))
    result = dict(world1=dict(losses=losses, step_ms=step1 * 1e3,
                              tokens_per_s=B * L / step1, peak_gib=peak,
                              launches=per_step[-1]),
                  spawn_s=spawn_s, bodies={}, cells={})
    # 16a
    for r, rk in enumerate(ranks):
        for body in PP_SCHEDULES:
            b = rk["bodies"][body]
            log(f"  16a {body} rank {r}: (rel all, rel last quarter) "
                + json.dumps(b["judged"]) + f", launches {b['launches']}, "
                f"max in flight {b['max_in_flight']}")
            if not b["ok"]:
                raise AssertionError(f"16a {body} rank {r} fails the judge")
            if b["launches"] != want:
                raise AssertionError(f"16a {body} rank {r} launched "
                                     f"{b['launches']}, want {want}")
            result["bodies"].setdefault(body, {})[f"rank{r}"] = b["judged"]
    for body in PP_SCHEDULES:
        planted = list(ranks[0]["bodies"][body]["faults_passed"])
        for fault in planted:
            if all(rk["bodies"][body]["faults_passed"][fault]
                   for rk in ranks):
                raise AssertionError(f"16a {body}: the planted fault "
                                     f"{PP_FAULTS[fault][0]!r} passes the "
                                     f"judge on every rank")
        log(f"  16a {body} planted faults, each failing the judge: "
            f"{[PP_FAULTS[f][0] for f in planted]}")
    # 16b
    for schedule in PP_SCHEDULES:
        got = [rk["cells"][schedule] for rk in ranks]
        worst = 0.0
        for r, g in enumerate(got):
            rel = max(abs(a - b) / abs(b) for a, b in zip(g["losses"],
                                                           losses))
            worst = max(worst, rel)
            if not rel <= PP_REL_TOL:
                raise AssertionError(f"16b {schedule} rank {r}: losses "
                                     f"{g['losses']} vs world 1 {losses} "
                                     f"(relative {rel:.3g})")
            for i, c in enumerate(g["launches"]):
                if c != want:
                    raise AssertionError(f"16b {schedule} rank {r} step {i} "
                                         f"launched {c}, want {want}")
            stage = ranks[r]["stage"]
            calls = pp_p2p_calls(schedule, PP_DEGREE, stage, n_micro)
            if g["staged_p2p_per_step"] != calls:
                raise AssertionError(f"16b {schedule} rank {r}: "
                                     f"{g['staged_p2p_per_step']} host-staged "
                                     f"point-to-point calls a step, want "
                                     f"{calls}")
            cap = (min(PP_DEGREE - stage, n_micro) if schedule == "1f1b"
                   else n_micro)
            if g["max_in_flight"] != cap:
                raise AssertionError(f"16b {schedule} rank {r}: "
                                     f"{g['max_in_flight']} micro-batches in "
                                     f"flight, want {cap}")
            if g["held"]["wq"][0] != per_stage:
                raise AssertionError(f"16b rank {r} holds {g['held']['wq']} "
                                     f"of wq, want {per_stage} layers")
        med = [float(np.median(g["step_secs"][1:])) for g in got]
        result["cells"][schedule] = dict(
            losses=got[0]["losses"], max_rel_to_world1=worst,
            step_ms_per_rank=[m * 1e3 for m in med],
            tokens_per_s=B * L / max(med),
            peak_gib_per_rank=[g["peak_gib"] for g in got],
            launches_per_rank_step=[g["launches"][-1] for g in got],
            staged_p2p_per_rank_step=[g["staged_p2p_per_step"] for g in got],
            max_in_flight_per_rank=[g["max_in_flight"] for g in got])
        log(f"  16b {schedule}, pp {PP_DEGREE} over gloo on one card: losses "
            f"{got[0]['losses']} vs world 1 {losses}, worst relative "
            f"{worst:.3g} (limit {PP_REL_TOL}); step "
            f"{[round(m * 1e3, 1) for m in med]} ms per rank, "
            f"{B * L / max(med):.1f} tokens/s, peak "
            f"{[round(g['peak_gib'], 2) for g in got]} GiB per rank, "
            f"host-staged point-to-point calls per rank and step "
            f"{[g['staged_p2p_per_step'] for g in got]}, in flight "
            f"{[g['max_in_flight'] for g in got]} (two processes sharing one "
            f"card through gloo: not a multi-GPU speed; {smi})")
    log(f"  16b world 1 on the card: step {step1 * 1e3:.1f} ms, "
        f"{B * L / step1:.1f} tokens/s, peak {peak:.2f} GiB ({smi}); spawn "
        f"and both pp runs {spawn_s:.1f} s")
    return result


# ---------------------------------------------------------------------------
# phase 17: GPT-2 small training
# ---------------------------------------------------------------------------

GPT2_TRAIN_BATCH = (8, 1024)
TRAIN_STEPS = 4                 # a warm-up + 3 timed steps


def gpt2_train_ids(vocab, B, L, device="cuda"):
    """Phase 17's batch: one repeated B x L batch of seeded random ids (the
    labels are the ids, shifted inside the model)."""
    return torch.from_numpy(np.random.default_rng(5).integers(
        0, vocab, (B, L))).to(device)


def gpt2_trainer(GPTForCausalLM, cfg, fleet, optimizer, seed, weights=None,
                 device="cuda"):
    """GPT-2 from seed 0 (or ``weights``: name -> full array) placed by
    ``fleet.distributed_model`` on the current mesh, and
    ``fleet.distributed_optimizer(AdamW(lr=1e-4, wd=0.01))
    .make_train_step``."""
    from paddle_tpu_torch.framework.io import load_numpy_state_dict
    seed(0)
    model = fleet.distributed_model(GPTForCausalLM(cfg, device=device))
    if weights is not None:
        load_numpy_state_dict(model, weights)
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        learning_rate=1e-4, weight_decay=0.01,
        parameters=model.parameters()))
    return model, opt.make_train_step(model, lambda m, x, y: m(x, labels=y))


def want_attention_launches(layers, ragged=0):
    """Rows 1-3 once per layer and step (and row 7 ``ragged`` times), all
    on the tensor cores; no fused head."""
    want = dict(flash_attention_fwd=layers, flash_attention_bwd_dq=layers,
                flash_attention_bwd_dkv=layers, fused_ce_stats=0,
                ragged_group_matmul=ragged)
    want.update({k + "_tc": v for k, v in list(want.items())})
    return want


def _rank_device(device):
    """The device both ranks of a pair share: cuda:0 on the card."""
    return "cuda:0" if device == "cuda" else device


def check_pair(tag, ranks, world1, want, tol=PAIR_REL_TOL):
    """Every rank's losses within ``tol`` relative of world 1's, equal on
    both ranks, and its launches per step ``want``; returns the worst
    relative loss difference."""
    worst = 0.0
    for r, g in enumerate(ranks):
        rel = max(abs(a - b) / abs(b) for a, b in zip(g["losses"], world1))
        worst = max(worst, rel)
        if not rel <= tol:
            raise AssertionError(f"{tag} rank {r}: losses {g['losses']} vs "
                                 f"world 1 {world1} (relative {rel:.3g})")
        for i, c in enumerate(g["launches"]):
            if c != want:
                raise AssertionError(f"{tag} rank {r} step {i} launched "
                                     f"{c}, want {want}")
    if ranks[0]["losses"] != ranks[1]["losses"]:
        raise AssertionError(f"{tag}: the ranks' losses differ: "
                             f"{ranks[0]['losses']} {ranks[1]['losses']}")
    return worst


def _gpt_tp_worker(workdir, cfg, batch, steps, device):
    """One of 17b's two ranks on ``device`` (gloo): GPT-2 under
    mp_degree=2 from the saved weights, ``steps`` steps on phase 17's
    batch."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_ce as fc
    from paddle_tpu_torch.ops import ragged_matmul as rm
    from paddle_tpu_torch.text.models import GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env(backend="gloo", device=device, timeout=600)
    rank = dist.get_rank()
    fleet.init(is_collective=True, strategy=_strategy(fleet, mp_degree=2))
    model, step = gpt2_trainer(GPTForCausalLM, cfg, fleet, optimizer,
                               pt.seed, saved_weights(workdir),
                               device=device)
    ids = gpt2_train_ids(cfg.vocab_size, *batch, device=device)
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    losses, secs, per_step = run_steps(fa, fc, rm, step, ids, steps,
                                       tag=f"[rank {rank}, tp2] ",
                                       warm_up=False)
    out = dict(rank=rank, losses=losses, step_secs=secs, launches=per_step,
               qkv_shape=list(model.gpt.blocks[0].qkv.weight.shape),
               peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                         if device != "cpu" else 0.0))
    with open(os.path.join(workdir, f"gpt_tp.r{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def phase_gpt2_train(fa, fc, rm, GPTConfig, GPTForCausalLM, fleet, optimizer,
                     seed, cfg=None, batch=GPT2_TRAIN_BATCH,
                     workdir="build/phase17", device="cuda"):
    """17a: GPT-2 small at OpenAI's widths (``GPTConfig``'s defaults:
    hidden 768, 12 layers, 12 heads, FFN 3072, vocab 50,304, dropout
    0.1), bf16, AdamW(lr=1e-4, wd=0.01), a warm-up + 3 steps on one
    repeated 8 x 1024 batch, one card: the loss finite, its first value
    within 1.0 of ln 50304, the last timed below the first (dropout makes
    it noisy); rows 1-3 once per layer and step, all on the tensor cores,
    on the q/k/v views of the fused qkv; the step time, tokens/s and peak
    memory, and one profiled step. 17b: the same weights (saved as numpy
    arrays) under ``mp_degree=2`` as two gloo ranks on the card: every
    rank's losses within ``PAIR_REL_TOL`` of 17a's (the ranks seed alike,
    so their dropout masks are 17a's), rows 1-3 once per layer and step
    on each rank's 6 heads, all ``"tc"``. Returns (17a's launches per
    step, the report)."""
    import shutil

    from paddle_tpu_torch import distributed as dist
    cfg = cfg or GPTConfig(dtype="bfloat16")
    B, L = batch
    fleet.init()                        # world 1: the default mesh
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        model, step = gpt2_trainer(GPTForCausalLM, cfg, fleet, optimizer,
                                   seed, device=device)
        save_weights(workdir, model)
        n_params = sum(p.numel() for p in model.parameters())
        log(f"  17a: {n_params / 1e6:.1f}M params, batch {B} x {L}, "
            f"AdamW(lr=1e-4, wd=0.01), dropout {cfg.dropout}")
        ids = gpt2_train_ids(cfg.vocab_size, B, L, device=device)
        if device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        losses, secs, per_step = run_steps(fa, fc, rm, step, ids,
                                           TRAIN_STEPS, tag="17a ")
        peak = (torch.cuda.max_memory_allocated() if device != "cpu"
                else 0)
        step_s = float(np.median(secs[1:]))
        log(f"  17a step time median {step_s * 1e3:.1f} ms over 3, "
            f"{B * L / step_s:.1f} tokens/s, peak memory "
            f"{peak / 2**30:.2f} GiB ({smi_line()})")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"17a: non-finite loss {losses}")
        if abs(losses[0] - np.log(cfg.vocab_size)) > 1.0:
            raise AssertionError(f"17a: first loss {losses[0]} not within "
                                 f"1.0 of ln({cfg.vocab_size})")
        if not losses[3] < losses[1]:
            raise AssertionError(f"17a: the last timed loss is not below "
                                 f"the first: {losses[1:]}")
        want = want_attention_launches(cfg.num_hidden_layers)
        for i, c in enumerate(per_step):
            if c != want:
                raise AssertionError(f"17a step {i} launched {c}, want "
                                     f"{want}")
        prof = profile_step(step, ids, ids) if device != "cpu" else None
        log("  17a profiled step " + json.dumps(prof))
        del step, model
        if device != "cpu":
            torch.cuda.empty_cache()
        dist.spawn(_gpt_tp_worker, args=(workdir, cfg, batch, TRAIN_STEPS,
                                         _rank_device(device)),
                   nprocs=2, timeout=900)
        ranks = []
        for r in range(2):
            with open(os.path.join(workdir, f"gpt_tp.r{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    worst = check_pair("17b tp2", ranks, losses, want)
    h = cfg.hidden_size
    if ranks[0]["qkv_shape"] != [h, 3 * h // 2]:
        raise AssertionError(f"17b: a rank's qkv is {ranks[0]['qkv_shape']}")
    log(f"  17b tp2: losses {ranks[0]['losses']} vs 17a {losses} (worst "
        f"relative {worst:.3g}); step times "
        f"{[[round(t, 3) for t in g['step_secs']] for g in ranks]} s per "
        f"rank (two ranks sharing one card through gloo: not multi-GPU "
        f"speeds)")
    return per_step[1], dict(
        losses=losses, step_ms=step_s * 1e3, step_secs=secs,
        tokens_per_s=B * L / step_s, peak_gib=peak / 2**30, profile=prof,
        tp2=dict(losses=ranks[0]["losses"], max_rel_to_world1=worst,
                 step_secs=[g["step_secs"] for g in ranks],
                 peak_gib=[g["peak_gib"] for g in ranks],
                 launches_per_rank_step=ranks[0]["launches"][-1]))


# ---------------------------------------------------------------------------
# phase 18: expert-parallel ERNIE-MoE training
# ---------------------------------------------------------------------------

EP_DEGREE = 2
# the gradients phase 18 holds against world 1's (``ep_grads``): the norm
# that feeds the first MoE layer (block 1), reached only through the
# experts' dx; its gate, reached through the routing weights; and block
# 0's attention, upstream of it
EP_PROBED = ("ernie.blocks.1.ln_2.weight", "ernie.blocks.1.moe.gate.weight",
             "ernie.blocks.0.qkv.weight")
EP_FAULTS = {
    "dx_not_reduced": "the expert input's dx not all-reduced over tp",
    "reduce_backward_sums": "reduce_from_tp's backward summing over tp",
}


class _SumBothWays(torch.autograd.Function):
    """All-reduce forward and backward: ``reduce_from_tp`` with a backward
    that sums the ranks' equal cotangents (tp x the gradient)."""

    @staticmethod
    def forward(ctx, x, group):
        from paddle_tpu_torch.distributed.collective import all_reduce
        ctx.group = group
        return all_reduce(x.contiguous().clone(), group=group)

    @staticmethod
    def backward(ctx, g):
        from paddle_tpu_torch.distributed.collective import all_reduce
        return all_reduce(g.contiguous().clone(), group=ctx.group), None


def ep_fault(moe, fault):
    """A context that plants ``fault`` (a key of ``EP_FAULTS``) into the
    port's ``nn.moe``."""
    from unittest import mock
    if fault == "dx_not_reduced":
        real = moe.copy_to_tp
        # the expert input is the one 2-d operand of copy_to_tp; the
        # routing weights (1-d) and the dense combine (3-d) keep theirs
        return mock.patch.object(
            moe, "copy_to_tp", lambda x, g: x if x.dim() == 2 else real(x, g))
    return mock.patch.object(
        moe, "reduce_from_tp",
        lambda x, g: x if g.nranks == 1 else _SumBothWays.apply(x, g))


def ernie_batch(vocab, B, L, device="cuda"):
    """Phase 9's batch: random ids and labels."""
    rng = np.random.default_rng(4)
    return tuple(torch.from_numpy(rng.integers(0, vocab, (B, L))).to(device)
                 for _ in range(2))


def ep_grads(model, ids, labels, seed):
    """The gradients of ``EP_PROBED`` from one forward and backward on the
    batch (dropout masks from ``seed(1)``), as float32 numpy arrays. The
    gates read their input detached here, so the norm before an MoE
    layer gets the experts' dx alone: at random weights (Xavier with
    ``fan_in = d * f`` on the banks) the experts' share of dx is ~1% of
    the gate's, and a wrong expert dx would hide under it."""
    from unittest import mock

    from paddle_tpu_torch.nn.moe import TopKGate
    logits = TopKGate._logits
    seed(1)
    model.zero_grad(set_to_none=True)
    with mock.patch.object(TopKGate, "_logits",
                           lambda gate, x: logits(gate, x.detach())):
        model(ids, labels=labels).backward()
    params = dict(model.named_parameters())
    out = {k: params[k].grad.float().cpu().numpy() for k in EP_PROBED}
    model.zero_grad(set_to_none=True)
    return out


def ep_train(fa, fc, rm, model, cfg, fleet, optimizer, seed, ids, labels,
             steps, tag):
    """``steps`` steps of AdamW(lr=1e-4) on the batch (dropout masks from
    ``seed(2)``): (losses, seconds, launches per step, the expert inputs'
    shapes the ragged matmul took)."""
    from paddle_tpu_torch.nn import moe as moe_mod
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        learning_rate=1e-4, parameters=model.parameters()))
    step = opt.make_train_step(model, lambda m, x, y: m(x, labels=y))
    shapes = set()
    real = moe_mod.ragged_dot

    def ragged(x, w, counts):
        shapes.add(tuple(x.shape))
        return real(x, w, counts)

    from unittest import mock
    seed(2)
    with mock.patch.object(moe_mod, "ragged_dot", ragged):
        losses, secs, per_step = run_steps(fa, fc, rm, step, ids, steps,
                                           tag=tag, labels=labels)
    return step, losses, secs, per_step, sorted(shapes)


def _ep_worker(workdir, cfg, batch, steps, tp, backend="gloo",
               device="cuda:0", profile=False, faults=True):
    """One of ``tp`` expert-parallel ranks (phase 18: two gloo ranks on
    cuda:0; ``tools/torch_ep_train.py``: NCCL, one card a rank): the
    model from the saved weights under ``mp_degree=tp``, the probed
    gradients (and with each planted fault), then ``steps`` steps."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework.device import resolve_device
    from paddle_tpu_torch.framework.io import load_numpy_state_dict
    from paddle_tpu_torch.nn import moe as moe_mod
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_ce as fc
    from paddle_tpu_torch.ops import ragged_matmul as rm
    from paddle_tpu_torch.text.models import ErnieMoEForPretraining

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env(backend=backend, device=device, timeout=900)
    dev = resolve_device(None)
    rank = dist.get_rank()
    fleet.init(is_collective=True, strategy=_strategy(fleet, mp_degree=tp))
    pt.seed(0)
    model = fleet.distributed_model(ErnieMoEForPretraining(cfg, device=dev))
    load_numpy_state_dict(model, saved_weights(workdir))
    for m in model.moe_layers():
        m.dispatch_mode, m.expert_kernel = "sparse", "ragged"
    ids, labels = ernie_batch(cfg.vocab_size, *batch, device=dev)
    grads = {"": ep_grads(model, ids, labels, pt.seed)}
    for fault in (EP_FAULTS if faults else ()):
        with ep_fault(moe_mod, fault):
            grads[fault] = ep_grads(model, ids, labels, pt.seed)
    np.savez(os.path.join(workdir, f"ep_grads.r{rank}.npz"),
             **{f"{f}|{k}": v for f, g in grads.items() for k, v in g.items()})
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    step, losses, secs, per_step, shapes = ep_train(
        fa, fc, rm, model, cfg, fleet, optimizer, pt.seed, ids, labels,
        steps, f"[rank {rank}, mp{tp}] ")
    from paddle_tpu_torch.distributed import collective as C
    out = dict(rank=rank, backend=torch.distributed.get_backend(),
               losses=losses, step_secs=secs, launches=per_step,
               ragged_shapes=shapes, host_staged=sum(C.host_staged.values()),
               banks=sorted({tuple(p.shape)
                             for k, p in model.named_parameters()
                             if k.endswith("w_up")}),
               peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                         if dev.type == "cuda" else 0.0))
    if profile:
        out["profile"] = profile_step(step, ids, labels)
    with open(os.path.join(workdir, f"ep.r{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def ep_world1(fa, fc, rm, cfg, batch, steps, ErnieMoEForPretraining, fleet,
              optimizer, seed, workdir, device="cuda"):
    """World 1 on one card: the model from seed 0 (its weights saved for
    the ranks), the probed gradients, then ``steps`` steps."""
    fleet.init()                        # world 1: the default mesh
    seed(0)
    model = fleet.distributed_model(ErnieMoEForPretraining(cfg,
                                                           device=device))
    save_weights(workdir, model)
    for m in model.moe_layers():
        m.dispatch_mode, m.expert_kernel = "sparse", "ragged"
    ids, labels = ernie_batch(cfg.vocab_size, *batch, device=device)
    grads = ep_grads(model, ids, labels, seed)
    step, losses, secs, per_step, shapes = ep_train(
        fa, fc, rm, model, cfg, fleet, optimizer, seed, ids, labels, steps,
        "world 1: ")
    del step, model
    if device != "cpu":
        torch.cuda.empty_cache()
    return dict(grads=grads, losses=losses, step_secs=secs,
                launches=per_step, ragged_shapes=shapes)


def check_ep(tag, ranks, grads, world1, want, tp, faults=True):
    """Each rank's probed gradients within 1e-2 of world 1's under
    ``judge_rel`` (and every planted fault failing it), its losses within
    ``PAIR_REL_TOL``, its launches per step ``want``, its banks and
    expert inputs at ``E / tp`` experts. Returns the report's numbers."""
    rels = {}
    for r, g in enumerate(grads):
        for k in EP_PROBED:
            a, t, ok = judge_rel(torch.from_numpy(g[f"|{k}"]),
                                 torch.from_numpy(world1["grads"][k]), 1e-2)
            rels[f"rank{r} {k}"] = [a, t]
            if not ok:
                raise AssertionError(f"{tag} rank {r}: the gradient of {k} "
                                     f"is {a:.3g} / {t:.3g} from world 1's")
        for fault in (EP_FAULTS if faults else ()):
            bad = [judge_rel(torch.from_numpy(g[f"{fault}|{k}"]),
                             torch.from_numpy(world1["grads"][k]), 1e-2)
                   for k in EP_PROBED]
            log(f"  {tag} rank {r}, planted fault ({EP_FAULTS[fault]}): "
                + ", ".join(f"{k} {a:.3e} / {t:.3e}"
                            for k, (a, t, _) in zip(EP_PROBED, bad))
                + (": PASSES (bad)" if all(b[2] for b in bad)
                   else ": fails, as it must"))
            if all(b[2] for b in bad):
                raise AssertionError(f"{tag}: the gradient check does not "
                                     f"see the planted fault {fault}")
    worst = 0.0
    for r, g in enumerate(ranks):
        rel = max(abs(a - b) / abs(b)
                  for a, b in zip(g["losses"], world1["losses"]))
        worst = max(worst, rel)
        if not rel <= PAIR_REL_TOL:
            raise AssertionError(f"{tag} rank {r}: losses {g['losses']} vs "
                                 f"world 1 {world1['losses']} (relative "
                                 f"{rel:.3g})")
        for i, c in enumerate(g["launches"]):
            if c != want:
                raise AssertionError(f"{tag} rank {r} step {i} launched "
                                     f"{c}, want {want}")
        E = world1["ragged_shapes"][0][0]
        want_shapes = [[E // tp] + list(s[1:])
                       for s in world1["ragged_shapes"]]
        if [list(s) for s in g["ragged_shapes"]] != want_shapes:
            raise AssertionError(f"{tag} rank {r}: expert inputs "
                                 f"{g['ragged_shapes']}, want {want_shapes}")
        if [b[0] for b in g["banks"]] != [E // tp]:
            raise AssertionError(f"{tag} rank {r}: banks {g['banks']}")
        if g["host_staged"]:
            raise AssertionError(f"{tag} rank {r}: {g['host_staged']} calls "
                                 "staged through the host")
    return dict(grad_rel=rels, max_rel_to_world1=worst)


def phase_ep(fa, fc, rm, ErnieMoEConfig, ErnieMoEForPretraining, fleet,
             optimizer, seed, cfg=None, batch=ERNIE_BATCH,
             workdir="build/phase18", device="cuda"):
    """Phase 9's configuration (``bench.py:bench_ernie_moe``: vocab 32000,
    hidden 1024, 6 layers, 8 experts top-2, dropout 0.1, 8 x 1024, bf16,
    the ragged kernel) at ``mp_degree=2``, expert parallel, as two gloo
    ranks on the card, against world 1 on the same weights and seeds.
    Each rank: the gradients of ``EP_PROBED`` from one forward and
    backward (``ep_grads``) within 1e-2 of world 1's (``judge_rel``), and
    with each
    planted fault of ``EP_FAULTS`` outside it; a warm-up + 3 steps whose
    losses are within ``PAIR_REL_TOL`` of world 1's; per step 12 ragged
    launches on ``[4, 2560, d]`` expert inputs (4 of the 8 experts) and
    rows 1-3 6 each, all on the tensor cores."""
    import shutil

    from paddle_tpu_torch import distributed as dist
    cfg = cfg or ErnieMoEConfig(**ERNIE_MOE)
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        world1 = ep_world1(fa, fc, rm, cfg, batch, TRAIN_STEPS,
                           ErnieMoEForPretraining, fleet, optimizer, seed,
                           workdir, device=device)
        dist.spawn(_ep_worker, args=(workdir, cfg, batch, TRAIN_STEPS,
                                     EP_DEGREE, "gloo",
                                     _rank_device(device)),
                   nprocs=EP_DEGREE, timeout=900)
        ranks, grads = [], []
        for r in range(EP_DEGREE):
            with open(os.path.join(workdir, f"ep.r{r}.json")) as f:
                ranks.append(json.load(f))
            with np.load(os.path.join(workdir, f"ep_grads.r{r}.npz")) as z:
                grads.append({k: z[k] for k in z.files})
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    n_moe = cfg.num_hidden_layers // cfg.moe_every
    want = want_attention_launches(cfg.num_hidden_layers, ragged=4 * n_moe)
    for i, c in enumerate(world1["launches"]):
        if c != want:
            raise AssertionError(f"18 world 1 step {i} launched {c}, want "
                                 f"{want}")
    res = check_ep("18 mp2", ranks, grads, world1, want, EP_DEGREE)
    log(f"  18 mp2: losses {ranks[0]['losses']} vs world 1 "
        f"{world1['losses']} (worst relative {res['max_rel_to_world1']:.3g})"
        f"; gradients {json.dumps(res['grad_rel'])}; expert inputs "
        f"{ranks[0]['ragged_shapes']}; step times "
        f"{[[round(t, 3) for t in g['step_secs']] for g in ranks]} s per "
        f"rank (gloo through the host: not multi-GPU speeds)")
    return ranks[0]["launches"][-1], dict(
        world1=dict(losses=world1["losses"],
                    step_secs=world1["step_secs"]),
        losses=ranks[0]["losses"], ragged_shapes=ranks[0]["ragged_shapes"],
        step_secs=[g["step_secs"] for g in ranks],
        peak_gib=[g["peak_gib"] for g in ranks], **res)


# ---------------------------------------------------------------------------
# phase 19: the comm-efficient data-parallel strategies
# ---------------------------------------------------------------------------

COMM_FAULTS = {
    "e1_dropped": "the compressed exchange's residual e1 not carried to "
                  "the next step",
    "zero1_slice_off": "ZeRO-1 updating the flat parameters' chunk one rank "
                       "off",
    "dgc_not_cleared": "DGC's sent entries left in the residuals u and v",
    "geo_mean": "the Geo merge averaging the replicas' deltas instead of "
                "summing them",
}


def comm_fault(fault):
    """A context that plants ``fault`` (a key of ``COMM_FAULTS``) into the
    port's comm-efficient steps, each built from the plain method."""
    from unittest import mock

    from paddle_tpu_torch.distributed import comm_opt as co
    from paddle_tpu_torch.distributed.fleet import comm_efficient as ce
    if fault == "e1_dropped":
        real = co.CommOptTrainStep._exchange

        def exchange(self, g, e1):
            mine, new = real(self, g, e1)
            return mine, None if new is None else new.zero_()
        return mock.patch.object(co.CommOptTrainStep, "_exchange", exchange)
    if fault == "zero1_slice_off":
        real = co.CommOptTrainStep._owned
        return mock.patch.object(
            co.CommOptTrainStep, "_owned",
            lambda self, flat: real(self, flat.roll(-self.chunk)))
    if fault == "dgc_not_cleared":
        real = ce.DGCTrainStep._send
        return mock.patch.object(
            ce.DGCTrainStep, "_send",
            lambda self, u, v: real(self, u.clone(), v.clone()))
    real = ce.GeoSGDTrainStep._delta_sum
    return mock.patch.object(ce.GeoSGDTrainStep, "_delta_sum",
                             lambda self, d: real(self, d) / self.dp)


# bench.py:bench_llama's configuration (bench.py:67-71): the 0.5B Llama
# (vocab 32000, hidden 2048, FFN 5504, 16 heads), bf16, here with the fused
# head; phase 19 cuts it to PAIR_LAYERS layers, tools/torch_commopt_train.py
# keeps its 8
COMM_CELL = dict(vocab_size=32000, hidden_size=2048, intermediate_size=5504,
                 num_hidden_layers=8, num_attention_heads=16,
                 num_key_value_heads=16, max_position_embeddings=2048,
                 dtype="bfloat16", fused_ce_chunk=8192)
COMM_LAYERS = 2         # 19's depth cut, below 12b's PAIR_LAYERS
COMM_BATCH = (4, 2048)          # bench_llama's batch: 2 x 2048 a rank at dp2
COMM_DEGREE = 2
# phase 19's arms: (strategy field, its configs, optimizer, planted fault)
COMM_ARMS = {
    "comm_opt_exact": ("comm_opt", {"grad_compress": None}, "adamw", None),
    "comm_opt_zero1": ("comm_opt", {"zero1": True}, "adamw", None),
    "comm_opt_bf16": ("comm_opt", {"grad_compress": "bf16"}, "adamw", None),
    "comm_opt_int8": ("comm_opt", {"grad_compress": "int8"}, "adamw", None),
    "fp16_allreduce_int8": ("fp16_allreduce", {"dtype": "int8"}, "adamw",
                            None),
    "localsgd_k2": ("localsgd", {"k_steps": 2}, "adamw", None),
    "a_sync_k2": ("a_sync", {"k_steps": 2}, "adamw", None),
    "dgc": ("dgc", {"sparsity": 0.99}, "momentum", None),
    "comm_opt_int8_e1_dropped": ("comm_opt", {"grad_compress": "int8"},
                                 "adamw", "e1_dropped"),
}
COMM_COMPRESSED = ("comm_opt_bf16", "comm_opt_int8", "fp16_allreduce_int8",
                   "fp16_allreduce_bf16")
COMM_TOL = 5e-2     # compressed vs exact losses: JAX's int8 bound
                    # (tests/test_comm_opt.py:141)
EF_TOL = 1e-3       # error-feedback conservation, relative (fp32 rounding
                    # of c = g + e1: ~1.5e-5)


def comm_probe(C):
    """Which of the collectives the comm-efficient exchanges send gloo (or
    the backend) carries between this world's ranks, through the port's
    wrappers, in the dtypes they send: ``{name: "ok" or the error}``,
    each checked for its values."""
    world = C.get_group()
    n, r = world.nranks, world.rank
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if torch.cuda.is_available() else torch.device("cpu")
    out = {}
    for dt in (torch.int8, torch.bfloat16, torch.float32, torch.int64):
        tag = str(dt).split(".")[1]
        x = torch.full((n, 4), r + 1, dtype=dt, device=dev)
        cases = {
            "all_to_all_single": (lambda: C.alltoall_single(x),
                                  lambda y: all(bool((y[i] == i + 1).all())
                                                for i in range(n))),
            "all_gather": (lambda: C.all_gather(None, x[0]),
                           lambda y: all(bool((y[i] == i + 1).all())
                                         for i in range(n))),
        }
        if dt in (torch.float32,):
            total = n * (n + 1) // 2
            cases.update({
                "reduce_scatter": (lambda: C.reduce_scatter(x.clone()),
                                   lambda y: bool((y == total).all())),
                "all_reduce": (lambda: C.all_reduce(x.clone()),
                               lambda y: bool((y == total).all())),
                "broadcast": (lambda: C.broadcast(x.clone(), src=0),
                              lambda y: bool((y == 1).all()))})
        for name, (run, ok) in cases.items():
            try:
                y = run()
                if dev.type == "cuda":
                    torch.cuda.synchronize()
                out[f"{name}_{tag}"] = "ok" if ok(y) else "wrong values"
            except RuntimeError as e:
                out[f"{name}_{tag}"] = f"{type(e).__name__}: {str(e)[:160]}"
    return out


class EFProbe:
    """Error feedback's conservation on one rank of a ``CommOptTrainStep``
    with a compressed exchange: ``D = sum_t (g_t - sent_t)`` in fp64, with
    ``sent_t`` the rows this rank puts on the wire (read from the
    all-to-all's payload, dequantized), must equal the residual ``e1``
    after the last step: what the quantizer dropped is delayed, not lost.
    ``rel()`` is ``|D - e1| / max(|D|, |e1|)``."""

    def __init__(self, step):
        from paddle_tpu_torch.distributed import collective as C
        from paddle_tpu_torch.distributed.fleet import comm_efficient as ce
        self.step, self.C, self.ce = step, C, ce
        self.d = None

    def _exchange(self, g, e1):
        C, step, sent = self.C, self.step, []
        real = C.alltoall_single

        def a2a(x, *a, **k):
            sent.append(x.clone())
            return real(x, *a, **k)
        C.alltoall_single = a2a
        try:
            mine, new = type(step)._exchange(step, g, e1)
        finally:
            C.alltoall_single = real
        rows = (self.ce._dequant_blocks(sent[0], sent[1], step.nblk)
                if step.grad_compress == "int8" else sent[0].float())
        if self.d is None:
            self.d = torch.zeros(g.shape, dtype=torch.float64,
                                 device=g.device)
        self.d += g.double() - rows.reshape(-1).double()
        return mine, new

    def __enter__(self):
        self.step._exchange = self._exchange
        return self

    def __exit__(self, *exc):
        del self.step._exchange

    def rel(self):
        e1 = self.step._ef["e1"].double()
        den = max(float(self.d.norm()), float(e1.norm()), 1e-300)
        return float((self.d - e1).norm()) / den


def wire_bytes(step, n_steps):
    """Logical payload a step sends through its dp collectives, per rank
    and step: each collective's full output, the convention of the JAX
    package's byte plan (``CommOptTrainStep.exchange_bytes``)."""
    kind = type(step).__name__
    if kind == "CommOptTrainStep":
        return step.exchange_bytes
    if kind == "CompressedAllreduceTrainStep":
        n = step._N + step._pad
        return (4 * n if step.dtype == "bfloat16"
                else 2 * (n + 4 * step.nblk * step.dp))
    if kind == "DGCTrainStep":
        return 12 * step.k * step.dp            # int64 indices + fp32 values
    params = list(step._params.values())
    n = sum(p.numel() for p in params)
    if kind == "LocalSGDTrainStep":
        return 4 * n * step.syncs / n_steps     # fp32 parameter all-reduces
    if kind == "GeoSGDTrainStep":
        return 4 * n * step.merges / n_steps
    return sum(p.numel() * p.element_size() for p in params)   # TrainStep


class timed_collectives:
    """CUDA events around every collective the train steps call (the
    port's ``collective`` functions, and the ones ``fleet.train_step``
    imports by name): ``ms()`` sums the elapsed times recorded since
    ``reset()`` (it synchronizes). NCCL's kernels spin while a rank waits,
    so this, not the profiler's busy sum, is the collective time."""

    NAMES = ("all_reduce", "all_gather", "reduce_scatter", "alltoall_single",
             "broadcast", "gather_dim", "reduce_scatter_dim")

    def __init__(self):
        from paddle_tpu_torch.distributed import collective as C
        from paddle_tpu_torch.distributed.fleet import train_step as ts
        self.targets = [(C, n) for n in self.NAMES] + [
            (ts, n) for n in ("all_reduce", "gather_dim",
                              "reduce_scatter_dim")]
        self.pairs, self.saved = [], []

    def _wrap(self, fn):
        def timed(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **k)
            e1.record()
            self.pairs.append((e0, e1))
            return out
        return timed

    def __enter__(self):
        for mod, n in self.targets:
            fn = getattr(mod, n)
            self.saved.append((mod, n, fn))
            setattr(mod, n, self._wrap(fn))
        return self

    def __exit__(self, *exc):
        for mod, n, fn in reversed(self.saved):
            setattr(mod, n, fn)
        self.saved = []

    def reset(self):
        self.pairs = []

    def ms(self):
        torch.cuda.synchronize()
        return float(sum(a.elapsed_time(b) for a, b in self.pairs))


def comm_optimizer(optimizer, kind, params):
    """Phase 8's AdamW (lr 1e-4, wd 0.01), or Momentum 0.9 at lr 1e-4 for
    DGC."""
    if kind == "momentum":
        return optimizer.Momentum(learning_rate=1e-4, momentum=0.9,
                                  parameters=params)
    return optimizer.AdamW(learning_rate=1e-4, weight_decay=0.01,
                           parameters=params)


def _comm_worker(workdir, cfg, batch, steps, arms, backend="gloo",
                 device="cuda:0", timed=False):
    """One of the dp ranks (phase 19: two gloo ranks on cuda:0;
    ``tools/torch_commopt_train.py``: NCCL, one card a rank): the probe,
    then each arm of ``arms`` (name -> (strategy field or None for the
    plain dp ``TrainStep``, its configs, optimizer, planted fault[, steps])
    as in ``COMM_ARMS``) from the saved weights, ``steps`` steps each (a
    planted-fault arm 2), the counts set to 0 before each step and read
    after it; with ``timed``, each step's collective time
    (``timed_collectives``)."""
    import contextlib

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework.device import resolve_device
    from paddle_tpu_torch.framework.io import load_numpy_state_dict
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_ce as fc
    from paddle_tpu_torch.ops import ragged_matmul as rm
    from paddle_tpu_torch.text.models.llama import LlamaForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env(backend=backend, device=device, timeout=900)
    dev = resolve_device(None)
    rank, world = dist.get_rank(), dist.get_world_size()
    out = dict(rank=rank, backend=torch.distributed.get_backend(),
               probe=comm_probe(C), arms={})
    bad = {k: v for k, v in out["probe"].items() if v != "ok"}
    if bad:
        raise AssertionError(f"rank {rank}: the backend does not carry "
                             f"{bad}")
    with np.load(os.path.join(workdir, "batch.npz")) as z:
        ids = torch.from_numpy(z["ids"]).to(dev)
    weights = saved_weights(workdir)
    saved = None
    timer = timed_collectives() if timed else contextlib.nullcontext()
    for name, arm in arms.items():
        field, cfgs, opt_kind, fault = arm[:4]
        s = fleet.DistributedStrategy()
        s.hybrid_configs["dp_degree"] = world
        if field is not None:
            setattr(s, field, True)
            getattr(s, field + "_configs").update(cfgs)
        fleet.init(is_collective=True, strategy=s)
        model = fleet.distributed_model(LlamaForCausalLM(cfg, device=dev))
        load_numpy_state_dict(model, weights)
        step = fleet.distributed_optimizer(comm_optimizer(
            optimizer, opt_kind, model.parameters())).make_train_step(
            model, lambda m, x, y: m(x, labels=y))
        probe = (EFProbe(step) if field == "comm_opt"
                 and cfgs.get("grad_compress") else contextlib.nullcontext())
        planted = (comm_fault(fault) if fault else contextlib.nullcontext())
        n = arm[4] if len(arm) > 4 else 2 if fault else steps
        staged = sum(C.host_staged.values())
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        coll, losses, secs, per_step = [], [], [], []
        with planted, probe, timer:
            for i in range(n):
                if timed:
                    timer.reset()
                got = run_steps(fa, fc, rm, step, ids, 1,
                                tag=f"[rank {rank}, {name} #{i}] ",
                                warm_up=False)
                losses += got[0]
                secs += got[1]
                per_step += got[2]
                if timed:
                    coll.append(timer.ms())
        rep = dict(kind=type(step).__name__, losses=losses, step_secs=secs,
                   launches=per_step, wire_bytes=wire_bytes(step, n),
                   host_staged=sum(C.host_staged.values()) - staged,
                   peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                             if dev.type == "cuda" else 0.0))
        if timed:
            rep["collective_ms"] = coll
        if isinstance(probe, EFProbe):
            rep["ef_rel"] = probe.rel()
        if field == "comm_opt":
            rep["comm_stats"] = step.comm_stats()
            rep["opt_elems"] = step.optimizer_state_elems_per_replica()
        if name in ("comm_opt_exact", "comm_opt_zero1"):
            flat = torch.cat([p.detach().reshape(-1)
                              for p in model.parameters()])
            if saved is None:
                saved = flat
            else:
                rep["bitwise_equal_to_exact"] = bool(torch.equal(saved, flat))
                saved = None
        out["arms"][name] = rep
        del step, model, probe
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    with open(os.path.join(workdir, f"comm.r{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def comm_world1(fa, fc, rm, LlamaForCausalLM, cfg, fleet, optimizer, seed,
                batch, steps, workdir, device="cuda", field=None):
    """World 1 on one card, ``steps`` steps on the whole batch from the
    model of seed 0: phase 8's trainer (its weights and the batch saved
    for the ranks), or with ``field`` (a comm-efficient strategy) that
    strategy's step at world 1 (``comm_opt``: the flat update, which
    keeps no fp32 master copy of a bf16 parameter, as in the JAX
    package)."""
    s = fleet.DistributedStrategy()
    if field is not None:
        setattr(s, field, True)
    fleet.init(is_collective=True, strategy=s)   # world 1: the default mesh
    seed(0)
    model = fleet.distributed_model(LlamaForCausalLM(cfg, device=device))
    step = fleet.distributed_optimizer(comm_optimizer(
        optimizer, "adamw", model.parameters())).make_train_step(
        model, lambda m, x, y: m(x, labels=y))
    ids = train_ids(cfg.vocab_size, *batch, device=device)
    if field is None:
        save_weights(workdir, model)
        np.savez(os.path.join(workdir, "batch.npz"), ids=ids.cpu().numpy())
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    losses, secs, per_step = run_steps(fa, fc, rm, step, ids, steps,
                                       tag=f"world 1, {field or 'plain'}: ")
    n_params = sum(p.numel() for p in model.parameters())
    peak = torch.cuda.max_memory_allocated() / 2**30 if device != "cpu" \
        else 0.0
    del step, model
    if device != "cpu":
        torch.cuda.empty_cache()
    return dict(losses=losses, step_secs=secs, launches=per_step,
                n_params=n_params, peak_gib=peak)


def comm_plain_timings(n, dp, flush, device="cuda"):
    """The plain PyTorch pieces of the exchanges at a flat gradient of
    ``n`` elements, timed on the card: the blockwise int8 quantizer (qblock
    1024) of ``[dp, n/dp]`` and its dequantizer, and DGC's top-k of
    ``|v|`` at 99% sparsity, each beside its memory bound."""
    from paddle_tpu_torch.distributed.fleet import comm_efficient as ce
    n -= n % (dp * 1024)
    g = torch.randn(dp, n // dp, device=device)
    nblk = n // dp // 1024
    q, sc = ce._quant_blocks(g, nblk)
    k = max(1, round(n * 0.01))
    v = g.reshape(-1).abs()
    out = {}
    for name, fn, byts in (
            ("quant_int8", lambda: ce._quant_blocks(g, nblk),
             4 * n + n + 4 * n // 1024),
            ("dequant_int8", lambda: ce._dequant_blocks(q, sc, nblk),
             n + 4 * n // 1024 + 4 * n),
            ("top_k", lambda: ce._top_k(v, k), 4 * n + 8 * k)):
        out[name] = dict(ms=time_ms(fn, flush), shape=[dp, n // dp],
                         k=k if name == "top_k" else None,
                         **bound(byts, 0))
    return out


def check_comm(ranks, world1, flat1, want, tag="19", staged=True):
    """The checks of phase 19 (and ``tools/torch_commopt_train.py``) over
    the ranks' reports (``world1``: phase 8's trainer at world 1;
    ``flat1``: the comm_opt step at world 1; ``staged``: whether a
    collective may go through the host, as gloo's on CUDA tensors do);
    returns the summary."""
    arms = ranks[0]["arms"]
    exact = arms["comm_opt_exact"]["losses"]

    def rel(a, b):
        return max(abs(x - y) / abs(y) for x, y in zip(a, b))

    res = {}
    for name in arms:
        got = [rk["arms"][name] for rk in ranks]
        for r, g in enumerate(got):
            if not all(np.isfinite(g["losses"])):
                raise AssertionError(f"{tag} {name} rank {r}: losses "
                                     f"{g['losses']}")
            for i, c in enumerate(g["launches"]):
                if c != want:
                    raise AssertionError(f"{tag} {name} rank {r} step {i} "
                                         f"launched {c}, want {want}")
            if g["losses"] != got[0]["losses"]:
                raise AssertionError(f"{tag} {name}: the ranks' losses "
                                     f"differ: {[x['losses'] for x in got]}")
            if not staged and g["host_staged"]:
                raise AssertionError(f"{tag} {name} rank {r}: "
                                     f"{g['host_staged']} calls staged "
                                     f"through the host")
        losses = got[0]["losses"]
        rel_w1, rel_flat1 = rel(losses, world1["losses"]), rel(
            losses, flat1["losses"])
        rel_exact = rel(losses, exact)
        if name == "trainstep" and not rel_w1 <= PAIR_REL_TOL:
            raise AssertionError(f"{tag} {name}: losses {losses} vs world 1 "
                                 f"{world1['losses']} ({rel_w1:.3g})")
        if name in ("comm_opt_exact", "comm_opt_zero1") and \
                not rel_flat1 <= PAIR_REL_TOL:
            raise AssertionError(f"{tag} {name}: losses {losses} vs the "
                                 f"comm_opt step at world 1 "
                                 f"{flat1['losses']} ({rel_flat1:.3g})")
        if name in COMM_COMPRESSED and not rel_exact <= COMM_TOL:
            raise AssertionError(f"{tag} {name}: losses {losses} vs the "
                                 f"exact arm's {exact} ({rel_exact:.3g})")
        res[name] = dict(
            kind=got[0]["kind"], losses=losses, rel_to_world1=rel_w1,
            rel_to_flat_world1=rel_flat1, rel_to_exact=rel_exact,
            step_secs=[g["step_secs"] for g in got],
            peak_gib=[g["peak_gib"] for g in got],
            wire_bytes_per_step=got[0]["wire_bytes"],
            host_staged=[g["host_staged"] for g in got],
            **{k: [g[k] for g in got] for k in ("ef_rel", "collective_ms")
               if k in got[0]})
    z1 = [rk["arms"]["comm_opt_zero1"] for rk in ranks]
    if not all(g["bitwise_equal_to_exact"] for g in z1) or \
            z1[0]["losses"] != exact:
        raise AssertionError(f"{tag}: zero1 is not bitwise the replicated "
                             f"flat arm")
    clean = [rk["arms"]["comm_opt_int8"]["ef_rel"] for rk in ranks]
    if not max(clean) <= EF_TOL:
        raise AssertionError(f"{tag} comm_opt_int8: error feedback lost "
                             f"{clean} of the dropped error")
    if "comm_opt_int8_e1_dropped" in arms:
        faulty = [rk["arms"]["comm_opt_int8_e1_dropped"]["ef_rel"]
                  for rk in ranks]
        if not min(faulty) > EF_TOL:
            raise AssertionError(f"{tag}: the planted fault (e1 dropped) "
                                 f"passed the error-feedback judge: {faulty}")
        res["comm_opt_int8_e1_dropped"]["fails_the_judge"] = True
    return res


def phase_comm(fa, fc, rm, LlamaConfig, LlamaForCausalLM, fleet, optimizer,
               seed, cfg=None, batch=COMM_BATCH, layers=COMM_LAYERS,
               workdir="build/phase19", device="cuda", steps=TRAIN_STEPS):
    """``bench.py:bench_llama``'s 0.5B Llama (bf16, the fused head), cut to
    ``layers`` layers, on its 4 x 2048 batch: world 1 on the card (phase 8's
    trainer, and the comm_opt step), then dp2 as two gloo ranks on the
    card (2 x 2048 a rank), from the same weights, under each arm of
    ``COMM_ARMS``: a warm-up + 3 steps each. Checks: every loss finite,
    equal on both ranks; the exact and zero1 arms within ``PAIR_REL_TOL``
    of the comm_opt step at world 1 (a flat update without an fp32
    master: phase 8's trainer, which keeps one, moves otherwise at bf16),
    zero1 bitwise the replicated flat arm (losses and parameters); the
    compressed arms within ``COMM_TOL`` of the exact arm's losses; error
    feedback conserved on the int8 arm (``EFProbe``) and broken by the
    planted fault (e1 dropped); per rank and step rows 1-3 once per layer
    and row 5 once, all on the tensor cores. Also times the plain quantizer and top-k at
    the model's flat size. Times are two processes sharing one card
    through gloo: not multi-GPU speeds."""
    import shutil

    from paddle_tpu_torch import distributed as dist
    cfg = cfg or LlamaConfig(**{**COMM_CELL, "num_hidden_layers": layers})
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        world1 = comm_world1(fa, fc, rm, LlamaForCausalLM, cfg, fleet,
                             optimizer, seed, batch, steps, workdir, device)
        flat1 = comm_world1(fa, fc, rm, LlamaForCausalLM, cfg, fleet,
                            optimizer, seed, batch, steps, workdir, device,
                            field="comm_opt")
        want = want_train_launches(cfg.num_hidden_layers)
        for i, c in enumerate(world1["launches"] + flat1["launches"]):
            if c != want:
                raise AssertionError(f"19 world 1 step {i} launched {c}, "
                                     f"want {want}")
        plain = None
        if device != "cpu":
            flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=device)
            plain = comm_plain_timings(world1["n_params"], COMM_DEGREE, flush)
            del flush
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        dist.spawn(_comm_worker, args=(workdir, cfg, batch, steps,
                                       COMM_ARMS, "gloo",
                                       _rank_device(device)),
                   nprocs=COMM_DEGREE, timeout=900)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(COMM_DEGREE):
            with open(os.path.join(workdir, f"comm.r{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    res = check_comm(ranks, world1, flat1, want)
    log(f"  19 world 1: phase 8's trainer {world1['losses']}, the comm_opt "
        f"step {flat1['losses']}")
    for name, r in res.items():
        log(f"  19 {name}: losses {r['losses']} (relative to world 1 "
            f"{r['rel_to_world1']:.3g}, to the comm_opt step at world 1 "
            f"{r['rel_to_flat_world1']:.3g}, to the exact arm "
            f"{r['rel_to_exact']:.3g}); step times "
            f"{[[round(t, 3) for t in s] for s in r['step_secs']]} s per "
            f"rank (two ranks sharing one card through gloo: not multi-GPU "
            f"speeds); peak {[round(p, 2) for p in r['peak_gib']]} GiB; "
            f"wire {r['wire_bytes_per_step']:.4g} B a step"
            + (f"; error feedback {r['ef_rel']}" if "ef_rel" in r else ""))
    log(f"  19 gloo on CUDA tensors carried every collective the arms send "
        f"in its own dtype (nothing bit-cast): {json.dumps(ranks[0]['probe'])}"
        f"; the plain pieces on the card: {json.dumps(plain)}; spawn "
        f"{spawn_s:.1f} s")
    return ranks[0]["arms"]["comm_opt_int8"]["launches"][-1], dict(
        world1=dict(losses=world1["losses"], step_secs=world1["step_secs"],
                    peak_gib=world1["peak_gib"],
                    n_params=world1["n_params"]),
        world1_comm_opt=dict(losses=flat1["losses"],
                             step_secs=flat1["step_secs"],
                             peak_gib=flat1["peak_gib"]),
        arms=res, probe=ranks[0]["probe"], plain=plain, spawn_s=spawn_s)


# ---------------------------------------------------------------------------
# phase 20: speculative decoding and beam search
# ---------------------------------------------------------------------------

SPEC_K = 4
SPEC_DRAFT_LAYERS = 4   # 20b's small draft: bench_llama's 0.5B widths at 4
                        # of its 8 layers (random: what rejection costs)
SPEC_GEO = dict(n_slots=4, max_len=256, block_size=16, flash_decode=True)
SPEC_SAMPLED = dict(do_sample=True, top_k=50, top_p=0.9, prefill_chunk=64)
SPEC_NEW = 32           # 20a's new tokens a request
SPEC_SERIAL_NEW = 48    # 20b: bench.py:bench_serving_spec's 48
SPEC_STEP_RATIO = 0.6   # target steps per emitted token, self-draft
BEAM_SHAPE = (2, 128)   # 20c: generate(ids[2, 128], 32 new, 4 beams)
BEAM_NEW = 32
BEAM_LOGPROB_TOL = 1e-4


class HostileDraft:
    """A custom proposer (the ``propose`` protocol) that always proposes
    token 9, which the masked requests forbid and the others almost never
    sample: every verify rejects at its first position."""

    def propose(self, ctx, k):
        return np.full(k, 9, np.int32)


def spec_traffic(vocab, seed):
    """20a's mixed traffic: two logit-masked repetitive requests (n-grams
    match: verifies fire) and two random ones (40 and 96 tokens, the
    latter chunked at ``prefill_chunk=64``), as (prompt, submit
    arguments)."""
    rng = np.random.default_rng(seed)
    masks = [np.isin(np.arange(vocab), [7]), None,
             np.isin(np.arange(vocab), [11, 13]), None]
    prompts = [np.full(9, 7, np.int32), rng.integers(0, vocab, 40),
               np.asarray([11, 13] * 5, np.int32), rng.integers(0, vocab, 96)]
    return [(p.astype(np.int32), dict(logit_mask=m))
            for p, m in zip(prompts, masks)]


def spec_run(model, fd, Engine, reqs, max_new, serial=False, **kw):
    """One engine run over ``reqs`` [(prompt, submit arguments)]: staggered
    (a step between submissions) or serial (each request finished before
    the next is submitted); the flash-decode counts reset just before the
    run and read just after. Checks that every request finished with
    ``max_new`` tokens and that the engine freed its KV."""
    free_cycles()
    eng = Engine(model, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fd.flash_decode)
    t0 = time.perf_counter()
    hs = []
    for i, (p, skw) in enumerate(reqs):
        if i and not serial:
            eng.step()
        hs.append(eng.submit(p, max_new_tokens=max_new, **skw))
        if serial:
            eng.drain()
    eng.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    r = dict(tokens=[list(h.tokens) for h in hs], stats=eng.stats(),
             handles=hs, wall_s=wall, launches=fd.flash_decode.launches,
             variants=dict(fd.flash_decode.launches_by_variant),
             peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    if not all(h.finished and h.finish_reason == "length"
               and len(h.tokens) == max_new for h in hs):
        raise AssertionError(f"{kw}: a request did not finish with "
                             f"{max_new} tokens")
    if eng.cache.n_free != eng.n_slots or not eng.cache.check_refcounts():
        raise AssertionError(f"{kw}: the engine did not free its KV")
    return r


def free_cycles():
    """Collect garbage held in reference cycles (an engine and its
    handles hold each other, with its KV pool and a draft's cache), so
    that a peak-memory reading sees one run's tensors only."""
    gc.collect()
    torch.cuda.empty_cache()


def check_spec_launches(what, n_layers, r):
    """Row 4 runs on the speculative engine's plain decode steps only (the
    slots with no proposal, and a request's last token when one remains):
    launches = layers x (decode steps - verifies), all on the split
    kernel. A draft that is always accepted may take no plain step (48
    tokens = the prefill's + 9 verifies of 5 + one of 2), so > 0 is
    required of each phase's runs together (``check_spec_total``)."""
    st = r["stats"]
    want = n_layers * (st["decode_steps"] - st["spec_steps"])
    if r["launches"] != want \
            or r["variants"] != {"split": want, "one_pass": 0}:
        raise AssertionError(f"{what}: flash_decode launched "
                             f"{r['launches']} times ({r['variants']}), want "
                             f"{want} = {n_layers} x (decode steps "
                             f"{st['decode_steps']} - verifies "
                             f"{st['spec_steps']}), all on the split kernel")


def check_spec_total(what, runs):
    """Row 4 launched in the runs of ``what`` (the plain arm's alone
    launches it every decode step)."""
    if sum(x["flash_decode_launches"] for x in runs.values()) <= 0:
        raise AssertionError(f"{what}: flash_decode never launched")


def steps_per_token(st):
    """Target-model steps (decode steps and verifies) per emitted token."""
    return st["decode_steps"] / st["tokens_generated"]


def spec_identity(model, fd, Engine, SpecConfig, what):
    """20a on one fp32 model (TF32 off): greedy, then sampled + chunked
    (temperature 0.6, seeds 1000 + i), the plain engine and the n-gram,
    self-draft and hostile arms at k = 4 on ``spec_traffic``. Every arm's
    tokens must be the plain engine's; row 4's launches obey
    ``check_spec_launches``; the greedy self-draft takes fewer than
    ``SPEC_STEP_RATIO`` target steps a token. Returns per mode and arm the
    printed numbers."""
    n = model.config.num_hidden_layers
    out = {}
    for mode, kw in (("greedy", {}), ("sampled", SPEC_SAMPLED)):
        reqs = spec_traffic(model.config.vocab_size, seed=20)
        if kw:
            reqs = [(p, dict(skw, temperature=0.6, seed=1000 + i))
                    for i, (p, skw) in enumerate(reqs)]
        runs = {}
        for arm, spec in (
                ("plain", None),
                ("ngram", SpecConfig(draft="ngram", k=SPEC_K)),
                ("self_draft", SpecConfig(draft=model, k=SPEC_K)),
                ("hostile", SpecConfig(draft=HostileDraft(), k=SPEC_K))):
            r = spec_run(model, fd, Engine, reqs, SPEC_NEW, **SPEC_GEO,
                         **kw, speculative=spec)
            check_spec_launches(f"20a {what} {mode} {arm}", n, r)
            st = r["stats"]
            runs[arm] = dict(
                identical_to_plain=r["tokens"] == (
                    runs["plain"]["tokens"] if runs else r["tokens"]),
                tokens=r["tokens"], decode_steps=st["decode_steps"],
                spec_steps=st["spec_steps"],
                acceptance=st["spec_acceptance_rate"],
                target_steps_per_token=steps_per_token(st),
                flash_decode_launches=r["launches"],
                chunked_prefills=st["chunked_prefills"])
        check_spec_total(f"20a {what} {mode}", runs)
        if kw and not runs["plain"]["chunked_prefills"]:
            raise AssertionError(f"20a {what} sampled: no prompt chunked")
        for arm, x in runs.items():
            log(f"  20a {what} {mode} {arm}: tokens identical to the plain "
                f"engine's {x['identical_to_plain']}, decode steps "
                f"{x['decode_steps']} (verifies {x['spec_steps']}), "
                f"acceptance {x['acceptance']}, target steps a token "
                f"{x['target_steps_per_token']:.3f}, flash_decode launches "
                f"{x['flash_decode_launches']}")
        bad = [a for a, x in runs.items() if not x["identical_to_plain"]]
        if bad:
            raise AssertionError(f"20a {what} {mode}: {bad} gave other "
                                 f"tokens than the plain engine")
        if mode == "greedy" and runs["self_draft"][
                "target_steps_per_token"] >= SPEC_STEP_RATIO:
            raise AssertionError(f"20a {what}: the self-draft took "
                                 f"{runs['self_draft']} target steps a token")
        out[mode] = {a: {k: v for k, v in x.items() if k != "tokens"}
                     for a, x in runs.items()}
    return out


def token_share(a, b):
    """The share of positions where two runs' tokens agree."""
    pairs = [(x, y) for ta, tb in zip(a, b) for x, y in zip(ta, tb)]
    return sum(x == y for x, y in pairs) / len(pairs)


def spec_latency(model, fd, Engine, SpecConfig, ledger, draft):
    """20b: phase 5's prompts (``workload(vocab, seed=1)``) served one at a
    time, 48 new tokens each, greedy, ``flash_decode=True``, on phase 5's
    geometry: the plain engine and the n-gram, self-draft and small-draft
    arms at k = 4. Each run finishes every request with 48 tokens and
    obeys ``check_spec_launches``; the self-draft takes fewer than
    ``SPEC_STEP_RATIO`` target steps a token. Returns per arm the printed
    numbers."""
    n = model.config.num_hidden_layers
    reqs = [(p, {}) for p in workload(model.config.vocab_size, seed=1)]
    smi = smi_line()
    runs, plain = {}, None
    for arm, spec in (("plain", None),
                      ("ngram", SpecConfig(draft="ngram", k=SPEC_K)),
                      ("self_draft", SpecConfig(draft=model, k=SPEC_K)),
                      ("small_draft", SpecConfig(draft=draft, k=SPEC_K))):
        r = spec_run(model, fd, Engine, reqs, SPEC_SERIAL_NEW, serial=True,
                     **SERVE_GEO, flash_decode=True, speculative=spec)
        check_spec_launches(f"20b {arm}", n, r)
        # the handles hold their engine: drop them before the next arm's
        # peak-memory reading
        st, led = r["stats"], ledger(r.pop("handles"))
        plain = plain or r["tokens"]
        runs[arm] = dict(
            itl_ms_p50=led["itl_ms_p50"], itl_ms_p95=led["itl_ms_p95"],
            tokens_per_s=led["tokens_per_sec"], wall_s=r["wall_s"],
            target_steps_per_token=steps_per_token(st),
            acceptance=st["spec_acceptance_rate"],
            draft_steps=st["draft_steps"], decode_steps=st["decode_steps"],
            verifies=st["spec_steps"], flash_decode_launches=r["launches"],
            peak_gib=r["peak_gib"],
            token_share_vs_plain=token_share(r["tokens"], plain))
        log(f"  20b {arm}: " + json.dumps(runs[arm]) + f" ({smi})")
    check_spec_total("20b", runs)
    if runs["self_draft"]["target_steps_per_token"] >= SPEC_STEP_RATIO:
        raise AssertionError(f"20b: the self-draft took "
                             f"{runs['self_draft']} target steps a token")
    return runs


def seq_logprob(model, full, prompt_len):
    """Per row, the sum of log p(token_t | prefix) over the generated
    tokens (fp64 log-softmax of the model's logits)."""
    with torch.inference_mode():
        logp = torch.log_softmax(model(full).double(), dim=-1)
    tgt = full[:, prompt_len:]
    return logp[:, prompt_len - 1:-1].gather(
        -1, tgt[..., None])[..., 0].sum(dim=1).tolist()


def beam_checks(model, beam_search_generate, ids, logprob=False):
    """20c on one model: ``generate(ids, 32 new, num_beams=4)`` timed with
    its peak memory; ``beam_search_generate(num_beams=1)`` equal to greedy
    ``generate`` token for token; with ``logprob``, each row's beam-4
    sequence log-prob at least greedy's - ``BEAM_LOGPROB_TOL``."""
    free_cycles()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    beam = model.generate(ids, max_new_tokens=BEAM_NEW, num_beams=4)
    torch.cuda.synchronize()
    out = dict(beam4_wall_s=time.perf_counter() - t0,
               beam4_peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    greedy = model.generate(ids, max_new_tokens=BEAM_NEW)
    one = beam_search_generate(model, ids, max_new_tokens=BEAM_NEW,
                               num_beams=1)
    out["beam1_equals_greedy"] = bool(torch.equal(one, greedy))
    if not out["beam1_equals_greedy"]:
        raise AssertionError("20c: num_beams=1 is not greedy generate")
    if tuple(beam.shape) != (ids.shape[0], ids.shape[1] + BEAM_NEW):
        raise AssertionError(f"20c: beam output {tuple(beam.shape)}")
    if logprob:
        L0 = ids.shape[1]
        sb, sg = seq_logprob(model, beam, L0), seq_logprob(model, greedy, L0)
        out.update(beam4_logprob=sb, greedy_logprob=sg)
        if not all(b >= g - BEAM_LOGPROB_TOL for b, g in zip(sb, sg)):
            raise AssertionError(f"20c: a beam-4 sequence scored below "
                                 f"greedy's: {sb} vs {sg}")
    return out


def phase_spec(model, fd, Engine, SpecConfig, ledger, beam_search_generate,
               LlamaConfig, LlamaForCausalLM, GPTConfig, GPTForCausalLM,
               seed, device="cuda"):
    """Phase 20 on phase 4's Llama-2-7B (bf16, full depth): 20b
    (``spec_latency``, with ``bench.py:bench_llama``'s 0.5B widths at
    ``SPEC_DRAFT_LAYERS`` layers as the small draft, random weights from
    seed 1) and 20c's
    beam search; then 20a (``spec_identity``) on the fp32 twins, Llama-2-7B
    widths at 2 layers and GPT-2 small, and 20c's log-prob check on the
    Llama twin. Returns (row 4's launches: 20a by model, mode and arm, and
    20b by arm; the printed numbers)."""
    out = {}
    seed(1)
    draft = LlamaForCausalLM(LlamaConfig(**{
        **COMM_CELL, "num_hidden_layers": SPEC_DRAFT_LAYERS}), device=device)
    out["20b"] = spec_latency(model, fd, Engine, SpecConfig, ledger, draft)
    del draft
    ids = torch.from_numpy(np.random.default_rng(21).integers(
        0, model.config.vocab_size, BEAM_SHAPE)).to(device)
    out["20c"] = beam_checks(model, beam_search_generate, ids)
    log("  20c Llama-2-7B bf16 " + json.dumps(out["20c"]) + f" "
        f"({smi_line()})")
    twins = {
        "llama": (LlamaForCausalLM, dataclasses.replace(
            model.config, dtype="float32", num_hidden_layers=2)),
        "gpt2": (GPTForCausalLM, GPTConfig(dtype="float32"))}
    for what, (cls, cfg) in twins.items():
        seed(0)
        twin = cls(cfg, device=device)
        if what == "gpt2":
            twin.eval()
        out[f"20a_{what}"] = spec_identity(twin, fd, Engine, SpecConfig, what)
        if what == "llama":
            out["20c_fp32"] = beam_checks(twin, beam_search_generate, ids,
                                          logprob=True)
            log("  20c fp32 twin " + json.dumps(out["20c_fp32"]))
        del twin
        free_cycles()
    launches = dict(
        **{f"20a_{w}_{m}_{a}": x["flash_decode_launches"]
           for w in twins for m, arms in out[f"20a_{w}"].items()
           for a, x in arms.items()},
        **{f"20b_{a}": x["flash_decode_launches"]
           for a, x in out["20b"].items()})
    return launches, out


# ---------------------------------------------------------------------------
# phase 21: mixed precision and attention dropout
# ---------------------------------------------------------------------------

AMP_CELL = dict(COMM_CELL, dtype="float32")     # bench_llama's 0.5B, fp32
AMP_BATCH = (4, 2048)                           # bench_llama's batch
AMP_ARMS = ("fp32", "o1", "o1_scaler", "o2")
AMP_LOSS_TOL = 2e-2     # a bf16 arm's losses vs fp32's, relative
AMP_PAIR_LAYERS = 2     # 21d's depth cut: two ranks' gloo traffic
MHA_SHAPE = (16, 512, 768, 12)   # bench_bert's batch, seq, BERT-base widths
MHA_DROPOUT = 0.1


def _amp_counters(fa, fc):
    """The wrappers of rows 1-3 and 5, by kernel name."""
    return dict(flash_attention_fwd=fa.flash_attention,
                flash_attention_bwd_dq=fa.flash_attention_bwd_dq,
                flash_attention_bwd_dkv=fa.flash_attention_bwd_dkv,
                fused_ce_stats=fc.fused_ce_stats)


def _variant_counts(fa, fc):
    """Rows 1-3 and 5: launches by variant since the last reset."""
    return {k: dict(f.launches_by_variant)
            for k, f in _amp_counters(fa, fc).items()}


def want_amp_launches(arm, layers):
    """An arm's launches by variant a step: rows 1-3 once per layer, row 5
    once. fp32 takes the CUDA cores everywhere; O1 casts q/k/v to bf16 (the
    tensor cores) and leaves the fused head fp32 (JAX's head does not
    cast); O2 is bf16 throughout."""
    attn = "cuda_core" if arm == "fp32" else "tc"
    head = "tc" if arm == "o2" else "cuda_core"
    out = {}
    for k in ("flash_attention_fwd", "flash_attention_bwd_dq",
              "flash_attention_bwd_dkv"):
        out[k] = {"tc": 0, "cuda_core": 0, attn: layers}
    out["fused_ce_stats"] = {"tc": 0, "cuda_core": 0, head: 1}
    return out


class Poison:
    """The loss function of phase 21's trainers: the model's loss times
    ``factor`` (1, or inf to plant a non-finite step)."""

    def __init__(self):
        self.factor = 1.0

    def __call__(self, m, x, y):
        return m(x, labels=y) * self.factor


def amp_trainer(LlamaForCausalLM, cfg, fleet, optimizer, amp, seed, arm,
                weights=None, device="cuda"):
    """The 0.5B trainer of one arm: fp32 parameters from seed 0 (or
    ``weights``), AdamW(lr=1e-4, wd=0.01, multi_precision); "o1" and
    "o1_scaler" train under ``amp_level="O1"`` (the second with a
    ``GradScaler``), "o2" after ``amp.decorate`` (bf16 parameters, fp32
    masters) under ``amp_level="O2"``."""
    from paddle_tpu_torch.framework.io import load_numpy_state_dict
    seed(0)
    model = fleet.distributed_model(LlamaForCausalLM(cfg, device=device))
    if weights is not None:
        load_numpy_state_dict(model, weights)
    if arm == "o2":
        amp.decorate(model, level="O2")
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        learning_rate=1e-4, weight_decay=0.01,
        parameters=model.parameters()))
    loss_fn = Poison()
    level = {"fp32": None, "o1": "O1", "o1_scaler": "O1", "o2": "O2"}[arm]
    scaler = amp.GradScaler() if arm == "o1_scaler" else None
    step = opt.make_train_step(model, loss_fn, amp_level=level,
                               scaler=scaler)
    return model, step, loss_fn


def run_amp_steps(fa, fc, step, ids, n, tag):
    """``n`` steps: (losses, seconds, launches by variant per step)."""
    losses, secs, per_step = [], [], []
    for i in range(n):
        for f in _amp_counters(fa, fc).values():
            reset_counts(f)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(ids, ids)))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        per_step.append(_variant_counts(fa, fc))
        log(f"  {tag}step {i}{' (warm-up)' if i == 0 else ''}: loss "
            f"{losses[-1]:.6f}, {secs[-1] * 1e3:.1f} ms")
    return losses, secs, per_step


def snapshot(step):
    """Copies of a train step's parameter blocks and optimizer state."""
    sd = step.state_dict()
    return ({k: v.detach().clone() for k, v in sd["params"].items()},
            {k: {n: t.clone() for n, t in st.items()}
             for k, st in sd["opt"].items()})


def unchanged_since(step, snap):
    """True when the step's parameters and optimizer state (masters, the
    moments, the beta powers) equal ``snap`` bit for bit."""
    params, state = snap
    sd = step.state_dict()
    return (all(torch.equal(v, params[k]) for k, v in sd["params"].items())
            and all(torch.equal(t, state[k][n])
                    for k, st in sd["opt"].items() for n, t in st.items()))


def plant_inf(step, loss_fn, ids):
    """One step with the loss multiplied by inf (the step's own poison):
    (found_inf, everything unchanged bit for bit, scale before, after)."""
    snap = snapshot(step)
    before = float(step.state_dict()["scaler"]["scale"])
    loss_fn.factor = float("inf")
    loss = float(step(ids, ids))
    loss_fn.factor = 1.0
    if np.isfinite(loss):
        raise AssertionError(f"21b: the planted step's loss is {loss}")
    return (bool(step.last_found_inf), unchanged_since(step, snap), before,
            float(step.state_dict()["scaler"]["scale"]))


def phase_amp_train(fa, fc, LlamaConfig, LlamaForCausalLM, fleet, optimizer,
                    amp, seed, cfg=None, batch=AMP_BATCH, device="cuda",
                    steps=TRAIN_STEPS):
    """21a: ``bench.py:bench_llama``'s 0.5B Llama with fp32 parameters
    (hidden 2048, 8 layers, 16 heads, FFN 5504, the fused head, AdamW)
    on its repeated 4 x 2048 batch, a warm-up + 3 steps in each arm of
    ``AMP_ARMS``: fp32; O1; O1 with a ``GradScaler`` (the step's one host
    read of ``found_inf``: its cost is the difference to O1); O2 after
    ``amp.decorate``. Each arm's launches by variant must be
    ``want_amp_launches``; every loss finite and falling; the bf16 arms'
    losses within ``AMP_LOSS_TOL`` of fp32's. 21b: then the O1-scaler
    step takes a step whose loss is inf: found_inf, parameters and the
    whole optimizer state unchanged bit for bit, the scale halved."""
    cfg = cfg or LlamaConfig(**AMP_CELL)
    B, L = batch
    fleet.init()
    ids = train_ids(cfg.vocab_size, B, L, device=device)
    out, launches = {}, {}
    for arm in AMP_ARMS:
        model, step, loss_fn = amp_trainer(LlamaForCausalLM, cfg, fleet,
                                           optimizer, amp, seed, arm,
                                           device=device)
        if device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        losses, secs, per_step = run_amp_steps(fa, fc, step, ids, steps,
                                               f"21a {arm} ")
        peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
        step_s = float(np.median(secs[1:]))
        want = want_amp_launches(arm, cfg.num_hidden_layers)
        for i, c in enumerate(per_step):
            if c != want:
                raise AssertionError(f"21a {arm} step {i} launched {c}, "
                                     f"want {want}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[1]:
            raise AssertionError(f"21a {arm}: losses {losses}")
        out[arm] = dict(losses=losses, step_ms=step_s * 1e3,
                        step_secs=secs, tokens_per_s=B * L / step_s,
                        peak_gib=peak / 2**30,
                        params_dtype=str(next(model.parameters()).dtype))
        launches[arm] = per_step[1]
        log(f"  21a {arm}: step {step_s * 1e3:.1f} ms (median of 3), "
            f"{B * L / step_s:.1f} tokens/s, peak {peak / 2**30:.2f} GiB, "
            f"launches by variant {json.dumps(per_step[1])} ({smi_line()})")
        if arm in ("o1", "o2") and device != "cpu":
            out[arm]["profile"] = profile_step(step, ids, ids)
            log(f"  21a {arm} profiled step "
                + json.dumps(out[arm]["profile"]))
        if arm == "o1_scaler":
            found, same, before, after = plant_inf(step, loss_fn, ids)
            if not (found and same and after == before / 2):
                raise AssertionError(
                    f"21b: found_inf {found}, unchanged {same}, scale "
                    f"{before} -> {after}")
            out["21b"] = dict(found_inf=found, unchanged=same,
                              scale_before=before, scale_after=after)
            log(f"  21b planted inf: found_inf, parameters and optimizer "
                f"state unchanged bit for bit, scale {before} -> {after}")
        del step, model, loss_fn
        if device != "cpu":
            torch.cuda.empty_cache()
    ref = out["fp32"]["losses"]
    for arm in AMP_ARMS[1:]:
        rel = max(abs(a - b) / abs(b) for a, b in zip(out[arm]["losses"],
                                                      ref))
        out[arm]["rel_to_fp32"] = rel
        if not rel <= AMP_LOSS_TOL:
            raise AssertionError(f"21a {arm}: losses {out[arm]['losses']} "
                                 f"vs fp32 {ref} (relative {rel:.3g})")
    out["scaler_read_ms"] = out["o1_scaler"]["step_ms"] - out["o1"]["step_ms"]
    return launches, out


def phase_mha(fa, F, nn, amp, seed, shape=MHA_SHAPE, device="cuda"):
    """21c: ``nn.MultiHeadAttention`` at BERT-base widths on
    ``bench_bert``'s 16 x 512 batch (head dim 64), bf16 after
    ``amp.decorate``, dropout 0.1. In eval without a mask it must take row 1
    once (on the tensor cores) and agree with the plain composite within
    1e-2 relative; in training it must take the plain composite (no
    launch, ``attention_path`` naming the dropout). Then the keep rate:
    with q = k = 0 and v = 1 each output is the kept share of its row
    over ``1 - p``, so the mean over 50M probabilities must be within 6
    binomial sigmas of ``1 - p``."""
    from paddle_tpu_torch.nn.functional.attention import _plain_sdpa
    B, L, E, H = shape
    seed(0)
    mha = amp.decorate(nn.MultiHeadAttention(E, H, dropout=MHA_DROPOUT,
                                             device=device))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (B, L, E)).astype(np.float32)).to(device, torch.bfloat16)
    out = {}
    for mode in ("eval", "train"):
        mha.train(mode == "train")
        reset_counts(fa.flash_attention)
        with torch.no_grad():
            y = mha(x)
            path = F.attention_path()
            n = fa.flash_attention.launches
            tc = fa.flash_attention.launches_by_variant["tc"]
            if device != "cpu":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                mha(x)
            if device != "cpu":
                torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 5 * 1e3
        out[mode] = dict(ms=ms, path=path, launches=n, launches_tc=tc)
        if not torch.isfinite(y).all():
            raise AssertionError(f"21c {mode}: non-finite output")
        if mode == "eval":
            with torch.no_grad():
                q, k, v = (mha._split(p(x)) for p in (
                    mha.q_proj, mha.k_proj, mha.v_proj))
                ref = mha.out_proj(_plain_sdpa(q, k, v).reshape(B, L, E))
            rel = float((y.float() - ref.float()).norm()
                        / ref.float().norm())
            out[mode]["rel_to_plain"] = rel
            want = 1 if device != "cpu" else 0
            if n != want or tc != want or rel > 1e-2:
                raise AssertionError(f"21c eval: {out[mode]}")
        elif n != 0 or "dropout" not in path["reason"]:
            raise AssertionError(f"21c train: {out[mode]}")
        log(f"  21c MultiHeadAttention {mode}: {ms:.3f} ms a forward, "
            f"path {path['path']} ({path['reason']}), row 1 launches {n}")
    p = MHA_DROPOUT
    seed(1)
    z = torch.zeros(B, L, H, E // H, device=device)
    got = F.scaled_dot_product_attention(z, z, torch.ones_like(z),
                                         dropout_p=p)
    rate = float(got.double().mean() * (1 - p))
    n = B * H * L * L
    sigma = float(np.sqrt(p * (1 - p) / n))
    out["keep_rate"] = dict(rate=rate, want=1 - p, sigma=sigma, n=n)
    log(f"  21c keep rate {rate:.6f} over {n} probabilities (want "
        f"{1 - p}, sigma {sigma:.2e})")
    if not abs(rate - (1 - p)) <= 6 * sigma:
        raise AssertionError(f"21c keep rate {out['keep_rate']}")
    return out


def _amp_tp_worker(workdir, cfg, batch, steps, device):
    """One of 21d's two ranks on ``device`` (gloo): the 0.5B widths cut to
    ``AMP_PAIR_LAYERS`` under mp_degree=2, O1 with a GradScaler, from the
    saved weights; ``steps`` steps, then a step whose loss is inf on rank
    1 only."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import amp
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_ce as fc
    from paddle_tpu_torch.text.models.llama import LlamaForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env(backend="gloo", device=device, timeout=600)
    rank = dist.get_rank()
    fleet.init(is_collective=True, strategy=_strategy(fleet, mp_degree=2))
    model, step, loss_fn = amp_trainer(
        LlamaForCausalLM, cfg, fleet, optimizer, amp, pt.seed, "o1_scaler",
        saved_weights(workdir), device=device)
    ids = train_ids(cfg.vocab_size, *batch, device=device)
    losses, secs, per_step = run_amp_steps(fa, fc, step, ids, steps,
                                           f"[rank {rank}, tp2 O1] ")
    snap = snapshot(step)
    before = float(step.state_dict()["scaler"]["scale"])
    loss_fn.factor = float("inf") if rank == 1 else 1.0
    step(ids, ids)
    out = dict(rank=rank, losses=losses, step_secs=secs, launches=per_step,
               planted=rank == 1, found_inf=bool(step.last_found_inf),
               unchanged=unchanged_since(step, snap), scale_before=before,
               scale_after=float(step.state_dict()["scaler"]["scale"]))
    with open(os.path.join(workdir, f"amp_tp.r{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def phase_amp_pair(fa, fc, LlamaConfig, LlamaForCausalLM, fleet, optimizer,
                   amp, seed, cfg=None, batch=AMP_BATCH,
                   workdir="build/phase21", device="cuda",
                   steps=TRAIN_STEPS):
    """21d: the 0.5B widths cut to ``AMP_PAIR_LAYERS`` layers (fp32
    parameters, O1 with a GradScaler), world 1 on the card, then
    ``mp_degree=2`` as two gloo ranks on the card from the same weights:
    every rank's losses within ``PAIR_REL_TOL`` of world 1's; rows 1-3
    once per layer a step on the tensor cores, row 5 once on the rank's
    vocabulary shard (fp32, the CUDA cores); then a step whose loss is
    inf on rank 1 only: both ranks see found_inf, keep their parameters
    and optimizer state bit for bit and halve the scale."""
    import shutil

    from paddle_tpu_torch import distributed as dist
    cfg = cfg or LlamaConfig(**{**AMP_CELL,
                                "num_hidden_layers": AMP_PAIR_LAYERS})
    fleet.init()
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        model, step, _ = amp_trainer(LlamaForCausalLM, cfg, fleet,
                                     optimizer, amp, seed, "o1_scaler",
                                     device=device)
        save_weights(workdir, model)
        ids = train_ids(cfg.vocab_size, *batch, device=device)
        world1, _, _ = run_amp_steps(fa, fc, step, ids, steps,
                                     "21d world 1 ")
        del step, model
        if device != "cpu":
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        dist.spawn(_amp_tp_worker, args=(workdir, cfg, batch, steps,
                                         _rank_device(device)),
                   nprocs=2, timeout=900)
        spawn_s = time.perf_counter() - t0
        ranks = []
        for r in range(2):
            with open(os.path.join(workdir, f"amp_tp.r{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    want = want_amp_launches("o1", cfg.num_hidden_layers)
    worst = 0.0
    for g in ranks:
        rel = max(abs(a - b) / abs(b) for a, b in zip(g["losses"], world1))
        worst = max(worst, rel)
        if rel > PAIR_REL_TOL or g["losses"] != ranks[0]["losses"]:
            raise AssertionError(f"21d rank {g['rank']}: losses "
                                 f"{g['losses']} vs world 1 {world1}")
        for i, c in enumerate(g["launches"]):
            if c != want:
                raise AssertionError(f"21d rank {g['rank']} step {i} "
                                     f"launched {c}, want {want}")
        if not (g["found_inf"] and g["unchanged"]
                and g["scale_after"] == g["scale_before"] / 2):
            raise AssertionError(f"21d rank {g['rank']}: {g}")
    log(f"  21d tp2 O1: losses {ranks[0]['losses']} vs world 1 {world1} "
        f"(worst relative {worst:.3g}); inf planted on rank 1 only: both "
        f"ranks skipped bit for bit, scale {ranks[0]['scale_before']} -> "
        f"{ranks[0]['scale_after']}; step times "
        f"{[[round(t, 3) for t in g['step_secs']] for g in ranks]} s per "
        f"rank (two ranks sharing one card through gloo: not multi-GPU "
        f"speeds); spawn {spawn_s:.1f} s")
    return ranks[0]["launches"][-1], dict(
        world1=world1, losses=ranks[0]["losses"], max_rel_to_world1=worst,
        skipped=[g["found_inf"] and g["unchanged"] for g in ranks],
        scale=[ranks[0]["scale_before"], ranks[0]["scale_after"]],
        step_secs=[g["step_secs"] for g in ranks], spawn_s=spawn_s)


# ---------------------------------------------------------------------------
# phase 22: the encoder families (BERT, T5, ViT)
# ---------------------------------------------------------------------------

BERT_BATCH = (16, 512)          # bench.py:bench_bert's batch
# 22b: the kernel step's losses vs the plain-routed step's (bf16 training,
# another attention arithmetic: a relative 1e-2, as the gloo pairs')
BERT_PLAIN_REL_TOL = PAIR_REL_TOL
BERT_LOGITS_REL_TOL = 1e-2      # 22c: bf16 logits vs the plain composite's
# 22d: T5's source and target lengths (the T5 paper's 512 inputs; its 114
# targets rounded up to 128) at batch 16, and generate's batch, source
# length and new tokens
T5_BATCH = (16, 512, 128)
T5_GENERATE = (8, 64, 32)
VIT_BATCH = (32, 224)           # bench.py:bench_vit's batch and image size


class plain_attention_routed:
    """``F.scaled_dot_product_attention``'s kernel route (``sdpa_raw``)
    sent to the plain composite inside the block: the yardstick of 22b and
    22c, in this script only (the package has no such switch)."""

    def __init__(self, attention):
        self.attention = attention

    def __enter__(self):
        att = self.attention
        self.saved = att.sdpa_raw

        def plain(q, k, v, causal=False, scale=None):
            att._record("plain", "routed to the plain composite by "
                                 "chip_smoke.py")
            return att._plain_sdpa(q, k, v, causal=causal, scale=scale)
        att.sdpa_raw = plain

    def __exit__(self, *exc):
        self.attention.sdpa_raw = self.saved


def bert_trainer(BertForPretraining, cfg, fleet, optimizer, seed,
                 device="cuda", lr=1e-4):
    """``bench_bert``'s trainer: weights from seed 0 cast to bf16, placed
    by ``fleet.distributed_model``, AdamW(lr=1e-4), the MLM loss."""
    seed(0)
    model = fleet.distributed_model(
        BertForPretraining(cfg, device=device).to(torch.bfloat16))
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        learning_rate=lr, parameters=model.parameters()))
    return model, opt.make_train_step(
        model, lambda m, x, y: m(x, masked_lm_labels=y))


def bert_batch(vocab, B, L, device="cuda"):
    """``bench_bert``'s batch: seeded random ids and MLM labels at every
    position."""
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.integers(0, vocab, (B, L))).to(device)
                 for _ in range(2))


def no_launches():
    return want_attention_launches(0)


def check_launches(tag, per_step, want):
    for i, c in enumerate(per_step):
        if c != want:
            raise AssertionError(f"{tag} step {i} launched {c}, want {want}")


def check_training(tag, losses, first_near=None):
    """Finite losses, the last timed below the first timed; with
    ``first_near`` the first within 1.0 of it."""
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: non-finite loss {losses}")
    if first_near is not None and abs(losses[0] - first_near) > 1.0:
        raise AssertionError(f"{tag}: first loss {losses[0]} not within "
                             f"1.0 of {first_near}")
    if not losses[-1] < losses[1]:
        raise AssertionError(f"{tag}: the last timed loss is not below the "
                             f"first: {losses[1:]}")


def peak_gib(device):
    return (torch.cuda.max_memory_allocated() / 2**30 if device != "cpu"
            else 0.0)


def reset_peak(device):
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def phase_bert(fa, fc, rm, F, attention, BertConfig, BertForPretraining,
               BertForSequenceClassification, fleet, optimizer, seed,
               cfg=None, batch=BERT_BATCH, device="cuda", lr=1e-4):
    """22a: ``bench_bert``'s configuration (``BertConfig()``: BERT-base,
    dropout 0.1; bf16; AdamW(lr=1e-4); MLM labels at every position) on
    its repeated 16 x 512 batch, a warm-up + 3 steps: the loss finite, the
    first within 1.0 of ln V, the last timed below the first; attention
    on the plain composite (training dropout), no launch of rows 1-3, as
    in JAX; step time, tokens/s, peak memory and one profiled step. 22b:
    the same weights with both dropouts 0: rows 1-3 once per layer and
    step, all on the tensor cores; the same steps again with attention
    routed to the plain composite (``plain_attention_routed``): every
    loss within ``BERT_PLAIN_REL_TOL``. 22c: the eval forward of
    ``BertForSequenceClassification`` at the same batch, bf16: without a
    mask row 1 once per layer on the tensor cores and the logits within
    ``BERT_LOGITS_REL_TOL`` of the plain-routed forward's; with a 2-D
    padding mask no launch and the plain path. Returns ({"step_22b": rows
    1-3's launches in a 22b kernel step, "forward_22c": row 1's per 22c
    forward, unmasked and masked}, the report)."""
    cfg = cfg or BertConfig()
    B, L = batch
    layers = cfg.num_hidden_layers
    on_card = device != "cpu"
    fleet.init()                        # world 1: the default mesh
    ids, labels = bert_batch(cfg.vocab_size, B, L, device)
    out = {}

    # ---- 22a ----
    model, step = bert_trainer(BertForPretraining, cfg, fleet, optimizer,
                               seed, device, lr)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  22a: {n_params / 1e6:.1f}M params, batch {B} x {L}, bf16, "
        f"AdamW(lr={lr}), dropout {cfg.hidden_dropout_prob} / "
        f"{cfg.attention_probs_dropout_prob}")
    reset_peak(device)
    losses, secs, per_step = run_steps(fa, fc, rm, step, ids, TRAIN_STEPS,
                                       tag="22a ", labels=labels)
    path = F.attention_path()
    check_training("22a", losses, first_near=np.log(cfg.vocab_size))
    check_launches("22a", per_step, no_launches())
    if path["path"] != "plain" or "dropout" not in path["reason"]:
        raise AssertionError(f"22a attention path {path}")
    step_s = float(np.median(secs[1:]))
    prof = profile_step(step, ids, labels) if on_card else None
    out["22a"] = dict(losses=losses, step_ms=step_s * 1e3,
                      tokens_per_s=B * L / step_s, peak_gib=peak_gib(device),
                      attention_path=path, profile=prof)
    log(f"  22a step time median {step_s * 1e3:.1f} ms over 3, "
        f"{B * L / step_s:.1f} tokens/s, peak {peak_gib(device):.2f} GiB, "
        f"attention {path['path']} ({path['reason']})"
        + (f" ({smi_line()})" if on_card else ""))
    log("  22a profiled step " + json.dumps(prof))
    del model, step

    # ---- 22b ----
    cfg0 = dataclasses.replace(cfg, hidden_dropout_prob=0.0,
                               attention_probs_dropout_prob=0.0)
    want = want_attention_launches(layers) if on_card else no_launches()
    runs = {}
    for arm in ("kernels", "plain-routed"):
        model, step = bert_trainer(BertForPretraining, cfg0, fleet,
                                   optimizer, seed, device, lr)
        reset_peak(device)
        routed = (plain_attention_routed(attention) if arm == "plain-routed"
                  else contextlib.nullcontext())
        with routed:
            losses, secs, per_step = run_steps(
                fa, fc, rm, step, ids, TRAIN_STEPS, tag=f"22b {arm} ",
                labels=labels)
            path = F.attention_path()
            prof = (profile_step(step, ids, labels)
                    if on_card and arm == "kernels" else None)
        check_training(f"22b {arm}", losses,
                       first_near=np.log(cfg.vocab_size))
        check_launches(f"22b {arm}", per_step,
                       want if arm == "kernels" else no_launches())
        if arm == "kernels":
            kernel_steps = per_step
        step_s = float(np.median(secs[1:]))
        runs[arm] = dict(losses=losses, step_ms=step_s * 1e3,
                         tokens_per_s=B * L / step_s,
                         peak_gib=peak_gib(device), attention_path=path)
        if prof is not None:
            runs[arm]["profile"] = prof
            log("  22b profiled kernel step " + json.dumps(prof))
        log(f"  22b {arm}: step time median {step_s * 1e3:.1f} ms, "
            f"{B * L / step_s:.1f} tokens/s, peak {peak_gib(device):.2f} "
            f"GiB, attention {path['path']}")
        del model, step
    worst = max(abs(a - b) / abs(b) for a, b in zip(
        runs["kernels"]["losses"], runs["plain-routed"]["losses"]))
    runs["max_rel_loss_to_plain"] = worst
    log(f"  22b losses {runs['kernels']['losses']} vs plain-routed "
        f"{runs['plain-routed']['losses']}: worst relative {worst:.3g} "
        f"(tol {BERT_PLAIN_REL_TOL})")
    if not worst <= BERT_PLAIN_REL_TOL:
        raise AssertionError(f"22b: the kernel steps' losses are "
                             f"{worst:.3g} from the plain-routed ones")
    out["22b"] = runs

    # ---- 22c ----
    seed(0)
    clf = BertForSequenceClassification(cfg, device=device).to(
        torch.bfloat16).eval()
    lengths = np.random.default_rng(1).integers(L // 2, L + 1, B)
    mask = torch.from_numpy((np.arange(L)[None] < lengths[:, None]).astype(
        np.int64)).to(device)
    res = {}
    with torch.no_grad():
        for arm, kw in (("unmasked", {}), ("masked", dict(
                attention_mask=mask))):
            reset_counts(fa.flash_attention)
            logits = clf(ids, **kw)
            n = fa.flash_attention.launches
            tc = fa.flash_attention.launches_by_variant["tc"]
            path = F.attention_path()
            if not bool(torch.isfinite(logits).all()):
                raise AssertionError(f"22c {arm}: non-finite logits")
            res[arm] = dict(launches=n, launches_tc=tc, path=path)
            if on_card:
                res[arm]["forward_ms"] = forward_ms(
                    lambda x: clf(x, **kw), ids)
            if arm == "unmasked":
                with plain_attention_routed(attention):
                    ref = clf(ids)
                    if on_card:
                        res[arm]["plain_routed_forward_ms"] = forward_ms(
                            clf, ids)
                res[arm]["rel_to_plain"] = rel_err(logits, ref)
        wl = layers if on_card else 0
        u, m = res["unmasked"], res["masked"]
        log(f"  22c classification eval forward [{B}, {L}] bf16: unmasked "
            f"{u}; masked {m}")
        if (u["launches"] != wl or u["launches_tc"] != wl
                or u["rel_to_plain"] > BERT_LOGITS_REL_TOL
                or (on_card and u["path"]["path"] != "flash")):
            raise AssertionError(f"22c unmasked: {u}")
        if m["launches"] != 0 or m["path"]["path"] != "plain":
            raise AssertionError(f"22c masked: {m}")
    out["22c"] = res
    del clf
    if on_card:
        torch.cuda.empty_cache()
    return dict(step_22b=kernel_steps[1], forward_22c={
        k: v["launches"] for k, v in res.items()}), out


def t5_lengths_used(Ls, Lt, Lg, M):
    """Every (qlen, klen, bidirectional) bucket table 22d's runs use:
    training's encoder and decoder, generate's encoder and padded decoder,
    and the incremental loop's decoder at every length."""
    used = {(Ls, Ls, True), (Lt, Lt, False), (Lg, Lg, True),
            (M + 1, M + 1, False)}
    return sorted(used | {(t, t, False) for t in range(1, M + 1)})


def phase_t5(fa, fc, rm, t5mod, fleet, optimizer, seed, cfg=None,
             gen_cfg=None, batch=T5_BATCH, gen=T5_GENERATE, device="cuda"):
    """22d: T5 at ``T5Config()``'s widths (d_model 512, 6 + 6 layers, 8
    heads, vocab 32,128), bf16, AdamW(lr=1e-4, wd=0.01), a warm-up + 3
    steps with labels on one repeated 16 x (512 -> 128) batch: finite and
    falling; T5's attention is its own body, so no flash launch. Then, in
    fp32 with untied embeddings (random tied ones emit the start token
    throughout), ``generate(max_new_tokens=32)`` on a seeded 8 x 64 batch
    token-identical to a step-by-step incremental greedy loop on the card
    (JAX's ``tests/test_hf_interop.py`` check), and the card's bucket
    table for every length those runs used equal to the CPU's."""
    T5Config = t5mod.T5Config
    cfg = cfg or T5Config(dtype="bfloat16")
    gen_cfg = gen_cfg or T5Config(tie_word_embeddings=False)
    B, Ls, Lt = batch
    Bg, Lg, M = gen
    on_card = device != "cpu"
    fleet.init()
    seed(0)
    model = fleet.distributed_model(
        t5mod.T5ForConditionalGeneration(cfg, device=device))
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        learning_rate=1e-4, weight_decay=0.01,
        parameters=model.parameters()))
    step = opt.make_train_step(model, lambda m, x, y: m(x, labels=y))
    rng = np.random.default_rng(7)
    src = torch.from_numpy(rng.integers(2, cfg.vocab_size, (B, Ls))).to(
        device)
    tgt = torch.from_numpy(rng.integers(2, cfg.vocab_size, (B, Lt))).to(
        device)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  22d: {n_params / 1e6:.1f}M params, batch {B} x ({Ls} -> {Lt}), "
        f"{cfg.dtype}, AdamW(lr=1e-4, wd=0.01)")
    reset_peak(device)
    losses, secs, per_step = run_steps(fa, fc, rm, step, src, TRAIN_STEPS,
                                       tag="22d ", labels=tgt)
    check_training("22d", losses)
    check_launches("22d", per_step, no_launches())
    step_s = float(np.median(secs[1:]))
    train = dict(losses=losses, step_ms=step_s * 1e3,
                 tokens_per_s=B * (Ls + Lt) / step_s,
                 peak_gib=peak_gib(device))
    log(f"  22d step time median {step_s * 1e3:.1f} ms, "
        f"{B * (Ls + Lt) / step_s:.1f} (source + target) tokens/s, peak "
        f"{peak_gib(device):.2f} GiB")
    del model, step, opt

    seed(1)
    gm = t5mod.T5ForConditionalGeneration(gen_cfg, device=device).eval()
    gsrc = torch.from_numpy(np.random.default_rng(8).integers(
        2, gen_cfg.vocab_size, (Bg, Lg))).to(device)
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = gm.generate(gsrc, max_new_tokens=M, eos_token_id=None)
    if on_card:
        torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    dec = torch.full((Bg, 1), gen_cfg.decoder_start_token_id,
                     dtype=torch.long, device=device)
    with torch.no_grad():
        for _ in range(M):
            logits = gm(gsrc, decoder_input_ids=dec)
            dec = torch.cat([dec, logits[:, -1].float().argmax(-1)[:, None]],
                            dim=1)
    same = bool(torch.equal(got, dec))
    distinct = int(torch.unique(got[:, 1:]).numel())
    log(f"  22d generate [{Bg}, {Lg}] -> {M} new, fp32, untied: "
        f"{gen_s * 1e3:.1f} ms, {distinct} distinct tokens, identical to "
        f"the incremental loop: {same}")
    if not same:
        raise AssertionError("22d: generate differs from the incremental "
                             "greedy loop")
    nb = gen_cfg.relative_attention_num_buckets
    md = gen_cfg.relative_attention_max_distance
    used = t5_lengths_used(Ls, Lt, Lg, M)
    dev = torch.device(device)
    bad = [u for u in used if not torch.equal(
        t5mod._bucket_table(*u, nb, md, dev).cpu(),
        t5mod._bucket_table(*u, nb, md, torch.device("cpu")))]
    # the formula evaluated on the device instead (not what the model
    # does): how many relative positions of lengths up to 2048 its log
    # would put in another bucket
    rel = torch.arange(-2047, 2048, dtype=torch.int32)
    formula = {bi: int((t5mod._rel_bucket(rel.to(device), bi, nb, md).cpu()
                        != t5mod._rel_bucket(rel, bi, nb, md)).sum())
               for bi in (True, False)}
    log(f"  22d bucket tables on the card equal the CPU's for all "
        f"{len(used)} (qlen, klen, direction) used: {not bad}; the formula "
        f"run on the device would differ at {formula} of 4095 relative "
        f"positions (bidirectional, one-directional)")
    if bad:
        raise AssertionError(f"22d bucket tables differ at {bad}")
    del gm
    if on_card:
        torch.cuda.empty_cache()
    return dict(train=train, generate=dict(
        shape=[Bg, Lg, M], ms=gen_s * 1e3, identical_to_incremental=same,
        distinct_tokens=distinct), bucket_tables_checked=len(used),
        device_formula_mismatches={str(k): v for k, v in formula.items()})


def phase_vit(fa, fc, rm, F, vit_b_16, fleet, optimizer, seed,
              batch=VIT_BATCH, device="cuda", **vit_kw):
    """22e: ``bench_vit``'s configuration: ViT-B/16 (``vit_b_16``: width
    768, 12 layers, 12 heads) over 1000 classes cast to bf16,
    AdamW(lr=3e-4), the fp32 CE; a warm-up + 3 steps on one repeated
    batch of 32 seeded 224 x 224 images (bf16): finite and falling; 197
    tokens, so attention takes the plain composite and rows 1-3 never
    launch, as in JAX; images/s and peak memory."""
    B, S = batch
    fleet.init()
    seed(0)
    model = fleet.distributed_model(
        vit_b_16(num_classes=1000, device=device, **vit_kw).to(
            torch.bfloat16))
    opt = fleet.distributed_optimizer(optimizer.AdamW(
        learning_rate=3e-4, parameters=model.parameters()))
    step = opt.make_train_step(
        model, lambda m, x, y: F.cross_entropy(m(x).float(), y))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((B, 3, S, S)).astype(
        np.float32)).to(device, torch.bfloat16)
    y = torch.from_numpy(rng.integers(0, 1000, (B,))).to(device)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"  22e: {n_params / 1e6:.1f}M params, {B} images {S} x {S}, bf16, "
        f"AdamW(lr=3e-4)")
    reset_peak(device)
    losses, secs, per_step = run_steps(fa, fc, rm, step, x, TRAIN_STEPS,
                                       tag="22e ", labels=y)
    path = F.attention_path()
    check_training("22e", losses)
    check_launches("22e", per_step, no_launches())
    if path["path"] != "plain":
        raise AssertionError(f"22e attention path {path}")
    step_s = float(np.median(secs[1:]))
    log(f"  22e step time median {step_s * 1e3:.1f} ms, {B / step_s:.1f} "
        f"images/s, peak {peak_gib(device):.2f} GiB, attention "
        f"{path['path']} ({path['reason']})")
    res = dict(losses=losses, step_ms=step_s * 1e3,
               images_per_s=B / step_s, peak_gib=peak_gib(device),
               attention_path=path)
    del model, step, opt
    if device != "cpu":
        torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 23: the serving deployment path
# ---------------------------------------------------------------------------

DEPLOY_GEO = dict(n_slots=4, max_len=256, block_size=16, flash_decode=True)
DEPLOY_NEW = 32
DEPLOY_FAULT_STEP = 5       # supervised step 5: four requests decoding at
#                             different positions, two queued
DEPLOY_FAULTS = ("decode-stall", "decode-raise", "kv-corrupt")
DEPLOY_STALL_S = 0.05
WEDGE_TIMEOUT_S = 0.5       # the real wedge: step_timeout_s, and the sleep
WEDGE_SLEEP_S = 1.0         # inside the decode step past it


def deploy_traffic(vocab, mode, max_len=DEPLOY_GEO["max_len"],
                   new=DEPLOY_NEW):
    """Phase 5's prompts (shared 64-token prefix) that fit ``max_len``
    with ``new`` tokens (the 256-token one does not), and per request the
    sampled mode's submit arguments (phase 11's: temperature 0.6, seeds
    1000 + i)."""
    prompts = [p for p in workload(vocab, seed=1) if len(p) + new <= max_len]
    per = ([dict(temperature=0.6, seed=1000 + i) for i in range(len(prompts))]
           if mode == "sampled" else None)
    return prompts, per


def mode_kw(mode):
    """The engine arguments of a mode: sampled + chunked is phase 11's."""
    return SAMPLED if mode == "sampled" else {}


def track_engines(sups):
    """Every engine the supervisors ``sups`` own, the ones their rebuilds
    make included (their ``_build`` is wrapped)."""
    engines = []
    for sup in sups:
        engines.append(sup.engine)

        def build(orig=sup._build):
            eng = orig()
            engines.append(eng)
            return eng
        sup._build = build
    return engines


def join_zombies():
    """Wait for the supervisors' abandoned step threads (a wedged step
    returns on its own after its sleep)."""
    for t in threading.enumerate():
        if t.name == "supervised-decode":
            t.join()


def deploy_run(server, prompts, per, fd, engines, n_layers, tag,
               new=DEPLOY_NEW, device="cuda"):
    """Phase 5's staggered schedule on ``server`` (an engine, a
    supervisor or a fleet); row 4's counts reset just before and read
    just after (abandoned step threads joined first). Every request must
    finish with ``new`` tokens and row 4 launch once per layer per decode
    step of every engine in ``engines`` (the incarnations), all on the
    split kernel. Returns the tokens, the handles, the supervised steps'
    start times, the wall and the launches."""
    free_cycles()
    reset_counts(fd.flash_decode)
    stamps = []
    step = server.step

    def stamped():
        stamps.append(time.perf_counter())
        return step()

    server.step = stamped
    t0 = time.perf_counter()
    hs = staggered(server, prompts, new, per)
    join_zombies()
    if device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    del server.step
    launches = fd.flash_decode.launches
    variants = dict(fd.flash_decode.launches_by_variant)
    steps = sum(e.metrics.decode_steps for e in engines)
    want = n_layers * steps
    if launches != want or not want \
            or variants != {"split": want, "one_pass": 0}:
        raise AssertionError(f"{tag}: flash_decode launched {launches} "
                             f"times ({variants}), want {want} = "
                             f"{n_layers} x {steps} decode steps over "
                             f"{len(engines)} engines, all on the split "
                             f"kernel")
    if not all(h.finished and h.finish_reason == "length"
               and len(h.tokens) == new for h in hs):
        raise AssertionError(f"{tag}: a request did not finish with {new} "
                             f"tokens")
    return dict(tokens=[list(map(int, h.tokens)) for h in hs], handles=hs,
                stamps=stamps, wall_s=wall, launches=launches,
                decode_steps=steps, engines=len(engines))


def first_token_after(handles, t):
    """Seconds from ``t`` to the first token any handle emitted after it
    (the recovery wall: the first replayed token)."""
    return min(s for h in handles for s in h.metrics.token_times if s > t) - t


def check_same(tag, got, want):
    """Token identity; a difference names the first differing request and
    position."""
    if got == want:
        return
    i = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
    j = next(j for j, (a, b) in enumerate(zip(got[i], want[i])) if a != b)
    raise AssertionError(f"{tag}: request {i} differs from the "
                         f"uninterrupted run at token {j}: {got[i][j]} vs "
                         f"{want[i][j]}")


def deploy_artifact(model, fd, save_lm, create_llm_predictor, base, what,
                    launches, device="cuda"):
    """23a: ``save_lm`` to a temporary directory, then one
    ``create_llm_predictor`` per mode (greedy; sampled + chunked): the
    predictor's tokens must be the source engine's (``base``). Returns the
    artifact's size, the save and load walls and the runs' numbers."""
    n = model.config.num_hidden_layers
    out = {}
    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        path = save_lm(model, os.path.join(td, "lm"))
        out["save_s"] = time.perf_counter() - t0
        out["artifact_bytes"] = os.path.getsize(path)
        for mode in ("greedy", "sampled"):
            free_cycles()
            t0 = time.perf_counter()
            pred = create_llm_predictor(path, device=device, **DEPLOY_GEO,
                                        **mode_kw(mode))
            if device != "cpu":
                torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            prompts, per = deploy_traffic(model.config.vocab_size, mode)
            tag = f"23a {what} {mode}"
            r = deploy_run(pred.engine, prompts, per, fd, [pred.engine], n,
                           tag, device=device)
            launches[tag] = r["launches"]
            check_same(f"23a {what} {mode} predictor", r["tokens"],
                       base[mode])
            out[mode] = dict(load_s=load_s, identical=True,
                             flash_decode_launches=r["launches"])
            del pred, r
    log(f"  23a {what}: artifact {out['artifact_bytes'] / 2**30:.3f} GiB, "
        f"save {out['save_s']:.2f} s, load (predictor built) greedy "
        f"{out['greedy']['load_s']:.2f} s, sampled "
        f"{out['sampled']['load_s']:.2f} s; tokens identical to the source "
        f"engine's")
    return out


def wedge_decode(eng, sleep_s, at_call):
    """A real wedge: the ``at_call``-th decode step of ``eng`` sleeps
    ``sleep_s`` inside the step (past the supervisor's condemnation
    check), then decodes on the engine, condemned by then. Returns a dict
    the wedge's start time goes into."""
    orig = eng._decode_once
    box = {"calls": 0}

    def slow(active):
        box["calls"] += 1
        if box["calls"] == at_call:
            box["t"] = time.perf_counter()
            time.sleep(sleep_s)
        return orig(active)

    eng._decode_once = slow
    return box


def probe_cost(sup, prompts, device):
    """One KV probe over the live blocks of ``prompts`` admitted on a
    fresh engine, after a warm-up probe: its wall with the host read, and
    on the card the device span between CUDA events recorded around it
    (its gathers, finiteness reductions and two copies: the block ids in,
    the verdict out). Returns (device ms or None, wall ms, live
    blocks)."""
    hs = [sup.submit(p, max_new_tokens=2) for p in prompts]
    live = len(sup.engine.cache.live_blocks())
    sup._probe_kv()                                  # warm-up
    dev_ms = None
    if device != "cpu":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        sup._probe_kv()
        end.record()
        torch.cuda.synchronize()
        dev_ms = start.elapsed_time(end)
    t0 = time.perf_counter()
    sup._probe_kv()
    ms = (time.perf_counter() - t0) * 1e3
    for h in hs:
        sup.cancel(h)
    return dev_ms, ms, live


def deploy_supervisor(model, fd, EngineSupervisor, ChaosMonkey, base, step_ms,
                      what, launches, device="cuda"):
    """23b: ``EngineSupervisor(kv_probe_interval=1)`` under ChaosMonkey's
    decode-stall, decode-raise and kv-corrupt at supervised step
    ``DEPLOY_FAULT_STEP``, and a real wedge (``step_timeout_s``, a decode
    step that sleeps past it), greedy and sampled + chunked: every
    request's tokens are the uninterrupted engine's (``base``); one
    rebuild, at least two replayed requests; row 4 once per layer per
    decode step summed over both incarnations (the wedge's zombie step on
    the condemned one included), on the split kernel; the zombie's late
    tokens dropped. Returns per mode and fault the numbers, and the
    probe's cost (``probe_cost``)."""
    n = model.config.num_hidden_layers
    out = {}
    for mode in ("greedy", "sampled"):
        prompts, per = deploy_traffic(model.config.vocab_size, mode)
        runs = {}
        for fault in DEPLOY_FAULTS + ("wedge",):
            if fault == "wedge":
                sup = EngineSupervisor(model, step_timeout_s=WEDGE_TIMEOUT_S,
                                       kv_probe_interval=1, **DEPLOY_GEO,
                                       **mode_kw(mode))
                box = wedge_decode(sup.engine, WEDGE_SLEEP_S,
                                   DEPLOY_FAULT_STEP + 1)
            else:
                chaos = ChaosMonkey(seed=0, at={DEPLOY_FAULT_STEP: fault},
                                    stall_s=DEPLOY_STALL_S)
                sup = EngineSupervisor(model, chaos=chaos,
                                       kv_probe_interval=1, **DEPLOY_GEO,
                                       **mode_kw(mode))
            engines = track_engines([sup])
            tag = f"23b {what} {mode} {fault}"
            r = deploy_run(sup, prompts, per, fd, engines, n, tag,
                           device=device)
            launches[tag] = r["launches"]
            check_same(tag, r["tokens"], base[mode])
            t_fault = (box["t"] if fault == "wedge"
                       else r["stamps"][DEPLOY_FAULT_STEP])
            c = sup.counters()
            if sup.rebuilds != 1 or sup.replayed < 2:
                raise AssertionError(f"{tag}: {c}")
            want_counter = {"decode-stall": "wedges",
                            "decode-raise": "step_errors",
                            "kv-corrupt": "kv_corruptions",
                            "wedge": "wedges"}[fault]
            if c[want_counter] != 1:
                raise AssertionError(f"{tag}: {c}")
            dropped = engines[0].dropped_emissions
            if fault == "wedge" and not dropped:
                raise AssertionError(f"{tag}: the zombie step emitted "
                                     f"nothing to drop")
            runs[fault] = dict(
                identical=True, rebuilds=sup.rebuilds,
                replayed=sup.replayed,
                recovery_ms=first_token_after(r["handles"], t_fault) * 1e3,
                flash_decode_launches=r["launches"],
                decode_steps=r["decode_steps"],
                zombie_tokens_dropped=dropped,
                kv_probes=sup.kv_probes,
                kv_probe_ms=sup.kv_probe_s / max(sup.kv_probes, 1) * 1e3)
            log(f"  {tag}: identical, rebuilds {sup.rebuilds}, replayed "
                f"{sup.replayed}, recovery (fault to the first replayed "
                f"token) {runs[fault]['recovery_ms']:.1f} ms vs the "
                f"uninterrupted decode step {step_ms[mode]:.2f} ms, "
                f"flash_decode launches {r['launches']} = {n} x "
                f"{r['decode_steps']}, zombie tokens dropped {dropped}, "
                f"probes {sup.kv_probes} at "
                f"{runs[fault]['kv_probe_ms']:.3f} ms")
            del sup, engines, r
        out[mode] = runs
    sup = EngineSupervisor(model, kv_probe_interval=1, **DEPLOY_GEO)
    prompts, _ = deploy_traffic(model.config.vocab_size, "greedy")
    dev_ms, ms, live = probe_cost(sup, prompts[:DEPLOY_GEO["n_slots"]],
                                  device)
    pool = sup.engine.cache.nbytes()
    out["kv_probe"] = dict(device_ms=dev_ms, wall_ms=ms, live_blocks=live,
                           pool_blocks=sup.engine.cache.pool.n_blocks,
                           pool_bytes=pool)
    log(f"  23b {what} KV probe: {live} live blocks of "
        f"{sup.engine.cache.pool.n_blocks} ({pool / 2**20:.1f} MiB pool): "
        f"{dev_ms} ms between CUDA events, {ms:.3f} ms of wall with its "
        f"host read")
    return out


def shares_weights(engine, model):
    """Every weight tensor of ``engine``'s arch is a view of one of
    ``model``'s parameters (the same storage)."""
    own = {p.untyped_storage().data_ptr() for p in model.parameters()}
    stack = list(engine._arch.w.values())
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, torch.Tensor) \
                and x.untyped_storage().data_ptr() not in own:
            return False
    return True


def deploy_fleet(model, fd, ReplicaFleet, ChaosMonkey, AdoptMismatch, base,
                 other_handle, what, launches, device="cuda"):
    """23c: ``ReplicaFleet(n_replicas=2)``: replica-kill at supervised step
    ``DEPLOY_FAULT_STEP`` (greedy; sampled + chunked) and route-flap
    (sampled): the migrated requests' tokens are the uninterrupted
    engine's, row 4 once per layer per decode step over every engine;
    a request sharing the 64-token prefix routes to the replica holding
    it although that replica is the busier; ``other_handle`` (another
    model's) offered to a replica raises ``AdoptMismatch``. One copy of
    the weights: every replica engine's weights are views of the model's
    (``shares_weights``), and the peak memory above the model's over each
    run is printed beside the two pools' bytes."""
    n = model.config.num_hidden_layers
    wbytes = weight_bytes(model)
    out = {}
    for mode, fault in (("greedy", "replica-kill"),
                        ("sampled", "replica-kill"),
                        ("sampled", "route-flap")):
        prompts, per = deploy_traffic(model.config.vocab_size, mode)
        at = {DEPLOY_FAULT_STEP: fault} if fault == "replica-kill" \
            else {0: fault}
        free_cycles()
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
        fleet = ReplicaFleet(model, 2, chaos=ChaosMonkey(seed=1, at=at),
                             kv_probe_interval=1, **DEPLOY_GEO,
                             **mode_kw(mode))
        engines = track_engines([r.sup for r in fleet.replicas.values()])
        pools = sum(r.engine.cache.nbytes() for r in fleet.replicas.values())
        tag = f"23c {what} {mode} {fault}"
        r = deploy_run(fleet, prompts, per, fd, engines, n, tag,
                       device=device)
        launches[tag] = r["launches"]
        check_same(tag, r["tokens"], base[mode])
        if not all(shares_weights(e, model) for e in engines):
            raise AssertionError(f"{tag}: an engine copied the weights")
        c = fleet.counters()
        if fault == "replica-kill" and (c["replica_kills"] != 1
                                        or c["migrations"] < 1):
            raise AssertionError(f"{tag}: {c}")
        if fault == "route-flap" and c["route_flaps"] != 1:
            raise AssertionError(f"{tag}: {c}")
        extra = (0 if device == "cpu"
                 else torch.cuda.max_memory_allocated() - before)
        out[f"{mode}_{fault}"] = dict(
            identical=True, migrations=c["migrations"],
            flash_decode_launches=r["launches"],
            decode_steps=r["decode_steps"], engines=r["engines"],
            replicas=[h.replica_id for h in r["handles"]],
            peak_over_weights_bytes=extra, two_pools_bytes=pools,
            weights_bytes=wbytes)
        log(f"  {tag}: identical, migrations {c['migrations']}, replicas "
            f"{out[f'{mode}_{fault}']['replicas']}, flash_decode launches "
            f"{r['launches']} = {n} x {r['decode_steps']} over "
            f"{r['engines']} engines; memory above the weights "
            f"({wbytes / 2**30:.2f} GiB, held once) peaked at "
            f"{extra / 2**30:.3f} GiB, two pools {pools / 2**30:.3f} GiB")
        del fleet, engines, r
    # prefix routing: r0 holds the 64-token prefix and is the busier
    prompts, _ = deploy_traffic(model.config.vocab_size, "greedy")
    fleet = ReplicaFleet(model, 2, **DEPLOY_GEO)
    h0 = fleet.submit(prompts[0], max_new_tokens=4)
    while not h0.finished:
        fleet.step()
    holder = fleet.replicas[h0.replica_id]
    rng = np.random.default_rng(23)
    busy = [holder.sup.submit(rng.integers(0, model.config.vocab_size, 32),
                              max_new_tokens=4) for _ in range(2)]
    h1 = fleet.submit(prompts[1], max_new_tokens=4)
    route = [x for x in fleet.ledger.to_list() if x["event"] == "route"]
    if h1.replica_id != holder.id or route[-1]["prefix_tokens"] != 64:
        raise AssertionError(f"23c {what}: the shared-prefix request went "
                             f"to {h1.replica_id} ({route[-1]}), not to "
                             f"{holder.id}, which holds its prefix")
    fleet.drain()
    out["prefix_route"] = dict(holder=holder.id, routed_to=h1.replica_id,
                               prefix_tokens=route[-1]["prefix_tokens"],
                               holder_active_at_route=len(busy))
    try:
        holder.engine.adopt(other_handle)
        raise AssertionError(f"23c {what}: a handle of another model was "
                             f"adopted")
    except AdoptMismatch as e:
        out["adopt_mismatch"] = str(e)[:80]
    log(f"  23c {what}: the shared-prefix request routed to {h1.replica_id}"
        f" (holds 64 prefix tokens, 2 requests busier); a GPT-2 handle "
        f"raised AdoptMismatch")
    return out


def deploy_baseline(model, fd, Engine, what, launches, device="cuda"):
    """The uninterrupted engine's tokens per mode, and its decode step
    (the rolling ITL median, ms)."""
    n = model.config.num_hidden_layers
    base, step_ms = {}, {}
    for mode in ("greedy", "sampled"):
        prompts, per = deploy_traffic(model.config.vocab_size, mode)
        eng = Engine(model, **DEPLOY_GEO, **mode_kw(mode))
        tag = f"23 {what} {mode} uninterrupted"
        r = deploy_run(eng, prompts, per, fd, [eng], n, tag, device=device)
        launches[tag] = r["launches"]
        if mode == "sampled" and not eng.metrics.chunked_prefills:
            raise AssertionError(f"23 {what}: no prompt was chunked")
        base[mode] = r["tokens"]
        step_ms[mode] = eng.metrics.itl_estimate() * 1e3
        del eng, r
    return base, step_ms


def phase_deploy(fd, Engine, EngineSupervisor, ReplicaFleet, ChaosMonkey,
                 AdoptMismatch, save_lm, create_llm_predictor, LlamaConfig,
                 LlamaForCausalLM, GPTConfig, GPTForCausalLM, seed,
                 twins=None, device="cuda"):
    """Phase 23 on phase 20a's fp32 twins (TF32 off, random weights from
    seed 0): GPT-2 small whole, then Llama-2-7B widths at 2 layers, each
    through 23a (``deploy_artifact``) and 23b (``deploy_supervisor``);
    23c (``deploy_fleet``) on the Llama twin, offered a GPT-2 handle.
    ``twins`` replaces the two (name, class, config) entries (tiny models
    for the card tests). Returns (row 4's launches by run, the printed
    numbers)."""
    from paddle_tpu_torch.text.models.llama import LLAMA2_7B
    twins = twins or (
        ("gpt2", GPTForCausalLM, GPTConfig(dtype="float32")),
        ("llama", LlamaForCausalLM, dataclasses.replace(
            LLAMA2_7B, dtype="float32", num_hidden_layers=2)))
    out, launches, other = {}, {}, None
    for what, cls, cfg in twins:
        t0 = time.perf_counter()
        seed(0)
        model = cls(cfg, device=device).eval()
        base, step_ms = deploy_baseline(model, fd, Engine, what, launches,
                                        device)
        res = dict(step_ms=step_ms)
        res["23a"] = deploy_artifact(model, fd, save_lm,
                                     create_llm_predictor, base, what,
                                     launches, device)
        res["23b"] = deploy_supervisor(model, fd, EngineSupervisor,
                                       ChaosMonkey, base, step_ms, what,
                                       launches, device)
        if other is None:
            # the first twin's handle, offered to the second's fleet
            eng = Engine(model, **DEPLOY_GEO)
            other = eng.submit(deploy_traffic(cfg.vocab_size, "greedy")[0][0],
                               max_new_tokens=1)
            del eng
        else:
            res["23c"] = deploy_fleet(model, fd, ReplicaFleet, ChaosMonkey,
                                      AdoptMismatch, base, other, what,
                                      launches, device)
        res["wall_s"] = time.perf_counter() - t0
        out[what] = res
        log(f"  23 {what}: {res['wall_s']:.1f} s")
        del model
        free_cycles()
    return launches, out


# ---------------------------------------------------------------------------
# phase 24: training robustness
# ---------------------------------------------------------------------------

P24_LAYERS = 4          # 24a's depth cut: 4 of GPT-2 small's 12 layers
P24_SEQS = 48           # 24a's dataset: 6 batches of 8 an epoch
P24_BATCH = 8
P24_STEPS = 11          # 2 epochs: the cursor crosses an epoch boundary;
                        # cadence saves after steps 4 and 8
P24_SAVE = 4            # save_interval
P24_TIMEOUT_S = 5.0     # the chaos run's step_timeout_s
P24_WEDGE_S = 6.0       # the wedged attempt sleeps this long, then runs
# the chaos run's plan, by invocation of the supervised step (a retry is an
# invocation): a transient error; a real wedge right after the cadence
# save of step 7 (not a ChaosMonkey fault: the step sleeps past the
# deadline and then runs), so that save's write is done before the
# corruption, which waits for it inside a supervised step; the newest
# checkpoint corrupted; then a NaN streak of nan_patience (2) that rolls
# back
P24_PLAN = {4: "error", 11: "corrupt", 12: "nan", 13: "nan"}
P24_WEDGE_AT = 9
P24_AFTER_ROLLBACK = 2  # steps the chaos run takes after its rollback
P24_KILL_AT = 10        # the victim child SIGKILLs itself at this step
# what the plan must give: retries (error, wedge), one skipped batch, one
# rollback over the corrupted step 7 to step 3
P24_WANT = dict(retries=2, skipped=1, rollbacks=1, rollback_to=3,
                anomalies={"step-error": 1, "stall": 1, "nonfinite": 2})
P24B_LAYERS = 2
P24B_BATCH = (4, 2048)
P24B_CFG = {"grad_compress": "int8", "zero1": True}
P24B_STEPS, P24B_MORE = 3, 2


def p24_ids(vocab, n=P24_SEQS, L=1024):
    """24a's seeded token dataset, ``[n, L]`` int64 on the host."""
    return np.random.default_rng(24).integers(0, vocab, (n, L))


def p24_loader(io, ids, device, epochs=2):
    """``ResumableLoader`` over ``DataLoader(TensorDataset([ids]))`` with a
    shuffling ``DistributedBatchSampler`` (one replica), batches on
    ``device``."""
    from paddle_tpu_torch.resilience import ResumableLoader
    sampler = io.DistributedBatchSampler(ids, P24_BATCH, num_replicas=1,
                                         rank=0, shuffle=True)
    return ResumableLoader(io.DataLoader(io.TensorDataset([ids]),
                                         batch_sampler=sampler,
                                         device=device), epochs=epochs)


def flat_params(model):
    """Every parameter in one flat copy (for bitwise comparisons)."""
    with torch.no_grad():
        return torch.cat([p.detach().reshape(-1)
                          for p in model.parameters()])


def p24_trainer(GPTForCausalLM, cfg, fleet, optimizer, seed, io, ids, ckdir,
                device, **sup_kw):
    """Phase 17's GPT-2 trainer (seed 0, AdamW, dropout 0.1) under a
    ``Supervisor`` with a ``CheckpointManager(ckdir)`` and 24a's loader:
    (model, step, loader, manager, supervisor factory)."""
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.resilience import Supervisor, TrainState
    model, step = gpt2_trainer(GPTForCausalLM, cfg, fleet, optimizer, seed,
                               device=device)
    loader = p24_loader(io, ids, device)
    mgr = CheckpointManager(ckdir, max_to_keep=3, device=device)
    state = TrainState(train_step=step, loader=loader)

    def supervise(fn):
        return Supervisor(fn, state, manager=mgr, save_interval=P24_SAVE,
                          **sup_kw)
    return model, step, loader, mgr, state, supervise


def p24_run(fa, fc, rm, GPTForCausalLM, cfg, fleet, optimizer, seed, io, ids,
            ckdir, device, snapshots=False):
    """One uninterrupted supervised run of ``P24_STEPS`` steps: losses,
    the parameters at each step's entry (with ``snapshots``) and at the
    end, launches over the run, seconds."""
    model, step, loader, mgr, state, supervise = p24_trainer(
        GPTForCausalLM, cfg, fleet, optimizer, seed, io, ids, ckdir, device)
    entries = []

    def train(x):
        if snapshots:
            entries.append(flat_params(model))
        return step(x, x)

    sup = supervise(train)
    _reset(fa, fc, rm)
    sync(device)
    t0 = time.perf_counter()
    losses = []
    for (x,) in loader:
        losses.append(float(sup.step(x)))
        if sup.steps_completed >= P24_STEPS:
            break
    sup.close()
    sync(device)
    secs = time.perf_counter() - t0
    counts = _counts(fa, fc, rm)
    return dict(losses=losses, entries=entries, final=flat_params(model),
                launches=counts, secs=secs, model=model, step=step,
                state=state, mgr=mgr, stats=sup.stats())


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def p24_chaos(fa, fc, rm, GPTForCausalLM, cfg, fleet, optimizer, seed, io, ids,
              ckdir, device, ChaosMonkey, attempt):
    """24a's chaos run: ``P24_PLAN`` through a ``ChaosMonkey`` with the
    manager, the wedge at ``P24_WEDGE_AT``, ``step_timeout_s``, NaN
    patience 2, no emergency saves (with them the NaN streak's first
    anomaly would persist the guard, and the newest checkpoint at the
    rollback would always be intact). Returns the run's record: the
    parameters at each attempt's entry by consumed-batch count, the
    supervisor's stats and ledger, executed attempts, launches."""
    model, step, loader, mgr, state, supervise = p24_trainer(
        GPTForCausalLM, cfg, fleet, optimizer, seed, io, ids, ckdir, device,
        step_timeout_s=P24_TIMEOUT_S, nan_patience=2, max_retries=2,
        max_rollbacks=1, retry_backoff_s=0.0, emergency_save=False)
    chaos = ChaosMonkey(seed=24, at=P24_PLAN, manager=mgr)
    entries, executed = [], []
    holder = {}

    def train(x):
        call = chaos.calls - 1
        entries.append((call, holder["sup"].steps_completed,
                        flat_params(model)))
        if call == P24_WEDGE_AT:
            time.sleep(P24_WEDGE_S)     # wedged: abandoned, then runs
        out = step(x, x)
        executed.append(call)
        return out

    sup = holder["sup"] = supervise(chaos.wrap(train))
    rollback_s, rollback = [], sup._rollback

    def timed_rollback(why):            # the restore wall, timed here
        sync(device)
        t0 = time.perf_counter()
        out = rollback(why)
        sync(device)
        rollback_s.append(time.perf_counter() - t0)
        return out
    sup._rollback = timed_rollback
    dropped0 = attempt.stats["dropped"]
    _reset(fa, fc, rm)
    t0 = time.perf_counter()
    losses, after = [], None
    for (x,) in loader:
        out = sup.step(x)
        losses.append(None if out is None else float(out))
        if sup.rollbacks and after is None:
            after = 0
        elif after is not None:
            after += 1
        if after is not None and after >= P24_AFTER_ROLLBACK:
            break
    sup.close()
    for t in sup.zombies:
        t.join(P24_WEDGE_S + 30)
    sync(device)
    secs = time.perf_counter() - t0
    counts = _counts(fa, fc, rm)
    ledger = sup.ledger.to_list()
    rb = [r for r in ledger if r["event"] == "rollback"]
    return dict(losses=losses, entries=entries, executed=executed,
                launches=counts, secs=secs, stats=sup.stats(), rollback=rb,
                rollback_s=rollback_s,
                fired=chaos.fired, dropped=attempt.stats["dropped"] - dropped0,
                zombies=len(sup.zombies),
                corrupt_skipped=[r for r in ledger
                                 if r["event"] == "anomaly"])


def _p24_child(workdir, ckdir, mode, cfg, device):
    """24a's kill-and-resume child: 24a's uninterrupted run in a process of
    its own; ``mode`` "victim" SIGKILLs itself at ``P24_KILL_AT``,
    "resume" resumes from ``ckdir`` (timing ``Supervisor.resume``) and
    runs to ``P24_STEPS``. Writes ``<mode>.json``."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import io, optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.resilience import ChaosMonkey
    from paddle_tpu_torch.text.models import GPTForCausalLM

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fleet.init()
    ids = p24_ids(cfg.vocab_size)
    model, step, loader, mgr, state, supervise = p24_trainer(
        GPTForCausalLM, cfg, fleet, optimizer, pt.seed, io, ids, ckdir,
        device)

    def train(x):
        return step(x, x)

    fn = train
    if mode == "victim":
        fn = ChaosMonkey(at={P24_KILL_AT: "kill"}).wrap(train)
    sup = supervise(fn)
    sync(device)
    t0 = time.perf_counter()
    start = sup.resume()
    sync(device)
    resume_s = time.perf_counter() - t0
    losses = {}
    for (x,) in loader:
        if sup.steps_completed >= P24_STEPS:
            break
        i = sup.steps_completed
        losses[i] = float(sup.step(x))
    sup.close()
    with open(os.path.join(workdir, f"{mode}.json"), "w") as f:
        json.dump(dict(start=start, losses=losses, resume_s=resume_s,
                       wall_s=time.perf_counter() - t_start), f)


def p24_child(workdir, mode, cfg, device):
    """Start 24a's kill-and-resume child ``mode`` (spawned; its checkpoints
    in ``<workdir>/ck_kill``)."""
    import multiprocessing
    p = multiprocessing.get_context("spawn").Process(
        target=_p24_child, args=(workdir, os.path.join(workdir, "ck_kill"),
                                 mode, cfg, device))
    p.start()
    return p


def p24_join(p, mode, want_code):
    """Wait for a child of ``p24_child``; fail unless it exits
    ``want_code`` (the victim: -9, SIGKILL)."""
    p.join(600)
    if p.is_alive():
        p.kill()
        p.join()
        raise AssertionError(f"24a: the {mode} child did not finish")
    if p.exitcode != want_code:
        raise AssertionError(f"24a: the {mode} child exited {p.exitcode}, "
                             f"want {want_code}")
    return p.exitcode


def p24_costs(step, state, mgr, ids, device, n=5):
    """The snapshot surface's costs at 24a's state: the guard capture
    alone; a step with and without the supervisor (no manager, so its
    guard capture is all it adds), medians of ``n`` alternating steps;
    and the run's last cadence save as the manager recorded it (the host
    copy, the pickle with its CRC, the fsync, the wall to the publish,
    the bytes)."""
    from paddle_tpu_torch.resilience import Supervisor
    sync(device)
    t0 = time.perf_counter()
    guard = state.capture()
    sync(device)
    capture_s = time.perf_counter() - t0
    del guard
    x = torch.as_tensor(ids[:P24_BATCH], device=device)
    sup = Supervisor(lambda b: step(b, b), state)
    plain, supervised = [], []
    for _ in range(n):
        sync(device)
        t0 = time.perf_counter()
        float(step(x, x))
        plain.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        float(sup.step(x))
        supervised.append(time.perf_counter() - t0)
    save = dict(mgr.last_save)
    return dict(capture_s=capture_s, step_s=float(np.median(plain)),
                supervised_step_s=float(np.median(supervised)),
                save_step=save.pop("step"), bytes=save.pop("bytes"),
                **{f"save_{k}": v for k, v in save.items()})


def p24_check_launches(tag, counts, attempts, layers):
    want = {k: v * attempts for k, v in
            want_attention_launches(layers).items()}
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts} over {attempts} "
                             f"executed attempts, want {want}")


def phase_robust_gpt2(fa, fc, rm, GPTConfig, GPTForCausalLM, fleet, optimizer,
                      seed, io, ChaosMonkey, attempt, cfg=None,
                      workdir="build/phase24", device="cuda"):
    """24a: phase 17's GPT-2 small trainer cut to ``P24_LAYERS`` layers
    (the widths, vocabulary and batch kept), under a
    ``Supervisor`` with a ``CheckpointManager`` on local disk
    (``save_interval`` 4) and 24a's loader, 11 steps over 2 epochs.
    The uninterrupted run twice: losses and final parameters equal bit
    for bit (the repeat check). The chaos run (``P24_PLAN``, the wedge):
    ``P24_WANT``'s counts, the rollback over the corrupted step 7 to step
    3, the zombie's update dropped, the parameters at every attempt's
    entry equal the uninterrupted run's at the same consumed-batch count
    up to the first skipped batch and right after the rollback. A victim
    child SIGKILLed at step 10 (run beside the repeat run, which only its
    time shares) and a resuming child: the resumed losses equal the
    uninterrupted run's bit for bit. Rows 1-3 launch once a layer each
    per executed attempt, all on the tensor cores. Prints the guard capture, a step
    with and without the supervisor, the save (from the first run's last
    cadence save), rollback and resume walls and the bytes a checkpoint
    holds."""
    import shutil
    cfg = cfg or GPTConfig(dtype="bfloat16", num_hidden_layers=P24_LAYERS)
    layers = cfg.num_hidden_layers
    fleet.init()
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    ids = p24_ids(cfg.vocab_size)
    t24 = time.perf_counter()
    children = []
    try:
        runs = []
        for i in range(2):
            runs.append(p24_run(fa, fc, rm, GPTForCausalLM, cfg, fleet,
                                optimizer, seed, io, ids,
                                os.path.join(workdir, f"ck_run{i}"), device,
                                snapshots=(i == 0)))
            log(f"  24a uninterrupted run {i}: losses {runs[-1]['losses']} "
                f"in {runs[-1]['secs']:.2f} s ({smi_line()})")
            p24_check_launches(f"24a run {i}", runs[-1]["launches"],
                               P24_STEPS, layers)
            if i == 0:
                costs = p24_costs(runs[0]["step"], runs[0]["state"],
                                  runs[0]["mgr"], ids, device)
                log("  24a snapshot surface " + json.dumps(costs))
            for k in ("model", "step", "state", "mgr"):
                runs[-1].pop(k)
            gc.collect()
            if device != "cpu":
                torch.cuda.empty_cache()
            if i == 0:
                children.append(p24_child(workdir, "victim", cfg, device))
        code = p24_join(children[0], "victim", -9)
        base = runs[0]
        if runs[1]["losses"] != base["losses"] or not torch.equal(
                runs[1]["final"], base["final"]):
            raise AssertionError(f"24a: the uninterrupted run does not "
                                 f"repeat: {base['losses']} vs "
                                 f"{runs[1]['losses']}")
        del runs
        chaos = p24_chaos(fa, fc, rm, GPTForCausalLM, cfg, fleet, optimizer,
                          seed, io, ids, os.path.join(workdir, "ck_chaos"),
                          device, ChaosMonkey, attempt)
        log(f"  24a chaos run: {chaos['stats']}, fired {chaos['fired']}, "
            f"rollback {chaos['rollback']}, executed attempts "
            f"{chaos['executed']}, {chaos['secs']:.2f} s")
        st = chaos["stats"]
        for k in ("retries", "skipped", "rollbacks", "anomalies"):
            if st[k] != P24_WANT[k]:
                raise AssertionError(f"24a chaos: {k} {st[k]}, want "
                                     f"{P24_WANT[k]}")
        if [r["to_step"] for r in chaos["rollback"]] != \
                [P24_WANT["rollback_to"]]:
            raise AssertionError(f"24a chaos: rollback {chaos['rollback']}, "
                                 f"want to step {P24_WANT['rollback_to']} "
                                 f"past the corrupted step 7")
        if chaos["zombies"] != 1 or chaos["dropped"] != 1 or \
                P24_WEDGE_AT in chaos["executed"]:
            raise AssertionError(f"24a chaos: the wedged attempt was not "
                                 f"dropped ({chaos['zombies']} zombies, "
                                 f"{chaos['dropped']} dropped, executed "
                                 f"{chaos['executed']})")
        # the state at each attempt's entry: the uninterrupted run's at the
        # same consumed-batch count, until the first skipped batch, and
        # again right after the rollback
        first_nan = min(c for c, f in P24_PLAN.items() if f == "nan")
        held = 0
        for call, done, flat in chaos["entries"]:
            if call < first_nan or (call > max(P24_PLAN) and done ==
                                    P24_WANT["rollback_to"] + 1):
                if not torch.equal(flat, base["entries"][done]):
                    raise AssertionError(f"24a chaos: parameters at call "
                                         f"{call} ({done} batches) differ "
                                         f"from the uninterrupted run's")
                held += 1
        if held < 10:
            raise AssertionError(f"24a chaos: only {held} states compared")
        p24_check_launches("24a chaos", chaos["launches"],
                           len(chaos["executed"]), layers)
        entries = base.pop("entries")
        del entries
        base.pop("final")
        chaos.pop("entries")
        gc.collect()
        if device != "cpu":
            torch.cuda.empty_cache()
        children.append(p24_child(workdir, "resume", cfg, device))
        p24_join(children[1], "resume", 0)
        with open(os.path.join(workdir, "resume.json")) as f:
            resumed = json.load(f)
        resumed["losses"] = {int(k): v for k, v in resumed["losses"].items()}
        start = resumed["start"]
        if start not in (P24_SAVE, 2 * P24_SAVE):
            raise AssertionError(f"24a: resumed at step {start}")
        want = {i: base["losses"][i] for i in range(start, P24_STEPS)}
        if resumed["losses"] != want:
            raise AssertionError(f"24a: resumed losses {resumed['losses']} "
                                 f"!= the uninterrupted {want}")
        log(f"  24a kill and resume: victim exit {code}, resumed at step "
            f"{start} in {resumed['resume_s']:.2f} s (child wall "
            f"{resumed['wall_s']:.1f} s), losses equal bit for bit")
    finally:
        for p in children:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(workdir, ignore_errors=True)
    total = time.perf_counter() - t24
    return dict(losses=base["losses"], run_s=base["secs"],
                launches_per_step={k: v // P24_STEPS
                                   for k, v in base["launches"].items()},
                chaos=dict(stats=chaos["stats"], fired=chaos["fired"],
                           rollback=chaos["rollback"],
                           executed=chaos["executed"],
                           launches=chaos["launches"], secs=chaos["secs"],
                           states_held=held, rollback_s=chaos["rollback_s"]),
                kill=dict(victim_exit=code, resumed_at=start,
                          resume_s=resumed["resume_s"],
                          child_wall_s=resumed["wall_s"]),
                **costs, phase_s=total)


def _p24b_worker(workdir, cfg, batch, device):
    """One of 24b's two dp ranks (gloo on ``device``): the comm-opt step
    (int8, zero1) from the saved weights, 3 steps, an async checkpoint
    (each rank its file, rank 0 seals) written during 2 more steps; then a
    fresh step restored from the checkpoint, 2 steps. Writes
    ``p24b.r<rank>.json``."""
    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.framework.device import resolve_device
    from paddle_tpu_torch.framework.io import load_numpy_state_dict
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_ce as fc
    from paddle_tpu_torch.ops import ragged_matmul as rm
    from paddle_tpu_torch.resilience import TrainState
    from paddle_tpu_torch.text.models.llama import LlamaForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_parallel_env(backend="gloo", device=device, timeout=900)
    dev = resolve_device(None)
    rank = dist.get_rank()
    with np.load(os.path.join(workdir, "batch.npz")) as z:
        ids = torch.from_numpy(z["ids"]).to(dev)
    weights = saved_weights(workdir)

    def build():
        s = fleet.DistributedStrategy()
        s.hybrid_configs["dp_degree"] = 2
        s.comm_opt = True
        s.comm_opt_configs.update(P24B_CFG)
        fleet.init(is_collective=True, strategy=s)
        model = fleet.distributed_model(LlamaForCausalLM(cfg, device=dev))
        load_numpy_state_dict(model, weights)
        return fleet.distributed_optimizer(comm_optimizer(
            optimizer, "adamw", model.parameters())).make_train_step(
            model, lambda m, x, y: m(x, labels=y))

    step = build()
    losses, _, launches = run_steps(fa, fc, rm, step, ids, P24B_STEPS,
                                    tag=f"[24b rank {rank}] ", warm_up=False)
    mgr = CheckpointManager(os.path.join(workdir, "ck"), device=dev)
    # the write runs while the next steps update the state in place
    mgr.save(P24B_STEPS - 1, TrainState(train_step=step).capture(copy=False))
    cont = run_steps(fa, fc, rm, step, ids, P24B_MORE,
                     tag=f"[24b rank {rank}, uninterrupted] ",
                     warm_up=False)[0]
    mgr.wait()
    save_s = mgr.last_save["wall_s"]
    meta = {k: int(v) for k, v in step.state_dict()["meta"].items()}
    del step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    fresh = build()
    state = TrainState(train_step=fresh)
    t0 = time.perf_counter()
    at, snap = mgr.restore_latest(state.capture())
    state.restore(snap)
    restore_s = time.perf_counter() - t0
    del snap
    resumed, _, more = run_steps(fa, fc, rm, fresh, ids, P24B_MORE,
                                 tag=f"[24b rank {rank}, restored] ",
                                 warm_up=False)
    with open(os.path.join(workdir, f"p24b.r{rank}.json"), "w") as f:
        json.dump(dict(rank=rank, losses=losses, cont=cont, resumed=resumed,
                       restored_at=at, launches=launches + more, meta=meta,
                       save_s=save_s, restore_s=restore_s), f)
    dist.destroy_process_group()


def phase_robust_comm(fa, fc, rm, LlamaConfig, LlamaForCausalLM, fleet,
                      optimizer, seed, cfg=None, batch=P24B_BATCH,
                      workdir="build/phase24b", device="cuda"):
    """24b: phase 19's 0.5B Llama widths at 2 layers, 4 x 2048, the
    comm-opt step with ``zero1=True, grad_compress="int8"``: dp2 as two
    gloo ranks on the card trains 3 steps, both ranks write and rank 0
    seals; a dp2 restore continues 2 steps bit for bit the uninterrupted
    dp2 run's. Then world 1 restores the dp2 checkpoint (two rank files: a
    ``RankStates``): its flat moments equal the two ranks' chunks joined
    in position bit for bit, its ``e1`` their host sum, the beta pows rank
    0's; 2 more steps finite and within ``COMM_TOL`` (relative) of the
    uninterrupted dp2 run. Rows 1-3 once per layer and row 5 once a step,
    all on the tensor cores, on every rank and at world 1."""
    import shutil

    from paddle_tpu_torch import distributed as dist
    from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
    from paddle_tpu_torch.resilience import TrainState
    cfg = cfg or LlamaConfig(**{**COMM_CELL,
                                "num_hidden_layers": P24B_LAYERS})
    want = want_train_launches(cfg.num_hidden_layers)
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    t0 = time.perf_counter()
    try:
        fleet.init()
        seed(0)
        model = LlamaForCausalLM(cfg, device=device)
        save_weights(workdir, model)
        del model
        ids = train_ids(cfg.vocab_size, *batch, device="cpu")
        np.savez(os.path.join(workdir, "batch.npz"), ids=ids.numpy())
        dist.spawn(_p24b_worker, args=(workdir, cfg, batch,
                                       _rank_device(device)),
                   nprocs=2, timeout=900)
        ranks = []
        for r in range(2):
            with open(os.path.join(workdir, f"p24b.r{r}.json")) as f:
                ranks.append(json.load(f))
        for g in ranks:
            if g["resumed"] != g["cont"]:
                raise AssertionError(f"24b rank {g['rank']}: restored dp2 "
                                     f"losses {g['resumed']} != the "
                                     f"uninterrupted {g['cont']}")
            for i, c in enumerate(g["launches"]):
                if c != want:
                    raise AssertionError(f"24b rank {g['rank']} step {i} "
                                         f"launched {c}, want {want}")
        if ranks[0]["losses"] != ranks[1]["losses"]:
            raise AssertionError("24b: the ranks' losses differ")
        # world 1 from the dp2 checkpoint
        s = fleet.DistributedStrategy()
        s.comm_opt = True
        s.comm_opt_configs.update(P24B_CFG)
        fleet.init(is_collective=True, strategy=s)
        model = fleet.distributed_model(LlamaForCausalLM(cfg, device=device))
        from paddle_tpu_torch.framework.io import load_numpy_state_dict
        load_numpy_state_dict(model, saved_weights(workdir))
        step = fleet.distributed_optimizer(comm_optimizer(
            optimizer, "adamw", model.parameters())).make_train_step(
            model, lambda m, x, y: m(x, labels=y))
        mgr = CheckpointManager(os.path.join(workdir, "ck"), device=device)
        t1 = time.perf_counter()
        at, snap = mgr.restore_latest()
        TrainState(train_step=step).restore(snap)
        sync(device)
        restore_s = time.perf_counter() - t1
        if len(snap) != 2:
            raise AssertionError(f"24b: {len(snap)} rank states, want 2")
        files = [{"train_step": {part: {k: t.cpu() for k, t in
                                        f["train_step"][part].items()}
                                 for part in ("opt", "ef")}} for f in snap]
        n = step.n_local
        got = {k: t.detach().cpu() for k, t in step._opt_state.items()}
        for k in ("moment1", "moment2"):
            joined = torch.cat([f["train_step"]["opt"][k] for f in files])
            if not (torch.equal(got[k][:n], joined[:n])
                    and not got[k][n:].any()):
                raise AssertionError(f"24b: world 1's {k} is not the ranks' "
                                     f"chunks joined")
        for k in ("beta1_pow", "beta2_pow"):
            if not torch.equal(got[k], files[0]["train_step"]["opt"][k]):
                raise AssertionError(f"24b: world 1's {k} is not rank 0's")
        e1 = files[0]["train_step"]["ef"]["e1"] + \
            files[1]["train_step"]["ef"]["e1"]
        if not torch.equal(step._ef["e1"].cpu()[:n], e1[:n]):
            raise AssertionError("24b: world 1's e1 is not the ranks' sum")
        del snap, files
        ids = ids.to(device)
        more, secs, launches = run_steps(fa, fc, rm, step, ids, P24B_MORE,
                                         tag="24b world 1 restored ",
                                         warm_up=False)
        cont = ranks[0]["cont"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(more, cont))
        if not (all(np.isfinite(more)) and rel <= COMM_TOL):
            raise AssertionError(f"24b: world 1 after the restore {more} vs "
                                 f"dp2 {cont} (relative {rel:.3g})")
        for i, c in enumerate(launches):
            if c != want:
                raise AssertionError(f"24b world 1 step {i} launched {c}, "
                                     f"want {want}")
        meta = ranks[0]["meta"]
        del step, model
        if device != "cpu":
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"  24b dp2: losses {ranks[0]['losses']}, then {ranks[0]['cont']} "
        f"uninterrupted and {ranks[0]['resumed']} restored (equal); world 1 "
        f"from the dp2 checkpoint (n_local {meta['n_local']}, dp2 n_pad "
        f"{meta['n_pad']}, world 1 n_pad {n + (-n) % 1024}): moments joined, "
        f"e1 summed, {more} (relative to dp2 {rel:.3g}); rank save "
        f"{[round(g['save_s'], 2) for g in ranks]} s, rank restore "
        f"{[round(g['restore_s'], 2) for g in ranks]} s, world-1 restore "
        f"{restore_s:.2f} s")
    return launches[-1], dict(
        losses=ranks[0]["losses"], cont=ranks[0]["cont"],
        world1=more, world1_rel=rel, rank_save_s=[g["save_s"] for g in ranks],
        rank_restore_s=[g["restore_s"] for g in ranks],
        world1_restore_s=restore_s, world1_step_secs=secs,
        phase_s=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 25: the high-level API and the CNN image-classification path
# ---------------------------------------------------------------------------

RESNET_BATCHES = (64, 128, 256)     # bench.py:bench_resnet50's sweep
RESNET_IMAGE = 224
RESNET_STEPS = 6                    # a warm-up + 5 timed steps
RESNET_TWIN_BATCH = 8               # 25a's fp32 twin (TF32 off)
RESNET_TWIN_TOL = 1e-4              # outputs: channels-last vs NCHW, folded
                                    # vs not (gradients: resnet_twin)
# resnet18(num_classes=10) as the CPU tests pin it (test_torch_hapi.py:
# summary and flops equal the JAX package's)
RESNET18_C10_PARAMS = 11_181_642
RESNET18_C10_FLOPS = 37_169_664     # flops(net, [1, 3, 32, 32])
HAPI_EPOCHS, HAPI_ITERS, HAPI_BATCH = 2, 4, 64   # 25b: 8 steps in all
HAPI_BERT_STEPS = 4                 # 25c: a warm-up + 3 steps


def resnet_step(models, layout, fleet, optimizer, F, seed, batch, size,
                channels_last=False, device="cuda", depth="resnet50"):
    """``bench_resnet50``'s trainer: ``resnet50(num_classes=1000)`` from
    seed 0 (``to_channels_last`` first where asked), bf16, placed by
    ``fleet.distributed_model``, Momentum(0.1, 0.9), the fp32 CE; one
    seeded batch of ``batch`` bf16 images ``size`` x ``size``."""
    seed(0)
    model = getattr(models, depth)(num_classes=1000, device=device)
    if channels_last:
        model = layout.to_channels_last(model)
    model = fleet.distributed_model(model.to(torch.bfloat16))
    opt = fleet.distributed_optimizer(optimizer.Momentum(
        learning_rate=0.1, momentum=0.9, parameters=model.parameters()))
    step = opt.make_train_step(
        model, lambda m, x, y: F.cross_entropy(m(x).float(), y))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(
        (batch, 3, size, size)).astype(np.float32)).to(device,
                                                       torch.bfloat16)
    y = torch.from_numpy(rng.integers(0, 1000, (batch,))).to(device)
    return model, step, x, y


def resnet_run(fa, fc, rm, models, layout, fleet, optimizer, F, seed, batch,
               size, channels_last, device, depth):
    """One 25a cell: a warm-up + ``RESNET_STEPS - 1`` timed steps (no port
    kernel may launch: convolutions on cuDNN, batch norm and pooling on
    torch's ops, as JAX computes them outside Pallas), then one profiled
    step. Returns the cell's numbers."""
    reset_peak(device)
    model, step, x, y = resnet_step(models, layout, fleet, optimizer, F,
                                    seed, batch, size, channels_last, device,
                                    depth)
    tag = f"25a bs{batch}{' channels-last' if channels_last else ''} "
    losses, secs, per_step = run_steps(fa, fc, rm, step, x, RESNET_STEPS,
                                       tag=tag, labels=y)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{tag}: non-finite loss {losses}")
    check_launches(tag, per_step, no_launches())
    step_s = float(np.median(secs[1:]))
    prof = profile_step(step, x, y) if device != "cpu" else None
    res = dict(batch=batch, channels_last=channels_last, losses=losses,
               step_ms=step_s * 1e3, images_per_s=batch / step_s,
               peak_gib=peak_gib(device))
    if prof is not None:
        res.update(device_idle_share=prof["device_idle_share"],
                   device_busy_ms=prof["device_busy_ms"],
                   profiled_step_wall_ms=prof["step_wall_ms"],
                   device_launches_per_step=prof["device_kernel_launches"],
                   top_kernels_ms=prof["top_kernels_ms"])
    log(f"  {tag}: {step_s * 1e3:.1f} ms a step, {batch / step_s:.1f} "
        f"images/s, peak {res['peak_gib']:.2f} GiB, device idle "
        f"{res.get('device_idle_share', float('nan')):.3f}, "
        f"{res.get('device_launches_per_step')} device launches a step"
        + (f" ({smi_line()})" if device != "cpu" else ""))
    del model, step, x, y
    return res


def _flat_grads(model, x, y, F):
    """(output, {name: gradient}) of one forward and backward of the CE,
    names without a ``ChannelsLast`` wrapper's ``model.`` prefix."""
    out = model(x)
    F.cross_entropy(out, y).backward()
    return out.detach(), {k.removeprefix("model."): p.grad
                          for k, p in model.named_parameters()}


def _global_rel(got, want):
    """‖got − want‖ / ‖want‖ over every gradient at once (float64)."""
    num = sum(float((got[k].double() - w.double()).square().sum())
              for k, w in want.items())
    return (num / sum(float(w.double().square().sum())
                      for w in want.values())) ** 0.5


def resnet_twin(models, layout, F, seed, batch, size, device, depth):
    """25a's fp32 twin (TF32 off): the channels-last copy's output within
    ``RESNET_TWIN_TOL`` of the NCHW model's; its gradients against a
    float64 copy of the model on the same device, no further from it
    (over all gradients at once) than twice the NCHW model's distance or
    ``RESNET_TWIN_TOL``, whichever is larger. The NCHW model itself is
    not within 1e-4 of float64: random-init ResNets in training mode sum
    the batch-norm parameters' gradients from terms that nearly cancel,
    and cuDNN's fp32 convolutions do not take exact sums (measured on one
    H100: ResNet-50's NCHW fp32 gradients 2.4e-2 off on a bias, ResNet-18's
    at 64 x 64 1.1e-2 where channels-last was 7e-6). Then
    ``fold_conv_bn``'s eval output within ``RESNET_TWIN_TOL`` of the
    unfolded model's (running statistics moved by three training
    forwards first). All as relative norms."""
    import copy
    seed(0)
    nchw = getattr(models, depth)(num_classes=1000, device=device)
    cl = layout.to_channels_last(copy.deepcopy(nchw))
    f64 = copy.deepcopy(nchw).double()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(
        (batch, 3, size, size)).astype(np.float32)).to(device)
    y = torch.from_numpy(rng.integers(0, 1000, (batch,))).to(device)
    out, grads = _flat_grads(nchw, x, y, F)
    out_cl, grads_cl = _flat_grads(cl, x, y, F)
    _, grads64 = _flat_grads(f64, x.double(), y, F)
    res = dict(channels_last_out_rel=rel_err(out_cl, out),
               nchw_grad_rel_to_f64=_global_rel(grads, grads64),
               channels_last_grad_rel_to_f64=_global_rel(grads_cl, grads64),
               nchw_worst_param_rel_to_f64=max(
                   rel_err(grads[k], w) for k, w in grads64.items()),
               channels_last_worst_param_rel_to_f64=max(
                   rel_err(grads_cl[k], w) for k, w in grads64.items()))
    del f64, grads64
    with torch.no_grad():
        for _ in range(3):
            nchw(x)
        nchw.eval()
        folded = copy.deepcopy(nchw)
        n_folded = len(layout.fold_conv_bn(folded))
        res.update(folded=n_folded,
                   fold_out_rel=rel_err(folded(x), nchw(x)))
    grad_tol = max(RESNET_TWIN_TOL, 2 * res["nchw_grad_rel_to_f64"])
    log(f"  25a fp32 twin (TF32 off, batch {batch}): channels-last output "
        f"{res['channels_last_out_rel']:.3g} of NCHW's; gradients to "
        f"float64: NCHW {res['nchw_grad_rel_to_f64']:.3g} (worst "
        f"parameter {res['nchw_worst_param_rel_to_f64']:.3g}), "
        f"channels-last {res['channels_last_grad_rel_to_f64']:.3g} (worst "
        f"{res['channels_last_worst_param_rel_to_f64']:.3g}; tol "
        f"{grad_tol:.3g}); {n_folded} batch norms folded, eval output "
        f"{res['fold_out_rel']:.3g} (tol {RESNET_TWIN_TOL})")
    bad = [k for k in ("channels_last_out_rel", "fold_out_rel")
           if not res[k] <= RESNET_TWIN_TOL]
    if not res["channels_last_grad_rel_to_f64"] <= grad_tol:
        bad.append("channels_last_grad_rel_to_f64")
    if bad:
        raise AssertionError(f"25a twin: {bad} beyond tolerance: {res}")
    return res


def phase_resnet(fa, fc, rm, models, layout, fleet, optimizer, F, seed,
                 batches=RESNET_BATCHES, size=RESNET_IMAGE,
                 twin_batch=RESNET_TWIN_BATCH, device="cuda",
                 depth="resnet50"):
    """25a: ``bench_resnet50`` at each of its batches, then at the batch
    with the most images/s the same in ``to_channels_last``; the fp32
    twin's checks (``resnet_twin``)."""
    fleet.init()
    sweep = [resnet_run(fa, fc, rm, models, layout, fleet, optimizer, F,
                        seed, b, size, False, device, depth)
             for b in batches]
    best = max(sweep, key=lambda r: r["images_per_s"])
    cl = resnet_run(fa, fc, rm, models, layout, fleet, optimizer, F, seed,
                    best["batch"], size, True, device, depth)
    twin = resnet_twin(models, layout, F, seed, twin_batch, size, device,
                       depth)
    if device != "cpu":
        torch.cuda.empty_cache()
    return dict(sweep=sweep, best_batch=best["batch"], channels_last=cl,
                twin=twin)


def hapi_resnet(models, vision, metric, callbacks, optimizer, nn, seed,
                Model, summary, flops, workdir, batch=HAPI_BATCH,
                device="cuda"):
    """25b: ``paddle.Model(resnet18(num_classes=10))`` on the synthetic
    ``Cifar10`` with ``ToTensor`` + ``Normalize`` through the port's
    ``DataLoader``: ``fit`` (``HAPI_EPOCHS`` epochs of ``HAPI_ITERS``
    batches) with ``EarlyStopping``, ``ModelCheckpoint`` and
    ``LRScheduler``, the LR after it the cosine schedule's after every
    step; ``evaluate`` with ``Accuracy(topk=(1, 5))``;
    ``predict(stack_outputs=True)``; ``save`` -> a fresh ``Model.load`` ->
    ``evaluate`` equal bit for bit; ``summary`` and ``flops`` equal to the
    CPU tests' pinned figures."""
    T = vision.transforms
    tf = T.Compose([T.ToTensor(), T.Normalize([0.5] * 3, [0.25] * 3)])
    train = vision.datasets.Cifar10(mode="train", transform=tf)
    test = vision.datasets.Cifar10(mode="test", transform=tf)

    def make():
        seed(0)
        net = models.resnet18(num_classes=10, device=device)
        sched = optimizer.lr.CosineAnnealingDecay(
            0.1, T_max=HAPI_EPOCHS * HAPI_ITERS)
        model = Model(net)
        model.prepare(optimizer.Momentum(sched, 0.9,
                                         parameters=net.parameters()),
                      nn.CrossEntropyLoss(),
                      metric.Accuracy(topk=(1, 5)))
        return model, sched

    model, sched = make()
    t0 = time.perf_counter()
    model.fit(train, batch_size=batch, epochs=HAPI_EPOCHS,
              num_iters=HAPI_ITERS, shuffle=False, verbose=0,
              callbacks=[callbacks.EarlyStopping(monitor="loss",
                                                 patience=2),
                         callbacks.ModelCheckpoint(save_dir=workdir),
                         callbacks.LRScheduler()])
    fit_s = time.perf_counter() - t0
    ref = optimizer.lr.CosineAnnealingDecay(0.1,
                                            T_max=HAPI_EPOCHS * HAPI_ITERS)
    for _ in range(HAPI_EPOCHS * HAPI_ITERS):
        ref.step()
    if sched() != ref():
        raise AssertionError(f"25b: LR {sched()} after fit, want {ref()}")
    saved = sorted(os.listdir(workdir))
    if saved != sorted(f"{e}.{x}" for e in range(HAPI_EPOCHS)
                       for x in ("pdparams", "pdopt")):
        raise AssertionError(f"25b: ModelCheckpoint wrote {saved}")
    logs = model.evaluate(test, batch_size=batch, verbose=0)
    pred = model.predict(test, batch_size=batch, stack_outputs=True)[0]
    if tuple(pred.shape) != (len(test), 10) or \
            not bool(torch.isfinite(pred).all()):
        raise AssertionError(f"25b: predict gave {tuple(pred.shape)}")
    if not (np.isfinite(logs["loss"]) and 0 <= logs["acc_top1"]
            <= logs["acc_top5"] <= 1):
        raise AssertionError(f"25b: evaluate gave {logs}")
    path = os.path.join(workdir, "final")
    model.save(path)
    fresh, _ = make()
    fresh.load(path)
    again = fresh.evaluate(test, batch_size=batch, verbose=0)
    if again != logs:
        raise AssertionError(f"25b: evaluate after load {again} != {logs}")
    counts = summary(model.network, (1, 3, 32, 32))
    n_flops = flops(model.network, [1, 3, 32, 32])
    if counts["total_params"] != RESNET18_C10_PARAMS \
            or n_flops != RESNET18_C10_FLOPS:
        raise AssertionError(f"25b: summary {counts}, flops {n_flops}; "
                             f"the CPU tests pin {RESNET18_C10_PARAMS} and "
                             f"{RESNET18_C10_FLOPS}")
    res = dict(fit_s=fit_s, steps=HAPI_EPOCHS * HAPI_ITERS, evaluate=logs,
               predict_shape=list(pred.shape), lr_after=sched(),
               checkpoints=saved, total_params=counts["total_params"],
               flops=n_flops)
    log(f"  25b resnet18 on Cifar10 (synthetic), batch {batch}: fit "
        f"{res['steps']} steps in {fit_s:.2f} s, evaluate {logs}, predict "
        f"{res['predict_shape']}, save -> load -> evaluate equal, "
        f"{counts['total_params']} params, {n_flops} FLOPs")
    return res


def hapi_bert(fa, fc, rm, BertForSequenceClassification, cfg, io, callbacks,
              fleet, optimizer, F, seed, Model, batch=BERT_BATCH,
              device="cuda", want=None):
    """25c: ``paddle.Model(BertForSequenceClassification)`` at ``cfg``
    (phase 22b's dropout-free BERT-base), bf16, AdamW(lr=1e-4), on
    ``HAPI_BERT_STEPS`` seeded batches (no mask), ``fit`` with a callback
    that times each batch and counts its launches; the same weights and
    batches through ``make_train_step`` directly (``run_steps``). Rows
    1-3 launch ``want`` each step, and the losses equal bit for bit."""
    B, L = batch
    rng = np.random.default_rng(25)
    ids = rng.integers(0, cfg.vocab_size, (HAPI_BERT_STEPS * B, L))
    labels = rng.integers(0, 2, (HAPI_BERT_STEPS * B, 1))

    def make():
        seed(0)
        net = BertForSequenceClassification(cfg, device=device).to(
            torch.bfloat16)
        return net, optimizer.AdamW(learning_rate=1e-4,
                                    parameters=net.parameters())

    def loss(logits, y):
        return F.cross_entropy(logits.float(), y)

    class Timer(callbacks.Callback):
        """Each train batch's wall (the train step and its loss read) and
        launches: the counts set to 0 at its begin, read at its end."""

        secs, per_step, losses = [], [], []

        def on_train_batch_begin(self, step, logs=None):
            _reset(fa, fc, rm)
            sync(device)
            self.t0 = time.perf_counter()

        def on_train_batch_end(self, step, logs=None):
            sync(device)
            self.secs.append(time.perf_counter() - self.t0)
            self.per_step.append(_counts(fa, fc, rm))
            self.losses.append(logs["loss"])

    net, opt = make()
    model = Model(net)
    model.prepare(opt, loss)
    timer = Timer()
    model.fit(io.TensorDataset([ids, labels]), batch_size=B, shuffle=False,
              verbose=0, callbacks=[timer])
    del model, net, opt
    net, opt = make()
    step = fleet.make_train_step(net, opt, lambda m, x, y: loss(m(x), y))
    secs, losses, per_step = [], [], []
    for i in range(HAPI_BERT_STEPS):
        x = torch.from_numpy(ids[i * B:(i + 1) * B]).to(device)
        y = torch.from_numpy(labels[i * B:(i + 1) * B]).to(device)
        l_, s_, p_ = run_steps(fa, fc, rm, step, x, 1, tag=f"25c direct "
                               f"{i} ", warm_up=i == 0, labels=y)
        losses += l_
        secs += s_
        per_step += p_
    del step, net, opt
    for i, (s, c) in enumerate(zip(timer.secs, timer.per_step)):
        log(f"  25c Model.fit step {i}: loss {timer.losses[i]:.6f}, "
            f"{s * 1e3:.1f} ms, launches {c}")
    if timer.losses != losses:
        raise AssertionError(f"25c: Model.fit's losses {timer.losses} != "
                             f"the direct step's {losses}")
    if want is not None:
        check_launches("25c Model.fit", timer.per_step, want)
        check_launches("25c direct", per_step, want)
    hapi_ms = float(np.median(timer.secs[1:])) * 1e3
    direct_ms = float(np.median(secs[1:])) * 1e3
    log(f"  25c step median: Model.fit {hapi_ms:.2f} ms, direct "
        f"{direct_ms:.2f} ms (hapi's host overhead {hapi_ms - direct_ms:.2f}"
        f" ms); losses equal bit for bit"
        + (f" ({smi_line()})" if device != "cpu" else ""))
    return timer.per_step[-1], dict(
        losses=losses, fit_step_ms=hapi_ms, direct_step_ms=direct_ms,
        overhead_ms=hapi_ms - direct_ms, fit_step_secs=timer.secs,
        direct_step_secs=secs)


def phase_hapi_cnn(fa, fc, rm, seed, resnet_kw=None, hapi_kw=None,
                   bert_cfg=None, bert_batch=BERT_BATCH, device="cuda"):
    """Phase 25: 25a ``phase_resnet``, 25b ``hapi_resnet``, 25c
    ``hapi_bert``. Returns (rows 1-3's launches in a 25c ``Model.fit``
    step, the report)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import (callbacks, io, metric, nn, optimizer,
                                  vision)
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.framework import layout
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.text.models import (BertConfig,
                                              BertForSequenceClassification)
    from paddle_tpu_torch.vision import models
    out = dict(resnet=phase_resnet(fa, fc, rm, models, layout, fleet,
                                   optimizer, F, seed, device=device,
                                   **(resnet_kw or {})))
    with tempfile.TemporaryDirectory() as workdir:
        out["hapi_resnet18"] = hapi_resnet(
            models, vision, metric, callbacks, optimizer, nn, seed, pt.Model,
            pt.summary, pt.flops, workdir, device=device, **(hapi_kw or {}))
    cfg = dataclasses.replace(bert_cfg or BertConfig(),
                              hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0)
    want = (want_attention_launches(cfg.num_hidden_layers)
            if device != "cpu" else no_launches())
    launches, out["hapi_bert"] = hapi_bert(
        fa, fc, rm, BertForSequenceClassification, cfg, io, callbacks, fleet,
        optimizer, F, seed, pt.Model, bert_batch, device, want)
    if device != "cpu":
        torch.cuda.empty_cache()
    return launches, out



# ---------------------------------------------------------------------------
# phase 26: the eager user surface (to_tensor, the flat ops, autograd, Layer)
# ---------------------------------------------------------------------------

# The op table: one row per case of the eager sweep. The CPU tests
# (``tests/test_torch_tensor_ops.py``) feed each row's numpy inputs at
# ``OP_ROWS_CPU`` rows to ``paddle_tpu.<op>`` and ``paddle_tpu_torch.<op>``
# (on the CPU); phase 26a feeds them at ``OP_ROWS_CARD`` rows (about 1M
# elements; linalg at its own shapes) to the port on the card and on a CPU
# copy. Tolerances by kind, relative and absolute alike: integer, bool and
# index results always bit for bit; "exact" rows' float results too;
# "float" (elementwise) 2e-6 (CUDA's fp32 transcendentals are within 2
# ulp of the CPU's, and an activation chains several), "reduce" 1e-5,
# "linalg" 1e-4 of the result's largest element (normwise, by
# reconstruction in float64 where a factor's sign or order is free; eigen
# inputs have eigenvalues 1 apart, so eigenvectors are well posed);
# "random" rows compare shapes and dtypes only. Gradients
# (``sum(op(x) * w)`` with a seeded w, into the first float input) within
# ``GRAD_TOL`` of their largest element, or the row's tolerance if larger,
# times the square root of the terms each gradient element sums (an input
# broadcast over 1M outputs sums 1M cancelling terms).
OP_TOL = {"exact": 0.0, "float": 2e-6, "reduce": 1e-5, "linalg": 1e-4,
          "random": None}
GRAD_TOL = 1e-5
OP_ROWS_CPU = 4
OP_ROWS_CARD = 131072           # x 8 columns: 1,048,576 elements


@dataclasses.dataclass
class Op:
    name: str                   # in the flat namespace, "F.x": nn.functional
    make: object                # (rng, rows) -> positional args (numpy)
    kw: dict = dataclasses.field(default_factory=dict)
    kind: str = "float"
    grad: bool = False
    post: object = None         # (outputs as numpy, args) -> arrays compared
    tag: str = ""
    ctor: tuple = ()            # "nn." rows: the layer's positional args

    @property
    def id(self):
        return self.name + (f"[{self.tag}]" if self.tag else "")


def _fl(r, *s):
    return r.standard_normal(s).astype(np.float32)


def _pos(r, *s):
    return (np.abs(r.standard_normal(s)) + 0.1).astype(np.float32)


def _unit(r, *s):
    return r.uniform(-0.9, 0.9, s).astype(np.float32)


def _nz(r, *s):
    a = _fl(r, *s)
    return np.where(np.abs(a) < 0.1, 0.5, a).astype(np.float32)


def _int(r, *s, lo=-5, hi=10, dt=np.int32):
    return r.integers(lo, hi, s).astype(dt)


def _nzint(r, *s):
    a = _int(r, *s, lo=-4, hi=5)
    return np.where(a == 0, 3, a).astype(np.int32)


def _bool(r, *s):
    return r.random(s) < 0.5


def _cplx(r, *s):
    return (r.standard_normal(s) + 1j * r.standard_normal(s)).astype(
        np.complex64)


def _specials(r, *s):
    a = _fl(r, *s).reshape(-1)
    a[::5], a[1::7], a[2::11] = np.nan, np.inf, -np.inf
    return a.reshape(s)


def _ties(r, *s):
    return r.integers(0, 3, s).astype(np.float32)


def _k(n):
    """The matrix size of the linalg rows: small on the CPU, 128 on the
    card."""
    return 4 if n < 64 else 128


def _well(r, b, k):
    """Well-conditioned square matrices: I + noise / (2 sqrt(k))."""
    return (np.eye(k) + r.standard_normal((b, k, k)) / (2 * np.sqrt(k))
            ).astype(np.float32)


def _spd(r, b, k):
    a = r.standard_normal((b, k, k)) / np.sqrt(k)
    return (a @ a.transpose(0, 2, 1) + np.eye(k)).astype(np.float32)


def _sym(r, b, k):
    """Symmetric matrices with eigenvalues 1 apart, -(k-1)/2 .. (k-1)/2."""
    q = np.linalg.qr(r.standard_normal((b, k, k)))[0]
    w = np.arange(k) - (k - 1) / 2
    return ((q * w[None, None, :]) @ q.transpose(0, 2, 1)).astype(
        np.float32)


def _reflectors(r, m, n):
    """A QR factorisation's Householder vectors (LAPACK's packing) and
    their taus, as ``householder_product`` takes them."""
    h, tau = np.linalg.qr(r.standard_normal((m, n)), mode="raw")
    return [np.ascontiguousarray(h.T).astype(np.float32),
            tau.astype(np.float32)]


def _np_lu(a):
    """LAPACK's getrf on one matrix: packed LU, 1-based int32 pivots."""
    a = np.array(a, dtype=np.float64)
    m = a.shape[0]
    piv = np.zeros(m, np.int32)
    for j in range(m):
        p = j + int(np.argmax(np.abs(a[j:, j])))
        piv[j] = p + 1
        a[[j, p]] = a[[p, j]]
        a[j + 1:, j] /= a[j, j]
        a[j + 1:, j + 1:] -= np.outer(a[j + 1:, j], a[j, j + 1:])
    return a.astype(np.float32), piv


def _lu_recon(lu_, piv):
    """``P @ L @ U`` from packed factors and 1-based pivots (batched)."""
    lu_, piv = np.asarray(lu_, np.float64), np.asarray(piv)
    out = []
    for f, p in zip(lu_.reshape(-1, *lu_.shape[-2:]),
                    piv.reshape(-1, piv.shape[-1])):
        m = f.shape[0]
        a = (np.tril(f, -1) + np.eye(m)) @ np.triu(f)
        for j in reversed(range(m)):
            a[[j, p[j] - 1]] = a[[p[j] - 1, j]]
        out.append(a)
    return np.stack(out).reshape(lu_.shape)


def _f64(outs):
    return [np.asarray(o, np.float64) for o in outs]


def _sorted_real(outs, args):
    return [np.sort(np.real(outs[0]).astype(np.float64), axis=-1)]


def _svd_post(outs, args):
    u, s, vh = _f64(outs)
    return [s, (u * s[..., None, :]) @ vh]


def _qr_post(outs, args):
    q, r_ = _f64(outs)
    return [q @ r_, np.abs(np.diagonal(r_, axis1=-2, axis2=-1))]


def _eigh_post(outs, args):
    w, v = _f64(outs)
    return [w, (v * w[..., None, :]) @ np.swapaxes(v, -1, -2)]


def _lu_post(outs, args):
    return [_lu_recon(outs[0], outs[1])]


def _pca_post(outs, args):
    u, s, v = _f64(outs)
    return [s, (u * s[..., None, :]) @ np.swapaxes(v, -1, -2)]


def _binary_family(n):
    """``test_op_parity_sweep.py``'s binary ops over its broadcasts and
    dtypes (float32, float64, and int32, int64 where they take ints)."""
    shapes = [((n, 8), (n, 8)), ((n, 1), (1, 8)), ((2, n, 4), (4,)),
              ((1,), (n, 2)), ((), (n, 8))]
    ops = [("add", True), ("subtract", True), ("multiply", True),
           ("divide", False), ("maximum", True), ("minimum", True),
           ("fmax", True), ("fmin", True), ("atan2", False),
           ("logaddexp", False), ("heaviside", False), ("hypot", False)]
    rows = []
    for name, int_ok in ops:
        for dt in [np.float32, np.float64] + (
                [np.int32, np.int64] if int_ok else []):
            for sa, sb in shapes:
                isint = np.issubdtype(dt, np.integer)

                def make(r, n_, sa=sa, sb=sb, dt=dt, name=name):
                    if np.issubdtype(dt, np.integer):
                        return [r.integers(-5, 10, sa).astype(dt),
                                r.integers(-5, 10, sb).astype(dt)]
                    b = r.standard_normal(sb)
                    if name == "divide":
                        b = np.abs(b) + 0.1
                    return [r.standard_normal(sa).astype(dt), b.astype(dt)]
                rows.append(Op(name, make, kind="exact" if isint
                               else "float",
                               grad=not isint and name != "heaviside",
                               tag=f"{np.dtype(dt).name}:{sa}x{sb}"))
    return rows


_UNARY = [("abs", _fl), ("acos", _unit), ("acosh", lambda r, *s: _pos(
    r, *s) + 1), ("asin", _unit), ("asinh", _fl), ("atan", _fl),
    ("atanh", _unit), ("ceil", _fl), ("cos", _fl), ("cosh", _fl),
    ("digamma", _pos), ("erf", _fl), ("erfinv", _unit), ("exp", _fl),
    ("expm1", _fl), ("floor", _fl), ("lgamma", _pos), ("log", _pos),
    ("log10", _pos), ("log1p", _pos), ("log2", _pos), ("neg", _fl),
    ("reciprocal", _nz), ("round", lambda r, *s: 3 * _fl(r, *s)),
    ("rsqrt", _pos), ("sigmoid", _fl), ("sign", _fl), ("sin", _fl),
    ("sinh", _fl), ("sqrt", _pos), ("square", _fl), ("tan", _unit),
    ("tanh", _fl), ("trunc", lambda r, *s: 3 * _fl(r, *s)), ("angle", _fl),
    ("conj", _fl), ("deg2rad", _fl), ("rad2deg", _fl),
    ("frac", lambda r, *s: 3 * _fl(r, *s)), ("i0", _fl), ("i1", _fl)]

_ACTIVATIONS = [
    ("relu", {}), ("relu6", {}), ("sigmoid", {}), ("tanh", {}),
    ("silu", {}), ("swish", {}), ("mish", {}), ("hardswish", {}),
    ("hardsigmoid", {}), ("tanhshrink", {}), ("softsign", {}),
    ("gelu", {}), ("gelu", {"approximate": True}), ("elu", {"alpha": 0.5}),
    ("celu", {"alpha": 2.0}), ("selu", {}),
    ("leaky_relu", {"negative_slope": 0.2}), ("rrelu", {}),
    ("hardtanh", {"min": -0.5, "max": 0.7}), ("hardshrink", {}),
    ("softshrink", {"threshold": 0.3}),
    ("softplus", {"beta": 2.0, "threshold": 3.0}), ("softmax", {"axis": 1}),
    ("log_softmax", {"axis": -1}), ("log_sigmoid", {}), ("logsigmoid", {}),
    ("glu", {"axis": 1}), ("thresholded_relu", {"threshold": 0.5})]


def op_cases(n):
    """The table at ``n`` rows (see ``OP_TOL``)."""
    k = _k(n)
    b = 2 if n < 64 else 8
    L = []

    def add(name, make, kind="float", grad=False, post=None, tag="", **kw):
        L.append(Op(name, make, kw, kind, grad, post, tag))

    # creation
    add("zeros", lambda r, n: [[n, 8]], "exact")
    add("ones", lambda r, n: [[n, 8]], "exact", dtype="int32")
    add("full", lambda r, n: [[n, 8], 2.5], "exact")
    add("full", lambda r, n: [[n, 8], 3], "exact", tag="int")
    add("empty", lambda r, n: [[n, 8]], "exact")
    add("zeros_like", lambda r, n: [_fl(r, n, 8)], "exact", dtype="int32")
    add("ones_like", lambda r, n: [_fl(r, n, 8)], "exact")
    add("full_like", lambda r, n: [_fl(r, n, 8), 1.5], "exact")
    add("empty_like", lambda r, n: [_int(r, n, 8)], "exact")
    add("arange", lambda r, n: [0, n * 8, 3], "exact")
    add("arange", lambda r, n: [0.5, 10.0, 0.25], tag="float")
    add("linspace", lambda r, n: [-1.0, 1.0, n * 8])
    add("logspace", lambda r, n: [0.0, 2.0, 16])
    add("eye", lambda r, n: [n, 8], "exact")
    add("meshgrid", lambda r, n: [[_fl(r, n), _fl(r, 8)]], "exact",
        grad=True)
    add("diag", lambda r, n: [_fl(r, 16)], "exact", grad=True, offset=1,
        padding_value=2.0)
    add("diag", lambda r, n: [_fl(r, 16, 16)], "exact", grad=True,
        tag="matrix", offset=-1)
    add("diagflat", lambda r, n: [_fl(r, 4, 4)], "exact", grad=True,
        offset=1)
    add("diag_embed", lambda r, n: [_fl(r, n, 4)], "exact", grad=True)
    add("tril", lambda r, n: [_fl(r, n, 8)], "exact", grad=True, diagonal=1)
    add("triu", lambda r, n: [_fl(r, n, 8)], "exact", grad=True,
        diagonal=-1)
    add("tril_indices", lambda r, n: [16, 12, 1], "exact")
    add("triu_indices", lambda r, n: [16, 12, -1], "exact")
    add("assign", lambda r, n: [_fl(r, n, 8)], "exact")
    add("clone", lambda r, n: [_fl(r, n, 8)], "exact", grad=True)
    add("complex", lambda r, n: [_fl(r, n, 8), _fl(r, n, 8)], "exact")
    add("as_complex", lambda r, n: [_fl(r, n, 8, 2)], "exact")
    add("as_real", lambda r, n: [_cplx(r, n, 8)], "exact")
    add("real", lambda r, n: [_cplx(r, n, 8)], "exact")
    add("imag", lambda r, n: [_cplx(r, n, 8)], "exact")
    add("polar", lambda r, n: [_pos(r, n, 8), _fl(r, n, 8)])
    # elementwise unary
    for name, dom in _UNARY:
        add(name, lambda r, n, dom=dom: [dom(r, n, 8)], grad=True)
    add("round", lambda r, n: [np.tile(np.asarray(
        [-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 3.5, 4.5], np.float32), (n, 1))],
        "exact", tag="halves")
    for name in ("abs", "sign", "square", "neg"):
        add(name, lambda r, n: [_int(r, n, 8)], "exact", tag="int32")
    add("sqrt", lambda r, n: [_int(r, n, 8, lo=0)], tag="int32")
    add("exp", lambda r, n: [_int(r, n, 8, lo=-3, hi=3)], tag="int32")
    for name in ("isfinite", "isinf", "isnan"):
        add(name, lambda r, n: [_specials(r, n, 8)], "exact")
    # elementwise binary
    L.extend(_binary_family(n))
    add("floor_divide", lambda r, n: [_int(r, n, 8, lo=-9), _nzint(r, n, 8)],
        "exact", tag="int")
    add("floor_divide", lambda r, n: [3 * _fl(r, n, 8), _nz(r, n, 8)],
        tag="float")
    for name in ("mod", "remainder", "floor_mod"):
        add(name, lambda r, n: [_int(r, n, 8, lo=-9), _nzint(r, n, 8)],
            "exact", tag="int")
    add("mod", lambda r, n: [3 * _fl(r, n, 8), _nz(r, n, 8)], grad=True,
        tag="float")
    add("true_divide", lambda r, n: [_fl(r, n, 8), _nz(r, n, 8)], grad=True)
    add("divide", lambda r, n: [_int(r, n, 8), _int(r, n, 8, lo=1)],
        tag="int")
    add("pow", lambda r, n: [_pos(r, n, 8), _fl(r, n, 8)], grad=True)
    add("pow", lambda r, n: [_fl(r, n, 8), 2], grad=True, tag="scalar")
    add("pow", lambda r, n: [_int(r, n, 8, lo=0, hi=5),
                             _int(r, n, 8, lo=0, hi=4)], "exact", tag="int")
    add("nextafter", lambda r, n: [_fl(r, n, 8), _fl(r, n, 8)], "exact")
    add("gcd", lambda r, n: [_int(r, n, 8, lo=-20, hi=20),
                             _int(r, n, 8, lo=-20, hi=20)], "exact")
    add("lcm", lambda r, n: [_int(r, n, 8, lo=-20, hi=20),
                             _int(r, n, 8, lo=-20, hi=20)], "exact")
    add("copysign", lambda r, n: [_fl(r, n, 8), _fl(r, n, 8)], grad=True)
    add("add", lambda r, n: [_int(r, n, 8), 2.5], tag="int+float")
    add("multiply", lambda r, n: [_fl(r, n, 8), 3], grad=True,
        tag="float*int")
    add("scale", lambda r, n: [_fl(r, n, 8)], grad=True, scale=2.0,
        bias=1.0)
    add("scale", lambda r, n: [_fl(r, n, 8)], grad=True, tag="bias_first",
        scale=2.0, bias=1.0, bias_after_scale=False)
    add("divide_no_nan", lambda r, n: [_fl(r, n, 8), np.where(
        _bool(r, n, 8), 0.0, _nz(r, n, 8)).astype(np.float32)], grad=True)
    add("multiplex", lambda r, n: [[_fl(r, n, 8), _fl(r, n, 8)],
                                   _int(r, n, 1, lo=0, hi=2)], "exact",
        grad=True)
    # matmul family
    add("matmul", lambda r, n: [_fl(r, n, 8), _fl(r, 8, 8)], "reduce",
        grad=True)
    add("matmul", lambda r, n: [_fl(r, n, 8), _fl(r, 16, 8)], "reduce",
        grad=True, tag="transpose_y", transpose_y=True)
    add("matmul", lambda r, n: [_fl(r, 8, n), _fl(r, 8, 4)], "reduce",
        grad=True, tag="transpose_x", transpose_x=True)
    add("mm", lambda r, n: [_fl(r, n, 8), _fl(r, 8, 4)], "reduce", grad=True)
    add("bmm", lambda r, n: [_fl(r, 2, n, 8), _fl(r, 2, 8, 4)], "reduce",
        grad=True)
    add("dot", lambda r, n: [_fl(r, n, 8), _fl(r, n, 8)], "reduce",
        grad=True)
    add("inner", lambda r, n: [_fl(r, n, 8), _fl(r, 4, 8)], "reduce",
        grad=True)
    add("outer", lambda r, n: [_fl(r, 64), _fl(r, 32)], grad=True)
    add("addmm", lambda r, n: [_fl(r, n, 4), _fl(r, n, 8), _fl(r, 8, 4)],
        "reduce", grad=True, beta=0.5, alpha=2.0)
    add("kron", lambda r, n: [_fl(r, 4, 4), _fl(r, 8, 3)], grad=True)
    add("cross", lambda r, n: [_fl(r, n, 3), _fl(r, n, 3)], grad=True)
    # reductions
    for name, dom in (("sum", _fl), ("mean", _fl), ("max", _fl),
                      ("min", _fl), ("amax", _fl), ("amin", _fl),
                      ("logsumexp", _fl), ("nansum", _specials),
                      ("nanmean", _specials),
                      ("prod", lambda r, *s: r.uniform(0.8, 1.2, s).astype(
                          np.float32))):
        nan = name.startswith("nan")
        dom = (lambda r, *s: np.where(_bool(r, *s), np.nan, _fl(r, *s))
               .astype(np.float32)) if nan else dom
        add(name, lambda r, n, dom=dom: [dom(r, n, 8)], "reduce",
            grad=not nan, axis=1)
        add(name, lambda r, n, dom=dom: [dom(r, n, 8)], "reduce",
            grad=not nan, tag="keepdim", axis=-1, keepdim=True)
        add(name, lambda r, n, dom=dom: [dom(r, 3, 4, 5)], "reduce",
            grad=not nan, tag="all")
        add(name, lambda r, n, dom=dom: [dom(r, 3, 4, 5)], "reduce",
            grad=not nan, tag="axes", axis=[0, 2], keepdim=True)
    for name in ("all", "any"):
        add(name, lambda r, n: [_bool(r, n, 8)], "exact", axis=1)
        add(name, lambda r, n: [_bool(r, 3, 4)], "exact", tag="all")
    add("count_nonzero", lambda r, n: [_int(r, n, 8, lo=-1, hi=2)], "exact",
        axis=1)
    add("sum", lambda r, n: [_int(r, n, 8)], "exact", tag="int32", axis=1)
    add("sum", lambda r, n: [_bool(r, n, 8)], "exact", tag="bool", axis=1)
    add("sum", lambda r, n: [_int(r, n, 8)], "exact", tag="dtype", axis=1,
        dtype="float32")
    add("mean", lambda r, n: [_int(r, n, 8)], "reduce", tag="int32", axis=1)
    add("prod", lambda r, n: [_int(r, n, 8, lo=-2, hi=3)], "exact",
        tag="int32", axis=1)
    # cumulative
    add("cumsum", lambda r, n: [_fl(r, n, 8)], "reduce", grad=True, axis=1)
    add("cumsum", lambda r, n: [_fl(r, 4, 5)], "reduce", grad=True,
        tag="flat")
    add("cumsum", lambda r, n: [_int(r, n, 8)], "exact", tag="int32", axis=1)
    add("cumprod", lambda r, n: [r.uniform(0.8, 1.2, (n, 8)).astype(
        np.float32)], "reduce", grad=True, dim=1)
    for name in ("cummax", "cummin"):
        add(name, lambda r, n: [_ties(r, n, 8)], "exact", tag="ties", axis=1)
        add(name, lambda r, n: [_fl(r, n, 8)], "exact", grad=True, axis=1)
    # clip and misc
    add("clip", lambda r, n: [_fl(r, n, 8), -0.5, 0.5], "exact", grad=True)
    add("clip", lambda r, n: [_int(r, n, 8), -2, 3], "exact", tag="int32")
    add("lerp", lambda r, n: [_fl(r, n, 8), _fl(r, n, 8), 0.3], grad=True)
    add("lerp", lambda r, n: [_fl(r, n, 8), _fl(r, n, 8), r.random(
        (n, 8)).astype(np.float32)], grad=True, tag="tensor_w")
    add("nan_to_num", lambda r, n: [_specials(r, n, 8)], "exact",
        posinf=9.0, neginf=-9.0)
    add("logit", lambda r, n: [r.uniform(-0.1, 1.1, (n, 8)).astype(
        np.float32)], grad=True, eps=1e-3)
    add("trace", lambda r, n: [_fl(r, n, 8)], "reduce", grad=True, offset=1)
    add("diagonal", lambda r, n: [_fl(r, 2, n, 8)], "exact", grad=True,
        axis1=1, axis2=2, offset=-1)
    add("diff", lambda r, n: [_fl(r, n, 8)], grad=True, n=2, axis=1)
    add("diff", lambda r, n: [_fl(r, n, 8)], grad=True, tag="prepend",
        axis=1, prepend=_fl(np.random.default_rng(5), n, 1))
    add("increment", lambda r, n: [_fl(r, 1)], value=2.0)
    add("stanh", lambda r, n: [_fl(r, n, 8)], grad=True)
    add("softplus_raw", lambda r, n: [_fl(r, n, 8)])
    add("broadcast_shape", lambda r, n: [[n, 1], [1, 8]], "exact")
    add("renorm", lambda r, n: [_fl(r, n, 8), 2.0, 1, float(np.sqrt(n))],
        "reduce", grad=True)
    # manipulation
    add("reshape", lambda r, n: [_fl(r, n, 8), [0, 2, -1]], "exact",
        grad=True)
    add("reshape", lambda r, n: [_int(r, n, 8), [-1]], "exact", tag="int")
    add("flatten", lambda r, n: [_fl(r, 2, n, 4)], "exact", grad=True,
        start_axis=1, stop_axis=2)
    add("transpose", lambda r, n: [_fl(r, 2, n, 4), [2, 0, 1]], "exact",
        grad=True)
    add("t", lambda r, n: [_fl(r, n, 8)], "exact", grad=True)
    add("moveaxis", lambda r, n: [_fl(r, 2, n, 4), 0, 2], "exact")
    add("swapaxes", lambda r, n: [_fl(r, 2, n, 4), 0, 2], "exact")
    add("concat", lambda r, n: [[_fl(r, n, 8), _fl(r, n, 3)], 1], "exact",
        grad=True)
    add("concat", lambda r, n: [[_fl(r, n, 8), _int(r, n, 8)]], "exact",
        tag="promote")
    add("stack", lambda r, n: [[_fl(r, n, 8), _fl(r, n, 8)], 1], "exact",
        grad=True)
    add("split", lambda r, n: [_fl(r, n, 8), 4, 1], "exact", grad=True)
    add("split", lambda r, n: [_fl(r, n, 8), [2, -1, 3], 1], "exact",
        grad=True, tag="sections")
    add("chunk", lambda r, n: [_fl(r, n, 8), 2, 1], "exact")
    add("unbind", lambda r, n: [_fl(r, 8, n)], "exact", grad=True)
    add("unstack", lambda r, n: [_fl(r, n, 3)], "exact", axis=1)
    add("squeeze", lambda r, n: [_fl(r, n, 1, 8, 1), [1, 3]], "exact",
        grad=True)
    add("squeeze", lambda r, n: [_fl(r, n, 1, 8), [0, 1]], "exact",
        tag="keeps")
    add("unsqueeze", lambda r, n: [_fl(r, n, 8), [0, 2]], "exact",
        grad=True)
    add("tile", lambda r, n: [_fl(r, n, 8), [2, 1]], "exact", grad=True)
    add("expand", lambda r, n: [_fl(r, 1, 8), [n, -1]], "exact", grad=True)
    add("expand_as", lambda r, n: [_fl(r, 1, 8), _fl(r, n, 8)], "exact")
    add("broadcast_to", lambda r, n: [_fl(r, n, 1), [n, 8]], "exact",
        grad=True)
    add("broadcast_tensors", lambda r, n: [[_fl(r, n, 1), _fl(r, 1, 8)]],
        "exact")
    add("flip", lambda r, n: [_fl(r, n, 8), [0, 1]], "exact", grad=True)
    add("rot90", lambda r, n: [_fl(r, n, 8), 1, [0, 1]], "exact")
    add("roll", lambda r, n: [_fl(r, n, 8), 2, 1], "exact", grad=True)
    add("roll", lambda r, n: [_fl(r, n, 8), 3], "exact", tag="flat")
    add("gather", lambda r, n: [_fl(r, n, 8), r.integers(0, n, 6)], "exact",
        grad=True)
    add("gather", lambda r, n: [_fl(r, n, 8), r.integers(0, 8, 5), 1],
        "exact", tag="axis1")
    add("gather_nd", lambda r, n: [_fl(r, n, 8), np.stack(
        [r.integers(0, n, 6), r.integers(0, 8, 6)], -1)], "exact",
        grad=True)
    add("take", lambda r, n: [_fl(r, n, 8), r.integers(0, n * 8, 10)],
        "exact", grad=True)
    add("take", lambda r, n: [_fl(r, n, 8), r.integers(
        -3 * n * 8, 3 * n * 8, 10)], "exact", tag="wrap", mode="wrap")
    add("take", lambda r, n: [_fl(r, n, 8), r.integers(
        -3 * n * 8, 3 * n * 8, 10)], "exact", tag="clip", mode="clip")
    add("take_along_axis", lambda r, n: [_fl(r, n, 8), r.integers(
        0, 8, (n, 3)), 1], "exact", grad=True)
    add("put_along_axis", lambda r, n: [_fl(r, n, 8), np.argsort(
        r.random((n, 8)), axis=1)[:, :3], _fl(r, n, 3), 1], "exact",
        grad=True)
    add("put_along_axis", lambda r, n: [_fl(r, n, 8), r.integers(
        0, 8, (n, 4)), _fl(r, n, 4), 1], "float", grad=True, tag="add",
        reduce="add")
    add("index_select", lambda r, n: [_fl(r, n, 8), r.integers(0, n, 5)],
        "exact", grad=True)
    add("index_sample", lambda r, n: [_fl(r, n, 8), r.integers(
        0, 8, (n, 3))], "exact", grad=True)
    add("index_add", lambda r, n: [_fl(r, n, 8), r.integers(0, n, 6), 0,
                                   _fl(r, 6, 8)], grad=True)
    add("scatter", lambda r, n: [_fl(r, n, 8), r.permutation(n)[:3],
                                 _fl(r, 3, 8)], "exact", grad=True)
    add("scatter", lambda r, n: [_fl(r, n, 8), np.asarray([1, 0, 1, 2]),
                                 _fl(r, 4, 8)], grad=True, tag="add",
        overwrite=False)
    add("scatter_nd_add", lambda r, n: [_fl(r, n, 8), np.stack(
        [r.integers(0, n, 6), r.integers(0, 8, 6)], -1), _fl(r, 6)],
        grad=True)
    add("scatter_nd", lambda r, n: [np.stack([r.integers(0, n, 6),
                                              r.integers(0, 8, 6)], -1),
                                    _fl(r, 6), [n, 8]], grad=True)
    add("masked_select", lambda r, n: [_fl(r, n, 8), _bool(r, n, 8)],
        "exact", grad=True)
    add("masked_fill", lambda r, n: [_fl(r, n, 8), _bool(r, n, 8), 2.0],
        "exact", grad=True)
    add("where", lambda r, n: [_bool(r, n, 8), _fl(r, n, 8), _fl(r, n, 8)],
        "exact", grad=True)
    add("where", lambda r, n: [_bool(r, n, 8), _fl(r, n, 8), 0.0], "exact",
        tag="scalar")
    add("where", lambda r, n: [_bool(r, n, 8)], "exact", tag="indices")
    add("nonzero", lambda r, n: [_int(r, n, 8, lo=-1, hi=2)], "exact")
    add("nonzero", lambda r, n: [_int(r, n, 8, lo=-1, hi=2)], "exact",
        tag="tuple", as_tuple=True)
    add("unique", lambda r, n: [_int(r, n, 8, lo=0, hi=20)], "exact",
        return_index=True, return_inverse=True, return_counts=True)
    add("unique", lambda r, n: [_int(r, n, 2, lo=0, hi=2)], "exact",
        tag="rows", return_counts=True, axis=0)
    add("unique_consecutive", lambda r, n: [np.repeat(_int(
        r, n * 2, lo=0, hi=3), 4).reshape(n, 8)], "exact",
        return_inverse=True, return_counts=True)
    add("unique_consecutive", lambda r, n: [np.repeat(_int(
        r, n, 2, lo=0, hi=2), 2, axis=0)], "exact", tag="rows",
        return_inverse=True, return_counts=True, axis=0)
    add("cast", lambda r, n: [3 * _fl(r, n, 8), "int32"], "exact")
    add("cast", lambda r, n: [_fl(r, n, 8), "bfloat16"], "exact",
        tag="bf16")
    add("cast", lambda r, n: [_int(r, n, 8), "float32"], "exact",
        tag="int")
    add("slice", lambda r, n: [_fl(r, n, 8), [0, 1], [1, 2], [n - 1, -1]],
        "exact", grad=True)
    add("strided_slice", lambda r, n: [_fl(r, n, 8), [0, 1], [0, 7],
                                       [n, 0], [2, -2]], "exact", grad=True)
    add("repeat_interleave", lambda r, n: [_fl(r, n, 8), 2, 1], "exact",
        grad=True)
    add("repeat_interleave", lambda r, n: [_fl(r, 4, 5), 2], "exact",
        tag="flat")
    add("shard_index", lambda r, n: [_int(r, n, 1, lo=0, hi=20), 20, 2, 1],
        "exact")
    add("crop", lambda r, n: [_fl(r, n, 8), [n - 1, 4], [1, 2]], "exact",
        grad=True)
    add("tensordot", lambda r, n: [_fl(r, n, 8), _fl(r, 8, 5), 1],
        "reduce", grad=True)
    add("tensordot", lambda r, n: [_fl(r, 4, 8), _fl(r, 4, 8), [0, 1]],
        "reduce", tag="flat_list")
    add("tensordot", lambda r, n: [_fl(r, n, 8), _fl(r, 5, 8), [[1], [1]]],
        "reduce", grad=True, tag="pairs")
    add("view", lambda r, n: [_fl(r, n, 8), [8, -1]], "exact")
    add("view_as", lambda r, n: [_fl(r, n, 8), _fl(r, 8, n)], "exact")
    add("as_strided", lambda r, n: [_fl(r, n, 8), [n, 4], [8, 2], 1],
        "exact")
    add("atleast_1d", lambda r, n: [np.asarray(1.5, np.float32)], "exact")
    add("atleast_2d", lambda r, n: [_fl(r, 8), _fl(r, n, 8)], "exact")
    add("atleast_3d", lambda r, n: [_fl(r, n, 8)], "exact")
    add("fill_diagonal", lambda r, n: [_fl(r, n, 8), 2.0], "exact",
        grad=True)
    add("fill_diagonal", lambda r, n: [_fl(r, n, 8), 2.0, 1, True], "exact",
        tag="wrap")
    add("fill_diagonal", lambda r, n: [_fl(r, 4, 4, 4), 1.0], "exact",
        tag="nd")
    add("fill_diagonal_tensor", lambda r, n: [_fl(r, n, 6, 4),
                                              _fl(r, n, 3)], "exact",
        grad=True, offset=1, dim1=1, dim2=2)
    # logic
    for name in ("equal", "not_equal", "greater_than", "greater_equal",
                 "less_than", "less_equal"):
        add(name, lambda r, n: [_ties(r, n, 8), _ties(r, n, 8)], "exact")
        add(name, lambda r, n: [_int(r, n, 8), _int(r, n, 8)], "exact",
            tag="int32")
    for name in ("logical_and", "logical_or", "logical_xor"):
        add(name, lambda r, n: [_bool(r, n, 8), _bool(r, n, 8)], "exact")
    add("logical_not", lambda r, n: [_bool(r, n, 8)], "exact")
    add("logical_and", lambda r, n: [_int(r, n, 8), _int(r, n, 8)], "exact",
        tag="int")
    for name in ("bitwise_and", "bitwise_or", "bitwise_xor"):
        add(name, lambda r, n: [_int(r, n, 8, lo=0, hi=255),
                                _int(r, n, 8, lo=0, hi=255)], "exact")
        add(name, lambda r, n: [_bool(r, n, 8), _bool(r, n, 8)], "exact",
            tag="bool")
    add("bitwise_not", lambda r, n: [_int(r, n, 8)], "exact")
    add("bitwise_left_shift", lambda r, n: [_int(r, n, 8, lo=0, hi=100),
                                            _int(r, n, 8, lo=0, hi=4)],
        "exact")
    add("bitwise_right_shift", lambda r, n: [_int(r, n, 8, lo=-100,
                                                  hi=100),
                                             _int(r, n, 8, lo=0, hi=4)],
        "exact")
    add("equal_all", lambda r, n: [_ties(r, n, 8), _ties(r, n, 8)], "exact")
    add("equal_all", lambda r, n: [np.ones((n, 8), np.float32),
                                   np.ones((n, 8), np.float32)], "exact",
        tag="same")
    add("allclose", lambda r, n: [np.ones((n, 8), np.float32), np.full(
        (n, 8), 1 + 1e-6, np.float32)], "exact")
    add("isclose", lambda r, n: [_fl(r, n, 8), _fl(r, n, 8)], "exact")
    add("is_empty", lambda r, n: [np.zeros((0, 3), np.float32)], "exact")
    add("is_tensor", lambda r, n: [_fl(r, 2)], "exact")
    add("isreal", lambda r, n: [np.where(_bool(r, n, 8), _cplx(r, n, 8),
                                         _fl(r, n, 8))], "exact")
    add("iscomplex", lambda r, n: [_cplx(r, 2)], "exact")
    add("is_complex", lambda r, n: [_cplx(r, 2)], "exact")
    add("is_floating_point", lambda r, n: [_fl(r, 2)], "exact")
    add("is_integer", lambda r, n: [_int(r, 2)], "exact")
    # search
    for name in ("argmax", "argmin"):
        add(name, lambda r, n: [_fl(r, n, 8)], "exact")
        add(name, lambda r, n: [_ties(r, n, 8)], "exact", tag="ties", axis=1,
            keepdim=True)
    add("argsort", lambda r, n: [_ties(r, n, 8)], "exact", tag="ties",
        descending=True)
    add("argsort", lambda r, n: [_fl(r, n, 8)], "exact", axis=0)
    add("sort", lambda r, n: [_ties(r, n, 8)], "exact", tag="ties",
        descending=True)
    add("sort", lambda r, n: [_fl(r, n, 8)], "exact", grad=True)
    add("topk", lambda r, n: [_ties(r, n, 8), 3], "exact", tag="ties")
    add("topk", lambda r, n: [_ties(r, n, 8), 3], "exact", tag="smallest",
        largest=False)
    add("topk", lambda r, n: [_fl(r, n, 8), 2], "exact", grad=True)
    add("kthvalue", lambda r, n: [_fl(r, n, 8), 3, 1], "exact", grad=True)
    add("kthvalue", lambda r, n: [_ties(r, n, 8), 2], "exact", tag="ties",
        keepdim=True)
    add("mode", lambda r, n: [_ties(r, n, 8)], "exact")
    add("searchsorted", lambda r, n: [np.sort(_fl(r, 64)), _fl(r, n, 8)],
        "exact")
    add("searchsorted", lambda r, n: [np.sort(_ties(r, n, 8), axis=1),
                                      _ties(r, n, 3)], "exact", tag="rows",
        right=True)
    add("bucketize", lambda r, n: [_fl(r, n, 8), np.sort(_fl(r, 16))],
        "exact")
    add("histogram", lambda r, n: [_fl(r, n, 8), 10, -2.0, 2.0], "exact")
    add("bincount", lambda r, n: [r.integers(0, 10, n * 8)], "exact",
        minlength=12)
    add("bincount", lambda r, n: [r.integers(0, 10, 40), _fl(r, 40)],
        "reduce", tag="weights")
    # statistics
    for name in ("std", "var"):
        add(name, lambda r, n: [_fl(r, n, 8)], "reduce", grad=True, axis=1)
        add(name, lambda r, n: [_fl(r, 4, 5)], "reduce", grad=True,
            tag="biased", unbiased=False)
    add("median", lambda r, n: [_fl(r, n, 8)], "reduce", grad=True, axis=1)
    add("median", lambda r, n: [_fl(r, n, 7)], "reduce", grad=True,
        tag="odd", axis=1, keepdim=True)
    add("median", lambda r, n: [_fl(r, 4, 5)], "reduce", grad=True,
        tag="all")
    add("median", lambda r, n: [_int(r, n, 8)], "reduce", tag="int32",
        axis=1)
    add("nanmedian", lambda r, n: [np.where(_bool(r, n, 8), np.nan, _fl(
        r, n, 8)).astype(np.float32)], "reduce", axis=1)
    add("quantile", lambda r, n: [_fl(r, n, 8), 0.3, 1], "reduce",
        grad=True)
    add("quantile", lambda r, n: [_fl(r, n, 8), [0.25, 0.75], 1],
        "reduce", grad=True, tag="list")
    add("nanquantile", lambda r, n: [np.where(_bool(r, n, 8), np.nan, _fl(
        r, n, 8)).astype(np.float32), 0.4, 1], "reduce")
    add("numel", lambda r, n: [_fl(r, n, 8)], "exact")
    add("corrcoef", lambda r, n: [_fl(r, 4, 64)], "reduce", grad=True)
    add("cov", lambda r, n: [_fl(r, 4, 64)], "reduce", grad=True)
    add("cov", lambda r, n: [_fl(r, 64, 4)], "reduce", tag="cols",
        rowvar=False, ddof=False)
    # linalg
    for p in ("fro", 1, "inf", 3):
        add("norm", lambda r, n: [_fl(r, n, 8)], "reduce", grad=True,
            tag=str(p), p=p)
    for p, ax in ((2, 1), ("-inf", 1), (0, 1), ("fro", [0, 1])):
        add("norm", lambda r, n: [_fl(r, n, 8)], "reduce", grad=p != 0,
            tag=f"{p}:{ax}", p=p, axis=ax, keepdim=True)
    for p in (2, float("inf"), 0, 1.5):
        add("dist", lambda r, n: [_fl(r, n, 8), _fl(r, n, 8)], "reduce",
            grad=p != 0, tag=str(p), p=p)
    add("cholesky", lambda r, n: [_spd(r, b, k)], "linalg", grad=True)
    add("cholesky", lambda r, n: [_spd(r, b, k)], "linalg", tag="upper",
        upper=True)
    add("cholesky_solve", lambda r, n: [_fl(r, b, k, 2), np.linalg.cholesky(
        _spd(r, b, k)).astype(np.float32)], "linalg", grad=True)
    add("inverse", lambda r, n: [_well(r, b, k)], "linalg", grad=True)
    add("inv", lambda r, n: [_well(r, b, k)], "linalg")
    add("pinv", lambda r, n: [_fl(r, b, k, k // 2)], "linalg")
    add("det", lambda r, n: [_well(r, b, k)], "linalg", grad=True)
    add("slogdet", lambda r, n: [_well(r, b, k)], "linalg", grad=True)
    add("svd", lambda r, n: [_fl(r, b, k, k // 2 + 1)], "linalg",
        post=_svd_post)
    add("qr", lambda r, n: [_fl(r, b, k, k // 2 + 1)], "linalg",
        post=_qr_post)
    add("eig", lambda r, n: [_sym(r, b, k)], "linalg", post=_sorted_real)
    add("eigh", lambda r, n: [_sym(r, b, k)], "linalg", post=_eigh_post)
    add("eigvals", lambda r, n: [_sym(r, b, k)], "linalg",
        post=_sorted_real)
    add("eigvalsh", lambda r, n: [_sym(r, b, k)], "linalg", grad=True)
    add("matrix_power", lambda r, n: [_well(r, b, k), 3], "linalg",
        grad=True)
    add("matrix_rank", lambda r, n: [_fl(r, b, k, 2) @ _fl(r, b, 2, k)],
        "exact")
    add("solve", lambda r, n: [_well(r, b, k), _fl(r, b, k, 2)], "linalg",
        grad=True)
    add("triangular_solve", lambda r, n: [np.triu(_well(r, b, k)),
                                          _fl(r, b, k, 2)], "linalg",
        grad=True)
    add("triangular_solve", lambda r, n: [np.tril(_well(r, b, k)),
                                          _fl(r, b, k, 2)], "linalg",
        tag="lower_t_unit", upper=False, transpose=True, unitriangular=True)
    add("lstsq", lambda r, n: [_fl(r, 3 * k, k), _fl(r, 3 * k, 2)],
        "linalg")
    add("lu", lambda r, n: [_well(r, b, k)], "linalg", post=_lu_post)
    add("lu_unpack", lambda r, n: list(_np_lu(_well(r, 1, k)[0])),
        "linalg")
    add("multi_dot", lambda r, n: [[_fl(r, n, 8), _fl(r, 8, 4),
                                    _fl(r, 4, 3)]], "reduce", grad=True)
    add("matrix_transpose", lambda r, n: [_fl(r, 2, n, 8)], "exact",
        grad=True)
    add("cond", lambda r, n: [_well(r, b, k)], "linalg")
    add("householder_product", lambda r, n: _reflectors(r, k, k // 2 + 1),
        "linalg")
    add("pca_lowrank", lambda r, n: [_fl(r, 64, 8)], "linalg",
        post=_pca_post)
    # the rest
    add("add_n", lambda r, n: [[_fl(r, n, 8), _fl(r, n, 8), _fl(r, n, 8)]],
        grad=True)
    add("mv", lambda r, n: [_fl(r, n, 8), _fl(r, 8)], "reduce", grad=True)
    add("sgn", lambda r, n: [_fl(r, n, 8)], "exact", grad=True)
    add("sgn", lambda r, n: [_cplx(r, n, 8)], tag="complex")
    add("logcumsumexp", lambda r, n: [_fl(r, n, 8)], "reduce", grad=True,
        axis=1)
    add("logcumsumexp", lambda r, n: [_fl(r, 4, 5)], "reduce", grad=True,
        tag="flat")
    add("reverse", lambda r, n: [_fl(r, n, 8), [1]], "exact", grad=True)
    add("shape", lambda r, n: [_fl(r, n, 8)], "exact")
    add("rank", lambda r, n: [_fl(r, n, 8)], "exact")
    add("tolist", lambda r, n: [_int(r, 3, 4)], "exact")
    add("reshape_", lambda r, n: [_fl(r, n, 8), [8, -1]], "exact")
    add("squeeze_", lambda r, n: [_fl(r, n, 1, 8), 1], "exact")
    add("unsqueeze_", lambda r, n: [_fl(r, n, 8), 0], "exact")
    add("scatter_", lambda r, n: [_fl(r, n, 8), r.permutation(n)[:3],
                                  _fl(r, 3, 8)], "exact")
    add("tanh_", lambda r, n: [_fl(r, n, 8)])
    add("einsum", lambda r, n: ["ij,jk->ik", _fl(r, n, 8), _fl(r, 8, 4)],
        "reduce", grad=True)
    add("einsum", lambda r, n: ["bij,bjk->bik", _fl(r, 2, n, 8),
                                _fl(r, 2, 8, 4)], "reduce", tag="batched")
    # random: shapes and dtypes only
    add("rand", lambda r, n: [[n, 8]], "random")
    add("randn", lambda r, n: [[n, 8]], "random")
    add("standard_normal", lambda r, n: [[n, 8]], "random")
    add("normal", lambda r, n: [0.0, 1.0, [n, 8]], "random")
    add("normal", lambda r, n: [_fl(r, n, 8), _pos(r, n, 8)], "random",
        tag="tensors")
    add("uniform", lambda r, n: [[n, 8]], "random", min=-2.0, max=2.0)
    add("randint", lambda r, n: [0, 10, [n, 8]], "random")
    add("randint_like", lambda r, n: [_int(r, n, 8), 0, 5], "random")
    add("randperm", lambda r, n: [64], "random")
    add("bernoulli", lambda r, n: [r.random((n, 8)).astype(np.float32)],
        "random")
    add("poisson", lambda r, n: [_pos(r, n, 8)], "random")
    add("multinomial", lambda r, n: [r.random((4, 10)).astype(
        np.float32), 3], "random")
    add("rand_like", lambda r, n: [_fl(r, n, 8)], "random")
    add("randn_like", lambda r, n: [_fl(r, n, 8)], "random")
    add("normal_like", lambda r, n: [_fl(r, n, 8)], "random")
    add("create_parameter", lambda r, n: [[n, 8], "float32"], "random")
    # nn.functional activations
    for name, kw in _ACTIVATIONS:
        add("F." + name, lambda r, n: [_fl(r, n, 8)], grad=True,
            tag=",".join(f"{a}={v}" for a, v in kw.items()), **kw)
    add("F.prelu", lambda r, n: [_fl(r, n, 4, 2), _pos(r, 4)], grad=True)
    add("F.prelu", lambda r, n: [_fl(r, n, 8), _pos(r, 1)], grad=True,
        tag="one")
    add("F.maxout", lambda r, n: [_fl(r, n, 8, 2), 2], grad=True, axis=1)
    add("F.gumbel_softmax", lambda r, n: [_fl(r, n, 8)], "random")
    for name in ("relu_", "elu_", "tanh_", "softmax_"):
        add("F." + name, lambda r, n: [_fl(r, n, 8)])
    return L


def op_module(name):
    """The port module a table row belongs to ("activation" for
    ``nn.functional``)."""
    if name.startswith("F."):
        return "activation"
    from paddle_tpu_torch import tensor_ops
    for mod in ("creation", "math", "manipulation", "logic", "search",
                "stat", "linalg", "random", "extras"):
        if name in getattr(tensor_ops, mod).__all__:
            return mod
    return "einsum"


def op_args(case, n, seed=0):
    """A row's positional numpy inputs (seeded by its id)."""
    rng = np.random.default_rng([seed, *case.id.encode()])
    return case.make(rng, n)


def grad_slot(args):
    """Where the gradient goes: the first float array, at the top level
    (i) or inside a list argument ((i, j)); None when there is none."""
    for i, a in enumerate(args):
        if isinstance(a, np.ndarray) and a.dtype.kind == "f":
            return (i,)
        if isinstance(a, list):
            for j, x in enumerate(a):
                if isinstance(x, np.ndarray) and x.dtype.kind == "f":
                    return (i, j)
    return None


def convert_args(args, convert, slot=None, mark=None):
    """``args`` with every numpy array passed through ``convert`` (the one
    at ``slot`` through ``mark``, which returns the leaf to differentiate
    by); strings, python scalars and lists of ints stay as they are."""
    out = []
    for i, a in enumerate(args):
        if isinstance(a, list) and any(isinstance(x, np.ndarray)
                                       for x in a):
            out.append([mark(x) if slot == (i, j) else convert(x)
                        for j, x in enumerate(a)])
        elif isinstance(a, np.ndarray):
            out.append(mark(a) if slot == (i,) else convert(a))
        else:
            out.append(a)
    return out


def _has_array(x):
    return hasattr(x, "shape") or (isinstance(x, (tuple, list))
                                   and any(_has_array(y) for y in x))


def flat_outputs(out):
    """An op's result as a flat list: tuples and lists of tensors
    unrolled, a list of python numbers kept whole, None dropped."""
    if out is None:
        return []
    if isinstance(out, (tuple, list)) and _has_array(out):
        return [o for x in out for o in flat_outputs(x)]
    return [out]


def weights_for(shape):
    """The seeded cotangent of a result of ``shape``."""
    return np.random.default_rng(1).standard_normal(shape).astype(
        np.float32)


def _map64(name):
    return {"int64": "int32", "float64": "float32",
            "complex128": "complex64"}.get(name, name)


def port_op(pt, case, args, device, grad=False):
    """Run a table row on the port on ``device``: (outputs as numpy
    arrays, their dtype names, the gradient as numpy or None, the terms
    each gradient element sums)."""
    from paddle_tpu_torch.nn import functional as F
    fn = (getattr(F, case.name[2:]) if case.name.startswith("F.")
          else getattr(pt, case.name))
    dev = torch.device(device)
    slot = grad_slot(args) if grad else None
    leaf = []

    def convert(a):
        return pt.to_tensor(a, place=dev)

    def mark(a):
        t = pt.to_tensor(a, place=dev, stop_gradient=False)
        leaf.append(t)
        return t

    with using_device(str(dev)):
        out = fn(*convert_args(args, convert, slot, mark), **case.kw)
    outs = flat_outputs(out)
    g, terms = None, 1
    if slot is not None:
        y = next(o for o in outs if isinstance(o, torch.Tensor)
                 and o.is_floating_point())
        w = torch.from_numpy(weights_for(tuple(y.shape))).to(dev, y.dtype)
        torch.sum(y * w).backward()
        g = leaf[0].grad.detach().float().cpu().numpy()
        terms = max(1, y.numel() // max(1, leaf[0].numel()))
    arrays, dtypes = [], []
    for o in outs:
        if isinstance(o, torch.Tensor):
            dtypes.append(str(o.dtype).replace("torch.", ""))
            o = o.detach()
            o = o.float() if o.dtype == torch.bfloat16 else o
            arrays.append(o.cpu().numpy())
        else:
            dtypes.append(type(o).__name__)
            arrays.append(np.asarray(o))
    return arrays, dtypes, g, terms


@contextlib.contextmanager
def using_device(device):
    """The framework's default device set to ``device`` inside."""
    from paddle_tpu_torch.framework import device as dmod
    before = dmod._current_device
    dmod._current_device = device
    try:
        yield
    finally:
        dmod._current_device = before


def compare_op(case, args, got, want):
    """None when ``got`` (outputs as numpy) matches ``want`` under the
    row's kind, else what differs. Integer and bool arrays bit for bit."""
    if case.post is not None:
        got, want = case.post(got, args), case.post(want, args)
    if len(got) != len(want):
        return f"{len(got)} outputs vs {len(want)}"
    tol = OP_TOL[case.kind]
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = np.asarray(g), np.asarray(w)
        if g.shape != w.shape:
            return f"output {i}: shape {g.shape} vs {w.shape}"
        if tol is None:
            continue
        if g.dtype.kind in "biu" or w.dtype.kind in "biu" or tol == 0.0:
            if not np.array_equal(g, w, equal_nan=g.dtype.kind in "fc"):
                bad = int(np.sum(g != w))
                return f"output {i}: {bad} elements differ"
            continue
        g64 = g.astype(np.complex128 if g.dtype.kind == "c" else np.float64)
        w64 = w.astype(g64.dtype)
        if case.kind == "linalg":       # normwise: |g - w| <= tol max|w|
            scale = max(float(np.abs(w64).max(initial=0.0)), 1e-30)
            err = float(np.abs(g64 - w64).max(initial=0.0)) / scale
            if not err <= tol:
                return f"output {i}: {err:.3g} of its largest beyond {tol}"
        elif not np.allclose(g64, w64, rtol=tol, atol=tol, equal_nan=True):
            err = np.nanmax(np.abs(g64 - w64) / (np.abs(w64) + 1))
            return f"output {i}: {err:.3g} beyond {tol}"
    return None


def compare_grad(case, got, want, terms=1):
    """None when two gradients agree within ``GRAD_TOL`` (or the row's
    tolerance, if larger) of the larger one's largest element, times
    ``sqrt(terms)``: the terms each gradient element sums."""
    if got is None or want is None:
        return None if got is None and want is None else "one gradient"
    if got.shape != want.shape:
        return f"gradient shape {got.shape} vs {want.shape}"
    tol = max(GRAD_TOL, OP_TOL[case.kind] or 0.0) * float(np.sqrt(terms))
    scale = max(np.abs(want).max(initial=0.0), 1.0)
    err = np.abs(got.astype(np.float64) - want).max(initial=0.0) / scale
    return None if err <= tol else f"gradient {err:.3g} beyond {tol}"



# ---- the nn table (phase 28a; tests/test_torch_nn_*.py) -------------------
# One row for every ``nn.functional`` function and ``nn`` layer of the layer
# library's slice: "F.<name>" rows through ``port_op`` / ``jax_op`` as the op
# table's, "nn.<Name>" rows a layer built from seed 0 (``Op.ctor`` its
# positional arguments, a callable taking the ``nn`` module for a cell) and
# called on the inputs, its gradient taken for the input and every
# parameter. Tolerance classes are ``OP_TOL``'s; "linalg" (1e-4 of the
# largest element) for the long sums of the convolutions and recurrences.
NN_ROWS_CPU = OP_ROWS_CPU
NN_ROWS_CARD = 1024


def _sizes(n):
    """Batch, channels, 2-D side, 3-D side, 1-D length, classes, rows of 8,
    rows of ``K`` classes, hidden width, time steps."""
    if n < 64:
        return dict(B=2, C=4, S=6, D=4, L=8, K=5, R=n, N=n, H=6, T=5)
    return dict(B=16, C=32, S=64, D=16, L=1024, K=1000, R=n * 128, N=n,
                H=256, T=64)


def _labels(r, shape, k):
    return r.integers(0, k, shape).astype(np.int64)


def _prob(r, *s):
    return r.uniform(0.05, 0.95, s).astype(np.float32)


def _softmax_np(a, axis=-1):
    e = np.exp(a - a.max(axis=axis, keepdims=True))
    return (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)


def _unpool_inputs(r, lead, spatial, k):
    """Pooled values and a valid, distinct argmax index for each, as a
    ``k``-window max pool without padding returns them."""
    out_sp = [s // k for s in spatial]
    idx = np.zeros(tuple(lead) + tuple(out_sp), np.int64)
    for pos in np.ndindex(*out_sp):
        flat = 0
        for d, o in enumerate(pos):
            flat = flat * spatial[d] + o * k + int(r.integers(0, k))
        idx[(...,) + pos] = flat
    return [_fl(r, *lead, *out_sp), idx.astype(np.int32)]


def _beam_ids(r, T, B, W, V):
    ids = r.integers(0, V, (T, B, W)).astype(np.int64)
    parents = r.integers(0, W, (T, B, W)).astype(np.int64)
    return [ids, parents]


def nn_cases(n):
    """The nn table at size ``n`` (small below 64, the card's above)."""
    z = _sizes(n)
    B, C, S, D, L, K, R, N, H, T = (z[k] for k in "BCSDLKRNHT")
    out = []

    def add(name, make, kind="float", grad=False, post=None, tag="",
            ctor=(), **kw):
        out.append(Op(name, make, kw, kind, grad, post, tag, ctor))

    # -- common ---------------------------------------------------------------
    add("F.one_hot", lambda r, n: [_int(r, N, lo=-1, hi=K + 1)], "exact",
        num_classes=K)
    add("F.embedding", lambda r, n: [_int(r, B, L, lo=0, hi=K),
                                     _fl(r, K, C)], "exact", grad=True,
        padding_idx=1)
    for mode in ("constant", "reflect", "replicate", "circular"):
        add("F.pad", lambda r, n: [_fl(r, B, C, S, S), [1, 2, 3, 0]],
            "exact", grad=True, tag=mode, mode=mode, value=0.5)
    add("F.pad", lambda r, n: [_fl(r, B, S, S, C), [2, 1, 0, 3]], "exact",
        grad=True, tag="reflect NHWC", mode="reflect", data_format="NHWC")
    add("F.pad", lambda r, n: [_fl(r, B, C, L), [0, 0, 1, 1, 2, 7]],
        "exact", grad=True, tag="reflect full", mode="reflect")
    add("F.pad", lambda r, n: [_fl(r, B, C, D, D, D), [1, 0, 2, 1, 0, 2]],
        "exact", grad=True, tag="circular 3d", mode="circular",
        data_format="NCDHW")
    add("F.zeropad2d", lambda r, n: [_fl(r, B, C, S, S), [1, 0, 2, 1]],
        "exact", grad=True)
    for mode in ("nearest", "bilinear", "bicubic", "area"):
        for tag, kw in (("up", dict(scale_factor=2)),
                        ("down", dict(size=[S // 2 + 1, S // 3]))):
            add("F.interpolate", lambda r, n: [_fl(r, B, C, S, S)],
                "reduce", grad=True, tag=f"{mode} {tag}", mode=mode, **kw)
    add("F.interpolate", lambda r, n: [_fl(r, B, C, S, S)], "reduce",
        grad=True, tag="bilinear corners", mode="bilinear",
        align_corners=True, size=[2 * S - 1, S + 3])
    add("F.interpolate", lambda r, n: [_fl(r, B, L, C)], "reduce",
        grad=True, tag="linear NLC down", mode="linear", size=[L // 3 + 1],
        data_format="NLC")
    add("F.interpolate", lambda r, n: [_fl(r, B, C, D, D, D)], "reduce",
        grad=True, tag="trilinear", mode="trilinear", size=[D + 3, D - 1,
                                                             2 * D])
    add("F.upsample", lambda r, n: [_fl(r, B, S, S, C)], "reduce",
        grad=True, tag="nearest NHWC", scale_factor=2, data_format="NHWC")
    add("F.label_smooth", lambda r, n: [_prob(r, N, K)], grad=True,
        epsilon=0.2)
    add("F.dropout2d", lambda r, n: [_fl(r, B, C, S, S)], "random", p=0.3)
    add("F.dropout3d", lambda r, n: [_fl(r, B, C, D, D, D)], "random",
        p=0.3)
    add("F.alpha_dropout", lambda r, n: [_fl(r, R, 8)], "random", p=0.2)
    add("F.bilinear", lambda r, n: [_fl(r, R, C), _fl(r, R, C + 1),
                                    _fl(r, 3, C, C + 1), _fl(r, 3)],
        "linalg", grad=True)
    add("F.cosine_similarity", lambda r, n: [_fl(r, R, 8), _fl(r, R, 8)],
        "reduce", grad=True, axis=1)
    add("F.pairwise_distance", lambda r, n: [_fl(r, R, 8), _fl(r, R, 8)],
        "reduce", grad=True, p=3.0)
    add("F.unfold", lambda r, n: [_fl(r, B, C, S, S)], "exact", grad=True,
        kernel_sizes=[3, 2], strides=[1, 2], paddings=[1, 0, 2, 1],
        dilations=[2, 1])
    add("F.fold", lambda r, n: [_fl(r, B, C * 6, (S // 2) * (S - 1))],
        "reduce", grad=True, output_sizes=[S, S], kernel_sizes=[3, 2],
        strides=[2, 1], paddings=[1, 0])
    # -- norm -----------------------------------------------------------------
    add("F.group_norm", lambda r, n: [_fl(r, B, C, S, S), 2, 1e-5,
                                      _fl(r, C), _fl(r, C)],
        "reduce", grad=True)
    add("F.group_norm", lambda r, n: [_fl(r, B, S, S, C), 2, 1e-5,
                                      _fl(r, C), _fl(r, C), "NHWC"],
        "reduce", grad=True, tag="NHWC")
    add("F.instance_norm", lambda r, n: [_fl(r, B, C, S, S), None, None,
                                         _fl(r, C), _fl(r, C)],
        "reduce", grad=True)
    for size in (3, 4):
        add("F.local_response_norm", lambda r, n: [_fl(r, B, C + 3, S, S)],
            "reduce", grad=True, tag=f"size {size}", size=size, alpha=0.1)
    add("F.normalize", lambda r, n: [_fl(r, R, 8)], "reduce", grad=True,
        p=3, axis=1)
    add("F.rms_norm", lambda r, n: [_fl(r, R, 8), _fl(r, 8)], "reduce",
        grad=True)
    # -- conv -----------------------------------------------------------------
    add("F.conv1d", lambda r, n: [_fl(r, B, C, L), _fl(r, 6, C // 2, 3),
                                  _fl(r, 6)], "linalg", grad=True,
        padding=[1, 2], stride=2, groups=2)
    add("F.conv1d", lambda r, n: [_fl(r, B, L, C), _fl(r, 6, C, 3)],
        "linalg", grad=True, tag="NLC SAME", padding="SAME",
        data_format="NLC")
    add("F.conv3d", lambda r, n: [_fl(r, B, C, D, D, D),
                                  _fl(r, 6, C, 3, 3, 3), _fl(r, 6)],
        "linalg", grad=True, padding=1, stride=[1, 2, 1])
    add("F.conv1d_transpose", lambda r, n: [_fl(r, B, C, L),
                                            _fl(r, C, 3, 4), _fl(r, 6)],
        "linalg", grad=True, stride=2, padding=1, output_padding=1,
        groups=2)
    add("F.conv2d_transpose", lambda r, n: [_fl(r, B, C, S, S),
                                            _fl(r, C, 5, 4, 4), _fl(r, 5)],
        "linalg", grad=True, stride=2, padding=1)
    add("F.conv2d_transpose", lambda r, n: [_fl(r, B, C, S, S),
                                            _fl(r, C, 5, 3, 3)],
        "linalg", grad=True, tag="asymmetric", stride=2,
        padding=[2, 0, 1, 1], output_padding=[1, 3], dilation=[1, 2])
    add("F.conv2d_transpose", lambda r, n: [_fl(r, B, S, S, C),
                                            _fl(r, C, 5, 3, 3)],
        "linalg", grad=True, tag="NHWC", stride=1, padding=1,
        data_format="NHWC")
    add("F.conv3d_transpose", lambda r, n: [_fl(r, B, C, D, D, D),
                                            _fl(r, C, 3, 2, 2, 2)],
        "linalg", grad=True, stride=2)
    # -- losses ---------------------------------------------------------------
    add("F.cross_entropy", lambda r, n: [_fl(r, N, K), _prob(r, N, K)],
        "reduce", grad=True, tag="soft smoothing", soft_label=True,
        label_smoothing=0.1)
    add("F.cross_entropy", lambda r, n: [_fl(r, N, K),
                                         _labels(r, (N,), K),
                                         _pos(r, K)],
        "reduce", grad=True, tag="weight smoothing ignore",
        label_smoothing=0.2, ignore_index=1)
    add("F.cross_entropy", lambda r, n: [_fl(r, K, N),
                                         _labels(r, (1, N), K)],
        "reduce", grad=True, tag="axis 0", axis=0, reduction="sum")
    add("F.cross_entropy", lambda r, n: [_softmax_np(_fl(r, N, K)),
                                         _labels(r, (N, 1), K)],
        "reduce", grad=True, tag="no softmax", use_softmax=False,
        reduction="none")
    add("F.softmax_with_cross_entropy",
        lambda r, n: [_fl(r, N, K), _labels(r, (N, 1), K)], "reduce",
        grad=True, return_softmax=True)
    add("F.nll_loss", lambda r, n: [np.log(_softmax_np(_fl(r, N, K, 3), 1)),
                                    _labels(r, (N, 3), K), _pos(r, K)],
        "reduce", grad=True, ignore_index=2)
    add("F.binary_cross_entropy", lambda r, n: [_prob(r, R, 8),
                                                _prob(r, R, 8),
                                                _pos(r, R, 8)],
        "reduce", grad=True)
    add("F.binary_cross_entropy_with_logits",
        lambda r, n: [_fl(r, R, 8), _prob(r, R, 8), None, "sum",
                      _pos(r, 8)], "reduce", grad=True)
    add("F.smooth_l1_loss", lambda r, n: [_fl(r, R, 8), _fl(r, R, 8)],
        "reduce", grad=True, delta=0.7)
    add("F.kl_div", lambda r, n: [_fl(r, R, 8), _fl(r, R, 8)], "reduce",
        grad=True, reduction="batchmean")
    add("F.margin_ranking_loss", lambda r, n: [
        _fl(r, R), _fl(r, R), np.sign(_nz(r, R))], "reduce", grad=True,
        margin=0.3)
    add("F.hinge_embedding_loss", lambda r, n: [
        _fl(r, R, 8), np.sign(_nz(r, R, 8))], "reduce", grad=True)
    add("F.cosine_embedding_loss", lambda r, n: [
        _fl(r, R, 8), _fl(r, R, 8), np.sign(_nz(r, R))], "reduce",
        grad=True, margin=0.2)
    add("F.triplet_margin_loss", lambda r, n: [
        _fl(r, R, 8), _fl(r, R, 8), _fl(r, R, 8)], "reduce", grad=True,
        swap=True, p=1.5)
    add("F.triplet_margin_with_distance_loss", lambda r, n: [
        _fl(r, R, 8), _fl(r, R, 8), _fl(r, R, 8)], "reduce", grad=True,
        swap=True, reduction="sum")
    add("F.ctc_loss", lambda r, n: [
        _fl(r, T + 3, B, 6), _int(r, B, T // 2, lo=1, hi=6),
        np.array([T + 3] + [T + 1] * (B - 1), np.int32),
        np.array([T // 2] + [T // 2 - 1] * (B - 1), np.int32)],
        "reduce", grad=True)
    add("F.hsigmoid_loss", lambda r, n: [
        _fl(r, R, 8), _labels(r, (R,), 6), 6, _fl(r, 5, 8), _fl(r, 5)],
        "reduce", grad=True)
    add("F.margin_cross_entropy", lambda r, n: [
        _unit(r, N, K), _labels(r, (N,), K)], "reduce", grad=True,
        return_softmax=True, scale=8.0)
    add("F.dice_loss", lambda r, n: [
        _softmax_np(_fl(r, B, S, S, 3)), _labels(r, (B, S, S, 1), 3)],
        "reduce", grad=True)
    add("F.npair_loss", lambda r, n: [
        _fl(r, N, 8), _fl(r, N, 8), _labels(r, (N,), 3).astype(np.float32)],
        "reduce", grad=True)
    add("F.sigmoid_focal_loss", lambda r, n: [
        _fl(r, R, 8), (r.random((R, 8)) < 0.3).astype(np.float32),
        np.array([3.0], np.float32)], "reduce", grad=True)
    add("F.log_loss", lambda r, n: [_prob(r, R, 1), _prob(r, R, 1)],
        grad=True)
    add("F.square_error_cost", lambda r, n: [_fl(r, R, 8), _fl(r, R, 8)],
        grad=True)
    add("F.soft_margin_loss", lambda r, n: [_fl(r, R, 8),
                                            np.sign(_nz(r, R, 8))],
        "reduce", grad=True)
    add("F.multi_label_soft_margin_loss", lambda r, n: [
        _fl(r, R, 8), (r.random((R, 8)) < 0.5).astype(np.float32),
        _pos(r, 8)], "reduce", grad=True)
    add("F.edit_distance", lambda r, n: [
        _int(r, B, 9, lo=0, hi=4), _int(r, B, 7, lo=0, hi=4)], "reduce",
        ignored_tokens=[3],
        input_length=None, label_length=None)
    # -- pooling: masks and unpooling ----------------------------------------
    add("F.max_pool1d", lambda r, n: [_ties(r, B, C, L)], "exact",
        grad=True, kernel_size=3, stride=2, padding=1, return_mask=True)
    add("F.max_pool2d", lambda r, n: [_ties(r, B, C, S, S)], "exact",
        grad=True, kernel_size=2, return_mask=True)
    add("F.max_pool2d", lambda r, n: [_ties(r, B, S, S, C)], "exact",
        grad=True, tag="NHWC", kernel_size=3, stride=2, padding=1,
        return_mask=True, data_format="NHWC")
    add("F.max_pool3d", lambda r, n: [_ties(r, B, C, D, D, D)], "exact",
        grad=True, kernel_size=2, return_mask=True)
    add("F.adaptive_max_pool1d", lambda r, n: [_ties(r, B, C, L)], "exact",
        grad=True, output_size=3, return_mask=True)
    add("F.adaptive_max_pool2d", lambda r, n: [_ties(r, B, C, S, S)],
        "exact", grad=True, output_size=[3, 2], return_mask=True)
    add("F.adaptive_max_pool2d", lambda r, n: [_ties(r, B, C, S, S)],
        "exact", grad=True, tag="even", output_size=S // 2,
        return_mask=True)
    add("F.adaptive_max_pool3d", lambda r, n: [_ties(r, B, C, D, D, D)],
        "exact", grad=True, output_size=[2, 3, 2], return_mask=True)
    add("F.max_unpool1d", lambda r, n: _unpool_inputs(r, (B, C), (L,), 2),
        "exact", grad=True, kernel_size=2)
    add("F.max_unpool2d", lambda r, n: _unpool_inputs(r, (B, C), (S, S), 2),
        "exact", grad=True, kernel_size=2)
    add("F.max_unpool3d", lambda r, n: _unpool_inputs(r, (B, C), (D, D, D),
                                                      2),
        "exact", grad=True, kernel_size=2, output_size=[D + 1, D, D])
    # -- vision and extension -------------------------------------------------
    add("F.pixel_shuffle", lambda r, n: [_fl(r, B, 4 * C, S, S)], "exact",
        grad=True, upscale_factor=2)
    add("F.pixel_shuffle", lambda r, n: [_fl(r, B, S, S, 9)], "exact",
        grad=True, tag="NHWC", upscale_factor=3, data_format="NHWC")
    add("F.pixel_unshuffle", lambda r, n: [_fl(r, B, C, S, S)], "exact",
        grad=True, downscale_factor=2)
    add("F.pixel_unshuffle", lambda r, n: [_fl(r, B, S, S, C)], "exact",
        grad=True, tag="NHWC", downscale_factor=2, data_format="NHWC")
    add("F.channel_shuffle", lambda r, n: [_fl(r, B, C, S, S)], "exact",
        grad=True, groups=2)
    add("F.channel_shuffle", lambda r, n: [_fl(r, B, S, S, C)], "exact",
        grad=True, tag="NHWC", groups=4, data_format="NHWC")
    for ac in (True, False):
        add("F.affine_grid", lambda r, n: [_fl(r, B, 2, 3), [B, C, S, S + 1]],
            "reduce", grad=True, tag=f"corners {ac}", align_corners=ac)
    for mode, pm, ac in (("bilinear", "zeros", True),
                         ("bilinear", "border", False),
                         ("nearest", "zeros", True)):
        add("F.grid_sample", lambda r, n: [
            _fl(r, B, C, S, S), 1.2 * _unit(r, B, S + 1, S - 1, 2)],
            "reduce", grad=True, tag=f"{mode} {pm} {ac}", mode=mode,
            padding_mode=pm, align_corners=ac)
    add("F.diag_embed", lambda r, n: [_fl(r, B, C, 5)], "exact", grad=True,
        offset=-1, dim1=0, dim2=2)
    add("F.sequence_mask", lambda r, n: [_int(r, B, C, lo=0, hi=L)],
        "exact")
    add("F.sequence_mask", lambda r, n: [_int(r, N, lo=0, hi=L)], "exact",
        tag="maxlen", maxlen=L + 2, dtype="float32")
    add("F.gather_tree", lambda r, n: _beam_ids(r, T, B, 4, K), "exact")
    add("F.temporal_shift", lambda r, n: [_fl(r, 2 * 3, C, S, S)], "exact",
        grad=True, seg_num=3, shift_ratio=0.25)
    add("F.temporal_shift", lambda r, n: [_fl(r, 2 * 3, S, S, C)], "exact",
        grad=True, tag="NHWC", seg_num=3, data_format="NHWC")

    # -- layers ---------------------------------------------------------------
    acts = [("CELU", (0.7,)), ("ELU", ()), ("GELU", (True,)), ("GLU", ()),
            ("Hardshrink", (0.3,)), ("Hardsigmoid", ()), ("Hardswish", ()),
            ("Hardtanh", (-0.4, 0.6)), ("LeakyReLU", (0.2,)),
            ("LogSigmoid", ()), ("LogSoftmax", (0,)), ("Maxout", (2,)),
            ("Mish", ()), ("PReLU", (C, 0.3)), ("ReLU", ()), ("ReLU6", ()),
            ("SELU", ()), ("Sigmoid", ()), ("Silu", ()), ("Softmax", (1,)),
            ("Softplus", (2.0, 1.0)), ("Softshrink", (0.4,)),
            ("Softsign", ()), ("Swish", ()), ("Tanh", ()),
            ("Tanhshrink", ()), ("ThresholdedReLU", (0.3,))]
    for name, args in acts:
        add("nn." + name, lambda r, n: [3 * _fl(r, B, C, S, S)], grad=True,
            ctor=args)
    add("nn.RReLU", lambda r, n: [_fl(r, B, C, S, S)], "random")
    add("nn.Embedding", lambda r, n: [_int(r, B, L, lo=0, hi=K)], "exact",
        grad=True, ctor=(K, C), padding_idx=-2)
    for name, pad, mode in (("Pad1D", [2, 1], "reflect"),
                            ("Pad2D", [1, 0, 2, 2], "replicate"),
                            ("Pad3D", [1, 1, 0, 2, 1, 0], "circular")):
        shape = {"Pad1D": (B, C, L), "Pad2D": (B, C, S, S),
                 "Pad3D": (B, C, D, D, D)}[name]
        add("nn." + name, lambda r, n, s=shape: [_fl(r, *s)], "exact",
            grad=True, ctor=(pad, mode))
    add("nn.ZeroPad2D", lambda r, n: [_fl(r, B, C, S, S)], "exact",
        grad=True, ctor=([1, 2, 0, 1],))
    add("nn.Upsample", lambda r, n: [_fl(r, B, C, S, S)], "reduce",
        grad=True, ctor=(None, 0.5, "bicubic"))
    add("nn.UpsamplingBilinear2D", lambda r, n: [_fl(r, B, C, S, S)],
        "reduce", grad=True, ctor=([S + 3, 2 * S],))
    add("nn.UpsamplingNearest2D", lambda r, n: [_fl(r, B, C, S, S)],
        "exact", grad=True, ctor=(None, 3))
    add("nn.Bilinear", lambda r, n: [_fl(r, R, C), _fl(r, R, 5)], "reduce",
        grad=True, ctor=(C, 5, 3))
    add("nn.CosineSimilarity", lambda r, n: [_fl(r, R, 8), _fl(r, R, 8)],
        "reduce", grad=True, ctor=(1,))
    add("nn.PairwiseDistance", lambda r, n: [_fl(r, R, 8), _fl(r, R, 8)],
        "reduce", grad=True)
    add("nn.Unfold", lambda r, n: [_fl(r, B, C, S, S)], "exact", grad=True,
        ctor=(3, 2, 1))
    add("nn.Fold", lambda r, n: [_fl(r, B, C * 4, (S - 1) ** 2)], "reduce",
        grad=True, ctor=([S, S], 2))
    add("nn.PixelShuffle", lambda r, n: [_fl(r, B, 4 * C, S, S)], "exact",
        grad=True, ctor=(2,))
    add("nn.PixelUnshuffle", lambda r, n: [_fl(r, B, C, S, S)], "exact",
        grad=True, ctor=(2,))
    add("nn.ChannelShuffle", lambda r, n: [_fl(r, B, C, S, S)], "exact",
        grad=True, ctor=(2,))
    add("nn.Softmax2D", lambda r, n: [_fl(r, B, C, S, S)], grad=True)
    add("nn.Dropout2D", lambda r, n: [_fl(r, B, C, S, S)], "random")
    add("nn.Dropout3D", lambda r, n: [_fl(r, B, C, D, D, D)], "random")
    add("nn.AlphaDropout", lambda r, n: [_fl(r, R, 8)], "random")
    add("nn.GroupNorm", lambda r, n: [_fl(r, B, C, S, S)], "reduce",
        grad=True, ctor=(2, C))
    add("nn.InstanceNorm1D", lambda r, n: [_fl(r, B, C, L)], "reduce",
        grad=True, ctor=(C,))
    add("nn.InstanceNorm2D", lambda r, n: [_fl(r, B, C, S, S)], "reduce",
        grad=True, ctor=(C,))
    add("nn.InstanceNorm3D", lambda r, n: [_fl(r, B, C, D, D, D)],
        "reduce", grad=True, ctor=(C,))
    add("nn.LocalResponseNorm", lambda r, n: [_fl(r, B, C, S, S)],
        "reduce", grad=True, ctor=(4, 0.2))
    add("nn.Conv1D", lambda r, n: [_fl(r, B, C, L)], "linalg", grad=True,
        ctor=(C, 6, 3), padding=2, padding_mode="reflect", dilation=2)
    for mode in ("zeros", "reflect", "replicate", "circular"):
        add("nn.Conv2D", lambda r, n: [_fl(r, B, C, S, S)], "linalg",
            grad=True, tag=mode, ctor=(C, 6, 3), padding=1,
            padding_mode=mode)
    add("nn.Conv3D", lambda r, n: [_fl(r, B, C, D, D, D)], "linalg",
        grad=True, ctor=(C, 4, 3), stride=2, padding=1)
    add("nn.Conv1DTranspose", lambda r, n: [_fl(r, B, C, L)], "linalg",
        grad=True, ctor=(C, 6, 4), stride=2, padding=1)
    add("nn.Conv2DTranspose", lambda r, n: [_fl(r, B, C, S, S)], "linalg",
        grad=True, ctor=(C, 6, 4, 2, 1))
    add("nn.Conv3DTranspose", lambda r, n: [_fl(r, B, C, D, D, D)],
        "linalg", grad=True, ctor=(C, 2, 3), stride=2, padding=1,
        output_padding=1)
    # losses: (input, label)
    add("nn.NLLLoss", lambda r, n: [np.log(_softmax_np(_fl(r, N, K))),
                                    _labels(r, (N,), K)], "reduce",
        grad=True)
    add("nn.BCELoss", lambda r, n: [_prob(r, R, 8), _prob(r, R, 8)],
        "reduce", grad=True)
    add("nn.BCEWithLogitsLoss", lambda r, n: [_fl(r, R, 8), _prob(r, R, 8)],
        "reduce", grad=True)
    add("nn.SmoothL1Loss", lambda r, n: [_fl(r, R, 8), _fl(r, R, 8)],
        "reduce", grad=True)
    add("nn.KLDivLoss", lambda r, n: [_fl(r, R, 8), _prob(r, R, 8)],
        "reduce", grad=True)
    add("nn.MarginRankingLoss", lambda r, n: [
        _fl(r, R), _fl(r, R), np.sign(_nz(r, R))], "reduce", grad=True,
        ctor=(0.1,))
    add("nn.HingeEmbeddingLoss", lambda r, n: [
        _fl(r, R, 8), np.sign(_nz(r, R, 8))], "reduce", grad=True)
    add("nn.CosineEmbeddingLoss", lambda r, n: [
        _fl(r, R, 8), _fl(r, R, 8), np.sign(_nz(r, R))], "reduce",
        grad=True)
    add("nn.TripletMarginLoss", lambda r, n: [
        _fl(r, R, 8), _fl(r, R, 8), _fl(r, R, 8)], "reduce", grad=True)
    add("nn.TripletMarginWithDistanceLoss", lambda r, n: [
        _fl(r, R, 8), _fl(r, R, 8), _fl(r, R, 8)], "reduce", grad=True)
    add("nn.CTCLoss", lambda r, n: [
        _fl(r, T, B, 5), _int(r, B, T // 2, lo=1, hi=5),
        np.full((B,), T, np.int32), np.full((B,), T // 2, np.int32)],
        "reduce", grad=True, ctor=(0, "sum"))
    add("nn.SoftMarginLoss", lambda r, n: [_fl(r, R, 8),
                                           np.sign(_nz(r, R, 8))],
        "reduce", grad=True)
    add("nn.MultiLabelSoftMarginLoss", lambda r, n: [
        _fl(r, R, 8), (r.random((R, 8)) < 0.5).astype(np.float32)],
        "reduce", grad=True)
    add("nn.HSigmoidLoss", lambda r, n: [_fl(r, R, 8),
                                         _labels(r, (R,), 7)], "reduce",
        grad=True, ctor=(8, 7))
    add("nn.CrossEntropyLoss", lambda r, n: [_fl(r, N, K),
                                             _labels(r, (N,), K)],
        "reduce", grad=True, tag="smoothing", label_smoothing=0.1)
    add("nn.MaxUnPool1D", lambda r, n: _unpool_inputs(r, (B, C), (L,), 2),
        "exact", grad=True, ctor=(2,))
    add("nn.MaxUnPool2D", lambda r, n: _unpool_inputs(r, (B, C), (S, S), 2),
        "exact", grad=True, ctor=(2,))
    add("nn.MaxUnPool3D", lambda r, n: _unpool_inputs(r, (B, C), (D, D, D),
                                                      2),
        "exact", grad=True, ctor=(2,))
    # recurrent layers
    add("nn.SimpleRNNCell", lambda r, n: [_fl(r, B, C), _fl(r, B, H)],
        "linalg", grad=True, ctor=(C, H, "relu"))
    add("nn.LSTMCell", lambda r, n: [_fl(r, B, C), [_fl(r, B, H),
                                                     _fl(r, B, H)]],
        "linalg", grad=True, ctor=(C, H))
    add("nn.GRUCell", lambda r, n: [_fl(r, B, C), _fl(r, B, H)], "linalg",
        grad=True, ctor=(C, H))
    add("nn.RNN", lambda r, n: [_fl(r, T, B, C)], "linalg", grad=True,
        ctor=(lambda nn: nn.GRUCell(C, H), True, True))
    add("nn.BiRNN", lambda r, n: [_fl(r, B, T, C)], "linalg", grad=True,
        ctor=(lambda nn: nn.LSTMCell(C, H), lambda nn: nn.LSTMCell(C, H)))
    add("nn.SimpleRNN", lambda r, n: [_fl(r, B, T, C)], "linalg",
        grad=True, ctor=(C, H, 2))
    add("nn.LSTM", lambda r, n: [_fl(r, T, B, C), [_fl(r, 4, B, H),
                                                   _fl(r, 4, B, H)]],
        "linalg", grad=True, ctor=(C, H, 2, "bidirect", True))
    add("nn.GRU", lambda r, n: [_fl(r, B, T, C), _fl(r, 2, B, H)],
        "linalg", grad=True, ctor=(C, H, 1, "bidirectional"))
    return out


def build_layer(pt, case, device):
    """A "nn." row's layer: built on the CPU from seed 0, then moved to
    ``device`` (so the card's and the CPU's weights are the same)."""
    with using_device("cpu"):
        pt.seed(0)
        ctor = [a(pt.nn) if callable(a) else a for a in case.ctor]
        layer = getattr(pt.nn, case.name[3:])(*ctor, **case.kw)
    return layer.to(torch.device(device))


def port_nn(pt, case, args, device, grad=False, layer=None):
    """A row of the nn table on the port on ``device``: ``port_op``'s
    (outputs, dtypes, gradient, terms), where for a layer row the
    gradient is a list of (array, terms), the input's first and then each
    parameter's in ``named_parameters`` order."""
    if not case.name.startswith("nn."):
        return port_op(pt, case, args, device, grad=grad)
    dev = torch.device(device)
    layer = build_layer(pt, case, device) if layer is None else layer
    slot = grad_slot(args) if grad else None
    leaf = []

    def convert(a):
        return pt.to_tensor(a, place=dev)

    def mark(a):
        t = pt.to_tensor(a, place=dev, stop_gradient=False)
        leaf.append(t)
        return t

    for p in layer.parameters():
        p.grad = None
    with using_device(str(dev)):
        out = layer(*convert_args(args, convert, slot, mark))
    outs = flat_outputs(out)
    grads = None
    if slot is not None:
        y = next(o for o in outs if isinstance(o, torch.Tensor)
                 and o.is_floating_point() and o.requires_grad)
        w = torch.from_numpy(weights_for(tuple(y.shape))).to(dev, y.dtype)
        torch.sum(y * w).backward()
        grads = []
        for t in leaf + [p for _, p in layer.named_parameters()]:
            g = (t.grad if t.grad is not None else torch.zeros_like(t))
            grads.append((g.detach().float().cpu().numpy(),
                          max(1, y.numel() // max(1, t.numel()))))
    arrays, dtypes = [], []
    for o in outs:
        dtypes.append(str(o.dtype).replace("torch.", ""))
        arrays.append(o.detach().float().cpu().numpy()
                      if o.dtype == torch.bfloat16 else
                      o.detach().cpu().numpy())
    return arrays, dtypes, grads, 1


def compare_nn_grads(case, got, want):
    """``compare_grad`` over a layer row's gradients, pair by pair."""
    if got is None or want is None:
        return None if got is None and want is None else "one gradient"
    if len(got) != len(want):
        return f"{len(got)} gradients vs {len(want)}"
    for i, ((g, t), (w, _)) in enumerate(zip(got, want)):
        err = compare_grad(case, g, w, t)
        if err:
            return f"gradient {i}: {err}"
    return None


# ---- phase 28b/28c: user models on the nn layer library ---------------------
# PaddleNLP examples/machine_translation/seq2seq (IWSLT'15 en-vi, attention
# LSTM): vocabularies 17,191 / 7,709, width 512, 2 layers, dropout 0.2,
# ClipGradByGlobalNorm(5.0), Adam; batch 128, 10-50 tokens.
S2S = dict(src_vocab=17191, trg_vocab=7709, hidden=512, layers=2,
           dropout=0.2)
S2S_BATCH, S2S_MAXLEN, S2S_LENS = 128, 50, (10, 50)
S2S_BEAM, S2S_MAX_STEPS = 10, 256
S2S_PAD, S2S_BOS, S2S_EOS = 0, 1, 2
S2S_TWIN_BATCH = 8          # the fp32 twin's batch (dropout 0, TF32 off)
S2S_TWIN_TOL = 1e-4         # card logits vs a CPU copy, relative norm
# DCGAN (Radford, Metz & Chintala, arXiv:1511.06434, Fig. 1 and section 4):
# z 100 -> 4x4x1024 -> ... -> 64x64x3, N(0, 0.02) weights, Adam(2e-4, 0.5),
# batch 128.
DCGAN = dict(nz=100, width=1024, channels=3)
DCGAN_BATCH, DCGAN_STEPS = 128, 3
DCGAN_TWIN_BATCH = 8
DCGAN_TWIN_TOL = 1e-4       # parameters after one G and one D step


def seq2seq(paddle, src_vocab, trg_vocab, hidden, layers, dropout,
            pad=S2S_PAD):
    """PaddleNLP's attention seq2seq as a user writes it, with ``paddle``
    either package: an ``Embedding(padding_idx=)`` + ``LSTM`` encoder, a
    decoder cell (an ``RNNCellBase``: ``layers`` ``LSTMCell``s fed the
    embedding and the last attention output, dot-product attention over
    the encoder outputs under the padding mask, context and state
    concatenated and projected) and a bias-free vocabulary projection.
    The cell's state is one flat tuple (h, c per layer, then the attention
    feed), as ``BeamSearchDecoder`` takes it. ``model(src, src_len, trg)``
    is teacher forcing: logits ``[B, T, trg_vocab]``."""
    nn, F = paddle.nn, paddle.nn.functional

    class Attention(nn.Layer):
        def __init__(self):
            super().__init__()
            self.input_proj = nn.Linear(hidden, hidden, bias_attr=False)
            self.output_proj = nn.Linear(2 * hidden, hidden,
                                         bias_attr=False)

        def forward(self, h, enc_out, mask):
            q = paddle.unsqueeze(self.input_proj(h), [1])
            scores = paddle.matmul(q, enc_out, transpose_y=True) + \
                paddle.unsqueeze(mask, [1])
            ctx = paddle.matmul(F.softmax(scores, axis=-1), enc_out)
            return paddle.tanh(self.output_proj(paddle.concat(
                [paddle.squeeze(ctx, [1]), h], axis=-1)))

    class DecoderCell(nn.RNNCellBase):
        def __init__(self):
            super().__init__()
            self.dropout = nn.Dropout(dropout)
            self.lstm_cells = nn.LayerList([
                nn.LSTMCell(2 * hidden if i == 0 else hidden, hidden)
                for i in range(layers)])
            self.attention = Attention()

        def forward(self, step_input, states, encoder_output,
                    encoder_padding_mask):
            x = paddle.concat([step_input, states[-1]], axis=-1)
            new = []
            for i, cell in enumerate(self.lstm_cells):
                out, (h, c) = cell(x, (states[2 * i], states[2 * i + 1]))
                x = self.dropout(out)
                new += [h, c]
            out = self.attention(x, encoder_output, encoder_padding_mask)
            return out, tuple(new + [out])

    class Seq2Seq(nn.Layer):
        def __init__(self):
            super().__init__()
            self.src_embedder = nn.Embedding(src_vocab, hidden,
                                             padding_idx=pad)
            self.encoder = nn.LSTM(hidden, hidden, layers, dropout=dropout)
            self.trg_embedder = nn.Embedding(trg_vocab, hidden,
                                             padding_idx=pad)
            self.cell = DecoderCell()
            self.output_layer = nn.Linear(hidden, trg_vocab,
                                          bias_attr=False)

        def encode(self, src, src_len):
            enc_out, (h, c) = self.encoder(self.src_embedder(src))
            keep = paddle.cast(F.sequence_mask(src_len, src.shape[1]),
                               "float32")
            states = []
            for i in range(layers):
                states += [h[i], c[i]]
            feed = paddle.zeros([src.shape[0], hidden], dtype="float32")
            return enc_out, (keep - 1.0) * 1e9, tuple(states + [feed])

        def forward(self, src, src_len, trg):
            enc_out, mask, states = self.encode(src, src_len)
            emb = self.trg_embedder(trg)
            outs = []
            for t in range(trg.shape[1]):
                out, states = self.cell(emb[:, t], states, enc_out, mask)
                outs.append(out)
            return self.output_layer(paddle.stack(outs, axis=1))

    return Seq2Seq()


def seq2seq_loss(paddle, logits, label, label_len):
    """Token-mean cross entropy over the target positions within each
    sentence's length."""
    F = paddle.nn.functional
    ce = F.cross_entropy(logits, label, reduction="none")
    keep = paddle.cast(F.sequence_mask(label_len, label.shape[1]),
                       "float32")
    return paddle.sum(ce * keep) / paddle.sum(keep)


def seq2seq_batch(B, max_len, lens, src_vocab, trg_vocab, seed=0):
    """A seeded batch: (src, src_len, trg_in, trg_out, trg_len) numpy,
    lengths in ``lens``, padded with ``S2S_PAD``; the target input starts
    with ``S2S_BOS`` and the output ends with ``S2S_EOS``."""
    r = np.random.default_rng(seed)
    src_len = r.integers(lens[0], lens[1] + 1, B).astype(np.int64)
    trg_len = r.integers(lens[0], lens[1] + 1, B).astype(np.int64)
    src = r.integers(3, src_vocab, (B, max_len)).astype(np.int64)
    body = r.integers(3, trg_vocab, (B, max_len)).astype(np.int64)
    pos = np.arange(max_len)[None, :]
    src[pos >= src_len[:, None]] = S2S_PAD
    trg_in = np.concatenate([np.full((B, 1), S2S_BOS), body[:, :-1]], 1)
    trg_out = np.where(pos == (trg_len - 1)[:, None], S2S_EOS, body)
    trg_in[pos >= trg_len[:, None]] = S2S_PAD
    trg_out[pos >= trg_len[:, None]] = S2S_PAD
    return src, src_len, trg_in, trg_out, trg_len


def beam_decode(paddle, model, src, src_len, beam, max_steps,
                eos=S2S_EOS):
    """``BeamSearchDecoder(model.cell)`` + ``dynamic_decode``, the encoder
    outputs and mask tiled by ``tile_beam_merge_with_batch``. Returns
    (predicted ids ``[B, T, beam]``, parent ids, scores, lengths, the
    step tokens before the backtrace ``[T, B, beam]``)."""
    nn = paddle.nn
    with paddle.no_grad():
        enc_out, mask, states = model.encode(src, src_len)
        dec = nn.BeamSearchDecoder(model.cell, S2S_BOS, eos, beam,
                                   embedding_fn=model.trg_embedder,
                                   output_fn=model.output_layer)
        raw = {}
        finalize = dec.finalize

        def keep_steps(outputs, final_states, lengths):
            raw["ids"] = outputs.predicted_ids
            return finalize(outputs, final_states, lengths)

        dec.finalize = keep_steps
        tile = dec.tile_beam_merge_with_batch
        out, _, lengths = nn.dynamic_decode(
            dec, inits=states, max_step_num=max_steps, return_length=True,
            encoder_output=paddle.to_tensor(tile(enc_out)),
            encoder_padding_mask=paddle.to_tensor(tile(mask)))
    return (out.predicted_ids, out.parent_ids, out.scores, lengths,
            raw["ids"])


def greedy_decode(paddle, model, src, src_len, steps, eos=S2S_EOS):
    """``steps`` greedy steps of the same cell: ``[B, steps]`` tokens, the
    end token repeated once a row has emitted it. The loop keeps each
    row's running log-probability and takes the arg-max (the lower index
    on a tie) of running + step log-probabilities, the sum a one-beam
    search ranks, so the two round alike: the step's own arg-max can
    differ where two candidates come within an ulp of the running sum."""
    F = paddle.nn.functional
    with paddle.no_grad():
        enc_out, mask, states = model.encode(src, src_len)
        tok = paddle.full([src.shape[0]], S2S_BOS, dtype="int64")
        done = paddle.zeros([src.shape[0]], dtype="bool")
        score = paddle.zeros([src.shape[0]], dtype="float32")
        out = []
        for _ in range(steps):
            h, states = model.cell(model.trg_embedder(tok), states,
                                   enc_out, mask)
            total = paddle.unsqueeze(score, [1]) + F.log_softmax(
                model.output_layer(h), axis=-1)
            nxt = paddle.argmax(total, axis=-1)
            score = paddle.where(done, score, paddle.max(total, axis=-1))
            tok = paddle.where(done, paddle.full_like(nxt, eos), nxt)
            done = paddle.logical_or(done, paddle.equal(
                tok, paddle.full_like(tok, eos)))
            out.append(tok)
    return paddle.stack(out, axis=1)


def np_backtrace(step_ids, parents):
    """numpy ``gather_tree`` of ``[T, B, beam]`` step tokens and parents."""
    step_ids, parents = np.asarray(step_ids), np.asarray(parents)
    T, B, W = step_ids.shape
    out = np.zeros_like(step_ids)
    for b in range(B):
        for k in range(W):
            beam = k
            for t in range(T - 1, -1, -1):
                out[t, b, k] = step_ids[t, b, beam]
                beam = parents[t, b, beam]
    return out


def dcgan(paddle, nz, width, channels):
    """DCGAN's generator and discriminator (arXiv:1511.06434, Fig. 1) as
    a user writes them with ``paddle`` either package: z ``[B, nz, 1, 1]``
    -> ``Conv2DTranspose(nz, width, 4, 1, 0)`` -> width / 2, / 4, / 8 by
    ``Conv2DTranspose(k 4, stride 2, pad 1)`` + ``BatchNorm2D`` + ``ReLU``
    -> 64 x 64 x channels, ``Tanh``; the discriminator mirrors it with
    ``Conv2D`` + ``LeakyReLU(0.2)`` (no batch norm on its input layer),
    then ``Sigmoid``. Convolution weights N(0, 0.02), no biases."""
    nn = paddle.nn
    attr = paddle.ParamAttr(initializer=nn.initializer.Normal(0.0, 0.02))
    w = [width, width // 2, width // 4, width // 8]

    def up(cin, cout):
        return [nn.Conv2DTranspose(cin, cout, 4, 2, 1, weight_attr=attr,
                                   bias_attr=False),
                nn.BatchNorm2D(cout), nn.ReLU()]

    def down(cin, cout, norm=True):
        return ([nn.Conv2D(cin, cout, 4, 2, 1, weight_attr=attr,
                           bias_attr=False)]
                + ([nn.BatchNorm2D(cout)] if norm else [])
                + [nn.LeakyReLU(0.2)])

    gen = nn.Sequential(
        nn.Conv2DTranspose(nz, w[0], 4, 1, 0, weight_attr=attr,
                           bias_attr=False),
        nn.BatchNorm2D(w[0]), nn.ReLU(), *up(w[0], w[1]), *up(w[1], w[2]),
        *up(w[2], w[3]),
        nn.Conv2DTranspose(w[3], channels, 4, 2, 1, weight_attr=attr,
                           bias_attr=False), nn.Tanh())
    disc = nn.Sequential(
        *down(channels, w[3], norm=False), *down(w[3], w[2]),
        *down(w[2], w[1]), *down(w[1], w[0]),
        nn.Conv2D(w[0], 1, 4, 1, 0, weight_attr=attr, bias_attr=False),
        nn.Sigmoid())
    return gen, disc


def dcgan_step(paddle, gen, disc, opt_g, opt_d, real, z, order="dg"):
    """One alternating step on one generated batch: D on real (label 1)
    and the detached fake (0), and G through D on the same fake (label
    1), ``BCELoss``; D first by default, G first with ``order="gd"``.
    Returns (d_loss, g_loss)."""
    bce = paddle.nn.BCELoss()
    b = real.shape[0]
    ones = paddle.ones([b, 1, 1, 1], dtype="float32")
    zeros = paddle.zeros([b, 1, 1, 1], dtype="float32")
    fake = gen(z)
    losses = {}
    for side in order:
        if side == "d":
            loss = bce(disc(real), ones) + bce(disc(fake.detach()), zeros)
            loss.backward()
            opt_d.step()
        else:
            loss = bce(disc(fake), ones)
            loss.backward()
            opt_g.step()
            opt_g.clear_grad()
        opt_d.clear_grad()
        losses[side] = loss
    return losses["d"], losses["g"]


def user_decoder_layer(paddle, hidden, heads, ffn, eps=1e-5, theta=10000.0):
    """A Llama decoder layer as a user writes it on paddle's eager
    surface, with ``paddle`` either package: ``nn.Layer`` subclasses whose
    weights come from ``create_parameter`` (names as
    ``LlamaDecoderLayer``'s, so state dicts carry across), RMSNorm from
    ``rsqrt``/``mean``, rotary embedding by ``split``/``concat``, scores by
    ``matmul(transpose_y=True)``, a causal mask from ``triu``/``where``,
    ``F.softmax`` and ``F.silu``. Works on [B, L, hidden] inputs."""
    F = paddle.nn.functional
    hd = hidden // heads
    ones = paddle.nn.initializer.Constant(1.0)

    class Proj(paddle.nn.Layer):
        def __init__(self, n_in, n_out):
            super().__init__()
            self.weight = self.create_parameter([n_in, n_out])

        def forward(self, x):
            return paddle.matmul(x, self.weight)

    class Norm(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.weight = self.create_parameter([hidden],
                                                default_initializer=ones)

        def forward(self, x):
            ms = paddle.mean(x * x, axis=-1, keepdim=True)
            return x * paddle.rsqrt(ms + eps) * self.weight

    def rotary(t, length):
        inv = 1.0 / (theta ** (paddle.arange(0, hd, 2, dtype="float32")
                               / hd))
        freqs = paddle.unsqueeze(paddle.arange(0, length, dtype="float32"),
                                 [1]) * paddle.unsqueeze(inv, [0])
        cos = paddle.reshape(paddle.cos(freqs), [1, length, 1, hd // 2])
        sin = paddle.reshape(paddle.sin(freqs), [1, length, 1, hd // 2])
        t1, t2 = paddle.split(t, 2, axis=-1)
        return paddle.concat([t1 * cos - t2 * sin, t1 * sin + t2 * cos],
                             axis=-1)

    class Attention(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.q_proj = Proj(hidden, hidden)
            self.k_proj = Proj(hidden, hidden)
            self.v_proj = Proj(hidden, hidden)
            self.o_proj = Proj(hidden, hidden)

        def forward(self, x):
            b, length = x.shape[0], x.shape[1]

            def heads_of(t):
                return paddle.reshape(t, [b, length, heads, hd])

            q = rotary(heads_of(self.q_proj(x)), length)
            k = rotary(heads_of(self.k_proj(x)), length)
            q, k, v = (paddle.transpose(t, [0, 2, 1, 3])
                       for t in (q, k, heads_of(self.v_proj(x))))
            s = paddle.matmul(q, k, transpose_y=True) * (hd ** -0.5)
            future = paddle.triu(paddle.ones([length, length]), diagonal=1)
            s = paddle.where(future > 0, paddle.full_like(s, -1e30), s)
            o = paddle.matmul(F.softmax(s, axis=-1), v)
            o = paddle.reshape(paddle.transpose(o, [0, 2, 1, 3]),
                               [b, length, hidden])
            return self.o_proj(o)

    class MLP(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.gate_proj = Proj(hidden, ffn)
            self.up_proj = Proj(hidden, ffn)
            self.down_proj = Proj(ffn, hidden)

        def forward(self, x):
            return self.down_proj(F.silu(self.gate_proj(x))
                                  * self.up_proj(x))

    class DecoderLayer(paddle.nn.Layer):
        def __init__(self):
            super().__init__()
            self.input_layernorm = Norm()
            self.self_attn = Attention()
            self.post_attention_layernorm = Norm()
            self.mlp = MLP()

        def forward(self, x):
            x = x + self.self_attn(self.input_layernorm(x))
            return x + self.mlp(self.post_attention_layernorm(x))

    return DecoderLayer()



P26_LAYER = dict(hidden=4096, heads=32, ffn=11008)     # Llama-2-7B
P26_TOKENS = 2048                                      # [1, 2048]
P26_REPS = 5                                           # timed fwd+bwd
# 26b: the user layer against LlamaDecoderLayer, fp32 with TF32 off:
# relative norm of the output and of every parameter's gradient
P26_TOL = 1e-4
P26C = dict(hidden=64, batch=32, warmup=40, steps=50)  # tools/bench_eager.py
P26D_TOL = 1e-5


def phase_eager_ops(pt, n=OP_ROWS_CARD, device="cuda"):
    """26a: every row of the op table on the card against a CPU copy:
    outputs (and gradients) within the row's tolerance, dtypes equal.
    Returns {module: [passed, rows]} and the five slowest rows (seconds,
    both devices); raises listing every failure."""
    counts, fails, times = {}, [], []
    for case in op_cases(n):
        args = op_args(case, n)
        mod = counts.setdefault(op_module(case.name), [0, 0])
        mod[1] += 1
        t0 = time.perf_counter()
        try:
            got = port_op(pt, case, args, device, grad=case.grad)
            want = port_op(pt, case, args, "cpu", grad=case.grad)
            err = (None if got[1] == want[1]
                   else f"dtypes {got[1]} vs {want[1]}")
            err = err or compare_op(case, args, got[0], want[0]) \
                or compare_grad(case, got[2], want[2], want[3])
        except Exception as e:                  # noqa: BLE001 (listed)
            err = f"{type(e).__name__}: {e}"
        times.append((round(time.perf_counter() - t0, 3), case.id))
        if err:
            fails.append(f"{case.id}: {err}")
        else:
            mod[0] += 1
    if fails:
        raise AssertionError(f"26a: {len(fails)} rows differ from the CPU: "
                             + "; ".join(fails[:40]))
    return counts, sorted(times, reverse=True)[:5]


def _rel_norm(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def _fwd_bwd(layer, x):
    """One forward and backward (loss = mean(out^2)); the output."""
    out = layer(x)
    torch.mean(out * out).backward()
    return out


def _time_fwd_bwd(layer, x, reps, device):
    times = []
    for _ in range(reps):
        layer.zero_grad(set_to_none=True)
        sync(device)
        t0 = time.perf_counter()
        _fwd_bwd(layer, x)
        sync(device)
        times.append(time.perf_counter() - t0)
    layer.zero_grad(set_to_none=True)
    return float(np.median(times)) * 1e3


def phase_user_layer(fa, fc, rm, pt, LlamaConfig, LlamaDecoderLayer,
                     layer=P26_LAYER, tokens=P26_TOKENS, reps=P26_REPS,
                     tol=P26_TOL, device="cuda"):
    """26b: ``user_decoder_layer`` (the user's flat-op ``nn.Layer``)
    holding the weights of the port's ``LlamaDecoderLayer`` built from
    seed 0, fp32: output and every parameter's gradient after
    ``loss.backward()`` within ``tol`` (relative norm) of the port
    layer's; rows 1-3 launch once each in a call of the port layer and
    never in the user's; the median of ``reps`` fwd+bwd times and the
    peak memory of each."""
    with using_device(device):
        return _user_layer(fa, fc, rm, pt, LlamaConfig, LlamaDecoderLayer,
                           layer, tokens, reps, tol, device)


def _user_layer(fa, fc, rm, pt, LlamaConfig, LlamaDecoderLayer, layer,
                tokens, reps, tol, device):
    from paddle_tpu_torch.framework.io import load_numpy_state_dict
    cfg = LlamaConfig(hidden_size=layer["hidden"],
                      intermediate_size=layer["ffn"],
                      num_attention_heads=layer["heads"],
                      num_key_value_heads=layer["heads"], dtype="float32")
    pt.seed(0)
    ref = LlamaDecoderLayer(cfg, device=device)
    user = user_decoder_layer(pt, layer["hidden"], layer["heads"],
                              layer["ffn"], cfg.rms_norm_eps, cfg.rope_theta)
    load_numpy_state_dict(user, {k: v.detach().cpu().numpy()
                                 for k, v in ref.state_dict().items()})
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, tokens, layer["hidden"])).astype(np.float32)).to(device)
    _reset(fa, fc, rm)
    out_ref = _fwd_bwd(ref, x).detach()
    ref_launches = _counts(fa, fc, rm)
    _reset(fa, fc, rm)
    out_user = _fwd_bwd(user, x).detach()
    user_launches = _counts(fa, fc, rm)
    want = (dict(flash_attention_fwd=1, flash_attention_bwd_dq=1,
                 flash_attention_bwd_dkv=1) if device != "cpu" else
            dict(flash_attention_fwd=0, flash_attention_bwd_dq=0,
                 flash_attention_bwd_dkv=0))
    for k, v in want.items():
        if ref_launches[k] != v:
            raise AssertionError(f"26b: {k} launched {ref_launches[k]} "
                                 f"times in a LlamaDecoderLayer call, not "
                                 f"{v}")
    if any(user_launches[k] for k in want):
        raise AssertionError(f"26b: the user layer launched a port kernel: "
                             f"{user_launches}")
    refp = dict(ref.named_parameters())
    errs = {"output": _rel_norm(out_user, out_ref)}
    errs.update({k: _rel_norm(p.grad, refp[k].grad)
                 for k, p in user.named_parameters()})
    worst = max(errs, key=errs.get)
    if errs[worst] > tol:
        raise AssertionError(f"26b: {worst} {errs[worst]:.3g} beyond {tol} "
                             f"(relative norm): {errs}")
    res = dict(widths=dict(layer, tokens=tokens), tol=tol,
               worst=[worst, errs[worst]], output_rel=errs["output"],
               launches={k: ref_launches[k] for k in want})
    del out_ref, out_user
    for name, mod in (("llama_decoder_layer", ref), ("user_layer", user)):
        mod.zero_grad(set_to_none=True)
        if device != "cpu":
            torch.cuda.empty_cache()
        reset_peak(device)
        res[name + "_ms"] = _time_fwd_bwd(mod, x, reps, device)
        res[name + "_peak_gib"] = peak_gib(device)
    return res


def eager_mlp_losses(pt, F, hidden, batch, steps, device):
    """``tools/bench_eager.py``'s loop on the port's eager API: ``Sequential
    (Linear, ReLU, Linear)`` from ``seed(0)``, ``cross_entropy``,
    ``backward``, ``Adam(1e-3)``, ``clear_grad``; (the step, its losses)."""
    rng = np.random.default_rng(0)
    x = pt.to_tensor(rng.standard_normal((batch, hidden)).astype(
        np.float32), place=device)
    y = pt.to_tensor(rng.integers(0, 10, (batch,)), place=device)
    with using_device(device):
        pt.seed(0)
        net = pt.nn.Sequential(pt.nn.Linear(hidden, hidden), pt.nn.ReLU(),
                               pt.nn.Linear(hidden, 10))
    opt = pt.optimizer.Adam(learning_rate=1e-3, parameters=net.parameters())
    losses = []

    def step():
        loss = F.cross_entropy(net(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss.detach())
        return loss

    return step, losses


def phase_eager_loop(pt, F, cfg=P26C, device="cuda"):
    """26c: ms a step over ``steps`` steps after ``warmup``, device
    launches a step (one profiled step), and the losses of two runs from
    the same seed equal bit for bit."""
    runs = []
    for _ in range(2):
        step, losses = eager_mlp_losses(pt, F, cfg["hidden"], cfg["batch"],
                                        cfg["steps"], device)
        for _ in range(cfg["warmup"]):
            step()
        sync(device)
        t0 = time.perf_counter()
        for _ in range(cfg["steps"]):
            step()
        sync(device)
        ms = (time.perf_counter() - t0) / cfg["steps"] * 1e3
        runs.append((ms, [float(v) for v in losses]))
    if runs[0][1] != runs[1][1]:
        raise AssertionError("26c: the losses did not repeat under seed(0)")
    if not runs[0][1][-1] < runs[0][1][0]:
        raise AssertionError(f"26c: the loss did not drop: {runs[0][1][0]} "
                             f"-> {runs[0][1][-1]}")
    prof = (profile_step(step) if device != "cpu" else {})
    return dict(ms_per_step=[r[0] for r in runs],
                launches_per_step=prof.get("device_kernel_launches"),
                device_idle_share=prof.get("device_idle_share"),
                first_losses=runs[0][1][:3], last_loss=runs[0][1][-1],
                bitwise_repeat=True)


def _autograd_probe(pt, device):
    """A PyLayer cube, ``jacobian`` and ``hessian`` of a small function,
    on ``device``: a list of numpy arrays."""
    with using_device(device):
        return _probe(pt, device)


def _probe(pt, device):
    class Cube(pt.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x):
            ctx.save_for_backward(x)
            return x * x * x

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            return dy * 3 * x * x

    rng = np.random.default_rng(4)
    a = rng.standard_normal((64, 32)).astype(np.float32)
    x = pt.to_tensor(a, place=device, stop_gradient=False)
    y = Cube.apply(x)
    pt.autograd.backward(pt.sum(y * pt.to_tensor(weights_for(a.shape),
                                                 place=device)))
    v = pt.to_tensor(rng.standard_normal(16).astype(np.float32),
                     place=device)
    w = pt.to_tensor(rng.standard_normal((16, 16)).astype(np.float32),
                     place=device)

    def f(t):
        return pt.sum(pt.tanh(pt.matmul(w, t)) ** 2)

    jac = pt.autograd.jacobian(lambda t: pt.tanh(pt.matmul(w, t)), v)
    hes = pt.autograd.hessian(f, v)
    return [t.detach().cpu().numpy() for t in (y, x.grad, jac, hes)]


def phase_autograd(pt, device="cuda", tol=P26D_TOL):
    """26d: the probe on the card against the CPU, each result within
    ``tol`` of the CPU's largest element."""
    got, want = _autograd_probe(pt, device), _autograd_probe(pt, "cpu")
    errs = [float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
            for g, w in zip(got, want)]
    names = ["pylayer_out", "pylayer_grad", "jacobian", "hessian"]
    if max(errs) > tol:
        raise AssertionError(f"26d: {dict(zip(names, errs))} beyond {tol}")
    return dict(zip(names, errs))


# ---------------------------------------------------------------------------
# phase 27: serving robustness under tp, and the observability surface
# ---------------------------------------------------------------------------

P27_AT = (6, 14)         # the supervised steps faults fire at: mid-decode
P27_TIMEOUT_S = 3.0     # step timeout of the stall runs (a step is ~0.1 s)
P27_STALL_S = 4.5       # rank 1's wedge, past the step timeout
# the supervised runs: (sampling, its two faults at P27_AT's steps), every
# fault once, greedy first
P27_RUNS = (("greedy", ("decode-raise", "rank 1 stall")),
            ("sampled", ("rank 1 raise", "rank 1 kv-corrupt")))
# the run in which rank 1 also wedges at the first decode step, after the
# step's last collective (stall_inside(late=True)): rank 0 finishes the
# step and emits its tokens before the group's verdict takes them back
P27_LATE = "greedy"
# each fault's plan entry (fault, the rank it is confined to or None) and
# the EngineSupervisor arguments it needs
P27_FAULTS = {
    "decode-raise": (("decode-raise", None), {}),
    "rank 1 raise": (("decode-raise", 1), {}),
    "rank 1 stall": (("decode-stall", 1),
                     dict(step_timeout_s=P27_TIMEOUT_S)),
    "rank 1 kv-corrupt": (("kv-corrupt", 1), dict(kv_probe_interval=1)),
}
P27_COUNTER = {"decode-raise": "step_errors", "rank 1 raise": "step_errors",
               "rank 1 stall": "wedges", "rank 1 kv-corrupt": "kv_corruptions",
               "rank 1 late stall": "wedges"}
P27_FLEET_REQUESTS = 4  # 27b: the first 4 of phase 5's prompts


# ---- phase 28: the nn layer library ----------------------------------------
def phase_nn_table(pt, n=NN_ROWS_CARD, device="cuda"):
    """28a: every row of the nn table at card size on the card against a
    CPU copy of the same inputs and weights: dtypes equal, outputs within
    the row's class (integer, mask and index results bit for bit), every
    gradient within ``GRAD_TOL``. Returns ({"functional"|"layers":
    [passed, rows]}, the five slowest rows); raises listing every
    failure."""
    counts, fails, times = {}, [], []
    for case in nn_cases(n):
        args = op_args(case, n)
        grp = counts.setdefault("layers" if case.name.startswith("nn.")
                                else "functional", [0, 0])
        grp[1] += 1
        t0 = time.perf_counter()
        try:
            got = port_nn(pt, case, args, device, grad=case.grad)
            want = port_nn(pt, case, args, "cpu", grad=case.grad)
            err = (None if got[1] == want[1]
                   else f"dtypes {got[1]} vs {want[1]}")
            err = err or compare_op(case, args, got[0], want[0])
            if not err and isinstance(want[2], list):
                err = compare_nn_grads(case, got[2], want[2])
            elif not err:
                err = compare_grad(case, got[2], want[2], want[3])
        except Exception as e:                  # noqa: BLE001 (listed)
            err = f"{type(e).__name__}: {e}"
        times.append((round(time.perf_counter() - t0, 3), case.id))
        if err:
            fails.append(f"{case.id}: {err}")
        else:
            grp[0] += 1
    if fails:
        raise AssertionError(f"28a: {len(fails)} rows differ from the CPU: "
                             + "; ".join(fails[:40]))
    return counts, sorted(times, reverse=True)[:5]


def _cuda_wall(fn, device):
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def _on(pt, arrays, device):
    return [pt.to_tensor(a, place=torch.device(device)) for a in arrays]


def phase_seq2seq(pt, device="cuda"):
    """28b: PaddleNLP's IWSLT'15 attention seq2seq (``S2S``) at batch
    ``S2S_BATCH``, fp32: 3 Adam steps (``ClipGradByGlobalNorm(5.0)``,
    dropout 0.2) on a repeated batch, the loss finite, the first within
    1.0 of ln(trg_vocab) and falling; then ``BeamSearchDecoder(beam_size=
    S2S_BEAM)`` + ``dynamic_decode(max_step_num=S2S_MAX_STEPS)`` on the
    tiled encoder outputs, its ``predicted_ids`` equal to a numpy
    backtrace of the step tokens along the returned ``parent_ids``. On an
    fp32 twin (dropout 0, TF32 off, batch ``S2S_TWIN_BATCH``, untrained):
    the card's logits within ``S2S_TWIN_TOL`` (relative norm) of a CPU
    copy's, the beam decode's backtrace again, and ``beam_size=1`` token
    for token the greedy loop over the same cell."""
    import copy
    nn = pt.nn
    out = {}
    with using_device(device):
        pt.seed(0)
        model = seq2seq(pt, **S2S)
        opt = pt.optimizer.Adam(learning_rate=1e-3,
                                parameters=model.parameters(),
                                grad_clip=nn.ClipGradByGlobalNorm(5.0))
        src, sl, ti, to, tl = _on(pt, seq2seq_batch(
            S2S_BATCH, S2S_MAXLEN, S2S_LENS, S2S["src_vocab"],
            S2S["trg_vocab"]), device)
        model.train()
        losses, walls = [], []
        for _ in range(3):
            def step():
                loss = seq2seq_loss(pt, model(src, sl, ti), to, tl)
                loss.backward()
                opt.step()
                opt.clear_grad()
                return float(loss.detach())
            loss, wall = _cuda_wall(step, device)
            losses.append(loss)
            walls.append(wall)
        first_near = abs(losses[0] - float(np.log(S2S["trg_vocab"])))
        if not all(np.isfinite(losses)) or first_near > 1.0 or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"28b losses {losses}")
        model.eval()
        (pred, parent, scores, lengths, steps), dec_s = _cuda_wall(
            lambda: beam_decode(pt, model, src, sl, S2S_BEAM,
                                S2S_MAX_STEPS), device)
        T = pred.shape[1]
        want = np_backtrace(steps.cpu().numpy(), parent.cpu().numpy()
                            .transpose(1, 0, 2))
        if not np.array_equal(pred.cpu().numpy().transpose(1, 0, 2), want):
            raise AssertionError("28b: predicted_ids are not the backtrace "
                                 "of the step tokens along parent_ids")
        if not torch.isfinite(scores).all() or \
                tuple(pred.shape) != (S2S_BATCH, T, S2S_BEAM):
            raise AssertionError(f"28b decode: shape {tuple(pred.shape)}")
        out.update(losses=losses, step_s=walls, decode_s=dec_s,
                   decode_steps=T, max_length=int(lengths.max()),
                   peak_gib=peak_gib(device))
        del model, opt
        gc.collect()
        torch.cuda.empty_cache()
        # the fp32 twin: dropout 0, a CPU copy of the same weights
        pt.seed(1)
        twin = seq2seq(pt, **{**S2S, "dropout": 0.0})
        twin.eval()
        cpu = copy.deepcopy(twin).to("cpu")
        arrays = seq2seq_batch(S2S_TWIN_BATCH, S2S_MAXLEN, S2S_LENS,
                               S2S["src_vocab"], S2S["trg_vocab"], seed=1)
        with torch.no_grad():
            got = twin(*_on(pt, arrays[:3], device))
            with using_device("cpu"):
                want = cpu(*_on(pt, arrays[:3], "cpu"))
        err = _rel_norm(got.cpu(), want)
        if not err <= S2S_TWIN_TOL:
            raise AssertionError(f"28b twin logits {err:.3g} from the CPU "
                                 f"copy's (limit {S2S_TWIN_TOL})")
        tsrc, tsl = _on(pt, arrays[:2], device)
        tpred, tpar, _, _, tsteps = beam_decode(pt, twin, tsrc, tsl,
                                                S2S_BEAM, S2S_MAX_STEPS)
        if not np.array_equal(tpred.cpu().numpy().transpose(1, 0, 2),
                              np_backtrace(tsteps.cpu().numpy(),
                                           tpar.cpu().numpy()
                                           .transpose(1, 0, 2))):
            raise AssertionError("28b twin: predicted_ids are not the "
                                 "backtrace of the step tokens")
        b1 = beam_decode(pt, twin, tsrc, tsl, 1, S2S_MAX_STEPS)[0]
        greedy = greedy_decode(pt, twin, tsrc, tsl, b1.shape[1])
        if not torch.equal(b1[:, :, 0], greedy):
            raise AssertionError("28b: beam_size=1 differs from the greedy "
                                 "loop")
        out.update(twin_logits_rel=err, twin_beam_steps=int(tpred.shape[1]),
                   beam1_steps=int(b1.shape[1]))
    return out


def phase_dcgan(pt, device="cuda"):
    """28c: DCGAN (``DCGAN``) at batch ``DCGAN_BATCH``, fp32: 3
    alternating D/G steps (Adam(2e-4, beta1 0.5), ``BCELoss``), every
    loss finite; on an fp32 twin (TF32 off, batch ``DCGAN_TWIN_BATCH``)
    one G and then one D step on the card and on a CPU copy of the same
    weights, each network's parameters and batch-norm buffers within
    ``DCGAN_TWIN_TOL`` (relative norm, all of them at once). G goes first:
    after a D step at these widths D's sigmoid saturates on the fake batch
    (G's loss ~19) and Adam's first, sign-like step turns the G
    gradient's rounding there into whole-lr differences."""
    import copy

    def models(seed):
        pt.seed(seed)
        g, d = dcgan(pt, **DCGAN)
        opts = [pt.optimizer.Adam(learning_rate=2e-4, beta1=0.5,
                                  parameters=m.parameters()) for m in (g, d)]
        return g, d, opts

    def data(b, seed):
        r = np.random.default_rng(seed)
        return (r.uniform(-1, 1, (b, DCGAN["channels"], 64, 64)).astype(
            np.float32), r.standard_normal((b, DCGAN["nz"], 1, 1)).astype(
            np.float32))

    out = {}
    with using_device(device):
        g, d, (og, od) = models(0)
        real, z = _on(pt, data(DCGAN_BATCH, 0), device)
        losses, walls = [], []
        for _ in range(DCGAN_STEPS):
            (dl, gl), wall = _cuda_wall(
                lambda: dcgan_step(pt, g, d, og, od, real, z), device)
            losses.append((float(dl.detach()), float(gl.detach())))
            walls.append(wall)
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"28c losses {losses}")
        out.update(losses=losses, step_s=walls,
                   images_per_s=DCGAN_BATCH / float(np.median(walls)),
                   peak_gib=peak_gib(device))
        del g, d, og, od
        gc.collect()
        torch.cuda.empty_cache()
        g, d, (og, od) = models(1)
        cg, cd = copy.deepcopy(g).to("cpu"), copy.deepcopy(d).to("cpu")
        arrays = data(DCGAN_TWIN_BATCH, 1)
        dcgan_step(pt, g, d, og, od, *_on(pt, arrays, device), order="gd")
        with using_device("cpu"):
            cog, cod = (pt.optimizer.Adam(learning_rate=2e-4, beta1=0.5,
                                          parameters=m.parameters())
                        for m in (cg, cd))
            dcgan_step(pt, cg, cd, cog, cod, *_on(pt, arrays, "cpu"),
                       order="gd")
        errs = {}
        for tag, a, b in (("G", g, cg), ("D", d, cd)):
            errs[tag] = _rel_norm(*(torch.cat([v.detach().float().cpu()
                                               .reshape(-1) for v in
                                               m.state_dict().values()])
                                    for m in (a, b)))
        if not max(errs.values()) <= DCGAN_TWIN_TOL:
            raise AssertionError(f"28c twin: parameters {errs} from the CPU "
                                 f"copy's (limit {DCGAN_TWIN_TOL})")
        out["twin_params_rel"] = errs
    return out


def p27_faults(mode, faults):
    """A run's faults in the order they fire: the late stall first."""
    return (("rank 1 late stall",) if mode == P27_LATE else ()) + faults


def p27_chaos(ChaosMonkey, mode, faults):
    """The ChaosMonkey and the supervisor arguments of a run's faults, the
    i-th at supervised step ``P27_AT[i]``."""
    at, ranks = {}, {}
    sup_kw = (dict(step_timeout_s=P27_TIMEOUT_S) if mode == P27_LATE
              else {})
    for step, name in zip(P27_AT, faults):
        (fault, rank), kw = P27_FAULTS[name]
        at[step] = fault
        if rank is not None:
            ranks[step] = rank
        sup_kw.update(kw)
    return (ChaosMonkey(seed=3, at=at, ranks=ranks, stall_s=P27_STALL_S),
            sup_kw)


def p27_per_request(n, sampled):
    return ([dict(temperature=0.6, seed=1000 + i) for i in range(n)]
            if sampled else [{}] * n)


def p27_fleet_schedule(server, prompts, per_request, kill=None):
    """27b's schedule (``tests/test_serving_fleet.py:490``'s): a request,
    two steps, a second, a step, kill r0, a third, a step, kill r1, the
    fourth, then drain; 32 new tokens each."""
    hs = [server.submit(prompts[0], max_new_tokens=32, **per_request[0])]
    server.step()
    server.step()
    hs.append(server.submit(prompts[1], max_new_tokens=32,
                            **per_request[1]))
    server.step()
    if kill:
        kill("r0")
    hs.append(server.submit(prompts[2], max_new_tokens=32,
                            **per_request[2]))
    server.step()
    if kill:
        kill("r1")
    hs.append(server.submit(prompts[3], max_new_tokens=32,
                            **per_request[3]))
    while any(not h.finished for h in hs):
        server.step()
    return hs


def _p27_join_zombies():
    for t in threading.enumerate():     # the abandoned step threads
        if t.name == "supervised-decode":
            t.join(120)


def _p27_work(model, rank, geo, prompts, workdir):
    """27a and 27b on one of phase 14b's two ranks (its process, its model
    on the CPU, after its runs): a plain ``Engine(tp=2)`` greedy run and
    a fault-free ``EngineSupervisor(tp=2)`` one (the supervision's cost),
    ``EngineSupervisor(tp=2)`` through each of ``P27_RUNS``; then the
    model on the card, a tp-1 engine's tokens on 27b's schedule and
    ``ReplicaFleet(tp_degrees=[2, 1])`` killing r0 and r1 on it."""
    from paddle_tpu_torch.framework.io import load_numpy_state_dict
    from paddle_tpu_torch.resilience import ChaosMonkey, stall_inside
    from paddle_tpu_torch.serving import (Engine, EngineSupervisor,
                                          ReplicaFleet)

    t_start = time.perf_counter()
    out = dict(rank=rank, runs={}, cost={})

    def timed(server, per_request=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hs = staggered(server, prompts, 32, per_request)
        torch.cuda.synchronize()
        return hs, time.perf_counter() - t0

    # the supervision's cost, fault-free: plain then supervised, greedy,
    # after phase 14's two runs warmed this process
    hs, wall = timed(Engine(model, tp=2, **geo))
    out["cost"]["plain"] = dict(wall_s=wall, tokens=[list(h.tokens)
                                                     for h in hs])
    sup = EngineSupervisor(model, tp=2, step_timeout_s=P27_TIMEOUT_S, **geo)
    hs, wall = timed(sup)
    st = sup.stats()
    out["cost"]["supervised"] = dict(
        wall_s=wall, tokens=[list(h.tokens) for h in hs],
        verdicts=st["verdicts"]["calls"], verdict_s=st["verdicts"]["seconds"],
        decode_steps=st["engine"]["decode_steps"],
        rebuilds=sup.rebuilds)
    del sup, hs
    for mode, faults in P27_RUNS:
        chaos, sup_kw = p27_chaos(ChaosMonkey, mode, faults)
        sampled = mode == "sampled"
        sup = EngineSupervisor(model, chaos=chaos, tp=2, **geo, **sup_kw,
                               **(TP_SAMPLED if sampled else {}))
        if mode == P27_LATE and rank == 1:
            stall_inside(sup.engine, P27_STALL_S, late=True)
        hs, wall = timed(sup, p27_per_request(len(prompts), sampled))
        _p27_join_zombies()
        recs = sup.ledger.to_list()
        stamps = {e: [r["t"] for r in recs if r["event"] == e]
                  for e in ("anomaly", "replay")}
        out["runs"][mode] = dict(
            tokens=[[int(t) for t in h.tokens] for h in hs],
            reasons=[h.finish_reason for h in hs], wall_s=wall,
            recovery_s=[b - a for a, b in zip(stamps["anomaly"],
                                              stamps["replay"])],
            counters=sup.counters(), tp=sup.engine.tp,
            records=[{k: v for k, v in r.items() if k != "t"}
                     for r in recs],
            trace_ids=[h.trace_id for h in hs])
        del sup
        gc.collect()
        torch.cuda.empty_cache()
    # 27b: the model on the card (the CPU draws, copied), a tp-1 engine's
    # tokens on the schedule, then the mixed fleet with both kills
    card = tp_model("14b", "cuda")
    load_numpy_state_dict(card, {k: v.numpy()
                                 for k, v in model.state_dict().items()})
    fprompts = prompts[:P27_FLEET_REQUESTS]
    per = p27_per_request(P27_FLEET_REQUESTS, True)
    ref = p27_fleet_schedule(Engine(card, **geo, **TP_SAMPLED), fprompts,
                             per)
    fleet = ReplicaFleet(card, 2, tp_degrees=[2, 1], **geo, **TP_SAMPLED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hs = p27_fleet_schedule(fleet, fprompts, per, kill=fleet.kill_replica)
    torch.cuda.synchronize()
    out["fleet"] = dict(
        tokens=[[int(t) for t in h.tokens] for h in hs],
        tp1_tokens=[[int(t) for t in h.tokens] for h in ref],
        reasons=[h.finish_reason for h in hs],
        wall_s=time.perf_counter() - t0, migrations=fleet.migrations,
        replica_kills=fleet.replica_kills,
        tps={rid: r.engine.tp for rid, r in fleet.replicas.items()},
        refcounts=all(r.engine.cache.check_refcounts()
                      for r in fleet.replicas.values()))
    out["work_s"] = time.perf_counter() - t_start
    with open(os.path.join(workdir, f"p27.r{rank}.json"), "w") as f:
        json.dump(out, f)


def phase_tp_robust(refs, workdir="build/phase27"):
    """27a and 27b's checks (see the module docstring) on what phase
    14b's ranks wrote (``_p27_work``); ``refs`` is phase 14's 14b record:
    {"greedy"/"sampled": {"tp1": tokens, "tp2": tokens}}."""
    import shutil

    smi = smi_line()
    try:
        ranks = []
        for r in range(2):
            with open(os.path.join(workdir, f"p27.r{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    result = dict(work_s=[rk["work_s"] for rk in ranks], runs={})
    # the supervision's cost
    cost = [rk["cost"] for rk in ranks]
    want = refs["greedy"]
    for c in cost:
        if not (c["plain"]["tokens"] == c["supervised"]["tokens"]
                == want["tp1"]) or c["supervised"]["rebuilds"]:
            raise AssertionError("27a: the fault-free runs' tokens differ "
                                 "from tp=1's")
    sv = cost[0]["supervised"]
    per_step = sv["verdict_s"] / max(sv["verdicts"], 1) * 1e3
    log(f"  27a fault-free, greedy, rank 0 / rank 1: Engine(tp=2) "
        f"{[round(c['plain']['wall_s'], 3) for c in cost]} s, "
        f"EngineSupervisor(tp=2, step_timeout_s={P27_TIMEOUT_S}) "
        f"{[round(c['supervised']['wall_s'], 3) for c in cost]} s "
        f"(tokens identical to tp=1); the verdicts: {sv['verdicts']} "
        f"collectives (two a supervised step; {sv['decode_steps']} decode "
        f"steps), "
        f"{sv['verdict_s'] * 1e3:.1f} ms on rank 0 ({per_step:.3f} ms "
        f"each) ({smi})")
    result["cost"] = dict(
        plain_wall_s=[c["plain"]["wall_s"] for c in cost],
        supervised_wall_s=[c["supervised"]["wall_s"] for c in cost],
        verdicts=sv["verdicts"], decode_steps=sv["decode_steps"],
        verdict_s=[c["supervised"]["verdict_s"] for c in cost])
    for mode, faults in P27_RUNS:
        faults = p27_faults(mode, faults)
        name = f"{mode} {' + '.join(faults)}"
        got = [rk["runs"][mode] for rk in ranks]
        want = refs[mode]
        same = [g["tokens"] == want["tp1"] == want["tp2"] for g in got]
        counts = {P27_COUNTER[f]: [g["counters"][P27_COUNTER[f]]
                                   for g in got] for f in faults}
        where = ("the late stall at the first decode step, the others "
                 if mode == P27_LATE else "")
        log(f"  27a {name} ({where}at supervised steps {list(P27_AT)}): "
            f"tokens "
            f"identical to tp=1 and to phase 14's uninterrupted tp=2 on "
            f"rank 0 / rank 1: {same} "
            f"({agreement(got[0]['tokens'], want['tp1'])}); rebuilds "
            f"{[g['counters']['rebuilds'] for g in got]}, {counts}; "
            f"recovery (anomaly -> replayed) "
            f"{[[round(x, 3) for x in g['recovery_s']] for g in got]} s, "
            f"supervised run {[round(g['wall_s'], 2) for g in got]} s "
            f"({smi})")
        if not all(same):
            raise AssertionError(f"27a {name}: tokens differ")
        want_counts = {}
        for f in faults:
            want_counts[P27_COUNTER[f]] = \
                want_counts.get(P27_COUNTER[f], 0) + 1
        for g in got:
            if g["counters"]["rebuilds"] != len(faults) \
                    or any(g["counters"][k] != v
                           for k, v in want_counts.items()) \
                    or len(g["recovery_s"]) != len(faults) \
                    or g["tp"] != 2 or g["reasons"] != ["length"] * 8:
                raise AssertionError(f"27a {name}: {g['counters']}, tp "
                                     f"{g['tp']}, {g['reasons']}")
        for k in ("counters", "records", "trace_ids"):
            if got[0][k] != got[1][k]:
                raise AssertionError(f"27a {name}: the ranks' {k} differ")
        anomalies = [r for r in got[0]["records"] if r["event"] == "anomaly"]
        if mode == P27_LATE and not (
                anomalies[0]["error"].startswith("rank 1: StepTimeout")
                and "rank 0" not in anomalies[0]["error"]):
            raise AssertionError(f"27a {name}: the late stall was not rank "
                                 f"1's alone: {anomalies[0]['error']}")
        result["runs"][name] = dict(
            recovery_s=[g["recovery_s"] for g in got],
            wall_s=[g["wall_s"] for g in got],
            counters=got[0]["counters"],
            ledger=[r["event"] for r in got[0]["records"]])
    fl = [rk["fleet"] for rk in ranks]
    same = [f["tokens"] == f["tp1_tokens"] == fl[0]["tp1_tokens"]
            for f in fl]
    log(f"  27b ReplicaFleet(tp_degrees=[2, 1]), r0 then r1 killed: tokens "
        f"identical to the tp-1 engine's on rank 0 / rank 1: {same} "
        f"({agreement(fl[0]['tokens'], fl[0]['tp1_tokens'])}); migrations "
        f"{[f['migrations'] for f in fl]}, kills "
        f"{[f['replica_kills'] for f in fl]}, replicas {fl[0]['tps']}, wall "
        f"{[round(f['wall_s'], 2) for f in fl]} s ({smi})")
    if not all(same) or fl[0]["tokens"] != fl[1]["tokens"]:
        raise AssertionError("27b: the fleet's tokens differ from tp-1's")
    for f in fl:
        if f["migrations"] < 2 or f["tps"] != {"r0": 2, "r1": 1} \
                or f["reasons"] != ["length"] * P27_FLEET_REQUESTS \
                or not f["refcounts"]:
            raise AssertionError(f"27b: {f['migrations']} migrations, "
                                 f"{f['tps']}, {f['reasons']}, refcounts "
                                 f"{f['refcounts']}")
    result["fleet"] = dict(migrations=fl[0]["migrations"],
                           wall_s=[f["wall_s"] for f in fl])
    log(f"  phase 27a/27b on phase 14b's ranks, after its runs: "
        f"{[round(rk['work_s'], 1) for rk in ranks]} s ({smi})")
    return result


LIFECYCLE = ("serving.submit", "serving.queue", "serving.prefill",
             "serving.decode", "serving.finish")


def _tool(name):
    """The module ``tools/<name>.py``."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tools"))
    try:
        return __import__(name)
    finally:
        sys.path.pop(0)


def _prom_parses(text):
    """``tools/torch_obs_dump.py:prom_parses``: the malformed lines of a
    Prometheus text exposition."""
    return _tool("torch_obs_dump").prom_parses(text)


# 27c's runs in order: an untimed warm-up, tracing off and on alternated
# twice, then the profiler
P27C_ARMS = ("warm-up", "off", "on", "off", "on", "profiler")
P27C_SPANS = 10_000     # spans timed alone: a span's own host cost


def phase_observe(model, fd, Engine, workdir="build/phase27c"):
    """27c (see the module docstring): phase 5's workload on a fresh engine
    for each of ``P27C_ARMS``. Returns row 4's launches of every run after
    the warm-up, and the record."""
    import shutil

    from paddle_tpu_torch import observability as obs
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.observability import tracing
    from paddle_tpu_torch.profiler.statistic import load_profiler_result

    shutil.rmtree(workdir, ignore_errors=True)
    prompts = workload(model.config.vocab_size, seed=1)
    smi = smi_line()
    runs, launches, toks = {}, {}, []

    def tokens_counter():
        fam = obs.snapshot()["paddle_serving_events_total"]["samples"]
        return next(s["value"] for s in fam
                    if s["labels"]["kind"] == "tokens_generated")

    try:
        for i, arm in enumerate(P27C_ARMS):
            name = f"{i} {arm}"
            tracing.disable()
            tracing.reset()
            eng = Engine(model, **SERVE_GEO, flash_decode=True)
            gc.collect()
            before = tokens_counter()
            prof = None
            if arm == "on":
                tracing.enable()
            if arm == "profiler":
                # the device's activity alone: the kernels are what the
                # run checks, and the host's operators would multiply the
                # trace's size and its export time
                prof = profiler.Profiler(
                    targets=[profiler.ProfilerTarget.GPU],
                    on_trace_ready=profiler.export_chrome_tracing(
                        workdir, "p27c"))
                prof.start()
            torch.cuda.synchronize()
            reset_counts(fd.flash_decode)
            t0 = time.perf_counter()
            hs = staggered(eng, prompts, 32)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            n = fd.flash_decode.launches
            by_variant = dict(fd.flash_decode.launches_by_variant)
            steps = eng.stats()["decode_steps"]
            rec = dict(wall_s=wall, decode_steps=steps, launches=n)
            toks.append([list(h.tokens) for h in hs])
            if prof is not None:
                prof.stop()
                res = load_profiler_result(workdir)
                k = res.kernel_summary().get("flash_decode_split_kernel", {})
                rec["profile_split_kernels"] = k.get("calls", 0)
                rec["profile_split_ms"] = k.get("total", 0.0) / 1e3
                rec["profile_busy_ms"] = sum(
                    res.device_summary().values()) / 1e3
                # the launch calls whose device record the trace lacks
                rec["profile_completeness"] = _tool(
                    "torch_profile_check").completeness(res.source)
                if rec["profile_split_kernels"] != n:
                    raise AssertionError(
                        f"27c: the profile holds {rec['profile_split_kernels']}"
                        f" flash_decode_split_kernel launches, the wrapper "
                        f"counted {n}; {rec['profile_completeness']}")
            want = model.config.num_hidden_layers * steps
            if n != want or by_variant != {"split": want, "one_pass": 0}:
                raise AssertionError(f"27c {name}: flash_decode launched {n} "
                                     f"({by_variant}), want {want} split")
            if not all(h.finish_reason == "length" and len(h.tokens) == 32
                       for h in hs):
                raise AssertionError(f"27c {name}: a request did not finish "
                                     f"with 32 tokens")
            delta = tokens_counter() - before
            if delta != sum(len(h.tokens) for h in hs):
                raise AssertionError(f"27c {name}: the token counter moved "
                                     f"{delta}")
            if arm == "on":
                ring = tracing.spans()
                for h in hs:
                    mine = {s["name"]: s for s in ring
                            if (s["args"] or {}).get("request_id")
                            == h.request_id and s["name"] in LIFECYCLE}
                    if set(mine) != set(LIFECYCLE) or any(
                            s["trace"] != h.trace_id
                            for s in mine.values()):
                        raise AssertionError(
                            f"27c: request {h.request_id}'s lifecycle "
                            f"spans {sorted(mine)} under one trace id "
                            f"{h.trace_id}")
                doc = json.loads(json.dumps(obs.to_chrome_trace()))
                bad = _prom_parses(obs.to_prometheus())
                if bad:
                    raise AssertionError(f"27c: malformed exposition {bad}")
                rec["spans"] = len(ring)
                rec["chrome_events"] = len(doc["traceEvents"])
            elif tracing.spans():
                raise AssertionError(f"27c {name}: spans recorded with "
                                     f"tracing off")
            runs[name] = rec
            if arm != "warm-up":
                launches[name] = n
            del eng, hs          # the engine lives while its handles do
        # a span's own cost, read directly (the walls spread wider)
        tracing.enable()
        tracing.reset()
        t0 = time.perf_counter()
        for _ in range(P27C_SPANS):
            with tracing.span("p27c.probe", cat="probe"):
                pass
        span_us = (time.perf_counter() - t0) / P27C_SPANS * 1e6
    finally:
        tracing.disable()
        tracing.reset()
        shutil.rmtree(workdir, ignore_errors=True)
    if not all(t == toks[0] for t in toks):
        raise AssertionError("27c: the runs' tokens differ")
    walls = {a: [r["wall_s"] for k, r in runs.items() if k.endswith(a)]
             for a in ("off", "on")}
    prof_run = runs[f"{len(P27C_ARMS) - 1} profiler"]
    order = ", ".join(f"{k} {r['wall_s']:.3f}" for k, r in runs.items())
    log(f"  27c walls in order {order} s: tracing off {[round(w, 3) for w in walls['off']]}, on "
        f"{[round(w, 3) for w in walls['on']]} (on - off by pair "
        f"{[round(b - a, 3) for a, b in zip(walls['off'], walls['on'])]} "
        f"s); decode steps {prof_run['decode_steps']}; row 4 launches "
        f"{list(launches.values())}, in the profile "
        f"{prof_run['profile_split_kernels']} "
        f"({prof_run['profile_split_ms']:.3f} ms of "
        f"{prof_run['profile_busy_ms']:.3f} ms busy; "
        f"{prof_run['profile_completeness']}); "
        f"{runs['2 on']['spans']} spans a traced run, a span "
        f"{span_us:.2f} us alone: {span_us * runs['2 on']['spans'] / 1e3:.3f}"
        f" ms of host time a traced run ({smi})")
    runs["span_us"] = span_us
    return list(launches.values()), runs


def main():
    # ---- 1. device ----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(0)
    log(f"[1] device {name}, count {torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    log("  nvidia-smi: " + smi_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"  torch.backends.cuda.matmul.allow_tf32 = "
        f"{torch.backends.cuda.matmul.allow_tf32}")

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import flash_decode as fd
    from paddle_tpu_torch.ops import fused_ce as fc
    from paddle_tpu_torch.ops import ragged_matmul as rm
    from paddle_tpu_torch.ops import int8_matmul as im
    from paddle_tpu_torch.ops import stochastic_round as sr
    from paddle_tpu_torch.ops import prng
    from paddle_tpu_torch.nn import quant as tq
    from paddle_tpu_torch import optimizer
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.serving import Engine, SpecConfig, ledger
    from paddle_tpu_torch.text.generation import beam_search_generate
    from paddle_tpu_torch.text.models import (ErnieMoEConfig,
                                              ErnieMoEForPretraining,
                                              GPTConfig, GPTForCausalLM)
    from paddle_tpu_torch.text.models.llama import (LLAMA2_7B, LLAMA_TINY,
                                                    LlamaConfig,
                                                    LlamaForCausalLM)

    # ---- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    log("[2] build the kernels that are missing or stale")
    built = _build.build()                  # only what is missing or stale
    log(f"  built {sorted(built)} in {time.perf_counter() - t0:.1f} s "
        f"(up to date: {sorted(set(_build.KERNELS) - set(built))})")
    for n in _build.KERNELS:
        blog = _build.build_log(n)
        for line in blog.splitlines():
            if any(s in line for s in ("registers", "spill", "smem",
                                       "Compiling entry", "C75")):
                log(f"  {n}: {line.strip()}")
        # C7520 / C7512: ptxas serialized the wgmmas (a divergent path; too
        # few registers)
        if "C7520" in blog or "C7512" in blog:
            raise AssertionError(f"{n}: ptxas serialized the wgmmas (see "
                                 f"above)")

    # ---- 3. parity ----------------------------------------------------------
    log("[3] kernel parity against the plain versions")
    errs = phase_parity(fa, fd, fc, rm, im, sr)

    # ---- 4. Llama-2-7B forward ---------------------------------------------
    t0 = time.perf_counter()
    pt.seed(0)
    model = LlamaForCausalLM(LLAMA2_7B, device="cuda")
    torch.cuda.synchronize()
    log(f"[4] Llama-2-7B bf16, {LLAMA2_7B.num_hidden_layers} layers, built "
        f"in {time.perf_counter() - t0:.1f} s, "
        f"{sum(p.numel() for p in model.parameters()) / 1e9:.3f}e9 params")
    fa_launches = phase_forward(model, fa, fd, F)

    # ---- 5. engine ----------------------------------------------------------
    log("[5] Engine(n_slots=8, max_len=512, block_size=16, "
        "flash_decode=True)")
    fd_launches = phase_engine(model, fa, fd, Engine, ledger)
    torch.cuda.empty_cache()

    # ---- 11. sampled, chunked serving (phase 4's model) --------------------
    log("[11] Engine(n_slots=8, max_len=512, block_size=16, flash_decode="
        "True, do_sample=True, top_k=50, top_p=0.9, prefill_chunk=64), "
        "temperature 0.6; then kv_layout='slot', greedy")
    sampled_launches, sampled = phase_sampled(model, fd, Engine, ledger)
    log("  sampled serving " + json.dumps(sampled))

    # ---- 20. speculative decoding and beam search (phase 4's model) --------
    log(f"[20] speculative decoding (k={SPEC_K}) and beam search: 20b "
        f"Llama-2-7B bf16, phase 5's prompts one at a time, "
        f"{SPEC_SERIAL_NEW} new tokens, greedy, flash_decode=True: plain, "
        f"n-gram, self-draft and a 0.5B-width {SPEC_DRAFT_LAYERS}-layer "
        f"draft; 20c "
        f"generate(ids{list(BEAM_SHAPE)}, {BEAM_NEW} new, num_beams=4); 20a "
        f"fp32 twins (Llama-2-7B widths at 2 layers, GPT-2 small), "
        f"{SPEC_GEO}, greedy then sampled + chunked: plain, n-gram, "
        f"self-draft and hostile")
    spec_launches, spec = phase_spec(
        model, fd, Engine, SpecConfig, ledger, beam_search_generate,
        LlamaConfig, LlamaForCausalLM, GPTConfig, GPTForCausalLM, pt.seed)
    log("  speculative decoding " + json.dumps(spec))

    # ---- 27c. tracing and profiling phase 5's engine (phase 4's model) -----
    t27c = time.perf_counter()
    log(f"[27c] phase 5's Engine(flash_decode=True), a fresh engine a "
        f"run: {list(P27C_ARMS)} (tracing off / on, "
        f"profiler.Profiler(targets=[GPU]))")
    observe_launches, observe = phase_observe(model, fd, Engine)
    log("  observability " + json.dumps(observe))
    log(f"  phase 27c took {time.perf_counter() - t27c:.1f} s "
        f"({smi_line()})")

    # ---- 10. PTQ Llama-2-7B (phase 4's model) ------------------------------
    log("[10] PTQ Llama-2-7B, 32 layers: PostTrainingQuantization -> "
        "Int8Linear, the int8 kernel on every projection and the head")
    q_launches, sr_launches, ptq = phase_ptq(model, fa, im, sr, tq)
    log("  ptq " + json.dumps(ptq))
    del model
    torch.cuda.empty_cache()

    # ---- 6. token identity --------------------------------------------------
    log("[6] token identity at LLAMA_TINY fp32")
    phase_identity(LlamaForCausalLM, LLAMA_TINY, Engine, pt.seed, prng)

    # ---- 7. timings ---------------------------------------------------------
    log("[7] timings (median of 20, L2 flushed)")
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    t = phase_timings(fa, fd, fc, rm, im, sr, flush)
    log("  timings " + json.dumps(t))
    for line in split_kernel_ptxas(_build):
        log("  flash_decode split kernel: " + line)
    del flush
    torch.cuda.empty_cache()

    # ---- 8. training --------------------------------------------------------
    log("[8] training: Llama-2-7B width, 8 layers, fleet + AdamW")
    train_launches, train = phase_train(fa, fc, rm, LlamaForCausalLM,
                                        LLAMA2_7B, fleet, optimizer, pt.seed)
    log("  training " + json.dumps(train))

    # ---- 9. ERNIE-MoE training ----------------------------------------------
    log("[9] ERNIE-MoE training: bench.py's configuration, fleet + AdamW, "
        "sparse dispatch + ragged experts")
    moe_launches, moe = phase_ernie(fa, fc, rm, ErnieMoEConfig,
                                    ErnieMoEForPretraining, fleet, optimizer,
                                    pt.seed)
    log("  ernie_moe training " + json.dumps(moe))

    # ---- 12. hybrid Fleet training ------------------------------------------
    log("[12a] phase 8's trainer through spawn(nprocs=1): NCCL, world 1, "
        "sharding_stage=3, sharding_degree=1, mp_degree=1")
    hybrid1 = phase_hybrid_world1(fa, fc, rm, LlamaForCausalLM, LLAMA2_7B,
                                  fleet, optimizer, pt.seed, train)
    log(f"[12b] two ranks on cuda:0 over gloo: Llama-2-7B width, "
        f"{PAIR_LAYERS} layers, mp_degree=2 and sharding_degree=2 stage 3")
    pair = phase_hybrid_pair(fa, fc, rm, LlamaForCausalLM, LLAMA2_7B, fleet,
                             optimizer, pt.seed)
    log("  hybrid " + json.dumps(dict(world1={k: hybrid1[k] for k in (
        "backend", "step_ms", "phase8_step_ms", "overhead_ms")},
        pair=pair)))

    # ---- 13. GPT-2 serving ---------------------------------------------------
    log("[13] GPT-2 small (hidden 768, 12 layers, 12 heads, FFN 3072, 1024 "
        "positions, vocab 50304), bf16: scoring, Engine(n_slots=8, "
        "max_len=1024, block_size=16, flash_decode=True) greedy and sampled "
        "+ chunked, batch generate")
    gpt_fa_launches, gpt_fd_launches, gpt_fd_sampled, gpt2 = phase_gpt2(
        fa, fd, F, Engine, ledger, GPTConfig, GPTForCausalLM, pt.seed)
    log("  gpt2 " + json.dumps(gpt2))

    # ---- 14. tensor-parallel serving -----------------------------------------
    log(f"[14] Engine(model, tp=2) as two ranks on cuda:0 over gloo, fp32: "
        f"14a GPT-2 small, 14b Llama-2-7B width at {TP_LLAMA_LAYERS} layers; "
        f"greedy, then sampled + chunked, against tp=1")
    from paddle_tpu_torch.framework.io import load_numpy_state_dict
    tp_refs = {}
    tp = phase_tp(Engine, ledger, load_numpy_state_dict, refs=tp_refs,
                  p27dir="build/phase27")
    log("  tp serving " + json.dumps(tp))

    # ---- 27a/27b. serving robustness under tp --------------------------------
    log(f"[27a] EngineSupervisor(tp=2) on phase 14b's two ranks (cuda:0, "
        f"gloo; Llama-2-7B width, {TP_LLAMA_LAYERS} layers, fp32), after "
        f"its runs: fault-free against Engine(tp=2), then faults "
        f"{[(m, p27_faults(m, f)) for m, f in P27_RUNS]} (the late stall "
        f"at the first decode step, the others at supervised steps "
        f"{list(P27_AT)}); [27b] ReplicaFleet(tp_degrees=[2, 1]) on it, "
        f"r0 then r1 killed mid-decode")
    tp_robust = phase_tp_robust(tp_refs["14b"])
    log("  tp robustness " + json.dumps(tp_robust))

    # ---- 15. sequence-parallel training -------------------------------------
    log(f"[15] sequence-parallel training: 15a ring and Ulysses at "
        f"{list(SEP_OPS)} bf16 causal, sep {SEP_DEGREE}, against world 1; "
        f"15b bench.py:bench_llama_long_context's cell (hidden 2048, "
        f"{SEP_LAYERS} layers, 16 heads, FFN 5504, {SEP_BATCH[0]}x{SEP_BATCH[1]}, bf16, "
        f"selective remat, AdamW) at world 1, then sep {SEP_DEGREE} ring and "
        f"Ulysses as two ranks on cuda:0 over gloo")
    sep = phase_sep(fa, fc, rm, LlamaConfig, LlamaForCausalLM, fleet,
                    optimizer, pt.seed)
    log("  sequence parallel " + json.dumps(sep))

    # ---- 16. pipeline-parallel training -------------------------------------
    log(f"[16] pipeline-parallel training: Llama-2-7B width, {PP_LAYERS} "
        f"layers, LlamaForCausalLMPipe, batch {PP_BATCH[0]}x{PP_BATCH[1]}, "
        f"{PP_MICRO} micro-batches, bf16, AdamW; 16a spmd_pipeline and "
        f"pipeline_1f1b against world 1, 16b the GPipe and 1F1B steps at "
        f"world 1, then pp {PP_DEGREE} as two ranks on cuda:0 over gloo")
    from paddle_tpu_torch.text.models import LlamaForCausalLMPipe
    pp = phase_pp(fa, fc, rm, LlamaConfig, LlamaForCausalLMPipe, fleet,
                  optimizer, pt.seed)
    log("  pipeline parallel " + json.dumps(pp))

    # ---- 17. GPT-2 small training ------------------------------------------
    log("[17] GPT-2 small training (hidden 768, 12 layers, 12 heads, FFN "
        "3072, vocab 50304), bf16, 8x1024, AdamW: 17a one card, 17b "
        "mp_degree=2 as two ranks on cuda:0 over gloo against 17a")
    gpt_train_launches, gpt_train = phase_gpt2_train(
        fa, fc, rm, GPTConfig, GPTForCausalLM, fleet, optimizer, pt.seed)
    log("  gpt2 training " + json.dumps(gpt_train))

    # ---- 18. expert-parallel ERNIE-MoE training ----------------------------
    log(f"[18] expert-parallel ERNIE-MoE training: phase 9's configuration "
        f"at mp_degree={EP_DEGREE} as two ranks on cuda:0 over gloo, "
        f"against world 1")
    ep_launches, ep = phase_ep(fa, fc, rm, ErnieMoEConfig,
                               ErnieMoEForPretraining, fleet, optimizer,
                               pt.seed)
    log("  expert parallel " + json.dumps(ep))

    # ---- 19. comm-efficient data parallel ----------------------------------
    log(f"[19] comm-efficient data parallel: bench.py:bench_llama's 0.5B "
        f"Llama (hidden 2048, FFN 5504, 16 heads, bf16, fused head) at "
        f"{COMM_LAYERS} layers, {COMM_BATCH[0]}x{COMM_BATCH[1]}: world 1, "
        f"then dp{COMM_DEGREE} as two ranks on cuda:0 over gloo under "
        f"{list(COMM_ARMS)}")
    comm_launches, comm = phase_comm(fa, fc, rm, LlamaConfig,
                                     LlamaForCausalLM, fleet, optimizer,
                                     pt.seed)
    log("  comm-efficient data parallel " + json.dumps(comm))

    # ---- 21. mixed precision and attention dropout --------------------------
    log(f"[21] mixed precision: 21a bench.py:bench_llama's 0.5B Llama with "
        f"fp32 parameters (hidden 2048, 8 layers, 16 heads, FFN 5504, fused "
        f"head, AdamW), {AMP_BATCH[0]}x{AMP_BATCH[1]}, arms {list(AMP_ARMS)};"
        f" 21b a planted inf under the scaler; 21c MultiHeadAttention at "
        f"{list(MHA_SHAPE)} (batch, seq, embed, heads) bf16, eval and "
        f"training dropout {MHA_DROPOUT}; 21d tp2 O1 as two ranks on cuda:0 "
        f"over gloo, the inf on one rank")
    from paddle_tpu_torch import amp, nn
    amp_launches, amp_train = phase_amp_train(
        fa, fc, LlamaConfig, LlamaForCausalLM, fleet, optimizer, amp,
        pt.seed)
    log("  amp training " + json.dumps(amp_train))
    mha = phase_mha(fa, F, nn, amp, pt.seed)
    log("  multi-head attention " + json.dumps(mha))
    amp_tp_launches, amp_pair = phase_amp_pair(
        fa, fc, LlamaConfig, LlamaForCausalLM, fleet, optimizer, amp,
        pt.seed)
    log("  amp tp2 " + json.dumps(amp_pair))

    # ---- 22. the encoder families -------------------------------------------
    t22 = time.perf_counter()
    log(f"[22] the encoder families: 22a-c BERT-base (bench.py:bench_bert's "
        f"configuration, {BERT_BATCH[0]}x{BERT_BATCH[1]}, bf16): "
        f"pretraining with dropout (the plain composite), without dropout "
        f"(rows 1-3) against plain-routed steps, the classification eval "
        f"forward unmasked and masked; 22d T5 at T5Config()'s widths, "
        f"{T5_BATCH[0]}x({T5_BATCH[1]} -> {T5_BATCH[2]}), bf16 training, "
        f"fp32 generate; 22e ViT-B/16 (bench.py:bench_vit's, "
        f"{VIT_BATCH[0]}x{VIT_BATCH[1]}^2, bf16)")
    from paddle_tpu_torch.nn.functional import attention
    from paddle_tpu_torch.text.models import (BertConfig, BertForPretraining,
                                              BertForSequenceClassification)
    from paddle_tpu_torch.text.models import t5 as t5mod
    from paddle_tpu_torch.vision import vit_b_16
    bert_launches, bert = phase_bert(
        fa, fc, rm, F, attention, BertConfig, BertForPretraining,
        BertForSequenceClassification, fleet, optimizer, pt.seed)
    log("  bert " + json.dumps(bert))
    t5 = phase_t5(fa, fc, rm, t5mod, fleet, optimizer, pt.seed)
    log("  t5 " + json.dumps(t5))
    vit = phase_vit(fa, fc, rm, F, vit_b_16, fleet, optimizer, pt.seed)
    log("  vit " + json.dumps(vit))
    log(f"  phase 22 took {time.perf_counter() - t22:.1f} s ({smi_line()})")

    # ---- 23. the serving deployment path -----------------------------------
    t23 = time.perf_counter()
    log(f"[23] the serving deployment path on phase 20a's fp32 twins (GPT-2 "
        f"small, Llama-2-7B widths at 2 layers), {DEPLOY_GEO}, phase 5's "
        f"prompts, greedy and sampled + chunked: 23a save_lm -> "
        f"create_llm_predictor, 23b EngineSupervisor under "
        f"{list(DEPLOY_FAULTS)} and a real wedge, 23c ReplicaFleet(2) "
        f"(Llama) under replica-kill and route-flap, prefix routing, the "
        f"adopt guard")
    from paddle_tpu_torch.inference import create_llm_predictor
    from paddle_tpu_torch.resilience import ChaosMonkey
    from paddle_tpu_torch.serving import (AdoptMismatch, EngineSupervisor,
                                          ReplicaFleet, save_lm)
    deploy_launches, deploy = phase_deploy(
        fd, Engine, EngineSupervisor, ReplicaFleet, ChaosMonkey,
        AdoptMismatch, save_lm, create_llm_predictor, LlamaConfig,
        LlamaForCausalLM, GPTConfig, GPTForCausalLM, pt.seed)
    log("  deployment " + json.dumps(deploy))
    log(f"  phase 23 took {time.perf_counter() - t23:.1f} s ({smi_line()})")

    # ---- 24. training robustness ------------------------------------------
    t24 = time.perf_counter()
    log(f"[24] training robustness: 24a phase 17's GPT-2 small trainer "
        f"(bf16, 8x1024, AdamW, dropout 0.1) at {P24_LAYERS} layers, under a "
        f"Supervisor with a CheckpointManager (save_interval {P24_SAVE}), "
        f"batches from DataLoader + DistributedBatchSampler(shuffle=True) + "
        f"ResumableLoader over {P24_SEQS} seeded sequences, {P24_STEPS} "
        f"steps over 2 epochs: twice uninterrupted, the chaos plan "
        f"{P24_PLAN} + a {P24_WEDGE_S} s wedge at invocation {P24_WEDGE_AT} "
        f"under step_timeout_s {P24_TIMEOUT_S}, a child SIGKILLed at step "
        f"{P24_KILL_AT} and a resuming child; 24b phase 19's 0.5B Llama at "
        f"{P24B_LAYERS} layers, {P24B_BATCH[0]}x{P24B_BATCH[1]}, comm_opt "
        f"{P24B_CFG}: dp2 as two gloo ranks on cuda:0, checkpointed, "
        f"restored at dp2 and at world 1")
    from paddle_tpu_torch import io as pio
    from paddle_tpu_torch.framework import attempt
    robust = phase_robust_gpt2(fa, fc, rm, GPTConfig, GPTForCausalLM, fleet,
                               optimizer, pt.seed, pio, ChaosMonkey, attempt)
    log("  robustness 24a " + json.dumps(robust))
    robust_comm_launches, robust_comm = phase_robust_comm(
        fa, fc, rm, LlamaConfig, LlamaForCausalLM, fleet, optimizer, pt.seed)
    log("  robustness 24b " + json.dumps(robust_comm))
    log(f"  phase 24 took {time.perf_counter() - t24:.1f} s ({smi_line()})")

    # ---- 25. the high-level API and the CNN path ----------------------------
    t25 = time.perf_counter()
    log(f"[25] the high-level API and the CNN path: 25a ResNet-50 at "
        f"bench.py:bench_resnet50's configuration (1000 classes, bf16, "
        f"{RESNET_IMAGE}^2, Momentum(0.1, 0.9)) at batches "
        f"{list(RESNET_BATCHES)}, then channels-last at the best, and the "
        f"fp32 twin's checks; 25b paddle.Model(resnet18(num_classes=10)) "
        f"on Cifar10 (synthetic): fit, evaluate, predict, save -> load; 25c "
        f"paddle.Model(BertForSequenceClassification) at BERT-base, "
        f"{BERT_BATCH[0]}x{BERT_BATCH[1]}, bf16, against the direct train "
        f"step")
    hapi_launches, hapi = phase_hapi_cnn(fa, fc, rm, pt.seed)
    log("  hapi+cnn " + json.dumps(hapi))
    log(f"  25c Model.fit step {hapi['hapi_bert']['fit_step_ms']:.1f} ms, "
        f"its direct step {hapi['hapi_bert']['direct_step_ms']:.1f} ms, "
        f"22b's kernel step (MLM head) "
        f"{bert['22b']['kernels']['step_ms']:.1f} ms ({smi_line()})")
    log(f"  phase 25 took {time.perf_counter() - t25:.1f} s ({smi_line()})")

    # ---- 26. the eager user surface -----------------------------------------
    t26 = time.perf_counter()
    log(f"[26] the eager user surface: 26a every row of the op table "
        f"({len(op_cases(OP_ROWS_CARD))} rows at {OP_ROWS_CARD} x 8 "
        f"elements, linalg at its own shapes) on the card against a CPU "
        f"copy; 26b a Llama-2-7B decoder layer written as a user nn.Layer "
        f"in the flat ops (hidden {P26_LAYER['hidden']}, "
        f"{P26_LAYER['heads']} heads, FFN {P26_LAYER['ffn']}, fp32, "
        f"[1, {P26_TOKENS}]) against LlamaDecoderLayer; 26c "
        f"tools/bench_eager.py's loop on the port's API; 26d a PyLayer, "
        f"jacobian and hessian on the card against the CPU")
    from paddle_tpu_torch.text.models.llama import LlamaDecoderLayer
    t26a = time.perf_counter()
    op_counts, slowest = phase_eager_ops(pt)
    log(f"  26a rows passed per module {json.dumps(op_counts)} "
        f"({time.perf_counter() - t26a:.1f} s; slowest rows {slowest})")
    user_layer = phase_user_layer(fa, fc, rm, pt, LlamaConfig,
                                  LlamaDecoderLayer)
    log("  26b " + json.dumps(user_layer))
    eager_loop = phase_eager_loop(pt, F)
    log("  26c " + json.dumps(eager_loop))
    log("  26d " + json.dumps(phase_autograd(pt)))
    log(f"  phase 26 took {time.perf_counter() - t26:.1f} s ({smi_line()})")

    # ---- 28. the nn layer library -----------------------------------------
    t28 = time.perf_counter()
    log(f"[28] the nn layer library: 28a every row of the nn table "
        f"({len(nn_cases(NN_ROWS_CARD))} rows at card size) on the card "
        f"against a CPU copy; 28b PaddleNLP's IWSLT'15 attention seq2seq "
        f"(vocab {S2S['src_vocab']}/{S2S['trg_vocab']}, width "
        f"{S2S['hidden']}, {S2S['layers']}-layer LSTM, batch {S2S_BATCH}, "
        f"fp32): 3 Adam steps, beam {S2S_BEAM} decode, the fp32 twin; 28c "
        f"DCGAN (z {DCGAN['nz']} -> 4x4x{DCGAN['width']} -> 64x64x"
        f"{DCGAN['channels']}, batch {DCGAN_BATCH}, fp32): "
        f"{DCGAN_STEPS} D/G steps, the fp32 twin")
    nn_counts, nn_slowest = phase_nn_table(pt)
    log(f"  28a rows passed {json.dumps(nn_counts)} "
        f"({time.perf_counter() - t28:.1f} s; slowest rows {nn_slowest})")
    t28b = time.perf_counter()
    s2s = phase_seq2seq(pt)
    log("  28b " + json.dumps(s2s))
    log(f"  28b seq2seq step walls {[round(w, 3) for w in s2s['step_s']]} "
        f"s, beam decode {s2s['decode_s']:.3f} s for "
        f"{s2s['decode_steps']} steps ({time.perf_counter() - t28b:.1f} s)")
    t28c = time.perf_counter()
    gan = phase_dcgan(pt)
    log("  28c " + json.dumps(gan))
    log(f"  28c DCGAN step walls {[round(w, 3) for w in gan['step_s']]} s, "
        f"{gan['images_per_s']:.1f} images/s "
        f"({time.perf_counter() - t28c:.1f} s)")
    log(f"  phase 28 took {time.perf_counter() - t28:.1f} s ({smi_line()})")

    cols = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    first = ("first_version_ms",)
    kernels = [
        dict(name="flash_attention_fwd", route="cuda",
             source="paddle_tpu_torch/csrc/flash_attention_fwd.cu",
             replaces="paddle_tpu/ops/pallas/flash_attention.py:137",
             launches=fa_launches,
             max_abs_err=errs["flash_attention_fwd"],
             max_err=errs["flash_attention_fwd"],
             **{k: t["flash_attention_fwd_L512"][k] for k in cols + first},
             L2048={k: t["flash_attention_fwd_L2048"][k]
                    for k in cols + first},
             gpt2=dict(launches=gpt_fa_launches,
                       **{k: t["flash_attention_fwd_gpt2"][k]
                          for k in cols + first + ("shape",)})),
        dict(name="flash_decode", route="cuda",
             source="paddle_tpu_torch/csrc/flash_decode.cu",
             replaces="paddle_tpu/ops/pallas/flash_decode.py:100",
             launches=fd_launches, launches_sampled=sampled_launches,
             launches_speculative=spec_launches,
             launches_deploy=deploy_launches,
             launches_observe=observe_launches,
             max_abs_err=errs["flash_decode"],
             max_err=errs["flash_decode"],
             **{k: t["flash_decode"][k] for k in cols + first},
             T4096={k: t["flash_decode_T4096"][k] for k in cols + first},
             gpt2=dict(launches=gpt_fd_launches,
                       launches_sampled=gpt_fd_sampled,
                       **{k: t["flash_decode_gpt2"][k]
                          for k in cols + first + ("shape",)}),
             gpt2_T1024={k: t["flash_decode_gpt2_T1024"][k]
                         for k in cols + first + ("shape",)}),
    ]
    for kname, source, replaces in (
            ("flash_attention_bwd_dq", "flash_attention_bwd.cu",
             "paddle_tpu/ops/pallas/flash_attention.py:279"),
            ("flash_attention_bwd_dkv", "flash_attention_bwd.cu",
             "paddle_tpu/ops/pallas/flash_attention.py:306"),
            ("fused_ce_stats", "fused_ce.cu",
             "paddle_tpu/ops/pallas/fused_ce.py:84")):
        kernels.append(dict(
            name=kname, route="cuda",
            source=f"paddle_tpu_torch/csrc/{source}", replaces=replaces,
            launches=train_launches[kname], max_abs_err=errs[kname],
            max_err=errs[kname], **{k: t[kname][k] for k in cols},
            **{k: t[kname][k] for k in first if k in t[kname]}))
    # rows 1-3 at the ERNIE-MoE shape, with their launches per ERNIE step
    for kd in kernels:
        if kd["name"].startswith("flash_attention"):
            te = t[kd["name"] + "_ernie"]
            kd["ernie"] = dict(launches=moe_launches[kd["name"]],
                               **{k: te[k] for k in cols + first if k in te})
    # rows 1-3 and 5 on 12b's rank-local shards: launches per tp rank and
    # step (mp2), and the vocabulary columns each rank's fused CE covered
    mp2 = pair["configs"]["mp2"]
    for kd in kernels:
        if kd["name"] == "flash_decode":
            continue
        kd["tp_rank"] = (dict(left_out=mp2["left_out"]) if "left_out" in mp2
                         else dict(launches=mp2["launches_per_rank_step"][
                             kd["name"]]))
        if kd["name"] == "fused_ce_stats" and "left_out" not in mp2:
            kd["tp_rank"]["vocab_columns"] = mp2["ce_columns"]
    # rows 1-3 on 15b's sequence shards: launches per rank and step, by
    # sep mode and rank, and at world 1
    for kd in kernels:
        if kd["name"].startswith("flash_attention_"):
            kd["sep"] = dict(world1=sep["world1"]["launches"][kd["name"]],
                             **{mode: [c[kd["name"]] for c in sep["cells"][
                                 mode]["launches_per_rank_step"]]
                                for mode in SEP_MODES})
    # rows 1-3 on 16b's pipeline stages: launches per rank and step, by
    # schedule and rank, and at world 1
    for kd in kernels:
        if kd["name"].startswith("flash_attention_"):
            kd["pp"] = dict(world1=pp["world1"]["launches"][kd["name"]],
                            **{s: [c[kd["name"]] for c in pp["cells"][s][
                                "launches_per_rank_step"]]
                               for s in PP_SCHEDULES})
    # rows 1-3 in GPT-2 small's training (17a a step; 17b per tp rank and
    # step) and rows 2-3 timed at its batch; in phase 18, per EP rank and
    # step
    for kd in kernels:
        if kd["name"].startswith("flash_attention_"):
            kd["gpt2_train"] = dict(
                launches=gpt_train_launches[kd["name"]],
                tp2_rank=gpt_train["tp2"]["launches_per_rank_step"][
                    kd["name"]],
                **{k: t[kd["name"] + "_gpt2_train"][k]
                   for k in cols + first + ("shape",)
                   if kd["name"] + "_gpt2_train" in t})
            kd["ep_rank"] = dict(launches=ep_launches[kd["name"]])
    # rows 1-3 and 5 per dp rank and step under the comm-efficient steps
    # (phase 19: the same on every arm)
    for kd in kernels:
        if kd["name"].startswith("flash_attention_") or \
                kd["name"] == "fused_ce_stats":
            kd["comm_dp_rank"] = dict(launches=comm_launches[kd["name"]],
                                      tc=comm_launches[kd["name"] + "_tc"])
    # rows 1-3 and 5 in phase 21: launches a step by variant in each amp
    # arm (21a) and per tp2 rank (21d); row 1 under MultiHeadAttention
    for kd in kernels:
        if kd["name"].startswith("flash_attention_") or \
                kd["name"] == "fused_ce_stats":
            kd["amp"] = dict(
                **{arm: amp_launches[arm][kd["name"]] for arm in AMP_ARMS},
                tp2_rank=amp_tp_launches[kd["name"]])
        if kd["name"] == "flash_attention_fwd":
            kd["amp"]["mha_eval"] = mha["eval"]["launches"]
    # rows 1-3 in phase 22 at BERT-base's [16, 512, 12, 64] non-causal
    # shape: launches in a dropout-free step (22b; 22a's dropout step takes
    # the plain composite: 0), row 1's per classification forward (22c),
    # and their phase-7 times there
    for kd in kernels:
        if kd["name"].startswith("flash_attention_"):
            te = t[kd["name"] + "_bert"]
            kd["bert"] = dict(
                launches_22a=0,
                launches_22b=bert_launches["step_22b"][kd["name"]],
                **{k: te[k] for k in cols + first + ("shape",) if k in te})
            if kd["name"] == "flash_attention_fwd":
                kd["bert"]["launches_22c"] = bert_launches["forward_22c"]
    # rows 1-3 and 5 in phase 24: 24a's launches per step (uninterrupted)
    # and over the chaos run's executed attempts; 24b's per step at world 1
    # after the dp2 restore
    for kd in kernels:
        if kd["name"].startswith("flash_attention_"):
            kd["robustness"] = dict(
                launches_24a_step=robust["launches_per_step"][kd["name"]],
                launches_24a_chaos=robust["chaos"]["launches"][kd["name"]],
                executed_attempts_24a_chaos=len(robust["chaos"]["executed"]),
                launches_24b_step=robust_comm_launches[kd["name"]])
        if kd["name"] == "fused_ce_stats":
            kd["robustness"] = dict(
                launches_24b_step=robust_comm_launches[kd["name"]])
    # rows 1-3 in phase 25c: launches in a Model.fit step of BERT-base
    # classification (dropout-free, no mask)
    for kd in kernels:
        if kd["name"].startswith("flash_attention_"):
            kd["hapi"] = dict(
                launches_25c_fit_step=hapi_launches[kd["name"]],
                launches_25c_fit_step_tc=hapi_launches[kd["name"] + "_tc"])
    # rows 1-3 in phase 26b: launches in one call (forward and backward) of
    # the port's LlamaDecoderLayer at Llama-2-7B's widths, fp32
    for kd in kernels:
        if kd["name"].startswith("flash_attention_"):
            kd["eager"] = dict(
                launches_26b_call=user_layer["launches"][kd["name"]])
    ragged_cols = ("variant", "first_version_ms")
    kernels.append(dict(
        name="ragged_group_matmul", route="cuda",
        source="paddle_tpu_torch/csrc/ragged_matmul.cu",
        replaces="paddle_tpu/ops/pallas/ragged_matmul.py:53",
        launches=moe_launches["ragged_group_matmul"],
        launches_tc=moe_launches["ragged_group_matmul_tc"],
        max_abs_err=errs["ragged_group_matmul"],
        max_err=errs["ragged_group_matmul"],
        **{k: t["ragged_group_matmul_up"][k] for k in cols + ragged_cols},
        down={k: t["ragged_group_matmul_down"][k]
              for k in cols + ragged_cols},
        dx={k: t["ragged_group_matmul_dx"][k] for k in cols + ragged_cols},
        ep_rank=dict(launches=ep_launches["ragged_group_matmul"],
                     launches_tc=ep_launches["ragged_group_matmul_tc"],
                     expert_inputs=ep["ragged_shapes"],
                     **{n: {k: t[f"ragged_group_matmul_{n}_ep"][k]
                            for k in cols + ragged_cols + ("shape",)}
                        for n in ("up", "down", "dx")})))
    int8_cols = cols + ("variant", "first_version_ms",
                        "int_mm_row_major_ms", "bf16_ms")
    kernels.append(dict(
        name="int8_matmul_rescale", route="cuda",
        source="paddle_tpu_torch/csrc/int8_matmul.cu",
        replaces="paddle_tpu/ops/pallas/int8_matmul.py:30",
        launches=q_launches["int8_matmul_rescale"],
        launches_tc=ptq["int8_variants"]["tc"],
        max_abs_err=errs["int8_matmul_rescale"],
        max_err=errs["int8_matmul_rescale"],
        **{k: t["int8_matmul_rescale_up"][k] for k in int8_cols},
        **{shape: {k: t[f"int8_matmul_rescale_{shape}"][k]
                   for k in int8_cols}
           for shape in ("qkvo", "down", "head", "bench")}))
    for kname, line in (("stochastic_round", 60),
                        ("quantize_int8_stochastic", 111)):
        kernels.append(dict(
            name=kname, route="cuda",
            source="paddle_tpu_torch/csrc/stochastic_round.cu",
            replaces=f"paddle_tpu/nn/quant/__init__.py:{line}",
            launches=sr_launches[kname], max_abs_err=errs[kname],
            max_err=errs[kname], **{k: t[kname][k] for k in cols},
            small={k: t[kname + "_small"][k] for k in cols}))
    end_phase()
    print(json.dumps({"kernels": kernels}), flush=True)
    print("nvidia-smi: " + smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
